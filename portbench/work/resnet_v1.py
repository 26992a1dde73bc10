"""Work of a ResNet v1 forward from its shapes (see ``work/__init__``)."""

from __future__ import annotations

import math
import re
from typing import List, Mapping

from portbench.reference import resnet_v1 as ref
from portbench.weights import POOL_GAIN, RELU, T16, T8, Plan
from portbench.work.common import Layer


def layers(config: Mapping, batch: int) -> List[Layer]:
    """The forward's convs and FC at ``batch`` images, with their input
    and output sizes; each input at the activation bits, each conv's
    output at the bits of the node it feeds (the residual carrier for the
    projection and the last 1×1 of a unit)."""
    a, r, wb = config['act_bits'], config['residual_bits'], config['weight_bits']
    hw = config['image_size']
    k = config['init_kernel']
    out = []
    hw_out = (hw + 2 * (k // 2) - k) // 2 + 1
    out.append(Layer('quant_init_convbn', batch, hw, hw_out, k, k, 3,
                     config['init_features'], 1, a, wb, r))
    hw = (hw_out + 2 - 3) // 2 + 1                       # the max-pool
    for p, cin, mid, cout, stride, proj in ref.units(config):
        h2 = hw // stride
        if proj:
            out.append(Layer(f'{p}.quant_identity_convbn', batch, hw, h2, 1,
                             1, cin, cout, 1, a, wb, r, stride=stride))
        out.append(Layer(f'{p}.quant_convbn1', batch, hw, h2, 1, 1, cin, mid,
                         1, a, wb, a, stride=stride))
        out.append(Layer(f'{p}.quant_convbn2', batch, h2, h2, 3, 3, mid, mid,
                         1, a, wb, a))
        out.append(Layer(f'{p}.quant_convbn3', batch, h2, h2, 1, 1, mid, cout,
                         1, a, wb, r))
        hw = h2
    out.append(Layer('quant_output', batch, 1, 1, 1, 1,
                     config['outs'][-1], config['num_classes'], 1, a, wb,
                     32))
    return out


def plan(config: Mapping) -> Plan:
    """The weight generator's walk of the graph (``weights.Plan``)."""
    plan = Plan()
    v = float(config['image_rms'])
    plan.act('quant_input', v, T8)
    k = config['init_kernel']
    acc = plan.conv('quant_init_convbn', (k, k, 3, config['init_features']),
                    k * k * 3, v, 'quant_input')
    plan.act('quant_act_int32', acc * RELU, T16)
    v = acc * RELU * POOL_GAIN
    for p, cin, mid, out, stride, proj in ref.units(config):
        plan.act(f'{p}.quant_act', v, T8)
        if proj:
            v_id = plan.conv(f'{p}.quant_identity_convbn', (1, 1, cin, out),
                             cin, v, f'{p}.quant_act')
        else:
            v_id = v
        acc = plan.conv(f'{p}.quant_convbn1', (1, 1, cin, mid), cin, v,
                        f'{p}.quant_act')
        plan.act(f'{p}.quant_act1', acc * RELU, T8)
        acc = plan.conv(f'{p}.quant_convbn2', (3, 3, mid, mid), 9 * mid,
                        acc * RELU, f'{p}.quant_act1')
        plan.act(f'{p}.quant_act2', acc * RELU, T8)
        acc = plan.conv(f'{p}.quant_convbn3', (1, 1, mid, out), mid,
                        acc * RELU, f'{p}.quant_act2')
        # the identity is non-negative, so the ReLU after the sum keeps
        # most of its RMS
        v = math.hypot(acc, v_id)
        plan.act(f'{p}.quant_act_int32', v, T16)
    plan.act('quant_act_output', v, T8)
    cin = config['outs'][-1]
    plan.conv('quant_output', (cin, config['num_classes']), cin, v,
              'quant_act_output')
    return plan


def qat_key(name: str) -> str:
    """The benchmark's key of the program trainer's leaf ``name``: the
    trainer names a unit ``stageN_unitM.``, the state ``stageN.unitM.``."""
    return re.sub(r'^(stage\d+)_(unit\d+)\.', r'\1.\2.', name)
