"""Work of an InceptionV3 forward from its shapes (see ``work/__init__``)."""

from __future__ import annotations

import math
from typing import List, Mapping

from portbench.reference import inception_v3 as ref
from portbench.weights import POOL_GAIN, RELU, T16, T8, Plan
from portbench.work.common import Layer

AVG_GAIN = 0.8               # RMS kept by the 3×3 average pool


def _out(hw: int, k: int, stride: int, pad: int) -> int:
    return (hw + 2 * pad - k) // stride + 1


def _pool(hw: int) -> int:
    """The 3×3 / stride 2 VALID max-pool's output size."""
    return (hw - 3) // 2 + 1


def layers(config: Mapping, batch: int) -> List[Layer]:
    """The forward's 94 convs and the FC at ``batch`` images, keyed as
    the frozen model's weights, with their input and output sizes (each
    conv keeps its map square: an asymmetric kernel is padded along its
    long side alone); each input at the activation bits, each output at
    the bits of the node it feeds."""
    wb = config['weight_bits']
    a = config['act_bits']
    out = []

    def conv(kp, hw, cin, conv_spec):
        cout, (kh, kw), stride, (ph, pw) = conv_spec
        h2 = _out(hw, kh, stride, ph)
        assert h2 == _out(hw, kw, stride, pw)
        out.append(Layer(f'{kp}.q_convbn', batch, hw, h2, kh, kw, cin, cout,
                         1, a, wb, ref.bits(config, f'{kp}.q_activ'),
                         stride=stride))
        return h2, cout

    hw, c = config['image_size'], 3
    for i, (cout, k, stride, pad) in enumerate(ref.stem(config), start=1):
        hw, c = conv(f'{ref.IP}.q_conv{i}', hw, c,
                     (cout, (k, k), stride, (pad, pad)))
        if i in ref.STEM_POOLS:
            hw = _pool(hw)
    for prefix, branches in ref.units(config):
        widths, hw_next = [], hw
        for name, kind, convs in branches:
            bp = f'{prefix}.branches.{name}'
            if kind == ref.MAX:
                widths.append(c)
                hw_next = _pool(hw)
                continue
            nodes = ref.branch_convs(bp, kind, convs)
            chain = nodes[:-2] if kind == ref.PAIR else nodes
            h, cb = hw, c
            for kp, spec in chain:
                h, cb = conv(kp, h, cb, spec)
            if kind == ref.PAIR:
                for kp, spec in nodes[-2:]:
                    conv(kp, h, cb, spec)
                cb *= 2
            widths.append(cb)
            hw_next = h
        hw, c = hw_next, sum(widths)
    out.append(Layer(ref.HEAD, batch, 1, 1, 1, 1, c, config['num_classes'],
                     1, a, wb, 32))
    return out


def plan(config: Mapping) -> Plan:
    """The weight generator's walk of the graph (``weights.Plan``): each
    node's grid puts the RMS of its values at T8 integer steps, or T16 for
    the 16-bit nodes (:func:`reference.inception_v3.bits`)."""
    plan = Plan()

    def act(key, v):
        plan.act(key, v, T16 if ref.bits(config, key) > 8 else T8)

    def conv(kp, spec, cin, v, node):
        """conv → ReLU → its node; returns the node's RMS."""
        cout, (kh, kw), _, _ = spec
        acc = plan.conv(f'{kp}.q_convbn', (kh, kw, cin, cout), kh * kw * cin,
                        v, node)
        act(f'{kp}.q_activ', acc * RELU)
        return acc * RELU

    v = float(config['image_rms'])
    act(ref.INPUT, v)
    node, c = ref.INPUT, 3
    for i, (cout, k, stride, pad) in enumerate(ref.stem(config), start=1):
        kp = f'{ref.IP}.q_conv{i}'
        v = conv(kp, (cout, (k, k), stride, (pad, pad)), c, v, node)
        node, c = f'{kp}.q_activ', cout
        if i in ref.STEM_POOLS:
            v *= POOL_GAIN
    for prefix, branches in ref.units(config):
        parts = []                          # (channels, RMS) of each branch
        for name, kind, convs in branches:
            bp = f'{prefix}.branches.{name}'
            node = f'{bp}.q_input_act'
            act(node, v)
            if kind == ref.MAX:
                parts.append((c, v * POOL_GAIN))
                continue
            vb, cb = v, c
            if kind == ref.AVG:
                node = f'{bp}.q_pool_act'
                vb *= AVG_GAIN
                act(node, vb)
            nodes = ref.branch_convs(bp, kind, convs)
            chain = nodes[:-2] if kind == ref.PAIR else nodes
            for kp, spec in chain:
                vb = conv(kp, spec, cb, vb, node)
                node, cb = f'{kp}.q_activ', spec[0]
            if kind == ref.PAIR:
                pair = [conv(kp, spec, cb, vb, node)
                        for kp, spec in nodes[-2:]]
                vb = pair[0]
                act(f'{bp}.q_rescaling_activ', vb)
                cb *= 2
            parts.append((cb, vb))
        c = sum(cb for cb, _ in parts)
        v = math.sqrt(sum(cb * vb * vb for cb, vb in parts) / c)
        act(f'{prefix}.q_rescaling_activ', v)
    act(ref.HEAD_IN, v)
    plan.conv(ref.HEAD, (c, config['num_classes']), c, v, ref.HEAD_IN)
    return plan
