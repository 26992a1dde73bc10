"""Deployment bundles of a frozen ResNet (port of the bundle half of
hawq_tpu/export/export.py; numpy only).

The reference exports trained models to QONNX ONNX graphs with custom
Quant/Trunc ops for FPGA toolchains (utils/export/manager.py:111-142,
function.py:5-141); ``export/qonnx.py`` writes those.  The bundle
(:func:`export_bundle`) is the toolchain-neutral form of the same
information: the frozen integer checkpoint (npz) + a JSON graph manifest
describing every node — op type, integer tensor refs, dyadic (m, e)
requant parameters per edge — from which a consumer can reconstruct the
exact integer computation without float arithmetic.

``hawq_tpu``'s StableHLO export of the compiled engine has no counterpart
here yet: a ``torch.export`` program would need every kernel wrapper
registered as a ``torch.library`` custom op with a fake implementation.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from hawq_tpu_torch.configs.bit_config import (RESNET_UNITS,
                                               RESNET_CONVS_PER_UNIT)
from hawq_tpu_torch.inference.freeze import FrozenModel
from hawq_tpu_torch.quant import ops as qops


def _np_dyadic_m_e(ratio: np.ndarray):
    ratio = np.asarray(ratio, np.float32)
    m, e = np.frexp(ratio)
    m_int = np.floor(m * (2.0 ** qops.DYADIC_MANTISSA_BITS) + 0.5)
    return m_int.astype(np.int64), (qops.DYADIC_MANTISSA_BITS - e).astype(np.int64)


def bundle_manifest(fm: FrozenModel) -> Dict:
    """Graph manifest: per-node op descriptions with dyadic requant params.

    Requant edges carry explicit integer (m, e) pairs so integer-only
    consumers need no float arithmetic at all.
    """
    cfg = fm.cfg
    nodes = []

    def requant_edge(name, acc_scale, out_scale, bits, signed):
        m, e = _np_dyadic_m_e(np.asarray(acc_scale, np.float32)
                              / np.float32(out_scale))
        nodes.append({
            'op': 'requantize', 'name': name,
            'm': m.reshape(-1).tolist(), 'e': e.reshape(-1).tolist(),
            'out_bits': bits, 'signed': signed,
            'rounding': 'half_up', 'mantissa_bits': qops.DYADIC_MANTISSA_BITS,
        })

    def conv_node(key, stride, padding):
        w = fm[key + '.weight_int']
        nodes.append({
            'op': 'qconv2d', 'name': key, 'weight': key + '.weight_int',
            'bias': key + '.bias_int', 'weight_bits': cfg.weight_bits(key),
            'kernel': list(w.shape[:2]), 'stride': stride, 'padding': padding,
            'layout': 'NHWC/HWIO', 'accum': 'int32',
        })
        return (fm[key + '.weight_scale'].astype(np.float32))

    bottleneck = RESNET_CONVS_PER_UNIT[fm.arch] == 3
    init_key = 'quant_init_convbn' if bottleneck else 'quant_init_block_convbn'
    s_in = fm.act_scale('quant_input')
    nodes.append({'op': 'quantize_input', 'name': 'quant_input',
                  'scale': float(s_in), 'bits': 8, 'signed': True})
    w_scale = conv_node(init_key, 2, 3)
    nodes.append({'op': 'maxpool', 'name': 'init_pool', 'window': 3,
                  'stride': 2, 'padding': 1})
    s16 = fm.act_scale('quant_act_int32')
    requant_edge('init_requant', w_scale * np.float32(s_in), s16, 16, True)
    prev = s16

    for s, n_units in enumerate(RESNET_UNITS[fm.arch], start=1):
        for u in range(1, n_units + 1):
            p = f'stage{s}.unit{u}'
            stride = 2 if (u == 1 and s > 1) else 1
            sa = fm.act_scale(f'{p}.quant_act')
            requant_edge(f'{p}.input_requant', prev, sa,
                         cfg.act_bits(f'{p}.quant_act'),
                         cfg.act_mode(f'{p}.quant_act') == 'symmetric')
            has_id = f'{p}.quant_identity_convbn.weight_int' in fm.tensors
            if has_id:
                id_w = conv_node(f'{p}.quant_identity_convbn', stride, 0)
                id_scale = id_w * np.float32(sa)
            else:
                id_scale = prev
            n_convs = 3 if bottleneck else 2
            conv1_stride = fm.arch == 'resnet50'
            acc_scale = None
            cur = sa
            for c in range(1, n_convs + 1):
                key = f'{p}.quant_convbn{c}'
                if bottleneck:
                    conv_stride = stride if (c == 1 if conv1_stride
                                             else c == 2) else 1
                    pad = 1 if c == 2 else 0
                else:
                    conv_stride = stride if c == 1 else 1
                    pad = 1
                w_sc = conv_node(key, conv_stride, pad)
                acc_scale = w_sc * np.float32(cur)
                if c < n_convs:
                    nxt = fm.act_scale(f'{p}.quant_act{c}')
                    requant_edge(f'{p}.requant{c}', acc_scale, nxt,
                                 cfg.act_bits(f'{p}.quant_act{c}'),
                                 cfg.act_mode(f'{p}.quant_act{c}')
                                 == 'symmetric')
                    cur = nxt
            out_sc = fm.act_scale(f'{p}.quant_act_int32')
            m1, e1 = _np_dyadic_m_e(acc_scale / np.float32(out_sc))
            m2, e2 = _np_dyadic_m_e(np.asarray(id_scale, np.float32)
                                    / np.float32(out_sc))
            nodes.append({'op': 'requantize_add', 'name': f'{p}.residual',
                          'm_main': m1.reshape(-1).tolist(),
                          'e_main': e1.reshape(-1).tolist(),
                          'm_identity': np.atleast_1d(m2).tolist(),
                          'e_identity': np.atleast_1d(e2).tolist(),
                          'mantissa_bits': qops.DYADIC_MANTISSA_BITS})
            prev = out_sc

    nodes.append({'op': 'global_avgpool_trunc', 'name': 'avg_pool',
                  'eps': 0.01})
    s_fc = fm.act_scale('quant_act_output')
    requant_edge('fc_requant', prev, s_fc, cfg.act_bits('quant_act_output'),
                 True)
    nodes.append({'op': 'qdense', 'name': 'quant_output',
                  'weight': 'quant_output.weight_int',
                  'bias': 'quant_output.bias_int',
                  'weight_bits': cfg.weight_bits('quant_output')})
    nodes.append({'op': 'dequantize', 'name': 'logits',
                  'scale': (fm['quant_output.weight_scale']
                            * np.float32(s_fc)).tolist()})

    return {'format': 'hawq-tpu-bundle-v1', 'arch': fm.arch,
            'num_classes': fm.num_classes,
            'bit_config': json.loads(fm.cfg.to_json()), 'graph': nodes}


def export_bundle(path: str, fm: FrozenModel) -> None:
    """Write <path>.npz (integer tensors) + <path>.bundle.json (graph)."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    np.savez(path, **fm.tensors)
    with open(path + '.bundle.json', 'w') as f:
        json.dump(bundle_manifest(fm), f, indent=1)
