"""Deployment bundles of a frozen ResNet, and the integer engine as a saved
``torch.export`` program (port of hawq_tpu/export/export.py).

The reference exports trained models to QONNX ONNX graphs with custom
Quant/Trunc ops for FPGA toolchains (utils/export/manager.py:111-142,
function.py:5-141); ``export/qonnx.py`` writes those.  The bundle
(:func:`export_bundle`) is the toolchain-neutral form of the same
information: the frozen integer checkpoint (npz) + a JSON graph manifest
describing every node — op type, integer tensor refs, dyadic (m, e)
requant parameters per edge — from which a consumer can reconstruct the
exact integer computation without float arithmetic.

:func:`export_program` / :func:`load_program` stand for ``hawq_tpu``'s
``export_stablehlo`` / ``load_stablehlo``: the ResNet engine's forward at a
fixed batch, image size and input mode, traced by ``torch.export`` (every
kernel an operator ``torch.ops.hawq.*``, ``kernels._build.define_op``) and
written with ``torch.export.save``; :func:`export_engine` traces any built
engine (``deploy --dump-hlo``).  Two differences from the StableHLO
program:

  * a loaded program calls the port's kernels, so ``hawq_tpu_torch``'s
    kernel modules must be imported where it runs (:func:`load_program`
    imports them);
  * it runs as exported, op for op, with no ``run_decompositions()``,
    ``torch.compile`` or AOTInductor: a compiler may contract the requant's
    multiply and add into an FMA or turn the true divisions into
    reciprocals, which flips borderline roundings.
"""

from __future__ import annotations

import io
import json
import os
from typing import Dict

import numpy as np
import torch

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


class _EngineModule(torch.nn.Module):
    """An engine's forward as a module, for ``torch.export``; the engine's
    weights and multipliers become the program's constants."""

    def __init__(self, engine):
        super().__init__()
        self.engine = engine

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.engine(images)


def export_engine(engine, images: torch.Tensor
                  ) -> torch.export.ExportedProgram:
    """The built engine (any family, input mode, carrier and routing) traced
    by ``torch.export`` (non-strict) at the shape, dtype and device of
    ``images``.  The engine runs once on ``images`` first, so that the
    weights and multipliers it builds at its first call are device tensors
    before the trace takes them as constants."""
    engine(images)
    return torch.export.export(_EngineModule(engine), (images,), strict=False)


def export_program(fm: FrozenModel, batch_size: int = 8,
                   image_size: int = 224, *, device='cuda') -> bytes:
    """The ResNet engine (``build_resnet_engine(fm)``: float32 images, the
    int32 carrier, native requant) on ``device``, exported for
    (batch_size, image_size, image_size, 3) images and saved with
    ``torch.export.save``; :func:`load_program` loads it.  Stands for
    ``hawq_tpu``'s ``export_stablehlo`` (module docstring)."""
    from hawq_tpu_torch.inference.engine import build_resnet_engine
    engine = build_resnet_engine(fm, device=device)
    images = torch.zeros((batch_size, image_size, image_size, 3),
                         dtype=torch.float32, device=engine.device)
    buf = io.BytesIO()
    torch.export.save(export_engine(engine, images), buf)
    return buf.getvalue()


def load_program(blob: bytes, device=None):
    """A program of :func:`export_program` (or a saved
    :func:`export_engine`) → ``program(images) -> logits``, on the device
    it was exported on, or moved to ``device``.  Imports the port's kernel
    modules, whose operators the program calls.  Stands for ``hawq_tpu``'s
    ``load_stablehlo``."""
    from hawq_tpu_torch.kernels import (avgpool, conv, depthwise,  # noqa: F401
                                        matmul, pool, requant)
    program = torch.export.load(io.BytesIO(blob))
    if device is not None:
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, torch.device(device))
    return program.module()
