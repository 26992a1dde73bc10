"""Deployable integer checkpoint, and the freeze of a trained QAT ResNet or
MobileNetV2 into one (port of hawq_tpu/inference/freeze.py; the ResNet v2
freezer is in inference/engine_v2.py, as in the reference).

The artifact is a flat dict of numpy arrays (layer-key → weight_int int8 /
bias_int int32 / weight_scale f32[C] / act_scale f32[]) plus the BitConfig.
The engine (inference/engine.py) uploads what it needs to the device at
build time; utils/checkpoint.py serializes it.

:func:`freeze_resnet` and :func:`freeze_mobilenetv2` replicate the folded
QAT path (nn/layers.py QuantConvBn, folded branch) in **float32 numpy with
the same op order**:
IEEE float32 elementwise ops are deterministic and identical between numpy
and PyTorch, so the frozen integers and scales are bit for bit the ones the
training graph uses.  (Float64 here would be wrong: double rounding flips
round-half-up decisions relative to the float32 QAT graph.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np

from hawq_tpu_torch.configs.bit_config import (BitConfig, RESNET_UNITS,
                                               RESNET_CONVS_PER_UNIT)

BN_EPS = 1e-5


@dataclasses.dataclass
class FrozenModel:
    """Deployable integer checkpoint."""
    arch: str
    cfg: BitConfig
    tensors: Dict[str, np.ndarray]      # '<key>.weight_int' etc.
    num_classes: int = 1000

    def __getitem__(self, k: str) -> np.ndarray:
        return self.tensors[k]

    def act_scale(self, key: str) -> np.float32:
        return np.float32(self.tensors[key + '.act_scale'])


def frozen_from_numpy(arch: str, cfg_name: str, cfg_table: Mapping[str, int],
                      tensors: Mapping[str, np.ndarray],
                      num_classes: int = 1000) -> FrozenModel:
    """Carry a checkpoint across as plain numpy and dicts: the parts of any
    FrozenModel (for example one produced by hawq_tpu) become the port's
    FrozenModel with identical integers and scales."""
    cfg = BitConfig(name=cfg_name, table=dict(cfg_table))
    return FrozenModel(arch=arch, cfg=cfg,
                       tensors={k: np.array(v) for k, v in tensors.items()},
                       num_classes=num_classes)


def _sym_scale(bits: int, lo, hi):
    """float32 mirror of qops.symmetric_quant_scale (same op order)."""
    n = 2 ** (bits - 1) - 1
    bound = np.maximum(np.abs(lo), np.abs(hi)).astype(np.float32)
    return (np.maximum(bound, np.float32(1e-8)) / n).astype(np.float32)


def _round_half_up(x):
    return np.floor(x + np.float32(0.5))


def _quant_int(x, scale, bits: int, out_dtype):
    """float32 mirror of qops.quantize_symmetric: clip(round(x/scale))."""
    n = 2 ** (bits - 1) - 1
    q = _round_half_up(x.astype(np.float32) / scale)
    q = np.clip(q, np.float32(-n - 1), np.float32(n))
    return q.astype(np.int64).astype(out_dtype)


def _act_scale_from_stats(stats: Mapping, bits: int, mode: str) -> np.float32:
    x_min = np.float32(stats['x_min'])
    x_max = np.float32(stats['x_max'])
    if mode == 'asymmetric':
        n = 2 ** bits - 1
        return np.float32(
            np.maximum(x_max - x_min, np.float32(1e-8)) / np.float32(n))
    n = 2 ** (bits - 1) - 1
    bound = np.maximum(np.abs(x_min), np.abs(x_max))
    return np.float32(np.maximum(bound, np.float32(1e-8)) / np.float32(n))


def _quantize_weights(w: np.ndarray, b: np.ndarray, weight_bit: int,
                      bias_bit: int, in_act_scale: np.float32,
                      per_channel: bool) -> Dict[str, np.ndarray]:
    """Per-channel (over the last axis) or per-tensor symmetric weight
    integers, and the bias at ``bias_bit`` in units of
    weight_scale · in_act_scale."""
    w_flat = w.reshape(-1, w.shape[-1])
    if per_channel:
        lo, hi = w_flat.min(axis=0), w_flat.max(axis=0)
    else:
        lo, hi = w_flat.min(), w_flat.max()
    w_scale = _sym_scale(weight_bit, lo, hi)
    bias_scale = (w_scale * np.float32(in_act_scale)).astype(np.float32)
    return {'weight_int': _quant_int(w, w_scale, weight_bit, np.int8),
            'bias_int': _quant_int(b, bias_scale, bias_bit, np.int32),
            'weight_scale': np.atleast_1d(w_scale)}


def _freeze_convbn(params: Mapping, bstats: Mapping, weight_bit: int,
                   bias_bit: int, in_act_scale: np.float32,
                   per_channel: bool) -> Dict[str, np.ndarray]:
    """Fold BN and quantize: float32 mirror of the QuantConvBn folded
    branch (nn/layers.py)."""
    kernel = np.asarray(params['kernel'], np.float32)        # HWIO
    gamma = np.asarray(params['gamma'], np.float32)
    beta = np.asarray(params['beta'], np.float32)
    mean = np.asarray(bstats['mean'], np.float32)
    var = np.asarray(bstats['var'], np.float32)
    bn_factor = gamma / np.sqrt(var + np.float32(BN_EPS))
    w = kernel * bn_factor                     # broadcast over Cout (last)
    b = (np.float32(0.0) - mean) * bn_factor + beta
    return _quantize_weights(w, b, weight_bit, bias_bit, in_act_scale,
                             per_channel)


def _freeze_linear(params: Mapping, weight_bit: int, bias_bit: int,
                   in_act_scale: np.float32,
                   per_channel: bool) -> Dict[str, np.ndarray]:
    return _quantize_weights(np.asarray(params['kernel'], np.float32),
                             np.asarray(params['bias'], np.float32),
                             weight_bit, bias_bit, in_act_scale, per_channel)


def freeze_resnet(variables: Mapping, arch: str, cfg: BitConfig,
                  num_classes: int = 1000) -> FrozenModel:
    """Convert QResNet QAT variables → FrozenModel.

    ``variables``: the flax-style tree of numpy arrays with 'params',
    'batch_stats', 'quant_stats' (``models.resnet.qat_to_numpy(model)``, or
    the variables of a ``hawq_tpu`` model); the quant_stats must have been
    calibrated."""
    params = variables['params']
    bstats = variables.get('batch_stats', {})
    qstats = variables['quant_stats']
    st = cfg.settings
    tensors: Dict[str, np.ndarray] = {}

    def act(key: str, module_path) -> np.float32:
        node = qstats
        for part in module_path:
            node = node[part]
        s = _act_scale_from_stats(node, cfg.act_bits(key), cfg.act_mode(key))
        tensors[key + '.act_scale'] = np.float32(s)
        return s

    def convbn(key: str, module_path, in_scale: np.float32):
        p, b = params, bstats
        for part in module_path:
            p = p[part]
            b = b[part]
        out = _freeze_convbn(p, b, cfg.weight_bits(key), st.bias_bit,
                             in_scale, st.per_channel)
        for k, v in out.items():
            tensors[f'{key}.{k}'] = v

    in_scale = act('quant_input', ('quant_input',))
    bottleneck = RESNET_CONVS_PER_UNIT[arch] == 3
    init_key = 'quant_init_convbn' if bottleneck else 'quant_init_block_convbn'
    convbn(init_key, (init_key,), in_scale)
    act('quant_act_int32', ('quant_act_int32',))

    for s, n_units in enumerate(RESNET_UNITS[arch], start=1):
        for u in range(1, n_units + 1):
            p = f'stage{s}.unit{u}'
            mod = f'stage{s}_unit{u}'
            a = act(f'{p}.quant_act', (mod, 'quant_act'))
            if f'{p}.quant_identity_convbn' in cfg or \
                    'quant_identity_convbn' in params.get(mod, {}):
                convbn(f'{p}.quant_identity_convbn',
                       (mod, 'quant_identity_convbn'), a)
            convbn(f'{p}.quant_convbn1', (mod, 'quant_convbn1'), a)
            a1 = act(f'{p}.quant_act1', (mod, 'quant_act1'))
            convbn(f'{p}.quant_convbn2', (mod, 'quant_convbn2'), a1)
            if bottleneck:
                a2 = act(f'{p}.quant_act2', (mod, 'quant_act2'))
                convbn(f'{p}.quant_convbn3', (mod, 'quant_convbn3'), a2)
            act(f'{p}.quant_act_int32', (mod, 'quant_act_int32'))

    out_sc = act('quant_act_output', ('quant_act_output',))
    lin = _freeze_linear(params['quant_output'],
                         cfg.weight_bits('quant_output'), st.bias_bit, out_sc,
                         st.per_channel)
    for k, v in lin.items():
        tensors[f'quant_output.{k}'] = v
    return FrozenModel(arch=arch, cfg=cfg, tensors=tensors,
                       num_classes=num_classes)


def freeze_mobilenetv2(variables: Mapping, cfg: BitConfig, stages,
                       num_classes: int = 1000) -> FrozenModel:
    """QMobileNetV2 QAT variables → FrozenModel.  ``stages`` is the channel
    structure the model was built with (``models.mobilenetv2``
    ``MOBILENETV2_STAGES`` or the tiny variant)."""
    params = variables['params']
    bstats = variables.get('batch_stats', {})
    qstats = variables['quant_stats']
    st = cfg.settings
    tensors: Dict[str, np.ndarray] = {}

    def act(key: str, module_path) -> np.float32:
        node = qstats
        for part in module_path:
            node = node[part]
        s = _act_scale_from_stats(node, cfg.act_bits(key), cfg.act_mode(key))
        tensors[key + '.act_scale'] = np.float32(s)
        return s

    def convbn(key: str, module_path, in_scale: np.float32):
        p, b = params, bstats
        for part in module_path:
            p = p[part]
            b = b[part]
        out = _freeze_convbn(p, b, cfg.weight_bits(key), st.bias_bit,
                             in_scale, st.per_channel)
        for k, v in out.items():
            tensors[f'{key}.{k}'] = v

    in_scale = act('quant_input', ('quant_input',))
    convbn('init_block', ('init_block',), in_scale)
    act('quant_act_int32', ('quant_act_int32',))

    for i, stage in enumerate(stages, start=1):
        for j, _ in enumerate(stage, start=1):
            p = f'features.stage{i}.unit{j}'
            mod = f'stage{i}_unit{j}'
            a = act(f'{p}.quant_act', (mod, 'quant_act'))
            convbn(f'{p}.conv1', (mod, 'conv1'), a)
            a1 = act(f'{p}.quant_act1', (mod, 'quant_act1'))
            convbn(f'{p}.conv2', (mod, 'conv2'), a1)
            a2 = act(f'{p}.quant_act2', (mod, 'quant_act2'))
            convbn(f'{p}.conv3', (mod, 'conv3'), a2)
            act(f'{p}.quant_act_int32', (mod, 'quant_act_int32'))

    a = act('quant_act_before_final_block', ('quant_act_before_final_block',))
    convbn('features.final_block', ('final_block',), a)
    act('quant_act_int32_final', ('quant_act_int32_final',))
    out_sc = act('quant_act_output', ('quant_act_output',))

    # the output head: a bare 1×1 QuantConv2d with bias
    head = _freeze_linear(params['output'], cfg.weight_bits('output'),
                          st.bias_bit, out_sc, st.per_channel)
    for k, v in head.items():
        tensors[f'output.{k}'] = v
    return FrozenModel(arch='mobilenetv2', cfg=cfg, tensors=tensors,
                       num_classes=num_classes)


def model_size_bytes(fm: FrozenModel) -> int:
    """Deployed model size with true bit-packing (int4 weights count 4 bits)."""
    total_bits = 0
    for key, t in fm.tensors.items():
        if key.endswith('.weight_int'):
            layer = key[:-len('.weight_int')]
            bits = fm.cfg.weight_bits(layer)
            total_bits += t.size * bits
        elif key.endswith('.bias_int'):
            total_bits += t.size * 32
        elif key.endswith(('.weight_scale', '.act_scale')):
            total_bits += t.size * 32
    return total_bits // 8
