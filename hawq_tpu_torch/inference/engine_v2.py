"""Freezer and integer engine for pre-activation ResNet v2 (port of
hawq_tpu/inference/engine_v2.py).

The unit's integer batch-norm is the canonical ``QuantBnAct`` semantics
(nn/layers.py): a per-channel dyadic requant of the residual stream plus an
integer offset, ReLU-clamped; the engine evaluates the same float32
expressions, as separate elementwise ops (a multiply-add fused into one
rounding would flip borderline values).

Routing (every integer conv and the FC through the port's kernels, their
plain versions on a CPU device):

  * the 7×7/s2 init conv → ``int8_conv_acc`` through its space-to-depth
    rewrite; ReLU, then the 3×3/s2 max-pool on the raw int32 accumulator,
    exactly in int32 (``engine.maxpool_int``), then the requant;
  * the bottleneck's conv1 (1×1, with the unit's stride) → a strided slice,
    then ``int8_matmul_requant`` with ReLU (exact: the requant is monotone
    and maps 0 to 0); a basic unit's conv1 → ``int8_conv_requant`` (stride
    2 through space-to-depth);
  * the bottleneck's 3×3 conv2 → ``int8_conv_requant`` with ReLU; a basic
    unit's conv2 → ``int8_conv_acc``, into ``requant_add_int32``;
  * conv3, the identity conv and the FC → ``int8_matmul_acc``.

The reference has no packed int4 route for v2, so 4-bit weights stay int8
containers and go through the int8 kernels.  The input mode is float32, the
residual carrier int32.  ``capture=<node>`` returns the raw integer tensor
at a named node: 'input', 'init', '<stage>.<unit>.pre' / '.conv1' /
'.quant_act_int32', 'fc_input'.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from hawq_tpu_torch.configs.bit_config import (BitConfig, RESNET_UNITS,
                                               RESNET_CONVS_PER_UNIT)
from hawq_tpu_torch.inference.engine import (IntEngine, engine_device,
                                             maxpool_int)
from hawq_tpu_torch.inference.freeze import (BN_EPS, FrozenModel,
                                             _act_scale_from_stats,
                                             _freeze_linear, _quant_int,
                                             _sym_scale)
from hawq_tpu_torch.quant import ops as qops


def _freeze_conv(params: Mapping, weight_bit: int, bias_bit: int, in_scale,
                 per_channel: bool, use_bias: bool = True):
    """float32 numpy mirror of QuantConv2d (nn/layers.py), same op order."""
    kernel = np.asarray(params['kernel'], np.float32)       # HWIO
    w_flat = kernel.reshape(-1, kernel.shape[-1])
    if per_channel:
        lo, hi = w_flat.min(axis=0), w_flat.max(axis=0)
    else:
        lo, hi = w_flat.min(), w_flat.max()
    w_scale = _sym_scale(weight_bit, lo, hi)
    w_int = _quant_int(kernel, w_scale, weight_bit, np.int8)
    bias_scale = (w_scale * np.float32(in_scale)).astype(np.float32)
    if use_bias:
        b_int = _quant_int(np.asarray(params['bias'], np.float32),
                           bias_scale, bias_bit, np.int32)
    else:
        b_int = np.zeros((kernel.shape[-1],), np.int32)
    return {'weight_int': w_int, 'bias_int': b_int,
            'weight_scale': np.atleast_1d(w_scale)}


def freeze_resnet_v2(variables: Mapping, arch: str, cfg: BitConfig,
                     num_classes: int = 1000) -> FrozenModel:
    """QResNetV2 QAT variables (the flax-style numpy tree) → FrozenModel, in
    float32 numpy with the QAT graph's op order."""
    base = arch[:-2]
    params = variables['params']
    bstats = variables.get('batch_stats', {})
    qstats = variables['quant_stats']
    st = cfg.settings
    tensors: Dict[str, np.ndarray] = {}

    def act(key, module_path):
        node = qstats
        for part in module_path:
            node = node[part]
        s = _act_scale_from_stats(node, cfg.act_bits(key), cfg.act_mode(key))
        tensors[key + '.act_scale'] = np.float32(s)
        return s

    def conv(key, module_path, in_scale, use_bias=True):
        p = params
        for part in module_path:
            p = p[part]
        out = _freeze_conv(p, cfg.weight_bits(key), st.bias_bit, in_scale,
                           st.per_channel, use_bias)
        for k, v in out.items():
            tensors[f'{key}.{k}'] = v

    in_scale = act('quant_input', ('quant_input',))
    conv('quant_init_conv', ('quant_init_conv',), in_scale)
    act('quant_act_int32', ('quant_act_int32',))

    bottleneck = RESNET_CONVS_PER_UNIT[base] == 3
    for s, n_units in enumerate(RESNET_UNITS[base], start=1):
        for u in range(1, n_units + 1):
            p = f'stage{s}.unit{u}'
            mod = f'stage{s}_unit{u}'
            # the unit's BN: per-channel affine, float32, QuantBnAct's order
            bp = params[mod]['quant_bn']
            bs = bstats[mod]['quant_bn']
            gamma = np.asarray(bp['gamma'], np.float32)
            beta = np.asarray(bp['beta'], np.float32)
            mean = np.asarray(bs['mean'], np.float32)
            var = np.asarray(bs['var'], np.float32)
            bn_factor = gamma / np.sqrt(var + np.float32(BN_EPS))
            tensors[f'{p}.quant_bn.bn_factor'] = bn_factor
            tensors[f'{p}.quant_bn.bn_bias'] = (
                beta - mean * bn_factor).astype(np.float32)
            a = act(f'{p}.quant_act', (mod, 'quant_bn'))

            if 'quant_identity_conv' in params[mod]:
                conv(f'{p}.quant_identity_conv', (mod, 'quant_identity_conv'),
                     a, use_bias=False)
            conv(f'{p}.quant_conv1', (mod, 'quant_conv1'), a)
            a1 = act(f'{p}.quant_act1', (mod, 'quant_act1'))
            conv(f'{p}.quant_conv2', (mod, 'quant_conv2'), a1)
            if bottleneck:
                a2 = act(f'{p}.quant_act2', (mod, 'quant_act2'))
                conv(f'{p}.quant_conv3', (mod, 'quant_conv3'), a2)
            act(f'{p}.quant_act_int32', (mod, 'quant_act_int32'))

    out_sc = act('quant_act_output', ('quant_act_output',))
    lin = _freeze_linear(params['quant_output'],
                         cfg.weight_bits('quant_output'), st.bias_bit,
                         out_sc, st.per_channel)
    for k, v in lin.items():
        tensors[f'quant_output.{k}'] = v
    return FrozenModel(arch=arch, cfg=cfg, tensors=tensors,
                       num_classes=num_classes)


class ResnetV2Engine(IntEngine):
    """Callable integer ResNet v2; see :func:`build_resnet_v2_engine`."""

    def __init__(self, fm: FrozenModel, capture: Optional[str],
                 device: torch.device):
        super().__init__(fm, capture, ('float32',), 'float32', torch.int32,
                         device)
        base = fm.arch[:-2]
        self.bottleneck = RESNET_CONVS_PER_UNIT[base] == 3
        self.units = [(si, u) for si, n in enumerate(RESNET_UNITS[base], 1)
                      for u in range(1, n + 1)]

    def _bn(self, p: str, prev_scale):
        """(multiplier, integer offset, bounds) of the unit's integer BN."""
        if (p, 'bn') not in self._w:
            sa, ba, sga = self.act_info(f'{p}.quant_act')
            bn_a = (np.float32(prev_scale)
                    * self.fm[f'{p}.quant_bn.bn_factor']).astype(np.float32)
            b1 = np.floor(self.fm[f'{p}.quant_bn.bn_bias'] / np.float32(sa)
                          + np.float32(0.5))
            self._w[p, 'bn'] = (self.requant_mult(f'{p}.bn', bn_a, sa),
                                self._dev(b1.astype(np.float32)),
                                qops.requant_clip_bounds(ba, sga))
        return self._w[p, 'bn']

    def _forward(self, images: torch.Tensor, emit) -> torch.Tensor:
        fm = self.fm
        s_in = fm.act_scale('quant_input')
        x8 = self._quantize_float(images)
        emit('input', x8)

        acc = torch.clamp_min(
            self._conv_kxk(x8, 'quant_init_conv', 2, pad=3), 0)
        acc = maxpool_int(acc)
        s16, b16, sg16 = self.act_info('quant_act_int32')
        mult = self.requant_mult('init_rq', self._scale('quant_init_conv',
                                                        s_in), s16)
        x = self._requant(acc, mult, b16, sg16, torch.int32)
        prev_scale = np.float32(s16)
        emit('init', x)

        for si, u in self.units:
            p = f'stage{si}.unit{u}'
            stride = 2 if (u == 1 and si > 1) else 1
            # the unit's BN + ReLU + requant: per-channel dyadic requant plus
            # an integer offset, each step its own elementwise op
            mult, b1, (lo, hi) = self._bn(p, prev_scale)
            pre = qops.round_half_up(x.to(torch.float32) * mult) + b1
            pre = torch.clamp(torch.clamp_min(pre, 0.0), lo, hi)
            pre = pre.to(torch.int8)
            emit(f'{p}.pre', pre)
            sa = self.act_info(f'{p}.quant_act')[0]

            id_key = f'{p}.quant_identity_conv'
            if id_key + '.weight_int' in fm.tensors:
                id_acc = self._conv1x1(pre, id_key, stride)
                id_scale = self._scale(id_key, sa)
            else:
                id_acc, id_scale = x, prev_scale

            key1, key2 = f'{p}.quant_conv1', f'{p}.quant_conv2'
            sa1, ba1, sg1 = self.act_info(f'{p}.quant_act1')
            mult = self.requant_mult(f'{p}.a1', self._scale(key1, sa), sa1)
            conv1 = self._conv1x1 if self.bottleneck else self._conv_kxk
            h = conv1(pre, key1, stride, mult, ba1, sg1)
            emit(f'{p}.conv1', h)
            acc_scale = self._scale(key2, sa1)
            if self.bottleneck:
                sa2, ba2, sg2 = self.act_info(f'{p}.quant_act2')
                mult = self.requant_mult(f'{p}.a2', acc_scale, sa2)
                h = self._conv_kxk(h, key2, 1, mult, ba2, sg2)
                key3 = f'{p}.quant_conv3'
                acc = self._conv1x1(h, key3, 1)
                acc_scale = self._scale(key3, sa2)
            else:
                acc = self._conv_kxk(h, key2, 1)

            s_out = self.act_info(f'{p}.quant_act_int32')[0]
            x = qops.requant_add_int32(
                acc, self.requant_mult(f'{p}.res_m', acc_scale, s_out),
                id_acc, self.requant_mult(f'{p}.res_i', id_scale, s_out))
            prev_scale = np.float32(s_out)
            emit(f'{p}.quant_act_int32', x)

        # head: ReLU → integer average pool → direct requant → FC
        pooled = self._avg_pool(torch.clamp_min(x, 0))
        s_fc, b_fc, sg_fc = self.act_info('quant_act_output')
        # the head quantizer re-quantizes the pooled values directly:
        # round(ints · prev_scale / s_fc), a true division
        f8 = torch.clamp(qops.round_half_up(qops.exact_div(
            pooled * float(prev_scale), s_fc)),
            *qops.requant_clip_bounds(b_fc, sg_fc)).to(torch.int8)
        emit('fc_input', f8)
        return self._head(f8, 'quant_output', s_fc)


def build_resnet_v2_engine(fm: FrozenModel, capture: Optional[str] = None,
                           device='cuda') -> ResnetV2Engine:
    """Build ``engine(images f32 NHWC) -> logits f32`` of a frozen QResNetV2
    on ``device``; with ``capture``, the engine returns the raw tensor at
    that node instead."""
    return ResnetV2Engine(fm, capture, engine_device(device))
