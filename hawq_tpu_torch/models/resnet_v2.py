"""Quantized pre-activation ResNet v2 (port of hawq_tpu/models/resnet_v2.py),
NHWC.

Per unit one explicit integer batch-norm on the residual stream
(``quant_bn``, a :class:`~hawq_tpu_torch.nn.layers.QuantBnAct`: it feeds
both the shortcut and the conv path, so it cannot fold into a conv) → ReLU →
requant → conv1 (with the stride, with bias) → ReLU → requant → conv2 (→
ReLU → requant → conv3 for bottlenecks); the shortcut is the raw residual
stream, or the 1×1 strided identity conv on the pre-activated input when
the shape changes; the unit ends in the dual-dyadic requant-add, with no
ReLU after it.  Head: ReLU → integer global average pool → direct requant
→ linear.  Init block: a 7×7/s2 conv with bias (no BN), ReLU, 3×3/s2
max-pool.

Submodules and parameters keep the flax names (``quant_init_conv``,
``stage{S}_unit{U}.quant_bn`` …), so :func:`~hawq_tpu_torch.models.resnet.
qat_from_numpy` / ``qat_to_numpy`` carry the variables across as they do
for ResNet v1.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hawq_tpu_torch.configs.bit_config import (BitConfig, RESNET_UNITS,
                                               RESNET_CONVS_PER_UNIT,
                                               get_bit_config)
from hawq_tpu_torch.models.resnet import (_INIT_FEATURES, _PAD1,
                                          _STAGE_CHANNELS, _qact, _relu_acc)
from hawq_tpu_torch.nn import layers as L


def base_arch(arch: str) -> str:
    """'resnet50v2' → 'resnet50': the v2 archs reuse the v1 unit tables."""
    if not arch.endswith('v2') or arch[:-2] not in RESNET_UNITS:
        raise ValueError(f'{arch} is not a ResNet v2 arch')
    return arch[:-2]


def _qconv(cfg: BitConfig, key: str, in_features: int, features: int,
           kernel, strides, padding, generator,
           use_bias: bool = True) -> L.QuantConv2d:
    return L.QuantConv2d(in_features, features, kernel, strides=strides,
                         padding=padding, weight_bit=cfg.weight_bits(key),
                         bias_bit=cfg.settings.bias_bit,
                         per_channel=cfg.settings.per_channel,
                         use_bias=use_bias, generator=generator)


class QResUnitV2(nn.Module):
    """Pre-activation unit."""

    def __init__(self, cfg: BitConfig, prefix: str, in_ch: int, mid: int,
                 out: int, stride: int, bottleneck: bool, generator=None):
        super().__init__()
        p = prefix
        self.resize = in_ch != out or stride != 1
        self.bottleneck = bottleneck
        s = (stride, stride)
        self.quant_bn = L.QuantBnAct(
            in_ch, bits=cfg.act_bits(f'{p}.quant_act'),
            momentum=cfg.settings.act_range_momentum,
            quant_mode=cfg.act_mode(f'{p}.quant_act'), relu=True)
        if self.resize:
            self.quant_identity_conv = _qconv(
                cfg, f'{p}.quant_identity_conv', in_ch, out, (1, 1), s,
                'VALID', generator, use_bias=False)
        self.quant_conv1 = _qconv(
            cfg, f'{p}.quant_conv1', in_ch, mid,
            (1, 1) if bottleneck else (3, 3), s,
            'VALID' if bottleneck else _PAD1, generator)
        self.quant_act1 = _qact(cfg, f'{p}.quant_act1')
        self.quant_conv2 = _qconv(cfg, f'{p}.quant_conv2', mid,
                                  mid if bottleneck else out, (3, 3), (1, 1),
                                  _PAD1, generator)
        if bottleneck:
            self.quant_act2 = _qact(cfg, f'{p}.quant_act2')
            self.quant_conv3 = _qconv(cfg, f'{p}.quant_conv3', mid, out,
                                      (1, 1), (1, 1), 'VALID', generator)
        self.quant_act_int32 = _qact(cfg, f'{p}.quant_act_int32')

    def forward(self, x, in_scale, *, folded: bool = True,
                update_stats: bool = False):
        pre, a_sf = self.quant_bn(x, in_scale, folded=folded,
                                  update_stats=update_stats)
        if self.resize:
            identity, id_w_scale, id_acc = self.quant_identity_conv(pre, a_sf)
            id_scale = a_sf
        else:
            identity, id_scale, id_w_scale, id_acc = x, in_scale, None, None

        h, w_scale, acc = self.quant_conv1(pre, a_sf)
        h, a_last = self.quant_act1(F.relu(h), a_sf, w_scale,
                                    x_int=_relu_acc(acc),
                                    update_stats=update_stats)
        h, w_scale, acc = self.quant_conv2(h, a_last)
        if self.bottleneck:
            h, a2 = self.quant_act2(F.relu(h), a_last, w_scale,
                                    x_int=_relu_acc(acc),
                                    update_stats=update_stats)
            h, w_scale, acc = self.quant_conv3(h, a2)
            a_last = a2
        # dual-scale residual requant-add; no trailing ReLU
        return self.quant_act_int32(
            h + identity, a_last, w_scale, identity, id_scale, id_w_scale,
            x_int=acc, identity_int=id_acc, update_stats=update_stats)


def unit_plan_v2(base: str):
    """(stage, unit, in_ch, mid, out, stride) of every v2 unit."""
    mids, outs = _STAGE_CHANNELS[base]
    in_ch = _INIT_FEATURES.get(base, 64)
    for s, n_units in enumerate(RESNET_UNITS[base], start=1):
        for u in range(1, n_units + 1):
            out = outs[s - 1]
            yield (s, u, in_ch, out if mids is None else mids[s - 1], out,
                   2 if (u == 1 and s > 1) else 1)
            in_ch = out


class QResNetV2(nn.Module):
    """Pre-activation quantized ResNet.  ``seed`` makes the initial weights
    (a ``torch.Generator``; they need not equal the flax initializers')."""

    def __init__(self, arch: str = 'resnet50v2',
                 cfg: Optional[BitConfig] = None, num_classes: int = 1000,
                 seed: int = 0):
        super().__init__()
        base = base_arch(arch)
        cfg = cfg if cfg is not None else get_bit_config(arch, 'uniform8')
        self.arch, self.cfg, self.num_classes = arch, cfg, num_classes
        gen = torch.Generator().manual_seed(seed)
        bottleneck = RESNET_CONVS_PER_UNIT[base] == 3
        init_feats = _INIT_FEATURES.get(base, 64)
        self.quant_input = _qact(cfg, 'quant_input')
        self.quant_init_conv = _qconv(cfg, 'quant_init_conv', 3, init_feats,
                                      (7, 7), (2, 2), ((3, 3), (3, 3)), gen)
        self.quant_act_int32 = _qact(cfg, 'quant_act_int32')
        self.unit_names = []
        for s, u, in_ch, mid, out, stride in unit_plan_v2(base):
            name = f'stage{s}_unit{u}'
            self.add_module(name, QResUnitV2(
                cfg, f'stage{s}.unit{u}', in_ch, mid, out, stride, bottleneck,
                generator=gen))
            self.unit_names.append(name)
        self.quant_act_output = _qact(cfg, 'quant_act_output')
        self.quant_output = L.QuantLinear(
            out, num_classes, weight_bit=cfg.weight_bits('quant_output'),
            bias_bit=cfg.settings.bias_bit,
            per_channel=cfg.settings.per_channel, generator=gen)

    def forward(self, x, *, folded: bool = True, update_stats: bool = False):
        x, act_scale = self.quant_input(x, update_stats=update_stats)
        x, w_scale, acc = self.quant_init_conv(x, act_scale)
        x, _ = L.quant_max_pool(F.relu(x), None, (3, 3), (2, 2), _PAD1)
        # the pool commutes with the (monotone) requant: pool the exact
        # integer accumulator alongside the value
        acc, _ = L.quant_max_pool(F.relu(acc), None, (3, 3), (2, 2), _PAD1)
        x, act_scale = self.quant_act_int32(x, act_scale, w_scale, x_int=acc,
                                            update_stats=update_stats)
        for name in self.unit_names:
            x, act_scale = getattr(self, name)(x, act_scale, folded=folded,
                                               update_stats=update_stats)
        x, act_scale = L.quant_global_avg_pool(F.relu(x), act_scale)
        # direct quantization of the pooled values (no incoming scale)
        x, act_scale = self.quant_act_output(x, update_stats=update_stats)
        return self.quant_output(x, act_scale)
