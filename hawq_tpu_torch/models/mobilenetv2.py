"""Quantized MobileNetV2 (port of hawq_tpu/models/mobilenetv2.py), NHWC.

Inverted-residual units: a 1×1 expansion conv → a 3×3 depthwise conv → a
1×1 linear projection, ReLU6 activations, and a residual add (requantized
with dual dyadic scales) only where the unit keeps its shape.  The output
head is a bare 1×1 ``QuantConv2d`` on the pooled feature map.

ReLU6 on the integer side: relu6 acts on value = acc · acc_scale, so the
accumulator clamp is [0, floor(6/acc_scale + 0.5)] per channel
(:func:`relu6_int`; the engine computes the same bound in numpy float32).
Both clamps are ``jnp.clip``'s, gradient included (``nn.layers.clip``).

Config keys are the reference's ('features.stage{S}.unit{U}.conv{1,2,3}'
…); submodules and parameters keep the flax names (``init_block``,
``stage{S}_unit{U}.conv2`` …), so :func:`~hawq_tpu_torch.models.resnet.
qat_from_numpy` / ``qat_to_numpy`` carry the variables across.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from hawq_tpu_torch.configs.bit_config import BitConfig
from hawq_tpu_torch.models.resnet import (_PAD1, _BatchNorm, _Conv, _qact,
                                          _qconvbn)
from hawq_tpu_torch.nn import layers as L
from hawq_tpu_torch.quant import ops as qops

# channels per stage for width 1.0 (the reference's q_mobilenetv2.py)
MOBILENETV2_STAGES = ((16,), (24, 24), (32, 32, 32),
                      (64, 64, 64, 64, 96, 96, 96), (160, 160, 160, 320))
MOBILENETV2_INIT_CH = 32
MOBILENETV2_FINAL_CH = 1280

# the tiny variant of the CPU tests: the same wiring (a first unit without
# expansion, depthwise convs, residual and non-residual units)
TINY_MNV2_STAGES = ((8,), (12, 12))
TINY_MNV2_INIT_CH = 8
TINY_MNV2_FINAL_CH = 32


def relu6(x: torch.Tensor) -> torch.Tensor:
    return L.clip(x, 0.0, 6.0)


def relu6_int(acc: Optional[torch.Tensor],
              acc_scale: torch.Tensor) -> Optional[torch.Tensor]:
    """Integer-side ReLU6: clip(acc, 0, floor(6/acc_scale + 0.5)), the
    division a true one on the device (:func:`qops.exact_rdiv`)."""
    if acc is None:
        return None
    hi = torch.floor(qops.exact_rdiv(6.0, acc_scale) + 0.5)
    return L.clip(acc, 0.0, hi)


def unit_plan(stages: Sequence, init_ch: int):
    """(stage, unit, in_ch, out_ch, stride, expansion) of every unit."""
    in_ch = init_ch
    for i, stage in enumerate(stages, start=1):
        for j, out_ch in enumerate(stage, start=1):
            yield (i, j, in_ch, out_ch, 2 if (j == 1 and i != 1) else 1,
                   (i != 1) or (j != 1))
            in_ch = out_ch


class QLinearBottleneck(nn.Module):
    """Inverted-residual unit."""

    def __init__(self, cfg: BitConfig, prefix: str, in_ch: int, out_ch: int,
                 stride: int, expansion: bool, generator=None):
        super().__init__()
        p = prefix
        self.residual = in_ch == out_ch and stride == 1
        mid = in_ch * 6 if expansion else in_ch
        self.quant_act = _qact(cfg, f'{p}.quant_act')
        self.conv1 = _qconvbn(cfg, f'{p}.conv1', in_ch, mid, (1, 1), (1, 1),
                              'VALID', generator)
        self.quant_act1 = _qact(cfg, f'{p}.quant_act1')
        self.conv2 = L.QuantConvBn(
            mid, mid, (3, 3), strides=(stride, stride), padding=_PAD1,
            groups=mid, weight_bit=cfg.weight_bits(f'{p}.conv2'),
            bias_bit=cfg.settings.bias_bit,
            per_channel=cfg.settings.per_channel, generator=generator)
        self.quant_act2 = _qact(cfg, f'{p}.quant_act2')
        self.conv3 = _qconvbn(cfg, f'{p}.conv3', mid, out_ch, (1, 1), (1, 1),
                              'VALID', generator)
        self.quant_act_int32 = _qact(cfg, f'{p}.quant_act_int32')

    def forward(self, x, in_scale, *, folded: bool = True,
                update_stats: bool = False):
        kw = dict(folded=folded, update_stats=update_stats)
        xq, act_scale = self.quant_act(x, in_scale, update_stats=update_stats)
        h, w_scale, acc = self.conv1(xq, act_scale, **kw)
        h, a_scale = self.quant_act1(
            relu6(h), act_scale, w_scale,
            x_int=relu6_int(acc, w_scale * act_scale),
            update_stats=update_stats)
        h, w_scale, acc = self.conv2(h, a_scale, **kw)          # depthwise
        h, a_scale2 = self.quant_act2(
            relu6(h), a_scale, w_scale,
            x_int=relu6_int(acc, w_scale * a_scale),
            update_stats=update_stats)
        h, w_scale, acc = self.conv3(h, a_scale2, **kw)         # linear
        if self.residual:
            return self.quant_act_int32(h + x, a_scale2, w_scale, x, in_scale,
                                        None, x_int=acc,
                                        update_stats=update_stats)
        return self.quant_act_int32(h, a_scale2, w_scale, x_int=acc,
                                    update_stats=update_stats)


class QMobileNetV2(nn.Module):
    """Quantized MobileNetV2.  ``seed`` makes the initial weights (a
    ``torch.Generator``; they need not equal the flax initializers')."""

    def __init__(self, cfg: Optional[BitConfig] = None,
                 num_classes: int = 1000, stages=MOBILENETV2_STAGES,
                 init_ch: int = MOBILENETV2_INIT_CH,
                 final_ch: int = MOBILENETV2_FINAL_CH, seed: int = 0):
        super().__init__()
        cfg = cfg if cfg is not None else BitConfig(
            name='mobilenetv2_uniform8', table={})
        self.cfg, self.num_classes = cfg, num_classes
        self.stages = tuple(tuple(s) for s in stages)
        self.init_ch, self.final_ch = init_ch, final_ch
        gen = torch.Generator().manual_seed(seed)
        self.quant_input = _qact(cfg, 'quant_input')
        self.init_block = _qconvbn(cfg, 'init_block', 3, init_ch, (3, 3),
                                   (2, 2), _PAD1, gen)
        self.quant_act_int32 = _qact(cfg, 'quant_act_int32')
        self.unit_names = []
        for i, j, in_ch, out_ch, stride, expansion in unit_plan(self.stages,
                                                                init_ch):
            name = f'stage{i}_unit{j}'
            self.add_module(name, QLinearBottleneck(
                cfg, f'features.stage{i}.unit{j}', in_ch, out_ch, stride,
                expansion, generator=gen))
            self.unit_names.append(name)
        self.quant_act_before_final_block = _qact(
            cfg, 'quant_act_before_final_block')
        self.final_block = _qconvbn(cfg, 'features.final_block', out_ch,
                                    final_ch, (1, 1), (1, 1), 'VALID', gen)
        self.quant_act_int32_final = _qact(cfg, 'quant_act_int32_final')
        self.quant_act_output = _qact(cfg, 'quant_act_output')
        self.output = L.QuantConv2d(
            final_ch, num_classes, (1, 1), padding='VALID',
            weight_bit=cfg.weight_bits('output'),
            bias_bit=cfg.settings.bias_bit,
            per_channel=cfg.settings.per_channel, generator=gen)

    def forward(self, x, *, folded: bool = True, update_stats: bool = False):
        kw = dict(folded=folded, update_stats=update_stats)
        x, act_scale = self.quant_input(x, update_stats=update_stats)
        x, w_scale, acc = self.init_block(x, act_scale, **kw)
        x, act_scale = self.quant_act_int32(
            relu6(x), act_scale, w_scale,
            x_int=relu6_int(acc, w_scale * act_scale),
            update_stats=update_stats)
        for name in self.unit_names:
            x, act_scale = getattr(self, name)(x, act_scale, **kw)
        x, act_scale = self.quant_act_before_final_block(
            x, act_scale, update_stats=update_stats)
        x, w_scale, acc = self.final_block(x, act_scale, **kw)
        x, act_scale = self.quant_act_int32_final(
            relu6(x), act_scale, w_scale,
            x_int=relu6_int(acc, w_scale * act_scale),
            update_stats=update_stats)
        x, act_scale = L.quant_avg_pool(x, act_scale,
                                        (x.shape[1], x.shape[2]))
        x, act_scale = self.quant_act_output(x, act_scale,
                                             update_stats=update_stats)
        x, _, _ = self.output(x, act_scale)
        return x.reshape(x.shape[0], -1)


class FloatMobileNetV2(nn.Module):
    """fp32 baseline with the same topology; submodules carry the flax
    names (``init_conv`` / ``init_bn``, ``stage1_unit1_c1_conv`` …,
    ``final_*``, ``output``)."""

    def __init__(self, num_classes: int = 1000, stages=MOBILENETV2_STAGES,
                 init_ch: int = MOBILENETV2_INIT_CH,
                 final_ch: int = MOBILENETV2_FINAL_CH, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self._convbn('init', 3, init_ch, (3, 3), 2, 1, gen)
        self.units = []
        for i, j, in_ch, out_ch, stride, expansion in unit_plan(stages,
                                                                init_ch):
            name = f'stage{i}_unit{j}'
            mid = in_ch * 6 if expansion else in_ch
            self._convbn(name + '_c1', in_ch, mid, (1, 1), 1, 0, gen)
            self._convbn(name + '_c2', mid, mid, (3, 3), stride, 1, gen,
                         groups=mid)
            self._convbn(name + '_c3', mid, out_ch, (1, 1), 1, 0, gen)
            self.units.append((name, in_ch == out_ch and stride == 1))
        self._convbn('final', out_ch, final_ch, (1, 1), 1, 0, gen)
        self.output = _Conv(final_ch, num_classes, (1, 1), 1, 0, gen,
                            use_bias=True)

    def _convbn(self, name, in_ch, feats, kernel, stride, pad, gen,
                groups=1):
        self.add_module(name + '_conv', _Conv(in_ch, feats, kernel, stride,
                                              pad, gen, groups=groups))
        self.add_module(name + '_bn', _BatchNorm(feats))

    def _run(self, name, x, train):
        return getattr(self, name + '_bn')(getattr(self, name + '_conv')(x),
                                           train)

    def forward(self, x, *, train: bool = False):
        x = relu6(self._run('init', x, train))
        for name, residual in self.units:
            h = relu6(self._run(name + '_c1', x, train))
            h = relu6(self._run(name + '_c2', h, train))
            h = self._run(name + '_c3', h, train)
            x = x + h if residual else h
        x = relu6(self._run('final', x, train))
        x = self.output(x.mean(dim=(1, 2), keepdim=True))
        return x.reshape(x.shape[0], -1)
