"""Quantized ResNet-18/50/50b/101 and their tiny and CIFAR forms (port of
hawq_tpu/models/resnet.py), NHWC.

The residual wiring is the part that matters for integer exactness:

  * every unit opens with a QuantAct that requantizes the incoming residual
    sum (16-bit precision) down to the unit's activation bits;
  * when the identity needs resizing, the 1×1 identity conv consumes the
    *quantized* unit input and the residual add requantizes main and identity
    branches with their own (act, weight) scale pairs;
  * when it doesn't, the identity is the *raw* unit input carrying the
    previous unit's output scale;
  * the closing quant_act_int32 performs the dual-dyadic requant-add and the
    unit ends with ReLU.

Config keys follow the reference naming (stage{S}.unit{U}.quant_convbn1 …);
submodule names replace '.' with '_', as the flax modules do, and parameters
and buffers keep the flax names (``kernel``, ``gamma``, ``beta``, ``bias``;
``mean``, ``var``; ``x_min``, ``x_max``).  :func:`qat_from_numpy` and
:func:`qat_to_numpy` carry a flax variables tree (``params`` /
``batch_stats`` / ``quant_stats``, as numpy) into and out of a model.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hawq_tpu_torch.configs.bit_config import (BitConfig, RESNET_UNITS,
                                               RESNET_CONVS_PER_UNIT,
                                               RESNET_CIFAR_ARCHS,
                                               uniform_config)
from hawq_tpu_torch.nn import layers as L

# (mid_channels_stage1.., out_channels_stage1..) per arch
_STAGE_CHANNELS = {
    'resnet18': (None, (64, 128, 256, 512)),
    'resnet34': (None, (64, 128, 256, 512)),
    'resnet50': ((64, 128, 256, 512), (256, 512, 1024, 2048)),
    'resnet50b': ((64, 128, 256, 512), (256, 512, 1024, 2048)),
    'resnet101': ((64, 128, 256, 512), (256, 512, 1024, 2048)),
    'resnet152': ((64, 128, 256, 512), (256, 512, 1024, 2048)),
    'resnet200': ((64, 128, 256, 512), (256, 512, 1024, 2048)),
    'resnet269': ((64, 128, 256, 512), (256, 512, 1024, 2048)),
    'tiny18': (None, (16, 32)),
    'tiny50': ((8, 16), (32, 64)),
    'wide50': ((128, 128), (256, 256)),
    # CIFAR filter lists: basic [16, 16, 32, 64]; bottleneck (n≥164)
    # [16, 64, 128, 256]
    'resnet20_cifar': (None, (16, 32, 64)),
    'resnet56_cifar': (None, (16, 32, 64)),
    'resnet110_cifar': (None, (16, 32, 64)),
    'resnet164_cifar': ((16, 32, 64), (64, 128, 256)),
}
_INIT_FEATURES = {'tiny18': 16, 'tiny50': 16, 'wide50': 64,
                  'resnet20_cifar': 16, 'resnet56_cifar': 16,
                  'resnet110_cifar': 16, 'resnet164_cifar': 16}
_PAD1 = ((1, 1), (1, 1))

# which collection of the flax variables tree a buffer belongs to
_BUFFER_COLLECTION = {'mean': 'batch_stats', 'var': 'batch_stats',
                      'x_min': 'quant_stats', 'x_max': 'quant_stats'}


def _qact(cfg: BitConfig, key: str) -> L.QuantAct:
    return L.QuantAct(bits=cfg.act_bits(key), quant_mode=cfg.act_mode(key),
                      momentum=cfg.settings.act_range_momentum,
                      percentile=cfg.settings.act_percentile,
                      fixed_point=cfg.settings.fixed_point_quantization)


def _qconvbn(cfg: BitConfig, key: str, in_features: int, features: int,
             kernel: Tuple[int, int], strides: Tuple[int, int], padding: Any,
             generator: Optional[torch.Generator]) -> L.QuantConvBn:
    return L.QuantConvBn(in_features, features, kernel, strides=strides,
                         padding=padding, weight_bit=cfg.weight_bits(key),
                         bias_bit=cfg.settings.bias_bit,
                         per_channel=cfg.settings.per_channel,
                         weight_percentile=cfg.settings.weight_percentile,
                         generator=generator)


def _relu_acc(acc):
    return None if acc is None else F.relu(acc)


class _ResUnitBase(nn.Module):
    """What the two unit types share: the opening QuantAct, the optional
    identity conv, and the closing residual requant-add."""

    def __init__(self, cfg: BitConfig, prefix: str, in_ch: int, out: int,
                 stride: int, resize: bool, generator):
        super().__init__()
        self.resize = resize
        self.quant_act = _qact(cfg, f'{prefix}.quant_act')
        if resize:
            self.quant_identity_convbn = _qconvbn(
                cfg, f'{prefix}.quant_identity_convbn', in_ch, out, (1, 1),
                (stride, stride), 'VALID', generator)
        self.quant_act_int32 = _qact(cfg, f'{prefix}.quant_act_int32')

    def _open(self, x, in_scale, folded, update_stats):
        """→ (quantized input, its scale, identity, its act scale, its
        weight scale, its integer accumulator)."""
        xq, act_scale = self.quant_act(x, in_scale, update_stats=update_stats)
        if not self.resize:
            return xq, act_scale, x, in_scale, None, None
        identity, id_w_scale, id_acc = self.quant_identity_convbn(
            xq, act_scale, folded=folded, update_stats=update_stats)
        return xq, act_scale, identity, act_scale, id_w_scale, id_acc

    def _close(self, h, a_scale, w_scale, acc, identity, id_act_scale,
               id_w_scale, id_acc, update_stats):
        h = h + identity
        hq, out_scale = self.quant_act_int32(
            h, a_scale, w_scale, identity, id_act_scale, id_w_scale,
            x_int=acc, identity_int=id_acc, update_stats=update_stats)
        return F.relu(hq), out_scale


class QResUnit(_ResUnitBase):
    """Bottleneck unit; ``conv1_stride`` puts the stride on the first 1×1
    (resnet50 v1) instead of the 3×3."""

    def __init__(self, cfg: BitConfig, prefix: str, in_ch: int, mid: int,
                 out: int, stride: int, resize: bool,
                 conv1_stride: bool = False, generator=None):
        super().__init__(cfg, prefix, in_ch, out, stride, resize, generator)
        s1 = (stride, stride) if conv1_stride else (1, 1)
        s2 = (1, 1) if conv1_stride else (stride, stride)
        self.quant_convbn1 = _qconvbn(cfg, f'{prefix}.quant_convbn1', in_ch,
                                      mid, (1, 1), s1, 'VALID', generator)
        self.quant_act1 = _qact(cfg, f'{prefix}.quant_act1')
        self.quant_convbn2 = _qconvbn(cfg, f'{prefix}.quant_convbn2', mid,
                                      mid, (3, 3), s2, _PAD1, generator)
        self.quant_act2 = _qact(cfg, f'{prefix}.quant_act2')
        self.quant_convbn3 = _qconvbn(cfg, f'{prefix}.quant_convbn3', mid,
                                      out, (1, 1), (1, 1), 'VALID', generator)

    def forward(self, x, in_scale, *, folded: bool = True,
                update_stats: bool = False):
        kw = dict(folded=folded, update_stats=update_stats)
        xq, act_scale, *identity = self._open(x, in_scale, folded,
                                              update_stats)
        h, w_scale, acc = self.quant_convbn1(xq, act_scale, **kw)
        h, a_scale = self.quant_act1(F.relu(h), act_scale, w_scale,
                                     x_int=_relu_acc(acc),
                                     update_stats=update_stats)
        h, w_scale, acc = self.quant_convbn2(h, a_scale, **kw)
        h, a_scale = self.quant_act2(F.relu(h), a_scale, w_scale,
                                     x_int=_relu_acc(acc),
                                     update_stats=update_stats)
        h, w_scale, acc = self.quant_convbn3(h, a_scale, **kw)
        return self._close(h, a_scale, w_scale, acc, *identity, update_stats)


class QResBlock(_ResUnitBase):
    """Basic (two-conv) unit."""

    def __init__(self, cfg: BitConfig, prefix: str, in_ch: int, out: int,
                 stride: int, resize: bool, generator=None):
        super().__init__(cfg, prefix, in_ch, out, stride, resize, generator)
        self.quant_convbn1 = _qconvbn(cfg, f'{prefix}.quant_convbn1', in_ch,
                                      out, (3, 3), (stride, stride), _PAD1,
                                      generator)
        self.quant_act1 = _qact(cfg, f'{prefix}.quant_act1')
        self.quant_convbn2 = _qconvbn(cfg, f'{prefix}.quant_convbn2', out,
                                      out, (3, 3), (1, 1), _PAD1, generator)

    def forward(self, x, in_scale, *, folded: bool = True,
                update_stats: bool = False):
        kw = dict(folded=folded, update_stats=update_stats)
        xq, act_scale, *identity = self._open(x, in_scale, folded,
                                              update_stats)
        h, w_scale, acc = self.quant_convbn1(xq, act_scale, **kw)
        h, a_scale = self.quant_act1(F.relu(h), act_scale, w_scale,
                                     x_int=_relu_acc(acc),
                                     update_stats=update_stats)
        h, w_scale, acc = self.quant_convbn2(h, a_scale, **kw)
        return self._close(h, a_scale, w_scale, acc, *identity, update_stats)


def _unit_plan(arch: str):
    """(stage, unit, in_ch, mid, out, stride, resize) of every unit."""
    mids, outs = _STAGE_CHANNELS[arch]
    in_ch = _INIT_FEATURES.get(arch, 64)
    for s, n_units in enumerate(RESNET_UNITS[arch], start=1):
        for u in range(1, n_units + 1):
            stride = 2 if (u == 1 and s > 1) else 1
            out_ch = outs[s - 1]
            resize = (u == 1) and (in_ch != out_ch or stride != 1)
            yield (s, u, in_ch, None if mids is None else mids[s - 1],
                   out_ch, stride, resize)
            in_ch = out_ch


class QResNet(nn.Module):
    """Quantized ResNet family.  ``seed`` makes the initial weights (a
    ``torch.Generator``; they need not equal the flax initializers')."""

    def __init__(self, arch: str = 'resnet50', cfg: Optional[BitConfig] = None,
                 num_classes: int = 1000, seed: int = 0):
        super().__init__()
        cfg = cfg if cfg is not None else uniform_config(arch, 8)
        self.arch, self.cfg, self.num_classes = arch, cfg, num_classes
        gen = torch.Generator().manual_seed(seed)
        bottleneck = RESNET_CONVS_PER_UNIT[arch] == 3
        self.cifar = arch in RESNET_CIFAR_ARCHS
        init_feats = _INIT_FEATURES.get(arch, 64)
        self.init_key = ('quant_init_convbn' if bottleneck
                         else 'quant_init_block_convbn')

        self.quant_input = _qact(cfg, 'quant_input')
        # CIFAR init: 3×3/s1/pad1, no maxpool
        init_k, init_s, init_p = (((3, 3), (1, 1), _PAD1) if self.cifar
                                  else ((7, 7), (2, 2), ((3, 3), (3, 3))))
        self.add_module(self.init_key, _qconvbn(
            cfg, self.init_key, 3, init_feats, init_k, init_s, init_p, gen))
        self.quant_act_int32 = _qact(cfg, 'quant_act_int32')
        self.unit_names = []
        for s, u, in_ch, mid, out_ch, stride, resize in _unit_plan(arch):
            prefix, name = f'stage{s}.unit{u}', f'stage{s}_unit{u}'
            if bottleneck:
                unit = QResUnit(cfg, prefix, in_ch, mid, out_ch, stride,
                                resize, conv1_stride=arch == 'resnet50',
                                generator=gen)
            else:
                unit = QResBlock(cfg, prefix, in_ch, out_ch, stride, resize,
                                 generator=gen)
            self.add_module(name, unit)
            self.unit_names.append(name)
        self.quant_act_output = _qact(cfg, 'quant_act_output')
        self.quant_output = L.QuantLinear(
            out_ch, num_classes, weight_bit=cfg.weight_bits('quant_output'),
            bias_bit=cfg.settings.bias_bit,
            per_channel=cfg.settings.per_channel, generator=gen)

    def forward(self, x, *, folded: bool = True, update_stats: bool = False):
        kw = dict(folded=folded, update_stats=update_stats)
        x, act_scale = self.quant_input(x, update_stats=update_stats)
        x, w_scale, acc = getattr(self, self.init_key)(x, act_scale, **kw)
        if not self.cifar:
            x, _ = L.quant_max_pool(x, None, (3, 3), (2, 2), _PAD1)
            # max-pool commutes with the (monotone) requant: pool the exact
            # integer accumulator alongside the value
            if acc is not None:
                acc, _ = L.quant_max_pool(acc, None, (3, 3), (2, 2), _PAD1)
        x, act_scale = self.quant_act_int32(x, act_scale, w_scale, x_int=acc,
                                            update_stats=update_stats)
        x = F.relu(x)
        for name in self.unit_names:
            x, act_scale = getattr(self, name)(x, act_scale, **kw)
        x, act_scale = L.quant_global_avg_pool(x, act_scale)
        x, act_scale = self.quant_act_output(x, update_stats=update_stats)
        return self.quant_output(x, act_scale)


# ---------------------------------------------------------------------------
# fp32 twin
# ---------------------------------------------------------------------------

class _Conv(nn.Module):
    """flax ``nn.Conv`` (HWIO ``kernel``, NHWC), bias-free unless asked."""

    def __init__(self, in_ch, feats, kernel, strides, pad, generator,
                 groups=1, use_bias=False):
        super().__init__()
        kh, kw = kernel
        self.strides, self.pad, self.groups = strides, pad, groups
        self.kernel = nn.Parameter(torch.empty(kh, kw, in_ch // groups, feats))
        L._he_normal_(self.kernel, kh * kw * in_ch // groups, 1.0, generator)
        self.bias = nn.Parameter(torch.zeros(feats)) if use_bias else None

    def forward(self, x):        # NHWC in and out
        y = F.conv2d(x.permute(0, 3, 1, 2), self.kernel.permute(3, 2, 0, 1),
                     stride=self.strides, padding=self.pad,
                     groups=self.groups)
        y = y.permute(0, 2, 3, 1)
        return y if self.bias is None else y + self.bias


class _BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis: biased batch variance in
    training, running statistics with momentum 0.99."""

    def __init__(self, feats, momentum=0.99, eps=1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(feats))
        self.bias = nn.Parameter(torch.zeros(feats))
        self.register_buffer('mean', torch.zeros(feats))
        self.register_buffer('var', torch.ones(feats))

    def forward(self, x, train: bool):
        if train:
            mean = x.mean(dim=(0, 1, 2))
            var = x.var(dim=(0, 1, 2), unbiased=False)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean
                                + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var
                               + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (self.scale * torch.rsqrt(var + self.eps)) \
            + self.bias


class _Dense(nn.Module):
    def __init__(self, in_features, features, generator):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        L._he_normal_(self.kernel, in_features, 1.0, generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return x @ self.kernel + self.bias


class FloatResNet(nn.Module):
    """fp32 baseline with identical topology: the KD teacher, and the float
    twin for speed comparisons.  Submodules carry the flax names
    (``init_conv`` / ``init_bn``, ``stage1_unit1_c1_conv`` …, ``output``)."""

    def __init__(self, arch: str = 'resnet50', num_classes: int = 1000,
                 seed: int = 0):
        super().__init__()
        self.arch = arch
        gen = torch.Generator().manual_seed(seed)
        self.bottleneck = RESNET_CONVS_PER_UNIT[arch] == 3
        self.cifar = arch in RESNET_CIFAR_ARCHS
        conv1_stride = arch == 'resnet50'
        init_feats = _INIT_FEATURES.get(arch, 64)
        if self.cifar:
            self._convbn('init', 3, init_feats, (3, 3), 1, 1, gen)
        else:
            self._convbn('init', 3, init_feats, (7, 7), 2, 3, gen)
        self.units = []
        for s, u, in_ch, mid, out_ch, stride, resize in _unit_plan(arch):
            name = f'stage{s}_unit{u}'
            if resize:
                self._convbn(name + '_id', in_ch, out_ch, (1, 1), stride, 0,
                             gen)
            if self.bottleneck:
                s1, s2 = (stride, 1) if conv1_stride else (1, stride)
                self._convbn(name + '_c1', in_ch, mid, (1, 1), s1, 0, gen)
                self._convbn(name + '_c2', mid, mid, (3, 3), s2, 1, gen)
                self._convbn(name + '_c3', mid, out_ch, (1, 1), 1, 0, gen)
            else:
                self._convbn(name + '_c1', in_ch, out_ch, (3, 3), stride, 1,
                             gen)
                self._convbn(name + '_c2', out_ch, out_ch, (3, 3), 1, 1, gen)
            self.units.append((name, resize))
        self.output = _Dense(out_ch, num_classes, gen)

    def _convbn(self, name, in_ch, feats, kernel, stride, pad, gen):
        self.add_module(name + '_conv', _Conv(in_ch, feats, kernel, stride,
                                              pad, gen))
        self.add_module(name + '_bn', _BatchNorm(feats))

    def _run(self, name, x, train):
        return getattr(self, name + '_bn')(getattr(self, name + '_conv')(x),
                                           train)

    def forward(self, x, *, train: bool = False):
        x = F.relu(self._run('init', x, train))
        if not self.cifar:
            x, _ = L.quant_max_pool(x, None, (3, 3), (2, 2), _PAD1)
        for name, resize in self.units:
            identity = self._run(name + '_id', x, train) if resize else x
            h = F.relu(self._run(name + '_c1', x, train))
            if self.bottleneck:
                h = F.relu(self._run(name + '_c2', h, train))
                h = self._run(name + '_c3', h, train)
            else:
                h = self._run(name + '_c2', h, train)
            x = F.relu(h + identity)
        return self.output(x.mean(dim=(1, 2)))


# ---------------------------------------------------------------------------
# weights and state carried across
# ---------------------------------------------------------------------------

def qat_to_numpy(model: nn.Module) -> Dict[str, Dict]:
    """The model's parameters and buffers as a flax variables tree of numpy
    arrays: ``{'params': {...}, 'batch_stats': {...}, 'quant_stats': {...}}``,
    nested by submodule name (copies; they do not follow later steps)."""
    tree: Dict[str, Dict] = {'params': {}, 'batch_stats': {},
                             'quant_stats': {}}

    def put(collection, path, t):
        node = tree[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = t.detach().cpu().numpy().copy()

    for name, p in model.named_parameters():
        put('params', name.split('.'), p)
    for name, b in model.named_buffers():
        path = name.split('.')
        put(_BUFFER_COLLECTION[path[-1]], path, b)
    return tree


def qat_from_numpy(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load a flax variables tree (numpy, as :func:`qat_to_numpy` returns it
    or as ``hawq_tpu`` holds it) into the model's parameters and buffers, in
    place, on the model's device.  Every parameter must be present with its
    shape; a missing statistics collection leaves those buffers as they
    are."""

    def get(collection, path):
        node = variables.get(collection)
        for part in path:
            if node is None or part not in node:
                return None
            node = node[part]
        return node

    with torch.no_grad():
        for name, p in model.named_parameters():
            src = get('params', name.split('.'))
            if src is None:
                raise KeyError(f'no parameter {name} in the variables tree')
            src = np.asarray(src)
            if src.shape != tuple(p.shape):
                raise ValueError(f'{name}: shape {src.shape}, expected '
                                 f'{tuple(p.shape)}')
            p.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))
        for name, b in model.named_buffers():
            path = name.split('.')
            src = get(_BUFFER_COLLECTION[path[-1]], path)
            if src is not None:
                b.copy_(torch.from_numpy(
                    np.array(src, dtype=np.float32).reshape(tuple(b.shape))))
    return model
