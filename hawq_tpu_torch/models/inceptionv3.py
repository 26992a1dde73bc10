"""Quantized InceptionV3 (port of hawq_tpu/models/inceptionv3.py), NHWC.

The graph's structure lives here once, as data: :func:`build_unit` gives a
unit's branch specifications, which the QAT model, the synthetic weights,
the freezer and the integer engine all walk.  A branch is one of

  * ``CONV1X1``: input requant, a 1×1 conv;
  * ``CONV_SEQ``: input requant, a chain of convs;
  * ``MAX_POOL``: input requant, a 3×3/s2 VALID max-pool;
  * ``AVG_POOL``: input requant, the 3×3/s1/p1 integer average pool, its
    requant (``q_pool_act``), a 1×1 conv;
  * ``CONV_SEQ_3X3``: input requant, a chain of convs, then parallel 1×3 and
    3×1 convs concatenated with a per-branch requant.

A unit concatenates its branches, each requantized to one shared scale by
the unit's rescaling ``QuantAct`` (its branch case).  Every conv is conv+BN
→ ReLU → requant (``_InceptConv``).  The stem is 5 convs and 2 max-pools;
the head an integer global average pool, a requant, dropout and the FC.

Config keys are the reference's ('features.stage1.unit1.branches.branch2.
q_conv_list.q_conv1.q_convbn' …); submodules and parameters keep the flax
names (``q_conv1``, ``stage1_unit1.branch2.q_conv1.q_convbn`` …), so
``models.resnet.qat_from_numpy`` / ``qat_to_numpy`` carry the variables
across.  ``width_div`` divides every channel count (at least 4) for the
small test variant.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hawq_tpu_torch.configs.bit_config import BitConfig
from hawq_tpu_torch.inference.fold import (depth_to_space_2x2,
                                           fold4_3x3s2_geometry)
from hawq_tpu_torch.models.resnet import (_BatchNorm, _Conv, _Dense,
                                          _qact, _qconvbn, _relu_acc)
from hawq_tpu_torch.nn import layers as L

INCEPTION_CHANNELS = ((256, 288, 288), (768, 768, 768, 768, 768),
                      (1280, 2048, 2048))
INCEPTION_B_MID = (128, 160, 160, 192)
INCEPTION_INIT_CH = 192
# the stem's q_conv1..5: (channels, kernel, stride, padding); a 3×3/s2
# VALID max-pool follows q_conv3 and q_conv5
INIT_CONVS = ((32, 3, 2, 0), (32, 3, 1, 0), (64, 3, 1, 1), (80, 1, 1, 0),
              (192, 3, 1, 0))
INIT_POOLS = (3, 5)

# branch kinds
CONV1X1, CONV_SEQ, MAX_POOL, AVG_POOL, CONV_SEQ_3X3 = (
    'conv1x1', 'conv_seq', 'max_pool', 'avg_pool', 'conv_seq_3x3')


def _cdiv(c: int, w: int) -> int:
    return max(c // w, 4)


def _pad(p) -> tuple:
    if isinstance(p, int):
        return ((p, p), (p, p))
    return ((p[0], p[0]), (p[1], p[1]))


def _ksize(k) -> Tuple[int, int]:
    return (k, k) if isinstance(k, int) else tuple(k)


class Unit(NamedTuple):
    """One inception unit: its config prefix, module name and branches,
    each (name, kind, keyword arguments)."""
    prefix: str
    name: str
    branch_defs: Tuple


def init_channels(width_div: int = 1) -> Tuple[int, ...]:
    return tuple(_cdiv(c, width_div) if width_div > 1 else c
                 for c, _, _, _ in INIT_CONVS)


def _unit_a(prefix, out_channels, name, w=1):
    pool_ch = _cdiv(out_channels - 224, w) if w > 1 else out_channels - 224
    d = lambda c: _cdiv(c, w)
    return Unit(prefix, name, (
        ('branch1', CONV1X1, dict(features=d(64))),
        ('branch2', CONV_SEQ, dict(out_channels=(d(48), d(64)),
                                   kernels=(1, 5), strides=(1, 1),
                                   paddings=(0, 2))),
        ('branch3', CONV_SEQ, dict(out_channels=(d(64), d(96), d(96)),
                                   kernels=(1, 3, 3), strides=(1, 1, 1),
                                   paddings=(0, 1, 1))),
        ('branch4', AVG_POOL, dict(features=pool_ch)),
    ))


def _unit_reduction_a(prefix, name, w=1):
    d = lambda c: _cdiv(c, w)
    return Unit(prefix, name, (
        ('branch1', CONV_SEQ, dict(out_channels=(d(384),), kernels=(3,),
                                   strides=(2,), paddings=(0,))),
        ('branch2', CONV_SEQ, dict(out_channels=(d(64), d(96), d(96)),
                                   kernels=(1, 3, 3), strides=(1, 1, 2),
                                   paddings=(0, 1, 0))),
        ('branch3', MAX_POOL, dict()),
    ))


def _unit_b(prefix, mid, name, w=1):
    d = lambda c: _cdiv(c, w)
    mid = d(mid)
    return Unit(prefix, name, (
        ('branch1', CONV1X1, dict(features=d(192))),
        ('branch2', CONV_SEQ, dict(out_channels=(mid, mid, d(192)),
                                   kernels=(1, (1, 7), (7, 1)),
                                   strides=(1, 1, 1),
                                   paddings=(0, (0, 3), (3, 0)))),
        ('branch3', CONV_SEQ, dict(
            out_channels=(mid, mid, mid, mid, d(192)),
            kernels=(1, (7, 1), (1, 7), (7, 1), (1, 7)),
            strides=(1, 1, 1, 1, 1),
            paddings=(0, (3, 0), (0, 3), (3, 0), (0, 3)))),
        ('branch4', AVG_POOL, dict(features=d(192))),
    ))


def _unit_reduction_b(prefix, name, w=1):
    d = lambda c: _cdiv(c, w)
    return Unit(prefix, name, (
        ('branch1', CONV_SEQ, dict(out_channels=(d(192), d(320)),
                                   kernels=(1, 3), strides=(1, 2),
                                   paddings=(0, 0))),
        ('branch2', CONV_SEQ, dict(
            out_channels=(d(192), d(192), d(192), d(192)),
            kernels=(1, (1, 7), (7, 1), 3),
            strides=(1, 1, 1, 2),
            paddings=(0, (0, 3), (3, 0), 0))),
        ('branch3', MAX_POOL, dict()),
    ))


def _unit_c(prefix, name, w=1):
    d = lambda c: _cdiv(c, w)
    return Unit(prefix, name, (
        ('branch1', CONV1X1, dict(features=d(320))),
        ('branch2', CONV_SEQ_3X3, dict(out_channels=(d(384),), kernels=(1,),
                                       strides=(1,), paddings=(0,))),
        ('branch3', CONV_SEQ_3X3, dict(out_channels=(d(448), d(384)),
                                       kernels=(1, 3), strides=(1, 1),
                                       paddings=(0, 1))),
        ('branch4', AVG_POOL, dict(features=d(192))),
    ))


def build_unit(i, j, out_ch, b_mid_idx, name=None, width_div=1) -> Unit:
    """The unit of stage i, unit j, shared by the model, the synthetic
    weights, the freezer and the engine so the graph's structure stays in
    one place (the reference's ``build_unit`` without its config argument:
    the structure does not depend on it)."""
    prefix = f'features.stage{i}.unit{j}'
    name = name or f'stage{i}_unit{j}'
    if j == 1 and i != 1:
        return (_unit_reduction_a(prefix, name, width_div) if i == 2
                else _unit_reduction_b(prefix, name, width_div))
    if i == 1:
        return _unit_a(prefix, out_ch, name, width_div)
    if i == 2:
        return _unit_b(prefix, INCEPTION_B_MID[b_mid_idx], name, width_div)
    return _unit_c(prefix, name, width_div)


def units(width_div: int = 1):
    """(stage, unit, :class:`Unit`) of every unit, in order."""
    b_idx = 0
    for i, stage in enumerate(INCEPTION_CHANNELS, start=1):
        for j, out_ch in enumerate(stage, start=1):
            yield i, j, build_unit(i, j, out_ch, b_idx, width_div=width_div)
            if i == 2 and j != 1:
                b_idx += 1


def branch_out_channels(kind: str, kwargs, in_ch: int) -> int:
    """Output channels of a branch on ``in_ch`` input channels."""
    if kind in (CONV1X1, AVG_POOL):
        return kwargs['features']
    if kind == MAX_POOL:
        return in_ch
    last = kwargs['out_channels'][-1]
    return 2 * last if kind == CONV_SEQ_3X3 else last


def unit_out_channels(unit: Unit, in_ch: int) -> int:
    return sum(branch_out_channels(kind, kw, in_ch)
               for _, kind, kw in unit.branch_defs)


# ---------------------------------------------------------------------------
# the QAT modules
# ---------------------------------------------------------------------------

class _InceptConv(nn.Module):
    """conv+BN → ReLU → requant (``q_convbn``, ``q_activ``)."""

    def __init__(self, cfg, prefix, in_ch, features, kernel, stride=1,
                 padding=0, generator=None):
        super().__init__()
        self.q_convbn = _qconvbn(cfg, f'{prefix}.q_convbn', in_ch, features,
                                 _ksize(kernel), (stride, stride),
                                 _pad(padding), generator)
        self.q_activ = _qact(cfg, f'{prefix}.q_activ')

    def forward(self, x, a_sf, *, folded=True, update_stats=False):
        h, w_sf, acc = self.q_convbn(x, a_sf, folded=folded,
                                     update_stats=update_stats)
        return self.q_activ(F.relu(h), a_sf, w_sf, x_int=_relu_acc(acc),
                            update_stats=update_stats)


class _Branch(nn.Module):
    """One branch of a unit, built from its specification."""

    def __init__(self, cfg, prefix, kind, kwargs, in_ch, generator=None):
        super().__init__()
        self.kind = kind
        self.q_input_act = _qact(cfg, f'{prefix}.q_input_act')
        self.convs = []
        if kind in (CONV1X1, AVG_POOL):
            if kind == AVG_POOL:
                self.q_pool_act = _qact(cfg, f'{prefix}.q_pool_act')
            self.q_conv = _InceptConv(cfg, f'{prefix}.q_conv', in_ch,
                                      kwargs['features'], 1,
                                      generator=generator)
        elif kind in (CONV_SEQ, CONV_SEQ_3X3):
            c_in = in_ch
            for i, (c, k, s, p) in enumerate(zip(
                    kwargs['out_channels'], kwargs['kernels'],
                    kwargs['strides'], kwargs['paddings']), start=1):
                self.add_module(f'q_conv{i}', _InceptConv(
                    cfg, f'{prefix}.q_conv_list.q_conv{i}', c_in, c, k, s, p,
                    generator))
                self.convs.append(f'q_conv{i}')
                c_in = c
            if kind == CONV_SEQ_3X3:
                self.q_conv1x3 = _InceptConv(cfg, f'{prefix}.q_conv1x3', c_in,
                                             c_in, (1, 3), 1, (0, 1),
                                             generator)
                self.q_conv3x1 = _InceptConv(cfg, f'{prefix}.q_conv3x1', c_in,
                                             c_in, (3, 1), 1, (1, 0),
                                             generator)
                self.q_rescaling_activ = _qact(
                    cfg, f'{prefix}.q_rescaling_activ')

    def forward(self, x, in_sf, *, folded=True, update_stats=False):
        kw = dict(folded=folded, update_stats=update_stats)
        h, a_sf = self.q_input_act(x, in_sf, update_stats=update_stats)
        if self.kind == MAX_POOL:
            return L.quant_max_pool(h, a_sf, (3, 3), (2, 2), 'VALID')
        if self.kind == AVG_POOL:
            h, a_sf = L.quant_avg_pool(h, a_sf, (3, 3), (1, 1),
                                       ((1, 1), (1, 1)))
            h, a_sf = self.q_pool_act(h, a_sf, update_stats=update_stats)
        if self.kind in (CONV1X1, AVG_POOL):
            return self.q_conv(h, a_sf, **kw)
        for name in self.convs:
            h, a_sf = getattr(self, name)(h, a_sf, **kw)
        if self.kind == CONV_SEQ:
            return h, a_sf
        y1, sf1 = self.q_conv1x3(h, a_sf, **kw)
        y2, sf2 = self.q_conv3x1(h, a_sf, **kw)
        return self.q_rescaling_activ(
            torch.cat([y1, y2], dim=-1), branch_scales=[sf1, sf2],
            branch_channels=[y1.shape[-1], y2.shape[-1]], pre_act_scale=sf1,
            update_stats=update_stats)


class _InceptionUnit(nn.Module):
    """Run the branches, concatenate, rescale (the unit's
    ``q_rescaling_activ``)."""

    def __init__(self, cfg, unit: Unit, in_ch, generator=None):
        super().__init__()
        self.branch_names = []
        for name, kind, kwargs in unit.branch_defs:
            self.add_module(name, _Branch(cfg, f'{unit.prefix}.branches.'
                                          f'{name}', kind, kwargs, in_ch,
                                          generator))
            self.branch_names.append(name)
        self.q_rescaling_activ = _qact(cfg,
                                       f'{unit.prefix}.q_rescaling_activ')

    def forward(self, x, in_sf, *, folded=True, update_stats=False):
        outs, sfs = [], []
        for name in self.branch_names:
            y, sf = getattr(self, name)(x, in_sf, folded=folded,
                                        update_stats=update_stats)
            outs.append(y)
            sfs.append(sf)
        return self.q_rescaling_activ(
            torch.cat(outs, dim=-1), branch_scales=sfs,
            branch_channels=[y.shape[-1] for y in outs],
            pre_act_scale=sfs[0], update_stats=update_stats)


class QInceptionV3(nn.Module):
    """Quantized InceptionV3, 299×299 input.  ``width_div`` scales every
    channel count down (the same wiring) for the small test variant;
    ``seed`` makes the initial weights (a ``torch.Generator``; they need not
    equal the flax initializers').  The head's dropout drops only when the
    forward gets a ``generator`` (the train step passes one)."""

    def __init__(self, cfg: Optional[BitConfig] = None,
                 num_classes: int = 1000, width_div: int = 1,
                 dropout_rate: float = 0.5, seed: int = 0):
        super().__init__()
        cfg = cfg if cfg is not None else BitConfig(
            name='inceptionv3_uniform8', table={})
        self.cfg, self.num_classes = cfg, num_classes
        self.width_div = width_div
        gen = torch.Generator().manual_seed(seed)
        ip = 'features.q_init_block'
        self.q_input_activ = _qact(cfg, f'{ip}.q_input_activ')
        c_in = 3
        for i, (c, (_, k, s, p)) in enumerate(
                zip(init_channels(width_div), INIT_CONVS), start=1):
            self.add_module(f'q_conv{i}', _InceptConv(
                cfg, f'{ip}.q_conv{i}', c_in, c, k, s, p, gen))
            c_in = c
        self.unit_names = []
        for i, j, unit in units(width_div):
            self.add_module(unit.name, _InceptionUnit(cfg, unit, c_in, gen))
            self.unit_names.append(unit.name)
            c_in = unit_out_channels(unit, c_in)
        self.q_concat_activ = _qact(cfg, 'features.q_concat_activ')
        self.q_dropout = L.QuantDropout(dropout_rate)
        self.q_fc = L.QuantLinear(
            c_in, num_classes, weight_bit=cfg.weight_bits('output.q_fc'),
            bias_bit=cfg.settings.bias_bit,
            per_channel=cfg.settings.per_channel, generator=gen)

    def forward(self, x, *, folded: bool = True, update_stats: bool = False,
                generator: Optional[torch.Generator] = None):
        kw = dict(folded=folded, update_stats=update_stats)
        x, a_sf = self.q_input_activ(x, update_stats=update_stats)
        for i in range(1, len(INIT_CONVS) + 1):
            x, a_sf = getattr(self, f'q_conv{i}')(x, a_sf, **kw)
            if i in INIT_POOLS:
                x, a_sf = L.quant_max_pool(x, a_sf, (3, 3), (2, 2), 'VALID')
        for name in self.unit_names:
            x, a_sf = getattr(self, name)(x, a_sf, **kw)
        x, a_sf = L.quant_avg_pool(x, a_sf, (x.shape[1], x.shape[2]))
        x, a_sf = self.q_concat_activ(x, a_sf, update_stats=update_stats)
        x = x.reshape(x.shape[0], -1)
        x, a_sf = self.q_dropout(x, a_sf, generator=generator)
        return self.q_fc(x, a_sf)


# ---------------------------------------------------------------------------
# fp32 twin
# ---------------------------------------------------------------------------

class FloatInceptionV3(nn.Module):
    """fp32 baseline with the same topology, built from the same unit
    specifications; submodules carry the flax names (``init_c1_conv`` /
    ``init_c1_bn``, ``s1u1b2_c1_conv`` …, ``output``).  ``folded_input``:
    the images arrive host-folded (``inference.fold.fold4_images_3x3s2(x,
    0)``) and ``init_c1`` runs as its 2×2/s1 rewrite over the fold (4·C
    outputs, the four stride-2 origins), then depth-to-space and the slice
    to the output size of ``input_hw``."""

    def __init__(self, num_classes: int = 1000, width_div: int = 1,
                 folded_input: bool = False,
                 input_hw: Sequence[int] = (299, 299), seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.folded_input = folded_input
        self.input_hw = tuple(input_hw)
        c_in = 3
        for i, (c, (_, k, s, p)) in enumerate(
                zip(init_channels(width_div), INIT_CONVS), start=1):
            if i == 1 and folded_input:
                self._convbn(f'init_c{i}', 48, 4 * c, 2, 1, 0, gen)
            else:
                self._convbn(f'init_c{i}', c_in, c, k, s, p, gen)
            c_in = c
        # per unit, per branch: (kind, its conv names, its name prefix)
        self.plan = []
        for i, j, unit in units(width_div):
            parts = []
            for b, (_, kind, kw) in enumerate(unit.branch_defs, start=1):
                pre = f's{i}u{j}b{b}'
                names = []
                if kind in (CONV1X1, AVG_POOL):
                    self._convbn(pre, c_in, kw['features'], 1, 1, 0, gen)
                    names = [pre]
                elif kind in (CONV_SEQ, CONV_SEQ_3X3):
                    convs = list(zip(kw['out_channels'], kw['kernels'],
                                     kw['strides'], kw['paddings']))
                    # flax names a lone conv before the 1×3 / 3×1 pair
                    # '<pre>c1', a chain '<pre>_c<n>'
                    names = ([pre + 'c1'] if kind == CONV_SEQ_3X3
                             and len(convs) == 1 else
                             [f'{pre}_c{n}' for n in range(1, len(convs) + 1)])
                    ch = c_in
                    for name, (c, k, s, p) in zip(names, convs):
                        self._convbn(name, ch, c, k, s, p, gen)
                        ch = c
                    if kind == CONV_SEQ_3X3:
                        self._convbn(pre + 'h', ch, ch, (1, 3), 1, (0, 1), gen)
                        self._convbn(pre + 'v', ch, ch, (3, 1), 1, (1, 0), gen)
                parts.append((kind, names, pre))
            self.plan.append(parts)
            c_in = unit_out_channels(unit, c_in)
        self.output = _Dense(c_in, num_classes, gen)

    def _convbn(self, name, in_ch, feats, kernel, stride, pad, gen):
        (ph, _), (pw, _) = _pad(pad)
        self.add_module(name + '_conv', _Conv(in_ch, feats, _ksize(kernel),
                                              (stride, stride), (ph, pw),
                                              gen))
        self.add_module(name + '_bn', _BatchNorm(feats))

    def _run(self, name, x, train):
        y = getattr(self, name + '_conv')(x)
        return F.relu(getattr(self, name + '_bn')(y, train))

    def _branch(self, kind, names, pre, x, train):
        if kind == MAX_POOL:
            return L.quant_max_pool(x, None, (3, 3), (2, 2), 'VALID')[0]
        if kind == AVG_POOL:
            x = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1).permute(
                0, 2, 3, 1)
        for name in names:
            x = self._run(name, x, train)
        if kind != CONV_SEQ_3X3:
            return x
        return torch.cat([self._run(pre + 'h', x, train),
                          self._run(pre + 'v', x, train)], dim=-1)

    def forward(self, x, *, train: bool = False):
        for i in range(1, len(INIT_CONVS) + 1):
            x = self._run(f'init_c{i}', x, train)
            if i == 1 and self.folded_input:
                oh, ow = (fold4_3x3s2_geometry(n, 0)[0]
                          for n in self.input_hw)
                x = depth_to_space_2x2(x)[:, :oh, :ow, :]
            if i in INIT_POOLS:
                x = L.quant_max_pool(x, None, (3, 3), (2, 2), 'VALID')[0]
        for parts in self.plan:
            x = torch.cat([self._branch(*part, x, train) for part in parts],
                          dim=-1)
        return self.output(x.mean(dim=(1, 2)))
