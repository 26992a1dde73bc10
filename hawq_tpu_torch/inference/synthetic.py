"""Synthetic frozen models for latency runs and compile checks (port of
hawq_tpu/inference/synthetic.py: ResNet v1 and v2, MobileNetV2,
InceptionV3).

Random integer weights and plausible scales from a numpy seed; the same
seed gives tensors identical to the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from hawq_tpu_torch.configs.bit_config import (BitConfig, RESNET_UNITS,
                                               RESNET_CONVS_PER_UNIT,
                                               RESNET_CIFAR_ARCHS)
from hawq_tpu_torch.inference.freeze import FrozenModel

# Channel tables of hawq_tpu/models/resnet.py: (bottleneck mids, stage outs).
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
    'resnet20_cifar': (None, (16, 32, 64)),
    'resnet56_cifar': (None, (16, 32, 64)),
    'resnet110_cifar': (None, (16, 32, 64)),
    'resnet164_cifar': ((16, 32, 64), (64, 128, 256)),
}
_INIT_FEATURES = {'tiny18': 16, 'tiny50': 16, 'wide50': 64,
                  'resnet20_cifar': 16, 'resnet56_cifar': 16,
                  'resnet110_cifar': 16, 'resnet164_cifar': 16}


def _gauss_weight_ints(rng, n: int, shape) -> np.ndarray:
    """Gaussian integer weights ~N(0, (n/3.5)²) clipped to ±n, the
    distribution of real per-channel quantized weights."""
    w = np.round(rng.normal(0.0, n / 3.5, shape))
    return np.clip(w, -n, n).astype(np.int8)


class _TensorGen:
    """The random tensor emitters the synthetic builders share, drawing from
    one numpy RandomState in the reference's order."""

    def __init__(self, cfg: BitConfig, seed: int):
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        self.tensors: Dict[str, np.ndarray] = {}

    def act(self, key: str):
        self.tensors[key + '.act_scale'] = np.float32(
            0.05 * (1.0 + 0.1 * self.rng.rand()))

    def conv(self, key: str, kh, kw, cin, cout):
        self.dense(key, cin, cout, shape=(kh, kw, cin, cout))

    def dense(self, key: str, cin, cout, shape=None):
        n = 2 ** (self.cfg.weight_bits(key) - 1) - 1
        self.tensors[key + '.weight_int'] = _gauss_weight_ints(
            self.rng, n, (cin, cout) if shape is None else shape)
        self.tensors[key + '.bias_int'] = self.rng.randint(
            -2 ** 16, 2 ** 16, (cout,)).astype(np.int32)
        self.tensors[key + '.weight_scale'] = (
            0.002 * (0.5 + self.rng.rand(cout))).astype(np.float32)


def synthetic_frozen_resnet(arch: str, cfg: BitConfig,
                            num_classes: int = 1000,
                            seed: int = 0) -> FrozenModel:
    g = _TensorGen(cfg, seed)
    bottleneck = RESNET_CONVS_PER_UNIT[arch] == 3
    mids, outs = _STAGE_CHANNELS[arch]

    g.act('quant_input')
    init_feats = _INIT_FEATURES.get(arch, 64)
    init_key = 'quant_init_convbn' if bottleneck else 'quant_init_block_convbn'
    init_k = 3 if arch in RESNET_CIFAR_ARCHS else 7
    g.conv(init_key, init_k, init_k, 3, init_feats)
    g.act('quant_act_int32')

    in_ch = init_feats
    for s, n_units in enumerate(RESNET_UNITS[arch], start=1):
        for u in range(1, n_units + 1):
            p = f'stage{s}.unit{u}'
            stride = 2 if (u == 1 and s > 1) else 1
            out_ch = outs[s - 1]
            resize = (u == 1) and (in_ch != out_ch or stride != 1)
            g.act(f'{p}.quant_act')
            if resize:
                g.conv(f'{p}.quant_identity_convbn', 1, 1, in_ch, out_ch)
            if bottleneck:
                mid = mids[s - 1]
                g.conv(f'{p}.quant_convbn1', 1, 1, in_ch, mid)
                g.act(f'{p}.quant_act1')
                g.conv(f'{p}.quant_convbn2', 3, 3, mid, mid)
                g.act(f'{p}.quant_act2')
                g.conv(f'{p}.quant_convbn3', 1, 1, mid, out_ch)
            else:
                g.conv(f'{p}.quant_convbn1', 3, 3, in_ch, out_ch)
                g.act(f'{p}.quant_act1')
                g.conv(f'{p}.quant_convbn2', 3, 3, out_ch, out_ch)
            g.act(f'{p}.quant_act_int32')
            in_ch = out_ch

    g.act('quant_act_output')
    g.dense('quant_output', in_ch, num_classes)
    return FrozenModel(arch=arch, cfg=cfg, tensors=g.tensors,
                       num_classes=num_classes)


def synthetic_frozen_resnet_v2(arch: str, cfg: BitConfig,
                               num_classes: int = 1000,
                               seed: int = 0) -> FrozenModel:
    """Random-integer FrozenModel in freeze_resnet_v2's namespace
    (``arch`` e.g. 'resnet50v2')."""
    base = arch[:-2]
    g = _TensorGen(cfg, seed)
    bottleneck = RESNET_CONVS_PER_UNIT[base] == 3
    mids, outs = _STAGE_CHANNELS[base]
    init_feats = _INIT_FEATURES.get(base, 64)

    g.act('quant_input')
    g.conv('quant_init_conv', 7, 7, 3, init_feats)
    g.act('quant_act_int32')

    in_ch = init_feats
    for s, n_units in enumerate(RESNET_UNITS[base], start=1):
        for u in range(1, n_units + 1):
            p = f'stage{s}.unit{u}'
            stride = 2 if (u == 1 and s > 1) else 1
            out_ch = outs[s - 1]
            # the standalone integer BN on the residual stream
            g.tensors[f'{p}.quant_bn.bn_factor'] = (
                0.5 + g.rng.rand(in_ch)).astype(np.float32)
            g.tensors[f'{p}.quant_bn.bn_bias'] = (
                g.rng.randn(in_ch) * 0.1).astype(np.float32)
            g.act(f'{p}.quant_act')
            if (in_ch != out_ch) or stride != 1:
                g.conv(f'{p}.quant_identity_conv', 1, 1, in_ch, out_ch)
            if bottleneck:
                mid = mids[s - 1]
                g.conv(f'{p}.quant_conv1', 1, 1, in_ch, mid)
                g.act(f'{p}.quant_act1')
                g.conv(f'{p}.quant_conv2', 3, 3, mid, mid)
                g.act(f'{p}.quant_act2')
                g.conv(f'{p}.quant_conv3', 1, 1, mid, out_ch)
            else:
                g.conv(f'{p}.quant_conv1', 3, 3, in_ch, out_ch)
                g.act(f'{p}.quant_act1')
                g.conv(f'{p}.quant_conv2', 3, 3, out_ch, out_ch)
            g.act(f'{p}.quant_act_int32')
            in_ch = out_ch

    g.act('quant_act_output')
    g.dense('quant_output', in_ch, num_classes)
    return FrozenModel(arch=arch, cfg=cfg, tensors=g.tensors,
                       num_classes=num_classes)


def synthetic_frozen_mobilenet(cfg: BitConfig, num_classes: int = 1000,
                               seed: int = 0, stages=None, init_ch=None,
                               final_ch=None) -> FrozenModel:
    """Random-integer FrozenModel in freeze_mobilenetv2's namespace; the
    full-width MobileNetV2 unless ``stages`` / ``init_ch`` / ``final_ch``
    say otherwise."""
    from hawq_tpu_torch.models.mobilenetv2 import (MOBILENETV2_STAGES,
                                                   MOBILENETV2_INIT_CH,
                                                   MOBILENETV2_FINAL_CH)
    stages = MOBILENETV2_STAGES if stages is None else stages
    init_ch = MOBILENETV2_INIT_CH if init_ch is None else init_ch
    final_ch = MOBILENETV2_FINAL_CH if final_ch is None else final_ch
    g = _TensorGen(cfg, seed)
    g.act('quant_input')
    g.conv('init_block', 3, 3, 3, init_ch)
    g.act('quant_act_int32')
    in_ch = init_ch
    for i, stage in enumerate(stages, start=1):
        for j, out_ch in enumerate(stage, start=1):
            p = f'features.stage{i}.unit{j}'
            mid = in_ch * (1 if (i == 1 and j == 1) else 6)
            g.act(f'{p}.quant_act')
            g.conv(f'{p}.conv1', 1, 1, in_ch, mid)
            g.act(f'{p}.quant_act1')
            g.conv(f'{p}.conv2', 3, 3, 1, mid)         # depthwise HWIO
            g.act(f'{p}.quant_act2')
            g.conv(f'{p}.conv3', 1, 1, mid, out_ch)
            g.act(f'{p}.quant_act_int32')
            in_ch = out_ch
    g.act('quant_act_before_final_block')
    g.conv('features.final_block', 1, 1, in_ch, final_ch)
    g.act('quant_act_int32_final')
    g.act('quant_act_output')
    g.conv('output', 1, 1, final_ch, num_classes)      # the 1×1 conv head
    return FrozenModel(arch='mobilenetv2', cfg=cfg, tensors=g.tensors,
                       num_classes=num_classes)


def synthetic_frozen_inception(cfg: BitConfig, num_classes: int = 1000,
                               width_div: int = 1,
                               seed: int = 0) -> FrozenModel:
    """Random-integer FrozenModel in freeze_inceptionv3's namespace,
    walking the branch specifications of ``models.inceptionv3.build_unit``
    that the model, the freezer and the engine share."""
    from hawq_tpu_torch.models import inceptionv3 as mi
    g = _TensorGen(cfg, seed)

    def incept_conv(prefix, kh, kw, cin, cout):
        g.conv(f'{prefix}.q_convbn', kh, kw, cin, cout)
        g.act(f'{prefix}.q_activ')

    ip = 'features.q_init_block'
    g.act(f'{ip}.q_input_activ')
    cin = 3
    for c, (ch, (_, k, _, _)) in enumerate(
            zip(mi.init_channels(width_div), mi.INIT_CONVS), start=1):
        incept_conv(f'{ip}.q_conv{c}', k, k, cin, ch)
        cin = ch

    in_ch = cin
    for _, _, unit in mi.units(width_div):
        for name, kind, kwargs in unit.branch_defs:
            bp = f'{unit.prefix}.branches.{name}'
            g.act(f'{bp}.q_input_act')
            if kind == mi.AVG_POOL:
                g.act(f'{bp}.q_pool_act')
            if kind in (mi.CONV1X1, mi.AVG_POOL):
                incept_conv(f'{bp}.q_conv', 1, 1, in_ch, kwargs['features'])
            elif kind in (mi.CONV_SEQ, mi.CONV_SEQ_3X3):
                c_in = in_ch
                for c, (oc, kz) in enumerate(
                        zip(kwargs['out_channels'], kwargs['kernels']),
                        start=1):
                    incept_conv(f'{bp}.q_conv_list.q_conv{c}',
                                *mi._ksize(kz), c_in, oc)
                    c_in = oc
                if kind == mi.CONV_SEQ_3X3:
                    incept_conv(f'{bp}.q_conv1x3', 1, 3, c_in, c_in)
                    incept_conv(f'{bp}.q_conv3x1', 3, 1, c_in, c_in)
                    g.act(f'{bp}.q_rescaling_activ')
        g.act(f'{unit.prefix}.q_rescaling_activ')
        in_ch = mi.unit_out_channels(unit, in_ch)

    g.act('features.q_concat_activ')
    g.dense('output.q_fc', in_ch, num_classes)
    return FrozenModel(arch='inceptionv3', cfg=cfg, tensors=g.tensors,
                       num_classes=num_classes)


def dyadic_scales(fm):
    """A copy of a frozen model whose scales are powers of two (the integers
    kept): every weight scale rounded to the nearest one, every activation
    scale too, then doubled 0, 1 or 2 times by its key (the sum of the
    key's characters mod 3, so neighbouring nodes differ).  Every requant
    ratio is then a power of two, most of them below 1, and the
    accumulators land on exact ties (odd multiples of half the ratio's
    step), where the native requant rounds half-up and the reference
    checkpoint's rounds half-even: the model on which the two requant modes
    give different integers.  ``fm`` may be any dataclass with ``tensors``
    (this package's FrozenModel or the JAX package's)."""
    def pow2(key, v):
        v = np.asarray(v)
        e = np.round(np.log2(v.astype(np.float64)))
        if key.endswith('.act_scale'):
            e += sum(map(ord, key)) % 3
        return np.exp2(e).astype(v.dtype)
    return dataclasses.replace(fm, tensors={
        k: pow2(k, v) if k.endswith(('.act_scale', '.weight_scale')) else v
        for k, v in fm.tensors.items()})
