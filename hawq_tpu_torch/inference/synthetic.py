"""Synthetic frozen ResNets for latency runs and compile checks (port of
hawq_tpu/inference/synthetic.py ``synthetic_frozen_resnet``).

Random integer weights and plausible scales from a numpy seed; the same
seed gives tensors identical to the reference's.
"""

from __future__ import annotations

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


def synthetic_frozen_resnet(arch: str, cfg: BitConfig,
                            num_classes: int = 1000,
                            seed: int = 0) -> FrozenModel:
    rng = np.random.RandomState(seed)
    tensors: Dict[str, np.ndarray] = {}
    bottleneck = RESNET_CONVS_PER_UNIT[arch] == 3
    mids, outs = _STAGE_CHANNELS[arch]

    def act(key: str):
        tensors[key + '.act_scale'] = np.float32(
            0.05 * (1.0 + 0.1 * rng.rand()))

    def conv(key: str, kh, kw, cin, cout):
        bits = cfg.weight_bits(key)
        n = 2 ** (bits - 1) - 1
        tensors[key + '.weight_int'] = _gauss_weight_ints(
            rng, n, (kh, kw, cin, cout))
        tensors[key + '.bias_int'] = rng.randint(
            -2 ** 16, 2 ** 16, (cout,)).astype(np.int32)
        tensors[key + '.weight_scale'] = (
            0.002 * (0.5 + rng.rand(cout))).astype(np.float32)

    act('quant_input')
    init_feats = _INIT_FEATURES.get(arch, 64)
    init_key = 'quant_init_convbn' if bottleneck else 'quant_init_block_convbn'
    init_k = 3 if arch in RESNET_CIFAR_ARCHS else 7
    conv(init_key, init_k, init_k, 3, init_feats)
    act('quant_act_int32')

    in_ch = init_feats
    for s, n_units in enumerate(RESNET_UNITS[arch], start=1):
        for u in range(1, n_units + 1):
            p = f'stage{s}.unit{u}'
            stride = 2 if (u == 1 and s > 1) else 1
            out_ch = outs[s - 1]
            resize = (u == 1) and (in_ch != out_ch or stride != 1)
            act(f'{p}.quant_act')
            if resize:
                conv(f'{p}.quant_identity_convbn', 1, 1, in_ch, out_ch)
            if bottleneck:
                mid = mids[s - 1]
                conv(f'{p}.quant_convbn1', 1, 1, in_ch, mid)
                act(f'{p}.quant_act1')
                conv(f'{p}.quant_convbn2', 3, 3, mid, mid)
                act(f'{p}.quant_act2')
                conv(f'{p}.quant_convbn3', 1, 1, mid, out_ch)
            else:
                conv(f'{p}.quant_convbn1', 3, 3, in_ch, out_ch)
                act(f'{p}.quant_act1')
                conv(f'{p}.quant_convbn2', 3, 3, out_ch, out_ch)
            act(f'{p}.quant_act_int32')
            in_ch = out_ch

    act('quant_act_output')
    bits = cfg.weight_bits('quant_output')
    n = 2 ** (bits - 1) - 1
    tensors['quant_output.weight_int'] = _gauss_weight_ints(
        rng, n, (in_ch, num_classes))
    tensors['quant_output.bias_int'] = rng.randint(
        -2 ** 16, 2 ** 16, (num_classes,)).astype(np.int32)
    tensors['quant_output.weight_scale'] = (
        0.002 * (0.5 + rng.rand(num_classes))).astype(np.float32)

    return FrozenModel(arch=arch, cfg=cfg, tensors=tensors,
                       num_classes=num_classes)
