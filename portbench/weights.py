"""Seeded integer weights and scales of a frozen model, made on the device.

The arrays are those of the program's frozen-model namespace (per conv or
FC ``key``: ``weight_int`` int8 HWIO, ``bias_int`` int32, ``weight_scale``
float32 per output channel; per activation node: ``act_scale`` float32),
and the same arrays go to the program and to the reference.

Weights are Gaussian integers N(0, (127/3.5)²) clipped to ±127, the shape
of real per-channel 8-bit weights.  The scales are not drawn at random:
walking the graph, each conv's weight scales are set so that its
accumulator, in real units, has an RMS near ``TARGET`` (so ReLU6 clamps a
few percent of values, as in a trained model), each bias is a fraction of
that RMS, and each activation scale puts the RMS of the values it quantizes
at ``T8`` integer steps (``T16`` for the 16-bit carriers), so that no layer
saturates or collapses to zero.  The logits then depend on the image:
without that, a lower-precision control could not fail the comparison.
Random draws take a few large calls of one ``torch.Generator`` on the
device; only the per-layer arithmetic runs on the host.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from portbench.work import common as work_common


SIGMA_W = 127 / 3.5          # RMS of the integer weights
W_SCALE_RMS = math.sqrt(1 + 1 / 12)   # RMS of the per-channel factor 0.5 + U
TARGET = 3.0                 # accumulator RMS in real units
BIAS_SHARE = 0.3             # bias RMS / accumulator RMS
T8, T16 = 32.0, 2048.0       # integer RMS of 8-bit activations, carriers
RELU = math.sqrt((1 + BIAS_SHARE ** 2) / 2)   # RMS kept by a ReLU
POOL_GAIN = 1.5              # RMS gain of the 3×3 max-pool


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of the run (weights, images,
    arrivals), from the run's seed and the stream's name."""
    digest = hashlib.sha256(f'{seed}:{tag}'.encode()).digest()
    return int.from_bytes(digest[:8], 'little') >> 1


class Plan:
    """The layers and nodes of a model with the scale arithmetic of the
    walk; the random parts are drawn in bulk by :func:`generate`."""

    def __init__(self):
        # key, shape, fan-in, input RMS, the node that quantizes the input
        self.convs: List[Tuple[str, tuple, int, float, str]] = []
        self.acts: Dict[str, float] = {}            # node → its scale

    def conv(self, key: str, shape: tuple, fan_in: int, v_in: float,
             s_in_key: str) -> float:
        """A conv on inputs of RMS ``v_in`` (real) quantized by node
        ``s_in_key``; returns its accumulator's RMS, bias included."""
        self.convs.append((key, shape, fan_in, v_in, s_in_key))
        return TARGET * math.sqrt(1 + BIAS_SHARE ** 2)

    def act(self, key: str, v: float, target: float) -> None:
        self.acts[key] = v / target




def family_plan(config: Mapping) -> 'Plan':
    """The configuration's plan, from its family's ``work`` module."""
    return work_common.family(config).plan(config)


def generate(config: Mapping, seed: int,
             device='cpu') -> Dict[str, np.ndarray]:
    """The frozen model's arrays for ``seed``, drawn on ``device``."""
    plan = family_plan(config)
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, 'weights'))
    n_w = sum(math.prod(shape) for _, shape, *_ in plan.convs)
    n_c = sum(shape[-1] for _, shape, *_ in plan.convs)
    w_all = torch.clamp(torch.round(torch.randn(
        n_w, generator=gen, device=device) * SIGMA_W), -127, 127).to(
            torch.int8).cpu().numpy()
    factors = (0.5 + torch.rand(n_c, generator=gen, device=device)
               ).cpu().numpy().astype(np.float32)
    bias_n = torch.randn(n_c, generator=gen, device=device).cpu().numpy()
    jitter = (1.0 + 0.1 * torch.rand(len(plan.acts), generator=gen,
                                     device=device)).cpu().numpy()

    out: Dict[str, np.ndarray] = {}
    for (key, v), j in zip(plan.acts.items(), jitter):
        out[key + '.act_scale'] = np.float32(v * j)
    iw = ic = 0
    for key, shape, fan_in, v_in, s_in_key in plan.convs:
        n, c = math.prod(shape), shape[-1]
        out[key + '.weight_int'] = w_all[iw:iw + n].reshape(shape)
        base = TARGET / (math.sqrt(fan_in) * v_in * SIGMA_W * W_SCALE_RMS)
        w_scale = (base * factors[ic:ic + c]).astype(np.float32)
        out[key + '.weight_scale'] = w_scale
        acc_unit = w_scale.astype(np.float64) * float(
            out[s_in_key + '.act_scale'])
        out[key + '.bias_int'] = np.round(
            bias_n[ic:ic + c] * BIAS_SHARE * TARGET / acc_unit).astype(
                np.int32)
        iw, ic = iw + n, ic + c
    return out


def generate_float(config: Mapping, seed: int, device='cpu'):
    """The float QAT state for ``seed`` → (params, stats), keyed as the
    frozen model is (``<conv>.kernel`` HWIO, ``.gamma``, ``.beta``; the
    head's ``.kernel`` (in, classes) and ``.bias``; ``<conv>.mean``,
    ``.var``; ``<node>.x_min``, ``.x_max``), as a model starts QAT: He
    normal kernels (gain 2, the head's gain 1) clipped at 2σ, γ = 1, β = 0,
    running mean 0 and variance 1, no ranges yet."""
    plan = family_plan(config)
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, 'float weights'))
    n_w = sum(math.prod(shape) for _, shape, *_ in plan.convs)
    w_all = torch.randn(n_w, generator=gen, device=device)
    params, stats = {}, {}
    head = plan.convs[-1][0]
    i = 0
    for key, shape, fan_in, *_ in plan.convs:
        n = math.prod(shape)
        std = math.sqrt((1.0 if key == head else 2.0) / fan_in) / 0.87962566
        params[key + '.kernel'] = torch.clamp(
            w_all[i:i + n] * std, -2 * std, 2 * std).reshape(shape)
        i += n
        c = shape[-1]
        if key == head:
            params[key + '.bias'] = torch.zeros(c, device=device)
            continue
        params[key + '.gamma'] = torch.ones(c, device=device)
        params[key + '.beta'] = torch.zeros(c, device=device)
        stats[key + '.mean'] = torch.zeros(c, device=device)
        stats[key + '.var'] = torch.ones(c, device=device)
    for key in plan.acts:
        stats[key + '.x_min'] = torch.zeros((), device=device)
        stats[key + '.x_max'] = torch.zeros((), device=device)
    return params, stats
