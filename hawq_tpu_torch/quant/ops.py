"""Integer-side quantization numerics (port of hawq_tpu/quant/ops.py).

The frozen engine's requant is the framework-canonical dyadic arithmetic

    out = clip(floor(f32(acc) * m·2⁻ᵉ + 0.5), lo, hi)

with the multiplier snapped to a 23-bit mantissa so that it is an exact
float32 (see hawq_tpu/quant/ops.py for the derivation).  Bit-exactness with
the reference needs a rounded multiply followed by a rounded add: eager
PyTorch runs ``*`` and ``+`` as separate kernels, so no FMA contraction can
merge them here; the CUDA epilogues use ``__fmul_rn``/``__fadd_rn``.

Multipliers are computed on the host in numpy float32
(:func:`np_dyadic_multiplier`), never on the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Number of mantissa bits in the dyadic multiplier (m ∈ [2²², 2²³]).
DYADIC_MANTISSA_BITS = 23


def np_dyadic_multiplier(ratio: np.ndarray) -> np.ndarray:
    """Host-side dyadic multiplier m·2⁻ᵉ of a scale ratio, in IEEE f32 with
    the op order of hawq_tpu/inference/engine.py ``_np_dyadic_multiplier``."""
    ratio = np.asarray(ratio, np.float32)
    m, e = np.frexp(ratio)
    m_int = np.floor(m * (2.0 ** DYADIC_MANTISSA_BITS) + 0.5)
    e_out = DYADIC_MANTISSA_BITS - e
    return np.ldexp(m_int.astype(np.float32), -e_out).astype(np.float32)


def exact_div(x: torch.Tensor, denom) -> torch.Tensor:
    """True IEEE division of a float tensor by a constant.

    PyTorch's CUDA true-divide multiplies by the reciprocal when the divisor
    is a Python or CPU scalar, which differs from division by 1 ulp on a few
    percent of inputs and flips borderline round-half-up decisions.  Dividing
    by a 0-dim tensor on ``x``'s own device takes the elementwise divide
    path on both CPU and CUDA."""
    d = torch.tensor(denom, dtype=x.dtype, device=x.device)
    return x / d


def round_half_up(x: torch.Tensor) -> torch.Tensor:
    """Deterministic round-half-up (0.5 → 1, −0.5 → 0)."""
    return torch.floor(x + 0.5)


def requant_clip_bounds(num_bits: int, signed: bool) -> Tuple[float, float]:
    if signed:
        n = 2 ** (num_bits - 1) - 1
        return float(-n - 1), float(n)
    return 0.0, float(2 ** num_bits - 1)


def requant_int32(acc: torch.Tensor, multiplier: torch.Tensor,
                  num_bits: int, signed: bool,
                  out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Frozen-engine requant: integer accumulator → num_bits integers.

    ``multiplier`` is a float32 tensor (scalar or per-channel over the last
    axis) on ``acc``'s device, from :func:`np_dyadic_multiplier`."""
    out = round_half_up(acc.to(torch.float32) * multiplier)
    lo, hi = requant_clip_bounds(num_bits, signed)
    return torch.clamp(out, lo, hi).to(out_dtype)


def requant_add_int32(acc: torch.Tensor, acc_multiplier: torch.Tensor,
                      identity: torch.Tensor, id_multiplier: torch.Tensor,
                      out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Dual-branch residual requant-add: each branch rounds with its own
    dyadic multiplier, the float32 sum is left unclamped."""
    a = round_half_up(acc.to(torch.float32) * acc_multiplier)
    b = round_half_up(identity.to(torch.float32) * id_multiplier)
    return (a + b).to(out_dtype)
