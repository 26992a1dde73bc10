"""Quantization numerics (port of hawq_tpu/quant/ops.py).

One definition serves the QAT graph (integer-valued float32 tensors with
straight-through gradients) and the frozen integer engine.  The requant is
the framework-canonical dyadic arithmetic

    out = clip(floor(f32(acc) * m·2⁻ᵉ + 0.5), lo, hi)

with the multiplier snapped to a 23-bit mantissa so that it is an exact
float32 (see hawq_tpu/quant/ops.py for the derivation).  Bit-exactness with
the reference needs a rounded multiply followed by a rounded add: eager
PyTorch runs ``*`` and ``+`` as separate kernels, so no FMA contraction can
merge them here; the CUDA epilogues use ``__fmul_rn``/``__fadd_rn``.

The reference pins quantization-critical values against XLA's algebraic
rewrites with ``exact()``.  That function has no counterpart here: eager
PyTorch evaluates the op order as written.  For the same reason the QAT
forward must stay out of ``torch.compile``, whose fusions may contract or
reassociate these ops.

The frozen engine computes its multipliers on the host in numpy float32
(:func:`np_dyadic_multiplier`); in QAT the scales are device tensors and
:func:`dyadic_multiplier` snaps them on the device, elementwise and exactly.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from hawq_tpu_torch.kernels import reduce as _reduce

# Number of mantissa bits in the dyadic multiplier (m ∈ [2²², 2²³]).
DYADIC_MANTISSA_BITS = 23

_EPS = 1e-8  # scale clamp floor


def np_dyadic_multiplier(ratio: np.ndarray) -> np.ndarray:
    """Host-side dyadic multiplier m·2⁻ᵉ of a scale ratio, in IEEE f32 with
    the op order of hawq_tpu/inference/engine.py ``_np_dyadic_multiplier``."""
    ratio = np.asarray(ratio, np.float32)
    m, e = np.frexp(ratio)
    m_int = np.floor(m * (2.0 ** DYADIC_MANTISSA_BITS) + 0.5)
    e_out = DYADIC_MANTISSA_BITS - e
    return np.ldexp(m_int.astype(np.float32), -e_out).astype(np.float32)


@functools.lru_cache(maxsize=4096)
def _constant(value: float, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """A 0-dim constant on ``device``, made once per (value, dtype, device):
    making it anew costs a host→device copy on every call."""
    return torch.tensor(value, dtype=dtype, device=device)


def exact_div(x: torch.Tensor, denom) -> torch.Tensor:
    """True IEEE division of a float tensor by a constant.

    PyTorch's CUDA true-divide multiplies by the reciprocal when the divisor
    is a Python or CPU scalar, which differs from division by 1 ulp on a few
    percent of inputs and flips borderline round-half-up decisions.  Dividing
    by a 0-dim tensor on ``x``'s own device takes the elementwise divide
    path on both CPU and CUDA.  Scalar divisors are cached as device
    constants (:func:`_constant`); an array divisor is uploaded per call."""
    if isinstance(denom, (int, float, np.integer, np.floating)):
        d = _constant(float(denom), x.dtype, x.device)
    else:
        d = torch.tensor(denom, dtype=x.dtype, device=x.device)
    return x / d


def exact_rdiv(num: float, x: torch.Tensor) -> torch.Tensor:
    """True IEEE division of a constant by a float tensor: ``num / x`` with
    a Python scalar numerator is a reciprocal and a multiply in PyTorch; a
    0-dim numerator on ``x``'s device divides elementwise."""
    return _constant(float(num), x.dtype, x.device) / x


def bn_inv_factor(gamma: torch.Tensor, var: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """γ / √(var + ε), a square root and then a true division as written
    (no ``rsqrt``).  Every BN fold comes through here.

    The root is taken in float64 and rounded back: PyTorch's vectorized
    float32 ``sqrt`` on the CPU is off by one ulp on a few inputs in a
    thousand, while the freeze's numpy mirror rounds correctly; a float64
    root rounded to float32 is the correctly rounded float32 root."""
    std = torch.sqrt((var + eps).to(torch.float64)).to(var.dtype)
    return gamma / std


def round_half_up(x: torch.Tensor) -> torch.Tensor:
    """Deterministic round-half-up (0.5 → 1, −0.5 → 0)."""
    return torch.floor(x + 0.5)


# ---------------------------------------------------------------------------
# Scale computation
# ---------------------------------------------------------------------------

def symmetric_quant_scale(num_bits: int, sat_min: torch.Tensor,
                          sat_max: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor or per-channel scale,
    max(|sat_min|, |sat_max|).clip(1e-8) / (2**(b-1) - 1), elementwise."""
    n = 2 ** (num_bits - 1) - 1
    bound = torch.maximum(torch.abs(sat_min), torch.abs(sat_max))
    return exact_div(torch.clamp(bound, min=_EPS), n)


def asymmetric_quant_scale(num_bits: int, sat_min: torch.Tensor,
                           sat_max: torch.Tensor) -> torch.Tensor:
    """Asymmetric (scaled-unsigned, zero point 0) scale, only valid
    post-ReLU: (max - min).clip(1e-8) / (2**b - 1)."""
    n = 2 ** num_bits - 1
    return exact_div(torch.clamp(sat_max - sat_min, min=_EPS), n)


def fused_minmax(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, max) of an activation tensor as two 0-dim tensors on its device:
    the one-pass kernel on a CUDA tensor, ``torch.amin`` / ``torch.amax`` on
    a CPU tensor (kernels/reduce.py).  Both compute the same function, so
    the statistics do not depend on the route."""
    return _reduce.minmax_1pass(x)


def percentile_bounds(x_flat: torch.Tensor, lower_pct: float,
                      upper_pct: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Percentile min/max of a flat tensor: exact order statistics with the
    reference's ``kthvalue`` index semantics, no interpolation.

    lower_pct / upper_pct are in percent, e.g. (0.1, 99.9) keeps the central
    99.8%.  The upper bound is the ``round(n·upper_pct/100)``-th smallest
    value, the lower bound the ``round(n·(1 − lower_pct/100))``-th largest
    (``round`` is Python's builtin, half-even).  One ascending sort serves
    both ends; an index below 1 raises as ``kthvalue(k=0)`` would."""
    n = int(x_flat.shape[0])
    s = torch.sort(x_flat).values
    upper_index = round(n * upper_pct * 0.01)
    if upper_index < 1:
        raise ValueError(
            f'percentile_bounds: upper index {upper_index} < 1 '
            f'(n={n}, upper_pct={upper_pct}) — tensor too small for this '
            f'percentile')
    upper = s[upper_index - 1]
    if lower_pct == 0:
        lower = upper * 0
    else:
        lower_index = round(n * (1.0 - lower_pct * 0.01))
        if lower_index < 1 or lower_index > n:
            raise ValueError(
                f'percentile_bounds: lower index {lower_index} out of '
                f'[1, {n}] (lower_pct={lower_pct})')
        lower = s[n - lower_index]
    return lower, upper


def weight_percentile_bounds_per_channel(
        w_flat: torch.Tensor, pct: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel weight percentile range of a (L, Cout) tensor: the
    ``ceil(L·(100−pct)/100)``-th and ``ceil(L·pct/100)``-th smallest value of
    each column (``math.ceil`` indices, a different rounding from the
    activation path's ``round``)."""
    ln = int(w_flat.shape[0])
    lower_index = math.ceil(ln * (100.0 - pct) * 0.01)
    upper_index = math.ceil(ln * pct * 0.01)
    if lower_index < 1 or upper_index < 1:
        raise ValueError(
            f'weight_percentile_bounds_per_channel: kth indices '
            f'({lower_index}, {upper_index}) < 1 (L={ln}, pct={pct}) — '
            f'channel too small for this percentile')
    ws = torch.sort(w_flat, dim=0).values
    return ws[lower_index - 1], ws[upper_index - 1]


# ---------------------------------------------------------------------------
# STE quantizers
# ---------------------------------------------------------------------------

class _QuantizeSTE(torch.autograd.Function):
    """clip(round_half_up(x / scale), lo, hi); backward g / scale with no
    range masking, and no gradient to the scale."""

    @staticmethod
    def forward(ctx, x, scale, lo, hi):
        ctx.save_for_backward(scale)
        return torch.clamp(round_half_up(x / scale), lo, hi)

    @staticmethod
    def backward(ctx, g):
        scale, = ctx.saved_tensors
        return g / scale, None, None, None


def quantize_symmetric(x: torch.Tensor, scale: torch.Tensor,
                       num_bits: int) -> torch.Tensor:
    """Symmetric STE quantizer → integer-valued float tensor in
    [-2^(b-1), 2^(b-1)-1]; callers multiply by ``scale`` for the fake-quant
    value.  A per-channel scale is 1-D over the last axis."""
    n = 2 ** (num_bits - 1) - 1
    return _QuantizeSTE.apply(x, scale, float(-n - 1), float(n))


def quantize_asymmetric(x: torch.Tensor, scale: torch.Tensor,
                        num_bits: int) -> torch.Tensor:
    """Asymmetric (unsigned, zero point 0) STE quantizer → [0, 2^b-1]; only
    used for post-ReLU activations."""
    return _QuantizeSTE.apply(x, scale, 0.0, float(2 ** num_bits - 1))


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_half_up(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _FloorEpsSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.trunc(x + 0.01)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Straight-through round-half-up."""
    return _RoundSTE.apply(x)


def ste_floor_eps(x: torch.Tensor) -> torch.Tensor:
    """trunc(x + 0.01) with straight-through backward: turns a float average
    into the integer division a hardware average pool performs (the 0.01
    absorbs float representation error; safe for windows up to 7×7)."""
    return _FloorEpsSTE.apply(x)


# ---------------------------------------------------------------------------
# Dyadic requantization
# ---------------------------------------------------------------------------

def _pow2(k: torch.Tensor) -> torch.Tensor:
    """Exact float32 2**k of an int32 tensor (normal range), built from the
    exponent bits: a ``pow`` on the device need not be exact."""
    return ((k + 127).clamp(1, 254) << 23).view(torch.float32)


def dyadic_decompose(scale_ratio: torch.Tensor,
                     mantissa_bits: int = DYADIC_MANTISSA_BITS
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decompose a positive scale ratio into (m, e) with ratio ≈ m / 2**e:
    m an integer in [2**(mb-1), 2**mb] held in float32 (exact), e int32."""
    mant, exp = torch.frexp(scale_ratio.to(torch.float32))
    m = round_half_up(mant * (2.0 ** mantissa_bits))
    return m, (mantissa_bits - exp).to(torch.int32)


def dyadic_multiplier(scale_ratio: torch.Tensor) -> torch.Tensor:
    """The exact float32 value of the dyadic multiplier m · 2**-e of a scale
    ratio, on the ratio's device (the tensor form of
    :func:`np_dyadic_multiplier`)."""
    m, e = dyadic_decompose(scale_ratio)
    return m * _pow2(-e)


class _RecoverIntSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, scale):
        ctx.save_for_backward(scale)
        return round_half_up(z / scale)

    @staticmethod
    def backward(ctx, g):
        scale, = ctx.saved_tensors
        return g / scale, None


def ste_recover_int(z: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round_half_up(z / scale) with STE backward g / scale: recovers the
    integer tensor from an int·scale value, exact while the integers stay
    below 2**22.  Raw conv accumulators can exceed that, which is why the
    quant layers thread their accumulators directly (``z_int`` below)."""
    return _RecoverIntSTE.apply(z, scale)


class _RequantCoreSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z_int, acc_scale, out_scale, lo, hi):
        ctx.save_for_backward(acc_scale, out_scale)
        out = round_half_up(z_int * dyadic_multiplier(acc_scale / out_scale))
        return out if lo is None else torch.clamp(out, lo, hi)

    @staticmethod
    def backward(ctx, g):
        acc_scale, out_scale = ctx.saved_tensors
        return g * acc_scale / out_scale, None, None, None, None


def requant_core_ste(z_int: torch.Tensor, acc_scale: torch.Tensor,
                     out_scale: torch.Tensor, num_bits: Optional[int],
                     signed: bool) -> torch.Tensor:
    """Dyadic requant of an exact integer-valued float tensor (e.g. the
    accumulator of ``int_conv2d``), with STE backward.

    Forward is the frozen engine's :func:`requant_int32`: snap
    acc_scale/out_scale to the dyadic grid, multiply, round, clamp
    (``num_bits=None`` skips the clamp, the residual-branch case).  Backward
    is g·acc_scale/out_scale."""
    lo, hi = ((None, None) if num_bits is None
              else requant_clip_bounds(num_bits, signed))
    return _RequantCoreSTE.apply(z_int, acc_scale, out_scale, lo, hi)


def dyadic_requant(z: torch.Tensor, acc_scale: torch.Tensor,
                   out_scale: torch.Tensor, num_bits: int, signed: bool,
                   z_int: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Requantize an accumulator *value* tensor (= z_int · acc_scale) to
    ``num_bits`` integers (float dtype).  With ``z_int`` given, the
    value/scale recovery division is skipped and the result is bit-exact for
    accumulators beyond the f32 round-trip range."""
    if z_int is None:
        z_int = ste_recover_int(z, acc_scale)
    return requant_core_ste(z_int, acc_scale, out_scale, num_bits, signed)


def dyadic_requant_residual(z: torch.Tensor, acc_scale: torch.Tensor,
                            identity: torch.Tensor,
                            identity_scale: torch.Tensor,
                            out_scale: torch.Tensor,
                            z_int: Optional[torch.Tensor] = None,
                            identity_int: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Residual-add requantization: ``z`` is the sum main + identity; each
    branch is requantized with its own dyadic multiplier to the common
    ``out_scale`` and rounded on its own, then the two are added.  The sum is
    not clamped here (it carries the 16-bit residual precision; the next
    QuantAct clamps).  ``z_int`` is the exact main-branch accumulator (not
    the sum), ``identity_int`` likewise for a convolved identity branch."""
    if z_int is None:
        z_int = ste_recover_int(z - identity, acc_scale)
    if identity_int is None:
        identity_int = ste_recover_int(identity, identity_scale)
    out_main = requant_core_ste(z_int, acc_scale, out_scale, None, True)
    out_id = requant_core_ste(identity_int, identity_scale, out_scale,
                              None, True)
    return out_main + out_id


# ---------------------------------------------------------------------------
# Pure integer-side helpers (frozen inference engine)
# ---------------------------------------------------------------------------


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


def requant_int32_ref(acc: torch.Tensor, m: torch.Tensor, inv2e: torch.Tensor,
                      num_bits: int, signed: bool,
                      out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Reference-exact replay requant (31-bit mantissa, float64), on
    ``acc``'s device.

    ``(m, inv2e)`` are float64 tensors (scalar or per-channel over the last
    axis) from ``reference_oracle.decompose_ref``, the reference's
    batch_frexp constants.  Evaluates its fixedpoint_fn case 0 exactly:
    the float64 product acc·m, which rounds once it exceeds 2⁵³ as the
    reference's does, then the exact 2⁻ᵉ factor, round-half-even
    (``torch.round``), clamp, cast.  Eager PyTorch evaluates the two
    products as written and does not reassociate them, so the JAX
    package's optimization barrier has no counterpart here; never fold
    m·inv2e into one constant."""
    p = acc.to(torch.float64) * m
    out = torch.round(p * inv2e)
    lo, hi = requant_clip_bounds(num_bits, signed)
    return torch.clamp(out, lo, hi).to(out_dtype)


def requant_add_int32_ref(acc: torch.Tensor, m_acc: torch.Tensor,
                          inv2e_acc: torch.Tensor, identity: torch.Tensor,
                          m_id: torch.Tensor, inv2e_id: torch.Tensor,
                          out_dtype: torch.dtype = torch.int32
                          ) -> torch.Tensor:
    """Reference-exact dual-branch residual requant-add (fixedpoint_fn case
    1): each branch rounds half-even in float64 with its own 31-bit
    (m, 2⁻ᵉ), as :func:`requant_int32_ref`; the sum is left unclamped."""
    a = torch.round((acc.to(torch.float64) * m_acc) * inv2e_acc)
    b = torch.round((identity.to(torch.float64) * m_id) * inv2e_id)
    return (a + b).to(out_dtype)
