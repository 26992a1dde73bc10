"""Reference-exact dyadic requantization semantics (numpy, host-side; port
of hawq_tpu/quant/reference_oracle.py, the same functions as they are).

The framework's canonical requant uses a 23-bit dyadic mantissa evaluated in
float32 (quant/ops.py).  The *reference* (HAWQ-V3's own fixed-point code,
``quant_utils.py`` batch_frexp and fixedpoint_fn) uses a 31-bit mantissa
with Decimal ROUND_HALF_UP and float64 evaluation, plus deliberate
double→float→double casts that mirror its TVM engine.  A checkpoint
imported from the reference's published model zoo is replayed with this
rounding to reproduce its logits bit for bit.

  * :func:`frexp31`         — batch_frexp: m = ROUND_HALF_UP(frexp_m·2³¹),
                              e = 31 − frexp_e
  * :func:`new_scale_ref`   — the double→float→double scale-ratio casts
  * :func:`decompose_ref`   — both combined → (m, 2⁻ᵉ) as float64 constants
  * :func:`requant_ref`     — fixedpoint_fn case 0
  * :func:`requant_add_ref` — fixedpoint_fn case 1, dual-branch residual

They are the oracle that the import and replay tests check against, and
the host-side constants of the engines' ``requant_mode='reference'``, whose
device arithmetic (quant/ops.py ``requant_int32_ref``) evaluates the same
float64 expression.

Faithfulness notes (each reproduces reference behavior):
  * torch.round on tensors is round-half-EVEN → np.rint here; the Decimal
    mantissa rounding alone is half-up.
  * ``z_int.double() * m.double()`` may itself round once the product
    exceeds 2⁵³ — that float64 product rounding is part of the semantics,
    so the product must not be reassociated with the exact 2⁻ᵉ factor.
  * case 1 does NOT clamp (the residual sum carries full precision until
    the next unit's input requant).
"""

from __future__ import annotations

import decimal
from decimal import Decimal
from typing import Tuple

import numpy as np


def frexp31(new_scale: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """31-bit dyadic decomposition, the reference's batch_frexp.

    new_scale — positive float64 array (any shape).
    returns (m, e): integer mantissa m = ROUND_HALF_UP(frexp_m · 2³¹) as
    float64 (exact — m ≤ 2³¹ < 2⁵³), e = 31 − frexp_e as float64, such
    that new_scale ≈ m / 2**e, including the Decimal(float) exact
    binary→decimal conversion before rounding.
    """
    ns = np.asarray(new_scale, np.float64)
    mant, exp = np.frexp(ns)
    flat = mant.reshape(-1)
    m_int = np.array(
        [int(Decimal(float(mi) * (2 ** 31)).quantize(
            Decimal('1'), rounding=decimal.ROUND_HALF_UP)) for mi in flat],
        np.float64).reshape(ns.shape)
    e_out = (31.0 - exp).astype(np.float64)
    return m_int, e_out


def new_scale_ref(acc_scale, out_scale) -> np.ndarray:
    """The reference's scale-ratio computation with its float32 round-trips:
    _A = f64(s_act)·f64(s_w); _B = f64(f32(_A)); _C = f64(f32(s_out));
    new_scale = _B / _C.

    ``acc_scale`` here is the already-multiplied f32 product s_act·s_w (as
    the engine plan carries it) — identical to f32(_A) because the IEEE f32
    product of two f32 values equals the f64 product correctly rounded to
    f32.  Inputs may be scalars or per-channel vectors.
    """
    _b = np.asarray(acc_scale, np.float32).astype(np.float64)
    _c = np.asarray(out_scale, np.float32).astype(np.float64)
    return _b / _c


def decompose_ref(acc_scale, out_scale) -> Tuple[np.ndarray, np.ndarray]:
    """(m, 2⁻ᵉ) float64 constants for one requant site.

    2⁻ᵉ is an exact float64 power of two, so multiplying by it equals the
    reference's division by 2**e exactly.
    """
    m, e = frexp31(new_scale_ref(acc_scale, out_scale))
    return m, np.ldexp(np.float64(1.0), -e.astype(np.int64))


def _clip_bounds(num_bits: int, signed: bool) -> Tuple[float, float]:
    if signed:
        n = 2 ** (num_bits - 1) - 1
        return float(-n - 1), float(n)
    return 0.0, float(2 ** num_bits - 1)


def requant_ref(z_int: np.ndarray, acc_scale, out_scale,
                num_bits: int, signed: bool) -> np.ndarray:
    """fixedpoint_fn case 0 on an exact integer accumulator (numpy oracle).

    z_int — integer-valued array (the int32 conv accumulator + bias).
    Returns integer values in the target bit range, float64 dtype:
    round_half_even(z·m / 2ᵉ) with the z·m product rounded in float64
    exactly as torch computes it, then clamped (the clamp happens after a
    float32 cast in the reference; the values are small integers, so the
    cast is exact).
    """
    m, inv2e = decompose_ref(acc_scale, out_scale)
    p = z_int.astype(np.float64) * m          # f64 product, may round — spec
    out = np.rint(p * inv2e)
    lo, hi = _clip_bounds(num_bits, signed)
    return np.clip(out, lo, hi)


def requant_add_ref(main_int: np.ndarray, acc_scale,
                    identity_int: np.ndarray, identity_scale,
                    out_scale) -> np.ndarray:
    """fixedpoint_fn case 1 — dual-branch residual requant-add (oracle).

    Each branch is requantized to out_scale with its own 31-bit (m, e) and
    rounded independently; the sum is NOT clamped.
    """
    m1, inv1 = decompose_ref(identity_scale, out_scale)
    o1 = np.rint((identity_int.astype(np.float64) * m1) * inv1)
    m2, inv2 = decompose_ref(acc_scale, out_scale)
    o2 = np.rint((main_int.astype(np.float64) * m2) * inv2)
    return o1 + o2
