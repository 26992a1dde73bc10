"""A1's plain version (``kernels.avgpool.int_avgpool3x3_requant`` on a CPU
tensor) == the JAX package's own ops, the ones
``hawq_tpu/inference/engine_inception.py`` runs for the pool branches:
``jax.lax.reduce_window`` (an int32 3×3 window sum over a zero border of
1), ``trunc(exact_div(sum, 9) + 0.01)``, then ``requant_int32`` to the
``q_pool_act`` bits.  Bit for bit, at every H, W in {1, 2, 3, 5, 8, 17, 35}
and C in {1, 3, 4, 12, 32, 288}, int32, int16 and int8 inputs, per-tensor
and per-channel multipliers, and the inputs where the arithmetic is
delicate: saturated ±32767, negative sums that are multiples of 9 (where
+0.01 turns −k into −(k−1)), sums next to a multiple of 9, and requant
products on a .5 boundary.  The fused form (the branch's input requant in
front, ``in_mult``) likewise, against ``requant_int32`` to the
``q_input_act`` bits before those ops: 16 bits signed and unsigned, 8 bits,
and a requant in front that saturates 16 bits.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.quant import ops as jops

from hawq_tpu_torch.kernels import avgpool as ka
from hawq_tpu_torch.quant.ops import np_dyadic_multiplier

torch.set_num_threads(1)

_HW = (1, 2, 3, 5, 8, 17, 35)
_C = (1, 3, 4, 12, 32, 288)
_DTYPES = (np.int32, np.int16)


@jax.jit
def _pool(x):
    summed = jax.lax.reduce_window(
        x.astype(jnp.int32), jnp.int32(0), jax.lax.add, (1, 3, 3, 1),
        (1, 1, 1, 1), ((0, 0), (1, 1), (1, 1), (0, 0)))
    return jnp.trunc(jops.exact_div(summed.astype(jnp.float32), 9.0)
                     + 0.01).astype(jnp.int32)


def _reference(x, mult, bits, signed):
    return np.asarray(jops.requant_int32(_pool(jnp.asarray(x)),
                                         jnp.asarray(mult), bits, signed,
                                         jnp.int8))


def _check(x, mult, bits=8, signed=True):
    mult = np.asarray(mult, np.float32)
    want = _reference(x, mult, bits, signed)
    got = ka.int_avgpool3x3_requant(torch.from_numpy(x),
                                    torch.from_numpy(mult), out_bits=bits,
                                    signed=signed)
    assert got.dtype == torch.int8 and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    return want


def _mult(rng, c, per_channel):
    ratio = (rng.rand(c) if per_channel else rng.rand()) * 0.01 + 0.002
    return np_dyadic_multiplier(np.asarray(ratio, np.float32))


@pytest.mark.parametrize('h', _HW)
def test_plain_equals_reference_ops(h):
    """Every W at this H, C and the container dtype cycled, 16-bit values,
    one call per-tensor and one per-channel, signed 8 and unsigned 4 bits."""
    rng = np.random.RandomState(h)
    for i, w in enumerate(_HW):
        c = _C[(i + h) % len(_C)]
        dt = _DTYPES[(i + h) % 2]
        x = rng.randint(-32768, 32768, (2, h, w, c)).astype(dt)
        _check(x, _mult(rng, c, False))
        _check(x, _mult(rng, c, True), 4, False)


@pytest.mark.parametrize('c', _C)
def test_every_width_and_dtype(c):
    rng = np.random.RandomState(c)
    for dt, lo, hi in ((np.int32, -32768, 32768), (np.int16, -32768, 32768),
                       (np.int8, -128, 128)):
        x = rng.randint(lo, hi, (2, 5, 8, c)).astype(dt)
        mult = _mult(rng, c, c > 1)
        if dt == np.int8:
            mult = mult * np.float32(64)
        out = _check(x, mult)
        assert len(np.unique(out)) > min(c, 4)


def test_saturated():
    for v in (32767, -32767, -32768):
        x = np.full((1, 5, 7, 8), v, np.int32)
        x[0, 2, 3, ::2] = -v if v != -32768 else 32767
        for mult in (np.float32(2 ** -12), np.float32(2 ** -8)):
            _check(x, mult)
            _check(x.astype(np.int16), mult)


def test_negative_multiples_of_nine():
    """A constant field −k: the interior sums are −9k, trunc(−k + 0.01)
    = −(k − 1); the borders 6 and 4 times the value."""
    for k in (1, 2, 9, 100, 3641, 32767):
        x = np.full((1, 4, 5, 4), -k, np.int32)
        want = _check(x, np.float32(1.0), 8, True)
        if k < 128:
            assert want[0, 1, 1, 0] == -(k - 1)


def test_sums_next_to_a_multiple_of_nine():
    """One pixel of a constant field off by ±1, ±2: window sums 9k ± 1 and
    ± 2 around it; the quotients k ± 1/9, k ± 2/9 lie near integers."""
    for k in (-32767, -1000, -1, 0, 1, 1000, 32766):
        for d in (-2, -1, 1, 2):
            x = np.full((1, 5, 5, 12), k, np.int32)
            x[0, 2, 2] = k + d
            _check(x, np.float32(2 ** -8))
            _check(x.astype(np.int16), np.float32(2 ** -8))


def test_requant_on_a_half():
    """Odd quotients times 0.5 and 1.5 lie on a .5 boundary, which
    floor(· + 0.5) rounds up.  The centre of a constant 3×3 field p sums
    9p, its quotient trunc(p + 0.01): p, or p + 1 below zero."""
    p = np.concatenate([np.arange(1, 256, 2),
                        np.arange(-256, 0, 2)]).astype(np.int32)
    x = np.ascontiguousarray(np.broadcast_to(p, (1, 3, 3, p.size)))
    q = np.where(p > 0, p, p + 1)
    assert (q % 2 == 1).all()
    for mult in (0.5, 1.5):
        assert (q * mult % 1 == 0.5).all()
        out = _check(x, np.float32(mult))
        np.testing.assert_array_equal(
            out[0, 1, 1], np.clip(np.floor(q * mult + 0.5), -128, 127))
    _check(x, np.where(np.arange(p.size) % 2, 0.5, 1.5).astype(np.float32))


# The fused form: the pool branch's input requant (``requant_int32`` to the
# ``q_input_act`` bits, into int32) in front of the pool, as
# ``int_avgpool3x3_requant(..., in_mult=, in_bits=, in_signed=)`` takes it
_FRONTS = ((16, True), (16, False), (8, True))


def _fused_check(x, in_mult, in_bits, in_signed, mult, bits=8, signed=True):
    in_mult = np.asarray(in_mult, np.float32)
    mult = np.asarray(mult, np.float32)
    h = jops.requant_int32(jnp.asarray(x), jnp.asarray(in_mult), in_bits,
                           in_signed, jnp.int32)
    want = np.asarray(jops.requant_int32(_pool(h), jnp.asarray(mult), bits,
                                         signed, jnp.int8))
    got = ka.int_avgpool3x3_requant(
        torch.from_numpy(x), torch.from_numpy(mult), out_bits=bits,
        signed=signed, in_mult=torch.from_numpy(in_mult), in_bits=in_bits,
        in_signed=in_signed)
    assert got.dtype == torch.int8 and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    return want


@pytest.mark.parametrize('h', _HW)
@pytest.mark.parametrize('front', _FRONTS)
def test_fused_plain_equals_reference_ops(h, front):
    """Every W at this H, C and the input dtype cycled (int32, int16, int8),
    the requant in front to 16 bits signed or unsigned or to 8 bits, per
    tensor and per channel, in front and after."""
    in_bits, in_signed = front
    rng = np.random.RandomState(100 + h + in_bits + in_signed)
    dtypes = ((np.int32, 32768), (np.int16, 32768), (np.int8, 128))
    for i, w in enumerate(_HW):
        c = _C[(i + h) % len(_C)]
        dt, hi = dtypes[(i + h) % 3]
        x = rng.randint(-hi, hi, (2, h, w, c)).astype(dt)
        base = (100.0 if dt == np.int8 else 1.0) / (64 if in_bits == 8
                                                      else 1)
        per_channel = i % 2 == 1
        ratio = (rng.rand(c) if per_channel else rng.rand()) * 1.5 + 0.25
        in_mult = np_dyadic_multiplier(np.asarray(base * ratio, np.float32))
        mult = _mult(rng, c, not per_channel)
        if in_bits == 8:
            mult = mult * np.float32(16)
        _fused_check(x, in_mult, in_bits, in_signed, mult)


@pytest.mark.parametrize('in_signed', [True, False])
def test_fused_saturated(in_signed):
    """A requant in front that saturates 16 bits: window sums up to 9·32767
    and 9·65535; a constant −9 field through a multiplier of 1 (unsigned:
    clipped to 0 in front)."""
    for dt in (np.int32, np.int16, np.int8):
        top = np.iinfo(dt).max
        x = np.full((2, 5, 7, 8), top, dt)
        x[:, 2, 3, ::2] = -top
        x[1] = -x[1]
        sat = np.float32(2 ** 20 / min(top, 32767))
        _fused_check(x, sat, 16, in_signed, np.float32(2 ** -9))
        _fused_check(x, np.where(np.arange(8) % 2, sat, 0.5).astype(
            np.float32), 16, in_signed, np.float32(2 ** -13), 4, False)
    x = np.full((1, 4, 5, 4), -9, np.int32)
    assert _fused_check(x, np.float32(1.0), 16, in_signed,
                        np.float32(1.0))[0, 1, 1, 0] == (-8 if in_signed
                                                         else 0)
