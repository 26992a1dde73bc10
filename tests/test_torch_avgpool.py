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
products on a .5 boundary.
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
