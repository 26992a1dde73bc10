"""The reference checkpoint's requant numerics in hawq_tpu_torch == hawq_tpu's,
bit for bit.

* ``quant.reference_oracle`` (the port's copy): ``frexp31``,
  ``new_scale_ref``, ``decompose_ref``, ``requant_ref``, ``requant_add_ref``
  and ``_clip_bounds`` against the JAX package's on scalar and per-channel
  scales, dyadic ratios (ties), |acc| up to 2³¹−1 with mantissas near 2³¹
  (products above 2⁵³, where the float64 product itself rounds), and 4-,
  8- and 16-bit signed and unsigned clips.
* ``quant.ops.requant_int32_ref`` / ``requant_add_int32_ref`` (float64 torch
  on the CPU) against JAX's (under ``jax.enable_x64``) on the same random
  accumulators; on the tie set the reference requant differs from the
  native ``requant_int32``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.quant import ops as jops
from hawq_tpu.quant import reference_oracle as jro

from hawq_tpu_torch.quant import ops as tops
from hawq_tpu_torch.quant import reference_oracle as tro

torch.set_num_threads(1)

_CLIPS = [(bits, signed) for bits in (4, 8, 16) for signed in (True, False)]


def _scales(rng, kind, c=8):
    """(acc_scale, out_scale): 'scalar', 'channel' (per-channel acc
    scales), 'dyadic' (power-of-two ratios below 1: ties), 'top'
    (mantissas near 2³¹, frexp mantissas just below 1)."""
    if kind == 'scalar':
        return np.float32(0.0123), np.float32(0.731)
    if kind == 'channel':
        return ((0.001 * (0.5 + rng.rand(c))).astype(np.float32)
                * np.float32(0.037)), np.float32(0.05)
    if kind == 'dyadic':         # channel i: the ratio 2^-(i + 1)
        return np.exp2(-np.arange(1, c + 1)).astype(np.float32), \
            np.float32(1.0)
    # 1 − k·2⁻²⁴: float32 mantissas whose 31-bit mantissa is near 2³¹
    return (np.float32(1.0) - rng.randint(1, 64, c).astype(np.float32)
            * np.float32(2 ** -24)), np.float32(0.5)


def _accs(rng, kind, shape):
    if kind == 'top':            # |acc| up to 2³¹−1: products above 2⁵³
        a = rng.randint(-2 ** 31 + 1, 2 ** 31, shape).astype(np.int64)
        a.reshape(-1)[:4] = (2 ** 31 - 1, -2 ** 31 + 1, 2 ** 30 + 1, -3)
        return a
    if kind == 'dyadic':         # odd multiples of the half step: ties
        odd = 2 * rng.randint(-7000, 7000, shape).astype(np.int64) + 1
        return odd << np.arange(shape[-1])
    return rng.randint(-7000, 7000, shape).astype(np.int64)


@pytest.mark.parametrize('kind', ['scalar', 'channel', 'dyadic', 'top'])
def test_oracle_equal(kind):
    rng = np.random.RandomState({'scalar': 0, 'channel': 1, 'dyadic': 2,
                                 'top': 3}[kind])
    acc_scale, out_scale = _scales(rng, kind)
    for fn in ('new_scale_ref', 'frexp31', 'decompose_ref'):
        args = ((acc_scale / np.float32(out_scale)).astype(np.float64),) \
            if fn == 'frexp31' else (acc_scale, out_scale)
        got, want = getattr(tro, fn)(*args), getattr(jro, fn)(*args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.dtype == w.dtype == np.float64, fn
            np.testing.assert_array_equal(g, w, err_msg=fn)
    if kind == 'top':
        m, _ = tro.decompose_ref(acc_scale, out_scale)
        assert (m > 2 ** 31 - 2 ** 14).all()
    z = _accs(rng, kind, (2, 3, 5, 8))
    if kind == 'top':           # acc·m above 2⁵³: the product rounds
        m, _ = tro.decompose_ref(acc_scale, out_scale)
        assert (np.abs(z.astype(np.float64) * m) > 2.0 ** 53).any()
    for bits, signed in _CLIPS:
        assert tro._clip_bounds(bits, signed) == jro._clip_bounds(bits,
                                                                  signed)
        got = tro.requant_ref(z, acc_scale, out_scale, bits, signed)
        np.testing.assert_array_equal(
            got, jro.requant_ref(z, acc_scale, out_scale, bits, signed),
            err_msg=f'{bits} {signed}')
    ident = _accs(rng, kind, z.shape)
    id_scale = np.float32(0.0042) if kind != 'dyadic' else np.float32(0.25)
    np.testing.assert_array_equal(
        tro.requant_add_ref(z, acc_scale, ident, id_scale, out_scale),
        jro.requant_add_ref(z, acc_scale, ident, id_scale, out_scale))


def test_frexp31_half_up_tie():
    """The Decimal half-up rounding of the mantissa (np.rint would round
    this tie to even)."""
    tie = np.float64(0.5) + np.float64(2.0) ** -32
    for ro in (tro, jro):
        m, e = ro.frexp31(np.array([tie]))
        assert m[0] == 2 ** 30 + 1 and e[0] == 31.0


@pytest.mark.parametrize('kind', ['scalar', 'channel', 'dyadic', 'top'])
def test_device_ops_equal(kind):
    """requant_int32_ref / requant_add_int32_ref, float64 torch on the CPU,
    == JAX's under x64, and == the numpy oracle."""
    rng = np.random.RandomState(10 + len(kind))
    acc_scale, out_scale = _scales(rng, kind)
    m, inv2e = tro.decompose_ref(acc_scale, out_scale)
    z = _accs(rng, kind, (2, 4, 3, 8)).astype(np.int32)
    ident = _accs(rng, kind, z.shape).astype(np.int32)
    mi, invi = tro.decompose_ref(np.float32(0.25), out_scale)
    tm, tinv = torch.from_numpy(np.asarray(m)), torch.from_numpy(
        np.asarray(inv2e))
    for bits, signed in _CLIPS:
        small = bits < 8 or (bits == 8 and signed)     # fits int8
        out_dt = torch.int8 if small else torch.int32
        got = tops.requant_int32_ref(torch.from_numpy(z), tm, tinv, bits,
                                     signed, out_dt)
        with jax.enable_x64():
            want = np.asarray(jops.requant_int32_ref(
                jnp.asarray(z), m, inv2e, bits, signed,
                jnp.int8 if small else jnp.int32))
        assert got.dtype == out_dt
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), tro.requant_ref(z, acc_scale, out_scale, bits,
                                         signed).astype(want.dtype))
    if kind == 'top':            # the unclamped sum within int32
        z, ident = z >> 3, ident >> 3
    got = tops.requant_add_int32_ref(
        torch.from_numpy(z), tm, tinv, torch.from_numpy(ident),
        torch.from_numpy(np.asarray(mi)), torch.from_numpy(np.asarray(invi)))
    with jax.enable_x64():
        want = np.asarray(jops.requant_add_int32_ref(
            jnp.asarray(z), m, inv2e, jnp.asarray(ident), mi, invi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tro.requant_add_ref(z, acc_scale, ident,
                                         np.float32(0.25), out_scale))


def test_reference_differs_from_native_on_ties():
    """On the tie set (dyadic ratios, accumulators on odd multiples of the
    half step) the native requant rounds half-up, the reference half-even:
    they differ; off the ties, on these ratios, they agree."""
    rng = np.random.RandomState(5)
    acc_scale, out_scale = _scales(rng, 'dyadic')
    m, inv2e = (torch.from_numpy(np.asarray(a))
                for a in tro.decompose_ref(acc_scale, out_scale))
    native = torch.from_numpy(tops.np_dyadic_multiplier(
        (acc_scale / out_scale).astype(np.float32)))
    ties = torch.from_numpy(_accs(rng, 'dyadic', (4, 6, 8)).astype(np.int32))
    ref = tops.requant_int32_ref(ties, m, inv2e, 16, True, torch.int32)
    nat = tops.requant_int32(ties, native, 16, True, torch.int32)
    assert (ref != nat).float().mean() > 0.4
    assert ((nat - ref == 1) | (nat == ref)).all()    # half-up vs even
    odd = ties + 1                                    # off the ties
    assert torch.equal(tops.requant_int32_ref(odd, m, inv2e, 16, True,
                                              torch.int32),
                       tops.requant_int32(odd, native, 16, True,
                                          torch.int32))
    ident = torch.zeros_like(ties)
    ref_add = tops.requant_add_int32_ref(ties, m, inv2e, ident, m, inv2e)
    nat_add = tops.requant_add_int32(ties, native, ident, native)
    assert not torch.equal(ref_add, nat_add)
