"""The QAT side of hawq_tpu_torch.quant.ops == hawq_tpu.quant.ops.

Scales, percentile bounds, STE quantizers, the device-side dyadic
multiplier and the requant STE functions: same numpy inputs through both
packages, forward values bit-equal (tolerance 0) on random and edge inputs
(exact .5 ties, clip edges, scales at the 1e-8 floor).  The backward of each
STE function is a ``g / scale`` product or quotient, so it is bit-equal to
``jax.vjp``'s as well.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.quant import ops as jops
from hawq_tpu_torch.quant import ops as tops

torch.set_num_threads(1)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _eq(got, want, msg=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _ranges(rng, n):
    lo = -np.abs(rng.randn(n)).astype(np.float32) * 3
    hi = np.abs(rng.randn(n)).astype(np.float32) * 3
    # zeros (the 1e-8 floor), a one-sided range, a tiny one
    lo[:3], hi[:3] = (0, -2.5, -1e-9), (0, 1.0, 1e-9)
    return lo, hi


@pytest.mark.parametrize('bits', [4, 8, 16, 32])
def test_scales_equal(bits):
    lo, hi = _ranges(np.random.RandomState(bits), 64)
    _eq(tops.symmetric_quant_scale(bits, _t(lo), _t(hi)),
        jops.symmetric_quant_scale(bits, jnp.asarray(lo), jnp.asarray(hi)))
    _eq(tops.asymmetric_quant_scale(bits, _t(lo), _t(hi)),
        jops.asymmetric_quant_scale(bits, jnp.asarray(lo), jnp.asarray(hi)))
    # 0-dim, as the activation ranges are
    _eq(tops.symmetric_quant_scale(bits, _t(lo[5]), _t(hi[5])),
        jops.symmetric_quant_scale(bits, jnp.asarray(lo[5]),
                                   jnp.asarray(hi[5])))


def test_bn_inv_factor_equal():
    rng = np.random.RandomState(1)
    gamma = rng.randn(257).astype(np.float32)
    var = (rng.rand(257) * 4).astype(np.float32)
    var[:2] = (0.0, 1e-12)
    _eq(tops.bn_inv_factor(_t(gamma), _t(var), 1e-5),
        jops.bn_inv_factor(jnp.asarray(gamma), jnp.asarray(var), 1e-5))


def test_fused_minmax_equal():
    x = np.random.RandomState(2).randn(3, 5, 7, 11).astype(np.float32)
    for got, want in zip(tops.fused_minmax(_t(x)),
                         jops.fused_minmax(jnp.asarray(x))):
        assert got.shape == ()
        _eq(got, want)


@pytest.mark.parametrize('n,lower,upper', [
    (1000, 0.1, 99.9), (1000, 0.0, 99.9), (77, 1.0, 99.0), (4096, 0.01, 99.99),
    (10, 5.0, 95.0)])
def test_percentile_bounds_equal(n, lower, upper):
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    x[:4] = x[4:8]                                   # ties
    got = tops.percentile_bounds(_t(x), lower, upper)
    want = jops.percentile_bounds(jnp.asarray(x), lower, upper)
    for g, w in zip(got, want):
        _eq(g, w)


def test_percentile_bounds_index_errors():
    x = np.arange(3, dtype=np.float32)
    for args in ((0.1, 10.0), (150.0, 99.0), (-50.0, 99.0)):
        with pytest.raises(ValueError):
            jops.percentile_bounds(jnp.asarray(x), *args)
        with pytest.raises(ValueError):
            tops.percentile_bounds(_t(x), *args)
    w = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    for pct in (100.0, 0.0):
        with pytest.raises(ValueError):
            jops.weight_percentile_bounds_per_channel(jnp.asarray(w), pct)
        with pytest.raises(ValueError):
            tops.weight_percentile_bounds_per_channel(_t(w), pct)


@pytest.mark.parametrize('pct', [99.9, 99.0, 60.0])
def test_weight_percentile_bounds_equal(pct):
    w = np.random.RandomState(3).randn(147, 16).astype(np.float32)
    got = tops.weight_percentile_bounds_per_channel(_t(w), pct)
    want = jops.weight_percentile_bounds_per_channel(jnp.asarray(w), pct)
    for g, w_ in zip(got, want):
        _eq(g, w_)


def _ste_inputs(rng, scale):
    """Random values plus exact .5 ties and values at and past the clip
    edges, in units of ``scale``."""
    ties = (np.arange(-140, 141) + 0.5).astype(np.float32)
    edges = np.float32([-129, -128.5, -128, 127, 127.49, 127.5, 128, 300,
                        -0.5, 0, 15, 15.5, 16, 255.5])
    ints = np.concatenate([ties, edges,
                           rng.randn(2000).astype(np.float32) * 60])
    return (ints * np.float32(scale)).astype(np.float32)


@pytest.mark.parametrize('fn,bits', [
    ('quantize_symmetric', 8), ('quantize_symmetric', 4),
    ('quantize_symmetric', 16), ('quantize_symmetric', 32),
    ('quantize_asymmetric', 8), ('quantize_asymmetric', 4)])
def test_ste_quantizers_equal(fn, bits):
    rng = np.random.RandomState(bits)
    for scale in (np.float32(0.0517), np.float32(0.25), np.float32(1e-8 / 127)):
        x = _ste_inputs(rng, scale)
        g = rng.randn(*x.shape).astype(np.float32)
        want, vjp = jax.vjp(lambda x, s: getattr(jops, fn)(x, s, bits),
                            jnp.asarray(x), jnp.asarray(scale))
        tx = _t(x, grad=True)
        got = getattr(tops, fn)(tx, _t(scale), bits)
        _eq(got, want, f'{fn} {bits} {scale}')
        got.backward(_t(g))
        _eq(tx.grad, vjp(jnp.asarray(g))[0], 'backward')
    # per-channel scale over the last axis (weights)
    w = rng.randn(3, 3, 5, 8).astype(np.float32)
    s = (np.abs(rng.randn(8)) * 0.01 + 1e-3).astype(np.float32)
    g = rng.randn(*w.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda x, s: getattr(jops, fn)(x, s, bits),
                        jnp.asarray(w), jnp.asarray(s))
    tw = _t(w, grad=True)
    got = getattr(tops, fn)(tw, _t(s), bits)
    _eq(got, want)
    got.backward(_t(g))
    _eq(tw.grad, vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize('fn', ['ste_round', 'ste_floor_eps'])
def test_ste_round_and_floor_eps_equal(fn):
    rng = np.random.RandomState(4)
    x = np.concatenate([_ste_inputs(rng, 1.0),
                        np.float32([1.99999999, 2.0, 47.99, 48 / 49 * 49])])
    g = rng.randn(*x.shape).astype(np.float32)
    want, vjp = jax.vjp(getattr(jops, fn), jnp.asarray(x))
    tx = _t(x, grad=True)
    got = getattr(tops, fn)(tx)
    _eq(got, want)
    got.backward(_t(g))
    _eq(tx.grad, vjp(jnp.asarray(g))[0])


def _ratios(rng, n):
    r = np.exp(rng.uniform(np.log(1e-7), np.log(50.0), n)).astype(np.float32)
    r[:6] = (2.0 ** -8, 1.0, 0.5, 1.0 - 2.0 ** -24, 3e-9, 1e3)
    return r


def test_dyadic_decompose_and_multiplier_equal():
    r = _ratios(np.random.RandomState(5), 4000)
    m, e = tops.dyadic_decompose(_t(r))
    jm, je = jops.dyadic_decompose(jnp.asarray(r))
    _eq(m, jm)
    _eq(e, je)
    got = tops.dyadic_multiplier(_t(r))
    _eq(got, jops.dyadic_multiplier(jnp.asarray(r)))
    _eq(got, tops.np_dyadic_multiplier(r))          # the engine's host form
    _eq(tops.dyadic_multiplier(_t(r[7])),
        jops.dyadic_multiplier(jnp.asarray(r[7])))   # 0-dim


def _accumulators(rng, n=4096):
    acc = rng.randint(-2 ** 20, 2 ** 20, n)
    ties = (2 * rng.randint(-2 ** 10, 2 ** 10, 256) + 1) * 2 ** 7
    big = rng.randint(2 ** 24, 2 ** 30, 256) * rng.choice([-1, 1], 256)
    return np.concatenate([acc, ties, big]).astype(np.float32)


def test_ste_recover_int_equal():
    rng = np.random.RandomState(6)
    q = rng.randint(-2 ** 21, 2 ** 21, 5000).astype(np.float32)
    for s in (np.float32(0.0123), np.float32(3.1e-5)):
        z = q * s
        g = rng.randn(*z.shape).astype(np.float32)
        want, vjp = jax.vjp(jops.ste_recover_int, jnp.asarray(z),
                            jnp.asarray(s))
        tz = _t(z, grad=True)
        got = tops.ste_recover_int(tz, _t(s))
        _eq(got, want)
        got.backward(_t(g))
        _eq(tz.grad, vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize('bits,signed', [(8, True), (4, False), (16, True),
                                         (None, True)])
def test_requant_core_ste_equal(bits, signed):
    rng = np.random.RandomState(7)
    z = _accumulators(rng).reshape(-1, 16)
    g = rng.randn(*z.shape).astype(np.float32)
    # per-channel acc scale; a 2⁻⁸ ratio that lands the engineered ties on x.5
    for acc_scale, out_scale in (
            ((rng.rand(16) * 1e-3 + 1e-5).astype(np.float32),
             np.float32(0.043)),
            (np.full(16, 2.0 ** -10, np.float32), np.float32(0.25))):
        want, vjp = jax.vjp(
            lambda z, a, o: jops.requant_core_ste(z, a, o, bits, signed),
            jnp.asarray(z), jnp.asarray(acc_scale), jnp.asarray(out_scale))
        tz = _t(z, grad=True)
        got = tops.requant_core_ste(tz, _t(acc_scale), _t(out_scale), bits,
                                    signed)
        _eq(got, want)
        got.backward(_t(g))
        _eq(tz.grad, vjp(jnp.asarray(g))[0])


def test_dyadic_requant_and_residual_equal():
    rng = np.random.RandomState(8)
    zi = rng.randint(-2 ** 20, 2 ** 20, (64, 16)).astype(np.float32)
    ii = rng.randint(-2 ** 14, 2 ** 14, (64, 16)).astype(np.float32)
    a = (rng.rand(16) * 1e-4 + 1e-6).astype(np.float32)
    i_s, o = np.float32(0.011), np.float32(0.0071)
    z, ident = zi * a, ii * i_s
    for kw in ({}, {'z_int': zi}):
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        tkw = {k: _t(v) for k, v in kw.items()}
        _eq(tops.dyadic_requant(_t(z), _t(a), _t(o), 8, True, **tkw),
            jops.dyadic_requant(jnp.asarray(z), jnp.asarray(a),
                                jnp.asarray(o), 8, True, **jkw))
    for kw in ({}, {'z_int': zi, 'identity_int': ii}):
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        tkw = {k: _t(v) for k, v in kw.items()}
        g = rng.randn(64, 16).astype(np.float32)
        want, vjp = jax.vjp(
            lambda z, ident: jops.dyadic_requant_residual(
                z, jnp.asarray(a), ident, jnp.asarray(i_s), jnp.asarray(o),
                **jkw), jnp.asarray(z + ident), jnp.asarray(ident))
        tz, ti = _t(z + ident, grad=True), _t(ident, grad=True)
        got = tops.dyadic_requant_residual(tz, _t(a), ti, _t(i_s), _t(o),
                                           **tkw)
        _eq(got, want)
        if not kw:                 # with exact ints given no gradient flows
            got.backward(_t(g))
            jg = vjp(jnp.asarray(g))
            _eq(tz.grad, jg[0])
            _eq(ti.grad, jg[1])


def test_exact_div_constant_is_cached_and_equal():
    x = torch.from_numpy(np.random.RandomState(9).randn(1000).astype(
        np.float32))
    a = tops._constant(127.0, torch.float32, x.device)
    assert tops._constant(127.0, torch.float32, x.device) is a
    np.testing.assert_array_equal(
        tops.exact_div(x, 127).numpy(),
        np.asarray(jops.exact_div(jnp.asarray(x.numpy()), 127)))
    # an array divisor is not cached and broadcasts
    std = np.float32([0.229, 0.224, 0.225])
    np.testing.assert_array_equal(
        tops.exact_div(x[:999].reshape(-1, 3), std).numpy(),
        x[:999].reshape(-1, 3).numpy() / std)
