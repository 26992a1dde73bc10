"""hawq_tpu_torch.nn.layers == hawq_tpu.nn.layers (flax), module by module.

The same numpy inputs and the same variables (carried across as numpy) go
through the flax module and its PyTorch counterpart.  Integer tensors
(``q_int``, the conv accumulators), returned scales, folded-mode outputs and
the updated range buffers are bit-equal (tolerance 0); unfolded-BN outputs,
running BN statistics and gradients agree within the rtol stated at each
check (``torch.var`` and the float gradient convolutions sum in another
order than XLA's).

The flax modules run eagerly here, not under ``jax.jit``: XLA's CPU backend
contracts ``a·m + b·(1−m)`` of the range EMA into a fused multiply-add when
it compiles the whole module, which rounds once where the written op order
(and the port, and the numpy freeze) rounds twice.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.nn import layers as JL
from hawq_tpu_torch.nn import layers as TL

torch.set_num_threads(1)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _eq(got, want, msg=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def _close(got, want, rtol, msg=''):
    """rtol on each element, with an absolute floor of rtol × the largest
    magnitude (sums of many terms leave elements near zero)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=msg)


# ---------------------------------------------------------------------------
# int_conv2d / int_matmul
# ---------------------------------------------------------------------------

_CONVS = [  # k, stride, padding, C, O, H
    (1, 1, 'VALID', 8, 16, 9), (1, 2, 'VALID', 8, 16, 9),
    (3, 1, ((1, 1), (1, 1)), 8, 16, 9), (3, 2, ((1, 1), (1, 1)), 8, 16, 9),
    (3, 2, ((1, 1), (1, 1)), 8, 16, 10), (7, 2, ((3, 3), (3, 3)), 3, 16, 32),
    (3, 2, 'SAME', 4, 8, 10), (3, 1, 'SAME', 4, 8, 7),
    # the ResNet-50 init's widths, and a C the space-to-depth path zero-fills
    # to a multiple of 4 (3 → 4, 5 → 8) before the rewrite
    (7, 2, ((3, 3), (3, 3)), 3, 64, 16), (3, 2, 'SAME', 5, 7, 10)]


@pytest.mark.parametrize('k,s,pad,c,o,h', _CONVS)
def test_int_conv2d_forward_and_gradients(k, s, pad, c, o, h):
    rng = np.random.RandomState(k * 10 + s + h)
    x = rng.randint(-128, 128, (2, h, h, c)).astype(np.float32)
    w = rng.randint(-127, 128, (k, k, c, o)).astype(np.float32)
    b = rng.randint(-2 ** 20, 2 ** 20, (o,)).astype(np.float32)
    f = lambda x, w, b: JL.int_conv2d(x, w, b, (s, s), pad, 1)
    want, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    g = rng.randn(*want.shape).astype(np.float32)
    tx, tw, tb = (_t(a, grad=True) for a in (x, w, b))
    got = TL.int_conv2d(tx, tw, tb, (s, s), pad, 1)
    assert got.dtype == torch.float32
    _eq(got, want)
    got.backward(_t(g))
    for name, t, jg in zip('xwb', (tx, tw, tb), vjp(jnp.asarray(g))):
        _close(t.grad, jg, 1e-5, f'd{name}')


def test_int_conv2d_exact_beyond_2_24():
    """Accumulators above 2²⁴, where a float32 convolution would round:
    same-sign operands near the int8 limits, C = 128, 3×3, and a large
    bias; the one float32 rounding comes after the int32 bias add."""
    rng = np.random.RandomState(0)
    x = rng.randint(100, 128, (1, 5, 5, 128)).astype(np.float32)
    w = rng.randint(100, 128, (3, 3, 128, 4)).astype(np.float32)
    b = np.float32([2 ** 24 + 1, -3, 12345, 7])
    want = np.asarray(JL.int_conv2d(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), (1, 1), ((1, 1), (1, 1)),
                                    1))
    assert want.max() > 2 ** 24
    _eq(TL.int_conv2d(_t(x), _t(w), _t(b), (1, 1), ((1, 1), (1, 1))), want)
    # all activation modes fit int8: 8-bit symmetric, 4-bit asymmetric 0..15
    for bits, mode in ((8, 'symmetric'), (4, 'asymmetric'), (4, 'symmetric')):
        act = TL.QuantAct(bits=bits, quant_mode=mode)
        with TL.capture_q_int(act) as q:
            act(_t(rng.randn(64, 64).astype(np.float32) * 9),
                update_stats=True)
        assert -128 <= float(q[''].min()) and float(q[''].max()) <= 127


def test_int_conv2d_narrow_backward_and_groups():
    rng = np.random.RandomState(1)
    x = rng.randint(-128, 128, (2, 6, 6, 8)).astype(np.float32)
    w = rng.randint(-127, 128, (3, 3, 8, 4)).astype(np.float32)
    b = np.zeros(4, np.float32)
    g = rng.randn(2, 6, 6, 4).astype(np.float32)
    pad = ((1, 1), (1, 1))

    def jax_grads():
        with JL.residual_store_dtype(jnp.bfloat16):
            _, vjp = jax.vjp(lambda x, w, b: JL.int_conv2d(
                x, w, b, (1, 1), pad, 1), jnp.asarray(x), jnp.asarray(w),
                jnp.asarray(b))
        return vjp(jnp.asarray(g))

    for ctx in (TL.residual_store_dtype(torch.bfloat16),
                TL.gradient_conv_dtype(torch.bfloat16)):
        tx, tw, tb = (_t(a, grad=True) for a in (x, w, b))
        with ctx:
            y = TL.int_conv2d(tx, tw, tb, (1, 1), pad)
        y.backward(_t(g))
        assert tx.grad.dtype == torch.float32
        # bfloat16 cotangents and outputs: 2⁻⁸ relative, twice
        for t, jg in zip((tx, tw, tb), jax_grads()):
            _close(t.grad, jg, 2e-2)
    with pytest.raises(NotImplementedError):
        TL.int_conv2d(_t(x), _t(w[:, :, :4]), _t(b), (1, 1), pad, 2)
    with pytest.raises(NotImplementedError):
        TL.int_conv2d(_t(x), _t(w), _t(b), (3, 3), pad)


def test_int_matmul_forward_and_gradients():
    rng = np.random.RandomState(2)
    x = rng.randint(-128, 128, (4, 2048)).astype(np.float32)
    w = np.abs(rng.randint(-127, 128, (2048, 10))).astype(np.float32)
    x[0] = 127                                   # a row beyond 2²⁴
    b = rng.randint(-2 ** 20, 2 ** 20, (10,)).astype(np.float32)
    want, vjp = jax.vjp(JL.int_matmul, jnp.asarray(x), jnp.asarray(w),
                        jnp.asarray(b))
    assert np.abs(np.asarray(want)).max() > 2 ** 24
    g = rng.randn(4, 10).astype(np.float32)
    tx, tw, tb = (_t(a, grad=True) for a in (x, w, b))
    got = TL.int_matmul(tx, tw, tb)
    _eq(got, want)
    got.backward(_t(g))
    for t, jg in zip((tx, tw, tb), vjp(jnp.asarray(g))):
        _close(t.grad, jg, 1e-5)


# ---------------------------------------------------------------------------
# QuantAct
# ---------------------------------------------------------------------------

def _stats(lo, hi):
    return {'quant_stats': {'x_min': jnp.float32(lo), 'x_max': jnp.float32(hi)}}


def _torch_act(stats, **kw):
    act = TL.QuantAct(**kw)
    with torch.no_grad():
        act.x_min.fill_(float(np.float32(stats['quant_stats']['x_min'])))
        act.x_max.fill_(float(np.float32(stats['quant_stats']['x_max'])))
    return act


def _run_act(kw, stats, args, call_kw):
    """The flax QuantAct and the port's on the same inputs → compares value,
    scale, q_int and the updated buffers."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]

    def convert(v, fn):
        if isinstance(v, list) and isinstance(v[0], np.floating):
            return [fn(s) for s in v]
        return fn(v) if isinstance(v, np.ndarray) else v

    jkw = {k: convert(v, jnp.asarray) for k, v in call_kw.items()}
    (jy, js), mut = JL.QuantAct(**kw).apply(
        stats, *jargs, **jkw, mutable=['quant_stats', 'intermediates'])
    act = _torch_act(stats, **kw)
    targs = [None if a is None else _t(a) for a in args]
    tkw = {k: convert(v, _t) for k, v in call_kw.items()}
    with TL.capture_q_int(act) as q:
        ty, ts = act(*targs, **tkw)
    _eq(q[''], mut['intermediates']['q_int'][0], 'q_int')
    _eq(ts, js, 'scale')
    _eq(ty, jy, 'value')
    new = mut.get('quant_stats', stats['quant_stats'])
    _eq(act.x_min, new['x_min'], 'x_min')
    _eq(act.x_max, new['x_max'], 'x_max')
    assert act._capture is None


@pytest.mark.parametrize('kw', [
    dict(bits=8), dict(bits=4, quant_mode='asymmetric'),
    dict(bits=8, momentum=-1), dict(bits=8, percentile=99.0),
    dict(bits=4, quant_mode='asymmetric', percentile=99.9),
    dict(bits=16, momentum=0.9)])
def test_quant_act_input_case_and_range_updates(kw):
    rng = np.random.RandomState(kw['bits'])
    x = rng.randn(4, 6, 6, 5).astype(np.float32) * 3
    if kw.get('quant_mode') == 'asymmetric':
        x = np.maximum(x, 0)
    for stats in (_stats(0, 0), _stats(-1.5, 2.25), _stats(-9, 11)):
        for update in (True, False):
            _run_act(kw, stats, [x], dict(update_stats=update))


def test_quant_act_fixed_point_and_branches():
    rng = np.random.RandomState(3)
    stats = _stats(-2.0, 3.0)
    pre = np.float32(0.031)
    xi = rng.randint(-2 ** 18, 2 ** 18, (2, 4, 4, 6)).astype(np.float32)
    # fixed_point: the direct quantizer even with an incoming scale
    _run_act(dict(bits=8, fixed_point=True), stats,
             [xi * pre * np.float32(1e-4), pre], {})
    # (b) multi-branch concat: two channel slices with their own scales
    s1, s2 = np.float32(0.011), np.float32(0.023)
    q = rng.randint(-120, 120, (2, 4, 4, 6)).astype(np.float32)
    x = np.concatenate([q[..., :2] * s1, q[..., 2:] * s2], -1)
    _run_act(dict(bits=8), stats, [x, pre],
             dict(branch_scales=[s1, s2], branch_channels=[2, 4]))


@pytest.mark.parametrize('bits,mode', [(8, 'symmetric'), (4, 'asymmetric'),
                                       (16, 'symmetric')])
def test_quant_act_requant_cases(bits, mode):
    rng = np.random.RandomState(bits)
    kw = dict(bits=bits, quant_mode=mode)
    stats = _stats(-4.0 if mode == 'symmetric' else 0.0, 6.0)
    pre = np.float32(0.027)
    wsc = (rng.rand(8) * 4e-3 + 1e-4).astype(np.float32)
    # accumulators beyond 2²² (where value/scale recovery stops being
    # exact) and beyond 2²⁴
    acc = rng.randint(-2 ** 25, 2 ** 25, (2, 5, 5, 8)).astype(np.float32)
    val = acc * (wsc * pre)
    for update in (False, True):
        # (c) normal, with and without the exact integers threaded
        _run_act(kw, stats, [val, pre, wsc],
                 dict(x_int=acc, update_stats=update))
        small = rng.randint(-2 ** 20, 2 ** 20, acc.shape).astype(np.float32)
        _run_act(kw, stats, [small * (wsc * pre), pre, wsc],
                 dict(update_stats=update))
        _run_act(kw, stats, [small * pre, pre], dict(update_stats=update))
        # (d) residual: a raw identity (scale only) and a convolved one
        ident_i = rng.randint(-2 ** 14, 2 ** 14, acc.shape).astype(np.float32)
        id_s, id_w = np.float32(0.0123), (rng.rand(8) * 3e-3 + 1e-4).astype(
            np.float32)
        ident = ident_i * id_s
        _run_act(kw, stats, [val + ident, pre, wsc, ident, id_s, None],
                 dict(x_int=acc, update_stats=update))
        ident = ident_i * (id_w * id_s)
        _run_act(kw, stats, [val + ident, pre, wsc, ident, id_s, id_w],
                 dict(x_int=acc, identity_int=ident_i, update_stats=update))
        _run_act(kw, stats, [small * (wsc * pre) + ident, pre, wsc, ident,
                             id_s, id_w], dict(update_stats=update))


def test_quant_act_gradient_is_pure_ste():
    """No gradient reaches the min/max: d sum(out)/dx == 1 for in-range x.
    A differentiable range would add a term of order (1−momentum)·|x| at
    the extremes."""
    x = np.random.RandomState(0).randn(4, 33).astype(np.float32)
    act = TL.QuantAct(bits=8, momentum=0.9)
    with torch.no_grad():
        act(_t(x), update_stats=True)
    tx = _t(x, grad=True)
    y, s = act(tx, update_stats=True)
    assert not s.requires_grad and not act.x_min.requires_grad
    y.sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.ones_like(x), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# QuantConvBn / QuantConv2d / QuantLinear / QuantBnAct
# ---------------------------------------------------------------------------

def _convbn_variables(rng, kh, cin, cout):
    return {'params': {
        'kernel': rng.randn(kh, kh, cin, cout).astype(np.float32) * 0.2,
        'gamma': (rng.rand(cout) + 0.5).astype(np.float32),
        'beta': rng.randn(cout).astype(np.float32) * 0.1},
        'batch_stats': {'mean': rng.randn(cout).astype(np.float32) * 0.1,
                        'var': (rng.rand(cout) + 0.3).astype(np.float32)}}


def _load(module, variables):
    with torch.no_grad():
        for coll in variables.values():
            for k, v in coll.items():
                getattr(module, k).copy_(_t(np.asarray(v)))
    return module


@pytest.mark.parametrize('k,s,pad,kw', [
    (3, 1, ((1, 1), (1, 1)), {}), (1, 2, 'VALID', {}),
    (3, 2, ((1, 1), (1, 1)), dict(weight_bit=4)),
    (7, 2, ((3, 3), (3, 3)), {}), (3, 1, 'SAME', dict(per_channel=False)),
    (3, 1, 'SAME', dict(weight_percentile=99.0)),
    (3, 1, 'SAME', dict(weight_percentile=99.0, per_channel=False))])
def test_quant_convbn_folded_and_unfolded(k, s, pad, kw):
    rng = np.random.RandomState(k + s)
    cin, cout, h = 6, 8, 10
    v = _convbn_variables(rng, k, cin, cout)
    pre = np.float32(0.043)
    x = rng.randint(-128, 128, (3, h, h, cin)).astype(np.float32) * pre
    jmod = JL.QuantConvBn(features=cout, kernel_size=(k, k), strides=(s, s),
                          padding=pad, **kw)
    jv = jax.tree.map(jnp.asarray, v)

    # folded: bit-equal, gradients of the kernel through the STE quantizer
    def f(params, x):
        out, ws, acc = jmod.apply({**jv, 'params': params}, x,
                                  jnp.asarray(pre), folded=True)
        return out, (ws, acc)
    (jout, jvjp, (jws, jacc)) = jax.vjp(f, jv['params'], jnp.asarray(x),
                                        has_aux=True)
    tmod = _load(TL.QuantConvBn(cin, cout, (k, k), strides=(s, s),
                                padding=pad, **kw), v)
    tx = _t(x, grad=True)
    out, ws, acc = tmod(tx, _t(pre), folded=True)
    _eq(acc, jacc, 'acc')
    _eq(ws, jws, 'weight_scale')
    _eq(out, jout, 'out')
    g = rng.randn(*out.shape).astype(np.float32)
    out.backward(_t(g))
    jgp, jgx = jvjp(jnp.asarray(g))
    _close(tx.grad, jgx, 1e-5, 'dx')
    for name in ('kernel', 'gamma', 'beta'):
        _close(getattr(tmod, name).grad, jgp[name], 1e-5, name)

    if kw.get('weight_percentile'):
        return                      # the unfolded branch ignores it
    # unfolded: batch-statistics BN in float; torch.var sums in another
    # order than jnp.var, so values agree to rtol 1e-5, not bit for bit
    (jout, jws, jacc), mut = jmod.apply(jv, jnp.asarray(x), jnp.asarray(pre),
                                        folded=False, update_stats=True,
                                        mutable=['batch_stats'])
    assert jacc is None
    tmod = _load(TL.QuantConvBn(cin, cout, (k, k), strides=(s, s),
                                padding=pad, **kw), v)
    out, ws, acc = tmod(_t(x), _t(pre), folded=False, update_stats=True)
    assert acc is None
    _close(out, jout, 1e-5, 'unfolded out')
    _close(ws, jws, 1e-5, 'unfolded weight scale')
    _close(tmod.mean, mut['batch_stats']['mean'], 1e-5, 'running mean')
    _close(tmod.var, mut['batch_stats']['var'], 1e-5, 'running var')
    before = tmod.mean.clone()
    tmod(_t(x), _t(pre), folded=False, update_stats=False)
    _eq(tmod.mean, before)


def test_quant_convbn_weight_scale_is_detached():
    rng = np.random.RandomState(1)
    v = _convbn_variables(rng, 1, 3, 3)
    x = rng.randn(2, 4, 4, 3).astype(np.float32)
    jmod = JL.QuantConvBn(features=3, kernel_size=(1, 1))
    jv = jax.tree.map(jnp.asarray, v)
    jg = jax.grad(lambda p: jnp.sum(jmod.apply(
        {**jv, 'params': p}, jnp.asarray(x), jnp.float32(0.05),
        folded=True)[0]))(jv['params'])
    tmod = _load(TL.QuantConvBn(3, 3, (1, 1)), v)
    out, ws, _ = tmod(_t(x), _t(np.float32(0.05)), folded=True)
    assert not ws.requires_grad
    out.sum().backward()
    _close(tmod.kernel.grad, jg['kernel'], 1e-5)


@pytest.mark.parametrize('kw', [{}, dict(use_bias=False),
                                dict(per_channel=False, weight_bit=4)])
def test_quant_conv2d(kw):
    rng = np.random.RandomState(5)
    pre = np.float32(0.02)
    x = rng.randint(-128, 128, (2, 5, 5, 6)).astype(np.float32) * pre
    params = {'kernel': rng.randn(1, 1, 6, 4).astype(np.float32)}
    if kw.get('use_bias', True):
        params['bias'] = rng.randn(4).astype(np.float32)
    jout, jws, jacc = JL.QuantConv2d(features=4, kernel_size=(1, 1),
                                     **kw).apply(
        {'params': jax.tree.map(jnp.asarray, params)}, jnp.asarray(x),
        jnp.asarray(pre))
    tmod = _load(TL.QuantConv2d(6, 4, (1, 1), **kw), {'params': params})
    out, ws, acc = tmod(_t(x), _t(pre))
    _eq(acc, jacc)
    _eq(ws, jws)
    _eq(out, jout)


@pytest.mark.parametrize('kw', [{}, dict(per_channel=False),
                                dict(weight_bit=4, bias_bit=16)])
def test_quant_linear(kw):
    rng = np.random.RandomState(6)
    pre = np.float32(0.02)
    x = rng.randint(-128, 128, (3, 64)).astype(np.float32) * pre
    params = {'kernel': rng.randn(64, 10).astype(np.float32) * 0.1,
              'bias': rng.randn(10).astype(np.float32)}
    jmod = JL.QuantLinear(features=10, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    jout, vjp = jax.vjp(lambda p, x: jmod.apply({'params': p}, x,
                                                jnp.asarray(pre)),
                        jp, jnp.asarray(x))
    tmod = _load(TL.QuantLinear(64, 10, **kw), {'params': params})
    tx = _t(x, grad=True)
    out = tmod(tx, _t(pre))
    _eq(out, jout)
    g = rng.randn(3, 10).astype(np.float32)
    out.backward(_t(g))
    jgp, jgx = vjp(jnp.asarray(g))
    _close(tx.grad, jgx, 1e-5)
    _close(tmod.kernel.grad, jgp['kernel'], 1e-5)
    _close(tmod.bias.grad, jgp['bias'], 1e-5)


@pytest.mark.parametrize('mode,relu', [('symmetric', True),
                                       ('asymmetric', True),
                                       ('symmetric', False)])
def test_quant_bn_act(mode, relu):
    rng = np.random.RandomState(7)
    c = 6
    v = {'params': {'gamma': (rng.rand(c) + 0.5).astype(np.float32),
                    'beta': rng.randn(c).astype(np.float32) * 0.2},
         'batch_stats': {'mean': rng.randn(c).astype(np.float32) * 0.3,
                         'var': (rng.rand(c) + 0.3).astype(np.float32)},
         'quant_stats': {'x_min': np.float32(-1.0), 'x_max': np.float32(2.0)}}
    in_scale = np.float32(0.0031)
    x_int = rng.randint(-2 ** 12, 2 ** 12, (2, 4, 4, c)).astype(np.float32)
    x = x_int * in_scale
    kw = dict(bits=8, quant_mode=mode, relu=relu)
    jmod = JL.QuantBnAct(features=c, **kw)
    jv = jax.tree.map(jnp.asarray, v)
    for folded, ints in ((True, True), (True, False), (False, False)):
        jkw = dict(x_int=jnp.asarray(x_int)) if ints else {}
        (jy, js), mut = jmod.apply(
            jv, jnp.asarray(x), jnp.asarray(in_scale), folded=folded,
            update_stats=True, **jkw,
            mutable=['quant_stats', 'batch_stats', 'intermediates'])
        tmod = _load(TL.QuantBnAct(c, **kw), v)
        with TL.capture_q_int(tmod) as q:
            ty, ts = tmod(_t(x), _t(in_scale), folded=folded,
                          update_stats=True,
                          **(dict(x_int=_t(x_int)) if ints else {}))
        if folded:
            _eq(q[''], mut['intermediates']['q_int'][0], 'q_int')
            _eq(ts, js)
            _eq(ty, jy)
            _eq(tmod.x_max, mut['quant_stats']['x_max'])
            _eq(tmod.x_min, mut['quant_stats']['x_min'])
        else:
            # batch-statistics BN: torch.var's summation order
            _close(ts, js, 1e-5)
            _close(tmod.var, mut['batch_stats']['var'], 1e-5)
            _close(tmod.mean, mut['batch_stats']['mean'], 1e-5)
            assert float((q[''] - _t(np.asarray(
                mut['intermediates']['q_int'][0]))).abs().max()) <= 1


# ---------------------------------------------------------------------------
# dropout and pools
# ---------------------------------------------------------------------------

def test_quant_dropout():
    x = _t(np.random.RandomState(8).randn(4, 100).astype(np.float32))
    s = _t(np.float32(0.1))
    drop = TL.QuantDropout(rate=0.5)
    y, s2 = drop(x, s)                       # no generator: identity
    assert y is x and s2 is s
    gen = torch.Generator().manual_seed(3)
    y, _ = drop(x, s, generator=gen)
    kept = y != 0
    assert 0.3 < float(kept.float().mean()) < 0.7
    _eq(y[kept], (x * 2.0)[kept])
    y2, _ = drop(x, s, generator=torch.Generator().manual_seed(3))
    _eq(y2, y)                               # the same seed, the same mask
    assert TL.QuantDropout(0.0)(x, s, generator=gen)[0] is x
    assert drop(x, s, deterministic=True, generator=gen)[0] is x


def test_quant_pools():
    rng = np.random.RandomState(9)
    s = np.float32(0.037)
    x = rng.randint(-2 ** 15, 2 ** 15, (2, 7, 7, 5)).astype(np.float32) * s
    for args in (((3, 3), (2, 2), ((1, 1), (1, 1))), ((2, 2), (2, 2), 'VALID'),
                 ((3, 3), (2, 2), 'SAME')):
        jy, js = JL.quant_max_pool(jnp.asarray(x), jnp.asarray(s), *args)
        ty, ts = TL.quant_max_pool(_t(x), _t(s), *args)
        _eq(ty, jy)
        _eq(ts, js)
    for window, strides in (((7, 7), (1, 1)), ((3, 3), (2, 2)),
                            ((2, 2), (1, 1))):
        jy, _ = JL.quant_avg_pool(jnp.asarray(x), jnp.asarray(s), window,
                                  strides)
        ty, _ = TL.quant_avg_pool(_t(x), _t(s), window, strides)
        _eq(ty, jy)
    jy, vjp = jax.vjp(lambda x: JL.quant_global_avg_pool(x, jnp.asarray(s))[0],
                      jnp.asarray(x))
    tx = _t(x, grad=True)
    ty, ts = TL.quant_global_avg_pool(tx, _t(s))
    assert ty.shape == (2, 5)
    _eq(ty, jy)
    g = rng.randn(2, 5).astype(np.float32)
    ty.backward(_t(g))
    _close(tx.grad, vjp(jnp.asarray(g))[0], 1e-6)
