"""D1, the depthwise 3×3 int8 conv of hawq_tpu_torch (kernels/depthwise.py),
against hawq_tpu on the same numpy inputs.

The plain versions, which the wrappers run on CPU tensors, are bit-equal
(tolerance 0) to the reference's two formulations of the depthwise conv:
nine shifted int32 multiply-adds (``engine_mobilenet._dw_shifted``) and
XLA's int8 grouped convolution (``engine._conv_i8`` with groups = C), and
the requant form to the reference's ``_relu6_clip`` then ``requant_int32``.
The grouped ``int_conv2d`` and the depthwise ``QuantConvBn`` of the QAT
layers equal the flax ones bit for bit in their integers, with gradients
within rtol 1e-5 (the float gradient convolutions sum in another order).
The kernel itself runs on the card only (tests/test_torch_cuda.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.inference.engine import _conv_i8
from hawq_tpu.inference.engine_mobilenet import _dw_shifted, _relu6_clip
from hawq_tpu.nn import layers as JL
from hawq_tpu.quant import ops as jops

from hawq_tpu_torch.inference.engine_mobilenet import relu6_bound
from hawq_tpu_torch.kernels import depthwise as kd
from hawq_tpu_torch.nn import layers as TL
from hawq_tpu_torch.quant.ops import np_dyadic_multiplier

torch.set_num_threads(1)

_SHAPES = [(2, 9, 7, 8), (1, 8, 8, 16), (2, 7, 11, 24), (1, 1, 1, 16),
           (1, 2, 3, 8)]


def _operands(rng, shape, saturate):
    c = shape[-1]
    if saturate:
        x = np.full(shape, -128, np.int8)
        w = np.full((3, 3, 1, c), -127, np.int8)
    else:
        x = rng.randint(-128, 128, shape).astype(np.int8)
        w = rng.randint(-127, 128, (3, 3, 1, c)).astype(np.int8)
    b = rng.randint(-2 ** 20, 2 ** 20, c).astype(np.int32)
    return x, w, b


@pytest.mark.parametrize('shape', _SHAPES)
@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('saturate', [False, True])
def test_acc_plain_equals_shifted_and_grouped_conv(shape, stride, saturate):
    x, w, b = _operands(np.random.RandomState(sum(shape) + stride), shape,
                        saturate)
    got = kd.int8_dwconv_acc(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), stride=stride)
    assert got.dtype == torch.int32
    shifted = np.asarray(_dw_shifted(jnp.asarray(x), w, stride)) + b
    grouped = np.asarray(_conv_i8(jnp.asarray(x), w, (stride, stride),
                                  ((1, 1), (1, 1)), groups=shape[-1])) + b
    np.testing.assert_array_equal(got.numpy(), shifted)
    np.testing.assert_array_equal(got.numpy(), grouped)
    assert got.shape[1:3] == kd.dw_output_hw(*shape[1:3], stride)


@pytest.mark.parametrize('shape', _SHAPES[:3])
@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('bits,signed', [(8, True), (4, False), (4, True)])
def test_requant_plain_equals_reference_epilogue(shape, stride, bits,
                                                 signed):
    """ReLU6 bound binding on some channels and not on others, and
    multipliers that put accumulators on a .5 boundary."""
    rng = np.random.RandomState(sum(shape) + bits)
    x, w, b = _operands(rng, shape, False)
    c = shape[-1]
    acc_scale = (rng.rand(c) * 3e-4 + 2e-5).astype(np.float32)
    acc_scale[::2] = 6.0 / 40.0          # hi6 = 40 binds on these channels
    mult = np_dyadic_multiplier((rng.rand(c) * 0.02 + 1e-3)
                                .astype(np.float32))
    mult[1::3] = 0.5                     # odd accumulators land on .5
    lo, hi = jops.requant_clip_bounds(bits, signed)
    got = kd.int8_dwconv_requant(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        torch.from_numpy(relu6_bound(acc_scale)), torch.from_numpy(mult),
        stride=stride, lo=lo, hi=hi)
    acc = _relu6_clip(_dw_shifted(jnp.asarray(x), w, stride) + b, acc_scale)
    want = np.asarray(jops.requant_int32(acc, jnp.asarray(mult), bits,
                                         signed))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.asarray(acc)[..., ::2] == 40).any()      # the bound binds


def test_relu6_bound_equals_reference():
    rng = np.random.RandomState(0)
    acc_scale = np.concatenate([
        (rng.rand(500) * 1e-3 + 1e-7).astype(np.float32),
        np.float32(6.0) / np.arange(1, 200, dtype=np.float32)])
    big = jnp.full((len(acc_scale),), 2 ** 31 - 1, jnp.int32)
    np.testing.assert_array_equal(relu6_bound(acc_scale),
                                  np.asarray(_relu6_clip(big, acc_scale)))


def test_wrapper_checks():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    w = torch.zeros((3, 3, 1, 8), dtype=torch.int8)
    b = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):          # no kernel for a meta tensor
        kd.int8_dwconv_acc(x.to('meta'), w, b, stride=1)
    # the CPU path is the plain version
    assert torch.equal(kd.int8_dwconv_acc(x, w, b, stride=2),
                       kd.dwconv_acc_plain(x, w, b, 2))


@pytest.mark.parametrize('stride', [1, 2])
def test_grouped_int_conv2d_forward_and_gradients(stride):
    rng = np.random.RandomState(stride)
    c = 8
    x = rng.randint(-128, 128, (2, 7, 9, c)).astype(np.float32)
    w = rng.randint(-127, 128, (3, 3, 1, c)).astype(np.float32)
    b = rng.randint(-2 ** 20, 2 ** 20, c).astype(np.float32)
    pad = ((1, 1), (1, 1))
    jy, vjp = jax.vjp(lambda x, w, b: JL.int_conv2d(
        x, w, b, (stride, stride), pad, c), jnp.asarray(x), jnp.asarray(w),
        jnp.asarray(b))
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    y = TL.int_conv2d(tx, tw, tb, (stride, stride), pad, c)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    g = rng.randn(*y.shape).astype(np.float32)
    y.backward(torch.from_numpy(g))
    for t, jg in zip((tx, tw, tb), vjp(jnp.asarray(g))):
        jg = np.asarray(jg)
        np.testing.assert_allclose(t.grad.numpy(), jg, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(jg).max()))


def test_other_groupings_raise():
    x = torch.zeros((1, 6, 6, 8))
    for w, strides, pad, groups in [
            (torch.zeros((3, 3, 2, 8)), (1, 1), 'SAME', 4),     # 2 a group
            (torch.zeros((5, 5, 1, 8)), (1, 1), 'SAME', 8),     # 5×5
            (torch.zeros((3, 3, 1, 8)), (1, 1), 'VALID', 8),    # no pad
            (torch.zeros((3, 3, 1, 8)), (3, 3), 'SAME', 8),     # stride 3
            (torch.zeros((3, 3, 1, 16)), (1, 1), 'SAME', 8)]:   # multiplier
        with pytest.raises(NotImplementedError):
            TL.int_conv2d(x, w, torch.zeros(w.shape[-1]), strides, pad,
                          groups)


@pytest.mark.parametrize('stride,kw', [(1, {}), (2, {}),
                                       (1, dict(weight_bit=4)),
                                       (2, dict(per_channel=False))])
def test_depthwise_quant_convbn_folded_and_unfolded(stride, kw):
    """A (3, 3, 1, C) kernel: per-channel ranges over 9 taps, BN folded per
    output channel, the integer conv through D1's accumulator form."""
    rng = np.random.RandomState(7 + stride)
    c, h = 16, 9
    v = {'params': {
        'kernel': rng.randn(3, 3, 1, c).astype(np.float32) * 0.3,
        'gamma': (rng.rand(c) + 0.5).astype(np.float32),
        'beta': rng.randn(c).astype(np.float32) * 0.1},
        'batch_stats': {'mean': rng.randn(c).astype(np.float32) * 0.1,
                        'var': (rng.rand(c) + 0.3).astype(np.float32)}}
    pre = np.float32(0.037)
    x = rng.randint(-128, 128, (2, h, h, c)).astype(np.float32) * pre
    jmod = JL.QuantConvBn(features=c, kernel_size=(3, 3),
                          strides=(stride, stride), padding=((1, 1), (1, 1)),
                          groups=c, **kw)
    jv = jax.tree.map(jnp.asarray, v)

    def f(params, x):
        out, ws, acc = jmod.apply({**jv, 'params': params}, x,
                                  jnp.asarray(pre), folded=True)
        return out, (ws, acc)
    jout, jvjp, (jws, jacc) = jax.vjp(f, jv['params'], jnp.asarray(x),
                                      has_aux=True)

    def port():
        mod = TL.QuantConvBn(c, c, (3, 3), strides=(stride, stride),
                             padding=((1, 1), (1, 1)), groups=c, **kw)
        with torch.no_grad():
            for coll in v.values():
                for k, a in coll.items():
                    getattr(mod, k).copy_(torch.from_numpy(a))
        return mod
    tmod = port()
    tx = torch.tensor(x, requires_grad=True)
    out, ws, acc = tmod(tx, torch.tensor(pre), folded=True)
    for got, want in ((acc, jacc), (ws, jws), (out, jout)):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    g = rng.randn(*out.shape).astype(np.float32)
    out.backward(torch.from_numpy(g))
    jgp, jgx = jvjp(jnp.asarray(g))
    for got, want in [(tx.grad, jgx)] + [(getattr(tmod, n).grad, jgp[n])
                                         for n in ('kernel', 'gamma', 'beta')]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))

    (jout, jws, _), mut = jmod.apply(jv, jnp.asarray(x), jnp.asarray(pre),
                                     folded=False, update_stats=True,
                                     mutable=['batch_stats'])
    tmod = port()
    out, ws, acc = tmod(torch.from_numpy(x), torch.tensor(pre), folded=False,
                        update_stats=True)
    assert acc is None
    for got, want in ((out, jout), (ws, jws),
                      (tmod.mean, mut['batch_stats']['mean']),
                      (tmod.var, mut['batch_stats']['var'])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want).max()))
