"""The port's kernel wrappers on CPU tensors (their plain versions) == the
JAX package's oracles, bit for bit.

Oracles: ``reference_matmul_requant`` (kernels/matmul.py), the int32
``lax.dot_general``, ``reference_conv_requant`` (kernels/conv.py) and the
int32 lax conv, ``fold.maxpool_3x3s2p1_folded`` and the Pallas
``maxpool_folded`` in interpret mode, the Pallas ``minmax_1pass`` and
``int8_matmul_requant_kblocked`` in interpret mode.  The CUDA kernels themselves are held
against these plain versions on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hawq_tpu.inference.fold import maxpool_3x3s2p1_folded as jpool_ref
from hawq_tpu.kernels import conv as jkc
from hawq_tpu.kernels import matmul as jkm
from hawq_tpu.kernels.pool import maxpool_folded as jpool_kernel
from hawq_tpu.kernels.reduce import minmax_1pass as jminmax

from hawq_tpu_torch.kernels import conv as tkc
from hawq_tpu_torch.kernels import matmul as tkm
from hawq_tpu_torch.kernels.pool import maxpool_folded as tpool
from hawq_tpu_torch.kernels.reduce import minmax_1pass as tminmax
from hawq_tpu_torch.quant.ops import np_dyadic_multiplier

torch.set_num_threads(1)

# (out_bits, signed, relu): signed and unsigned 4-bit outputs, ReLU or not
_EPILOGUES = [(8, True, False), (8, True, True), (4, False, True),
              (4, True, False)]


def _operands(rng, m, k, n, wbits=8):
    q = 2 ** (wbits - 1) - 1
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = np.clip(np.round(rng.normal(0, q / 3.5, (k, n))), -q, q).astype(np.int8)
    bias = rng.randint(-2 ** 14, 2 ** 14, n).astype(np.int32)
    mult = np_dyadic_multiplier((rng.rand(n) * 2e-3 + 1e-4).astype(np.float32))
    return x, w, bias, mult


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize('m,k,n', [(37, 45, 19), (64, 256, 128), (8, 2048, 1000),
                                   (5, 3, 7)])
def test_matmul_plain_matches_oracle(m, k, n):
    rng = np.random.RandomState(m + k + n)
    x, w, bias, mult = _operands(rng, m, k, n)
    for out_bits, signed, relu in _EPILOGUES:
        want = np.asarray(jkm.reference_matmul_requant(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
            jnp.asarray(mult), out_bits=out_bits, signed=signed))
        if relu:
            want = np.maximum(want, 0)
        got = tkm.int8_matmul_requant(_t(x), _t(w), _t(bias), _t(mult),
                                      out_bits=out_bits, signed=signed,
                                      relu=relu).numpy()
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want,
                                      err_msg=f'{out_bits} {signed} {relu}')
    want = np.asarray(jax.lax.dot_general(
        jnp.asarray(x), jnp.asarray(w), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32) + bias)
    got = tkm.int8_matmul_acc(_t(x), _t(w), _t(bias)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _lax_conv_acc(x8, w, bias, stride, pad):
    dn = jax.lax.conv_dimension_numbers(x8.shape, w.shape,
                                        ('NHWC', 'HWIO', 'NHWC'))
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x8), jnp.asarray(w), (stride, stride),
        ((pad, pad), (pad, pad)), dimension_numbers=dn,
        preferred_element_type=jnp.int32) + bias)


def _port_conv(x8, w, bias, mult, stride, pad, **epi):
    """The engine's routing: stride 1 over the padded slab, stride 2 through
    the space-to-depth rewrite."""
    b, h, wd, c = x8.shape
    kh, kw = w.shape[:2]
    if stride == 2:
        x2, w2 = tkc.s2d_conv_transform(_t(x8), w, pad)
        oh, ow = tkc.s2d_output_hw(h, wd, kh, kw, pad)
        xp = tkc.prepare_conv_input(x2, (0, 0))
        w = w2
    else:
        oh, ow = h + 2 * pad - kh + 1, wd + 2 * pad - kw + 1
        xp = tkc.prepare_conv_input(_t(x8), (pad, pad))
    args = dict(taps=w.shape[:2], out_hw=(oh, ow), cin=w.shape[2])
    wf = _t(tkc.flatten_conv_kernel(w))
    if mult is None:
        y = tkc.int8_conv_acc(xp, wf, _t(bias), **args)
    else:
        y = tkc.int8_conv_requant(xp, wf, _t(bias), _t(mult), **args, **epi)
    return y.reshape(b, oh, ow, -1).numpy()


@pytest.mark.parametrize('shape,cout,stride', [
    ((2, 9, 7, 5), 11, 1), ((2, 9, 7, 5), 11, 2), ((1, 8, 8, 16), 32, 1),
    ((2, 10, 10, 8), 16, 2), ((1, 6, 5, 3), 4, 1)])
def test_conv_plain_matches_oracle(shape, cout, stride):
    rng = np.random.RandomState(sum(shape) + cout + stride)
    x8 = rng.randint(-128, 128, shape).astype(np.int8)
    _, w2d, bias, mult = _operands(rng, 1, 9 * shape[3], cout)
    w = w2d.reshape(3, 3, shape[3], cout)
    for out_bits, signed, relu in _EPILOGUES:
        want = np.asarray(jkc.reference_conv_requant(
            jnp.asarray(x8), jnp.asarray(w), jnp.asarray(bias),
            jnp.asarray(mult), stride=stride, pad=1, out_bits=out_bits,
            signed=signed, relu=relu))
        got = _port_conv(x8, w, bias, mult, stride, 1, out_bits=out_bits,
                         signed=signed, relu=relu)
        np.testing.assert_array_equal(got, want,
                                      err_msg=f'{out_bits} {signed} {relu}')
    np.testing.assert_array_equal(_port_conv(x8, w, bias, None, stride, 1),
                                  _lax_conv_acc(x8, w, bias, stride, 1))


def test_init_conv_rewrites_match_oracle():
    """The raw 7×7/s2/p3 init through its space-to-depth 4×4 rewrite."""
    rng = np.random.RandomState(11)
    x8 = rng.randint(-128, 128, (2, 17, 16, 3)).astype(np.int8)
    w = rng.randint(-127, 128, (7, 7, 3, 10)).astype(np.int8)
    bias = rng.randint(-2 ** 14, 2 ** 14, 10).astype(np.int32)
    np.testing.assert_array_equal(_port_conv(x8, w, bias, None, 2, 3),
                                  _lax_conv_acc(x8, w, bias, 2, 3))


def test_conv_host_helpers_equal():
    rng = np.random.RandomState(12)
    x8 = rng.randint(-128, 128, (2, 7, 9, 4)).astype(np.int8)
    w = rng.randint(-127, 128, (3, 3, 4, 6)).astype(np.int8)
    for pad in ((1, 1), (0, 0), (2, 1)):
        np.testing.assert_array_equal(
            tkc.prepare_conv_input(_t(x8), pad).numpy(),
            np.asarray(jkc.prepare_conv_input(jnp.asarray(x8), pad)))
    for pad in (0, 1, 3):
        np.testing.assert_array_equal(
            tkc.s2d_input(_t(x8), pad).numpy(),
            np.asarray(jkc.s2d_input(jnp.asarray(x8), pad)))
        assert tkc.s2d_output_hw(7, 9, 3, 3, pad) == \
            jkc.s2d_output_hw(7, 9, 3, 3, pad)
    np.testing.assert_array_equal(tkc.s2d_kernel(w), jkc.s2d_kernel(w))
    np.testing.assert_array_equal(tkc.flatten_conv_kernel(w),
                                  jkc.flatten_conv_kernel(w))


def test_folded_maxpool_plain_matches_oracles():
    rng = np.random.RandomState(0)
    for dt in (np.int16, np.int32, np.float32):
        for shape in ((2, 7, 9, 20), (1, 8, 8, 256)):
            xf = rng.randint(-2 ** 14, 2 ** 14, shape).astype(dt)
            want = np.asarray(jax.jit(jpool_ref)(jnp.asarray(xf)))
            got = tpool(_t(xf)).numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f'{dt} {shape}')
            if shape[-1] == 20:
                np.testing.assert_array_equal(
                    got, np.asarray(jpool_kernel(jnp.asarray(xf),
                                                 interpret=True)))


@pytest.mark.parametrize('shape', [(2, 56, 56, 128), (777,)])
def test_minmax_plain_matches_pallas_kernel(shape):
    """(2,56,56,128) is one whole Pallas block plus a tail; (777,) is below
    one block."""
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jminmax(jnp.asarray(x))
    got = tminmax(_t(x))
    for g, w in zip(got, want):
        assert g.shape == () and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0].numpy(), x.min())
    np.testing.assert_array_equal(got[1].numpy(), x.max())


@pytest.mark.parametrize('case', ['nan', 'inf', 'single', 'strided'])
def test_minmax_edge_cases_match_jnp(case):
    x = np.random.RandomState(3).randn(5, 9).astype(np.float32)
    if case == 'nan':
        x[2, 3] = np.nan
    elif case == 'inf':
        x[0, 0], x[4, 8] = np.inf, -np.inf
    elif case == 'single':
        x = x[:1, :1]
    tx = _t(x)
    if case == 'strided':
        x, tx = x[:, ::2], tx[:, ::2]
        assert not tx.is_contiguous()
    got = tminmax(tx)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(jnp.min(jnp.asarray(x))))
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(jnp.max(jnp.asarray(x))))


def test_minmax_empty_raises():
    with pytest.raises(ValueError):
        tminmax(torch.zeros((0, 4)))


def test_kblocked_plain_matches_pallas_kernel_and_oracle():
    """The shape and blocks of the reference's own K-blocked test."""
    rng = np.random.RandomState(5)
    x, w, bias, mult = _operands(rng, 128, 512, 128)
    args = [jnp.asarray(a) for a in (x, w, bias, mult)]
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(jkm.int8_matmul_requant_kblocked(
            *args, block_m=64, block_n=128, block_k=128))
    oracle = np.asarray(jkm.reference_matmul_requant(*args))
    got = tkm.int8_matmul_requant_kblocked(_t(x), _t(w), _t(bias),
                                           _t(mult)).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, kernel)
    np.testing.assert_array_equal(got, oracle)
    # its own epilogues, and a K that no block size divides
    x, w, bias, mult = _operands(rng, 37, 45, 19)
    for out_bits, signed, relu in _EPILOGUES:
        want = np.asarray(jkm.reference_matmul_requant(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
            jnp.asarray(mult), out_bits=out_bits, signed=signed))
        if relu:
            want = np.maximum(want, 0)
        np.testing.assert_array_equal(
            tkm.int8_matmul_requant_kblocked(
                _t(x), _t(w), _t(bias), _t(mult), out_bits=out_bits,
                signed=signed, relu=relu).numpy(), want)


def test_device_twins_of_the_host_conv_helpers():
    """The torch twins that rewrite training weights on their own device ==
    the numpy helpers the engine uses once per layer."""
    rng = np.random.RandomState(13)
    for shape in ((3, 3, 4, 6), (7, 7, 3, 10), (1, 1, 8, 5), (2, 2, 4, 3),
                  (3, 5, 2, 4)):
        w = rng.randint(-127, 128, shape).astype(np.int8)
        np.testing.assert_array_equal(tkc.s2d_kernel_torch(_t(w)).numpy(),
                                      tkc.s2d_kernel(w))
        np.testing.assert_array_equal(
            tkc.flatten_conv_kernel_torch(_t(w)).numpy(),
            tkc.flatten_conv_kernel(w))
        np.testing.assert_array_equal(
            tkc.flatten_conv_kernel_torch(
                tkc.s2d_kernel_torch(_t(w))).numpy(),
            tkc.flatten_conv_kernel(tkc.s2d_kernel(w)))


def test_wrappers_reject_other_devices():
    """No silent fallback: a tensor that is not on the CPU never takes the
    plain path, and without a CUDA device there is no kernel to launch."""
    x = torch.zeros((4, 4), dtype=torch.int8, device='meta')
    w = torch.zeros((4, 4), dtype=torch.int8, device='meta')
    b = torch.zeros((4,), dtype=torch.int32, device='meta')
    with pytest.raises(ValueError):
        tkm.int8_matmul_acc(x, w, b)
    with pytest.raises(ValueError):
        tpool(torch.zeros((1, 2, 2, 4), dtype=torch.int16, device='meta'))
    with pytest.raises(ValueError):
        tminmax(torch.zeros((4, 4), device='meta'))
    with pytest.raises(ValueError):
        tkm.int8_matmul_requant_kblocked(
            x, w, b, torch.zeros((4,), device='meta'))
