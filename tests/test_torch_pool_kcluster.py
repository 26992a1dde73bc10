"""The folded pool with the init requant in front, the pool's column-run
walk, and the K-blocked matmul on a Hopper-core handle, on the CPU.

``maxpool_folded_requant`` (requant, ReLU, then the folded max-pool in one
kernel on the card) and ``int8_matmul_requant_kblocked`` over a
``prepare_weights`` handle (the Hopper core's walk: the whole K in one
accumulator, one requant) are held against ``hawq_tpu`` on the same numpy
inputs from a seed, tolerance 0: the pool against
``inference.fold.maxpool_3x3s2p1_folded`` over ``quant.ops.requant_int32``,
the matmul against the Pallas ``int8_matmul_requant_kblocked`` in interpret
mode and ``reference_matmul_requant``.  Beside them: the plain walk of the
pool kernel (runs of R columns, the left term carried) against the oracle,
and the folded engine's call of the fused pool.  The kernels themselves are
held against these plain versions on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hawq_tpu.inference import fold as jfold
from hawq_tpu.kernels import matmul as jkm
from hawq_tpu.quant import ops as jops

from hawq_tpu_torch.configs.bit_config import get_bit_config
from hawq_tpu_torch.inference.engine import build_resnet_engine
from hawq_tpu_torch.inference.fold import fold4_images, maxpool_3x3s2p1_folded
from hawq_tpu_torch.inference.synthetic import synthetic_frozen_resnet
from hawq_tpu_torch.kernels import matmul as tkm
from hawq_tpu_torch.kernels import pool as tkp
from hawq_tpu_torch.quant.ops import np_dyadic_multiplier

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# maxpool_folded_requant
# ---------------------------------------------------------------------------

def _requant_operands(rng, shape, out_bits):
    """An int32 accumulator with negative values, odd values under a 0.5
    multiplier (requant inputs exactly on a .5 boundary) and values that
    saturate both clip bounds; multipliers that differ across the four
    (py, px) origins of each channel."""
    b, hq, wq, n4 = shape
    n = n4 // 4
    acc = rng.randint(-2 ** 20, 2 ** 20, shape).astype(np.int32)
    acc[..., ::5] = rng.randint(-99, 100, acc[..., ::5].shape) * 2 + 1
    big = 2 ** (out_bits + 2)
    acc[0, 0, 0, :] = big                      # above hi for every multiplier
    acc[-1, -1, -1, :] = -big                  # below lo
    mult = np_dyadic_multiplier(
        (rng.rand(n4) * 2 ** (3 - out_bits) + 1e-5).astype(np.float32))
    mult[::5] = 0.5                            # the .5 boundary
    mult[n:2 * n] *= 3                         # (py, px) origins differ
    mult[3 * n:] /= 2
    mult[0], mult[n4 - 1] = 4.0, 4.0           # saturation on both sides
    return acc, mult.astype(np.float32)


@pytest.mark.parametrize('out_dtype,out_bits,signed', [
    (torch.int16, 16, True), (torch.int32, 16, True), (torch.int16, 8, True),
    (torch.int32, 8, True), (torch.int16, 8, False), (torch.int32, 12, False)])
@pytest.mark.parametrize('relu', [True, False])
def test_pool_requant_plain_matches_hawq_tpu(out_dtype, out_bits, signed,
                                             relu):
    rng = np.random.RandomState(out_bits + 7 * signed)
    jdt = {torch.int16: jnp.int16, torch.int32: jnp.int32}[out_dtype]
    for shape in ((2, 5, 7, 20), (1, 4, 4, 256), (3, 1, 3, 8)):
        acc, mult = _requant_operands(rng, shape, out_bits)
        x = jops.requant_int32(jnp.asarray(acc), jnp.asarray(mult), out_bits,
                               signed, jdt)
        if relu:
            x = jnp.maximum(x, 0)
        want = np.asarray(jfold.maxpool_3x3s2p1_folded(x))
        got = tkp.maxpool_folded_requant(_t(acc), _t(mult), out_bits=out_bits,
                                         signed=signed, relu=relu,
                                         out_dtype=out_dtype)
        assert got.dtype == out_dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        # the values the clip reaches are in the result
        lo = 0 if relu or not signed else -2 ** (out_bits - 1)
        hi = 2 ** (out_bits - (1 if signed else 0)) - 1
        assert got.max() == hi and got.min() >= lo


def test_pool_requant_plain_is_the_engine_sequence():
    """The plain version is the engine's former three lines."""
    rng = np.random.RandomState(3)
    acc, mult = _requant_operands(rng, (2, 6, 6, 16), 16)
    a, m = _t(acc), _t(mult)
    from hawq_tpu_torch.quant.ops import requant_int32
    want = maxpool_3x3s2p1_folded(
        torch.clamp_min(requant_int32(a, m, 16, True, torch.int16), 0))
    got = tkp.maxpool_folded_requant_plain(a, m, 16, True, True, torch.int16)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the pool kernel's walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('wq', [5, 7, 9])
@pytest.mark.parametrize('run', [4, 8])
def test_pool_walk_matches_oracle(wq, run):
    rng = np.random.RandomState(wq * run)
    for dtype in (np.int16, np.int32, np.float32):
        for hq in (1, 2, 6):
            xf = rng.randint(-2 ** 14, 2 ** 14, (2, hq, wq, 12)).astype(dtype)
            want = np.asarray(jfold.maxpool_3x3s2p1_folded(jnp.asarray(xf)))
            got = tkp.maxpool_folded_walk_plain(_t(xf), run)
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(
                maxpool_3x3s2p1_folded(_t(xf)).numpy(), want)


def test_pool_wrapper_options_checked():
    xf = torch.arange(2 * 3 * 9 * 8, dtype=torch.int16).reshape(2, 3, 9, 8)
    acc = torch.zeros((1, 2, 2, 8), dtype=torch.int32)
    mult = torch.ones(8)
    assert torch.equal(tkp.maxpool_folded(xf), maxpool_3x3s2p1_folded(xf))
    assert torch.equal(tkp.maxpool_folded_walk_plain(xf),   # the kernel's run
                       maxpool_3x3s2p1_folded(xf))
    assert tkp.maxpool_folded_requant(
        acc, mult, out_bits=16, signed=True, relu=True,
        out_dtype=torch.int16).shape == (1, 2, 2, 2)
    with pytest.raises(ValueError):            # no kernel off the CPU
        tkp.maxpool_folded_requant(acc.to('meta'), mult.to('meta'),
                                   out_bits=16, signed=True, relu=True,
                                   out_dtype=torch.int16)


@pytest.mark.parametrize('arch,mode', [('tiny50', 'folded_float32'),
                                       ('tiny18', 'folded_int8')])
def test_folded_engine_calls_the_fused_pool_once(arch, mode, monkeypatch):
    """The folded init runs maxpool_folded_requant once and maxpool_folded
    never; the engine's 'init' node is the fused pool's output."""
    fm = synthetic_frozen_resnet(arch, get_bit_config(arch, 'uniform8'),
                                 num_classes=10, seed=1)
    x = fold4_images(np.random.RandomState(2).randn(2, 32, 32, 3).astype(
        np.float32))
    if mode == 'folded_int8':
        from hawq_tpu_torch.utils.preproc import quantize_int8
        x = quantize_int8(x, fm.act_scale('quant_input'))
    calls = {'maxpool_folded_requant': [], 'maxpool_folded': []}
    for name in calls:
        real = getattr(tkp, name)

        def spy(*args, _name=name, _real=real, **kw):
            out = _real(*args, **kw)
            calls[_name].append(out)
            return out
        monkeypatch.setattr(tkp, name, spy)
    init = build_resnet_engine(fm, input_mode=mode, capture='init',
                               device='cpu')(x)
    assert len(calls['maxpool_folded_requant']) == 1
    assert calls['maxpool_folded'] == []
    assert torch.equal(calls['maxpool_folded_requant'][0], init)


# ---------------------------------------------------------------------------
# int8_matmul_requant_kblocked on a Hopper-core handle
# ---------------------------------------------------------------------------

def _operands(rng, m, k, n):
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    bias = rng.randint(-2 ** 16, 2 ** 16, n).astype(np.int32)
    mult = np_dyadic_multiplier(
        (rng.rand(n) * 2e-4 + 1e-5).astype(np.float32))
    mult[::3] = 0.5
    return x, w, bias, mult


# M, K, N and the Pallas kernel's blocks (they must divide the shape): K
# ragged against the Hopper core's 64- and 128-deep steps (1000: eight
# 128-deep steps over a padded 1024; 520: nine 64-deep steps over 576); K
# and N that are not multiples of 16, which the card zero-pads first
# (MobileNetV2's K = 24 and N = 24 among them); the FC's N = 1000
_KBLOCKED_SHAPES = [((64, 1000, 64), (64, 64, 200)),
                    ((37, 520, 48), (37, 48, 104)),
                    ((37, 45, 19), (37, 19, 45)),
                    ((16, 24, 24), (16, 24, 24)),
                    ((50, 130, 20), (50, 20, 65)),
                    ((8, 2048, 1000), (8, 200, 512)),
                    ((128, 256, 40), (64, 40, 128)),
                    ((3, 72, 10), (3, 10, 24))]


@pytest.mark.parametrize('shape,blocks', _KBLOCKED_SHAPES)
def test_kblocked_handle_matches_pallas_kernel_and_oracle(shape, blocks):
    """The wrapper over a handle walks the Hopper core's way (the padded K
    in one accumulator, one requant), over plain weights the plain version;
    both equal the Pallas K-blocked kernel and the oracle."""
    m, k, n = shape
    rng = np.random.RandomState(m + k + n)
    x, w, bias, mult = _operands(rng, m, k, n)
    x[0], w[:, 0] = -128, 127                     # |acc| past 2^24 at K 2048
    args = [jnp.asarray(a) for a in (x, w, bias, mult)]
    prepared = tkm.prepare_weights(_t(w))
    for out_bits, signed, relu in ((8, True, False), (4, False, True)):
        with pltpu.force_tpu_interpret_mode():
            kernel = np.asarray(jkm.int8_matmul_requant_kblocked(
                *args, out_bits=out_bits, signed=signed, relu=relu,
                block_m=blocks[0], block_n=blocks[1], block_k=blocks[2]))
        oracle = np.asarray(jkm.reference_matmul_requant(
            *args, out_bits=out_bits, signed=signed))
        if relu:
            oracle = np.maximum(oracle, 0)
        np.testing.assert_array_equal(kernel, oracle)
        for weights in (prepared, _t(w)):
            got = tkm.int8_matmul_requant_kblocked(
                _t(x), weights, _t(bias), _t(mult), out_bits=out_bits,
                signed=signed, relu=relu)
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), oracle)
