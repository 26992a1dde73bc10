"""The Hopper GEMM core's host side and plain walk on the CPU.

The four convs (``int8_conv_requant``, ``int4w_conv_requant``,
``int8_conv_acc``, ``int4w_conv_acc``) and the four matmuls
(``int8_matmul_requant``, ``int8_matmul_acc`` and their packed int4 forms)
run on the Hopper GEMM core on the card (csrc/gemm_s8_sm90.cuh).  What
surrounds that kernel is Python and is tested here: the K-major weight
layouts (``prepare_weights``, and ``prepare_weights_int4`` for weights that
stay nibble-packed), the conv's plan of pixel-rectangle tiles, the plain
versions of the kernel's own walk (``conv_acc_tiled_plain`` and its requant
``conv_requant_tiled_plain``, ``matmul_acc_kmajor_plain``,
``matmul_requant_kmajor_plain``) against the first plain versions and
against the JAX package's Pallas kernels in interpret mode (same numpy
inputs from a seed, tolerance 0), the alignment step that zero-pads what TMA
cannot read as it is (``sm90_operands``) and the walk on its padded
operands, the tile rules, and the engine's caches of prepared weights.
The kernel itself is held against these plain versions on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from hawq_tpu.configs.bit_config import get_bit_config as jax_bit_config
from hawq_tpu.inference import fold as jfold
from hawq_tpu.inference.engine import build_resnet_engine as jax_engine
from hawq_tpu.inference.synthetic import (
    synthetic_frozen_resnet as jax_synthetic_frozen_resnet)
from hawq_tpu.kernels import conv as jkc
from hawq_tpu.kernels import matmul as jkm
from hawq_tpu.quant import ops as jops

from hawq_tpu_torch.configs.bit_config import (RESNET_UNITS, get_bit_config)
from hawq_tpu_torch.inference.engine import build_resnet_engine
from hawq_tpu_torch.inference.synthetic import synthetic_frozen_resnet
from hawq_tpu_torch.kernels import conv as tkc
from hawq_tpu_torch.kernels import matmul as tkm
from hawq_tpu_torch.nn import layers as TL
from hawq_tpu_torch.quant.ops import (np_dyadic_multiplier,
                                      requant_add_int32, requant_clip_bounds,
                                      requant_int32, round_half_up)
from tests.test_torch_cuda import RESIDUAL_CASES, _residual_operands
from tests.test_torch_engine import _port_fm, _reference_nodes

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# (a) the K-major layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('taps,cin,n', [(1, 64, 16), (1, 45, 19), (9, 64, 64),
                                        (9, 5, 11), (4, 80, 24), (1, 2048, 8),
                                        (9, 128, 32), (1, 1, 1)])
def test_prepare_weights_layout_and_round_trip(taps, cin, n):
    rng = np.random.RandomState(taps + cin + n)
    w = rng.randint(-128, 128, (taps * cin, n)).astype(np.int8)
    p = tkm.prepare_weights(_t(w), taps)
    cpad = -(-cin // 64) * 64
    assert (p.taps, p.cin, p.cpad, p.n, p.k) == (taps, cin, cpad, n,
                                                 taps * cin)
    assert p.tile_k == (128 if cpad % 128 == 0 else 64)
    wt = p.wt.numpy()
    assert wt.shape == (n, taps * cpad) and wt.dtype == np.int8
    assert p.wt.is_contiguous()
    for t in range(taps):                  # per tap: w_flat.T, then zeros
        block = wt[:, t * cpad:(t + 1) * cpad]
        np.testing.assert_array_equal(block[:, :cin],
                                      w[t * cin:(t + 1) * cin].T)
        assert not block[:, cin:].any()
    np.testing.assert_array_equal(tkm.unprepare_weights(p).numpy(), w)


def test_prepare_weights_rejects_uneven_taps():
    with pytest.raises(ValueError):
        tkm.prepare_weights(torch.zeros((10, 4), dtype=torch.int8), 3)


def _w4(rng, shape):
    """int4 weights over the whole range, -8 and 7 included."""
    w = rng.randint(-8, 8, shape).astype(np.int8)
    w.reshape(-1)[:2] = (-8, 7)
    return w


@pytest.mark.parametrize('taps', [1, 3, 9])
@pytest.mark.parametrize('cin', [16, 64, 80, 128, 6])
def test_prepare_weights_int4_layout_and_round_trip(taps, cin):
    """The packed K-major handle: (N, taps·cpad/2) bytes; inside every
    tile_k-channel chunk byte i holds channel c0 + i (low nibble) and
    channel c0 + tile_k/2 + i (high nibble), zeros beyond C; back to
    ``pack_int4_conv``'s bytes."""
    n = 12
    rng = np.random.RandomState(taps + cin)
    w = _w4(rng, (taps * cin, n))
    packed = tkc.pack_int4_conv(w, taps)
    p = tkm.prepare_weights_int4(_t(packed), taps)
    cpad = -(-cin // 64) * 64
    bk = 128 if cpad % 128 == 0 else 64
    assert (p.taps, p.cin, p.cpad, p.n, p.k, p.int4, p.tile_k) == (
        taps, cin, cpad, n, taps * cin, True, bk)
    assert p.row_bytes == taps * cpad // 2
    wt = p.wt.numpy()
    assert wt.shape == (n, taps * cpad // 2) and wt.dtype == np.int8
    assert p.wt.is_contiguous()
    wpad = np.zeros((taps, cpad, n), np.int8)
    wpad[:, :cin] = w.reshape(taps, cin, n)
    lo = (wt.astype(np.int16) & 0xF ^ 8) - 8
    hi = ((wt.astype(np.int16) >> 4) & 0xF ^ 8) - 8
    for t in range(taps):
        for c0 in range(0, cpad, bk):
            cols = slice((t * cpad + c0) // 2, (t * cpad + c0 + bk) // 2)
            np.testing.assert_array_equal(lo[:, cols],
                                          wpad[t, c0:c0 + bk // 2].T)
            np.testing.assert_array_equal(hi[:, cols],
                                          wpad[t, c0 + bk // 2:c0 + bk].T)
    # what the kernel's unpack rebuilds is the int8 handle of the same weights
    np.testing.assert_array_equal(
        p.kmajor_int8().numpy(), tkm.prepare_weights(_t(w), taps).wt.numpy())
    np.testing.assert_array_equal(tkm.unprepare_weights(p).numpy(), packed)


@pytest.mark.parametrize('k', [48, 64, 80, 256])
@pytest.mark.parametrize('n', [16, 19, 64])
def test_prepare_weights_int4_of_pack_int4_bytes(k, n):
    """A matmul's handle, built from the engine's ``pack_int4`` bytes (whose
    split-K order is not the handle's: every tile_k-channel chunk is split
    into its low and high nibbles), unpacks to ``unpack_int4``'s matrix,
    K-major and zero-padded, and gives the same bytes back."""
    rng = np.random.RandomState(k + n)
    w = _w4(rng, (k, n))
    packed = tkm.pack_int4(w)
    p = tkm.prepare_weights_int4(_t(packed))
    cpad = -(-k // 64) * 64
    assert (p.taps, p.cin, p.cpad, p.n, p.int4) == (1, k, cpad, n, True)
    assert p.wt.shape == (n, cpad // 2) and p.row_bytes == cpad // 2
    unpacked = tkm.unpack_int4(_t(packed))
    np.testing.assert_array_equal(unpacked.numpy(), w)
    kmajor = p.kmajor_int8().numpy()
    np.testing.assert_array_equal(kmajor[:, :k], unpacked.numpy().T)
    assert not kmajor[:, k:].any()
    np.testing.assert_array_equal(tkm.unprepare_weights(p).numpy(), packed)


@pytest.mark.parametrize('int4', [False, True])
@pytest.mark.parametrize('taps,cin,pad,rows', [
    ((4, 4), 16, (0, 0), 4), ((3, 3), 48, (0, 0), 3), ((3, 3), 16, (1, 0), 3),
    ((3, 3), 16, (1, 1), 1), ((3, 3), 64, (0, 0), 1), ((1, 1), 16, (0, 0), 1),
    ((2, 2), 80, (0, 0), 2), ((3, 3), 24, (0, 0), 1)])
def test_prepare_conv_weights_reads_a_kernel_row_as_one_tap(taps, cin, pad,
                                                            rows, int4):
    """Where C is not a multiple of 64 but of 16 and no border is left to
    TMA along x, a kernel row of kw taps is one tap of kw·C channels: the
    handle is that of the (kh, kw·C, N) weights, K padded to 64 once a row;
    it round-trips to the flat weights (per-tap packed bytes for int4).  A
    C off 16 (24) reads a tap at a time: TMA's pixels of a row must lie 16
    bytes apart."""
    kh, kw = taps
    n = 12
    rng = np.random.RandomState(kh + cin + n)
    w = _w4(rng, (kh * kw * cin, n))
    flat = _t(tkc.pack_int4_conv(w, kh * kw)) if int4 else _t(w)
    assert tkc.sm90_row_taps(taps, cin, pad) == rows
    p = tkc.prepare_conv_weights(flat, taps, cin, pad, int4)
    row_cin = rows * cin
    assert (p.taps, p.cin, p.row_taps, p.k, p.int4) == (
        kh * kw // rows, row_cin, rows, kh * kw * cin, int4)
    assert p.cpad == -(-row_cin // 64) * 64
    # the int8 K-major layout is that of the weights seen as (kh·kw/rows)
    # taps of rows·C channels
    np.testing.assert_array_equal(
        p.kmajor_int8().numpy(),
        tkm.prepare_weights(_t(w), kh * kw // rows).wt.numpy())
    np.testing.assert_array_equal(tkm.unprepare_weights(p).numpy(),
                                  flat.numpy())
    p.check(kh * kw, cin, 'int4w_conv_acc' if int4 else 'int8_conv_acc')


def test_prepare_weights_int4_rejects_uneven_taps():
    with pytest.raises(ValueError):
        tkm.prepare_weights_int4(torch.zeros((10, 4), dtype=torch.int8), 3)


# ---------------------------------------------------------------------------
# (b) the conv tile plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('size', [56, 28, 14, 7, 5, 1])
@pytest.mark.parametrize('batch', [1, 3])
def test_conv_tile_plan_covers_every_pixel_once(size, batch):
    th, tw = tkc.conv_tile_plan(size, size)
    assert th * tw == tkm.SM90_TILE_M
    ty, tx = -(-size // th), -(-size // tw)
    hits = np.zeros((batch, size, size), np.int64)
    for tile in range(batch * ty * tx):     # the kernel's blockIdx.x walk
        b, r = divmod(tile, ty * tx)
        oy0, ox0 = (r // tx) * th, (r % tx) * tw
        for row in range(tkm.SM90_TILE_M):
            oy, ox = oy0 + row // tw, ox0 + row % tw
            if oy < size and ox < size:     # the store drops the others
                hits[b, oy, ox] += 1
    assert (hits == 1).all()
    # the plan of the ResNet stages, as the kernel source states it
    assert (th, tw) == {28: (4, 16)}.get(size, (8, 8))


def test_conv_tile_plan_of_a_wide_image_is_wide():
    assert tkc.conv_tile_plan(2, 64) == (2, 32)
    assert tkc.conv_tile_plan(64, 1) == (64, 1)


# ---------------------------------------------------------------------------
# (c) the plain versions of the kernel's walk
# ---------------------------------------------------------------------------

def _vectors(rng, n, half):
    bias = rng.randint(-2 ** 14, 2 ** 14, n).astype(np.int32)
    mult = np_dyadic_multiplier((rng.rand(n) * 2e-3 + 1e-4).astype(np.float32))
    if half:          # odd accumulators land exactly on a .5 boundary
        mult[::2] = 0.5
    return bias, mult


# (B, H, W, C), N, taps, case: block_n of the Pallas call divides N
_WALK_CONVS = [((2, 9, 7, 16), 16, (3, 3), 'random'),
               ((1, 14, 14, 8), 8, (3, 3), 'random'),
               ((3, 5, 5, 64), 32, (2, 2), 'random'),
               ((1, 28, 6, 5), 8, (3, 3), 'random'),
               ((2, 7, 7, 80), 16, (1, 1), 'random'),
               ((1, 8, 8, 128), 8, (3, 3), 'saturated'),
               ((2, 6, 6, 16), 16, (3, 3), 'half')]


@pytest.mark.parametrize('shape,n,taps,case', _WALK_CONVS)
def test_conv_tiled_plain_matches_plain_and_pallas(shape, n, taps, case):
    rng = np.random.RandomState(sum(shape) + n)
    b, h, w, c = shape
    kh, kw = taps
    xp = rng.randint(-128, 128, (b, h + kh - 1, (w + kw - 1) * c)).astype(
        np.int8)
    wf = rng.randint(-127, 128, (kh * kw * c, n)).astype(np.int8)
    if case == 'saturated':                 # |acc| = 9·128·128·127 > 2**24
        xp[:] = -128
        wf[:, 0], wf[:, 1] = 127, -127
    if case == 'half':                      # small sums, so .5 is not clipped
        xp = rng.randint(-3, 4, xp.shape).astype(np.int8)
        wf = rng.randint(-3, 4, wf.shape).astype(np.int8)
    bias, mult = _vectors(rng, n, half=case == 'half')
    geo = dict(taps=taps, out_hw=(h, w), cin=c)
    prepared = tkm.prepare_weights(_t(wf), kh * kw)
    rows = tkc.prepare_conv_weights(_t(wf), taps, c)
    for out_bits, signed, relu in [(8, True, False), (8, True, True),
                                   (4, False, True)]:
        epi = dict(out_bits=out_bits, signed=signed, relu=relu)
        lo, hi = tkm.epilogue_bounds(out_bits, signed, relu)
        plain = tkc.conv_requant_plain(_t(xp), _t(wf), _t(bias), _t(mult),
                                       lo=lo, hi=hi, **geo).numpy()
        tiled = tkc.conv_requant_tiled_plain(_t(xp), prepared, _t(bias),
                                             _t(mult), lo=lo, hi=hi,
                                             **geo).numpy()
        np.testing.assert_array_equal(tkc.conv_requant_tiled_plain(
            _t(xp), rows, _t(bias), _t(mult), lo=lo, hi=hi, **geo).numpy(),
            tiled, err_msg=str(epi))
        # the wrapper takes the walk's plain version for a prepared handle
        wrapped = tkc.int8_conv_requant(_t(xp), prepared, _t(bias), _t(mult),
                                        **geo, **epi).numpy()
        with pltpu.force_tpu_interpret_mode():
            pallas = np.asarray(jkc.int8_conv_requant(
                jnp.asarray(xp), jnp.asarray(wf), jnp.asarray(bias),
                jnp.asarray(mult), **geo, **epi))
        assert tiled.dtype == np.int8 and tiled.shape == (b, h * w, n)
        np.testing.assert_array_equal(tiled, plain, err_msg=str(epi))
        np.testing.assert_array_equal(wrapped, plain, err_msg=str(epi))
        np.testing.assert_array_equal(tiled, pallas, err_msg=str(epi))
    if case == 'half':                      # the boundary really was hit
        acc = tkc.conv_acc_plain(_t(xp), _t(wf), _t(bias), **geo).numpy()
        assert (acc[..., ::2] % 2 != 0).any()


@pytest.mark.parametrize('shape,n,taps,pad', [
    ((2, 9, 7, 16), 8, (3, 3), (1, 1)), ((1, 5, 6, 8), 4, (3, 3), (0, 1)),
    ((1, 6, 5, 8), 4, (5, 5), (2, 2)), ((2, 4, 4, 16), 16, (3, 3), (1, 0))])
def test_conv_pad_argument_equals_the_padded_slab(shape, n, taps, pad):
    """With ``pad`` the wrapper takes the activations without their zero
    border (the Hopper core leaves the border to TMA; here, on the CPU, the
    wrapper pads): the result is that of the slab call."""
    rng = np.random.RandomState(sum(shape) + n)
    b, h, w, c = shape
    kh, kw = taps
    x = _t(rng.randint(-128, 128, (b, h + kh - 1 - 2 * pad[0],
                                   (w + kw - 1 - 2 * pad[1]) * c)).astype(
                                       np.int8))
    wf = _t(rng.randint(-127, 128, (kh * kw * c, n)).astype(np.int8))
    bias, mult = (_t(a) for a in _vectors(rng, n, half=False))
    geo = dict(taps=taps, out_hw=(h, w), cin=c)
    x4 = x.reshape(b, x.shape[1], -1, c)
    xp = tkc.prepare_conv_input(x4, pad)
    np.testing.assert_array_equal(
        tkc.pad_conv_input(x, pad, **geo).numpy(), xp.numpy())
    want = tkc.int8_conv_requant(xp, wf, bias, mult, relu=True, **geo)
    for weights in (wf, tkm.prepare_weights(wf, kh * kw)):
        got = tkc.int8_conv_requant(x, weights, bias, mult, relu=True,
                                    pad=pad, **geo)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError):
        tkc.int8_conv_requant(xp, wf, bias, mult, pad=pad, **geo)


_WALK_MATMULS = [(37, 45, 19, 'random'), (64, 64, 64, 'random'),
                 (130, 80, 72, 'random'), (8, 2048, 24, 'saturated'),
                 (1, 16, 4, 'random'), (65, 192, 128, 'random')]


@pytest.mark.parametrize('m,k,n,case', _WALK_MATMULS)
def test_matmul_kmajor_plain_matches_plain_and_pallas(m, k, n, case):
    rng = np.random.RandomState(m + k + n)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    if case == 'saturated':                 # |acc| = 2048·128·127 > 2**24
        x[0, :] = -128
        w[:, 0], w[:, 1] = 127, -127
    bias = rng.randint(-2 ** 14, 2 ** 14, n).astype(np.int32)
    prepared = tkm.prepare_weights(_t(w))
    plain = tkm.matmul_acc_plain(_t(x), _t(w), _t(bias)).numpy()
    kmajor = tkm.matmul_acc_kmajor_plain(_t(x), prepared, _t(bias)).numpy()
    wrapped = tkm.int8_matmul_acc(_t(x), prepared, _t(bias)).numpy()
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jkm.int8_matmul_acc(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias)))
    assert kmajor.dtype == np.int32 and kmajor.shape == (m, n)
    np.testing.assert_array_equal(kmajor, plain)
    np.testing.assert_array_equal(wrapped, plain)
    np.testing.assert_array_equal(kmajor, pallas)
    if case == 'saturated':
        assert abs(int(kmajor[0, 0])) > 2 ** 24


# (B, H, W, C), N, taps, pad, case: C even; block_n of the Pallas call
# divides N
_WALK_CONVS_INT4 = [((2, 9, 7, 16), 16, (3, 3), (1, 1), 'random'),
                    ((1, 14, 14, 8), 8, (3, 3), (0, 0), 'random'),
                    ((3, 5, 5, 64), 32, (2, 2), (0, 0), 'random'),
                    ((1, 28, 6, 6), 8, (3, 3), (1, 0), 'random'),
                    ((2, 7, 7, 80), 16, (1, 1), (0, 0), 'random'),
                    ((1, 8, 8, 128), 8, (3, 3), (1, 1), 'saturated'),
                    ((2, 6, 6, 16), 16, (3, 3), (0, 1), 'half')]


@pytest.mark.parametrize('shape,n,taps,pad,case', _WALK_CONVS_INT4)
def test_int4w_conv_tiled_plain_matches_plain_and_pallas(shape, n, taps, pad,
                                                         case):
    """``int4w_conv_requant`` with the packed handle (the Hopper core's
    walk, its nibbles unpacked chunk by chunk) == with ``pack_int4_conv``'s
    bytes == the Pallas kernel on those bytes; with ``pad`` the wrapper is
    handed the activations without their zero border."""
    rng = np.random.RandomState(sum(shape) + n)
    b, h, w, c = shape
    kh, kw = taps
    x = rng.randint(-128, 128, (b, h + kh - 1 - 2 * pad[0],
                                (w + kw - 1 - 2 * pad[1]) * c)).astype(np.int8)
    wf = _w4(rng, (kh * kw * c, n))
    if case == 'saturated':                 # |acc| = 9·128·128·8 > 2**20
        x[:] = -128
        wf[:, 0], wf[:, 1] = 7, -8
    if case == 'half':                      # small sums, so .5 is not clipped
        x = rng.randint(-3, 4, x.shape).astype(np.int8)
        wf = rng.randint(-3, 4, wf.shape).astype(np.int8)
    bias, mult = _vectors(rng, n, half=case == 'half')
    geo = dict(taps=taps, out_hw=(h, w), cin=c)
    wp = tkc.pack_int4_conv(wf, kh * kw)
    prepared = tkm.prepare_weights_int4(_t(wp), kh * kw)
    xp = tkc.pad_conv_input(_t(x), pad, **geo) if pad != (0, 0) else _t(x)
    for out_bits, signed, relu in [(8, True, False), (8, True, True),
                                   (4, False, True)]:
        epi = dict(out_bits=out_bits, signed=signed, relu=relu)
        lo, hi = tkm.epilogue_bounds(out_bits, signed, relu)
        plain = tkc.conv_requant_plain(xp, _t(wf), _t(bias), _t(mult),
                                       lo=lo, hi=hi, **geo).numpy()
        tiled = tkc.conv_requant_tiled_plain(xp, prepared, _t(bias),
                                             _t(mult), lo=lo, hi=hi,
                                             **geo).numpy()
        wrapped = [tkc.int4w_conv_requant(_t(x), wts, _t(bias), _t(mult),
                                          pad=pad, **geo, **epi).numpy()
                   for wts in (prepared, _t(wp))]
        with pltpu.force_tpu_interpret_mode():
            pallas = np.asarray(jkc.int4w_conv_requant(
                jnp.asarray(xp.numpy()), jnp.asarray(wp), jnp.asarray(bias),
                jnp.asarray(mult), **geo, **epi))
        assert tiled.dtype == np.int8 and tiled.shape == (b, h * w, n)
        np.testing.assert_array_equal(tiled, plain, err_msg=str(epi))
        for got in wrapped:
            np.testing.assert_array_equal(got, plain, err_msg=str(epi))
        np.testing.assert_array_equal(tiled, pallas, err_msg=str(epi))
    if case == 'half':                      # the boundary really was hit
        acc = tkc.conv_acc_plain(xp, _t(wf), _t(bias), **geo).numpy()
        assert (acc[..., ::2] % 2 != 0).any()


# (B, H, W, C), N, taps, pad, case of the accumulator walk: ragged N (N % 4
# only) with the border left to TMA, the folded init (C = 48, N = 256), the
# channel-padded RGB init's 4×4-tap space-to-depth rewrite (C = 16), a 2×2-tap
# stride-2 rewrite, and saturated operands whose sums pass 2**24 (for the
# int4 weights at C = 2048)
_WALK_CONVS_ACC = [((2, 9, 7, 16), 20, (3, 3), (1, 1), 'random'),
                   ((1, 8, 8, 48), 256, (3, 3), (0, 0), 'random'),
                   ((2, 10, 10, 16), 64, (4, 4), (0, 0), 'random'),
                   ((3, 5, 5, 64), 32, (2, 2), (0, 0), 'random'),
                   ((1, 8, 8, 128), 8, (3, 3), (1, 1), 'saturated'),
                   ((1, 3, 3, 2048), 8, (3, 3), (1, 1), 'saturated')]


@pytest.mark.parametrize('int4', [False, True])
@pytest.mark.parametrize('shape,n,taps,pad,case', _WALK_CONVS_ACC)
def test_conv_acc_tiled_plain_matches_plain_and_pallas(shape, n, taps, pad,
                                                       case, int4):
    """``int8_conv_acc`` / ``int4w_conv_acc`` with the handle (the Hopper
    core's walk, packed nibbles unpacked chunk by chunk) == with the flat
    (or ``pack_int4_conv``) weights == ``conv_acc_plain`` == the Pallas
    kernel; with ``pad`` the wrappers are handed the activations without
    their zero border."""
    rng = np.random.RandomState(sum(shape) + n + int4)
    b, h, w, c = shape
    kh, kw = taps
    x = rng.randint(-128, 128, (b, h + kh - 1 - 2 * pad[0],
                                (w + kw - 1 - 2 * pad[1]) * c)).astype(np.int8)
    wf = (_w4(rng, (kh * kw * c, n)) if int4 else
          rng.randint(-127, 128, (kh * kw * c, n)).astype(np.int8))
    if case == 'saturated':
        x[:] = -128
        wf[:, 0], wf[:, 1] = (7, -8) if int4 else (127, -127)
    bias = rng.randint(-2 ** 14, 2 ** 14, n).astype(np.int32)
    geo = dict(taps=taps, out_hw=(h, w), cin=c)
    xp = tkc.pad_conv_input(_t(x), pad, **geo)
    if int4:
        weights = _t(tkc.pack_int4_conv(wf, kh * kw))
        prepared = tkm.prepare_weights_int4(weights, kh * kw)
        fn, jfn = tkc.int4w_conv_acc, jkc.int4w_conv_acc
    else:
        weights = _t(wf)
        prepared = tkm.prepare_weights(weights, kh * kw)
        fn, jfn = tkc.int8_conv_acc, jkc.int8_conv_acc
    # the handle the wrapper itself lays out: a kernel row read as one tap
    # where the call allows (the two init convs)
    rows = tkc.prepare_conv_weights(weights, taps, c, pad, int4)
    assert rows.row_taps == (kw if c % 64 and pad == (0, 0) else 1)
    plain = tkc.conv_acc_plain(xp, _t(wf), _t(bias), **geo).numpy()
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jfn(jnp.asarray(xp.numpy()),
                                jnp.asarray(weights.numpy()),
                                jnp.asarray(bias), **geo))
    np.testing.assert_array_equal(plain, pallas)
    for handle in (prepared, rows):
        tiled = tkc.conv_acc_tiled_plain(xp, handle, _t(bias), **geo).numpy()
        assert tiled.dtype == np.int32 and tiled.shape == (b, h * w, n)
        np.testing.assert_array_equal(tiled, plain)
    for wts in (prepared, rows, weights):
        np.testing.assert_array_equal(
            fn(_t(x), wts, _t(bias), pad=pad, **geo).numpy(), plain)
    if case == 'saturated' and (not int4 or c == 2048):
        assert np.abs(plain - bias).max() > 2 ** 24


_WALK_REQUANT_MATMULS = [(37, 48, 16, 'random'), (64, 64, 64, 'random'),
                         (130, 80, 80, 'random'), (8, 2048, 32, 'saturated'),
                         (256, 192, 48, 'random'), (65, 32, 16, 'half'),
                         (1, 16, 16, 'random'), (37, 45, 19, 'random')]


@pytest.mark.parametrize('m,k,n,case', _WALK_REQUANT_MATMULS)
def test_matmul_requant_kmajor_plain_matches_plain_and_pallas(m, k, n, case):
    rng = np.random.RandomState(m + k + n)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    if case == 'saturated':                 # |acc| = 2048·128·127 > 2**24
        x[0, :] = -128
        w[:, 0], w[:, 1] = 127, -127
    if case == 'half':
        x = rng.randint(-3, 4, x.shape).astype(np.int8)
        w = rng.randint(-3, 4, w.shape).astype(np.int8)
    bias, mult = _vectors(rng, n, half=case == 'half')
    prepared = tkm.prepare_weights(_t(w))
    for out_bits, signed, relu in [(8, True, False), (8, True, True),
                                   (4, False, True)]:
        epi = dict(out_bits=out_bits, signed=signed, relu=relu)
        lo, hi = tkm.epilogue_bounds(out_bits, signed, relu)
        plain = tkm.matmul_requant_plain(_t(x), _t(w), _t(bias), _t(mult),
                                         lo, hi).numpy()
        kmajor = tkm.matmul_requant_kmajor_plain(_t(x), prepared, _t(bias),
                                                 _t(mult), lo, hi).numpy()
        wrapped = tkm.int8_matmul_requant(_t(x), prepared, _t(bias),
                                          _t(mult), **epi).numpy()
        with pltpu.force_tpu_interpret_mode():
            pallas = np.asarray(jkm.int8_matmul_requant(
                jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                jnp.asarray(mult), **epi))
        assert kmajor.dtype == np.int8 and kmajor.shape == (m, n)
        np.testing.assert_array_equal(kmajor, plain, err_msg=str(epi))
        np.testing.assert_array_equal(wrapped, plain, err_msg=str(epi))
        np.testing.assert_array_equal(kmajor, pallas, err_msg=str(epi))
    acc = tkm.matmul_acc_plain(_t(x), _t(w), _t(bias)).numpy()
    if case == 'saturated':
        assert abs(int(acc[0, 0] - bias[0])) > 2 ** 24
    if case == 'half':
        assert (acc[..., ::2] % 2 != 0).any()


# M, K, N, case of the packed matmuls: M off the 64-row tile, K below and
# between the paddings, M = 1, sums beyond 2**24 (K = 16448 at |x·w| = 1024),
# requant inputs on a .5 boundary; the Pallas grid is M // min(256, M), so
# M = 300 is held against the plain version alone
_WALK_INT4_MATMULS = [(37, 48, 16, 'random'), (64, 64, 64, 'random'),
                      (256, 80, 48, 'random'), (8, 16448, 16, 'saturated'),
                      (65, 32, 16, 'half'), (1, 16, 16, 'random'),
                      (130, 256, 19, 'random'), (512, 128, 32, 'random'),
                      (300, 64, 32, 'random')]


@pytest.mark.parametrize('m,k,n,case', _WALK_INT4_MATMULS)
def test_int4w_matmul_kmajor_plain_matches_plain_and_pallas(m, k, n, case):
    """``int4w_matmul_requant`` / ``int4w_matmul_acc`` with the packed handle
    (the Hopper core's walk, its nibbles unpacked chunk by chunk) == with
    ``pack_int4``'s bytes == the plain version on the unpacked weights ==
    the Pallas kernels on those bytes, in all three epilogues."""
    rng = np.random.RandomState(m + k + n)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = _w4(rng, (k, n))
    if case == 'saturated':
        x[0, :] = -128
        w[:, 0], w[:, 1] = -8, 7
    if case == 'half':
        x = rng.randint(-3, 4, x.shape).astype(np.int8)
        w = rng.randint(-3, 4, w.shape).astype(np.int8)
    bias, mult = _vectors(rng, n, half=case == 'half')
    wp = tkm.pack_int4(w)
    prepared = tkm.prepare_weights_int4(_t(wp))
    pallas_ok = m <= 256 or m % 256 == 0
    jx, jw, jb, jm = map(jnp.asarray, (x, wp, bias, mult))
    for out_bits, signed, relu in [(8, True, False), (8, True, True),
                                   (4, False, True)]:
        epi = dict(out_bits=out_bits, signed=signed, relu=relu)
        lo, hi = tkm.epilogue_bounds(out_bits, signed, relu)
        plain = tkm.matmul_requant_plain(_t(x), _t(w), _t(bias), _t(mult),
                                         lo, hi).numpy()
        kmajor = tkm.matmul_requant_kmajor_plain(
            _t(x), prepared, _t(bias), _t(mult), lo, hi,
            'int4w_matmul_requant').numpy()
        assert kmajor.dtype == np.int8 and kmajor.shape == (m, n)
        np.testing.assert_array_equal(kmajor, plain, err_msg=str(epi))
        for wts in (prepared, _t(wp)):
            np.testing.assert_array_equal(tkm.int4w_matmul_requant(
                _t(x), wts, _t(bias), _t(mult), **epi).numpy(), plain,
                err_msg=str(epi))
        if pallas_ok:
            with pltpu.force_tpu_interpret_mode():
                pallas = np.asarray(jkm.int4w_matmul_requant(jx, jw, jb, jm,
                                                             **epi))
            np.testing.assert_array_equal(kmajor, pallas, err_msg=str(epi))
    acc = tkm.matmul_acc_plain(_t(x), _t(w), _t(bias)).numpy()
    kmajor = tkm.matmul_acc_kmajor_plain(_t(x), prepared, _t(bias),
                                         'int4w_matmul_acc').numpy()
    assert kmajor.dtype == np.int32
    np.testing.assert_array_equal(kmajor, acc)
    for wts in (prepared, _t(wp)):
        np.testing.assert_array_equal(
            tkm.int4w_matmul_acc(_t(x), wts, _t(bias)).numpy(), acc)
    if pallas_ok:
        with pltpu.force_tpu_interpret_mode():
            pallas = np.asarray(jkm.int4w_matmul_acc(jx, jw, jb))
        np.testing.assert_array_equal(kmajor, pallas)
    if case == 'saturated':
        assert np.abs(acc - bias).max() > 2 ** 24
    if case == 'half':
        assert (acc[..., ::2] % 2 != 0).any()


@pytest.mark.parametrize('requant', [False, True])
def test_matmuls_refuse_a_handle_of_the_other_weight_width(requant):
    """An int8 handle is refused by the ``int4w_*`` matmuls, a packed one by
    the ``int8_*`` matmuls, on either walk."""
    x = torch.zeros((4, 64), dtype=torch.int8)
    bias, mult = torch.zeros(16, dtype=torch.int32), torch.ones(16)
    p8 = tkm.prepare_weights(torch.zeros((64, 16), dtype=torch.int8))
    p4 = tkm.prepare_weights_int4(torch.zeros((32, 16), dtype=torch.int8))
    epi = (mult,) if requant else ()
    int8_fn = tkm.int8_matmul_requant if requant else tkm.int8_matmul_acc
    int4_fn = tkm.int4w_matmul_requant if requant else tkm.int4w_matmul_acc
    int8_fn(x, p8, bias, *epi)
    int4_fn(x, p4, bias, *epi)
    with pytest.raises(ValueError, match='int4w.*int8 weights'):
        int4_fn(x, p8, bias, *epi)
    with pytest.raises(ValueError, match='int8.*packed int4'):
        int8_fn(x, p4, bias, *epi)
    name = 'int4w_matmul_requant' if requant else 'int4w_matmul_acc'
    with pytest.raises(ValueError):
        tkm.matmul_acc_kmajor_plain(x, p8, bias, name)
    with pytest.raises(ValueError):
        tkm.matmul_requant_kmajor_plain(x, p4, bias, mult, -128, 127)


def test_wrappers_reject_a_handle_of_another_shape():
    """A handle prepared for other taps or another K is refused, not
    zero-filled up to its padded K."""
    bias = torch.zeros(8, dtype=torch.int32)
    p = tkm.prepare_weights(torch.zeros((64, 8), dtype=torch.int8))
    with pytest.raises(ValueError):
        tkm.int8_matmul_acc(torch.zeros((4, 32), dtype=torch.int8), p, bias)
    xp = torch.zeros((1, 4, 4 * 16), dtype=torch.int8)
    mult = torch.ones(8)
    geo = dict(taps=(2, 2), out_hw=(3, 3), cin=16)
    tkc.int8_conv_requant(xp, tkm.prepare_weights(p.wt.t().contiguous(), 4),
                          bias, mult, **geo)
    with pytest.raises(ValueError):
        tkc.int8_conv_requant(xp, p, bias, mult, **geo)
    with pytest.raises(ValueError):
        tkm.int8_matmul_requant(torch.zeros((4, 32), dtype=torch.int8), p,
                                bias, mult)
    # a handle that reads a kernel row as one tap needs the whole row in the
    # slab: no border left to TMA along x
    w16 = torch.zeros((9 * 16, 8), dtype=torch.int8)
    rows = tkc.prepare_conv_weights(w16, (3, 3), 16)
    assert rows.row_taps == 3
    geo3 = dict(taps=(3, 3), out_hw=(4, 4), cin=16)
    tkc.int8_conv_acc(torch.zeros((1, 6, 6 * 16), dtype=torch.int8), rows,
                      bias, **geo3)
    with pytest.raises(ValueError):
        tkc.int8_conv_acc(torch.zeros((1, 4, 4 * 16), dtype=torch.int8), rows,
                          bias, pad=(1, 1), **geo3)
    # and pixels of whole 16 bytes: a row handle of C = 5 has no view at the
    # width the alignment step pads the slab to
    rows5 = tkm.prepare_weights(torch.zeros((9 * 5, 8), dtype=torch.int8), 9,
                                row_taps=3)
    with pytest.raises(ValueError, match='C % 16'):
        tkm.sm90_operands(torch.zeros((1, 6, 6 * 5), dtype=torch.int8), rows5,
                          (bias,), 1)
    # packed weights only through the int4w kernel, int8 ones only through
    # the int8 kernels
    p4 = tkm.prepare_weights_int4(torch.zeros((4 * 8, 8), dtype=torch.int8), 4)
    tkc.int4w_conv_requant(xp, p4, bias, mult, **geo)
    with pytest.raises(ValueError):
        tkc.int8_conv_requant(xp, p4, bias, mult, **geo)
    with pytest.raises(ValueError):
        tkc.int4w_conv_requant(
            xp, tkm.prepare_weights(torch.zeros((64, 8), dtype=torch.int8),
                                    4), bias, mult, **geo)


# ---------------------------------------------------------------------------
# (d) the alignment step and the tile width
# ---------------------------------------------------------------------------

def _resnet50_gemm_shapes(batch, size=224):
    """(kind, M or pixels, K or C, N) of every ``int8_matmul_requant``
    (kind 'matmul_requant'), ``int8_conv_requant``, ``int8_conv_acc``
    (kind 'conv_acc': the folded init) and ``int8_matmul_acc`` call of a
    ResNet-50 uniform8 engine forward (the 'conv' entries are also the
    ``int4w_conv_requant`` calls of the uniform4 engine), and of every
    ``int8_matmul_acc`` (all 1×1 convs and the FC) and ``int8_conv_acc``
    call (the channel-padded 7×7/s2 init's 4×4-tap rewrite, C = 16, and
    the 3×3 convs) of a QAT forward, at ``batch`` × ``size``²."""
    hw = size // 4
    engine = [('conv_acc', batch * hw * hw, 48, 256)]
    train = [('conv_acc', batch * 4 * hw * hw, 16, 64)]
    cin = 64
    for stage, units in enumerate(RESNET_UNITS['resnet50']):
        mid, out = 64 * 2 ** stage, 256 * 2 ** stage
        for unit in range(units):
            stride = 2 if (unit == 0 and stage > 0) else 1
            hw_out = hw // stride
            m_in, m_out = batch * hw * hw, batch * hw_out * hw_out
            train.append(('matmul', m_out, cin, mid))            # conv1
            engine.append(('matmul_requant', m_out, cin, mid))
            # conv2: 3×3 stride 1, or its 2×2-tap space-to-depth rewrite
            engine.append(('conv', m_out, mid * stride * stride, mid))
            train.append(('conv_acc', m_out, mid, mid))     # 3×3, stride 1
            engine.append(('matmul', m_out, mid, out))           # conv3
            train.append(('matmul', m_out, mid, out))
            if unit == 0:                                        # identity
                engine.append(('matmul', m_out, cin, out))
                train.append(('matmul', m_out, cin, out))
            cin, hw = out, hw_out
            del m_in
    engine.append(('matmul', batch, 2048, 1000))
    train.append(('matmul', batch, 2048, 1000))
    return engine, train


_ENGINE_SHAPES, _ = _resnet50_gemm_shapes(8)
_, _TRAIN_SHAPES = _resnet50_gemm_shapes(32)


# bytes of an output element of each kind of call: the requant forms write
# int8, the accumulator forms int32
_OUT_BYTES = {'matmul': 4, 'matmul_requant': 1, 'conv': 1, 'conv_acc': 4}


def _at(a, ptr: int) -> torch.Tensor:
    """``a`` as a contiguous tensor whose data pointer lies ``ptr`` % 16
    bytes past a 16-byte boundary."""
    t = _t(a)
    size, off = t.numel() * t.element_size(), ptr % 16
    buf = torch.zeros(size + 32, dtype=torch.uint8)
    start = -buf.data_ptr() % 16 + off
    out = buf[start:start + size].view(t.dtype).view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == off
    return out


def _step(kind, k, n, ptr=0):
    """The alignment step on the operands of a ``kind`` call with K (a
    matmul) or C (a 3×3 conv over a slab of 3 pixels a row) of ``k``, N of
    ``n``, x at ``ptr`` → (x, handle, vectors, the step's result)."""
    conv = kind.startswith('conv')
    taps, cpad = (9 if conv else 1), -(-k // 64) * 64
    prepared = tkm.PreparedWeights(
        torch.zeros((n, taps * cpad), dtype=torch.int8), taps, k, cpad)
    x = _at(np.arange(2 * (3 if conv else 1) * k).astype(np.int8).reshape(
        2, -1), ptr)
    vectors = (torch.arange(n, dtype=torch.int32), torch.ones(n))
    return x, prepared, vectors, tkm.sm90_operands(x, prepared, vectors,
                                                   _OUT_BYTES[kind])


def _needs_no_padding(kind, k, n):
    x, prepared, vectors, (x2, p2, v2, _) = _step(kind, k, n)
    assert x2 is x and p2 is prepared and v2 is vectors


@pytest.mark.parametrize('kind,m,k,n', sorted(set(_ENGINE_SHAPES)))
def test_rule_takes_every_engine_shape_of_resnet50_b8(kind, m, k, n):
    _needs_no_padding(kind, k, n)
    assert tkm.sm90_tile_n(-(-m // 64), n, -(-k // 128), 132) in \
        tkm.SM90_TILE_NS


@pytest.mark.parametrize('kind,m,k,n', sorted(set(_TRAIN_SHAPES)))
def test_rule_takes_every_train_shape_of_resnet50_b32(kind, m, k, n):
    _needs_no_padding(kind, k, n)


# the int4w_matmul_requant ('matmul_requant') and int4w_matmul_acc
# ('matmul') calls of a ResNet-50 uniform4 forward at batch 8: every unit 1×1
# conv (the FC keeps int8 weights)
_INT4W_MATMUL_SHAPES = [s for s in _ENGINE_SHAPES
                        if s[0] in ('matmul', 'matmul_requant')
                        and s[1:] != (8, 2048, 1000)]


@pytest.mark.parametrize('kind,m,k,n', sorted(set(_INT4W_MATMUL_SHAPES)))
def test_rule_takes_every_int4w_matmul_shape_of_resnet50_b8(kind, m, k, n):
    _needs_no_padding(kind, k, n)
    k_tiles = -(-k // (128 if k % 128 == 0 else 64))
    assert tkm.sm90_tile_n(-(-m // 64), n, k_tiles, 132,
                           tkm.SM90_INT4_MATMUL_WIDEST) in tkm.SM90_TILE_NS
    assert tkm.sm90_tile_m(m, n, k_tiles, 132) in (64, 128)


def test_resnet50_shape_lists_have_the_launch_counts():
    assert sum(s[0] == 'matmul_requant' for s in _INT4W_MATMUL_SHAPES) == 16
    assert sum(s[0] == 'matmul' for s in _INT4W_MATMUL_SHAPES) == 20
    assert sum(s[0] == 'conv' for s in _ENGINE_SHAPES) == 16
    assert sum(s[0] == 'matmul_requant' for s in _ENGINE_SHAPES) == 16
    assert sum(s[0] == 'matmul' for s in _ENGINE_SHAPES) == 21
    assert sum(s[0] == 'conv_acc' for s in _ENGINE_SHAPES) == 1
    assert sum(s[0] == 'matmul' for s in _TRAIN_SHAPES) == 37
    assert sum(s[0] == 'conv_acc' for s in _TRAIN_SHAPES) == 17


@pytest.mark.parametrize('kind,k,n,ptr,clause', [
    ('matmul', 45, 20, 512, 'K % 16'), ('matmul', 48, 18, 512, 'N % 4'),
    ('matmul', 48, 20, 520, 'pointer % 16'), ('conv', 5, 16, 512, 'C % 16'),
    ('conv', 48, 1000, 512, 'N % 16'), ('conv', 16, 24, 512, 'N % 16'),
    ('conv', 16, 16, 4, 'pointer % 16'), ('conv', 3, 7, 1, 'C % 16'),
    ('conv', 10, 16, 512, 'C % 16'), ('matmul_requant', 45, 16, 512, 'K % 16'),
    ('matmul_requant', 48, 20, 512, 'N % 16'),
    ('matmul_requant', 48, 1000, 512, 'N % 16'),
    ('matmul_requant', 48, 16, 520, 'pointer % 16'),
    ('conv_acc', 12, 64, 512, 'C % 16'), ('conv_acc', 3, 64, 512, 'C % 16'),
    ('conv_acc', 16, 18, 512, 'N % 4'), ('conv_acc', 48, 1002, 512, 'N % 4'),
    ('conv_acc', 16, 20, 520, 'pointer % 16')])
def test_rule_names_the_clause_that_excludes(kind, k, n, ptr, clause):
    """The step pads what each clause names, and nothing else: x's K or C
    zero-filled to a multiple of 16 (the handle viewed at that width),
    the vectors widened to an N of whole 16-byte output rows, x copied to
    a 16-byte boundary; a case may hit more clauses than the one it is
    named for (C = 3, N = 7 at an odd pointer)."""
    conv = kind.startswith('conv')
    x, prepared, vectors, (x2, p2, v2, _) = _step(kind, k, n, ptr)
    align = 16 // _OUT_BYTES[kind]
    k16, n_out = -(-k // 16) * 16, -(-n // align) * align
    want = ({'C % 16' if conv else 'K % 16'} if k16 != k else set()) | (
        {f'N % {align}'} if n_out != n else set()) | (
        {'pointer % 16'} if ptr % 16 and k16 == k else set())
    assert clause in want
    padded = set()
    if x2.shape[-1] != x.shape[-1]:
        padded.add('C % 16' if conv else 'K % 16')
        assert x2.shape == (2, x.shape[-1] // k * k16)
        assert (p2.wt is prepared.wt and (p2.taps, p2.cin, p2.cpad) ==
                (prepared.taps, k16, prepared.cpad))
        pix = x2.reshape(-1, k16)
        assert torch.equal(pix[:, :k], x.reshape(-1, k))
        assert not pix[:, k:].any()
    elif x2 is not x:
        padded.add('pointer % 16')
        assert torch.equal(x2, x) and p2 is prepared
    if v2 is not vectors:
        padded.add(f'N % {align}')
        for got, was in zip(v2, vectors):
            assert got.shape == (n_out,) and torch.equal(got[:n], was)
            assert not got[n:].any()
    assert padded == want
    assert x2.data_ptr() % 16 == 0 and x2.is_contiguous()


# form, shape, x's pointer % 16 ('identity': the residual's identity's): a
# matmul's (M, K, N), a conv's ((B, H, W, C), N, taps, pad), each refused
# class of the bare core, int8 and packed int4; MobileNetV2's K = 24 1×1
# convs and N = 24 projections, the CIFAR init's C = 3 (on the padded slab,
# and with its border left to TMA)
_PADDED = [('int8_matmul_acc', (37, 24, 24), 0),
           ('int8_matmul_requant', (37, 48, 24), 0),
           ('int8_matmul_acc', (20, 48, 18), 0),
           ('int8_matmul_requant', (20, 48, 16), 8),
           ('int8_matmul_requant', (9, 45, 19), 1),
           ('int4w_matmul_requant', (37, 24, 24), 0),
           ('int4w_matmul_acc', (20, 40, 18), 4),
           ('int8_conv_acc', ((2, 8, 8, 3), 16, (3, 3), (1, 1)), 0),
           ('int8_conv_acc', ((2, 8, 8, 3), 16, (3, 3), (0, 0)), 0),
           ('int8_conv_requant', ((2, 6, 6, 16), 24, (3, 3), (1, 1)), 0),
           ('int8_conv_acc', ((2, 6, 6, 16), 18, (3, 3), (0, 0)), 0),
           ('int8_conv_requant', ((1, 5, 5, 16), 16, (3, 3), (1, 1)), 8),
           ('int4w_conv_requant', ((2, 6, 6, 24), 24, (3, 3), (1, 1)), 0),
           ('int4w_conv_acc', ((1, 7, 7, 10), 18, (1, 1), (0, 0)), 4),
           ('residual', (37, 24, 24), 0),
           ('residual', (20, 48, 18), 0),
           ('residual', (20, 48, 16), 'identity'),
           ('residual', (20, 48, 16), 8)]


def _padded_conv(form, shape, ptr, rng):
    """(the walk on the step's operands cut back to N, the plain version,
    the Pallas kernel) of a conv call."""
    (b, h, w, c), n, taps, pad = shape
    kh, kw = taps
    int4, requant = form.startswith('int4w'), form.endswith('_requant')
    x = rng.randint(-128, 128, (b, h + kh - 1 - 2 * pad[0],
                                (w + kw - 1 - 2 * pad[1]) * c)).astype(np.int8)
    wf = (_w4 if int4 else lambda r, s: r.randint(-127, 128, s).astype(
        np.int8))(rng, (kh * kw * c, n))
    wp = tkc.pack_int4_conv(wf, kh * kw) if int4 else wf
    bias, mult = _vectors(rng, n, half=False)
    geo = dict(taps=taps, out_hw=(h, w), cin=c)
    xp = tkc.pad_conv_input(_t(x), pad, **geo) if pad != (0, 0) else _t(x)
    plain = tkc.conv_acc_plain(xp, _t(wf), _t(bias), **geo)
    prepared = tkc.prepare_conv_weights(_t(wp), taps, c, pad, int4)
    x2, p2, (b2, m2), _ = tkm.sm90_operands(
        _at(x, ptr), prepared, (_t(bias), _t(mult)), 1 if requant else 4)
    c2 = p2.cin // p2.row_taps
    geo2 = dict(geo, cin=c2)
    if pad != (0, 0):
        x2 = tkc.pad_conv_input(x2, pad, **geo2)
    walk = tkc.conv_acc_tiled_plain(x2, p2, b2, **geo2)
    epi = dict(out_bits=8, signed=True, relu=True)
    lo, hi = tkm.epilogue_bounds(**epi)
    args = [jnp.asarray(a) for a in (xp.numpy(), wp, bias)]
    with pltpu.force_tpu_interpret_mode():
        if requant:
            walk = tkm.requant_epilogue(walk, m2, lo, hi)
            plain = tkm.requant_epilogue(plain, _t(mult), lo, hi)
            fn = jkc.int4w_conv_requant if int4 else jkc.int8_conv_requant
            pallas = fn(*args, jnp.asarray(mult), **geo, **epi)
        else:
            fn = jkc.int4w_conv_acc if int4 else jkc.int8_conv_acc
            pallas = fn(*args, **geo)
    assert walk.shape == (b, h * w, b2.shape[0])
    return walk[..., :n], plain, np.asarray(pallas)


def _padded_matmul(form, shape, ptr, rng):
    """(the walk on the step's operands cut back to N, the plain version,
    the Pallas kernel, with the residual's requant-add after hawq_tpu's
    accumulator) of a matmul call."""
    m, k, n = shape
    int4, requant = form.startswith('int4w'), form.endswith('_requant')
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = (_w4(rng, (k, n)) if int4
         else rng.randint(-127, 128, (k, n)).astype(np.int8))
    wp = tkm.pack_int4(w) if int4 else w
    bias, mult = _vectors(rng, n, half=False)
    prepared = (tkm.prepare_weights_int4 if int4 else tkm.prepare_weights)(
        _t(wp))
    plain = tkm.matmul_acc_plain(_t(x), _t(w), _t(bias))
    identity = None
    if form == 'residual':
        identity = rng.randint(-2 ** 20, 2 ** 20, (m, n)).astype(np.int32)
        mult_id = np_dyadic_multiplier(
            (rng.rand(n) * 2e-3 + 1e-4).astype(np.float32))
        vectors = (_t(bias), _t(mult), _t(mult_id))
        idt = _at(identity, 8 if ptr == 'identity' else 0)
    else:
        vectors = (_t(bias), _t(mult))
    x2, p2, v2, id2 = tkm.sm90_operands(
        _at(x, 0 if ptr == 'identity' else ptr), prepared, vectors,
        1 if requant else 4, None if identity is None else idt)
    walk = tkm.matmul_acc_kmajor_plain(
        x2, p2, v2[0], 'int4w_matmul_acc' if int4 else 'int8_matmul_acc')
    epi = dict(out_bits=8, signed=True, relu=True)
    lo, hi = tkm.epilogue_bounds(**epi)
    args = [jnp.asarray(a) for a in (x, wp, bias)]
    with pltpu.force_tpu_interpret_mode():
        if requant:
            walk = tkm.requant_epilogue(walk, v2[1], lo, hi)
            plain = tkm.requant_epilogue(plain, _t(mult), lo, hi)
            fn = jkm.int4w_matmul_requant if int4 else jkm.int8_matmul_requant
            pallas = np.asarray(fn(*args, jnp.asarray(mult), **epi))
        else:
            fn = jkm.int4w_matmul_acc if int4 else jkm.int8_matmul_acc
            pallas = np.asarray(fn(*args))
    if identity is not None:
        assert id2.shape == (m, v2[0].shape[0]) and id2.data_ptr() % 16 == 0
        walk = tkm.residual_epilogue(walk, v2[1], id2, v2[2])
        plain = tkm.residual_epilogue(plain, _t(mult), _t(identity),
                                      _t(mult_id))
        pallas = np.maximum(np.asarray(jops.requant_add_int32(
            jnp.asarray(pallas), jnp.asarray(mult), jnp.asarray(identity),
            jnp.asarray(mult_id))), 0)
    assert walk.shape == (m, v2[0].shape[0])
    return walk[:, :n], plain, pallas


@pytest.mark.parametrize('form,shape,ptr', _PADDED)
def test_padded_walk_equals_plain_and_pallas(form, shape, ptr):
    """A call the bare core refuses (K or C not a multiple of 16, an output
    row that is not whole 16 bytes, a pointer off 16 bytes): the step's
    padded operands through the Hopper core's plain walk, the output cut
    back to N, equal the plain version and the JAX package's Pallas kernel
    (with the residual, hawq_tpu's accumulator and requant-add)."""
    rng = np.random.RandomState(len(form) + sum(np.ravel(shape[0])))
    padded = (_padded_conv if '_conv_' in form else _padded_matmul)(
        form, shape, ptr, rng)
    walk, plain, pallas = padded
    assert walk.dtype == plain.dtype
    np.testing.assert_array_equal(walk.numpy(), plain.numpy())
    np.testing.assert_array_equal(walk.numpy(), pallas)


@pytest.mark.parametrize('k,s,pad,c,o,h', [
    (3, 1, ((1, 1), (1, 1)), 64, 64, 6), (7, 2, ((3, 3), (3, 3)), 3, 64, 12),
    (3, 2, 'SAME', 5, 16, 10)])
def test_qat_convs_reach_the_rule_with_its_widths(monkeypatch, k, s, pad, c,
                                                  o, h):
    """``int_conv2d`` at ResNet-50 widths: a 3×3 / pad 1 conv hands
    ``int8_conv_acc`` the unpadded activations with ``pad`` (1, 1); a
    stride-2 conv its space-to-depth rewrite with C zero-filled to a
    multiple of 4 first (the RGB init: 3 → 4, C = 16 after the rewrite), so
    that the alignment step has nothing to pad; the result equals a float64
    convolution (exact for these integers)."""
    calls = []
    real = tkc.int8_conv_acc

    def record(xp, w, bias, **kw):
        calls.append((tuple(xp.shape), kw))
        return real(xp, w, bias, **kw)
    monkeypatch.setattr(tkc, 'int8_conv_acc', record)
    rng = np.random.RandomState(k + c)
    x = rng.randint(-128, 128, (2, h, h, c)).astype(np.float32)
    w = rng.randint(-127, 128, (k, k, c, o)).astype(np.float32)
    b = rng.randint(-2 ** 20, 2 ** 20, (o,)).astype(np.float32)
    got = TL.int_conv2d(_t(x), _t(w), _t(b), (s, s), pad)
    (shape, kw), = calls
    _needs_no_padding('conv_acc', kw['cin'], o)
    if s == 1:
        assert kw['pad'] == (1, 1) and shape == (2, h, h * c)
    else:
        assert kw['cin'] == 4 * (c + -c % 4) and kw['pad'] == (0, 0)
    (t, bo), (l, r) = TL.resolve_padding(pad, (h, h), (k, k), (s, s))
    xt = F.pad(torch.tensor(x, dtype=torch.float64).permute(0, 3, 1, 2),
               (l, r, t, bo))
    want = F.conv2d(xt, torch.tensor(w, dtype=torch.float64).permute(
        3, 2, 0, 1), torch.tensor(b, dtype=torch.float64), stride=s)
    np.testing.assert_array_equal(
        got.numpy(), want.permute(0, 2, 3, 1).numpy().astype(np.float32))


@pytest.mark.parametrize('m_tiles,n,k_tiles,want', [
    (392, 256, 1, 64), (392, 256, 2, 128), (98, 512, 1, 64),
    (98, 512, 2, 128), (25, 1024, 2, 128), (7, 2048, 4, 64),
    (7, 2048, 8, 128),
    (1, 1000, 16, 32), (1568, 64, 2, 64), (392, 64, 9, 64),
    (112, 128, 9, 128), (32, 256, 18, 64), (8, 512, 36, 32), (1, 4, 1, 32),
    (1000, 40, 3, 64),
    # int8_matmul_requant of ResNet-50 at batch 8: conv1 of stages 1 to 4
    # (a 128-wide grid of a short call must have a block for every SM)
    (392, 64, 1, 64), (392, 64, 2, 64), (98, 128, 2, 64), (98, 128, 4, 64),
    (25, 256, 4, 64), (25, 256, 8, 64), (7, 512, 8, 32), (7, 512, 16, 32)])
def test_tile_width_rule(m_tiles, n, k_tiles, want):
    assert tkm.sm90_tile_n(m_tiles, n, k_tiles, 132) == want


@pytest.mark.parametrize('m_tiles,n,k_tiles,want', [
    # int4w_conv_requant of ResNet-50 at batch 8: the 3×3 convs of stages 1
    # to 4, then the three 2×2-tap stride-2 convs
    (392, 64, 9, 64), (112, 128, 9, 64), (32, 256, 18, 64), (8, 512, 36, 32),
    (112, 128, 16, 64), (32, 256, 32, 64), (8, 512, 64, 32)])
def test_tile_width_rule_of_the_packed_conv_stops_at_64(m_tiles, n, k_tiles,
                                                        want):
    assert tkm.sm90_tile_n(m_tiles, n, k_tiles, 132, 64) == want


@pytest.mark.parametrize('m_tiles,n,k_tiles,want', [
    # int4w_matmul_requant of ResNet-50 at batch 8 (conv1 of stages 1 to 4),
    # then int4w_matmul_acc (conv3 and the identity convs)
    (392, 64, 1, 64), (392, 64, 2, 64), (98, 128, 2, 64), (98, 128, 4, 64),
    (25, 256, 4, 64), (25, 256, 8, 64), (7, 512, 8, 32), (7, 512, 16, 32),
    (392, 256, 1, 64), (98, 512, 1, 64), (98, 512, 2, 64), (25, 1024, 2, 64),
    (25, 1024, 4, 64), (7, 2048, 4, 64), (7, 2048, 8, 64)])
def test_tile_width_rule_of_the_packed_matmul_stops_at_64(m_tiles, n, k_tiles,
                                                          want):
    assert tkm.sm90_tile_n(m_tiles, n, k_tiles, 132,
                           tkm.SM90_INT4_MATMUL_WIDEST) == want


@pytest.mark.parametrize('m,n,k_tiles,want', [
    # the packed matmuls of ResNet-50 uniform4 at batch 8: 128 rows for the
    # wide weight matrices and the single-step stage-1 calls
    (25088, 64, 1, 128), (25088, 64, 2, 64), (6272, 128, 2, 64),
    (6272, 128, 4, 64), (1568, 256, 4, 64), (1568, 256, 8, 64),
    (392, 512, 8, 64), (392, 512, 16, 64), (25088, 256, 1, 128),
    (6272, 512, 1, 64), (6272, 512, 2, 64), (1568, 1024, 2, 128),
    (1568, 1024, 4, 128), (392, 2048, 4, 128), (392, 2048, 8, 128),
    # ResNet-18's identity convs, ragged calls
    (6272, 128, 1, 64), (1568, 256, 1, 64), (392, 512, 2, 64),
    (1, 16, 1, 64), (300, 1000, 1, 64), (130, 1024, 16, 128)])
def test_tile_rows_rule_of_the_packed_matmul(m, n, k_tiles, want):
    assert tkm.sm90_tile_m(m, n, k_tiles, 132) == want


# ---------------------------------------------------------------------------
# the engine keeps prepared weights, on the CPU too
# ---------------------------------------------------------------------------

def _unprepared(eng):
    """``eng``, its caches filled by a call, with every cached handle taken
    back to its plain weights (``unprepare_weights``), which the wrappers
    run by the first plain versions."""
    for key, val in eng._w.items():
        w = tkm.unprepare_weights(val[0])
        eng._w[key] = (val._replace(w=w) if hasattr(val, '_replace')
                       else (w,) + tuple(val[1:]))
    return eng


def test_engine_caches_prepared_weights_where_the_rule_takes_the_widths():
    """The CPU engine keeps K-major handles for every conv of tiny50 (conv1
    feeds ``int8_matmul_requant``, conv2 ``int8_conv_requant``, conv3 /
    identity ``int8_matmul_acc``), the 8-wide convs of stage 1 and the
    10-class FC (N % 4 and N % 16 unaligned) among them, and for the init
    conv (``int8_conv_acc`` over the channel-padded 4×4-tap rewrite, C =
    16), and runs the plain walk; the engine whose handles are taken back
    to plain weights gives the same logits."""
    fm = synthetic_frozen_resnet('tiny50', get_bit_config('tiny50',
                                                          'uniform8'),
                                 num_classes=10, seed=3)
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    eng = build_resnet_engine(fm, device='cpu')
    got = eng(x)
    kinds = {key: type(val[0]) for key, val in eng._w.items()}
    for conv in ('quant_convbn1', 'quant_convbn2', 'quant_convbn3',
                 'quant_identity_convbn'):
        assert any(conv in str(k) for k in kinds), conv
    assert all(t is tkm.PreparedWeights for t in kinds.values()), kinds
    assert 'stage1.unit1.quant_convbn1' in kinds         # N = 8
    assert 'quant_output' in kinds                       # N = 10
    assert not any(v[0].int4 for v in eng._w.values())
    # the raw init conv is cached by the k×k route, under (key, stride)
    init = eng._w['quant_init_convbn', 2][0]  # 4 rows of 4 taps of C = 16
    assert (init.taps, init.cin, init.row_taps) == (4, 64, 4)
    plain_eng = build_resnet_engine(fm, device='cpu')
    plain_eng(x)
    want = _unprepared(plain_eng)(x)
    assert not any(isinstance(v[0], tkm.PreparedWeights)
                   for v in plain_eng._w.values())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize('arch,scheme', [('tiny50', 'uniform4'),
                                         ('resnet50', 'bops_0.5')])
def test_engine_caches_packed_matmul_handles(arch, scheme):
    """Every 1×1 conv with 4-bit weights keeps a packed handle (``int4``,
    one tap) for ``int4w_matmul_requant`` / ``int4w_matmul_acc``, every
    8-bit one an int8 handle (the FC's int8 weights too, whatever its N);
    the logits equal those of the engine whose handles are taken back to
    plain weights (plain packed bytes, first plain versions)."""
    cfg = get_bit_config(arch, scheme)
    fm = synthetic_frozen_resnet(arch, cfg, num_classes=16, seed=9)
    x = np.random.RandomState(10).randn(1, 32, 32, 3).astype(np.float32)
    eng = build_resnet_engine(fm, device='cpu')
    got = eng(x)
    n4 = 0
    for key, (w, _) in ((k, v[:2]) for k, v in eng._w.items()
                        if isinstance(k, str) and k != 'init'):
        cin = np.asarray(fm[key + '.weight_int']).shape[-2]
        four = key != 'quant_output' and cfg.weight_bits(key) == 4
        assert isinstance(w, tkm.PreparedWeights), key
        assert w.int4 == four and w.taps == 1 and w.k == cin, key
        n4 += four
    assert n4 > 0
    plain = build_resnet_engine(fm, device='cpu')
    plain(x)
    want = _unprepared(plain)(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize('arch,scheme,input_mode', [
    ('tiny18', 'uniform8', 'float32'), ('tiny18', 'uniform4', 'folded_float32'),
    ('tiny50', 'uniform8', 'folded_float32'), ('tiny50', 'uniform4', 'float32'),
    ('wide50', 'uniform4', 'float32'), ('tiny18', 'uniform8', 'folded_float32'),
    ('tiny18', 'uniform4', 'float32'), ('tiny50', 'uniform8', 'float32'),
    ('tiny50', 'uniform4', 'folded_float32'),
    ('wide50', 'uniform4', 'folded_float32')])
def test_engine_with_cached_handles_matches_reference(arch, scheme,
                                                      input_mode):
    """The CPU engine keeps handles for the 1×1 and the 3×3 convs (packed
    where 4-bit) and the init conv, runs their plain walks, and its logits
    and every capture node equal the JAX engine's."""
    fm = jax_synthetic_frozen_resnet(arch, jax_bit_config(arch, scheme),
                                     num_classes=10, seed=11)
    x = np.random.RandomState(12).randn(1, 32, 32, 3).astype(np.float32)
    if input_mode == 'folded_float32':
        x = jfold.fold4_images(x)
    jkw = dict(input_mode=input_mode, residual_dtype=jnp.int16)
    tkw = dict(input_mode=input_mode, residual_dtype=torch.int16,
               device='cpu')
    eng = build_resnet_engine(_port_fm(fm), **tkw)
    got = eng(x).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_engine(fm, **jkw)(jnp.asarray(x))))
    handles = {(k if isinstance(k, str) else k[0]): v[0]
               for k, v in eng._w.items()
               if isinstance(v[0], tkm.PreparedWeights)}
    int4 = scheme == 'uniform4'
    bottleneck = arch != 'tiny18'
    # conv1 (1×1 of a bottleneck, else 3×3) and conv2 (3×3 of a bottleneck,
    # the int32 3×3 of a basic block), the bottleneck's conv3 and identity
    # conv (1×1), all packed where 4-bit; the init conv's are int8, a kernel
    # row read as one tap: the fold (3×3 of C = 48) or the 4×4-tap rewrite
    # of the channel-padded 7×7/s2 conv (C = 16)
    conv1 = [h for k, h in handles.items() if k.endswith('quant_convbn1')]
    conv2 = [h for k, h in handles.items() if k.endswith('quant_convbn2')]
    assert conv2 and all(h.int4 == int4 and h.taps in (4, 9) for h in conv2)
    if bottleneck:
        unit1x1 = conv1 + [h for k, h in handles.items() if k.endswith(
            ('quant_convbn3', 'quant_identity_convbn'))]
        assert conv1 and unit1x1
        assert all(h.int4 == int4 and h.taps == 1 for h in unit1x1)
    else:
        assert conv1 and all(h.int4 == int4 and h.taps in (4, 9)
                             for h in conv1)
    # the fold's weights are cached as 'init', the raw init conv's by the
    # k×k route under its key
    init = handles['init' if input_mode == 'folded_float32' else eng.init_key]
    assert not init.int4 and (init.taps, init.cin, init.row_taps) == (
        (3, 144, 3) if input_mode == 'folded_float32' else (4, 64, 4))
    nodes = _reference_nodes(fm, x, **jkw)
    for node, ref in nodes.items():
        port = build_resnet_engine(_port_fm(fm), capture=node, **tkw)(x)
        assert port.numpy().dtype == ref.dtype, node
        np.testing.assert_array_equal(port.numpy(), ref, err_msg=node)


# ---------------------------------------------------------------------------
# (f) the residual epilogue: a bottleneck's conv3 leaves as the carrier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('m', [128, 49])
@pytest.mark.parametrize('case', RESIDUAL_CASES)
def test_residual_matmul_equals_the_unfused_composition(case, m):
    """``int8_matmul_acc_residual`` (plain weights and the Hopper core's
    handle, the identity's multiplier repeated over N as the engine caches
    a scalar one) == the accumulator, the requant-add and the ReLU it
    replaces, in each operand regime (a ragged M among them); each regime
    hits what it is named for."""
    k, n = 64, 48
    x, w, bias, identity, mult_main, mult_id = (
        torch.tensor(a) for a in _residual_operands(case, m, k, n))
    acc = tkm.matmul_acc_plain(x, w, bias)
    a = round_half_up(acc.to(torch.float32) * mult_main)
    b = round_half_up(identity.to(torch.float32) * mult_id)
    want = torch.clamp_min(requant_add_int32(acc, mult_main, identity,
                                             mult_id), 0)
    for weights in (w, tkm.prepare_weights(w)):
        got = tkm.int8_matmul_acc_residual(x, weights, bias, identity,
                                           mult_main,
                                           mult_id.expand(n).contiguous())
        assert got.dtype == torch.int32 and got.shape == (m, n)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    s = a + b
    hit = {'carrier': mult_id.dim() == 0 and bool((identity >= 0).all()),
           'id_conv': mult_id.shape == (n,) and bool((identity < 0).any()),
           'ties': bool(((acc.to(torch.float32) * mult_main) % 1
                         == 0.5).any()),
           'past_2_24': bool((s > 2 ** 24).any() and (s < 2 ** 24).any()
                             and (a.double() + b.double()
                                  != s.double()).any()),
           'negative': bool((s < 0).float().mean() > 0.5 and (s > 0).any())}
    assert hit[case]


@pytest.mark.parametrize('out_bits,signed', [(8, True), (4, True),
                                             (4, False), (7, False)])
@pytest.mark.parametrize('case', ['carrier', 'id_conv'])
def test_residual_requant_plain_equals_residual_then_requant(case, out_bits,
                                                             signed):
    """The plain version of ``int8_matmul_acc_residual_requant`` and
    ``int8_matmul_residual_requant`` (plain weights and the Hopper core's
    handle, a ragged M) == ``residual_epilogue``, then
    ``quant.ops.requant_int32`` of that carrier at a scalar multiplier,
    signed and unsigned, both ends of the range hit; 8-bit unsigned values
    do not fit the int8 entry and are refused."""
    m, k, n = 49, 64, 48
    x, w, bias, identity, mult_main, mult_id = (
        torch.tensor(a) for a in _residual_operands(case, m, k, n))
    mult_id = mult_id.expand(n).contiguous()
    carrier = tkm.residual_epilogue(tkm.matmul_acc_plain(x, w, bias),
                                    mult_main, identity, mult_id)
    # a multiplier that spreads the carriers over the whole entry range and
    # past it (the clip)
    lo, hi = requant_clip_bounds(out_bits, signed)
    mult_in = _mult(2 * hi, float(carrier.max()))
    want = requant_int32(carrier, mult_in, out_bits, signed, torch.int8)
    assert int(want.min()) == max(lo, 0) and int(want.max()) == hi
    assert (want > 0).sum() > m * n // 4 and mult_in.dim() == 0
    for weights in (w, tkm.prepare_weights(w)):
        args = (x, weights, bias, identity, mult_main, mult_id, mult_in)
        kw = dict(out_bits=out_bits, signed=signed)
        got_c, got = tkm.int8_matmul_acc_residual_requant(*args, **kw)
        torch.testing.assert_close(got_c, carrier, rtol=0, atol=0)
        assert got.dtype == torch.int8
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(tkm.int8_matmul_residual_requant(
            *args, **kw), want, rtol=0, atol=0)
    with pytest.raises(ValueError, match='do not fit int8'):
        tkm.int8_matmul_residual_requant(x, w, bias, identity, mult_main,
                                         mult_id, mult_in, out_bits=8,
                                         signed=False)


def _unit_convs(fm, p):
    """(weights (K, N), bias, per-channel scale) of unit ``p``'s 1×1 convs
    that exist: conv3 and the identity conv."""
    out = {}
    for conv in ('quant_convbn3', 'quant_identity_convbn'):
        key = f'{p}.{conv}'
        if key + '.weight_int' in fm.tensors:
            w = torch.from_numpy(np.asarray(fm[key + '.weight_int']))
            out[conv] = (w.reshape(-1, w.shape[-1]),
                         torch.from_numpy(np.asarray(fm[key + '.bias_int'])),
                         np.asarray(fm[key + '.weight_scale'], np.float32))
    return out


def _mult(acc_scale, out_scale):
    """The engine's native multiplier of a requant site, on the host."""
    return torch.tensor(np_dyadic_multiplier(
        (np.asarray(acc_scale, np.float32) / np.float32(out_scale))
        .astype(np.float32)))


def test_engine_conv3_leaves_as_the_carrier_of_the_unfused_composition():
    """tiny50 uniform8, native requant, int32 carrier: every unit's
    ``quant_act_int32`` node (conv3 through its residual epilogue) equals
    the unfused composition computed here from the engine's earlier nodes:
    conv3's accumulator over the ``conv2`` node, the identity conv's over
    the unit's ``input`` node (or the carrier before the unit), then the
    requant-add and the ReLU; the logits equal the JAX engine's."""
    jfm = jax_synthetic_frozen_resnet(
        'tiny50', jax_bit_config('tiny50', 'uniform8'), num_classes=10,
        seed=5)
    fm = _port_fm(jfm)
    x = np.random.RandomState(6).randn(2, 32, 32, 3).astype(np.float32)

    def node(name):
        return build_resnet_engine(fm, capture=name, device='cpu')(x)
    carrier, carrier_scale = node('init'), fm.act_scale('quant_act_int32')
    for si, u in [(si, u) for si, n in enumerate(RESNET_UNITS['tiny50'], 1)
                  for u in range(1, n + 1)]:
        p = f'stage{si}.unit{u}'
        stride = 2 if (u == 1 and si > 1) else 1
        convs = _unit_convs(fm, p)
        w3, b3, ws3 = convs['quant_convbn3']
        h = node(f'{p}.conv2')
        acc = tkm.matmul_acc_plain(h.reshape(-1, w3.shape[0]), w3, b3)
        s_out = fm.act_scale(f'{p}.quant_act_int32')
        if 'quant_identity_convbn' in convs:
            wi, bi, wsi = convs['quant_identity_convbn']
            xs = node(f'{p}.input')[:, ::stride, ::stride, :]
            identity = tkm.matmul_acc_plain(xs.reshape(-1, wi.shape[0]), wi,
                                            bi)
            id_scale = wsi * np.float32(fm.act_scale(f'{p}.quant_act'))
        else:
            identity, id_scale = carrier.reshape(acc.shape), carrier_scale
        want = torch.clamp_min(requant_add_int32(
            acc, _mult(ws3 * np.float32(fm.act_scale(f'{p}.quant_act2')),
                       s_out), identity, _mult(id_scale, s_out)), 0)
        carrier, carrier_scale = node(f'{p}.quant_act_int32'), s_out
        assert carrier.dtype == torch.int32
        torch.testing.assert_close(carrier.reshape(want.shape), want,
                                   rtol=0, atol=0)
    np.testing.assert_array_equal(
        build_resnet_engine(fm, device='cpu')(x).numpy(),
        np.asarray(jax_engine(jfm)(jnp.asarray(x))))


@pytest.mark.parametrize('arch,scheme,kw,routing,fused', [
    ('tiny50', 'uniform8', {}, None, True),
    ('tiny50', 'uniform8', dict(input_mode='folded_float32'), None, True),
    ('tiny50', 'uniform8', dict(residual_dtype=torch.int16), None, False),
    ('tiny50', 'uniform8', dict(requant_mode='reference'), None, False),
    ('tiny50', 'uniform4', {}, None, False),
    ('tiny50', 'uniform4', {}, 'int8', True),
    ('tiny50', 'uniform8', {}, 'int4w', True),
    ('tiny18', 'uniform8', {}, None, False)])
def test_engine_takes_the_residual_epilogue_where_it_can(monkeypatch, arch,
                                                        scheme, kw, routing,
                                                        fused):
    """The residual epilogue once a unit for a bottleneck in native mode
    with the int32 carrier and int8 conv3 weights (a routing table's
    'int8' on 4-bit weights too, its 'int4w' only on 4-bit ones), never for
    the int16 carrier, reference mode, packed conv3 weights or basic
    blocks; in every unit but the last with the next unit's entry requant
    (tiny50: stage2.unit1 has an identity conv, so stage1.unit1's carrier
    is not stored; stage2.unit2 reads stage2.unit1's as its identity); the
    logits equal the JAX engine's."""
    calls = []
    forms = (tkm.RESIDUAL, tkm.RESIDUAL_REQUANT, tkm.RESIDUAL_REQUANT_ONLY)

    def counted(name, fn):
        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call
    for name in forms:
        monkeypatch.setattr(tkm, name, counted(name, getattr(tkm, name)))
    jfm = jax_synthetic_frozen_resnet(arch, jax_bit_config(arch, scheme),
                                      num_classes=10, seed=7)
    fm = _port_fm(jfm)
    table = None
    if routing is not None:                  # every unit conv one route
        table = {k[:-len('.weight_int')]: routing for k in fm.tensors
                 if k.startswith('stage') and k.endswith('.weight_int')}
    x = np.random.RandomState(8).randn(2, 32, 32, 3).astype(np.float32)
    jkw = dict(kw)
    if kw.get('input_mode') == 'folded_float32':
        x = jfold.fold4_images(x)
    if 'residual_dtype' in kw:
        jkw['residual_dtype'] = jnp.int16
    got = build_resnet_engine(fm, device='cpu', routing=table, **kw)(x)
    assert len(calls) == (sum(RESNET_UNITS[arch]) if fused else 0)
    if fused:
        assert calls == [tkm.RESIDUAL_REQUANT_ONLY, tkm.RESIDUAL_REQUANT,
                         tkm.RESIDUAL]
    if routing is None and 'requant_mode' not in kw:
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_engine(jfm, **jkw)(jnp.asarray(x))))
