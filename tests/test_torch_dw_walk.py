"""The walk of D1's kernel (hawq_tpu_torch/kernels/csrc/depthwise.cu) on the
CPU: ``kernels/depthwise.py dwconv_walk_plain`` computes the depthwise conv
the way the kernel does — the tile rule's tiles, each staged with its halo
from the zero-bordered input, 4 channels a thread (pixel words transposed
with ``prmt``) or one, each pixel's three taps of a kernel row one funnel
``prmt`` and one ``dp4a`` — and is held bit-equal (tolerance 0) to the
plain versions and to hawq_tpu's two formulations: nine shifted int32
multiply-adds (``engine_mobilenet._dw_shifted``) plus the bias, and XLA's
int8 grouped convolution (``engine._conv_i8``, groups = C); the requant
form also to the reference's ``_relu6_clip`` then ``requant_int32``.  The
tile rule is held to its contract at every MobileNetV2 w1 shape.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.inference.engine import _conv_i8
from hawq_tpu.inference.engine_mobilenet import _dw_shifted, _relu6_clip
from hawq_tpu.quant import ops as jops

from hawq_tpu_torch.inference.engine_mobilenet import relu6_bound
from hawq_tpu_torch.kernels import depthwise as kd
from hawq_tpu_torch.quant.ops import np_dyadic_multiplier

torch.set_num_threads(1)

# every H and W of {1, 2, 3, 5, 7, 9, 14}, odd and even H, widths off the
# pixels a thread takes
_HW = [(1, 1), (2, 14), (3, 5), (5, 3), (7, 9), (9, 2), (14, 7)]
_C = [3, 4, 8, 12, 20, 36]


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


def _plans(shape, stride):
    """The rule's plan for CPU pointers, then each form the channels allow
    (4 channels a thread with 16- and 4-byte copies, one channel) at each
    pixels-a-thread choice, on tiles that leave ragged edges."""
    b, h, w, c = shape
    plans = [None]
    forms = [(1, 1)] + ([(4, 4)] if c % 4 == 0 else []) + (
        [(4, 16)] if c % 16 == 0 else [])
    for vec, copy in forms:
        cs = kd.dw_plan(b, h, w, c, stride, vec=vec, copy=copy).cs
        for p in ((2, 4) if vec == 4 else (4 // stride,)):
            for ng, rows in ((1, 2), (3, 1)):
                plans.append(kd.DwPlan(vec, copy, p, cs, ng, rows))
    return plans


@pytest.mark.parametrize('hw', _HW)
@pytest.mark.parametrize('c', _C)
@pytest.mark.parametrize('stride', [1, 2])
def test_walk_acc_equals_shifted_and_grouped_conv(hw, c, stride):
    shape = (2, *hw, c)
    saturate = c == 36
    x, w, b = _operands(np.random.RandomState(sum(shape) + stride), shape,
                        saturate)
    shifted = np.asarray(_dw_shifted(jnp.asarray(x), w, stride)) + b
    grouped = np.asarray(_conv_i8(jnp.asarray(x), w, (stride, stride),
                                  ((1, 1), (1, 1)), groups=c)) + b
    np.testing.assert_array_equal(shifted, grouped)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    np.testing.assert_array_equal(
        kd.dwconv_acc_plain(tx, tw, tb, stride).numpy(), shifted)
    for plan in _plans(shape, stride):
        got = kd.dwconv_walk_plain(tx, tw, tb, stride, plan)
        assert got.dtype == torch.int32, plan
        np.testing.assert_array_equal(got.numpy(), shifted, err_msg=str(plan))


@pytest.mark.parametrize('hw', [(7, 9), (2, 14), (5, 3)])
@pytest.mark.parametrize('c', [4, 12, 20])
@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('bits,signed', [(8, True), (4, False)])
def test_walk_requant_equals_reference_epilogue(hw, c, stride, bits,
                                                signed):
    """ReLU6 bounds that bind on some channels and not on others, and
    multipliers of 0.5 that put odd accumulators on a .5 boundary."""
    shape = (2, *hw, c)
    rng = np.random.RandomState(sum(shape) + bits)
    x, w, b = _operands(rng, shape, False)
    acc_scale = (rng.rand(c) * 3e-4 + 2e-5).astype(np.float32)
    acc_scale[::2] = 6.0 / 40.0          # hi6 = 40 binds on these channels
    mult = np_dyadic_multiplier((rng.rand(c) * 0.02 + 1e-3)
                                .astype(np.float32))
    mult[1::3] = 0.5
    lo, hi = jops.requant_clip_bounds(bits, signed)
    acc = _relu6_clip(_dw_shifted(jnp.asarray(x), w, stride) + b, acc_scale)
    want = np.asarray(jops.requant_int32(acc, jnp.asarray(mult), bits,
                                         signed))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    hi6, tm = torch.from_numpy(relu6_bound(acc_scale)), torch.from_numpy(mult)
    np.testing.assert_array_equal(
        kd.dwconv_requant_plain(tx, tw, tb, hi6, tm, stride, lo, hi).numpy(),
        want)
    for plan in _plans(shape, stride):
        got = kd.dwconv_walk_plain(tx, tw, tb, stride, plan, hi6=hi6,
                                   mult=tm, lo=lo, hi=hi)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(plan))


# MobileNetV2 w1's 17 depthwise convs at 224²: (H = W in, C, stride)
_MNV2 = [(112, 32, 1), (112, 96, 2), (56, 144, 1), (56, 144, 2),
         (28, 192, 1), (28, 192, 2), (14, 384, 1), (14, 576, 1),
         (14, 576, 2), (7, 960, 1)]


@pytest.mark.parametrize('batch', [8, 32])
@pytest.mark.parametrize('h,c,stride', _MNV2)
def test_tile_rule_fills_the_card(batch, h, c, stride):
    """At every MobileNetV2 w1 shape, b8 and b32: 4 channels a thread with
    16-byte copies, at least one tile for each of the H100's 132 SMs, at
    most 256 threads a block, whole channel slabs (16-byte copies need a
    multiple of 4 words), and no more than one tile of rows or columns
    beyond the output."""
    plan = kd.dw_plan(batch, h, h, c, stride, vec=4, copy=16)
    assert (plan.vec, plan.copy, plan.p) == (4, 16, 4)
    assert kd.dw_grid(plan, batch, h, h, c, stride) >= kd.DW_SMS
    assert plan.cs * plan.ng * plan.rows <= kd.DW_THREADS
    assert (c // 4) % plan.cs == 0 and plan.cs % 4 == 0
    oh, ow = kd.dw_output_hw(h, h, stride)
    assert plan.rows <= oh and plan.ng * plan.p < ow + plan.p


def test_tile_rule_small_and_ragged_shapes():
    """One channel a thread where C % 4 or a pointer forbids words (s·p =
    4); a slab that divides the channel units; a grid under 132 blocks only
    where the shape has fewer tiles of one row than that."""
    assert kd.dw_form(12, 0, 0, 0) == (4, 4)
    assert kd.dw_form(32, 0, 0, 0) == (4, 16)
    assert kd.dw_form(32, 4, 0, 0) == (4, 4)
    assert kd.dw_form(32, 1, 0, 0) == (1, 1)
    assert kd.dw_form(3, 0, 0, 0) == (1, 1)
    assert kd.dw_form(32, 0, 0, 8) == (1, 1)      # out off 16 bytes
    for stride in (1, 2):
        plan = kd.dw_plan(2, 5, 9, 3, stride, vec=1, copy=1)
        assert plan.vec == 1 and plan.p * stride == 4 and plan.cs == 3
        plan = kd.dw_plan(1, 7, 7, 20, stride, vec=4, copy=4)
        assert plan.cs == 5 and plan.rows == 1     # 5 units, one slab
        b, h, w, c = 1, 7, 7, 20
        oh, ow = kd.dw_output_hw(h, w, stride)
        # rows shrank to 1 and p to 2 chasing 132 blocks: as small as it goes
        assert plan.p == 2
        assert kd.dw_grid(plan, b, h, w, c, stride) == oh * -(-ow // (
            plan.ng * plan.p))


@pytest.mark.parametrize('r', [0, 1, 2, 3])
def test_byte_selections_match_the_ptx_definitions(r):
    """``prmt`` (byte i of the result: byte sel[4i+2:4i] of the 8-byte run
    (a, b)), the 4×4 byte transpose, a pixel's taps and a signed ``dp4a``,
    against numpy on random words."""
    rng = np.random.RandomState(r)
    words = rng.randint(0, 2 ** 32, (4, 64), dtype=np.uint64)
    by = [[(words[i] >> np.uint64(8 * j)) & np.uint64(0xFF)
           for j in range(4)] for i in range(4)]
    t = kd.transpose4(*(torch.from_numpy(wd.astype(np.int64))
                        for wd in words))
    for j in range(4):                  # byte i of t_j is byte j of a_i
        want = sum(by[i][j] << np.uint64(8 * i) for i in range(4))
        np.testing.assert_array_equal(t[j].numpy(), want.astype(np.int64))
    lo, hi = (torch.from_numpy(wd.astype(np.int64)) for wd in words[:2])
    run = [by[0][k] for k in range(4)] + [by[1][k] for k in range(4)]
    want = sum(run[r + i] << np.uint64(8 * i) for i in range(4))
    np.testing.assert_array_equal(kd._taps(lo, hi, r).numpy(),
                                  want.astype(np.int64))
    acc = torch.from_numpy(rng.randint(-2 ** 20, 2 ** 20, 64))
    s8 = [[b.astype(np.int64) - 256 * (b >= 128) for b in row]
          for row in by[2:]]
    want = acc.numpy() + sum(s8[0][i] * s8[1][i] for i in range(4))
    np.testing.assert_array_equal(
        kd.dp4a(*(torch.from_numpy(wd.astype(np.int64))
                  for wd in words[2:]), acc).numpy(), want)


def test_plan_must_fit_the_pointers():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    w = torch.zeros((3, 3, 1, 8), dtype=torch.int8)
    flat = torch.zeros(x.numel() + 1, dtype=torch.int8)
    unaligned = flat[1:].view(x.shape)
    out = torch.empty((1, 4, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        kd.call_plan(unaligned, w, out, 1, kd.DwPlan(4, 4, 4, 2, 1, 1))
    with pytest.raises(ValueError):            # C % 16: no 16-byte copies
        kd.call_plan(x, w, out, 1, kd.DwPlan(4, 16, 4, 2, 1, 1))
    plan = kd.DwPlan(1, 1, 4, 8, 1, 1)
    assert kd.call_plan(unaligned, w, out, 1, plan) == plan
