"""The walk of A1's kernel (hawq_tpu_torch/kernels/csrc/avgpool.cu) on the
CPU: ``kernels/avgpool.py avgpool_walk_plain`` computes the pool the way
the kernel does — the tile rule's tiles, each staged with its halo from the
zero-bordered input and requantized there (the clip before the floor), a
row 3-sum per staged row and a 3-row window slid down each output column,
the quotient in integers where the sums are bounded — and is held bit-equal
(tolerance 0) to the JAX package's ops: ``requant_int32`` to the branch's
``q_input_act`` bits, ``jax.lax.reduce_window``, ``trunc(exact_div(sum,
9) + 0.01)`` and ``requant_int32`` to int8, as
``hawq_tpu/inference/engine_inception.py`` runs the pool branches; so is
the fused form's plain version.  The integer quotient is held equal to the
true division at every sum it takes, and the tile rule to its contract at
every InceptionV3 shape.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.quant import ops as jops

from hawq_tpu_torch.kernels import avgpool as ka
from hawq_tpu_torch.quant.ops import np_dyadic_multiplier
from tests.test_torch_avgpool import _pool

torch.set_num_threads(1)

_HW = (1, 2, 3, 5, 8, 17, 35)
_C = (1, 3, 4, 12, 32, 288)
_DTYPES = ((np.int32, 32768), (np.int16, 32768), (np.int8, 128))
_TORCH = {np.int32: torch.int32, np.int16: torch.int16, np.int8: torch.int8}
# the requant in front: none, to 16 bits signed per tensor, to 16 bits
# unsigned per channel, to 8 bits signed per channel
_FRONT = (None, (16, True, False), (16, False, True), (8, True, True))


def _reference(x, mult, bits, signed, front=None):
    """The JAX package's ops on numpy inputs → int8 numpy."""
    h = jnp.asarray(x)
    if front is not None:
        in_mult, in_bits, in_signed = front
        h = jops.requant_int32(h, jnp.asarray(in_mult), in_bits, in_signed,
                               jnp.int32)
    return np.asarray(jops.requant_int32(_pool(h), jnp.asarray(mult), bits,
                                         signed, jnp.int8))


def _front_kw(front):
    if front is None:
        return {}
    in_mult, in_bits, in_signed = front
    return dict(in_mult=torch.from_numpy(np.asarray(in_mult, np.float32)),
                in_bits=in_bits, in_signed=in_signed)


def _plans(shape, dtype):
    """The rule's plan, then each form the channels allow (16-byte copies,
    one-word copies, one channel a thread) on tiles that leave ragged
    edges: 3 columns × 2 rows, whole rows one at a time, 2 columns × the
    whole height."""
    b, h, w, c = shape
    es = torch.empty((), dtype=dtype).element_size()
    forms = [(1, es)]
    if c % 4 == 0:
        forms.append((4, 4 * es))
        if c * es % 16 == 0:
            forms.append((4, 16))
    plans = [None]
    for vec, copy in forms:
        units = c // vec
        wpc = copy // (4 * es) if vec == 4 else 1
        cs = max(d for d in range(wpc, min(units, 8) + 1, wpc)
                 if units % d == 0)
        for tw, th in ((3, 2), (w, 1), (2, h)):
            plans.append(ka.AvgPlan(vec, copy, cs, tw, th))
    return plans


def _check(x, mult, bits=8, signed=True, front=None, plans=None):
    mult = np.asarray(mult, np.float32)
    want = _reference(x, mult, bits, signed, front)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mult)
    kw = _front_kw(front)
    plain = ka.int_avgpool3x3_requant(tx, tm, out_bits=bits, signed=signed,
                                      **kw)
    np.testing.assert_array_equal(plain.numpy(), want)
    for plan in plans or [None]:
        got = ka.avgpool_walk_plain(tx, tm, bits, signed, plan=plan, **kw)
        assert got.dtype == torch.int8 and tuple(got.shape) == x.shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(plan))
    return want


def _mult(rng, c, per_channel, scale=1.0):
    ratio = (rng.rand(c) if per_channel else rng.rand()) * 0.01 + 0.002
    return np_dyadic_multiplier(np.asarray(scale * ratio, np.float32))


def _in_mult(rng, c, per_channel, es):
    """Multipliers into the requant in front: about 1 for 16-bit inputs,
    ~100 for int8, ~1/100 into 8 bits; some saturate."""
    base = {4: 1.0, 2: 1.0, 1: 100.0}[es]
    ratio = (rng.rand(c) if per_channel else rng.rand()) * 1.5 + 0.25
    return np_dyadic_multiplier(np.asarray(base * ratio, np.float32))


@pytest.mark.parametrize('h', _HW)
@pytest.mark.parametrize('front', _FRONT)
def test_walk_equals_reference_ops(h, front):
    """Every W at this H, C and the input dtype cycled; the rule's plan and
    every form's ragged tiles (the alternatives at the widest shapes only
    where they stay quick)."""
    rng = np.random.RandomState(h + 7 * _FRONT.index(front))
    for i, w in enumerate(_HW):
        c = _C[(i + h) % len(_C)]
        dt, hi = _DTYPES[(i + h) % 3]
        x = rng.randint(-hi, hi, (2, h, w, c)).astype(dt)
        es = x.itemsize
        f = None
        if front is not None:
            bits, signed, per_channel = front
            f = (_in_mult(rng, c, per_channel, es)
                 * (np.float32(1 / 64) if bits == 8 else np.float32(1)),
                 bits, signed)
        scale = 64.0 if dt == np.int8 and front is None else 1.0
        if front is not None and front[0] == 8:
            scale = 16.0
        plans = _plans(x.shape, _TORCH[dt])
        if h * w * c > 35 * 35 * 4:
            plans = plans[:2]
        out = _check(x, _mult(rng, c, i % 2 == 1, scale), 8, True, f, plans)
        if h * w > 4:
            assert len(np.unique(out)) > 2


@pytest.mark.parametrize('dtype', [np.int32, np.int16, np.int8])
@pytest.mark.parametrize('in_signed', [True, False])
def test_front_saturates(dtype, in_signed):
    """A requant in front that drives x to ±32767 / [0, 65535]: window sums
    at 9·32767 and at the bound 9·65535 of the integer quotient, per-tensor
    and per-channel, signed 8 and unsigned 4 bits out."""
    hi = np.iinfo(dtype).max
    x = np.full((2, 5, 7, 8), hi, dtype)
    x[:, 2, 3, ::2] = -hi
    x[1] = -x[1]
    m_sat = np.float32(2 ** 20 / hi)
    for in_mult in (m_sat, np.where(np.arange(8) % 2, m_sat,
                                    np.float32(0.5)).astype(np.float32)):
        front = (in_mult, 16, in_signed)
        _check(x, np.float32(2 ** -9), 8, True, front,
               _plans(x.shape, _TORCH[dtype]))
        _check(x, np.float32(2 ** -13), 4, False, front)
    h = ka.int_avgpool3x3_requant(
        torch.from_numpy(x), torch.tensor(np.float32(1 / 9 * 2 ** -9)),
        out_bits=8, signed=True, in_mult=torch.tensor(m_sat), in_bits=16,
        in_signed=in_signed)
    assert int(h.max()) > 0


@pytest.mark.parametrize('dtype', [np.int32, np.int16, np.int8])
@pytest.mark.parametrize('front', [None, (np.float32(1.0), 16, True)])
def test_constant_minus_nine(dtype, front):
    """A constant −9 field: interior sums −81, trunc(−9 + 0.01) = −8; the
    borders −54 and −36 (multiples of 9 too: −5 and −3)."""
    x = np.full((1, 4, 5, 4), -9, dtype)
    want = _check(x, np.float32(1.0), 8, True, front,
                  _plans(x.shape, _TORCH[dtype]))
    assert want[0, 1, 1, 0] == -8
    assert want[0, 0, 0, 0] == -3 and want[0, 0, 1, 0] == -5


def test_quotient_at_every_bounded_sum():
    """The kernel's integer quotient (``pool_quotient(s, True)``) equals
    trunc(f32(s) / 9 + 0.01) by the true division, in torch and in JAX's
    ``exact_div``, at every sum a requant in front to at most 16 bits (or a
    16- or 8-bit input) gives: −9·32768 … 9·65535."""
    s = torch.arange(-9 * 32768, 9 * 65535 + 1, dtype=torch.int32)
    got = ka.pool_quotient(s, True)
    want = ka.pool_quotient(s, False)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    ref = jnp.trunc(jops.exact_div(jnp.asarray(s.numpy()).astype(
        jnp.float32), 9.0) + 0.01)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# InceptionV3's pool branches at 299², b8: (H = W, C), nine calls
_INCEPTION = [(35, 192), (35, 256), (35, 288), (17, 768), (8, 1280),
              (8, 2048)]


@pytest.mark.parametrize('dtype', [torch.int32, torch.int16])
@pytest.mark.parametrize('h,c', _INCEPTION)
def test_tile_rule_fills_the_card(dtype, h, c):
    """At every InceptionV3 pool shape, b8, on both wide containers: 4
    channels a thread with 16-byte copies, at least one tile for each of
    the H100's 132 SMs, at most 512 threads and 96 KB of shared memory a
    block, whole channel slabs of whole copies, several output rows a
    thread, and no more than one tile of rows or columns beyond the
    output."""
    plan = ka.avgpool_plan(8, h, h, c, dtype)
    assert (plan.vec, plan.copy) == (4, 16)
    assert ka.avgpool_grid(plan, 8, h, h, c) >= ka.AP_SMS
    assert plan.cs * plan.tw <= ka.AP_THREADS
    assert ka.avgpool_smem(plan, dtype) <= ka.AP_SMEM
    wpc = 16 // (4 * torch.empty((), dtype=dtype).element_size())
    assert (c // 4) % plan.cs == 0 and plan.cs % wpc == 0
    assert plan.th >= 4
    assert plan.th < h + plan.th and plan.tw < h + plan.tw


def test_form_and_ragged_plans():
    """One channel a thread where C % 4 or the pointer is off a word; copies
    of one word where C·sizeof or the pointer is off 16 bytes; the rule's
    plan at small and ragged shapes fits the kernel's limits (threads,
    shared memory, columns, rows a thread)."""
    assert ka.avgpool_form(288, torch.int32) == (4, 16)
    assert ka.avgpool_form(12, torch.int16) == (4, 8)
    assert ka.avgpool_form(16, torch.int16) == (4, 16)
    assert ka.avgpool_form(16, torch.int16, 8) == (4, 8)
    assert ka.avgpool_form(12, torch.int8) == (4, 4)
    assert ka.avgpool_form(12, torch.int32, 4) == (1, 4)
    assert ka.avgpool_form(3, torch.int16) == (1, 2)
    for shape in ((1, 1, 1, 1), (2, 5, 7, 3), (1, 35, 35, 4),
                  (2, 147, 147, 64), (1, 2, 300, 12)):
        for dtype in (torch.int32, torch.int16, torch.int8):
            plan = ka.avgpool_plan(*shape, dtype)
            assert plan.cs * plan.tw <= ka.AP_THREADS
            assert ka.avgpool_smem(plan, dtype) <= ka.AP_SMEM
            assert plan.tw <= ka.AP_COLS and plan.th <= ka.AP_ROWS
            assert plan.th >= min(shape[1] // 2, 4)


def test_plan_must_fit_the_pointer():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int32)
    flat = torch.zeros(x.numel() + 1, dtype=torch.int32)
    unaligned = flat[1:].view(x.shape)
    with pytest.raises(ValueError):
        ka.call_plan(unaligned, ka.AvgPlan(4, 16, 2, 4, 4))
    plan = ka.AvgPlan(1, 4, 8, 4, 4)
    assert ka.call_plan(unaligned, plan) == plan
    with pytest.raises(ValueError):                # in_mult without its bits
        ka.int_avgpool3x3_requant(x, torch.tensor(1.0), out_bits=8,
                                  signed=True, in_mult=torch.tensor(1.0))
