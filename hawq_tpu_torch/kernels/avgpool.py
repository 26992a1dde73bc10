"""A1: the integer 3×3/s1/p1 average pool of InceptionV3's pool branches,
with the requant that follows it and, optionally, the branch's input
requant in front of it: a kernel the TPU package does not have.

``hawq_tpu`` requantizes the unit's input to ``q_input_act``, runs the pool
as XLA's ``reduce_window`` window sum, then ``trunc(sum / 9 + 0.01)`` with a
true division (``engine_inception.py int_avgpool_3x3``), then the
``q_pool_act`` requant.  On a CUDA tensor :func:`int_avgpool3x3_requant`
launches csrc/avgpool.cu, which does the last three in one pass and, given
``in_mult``, the first as well; on a CPU tensor it runs the plain version,
:func:`avgpool3x3_requant_plain`: torch ops in the reference's order.
:func:`int_avgpool3x3` is the same kernel's quotient form, with neither
requant: the window sum and ``trunc(sum / 9 + 0.01)`` as int32, the exact
counterpart of ``int_avgpool_3x3`` (the reference-checkpoint replay runs
its requants in float64 around it); its plain version is
:func:`avgpool3x3_plain`.

The kernel walks output tiles (:func:`avgpool_plan` picks them), each
staged once with its halo in shared memory and requantized there; a thread
owns one output column and 4 channels (or one) of a tile and slides a
3-row window of row 3-sums down it.  :func:`avgpool_walk_plain` walks the
same tiles in torch integer ops on the CPU.  Both forms run as the
operators ``torch.ops.hawq.<wrapper name>`` (:data:`OPS`;
``_build.define_op``), the plan as ints, or none for the rule's, chosen at
launch from the pointer.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from hawq_tpu_torch.kernels import _build
from hawq_tpu_torch.kernels.depthwise import _split
from hawq_tpu_torch.quant import ops as qops

_IN_CODES = {torch.int16: 0, torch.int32: 1, torch.int8: 2}
_SIZES = {torch.int32: 4, torch.int16: 2, torch.int8: 1}

AP_THREADS = 512          # the most threads a block takes (csrc MAX_THREADS)
AP_SMEM = 96 * 1024       # the most shared memory a block takes (MAX_SMEM)
AP_SMS = 132              # the H100's SMs: the grid the rule aims to fill
# The tile rule's shape, from the kernel's times at the InceptionV3 b8
# shapes on one H100 (PERF.md §6): tiles of at most 32 columns and 9
# rows (at most half the height), blocks of at most 256 threads.
AP_COLS, AP_ROWS, AP_RULE_THREADS = 32, 9, 256


class AvgPlan(NamedTuple):
    """How the kernel walks one call (csrc/avgpool.cu ``Tile``)."""
    vec: int     # channels a thread: 4 (one word of a pixel) or 1
    copy: int    # bytes a staging copy moves: 16 or one word (vec 4); one
                 # element, loaded through registers (vec 1)
    cs: int      # channel units (vec channels each) a block
    tw: int      # output columns a block: a thread each
    th: int      # output rows a block: each thread walks them


def avgpool_form(c: int, dtype: torch.dtype, x_ptr: int = 0):
    """(vec, copy) of a call: 4 channels a thread where C % 4 and x is
    aligned to a word of 4 channels, with 16-byte staging copies where also
    C·sizeof % 16 and x is 16-byte aligned, else copies of one word; one
    channel a thread otherwise."""
    es = _SIZES[dtype]
    if c % 4 or x_ptr % (4 * es):
        return 1, es
    return 4, 16 if (c * es) % 16 == 0 and x_ptr % 16 == 0 else 4 * es


def avgpool_grid(plan: AvgPlan, b: int, h: int, w: int, c: int) -> int:
    """Tiles of a call under ``plan``: the kernel's blocks, one each."""
    return (b * -(-h // plan.th) * -(-w // plan.tw)
            * (c // plan.vec // plan.cs))


def avgpool_smem(plan: AvgPlan, dtype: torch.dtype) -> int:
    """Shared memory of a block: the int32 tile with its halo and, for a
    16- or 8-bit input staged by copies, the raw region the copies land in
    (csrc/avgpool.cu ``launch``)."""
    words = (plan.th + 2) * (plan.tw + 2) * plan.cs * plan.vec
    es = _SIZES[dtype]
    return words * 4 + (words * es if plan.vec == 4 and es < 4 else 0)


@functools.lru_cache(maxsize=None)
def avgpool_plan(b: int, h: int, w: int, c: int, dtype: torch.dtype, *,
                 vec: Optional[int] = None, copy: Optional[int] = None,
                 sms: int = AP_SMS) -> AvgPlan:
    """The tile of one call (``vec``, ``copy``: :func:`avgpool_form` of an
    aligned input where not given): the even share of the columns of at
    most :data:`AP_COLS`, the even share of the rows of at most
    :data:`AP_ROWS` and half the height, and the widest channel slab (a
    divisor of the units, a multiple of the words a copy moves) with at
    most :data:`AP_RULE_THREADS` threads and :data:`AP_SMEM` of shared
    memory, narrowed while the call has fewer tiles than ``sms``."""
    if vec is None:
        vec, copy = avgpool_form(c, dtype)
    units = c // vec
    wpc = copy // (4 * _SIZES[dtype]) if vec == 4 else 1
    tw = _split(w, AP_COLS)
    th = _split(h, min(AP_ROWS, -(-h // 2)))
    slabs = [cs for cs in range(wpc, units + 1, wpc) if units % cs == 0]
    fit = [cs for cs in slabs if cs * tw <= max(AP_RULE_THREADS, tw * wpc)
           and avgpool_smem(AvgPlan(vec, copy, cs, tw, th), dtype)
           <= AP_SMEM] or slabs[:1]
    for cs in reversed(fit):
        plan = AvgPlan(vec, copy, cs, tw, th)
        if avgpool_grid(plan, b, h, w, c) >= sms:
            break
    return plan


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def avgpool3x3_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int_avgpool3x3`: the int32 sum of each 3×3
    window over a zero border of 1 (nine slice adds), then the truncating
    true division by 9 → int32."""
    b, h, w, c = x.shape
    xp = F.pad(x.to(torch.int32), (0, 0, 1, 1, 1, 1))
    s = None
    for dy in range(3):
        for dx in range(3):
            t = xp[:, dy:dy + h, dx:dx + w]
            s = t if s is None else s + t
    q = torch.trunc(qops.exact_div(s.to(torch.float32), 9.0) + 0.01)
    return q.to(torch.int32)


def avgpool3x3_requant_plain(x: torch.Tensor, mult: torch.Tensor,
                             out_bits: int, signed: bool, *,
                             in_mult: Optional[torch.Tensor] = None,
                             in_bits: Optional[int] = None,
                             in_signed: Optional[bool] = None
                             ) -> torch.Tensor:
    """Plain version of :func:`int_avgpool3x3_requant`: given ``in_mult``,
    ``requant_int32`` to ``in_bits`` first; :func:`avgpool3x3_plain`, then
    ``requant_int32`` to int8."""
    if in_mult is not None:
        x = qops.requant_int32(x, in_mult, in_bits, in_signed, torch.int32)
    return qops.requant_int32(avgpool3x3_plain(x), mult, out_bits, signed,
                              torch.int8)


_NINTH = torch.tensor(1 / 9, dtype=torch.float32)     # fl(1/9) > 1/9


def pool_quotient(s: torch.Tensor, bounded: bool) -> torch.Tensor:
    """csrc/avgpool.cu ``pool_quotient``: trunc(f32(s) / 9 + 0.01) of int32
    window sums, float32.  ``bounded`` (|s| < 9·2¹⁶): trunc(x / 9) of x =
    s + [s < 0], as the floor of |x|·fl(1/9) with y's sign, written as the
    kernel writes it; else the true division."""
    if bounded:
        y = (s - (s >> 31)).to(torch.float32) * _NINTH
        return torch.copysign(torch.floor(y.abs()), y)
    return torch.trunc(qops.exact_div(s.to(torch.float32), 9.0) + 0.01)


def _clip_floor(f: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """floor(clip(f, lo, hi)) → int32: the kernel clips before the floor
    (integer bounds: the same value as clip(floor(f)))."""
    return torch.floor(torch.clamp(f, lo, hi)).to(torch.int32)


def avgpool_walk_plain(x: torch.Tensor, mult: Optional[torch.Tensor],
                       out_bits: int = 8, signed: bool = True, *,
                       in_mult: Optional[torch.Tensor] = None,
                       in_bits: Optional[int] = None,
                       in_signed: Optional[bool] = None,
                       plan: Optional[AvgPlan] = None) -> torch.Tensor:
    """:func:`avgpool3x3_requant_plain` computed the kernel's way: the tiles
    of ``plan`` (default: :func:`avgpool_plan` for an aligned input), each
    staged with its halo from the zero-bordered input and requantized there
    (every staged element, the halo in each tile that stages it), the
    requant's clip before its floor; per output column the row 3-sums of
    the staged rows and a 3-row window slid down them; the quotient as
    :func:`pool_quotient`; the requant after.  The channel slabs split no
    arithmetic, so every channel of a tile is walked at once.  With
    ``mult`` None (and no ``in_mult``), the quotient form
    :func:`int_avgpool3x3`: the int32 quotients, no requant."""
    b, h, w, c = x.shape
    if plan is None:
        plan = avgpool_plan(b, h, w, c, x.dtype)
    th, tw = plan.th, plan.tw
    tiles_y, tiles_x = -(-h // th), -(-w // tw)
    xp = torch.zeros((b, tiles_y * th + 2, tiles_x * tw + 2, c),
                     dtype=x.dtype)
    xp[:, 1:h + 1, 1:w + 1] = x
    bounded = in_mult is not None or x.dtype != torch.int32
    lo, hi = qops.requant_clip_bounds(out_bits, signed)
    out = torch.empty((b, tiles_y * th, tiles_x * tw, c),
                      dtype=torch.int8 if mult is not None else torch.int32)
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            staged = xp[:, ty * th:ty * th + th + 2, tx * tw:tx * tw + tw + 2]
            if in_mult is not None:
                in_lo, in_hi = qops.requant_clip_bounds(in_bits, in_signed)
                staged = _clip_floor(staged.to(torch.float32) * in_mult
                                     + 0.5, in_lo, in_hi)
            else:
                staged = staged.to(torch.int32)
            rs = (staged[:, :, 0:tw] + staged[:, :, 1:tw + 1]
                  + staged[:, :, 2:tw + 2])          # (b, th + 2, tw, c)
            r1, r2 = rs[:, 0], rs[:, 1]
            for y in range(th):
                r0, r1, r2 = r1, r2, rs[:, y + 2]
                q = pool_quotient(r0 + r1 + r2, bounded)
                out[:, ty * th + y, tx * tw:(tx + 1) * tw] = (
                    q.to(torch.int32) if mult is None else
                    _clip_floor(q * mult + 0.5, lo, hi).to(torch.int8))
    return out[:, :h, :w]


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def call_plan(x: torch.Tensor, plan: Optional[AvgPlan] = None) -> AvgPlan:
    """The plan the wrapper launches for ``x`` on its card: ``plan`` where
    given (it must fit the pointer: :func:`avgpool_form`), else
    :func:`avgpool_plan`'s."""
    from hawq_tpu_torch.kernels.matmul import sm_count
    b, h, w, c = x.shape
    vec, copy = avgpool_form(c, x.dtype, x.data_ptr())
    if plan is None:
        return avgpool_plan(b, h, w, c, x.dtype, vec=vec, copy=copy,
                            sms=sm_count(x.device))
    if plan.vec > vec or (plan.vec == 4 and plan.copy > copy):
        raise ValueError(f'avgpool: {plan} needs channels or a pointer that '
                         f'this input does not have (C {c}: vec {vec}, copy '
                         f'{copy})')
    return AvgPlan(*plan)


def _check_mult(what, mult, c, dev):
    per_channel = mult.numel() != 1
    _build.require(mult, what, torch.float32,
                   (c,) if per_channel else tuple(mult.shape), dev)
    return int(per_channel)


def _avgpool_requant_cuda(x, mult, out_bits, signed, in_mult, in_bits,
                          in_signed, plan) -> torch.Tensor:
    name = 'int_avgpool3x3_requant'
    dev = _build.kernel_device(x)
    if x.dim() != 4 or x.dtype not in _IN_CODES:
        raise ValueError(f'{name}: x must be (B, H, W, C) int32, int16 or '
                         f'int8, got {x.dtype}{tuple(x.shape)}')
    b, h, w, c = x.shape
    _build.require(x, 'x', x.dtype, (b, h, w, c), dev)
    mult_stride = _check_mult('mult', mult, c, dev)
    if out_bits > 8:
        raise ValueError(f'{name}: {out_bits}-bit outputs do not fit int8')
    lo, hi = qops.requant_clip_bounds(out_bits, signed)
    in_stride, in_lo, in_hi = 0, 0, 0
    if in_mult is not None:
        if in_bits > 16:
            raise ValueError(f'{name}: a requant in front to {in_bits} bits; '
                             f'the kernel takes at most 16')
        in_stride = _check_mult('in_mult', in_mult, c, dev)
        in_lo, in_hi = qops.requant_clip_bounds(in_bits, in_signed)
    out = torch.empty((b, h, w, c), dtype=torch.int8, device=dev)
    plan = call_plan(x, AvgPlan(*plan) if plan else None)
    with torch.cuda.device(dev):
        code = _build.lib().hawq_avgpool3x3_requant(
            x.data_ptr(), None if in_mult is None else in_mult.data_ptr(),
            mult.data_ptr(), out.data_ptr(), b, h, w, c, _IN_CODES[x.dtype],
            in_stride, int(in_lo), int(in_hi), mult_stride, int(lo), int(hi),
            *plan, _build.stream_ptr(dev))
    _build.check(code, name)
    _build.count(name)
    return out


def _avgpool_cuda(x, plan) -> torch.Tensor:
    name = 'int_avgpool3x3'
    dev = _build.kernel_device(x)
    if x.dim() != 4 or x.dtype not in _IN_CODES:
        raise ValueError(f'{name}: x must be (B, H, W, C) int32, int16 or '
                         f'int8, got {x.dtype}{tuple(x.shape)}')
    b, h, w, c = x.shape
    _build.require(x, 'x', x.dtype, (b, h, w, c), dev)
    out = torch.empty((b, h, w, c), dtype=torch.int32, device=dev)
    plan = call_plan(x, AvgPlan(*plan) if plan else None)
    with torch.cuda.device(dev):
        code = _build.lib().hawq_avgpool3x3(
            x.data_ptr(), out.data_ptr(), b, h, w, c, _IN_CODES[x.dtype],
            *plan, _build.stream_ptr(dev))
    _build.check(code, name)
    _build.count(name)
    return out


def _avgpool_requant_plain(x, mult, out_bits, signed, in_mult, in_bits,
                           in_signed, plan) -> torch.Tensor:
    if in_mult is None:
        in_bits = in_signed = None
    return avgpool3x3_requant_plain(x, mult, out_bits, signed,
                                    in_mult=in_mult, in_bits=in_bits,
                                    in_signed=in_signed)


OPS = {
    'int_avgpool3x3_requant': _build.define_op(
        'int_avgpool3x3_requant(Tensor x, Tensor mult, int out_bits, '
        'bool signed, Tensor? in_mult, int in_bits, bool in_signed, '
        'int[] plan) -> Tensor',
        _avgpool_requant_plain, _avgpool_requant_cuda,
        lambda x, *_: x.new_empty(x.shape, dtype=torch.int8)),
    'int_avgpool3x3': _build.define_op(
        'int_avgpool3x3(Tensor x, int[] plan) -> Tensor',
        lambda x, plan: avgpool3x3_plain(x), _avgpool_cuda,
        lambda x, plan: x.new_empty(x.shape, dtype=torch.int32))}


def int_avgpool3x3_requant(x: torch.Tensor, mult: torch.Tensor, *,
                           out_bits: int, signed: bool,
                           in_mult: Optional[torch.Tensor] = None,
                           in_bits: Optional[int] = None,
                           in_signed: Optional[bool] = None,
                           plan: Optional[AvgPlan] = None) -> torch.Tensor:
    """(B, H, W, C) int32, int16 or int8 NHWC → the 3×3/s1/p1 integer average
    pool (divisor 9 at the border too), requantized with ``mult`` (a
    float32 scalar or (C,) vector of dyadic multipliers) to ``out_bits``
    ≤ 8 → (B, H, W, C) int8.  With ``in_mult`` (the same kinds), x is
    first requantized to ``in_bits`` ≤ 16 (``in_signed``): the pool
    branch's input requant, fused.  ``plan``: the kernel's tile, where not
    :func:`avgpool_plan`'s (tests and timings)."""
    if in_mult is not None and (in_bits is None or in_signed is None):
        raise ValueError('int_avgpool3x3_requant: in_mult needs in_bits and '
                         'in_signed')
    return OPS['int_avgpool3x3_requant'](
        x, mult, int(out_bits), bool(signed), in_mult,
        _build.opt_int(in_bits), bool(in_signed), _build.opt_ints(plan))


def int_avgpool3x3(x: torch.Tensor, *,
                   plan: Optional[AvgPlan] = None) -> torch.Tensor:
    """(B, H, W, C) int32, int16 or int8 NHWC → the 3×3/s1/p1 integer average
    pool, ``trunc(f32(sum) / 9 + 0.01)`` of each window's sum over a zero
    border (divisor 9 at the border too) → (B, H, W, C) int32, with neither
    requant: A1's quotient form, the same kernel and tile rule as
    :func:`int_avgpool3x3_requant`.  ``plan``: the kernel's tile, where not
    :func:`avgpool_plan`'s (tests and timings)."""
    return OPS['int_avgpool3x3'](x, _build.opt_ints(plan))
