"""Depthwise 3×3 int8 convolution, pad 1, stride 1 or 2 (MobileNetV2's
conv2): D1, a kernel the TPU package does not have.

``hawq_tpu`` runs the depthwise conv as XLA's int8 grouped convolution, or
as nine shifted int32 multiply-adds (``engine_mobilenet.py _dw_shifted``).
CUDA PyTorch has no integer convolution, so on a CUDA tensor each wrapper
launches csrc/depthwise.cu; on a CPU tensor it runs the plain version, the
nine shifted multiply-adds in int32 (:func:`dwconv_acc_plain`,
:func:`dwconv_requant_plain`).

The kernel walks output tiles (:func:`dw_plan` picks them) with the input
rectangle and its halo staged in shared memory; a thread takes 4 channels
(one 32-bit word of a pixel) or one, and P output pixels along a row, and
adds each kernel row's three taps with one ``dp4a`` over channel-transposed
column words.  :func:`dwconv_walk_plain` walks the same tiles, byte
selections and ``dp4a`` groupings in torch integer ops on the CPU.  Both
forms run as the operators ``torch.ops.hawq.<wrapper name>`` (:data:`OPS`;
``_build.define_op``), the plan as six ints, or none for the rule's, chosen
at launch from the pointers.

Layouts are the frozen model's: x (B, H, W, C) int8 NHWC, w (3, 3, 1, C)
int8 HWIO, bias (C,) int32; the output is (B, ⌊(H−1)/s⌋+1, ⌊(W−1)/s⌋+1, C).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hawq_tpu_torch.kernels import _build
from hawq_tpu_torch.quant.ops import round_half_up

DW_THREADS = 256      # the most threads a block of the kernel takes
DW_SLAB = 32          # the most channel units a block takes
DW_SMS = 132          # the H100's SMs: the grid the rule aims to fill
DW_MIN_ROWS = 4       # output rows a block keeps room for along the width


class DwPlan(NamedTuple):
    """How the kernel walks one call (csrc/depthwise.cu ``Tile``)."""
    vec: int     # channels a thread: 4 (one word of a pixel) or 1
    copy: int    # bytes a staging copy moves: 16 or 4 (vec 4), 1 (vec 1)
    p: int       # output pixels a thread, along a row
    cs: int      # channel units (vec channels each) a block
    ng: int      # groups of p output pixels a block, along a row
    rows: int    # output rows a block


def dw_output_hw(h: int, w: int, stride: int):
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def dw_form(c: int, x_ptr: int, w_ptr: int, out_ptr: int):
    """(vec, copy) of a call: 4 channels a thread where C % 4 and x, w 4-byte
    and out 16-byte aligned, with 16-byte staging copies where also C % 16
    and x 16-byte aligned; else one channel a thread."""
    if c % 4 or x_ptr % 4 or w_ptr % 4 or out_ptr % 16:
        return 1, 1
    return 4, 16 if c % 16 == 0 and x_ptr % 16 == 0 else 4


def _split(n: int, most: int) -> int:
    """The even share of ``n`` in ceil(n / most) parts."""
    parts = -(-n // max(1, most))
    return -(-n // parts)


def dw_grid(plan: DwPlan, b: int, h: int, w: int, c: int,
            stride: int) -> int:
    """Blocks the kernel launches for ``plan``."""
    oh, ow = dw_output_hw(h, w, stride)
    return (b * -(-oh // plan.rows) * -(-ow // (plan.ng * plan.p))
            * (c // plan.vec // plan.cs))


def dw_plan(b: int, h: int, w: int, c: int, stride: int, *, vec: int = 4,
            copy: int = 16, sms: int = DW_SMS) -> DwPlan:
    """The tile of one call.  The channel slab is the largest divisor of
    the C / vec channel units up to :data:`DW_SLAB` (a multiple of 4 for
    16-byte copies).  Along a row, groups of p pixels up to what leaves a
    256-thread block room for :data:`DW_MIN_ROWS` rows, split evenly; then
    as many rows as the block holds, split evenly.  p = 4 first, with fewer
    rows while the grid has fewer blocks than the card has SMs; then p = 2.
    One channel a thread reads its rows as words of 4 columns, so there
    s·p = 4."""
    oh, ow = dw_output_hw(h, w, stride)
    units = c // vec
    mult = 4 if copy == 16 else 1
    cs = max(d for d in range(1, min(units, DW_SLAB) + 1)
             if units % d == 0 and d % mult == 0)
    plan = None
    for p in ((4, 2) if vec == 4 else (4 // stride,)):
        groups = -(-ow // p)
        ng = _split(groups, DW_THREADS // (cs * min(oh, DW_MIN_ROWS)))
        most = min(oh, DW_THREADS // (cs * ng))
        while True:
            plan = DwPlan(vec, copy, p, cs, ng, _split(oh, most))
            if dw_grid(plan, b, h, w, c, stride) >= sms or plan.rows == 1:
                break
            most = plan.rows - 1
        if dw_grid(plan, b, h, w, c, stride) >= sms:
            break
    return plan


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def dwconv_acc_plain(x8: torch.Tensor, w8: torch.Tensor, bias: torch.Tensor,
                     stride: int) -> torch.Tensor:
    """Plain version of :func:`int8_dwconv_acc`: nine shifted int32
    multiply-adds over the zero-padded input, plus the bias."""
    b, h, w, c = x8.shape
    oh, ow = dw_output_hw(h, w, stride)
    xp = torch.nn.functional.pad(x8.to(torch.int32), (0, 0, 1, 1, 1, 1))
    taps = w8.to(torch.int32).reshape(3, 3, c)
    acc = bias.to(torch.int32).expand(b, oh, ow, c).clone()
    for dy in range(3):
        for dx in range(3):
            acc += xp[:, dy:dy + stride * (oh - 1) + 1:stride,
                      dx:dx + stride * (ow - 1) + 1:stride, :] * taps[dy, dx]
    return acc


def _relu6_requant(acc, hi6, mult, lo, hi):
    acc = torch.minimum(torch.clamp_min(acc, 0), hi6)
    out = round_half_up(acc.to(torch.float32) * mult)
    return torch.clamp(out, lo, hi).to(torch.int8)


def dwconv_requant_plain(x8: torch.Tensor, w8: torch.Tensor,
                         bias: torch.Tensor, hi6: torch.Tensor,
                         mult: torch.Tensor, stride: int, lo: float,
                         hi: float) -> torch.Tensor:
    """Plain version of :func:`int8_dwconv_requant`: the accumulator
    clamped to [0, hi6], then clip(floor(f32(acc)·mult + 0.5), lo, hi)."""
    return _relu6_requant(dwconv_acc_plain(x8, w8, bias, stride), hi6, mult,
                          lo, hi)


def _byte(v: torch.Tensor, i: int) -> torch.Tensor:
    return (v >> (8 * i)) & 0xFF


def _word(byte_list):
    """Bytes (0..255, int64) → the little-endian 32-bit word, int64."""
    out = torch.zeros_like(byte_list[0])
    for i, v in enumerate(byte_list):
        out = out | (v << (8 * i))
    return out


def prmt(a: torch.Tensor, b: torch.Tensor, sel: int) -> torch.Tensor:
    """PTX ``prmt.b32`` (``__byte_perm``) on int64-held 32-bit words: byte i
    of the result is byte (sel >> 4i) & 7 of the 8-byte run (a, b)."""
    src = [_byte(a, i) for i in range(4)] + [_byte(b, i) for i in range(4)]
    return _word([src[(sel >> (4 * i)) & 7] for i in range(4)])


def dp4a(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``__dp4a`` signed: c + Σ_i s8(byte i of a)·s8(byte i of b)."""
    for i in range(4):
        c = c + (((_byte(a, i) ^ 0x80) - 0x80)
                 * ((_byte(b, i) ^ 0x80) - 0x80))
    return c


def transpose4(a0, a1, a2, a3):
    """csrc/depthwise.cu ``transpose4``: byte j of a_i → byte i of t_j."""
    p0, p1 = prmt(a0, a1, 0x5140), prmt(a0, a1, 0x7362)
    q0, q1 = prmt(a2, a3, 0x5140), prmt(a2, a3, 0x7362)
    return [prmt(p0, q0, 0x5410), prmt(p0, q0, 0x7632),
            prmt(p1, q1, 0x5410), prmt(p1, q1, 0x7632)]


def _taps(lo, hi, r):
    """Bytes r .. r + 3 of (lo, hi): a pixel's three taps and one byte whose
    weight is 0 (csrc/depthwise.cu ``taps_at``)."""
    if r == 0:
        return lo
    return prmt(lo, hi, r | (r + 1) << 4 | (r + 2) << 8 | (r + 3) << 12)


def dwconv_walk_plain(x8: torch.Tensor, w8: torch.Tensor, bias: torch.Tensor,
                      stride: int, plan: Optional[DwPlan] = None, *,
                      hi6: Optional[torch.Tensor] = None,
                      mult: Optional[torch.Tensor] = None,
                      lo: float = -128, hi: float = 127) -> torch.Tensor:
    """:func:`dwconv_acc_plain` (or, given ``hi6`` and ``mult``,
    :func:`dwconv_requant_plain`) computed the kernel's way: the tiles of
    ``plan`` (default: :func:`dw_plan` for CPU tensors' alignment), each
    staged with its halo from the zero-bordered input; per thread and
    kernel row the 4G column words of its channel unit (vec 4: pixel words
    transposed with ``prmt``; vec 1: the channel's bytes packed as they
    lie), each pixel's taps a funnel ``prmt`` and one ``dp4a`` against the
    row's weight word (w0, w1, w2, 0)."""
    b, h, w, c = x8.shape
    s = stride
    oh, ow = dw_output_hw(h, w, s)
    if plan is None:
        plan = dw_plan(b, h, w, c, s, **dict(zip(('vec', 'copy'),
                                                 dw_form(c, 0, 0, 0))))
    v, p, cs, ng, rows = plan.vec, plan.p, plan.cs, plan.ng, plan.rows
    g_words = (s * (p - 1) + 6) // 4
    sp = s * p
    rows_in, cols_in = s * (rows - 1) + 3, sp * (ng - 1) + 4 * g_words
    tiles_y, tiles_x = -(-oh // rows), -(-ow // (ng * p))
    xp = torch.zeros((b, tiles_y * rows * s + rows_in,
                      tiles_x * ng * sp + cols_in, c), dtype=torch.int64)
    xp[:, 1:h + 1, 1:w + 1] = x8.to(torch.int64) & 0xFF
    wb = w8.to(torch.int64).reshape(3, 3, c) & 0xFF
    acc_out = torch.empty((b, tiles_y * rows, tiles_x * ng * p, c),
                          dtype=torch.int64)
    r_idx = torch.arange(rows)
    # column of (group, word k, byte i) in the staged tile
    cols = (torch.arange(ng)[:, None, None] * sp
            + 4 * torch.arange(g_words)[None, :, None]
            + torch.arange(4)[None, None, :])
    for slab in range(c // v // cs):
        ch = slice(slab * cs * v, (slab + 1) * cs * v)
        if v == 4:                        # (3, 3, cs) words of 4 channels
            taps = _word([wb[:, :, ch][..., i::4] for i in range(4)])
            zero = torch.zeros_like(taps[0, 0])
            wr = [torch.stack(t) for t in zip(*(
                transpose4(taps[dy, 0], taps[dy, 1], taps[dy, 2], zero)
                for dy in range(3)))]     # wr[e]: (3, cs)
        else:
            wr = [_word([wb[:, 0, ch], wb[:, 1, ch], wb[:, 2, ch]])]
        bias_u = bias[ch].to(torch.int64).reshape(cs, v)
        for ty in range(tiles_y):
            for tx in range(tiles_x):
                tile = xp[:, ty * rows * s:ty * rows * s + rows_in,
                          tx * ng * sp:tx * ng * sp + cols_in, ch]
                if v == 4:                # (b, rows_in, cols_in, cs) words
                    words = _word([tile[..., i::4] for i in range(4)])
                # acc (b, rows, ng, p, cs, v)
                acc = bias_u.expand(b, rows, ng, p, cs, v).clone()
                for dy in range(3):
                    ry = s * r_idx + dy
                    if v == 4:
                        # a: (b, rows, ng, G, 4 columns, cs) pixel words
                        a = words[:, ry][:, :, cols]
                        t = transpose4(*(a[..., i, :] for i in range(4)))
                    else:
                        by = tile[:, ry][:, :, cols]   # (b, r, ng, G, 4, cs)
                        t = [_word([by[..., i, :] for i in range(4)])]
                    for j in range(p):
                        o = s * j
                        k, r = o >> 2, o & 3
                        for e in range(v):
                            lo_w = t[e][..., k, :]
                            hi_w = (t[e][..., k + 1, :] if k + 1 < g_words
                                    else torch.zeros_like(lo_w))
                            acc[:, :, :, j, :, e] = dp4a(
                                _taps(lo_w, hi_w, r), wr[e][dy],
                                acc[:, :, :, j, :, e])
                acc_out[:, ty * rows:(ty + 1) * rows,
                        tx * ng * p:(tx + 1) * ng * p, ch] = acc.reshape(
                    b, rows, ng * p, cs * v)
    acc = acc_out[:, :oh, :ow].to(torch.int32)
    if hi6 is None:
        return acc
    return _relu6_requant(acc, hi6, mult, lo, hi)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, x8, w8, bias, stride, dev):
    if x8.dim() != 4:
        raise ValueError(f'{name}: x must be (B, H, W, C), got '
                         f'{tuple(x8.shape)}')
    if stride not in (1, 2):
        raise ValueError(f'{name}: stride {stride}, expected 1 or 2')
    c = x8.shape[3]
    _build.require(x8, 'x8', torch.int8, tuple(x8.shape), dev)
    _build.require(w8, 'w8', torch.int8, (3, 3, 1, c), dev)
    _build.require(bias, 'bias', torch.int32, (c,), dev)
    return c


def call_plan(x8: torch.Tensor, w8: torch.Tensor, out: torch.Tensor,
              stride: int, plan: Optional[DwPlan] = None) -> DwPlan:
    """The plan a wrapper launches for these tensors on their card: ``plan``
    where given (it must fit the pointers: :func:`dw_form`), else
    :func:`dw_plan`'s."""
    from hawq_tpu_torch.kernels.matmul import sm_count
    b, h, w, c = x8.shape
    vec, copy = dw_form(c, x8.data_ptr(), w8.data_ptr(), out.data_ptr())
    if plan is None:
        return dw_plan(b, h, w, c, stride, vec=vec, copy=copy,
                       sms=sm_count(x8.device))
    if plan.vec > vec or plan.copy > copy:
        raise ValueError(f'depthwise: {plan} needs channels or pointers '
                         f'that these tensors do not have (C {c}: vec '
                         f'{vec}, copy {copy})')
    return DwPlan(*plan)


def _dwconv_acc_cuda(x8, w8, bias, stride, plan) -> torch.Tensor:
    name = 'int8_dwconv_acc'
    dev = _build.kernel_device(x8)
    c = _check(name, x8, w8, bias, stride, dev)
    b, h, w, _ = x8.shape
    out = torch.empty((b, *dw_output_hw(h, w, stride), c), dtype=torch.int32,
                      device=dev)
    plan = call_plan(x8, w8, out, stride, DwPlan(*plan) if plan else None)
    with torch.cuda.device(dev):
        code = _build.lib().hawq_dwconv_acc(
            x8.data_ptr(), w8.data_ptr(), bias.data_ptr(), out.data_ptr(), b,
            h, w, c, stride, *plan, _build.stream_ptr(dev))
    _build.check(code, name)
    _build.count(name)
    return out


def _dwconv_requant_cuda(x8, w8, bias, hi6, mult, stride, lo, hi,
                         plan) -> torch.Tensor:
    name = 'int8_dwconv_requant'
    dev = _build.kernel_device(x8)
    c = _check(name, x8, w8, bias, stride, dev)
    _build.require(hi6, 'hi6', torch.int32, (c,), dev)
    _build.require(mult, 'mult', torch.float32, (c,), dev)
    if lo < -128 or hi > 127 or lo > hi:
        raise ValueError(f'{name}: bounds [{lo}, {hi}] do not fit int8')
    b, h, w, _ = x8.shape
    out = torch.empty((b, *dw_output_hw(h, w, stride), c), dtype=torch.int8,
                      device=dev)
    plan = call_plan(x8, w8, out, stride, DwPlan(*plan) if plan else None)
    with torch.cuda.device(dev):
        code = _build.lib().hawq_dwconv_requant(
            x8.data_ptr(), w8.data_ptr(), bias.data_ptr(), hi6.data_ptr(),
            mult.data_ptr(), out.data_ptr(), b, h, w, c, stride, int(lo),
            int(hi), *plan, _build.stream_ptr(dev))
    _build.check(code, name)
    _build.count(name)
    return out


def _dw_out(x8: torch.Tensor, stride: int, dtype: torch.dtype):
    b, h, w, c = x8.shape
    return x8.new_empty((b, *dw_output_hw(h, w, stride), c), dtype=dtype)


OPS = {
    'int8_dwconv_acc': _build.define_op(
        'int8_dwconv_acc(Tensor x8, Tensor w8, Tensor bias, int stride, '
        'int[] plan) -> Tensor',
        lambda x8, w8, bias, stride, plan: dwconv_acc_plain(x8, w8, bias,
                                                            stride),
        _dwconv_acc_cuda,
        lambda x8, w8, bias, stride, plan: _dw_out(x8, stride, torch.int32)),
    'int8_dwconv_requant': _build.define_op(
        'int8_dwconv_requant(Tensor x8, Tensor w8, Tensor bias, Tensor hi6, '
        'Tensor mult, int stride, float lo, float hi, int[] plan) -> Tensor',
        lambda x8, w8, bias, hi6, mult, stride, lo, hi, plan:
        dwconv_requant_plain(x8, w8, bias, hi6, mult, stride, lo, hi),
        _dwconv_requant_cuda,
        lambda x8, w8, bias, hi6, mult, stride, lo, hi, plan:
        _dw_out(x8, stride, torch.int8))}


def int8_dwconv_acc(x8: torch.Tensor, w8: torch.Tensor, bias: torch.Tensor,
                    *, stride: int,
                    plan: Optional[DwPlan] = None) -> torch.Tensor:
    """Depthwise 3×3 conv, pad 1, → int32 accumulator + bias (the QAT
    forward's grouped conv).  ``plan``: the kernel's tile, where not
    :func:`dw_plan`'s (tests and timings)."""
    return OPS['int8_dwconv_acc'](x8, w8, bias, int(stride),
                                  _build.opt_ints(plan))


def int8_dwconv_requant(x8: torch.Tensor, w8: torch.Tensor,
                        bias: torch.Tensor, hi6: torch.Tensor,
                        mult: torch.Tensor, *, stride: int, lo: float,
                        hi: float,
                        plan: Optional[DwPlan] = None) -> torch.Tensor:
    """The accumulator of :func:`int8_dwconv_acc` clamped to [0, hi6[c]]
    (ReLU6 on the integer side; hi6 (C,) int32) and requantized to int8 with
    mult (C,) float32: clip(floor(f32(acc)·mult + 0.5), lo, hi)."""
    return OPS['int8_dwconv_requant'](x8, w8, bias, hi6, mult, int(stride),
                                      float(lo), float(hi),
                                      _build.opt_ints(plan))
