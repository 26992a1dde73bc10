"""The engines' native requant as one kernel, and the same requant of a
unit's branches straight into their concatenation: kernels the TPU package
does not have (XLA fuses ``quant/ops.py requant_int32``'s six elementwise
ops into one loop there).

:func:`requant_int32`: an int8, int16 or int32 tensor (last axis C) →
``clip(floor(f32(x) · mult + 0.5), lo, hi)`` as int8, int16 or int32, with a
float32 scalar or (C,) dyadic multiplier; ``relu`` sets lo = 0, the ReLU in
front of the requant (monotone, 0 → 0, so it takes the ReLU in).
:func:`requant_concat`: 1 to :data:`RQ_MAX_PIECES` pieces with equal leading
shapes, each with its own multiplier and all to one bit width → the
concatenation of their requants on the last axis.

On a CUDA tensor each wrapper makes one launch of csrc/requant.cu, which
writes each piece into its slice of the output (row stride the concat's
width, offset the piece's first channel); on a CPU tensor it runs the
plain version, :func:`requant_plain` (``quant.ops.requant_int32``, then the
ReLU) and the requant of each piece, then ``torch.cat``.  :func:`rq_plan`
is how the kernel walks a call (16-byte vectors where the pointers and C
allow, one element a step otherwise); :func:`requant_walk_plain` walks it
the same way on the CPU.  Both run as the operators ``torch.ops.hawq.<wrapper
name>`` (:data:`OPS`; ``_build.define_op``), the output dtype as an int
code; each launch counts once in ``_build.LAUNCHES`` under its wrapper's
name.
"""

from __future__ import annotations

import functools
import struct
from typing import List, NamedTuple, Sequence, Tuple

import torch

from hawq_tpu_torch.kernels import _build
from hawq_tpu_torch.kernels.matmul import sm_count
from hawq_tpu_torch.quant import ops as qops

_CODES = {torch.int8: 0, torch.int16: 1, torch.int32: 2}
_DTYPES = {v: k for k, v in _CODES.items()}
RQ_THREADS = 256          # a block's threads (csrc/requant.cu THREADS)
RQ_BLOCKS_PER_SM = 8      # the grid: at most this many blocks a SM
RQ_MAX_PIECES = 8         # pieces a launch (csrc/requant.cu MAX_PIECES)
_INT32_MAX = 2 ** 31 - 1
_DESC = struct.Struct('8q')   # a piece's descriptor (csrc/requant.cu)


class RqPlan(NamedTuple):
    """How the kernel walks one launch: ``vec`` elements a step (16 bytes
    on the narrowest side, or 1); for each piece ``nvec`` whole steps, then
    ``tail`` elements one a thread."""
    vec: int
    nvec: Tuple[int, ...]
    tail: Tuple[int, ...]


def rq_plan(pieces: Sequence[Sequence[int]], ld: int,
            out_size: int) -> RqPlan:
    """The kernel's walk of ``pieces``, each (elements, C, element size,
    per-channel multiplier, input address, output address at its slice,
    multiplier address, ...), in rows of C written ``ld`` apart into
    ``out_size``-byte elements.  The vector form takes 16 bytes of the
    narrowest side a step; it needs every piece's pointers 16-byte aligned
    (the multiplier's only where it is per channel) and, where a vector's
    channel or row matters, C a multiple of the vector and rows that stay
    aligned; else the whole launch takes one element a step."""
    v = 16 // min(out_size, *[p[2] for p in pieces])
    rows_ok = ld * out_size % 16 == 0
    for numel, c, _, pc, x_ptr, out_ptr, mult_ptr, *_ in pieces:
        if ((x_ptr | out_ptr) % 16 or (pc and mult_ptr % 16)
                or ((pc or ld != c) and (c % v or not rows_ok))):
            return RqPlan(1, tuple([p[0] for p in pieces]),
                          (0,) * len(pieces))
    return RqPlan(v, tuple([p[0] // v for p in pieces]),
                  tuple([p[0] % v for p in pieces]))


def rq_grid(plan: RqPlan, sms: int) -> int:
    """Blocks of the grid: enough for one step of every thread, at most
    :data:`RQ_BLOCKS_PER_SM` a SM (the rest stride); at least one, which
    also takes the tails."""
    need = -(-sum(plan.nvec) // RQ_THREADS)
    return max(1, min(need, sms * RQ_BLOCKS_PER_SM))


def requant_plain(x: torch.Tensor, mult: torch.Tensor, out_bits: int,
                  signed: bool, relu: bool,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of :func:`requant_int32`: ``quant.ops.requant_int32``,
    then the ReLU."""
    y = qops.requant_int32(x, mult, out_bits, signed, out_dtype)
    return torch.clamp_min(y, 0) if relu else y


def requant_concat_plain(pieces: Sequence[torch.Tensor],
                         mults: Sequence[torch.Tensor], out_bits: int,
                         signed: bool,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of :func:`requant_concat`: each piece's requant, then
    ``torch.cat`` on the last axis."""
    return torch.cat([qops.requant_int32(p, m, out_bits, signed, out_dtype)
                      for p, m in zip(pieces, mults)], dim=-1)


def requant_walk_plain(pieces: Sequence[torch.Tensor],
                       mults: Sequence[torch.Tensor], out: torch.Tensor,
                       lo: float, hi: float, plan: RqPlan) -> torch.Tensor:
    """:func:`requant_concat_plain`'s values written the kernel's way into
    ``out`` (rows of its last axis, the pieces' slices in order): the
    pieces' ``plan.nvec`` steps of ``plan.vec`` elements laid end to end,
    each step's piece found from the running starts, its channel its
    offset modulo C and its output row the offset over C (the output at
    the offset itself where neither matters), then each piece's tail one
    element at a time.  Returns ``out``."""
    ld, of = out.shape[-1], out.view(-1)
    cs = [p.shape[-1] for p in pieces]
    off = torch.tensor([0] + cs[:-1]).cumsum(0)
    c = torch.tensor(cs)
    pc = torch.tensor([m.numel() != 1 for m in mults])
    xs = torch.cat([p.reshape(-1).to(torch.int64) for p in pieces])
    xbase = torch.tensor([0] + [p.numel() for p in pieces[:-1]]).cumsum(0)
    ms = torch.cat([m.reshape(-1) for m in mults])
    mbase = torch.tensor([0] + [m.numel() for m in mults[:-1]]).cumsum(0)

    def write(k, i, lane, whole):
        row = i // c[k]
        ch = i - row * c[k]
        dst = torch.where(whole, i, row * ld + off[k] + ch) + lane
        mi = ms[mbase[k] + torch.where(pc[k], ch + lane, 0)]
        of[dst] = torch.clamp(qops.round_half_up(
            xs[xbase[k] + i + lane].to(torch.float32) * mi), lo,
            hi).to(out.dtype)

    v = plan.vec
    starts = torch.tensor((0,) + plan.nvec).cumsum(0)
    steps = torch.arange(int(starts[-1]))
    k = torch.searchsorted(starts[1:], steps, right=True)
    i = (steps - starts[k]) * v
    whole = ~pc[k] & (c[k] == ld)            # no channel, no row
    lanes = torch.arange(v)
    write(k[:, None].expand(-1, v), i[:, None].expand(-1, v), lanes,
          whole[:, None].expand(-1, v))
    for q, (n, t) in enumerate(zip(plan.nvec, plan.tail)):
        i = torch.arange(n * v, n * v + t)
        k = torch.full_like(i, q)
        write(k, i, 0, torch.zeros_like(i, dtype=torch.bool))
    return out


@functools.lru_cache(maxsize=None)
def _bounds(name: str, out_bits: int, signed: bool, relu: bool,
            out_dtype: torch.dtype):
    """The clip bounds [lo, hi] of a call; raises for an output dtype or
    a bit width the kernel does not take."""
    if out_dtype not in _CODES:
        raise ValueError(f'{name}: out_dtype {out_dtype} must be int8, int16 '
                         f'or int32')
    if not 1 <= out_bits <= 16:
        raise ValueError(f'{name}: out_bits {out_bits} not in 1..16')
    lo, hi = qops.requant_clip_bounds(out_bits, signed)
    info = torch.iinfo(out_dtype)
    if lo < info.min or hi > info.max:
        raise ValueError(f'{name}: {out_bits}-bit values do not fit '
                         f'{out_dtype}')
    return (max(lo, 0.0) if relu else lo), hi


def _launch(name: str, pieces, mults, out: torch.Tensor, lo: float,
            hi: float, dev: torch.device) -> None:
    """One launch: each piece's requant into its slice of ``out``; a piece's
    record (:func:`rq_plan`) also carries its dtype code and first output
    channel, which its descriptor passes on."""
    ld, esize = out.shape[-1], out.element_size()
    if out.numel() > _INT32_MAX:
        raise ValueError(f'{name}: {out.numel()} elements; the kernel takes '
                         f'fewer than 2^31')
    if out.numel() == 0:
        return
    base, recs, off = out.data_ptr(), [], 0
    for x, mult in zip(pieces, mults):
        code = _CODES.get(x.dtype)
        if code is None or x.dim() < 1:
            raise ValueError(f'{name}: x must be int8, int16 or int32 with '
                             f'a channel axis, got {x.dtype}{tuple(x.shape)}')
        _build.require(x, 'x', x.dtype, x.shape, dev)
        c = x.shape[-1]
        pc = mult.numel() != 1
        _build.require(mult, 'mult', torch.float32,
                       (c,) if pc else mult.shape, dev)
        recs.append((x.numel(), c, x.element_size(), pc, x.data_ptr(),
                     base + off * esize, mult.data_ptr(), code, off))
        off += c
    plan = rq_plan(recs, ld, esize)
    desc = b''.join([_DESC.pack(x_ptr, m_ptr, numel, nvec, c, o, code, pc)
                     for (numel, c, _, pc, x_ptr, _, m_ptr, code, o), nvec
                     in zip(recs, plan.nvec)])
    with torch.cuda.device(dev):
        code = _build.lib().hawq_requant(
            desc, len(recs), base, ld, _CODES[out.dtype], plan.vec,
            int(lo), int(hi), rq_grid(plan, sm_count(dev)),
            _build.stream_ptr(dev))
    _build.check(code, name)
    _build.count(name)


def _requant_cuda(x, mult, out_bits, signed, relu, out_code) -> torch.Tensor:
    name = 'requant_int32'
    dev = _build.kernel_device(x)
    out_dtype = _DTYPES[out_code]
    lo, hi = _bounds(name, out_bits, signed, relu, out_dtype)
    out = torch.empty(x.shape, dtype=out_dtype, device=dev)
    _launch(name, (x,), (mult,), out, lo, hi, dev)
    return out


def _concat_shape(pieces: Sequence[torch.Tensor]):
    lead = tuple(pieces[0].shape[:-1])
    if any(tuple(p.shape[:-1]) != lead for p in pieces):
        raise ValueError(f'requant_concat: pieces of shapes '
                         f'{[tuple(p.shape) for p in pieces]} differ before '
                         f'the last axis')
    return lead + (sum(p.shape[-1] for p in pieces),)


def _requant_concat_cuda(pieces, mults, out_bits, signed,
                         out_code) -> torch.Tensor:
    name = 'requant_concat'
    dev = _build.kernel_device(pieces[0])
    out_dtype = _DTYPES[out_code]
    lo, hi = _bounds(name, out_bits, signed, False, out_dtype)
    out = torch.empty(_concat_shape(pieces), dtype=out_dtype, device=dev)
    _launch(name, pieces, mults, out, lo, hi, dev)
    return out


OPS = {
    'requant_int32': _build.define_op(
        'requant_int32(Tensor x, Tensor mult, int out_bits, bool signed, '
        'bool relu, int out_code) -> Tensor',
        lambda x, mult, out_bits, signed, relu, out_code: requant_plain(
            x, mult, out_bits, signed, relu, _DTYPES[out_code]),
        _requant_cuda,
        lambda x, mult, out_bits, signed, relu, out_code: x.new_empty(
            x.shape, dtype=_DTYPES[out_code])),
    'requant_concat': _build.define_op(
        'requant_concat(Tensor[] pieces, Tensor[] mults, int out_bits, '
        'bool signed, int out_code) -> Tensor',
        lambda pieces, mults, out_bits, signed, out_code:
        requant_concat_plain(pieces, mults, out_bits, signed,
                             _DTYPES[out_code]),
        _requant_concat_cuda,
        lambda pieces, mults, out_bits, signed, out_code: pieces[0].new_empty(
            _concat_shape(pieces), dtype=_DTYPES[out_code]))}


def requant_int32(x: torch.Tensor, mult: torch.Tensor, *, out_bits: int,
                  signed: bool, relu: bool = False,
                  out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """int8 / int16 / int32 ``x`` (last axis C) → ``clip(floor(f32(x) · mult
    + 0.5), lo, hi)`` in ``out_dtype`` (int8, int16 or int32), [lo, hi]
    the ``out_bits`` range (1–16 bits; ``signed``), lo = 0 with ``relu``:
    ``quant.ops.requant_int32`` bit for bit, with the ReLU in front.
    ``mult``: float32, one value or (C,), on x's device."""
    _bounds('requant_int32', out_bits, signed, relu, out_dtype)
    return OPS['requant_int32'](x, mult, int(out_bits), bool(signed),
                                bool(relu), _CODES[out_dtype])


def requant_concat(pieces: Sequence[torch.Tensor],
                   mults: Sequence[torch.Tensor], *, out_bits: int,
                   signed: bool,
                   out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """1 to :data:`RQ_MAX_PIECES` pieces (int8 / int16 / int32, equal shapes
    but the last axis) → the concatenation on the last axis of each piece's
    :func:`requant_int32` with its own multiplier (one value or one per
    channel of the piece), all to ``out_bits`` (``signed``) in
    ``out_dtype``."""
    pieces: List[torch.Tensor] = list(pieces)
    mults: List[torch.Tensor] = list(mults)
    if not 1 <= len(pieces) <= RQ_MAX_PIECES or len(pieces) != len(mults):
        raise ValueError(f'requant_concat: {len(pieces)} pieces and '
                         f'{len(mults)} multipliers (1 to {RQ_MAX_PIECES} '
                         f'pieces)')
    _bounds('requant_concat', out_bits, signed, False, out_dtype)
    return OPS['requant_concat'](pieces, mults, int(out_bits), bool(signed),
                                 _CODES[out_dtype])
