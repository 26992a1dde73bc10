"""3×3/s2/p1 max-pool on the fold4 layout (port of hawq_tpu/kernels/pool.py
``maxpool_folded``), and the same pool with the init conv's requant and
ReLU in front (``maxpool_folded_requant``, the engine's folded init).

On a CUDA tensor each wrapper launches csrc/pool.cu; on a CPU tensor it
runs the plain version: ``inference.fold.maxpool_3x3s2p1_folded``, and
:func:`maxpool_folded_requant_plain` (requant, ReLU, then that pool).  The
kernel walks runs of :data:`POOL_RUN` output columns per thread, each
thread on one 16-byte vector of channels where the shape and pointers allow,
one channel otherwise; :func:`maxpool_folded_walk_plain` walks the same way
on the CPU.  Both run as the operators ``torch.ops.hawq.<wrapper name>``
(:data:`OPS`; ``_build.define_op``), the output dtype as an int code.
"""

from __future__ import annotations

import torch

from hawq_tpu_torch.inference.fold import maxpool_3x3s2p1_folded
from hawq_tpu_torch.kernels import _build
from hawq_tpu_torch.quant.ops import requant_clip_bounds, requant_int32

_DTYPE_CODES = {torch.int16: 0, torch.int32: 1, torch.float32: 2}
_OUT_CODES = {torch.int16: 0, torch.int32: 1}
_OUT_DTYPES = {v: k for k, v in _OUT_CODES.items()}
POOL_RUN = 4      # output columns one thread walks (csrc/pool.cu RUN)


def maxpool_folded_requant_plain(acc: torch.Tensor, mult: torch.Tensor,
                                 out_bits: int, signed: bool, relu: bool,
                                 out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of :func:`maxpool_folded_requant`: the engine's folded
    init sequence — requant, ReLU, then the folded pool."""
    x = requant_int32(acc, mult, out_bits, signed, out_dtype)
    if relu:
        x = torch.clamp_min(x, 0)
    return maxpool_3x3s2p1_folded(x)


def maxpool_folded_walk_plain(xf: torch.Tensor,
                              run: int = POOL_RUN) -> torch.Tensor:
    """:func:`maxpool_3x3s2p1_folded` computed the kernel's way: the row max
    rm_px(i, j) = max(x[i, j, 0, px], x[i, j, 1, px], x[i-1, j, 1, px])
    (row −1 left out by a predicate), then along each row runs of ``run``
    columns, each starting from rm_1 of the column before it and carrying
    rm_1(j) on as the "left" term of column j + 1."""
    b, hq, wq, n4 = xf.shape
    x = xf.reshape(b, hq, wq, 2, 2, n4 // 4)            # (py, px, n)
    rm = torch.maximum(x[:, :, :, 0], x[:, :, :, 1])     # (b, hq, wq, px, n)
    rm[:, 1:] = torch.maximum(rm[:, 1:], x[:, :-1, :, 1])
    out = torch.empty((b, hq, wq, n4 // 4), dtype=xf.dtype)
    for j0 in range(0, wq, run):
        left = rm[:, :, j0 - 1, 1] if j0 > 0 else None
        for j in range(j0, min(j0 + run, wq)):
            m = torch.maximum(rm[:, :, j, 0], rm[:, :, j, 1])
            out[:, :, j] = m if left is None else torch.maximum(m, left)
            left = rm[:, :, j, 1]
    return out


def _maxpool_folded_cuda(xf: torch.Tensor) -> torch.Tensor:
    dev = _build.kernel_device(xf)
    b, hq, wq, n4 = xf.shape
    if n4 % 4 or xf.dtype not in _DTYPE_CODES:
        raise ValueError(f'maxpool_folded: channels {n4} must be a multiple '
                         f'of 4 and dtype {xf.dtype} one of int16, int32, '
                         f'float32')
    _build.require(xf, 'xf', xf.dtype, (b, hq, wq, n4), dev)
    n = n4 // 4
    vec = int(n * xf.element_size() % 16 == 0 and xf.data_ptr() % 16 == 0)
    out = torch.empty((b, hq, wq, n), dtype=xf.dtype, device=dev)
    with torch.cuda.device(dev):
        code = _build.lib().hawq_maxpool_folded(
            xf.data_ptr(), out.data_ptr(), b, hq, wq, n,
            _DTYPE_CODES[xf.dtype], vec, _build.stream_ptr(dev))
    _build.check(code, 'maxpool_folded')
    _build.count('maxpool_folded')
    return out


def _maxpool_folded_requant_cuda(acc, mult, out_bits, signed, relu,
                                 out_code) -> torch.Tensor:
    name = 'maxpool_folded_requant'
    out_dtype = _OUT_DTYPES[out_code]
    dev = _build.kernel_device(acc)
    b, hq, wq, n4 = acc.shape
    if n4 % 4:
        raise ValueError(f'{name}: channels {n4} must be a multiple of 4')
    _build.require(acc, 'acc', torch.int32, (b, hq, wq, n4), dev)
    _build.require(mult, 'mult', torch.float32, (n4,), dev)
    lo, hi = requant_clip_bounds(out_bits, signed)
    info = torch.iinfo(out_dtype)
    if lo < info.min or hi > info.max:
        raise ValueError(f'{name}: {out_bits}-bit values do not fit '
                         f'{out_dtype}')
    lo = max(lo, 0.0) if relu else lo
    n = n4 // 4
    vec = int(n % 4 == 0 and acc.data_ptr() % 16 == 0
              and mult.data_ptr() % 16 == 0)
    out = torch.empty((b, hq, wq, n), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        code = _build.lib().hawq_maxpool_folded_requant(
            acc.data_ptr(), mult.data_ptr(), out.data_ptr(), b, hq, wq, n,
            int(lo), int(hi), out_code, vec, _build.stream_ptr(dev))
    _build.check(code, name)
    _build.count(name)
    return out


def _pooled(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b, hq, wq, n4 = x.shape
    return x.new_empty((b, hq, wq, n4 // 4), dtype=dtype)


OPS = {
    'maxpool_folded': _build.define_op(
        'maxpool_folded(Tensor xf) -> Tensor',
        maxpool_3x3s2p1_folded,
        _maxpool_folded_cuda, lambda xf: _pooled(xf, xf.dtype)),
    'maxpool_folded_requant': _build.define_op(
        'maxpool_folded_requant(Tensor acc, Tensor mult, int out_bits, '
        'bool signed, bool relu, int out_code) -> Tensor',
        lambda acc, mult, out_bits, signed, relu, out_code:
        maxpool_folded_requant_plain(acc, mult, out_bits, signed, relu,
                                     _OUT_DTYPES[out_code]),
        _maxpool_folded_requant_cuda,
        lambda acc, mult, out_bits, signed, relu, out_code:
        _pooled(acc, _OUT_DTYPES[out_code]))}


def maxpool_folded(xf: torch.Tensor) -> torch.Tensor:
    """(B, Hq, Wq, 4N) folded conv output → (B, Hq, Wq, N) pooled, int16,
    int32 or float32."""
    return OPS['maxpool_folded'](xf)


def maxpool_folded_requant(acc: torch.Tensor, mult: torch.Tensor, *,
                           out_bits: int, signed: bool, relu: bool,
                           out_dtype: torch.dtype) -> torch.Tensor:
    """The folded init's requant, ReLU and max-pool in one pass:
    pool(relu(requant_int32(acc, mult, out_bits, signed, out_dtype))).

    acc (B, Hq, Wq, 4N) int32 accumulator, mult (4N,) float32 dyadic
    multipliers in the fold's (py, px, n) channel order, out_dtype int16 or
    int32 (the engine's carrier) → (B, Hq, Wq, N).  The kernel requantizes
    each of the nine values of a window with its own channel's multiplier
    before the max, so the result equals the plain sequence for any
    multipliers."""
    if out_dtype not in _OUT_CODES:
        raise ValueError(f'maxpool_folded_requant: out_dtype {out_dtype} '
                         f'must be int16 or int32')
    return OPS['maxpool_folded_requant'](acc, mult, int(out_bits),
                                         bool(signed), bool(relu),
                                         _OUT_CODES[out_dtype])
