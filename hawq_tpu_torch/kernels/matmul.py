"""Integer matmul with fused dyadic requant epilogues (port of
hawq_tpu/kernels/matmul.py ``int8_matmul_requant`` / ``int8_matmul_acc``,
their nibble-packed int4-weight forms ``int4w_matmul_requant`` /
``int4w_matmul_acc``, and the K-blocked ``int8_matmul_requant_kblocked``),
and the host packer for those weights.

On a CUDA tensor each wrapper launches the hand-written tensor-core kernel
(csrc/matmul.cu and csrc/matmul_kblocked.cu over csrc/gemm_s8.cuh, any M, K
and N; the int4 forms need an even K); on a CPU tensor it runs the plain PyTorch version beside it.
The plain versions compute the int32 accumulator exactly through float64
(every sum here is far below 2⁵³) and repeat the kernel's epilogue op for
op; the int4 forms unpack the weights with :func:`unpack_int4` first.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hawq_tpu_torch.kernels import _build
from hawq_tpu_torch.quant.ops import requant_clip_bounds, round_half_up


def epilogue_bounds(out_bits: int, signed: bool,
                    relu: bool) -> Tuple[int, int]:
    """Clip bounds of the requant epilogue; ``relu`` clamps low at 0."""
    lo, hi = requant_clip_bounds(out_bits, signed)
    return (0 if relu else int(lo)), int(hi)


# ---------------------------------------------------------------------------
# int4 packing
# ---------------------------------------------------------------------------

def pack_int4(w: np.ndarray) -> np.ndarray:
    """Pack int4-valued (..., K, N) int8 weights → (..., K/2, N) bytes.

    byte[k, n] = (W[k + K/2, n] << 4) | (W[k, n] & 0xF), the split-K layout
    of hawq_tpu/kernels/matmul.py ``pack_int4``; over a leading axis each
    (K, N) block is packed on its own (the conv's per-tap packing)."""
    w = np.asarray(w, np.int8)
    k = w.shape[-2]
    if k % 2:
        raise ValueError(f'pack_int4 needs an even K, got {k}')
    if w.size and (w.min() < -8 or w.max() > 7):
        raise ValueError('pack_int4: weights outside the int4 range [-8, 7]')
    lo = w[..., : k // 2, :].astype(np.uint8) & 0xF
    hi = (w[..., k // 2:, :].astype(np.uint8) & 0xF) << 4
    return np.ascontiguousarray((lo | hi).astype(np.int8))


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` in torch: (..., K/2, N) bytes → (..., K,
    N) int8 values in [-8, 7], low nibbles first, each sign-extended."""
    p = packed.to(torch.int16)
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def requant_epilogue(acc: torch.Tensor, mult: torch.Tensor, lo: int,
                     hi: int) -> torch.Tensor:
    """clip(floor(f32(acc)·mult + 0.5), lo, hi) → int8 (plain version)."""
    out = round_half_up(acc.to(torch.float32) * mult)
    return torch.clamp(out, float(lo), float(hi)).to(torch.int8)


def int_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of two int8 matrices (plain version)."""
    return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)


def matmul_acc_plain(x, w, bias):
    return int_product(x, w) + bias


def matmul_requant_plain(x, w, bias, mult, lo, hi):
    return requant_epilogue(matmul_acc_plain(x, w, bias), mult, lo, hi)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _launch(x, w, bias, mult, lo, hi, requant: bool,
            int4: bool) -> torch.Tensor:
    m, k = x.shape
    n = w.shape[1]
    if int4 and k % 2:
        raise ValueError(f'int4w matmul needs an even K, got {k}')
    dev = _build.kernel_device(x)
    _build.require(x, 'x', torch.int8, (m, k), dev)
    _build.require(w, 'w_packed' if int4 else 'w', torch.int8,
                   (k // 2 if int4 else k, n), dev)
    _build.require(bias, 'bias', torch.int32, (n,), dev)
    if requant:
        _build.require(mult, 'mult', torch.float32, (n,), dev)
    out = torch.empty((m, n), dtype=torch.int8 if requant else torch.int32,
                      device=dev)
    vec_a = int(k % 16 == 0 and x.data_ptr() % 16 == 0)
    vec_b = int(n % 4 == 0 and w.data_ptr() % 4 == 0)
    name = (('int4w' if int4 else 'int8') + '_matmul_'
            + ('requant' if requant else 'acc'))
    with torch.cuda.device(dev):
        code = _build.lib().hawq_int8_matmul(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(),
            mult.data_ptr() if requant else None, out.data_ptr(),
            m, k, n, lo, hi, int(requant), int(int4), vec_a, vec_b,
            _build.stream_ptr(dev))
    _build.check(code, name)
    _build.count(name)
    return out


def int8_matmul_requant(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                        mult: torch.Tensor, *, out_bits: int = 8,
                        signed: bool = True,
                        relu: bool = False) -> torch.Tensor:
    """out[i, n] = requant(Σ_k x[i,k]·w[k,n] + bias[n]) as int8.

    x (M, K) int8, w (K, N) int8, bias (N,) int32, mult (N,) float32 dyadic
    multipliers.  relu=True clamps the low end at 0."""
    lo, hi = epilogue_bounds(out_bits, signed, relu)
    if x.device.type == 'cpu':
        return matmul_requant_plain(x, w, bias, mult, lo, hi)
    return _launch(x, w, bias, mult, lo, hi, True, False)


def int8_matmul_acc(x: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """int8 matmul returning the raw int32 accumulator + bias."""
    if x.device.type == 'cpu':
        return matmul_acc_plain(x, w, bias)
    return _launch(x, w, bias, None, 0, 0, False, False)


def int4w_matmul_requant(x: torch.Tensor, w_packed: torch.Tensor,
                         bias: torch.Tensor, mult: torch.Tensor, *,
                         out_bits: int = 8, signed: bool = True,
                         relu: bool = False) -> torch.Tensor:
    """:func:`int8_matmul_requant` with nibble-packed int4 weights: w_packed
    (K/2, N) from :func:`pack_int4`; K even."""
    lo, hi = epilogue_bounds(out_bits, signed, relu)
    if x.device.type == 'cpu':
        return matmul_requant_plain(x, unpack_int4(w_packed), bias, mult,
                                    lo, hi)
    return _launch(x, w_packed, bias, mult, lo, hi, True, True)


def int4w_matmul_acc(x: torch.Tensor, w_packed: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """:func:`int8_matmul_acc` with nibble-packed int4 weights."""
    if x.device.type == 'cpu':
        return matmul_acc_plain(x, unpack_int4(w_packed), bias)
    return _launch(x, w_packed, bias, None, 0, 0, False, True)


def default_k_splits(m: int, k: int, n: int, sm_count: int) -> int:
    """Pieces of K for the split-K kernel: enough that output tiles × splits
    reach about two blocks per SM, with at least four 64-wide K tiles in a
    piece; 1 when the output tiles alone fill the card."""
    tiles = -(-m // 64) * -(-n // 64)
    k_tiles = -(-k // 64)
    return max(1, min(2 * sm_count // tiles, k_tiles // 4))


def int8_matmul_requant_kblocked(x: torch.Tensor, w: torch.Tensor,
                                 bias: torch.Tensor, mult: torch.Tensor, *,
                                 out_bits: int = 8, signed: bool = True,
                                 relu: bool = False,
                                 k_splits: Optional[int] = None
                                 ) -> torch.Tensor:
    """:func:`int8_matmul_requant`'s function with K accumulated in pieces
    through an int32 workspace and a single requant at the end (split-K; see
    csrc/matmul_kblocked.cu).  Any K (the last piece is masked).

    ``k_splits`` is the number of pieces, at most ⌈K/64⌉; None picks it from
    the shape and the card's SM count (:func:`default_k_splits`).  The
    result does not depend on it."""
    lo, hi = epilogue_bounds(out_bits, signed, relu)
    m, k = x.shape
    n = w.shape[1]
    k_tiles = -(-k // 64)
    if k_splits is not None and not 1 <= k_splits <= k_tiles:
        raise ValueError(f'k_splits {k_splits} not in [1, {k_tiles}] for '
                         f'K = {k}')
    if x.device.type == 'cpu':
        return matmul_requant_plain(x, w, bias, mult, lo, hi)
    dev = _build.kernel_device(x)
    _build.require(x, 'x', torch.int8, (m, k), dev)
    _build.require(w, 'w', torch.int8, (k, n), dev)
    _build.require(bias, 'bias', torch.int32, (n,), dev)
    _build.require(mult, 'mult', torch.float32, (n,), dev)
    if m < 1 or k < 1 or n < 1:
        raise ValueError(f'int8_matmul_requant_kblocked: empty shape '
                         f'({m}, {k}) x ({k}, {n})')
    if k_splits is None:
        k_splits = default_k_splits(
            m, k, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    ws = None
    if k_splits > 1:        # the sums, then one arrival counter per tile
        ws = torch.zeros(m * n + -(-m // 64) * -(-n // 64),
                         dtype=torch.int32, device=dev)
    vec_a = int(k % 16 == 0 and x.data_ptr() % 16 == 0)
    vec_b = int(n % 4 == 0 and w.data_ptr() % 4 == 0)
    with torch.cuda.device(dev):
        code = _build.lib().hawq_int8_matmul_kblocked(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), mult.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(), m, k, n,
            lo, hi, k_splits, vec_a, vec_b, _build.stream_ptr(dev))
    _build.check(code, 'int8_matmul_requant_kblocked')
    _build.count('int8_matmul_requant_kblocked')
    return out
