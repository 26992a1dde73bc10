"""Integer matmul with fused dyadic requant epilogues (port of
hawq_tpu/kernels/matmul.py ``int8_matmul_requant`` / ``int8_matmul_acc``,
their nibble-packed int4-weight forms ``int4w_matmul_requant`` /
``int4w_matmul_acc``, and the K-blocked ``int8_matmul_requant_kblocked``),
and the host packer for those weights.

On a CUDA tensor each wrapper launches the hand-written GEMM core for
Hopper (csrc/gemm_s8_sm90.cuh: TMA, mbarriers, wgmma; any M, K and N, the
int4 forms need an even K); on a CPU tensor it runs the plain PyTorch
version beside it.  The plain versions compute the int32 accumulator
exactly through float64 (every sum here is far below 2⁵³) and repeat the
kernel's epilogue op for op; the int4 forms unpack the weights with
:func:`unpack_int4` first.

The core reads the weights K-major: :func:`prepare_weights` (and
:func:`prepare_weights_int4` for nibble-packed weights, which stay packed
and are unpacked inside the kernel) lays them out once (the engine caches
the handle); a wrapper handed plain weights lays them out on the device at
each call.  TMA needs every row stride and base pointer on 16 bytes;
:func:`sm90_operands`, the one alignment step, zero-pads the operands of a
call that misses it, so that the core takes every shape (the cells' shapes
need none of it).  The K-blocked matmul is ``int8_matmul_requant``'s
kernel: one block walks the whole K in its register accumulators and
requantizes once.

``int8_matmul_acc_residual`` is ``int8_matmul_acc`` with a bottleneck
unit's residual in its epilogue: the requant-add of the accumulator and an
int32 identity, each with its own multipliers, then the ReLU
(:func:`residual_epilogue`, the plain version), so that the unit's last
1×1 conv leaves as its int32 carrier: the core's ``RESIDUAL`` epilogue.
``int8_matmul_acc_residual_requant`` also leaves as the next unit's entry
requant of that carrier, int8 by one scalar multiplier
(:func:`residual_requant_epilogue`, the plain version: the standalone
requant of ``kernels.requant`` after the residual), so that the next unit
reads one byte an element in place of the carrier's four: the core's
``ENTRY`` epilogue.  ``int8_matmul_residual_requant`` is the same call
where nothing reads the carrier: it returns the entry alone, and the
carrier is never stored.

The four matmuls and the three residual forms run as the operators
``torch.ops.hawq.<wrapper name>`` (:data:`OPS`; ``_build.define_op``): the
wrapper takes a handle apart into its ``wt`` and padded K and its options
into ints, and the operator aligns the operands and picks the tile at
launch.  The K-blocked matmul, on no engine's path, stays a plain call.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hawq_tpu_torch.kernels import _build
from hawq_tpu_torch.quant.ops import (requant_add_int32, requant_clip_bounds,
                                      requant_int32, round_half_up)

# the accumulator matmul with a bottleneck's residual epilogue
RESIDUAL = 'int8_matmul_acc_residual'
# the same with the next unit's entry requant of the carrier: the carrier
# and the entry, or the entry alone (the carrier not stored)
RESIDUAL_REQUANT = 'int8_matmul_acc_residual_requant'
RESIDUAL_REQUANT_ONLY = 'int8_matmul_residual_requant'


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


def residual_epilogue(acc: torch.Tensor, mult_main: torch.Tensor,
                      identity: torch.Tensor,
                      mult_id: torch.Tensor) -> torch.Tensor:
    """max(requant_add(acc, mult_main; identity, mult_id), 0) → int32 (plain
    version): a bottleneck's residual requant-add
    (``quant.ops.requant_add_int32``), then the ReLU."""
    return torch.clamp_min(
        requant_add_int32(acc, mult_main, identity, mult_id), 0)


def residual_requant_epilogue(acc: torch.Tensor, mult_main: torch.Tensor,
                              identity: torch.Tensor, mult_id: torch.Tensor,
                              mult_in: torch.Tensor, out_bits: int,
                              signed: bool):
    """(carrier int32, entry int8) (plain version): the carrier of
    :func:`residual_epilogue`, then its requant by the one float32
    ``mult_in`` to ``out_bits`` (``quant.ops.requant_int32``, as
    ``kernels.requant`` requantizes a unit's input)."""
    carrier = residual_epilogue(acc, mult_main, identity, mult_id)
    return carrier, requant_int32(carrier, mult_in, out_bits, signed,
                                  torch.int8)


def int_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of two int8 matrices (plain version)."""
    return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)


def matmul_acc_plain(x, w, bias):
    return int_product(x, w) + bias


def matmul_requant_plain(x, w, bias, mult, lo, hi):
    return requant_epilogue(matmul_acc_plain(x, w, bias), mult, lo, hi)


def matmul_acc_kmajor_plain(x, prepared: 'PreparedWeights', bias,
                            name: str = 'int8_matmul_acc'):
    """:func:`matmul_acc_plain` by the Hopper core's walk: x zero-filled to
    whole 64-row tiles and to the padded K of the K-major weights, and the
    weights' N rows to the bias's width (what TMA does out of bounds: an
    output widened by :func:`sm90_operands`), the product against
    ``prepared.wt``, the rows beyond M dropped at the store."""
    m, k = x.shape
    prepared.check(1, k, name)
    xt = F.pad(x, (0, prepared.cpad - k, 0, -m % SM90_TILE_M))
    acc = (xt.to(torch.float64) @ prepared.kmajor_int8().to(torch.float64).t())
    acc = F.pad(acc, (0, bias.shape[0] - prepared.n))
    return acc[:m].to(torch.int32) + bias


def matmul_requant_kmajor_plain(x, prepared: 'PreparedWeights', bias, mult,
                                lo, hi, name: str = 'int8_matmul_requant'):
    """:func:`matmul_requant_plain` by the Hopper core's walk: the requant
    of :func:`matmul_acc_kmajor_plain`."""
    return requant_epilogue(matmul_acc_kmajor_plain(x, prepared, bias, name),
                            mult, lo, hi)


# ---------------------------------------------------------------------------
# the Hopper core's weights, alignment step and tile width
# ---------------------------------------------------------------------------

SM90_TILE_M = 64          # rows of an output tile (one wgmma)
SM90_TILE_NS = (128, 64, 32)
SM90_K_ALIGN = 64         # every tap's K is zero-padded to a multiple of it
SM90_ALIGN = 16           # bytes: TMA's rule for row strides and pointers


class PreparedWeights:
    """(K, N) int8 weights laid out for the Hopper core: ``wt`` is (N,
    taps·cpad) K-major, each tap's ``cin`` rows zero-padded to ``cpad``, a
    multiple of 64.  Accepted by ``int8_matmul_requant``,
    ``int8_matmul_acc``, ``int8_conv_requant`` and ``int8_conv_acc`` in
    place of the (K, N) tensor.  With ``int4`` (:func:`prepare_weights_int4`,
    accepted by the four ``int4w_*`` kernels) the weights stay
    nibble-packed: ``wt`` is (N, taps·cpad/2) bytes, and inside every
    ``tile_k``-channel chunk byte i holds channel c0 + i in its low nibble
    and channel c0 + tile_k/2 + i in its high nibble, so that the kernel
    unpacks 16 packed bytes into two whole 16-byte units of its int8 tile.
    With ``row_taps`` > 1 (a conv's, ``conv.prepare_conv_weights``) each of
    the kernel's ``taps`` is a row of ``row_taps`` conv taps, read as one
    pixel of ``cin`` = row_taps·C channels.  A launch encodes the TMA
    tensor map of ``wt`` (:func:`weight_map`, cached by pointer and
    geometry), so the kernels' operators take the handle as ``wt`` and its
    ints alone."""

    __slots__ = ('wt', 'taps', 'cin', 'cpad', 'n', 'int4', 'row_taps')

    def __init__(self, wt: torch.Tensor, taps: int, cin: int, cpad: int,
                 int4: bool = False, row_taps: int = 1):
        self.wt, self.taps, self.cin, self.cpad = wt, taps, cin, cpad
        self.n = wt.shape[0]
        self.int4 = int4
        self.row_taps = row_taps

    @property
    def k(self) -> int:
        return self.taps * self.cin

    @property
    def tile_k(self) -> int:
        """Bytes of K per ring stage: 128 where the padded K allows."""
        return 128 if self.cpad % 128 == 0 else 64

    def check(self, taps: int, cin: int, name: str) -> None:
        """Raise unless the weights were prepared for ``taps`` taps of
        ``cin`` channels (a matmul: one tap of K), packed for an ``int4w_*``
        kernel and not packed for an ``int8_*`` one."""
        real = (self.taps * self.row_taps, self.cin // self.row_taps)
        if real != (taps, cin):
            raise ValueError(f'{name}: weights prepared for {real[0]} '
                             f'tap(s) of {real[1]}, the call has {taps} '
                             f'of {cin}')
        if self.int4 != name.startswith('int4w'):
            raise ValueError(f'{name}: the handle holds '
                             f'{"packed int4" if self.int4 else "int8"} '
                             f'weights')

    @property
    def row_bytes(self) -> int:
        """Bytes of one K-major row of ``wt``."""
        return self.taps * self.cpad // (2 if self.int4 else 1)

    def kmajor_int8(self) -> torch.Tensor:
        """The (N, taps·cpad) int8 K-major weights: ``wt``, or with ``int4``
        its nibbles unpacked chunk by chunk as the kernel does."""
        if not self.int4:
            return self.wt
        p = self.wt.reshape(self.n, -1, self.tile_k // 2).to(torch.int16)
        lo = ((p & 0xF) ^ 8) - 8
        hi = (((p >> 4) & 0xF) ^ 8) - 8
        return torch.cat([lo, hi], dim=-1).to(torch.int8).reshape(
            self.n, self.taps * self.cpad)

    def tensor_map(self, tile_n: int) -> ctypes.Array:
        """The 128-byte CUtensorMap of ``wt`` for boxes of tile_k channels ×
        tile_n rows."""
        return weight_map(self.wt.data_ptr(), self.n, self.row_bytes,
                          self.tile_k // (2 if self.int4 else 1), tile_n)


# Encoded tensor maps by (pointer, rows, row bytes, box bytes, box rows),
# everything a map holds: a map is the same for any tensor at that address
# with that geometry, so a loaded program's weights and an engine's share
# one.  The oldest are dropped past WEIGHT_MAPS_KEPT (a training step lays
# out new weights at each call); a launch keeps its own reference to the
# map it passes.
_WEIGHT_MAPS: 'OrderedDict[Tuple[int, ...], ctypes.Array]' = OrderedDict()
_WEIGHT_MAPS_LOCK = threading.Lock()
WEIGHT_MAPS_KEPT = 4096


def weight_map(ptr: int, n: int, row_bytes: int, box_k: int,
               tile_n: int) -> ctypes.Array:
    """The CUtensorMap of (n, row_bytes) K-major weights at ``ptr`` for
    boxes of ``box_k`` bytes × ``tile_n`` rows, encoded at first use."""
    key = (ptr, n, row_bytes, box_k, tile_n)
    with _WEIGHT_MAPS_LOCK:
        buf = _WEIGHT_MAPS.get(key)
        if buf is not None:
            _WEIGHT_MAPS.move_to_end(key)
            return buf
        buf = ctypes.create_string_buffer(128)
        code = _build.lib().hawq_sm90_weight_map(buf, ptr, n, row_bytes,
                                                 box_k, tile_n)
        _build.check(code, 'hawq_sm90_weight_map')
        _WEIGHT_MAPS[key] = buf
        if len(_WEIGHT_MAPS) > WEIGHT_MAPS_KEPT:
            _WEIGHT_MAPS.popitem(last=False)
        return buf


def _row_geometry(name: str, k: int, taps: int, row_taps: int):
    """(kernel taps, channels of a kernel tap, cpad) of ``taps`` taps of
    equal C over K rows, ``row_taps`` of them to a kernel tap."""
    if k % taps or taps % row_taps:
        raise ValueError(f'{name}: K = {k} is not {taps} taps of equal C in '
                         f'rows of {row_taps}')
    cin = k // taps * row_taps
    return taps // row_taps, cin, -(-cin // SM90_K_ALIGN) * SM90_K_ALIGN


def prepare_weights(w_flat: torch.Tensor, taps: int = 1,
                    row_taps: int = 1) -> PreparedWeights:
    """(taps·C, N) int8 weights (a matmul's (K, N) is one tap) → their
    K-major layout for the Hopper core, on ``w_flat``'s device:
    wt[n, t·cpad + c] = w_flat[t·C + c, n], zeros for C ≤ c < cpad, cpad = C
    rounded up to a multiple of 64.  With ``row_taps`` each kernel tap t is
    ``row_taps`` consecutive taps (a kernel row), C = row_taps·C."""
    k, n = w_flat.shape
    taps, cin, cpad = _row_geometry('prepare_weights', k, taps, row_taps)
    if taps == 1 and cpad == cin:          # a matmul with nothing to pad
        return PreparedWeights(w_flat.t().contiguous(), 1, cin, cin,
                               row_taps=row_taps)
    wt = w_flat.reshape(taps, cin, n).permute(2, 0, 1)
    if cpad != cin:
        wt = F.pad(wt, (0, cpad - cin))
    return PreparedWeights(wt.contiguous().reshape(n, taps * cpad), taps, cin,
                           cpad, row_taps=row_taps)


def pack_nibbles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int4-valued int8 tensors → bytes (hi << 4) | (lo & 0xF), as int8."""
    b = ((hi.to(torch.int16) & 0xF) << 4) | (lo.to(torch.int16) & 0xF)
    return b.to(torch.uint8).view(torch.int8)


def prepare_weights_int4(w_packed: torch.Tensor, taps: int = 1,
                         row_taps: int = 1) -> PreparedWeights:
    """(taps·C/2, N) nibble-packed weights (``conv.pack_int4_conv``: per
    tap, byte[c] = W[c + C/2] << 4 | W[c] & 0xF; with one tap the (K/2, N)
    bytes of :func:`pack_int4`) → their packed K-major
    handle for the Hopper core, on ``w_packed``'s device: (N, taps·cpad/2)
    bytes, cpad as in :func:`prepare_weights`, each ``tile_k``-channel chunk
    split into its low-nibble and high-nibble halves (see
    :class:`PreparedWeights`); ``row_taps`` as in :func:`prepare_weights`."""
    kh, n = w_packed.shape
    if kh % taps:
        raise ValueError(f'prepare_weights_int4: {kh} packed rows are not '
                         f'{taps} taps of equal C/2')
    w = unpack_int4(w_packed.reshape(taps, kh // taps, n))    # (taps, C, N)
    taps, cin, cpad = _row_geometry('prepare_weights_int4', 2 * kh, taps,
                                    row_taps)
    wt = F.pad(w.reshape(taps, cin, n).permute(2, 0, 1),
               (0, cpad - cin))                               # (N, taps, cpad)
    tile_k = 128 if cpad % 128 == 0 else 64
    halves = wt.reshape(n, taps * cpad // tile_k, 2, tile_k // 2)
    packed = pack_nibbles(halves[:, :, 0], halves[:, :, 1])
    return PreparedWeights(packed.reshape(n, taps * cpad // 2).contiguous(),
                           taps, cin, cpad, int4=True, row_taps=row_taps)


def unprepare_weights(prepared: PreparedWeights) -> torch.Tensor:
    """Inverse of :func:`prepare_weights`: the (taps·C, N) weights; of
    :func:`prepare_weights_int4`: the (taps·C/2, N) bytes of
    ``conv.pack_int4_conv`` (of :func:`pack_int4` for one tap)."""
    p = prepared
    wt = p.kmajor_int8().reshape(p.n, p.taps, p.cpad)[:, :, :p.cin]
    w = wt.permute(1, 2, 0).reshape(p.taps * p.row_taps, -1,
                                    p.n)                      # (taps, C, N)
    if p.int4:
        half = w.shape[1] // 2
        return pack_nibbles(w[:, :half], w[:, half:]).reshape(
            p.k // 2, p.n).contiguous()
    return w.reshape(p.k, p.n).contiguous()


def sm90_operands(x: torch.Tensor, prepared: PreparedWeights, vectors,
                  out_bytes: int, identity: Optional[torch.Tensor] = None):
    """The one alignment step between a call and the Hopper core, whose TMA
    maps need every row stride and base pointer on 16 bytes: it zero-pads
    the operands that miss that, so that the core takes every shape.

      * x's channels (a matmul's K; the C of a conv slab's pixels, x's last
        axis being a whole number of them) zero-filled to a multiple of 16,
        and the handle viewed at that width: its bytes are the same, each
        tap's rows being zeros from C up to ``cpad`` already;
      * the output's N widened to a multiple of 16 / ``out_bytes`` (16 for
        an int8 output, 4 for int32), and with it ``vectors`` (the bias and
        the multipliers, which the epilogue reads by column; a None stays
        None) and ``identity``'s (M, N) columns, zero-filled; the weights
        stay as they are, since TMA zero-fills the weight map's rows beyond
        N;
      * x or ``identity`` copied to a fresh allocation where its pointer is
        not on 16 bytes.

    Zero activations meet zero weight rows and the added columns are cut
    away, so no result changes.  → (x, prepared, vectors, identity); the
    output has ``vectors[0].shape[0]`` columns, and the caller cuts it back
    to ``prepared.n``.  A call that needs none of it, as every call of the
    benchmark's cells, gets its operands back as they are.  The handle's
    layout is decided where it is prepared (``conv.sm90_row_taps`` reads a
    kernel row as one tap only where C is a multiple of 16)."""
    c = prepared.cin // prepared.row_taps
    c16 = -(-c // SM90_ALIGN) * SM90_ALIGN
    if c16 != c:
        if prepared.row_taps > 1:
            raise ValueError(f'weights prepared to read rows of '
                             f'{prepared.row_taps} taps of C = {c}: a row '
                             f'read as one tap needs C % {SM90_ALIGN}')
        x = F.pad(x.reshape(-1, c), (0, c16 - c)).reshape(
            *x.shape[:-1], x.shape[-1] // c * c16)
        prepared = PreparedWeights(prepared.wt, prepared.taps, c16,
                                   prepared.cpad, prepared.int4)
    elif x.data_ptr() % SM90_ALIGN:
        x = x.clone()
    n = prepared.n
    step = SM90_ALIGN // out_bytes
    n_out = -(-n // step) * step
    if n_out != n:
        vectors = tuple(v if v is None else F.pad(v, (0, n_out - n))
                        for v in vectors)
        if identity is not None:
            identity = F.pad(identity, (0, n_out - n))
    elif identity is not None and identity.data_ptr() % SM90_ALIGN:
        identity = identity.clone()
    return x, prepared, vectors, identity


@functools.lru_cache(maxsize=None)
def sm90_tile_n(m_tiles: int, n: int, k_tiles: int, sm_count: int,
                widest: int = 128) -> int:
    """Width of the Hopper core's output tile: the widest of 128 and 64
    (not wider than twice N, nor than ``widest``) whose grid still has two
    blocks for every three SMs, else 32.  Where K is at most four steps a
    128-wide grid must have a block for every SM, and where K is a single
    step 64 is the most.  Measured on the H100 at the ResNet-50 shapes
    (chip_sweep_sm90.py at the root of the repository): a wide tile reads A
    fewer times and wins wherever the grid stays that full; below it the
    narrower tile's extra blocks win; a short call is mostly launch and
    epilogue, where more and smaller blocks win (M = 6272, K = 256, N = 128:
    3.9 against 4.75 µs at 64; M = 392, K = 512, N = 2048: 4.2 against 4.5);
    and a one-step call is all epilogue, where the narrower tile's smaller
    staging lets more blocks overlap their stores (M = 25088 and 100352,
    K = 64, N = 256: 11.4 against 12.8 µs and 48.7 against 54.5 at 64).
    The packed int4 conv and matmul pass ``widest`` = 64: their consumers
    unpack every B tile through shared memory, which costs a 128-wide tile
    more than the A re-reads it saves (at every 3×3 and 2×2-tap conv and
    every 1×1 conv of ResNet-50 at batch 8 the 64- or 32-wide tile is the
    faster: M = 6272, K = 256, N = 512, 9.0 against 10.6 µs at 128)."""
    for tile_n in SM90_TILE_NS[:2]:
        if tile_n > widest or (tile_n == 128 and k_tiles == 1):
            continue
        blocks = m_tiles * -(-n // tile_n)
        full = (blocks >= sm_count if tile_n == 128 and k_tiles <= 4
                else 3 * blocks >= 2 * sm_count)
        if 2 * n > tile_n and full:
            return tile_n
    return SM90_TILE_NS[2]


# widest tile of the packed matmul (sm90_tile_n's ``widest``)
SM90_INT4_MATMUL_WIDEST = 64


@functools.lru_cache(maxsize=None)
def sm90_tile_m(m: int, n: int, k_tiles: int, sm_count: int) -> int:
    """Rows of the packed matmul's output tile on the Hopper core: 128 (two
    consumer warpgroups that share each unpacked B tile: half the unpack
    work per output row, half the blocks) where N is at least 1024, or
    where K is a single step and the 128-row grid still has an M tile for
    every SM; else 64 (one warpgroup).  Measured on the H100 at the
    ResNet-50 b8 shapes at the width :func:`sm90_tile_n` picks
    (chip_sweep_sm90.py): M = 1568, N = 1024, K = 256 and 512: 5.2 and 6.3
    against 6.6 and 8.1 µs; M = 392, N = 2048: 4.7 and 6.3 against 4.8 and
    6.5; M = 25088, K = 64, N = 64 and 256: 5.2 and 12.2 against 5.4 and
    12.6.  Everywhere else the 64-row tile is the faster, by up to 23 %
    (M = 392, K = 2048, N = 512: 6.7 against 8.2 µs), as the grid loses
    half its blocks (M = 6272, K = 128, N = 512: 7.6 against 8.0)."""
    if n >= 1024 or (k_tiles == 1 and -(-m // (2 * SM90_TILE_M)) >= sm_count):
        return 2 * SM90_TILE_M
    return SM90_TILE_M


_SM_COUNT: Dict[torch.device, int] = {}


def sm_count(dev: torch.device) -> int:
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SM_COUNT[dev]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _matmul_name(requant: bool, int4: bool) -> str:
    return (('int4w' if int4 else 'int8') + '_matmul_'
            + ('requant' if requant else 'acc'))


def _launch_sm90(x, prepared: PreparedWeights, bias, mult, lo, hi,
                 requant: bool, tile_n: Optional[int], tile_m: Optional[int],
                 smem_extra: int, name: Optional[str] = None,
                 identity: Optional[torch.Tensor] = None,
                 mult_id: Optional[torch.Tensor] = None,
                 mult_in: Optional[torch.Tensor] = None,
                 carrier: bool = True):
    """The four matmuls on the Hopper core: int8 or packed int4 weights
    (``prepared.int4``), with ``requant`` the requant forms (int8 out), else
    the accumulator forms (int32 out), the int8 one with ``identity`` (M, N)
    int32 in its residual epilogue (``mult`` the accumulator's multipliers,
    ``mult_id`` the identity's), and with ``mult_in`` (one float32) also the
    entry requant of its carrier into [lo, hi] → (the carrier, or None
    without ``carrier``: not stored; the int8 entry); the operands aligned
    by :func:`sm90_operands`; counted as ``name`` (the K-blocked matmul
    runs the int8 requant form)."""
    int4 = prepared.int4
    name = name or _matmul_name(requant, int4)
    m, k = x.shape
    n = prepared.n
    dev = _build.kernel_device(x)
    _build.require(x, 'x', torch.int8, (m, k), dev)
    prepared.check(1, k, name)
    _build.require(prepared.wt, 'prepared.wt', torch.int8,
                   (n, prepared.row_bytes), dev)
    _build.require(bias, 'bias', torch.int32, (n,), dev)
    if requant or identity is not None:
        _build.require(mult, 'mult', torch.float32, (n,), dev)
    if identity is not None:
        _build.require(identity, 'identity', torch.int32, (m, n), dev)
        _build.require(mult_id, 'mult_id', torch.float32, (n,), dev)
    entry = mult_in is not None
    if entry:
        _build.require(mult_in, 'mult_in', torch.float32, mult_in.shape, dev)
        if mult_in.numel() != 1:
            raise ValueError(f'{name}: mult_in must be one value, got '
                             f'{tuple(mult_in.shape)}')
    if m < 1:
        raise ValueError(f'{name}: empty x')
    x, prepared, (bias, mult, mult_id), identity = sm90_operands(
        x, prepared, (bias, mult, mult_id), 1 if requant or entry else 4,
        identity)
    k, n_out = x.shape[1], bias.shape[0]
    k_tiles = -(-k // prepared.tile_k)
    if tile_m is None:
        tile_m = (sm90_tile_m(m, n, k_tiles, sm_count(dev)) if int4
                  else SM90_TILE_M)
    if tile_m not in ((SM90_TILE_M, 2 * SM90_TILE_M) if int4
                      else (SM90_TILE_M,)):
        raise ValueError(f'{name}: tile_m {tile_m}')
    if tile_n is None:
        tile_n = sm90_tile_n(-(-m // SM90_TILE_M), n, k_tiles, sm_count(dev),
                             SM90_INT4_MATMUL_WIDEST if int4 else 128)
    out = (torch.empty((m, n_out),
                       dtype=torch.int8 if requant else torch.int32,
                       device=dev) if carrier else None)
    out8 = torch.empty((m, n_out), dtype=torch.int8,
                       device=dev) if entry else None
    lib = _build.lib()
    head = (x.data_ptr(), prepared.tensor_map(tile_n), bias.data_ptr())
    tail = (prepared.tile_k, tile_n) + ((tile_m,) if int4 else ()) + (
        smem_extra, _build.stream_ptr(dev))
    with torch.cuda.device(dev):
        if entry:
            code = lib.hawq_int8_matmul_residual_requant_sm90(
                *head, mult.data_ptr(), identity.data_ptr(),
                mult_id.data_ptr(), mult_in.data_ptr(),
                None if out is None else out.data_ptr(), out8.data_ptr(), m,
                k, n_out, lo, hi, *tail)
        elif identity is not None:
            code = lib.hawq_int8_matmul_residual_sm90(
                *head, mult.data_ptr(), identity.data_ptr(),
                mult_id.data_ptr(), out.data_ptr(), m, k, n_out, *tail)
        elif requant:
            fn = (lib.hawq_int4w_matmul_sm90 if int4
                  else lib.hawq_int8_matmul_requant_sm90)
            code = fn(*head, mult.data_ptr(), out.data_ptr(), m, k, n_out,
                      lo, hi, *tail)
        else:
            fn = (lib.hawq_int4w_matmul_acc_sm90 if int4
                  else lib.hawq_int8_matmul_sm90)
            code = fn(*head, out.data_ptr(), m, k, n_out, *tail)
    _build.check(code, name)
    _build.count(name)
    if n_out != n:                  # the columns the alignment step added
        out, out8 = [t if t is None else t[:, :n].contiguous()
                     for t in (out, out8)]
    return (out, out8) if entry else out


def _matmul_plain(name, x, w, cpad, bias, mult, lo, hi) -> torch.Tensor:
    """The four matmuls' CPU implementation: the plain version, or where
    ``cpad`` is not 0 (``w`` a handle's K-major ``wt``) that of the Hopper
    core's walk."""
    requant, int4 = name.endswith('_requant'), name.startswith('int4w')
    if not cpad:
        w = unpack_int4(w) if int4 else w
        return (matmul_requant_plain(x, w, bias, mult, lo, hi) if requant
                else matmul_acc_plain(x, w, bias))
    prepared = PreparedWeights(w, 1, x.shape[1], cpad, int4)
    if requant:
        return matmul_requant_kmajor_plain(x, prepared, bias, mult, lo, hi,
                                           name)
    return matmul_acc_kmajor_plain(x, prepared, bias, name)


def _prepared(name, x, w, cpad) -> PreparedWeights:
    """The handle whose ``wt`` is ``w`` (``cpad`` not 0), or plain weights
    laid out here."""
    int4 = name.startswith('int4w')
    k = x.shape[1]
    if cpad:
        return PreparedWeights(w, 1, k, cpad, int4)
    _build.require(w, 'w_packed' if int4 else 'w', torch.int8,
                   (k // 2 if int4 else k, w.shape[1]), x.device)
    return prepare_weights_int4(w) if int4 else prepare_weights(w)


def _matmul_cuda(name, x, w, cpad, bias, mult, lo, hi, tile_n, tile_m,
                 smem_extra) -> torch.Tensor:
    """The four matmuls' CUDA implementation: the Hopper core on the
    handle's layout (``cpad`` not 0) or on plain weights laid out here."""
    return _launch_sm90(x, _prepared(name, x, w, cpad), bias, mult, lo, hi,
                        name.endswith('_requant'), _build.from_opt_int(tile_n),
                        _build.from_opt_int(tile_m), smem_extra)


def _define_matmul(name: str):
    """``hawq::<name>(x, w, cpad, bias, mult, lo, hi, tile_n, tile_m,
    smem_extra)``: ``cpad`` 0 for plain weights, else the padded K of the
    handle whose ``wt`` is ``w``; ``mult`` None (``lo``, ``hi`` 0) for the
    accumulator forms; ``tile_n`` / ``tile_m`` −1 for the rule's."""
    requant = name.endswith('_requant')

    def cpu(x, w, cpad, bias, mult, lo, hi, tile_n, tile_m, smem_extra):
        return _matmul_plain(name, x, w, cpad, bias, mult, lo, hi)

    def cuda(x, w, cpad, bias, mult, lo, hi, tile_n, tile_m, smem_extra):
        return _matmul_cuda(name, x, w, cpad, bias, mult, lo, hi, tile_n,
                            tile_m, smem_extra)

    def fake(x, w, cpad, bias, mult, lo, hi, tile_n, tile_m, smem_extra):
        return x.new_empty((x.shape[0], w.shape[0] if cpad else w.shape[1]),
                           dtype=torch.int8 if requant else torch.int32)
    return _build.define_op(
        f'{name}(Tensor x, Tensor w, int cpad, Tensor bias, Tensor? mult, '
        f'int lo, int hi, int tile_n, int tile_m, int smem_extra) -> Tensor',
        cpu, cuda, fake)


def _residual_cuda(x, w, cpad, bias, identity, mult_main, mult_id, tile_n,
                   smem_extra) -> torch.Tensor:
    """The residual form's CUDA implementation: the Hopper core's
    ``RESIDUAL`` epilogue."""
    return _launch_sm90(x, _prepared(RESIDUAL, x, w, cpad), bias, mult_main, 0,
                        0, False, _build.from_opt_int(tile_n), None,
                        smem_extra, RESIDUAL, identity, mult_id)


def _define_residual():
    """``hawq::int8_matmul_acc_residual(x, w, cpad, bias, identity,
    mult_main, mult_id, tile_n, smem_extra)``: ``w`` and ``cpad`` as for the
    matmuls, ``mult_main`` and ``mult_id`` (N,) float32."""

    def cpu(x, w, cpad, bias, identity, mult_main, mult_id, tile_n,
            smem_extra):
        acc = _matmul_plain('int8_matmul_acc', x, w, cpad, bias, None, 0, 0)
        return residual_epilogue(acc, mult_main, identity, mult_id)

    def fake(x, w, cpad, bias, identity, mult_main, mult_id, tile_n,
             smem_extra):
        return identity.new_empty(identity.shape)
    return _build.define_op(
        f'{RESIDUAL}(Tensor x, Tensor w, int cpad, Tensor bias, '
        f'Tensor identity, Tensor mult_main, Tensor mult_id, int tile_n, '
        f'int smem_extra) -> Tensor', cpu, _residual_cuda, fake)


def _entry_bounds(name: str, out_bits: int, signed: bool) -> Tuple[int, int]:
    """Clip bounds of the entry requant; raises where its values do not fit
    int8."""
    lo, hi = epilogue_bounds(out_bits, signed, False)
    if not 1 <= out_bits <= 8 or lo < -128 or hi > 127:
        raise ValueError(f'{name}: {out_bits}-bit '
                         f'{"signed" if signed else "unsigned"} values do not '
                         f'fit int8')
    return lo, hi


def _define_residual_requant(name: str):
    """``hawq::<name>(x, w, cpad, bias, identity, mult_main, mult_id,
    mult_in, out_bits, signed, tile_n, smem_extra)``: the residual form's
    arguments, then the entry requant's one-value ``mult_in`` and its bits;
    → (carrier, entry) for :data:`RESIDUAL_REQUANT`, the entry alone for
    :data:`RESIDUAL_REQUANT_ONLY`."""
    carrier = name == RESIDUAL_REQUANT

    def cpu(x, w, cpad, bias, identity, mult_main, mult_id, mult_in,
            out_bits, signed, tile_n, smem_extra):
        acc = _matmul_plain('int8_matmul_acc', x, w, cpad, bias, None, 0, 0)
        out = residual_requant_epilogue(acc, mult_main, identity, mult_id,
                                        mult_in, out_bits, signed)
        return out if carrier else out[1]

    def cuda(x, w, cpad, bias, identity, mult_main, mult_id, mult_in,
             out_bits, signed, tile_n, smem_extra):
        lo, hi = _entry_bounds(name, out_bits, signed)
        out = _launch_sm90(x, _prepared(name, x, w, cpad), bias, mult_main,
                           lo, hi, False, _build.from_opt_int(tile_n), None,
                           smem_extra, name, identity, mult_id, mult_in,
                           carrier)
        return out if carrier else out[1]

    def fake(x, w, cpad, bias, identity, mult_main, mult_id, mult_in,
             out_bits, signed, tile_n, smem_extra):
        entry = identity.new_empty(identity.shape, dtype=torch.int8)
        return (identity.new_empty(identity.shape), entry) if carrier \
            else entry
    return _build.define_op(
        f'{name}(Tensor x, Tensor w, int cpad, Tensor bias, '
        f'Tensor identity, Tensor mult_main, Tensor mult_id, Tensor mult_in, '
        f'int out_bits, bool signed, int tile_n, int smem_extra) -> '
        + ('(Tensor, Tensor)' if carrier else 'Tensor'), cpu, cuda, fake)


OPS = {name: _define_matmul(name) for name in (
    'int8_matmul_requant', 'int8_matmul_acc', 'int4w_matmul_requant',
    'int4w_matmul_acc')}
OPS[RESIDUAL] = _define_residual()
OPS[RESIDUAL_REQUANT] = _define_residual_requant(RESIDUAL_REQUANT)
OPS[RESIDUAL_REQUANT_ONLY] = _define_residual_requant(RESIDUAL_REQUANT_ONLY)


def _matmul(x, w, bias, mult, lo, hi, requant: bool, int4: bool,
            tile_n: Optional[int], tile_m: Optional[int],
            smem_extra: int) -> torch.Tensor:
    """The four matmuls through their operators: a handle taken apart into
    its ``wt`` and padded K, the options into ints."""
    name = _matmul_name(requant, int4)
    cpad = 0
    if isinstance(w, PreparedWeights):
        w.check(1, x.shape[1], name)
        w, cpad = w.wt, w.cpad
    return OPS[name](x, w, cpad, bias, mult, lo, hi, _build.opt_int(tile_n),
                     _build.opt_int(tile_m), smem_extra)


def int8_matmul_requant(x: torch.Tensor, w, bias: torch.Tensor,
                        mult: torch.Tensor, *, out_bits: int = 8,
                        signed: bool = True, relu: bool = False,
                        tile_n: Optional[int] = None,
                        smem_extra: int = 0) -> torch.Tensor:
    """out[i, n] = requant(Σ_k x[i,k]·w[k,n] + bias[n]) as int8.

    x (M, K) int8, w (K, N) int8 or its :func:`prepare_weights` handle,
    bias (N,) int32, mult (N,) float32 dyadic multipliers.  relu=True
    clamps the low end at 0.  ``tile_n`` and ``smem_extra`` as in
    :func:`int8_matmul_acc`."""
    lo, hi = epilogue_bounds(out_bits, signed, relu)
    return _matmul(x, w, bias, mult, lo, hi, True, False, tile_n, None,
                   smem_extra)


def int8_matmul_acc(x: torch.Tensor, w, bias: torch.Tensor, *,
                    tile_n: Optional[int] = None,
                    smem_extra: int = 0) -> torch.Tensor:
    """int8 matmul returning the raw int32 accumulator + bias.

    ``w`` is the (K, N) int8 tensor or its :func:`prepare_weights` handle.
    On a CUDA tensor ``tile_n`` sets the Hopper core's tile width, and
    ``smem_extra`` adds to its shared-memory request (timing and tests).
    The result does not depend on either."""
    return _matmul(x, w, bias, None, 0, 0, False, False, tile_n, None,
                   smem_extra)


def int8_matmul_acc_residual(x: torch.Tensor, w, bias: torch.Tensor,
                             identity: torch.Tensor, mult_main: torch.Tensor,
                             mult_id: torch.Tensor, *,
                             tile_n: Optional[int] = None,
                             smem_extra: int = 0) -> torch.Tensor:
    """out[i, n] = max(round(acc[i, n]·mult_main[n]) +
    round(identity[i, n]·mult_id[n]), 0) as int32, acc = Σ_k x[i,k]·w[k,n] +
    bias[n]: :func:`int8_matmul_acc` with a bottleneck's residual
    requant-add and ReLU (:func:`residual_epilogue`) in its epilogue.

    ``identity`` (M, N) int32 (the identity conv's accumulator or the
    previous carrier), ``mult_main`` and ``mult_id`` (N,) float32 (a scalar
    multiplier repeated N times); the other arguments as in
    :func:`int8_matmul_acc`."""
    cpad = 0
    if isinstance(w, PreparedWeights):
        w.check(1, x.shape[1], RESIDUAL)
        w, cpad = w.wt, w.cpad
    return OPS[RESIDUAL](x, w, cpad, bias, identity, mult_main, mult_id,
                         _build.opt_int(tile_n), smem_extra)


def _residual_requant(name, x, w, bias, identity, mult_main, mult_id,
                      mult_in, out_bits, signed, tile_n, smem_extra):
    _entry_bounds(name, out_bits, signed)
    cpad = 0
    if isinstance(w, PreparedWeights):
        w.check(1, x.shape[1], name)
        w, cpad = w.wt, w.cpad
    return OPS[name](x, w, cpad, bias, identity, mult_main, mult_id, mult_in,
                     int(out_bits), bool(signed), _build.opt_int(tile_n),
                     smem_extra)


def int8_matmul_acc_residual_requant(
        x: torch.Tensor, w, bias: torch.Tensor, identity: torch.Tensor,
        mult_main: torch.Tensor, mult_id: torch.Tensor,
        mult_in: torch.Tensor, *, out_bits: int = 8, signed: bool = True,
        tile_n: Optional[int] = None, smem_extra: int = 0):
    """:func:`int8_matmul_acc_residual` with the next unit's entry requant
    of the carrier in the same epilogue → (carrier int32 (M, N), entry int8
    (M, N)), entry = clip(floor(f32(carrier)·mult_in + 0.5), lo, hi) bit
    for bit as ``kernels.requant.requant_int32`` computes it from the
    carrier (:func:`residual_requant_epilogue`).  ``mult_in``: one float32
    value; [lo, hi] the ``out_bits`` range (``signed``), which must fit
    int8; the other arguments as in :func:`int8_matmul_acc_residual`."""
    return _residual_requant(RESIDUAL_REQUANT, x, w, bias, identity,
                             mult_main, mult_id, mult_in, out_bits, signed,
                             tile_n, smem_extra)


def int8_matmul_residual_requant(
        x: torch.Tensor, w, bias: torch.Tensor, identity: torch.Tensor,
        mult_main: torch.Tensor, mult_id: torch.Tensor,
        mult_in: torch.Tensor, *, out_bits: int = 8, signed: bool = True,
        tile_n: Optional[int] = None, smem_extra: int = 0) -> torch.Tensor:
    """The entry of :func:`int8_matmul_acc_residual_requant` alone, int8
    (M, N): for a carrier that nothing reads, which the kernel then never
    stores."""
    return _residual_requant(RESIDUAL_REQUANT_ONLY, x, w, bias, identity,
                             mult_main, mult_id, mult_in, out_bits, signed,
                             tile_n, smem_extra)


def int4w_matmul_requant(x: torch.Tensor, w_packed, bias: torch.Tensor,
                         mult: torch.Tensor, *, out_bits: int = 8,
                         signed: bool = True, relu: bool = False,
                         tile_n: Optional[int] = None,
                         tile_m: Optional[int] = None,
                         smem_extra: int = 0) -> torch.Tensor:
    """:func:`int8_matmul_requant` with nibble-packed int4 weights: w_packed
    (K/2, N) from :func:`pack_int4` (K even), or its
    :func:`prepare_weights_int4` handle.  ``tile_m`` is the rows of the
    Hopper core's output tile, 64 or 128 (:func:`sm90_tile_m`); the other
    keywords as in :func:`int8_matmul_acc`."""
    lo, hi = epilogue_bounds(out_bits, signed, relu)
    return _matmul(x, w_packed, bias, mult, lo, hi, True, True, tile_n,
                   tile_m, smem_extra)


def int4w_matmul_acc(x: torch.Tensor, w_packed, bias: torch.Tensor, *,
                     tile_n: Optional[int] = None,
                     tile_m: Optional[int] = None,
                     smem_extra: int = 0) -> torch.Tensor:
    """:func:`int8_matmul_acc` with nibble-packed int4 weights (or their
    handle), as in :func:`int4w_matmul_requant`."""
    return _matmul(x, w_packed, bias, None, 0, 0, False, True, tile_n,
                   tile_m, smem_extra)


def int8_matmul_requant_kblocked(x: torch.Tensor, w, bias: torch.Tensor,
                                 mult: torch.Tensor, *, out_bits: int = 8,
                                 signed: bool = True,
                                 relu: bool = False) -> torch.Tensor:
    """:func:`int8_matmul_requant`'s function with K accumulated on chip and
    a single requant at the end.  Any K.

    ``w`` is the (K, N) int8 tensor or its :func:`prepare_weights` handle.
    On a CUDA tensor the call runs :func:`int8_matmul_requant`'s kernel on
    the Hopper core (one block walks the whole K in its register
    accumulators and requantizes once, csrc/matmul_requant_sm90.cu)."""
    name = 'int8_matmul_requant_kblocked'
    lo, hi = epilogue_bounds(out_bits, signed, relu)
    prepared = w if isinstance(w, PreparedWeights) else None
    if x.device.type == 'cpu':
        if prepared is None:
            return matmul_requant_plain(x, w, bias, mult, lo, hi)
        return matmul_requant_kmajor_plain(x, prepared, bias, mult, lo, hi,
                                           name)
    if prepared is None:
        prepared = _prepared(name, x, w, 0)
    return _launch_sm90(x, prepared, bias, mult, lo, hi, True, None, None, 0,
                        name)
