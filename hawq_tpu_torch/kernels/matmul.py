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

``int8_matmul_acc`` (and ``int8_conv_requant`` in kernels/conv.py) run on a
second core written for Hopper (csrc/gemm_s8_sm90.cuh: TMA, mbarriers,
wgmma) wherever :func:`sm90_route` admits the shape, and on csrc/gemm_s8.cuh
elsewhere.  That core reads the weights K-major: :func:`prepare_weights`
lays them out once (the engine caches the handle); a wrapper handed plain
(K, N) weights lays them out on the device at each call.
:data:`_build.CORE_LAUNCHES` counts the launches of each core.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


def matmul_acc_kmajor_plain(x, prepared: 'PreparedWeights', bias):
    """:func:`matmul_acc_plain` by the Hopper core's walk: x zero-filled to
    whole 64-row tiles and to the padded K of the K-major weights (what TMA
    does out of bounds), the product against ``prepared.wt``, the rows
    beyond M dropped at the store."""
    m, k = x.shape
    prepared.check(1, k, 'int8_matmul_acc')
    xt = F.pad(x, (0, prepared.cpad - k, 0, -m % SM90_TILE_M))
    acc = (xt.to(torch.float64) @ prepared.wt.to(torch.float64).t())
    return acc[:m].to(torch.int32) + bias


# ---------------------------------------------------------------------------
# the Hopper core's weights, routing rule and tile width
# ---------------------------------------------------------------------------

SM90_TILE_M = 64          # rows of an output tile (one wgmma)
SM90_TILE_NS = (128, 64, 32)
SM90_K_ALIGN = 64         # every tap's K is zero-padded to a multiple of it


class PreparedWeights:
    """(K, N) int8 weights laid out for the Hopper core: ``wt`` is (N,
    taps·cpad) K-major, each tap's ``cin`` rows zero-padded to ``cpad``, a
    multiple of 64.  Accepted by ``int8_matmul_acc`` and
    ``int8_conv_requant`` in place of the (K, N) tensor.  On a CUDA device
    it also keeps the encoded TMA tensor map of ``wt`` per tile shape."""

    __slots__ = ('wt', 'taps', 'cin', 'cpad', 'n', '_maps')

    def __init__(self, wt: torch.Tensor, taps: int, cin: int, cpad: int):
        self.wt, self.taps, self.cin, self.cpad = wt, taps, cin, cpad
        self.n = wt.shape[0]
        self._maps: Dict[Tuple[int, int], ctypes.Array] = {}

    @property
    def k(self) -> int:
        return self.taps * self.cin

    @property
    def tile_k(self) -> int:
        """Bytes of K per ring stage: 128 where the padded K allows."""
        return 128 if self.cpad % 128 == 0 else 64

    def check(self, taps: int, cin: int, name: str) -> None:
        """Raise unless the weights were prepared for ``taps`` taps of
        ``cin`` channels (a matmul: one tap of K)."""
        if (self.taps, self.cin) != (taps, cin):
            raise ValueError(f'{name}: weights prepared for {self.taps} '
                             f'tap(s) of {self.cin}, the call has {taps} '
                             f'of {cin}')

    def tensor_map(self, tile_n: int) -> ctypes.Array:
        """The 128-byte CUtensorMap of ``wt`` for tile_k × tile_n boxes."""
        key = (self.tile_k, tile_n)
        if key not in self._maps:
            buf = ctypes.create_string_buffer(128)
            code = _build.lib().hawq_sm90_weight_map(
                buf, self.wt.data_ptr(), self.n, self.taps * self.cpad,
                self.tile_k, tile_n)
            _build.check(code, 'hawq_sm90_weight_map')
            self._maps[key] = buf
        return self._maps[key]


def prepare_weights(w_flat: torch.Tensor, taps: int = 1) -> PreparedWeights:
    """(taps·C, N) int8 weights (a matmul's (K, N) is one tap) → their
    K-major layout for the Hopper core, on ``w_flat``'s device:
    wt[n, t·cpad + c] = w_flat[t·C + c, n], zeros for C ≤ c < cpad, cpad = C
    rounded up to a multiple of 64."""
    k, n = w_flat.shape
    if k % taps:
        raise ValueError(f'prepare_weights: K = {k} is not {taps} taps of '
                         f'equal C')
    cin = k // taps
    cpad = -(-cin // SM90_K_ALIGN) * SM90_K_ALIGN
    if taps == 1 and cpad == cin:          # a matmul with nothing to pad
        return PreparedWeights(w_flat.t().contiguous(), 1, cin, cin)
    wt = w_flat.reshape(taps, cin, n).permute(2, 0, 1)
    if cpad != cin:
        wt = F.pad(wt, (0, cpad - cin))
    return PreparedWeights(wt.contiguous().reshape(n, taps * cpad), taps, cin,
                           cpad)


def unprepare_weights(prepared: PreparedWeights) -> torch.Tensor:
    """Inverse of :func:`prepare_weights`: the (taps·C, N) weights."""
    p = prepared
    wt = p.wt.reshape(p.n, p.taps, p.cpad)[:, :, :p.cin]
    return wt.permute(1, 2, 0).reshape(p.k, p.n).contiguous()


def sm90_route(kind: str, *, k: int, n: int, ptr: int) -> Optional[str]:
    """The rule that sends a call to the Hopper core or to the first one:
    None where the Hopper core takes it, else the clause that excludes it.

    TMA needs every row stride and base pointer to be a multiple of 16
    bytes.  ``kind`` 'matmul' (``int8_matmul_acc``: x (M, K) int8 at
    ``ptr``, int32 output rows of N): K % 16, N % 4.  ``kind`` 'conv'
    (``int8_conv_requant``: slab pixels of ``k`` = C channels at ``ptr``,
    int8 output rows of N): C % 16, N % 16."""
    if kind not in ('matmul', 'conv'):
        raise ValueError(f'sm90_route: kind {kind!r}')
    if k % 16:
        return 'K % 16' if kind == 'matmul' else 'C % 16'
    n_align = 4 if kind == 'matmul' else 16
    if n % n_align:
        return f'N % {n_align}'
    if ptr % 16:
        return 'pointer % 16'
    return None


@functools.lru_cache(maxsize=None)
def sm90_tile_n(m_tiles: int, n: int, k_tiles: int, sm_count: int) -> int:
    """Width of the Hopper core's output tile: the widest of 128 and 64
    (not wider than twice N) whose grid still has two blocks for every
    three SMs, else 32; 64 at most where K is a single step.  Measured on
    the H100 at the ResNet-50 shapes (chip_sweep_sm90.py at the root of the
    repository): a wide tile reads A fewer times and wins wherever the grid
    stays that full; below it the narrower tile's extra blocks win; and a
    one-step call is all epilogue, where the narrower tile's smaller
    staging lets more blocks overlap their stores (M = 25088 and 100352,
    K = 64, N = 256: 11.4 against 12.8 µs and 48.7 against 54.5 at 64)."""
    widths = SM90_TILE_NS[1:2] if k_tiles == 1 else SM90_TILE_NS[:2]
    for tile_n in widths:
        if (2 * n > tile_n
                and 3 * m_tiles * -(-n // tile_n) >= 2 * sm_count):
            return tile_n
    return SM90_TILE_NS[2]


_SM_COUNT: Dict[torch.device, int] = {}


def sm_count(dev: torch.device) -> int:
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SM_COUNT[dev]


def pick_core(kind: str, name: str, core: Optional[str], *, k: int, n: int,
              ptr: int) -> str:
    """'sm90' or 'mma' for a call: by :func:`sm90_route`, or as ``core``
    asks; asking for 'sm90' where the rule excludes the shape raises."""
    reason = sm90_route(kind, k=k, n=n, ptr=ptr)
    if core not in (None, 'sm90', 'mma'):
        raise ValueError(f'{name}: core {core!r} not in (None, sm90, mma)')
    if core == 'sm90' and reason is not None:
        raise ValueError(f'{name}: the Hopper core does not take this call '
                         f'({reason})')
    return core or ('mma' if reason is not None else 'sm90')


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _launch_sm90(x, prepared: PreparedWeights, bias, tile_n: Optional[int],
                 smem_extra: int) -> torch.Tensor:
    """``int8_matmul_acc`` on the Hopper core."""
    m, k = x.shape
    n = prepared.n
    dev = _build.kernel_device(x)
    _build.require(x, 'x', torch.int8, (m, k), dev)
    prepared.check(1, k, 'int8_matmul_acc')
    _build.require(prepared.wt, 'prepared.wt', torch.int8,
                   (n, prepared.cpad), dev)
    _build.require(bias, 'bias', torch.int32, (n,), dev)
    if m < 1:
        raise ValueError('int8_matmul_acc: empty x')
    if tile_n is None:
        tile_n = sm90_tile_n(-(-m // SM90_TILE_M), n,
                             -(-k // prepared.tile_k), sm_count(dev))
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = _build.lib().hawq_int8_matmul_sm90(
            x.data_ptr(), prepared.tensor_map(tile_n), bias.data_ptr(),
            out.data_ptr(), m, k, n, prepared.tile_k, tile_n, smem_extra,
            _build.stream_ptr(dev))
    _build.check(code, 'int8_matmul_acc (sm90 core)')
    _build.count('int8_matmul_acc', 'sm90')
    return out


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
    _build.count(name, 'mma')
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


def int8_matmul_acc(x: torch.Tensor, w, bias: torch.Tensor, *,
                    core: Optional[str] = None,
                    tile_n: Optional[int] = None,
                    smem_extra: int = 0) -> torch.Tensor:
    """int8 matmul returning the raw int32 accumulator + bias.

    ``w`` is the (K, N) int8 tensor or its :func:`prepare_weights` handle.
    On a CUDA tensor the call runs on the Hopper core where
    :func:`sm90_route` admits it, else on the first core; ``core`` ('sm90' /
    'mma') overrides the rule, ``tile_n`` the Hopper core's tile width, and
    ``smem_extra`` adds to its shared-memory request (timing and tests).
    The result does not depend on any of them."""
    prepared = w if isinstance(w, PreparedWeights) else None
    if x.device.type == 'cpu':
        if prepared is not None:
            return matmul_acc_kmajor_plain(x, prepared, bias)
        return matmul_acc_plain(x, w, bias)
    n = prepared.n if prepared is not None else w.shape[1]
    core = pick_core('matmul', 'int8_matmul_acc', core, k=x.shape[1], n=n,
                     ptr=x.data_ptr())
    if core == 'mma':
        if prepared is not None:
            w = unprepare_weights(prepared)
        return _launch(x, w, bias, None, 0, 0, False, False)
    if prepared is None:
        _build.require(w, 'w', torch.int8, (x.shape[1], n), x.device)
        prepared = prepare_weights(w)
    return _launch_sm90(x, prepared, bias, tile_n, smem_extra)


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
