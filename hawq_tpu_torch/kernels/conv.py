"""Stride-1 implicit-GEMM integer convolution with fused dyadic requant (port
of hawq_tpu/kernels/conv.py ``int8_conv_requant`` / ``int8_conv_acc`` and
their nibble-packed int4-weight forms ``int4w_conv_requant`` /
``int4w_conv_acc``), and the host layout helpers around it.

Same layouts and signatures as the reference: the input is the zero-padded
(B, Hp, Wp·C) slab of :func:`prepare_conv_input`, the weights the
(kh·kw·C, N) flattening of an HWIO kernel (or its per-tap split-C packing,
:func:`pack_int4_conv`), the output (B, H·W, N).  Stride 2 is rewritten to
stride 1 by space-to-depth (:func:`s2d_conv_transform`).

On a CUDA tensor each wrapper launches the hand-written GEMM core for
Hopper (csrc/conv_sm90.cu and csrc/conv_int4_sm90.cu over
csrc/gemm_s8_sm90.cuh; any taps, C and N, the int4 forms need an even C);
on a CPU tensor it runs the plain version, a tap-decomposed float64 product
that is exact for these integer sums.  The M tiles are rectangles of
output pixels (:func:`conv_tile_plan`) so that every tap of a tile is one
TMA box of the slab, and the weights are the K-major layout of
``matmul.prepare_weights`` / ``matmul.prepare_weights_int4`` (a handle, or
laid out on the device at each call); the int4 forms keep them
nibble-packed in device memory and unpack them inside the kernel.  A slab
whose C is not a multiple of 16, or an output whose rows are not whole 16
bytes, is zero-padded first by ``matmul.sm90_operands``.
:func:`conv_acc_tiled_plain` is the plain version of that walk,
:func:`conv_requant_tiled_plain` its requant.

The four run as the operators ``torch.ops.hawq.<wrapper name>`` (:data:`OPS`,
as ``matmul.OPS``): the border's zero fill (TMA's) and the tile are chosen
at launch.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hawq_tpu_torch.kernels import _build
from hawq_tpu_torch.kernels.matmul import (SM90_ALIGN, SM90_K_ALIGN,
                                           SM90_TILE_M, PreparedWeights,
                                           epilogue_bounds, pack_int4,
                                           prepare_weights,
                                           prepare_weights_int4,
                                           requant_epilogue, sm90_operands,
                                           sm90_tile_n, sm_count,
                                           unpack_int4)


# ---------------------------------------------------------------------------
# host-side layout helpers
# ---------------------------------------------------------------------------

def flatten_conv_kernel(w: np.ndarray) -> np.ndarray:
    """(kh, kw, C, O) HWIO → (kh·kw·C, O), row = (dy·kw + dx)·C + c."""
    kh, kw, c, o = w.shape
    return np.ascontiguousarray(w.reshape(kh * kw * c, o))


def pack_int4_conv(w_flat: np.ndarray, taps: int) -> np.ndarray:
    """Per-tap split-C nibble packing of a flattened conv kernel.

    w_flat (taps·C, N) int4-valued int8 → (taps·C/2, N) bytes; within each
    tap block, byte[c, n] = (W[c + C/2, n] << 4) | (W[c, n] & 0xF)."""
    k, n = w_flat.shape
    return pack_int4(w_flat.reshape(taps, k // taps, n)).reshape(k // 2, n)


def unpack_int4_conv(w_packed: torch.Tensor, taps: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4_conv` in torch → (taps·C, N) int8."""
    kh, n = w_packed.shape
    return unpack_int4(w_packed.reshape(taps, kh // taps, n)).reshape(
        2 * kh, n)


def prepare_conv_input(x8: torch.Tensor, pad: Tuple[int, int]) -> torch.Tensor:
    """NHWC int8 → symmetrically zero-padded (B, H+2ph, (W+2pw)·C) slab."""
    b, h, w, c = x8.shape
    ph, pw = pad
    if ph or pw:
        x8 = F.pad(x8, (0, 0, pw, pw, ph, ph))
    return x8.contiguous().reshape(b, h + 2 * ph, (w + 2 * pw) * c)


def s2d_input(x8: torch.Tensor, pad: int) -> torch.Tensor:
    """Space-to-depth half of the stride-2 rewrite: pad, make even, fold
    2×2 pixel blocks into channels → (B, ⌈(H+2p)/2⌉, ⌈(W+2p)/2⌉, 4C)."""
    b, h, w, c = x8.shape
    hp, wp = h + 2 * pad, w + 2 * pad
    xp = F.pad(x8, (0, 0, pad, pad + wp % 2, pad, pad + hp % 2))
    hp += hp % 2
    wp += wp % 2
    x2 = xp.reshape(b, hp // 2, 2, wp // 2, 2, c)
    return x2.permute(0, 1, 3, 2, 4, 5).reshape(b, hp // 2, wp // 2, 4 * c)


def s2d_kernel(w: np.ndarray) -> np.ndarray:
    """Kernel half of the stride-2 rewrite: (kh, kw, C, O) → (a, b, 4C, O),
    zero-padded to the next even size, 2×2-folded in (cy, cx, c) order."""
    kh, kw, c, o = w.shape
    a, b2 = (kh + 2) // 2, (kw + 2) // 2
    wpad = np.zeros((2 * a, 2 * b2, c, o), w.dtype)
    wpad[:kh, :kw] = w
    w2 = wpad.reshape(a, 2, b2, 2, c, o).transpose(0, 2, 1, 3, 4, 5)
    return np.ascontiguousarray(w2.reshape(a, b2, 4 * c, o))


def flatten_conv_kernel_torch(w: torch.Tensor) -> torch.Tensor:
    """:func:`flatten_conv_kernel` on a tensor, on its own device."""
    kh, kw, c, o = w.shape
    return w.contiguous().reshape(kh * kw * c, o)


def s2d_kernel_torch(w: torch.Tensor) -> torch.Tensor:
    """:func:`s2d_kernel` on a tensor, on its own device: in training the
    weights change every step and live on the device, so the rewrite must
    not pass through the host."""
    kh, kw, c, o = w.shape
    a, b2 = (kh + 2) // 2, (kw + 2) // 2
    wpad = F.pad(w, (0, 0, 0, 0, 0, 2 * b2 - kw, 0, 2 * a - kh))
    w2 = wpad.reshape(a, 2, b2, 2, c, o).permute(0, 2, 1, 3, 4, 5)
    return w2.reshape(a, b2, 4 * c, o)


def s2d_conv_transform(x8: torch.Tensor, w: np.ndarray, pad: int
                       ) -> Tuple[torch.Tensor, np.ndarray]:
    """Rewrite a stride-2 conv as a stride-1 VALID conv via space-to-depth
    (identical integer products)."""
    return s2d_input(x8, pad), s2d_kernel(w)


def s2d_output_hw(h: int, w: int, kh: int, kw: int, pad: int
                  ) -> Tuple[int, int]:
    """Output spatial size of the stride-2 conv the transform replaces."""
    return ((h + 2 * pad - kh) // 2 + 1, (w + 2 * pad - kw) // 2 + 1)


def pad_nhwc(x: torch.Tensor, pad, value=0) -> torch.Tensor:
    """Pad an NHWC tensor by ((top, bottom), (left, right)) with ``value``
    (zero by default)."""
    (t, b), (l, r) = pad
    if t or b or l or r:
        return F.pad(x, (0, 0, l, r, t, b), value=value)
    return x


def conv_call(x8: torch.Tensor, taps: Tuple[int, int],
              strides: Tuple[int, int], pad):
    """How the stride-1 conv kernels run a k×k int8 conv of the NHWC
    ``x8`` with a ``taps`` = (kh, kw) kernel, ``strides`` and ``pad`` =
    ((top, bottom), (left, right)) → (xp, geometry), the geometry being the
    keywords ``taps``, ``out_hw``, ``cin`` and ``pad`` of ``int8_conv_*``
    for the weights :func:`conv_call_kernel` rewrites:

      * stride 1 with a symmetric border on each axis: the unpadded
        activations, the border passed on as ``pad`` (TMA's zero fill on
        the card; on the CPU the wrapper pads a copy);
      * stride 1 otherwise: the padded slab;
      * stride 2: the space-to-depth rewrite of the padded input, its C
        zero-filled to a multiple of 4 first, so that the rewrite's 4·C
        is whole 16-byte pixels, as the Hopper core's TMA reads them (zero
        activations meet zero weights; the RGB image's 3 → 4), cut or
        zero-extended to the rows and columns the rewritten kernel reads
        (an even kernel size gains a zero tap, and with it one more zero
        row or column of input).

    The engines and the QAT layers' integer conv both take this route."""
    kh, kw = taps
    (t, bo), (l, r) = pad
    b, h, w, c = x8.shape
    sh, sw = strides
    if (sh, sw) == (1, 1):
        oh, ow = h + t + bo - kh + 1, w + l + r - kw + 1
        if t == bo and l == r:
            return (x8.contiguous().reshape(b, h, w * c),
                    dict(taps=(kh, kw), out_hw=(oh, ow), cin=c, pad=(t, l)))
        return (prepare_conv_input(pad_nhwc(x8, pad), (0, 0)),
                dict(taps=(kh, kw), out_hw=(oh, ow), cin=c, pad=(0, 0)))
    if (sh, sw) != (2, 2):
        raise NotImplementedError(
            f'conv_call: strides {strides} with a {kh}×{kw} kernel (the '
            f'integer conv kernels run stride 1, and stride 2 through '
            f'space-to-depth)')
    dc = -c % 4
    oh, ow = s2d_output_hw(h + t + bo, w + l + r, kh, kw, 0)
    a, b2 = (kh + 2) // 2, (kw + 2) // 2
    xs = s2d_input(F.pad(x8, (0, dc, l, r, t, bo)), 0)
    xs = xs[:, :oh + a - 1, :ow + b2 - 1]
    xs = pad_nhwc(xs, ((0, oh + a - 1 - xs.shape[1]),
                        (0, ow + b2 - 1 - xs.shape[2])))
    return (prepare_conv_input(xs, (0, 0)),
            dict(taps=(a, b2), out_hw=(oh, ow), cin=4 * (c + dc),
                 pad=(0, 0)))


def conv_call_kernel(w, strides: Tuple[int, int]):
    """The HWIO kernel (numpy or torch, on its own device) rewritten for
    :func:`conv_call`'s geometry: as it is at stride 1; at stride 2 its C
    zero-filled to a multiple of 4, then the space-to-depth rewrite."""
    if tuple(strides) == (1, 1):
        return w
    dc = -w.shape[2] % 4
    if isinstance(w, np.ndarray):
        return s2d_kernel(np.pad(w, ((0, 0), (0, 0), (0, dc), (0, 0))))
    return s2d_kernel_torch(F.pad(w, (0, 0, 0, dc)))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def conv_acc_plain(xp, w_flat, bias, *, taps, out_hw, cin):
    """Tap-decomposed conv accumulator + bias → (B, H·W, N) int32, exact
    through float64."""
    kh, kw = taps
    h, w = out_hw
    b = xp.shape[0]
    x4 = xp.reshape(b, h + kh - 1, w + kw - 1, cin)
    wd = w_flat.to(torch.float64)
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            t = dy * kw + dx
            xs = x4[:, dy:dy + h, dx:dx + w, :].reshape(b * h * w, cin)
            d = xs.to(torch.float64) @ wd[t * cin:(t + 1) * cin]
            acc = d if acc is None else acc + d
    return acc.to(torch.int32).reshape(b, h * w, -1) + bias


def conv_requant_plain(xp, w_flat, bias, mult, *, taps, out_hw, cin, lo, hi):
    acc = conv_acc_plain(xp, w_flat, bias, taps=taps, out_hw=out_hw, cin=cin)
    return requant_epilogue(acc, mult, lo, hi)


def _slab_shape(b, taps, out_hw, cin, pad=(0, 0)):
    """Shape of the conv input: the padded slab, less ``pad`` rows / columns
    of zero border on each side."""
    return (b, out_hw[0] + taps[0] - 1 - 2 * pad[0],
            (out_hw[1] + taps[1] - 1 - 2 * pad[1]) * cin)


def pad_conv_input(x, pad, *, taps, out_hw, cin):
    """The activations that lack ``pad`` rows / columns of zero border, (B,
    Hi, Wi·C) → the padded slab (B, Hp, Wp·C)."""
    b = x.shape[0]
    want = _slab_shape(b, taps, out_hw, cin, pad)
    if tuple(x.shape) != want:
        raise ValueError(f'xp: shape {tuple(x.shape)}, expected {want}')
    return prepare_conv_input(x.reshape(b, want[1], want[2] // cin, cin), pad)


# The Hopper core's M tile: a th × tw rectangle of th·tw = 64 output pixels
# of one image.
_TILE_SHAPES = ((8, 8), (4, 16), (16, 4), (2, 32), (32, 2), (1, 64), (64, 1))


@functools.lru_cache(maxsize=None)
def conv_tile_plan(h: int, w: int) -> Tuple[int, int]:
    """(th, tw) of the pixel rectangles that cover an h × w output image in
    the fewest tiles (the squarer shape on a tie): 8×8 at 56², 14² and 7²,
    4×16 at 28²."""
    return min(_TILE_SHAPES,
               key=lambda t: -(-h // t[0]) * -(-w // t[1]))


def sm90_row_taps(taps: Tuple[int, int], cin: int,
                  pad: Tuple[int, int] = (0, 0)) -> int:
    """Taps of a kernel row the Hopper core reads as one: kw where C is not
    a multiple of 64 but of 16 and the slab is read whole along x (no zero
    border left to TMA there), else 1.  A row's kw·C bytes are contiguous
    in the slab, so one TMA box over a map whose pixels are kw·C bytes
    wide, C bytes apart, holds the whole row: K is padded to 64 once a row,
    not once a tap (the RGB init's 4×4 taps of C = 16: 64 bytes a row, not
    4 × 64), and the box's inner extent is whole.  The map's pixels must
    lie 16 bytes apart, so a C that is not a multiple of 16 reads a tap at
    a time, over the slab that ``matmul.sm90_operands`` zero-fills to a
    multiple of 16 channels."""
    kw = taps[1]
    return (kw if kw > 1 and pad[1] == 0 and cin % SM90_K_ALIGN
            and cin % SM90_ALIGN == 0 else 1)


def prepare_conv_weights(weights: torch.Tensor, taps: Tuple[int, int],
                         cin: int, pad: Tuple[int, int] = (0, 0),
                         int4: bool = False) -> PreparedWeights:
    """The Hopper-core handle of a conv's flat weights (with ``int4`` its
    per-tap packed bytes), laid out for the walk the core takes on a call
    of this geometry: a kernel row read as one tap where
    :func:`sm90_row_taps` says so."""
    prepare = prepare_weights_int4 if int4 else prepare_weights
    return prepare(weights, taps[0] * taps[1], sm90_row_taps(taps, cin, pad))


def sm90_conv_tile_n(prepared: PreparedWeights, b: int,
                     out_hw: Tuple[int, int], sm: int) -> int:
    """The Hopper core's tile width for a conv of ``b`` images onto
    ``out_hw`` with these weights: ``matmul.sm90_tile_n`` over its
    :func:`conv_tile_plan` tiles and K steps, at most 64 wide for packed
    weights (the unpack's shared-memory traffic grows with the width)."""
    h, w = out_hw
    th, tw = conv_tile_plan(h, w)
    return sm90_tile_n(b * -(-h // th) * -(-w // tw), prepared.n,
                       prepared.taps * (prepared.cpad // prepared.tile_k), sm,
                       64 if prepared.int4 else 128)


def conv_acc_tiled_plain(xp, prepared: PreparedWeights, bias, *, taps,
                         out_hw, cin):
    """:func:`conv_acc_plain` by the Hopper core's walk: the output image
    cut into :func:`conv_tile_plan` rectangles; for each tap the
    rectangle's box of the slab, zero-filled where it leaves the slab (as
    TMA does) and in the channels up to the weights' padded C; the product
    against the K-major ``prepared.wt`` (a packed int4 handle unpacked chunk
    by chunk, as the kernel does), its N columns zero-filled to the bias's
    width (an output widened by ``matmul.sm90_operands``); pixels outside
    the image dropped at the store → (B, H·W, N) int32."""
    kh, kw = taps
    h, w = out_hw
    b = xp.shape[0]
    prepared.check(kh * kw, cin, 'int4w_conv_acc' if prepared.int4
                   else 'int8_conv_acc')
    x4 = xp.reshape(b, h + kh - 1, w + kw - 1, cin)
    if prepared.row_taps > 1:
        # a kernel row as one pixel of kw·C channels, as TMA reads it
        x4 = torch.cat([x4[:, :, dx:dx + w] for dx in range(kw)], dim=-1)
        kw, cin = 1, kw * cin
    th, tw = conv_tile_plan(h, w)
    ty, tx = -(-h // th), -(-w // tw)
    cpad = prepared.cpad
    x4 = F.pad(x4, (0, cpad - cin, 0, tx * tw - w, 0, ty * th - h))
    wd = prepared.kmajor_int8().to(torch.float64)
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            t = dy * kw + dx
            box = x4[:, dy:dy + ty * th, dx:dx + tx * tw, :]
            rows = box.reshape(b, ty, th, tx, tw, cpad).permute(
                0, 1, 3, 2, 4, 5).reshape(b * ty * tx * SM90_TILE_M, cpad)
            d = rows.to(torch.float64) @ wd[:, t * cpad:(t + 1) * cpad].t()
            acc = d if acc is None else acc + d
    acc = F.pad(acc, (0, bias.shape[0] - prepared.n))
    acc = acc.to(torch.int32).reshape(b, ty, tx, th, tw, -1).permute(
        0, 1, 3, 2, 4, 5).reshape(b, ty * th, tx * tw, -1)
    return acc[:, :h, :w, :].reshape(b, h * w, -1) + bias


def conv_requant_tiled_plain(xp, prepared: PreparedWeights, bias, mult, *,
                             taps, out_hw, cin, lo, hi):
    """:func:`conv_requant_plain` by the Hopper core's walk: the requant of
    :func:`conv_acc_tiled_plain`."""
    acc = conv_acc_tiled_plain(xp, prepared, bias, taps=taps, out_hw=out_hw,
                               cin=cin)
    return requant_epilogue(acc, mult, lo, hi)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _launch_sm90(name, xp, prepared: PreparedWeights, bias, mult, taps,
                 out_hw, cin, lo, hi, pad, tile_n: Optional[int],
                 smem_extra: int) -> torch.Tensor:
    """The four convs on the Hopper core: with ``mult`` the requant forms
    (int8 out), without it the accumulator forms (int32 out); the operands
    aligned by ``matmul.sm90_operands``."""
    requant = mult is not None
    kh, kw = taps
    h, w = out_hw
    b = xp.shape[0]
    n = prepared.n
    dev = _build.kernel_device(xp)
    _build.require(xp, 'xp', torch.int8, _slab_shape(b, taps, out_hw, cin,
                                                     pad), dev)
    prepared.check(kh * kw, cin, name)
    _build.require(prepared.wt, 'prepared.wt', torch.int8,
                   (n, prepared.row_bytes), dev)
    _build.require(bias, 'bias', torch.int32, (n,), dev)
    if requant:
        _build.require(mult, 'mult', torch.float32, (n,), dev)
    if b < 1 or h < 1 or w < 1:
        raise ValueError(f'{name}: empty output')
    xp, prepared, (bias, mult), _ = sm90_operands(
        xp, prepared, (bias, mult), 1 if requant else 4)
    cin, n_out = prepared.cin // prepared.row_taps, bias.shape[0]
    th, tw = conv_tile_plan(h, w)
    if tile_n is None:
        tile_n = sm90_conv_tile_n(prepared, b, out_hw, sm_count(dev))
    out = torch.empty((b, h * w, n_out),
                      dtype=torch.int8 if requant else torch.int32, device=dev)
    lib = _build.lib()
    shape = (b, h, w, cin, kh, kw, n_out)
    tail = (prepared.row_taps, prepared.cpad, prepared.tile_k, tile_n, th,
            tw, pad[0], pad[1], smem_extra, _build.stream_ptr(dev))
    with torch.cuda.device(dev):
        if requant:
            entry = (lib.hawq_int4w_conv_sm90 if prepared.int4
                     else lib.hawq_int8_conv_sm90)
            code = entry(xp.data_ptr(), prepared.tensor_map(tile_n),
                         bias.data_ptr(), mult.data_ptr(), out.data_ptr(),
                         *shape, lo, hi, *tail)
        else:
            entry = (lib.hawq_int4w_conv_acc_sm90 if prepared.int4
                     else lib.hawq_int8_conv_acc_sm90)
            code = entry(xp.data_ptr(), prepared.tensor_map(tile_n),
                         bias.data_ptr(), out.data_ptr(), *shape, *tail)
    _build.check(code, name)
    _build.count(name)
    return out if n_out == n else out[..., :n].contiguous()


def _handle(w, cpad, row_taps, taps, cin, int4) -> PreparedWeights:
    """The handle whose ``wt`` is ``w``, for a call of ``taps`` taps of
    ``cin`` channels read in rows of ``row_taps``."""
    return PreparedWeights(w, taps[0] * taps[1] // row_taps, cin * row_taps,
                           cpad, int4, row_taps)


def _conv_plain(name, xp, w, cpad, row_taps, bias, mult, lo, hi, taps,
                out_hw, cin, pad) -> torch.Tensor:
    """The four convs' CPU implementation (``mult`` None for the
    accumulator forms): the plain version, or where ``cpad`` is not 0
    (``w`` a handle's K-major ``wt``) that of the Hopper core's walk, on the
    input padded first."""
    int4 = name.startswith('int4w')
    taps, out_hw, pad = tuple(taps), tuple(out_hw), tuple(pad)
    if pad != (0, 0):
        xp = pad_conv_input(xp, pad, taps=taps, out_hw=out_hw, cin=cin)
    geo = dict(taps=taps, out_hw=out_hw, cin=cin)
    if cpad:
        acc = conv_acc_tiled_plain(
            xp, _handle(w, cpad, row_taps, taps, cin, int4), bias, **geo)
    else:
        if int4:
            w = unpack_int4_conv(w, taps[0] * taps[1])
        acc = conv_acc_plain(xp, w, bias, **geo)
    return requant_epilogue(acc, mult, lo, hi) if mult is not None else acc


def _conv_cuda(name, xp, w, cpad, row_taps, bias, mult, lo, hi, taps,
               out_hw, cin, pad, tile_n, smem_extra) -> torch.Tensor:
    """The four convs' CUDA implementation: the Hopper core on the handle's
    layout (``cpad`` not 0) or on plain weights laid out here."""
    int4 = name.startswith('int4w')
    taps, out_hw, pad = tuple(taps), tuple(out_hw), tuple(pad)
    if cpad:
        prepared = _handle(w, cpad, row_taps, taps, cin, int4)
    else:
        if int4 and cin % 2:
            raise ValueError(f'{name} needs an even C per tap, got {cin}')
        _build.require(w, 'w_packed' if int4 else 'w_flat', torch.int8,
                       (taps[0] * taps[1] * (cin // 2 if int4 else cin),
                        w.shape[1]), xp.device)
        prepared = prepare_conv_weights(w, taps, cin, pad, int4)
    return _launch_sm90(name, xp, prepared, bias, mult, taps, out_hw, cin, lo,
                        hi, pad, _build.from_opt_int(tile_n), smem_extra)


def _define_conv(name: str):
    """``hawq::<name>(xp, w, cpad, row_taps, bias, mult, lo, hi, taps,
    out_hw, cin, pad, tile_n, smem_extra)``: ``cpad`` 0 for plain weights,
    else with ``row_taps`` the handle whose ``wt`` is ``w``; ``mult`` None
    (``lo``, ``hi`` 0) for the accumulator forms; ``tile_n`` −1 for the
    rule's."""
    requant = name.endswith('_requant')

    def cpu(xp, w, cpad, row_taps, bias, mult, lo, hi, taps, out_hw, cin,
            pad, tile_n, smem_extra):
        return _conv_plain(name, xp, w, cpad, row_taps, bias, mult, lo, hi,
                           taps, out_hw, cin, pad)

    def cuda(xp, w, cpad, row_taps, bias, mult, lo, hi, taps, out_hw, cin,
             pad, tile_n, smem_extra):
        return _conv_cuda(name, xp, w, cpad, row_taps, bias, mult, lo, hi,
                          taps, out_hw, cin, pad, tile_n, smem_extra)

    def fake(xp, w, cpad, row_taps, bias, mult, lo, hi, taps, out_hw, cin,
             pad, tile_n, smem_extra):
        return xp.new_empty((xp.shape[0], out_hw[0] * out_hw[1],
                             w.shape[0] if cpad else w.shape[1]),
                            dtype=torch.int8 if requant else torch.int32)
    return _build.define_op(
        f'{name}(Tensor xp, Tensor w, int cpad, int row_taps, Tensor bias, '
        f'Tensor? mult, int lo, int hi, int[] taps, int[] out_hw, int cin, '
        f'int[] pad, int tile_n, int smem_extra) -> Tensor', cpu, cuda, fake)


OPS = {name: _define_conv(name) for name in (
    'int8_conv_requant', 'int8_conv_acc', 'int4w_conv_requant',
    'int4w_conv_acc')}


def _conv(name, xp, weights, bias, mult, taps, out_hw, cin, lo, hi, pad,
          tile_n, smem_extra):
    """The four convs (``mult`` None for the accumulator forms) through
    their operators: a handle taken apart into its ``wt``, padded C and row
    taps, the geometry and options into ints."""
    n_taps = taps[0] * taps[1]
    pad = (int(pad[0]), int(pad[1]))
    cpad, row_taps = 0, 1
    if isinstance(weights, PreparedWeights):
        weights.check(n_taps, cin, name)
        if weights.row_taps > 1 and (weights.row_taps != taps[1] or pad[1]):
            raise ValueError(f'{name}: weights prepared to read rows of '
                             f'{weights.row_taps} taps, the call has '
                             f'{taps[1]} a row and a border of {pad[1]}')
        weights, cpad, row_taps = weights.wt, weights.cpad, weights.row_taps
    return OPS[name](xp, weights, cpad, row_taps, bias, mult, lo, hi,
                     [int(t) for t in taps], [int(v) for v in out_hw],
                     int(cin), list(pad), _build.opt_int(tile_n), smem_extra)


def int8_conv_requant(xp, w_flat, bias, mult, *, taps, out_hw, cin,
                      out_bits=8, signed=True, relu=False,
                      pad: Tuple[int, int] = (0, 0),
                      tile_n: Optional[int] = None, smem_extra: int = 0):
    """Stride-1 int8 conv + fused dyadic requant → (B, H·W, N) int8.

    xp from :func:`prepare_conv_input`, w_flat from
    :func:`flatten_conv_kernel` (or its ``prepare_weights(w_flat, kh·kw)``
    handle), bias (N,) int32, mult (N,) f32 dyadic multipliers.  relu=True
    clamps the low end at 0.

    With ``pad`` = (ph, pw), xp is the activations that still lack ph rows
    and pw columns of zero border on each side, (B, H + kh − 1 − 2ph,
    (W + kw − 1 − 2pw)·C): on the card TMA's out-of-bounds zero fill
    supplies the border, so no padded copy is made; on the CPU the wrapper
    pads first.

    On a CUDA tensor ``tile_n`` sets the Hopper core's tile width, and
    ``smem_extra`` adds to its shared-memory request (timing and tests).
    The result does not depend on either."""
    lo, hi = epilogue_bounds(out_bits, signed, relu)
    return _conv('int8_conv_requant', xp, w_flat, bias, mult, taps, out_hw,
                 cin, lo, hi, pad, tile_n, smem_extra)


def int8_conv_acc(xp, w_flat, bias, *, taps, out_hw, cin,
                  pad: Tuple[int, int] = (0, 0),
                  tile_n: Optional[int] = None, smem_extra: int = 0):
    """Stride-1 int8 conv returning the raw int32 accumulator + bias →
    (B, H·W, N) int32.  ``w_flat`` (or its ``prepare_weights`` handle),
    ``pad``, ``tile_n`` and ``smem_extra`` as in
    :func:`int8_conv_requant`."""
    return _conv('int8_conv_acc', xp, w_flat, bias, None, taps, out_hw, cin,
                 0, 0, pad, tile_n, smem_extra)


def int4w_conv_requant(xp, w_packed, bias, mult, *, taps, out_hw, cin,
                       out_bits=8, signed=True, relu=False,
                       pad: Tuple[int, int] = (0, 0),
                       tile_n: Optional[int] = None, smem_extra: int = 0):
    """:func:`int8_conv_requant` with nibble-packed int4 weights: w_packed
    (kh·kw·C/2, N) from :func:`pack_int4_conv`, or its
    ``prepare_weights_int4(w_packed, kh·kw)`` handle; C even.  On the card
    the weights stay packed in device memory and the kernel unpacks them;
    ``pad``, ``tile_n`` and ``smem_extra`` as in
    :func:`int8_conv_requant`."""
    lo, hi = epilogue_bounds(out_bits, signed, relu)
    return _conv('int4w_conv_requant', xp, w_packed, bias, mult, taps,
                 out_hw, cin, lo, hi, pad, tile_n, smem_extra)


def int4w_conv_acc(xp, w_packed, bias, *, taps, out_hw, cin,
                   pad: Tuple[int, int] = (0, 0),
                   tile_n: Optional[int] = None, smem_extra: int = 0):
    """:func:`int8_conv_acc` with nibble-packed int4 weights: w_packed from
    :func:`pack_int4_conv`, or its ``prepare_weights_int4`` handle (kept
    packed on the card); C even."""
    return _conv('int4w_conv_acc', xp, w_packed, bias, None, taps, out_hw,
                 cin, 0, 0, pad, tile_n, smem_extra)
