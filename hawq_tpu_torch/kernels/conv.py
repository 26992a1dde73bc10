"""Stride-1 implicit-GEMM integer convolution with fused dyadic requant (port
of hawq_tpu/kernels/conv.py ``int8_conv_requant`` / ``int8_conv_acc`` and
their nibble-packed int4-weight forms ``int4w_conv_requant`` /
``int4w_conv_acc``), and the host layout helpers around it.

Same layouts and signatures as the reference: the input is the zero-padded
(B, Hp, Wp·C) slab of :func:`prepare_conv_input`, the weights the
(kh·kw·C, N) flattening of an HWIO kernel (or its per-tap split-C packing,
:func:`pack_int4_conv`), the output (B, H·W, N).  Stride 2 is rewritten to
stride 1 by space-to-depth (:func:`s2d_conv_transform`).

On a CUDA tensor each wrapper launches the hand-written kernel
(csrc/conv.cu over csrc/gemm_s8.cuh: any taps, C and N, ragged edges
masked; the int4 forms need an even C); on a CPU tensor it runs the plain
version, a tap-decomposed float64 product that is exact for these integer
sums.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hawq_tpu_torch.kernels import _build
from hawq_tpu_torch.kernels.matmul import (epilogue_bounds, pack_int4,
                                           requant_epilogue, unpack_int4)


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


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _launch(xp, w_flat, bias, mult, taps, out_hw, cin, lo, hi,
            requant: bool, int4: bool) -> torch.Tensor:
    kh, kw = taps
    h, w = out_hw
    b = xp.shape[0]
    n = w_flat.shape[1]
    if int4 and cin % 2:
        raise ValueError(f'int4w conv needs an even C per tap, got {cin}')
    dev = _build.kernel_device(xp)
    _build.require(xp, 'xp', torch.int8, (b, h + kh - 1, (w + kw - 1) * cin),
                   dev)
    _build.require(w_flat, 'w_packed' if int4 else 'w_flat', torch.int8,
                   (kh * kw * (cin // 2 if int4 else cin), n), dev)
    _build.require(bias, 'bias', torch.int32, (n,), dev)
    if requant:
        _build.require(mult, 'mult', torch.float32, (n,), dev)
    out = torch.empty((b, h * w, n),
                      dtype=torch.int8 if requant else torch.int32, device=dev)
    vec_a = int(cin % 16 == 0 and xp.data_ptr() % 16 == 0)
    vec_b = int(n % 4 == 0 and w_flat.data_ptr() % 4 == 0)
    name = (('int4w' if int4 else 'int8') + '_conv_'
            + ('requant' if requant else 'acc'))
    with torch.cuda.device(dev):
        code = _build.lib().hawq_int8_conv(
            xp.data_ptr(), w_flat.data_ptr(), bias.data_ptr(),
            mult.data_ptr() if requant else None, out.data_ptr(),
            b, h, w, cin, kh, kw, n, lo, hi, int(requant), int(int4), vec_a,
            vec_b, _build.stream_ptr(dev))
    _build.check(code, name)
    _build.count(name)
    return out


def int8_conv_requant(xp, w_flat, bias, mult, *, taps, out_hw, cin,
                      out_bits=8, signed=True, relu=False):
    """Stride-1 int8 conv + fused dyadic requant → (B, H·W, N) int8.

    xp from :func:`prepare_conv_input`, w_flat from
    :func:`flatten_conv_kernel`, bias (N,) int32, mult (N,) f32 dyadic
    multipliers.  relu=True clamps the low end at 0."""
    lo, hi = epilogue_bounds(out_bits, signed, relu)
    if xp.device.type == 'cpu':
        return conv_requant_plain(xp, w_flat, bias, mult, taps=taps,
                                  out_hw=out_hw, cin=cin, lo=lo, hi=hi)
    return _launch(xp, w_flat, bias, mult, taps, out_hw, cin, lo, hi, True,
                   False)


def int8_conv_acc(xp, w_flat, bias, *, taps, out_hw, cin):
    """Stride-1 int8 conv returning the raw int32 accumulator + bias."""
    if xp.device.type == 'cpu':
        return conv_acc_plain(xp, w_flat, bias, taps=taps, out_hw=out_hw,
                              cin=cin)
    return _launch(xp, w_flat, bias, None, taps, out_hw, cin, 0, 0, False,
                   False)


def int4w_conv_requant(xp, w_packed, bias, mult, *, taps, out_hw, cin,
                       out_bits=8, signed=True, relu=False):
    """:func:`int8_conv_requant` with nibble-packed int4 weights: w_packed
    (kh·kw·C/2, N) from :func:`pack_int4_conv`; C even."""
    lo, hi = epilogue_bounds(out_bits, signed, relu)
    if xp.device.type == 'cpu':
        return conv_requant_plain(
            xp, unpack_int4_conv(w_packed, taps[0] * taps[1]), bias, mult,
            taps=taps, out_hw=out_hw, cin=cin, lo=lo, hi=hi)
    return _launch(xp, w_packed, bias, mult, taps, out_hw, cin, lo, hi, True,
                   True)


def int4w_conv_acc(xp, w_packed, bias, *, taps, out_hw, cin):
    """:func:`int8_conv_acc` with nibble-packed int4 weights."""
    if xp.device.type == 'cpu':
        return conv_acc_plain(
            xp, unpack_int4_conv(w_packed, taps[0] * taps[1]), bias,
            taps=taps, out_hw=out_hw, cin=cin)
    return _launch(xp, w_packed, bias, None, taps, out_hw, cin, 0, 0, False,
                   True)
