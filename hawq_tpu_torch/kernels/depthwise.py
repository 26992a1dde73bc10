"""Depthwise 3×3 int8 convolution, pad 1, stride 1 or 2 (MobileNetV2's
conv2): D1, a kernel the TPU package does not have.

``hawq_tpu`` runs the depthwise conv as XLA's int8 grouped convolution, or
as nine shifted int32 multiply-adds (``engine_mobilenet.py _dw_shifted``).
CUDA PyTorch has no integer convolution, so on a CUDA tensor each wrapper
launches csrc/depthwise.cu; on a CPU tensor it runs the plain version, the
nine shifted multiply-adds in int32 (:func:`dwconv_acc_plain`,
:func:`dwconv_requant_plain`).

Layouts are the frozen model's: x (B, H, W, C) int8 NHWC, w (3, 3, 1, C)
int8 HWIO, bias (C,) int32; the output is (B, ⌊(H−1)/s⌋+1, ⌊(W−1)/s⌋+1, C).
"""

from __future__ import annotations

import torch

from hawq_tpu_torch.kernels import _build
from hawq_tpu_torch.quant.ops import round_half_up

VEC = 16          # channels a thread takes in the kernel's vector form


def dw_output_hw(h: int, w: int, stride: int):
    return (h - 1) // stride + 1, (w - 1) // stride + 1


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


def dwconv_requant_plain(x8: torch.Tensor, w8: torch.Tensor,
                         bias: torch.Tensor, hi6: torch.Tensor,
                         mult: torch.Tensor, stride: int, lo: float,
                         hi: float) -> torch.Tensor:
    """Plain version of :func:`int8_dwconv_requant`: the accumulator
    clamped to [0, hi6], then clip(floor(f32(acc)·mult + 0.5), lo, hi)."""
    acc = dwconv_acc_plain(x8, w8, bias, stride)
    acc = torch.minimum(torch.clamp_min(acc, 0), hi6)
    out = round_half_up(acc.to(torch.float32) * mult)
    return torch.clamp(out, lo, hi).to(torch.int8)


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


def _vector(c, *tensors):
    """Whether the kernel can take 16 channels a thread: C % 16 and every
    pointer 16-byte aligned."""
    return int(c % VEC == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def int8_dwconv_acc(x8: torch.Tensor, w8: torch.Tensor, bias: torch.Tensor,
                    *, stride: int) -> torch.Tensor:
    """Depthwise 3×3 conv, pad 1, → int32 accumulator + bias (the QAT
    forward's grouped conv)."""
    if x8.device.type == 'cpu':
        return dwconv_acc_plain(x8, w8, bias, stride)
    name = 'int8_dwconv_acc'
    dev = _build.kernel_device(x8)
    c = _check(name, x8, w8, bias, stride, dev)
    b, h, w, _ = x8.shape
    out = torch.empty((b, *dw_output_hw(h, w, stride), c), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        code = _build.lib().hawq_dwconv_acc(
            x8.data_ptr(), w8.data_ptr(), bias.data_ptr(), out.data_ptr(), b,
            h, w, c, stride, _vector(c, x8, w8, bias, out),
            _build.stream_ptr(dev))
    _build.check(code, name)
    _build.count(name, 'cuda')
    return out


def int8_dwconv_requant(x8: torch.Tensor, w8: torch.Tensor,
                        bias: torch.Tensor, hi6: torch.Tensor,
                        mult: torch.Tensor, *, stride: int, lo: float,
                        hi: float) -> torch.Tensor:
    """The accumulator of :func:`int8_dwconv_acc` clamped to [0, hi6[c]]
    (ReLU6 on the integer side; hi6 (C,) int32) and requantized to int8 with
    mult (C,) float32: clip(floor(f32(acc)·mult + 0.5), lo, hi)."""
    if x8.device.type == 'cpu':
        return dwconv_requant_plain(x8, w8, bias, hi6, mult, stride, lo, hi)
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
    with torch.cuda.device(dev):
        code = _build.lib().hawq_dwconv_requant(
            x8.data_ptr(), w8.data_ptr(), bias.data_ptr(), hi6.data_ptr(),
            mult.data_ptr(), out.data_ptr(), b, h, w, c, stride, int(lo),
            int(hi), _vector(c, x8, w8, bias, hi6, mult, out),
            _build.stream_ptr(dev))
    _build.check(code, name)
    _build.count(name, 'cuda')
    return out
