"""The integer arithmetic of HAWQ-V3's integer-only inference, written out
plainly in PyTorch and NumPy for the benchmark's reference forwards.

Nothing here comes from the program under test.  The rules follow HAWQ-V3
(Yao et al. 2021, arXiv:2011.10680, section 3): a layer's int32 accumulator
is brought to the next layer's integer grid by a dyadic multiplier, and the
frozen models of the program state the rounding of each step:

* dyadic multiplier of a scale ratio r (float32): r = m·2^e with m in
  [0.5, 1); the multiplier is floor(m·2^23 + 0.5)·2^(e−23), an exact
  float32;
* requant: clip(floor(f32(acc)·mult + 0.5)), a rounded float32 product and
  then a rounded float32 add (no fused multiply-add);
* residual requant-add: each branch rounded on its own with its own
  multiplier, the float32 sum left unclamped;
* input quantization: clip(floor(x / s_in + 0.5)) with a true division;
* integer average pool: trunc(sum / hw + 0.01), a true division.

Convolutions run on integer tensors held in float64: every partial sum of
int8 × int8 products over a few thousand taps is an integer below 2^53, so
any summation order gives the exact result.  Tensors are NCHW; a
per-channel vector is broadcast over dim 1.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MANTISSA_BITS = 23


def dyadic_multiplier(ratio) -> np.ndarray:
    """The float32 dyadic multiplier of a scale ratio (scalar or vector)."""
    ratio = np.asarray(ratio, np.float32)
    m, e = np.frexp(ratio)
    m_int = np.floor(m * np.float32(2 ** MANTISSA_BITS) + np.float32(0.5))
    return np.ldexp(m_int.astype(np.float32),
                    (e - MANTISSA_BITS).astype(np.int32)).astype(np.float32)


def f32_scale(w_scale, act_scale) -> np.ndarray:
    """A conv's accumulator scale: weight scale × input activation scale,
    float32."""
    return np.asarray(w_scale, np.float32) * np.float32(act_scale)


def ratio(acc_scale, out_scale) -> np.ndarray:
    return (np.asarray(acc_scale, np.float32)
            / np.float32(out_scale)).astype(np.float32)


def bounds(bits: int, signed: bool = True):
    if signed:
        n = 2 ** (bits - 1) - 1
        return -n - 1, n
    return 0, 2 ** bits - 1


def channel(v, x: torch.Tensor) -> torch.Tensor:
    """A host vector (or scalar) as a tensor broadcast over dim 1 of the
    NCHW ``x`` (or the last dim of a 2-D ``x``), on its device."""
    t = torch.as_tensor(np.asarray(v), device=x.device)
    if t.dim() == 0:
        return t
    return t.reshape(-1, 1, 1) if x.dim() == 4 else t


def true_div(x: torch.Tensor, d) -> torch.Tensor:
    """IEEE division of a float32 tensor by a constant (a 0-dim tensor on
    x's device, so that no reciprocal is taken)."""
    return x / torch.tensor(np.float32(d), device=x.device)


def requant(acc: torch.Tensor, mult, bits: int,
            signed: bool = True) -> torch.Tensor:
    """clip(floor(f32(acc)·mult + 0.5)) → int64 integers."""
    y = acc.to(torch.float32) * channel(mult, acc)
    y = torch.floor(y + 0.5)
    lo, hi = bounds(bits, signed)
    return torch.clamp(y, lo, hi).to(torch.int64)


def requant_add(acc: torch.Tensor, mult_acc, identity: torch.Tensor,
                mult_id) -> torch.Tensor:
    """Two branches rounded on their own, the float32 sum unclamped."""
    a = torch.floor(acc.to(torch.float32) * channel(mult_acc, acc) + 0.5)
    b = torch.floor(identity.to(torch.float32) * channel(mult_id, identity)
                    + 0.5)
    return (a + b).to(torch.int64)


def quantize_input(x: torch.Tensor, s_in, bits: int = 8) -> torch.Tensor:
    """float32 NCHW images → integers, floor(x / s_in + 0.5), clipped."""
    lo, hi = bounds(bits)
    return torch.clamp(torch.floor(true_div(x, s_in) + 0.5), lo, hi
                       ).to(torch.int64)


def normalize_uint8(u8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NCHW pixels → (u/255 − mean)/std in float32, true divisions."""
    x = true_div(u8.to(torch.float32), 255.0)
    x = x - channel(np.asarray(mean, np.float32), x)
    return x / channel(np.asarray(std, np.float32), x)


def conv(x: torch.Tensor, w_hwio: np.ndarray, bias: np.ndarray,
         stride: int, pad: int, groups: int = 1) -> torch.Tensor:
    """Integer conv of NCHW integers with HWIO integer weights, + bias →
    int64, exact (float64 partial sums below 2^53)."""
    w = torch.as_tensor(np.ascontiguousarray(
        np.asarray(w_hwio).transpose(3, 2, 0, 1)), device=x.device)
    y = F.conv2d(x.to(torch.float64), w.to(torch.float64), stride=stride,
                 padding=pad, groups=groups)
    y = y + channel(np.asarray(bias, np.float64), y)
    return y.to(torch.int64)


def maxpool3x3s2(x: torch.Tensor) -> torch.Tensor:
    """3×3 / stride 2 / pad 1 max-pool of integers (exact in float64)."""
    return F.max_pool2d(x.to(torch.float64), 3, 2, 1).to(torch.int64)


def avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global integer average pool of NCHW integers → (B, C) integers,
    trunc(sum / hw + 0.01) in float32."""
    hw = x.shape[2] * x.shape[3]
    s = x.sum(dim=(2, 3)).to(torch.float32)
    return torch.trunc(true_div(s, float(hw)) + 0.01).to(torch.int64)


def logits(acc: torch.Tensor, w_scale, act_scale) -> torch.Tensor:
    """The head's int32 accumulator → float32 logits, acc·(w_scale·s)."""
    return acc.to(torch.float32) * torch.as_tensor(
        f32_scale(w_scale, act_scale), device=acc.device)
