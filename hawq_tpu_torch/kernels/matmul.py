"""int8 matmul with fused dyadic requant epilogues (port of
hawq_tpu/kernels/matmul.py ``int8_matmul_requant`` / ``int8_matmul_acc``).

On a CUDA tensor each wrapper launches the hand-written tensor-core kernel
(csrc/matmul.cu over csrc/gemm_s8.cuh, any M, K and N); on a CPU tensor it
runs the plain PyTorch version beside it.  The plain versions compute the
int32 accumulator exactly through float64 (every sum here is far below
2⁵³) and repeat the kernel's epilogue op for op.
"""

from __future__ import annotations

from typing import Tuple

import torch

from hawq_tpu_torch.kernels import _build
from hawq_tpu_torch.quant.ops import requant_clip_bounds, round_half_up


def epilogue_bounds(out_bits: int, signed: bool,
                    relu: bool) -> Tuple[int, int]:
    """Clip bounds of the requant epilogue; ``relu`` clamps low at 0."""
    lo, hi = requant_clip_bounds(out_bits, signed)
    return (0 if relu else int(lo)), int(hi)


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


def _launch(x, w, bias, mult, lo, hi, requant: bool) -> torch.Tensor:
    m, k = x.shape
    n = w.shape[1]
    dev = _build.kernel_device(x)
    _build.require(x, 'x', torch.int8, (m, k), dev)
    _build.require(w, 'w', torch.int8, (k, n), dev)
    _build.require(bias, 'bias', torch.int32, (n,), dev)
    if requant:
        _build.require(mult, 'mult', torch.float32, (n,), dev)
    out = torch.empty((m, n), dtype=torch.int8 if requant else torch.int32,
                      device=dev)
    vec_a = int(k % 16 == 0 and x.data_ptr() % 16 == 0)
    vec_b = int(n % 4 == 0 and w.data_ptr() % 4 == 0)
    name = 'int8_matmul_requant' if requant else 'int8_matmul_acc'
    with torch.cuda.device(dev):
        code = _build.lib().hawq_int8_matmul(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(),
            mult.data_ptr() if requant else None, out.data_ptr(),
            m, k, n, lo, hi, int(requant), vec_a, vec_b,
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
    return _launch(x, w, bias, mult, lo, hi, True)


def int8_matmul_acc(x: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """int8 matmul returning the raw int32 accumulator + bias."""
    if x.device.type == 'cpu':
        return matmul_acc_plain(x, w, bias)
    return _launch(x, w, bias, None, 0, 0, False)
