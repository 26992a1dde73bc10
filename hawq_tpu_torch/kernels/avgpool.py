"""A1: the integer 3×3/s1/p1 average pool of InceptionV3's pool branches,
with the requant that follows it, a kernel the TPU package does not have.

``hawq_tpu`` runs the pool as XLA's ``reduce_window`` window sum, then
``trunc(sum / 9 + 0.01)`` with a true division
(``engine_inception.py int_avgpool_3x3``), then the ``q_pool_act`` requant.
On a CUDA tensor :func:`int_avgpool3x3_requant` launches csrc/avgpool.cu,
which does all three in one pass; on a CPU tensor it runs the plain
version, :func:`avgpool3x3_requant_plain`: torch ops in the reference's
order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hawq_tpu_torch.kernels import _build
from hawq_tpu_torch.quant import ops as qops

_IN_CODES = {torch.int16: 0, torch.int32: 1, torch.int8: 2}


def avgpool3x3_requant_plain(x: torch.Tensor, mult: torch.Tensor,
                             out_bits: int, signed: bool) -> torch.Tensor:
    """Plain version of :func:`int_avgpool3x3_requant`: the int32 sum of
    each 3×3 window over a zero border of 1 (nine slice adds), the
    truncating true division by 9, then ``requant_int32`` to int8."""
    b, h, w, c = x.shape
    xp = F.pad(x.to(torch.int32), (0, 0, 1, 1, 1, 1))
    s = None
    for dy in range(3):
        for dx in range(3):
            t = xp[:, dy:dy + h, dx:dx + w]
            s = t if s is None else s + t
    q = torch.trunc(qops.exact_div(s.to(torch.float32), 9.0) + 0.01)
    return qops.requant_int32(q.to(torch.int32), mult, out_bits, signed,
                              torch.int8)


def int_avgpool3x3_requant(x: torch.Tensor, mult: torch.Tensor, *,
                           out_bits: int, signed: bool) -> torch.Tensor:
    """(B, H, W, C) int32, int16 or int8 NHWC → the 3×3/s1/p1 integer average
    pool (divisor 9 at the border too), requantized with ``mult`` (a
    float32 scalar or (C,) vector of dyadic multipliers) to ``out_bits``
    ≤ 8 → (B, H, W, C) int8."""
    if x.device.type == 'cpu':
        return avgpool3x3_requant_plain(x, mult, out_bits, signed)
    name = 'int_avgpool3x3_requant'
    dev = _build.kernel_device(x)
    if x.dim() != 4 or x.dtype not in _IN_CODES:
        raise ValueError(f'{name}: x must be (B, H, W, C) int32, int16 or '
                         f'int8, got {x.dtype}{tuple(x.shape)}')
    b, h, w, c = x.shape
    _build.require(x, 'x', x.dtype, (b, h, w, c), dev)
    per_channel = mult.numel() != 1
    _build.require(mult, 'mult', torch.float32,
                   (c,) if per_channel else tuple(mult.shape), dev)
    if out_bits > 8:
        raise ValueError(f'{name}: {out_bits}-bit outputs do not fit int8')
    lo, hi = qops.requant_clip_bounds(out_bits, signed)
    vec = 4 if (c % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0
                ) else 1
    out = torch.empty((b, h, w, c), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        code = _build.lib().hawq_avgpool3x3_requant(
            x.data_ptr(), mult.data_ptr(), out.data_ptr(), b, h, w, c,
            _IN_CODES[x.dtype], int(per_channel), int(lo), int(hi), vec,
            _build.stream_ptr(dev))
    _build.check(code, name)
    _build.count(name, 'cuda')
    return out
