"""3×3/s2/p1 max-pool on the fold4 layout (port of hawq_tpu/kernels/pool.py
``maxpool_folded``).

On a CUDA tensor it launches csrc/pool.cu; on a CPU tensor it runs the plain
version, ``inference.fold.maxpool_3x3s2p1_folded``.
"""

from __future__ import annotations

import torch

from hawq_tpu_torch.inference.fold import maxpool_3x3s2p1_folded
from hawq_tpu_torch.kernels import _build

_DTYPE_CODES = {torch.int16: 0, torch.int32: 1, torch.float32: 2}


def maxpool_folded(xf: torch.Tensor) -> torch.Tensor:
    """(B, Hq, Wq, 4N) folded conv output → (B, Hq, Wq, N) pooled, int16,
    int32 or float32."""
    if xf.device.type == 'cpu':
        return maxpool_3x3s2p1_folded(xf)
    dev = _build.kernel_device(xf)
    b, hq, wq, n4 = xf.shape
    if n4 % 4 or xf.dtype not in _DTYPE_CODES:
        raise ValueError(f'maxpool_folded: channels {n4} must be a multiple '
                         f'of 4 and dtype {xf.dtype} one of int16, int32, '
                         f'float32')
    _build.require(xf, 'xf', xf.dtype, (b, hq, wq, n4), dev)
    out = torch.empty((b, hq, wq, n4 // 4), dtype=xf.dtype, device=dev)
    with torch.cuda.device(dev):
        code = _build.lib().hawq_maxpool_folded(
            xf.data_ptr(), out.data_ptr(), b, hq, wq, n4 // 4,
            _DTYPE_CODES[xf.dtype], _build.stream_ptr(dev))
    _build.check(code, 'maxpool_folded')
    _build.count('maxpool_folded')
    return out
