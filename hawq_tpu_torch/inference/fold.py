"""4×4 block-fold of the 7×7/s2 init convolution (port of
hawq_tpu/inference/fold.py).

The host folds 4×4 pixel blocks into channels,

    (B, H, W, 3) --pad (3,5)--> (B, H+8, W+8, 3) --fold--> (B, (H+8)/4,
    (W+8)/4, 48)

and the 7×7/s2 conv becomes a 3×3/s1 conv with C=48, N=4·64 over the folded
grid, each output pixel holding the 2×2 stride-2 origins of its block in
channel order (py, px, n).  MobileNetV2's 3×3/s2 init folds the same way
into a 2×2/s1 conv with C=48, N=4·32 (:func:`fold4_images_3x3s2`,
:func:`fold4_kernel_3x3s2`).  Bit-exact: the same int8 products and int32
sums, reassociated.  The 3×3/s2/p1 max-pool then runs directly on that
layout (:func:`maxpool_3x3s2p1_folded`, the plain version of the CUDA pool
kernel in kernels/pool.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def fold4_geometry(h: int, w: int) -> Tuple[int, int]:
    """Folded spatial dims for an (h, w) image; requires h % 4 == w % 4 == 0."""
    if h % 4 or w % 4:
        raise ValueError(f'fold4 needs H and W divisible by 4, got {(h, w)}')
    return (h + 8) // 4, (w + 8) // 4


def fold4_images(x: np.ndarray) -> np.ndarray:
    """(B, H, W, C) → (B, (H+8)/4, (W+8)/4, 16C), pad (3, 5) per axis.

    Padding is zeros, which quantize to the integer 0 exactly like the zero
    padding of the direct conv."""
    b, h, w, c = x.shape
    nb, mb = fold4_geometry(h, w)
    xp = np.pad(x, ((0, 0), (3, 5), (3, 5), (0, 0)))
    xf = xp.reshape(b, nb, 4, mb, 4, c).transpose(0, 1, 3, 2, 4, 5)
    return np.ascontiguousarray(xf.reshape(b, nb, mb, 16 * c))


def fold4_kernel(w: np.ndarray) -> np.ndarray:
    """(7, 7, C, N) stride-2 kernel → (3, 3, 16C, 4N) stride-1 over the fold.

    Output channel (py, px, n) is the conv output at stride-2 origin
    (2·py, 2·px) within the 4×4 block; input channel (ry, rx, c) is pixel
    (ry, rx) of a block; tap dy = 4·By + ry − 2·py ∈ [0, 7)."""
    kh, kw, c, n = w.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f'fold4_kernel needs a 7×7 kernel, got {(kh, kw)}')
    out = np.zeros((3, 3, 4, 4, c, 2, 2, n), w.dtype)
    for by in range(3):
        for ry in range(4):
            for py in range(2):
                dy = 4 * by + ry - 2 * py
                if not 0 <= dy < kh:
                    continue
                for bx in range(3):
                    for rx in range(4):
                        for px in range(2):
                            dx = 4 * bx + rx - 2 * px
                            if not 0 <= dx < kw:
                                continue
                            out[by, bx, ry, rx, :, py, px, :] = w[dy, dx]
    return np.ascontiguousarray(out.reshape(3, 3, 16 * c, 4 * n))


def fold4_3x3s2_geometry(h: int, p0: int) -> Tuple[int, int, int]:
    """Geometry of the 4×4 fold of a 3×3/stride-2 conv with pad ``p0``:
    (out_pixels, folded_rows, padded_size).  The conv gives ``out`` pixels;
    the host pads to ``padded`` (p0 before, the rest after) and folds to
    ``folded`` block rows; the device runs a 2×2/s1 conv over them →
    ``folded − 1`` block outputs of 2 stride-2 origins each (then
    depth-to-space and the slice to ``out``)."""
    out = (h + 2 * p0 - 3) // 2 + 1
    folded = (out + 1) // 2 + 1
    return out, folded, 4 * folded


def fold4_images_3x3s2(x: np.ndarray, p0: int) -> np.ndarray:
    """(B, H, W, C) → (B, fh, fw, 16C): the host's 4×4 fold for a
    3×3/stride-2 init conv (MobileNetV2: p0 = 1)."""
    b, h, w, c = x.shape
    _, fh, hp = fold4_3x3s2_geometry(h, p0)
    _, fw, wp = fold4_3x3s2_geometry(w, p0)
    xp = np.pad(x, ((0, 0), (p0, hp - h - p0), (p0, wp - w - p0), (0, 0)))
    xf = xp.reshape(b, fh, 4, fw, 4, c).transpose(0, 1, 3, 2, 4, 5)
    return np.ascontiguousarray(xf.reshape(b, fh, fw, 16 * c))


def fold4_kernel_3x3s2(w: np.ndarray) -> np.ndarray:
    """(3, 3, C, N) stride-2 kernel → (2, 2, 16C, 4N) stride-1 over the
    fold: output channel (py, px, n) is the stride-2 origin (2py, 2px) in
    the block; tap dy = 4·By + ry − 2·py ∈ [0, 3) spans two blocks."""
    kh, kw, c, n = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f'fold4_kernel_3x3s2 takes a 3×3 kernel, got '
                         f'{(kh, kw)}')
    out = np.zeros((2, 2, 4, 4, c, 2, 2, n), w.dtype)
    for by in range(2):
        for ry in range(4):
            for py in range(2):
                dy = 4 * by + ry - 2 * py
                if not 0 <= dy < kh:
                    continue
                for bx in range(2):
                    for rx in range(4):
                        for px in range(2):
                            dx = 4 * bx + rx - 2 * px
                            if not 0 <= dx < kw:
                                continue
                            out[by, bx, ry, rx, :, py, px, :] = w[dy, dx]
    return np.ascontiguousarray(out.reshape(2, 2, 16 * c, 4 * n))


def tile4(a) -> np.ndarray:
    """A per-channel vector tiled over the fold's 4 stride-2 origins (a
    scalar as it is): the bias and multipliers of a folded 3×3/s2 conv."""
    a = np.asarray(a)
    return np.tile(a, 4) if a.size > 1 else a


def depth_to_space_2x2(acc):
    """(B, H/4, W/4, 4N) folded conv output → (B, H/2, W/2, N), of a numpy
    array or a tensor."""
    b, hq, wq, n4 = acc.shape
    n = n4 // 4
    y = acc.reshape(b, hq, wq, 2, 2, n)
    order = (0, 1, 3, 2, 4, 5)
    y = y.permute(order) if isinstance(y, torch.Tensor) else y.transpose(order)
    return y.reshape(b, 2 * hq, 2 * wq, n)


def _dtype_min(dtype: torch.dtype):
    """The max-pool's identity: −inf for floats, the integer minimum else."""
    if dtype.is_floating_point:
        return float('-inf')
    return torch.iinfo(dtype).min


def maxpool_3x3s2p1_folded(xf: torch.Tensor) -> torch.Tensor:
    """3×3/stride-2/pad-1 max-pool of the depth-to-space image, computed in
    the folded (2, 2, N) channel layout: (B, Hq, Wq, 4N) → (B, Hq, Wq, N).

    Logical pixel (2a+py, 2b+px) lives at xf[a, b, py, px]; pool row i reads
    rows {(i−1, py=1), (i, py=0), (i, py=1)}, same for columns.  The border
    row/column −1 holds the dtype minimum."""
    b, hq, wq, n4 = xf.shape
    n = n4 // 4
    neg = _dtype_min(xf.dtype)

    def up(t):      # t[i-1, j]
        pad = torch.full_like(t[:, :1], neg)
        return torch.cat([pad, t[:, :-1]], dim=1)

    def left(t):    # t[i, j-1]
        pad = torch.full_like(t[:, :, :1], neg)
        return torch.cat([pad, t[:, :, :-1]], dim=2)

    m1 = torch.maximum(xf, up(xf))
    rm = torch.maximum(xf[..., :2 * n], m1[..., 2 * n:])
    m2 = torch.maximum(rm, left(rm))
    return torch.maximum(rm[..., :n], m2[..., n:]).contiguous()
