"""Seeded image pools, made on the device in a few large calls.

An image is a smooth random field (noise on an 8×8 grid, upsampled
bilinearly) with fine noise over it, at a contrast and brightness of its
own, so that images differ in their global statistics as photographs do:
i.i.d. pixel noise would give every image nearly the same pooled features,
and the logits would hardly depend on the image.  Pixels are in [0, 1];
``float_images`` normalizes them with the ImageNet mean and std (the
preprocessing the program's users run before a float32 request),
``uint8_images`` returns the decoded pixels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.weights import sub_seed

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _pixels(seed: int, n: int, size: int, device) -> torch.Tensor:
    """(n, size, size, 3) float32 pixels in [0, 1] on ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 'images'))
    coarse = torch.rand(n, 3, 8, 8, generator=gen, device=device)
    smooth = F.interpolate(coarse, size=(size, size), mode='bilinear',
                           align_corners=False)
    fine = torch.rand(n, 3, size, size, generator=gen, device=device)
    contrast = 0.4 + 0.6 * torch.rand(n, 1, 1, 1, generator=gen,
                                      device=device)
    bright = 0.3 * (torch.rand(n, 1, 1, 1, generator=gen, device=device)
                    - 0.5)
    px = 0.5 + bright + contrast * ((smooth - 0.5) * 1.6 + (fine - 0.5) * 0.4)
    return torch.clamp(px, 0.0, 1.0).permute(0, 2, 3, 1).contiguous()


def float_images(seed: int, n: int, size: int, device='cpu') -> np.ndarray:
    """(n, size, size, 3) float32 normalized images, on the host."""
    px = _pixels(seed, n, size, device)
    mean = torch.tensor(MEAN, device=px.device)
    std = torch.tensor(STD, device=px.device)
    return ((px - mean) / std).cpu().numpy()


def uint8_images(seed: int, n: int, size: int, device='cpu') -> np.ndarray:
    """(n, size, size, 3) uint8 pixels, on the host."""
    px = _pixels(seed, n, size, device)
    return torch.round(px * 255.0).to(torch.uint8).cpu().numpy()
