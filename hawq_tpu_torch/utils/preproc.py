"""Host-side input preprocessing (port of hawq_tpu/utils/preproc.py,
``quantize_int8``, numpy path).

``quantize_int8`` is the host quantization of the engine's 'folded_int8'
input mode: the host folds (``inference.fold.fold4_images``) and quantizes
with the model's input scale, and the device receives int8.  Its float32 op
order, floor(x / scale + 0.5), is the engine's own device-side quantization,
so both give the same integers.
"""

from __future__ import annotations

import numpy as np


def quantize_int8(x: np.ndarray, scale: float, lo: int = -128,
                  hi: int = 127) -> np.ndarray:
    """f32 → int8 symmetric quantization: clip(floor(x / scale + 0.5))."""
    x = np.ascontiguousarray(x, np.float32)
    return np.clip(np.floor(x / np.float32(scale) + np.float32(0.5)),
                   lo, hi).astype(np.int8)
