"""Host-side input preprocessing (port of hawq_tpu/utils/preproc.py).

  * ``preprocess_batch``   — uint8 HWC → resized, center-cropped, normalized
    float32 NHWC;
  * ``fold4_images_3x3s2`` — the 4×4 block fold of a 3×3/s2 init conv's
    input (``inference.fold``);
  * ``quantize_int8``      — float32 → int8, clip(floor(x / scale + 0.5)):
    the host quantization of the engines' 'folded_int8' input, in the float32
    op order of the engine's own device-side quantization;
  * ``pack_int4``          — split-K nibble packing (``kernels.matmul``);
  * ``fold4_images``       — the fold of a 7×7/s2 init conv's input
    (``inference.fold``).

The first two run the native library (``utils/csrc/hawq_preproc.cpp``, the
JAX package's ``csrc/hawq_preproc.cpp`` loops for them) where it is built;
they beat numpy on the H100 machine's host (PERF.md, "host input prep").
The other three are numpy only: the JAX package's native loops for them
were level with numpy or slower there, so the port does not carry them.

The library is built at first use with g++ (``csrc/Makefile``'s flags) into
``kernels/build/``, keyed by a hash of the source and the host CPU (for
``-march=native``), through a temporary name
and ``os.replace`` so that processes building at once agree.  Where the box
has no C++ compiler the two take their numpy versions: the fold gives the
same bytes, ``preprocess_batch`` resizes with PIL's bilinear filter (as in
the JAX package); a compiler that fails to build the source raises.
:func:`native_available` says whether the native library runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from hawq_tpu_torch.inference import fold as _fold
from hawq_tpu_torch.inference.fold import fold4_images  # noqa: F401
from hawq_tpu_torch.kernels.matmul import pack_int4  # noqa: F401

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, 'csrc', 'hawq_preproc.cpp')
BUILD_DIR = os.path.join(os.path.dirname(_HERE), 'kernels', 'build')
CXX_FLAGS = ['-O3', '-march=native', '-std=c++17', '-fPIC', '-Wall',
             '-Wextra', '-shared', '-pthread']

_P8, _PF = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
_I = ctypes.c_int
_SIGNATURES = {
    'preprocess_batch': [_P8, _I, _I, _I, _I, _I, _PF, _PF, _PF],
    'fold4_general': [_P8, _I, _I, _I, _I, _I, _I, _I, _I, _P8],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cxx() -> Optional[str]:
    return shutil.which(os.environ.get('CXX', 'g++'))


def _host_cpu() -> bytes:
    """What ``-march=native`` compiles for: the host CPU's model and
    feature flags (``/proc/cpuinfo``), else the processor's name."""
    if os.path.exists('/proc/cpuinfo'):
        with open('/proc/cpuinfo') as f:
            return ''.join(l for l in f if l.startswith(
                ('model name', 'flags'))).encode()
    return platform.processor().encode()


def build(cxx: str) -> str:
    """Compile the source with ``cxx`` unless it is built for this source,
    these flags and this host CPU; return the library's path."""
    h = hashlib.sha256(' '.join(CXX_FLAGS).encode() + _host_cpu())
    with open(SOURCE, 'rb') as f:
        h.update(f.read())
    path = os.path.join(BUILD_DIR, f'libhawq_preproc_{h.hexdigest()[:16]}.so')
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{path}.tmp{os.getpid()}'
    proc = subprocess.run([cxx, *CXX_FLAGS, '-o', tmp, SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f'{cxx} failed to build {SOURCE}\n{proc.stdout}')
    os.replace(tmp, path)                  # atomic: concurrent builds agree
    return path


def _load() -> Optional[ctypes.CDLL]:
    """The native library, built at first use; None without a compiler."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            cxx = _cxx()
            if cxx is not None:
                lib = ctypes.CDLL(build(cxx))
                for name, args in _SIGNATURES.items():
                    getattr(lib, name).argtypes = args
                    getattr(lib, name).restype = None
                _lib = lib
        return _lib


def native_available() -> bool:
    """Whether ``preprocess_batch`` and ``fold4_images_3x3s2`` run the
    native library (else numpy)."""
    return _load() is not None


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def preprocess_batch(images: np.ndarray, resize: int, crop: int,
                     mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """uint8 (B, H, W, 3) → float32 (B, crop, crop, 3): resize the shorter
    side to ``resize`` (bilinear), center-crop ``crop``, then
    (v/255 − mean) / std."""
    images = np.ascontiguousarray(images, np.uint8)
    b, h, w, c = images.shape
    if c != 3:
        raise ValueError(f'preprocess_batch takes 3 channels, got {c}')
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = np.empty((b, crop, crop, 3), np.float32)
    lib = _load()
    if lib is not None:
        lib.preprocess_batch(_ptr(images, ctypes.c_uint8), b, h, w, resize,
                             crop, _ptr(mean, ctypes.c_float),
                             _ptr(std, ctypes.c_float),
                             _ptr(out, ctypes.c_float))
        return out
    from PIL import Image
    for i in range(b):
        img = Image.fromarray(images[i])
        if w < h:
            nw, nh = resize, int(round(h * resize / w))
        else:
            nw, nh = int(round(w * resize / h)), resize
        img = img.resize((nw, nh), Image.BILINEAR)
        x0, y0 = (nw - crop) // 2, (nh - crop) // 2
        arr = np.asarray(img.crop((x0, y0, x0 + crop, y0 + crop)),
                         np.float32) / 255.0
        out[i] = (arr - mean) / std
    return out


def quantize_int8(x: np.ndarray, scale: float, lo: int = -128,
                  hi: int = 127) -> np.ndarray:
    """float32 → int8 symmetric quantization:
    clip(floor(x / scale + 0.5))."""
    x = np.ascontiguousarray(x, np.float32)
    return np.clip(np.floor(x / np.float32(scale) + np.float32(0.5)),
                   lo, hi).astype(np.int8)


def fold4_images_3x3s2(x: np.ndarray, p0: int) -> np.ndarray:
    """(B, H, W, C) → (B, fh, fw, 16C), the fold of a 3×3/s2 init conv's
    input with pad ``p0`` (InceptionV3 0, MobileNetV2 1;
    ``inference.fold.fold4_images_3x3s2``)."""
    x = np.ascontiguousarray(x)
    lib = _load()
    if lib is None:
        return _fold.fold4_images_3x3s2(x, p0)
    b, h, w, c = x.shape
    fh = _fold.fold4_3x3s2_geometry(h, p0)[1]
    fw = _fold.fold4_3x3s2_geometry(w, p0)[1]
    out = np.empty((b, fh, fw, 16 * c), x.dtype)
    lib.fold4_general(_ptr(x.view(np.uint8), ctypes.c_uint8), b, h, w, c,
                      x.itemsize, p0, fh, fw,
                      _ptr(out.view(np.uint8), ctypes.c_uint8))
    return out
