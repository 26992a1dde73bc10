"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled with nvcc for ``sm_90a`` into one shared
library with a plain C interface, at first use, and loaded with ctypes.
One nvcc process per source runs in parallel, then one link.  The library
name carries a hash of the sources (and headers), so an edited source
rebuilds and an unchanged one is reused.  The build directory,
``hawq_tpu_torch/kernels/build/``, is listed in ``.gitignore``.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise on a non-zero code (:func:`check`).  The Hopper core's entry
points (csrc/*_sm90.cu) also encode TMA tensor maps, with libcuda's
``cuTensorMapEncodeTiled`` resolved through ``cudaGetDriverEntryPoint``, so
the library links against the CUDA runtime alone.  The wrappers also count
their launches in :data:`LAUNCHES`, so a run can show that a path (the
engine's, the trainer's) went through the kernels.

Each kernel that an engine launches is also a ``torch.library`` operator in
the ``hawq`` namespace (:func:`define_op`; ``torch.ops.hawq.<wrapper name>``),
so that ``torch.export`` can trace an engine and a saved program can call the
kernels again (``export.export.export_program``).  An operator takes tensors,
ints, floats and bools only; its CUDA implementation is the wrapper's launch
(the operands' alignment, the tile and the tensor map chosen there, from
the real pointers), its CPU implementation the plain version, its fake
implementation the output's shape and dtype.  An eager call on a plain CPU
or CUDA tensor runs the implementation without the dispatcher's cost
(:class:`Op`).
Registering the operators builds nothing: the library is compiled at the
first launch.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import is_fake

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, 'csrc')
BUILD_DIR = os.path.join(_HERE, 'build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    'hawq_sm90_weight_map': [_P, _P] + [_I] * 4,
    'hawq_int8_matmul_sm90': [_P, _P, _P, _P] + [_I] * 6 + [_P],
    'hawq_int8_matmul_requant_sm90': [_P] * 5 + [_I] * 8 + [_P],
    'hawq_int8_matmul_residual_sm90': [_P] * 7 + [_I] * 6 + [_P],
    'hawq_int8_matmul_residual_requant_sm90': [_P] * 9 + [_I] * 8 + [_P],
    'hawq_int4w_matmul_sm90': [_P] * 5 + [_I] * 9 + [_P],
    'hawq_int4w_matmul_acc_sm90': [_P, _P, _P, _P] + [_I] * 7 + [_P],
    'hawq_int8_conv_sm90': [_P, _P, _P, _P, _P] + [_I] * 18 + [_P],
    'hawq_int4w_conv_sm90': [_P, _P, _P, _P, _P] + [_I] * 18 + [_P],
    'hawq_int8_conv_acc_sm90': [_P, _P, _P, _P] + [_I] * 16 + [_P],
    'hawq_int4w_conv_acc_sm90': [_P, _P, _P, _P] + [_I] * 16 + [_P],
    'hawq_maxpool_folded': [_P, _P] + [_I] * 6 + [_P],
    'hawq_maxpool_folded_requant': [_P] * 3 + [_I] * 8 + [_P],
    'hawq_dwconv_acc': [_P] * 4 + [_I] * 11 + [_P],
    'hawq_dwconv_requant': [_P] * 6 + [_I] * 13 + [_P],
    'hawq_avgpool3x3_requant': [_P] * 4 + [_I] * 16 + [_P],
    'hawq_avgpool3x3': [_P, _P] + [_I] * 10 + [_P],
    'hawq_requant': [_P, _I, _P] + [_I] * 6 + [_P],
    'hawq_minmax_max_blocks': [],
    'hawq_minmax_f32': [_P, _L, _P, _P, _P],
}

# Launch counts per wrapper; reset with reset_launches().
LAUNCHES: Dict[str, int] = {}

# The ``hawq`` operator namespace; the operators live as long as this object.
OPS = torch.library.Library('hawq', 'DEF')

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def reset_launches() -> None:
    for k in list(LAUNCHES):
        LAUNCHES[k] = 0


def count(name: str) -> None:
    """One launch of wrapper ``name``."""
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


class Op:
    """A ``hawq`` operator (``overload``, ``torch.ops.hawq.<name>.default``)
    and its CPU and CUDA implementations.  A call whose first argument is a
    plain CPU or CUDA tensor, with no dispatch mode active and nothing
    compiling, runs the implementation directly: the dispatcher's trip
    through Python kernels costs more host time than the launch itself
    (PERF.md §6; ``chip_op_dispatch.py`` measures it).  Every other
    call, a traced one among them, goes through the dispatcher, so that
    ``torch.export`` records the operator.  A first argument that is a list
    of tensors is judged by its first tensor."""

    __slots__ = ('overload', 'cpu', 'cuda')

    def __init__(self, overload, cpu, cuda):
        self.overload, self.cpu, self.cuda = overload, cpu, cuda

    def __call__(self, x, *args):
        t = x[0] if type(x) is list else x
        if (type(t) is torch.Tensor and not _dispatch_modes()
                and not torch.compiler.is_compiling()):
            if t.is_cuda:
                return self.cuda(x, *args)
            if t.is_cpu:
                return self.cpu(x, *args)
        return self.overload(x, *args)


_dispatch_modes = torch._C._len_torch_dispatch_stack


def define_op(schema: str, cpu, cuda, fake) -> Op:
    """Define ``hawq::<schema>`` with its CPU, CUDA and fake implementations
    and return it (:class:`Op`).  Every operator allocates its output (no
    argument is mutated or aliased); its first argument is a tensor or a
    list of tensors."""
    name = schema.split('(', 1)[0]
    OPS.define(schema)
    OPS.impl(name, cpu, 'CPU')
    OPS.impl(name, cuda, 'CUDA')

    def traced(t, *args):
        # the fake implementation also serves the meta device, and a meta
        # tensor has no kernel, as any device but the CPU and the card
        first = t[0] if isinstance(t, (list, tuple)) else t
        if not is_fake(first):
            kernel_device(first)
        return fake(t, *args)
    torch.library.register_fake(f'hawq::{name}', traced, lib=OPS)
    return Op(getattr(torch.ops.hawq, name).default, cpu, cuda)


def opt_int(v: Optional[int]) -> int:
    """An optional int as an operator argument: None is -1."""
    return -1 if v is None else int(v)


def from_opt_int(v: int) -> Optional[int]:
    return None if v < 0 else v


def opt_ints(values) -> list:
    """An optional tuple of ints (a tile plan) as an operator argument: None
    is []."""
    return [] if values is None else [int(v) for v in values]


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(path):
        return path
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                           'toolkit (set CUDA_HOME)')
    return found


def _sources_hash(files) -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for f in files:
        h.update(os.path.basename(f).encode())
        with open(f, 'rb') as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels (if this source hash is not built yet) and return
    the path of the shared library."""
    sources = sorted(glob.glob(os.path.join(CSRC, '*.cu')))
    headers = sorted(glob.glob(os.path.join(CSRC, '*.cuh')))
    key = _sources_hash(sources + headers)
    lib_path = os.path.join(BUILD_DIR, f'libhawq_kernels_{key}.so')
    if os.path.exists(lib_path):
        build_info.update(path=lib_path, seconds=0.0, cached=True, log='')
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = os.path.join(BUILD_DIR, f'tmp_{key}_{os.getpid()}')
    os.makedirs(tmp, exist_ok=True)
    procs, objs = [], []
    for src in sources:
        obj = os.path.join(tmp, os.path.basename(src) + '.o')
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, '-I', CSRC, '-c', src, '-o', obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f'--- {os.path.basename(src)}\n{out}')
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError('nvcc failed for ' + ', '.join(failed) + '\n'
                           + '\n'.join(log))
    tmp_lib = os.path.join(tmp, 'lib.so')
    link = subprocess.run([nvcc, '-shared', '-o', tmp_lib, *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError('nvcc link failed\n' + link.stdout)
    os.replace(tmp_lib, lib_path)          # atomic: concurrent builds agree
    shutil.rmtree(tmp, ignore_errors=True)
    build_info.update(path=lib_path, seconds=time.perf_counter() - t0,
                      cached=False, log='\n'.join(log))
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


ENCODE_ERROR = 10000      # csrc/gemm_s8_sm90.cuh: + the CUresult


def check(code: int, name: str) -> None:
    if code >= ENCODE_ERROR:
        raise RuntimeError(f'{name}: encoding a TMA tensor map failed with '
                           f'CUresult {code - ENCODE_ERROR}')
    if code != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with cudaError {code}')


def kernel_device(t: torch.Tensor) -> torch.device:
    """The CUDA device a kernel launch for ``t`` runs on; raises for any
    other device (a CPU tensor takes the plain version before this)."""
    if t.device.type != 'cuda':
        raise ValueError(f'no kernel for a tensor on {t.device}')
    return t.device


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
            device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what a kernel reading raw pointers needs."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'{name}: expected a torch.Tensor, got {type(t)}')
    if t.device != device:
        raise ValueError(f'{name}: on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise ValueError(f'{name}: dtype {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(t.shape)}, expected '
                         f'{tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: must be contiguous')
