"""Seconds per call of an engine or kernel (the port's counterpart of
``bench.py time_per_iter``).

On the card a window of N calls is timed with CUDA events recorded on the
current stream around it, so the window ends when the device has run the
last call's kernels; on the CPU with ``time.perf_counter``.  A window of two
calls warms up, a window of one call measures the fixed cost, and N grows
×4 from 16 until the window is well over that cost (more than three times
it and more than it plus a second), unless the caller fixes N; the time per
call is (t(N) − t(1)) / (N − 1).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch


def _window(fn: Callable, x, n: int, cuda: bool) -> float:
    """Seconds for ``n`` calls of ``fn(x)``."""
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(n):
            fn(x)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def time_per_iter(fn: Callable, x, n_iters: Optional[int] = None,
                  max_iters: int = 4096) -> float:
    """Seconds per ``fn(x)``: by CUDA events where ``x`` is a CUDA tensor,
    else by the host clock.  ``n_iters`` fixes the window's calls (at least
    2); without it the window grows as the module docstring says."""
    if n_iters is not None and n_iters < 2:
        raise ValueError(f'time_per_iter: n_iters {n_iters} < 2')
    cuda = isinstance(x, torch.Tensor) and x.is_cuda
    _window(fn, x, 2, cuda)                     # warm-up
    t1 = _window(fn, x, 1, cuda)
    n = n_iters or 16
    while True:
        tn = _window(fn, x, n, cuda)
        if (n_iters is not None or tn > max(3 * t1, t1 + 1.0)
                or n >= max_iters):
            break
        n *= 4
    return max(tn - t1, 1e-9) / (n - 1)
