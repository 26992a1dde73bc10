"""One-pass global (min, max) of a tensor (port of hawq_tpu/kernels/reduce.py
``minmax_1pass``): the range statistic of every QuantAct in QAT.

On a CUDA tensor it launches csrc/reduce.cu (float32; the tensor is read
once); on a CPU tensor it runs the plain version, ``torch.amin`` /
``torch.amax``.  Both return two 0-dim tensors on the input's device and
never synchronize with the host.  Semantics are ``torch.amin`` /
``torch.amax``: a NaN anywhere gives NaN, ±inf pass through, an empty tensor
raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from hawq_tpu_torch.kernels import _build


def minmax_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: two reductions, each reading the tensor."""
    return torch.amin(x), torch.amax(x)


def minmax_1pass(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, max) of ``x`` over all its elements, any shape.

    A non-contiguous CUDA input is reduced through a contiguous copy (the
    kernel reads a flat array)."""
    if x.numel() == 0:
        raise ValueError('minmax_1pass: empty tensor')
    if x.device.type == 'cpu':
        return minmax_plain(x)
    dev = _build.kernel_device(x)
    if x.dtype != torch.float32:
        raise ValueError(f'minmax_1pass: dtype {x.dtype}, expected '
                         f'torch.float32')
    x = x.detach().contiguous()
    lib = _build.lib()
    ws = torch.empty(2 * lib.hawq_minmax_max_blocks(), dtype=torch.float32,
                     device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.hawq_minmax_f32(x.data_ptr(), x.numel(), ws.data_ptr(),
                                   out.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, 'minmax_1pass')
    _build.count('minmax_1pass')
    return out[0], out[1]
