"""Hutchinson layer-wise Hessian-trace estimation (port of
hawq_tpu/sensitivity/hessian.py).

For Rademacher probes v ~ {-1,+1}^d,

    E[v_l · (Hv)_l] = trace(H_{ll})

so one Hessian-vector product over all parameters gives unbiased per-layer
trace estimates for every layer at once (cross-block terms vanish in
expectation).  Hv is computed reverse-over-reverse: the gradient with its
graph kept, then the gradient of Σ g·v (:func:`hvp`).

Parameters are a mapping name → tensor with ``named_parameters()``'s dotted
names; the traces are keyed by ``hawq_tpu``'s flat paths, the same names
with '/' for '.' ('stage1_unit1/quant_convbn1/kernel').  Leaves are walked
in sorted path order, the order ``jax.tree.flatten`` gives a nested dict.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from hawq_tpu_torch.nn import layers as L

Params = Mapping[str, torch.Tensor]


def _names(params: Params) -> List[str]:
    return sorted(params, key=lambda k: tuple(k.split('.')))


def _narrow_residuals() -> bool:
    """Whether forwards run now save their conv residuals narrow
    (``nn.layers.residual_store_dtype``): copies made inside the forward,
    which carry no graph."""
    return getattr(L._BACKWARD, 'store', None) in L._NARROW


def rademacher_like(params: Params,
                    generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One ±1 tensor per leaf, of its shape and dtype on its device, drawn
    from ``generator`` (on the generator's device, so a CPU generator gives
    the same probes for parameters on any device)."""
    out = {}
    for k in _names(params):
        p = params[k]
        bits = torch.randint(0, 2, tuple(p.shape), generator=generator,
                             device=generator.device)
        out[k] = (bits.to(p.dtype) * 2 - 1).to(p.device)
    return out


def hvp(loss_fn: Callable[[Params], torch.Tensor], params: Params,
        v: Params) -> Dict[str, torch.Tensor]:
    """Hessian-vector product of ``loss_fn`` at ``params`` along ``v``,
    reverse-over-reverse: ``torch.autograd.grad`` with ``create_graph``,
    then the gradient of Σ g·v.  (``torch.func`` transforms refuse the
    QAT graph's autograd Functions, which keep the ``forward(ctx, …)``
    form.)  ``loss_fn(params)`` may close over a model through
    ``torch.func.functional_call`` or over the model's own parameters; a
    leaf that does not require a gradient is replaced by a detached copy
    that does.  Runs with TF32 off (``faithful_float_math``).

    Raises inside ``nn.layers.residual_store_dtype`` with a narrow dtype:
    the conv residuals are then copies without a graph, which would cut the
    second-order terms through them silently."""
    if _narrow_residuals():
        raise RuntimeError('hvp: the conv residuals are stored narrow '
                           '(residual_store_dtype); their copies carry no '
                           'graph, so the second derivative would be cut')
    names = _names(params)
    leaves = {k: (params[k] if params[k].requires_grad
                  else params[k].detach().requires_grad_(True))
              for k in names}
    wrt = [leaves[k] for k in names]
    with L.faithful_float_math(), torch.enable_grad():
        grads = torch.autograd.grad(loss_fn(leaves), wrt, create_graph=True,
                                    allow_unused=True)
        gdot = sum((g * v[k]).sum() for k, g in zip(names, grads)
                   if g is not None)
        hv = torch.autograd.grad(gdot, wrt, allow_unused=True)
    return {k: (torch.zeros_like(leaves[k]) if h is None else h.detach())
            for k, h in zip(names, hv)}


def hutchinson_layer_traces(loss_fn: Callable[[Params], torch.Tensor],
                            params: Params, n_probes: int = 8,
                            generator: Optional[torch.Generator] = None,
                            normalize: bool = True) -> Dict[str, float]:
    """Per-layer Hessian traces of ``loss_fn(params)``.

    Returns {flat_layer_path: trace or trace/#params}.  ``loss_fn`` should
    close over a fixed calibration batch (the HAWQ-V2 protocol).  The
    probes come from ``generator`` (default: a CPU generator seeded 0),
    :func:`rademacher_like` once per probe."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    names = _names(params)
    acc = None
    for _ in range(n_probes):
        v = rademacher_like(params, generator)
        hv = hvp(loss_fn, params, v)
        prods = {k: torch.sum(v[k] * hv[k]) for k in names}
        acc = prods if acc is None else {k: acc[k] + prods[k] for k in names}
    out = {}
    for k in names:
        t = float(acc[k]) / n_probes
        if normalize:
            t /= float(params[k].numel())
        out[k.replace('.', '/')] = t
    return out


def conv_layer_traces(traces: Mapping[str, float],
                      kernel_suffix: str = 'kernel') -> Dict[str, float]:
    """Keep only conv/linear kernel entries, keyed by their module path."""
    out = {}
    for key, t in traces.items():
        parts = key.split('/')
        if parts[-1] == kernel_suffix:
            out['/'.join(parts[:-1])] = t
    return out


def quantization_perturbation(weight: np.ndarray, bits: int,
                              per_channel: bool = True) -> float:
    """‖W − Q(W)‖² for symmetric quantization at the given bits — the ΔW²
    arrays of the reference's ILP notebook, computed from real weights."""
    w = np.asarray(weight, np.float64)
    flat = w.reshape(-1, w.shape[-1]) if (per_channel and w.ndim > 1) \
        else w.reshape(-1, 1)
    n = 2 ** (bits - 1) - 1
    scale = np.maximum(np.maximum(np.abs(flat.min(0)), np.abs(flat.max(0))),
                       1e-8) / n
    q = np.clip(np.floor(flat / scale + 0.5), -n - 1, n) * scale
    return float(np.sum((flat - q) ** 2))
