"""QAT training steps: SGD + step decay, KD, the BN schedule's two modes (port
of hawq_tpu/train/train.py).

  * train / loss: cross entropy + SGD with momentum and weight decay;
  * distillation: KL(student/T, teacher/T)·αT² + CE·(1−α);
  * learning rate × ``decay_factor`` every ``decay_every_steps`` steps;
  * the fix-BN schedule lives in the trainer, which builds one step for
    ``folded=False`` and one for ``folded=True``;
  * eval runs with frozen ranges (``update_stats=False``).

The state is the model itself (parameters and statistics buffers), its
optimizer and the step counter, updated **in place** by the steps; the flax
variables tree is a view of it (:meth:`TrainState.variables`).  Steps run
eagerly on one device; they return loss and accuracy as 0-dim tensors on
that device and never synchronize with the host themselves.  A train step
opens the span ``train.step`` and in it ``train.forward`` (the model and
the loss), ``train.backward`` and ``train.optimizer`` (``utils.tracing``:
recorded only while a profiler records).

Over a mesh (parallel/mesh.py; the model's layers given their groups by
``mesh.distribute``) a train step runs the model under
``DistributedDataParallel`` over the data group, which averages every
gradient over it; its statistics are global already (nn/layers.py), so no
buffer is broadcast.  A head split over the model group is gathered whole
into :meth:`TrainState.variables` and :meth:`TrainState.opt_leaves`, and a
checkpoint's whole head sliced back by :meth:`TrainState.load_opt_leaves`
and :func:`shard_tree`.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hawq_tpu_torch.models.resnet import qat_to_numpy
from hawq_tpu_torch.nn import layers as L
from hawq_tpu_torch.parallel import collectives as coll
from hawq_tpu_torch.parallel import mesh as pmesh
from hawq_tpu_torch.utils.tracing import span


def _sorted_parameters(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """Parameters in the leaf order of the flax params tree (keys sorted at
    every level): the order optimizer leaves are stored in checkpoints."""
    return sorted(model.named_parameters(),
                  key=lambda kv: tuple(kv[0].split('.')))


def _shards(model: nn.Module):
    """{id(parameter): (its layer's model group, class axis, classes)} of
    every parameter split over a model group."""
    return {id(p): (m.model_group, axis, m.classes)
            for m in model.modules() if isinstance(m, L.QuantLinear)
            for p, axis in m.shards()}


def _whole(t: torch.Tensor, shard) -> torch.Tensor:
    group, axis, _ = shard
    return coll.cat_over(t.detach(), group, dim=axis)


def _slice(a: np.ndarray, shard) -> np.ndarray:
    _, axis, classes = shard
    if a.ndim <= axis:            # not this parameter's leaf: left to fail
        return a                  # the shape check
    return a[(slice(None),) * axis + (classes,)]


def _named_shards(model: nn.Module):
    by_id = _shards(model)
    for name, p in model.named_parameters():
        if id(p) in by_id:
            yield name.split('.'), p, by_id[id(p)]


def shard_tree(model: nn.Module, params: Mapping) -> Mapping:
    """A whole params tree (a checkpoint's) with the model's split
    parameters sliced to this rank's classes (a new tree)."""
    params = dict(params)
    for path, _, shard in _named_shards(model):
        node = params
        for part in path[:-1]:
            node[part] = dict(node[part])
            node = node[part]
        node[path[-1]] = _slice(np.asarray(node[path[-1]]), shard)
    return params


def sgd_with_step_decay(model: nn.Module, base_lr: float,
                        momentum: float = 0.9, weight_decay: float = 1e-4,
                        decay_every_steps: Optional[int] = None,
                        decay_factor: float = 0.1):
    """SGD + momentum + weight decay, lr stepped ×decay_factor periodically
    → (optimizer, scheduler).  ``torch.optim.SGD`` with ``dampening=0``
    computes the reference's update: g + wd·p, then the momentum trace, then
    −lr·trace; the ``LambdaLR`` holds the schedule's step count."""
    opt = torch.optim.SGD([p for _, p in _sorted_parameters(model)],
                          lr=base_lr, momentum=momentum,
                          weight_decay=weight_decay, dampening=0.0)
    if decay_every_steps is None:
        factor = lambda step: 1.0
    else:
        factor = lambda step: decay_factor ** (step // decay_every_steps)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


class TrainState:
    """Model, optimizer, schedule and step counter of a QAT run."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 scheduler, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.step = step
        self.ddp = None     # the model's DistributedDataParallel, once made

    @classmethod
    def create(cls, model: nn.Module, tx) -> 'TrainState':
        optimizer, scheduler = tx
        return cls(model, optimizer, scheduler)

    def variables(self) -> Mapping:
        """The flax variables tree of the model, as numpy copies; a head
        split over a model group whole (a collective: every rank of the
        group calls it)."""
        tree = qat_to_numpy(self.model)
        for path, p, shard in _named_shards(self.model):
            node = tree['params']
            for part in path[:-1]:
                node = node[part]
            node[path[-1]] = _whole(p, shard).cpu().numpy()
        return tree

    def opt_leaves(self) -> List[np.ndarray]:
        """Optimizer state as the reference stores it positionally: one
        momentum trace per parameter in sorted tree order (zeros before the
        first step), then the schedule's step count."""
        leaves, shards = [], _shards(self.model)
        for _, p in _sorted_parameters(self.model):
            buf = self.optimizer.state.get(p, {}).get('momentum_buffer')
            if buf is None:
                buf = torch.zeros_like(p)
            if id(p) in shards:          # the whole head (a collective)
                buf = _whole(buf, shards[id(p)])
            leaves.append(buf.detach().cpu().numpy())
        leaves.append(np.asarray(self.scheduler.last_epoch, np.int32))
        return leaves

    def load_opt_leaves(self, leaves) -> bool:
        """Restore :meth:`opt_leaves` (a split head's leaves whole, as
        :meth:`opt_leaves` writes them); False (and nothing restored) when the
        leaves do not match this optimizer."""
        params = [p for _, p in _sorted_parameters(self.model)]
        shards = _shards(self.model)
        if len(leaves) == len(params) + 1:
            leaves = [_slice(np.asarray(l), shards[id(p)])
                      if id(p) in shards else l
                      for l, p in zip(leaves, params)] + [leaves[-1]]
        if len(leaves) != len(params) + 1 or any(
                np.shape(l) != tuple(p.shape)
                for l, p in zip(leaves, params)):
            return False
        for leaf, p in zip(leaves, params):
            self.optimizer.state[p]['momentum_buffer'] = torch.tensor(
                np.asarray(leaf, np.float32), device=p.device)
        self.scheduler.last_epoch = int(leaves[-1])
        for group, lr in zip(self.optimizer.param_groups,
                             self.scheduler.base_lrs):
            group['lr'] = lr * self.scheduler.lr_lambdas[0](
                self.scheduler.last_epoch)
        return True


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels)


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            labels: torch.Tensor, alpha: float = 0.95,
            temperature: float = 6.0) -> torch.Tensor:
    """KD_naive distillation loss: the KL term is summed over classes and
    averaged over the batch."""
    t = temperature
    kl = F.kl_div(F.log_softmax(student_logits / t, dim=-1),
                  F.softmax(teacher_logits / t, dim=-1),
                  reduction='batchmean')
    ce = cross_entropy(student_logits, labels)
    return kl * (alpha * t * t) + ce * (1.0 - alpha)


_DTYPES = {None: None, 'float32': None, 'bfloat16': torch.bfloat16,
           'float16': torch.float16}


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    if name not in _DTYPES:
        raise ValueError(f'unknown precision {name!r}; one of '
                         f'{[k for k in _DTYPES if k]}')
    return _DTYPES[name]


def _data_parallel(model: nn.Module, state: TrainState, mesh) -> nn.Module:
    """The module a step runs: ``model`` or, over a mesh whose data dim has
    several ranks, the state's model's ``DistributedDataParallel`` over the
    data group (one per state, made at its first step; its gradient
    all-reduces counted, parallel/collectives.py)."""
    group = pmesh.data_group(mesh)
    if group is None:
        return model
    if state.ddp is None:
        from torch.nn.parallel import DistributedDataParallel
        state.ddp = DistributedDataParallel(
            state.model, process_group=group, broadcast_buffers=False)
        state.ddp.register_comm_hook(group, coll.counted_allreduce_hook)
    return state.ddp


def make_train_step(model: nn.Module, *, folded: bool,
                    distill_alpha: Optional[float] = None,
                    temperature: float = 6.0, rng_seed: int = 0,
                    matmul_precision: Optional[str] = None,
                    residual_store_dtype: Optional[str] = None,
                    mesh=None) -> Callable:
    """Build the QAT train step ``train_step(state, batch) → (state,
    metrics)``; ``state`` is updated in place and returned.

    ``folded`` selects the BN mode.  If ``distill_alpha`` is set, the batch
    must carry 'teacher_logits'.  ``batch`` holds tensors on the model's
    device.

    ``matmul_precision``: precision of the float (backward) convolutions;
    the quantized forward runs in integers regardless.  None is float32
    with TF32 off; 'bfloat16' runs the gradient convolutions in bfloat16.
    ``residual_store_dtype``: storage dtype of the conv backward residuals;
    'bfloat16' halves what the forward keeps for the backward, value-exact
    for the integer activations (see nn/layers.py), and runs the gradient
    convolutions in bfloat16 too.

    A model with dropout draws its masks from a ``torch.Generator`` seeded
    from ``(rng_seed, step)``: deterministic and resume-stable.

    ``mesh``: the ``('data', 'model')`` mesh the model was distributed over
    (``parallel.mesh.distribute``): the step then runs under
    ``DistributedDataParallel`` over its data group, and its metrics are the
    means over that group (each rank holds an equal share of the global
    batch, so they are the global batch's)."""
    grad_dt = _dtype(matmul_precision)
    store_dt = _dtype(residual_store_dtype)
    has_dropout = any(isinstance(m, L.QuantDropout) and m.rate > 0
                      for m in model.modules())

    def train_step(state: TrainState, batch: Mapping):
        device = batch['image'].device
        with span('train.step'):
            kw = {}
            if has_dropout:
                kw['generator'] = torch.Generator(
                    device=next(model.parameters()).device).manual_seed(
                        rng_seed * 1_000_003 + state.step)
            with contextlib.ExitStack() as ctx:
                ctx.enter_context(L.faithful_float_math())
                ctx.enter_context(L.residual_store_dtype(store_dt))
                ctx.enter_context(L.gradient_conv_dtype(grad_dt))
                state.optimizer.zero_grad(set_to_none=True)
                with span('train.forward', device):
                    logits = _data_parallel(model, state, mesh)(
                        batch['image'], folded=folded, update_stats=True,
                        **kw)
                    if distill_alpha is not None:
                        loss = kd_loss(logits, batch['teacher_logits'],
                                       batch['label'], distill_alpha,
                                       temperature)
                    else:
                        loss = cross_entropy(logits, batch['label'])
                with span('train.backward', device):
                    loss.backward()
            with span('train.optimizer', device):
                state.optimizer.step()
                state.scheduler.step()
                state.step += 1
                with torch.no_grad():
                    acc = (logits.argmax(-1) == batch['label']).float().mean()
                group = pmesh.data_group(mesh)
                if group is not None:
                    loss, acc = coll.mean_over(torch.stack([loss, acc]),
                                               group)
        return state, {'loss': loss.detach(), 'accuracy': acc}

    return train_step


def make_eval_step(model: nn.Module, *, folded: bool = True) -> Callable:
    """Frozen-range eval step ``eval_step(batch) → metrics`` (top-1, top-5
    and loss as 0-dim tensors)."""

    def eval_step(batch: Mapping) -> Mapping:
        with torch.no_grad():
            logits = model(batch['image'], folded=folded, update_stats=False)
            label = batch['label']
            top1 = (logits.argmax(-1) == label).float()
            k = min(5, logits.shape[-1])
            top5 = (logits.topk(k, dim=-1).indices
                    == label[:, None]).any(dim=-1).float()
            return {'top1': top1.mean(), 'top5': top5.mean(),
                    'loss': cross_entropy(logits, label)}

    return eval_step


def make_calibration_step(model: nn.Module, *, folded: bool = True
                          ) -> Callable:
    """Range-calibration pass ``calib_step(images)``: forward only, updating
    the model's statistics in place."""

    def calib_step(images: torch.Tensor) -> None:
        with torch.no_grad():
            model(images, folded=folded, update_stats=True)

    return calib_step
