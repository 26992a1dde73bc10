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
that device and never synchronize with the host themselves.
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


def _sorted_parameters(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """Parameters in the leaf order of the flax params tree (keys sorted at
    every level): the order optimizer leaves are stored in checkpoints."""
    return sorted(model.named_parameters(),
                  key=lambda kv: tuple(kv[0].split('.')))


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

    @classmethod
    def create(cls, model: nn.Module, tx) -> 'TrainState':
        optimizer, scheduler = tx
        return cls(model, optimizer, scheduler)

    def variables(self) -> Mapping:
        """The flax variables tree of the model, as numpy copies."""
        return qat_to_numpy(self.model)

    def opt_leaves(self) -> List[np.ndarray]:
        """Optimizer state as the reference stores it positionally: one
        momentum trace per parameter in sorted tree order (zeros before the
        first step), then the schedule's step count."""
        leaves = []
        for _, p in _sorted_parameters(self.model):
            buf = self.optimizer.state.get(p, {}).get('momentum_buffer')
            leaves.append(np.zeros(tuple(p.shape), np.float32) if buf is None
                          else buf.detach().cpu().numpy())
        leaves.append(np.asarray(self.scheduler.last_epoch, np.int32))
        return leaves

    def load_opt_leaves(self, leaves) -> bool:
        """Restore :meth:`opt_leaves`; False (and nothing restored) when the
        leaves do not match this optimizer."""
        params = [p for _, p in _sorted_parameters(self.model)]
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


def make_train_step(model: nn.Module, *, folded: bool,
                    distill_alpha: Optional[float] = None,
                    temperature: float = 6.0, rng_seed: int = 0,
                    matmul_precision: Optional[str] = None,
                    residual_store_dtype: Optional[str] = None) -> Callable:
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
    from ``(rng_seed, step)``: deterministic and resume-stable."""
    grad_dt = _dtype(matmul_precision)
    store_dt = _dtype(residual_store_dtype)
    has_dropout = any(isinstance(m, L.QuantDropout) and m.rate > 0
                      for m in model.modules())

    def train_step(state: TrainState, batch: Mapping):
        kw = {}
        if has_dropout:
            device = next(model.parameters()).device
            kw['generator'] = torch.Generator(device=device).manual_seed(
                rng_seed * 1_000_003 + state.step)
        with contextlib.ExitStack() as ctx:
            ctx.enter_context(L.faithful_float_math())
            ctx.enter_context(L.residual_store_dtype(store_dt))
            ctx.enter_context(L.gradient_conv_dtype(grad_dt))
            state.optimizer.zero_grad(set_to_none=True)
            logits = model(batch['image'], folded=folded, update_stats=True,
                           **kw)
            if distill_alpha is not None:
                loss = kd_loss(logits, batch['teacher_logits'],
                               batch['label'], distill_alpha, temperature)
            else:
                loss = cross_entropy(logits, batch['label'])
            loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        with torch.no_grad():
            acc = (logits.argmax(-1) == batch['label']).float().mean()
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
