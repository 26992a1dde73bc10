"""The collectives of the port's data- and model-parallel paths, on
``torch.distributed`` process groups.

Only collectives that both ``gloo`` and ``nccl`` have are used:
``all_reduce``, ``all_gather`` and ``broadcast`` (``gloo`` has no
``reduce_scatter``).  Each
call adds one to ``COLLECTIVES[name]`` where it issues its collective and
nowhere else, so a run can count its collectives apart from the kernel
launches of ``kernels/_build.py``; the gradient all-reduces of
``DistributedDataParallel`` are counted by its comm hook
(:func:`counted_allreduce_hook`).

The autograd functions carry the three patterns the QAT graph needs:

  * :func:`sum_over` — an ``all_reduce(SUM)`` whose backward is the
    ``all_reduce(SUM)`` of the gradient: a statistic over the data group
    (the BN batch moments) whose every rank's loss depends on every rank's
    rows;
  * :func:`copy_to` — identity forward, ``all_reduce(SUM)`` backward: the
    input of a layer whose output columns are split over the model group;
  * :func:`gather_from` — ``all_gather`` along the last axis forward, this
    rank's columns of the gradient backward: the split layer's output.

Collectives that no gradient passes through (ranges, metrics) take no
autograd function.  Nothing here falls back to another backend or retries.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Tuple

import torch
import torch.distributed as dist

COLLECTIVES: Counter = Counter()


def reset_collectives() -> None:
    COLLECTIVES.clear()


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM,
               name: str = 'all_reduce') -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place over ``group`` (None: every
    process), counted as ``name``."""
    COLLECTIVES[name] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group, name: str = 'all_gather'
               ) -> List[torch.Tensor]:
    """The group's ranks' ``t`` (equal shapes) in rank order, counted as
    ``name``."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    COLLECTIVES[name] += 1
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def broadcast(t: torch.Tensor, group, name: str = 'broadcast'
              ) -> torch.Tensor:
    """``dist.broadcast`` of ``t`` in place from the group's first rank,
    counted as ``name``."""
    COLLECTIVES[name] += 1
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return t


def min_max(cur_min: torch.Tensor, cur_max: torch.Tensor, group
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (min, max) over the group's ranks of each rank's (min, max): one
    ``all_reduce(MAX)`` of (−min, max).  Negation is exact, so the result is
    exactly the min and max of the union of the ranks' tensors."""
    t = torch.stack([-cur_min, cur_max])
    all_reduce(t, group, dist.ReduceOp.MAX, 'all_reduce_minmax')
    return -t[0], t[1]


def cat_over(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' tensors (equal shapes) concatenated along ``dim`` in rank
    order (no gradient)."""
    return torch.cat(all_gather(t, group), dim=dim)


def mean_over(t: torch.Tensor, group) -> torch.Tensor:
    """The mean over the group's ranks of ``t`` (no gradient)."""
    t = all_reduce(t.detach().clone(), group, name='all_reduce_metrics')
    return t / dist.get_world_size(group)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t.clone(), group, name='all_reduce_moments')

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group,
                          name='all_reduce_moments_grad'), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group,
                          name='all_reduce_head_grad'), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        ctx.index = dist.get_rank(group)
        ctx.width = t.shape[-1]
        return torch.cat(all_gather(t, group, 'all_gather_head'), dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """``all_reduce(SUM)`` of ``t`` over ``group``; its gradient is the sum
    over the ranks of theirs."""
    return _SumOver.apply(t, group)


def copy_to(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself; in the backward the gradients of the group's ranks
    summed."""
    return _CopyTo.apply(t, group)


def gather_from(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along the last axis in rank order; the
    backward hands each rank its own columns of the gradient."""
    return _GatherFrom.apply(t, group)


def counted_allreduce_hook(group, bucket):
    """``DistributedDataParallel``'s default gradient reduction (each bucket
    divided by the group's size, then ``all_reduce(SUM)``), counted as
    ``ddp_all_reduce``."""
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks
    COLLECTIVES['ddp_all_reduce'] += 1
    return default_hooks.allreduce_hook(group, bucket)
