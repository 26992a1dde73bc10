"""Process groups and cross-process utilities (port of
hawq_tpu/parallel/distributed.py).

One process per card (or, on the CPU, per rank).  :func:`initialize` joins
the processes into one ``torch.distributed`` group by the same environment
protocol as ``hawq_tpu`` (``HAWQ_COORDINATOR`` / ``HAWQ_NUM_PROCESSES`` /
``HAWQ_PROCESS_ID``) or, under ``torchrun``, by its ``MASTER_ADDR`` /
``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``.  Without either, and without a
group, every helper here is the single-process identity, so the same
trainer and server run unchanged from one card to several.

What differs from ``hawq_tpu``: there one jitted program spans every host's
devices and a host contributes its shard of one global array; here each
process runs its own eager program on its own rows, and the statistics that
``hawq_tpu``'s program takes over the global array are collectives over the
data group (nn/layers.py, parallel/collectives.py).
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from hawq_tpu_torch.parallel import collectives as coll


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device='cuda') -> None:
    """Join the process group if asked by the arguments or the environment.

    Environment protocol (set by the launcher for every process):
      HAWQ_COORDINATOR=host0:port  HAWQ_NUM_PROCESSES=N  HAWQ_PROCESS_ID=i
    or ``torchrun``'s MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK.  A no-op
    when neither is set, or when a group already exists.  ``backend``:
    'nccl' or 'gloo'; by default 'nccl' where the ranks' ``device`` is a
    card and 'gloo' on the CPU.  A failure to join raises: nothing retries
    with another backend."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get('HAWQ_COORDINATOR')
        if coordinator_address is None and all(
                k in env for k in ('MASTER_ADDR', 'MASTER_PORT',
                                   'WORLD_SIZE', 'RANK')):
            coordinator_address = (f"{env['MASTER_ADDR']}:"
                                   f"{env['MASTER_PORT']}")
            num_processes = num_processes or int(env['WORLD_SIZE'])
            process_id = process_id if process_id is not None else int(
                env['RANK'])
    if coordinator_address is None:
        return
    if num_processes is None:
        num_processes = int(env['HAWQ_NUM_PROCESSES'])
    if process_id is None:
        process_id = int(env['HAWQ_PROCESS_ID'])
    if backend is None:
        backend = 'nccl' if torch.device(device).type == 'cuda' else 'gloo'
    dist.init_process_group(backend,
                            init_method=f'tcp://{coordinator_address}',
                            world_size=num_processes, rank=process_id)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device='cuda') -> torch.device:
    """This process's device: ``device`` itself where it names a card or the
    CPU; for a bare 'cuda' the card ``LOCAL_RANK`` (or the process index)
    modulo the visible cards, so that several processes share the cards
    round-robin (two ranks on one card both take ``cuda:0``)."""
    device = torch.device(device)
    if device.type != 'cuda' or device.index is not None:
        return device
    local = int(os.environ.get('LOCAL_RANK', process_index()))
    return torch.device('cuda', local % torch.cuda.device_count())


def global_batch_from_host_shards(mesh, host_batch: Mapping[str, np.ndarray],
                                  device=None) -> Mapping[str, torch.Tensor]:
    """This rank's shard of the global batch, on its device.

    Each process's loader yields ``1 / n_data`` of the global batch (its
    rows, ``ImageFolderLoader(process_index=, process_count=)`` over the
    mesh's data coordinate); the global batch has the shape of a shard with
    ``n_data`` times its rows, and is never formed: the ranks of a model
    group share one shard, and the collectives of the QAT graph see the
    rest.  ``device`` defaults to the mesh's card (or the CPU); ``mesh``
    may be None (one process)."""
    if device is None:
        device = local_device(mesh.device_type if mesh is not None
                              else 'cuda')
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host_batch.items()}


def psum_metrics(metrics: Mapping[str, object],
                 count: float = 1.0) -> Mapping[str, float]:
    """Weighted average of scalar metrics across processes (eval
    aggregation): Σ count·metric / Σ count, where ``count`` is this
    process's sample weight (the examples behind its means), so uneven final
    eval batches are weighted by their size.  One ``all_reduce(SUM)`` of
    [metric·count …, count] over every process; the identity with one."""
    if process_count() == 1:
        return {k: float(v) for k, v in metrics.items()}
    c = float(count)
    vals = torch.tensor([float(v) * c for v in metrics.values()] + [c],
                        dtype=torch.float64)
    if dist.get_backend() == 'nccl':
        vals = vals.to(local_device())
    coll.all_reduce(vals, None, name='all_reduce_metrics')
    out = vals.cpu().numpy()
    denom = max(float(out[-1]), 1e-12)
    return {k: float(out[i]) / denom for i, k in enumerate(metrics)}
