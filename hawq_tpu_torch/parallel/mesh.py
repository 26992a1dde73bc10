"""The process mesh and what it shards (port of hawq_tpu/parallel/mesh.py).

``hawq_tpu``'s mesh is a grid of devices ``('data', 'model')``: the batch
sharded over 'data', the parameters replicated, the classifier head
optionally split over 'model', GSPMD inserting the collectives.  Here the
grid is of processes (one per card, or per CPU rank), a
``torch.distributed.device_mesh.DeviceMesh`` with the same two dims: rank
``d·n_model + m`` sits at (d, m), as ``hawq_tpu`` reshapes its device list.
The ranks of a data group (same m) hold different rows and average their
gradients; the ranks of a model group (same d) hold the same rows and
split the head's output classes.  :func:`distribute` hands a model's layers
their groups.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from hawq_tpu_torch.nn import layers as L
from hawq_tpu_torch.parallel import collectives as coll


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device='cuda') -> DeviceMesh:
    """The ('data', 'model') mesh over every process of the group, which
    must exist (:func:`distributed.initialize`); ``n_data`` defaults to the
    processes over ``n_model``, and n_data · n_model must be all of them.
    ``device``: the ranks' device type ('cuda' or 'cpu')."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f'make_mesh: {n_data} × {n_model} ranks, the group '
                         f'has {world}')
    return init_device_mesh(torch.device(device).type, (n_data, n_model),
                            mesh_dim_names=('data', 'model'))


def mesh_shape(mesh: DeviceMesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _group(mesh: Optional[DeviceMesh], dim: str):
    if mesh is None or mesh.size(mesh.mesh_dim_names.index(dim)) == 1:
        return None
    return mesh.get_group(dim)


def data_group(mesh: Optional[DeviceMesh]):
    """The process group of this rank's data dim, or None where it has one
    rank (nothing to reduce)."""
    return _group(mesh, 'data')


def model_group(mesh: Optional[DeviceMesh]):
    """The process group of this rank's model dim, or None where it has one
    rank."""
    return _group(mesh, 'model')


def data_shard(mesh: Optional[DeviceMesh]):
    """(index, count) of this rank's rows of the global batch: its data
    coordinate and the data dim's size; (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank('data'), mesh.size(0)


def replicate_state(mesh: DeviceMesh, model: nn.Module) -> nn.Module:
    """Every parameter and buffer broadcast from the first rank of this
    rank's data group (the ranks that hold the same head shard), in place."""
    group = data_group(mesh)
    if group is not None:
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                coll.broadcast(t.data, group, 'broadcast_state')
    return model


def fc_tensor_sharding(mesh: DeviceMesh, num_classes: int) -> slice:
    """The output classes of the classifier kernel (F, O) this rank keeps:
    its equal share of O by its model coordinate (``P(None, 'model')``)."""
    count = mesh.size(1)
    index = mesh.get_local_rank('model')
    return slice(num_classes // count * index,
                 num_classes // count * (index + 1))


def distribute(model: nn.Module, mesh: Optional[DeviceMesh]) -> nn.Module:
    """Give ``model``'s layers the mesh's groups, in place: every statistics
    site the data group (ranges and BN batch moments over the global batch)
    and, where the model dim has several ranks, the head ``quant_output``
    (ResNet v1 / v2, as ``hawq_tpu`` shards it) split over the model group.
    Call it before the optimizer is made: the head's parameters are new."""
    group = data_group(mesh)
    for m in model.modules():
        if isinstance(m, (L.QuantAct, L.QuantBnAct, L.QuantConvBn)):
            m.data_group = group
    head = getattr(model, 'quant_output', None)
    group = model_group(mesh)
    if group is not None and isinstance(head, L.QuantLinear):
        head.shard_classes(group, fc_tensor_sharding(
            mesh, head.kernel.shape[1]))
    return model
