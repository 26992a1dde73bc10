"""Checkpoint save/load: training state and frozen integer artifacts (port
of the part of hawq_tpu/utils/checkpoint.py the trainer uses).

Formats are the reference's: plain ``.npz`` (flat key → array, nesting
joined with '/') plus a JSON manifest, no pickle.  A checkpoint written by
either package loads in the other.  The frozen artifact stores int4-eligible
weights as int8 containers; true bit-packing happens in the serving path.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np

from hawq_tpu_torch.configs.bit_config import BitConfig
from hawq_tpu_torch.inference.freeze import FrozenModel


# ---------------------------------------------------------------------------
# flat <-> nested tree
# ---------------------------------------------------------------------------

def flatten_dict(tree: Mapping, sep: str = '/') -> Dict[str, np.ndarray]:
    out = {}

    def rec(prefix, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                rec(f'{prefix}{sep}{k}' if prefix else str(k), v)
        else:
            out[prefix] = np.asarray(node)

    rec('', tree)
    return out


def unflatten_dict(flat: Mapping[str, np.ndarray], sep: str = '/') -> Dict:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(sep)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


# ---------------------------------------------------------------------------
# training checkpoints
# ---------------------------------------------------------------------------

_OPT_PREFIX = '__opt__'    # positional optimizer-state leaves in the npz


def _npz_path(path: str) -> str:
    return path if path.endswith('.npz') else path + '.npz'


def save_train_checkpoint(path: str, variables: Mapping,
                          meta: Optional[Mapping] = None,
                          opt_leaves: Optional[list] = None) -> None:
    """Training checkpoint: the variables tree (+ optional optimizer-state
    leaves, stored positionally) and a JSON ``meta`` beside it."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    flat = flatten_dict(variables)
    for i, leaf in enumerate(opt_leaves or []):
        flat[f'{_OPT_PREFIX}{i}'] = np.asarray(leaf)
    np.savez(path, **flat)
    if meta is not None:
        with open(path + '.meta.json', 'w') as f:
            json.dump(dict(meta), f, indent=1, default=str)


def load_train_checkpoint(path: str, return_opt: bool = False):
    """Returns (variables, meta), or (variables, meta, opt_leaves) with
    ``return_opt``, where opt_leaves is the positional list saved by
    :func:`save_train_checkpoint` ([] for checkpoints without optimizer
    state)."""
    with np.load(_npz_path(path)) as z:
        flat = {k: z[k] for k in z.files}
    opt_keys = sorted((k for k in flat if k.startswith(_OPT_PREFIX)),
                      key=lambda k: int(k[len(_OPT_PREFIX):]))
    opt_leaves = [flat.pop(k) for k in opt_keys]
    meta = None
    meta_path = _npz_path(path) + '.meta.json'
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if return_opt:
        return unflatten_dict(flat), meta, opt_leaves
    return unflatten_dict(flat), meta


# ---------------------------------------------------------------------------
# frozen integer artifacts
# ---------------------------------------------------------------------------

def save_frozen(path: str, fm: FrozenModel) -> None:
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    np.savez(path, **fm.tensors)
    with open(_npz_path(path) + '.manifest.json', 'w') as f:
        json.dump({'arch': fm.arch, 'num_classes': fm.num_classes,
                   'cfg': json.loads(fm.cfg.to_json())}, f, indent=1)


def load_frozen(path: str) -> FrozenModel:
    with np.load(_npz_path(path)) as z:
        tensors = {k: z[k] for k in z.files}
    with open(_npz_path(path) + '.manifest.json') as f:
        man = json.load(f)
    cfg = BitConfig.from_json(json.dumps(man['cfg']))
    return FrozenModel(arch=man['arch'], cfg=cfg, tensors=tensors,
                       num_classes=man['num_classes'])
