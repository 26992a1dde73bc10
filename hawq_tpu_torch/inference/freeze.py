"""Deployable integer checkpoint (port of hawq_tpu/inference/freeze.py).

A flat dict of numpy arrays (layer-key → weight_int int8 / bias_int int32 /
weight_scale f32[C] / act_scale f32[]) plus the BitConfig.  The engine
(inference/engine.py) uploads what it needs to the device at build time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np

from hawq_tpu_torch.configs.bit_config import BitConfig


@dataclasses.dataclass
class FrozenModel:
    """Deployable integer checkpoint."""
    arch: str
    cfg: BitConfig
    tensors: Dict[str, np.ndarray]      # '<key>.weight_int' etc.
    num_classes: int = 1000

    def __getitem__(self, k: str) -> np.ndarray:
        return self.tensors[k]

    def act_scale(self, key: str) -> np.float32:
        return np.float32(self.tensors[key + '.act_scale'])


def frozen_from_numpy(arch: str, cfg_name: str, cfg_table: Mapping[str, int],
                      tensors: Mapping[str, np.ndarray],
                      num_classes: int = 1000) -> FrozenModel:
    """Carry a checkpoint across as plain numpy and dicts: the parts of any
    FrozenModel (for example one produced by hawq_tpu) become the port's
    FrozenModel with identical integers and scales."""
    cfg = BitConfig(name=cfg_name, table=dict(cfg_table))
    return FrozenModel(arch=arch, cfg=cfg,
                       tensors={k: np.array(v) for k, v in tensors.items()},
                       num_classes=num_classes)


def model_size_bytes(fm: FrozenModel) -> int:
    """Deployed model size with true bit-packing (int4 weights count 4 bits)."""
    total_bits = 0
    for key, t in fm.tensors.items():
        if key.endswith('.weight_int'):
            layer = key[:-len('.weight_int')]
            bits = fm.cfg.weight_bits(layer)
            total_bits += t.size * bits
        elif key.endswith('.bias_int'):
            total_bits += t.size * 32
        elif key.endswith(('.weight_scale', '.act_scale')):
            total_bits += t.size * 32
    return total_bits // 8
