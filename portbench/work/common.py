"""One conv or FC layer's work, and the roofline bound of a list of them."""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
from typing import List, Mapping

PEAKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'peaks.json')


def peaks() -> Mapping[str, float]:
    with open(PEAKS) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class Layer:
    """A ``kh``×``kw`` conv (the FC as a 1×1 on a 1×1 map) over ``batch``
    images of ``hw_in``² × ``cin`` to ``hw_out``² × ``cout``."""
    key: str
    batch: int
    hw_in: int
    hw_out: int
    kh: int
    kw: int
    cin: int
    cout: int
    groups: int
    in_bits: int
    w_bits: int
    out_bits: int
    stride: int = 1

    @property
    def macs(self) -> int:
        return (self.batch * self.hw_out ** 2 * self.cout * self.kh * self.kw
                * self.cin // self.groups)

    @property
    def ops(self) -> int:
        """Integer operations: a multiply and an add per MAC."""
        return 2 * self.macs

    @property
    def bytes(self) -> float:
        """The input once (of a strided 1×1, the pixels it reads), the
        weights and int32 bias once, the output once."""
        hw_read = (self.hw_out if self.kh == self.kw == 1 and self.stride > 1
                   else self.hw_in)
        x = self.batch * hw_read ** 2 * self.cin * self.in_bits / 8
        w = (self.kh * self.kw * self.cin // self.groups * self.cout
             * self.w_bits / 8)
        y = self.batch * self.hw_out ** 2 * self.cout * self.out_bits / 8
        return x + w + 4 * self.cout + y

    def bound_s(self, pk: Mapping[str, float]) -> float:
        """The least time the card could take: the larger of the int8
        operations over the int8 peak and the bytes over the memory
        bandwidth."""
        return max(self.ops / pk['int8_ops_per_s'],
                   self.bytes / pk['hbm_bytes_per_s'])


def family(config: Mapping):
    """The module of the configuration's family, ``work/<family>.py``."""
    return importlib.import_module(f"portbench.work.{config['family']}")


def forward_layers(config: Mapping, batch: int) -> List[Layer]:
    """The layers of the configuration's family at ``batch`` images."""
    return family(config).layers(config, batch)


def forward_ops(config: Mapping, batch: int) -> int:
    return sum(l.ops for l in forward_layers(config, batch))


def forward_bound_s(config: Mapping, batch: int) -> float:
    pk = peaks()
    return sum(l.bound_s(pk) for l in forward_layers(config, batch))
