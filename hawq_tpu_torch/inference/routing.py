"""Per-site kernel routing of the integer engines (port of
hawq_tpu/inference/routing.py).

A routing table maps conv keys to this card's routes:

  * ``'int8'``  — the int8 kernels (#1 ``int8_matmul_requant`` / #2
    ``int8_matmul_acc`` for a 1×1 conv, #6 / #7 for a k×k one);
  * ``'int4w'`` — the same products on nibble-packed weights (#3 / #4, #8 /
    #9), half the weight bytes.  On a layer whose weights are not 4-bit it
    takes ``'int8'``: packing needs nibble-range weights (the JAX package's
    rule, ``make_router``).

The JAX package's tables name TPU routes (``'xla'``, ``'pallas8'``,
``'pallas4w'``): readings of a TPU, which :func:`check_routing` refuses.
Tables for this card come from ``inference.autotune``.  Which sites a table
may route: every unit conv of a ResNet v1; the 1×1 convs of MobileNetV2 (the
accumulator forms #2 / #4, whose ReLU6 or residual epilogue stays PyTorch)
and of InceptionV3 where the requant fuses (#1 / #3 with ReLU: the requant
is monotone with requant(0) = 0, so requantizing max(acc, 0) clamps at 0).
A site a table does not list takes ``'int8'``.  Without a table each engine
keeps its own rule (a ResNet v1's 4-bit unit convs packed, every other conv
int8).

:class:`Routed1x1` is one 1×1 site's weights prepared once for its kernels;
the odd-K case of a packed site gains a zero row of weights and a zero
column of activations, which add exact zeros to the accumulator.
:func:`mobilenet_conv1x1_sites` and :func:`inception_conv1x1_sites`
enumerate the 1×1 sites the autotuner sweeps (the JAX package's tuples).
"""

from __future__ import annotations

from typing import (Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch
import torch.nn.functional as F

from hawq_tpu_torch.inference.freeze import FrozenModel
from hawq_tpu_torch.kernels import matmul as km

ROUTES = ('int8', 'int4w')
TPU_ROUTES = ('xla', 'pallas8', 'pallas4w')


def check_routing(table: Optional[Mapping[str, str]]
                  ) -> Optional[Dict[str, str]]:
    """A routing table without its comment keys (those starting with '_'),
    every value one of :data:`ROUTES`; None stays None."""
    if table is None:
        return None
    table = {k: v for k, v in table.items() if not k.startswith('_')}
    tpu = sorted(k for k, v in table.items() if v in TPU_ROUTES)
    if tpu:
        raise ValueError(
            f'routing table names TPU routes ({", ".join(TPU_ROUTES)}) at '
            f'{len(tpu)} sites, e.g. {tpu[0]!r}: those are readings of a TPU '
            f'(the JAX package\'s autotuner); measure this card\'s with '
            f'python -m hawq_tpu_torch.inference.autotune')
    bad = sorted(k for k, v in table.items() if v not in ROUTES)
    if bad:
        raise ValueError(f'routing table: {bad[0]!r} -> {table[bad[0]]!r} '
                         f'is not one of {ROUTES}')
    return table


class Routed1x1(NamedTuple):
    """A 1×1 conv (or FC) site's weights prepared once for the kernels of
    one kind (:meth:`prepare`): ``w`` the (K, N) int8 weights for #1 / #2,
    or with ``int4`` the nibble-packed (K/2, N) bytes for #3 / #4 (an odd K
    padded to even with a zero row), either laid out as the Hopper core's
    handle (``kernels.matmul.prepare_weights``) where its rule takes the
    widths; ``bias`` int32; ``cin`` the input channels."""
    w: object
    bias: torch.Tensor
    cin: int
    int4: bool

    @classmethod
    def prepare(cls, w, bias, int4: bool, kind: str,
                device: torch.device) -> 'Routed1x1':
        """``kind``: 'matmul' (the accumulator forms) or 'matmul_requant'
        (the requant forms), the ``sm90_route`` kind of its calls."""
        w = np.asarray(w, np.int8)
        cin, cout = w.shape[-2], w.shape[-1]
        w = w.reshape(cin, cout)
        if int4 and cin % 2:
            w = np.concatenate([w, np.zeros((1, cout), np.int8)])
        wd = torch.tensor(km.pack_int4(w) if int4 else
                          np.ascontiguousarray(w), device=device)
        if km.sm90_route(kind, k=w.shape[0], n=cout, ptr=0) is None:
            wd = (km.prepare_weights_int4(wd) if int4
                  else km.prepare_weights(wd))
        return cls(wd, torch.tensor(np.asarray(bias, np.int32).reshape(-1),
                                    device=device), cin, int4)

    def _rows(self, x8: torch.Tensor) -> torch.Tensor:
        """(..., C) int8 → (M, K) rows, a padded column zero."""
        if x8.shape[-1] != self.cin:
            raise ValueError(f'Routed1x1: {x8.shape[-1]} input channels, '
                             f'the weights take {self.cin}')
        x2 = x8.reshape(-1, self.cin)
        if self.int4 and self.cin % 2:
            x2 = F.pad(x2, (0, 1))
        return x2

    def requant(self, x8: torch.Tensor, mult: torch.Tensor, *, out_bits: int,
                signed: bool, relu: bool) -> torch.Tensor:
        """conv + bias → (ReLU) → requant, int8 (..., N): #1, or #3
        packed."""
        fn = km.int4w_matmul_requant if self.int4 else km.int8_matmul_requant
        y = fn(self._rows(x8), self.w, self.bias, mult, out_bits=out_bits,
               signed=signed, relu=relu)
        return y.reshape(*x8.shape[:-1], y.shape[-1])

    def acc(self, x8: torch.Tensor) -> torch.Tensor:
        """conv + bias → the int32 accumulator (..., N): #2, or #4 packed."""
        fn = km.int4w_matmul_acc if self.int4 else km.int8_matmul_acc
        y = fn(self._rows(x8), self.w, self.bias)
        return y.reshape(*x8.shape[:-1], y.shape[-1])


def make_router(fm: FrozenModel, device: torch.device,
                cache: Optional[Dict] = None
                ) -> Callable[[str, str, bool], Routed1x1]:
    """``route(key, kind, int4)`` → the :class:`Routed1x1` of 1×1 conv or FC
    ``key`` for kernels of ``kind``, nibble-packed with ``int4`` (the
    caller's rule: an engine's :meth:`_int4`), prepared once into
    ``cache`` (an engine keeps its weights there)."""
    cache = {} if cache is None else cache

    def route(key: str, kind: str, int4: bool) -> Routed1x1:
        if key not in cache:
            cache[key] = Routed1x1.prepare(fm[key + '.weight_int'],
                                           fm[key + '.bias_int'], int4, kind,
                                           device)
        return cache[key]
    return route


# ---------------------------------------------------------------------------
# routable-site enumeration (the autotuner's shape tables)
# ---------------------------------------------------------------------------

def mobilenet_conv1x1_sites(stages=None, init_ch=None, final_ch=None,
                            image_size: int = 224
                            ) -> List[Tuple[str, int, int, int, str]]:
    """(key, spatial, cin, cout, epilogue) for every 1×1 conv of the
    MobileNetV2 engine, epilogue 'acc' (the accumulator forms); the
    full-size model unless the tiny stage lists are passed."""
    from hawq_tpu_torch.models.mobilenetv2 import (MOBILENETV2_FINAL_CH,
                                                   MOBILENETV2_INIT_CH,
                                                   MOBILENETV2_STAGES)
    stages = MOBILENETV2_STAGES if stages is None else stages
    init_ch = MOBILENETV2_INIT_CH if init_ch is None else init_ch
    final_ch = MOBILENETV2_FINAL_CH if final_ch is None else final_ch
    sites = []
    spatial = image_size // 2                     # init conv s2
    in_ch = init_ch
    for i, stage in enumerate(stages, start=1):
        for j, out_ch in enumerate(stage, start=1):
            p = f'features.stage{i}.unit{j}'
            stride = 2 if (j == 1 and i != 1) else 1
            mid = in_ch * (1 if (i == 1 and j == 1) else 6)
            sites.append((f'{p}.conv1', spatial, in_ch, mid, 'acc'))
            spatial_out = spatial // stride
            sites.append((f'{p}.conv3', spatial_out, mid, out_ch, 'acc'))
            spatial, in_ch = spatial_out, out_ch
    sites.append(('features.final_block', spatial, in_ch, final_ch, 'acc'))
    return sites


def inception_conv1x1_sites(image_size: int = 299, width_div: int = 1
                            ) -> List[Tuple[str, int, int, int, str]]:
    """(key, spatial, cin, cout, epilogue) for every 1×1 stride-1 conv of
    the InceptionV3 engine, epilogue 'requant' (the JAX package's tuples;
    its copy also takes a bit config it does not read).
    Spatial geometry at 299: the stem 299 → 35, stage 1 at 35, stage 2 at
    17 (its reduction unit's 1×1 heads still at 35), stage 3 at 8 (heads at
    17)."""
    from hawq_tpu_torch.models import inceptionv3 as mi

    def d(c):
        return mi._cdiv(c, width_div) if width_div > 1 else c
    # the stem at 299: conv1 3×3/s2 → 149, conv2 3×3 → 147, conv3 → 147,
    # max-pool/s2 → 73, conv4 1×1 → 73, conv5 3×3 → 71, max-pool/s2 → 35
    s0 = (image_size - 1) // 2 - 2
    s_pool1 = (s0 - 1) // 2
    sp1 = (s_pool1 - 3) // 2
    spatials = {1: sp1, 2: (sp1 - 3) // 2 + 1,
                3: ((sp1 - 3) // 2 + 1 - 3) // 2 + 1}
    sites = [('features.q_init_block.q_conv4.q_convbn', s_pool1, d(64),
              d(80), 'requant')]
    in_ch = d(192)
    for i, j, unit in mi.units(width_div):
        reduction = j == 1 and i != 1
        sp = spatials[i - 1] if reduction else spatials[i]
        for name, kind, kwargs in unit.branch_defs:
            bp = f'{unit.prefix}.branches.{name}'
            if kind in (mi.CONV1X1, mi.AVG_POOL):
                sites.append((f'{bp}.q_conv.q_convbn', sp, in_ch,
                              kwargs['features'], 'requant'))
            elif kind in (mi.CONV_SEQ, mi.CONV_SEQ_3X3):
                c_in = in_ch
                for c, (oc, kz, st) in enumerate(
                        zip(kwargs['out_channels'], kwargs['kernels'],
                            kwargs['strides']), start=1):
                    if kz == 1 and st == 1:
                        sites.append((
                            f'{bp}.q_conv_list.q_conv{c}.q_convbn', sp, c_in,
                            oc, 'requant'))
                    c_in = oc
        in_ch = d(mi.INCEPTION_CHANNELS[i - 1][j - 1])
    return sites
