"""Plain integer-only forward of InceptionV3, for the benchmark's comparison.

The network follows Szegedy et al. 2015 (arXiv:1512.00567, Table 1 and
Figures 5-7) in pytorchcv's layout, which is HAWQ's: a stem of five convs
(3×3/2, 3×3, 3×3 padded, 1×1, 3×3) with a 3×3/2 max-pool after the third
and the fifth; three A units (Figure 5: 1×1, 1×1→5×5, 1×1→3×3→3×3 and an
average-pool branch); the grid reduction B (3×3/2, 1×1→3×3→3×3/2 and a
max-pool); four C units (Figure 6, the 7×7 factorized into 1×7 and 7×1,
with c7 = 128, 160, 160, 192 intermediate channels); the grid reduction D
(1×1→3×3/2, 1×1→1×7→7×1→3×3/2 and a max-pool); two E units (Figure 7,
whose 3×3 branches end in a parallel 1×3 / 3×1 pair); a global average
pool and a fully connected layer over 1000 classes.  Pools and the
unpadded convs are VALID, as in the paper (a 299² image ends at 8²).

Departures from the paper, all of them HAWQ-V3's integer-only inference
(Yao et al. 2021, arXiv:2011.10680) or its deployment of the model: no
auxiliary classifier, no dropout; batch norm is folded into each conv's
integer weights, per-channel weight scales and int32 bias; activations are
integers on a per-tensor grid, brought from each accumulator to the next
grid by a dyadic requant (``numerics``); ReLU is the clamp at 0 before the
requant; each branch's input is requantized to the branch's own grid, and
each branch's output to its unit's shared grid before the concatenation
(an E unit's 1×3 / 3×1 pair first to the branch's grid); the average-pool
branches sum each 3×3 window over a zero border of 1 and take trunc(sum /
9 + 0.01), the divisor 9 at the border too; the global pool truncates the
same way; the logits are the head's accumulator times its scale.  The bit
widths come from the configuration's rule (:func:`bits`).

``width_div`` divides every channel count (each at least 4 where it is
above 1), for the benchmark's tests at small widths.
"""

from __future__ import annotations

import functools
from typing import List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import numerics as nx

IP = 'features.q_init_block'
INPUT = f'{IP}.q_input_activ'
HEAD_IN = 'features.q_concat_activ'
HEAD = 'output.q_fc'
# the stem's convs: (channels, kernel, stride, padding); a 3×3/2 VALID
# max-pool follows the convs in STEM_POOLS
STEM = ((32, 3, 2, 0), (32, 3, 1, 0), (64, 3, 1, 1), (80, 1, 1, 0),
        (192, 3, 1, 0))
STEM_POOLS = (3, 5)
A_OUT = (256, 288, 288)                  # the A units' output channels
C7 = (128, 160, 160, 192)                # the C units' intermediate channels

# branch kinds: a 1×1 conv; a chain of convs; a 3×3/1/1 average pool and a
# 1×1 conv; a 3×3/2 max-pool; a chain ending in a parallel 1×3 / 3×1 pair
CONV1X1, CHAIN, AVG, MAX, PAIR = 'conv1x1', 'chain', 'avg', 'max', 'pair'

# a conv of a branch: (out channels, (kh, kw), stride, (ph, pw))
Conv = Tuple[int, Tuple[int, int], int, Tuple[int, int]]


def _c(cout: int, k=1, stride: int = 1, pad=0) -> Conv:
    k = (k, k) if isinstance(k, int) else tuple(k)
    pad = (pad, pad) if isinstance(pad, int) else tuple(pad)
    return (cout, k, stride, pad)


def width(c: int, width_div: int) -> int:
    """A channel count at ``width_div``: c // width_div, at least 4."""
    return c if width_div == 1 else max(c // width_div, 4)


def stem(config: Mapping) -> List[Tuple[int, int, int, int]]:
    w = int(config['width_div'])
    return [(width(c, w), k, s, p) for c, k, s, p in STEM]


def units(config: Mapping) -> List[Tuple[str, tuple]]:
    """(prefix, branches) of every unit in order; a branch is (name, kind,
    its convs)."""
    w = int(config['width_div'])
    d = functools.partial(width, width_div=w)
    out = []
    for j, a_out in enumerate(A_OUT, start=1):
        out.append((f'features.stage1.unit{j}', (
            ('branch1', CONV1X1, [_c(d(64))]),
            ('branch2', CHAIN, [_c(d(48)), _c(d(64), 5, 1, 2)]),
            ('branch3', CHAIN, [_c(d(64)), _c(d(96), 3, 1, 1),
                                _c(d(96), 3, 1, 1)]),
            ('branch4', AVG, [_c(d(a_out - 224))]))))
    out.append(('features.stage2.unit1', (
        ('branch1', CHAIN, [_c(d(384), 3, 2)]),
        ('branch2', CHAIN, [_c(d(64)), _c(d(96), 3, 1, 1),
                            _c(d(96), 3, 2)]),
        ('branch3', MAX, []))))
    for j, mid in enumerate(C7, start=2):
        m = d(mid)
        out.append((f'features.stage2.unit{j}', (
            ('branch1', CONV1X1, [_c(d(192))]),
            ('branch2', CHAIN, [_c(m), _c(m, (1, 7), 1, (0, 3)),
                                _c(d(192), (7, 1), 1, (3, 0))]),
            ('branch3', CHAIN, [_c(m), _c(m, (7, 1), 1, (3, 0)),
                                _c(m, (1, 7), 1, (0, 3)),
                                _c(m, (7, 1), 1, (3, 0)),
                                _c(d(192), (1, 7), 1, (0, 3))]),
            ('branch4', AVG, [_c(d(192))]))))
    out.append(('features.stage3.unit1', (
        ('branch1', CHAIN, [_c(d(192)), _c(d(320), 3, 2)]),
        ('branch2', CHAIN, [_c(d(192)), _c(d(192), (1, 7), 1, (0, 3)),
                            _c(d(192), (7, 1), 1, (3, 0)),
                            _c(d(192), 3, 2)]),
        ('branch3', MAX, []))))
    for j in (2, 3):
        out.append((f'features.stage3.unit{j}', (
            ('branch1', CONV1X1, [_c(d(320))]),
            ('branch2', PAIR, [_c(d(384))]),
            ('branch3', PAIR, [_c(d(448)), _c(d(384), 3, 1, 1)]),
            ('branch4', AVG, [_c(d(192))]))))
    return out


# the pair that ends a PAIR branch: (name, kernel, padding)
PAIR_CONVS = (('q_conv1x3', (1, 3), (0, 1)), ('q_conv3x1', (3, 1), (1, 0)))


def branch_convs(bp: str, kind: str, convs) -> List[Tuple[str, Conv]]:
    """(node prefix, conv) of every conv of a branch, in order; the pair
    of a PAIR branch takes the chain's last width."""
    if kind in (CONV1X1, AVG):
        return [(f'{bp}.q_conv', convs[0])]
    out = [(f'{bp}.q_conv_list.q_conv{i}', c)
           for i, c in enumerate(convs, start=1)]
    if kind == PAIR:
        out += [(f'{bp}.{name}', (convs[-1][0], k, 1, p))
                for name, k, p in PAIR_CONVS]
    return out


@functools.lru_cache(maxsize=None)
def wide_nodes() -> frozenset:
    """HAWQ-V3's 16-bit nodes of InceptionV3 (its ``bit_config.py``
    ``inceptionv3`` tables): the stem's last conv, the last conv of every
    branch (both convs of a pair, and the pair's requant), the input of
    every pool branch, and every unit's concat.  The names do not depend
    on the widths."""
    out = {f'{IP}.q_conv{len(STEM)}.q_activ'}
    for prefix, branches in units({'width_div': 1}):
        out.add(f'{prefix}.q_rescaling_activ')
        for name, kind, convs in branches:
            bp = f'{prefix}.branches.{name}'
            if kind in (AVG, MAX):
                out.add(f'{bp}.q_input_act')
            if kind == MAX:
                continue
            nodes = branch_convs(bp, kind, convs)
            if kind == PAIR:
                out.update(f'{kp}.q_activ' for kp, _ in nodes[-2:])
                out.add(f'{bp}.q_rescaling_activ')
            else:
                out.add(f'{nodes[-1][0]}.q_activ')
    return frozenset(out)


def bits(config: Mapping, key: str) -> int:
    """The activation bits of node ``key``: the nodes of
    :func:`wide_nodes` at ``wide_bits``, every other node at
    ``act_bits``."""
    if key in wide_nodes():
        return int(config['wide_bits'])
    return int(config['act_bits'])


class Frozen:
    """The frozen model's arrays with the scale arithmetic of the forward."""

    def __init__(self, config: Mapping, tensors: Mapping[str, np.ndarray]):
        self.config, self.t = config, tensors

    def s(self, key: str) -> np.float32:
        return np.float32(self.t[key + '.act_scale'])

    def requant(self, x, scale, out_key):
        """``x`` on the grid of ``scale`` (an accumulator's, per channel,
        or a node's) → node ``out_key``'s integers."""
        return nx.requant(x, nx.dyadic_multiplier(
            nx.ratio(scale, self.s(out_key))), bits(self.config, out_key))

    def conv(self, x, s_in, kp: str, stride: int, pad):
        """conv + bias → ReLU → the requant to ``<kp>.q_activ`` → (its
        integers, its scale)."""
        key = f'{kp}.q_convbn'
        acc = nx.conv(x, self.t[key + '.weight_int'], self.t[key + '.bias_int'],
                      stride, pad)
        out = f'{kp}.q_activ'
        acc_scale = nx.f32_scale(self.t[key + '.weight_scale'], s_in)
        return (self.requant(torch.clamp_min(acc, 0), acc_scale, out),
                self.s(out))


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """3×3 / stride 2 VALID max-pool of integers (exact in float64)."""
    return F.max_pool2d(x.to(torch.float64), 3, 2).to(torch.int64)


def avg_pool3x3(x: torch.Tensor) -> torch.Tensor:
    """3×3 / stride 1 average pool of NCHW integers over a zero border of 1:
    the window's integer sum, then trunc(sum / 9 + 0.01) in float32."""
    h, w = x.shape[2:]
    xp = F.pad(x, (1, 1, 1, 1))
    s = sum(xp[:, :, dy:dy + h, dx:dx + w]
            for dy in range(3) for dx in range(3))
    return torch.trunc(nx.true_div(s.to(torch.float32), 9.0) + 0.01).to(
        torch.int64)


def _branch(f: Frozen, x, s, bp: str, kind: str, convs):
    """One branch on the unit input ``x`` at scale ``s`` → (its integers,
    its scale)."""
    node = f'{bp}.q_input_act'
    h, a = f.requant(x, s, node), f.s(node)
    if kind == MAX:
        return max_pool(h), a
    if kind == AVG:
        node = f'{bp}.q_pool_act'
        h, a = f.requant(avg_pool3x3(h), a, node), f.s(node)
    nodes = branch_convs(bp, kind, convs)
    chain = nodes[:-2] if kind == PAIR else nodes
    for kp, (_, _, stride, pad) in chain:
        h, a = f.conv(h, a, kp, stride, pad)
    if kind != PAIR:
        return h, a
    key = f'{bp}.q_rescaling_activ'
    pair = [f.conv(h, a, kp, stride, pad)
            for kp, (_, _, stride, pad) in nodes[-2:]]
    return torch.cat([f.requant(y, ay, key) for y, ay in pair], 1), f.s(key)


def forward(config: Mapping, tensors: Mapping[str, np.ndarray],
            images: torch.Tensor, input_mode: str = 'float32',
            mean=(0.485, 0.456, 0.406),
            std=(0.229, 0.224, 0.225), emit=None) -> torch.Tensor:
    """Logits (float32, (B, classes)) of NHWC ``images`` (float32, or uint8
    pixels with ``input_mode='uint8'``), on the images' device.  ``emit``,
    where given, is called with the name and NCHW integers of the stem's
    output ('init') and of each unit's concat (its
    '<prefix>.q_rescaling_activ')."""
    emit = emit or (lambda name, value: None)
    f = Frozen(config, tensors)
    x = images.permute(0, 3, 1, 2)
    if input_mode == 'uint8':
        x = nx.normalize_uint8(x, mean, std)
    elif input_mode != 'float32':
        raise ValueError(f'input_mode {input_mode!r}')
    s = f.s(INPUT)
    x = nx.quantize_input(x.to(torch.float32), s, bits(config, INPUT))

    for c, (_, _, stride, pad) in enumerate(STEM, start=1):
        x, s = f.conv(x, s, f'{IP}.q_conv{c}', stride, pad)
        if c in STEM_POOLS:
            x = max_pool(x)
    emit('init', x)

    for prefix, branches in units(config):
        outs = [_branch(f, x, s, f'{prefix}.branches.{name}', kind, convs)
                for name, kind, convs in branches]
        key = f'{prefix}.q_rescaling_activ'
        x = torch.cat([f.requant(h, a, key) for h, a in outs], 1)
        s = f.s(key)
        emit(key, x)

    f8 = f.requant(nx.avg_pool(x), s, HEAD_IN)
    w = tensors[HEAD + '.weight_int'].reshape(-1, config['num_classes'])
    acc = (f8.to(torch.float64) @ torch.as_tensor(
        w, device=f8.device).to(torch.float64)).to(torch.int64)
    acc = acc + torch.as_tensor(tensors[HEAD + '.bias_int'],
                                device=acc.device).to(torch.int64)
    return nx.logits(acc, tensors[HEAD + '.weight_scale'], f.s(HEAD_IN))
