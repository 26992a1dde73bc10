"""Plain integer-only forward of a ResNet v1 with bottleneck units, for the
benchmark's comparison.

The network follows He et al. 2015 (arXiv:1512.03385, Table 1, the
50-layer column): a 7×7/2 conv, a 3×3/2 max-pool, four stages of
bottleneck units (1×1, 3×3, 1×1) whose first unit changes the width
through a 1×1 projection on the shortcut, a global average pool and a
fully connected layer.  The stride of a stage's first unit sits on its
first 1×1 conv, as in the paper's original model and in HAWQ's ResNet-50
(later variants put it on the 3×3).

Departures from the paper, all of them HAWQ-V3's integer-only inference
(Yao et al. 2021): batch norm is folded into each conv's integer weights,
per-channel weight scales and int32 bias; activations are integers on a
per-tensor grid, brought from each accumulator to the next grid by a
dyadic requant (``numerics``); ReLU is the clamp at 0 before the requant;
the residual sum adds the two branches, each requantized to the unit's
output grid, and the carrier between units is an integer on that grid;
the average pool truncates; the logits are the head's accumulator times
its scale.  The bit widths come from the configuration's rule
(:func:`bits`).
"""

from __future__ import annotations

from typing import Iterator, Mapping, Tuple

import numpy as np
import torch

from portbench.reference import numerics as nx


def bits(config: Mapping, key: str) -> int:
    """The activation bits of node ``key``: the residual carriers
    (``*quant_act_int32*``) at ``residual_bits``, every other node at
    ``act_bits``."""
    if 'quant_act_int32' in key:
        return int(config['residual_bits'])
    return int(config['act_bits'])


def units(config: Mapping) -> Iterator[Tuple[str, int, int, int, int, bool]]:
    """(prefix, in_ch, mid, out_ch, stride, projection) of every unit."""
    in_ch = config['init_features']
    for s, n in enumerate(config['units'], start=1):
        for u in range(1, n + 1):
            stride = 2 if (u == 1 and s > 1) else 1
            out = config['outs'][s - 1]
            yield (f'stage{s}.unit{u}', in_ch, config['mids'][s - 1], out,
                   stride, u == 1 and (in_ch != out or stride != 1))
            in_ch = out


class Frozen:
    """The frozen model's arrays with the scale arithmetic of the forward."""

    def __init__(self, config: Mapping, tensors: Mapping[str, np.ndarray]):
        self.config, self.t = config, tensors

    def s(self, key: str) -> np.float32:
        return np.float32(self.t[key + '.act_scale'])

    def acc_scale(self, key: str, act_scale) -> np.ndarray:
        return nx.f32_scale(self.t[key + '.weight_scale'], act_scale)

    def conv(self, x, key, stride, pad):
        return nx.conv(x, self.t[key + '.weight_int'], self.t[key + '.bias_int'],
                       stride, pad)

    def requant(self, acc, acc_scale, out_key):
        return nx.requant(acc, nx.dyadic_multiplier(
            nx.ratio(acc_scale, self.s(out_key))), bits(self.config, out_key))


def forward(config: Mapping, tensors: Mapping[str, np.ndarray],
            images: torch.Tensor, input_mode: str = 'float32',
            mean=(0.485, 0.456, 0.406),
            std=(0.229, 0.224, 0.225)) -> torch.Tensor:
    """Logits (float32, (B, classes)) of NHWC ``images`` (float32, or uint8
    pixels with ``input_mode='uint8'``), on the images' device."""
    f = Frozen(config, tensors)
    x = images.permute(0, 3, 1, 2)
    if input_mode == 'uint8':
        x = nx.normalize_uint8(x, mean, std)
    elif input_mode != 'float32':
        raise ValueError(f'input_mode {input_mode!r}')
    s_in = f.s('quant_input')
    x = nx.quantize_input(x.to(torch.float32), s_in, bits(config,
                                                          'quant_input'))

    # init block: conv, ReLU, requant to the carrier, max-pool
    k = config['init_kernel']
    acc = torch.clamp_min(f.conv(x, 'quant_init_convbn', 2, k // 2), 0)
    x = f.requant(acc, f.acc_scale('quant_init_convbn', s_in),
                  'quant_act_int32')
    x = nx.maxpool3x3s2(x)
    prev = f.s('quant_act_int32')

    for p, _, _, _, stride, proj in units(config):
        sa = f.s(f'{p}.quant_act')
        xa = f.requant(x, prev, f'{p}.quant_act')
        if proj:
            key = f'{p}.quant_identity_convbn'
            identity = f.conv(xa[:, :, ::stride, ::stride], key, 1, 0)
            id_scale = f.acc_scale(key, sa)
        else:
            identity, id_scale = x, prev
        key = f'{p}.quant_convbn1'
        h = torch.clamp_min(f.conv(xa[:, :, ::stride, ::stride], key, 1, 0),
                            0)
        h = f.requant(h, f.acc_scale(key, sa), f'{p}.quant_act1')
        key = f'{p}.quant_convbn2'
        acc = torch.clamp_min(f.conv(h, key, 1, 1), 0)
        h = f.requant(acc, f.acc_scale(key, f.s(f'{p}.quant_act1')),
                      f'{p}.quant_act2')
        key = f'{p}.quant_convbn3'
        acc = f.conv(h, key, 1, 0)
        out = f'{p}.quant_act_int32'
        s_out = f.s(out)
        main = nx.dyadic_multiplier(nx.ratio(
            f.acc_scale(key, f.s(f'{p}.quant_act2')), s_out))
        side = nx.dyadic_multiplier(nx.ratio(id_scale, s_out))
        x = torch.clamp_min(nx.requant_add(acc, main, identity, side), 0)
        prev = s_out

    pooled = nx.avg_pool(x)
    f8 = f.requant(pooled, prev, 'quant_act_output')
    w = tensors['quant_output.weight_int'].reshape(
        -1, config['num_classes'])
    acc = (f8.to(torch.float64) @ torch.as_tensor(
        w, device=f8.device).to(torch.float64)).to(torch.int64)
    acc = acc + torch.as_tensor(tensors['quant_output.bias_int'],
                                device=acc.device).to(torch.int64)
    return nx.logits(acc, tensors['quant_output.weight_scale'],
                     f.s('quant_act_output'))
