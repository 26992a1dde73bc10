"""Conv shape tables of the model families (the port's copy of the JAX
package's ``benchmarks/latency_lut.py`` walkers ``conv_shapes`` and
``mobilenetv2_conv_shapes``), on the port's own bit-config and model tables.
``inference.profile.engine_flops_and_bytes`` and
``inference.autotune.routable_convs`` read them.
"""

from __future__ import annotations

from typing import List, Tuple

from hawq_tpu_torch.configs.bit_config import (RESNET_CONVS_PER_UNIT,
                                               RESNET_UNITS)
from hawq_tpu_torch.models.mobilenetv2 import (MOBILENETV2_FINAL_CH,
                                               MOBILENETV2_INIT_CH,
                                               MOBILENETV2_STAGES)
from hawq_tpu_torch.models.resnet import _INIT_FEATURES, _STAGE_CHANNELS


def mobilenetv2_conv_shapes(input_size: int = 224
                            ) -> List[Tuple[str, int, int, int, int, int,
                                            int, int]]:
    """(key, H_in, stride, kh, kw, cin_per_group, cout, groups) for every
    MobileNetV2 conv, the init conv and the head included."""
    out = [('init_block', input_size, 2, 3, 3, 3, MOBILENETV2_INIT_CH, 1)]
    spatial = input_size // 2
    in_ch = MOBILENETV2_INIT_CH
    for i, stage in enumerate(MOBILENETV2_STAGES, start=1):
        for j, out_ch in enumerate(stage, start=1):
            p = f'features.stage{i}.unit{j}'
            stride = 2 if (j == 1 and i != 1) else 1
            mid = in_ch * 6 if (i != 1 or j != 1) else in_ch
            out.append((f'{p}.conv1', spatial, 1, 1, 1, in_ch, mid, 1))
            out.append((f'{p}.conv2', spatial, stride, 3, 3, 1, mid, mid))
            spatial //= stride
            out.append((f'{p}.conv3', spatial, 1, 1, 1, mid, out_ch, 1))
            in_ch = out_ch
    out.append(('features.final_block', spatial, 1, 1, 1, in_ch,
                MOBILENETV2_FINAL_CH, 1))
    out.append(('output', 1, 1, 1, 1, MOBILENETV2_FINAL_CH, 1000, 1))
    return out


def conv_shapes(arch: str, input_size: int = 224
                ) -> List[Tuple[str, int, int, int, int, int, int]]:
    """(key, H_in, stride, kh, kw, cin, cout) for every unit conv of a
    ResNet v1, per image (the JAX package's copy also takes a ``batch`` it
    does not read)."""
    bottleneck = RESNET_CONVS_PER_UNIT[arch] == 3
    mids, outs = _STAGE_CHANNELS[arch]
    conv1_stride = arch == 'resnet50'
    spatial = input_size // 4
    in_ch = _INIT_FEATURES.get(arch, 64)
    out = []
    for s, n_units in enumerate(RESNET_UNITS[arch], start=1):
        if s > 1:
            spatial //= 2
        for u in range(1, n_units + 1):
            p = f'stage{s}.unit{u}'
            stride = 2 if (u == 1 and s > 1) else 1
            out_ch = outs[s - 1]
            h_in = spatial * stride
            if u == 1 and (in_ch != out_ch or stride != 1):
                out.append((f'{p}.quant_identity_convbn', h_in, stride,
                            1, 1, in_ch, out_ch))
            if bottleneck:
                mid = mids[s - 1]
                s1 = stride if conv1_stride else 1
                s2 = 1 if conv1_stride else stride
                out.append((f'{p}.quant_convbn1', h_in, s1, 1, 1, in_ch, mid))
                out.append((f'{p}.quant_convbn2', h_in // s1, s2, 3, 3,
                            mid, mid))
                out.append((f'{p}.quant_convbn3', spatial, 1, 1, 1,
                            mid, out_ch))
            else:
                out.append((f'{p}.quant_convbn1', h_in, stride, 3, 3,
                            in_ch, out_ch))
                out.append((f'{p}.quant_convbn2', spatial, 1, 3, 3,
                            out_ch, out_ch))
            in_ch = out_ch
    return out
