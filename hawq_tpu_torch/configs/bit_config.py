"""Per-layer quantization config registry (the PyTorch port's copy of
hawq_tpu/configs/bit_config.py; standard library only).

Unifies the reference's three config tiers (SURVEY.md §5): the training-side
``bit_config_dict`` name→bit tables (the upstream HAWQ bit_config.py:1-4204),
the argparse quant flags (quant_train.py:26-152), and the deployment-side
QConfig/QuantizeContext registry (tvm_benchmark/mixed_precision_models/
layers.py:8-32) into one serializable object consumed by both the QAT model
builders and the frozen integer engine.

Layer keys use the reference's naming convention so its published mixed
configs carry over directly::

    quant_input, quant_init_convbn, quant_act_int32,
    stage{S}.unit{U}.{quant_act, quant_convbn1, quant_act1, quant_convbn2,
                      quant_act2, quant_convbn3, quant_identity_convbn,
                      quant_act_int32},
    quant_act_output, quant_output

Uniform schemes are generated programmatically; the ILP-derived mixed
schemes ship as JSON data (configs/data/*.json, regenerable by
hawq_tpu.sensitivity.ilp) mirroring the published tables.

Application rule (quant_train.py:266-301): entries set the activation bit of
QuantAct nodes and the weight bit of conv/linear nodes; a 4-bit activation
switches that node to asymmetric (unsigned, zero-point-0) mode; residual
``quant_act_int32`` nodes carry 16 bits and stay symmetric; input/output
nodes stay at 8 bits even in uniform4.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, Mapping, Optional, Tuple

_DATA_DIR = os.path.join(os.path.dirname(__file__), 'data')

# Per-architecture unit counts (q_resnet.py:35, 96, 157).  The tiny variants
# exercise identical wiring (resize + non-resize units, both block types) at
# a fraction of the compile cost — used by the CPU test suite.
RESNET_UNITS = {
    'resnet18': (2, 2, 2, 2),
    'resnet50': (3, 4, 6, 3),
    'resnet50b': (3, 4, 6, 3),
    'resnet34': (3, 4, 6, 3),
    'resnet101': (3, 4, 23, 3),
    'resnet152': (3, 8, 36, 3),
    'resnet200': (3, 24, 36, 3),      # quantized_resnet_v1.py:473-616 table
    'resnet269': (3, 30, 48, 8),
    'tiny18': (1, 2),
    'tiny50': (1, 2),
    # wide50: MXU-aligned channels at tiny depth — exercises the pallas
    # conv-kernel routing (requires C%128==0) on the CPU test budget
    'wide50': (1, 1),
    # CIFAR-style resnets (quantized_resnet_v1.py:504-513): 3 stages of
    # (n−2)/6 basic units (n < 164) or (n−2)/9 bottlenecks (n ≥ 164),
    # 3×3/s1 init conv, no maxpool.
    'resnet20_cifar': (3, 3, 3),
    'resnet56_cifar': (9, 9, 9),
    'resnet110_cifar': (18, 18, 18),
    'resnet164_cifar': (18, 18, 18),
}
# Basic blocks have 2 convs, bottlenecks 3.
RESNET_CONVS_PER_UNIT = {'resnet18': 2, 'resnet34': 2, 'resnet50': 3,
                         'resnet50b': 3, 'resnet101': 3, 'resnet152': 3,
                         'resnet200': 3, 'resnet269': 3,
                         'tiny18': 2, 'tiny50': 3, 'wide50': 3,
                         'resnet20_cifar': 2, 'resnet56_cifar': 2,
                         'resnet110_cifar': 2, 'resnet164_cifar': 3}
# Archs using the CIFAR init block: 3×3/s1/pad1 conv, no maxpool
# (quantized_resnet_v1.py:334-348, 375-380).
RESNET_CIFAR_ARCHS = frozenset({'resnet20_cifar', 'resnet56_cifar',
                                'resnet110_cifar', 'resnet164_cifar'})


@dataclasses.dataclass(frozen=True)
class QuantSettings:
    """Global quantization hyper-parameters (the argparse tier)."""
    bias_bit: int = 32
    per_channel: bool = True
    act_percentile: float = 0.0
    weight_percentile: float = 0.0
    act_range_momentum: float = 0.99
    fix_bn: bool = False
    fix_bn_threshold: Optional[int] = None
    fixed_point_quantization: bool = False


@dataclasses.dataclass(frozen=True)
class BitConfig:
    """name → bitwidth table plus global settings."""
    name: str
    table: Mapping[str, int]
    settings: QuantSettings = QuantSettings()

    def act_bits(self, key: str) -> int:
        return int(self.table.get(key, 8))

    def act_mode(self, key: str) -> str:
        return 'asymmetric' if self.act_bits(key) == 4 else 'symmetric'

    def weight_bits(self, key: str) -> int:
        return int(self.table.get(key, 8))

    def __contains__(self, key: str) -> bool:
        return key in self.table

    def to_json(self) -> str:
        return json.dumps({'name': self.name, 'table': dict(self.table),
                           'settings': dataclasses.asdict(self.settings)},
                          indent=1, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> 'BitConfig':
        d = json.loads(text)
        return BitConfig(name=d['name'], table=d['table'],
                         settings=QuantSettings(**d.get('settings', {})))


def resnet_layer_keys(arch: str) -> Iterator[str]:
    """All config keys of a quantized ResNet, in graph order.

    The init-conv key is arch-dependent (reference naming): bottleneck nets
    use 'quant_init_convbn', basic-block nets 'quant_init_block_convbn'
    (q_resnet.py:37 vs :98) — the model builders and freeze_resnet read the
    same arch-correct key.
    """
    units = RESNET_UNITS[arch]
    n_convs = RESNET_CONVS_PER_UNIT[arch]
    yield 'quant_input'
    yield ('quant_init_convbn' if n_convs == 3 else 'quant_init_block_convbn')
    yield 'quant_act_int32'
    for s, n_units in enumerate(units, start=1):
        for u in range(1, n_units + 1):
            p = f'stage{s}.unit{u}'
            yield f'{p}.quant_act'
            for c in range(1, n_convs + 1):
                yield f'{p}.quant_convbn{c}'
                if c < n_convs:
                    yield f'{p}.quant_act{c}'
            if u == 1 and not (n_convs == 2 and s == 1):
                # stage-opening units resize the identity — except stage 1 of
                # basic-block nets, where channels don't change.
                yield f'{p}.quant_identity_convbn'
            yield f'{p}.quant_act_int32'
    yield 'quant_act_output'
    yield 'quant_output'


def uniform_config(arch: str, bits: int) -> BitConfig:
    """uniform8 / uniform4 schemes (bit_config.py:3-231 pattern).

    Residual-precision nodes get 16 bits; the input quantizer, the init
    block, and the output head stay at 8 bits regardless.
    """
    table: Dict[str, int] = {}
    for key in resnet_layer_keys(arch):
        if key.endswith('quant_act_int32'):
            table[key] = 16
        elif key in ('quant_input', 'quant_init_convbn',
                     'quant_init_block_convbn', 'quant_act_output',
                     'quant_output'):
            table[key] = 8
        else:
            table[key] = bits
    return BitConfig(name=f'{arch}_uniform{bits}', table=table)


def resnet_v2_layer_keys(base: str) -> Iterator[str]:
    """Config keys of a pre-activation (v2) quantized ResNet, graph order
    (models/resnet_v2.py; reference quantized_resnet_v2.py naming analog)."""
    units = RESNET_UNITS[base]
    n_convs = RESNET_CONVS_PER_UNIT[base]
    yield 'quant_input'
    yield 'quant_init_conv'
    yield 'quant_act_int32'
    for s, n_units in enumerate(units, start=1):
        for u in range(1, n_units + 1):
            p = f'stage{s}.unit{u}'
            yield f'{p}.quant_act'           # the qbn1 output quantizer
            for c in range(1, n_convs + 1):
                yield f'{p}.quant_conv{c}'
                if c < n_convs:
                    yield f'{p}.quant_act{c}'
            if u == 1 and not (n_convs == 2 and s == 1):
                yield f'{p}.quant_identity_conv'
            yield f'{p}.quant_act_int32'
    yield 'quant_act_output'
    yield 'quant_output'


def uniform_config_v2(base: str, bits: int) -> BitConfig:
    table: Dict[str, int] = {}
    for key in resnet_v2_layer_keys(base):
        if key.endswith('quant_act_int32'):
            table[key] = 16
        elif key in ('quant_input', 'quant_init_conv', 'quant_act_output',
                     'quant_output'):
            table[key] = 8
        else:
            table[key] = bits
    return BitConfig(name=f'{base}v2_uniform{bits}', table=table)


def _load_mixed(name: str) -> Optional[BitConfig]:
    path = os.path.join(_DATA_DIR, name + '.json')
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return BitConfig.from_json(f.read())


# model archs whose published tables are filed under a different registry
# name (reference: bit_config_mobilenetv2_w1_*)
_ARCH_ALIASES = {'mobilenetv2': 'mobilenetv2_w1'}


def get_bit_config(arch: str, scheme: str) -> BitConfig:
    """Lookup: e.g. get_bit_config('resnet50', 'uniform8' | 'bops_0.5' | ...).

    Transcribed JSON tables (configs/data/) take precedence; resnet uniforms
    are generated programmatically (uniform_config / uniform_config_v2)."""
    arch = _ARCH_ALIASES.get(arch, arch)
    cfg = _load_mixed(f'{arch}_{scheme}')
    if cfg is not None:
        return cfg
    if scheme.startswith('uniform'):
        if arch.endswith('v2') and arch[:-2] in RESNET_UNITS:
            return uniform_config_v2(arch[:-2], int(scheme[len('uniform'):]))
        if arch in RESNET_UNITS:
            return uniform_config(arch, int(scheme[len('uniform'):]))
    raise KeyError(f'no bit config {arch}_{scheme}; available: '
                   f'{sorted(available_schemes(arch))}')


def available_schemes(arch: str) -> Iterator[str]:
    arch = _ARCH_ALIASES.get(arch, arch)
    if arch in RESNET_UNITS or (arch.endswith('v2')
                                and arch[:-2] in RESNET_UNITS):
        yield 'uniform8'
        yield 'uniform4'
    if os.path.isdir(_DATA_DIR):
        for fn in os.listdir(_DATA_DIR):
            if fn.startswith(arch + '_') and fn.endswith('.json'):
                yield fn[len(arch) + 1:-len('.json')]
