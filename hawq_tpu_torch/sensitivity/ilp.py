"""ILP mixed-precision bit allocation (scipy.optimize.milp; port of
hawq_tpu/sensitivity/ilp.py, numpy and scipy).

Re-implements the reference's PuLP/GLPK notebook (ILP.ipynb cells 3-27)
as a library function.  Per quantizable layer i a binary choice
y_i ∈ {0 (4-bit), 1 (8-bit)} minimizes the total sensitivity-weighted
quantization perturbation

    Ω = Σ_i trace_i · [ y_i·ΔW8²_i + (1−y_i)·ΔW4²_i ]

subject to exactly one resource constraint (ILP.ipynb's three modes):

    model_size:  Σ params_i·bits_i/8          ≤ size4  + frac·(size8−size4)
    bops:        Σ macs_i·bits_i·act_bits_i   ≤ bops4  + frac·(bops8−bops4)
    latency:     Σ lat_LUT[i][bits_i]         ≤ lat4   + frac·(lat8−lat4)

plus tie constraints forcing identity (downsample) convs to the bitwidth of
their parallel mainstream conv (ILP.ipynb cells 14-16, 25-27).

Outputs a BitConfig in the reference naming scheme: conv weight bits from
the ILP, activation quantizers following their producing conv (the 4-bit
activation → asymmetric convention), residual nodes at 16.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import LinearConstraint, milp, Bounds

from hawq_tpu_torch.configs.bit_config import (BitConfig, QuantSettings,
                                               RESNET_UNITS,
                                               RESNET_CONVS_PER_UNIT,
                                               resnet_layer_keys)
from hawq_tpu_torch.models.mobilenetv2 import MOBILENETV2_STAGES
from hawq_tpu_torch.sensitivity.hessian import quantization_perturbation


@dataclasses.dataclass
class LayerCost:
    """Per-layer inputs to the allocator."""
    key: str                    # config key, e.g. 'stage1.unit1.quant_convbn1'
    trace: float                # normalized Hessian trace (trace/#params)
    delta_w4: float             # ‖W − Q4(W)‖²
    delta_w8: float             # ‖W − Q8(W)‖²
    params: int                 # #weights
    macs: float                 # multiply-accumulates per inference
    latency4: float = 0.0       # measured ms at W4A4 (latency mode)
    latency8: float = 0.0       # measured ms at W8A8
    tie_to: Optional[str] = None  # force same bits as this layer's key


@dataclasses.dataclass
class AllocationResult:
    bits: Dict[str, int]
    objective: float
    resource_used: float
    resource_limit: float


def allocate_bits(layers: Sequence[LayerCost], mode: str,
                  fraction: float) -> AllocationResult:
    """Solve the binary ILP.  mode ∈ {'model_size', 'bops', 'latency'};
    fraction ∈ (0, 1] positions the budget between all-4-bit (0) and
    all-8-bit (1) as in the reference's 0.25/0.5/0.75 grids."""
    n = len(layers)
    idx = {l.key: i for i, l in enumerate(layers)}

    # objective: minimize Σ trace·ΔW4 + y_i·trace·(ΔW8−ΔW4)
    base = sum(l.trace * l.delta_w4 for l in layers)
    c = np.array([l.trace * (l.delta_w8 - l.delta_w4) for l in layers])

    if mode == 'model_size':
        cost4 = np.array([l.params * 4 / 8 for l in layers], float)
        cost8 = np.array([l.params * 8 / 8 for l in layers], float)
    elif mode == 'bops':
        # weight-bits × act-bits × MACs; activations follow weights (W4A4 /
        # W8A8 pairing, as in the reference grids)
        cost4 = np.array([l.macs * 4 * 4 for l in layers], float)
        cost8 = np.array([l.macs * 8 * 8 for l in layers], float)
    elif mode == 'latency':
        cost4 = np.array([l.latency4 for l in layers], float)
        cost8 = np.array([l.latency8 for l in layers], float)
    else:
        raise ValueError(f'unknown mode {mode}')

    lo, hi = cost4.sum(), cost8.sum()
    limit = lo + fraction * (hi - lo)
    # Σ cost4 + y·(cost8−cost4) ≤ limit
    a_resource = (cost8 - cost4)[None, :]
    constraints = [LinearConstraint(a_resource, -np.inf, limit - lo)]

    # tie constraints y_i − y_j = 0
    for l in layers:
        if l.tie_to is not None:
            row = np.zeros(n)
            row[idx[l.key]] = 1.0
            row[idx[l.tie_to]] = -1.0
            constraints.append(LinearConstraint(row[None, :], 0.0, 0.0))

    res = milp(c=c, integrality=np.ones(n),
               bounds=Bounds(np.zeros(n), np.ones(n)),
               constraints=constraints)
    if not res.success:
        raise RuntimeError(f'ILP infeasible: {res.message}')

    y = np.round(res.x).astype(int)
    bits = {l.key: (8 if y[i] else 4) for i, l in enumerate(layers)}
    used = float(cost4.sum() + a_resource[0] @ y)
    return AllocationResult(bits=bits, objective=float(base + c @ y),
                            resource_used=used, resource_limit=float(limit))


def resnet_layer_costs(arch: str, params: Mapping, traces: Mapping[str, float],
                       input_size: int = 224,
                       latency_lut: Optional[Mapping[str, Tuple[float, float]]]
                       = None) -> List[LayerCost]:
    """Build LayerCost entries for a QResNet's stage convs.

    ``params`` is the nested params tree (``models.resnet.qat_to_numpy(
    model)['params']``, or a flax one); ``traces`` maps module paths
    ('stage1_unit1/quant_convbn1') to normalized traces.  Init block and
    output head are excluded (always 8-bit, bit_config.py:63-121 convention).
    Identity convs tie to their unit's conv1 (ILP.ipynb downsample ties).
    MACs are computed from the actual spatial geometry.
    """
    bottleneck = RESNET_CONVS_PER_UNIT[arch] == 3
    conv1_stride = arch == 'resnet50'   # v1: stage stride on the 1×1 conv1
    layers: List[LayerCost] = []
    # spatial size after init conv (stride 2) + maxpool (stride 2)
    spatial = input_size // 4

    for s, n_units in enumerate(RESNET_UNITS[arch], start=1):
        in_spatial = spatial            # unit input resolution (pre-stride)
        if s > 1:
            spatial //= 2               # resolution after the strided conv
        for u in range(1, n_units + 1):
            mod = f'stage{s}_unit{u}'
            p = f'stage{s}.unit{u}'
            n_convs = 3 if bottleneck else 2
            keys = [f'quant_convbn{c}' for c in range(1, n_convs + 1)]
            if 'quant_identity_convbn' in params[mod]:
                keys.append('quant_identity_convbn')
            # which conv carries the stage stride (only unit 1 strides):
            # resnet50 v1 puts it on conv1; v1.5 (50b/101) on the 3×3 conv2;
            # basic blocks on conv1 (their 3×3).  Convs before the strided
            # one run at the pre-stride resolution.
            strided = ('quant_convbn1' if (conv1_stride or not bottleneck)
                       else 'quant_convbn2') if (u == 1 and s > 1) else None
            for k in keys:
                kernel = np.asarray(params[mod][k]['kernel'])
                kh, kw, cin, cout = kernel.shape
                if strided is not None and k == 'quant_convbn1' \
                        and strided == 'quant_convbn2':
                    out_sp = in_spatial   # conv1 runs pre-stride (v1.5)
                else:
                    out_sp = spatial
                macs = kh * kw * cin * cout * out_sp * out_sp
                key = f'{p}.{k}'
                lat = (latency_lut or {}).get(key, (0.0, 0.0))
                layers.append(LayerCost(
                    key=key,
                    trace=float(traces.get(f'{mod}/{k}', 1.0)),
                    delta_w4=quantization_perturbation(kernel, 4),
                    delta_w8=quantization_perturbation(kernel, 8),
                    params=int(kernel.size),
                    macs=float(macs),
                    latency4=lat[0], latency8=lat[1],
                    tie_to=(f'{p}.quant_convbn1'
                            if k == 'quant_identity_convbn' else None)))
    return layers


def mobilenet_layer_costs(params: Mapping, traces: Mapping[str, float],
                          stages=None, input_size: int = 224,
                          latency_lut: Optional[Mapping[str,
                                                        Tuple[float, float]]]
                          = None) -> List[LayerCost]:
    """LayerCost entries for a QMobileNetV2's unit convs.

    The reference ships ILP-derived mobilenetv2_w1 modelsize/bops tables
    (bit_config.py:3604-4053) but generates them offline; this builds the
    same allocator inputs from a trained params tree.  Init block, final
    block, and the output head are excluded (always 8-bit, per the
    published tables).  conv1 runs at the unit's input resolution,
    conv2 (depthwise, strided) and conv3 at the output resolution.
    """
    stages = MOBILENETV2_STAGES if stages is None else stages

    layers: List[LayerCost] = []
    spatial = input_size // 2                  # after init conv s2
    for i, stage in enumerate(stages, start=1):
        for j, _ in enumerate(stage, start=1):
            mod = f'stage{i}_unit{j}'
            p = f'features.stage{i}.unit{j}'
            stride = 2 if (j == 1 and i != 1) else 1
            sp_in, sp_out = spatial, spatial // stride
            for c, sp in ((1, sp_in), (2, sp_out), (3, sp_out)):
                kernel = np.asarray(params[mod][f'conv{c}']['kernel'])
                kh, kw, cin, cout = kernel.shape
                # depthwise conv2: HWIO (3,3,1,C), one MAC chain per channel
                macs = kh * kw * cin * cout * sp * sp
                key = f'{p}.conv{c}'
                lat = (latency_lut or {}).get(key, (0.0, 0.0))
                layers.append(LayerCost(
                    key=key,
                    trace=float(traces.get(f'{mod}/conv{c}', 1.0)),
                    delta_w4=quantization_perturbation(kernel, 4),
                    delta_w8=quantization_perturbation(kernel, 8),
                    params=int(kernel.size),
                    macs=float(macs),
                    latency4=lat[0], latency8=lat[1]))
            spatial = sp_out
    return layers


def mobilenet_allocation_to_bit_config(alloc: AllocationResult,
                                       scheme_name: str,
                                       stages=None) -> BitConfig:
    """Expand mobilenet conv choices into a full table: each quant_act
    follows the conv it feeds (the published-table convention —
    mobilenetv2_w1_bops_0.5), residual/requant nodes 16, init/final/head 8."""
    stages = MOBILENETV2_STAGES if stages is None else stages
    table: Dict[str, int] = {
        'quant_input': 8, 'init_block': 8, 'quant_act_int32': 16,
        'quant_act_before_final_block': 8, 'features.final_block': 8,
        'quant_act_int32_final': 16, 'quant_act_output': 8, 'output': 8}
    for i, stage in enumerate(stages, start=1):
        for j, _ in enumerate(stage, start=1):
            p = f'features.stage{i}.unit{j}'
            bits = [alloc.bits.get(f'{p}.conv{c}', 8) for c in (1, 2, 3)]
            table[f'{p}.quant_act'] = bits[0]
            table[f'{p}.conv1'] = bits[0]
            table[f'{p}.quant_act1'] = bits[1]
            table[f'{p}.conv2'] = bits[1]
            table[f'{p}.quant_act2'] = bits[2]
            table[f'{p}.conv3'] = bits[2]
            table[f'{p}.quant_act_int32'] = 16
    return BitConfig(name=f'mobilenetv2_w1_{scheme_name}', table=table,
                     settings=QuantSettings())


def published_ilp_inputs(arch: str) -> List[LayerCost]:
    """LayerCost list from the reference's published measured arrays.

    The arrays (Hutchinson traces, ‖W−Q(W)‖², params, BOPS, T4 latency LUT)
    are the hard-coded inputs of ILP.ipynb cells 4/17, shipped as data in
    configs/data/ilp_inputs_<arch>.json.  Index order matches the notebook's
    variable numbering: per unit conv1..convN then the identity conv (its
    tie constraints x4==x6 / x0==x3 etc. confirm this order).  Running
    :func:`allocate_bits` on these inputs must regenerate the published
    mixed configs — the SURVEY §7 stage-6 validation.
    """
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'configs', 'data',
        f'ilp_inputs_{arch}.json')
    with open(path) as f:
        d = json.load(f)

    n_convs = RESNET_CONVS_PER_UNIT[arch]
    keys: List[Tuple[str, Optional[str]]] = []
    for s, n_units in enumerate(RESNET_UNITS[arch], start=1):
        for u in range(1, n_units + 1):
            p = f'stage{s}.unit{u}'
            for c in range(1, n_convs + 1):
                keys.append((f'{p}.quant_convbn{c}', None))
            # stage-opening units resize the identity (stage 1 too for
            # bottleneck nets; never for basic-block stage 1)
            if u == 1 and not (n_convs == 2 and s == 1):
                keys.append((f'{p}.quant_identity_convbn',
                             f'{p}.quant_convbn1'))
    assert len(keys) == len(d['trace']), (len(keys), len(d['trace']))

    return [LayerCost(key=k, trace=d['trace'][i], delta_w4=d['dw4'][i],
                      delta_w8=d['dw8'][i], params=d['params'][i],
                      macs=d['bops'][i], latency4=d['lat4'][i],
                      latency8=d['lat8'][i], tie_to=tie)
            for i, (k, tie) in enumerate(keys)]


def allocation_to_bit_config(arch: str, alloc: AllocationResult,
                             scheme_name: str) -> BitConfig:
    """Expand conv bit choices into a full BitConfig: activations follow the
    unit's weight bits, residual nodes 16, init/head 8."""
    table: Dict[str, int] = {}
    for key in resnet_layer_keys(arch):
        if key.endswith('quant_act_int32'):
            table[key] = 16
        elif key in ('quant_input', 'quant_init_convbn',
                     'quant_init_block_convbn', 'quant_act_output',
                     'quant_output'):
            table[key] = 8
        elif key in alloc.bits:
            table[key] = alloc.bits[key]
        else:
            # activation quantizers: follow the convs they feed
            prefix = key.rsplit('.', 1)[0]
            unit_bits = [b for k, b in alloc.bits.items()
                         if k.startswith(prefix + '.')]
            table[key] = max(unit_bits) if unit_bits else 8
    return BitConfig(name=f'{arch}_{scheme_name}', table=table,
                     settings=QuantSettings())
