"""Checkpoint save/load (port of hawq_tpu/utils/checkpoint.py): training
state, frozen integer artifacts, the reference's quantized-checkpoint
format, and float-weight import from torch model zoos.

Training checkpoints and frozen artifacts are plain ``.npz`` (flat key →
array, nesting joined with '/') plus a JSON manifest, no pickle.  The
reference's quantized deployment checkpoint is its torch-pickled five-slice
dict (``quantized_checkpoint.pth.tar``): :func:`import_reference_quantized`
/ :func:`export_reference_quantized` map it to and from a FrozenModel, and
:func:`save_reference_quantized` / :func:`load_reference_quantized` write
and read the file.  The float importers map pytorchcv-style float state
dicts onto the QAT models' nested numpy ``(params, batch_stats)``, the
layout ``models.resnet.qat_from_numpy`` loads.  Every file written by
either package loads in the other.  The frozen artifact stores
int4-eligible weights as int8 containers; true bit-packing happens in the
serving path.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from hawq_tpu_torch.configs.bit_config import (BitConfig, RESNET_UNITS,
                                               RESNET_CONVS_PER_UNIT,
                                               resnet_layer_keys)
from hawq_tpu_torch.inference.freeze import FrozenModel
from hawq_tpu_torch.models import inceptionv3 as mi


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


# ---------------------------------------------------------------------------
# the reference's quantized checkpoint (HAWQ-V3 model zoo) <-> FrozenModel
# ---------------------------------------------------------------------------

_REF_SLICES = ('convbn_scaling_factor', 'fc_scaling_factor',
               'weight_integer', 'bias_integer', 'act_scaling_factor')
# Sixth, optional slice: the bare-QuantConv2d weight scale (the MobileNetV2
# output head).  The reference's own dump recipe collects only the five
# slices above, losing QuantConv2d's 'conv_scaling_factor' buffer and its
# bias (assigned in forward but never registered, so absent from
# state_dict): the reference cannot round-trip its own quantized
# MobileNetV2.  Checkpoints dumped with the extended filter (this slice
# added, the head bias registered) import completely here.
_REF_CONV_SLICE = 'conv_scaling_factor'


def _ref_key(key: str) -> str:
    """Strip the DataParallel 'module.' prefix the reference saves under."""
    return key[len('module.'):] if key.startswith('module.') else key


def _ref_np(v) -> np.ndarray:
    """torch tensor or array-like → numpy."""
    if hasattr(v, 'detach'):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _int_exact(v: np.ndarray, dtype, what: str) -> np.ndarray:
    """Cast integer-valued floats to an integer dtype, verifying exactness
    and range (the reference stores weight_integer / bias_integer as float
    buffers holding rounded values)."""
    f = np.asarray(v, np.float64)
    r = np.rint(f)
    if not np.array_equal(r, f):
        raise ValueError(f'{what}: non-integer values in integer slice')
    info = np.iinfo(dtype)
    if r.min() < info.min or r.max() > info.max:
        raise ValueError(f'{what}: values outside {np.dtype(dtype).name} '
                         f'range [{r.min()}, {r.max()}]')
    return np.ascontiguousarray(r, dtype)      # the kernels take C order


def import_reference_quantized(state: Mapping[str, Mapping[str, Any]],
                               arch: str, cfg: BitConfig,
                               num_classes: Optional[int] = None
                               ) -> FrozenModel:
    """Import the reference's quantized deployment checkpoint → FrozenModel.

    ``state`` is the five-slice dict the reference's validate() dumps as
    ``quantized_checkpoint.pth.tar``: convbn_scaling_factor,
    fc_scaling_factor, weight_integer, bias_integer, act_scaling_factor —
    each mapping ``module.``-prefixed module paths to tensors (torch
    tensors or numpy arrays).

    The wiring is the reference's checkpoint→TVM converter's:
      * conv weight_integer OIHW → HWIO as int8;
      * fc weight_integer (O, F) → (F, O);
      * bias_integer → int32 vectors;
      * convbn / fc_scaling_factor → per-channel float32 weight_scale;
      * act_scaling_factor (1,) buffers → scalar float32 act_scale, from
        which the engines chain every requant's scales.

    The result drives the engines in either requant mode; pass
    ``requant_mode='reference'`` to replay the reference's own 31-bit
    float64 rounding.  Incomplete, non-integer and out-of-range inputs raise
    ``ValueError``.
    """
    missing = [s for s in _REF_SLICES if s not in state]
    if missing:
        raise ValueError(f'not a reference quantized checkpoint: missing '
                         f'slices {missing}')
    tensors: Dict[str, np.ndarray] = {}

    for key, v in state['weight_integer'].items():
        base = _ref_key(key)[:-len('.weight_integer')]
        w = _ref_np(v)
        if w.ndim == 4:                      # conv, torch OIHW
            w = np.transpose(w, (2, 3, 1, 0))            # → HWIO
        elif w.ndim == 2:                    # linear, torch (O, F)
            w = np.transpose(w, (1, 0))                  # → (F, O)
        else:
            raise ValueError(f'{key}: unexpected weight rank {w.ndim}')
        tensors[base + '.weight_int'] = _int_exact(w, np.int8, key)

    for key, v in state['bias_integer'].items():
        base = _ref_key(key)[:-len('.bias_integer')]
        tensors[base + '.bias_int'] = _int_exact(
            _ref_np(v).reshape(-1), np.int32, key)

    scale_slices = ['convbn_scaling_factor', 'fc_scaling_factor']
    if _REF_CONV_SLICE in state:        # extended dump (see _REF_CONV_SLICE)
        scale_slices.append(_REF_CONV_SLICE)
    for slice_name in scale_slices:
        for key, v in state[slice_name].items():
            if not _ref_key(key).endswith('.' + slice_name):
                # substring-filtered dumps put 'convbn_scaling_factor' keys
                # into the 'conv_scaling_factor' slice too — skip them there
                continue
            base = _ref_key(key)[:-len('.' + slice_name)]
            tensors[base + '.weight_scale'] = (
                _ref_np(v).reshape(-1).astype(np.float32))

    for key, v in state['act_scaling_factor'].items():
        base = _ref_key(key)[:-len('.act_scaling_factor')]
        s = _ref_np(v).reshape(-1)
        tensors[base + '.act_scale'] = np.float32(s[0])

    # completeness against the arch's graph walk: a missing key fails here
    # with its name instead of deep inside an engine build
    need = []
    head_key = 'quant_output'
    if arch in RESNET_UNITS:
        for lk in resnet_layer_keys(arch):
            if 'conv' in lk.rsplit('.', 1)[-1] or lk == 'quant_output':
                need += [lk + '.weight_int', lk + '.bias_int',
                         lk + '.weight_scale']
            else:
                need.append(lk + '.act_scale')
    elif arch == 'mobilenetv2':
        need, head_key = _mobilenetv2_required_tensors(tensors)
    elif arch == 'inceptionv3':
        need, head_key = _inceptionv3_required_tensors(cfg)
    absent = [k for k in need if k not in tensors]
    if absent:
        hint = ''
        if arch == 'mobilenetv2' and any(k.startswith('output.')
                                         for k in absent):
            hint = (" — note: the reference's own dump recipe omits the "
                    "QuantConv2d head ('conv_scaling_factor' buffer + "
                    'unregistered bias); dump with the extended slice '
                    'filter (see utils/checkpoint.py _REF_CONV_SLICE)')
        raise ValueError(f'reference checkpoint incomplete for {arch}: '
                         f'missing {absent[:8]}'
                         + (' ...' if len(absent) > 8 else '') + hint)

    if num_classes is None:
        num_classes = int(tensors[head_key + '.weight_int'].shape[-1])
    return FrozenModel(arch=arch, cfg=cfg, tensors=tensors,
                       num_classes=num_classes)


def _mobilenetv2_required_tensors(tensors: Mapping[str, np.ndarray]):
    """Required tensor keys for a MobileNetV2 import.  The unit structure is
    read from the checkpoint itself (conv3 occurrences), so tiny test
    variants are checked with the same walk as the full model."""
    units = sorted({k.split('.weight_int')[0].rsplit('.conv3', 1)[0]
                    for k in tensors
                    if k.startswith('features.stage')
                    and k.endswith('.conv3.weight_int')})
    need = []
    for ck in (['init_block', 'features.final_block', 'output']
               + [f'{u}.conv{c}' for u in units for c in (1, 2, 3)]):
        need += [ck + '.weight_int', ck + '.bias_int', ck + '.weight_scale']
    for ak in (['quant_input', 'quant_act_int32',
                'quant_act_before_final_block', 'quant_act_int32_final',
                'quant_act_output']
               + [f'{u}.quant_act{suf}' for u in units
                  for suf in ('', '1', '2', '_int32')]):
        need.append(ak + '.act_scale')
    return need, 'output'


def _inceptionv3_required_tensors(cfg: BitConfig):
    """Required tensor keys for an InceptionV3 import: the walk of the
    port's unit tables (``models.inceptionv3.units``) that the model,
    freezer and engine share; the keys do not depend on the width."""
    need = []

    def conv(ck):
        need.extend([f'{ck}.q_convbn.weight_int', f'{ck}.q_convbn.bias_int',
                     f'{ck}.q_convbn.weight_scale', f'{ck}.q_activ.act_scale'])

    ip = 'features.q_init_block'
    need.append(f'{ip}.q_input_activ.act_scale')
    for c in range(1, len(mi.INIT_CONVS) + 1):
        conv(f'{ip}.q_conv{c}')
    for _, _, unit in mi.units():
        for name, kind, kwargs in unit.branch_defs:
            bp = f'{unit.prefix}.branches.{name}'
            need.append(f'{bp}.q_input_act.act_scale')
            if kind in (mi.CONV1X1, mi.AVG_POOL):
                conv(f'{bp}.q_conv')
                if kind == mi.AVG_POOL:
                    need.append(f'{bp}.q_pool_act.act_scale')
            elif kind in (mi.CONV_SEQ, mi.CONV_SEQ_3X3):
                for c in range(1, len(kwargs['out_channels']) + 1):
                    conv(f'{bp}.q_conv_list.q_conv{c}')
                if kind == mi.CONV_SEQ_3X3:
                    conv(f'{bp}.q_conv1x3')
                    conv(f'{bp}.q_conv3x1')
                    need.append(f'{bp}.q_rescaling_activ.act_scale')
        need.append(f'{unit.prefix}.q_rescaling_activ.act_scale')
    need.append('features.q_concat_activ.act_scale')
    need += ['output.q_fc.weight_int', 'output.q_fc.bias_int',
             'output.q_fc.weight_scale']
    return need, 'output.q_fc'


def export_reference_quantized(fm: FrozenModel) -> Dict[str, Dict]:
    """FrozenModel → the reference's quantized-checkpoint dict (the inverse
    of :func:`import_reference_quantized`).

    The slice layout the reference's validate() dumps, 'module.'-prefixed
    keys, numpy float32 values: weights transposed back HWIO → OIHW /
    (F, O) → (O, F), integer tensors as float buffers holding exact
    integers, as the reference stores them.  QuantLinear heads (ResNet
    'quant_output', InceptionV3 'output.q_fc') go to fc_scaling_factor; the
    MobileNetV2 QuantConv2d head ('output') to the sixth
    'conv_scaling_factor' slice (see _REF_CONV_SLICE)."""
    state: Dict[str, Dict] = {s: {} for s in _REF_SLICES + (_REF_CONV_SLICE,)}
    for key, t in fm.tensors.items():
        base, kind = key.rsplit('.', 1)
        mkey = 'module.' + base
        if kind == 'weight_int':
            w = np.asarray(t, np.float32)
            w = (np.transpose(w, (3, 2, 0, 1)) if w.ndim == 4
                 else np.transpose(w, (1, 0)))
            state['weight_integer'][mkey + '.weight_integer'] = w
        elif kind == 'bias_int':
            state['bias_integer'][mkey + '.bias_integer'] = \
                np.asarray(t, np.float32)
        elif kind == 'weight_scale':
            slc = ('fc_scaling_factor'
                   if base in ('quant_output', 'output.q_fc')
                   else _REF_CONV_SLICE if base == 'output'
                   else 'convbn_scaling_factor')
            state[slc][mkey + '.' + slc] = \
                np.asarray(t, np.float32).reshape(-1)
        elif kind == 'act_scale':
            state['act_scaling_factor'][mkey + '.act_scaling_factor'] = \
                np.full((1,), np.float32(t), np.float32)
    if not state[_REF_CONV_SLICE]:        # not MobileNetV2: the five slices
        del state[_REF_CONV_SLICE]
    return state


def save_reference_quantized(path: str, fm: FrozenModel) -> None:
    """Write ``quantized_checkpoint.pth.tar`` (torch-pickled, the
    reference's on-disk format) from a FrozenModel."""
    import torch
    state = {s: {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in d.items()}
             for s, d in export_reference_quantized(fm).items()}
    torch.save(state, path)


def load_reference_quantized(path: str, arch: str, cfg: BitConfig,
                             num_classes: Optional[int] = None
                             ) -> FrozenModel:
    """Load a reference ``quantized_checkpoint.pth.tar`` from disk (torch
    on the CPU unpickles it; everything after is numpy).

    ``weights_only=False`` is required: the artifact is a plain pickled
    dict of tensors, and unpickling runs whatever code the file names, so
    load only files from a source you trust.
    """
    import torch
    state = torch.load(path, map_location='cpu', weights_only=False)
    return import_reference_quantized(state, arch, cfg, num_classes)


# ---------------------------------------------------------------------------
# float weight import (torch model zoo -> the QAT models' params)
# ---------------------------------------------------------------------------

def _mutable(target_params: Mapping, target_batch_stats: Mapping):
    """Two-level copies of the target trees to fill in."""
    return ({k: dict(v) if isinstance(v, Mapping) else v
             for k, v in flatten_to_mutable(target_params).items()},
            {k: dict(v) if isinstance(v, Mapping) else v
             for k, v in flatten_to_mutable(target_batch_stats).items()})


def _convbn_putter(state_dict, params, bstats):
    """put(dst, src): the conv kernel (OIHW → HWIO) and BN γ/β into
    ``params[dst]``, its running mean / var into ``bstats[dst]``, from the
    state dict's ``<src>conv.weight`` and ``<src>bn.*``."""
    def put(dst: str, src: str):
        params[dst]['kernel'] = np.transpose(
            np.asarray(state_dict[src + 'conv.weight']), (2, 3, 1, 0))
        params[dst]['gamma'] = np.asarray(state_dict[src + 'bn.weight'])
        params[dst]['beta'] = np.asarray(state_dict[src + 'bn.bias'])
        bstats[dst]['mean'] = np.asarray(state_dict[src + 'bn.running_mean'])
        bstats[dst]['var'] = np.asarray(state_dict[src + 'bn.running_var'])
    return put


def import_torch_resnet(state_dict: Mapping[str, Any], arch: str,
                        target_params: Mapping,
                        target_batch_stats: Mapping) -> Tuple[Dict, Dict]:
    """Map a pytorchcv-style float ResNet state dict onto QResNet params.

    Takes numpy arrays (callers convert torch tensors with ``.numpy()``)
    and the model's ``params`` / ``batch_stats`` trees (as
    ``models.resnet.qat_to_numpy`` gives them) as the targets.  Conv
    weights transpose OIHW → HWIO; BN γ/β/μ/σ² map to (gamma, beta) params
    and (mean, var) batch_stats; the FC (O, F) → (F, O) — the reference's
    float resume remapping.  Returns the filled (params, batch_stats).
    """
    params, bstats = _mutable(target_params, target_batch_stats)
    put = _convbn_putter(state_dict, params, bstats)
    bottleneck = RESNET_CONVS_PER_UNIT[arch] == 3
    put('quant_init_convbn' if bottleneck else 'quant_init_block_convbn',
        'features.init_block.conv.')
    for s, n_units in enumerate(RESNET_UNITS[arch], start=1):
        for u in range(1, n_units + 1):
            mod = f'stage{s}_unit{u}'
            src = f'features.stage{s}.unit{u}.'
            for c in range(1, (3 if bottleneck else 2) + 1):
                put(f'{mod}/quant_convbn{c}', src + f'body.conv{c}.')
            if src + 'identity_conv.conv.weight' in state_dict:
                put(f'{mod}/quant_identity_convbn', src + 'identity_conv.')
    params['quant_output']['kernel'] = np.transpose(
        np.asarray(state_dict['output.weight']), (1, 0))
    params['quant_output']['bias'] = np.asarray(state_dict['output.bias'])
    return nest_two_level(params), nest_two_level(bstats)


def import_torch_mobilenetv2(state_dict: Mapping[str, Any], stages,
                             target_params: Mapping,
                             target_batch_stats: Mapping
                             ) -> Tuple[Dict, Dict]:
    """Map a pytorchcv-style float MobileNetV2 state dict onto QMobileNetV2:
    features.init_block.{conv,bn}, features.stage{i}.unit{j}.conv{1,2,3}.
    {conv,bn}, features.final_block, and a 1×1-conv output head.  Conv
    weights transpose OIHW → HWIO (the depthwise conv2's (C, 1, 3, 3) lands
    as (3, 3, 1, C))."""
    params, bstats = _mutable(target_params, target_batch_stats)
    put = _convbn_putter(state_dict, params, bstats)
    put('init_block', 'features.init_block.')
    for i, stage in enumerate(stages, start=1):
        for j, _ in enumerate(stage, start=1):
            for c in (1, 2, 3):
                put(f'stage{i}_unit{j}/conv{c}',
                    f'features.stage{i}.unit{j}.conv{c}.')
    put('final_block', 'features.final_block.')
    params['output']['kernel'] = np.transpose(
        np.asarray(state_dict['output.weight']), (2, 3, 1, 0))
    params['output']['bias'] = np.asarray(state_dict['output.bias'])
    return nest_two_level(params), nest_two_level(bstats)


def import_torch_inceptionv3(state_dict: Mapping[str, Any], cfg: BitConfig,
                             target_params: Mapping,
                             target_batch_stats: Mapping,
                             width_div: int = 1) -> Tuple[Dict, Dict]:
    """Map a pytorchcv-style float InceptionV3 state dict onto QInceptionV3:
    features.init_block.conv{1..5}, features.stage{i}.unit{j}.branches.
    branch{k} with per-branch conv / conv_list.conv{n} / conv1x3 / conv3x1
    ConvBlocks, and output.fc — walking the unit tables
    (``models.inceptionv3.units``) that the model, freezer and engine
    share.  ``cfg`` is not read (the graph does not depend on it); it stays
    for the reference's signature."""
    params, bstats = _mutable(target_params, target_batch_stats)
    put = _convbn_putter(state_dict, params, bstats)
    for c in range(1, len(mi.INIT_CONVS) + 1):
        put(f'q_conv{c}/q_convbn', f'features.init_block.conv{c}.')
    for i, j, unit in mi.units(width_div):
        for name, kind, kwargs in unit.branch_defs:
            src = f'features.stage{i}.unit{j}.branches.{name}.'
            dst = f'stage{i}_unit{j}/{name}'
            if kind in (mi.CONV1X1, mi.AVG_POOL):
                put(f'{dst}/q_conv/q_convbn', src + 'conv.')
            elif kind in (mi.CONV_SEQ, mi.CONV_SEQ_3X3):
                for c in range(1, len(kwargs['out_channels']) + 1):
                    put(f'{dst}/q_conv{c}/q_convbn',
                        src + f'conv_list.conv{c}.')
                if kind == mi.CONV_SEQ_3X3:
                    put(f'{dst}/q_conv1x3/q_convbn', src + 'conv1x3.')
                    put(f'{dst}/q_conv3x1/q_convbn', src + 'conv3x1.')
    params['q_fc']['kernel'] = np.transpose(
        np.asarray(state_dict['output.fc.weight']), (1, 0))
    params['q_fc']['bias'] = np.asarray(state_dict['output.fc.bias'])
    return nest_two_level(params), nest_two_level(bstats)


def flatten_to_mutable(tree: Mapping) -> Dict[str, Dict]:
    """Two-level view: {'stage1_unit1/quant_convbn1': {...leaf dict...}}."""
    out: Dict[str, Dict] = {}

    def rec(prefix, node):
        if isinstance(node, Mapping) and node and all(
                not isinstance(v, Mapping) for v in node.values()):
            out[prefix] = dict(node)
        elif isinstance(node, Mapping):
            for k, v in node.items():
                rec(f'{prefix}/{k}' if prefix else str(k), v)
        else:
            out[prefix] = node

    rec('', tree)
    return out


# The inverse of :func:`flatten_to_mutable`: '/'-joined keys back into
# nested dicts (the reference's name for :func:`unflatten_dict`).
nest_two_level = unflatten_dict
