"""The ILP bit allocator of hawq_tpu_torch == hawq_tpu's.

* ``allocate_bits`` on the reference's published inputs, resnet18 and
  resnet50 × {model_size, bops, latency} × {0.25, 0.5, 0.75}: the same
  bits, objective and resource;
* ``resnet_layer_costs`` / ``mobilenet_layer_costs`` equal field by field
  on the same weights (the port's models' ``qat_to_numpy`` params) and
  traces;
* the BitConfigs the allocations expand to, ``to_json()`` byte for byte;
* the pipeline's published-input path and its latency-LUT checks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hawq_tpu.sensitivity import ilp as jilp

from hawq_tpu_torch.models.mobilenetv2 import (QMobileNetV2,
                                               TINY_MNV2_FINAL_CH,
                                               TINY_MNV2_INIT_CH,
                                               TINY_MNV2_STAGES)
from hawq_tpu_torch.models.resnet import QResNet, qat_to_numpy
from hawq_tpu_torch.sensitivity import ilp as tilp
from hawq_tpu_torch.sensitivity import pipeline as tp

torch.set_num_threads(1)

MODES = ('model_size', 'bops', 'latency')
FRACTIONS = (0.25, 0.5, 0.75)
_params = {}


def _resnet_params(arch):
    if arch not in _params:
        _params[arch] = qat_to_numpy(QResNet(arch, num_classes=10,
                                             seed=1))['params']
    return _params[arch]


def _traces(params, seed):
    """Random positive traces for every conv of a params tree."""
    rng = np.random.RandomState(seed)
    out = {}
    for mod, sub in sorted(params.items()):
        for name, leaf in sorted(sub.items()):
            if isinstance(leaf, dict) and 'kernel' in leaf:
                out[f'{mod}/{name}'] = float(rng.rand() * 10 ** rng.randint(
                    -3, 2))
    return out


def _fields(costs):
    return [dataclasses.astuple(c) for c in costs]


@pytest.mark.parametrize('arch', ['resnet18', 'resnet50'])
def test_published_inputs_equal(arch):
    assert _fields(tilp.published_ilp_inputs(arch)) == _fields(
        jilp.published_ilp_inputs(arch))


@pytest.mark.parametrize('fraction', FRACTIONS)
@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('arch', ['resnet18', 'resnet50'])
def test_allocation_on_published_inputs_equals_hawq_tpus(arch, mode,
                                                         fraction):
    got = tilp.allocate_bits(tilp.published_ilp_inputs(arch), mode, fraction)
    want = jilp.allocate_bits(jilp.published_ilp_inputs(arch), mode,
                              fraction)
    assert got.bits == want.bits
    assert (got.objective, got.resource_used, got.resource_limit) == (
        want.objective, want.resource_used, want.resource_limit)
    assert got.resource_used <= got.resource_limit
    name = f'{mode}_{fraction}_generated'
    assert tilp.allocation_to_bit_config(arch, got, name).to_json() == \
        jilp.allocation_to_bit_config(arch, want, name).to_json()


@pytest.mark.parametrize('arch,size', [('tiny18', 32), ('tiny50', 32),
                                       ('resnet18', 224), ('resnet50', 224)])
def test_resnet_layer_costs_equal(arch, size):
    params = _resnet_params(arch)
    traces = _traces(params, 3)
    lut = {f'stage1.unit1.quant_convbn{c}': (0.1 * c, 0.2 * c)
           for c in (1, 2)}
    got = tilp.resnet_layer_costs(arch, params, traces, input_size=size,
                                  latency_lut=lut)
    want = jilp.resnet_layer_costs(arch, params, traces, input_size=size,
                                   latency_lut=lut)
    assert _fields(got) == _fields(want) and len(got) > 4
    for mode in ('model_size', 'bops'):
        a = tilp.allocate_bits(got, mode, 0.5)
        b = jilp.allocate_bits(want, mode, 0.5)
        assert a.bits == b.bits
        assert tilp.allocation_to_bit_config(arch, a, 'g').to_json() == \
            jilp.allocation_to_bit_config(arch, b, 'g').to_json()


@pytest.mark.parametrize('tiny', [True, False])
def test_mobilenet_layer_costs_and_config_equal(tiny):
    kw = (dict(stages=TINY_MNV2_STAGES, init_ch=TINY_MNV2_INIT_CH,
               final_ch=TINY_MNV2_FINAL_CH) if tiny else {})
    model = QMobileNetV2(num_classes=10, seed=2, **kw)
    params = qat_to_numpy(model)['params']
    traces = _traces(params, 4)
    stages = model.stages
    got = tilp.mobilenet_layer_costs(params, traces, stages=stages,
                                     input_size=64)
    want = jilp.mobilenet_layer_costs(params, traces, stages=stages,
                                      input_size=64)
    assert _fields(got) == _fields(want)
    for mode in ('model_size', 'bops'):
        a = tilp.allocate_bits(got, mode, 0.5)
        b = jilp.allocate_bits(want, mode, 0.5)
        assert a.bits == b.bits
        assert tilp.mobilenet_allocation_to_bit_config(
            a, 'g', stages).to_json() == \
            jilp.mobilenet_allocation_to_bit_config(b, 'g', stages).to_json()


def test_pipeline_published_path_and_latency_lut():
    lut = {c.key: (c.latency4 * 0.5, c.latency8 * 0.25)
           for c in tilp.published_ilp_inputs('resnet18')}
    cfg = tp.generate_mixed_config('resnet18', 'latency', 0.5,
                                   published_traces=True, latency_lut=lut)
    costs = [dataclasses.replace(c, latency4=lut[c.key][0],
                                 latency8=lut[c.key][1])
             for c in jilp.published_ilp_inputs('resnet18')]
    want = jilp.allocation_to_bit_config(
        'resnet18', jilp.allocate_bits(costs, 'latency', 0.5),
        'latency_0.5_generated')
    assert cfg.to_json() == want.to_json()
    with pytest.raises(ValueError, match='latency LUT'):
        tp.generate_mixed_config('resnet18', 'latency', 0.5,
                                 published_traces=True)
    with pytest.raises(KeyError, match='missing'):
        tp.generate_mixed_config('resnet18', 'latency', 0.5,
                                 published_traces=True,
                                 latency_lut=dict(list(lut.items())[1:]))
    with pytest.raises(ValueError, match='checkpoint'):
        tp.generate_mixed_config('resnet18', 'bops', 0.5,
                                 published_traces=True, checkpoint='x.npz')
