"""The ILP's latency LUT measured by the port
(``hawq_tpu_torch.sensitivity.latency_lut``) and the latency mode on it.

* With a stub timer the LUT has every cost key of the ILP (19 for
  ResNet-18, 52 for ResNet-50), each timed on both routes, lat8 the int8
  time and lat4 min(int4w, int8); its comment keys carry the device and the
  batch.
* ``generate_mixed_config(arch, 'latency', 0.5, published_traces=True,
  latency_lut=lut)`` returns a config whose table equals the one
  ``hawq_tpu.sensitivity.ilp`` allocates on the same LUT.
* The pipeline CLI reads the written file (its comment keys dropped), and
  the LUT CLI writes one on the CPU.
"""

import dataclasses
import json
import math

import pytest

from hawq_tpu.sensitivity import ilp as jilp

from hawq_tpu_torch.sensitivity import latency_lut as ll
from hawq_tpu_torch.sensitivity import pipeline
from hawq_tpu_torch.sensitivity.ilp import published_ilp_inputs


def _stub_timer(calls):
    """Seconds per call from the site's input shape: int4w is 0.6× or 1.3×
    int8 in turns, so that lat4 is int4w's at some sites and int8's at the
    others."""
    def timer(fns, x):
        calls.append((tuple(fns), tuple(x.shape)))
        t8 = 1e-5 * (1 + x.shape[1] * x.shape[3] % 97)
        t4 = t8 * (0.6 if len(calls) % 2 else 1.3)
        return {'int8': t8, 'int4w': t4}
    return timer


@pytest.fixture(scope='module')
def luts():
    out = {}
    for arch in ('resnet18', 'resnet50'):
        calls = []
        out[arch] = ll.measure_latency_lut(arch, batch=2, device='cpu',
                                           timer=_stub_timer(calls)), calls
    return out


@pytest.mark.parametrize('arch,n_keys', [('resnet18', 19), ('resnet50', 52)])
def test_lut_covers_the_ilp_keys(luts, arch, n_keys):
    lut, calls = luts[arch]
    assert lut['_device'] == 'cpu' and lut['_batch'] == 2
    layers = {k: v for k, v in lut.items() if not k.startswith('_')}
    keys = [c.key for c in published_ilp_inputs(arch)]
    assert len(keys) == n_keys and set(layers) == set(keys)
    assert len(calls) == n_keys
    assert all(routes == ('int8', 'int4w') and len(shape) == 4
               for routes, shape in calls)
    below = 0
    for lat4, lat8 in layers.values():
        assert 0 < lat4 <= lat8
        below += lat4 < lat8
    assert 0 < below < n_keys          # min(int4w, int8) took both sides


@pytest.mark.parametrize('arch', ['resnet18', 'resnet50'])
def test_latency_mode_equals_hawq_tpu_on_the_lut(luts, arch):
    lut = {k: tuple(v) for k, v in luts[arch][0].items()
           if not k.startswith('_')}
    cfg = pipeline.generate_mixed_config(arch, 'latency', 0.5,
                                         published_traces=True,
                                         latency_lut=lut)
    costs = [dataclasses.replace(c, latency4=lut[c.key][0],
                                 latency8=lut[c.key][1])
             for c in jilp.published_ilp_inputs(arch)]
    jcfg = jilp.allocation_to_bit_config(
        arch, jilp.allocate_bits(costs, 'latency', 0.5),
        'latency_0.5_generated')
    assert cfg.name == jcfg.name
    assert dict(cfg.table) == dict(jcfg.table)
    bits = [cfg.weight_bits(c.key) for c in published_ilp_inputs(arch)]
    assert 4 in bits and 8 in bits


def test_pipeline_cli_reads_the_written_lut(luts, tmp_path, capsys):
    path = str(tmp_path / 'lut.json')
    ll.save_latency_lut(path, luts['resnet18'][0])
    with open(path) as f:
        assert '_device' in json.load(f)
    out = str(tmp_path / 'cfg.json')
    pipeline.main(['--arch', 'resnet18', '--mode', 'latency', '--fraction',
                   '0.5', '--published-traces', '--latency-lut', path,
                   '--out', out])
    assert 'resnet18_latency_0.5_generated' in capsys.readouterr().out
    with open(out) as f:
        assert json.load(f)['name'] == 'resnet18_latency_0.5_generated'


def test_lut_cli_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / 'lut18.json')
    assert ll.main(['--arch', 'resnet18', '--batch', '1', '--image-size',
                    '32', '--device', 'cpu', '--out', path]) == 0
    assert 'wrote ' + path in capsys.readouterr().out
    lut = ll.load_latency_lut(path)
    assert len(lut) == 19
    # host-clock readings of tiny convs: lat4 = min(int4w, int8) ≤ lat8
    assert all(math.isfinite(b) and a <= b for a, b in lut.values())
