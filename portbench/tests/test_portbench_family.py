"""A second model family joins the benchmark by new files alone: its bit
rule, int4 control, plain QAT reference, trainer key map and layer counts
come from the configuration's ``family``, and a cell with its data files,
its tiny file and its entries runs with no edit to the harness.

A family is registered for a test as ``portbench.reference.<family>``,
``portbench.reference.<family>_qat`` and ``portbench.work.<family>``, the
modules its files would be."""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import sys
import time
import types

import pytest
import torch

from portbench import control, program, run, weights
from portbench.reference import lower, resnet_v1, resnet_v1_qat
from portbench.tests import tiny
from portbench.traffic import train_steps as ts
from portbench.work import resnet_v1 as work_resnet

torch.set_num_threads(1)
SEED = 2 ** 32 + 2 ** 31 + 5
NODE = 'stage1.unit1.quant_act1'      # an 8-bit node in ResNet's rule


def _module(name: str, **attrs) -> types.ModuleType:
    mod = types.ModuleType(name)
    mod.__dict__.update(attrs)
    return mod


def _register(monkeypatch, family, reference, work, qat=None):
    monkeypatch.setitem(sys.modules, f'portbench.reference.{family}',
                        reference)
    monkeypatch.setitem(sys.modules, f'portbench.work.{family}', work)
    if qat is not None:
        monkeypatch.setitem(sys.modules, f'portbench.reference.{family}_qat',
                            qat)


def _load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _mix(workload: str) -> dict:
    bench = _load(tiny.ROOT, 'BENCHMARK.json')
    entry = next(w for w in bench['workloads'] if w['name'] == workload)
    mix = _load(tiny.HERE, 'traffic', entry['traffic'] + '.json')
    mix.update(tiny.CELLS[workload][1])
    return mix


def test_bit_rule_and_int4_control_follow_the_family(monkeypatch):
    """A family whose rule holds one of ResNet's 8-bit nodes at 16 bits:
    the program's bit table gives that node 16, and the int4 control
    leaves its scale as it is, where ResNet's rule would scale it."""
    def bits(config, key):
        return 16 if key == NODE else resnet_v1.bits(config, key)
    _register(monkeypatch, 'sixteen', _module('sixteen', bits=bits),
              work_resnet)
    config = dict(tiny.RESNET, family='sixteen')
    tensors = weights.generate(config, SEED)
    ours = program.bit_table(config, tensors)
    resnet = program.bit_table(tiny.RESNET, tensors)
    assert (ours.pop(NODE), resnet.pop(NODE)) == (16, 8)
    assert ours == resnet
    _, t4 = lower.int4(config, tensors)
    _, r4 = lower.int4(tiny.RESNET, tensors)
    scale = NODE + '.act_scale'
    assert t4[scale] == tensors[scale] != r4[scale]
    assert all(t4[k] == r4[k] for k in t4
               if k.endswith('.act_scale') and k != scale)


def _keyed_family(monkeypatch, seen):
    """Family 'keyed': ResNet's modules, and a ``qat_key`` that keys each
    leaf under ``net.``, as a family whose state is named otherwise
    would."""
    def qat_key(name):
        seen.append(name)
        return 'net.' + work_resnet.qat_key(name)
    _register(monkeypatch, 'keyed', resnet_v1,
              _module('keyed', layers=work_resnet.layers,
                      plan=work_resnet.plan, qat_key=qat_key))
    config = dict(tiny.RESNET_32, family='keyed')
    params, stats = weights.generate_float(config, SEED)
    return (config, {'net.' + k: v for k, v in params.items()},
            {'net.' + k: v for k, v in stats.items()})


def test_trainer_keys_its_leaves_by_the_familys_qat_key(monkeypatch):
    seen = []
    config, params, stats = _keyed_family(monkeypatch, seen)
    qat = program.QatTrainer(config, params, stats, torch.device('cpu'),
                             1e-4, 0.9, 1e-4)
    got = qat.params()
    assert set(got) == set(params) and set(qat.stats()) == set(stats)
    assert set(qat.momentum()) == set(params)
    assert all(torch.equal(got[k], params[k]) for k in params)
    leaves = [n for n, _ in qat.model.named_parameters()] + [
        n for n, _ in qat.model.named_buffers()]
    assert set(seen) == set(leaves)


def test_a_leaf_without_a_key_names_the_leaf_and_the_family(monkeypatch):
    config, params, stats = _keyed_family(monkeypatch, [])
    leaf = next(k for k in params if k.startswith('net.stage2.unit1.'))
    del params[leaf]
    with pytest.raises(LookupError) as e:
        program.QatTrainer(config, params, stats, torch.device('cpu'),
                           1e-4, 0.9, 1e-4)
    assert type(e.value) is LookupError
    trainer_leaf = leaf[len('net.'):].replace('stage2.unit1.',
                                              'stage2_unit1.')
    assert "'keyed'" in str(e.value) and repr(trainer_leaf) in str(e.value)


def test_qat_reference_and_control_come_from_the_family(monkeypatch):
    """``train_steps.reference`` and ``control.train_readings`` (the
    program's side and every planted fault) call the family's
    ``<family>_qat.train``, never ResNet's."""
    calls = []

    def train(config, params0, stats0, calibration, steps, lr, mu, wd,
              tf32=False, step_updates=('params', 'stats')):
        calls.append(dict(family=config['family'], steps=steps, tf32=tf32,
                          step_updates=step_updates, hyper=(lr, mu, wd),
                          calibration=len(calibration)))
        return len(calls) - 1

    def resnet_train(*args, **kw):
        raise AssertionError("ResNet's QAT reference was called")

    _register(monkeypatch, 'other', resnet_v1, work_resnet,
              _module('other_qat', train=train))
    monkeypatch.setattr(resnet_v1_qat, 'train', resnet_train)
    monkeypatch.setattr(ts, 'checked', lambda cfg, mix, data: (None, 'prog'))
    monkeypatch.setattr(ts, 'compare', lambda got, ref, params0: (got, ref))
    config = dict(tiny.RESNET, family='other')
    mix = _mix('resnet50_w8a8.train_b128')
    out = control.train_readings(config, mix, SEED, torch.device('cpu'),
                                 faults=True)
    assert list(out) == ['program', 'tf32', 'half_batch', 'label_altered',
                         'stats_unchanged', 'state_unchanged']
    assert out['program'] == ('prog', 0)
    assert all(ref == 0 for _, ref in out.values())
    side = {name: calls[i] for name, (i, _) in out.items()
            if name != 'program'}
    assert len(calls) == 6 and {c['family'] for c in calls} == {'other'}
    assert all(c['hyper'] == (mix['lr'], mix['momentum'], mix['weight_decay'])
               and c['calibration'] == mix['calibration_batches']
               for c in calls)
    assert (calls[0]['tf32'], calls[0]['step_updates']) == (
        False, ('params', 'stats'))
    assert side['tf32']['tf32'] is True
    assert side['stats_unchanged']['step_updates'] == ('params',)
    assert side['state_unchanged']['step_updates'] == ()
    batch = mix['batch']
    assert [len(x) for x, _ in side['half_batch']['steps']] == [
        batch // 2] * mix['checked_steps']
    y0, y = calls[0]['steps'][0][1], side['label_altered']['steps'][0][1]
    assert int(y[0]) != int(y0[0]) and torch.equal(y[1:], y0[1:])


def _data_files(tmp_path):
    """A checkout's data files, copied: BENCHMARK.json, configs, mixes and
    tiny cells → (its root, its BENCHMARK.json)."""
    src = tmp_path / 'src'
    for d in ('configs', 'traffic', os.path.join('tests', 'cells')):
        shutil.copytree(os.path.join(tiny.HERE, d), src / 'portbench' / d)
    return src, _load(tiny.ROOT, 'BENCHMARK.json')


def _write(path, obj):
    with open(path, 'w') as f:
        json.dump(obj, f, indent=1)


def test_a_cell_without_its_tiny_file_is_named(tmp_path):
    src, bench = _data_files(tmp_path)
    bench['workloads'].append(dict(bench['workloads'][0],
                                   name='resnet50_w8a8.batch_b8'))
    _write(src / 'BENCHMARK.json', bench)
    path = tiny.cell_path('resnet50_w8a8.batch_b8', str(src))
    with pytest.raises(FileNotFoundError, match=re.escape(path)):
        tiny.tree(str(tmp_path / 'checkout'), str(src))


@pytest.fixture
def twin(monkeypatch, tmp_path):
    """A checkout where a second family, 'twin', joined as a later change
    adds one: ResNet's arithmetic under the family's own module names
    (each call counted) with its own ``qat_key``; its configuration file;
    a cell for each mix, with its tiny file; and their entries in
    BENCHMARK.json → (the tiny checkout, the counts)."""
    count = collections.Counter()

    def counted(name, fn):
        def call(*args, **kw):
            count[name] += 1
            return fn(*args, **kw)
        return call

    _register(
        monkeypatch, 'twin',
        _module('twin', bits=counted('bits', resnet_v1.bits),
                forward=counted('forward', resnet_v1.forward)),
        _module('twin', layers=counted('layers', work_resnet.layers),
                plan=counted('plan', work_resnet.plan),
                qat_key=counted('qat_key', work_resnet.qat_key)),
        _module('twin_qat', train=counted('train', resnet_v1_qat.train)))
    src, bench = _data_files(tmp_path)
    config = _load(tiny.HERE, 'configs', 'resnet50_w8a8.json')
    config.update(name='twin_w8a8', family='twin')
    _write(src / 'portbench' / 'configs' / 'twin_w8a8.json', config)
    bench['configs'].append(dict(bench['configs'][0], name='twin_w8a8',
                                 file='portbench/configs/twin_w8a8.json'))
    for w in list(bench['workloads']):
        name = f"twin_w8a8.{w['traffic']}"
        bench['workloads'].append(dict(w, name=name, config='twin_w8a8'))
        for m in bench['end_to_end'] + bench['per_layer']:
            if w['name'] in m.get('workloads', []):
                m['workloads'].append(name)
        cell = _load(tiny.cell_path(w['name']))
        cell['base'] = 'twin_w8a8'
        cell['config']['name'] = 'twin_' + cell['config']['name']
        _write(tiny.cell_path(name, str(src)), cell)
    _write(src / 'BENCHMARK.json', bench)
    return tiny.tree(str(tmp_path / 'checkout'), str(src)), count


MIXES = sorted({w['traffic']
                for w in _load(tiny.ROOT, 'BENCHMARK.json')['workloads']})


@pytest.mark.parametrize('mix', MIXES)
def test_a_new_familys_cell_runs_from_its_files_alone(twin, mix):
    root, count = twin
    workload = f'twin_w8a8.{mix}'
    result = run.execute(workload, SEED, 1.0, False, torch.device('cpu'),
                         time.perf_counter(), root)
    assert result['correct'] is True and result['attempted'] > 0
    e2e, _ = run.cell_metrics(_load(root, 'BENCHMARK.json'), workload)
    assert set(result['metrics']) == {m['name'] for m in e2e}
    assert len(result['metrics']) >= 2
    kind = _load(tiny.HERE, 'traffic', mix + '.json')['kind']
    want = ({'plan', 'qat_key', 'train', 'layers'} if kind == 'train_steps'
            else {'plan', 'bits', 'forward', 'layers'})
    assert want <= set(count)
