"""Whole runs of the tiny cells on the CPU (the harness's look for a card
skipped): the result line's shape, faults planted under the timed path
that must come out not correct, and a run without a card, which must fail
and print nothing.  One card test runs a real cell."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import program, run
from portbench.tests import tiny

torch.set_num_threads(1)
SEED = 2 ** 31 + 19
CELLS = sorted(tiny.CELLS)
with open(os.path.join(tiny.ROOT, 'BENCHMARK.json')) as _f:
    _WORKLOADS = json.load(_f)['workloads']
DECLARED = [w['name'] for w in _WORKLOADS]


def _kind(traffic: str) -> str:
    with open(os.path.join(tiny.HERE, 'traffic', traffic + '.json')) as f:
        return json.load(f)['kind']


KIND = {w['name']: _kind(w['traffic']) for w in _WORKLOADS}


def _execute(root, workload, trace=False, seconds=1.5):
    return run.execute(workload, SEED, seconds, trace, torch.device('cpu'),
                       time.perf_counter(), root)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return tiny.tree(str(tmp_path_factory.mktemp('checkout')))


@pytest.mark.parametrize('workload', CELLS)
@pytest.mark.parametrize('trace', [False, True], ids=['e2e', 'traced'])
def test_result_line(root, workload, trace, capsys):
    """The last line of standard output is the contract's object, its
    metrics the cell's end-to-end or per-layer ones, ``compared`` its last
    key, and every number compared is also a line of standard error."""
    result = _execute(root, workload, trace)
    run.report(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                              'device']
    assert list(line)[-1] == 'compared'
    assert line['correct'] is True and line['failed'] == 0
    assert line['attempted'] > 0
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        e2e, per_layer = run.cell_metrics(json.load(f), workload)
    names = {m['name'] for m in (per_layer if trace else e2e)}
    if trace:                       # the CPU has no device trace to read
        assert set(line['metrics']) <= names
    else:
        assert set(line['metrics']) == names
    assert {'platform', 'kind', 'count', 'memory_peak_bytes'} <= set(
        line['device'])
    tail = err.strip().splitlines()[-len(line['compared']):]
    for (name, c), text in zip(line['compared'].items(), tail):
        assert text == f"compared {name} {c['value']!r} limit {c['limit']!r}"


def _altered(engine):
    """One logit of the first row off by a hair, where it is produced."""
    def call(x):
        out = engine(x).clone()
        out[0, 0] += 1e-3
        return out
    return call


def _half_left_out(engine):
    """The batch's second half not computed: its rows answered with the
    first half's."""
    def call(x):
        h = (x.shape[0] + 1) // 2
        out = engine(x[:h])
        return torch.cat([out, out])[:x.shape[0]]
    return call


INFERENCE = [c for c in CELLS if KIND[c] == 'batch_closed']
TRAIN = [c for c in CELLS if KIND[c] == 'train_steps']


@pytest.mark.parametrize('workload', INFERENCE)
@pytest.mark.parametrize('fault', [_altered, _half_left_out],
                         ids=['answer_altered', 'half_batch_left_out'])
def test_fault_is_not_correct(root, workload, fault, monkeypatch):
    engine = program.engine
    monkeypatch.setattr(program, 'engine',
                        lambda *a, **kw: fault(engine(*a, **kw)))
    result = _execute(root, workload)
    assert result['correct'] is False
    assert result['compared']['logit_max_abs_diff']['value'] > 0


class _Unchanged(program.QatTrainer):
    """A step that computes its loss and leaves the state as it was."""
    def step(self, images, labels):
        with torch.no_grad():
            return torch.nn.functional.cross_entropy(
                self.model(images, folded=False, update_stats=True), labels)


class _HalfBatch(program.QatTrainer):
    """Half of each batch left out, the mean taken over the rest."""
    def step(self, images, labels):
        h = images.shape[0] // 2
        return super().step(images[:h], labels[:h])


class _StatsUnchanged(program.QatTrainer):
    """A step that leaves the running statistics and ranges as they
    were."""
    def step(self, images, labels):
        kept = [b.detach().clone() for b in self.model.buffers()]
        loss = super().step(images, labels)
        with torch.no_grad():
            for b, k in zip(self.model.buffers(), kept):
                b.copy_(k)
        return loss


class _LabelAltered(program.QatTrainer):
    """One row's label altered where the step takes it."""
    def step(self, images, labels):
        labels = labels.clone()
        labels[0] = (labels[0] + 1) % self.model.num_classes
        return super().step(images, labels)


@pytest.mark.parametrize('workload', TRAIN)
@pytest.mark.parametrize('fault', [_Unchanged, _HalfBatch, _LabelAltered,
                                   _StatsUnchanged],
                         ids=['state_unchanged', 'half_batch_left_out',
                              'answer_altered', 'statistics_unchanged'])
def test_train_fault_is_not_correct(root, workload, fault, monkeypatch):
    monkeypatch.setattr(program, 'QatTrainer', fault)
    result = _execute(root, workload)
    assert result['correct'] is False


def test_no_card_no_result():
    """Without a card the run exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    p = subprocess.run([sys.executable, 'portbench/run.py', '--workload',
                        DECLARED[0], '--seed', '1', '--seconds', '1'],
                       cwd=tiny.ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout == ''
    assert 'CUDA card' in p.stderr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')


@pytest.mark.cuda
@pytest.mark.parametrize('workload', DECLARED)
def test_cell_on_the_card(card, workload):
    """Each real cell, two seconds, on the card: correct."""
    p = subprocess.run([sys.executable, 'portbench/run.py', '--workload',
                        workload, '--seed', str(SEED), '--seconds', '2'],
                       cwd=tiny.ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])['correct'] is True
