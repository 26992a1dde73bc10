"""BENCHMARK.json against the rules it is checked by: its keys, names,
units and bounds; every configuration, cell, mix and metric reader found
by name; every cell reporting the set-up time, another end-to-end metric
and a per-layer one; every per-layer metric reported where the metric it
moves is."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench import run
from portbench.tests import tiny

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


@pytest.fixture(scope='module')
def bench():
    with open(os.path.join(tiny.ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level(bench):
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert bench['command'] == ['python3', 'portbench/run.py']
    assert bench['paths'] == ['portbench']
    assert 1 <= bench['run_seconds'] <= 51
    size = os.path.getsize(os.path.join(tiny.ROOT, 'BENCHMARK.json'))
    assert size <= 64 * 1024


def test_configs(bench):
    used = {w['config'] for w in bench['workloads']}
    names = [c['name'] for c in bench['configs']]
    assert len(names) == len(set(names)) and set(names) == used
    for c in bench['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and _line(c['source']) and _line(c['why'])
        assert c['file'] == f"portbench/configs/{c['name']}.json"
        with open(os.path.join(tiny.ROOT, c['file'])) as f:
            data = json.load(f)
        assert data['reduced'] == c['reduced'] == []
        assert data['source'] == c['source']


def test_workloads(bench):
    names = [w['name'] for w in bench['workloads']]
    assert len(names) == len(set(names))
    pairs = [(w['config'], w['traffic']) for w in bench['workloads']]
    assert len(pairs) == len(set(pairs))
    for w in bench['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic'])
        assert w['chips'] == 1 and _line(w['why'])
        for path in (('cells', w['name']), ('traffic', w['traffic'])):
            assert os.path.exists(os.path.join(tiny.HERE, *path[:-1],
                                               path[-1] + '.json'))
        with open(os.path.join(tiny.HERE, 'cells', w['name'] + '.json')) as f:
            assert json.load(f)['config'] == w['config']


def test_each_workload_has_its_tiny_cell(bench):
    """The CPU tests run every cell at test sizes from its file
    ``tests/cells/<cell>.json``, and every such file is a cell's."""
    cells = os.path.dirname(tiny.cell_path(''))
    files = {n[:-len('.json')] for n in os.listdir(cells)
             if n.endswith('.json')}
    assert files == {w['name'] for w in bench['workloads']}
    for w in bench['workloads']:
        with open(tiny.cell_path(w['name'])) as f:
            cell = json.load(f)
        assert set(cell) == {'why', 'base', 'config', 'traffic'}
        assert cell['base'] == w['config'] and _line(cell['why'])
        assert NAME.match(cell['config']['name'])


def test_metrics(bench):
    e2e, per_layer = bench['end_to_end'], bench['per_layer']
    names = [m['name'] for m in e2e + per_layer]
    assert len(names) == len(set(names))
    cells = {w['name'] for w in bench['workloads']}
    for m in e2e + per_layer:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
        assert set(m.get('workloads', [])) <= cells
    for m in e2e:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert next(m for m in e2e if m['name'] == 'setup_s')['bound'] == 0.25
    for m in per_layer:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        assert _line(m['layer'])
        assert os.path.exists(run.reader_path(m['name']))
        moved = next(e for e in e2e if e['name'] == m['moves'])
        for cell in m['workloads']:
            assert cell in moved.get('workloads', cells)


def test_each_cell_reports_enough(bench):
    for w in bench['workloads']:
        e2e, per_layer = run.cell_metrics(bench, w['name'])
        names = {m['name'] for m in e2e}
        assert 'setup_s' in names and len(names) >= 2
        assert per_layer


def test_files_are_named_from_name_characters():
    for d, _, files in os.walk(tiny.HERE):
        if '__pycache__' in d:
            continue
        for name in files:
            rel = os.path.relpath(os.path.join(d, name), tiny.ROOT)
            assert re.match(r'^[A-Za-z0-9_./-]+$', rel), rel
