"""Tiny cells for the CPU tests: each cell of BENCHMARK.json at test sizes,
and a tree of them laid out as a checkout.

A cell's tiny form is its file ``tests/cells/<cell>.json``: ``base``, the
configuration it shrinks (``configs/<base>.json``); ``config``, its
overrides of that configuration, a new ``name`` among them; ``traffic``,
its overrides of the cell's mix; and ``why``."""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Mapping, Tuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_path(workload: str, src: str = ROOT) -> str:
    return os.path.join(src, 'portbench', 'tests', 'cells', workload + '.json')


def load(workload: str, src: str = ROOT) -> Tuple[Dict, Mapping]:
    """(the tiny configuration, the traffic overrides) of ``workload``,
    from the data files under the checkout ``src``."""
    path = cell_path(workload, src)
    if not os.path.exists(path):
        raise FileNotFoundError(f'the workload {workload!r} has no tiny cell: '
                                f'add {path}')
    cell = _load_json(path)
    config = _load_json(src, 'portbench', 'configs', cell['base'] + '.json')
    config.update(cell['config'])
    return config, cell['traffic']


CELLS = {name[:-len('.json')]: load(name[:-len('.json')])
         for name in sorted(os.listdir(os.path.dirname(cell_path(''))))
         if name.endswith('.json')}
RESNET = CELLS['resnet50_w8a8.batch_b256'][0]
RESNET_32 = CELLS['resnet50_w8a8.train_b128'][0]


def tree(path: str, src: str = ROOT) -> str:
    """The data files of the checkout ``src`` with the cells of its
    BENCHMARK.json at tiny sizes, under ``path``; returns it."""
    bench = _load_json(src, 'BENCHMARK.json')
    data = os.path.join(path, 'portbench')
    for d in ('configs', 'cells', 'traffic'):
        os.makedirs(os.path.join(data, d), exist_ok=True)
    for w in bench['workloads']:
        config, traffic = load(w['name'], src)
        w['config'] = config['name']
        with open(os.path.join(data, 'configs', config['name'] + '.json'),
                  'w') as f:
            json.dump(config, f)
        with open(os.path.join(data, 'cells', w['name'] + '.json'),
                  'w') as f:
            json.dump({'config': config['name'], 'traffic': traffic}, f)
        shutil.copy(os.path.join(src, 'portbench', 'traffic',
                                 w['traffic'] + '.json'),
                    os.path.join(data, 'traffic'))
    with open(os.path.join(path, 'BENCHMARK.json'), 'w') as f:
        json.dump(bench, f)
    return path
