"""Tiny configurations and a tree of tiny cells for the CPU tests: the
benchmark's real configuration at test sizes."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

with open(os.path.join(HERE, 'configs', 'resnet50_w8a8.json')) as _f:
    RESNET50 = json.load(_f)
# ResNet-50's depth and stride on the first 1×1 at test widths, 32² and 10
# classes: the program's engine takes its widths from the arrays
RESNET = dict(RESNET50, name='resnet50_narrow_w8a8', image_size=32,
              num_classes=10, init_features=16, mids=[8, 16, 16, 32],
              outs=[32, 64, 64, 128])
# the program's trainer builds ResNet-50 at its published widths (it keys
# them by the arch's name): the train cell at 32² and 10 classes
RESNET_32 = dict(RESNET50, name='resnet50_32px_w8a8', image_size=32,
                 num_classes=10)

# the cells of BENCHMARK.json at tiny sizes: config, traffic overrides
CELLS = {
    'resnet50_w8a8.batch_b64': (RESNET, dict(batch=4, pool_batches=3,
                                             warmup_calls=2, trace_calls=2)),
    'resnet50_w8a8.train_b128': (RESNET_32, dict(batch=4,
                                                 calibration_batches=2,
                                                 trace_steps=1)),
}


def tree(path: str) -> str:
    """A checkout's data files with the cells of BENCHMARK.json at tiny
    sizes under ``path``; returns it."""
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    data = os.path.join(path, 'portbench')
    for d in ('configs', 'cells', 'traffic'):
        os.makedirs(os.path.join(data, d), exist_ok=True)
    for w in bench['workloads']:
        config, traffic = CELLS[w['name']]
        w['config'] = config['name']
        with open(os.path.join(data, 'configs', config['name'] + '.json'),
                  'w') as f:
            json.dump(config, f)
        with open(os.path.join(data, 'cells', w['name'] + '.json'),
                  'w') as f:
            json.dump({'config': config['name'], 'traffic': traffic}, f)
        shutil.copy(os.path.join(HERE, 'traffic', w['traffic'] + '.json'),
                    os.path.join(data, 'traffic'))
    with open(os.path.join(path, 'BENCHMARK.json'), 'w') as f:
        json.dump(bench, f)
    return path
