"""The lower-precision control of a cell, and its planted faults, on the
card, for each seed, each held to the cell's own limits.

An inference cell: the reference's logits of the cell's distinct inputs
at int4 (``reference/lower.py``) in the program's place, against the
reference's at int8, as the run compares them (the largest gap of any
logit).  The train cell: the program's checked steps (``--program``, the
lower readings), and in its place the reference at TF32 (the control) and
with faults planted (half of each batch left out, one label altered, the
statistics or the whole state left unchanged by the step), each against
the float32 reference, as the run compares them
(``traffic/train_steps.py``).

    python3 portbench/control.py --workload resnet50_w8a8.batch_b256 \\
        --seeds 1,2,3 [--program 4,5,6]

The control takes the program's place: its answers are its logits, and
which batch an image lands in cannot change a reference's logits.  Prints
one JSON line per seed and side: every number, and ``correct`` as the
cell's limits judge it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def inference_readings(config, mix, seed: int, device):
    """{'int4': {'logit_max_abs_diff': the control's}} of one seed."""
    import numpy as np
    from portbench import common, inputs, weights
    from portbench.reference import lower
    size = config['image_size']
    tensors = weights.generate(config, seed, device)
    mode = mix['input_mode']
    n = mix['pool_batches'] * mix['batch']
    make = inputs.uint8_images if mode == 'uint8' else inputs.float_images
    pool = make(seed, n, size, device)
    ref = common.reference_logits(config, tensors, pool, range(n), device,
                                  input_mode=mode)
    cfg4, t4 = lower.int4(config, tensors)
    ctl = common.reference_logits(cfg4, t4, pool, range(n), device,
                                  input_mode=mode)
    gap = max(float(np.max(np.abs(ctl[i] - ref[i]))) for i in range(n))
    return {'int4': {'logit_max_abs_diff': gap}}


def train_readings(config, mix, seed: int, device, faults: bool):
    """The train cell's numbers of one seed → {side: numbers}: the
    program, and with ``faults`` the reference at TF32 and with each
    planted fault, each against the float32 reference."""
    from portbench import common
    from portbench.traffic import train_steps as ts
    data = ts.Data(config, mix, seed, device)
    qat, got = ts.checked(config, mix, data)
    del qat
    common.release()
    ref = ts.reference(config, mix, data)
    out = {'program': ts.compare(got, ref, data.params0)}
    del got
    if not faults:
        return out
    half = [(x[:data.batch // 2], y[:data.batch // 2])
            for x, y in data.steps()]
    relabelled = []
    for x, y in data.steps():
        y = y.clone()
        y[0] = (y[0] + 1) % config['num_classes']
        relabelled.append((x, y))
    sides = (('tf32', dict(tf32=True), None),
             ('half_batch', {}, half),
             ('label_altered', {}, relabelled),
             ('stats_unchanged', dict(step_updates=('params',)), None),
             ('state_unchanged', dict(step_updates=()), None))
    for name, kw, steps in sides:
        got = ts.reference(config, mix, data, steps, **kw)
        out[name] = ts.compare(got, ref, data.params0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', default='',
                   help='seeds of the control (and the faults)')
    p.add_argument('--program', default='',
                   help='seeds of the program alone (train cell)')
    args = p.parse_args(argv)
    import torch
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    entry = next(w for w in bench['workloads'] if w['name'] == args.workload)
    data = os.path.join(ROOT, 'portbench')
    with open(os.path.join(data, 'configs', entry['config'] + '.json')) as f:
        config = json.load(f)
    with open(os.path.join(data, 'traffic', entry['traffic'] + '.json')) as f:
        mix = json.load(f)
    with open(os.path.join(data, 'cells', args.workload + '.json')) as f:
        mix.update(json.load(f).get('traffic', {}))
    limits = mix.get('limits', {'logit_max_abs_diff': 0.0})
    if not torch.cuda.is_available():
        sys.stderr.write('control.py runs on the card only\n')
        return 3
    dev = torch.device('cuda', 0)
    seeds = [(int(s), True) for s in args.seeds.split(',') if s]
    seeds += [(int(s), False) for s in args.program.split(',') if s]
    for seed, faults in seeds:
        t = time.perf_counter()
        if mix['kind'] == 'train_steps':
            rows = train_readings(config, mix, seed, dev, faults)
        else:
            rows = inference_readings(config, mix, seed, dev)
        for side, nums in rows.items():
            correct = all(nums[k] <= v for k, v in limits.items())
            print(json.dumps(dict(workload=args.workload, seed=seed,
                                  side=side, correct=correct, numbers=nums,
                                  seconds=time.perf_counter() - t)),
                  flush=True)
    return 0


if __name__ == '__main__':
    if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT,
                                                                 'portbench'):
        sys.path[0] = ROOT
    sys.exit(main())
