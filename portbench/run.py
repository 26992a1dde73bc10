"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cell; the cell's
file (``cells/<cell>.json``) names its traffic mix (``traffic/<mix>.json``,
whose ``kind`` is the driver ``traffic/<kind>.py``) and the configuration
(``configs/<config>.json``).  With ``--trace 0`` the result carries the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, each
read by its reader (:func:`reader_path`) from what the run recorded and
from a profiled slice.  The last line of standard output is the result,
one JSON object; the numbers compared with the reference, each beside its
limit, are the last lines of standard error and the result's last key.  Without
a card (or with fewer cards than the cell asks for) the run fails and
prints no result.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, 'portbench')
CACHE = os.path.join(ROOT, '.portbench_cache')


def _load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def reader_path(name: str, root: str = HERE) -> str:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    where there is none, the reader its kind shares,
    ``metrics/<name less its last dotted part>.py`` (``device_idle.py``
    reads ``device_idle.batch`` and ``device_idle.train``)."""
    path = os.path.join(root, 'metrics', name + '.py')
    if os.path.exists(path) or '.' not in name:
        return path
    return os.path.join(root, 'metrics', name.rsplit('.', 1)[0] + '.py')


def _metric_reader(name: str):
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_' + name.replace('.', '_').replace('-', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench, workload: str):
    """(end-to-end, per-layer) metric entries the cell reports."""
    e2e = [m for m in bench['end_to_end']
           if workload in m.get('workloads', [workload])]
    names = {m['name'] for m in e2e}
    per_layer = [m for m in bench['per_layer']
                 if (workload in m['workloads'] if 'workloads' in m
                     else m['moves'] in names)]
    return e2e, per_layer


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            born: float, root: str = ROOT):
    """Run the cell on ``device`` → the result object.  The cell's data
    files are read under ``root`` (the tests give a tree of tiny ones)."""
    import torch
    from portbench import common, guard
    from portbench.work import common as work
    bench = _load_json(root, 'BENCHMARK.json')
    entry = next((w for w in bench['workloads'] if w['name'] == workload),
                 None)
    if entry is None:
        raise SystemExit(f'no workload {workload!r} in BENCHMARK.json')
    data = os.path.join(root, 'portbench')
    config = _load_json(data, 'configs', entry['config'] + '.json')
    cell = _load_json(data, 'cells', workload + '.json')
    mix = dict(_load_json(data, 'traffic', entry['traffic'] + '.json'))
    mix.update(cell.get('traffic', {}))
    driver = importlib.import_module(f"portbench.traffic.{mix['kind']}")
    run = common.Run(workload=workload, seed=seed, seconds=seconds,
                     trace=trace, config=config, mix=mix, device=device,
                     born=born)
    out = driver.run(run)
    found = guard.loaded()
    if found:
        raise RuntimeError(f'forbidden modules loaded: {found}')

    e2e, per_layer = cell_metrics(bench, workload)
    metrics = {}
    if not trace:
        values = dict(out['e2e'], setup_s=run.setup_s)
        for m in e2e:
            metrics[m['name']] = {'value': values[m['name']],
                                  'unit': m['unit']}
    else:
        rec = dict(out['record'], trace=out['trace'], peaks=work.peaks())
        for m in per_layer:
            v = _metric_reader(m['name'])(rec)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    compared = out['compared']
    correct = all(v <= limit for v, limit in compared.values())
    dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
           'kind': (torch.cuda.get_device_name(device)
                    if device.type == 'cuda' else 'cpu'),
           'count': entry['chips'],
           'memory_peak_bytes': out['memory_peak_bytes']}
    result = {'correct': bool(correct), 'attempted': out['attempted'],
              'failed': out['failed'], 'metrics': metrics, 'device': dev}
    if trace and out['trace']:
        dev['busy_s'] = out['trace']['busy_s']
        dev['window_s'] = out['trace']['wall_s']
        result['breakdown'] = out['trace']['breakdown']
    result['compared'] = {k: {'value': v, 'limit': limit}
                          for k, (v, limit) in compared.items()}
    return result


def main(argv=None) -> int:
    from portbench import common
    born = time.perf_counter() - common.process_age_s()
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import guard
    bad = guard.source_imports()
    if bad:
        common.log(f'forbidden imports in the benchmark: {bad}')
        return 2
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton')):
        os.environ[var] = os.path.join(CACHE, sub)
    import torch
    bench = _load_json(ROOT, 'BENCHMARK.json')
    chips = next((w['chips'] for w in bench['workloads']
                  if w['name'] == args.workload), None)
    if chips is None:
        common.log(f'no workload {args.workload!r} in BENCHMARK.json')
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        common.log(f'{args.workload} needs {chips} CUDA card(s); found '
                   f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}')
        return 3
    device = torch.device('cuda', 0)
    info = common.card_info(device)
    common.log('card: ' + json.dumps(info))
    try:
        result = execute(args.workload, args.seed, args.seconds,
                         bool(args.trace), device, born)
    except Exception:
        traceback.print_exc()
        return 1
    report(result)
    return 0


def report(result) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; the result as the last line of standard output."""
    from portbench import common
    common.log(f"memory_peak_bytes {result['device']['memory_peak_bytes']}")
    for name, c in result['compared'].items():
        common.log(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    sys.stdout.write(json.dumps(result) + '\n')
    sys.stdout.flush()


if __name__ == '__main__':
    # the script's own directory would shadow modules of the standard
    # library (trace) with the benchmark's: import it as a package instead
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path[0] = ROOT
    else:
        sys.path.insert(0, ROOT)
    sys.exit(main())
