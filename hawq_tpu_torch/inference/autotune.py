"""Per-layer kernel routing autotuner (port of
hawq_tpu/inference/autotune.py).

Each routable conv is timed on this card with each of its bit-exact routes,
``'int8'`` and, where its weights are 4-bit, ``'int4w'`` (the nibble-packed
kernels, ``inference.routing``), and the faster is the table's choice (on a
tie ``'int8'``).  A ResNet v1's unit convs are timed through the engine's own
conv routes (``build_resnet_engine(routing=...)``), the 1×1 sites of
MobileNetV2 and InceptionV3 through the ``Routed1x1`` the engine calls.

Timing: ``utils.timing.time_per_iter`` at a fixed count of calls, the
candidates in alternating turns for a few rounds, the median.  On the card
each candidate's call is first captured :data:`GRAPH_CALLS` times into a
CUDA graph and the window replays the graph, so a reading is the device's
time for the site (its glue included), not the host's launch cost, which is
the same for both routes.  A candidate that fails fails the sweep.

The table is JSON: ``{conv key: route}`` and, as comment keys that
``routing.check_routing`` drops, ``'_us'`` (µs per call of every candidate
at every site), ``'_device'`` and ``'_batch'``.

    python -m hawq_tpu_torch.inference.autotune --arch resnet50 \\
        --scheme uniform4 --batch 8 [--out table.json] [--device cpu]

writes ``chiprun_out/routing_<arch>_<scheme>_b<batch>.json`` unless
``--out`` names another file; ``deploy --routing`` serves it.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from hawq_tpu_torch.inference.freeze import FrozenModel
from hawq_tpu_torch.inference.routing import Routed1x1, check_routing
from hawq_tpu_torch.utils.timing import time_per_iter

GRAPH_CALLS = 10          # calls of a candidate captured in one CUDA graph
N_ITERS = 10              # graph replays (or calls, on the CPU) a window
ROUNDS = 3                # alternating turns of every candidate at a site
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'chiprun_out')


def routable_convs(fm: FrozenModel, image_size: int = 224):
    """(key, h_in, stride, kh, cin, cout, weight_bits) of every unit conv of
    a ResNet v1 (1×1 and 3×3), each of which a table may route."""
    from hawq_tpu_torch.inference.conv_shapes import conv_shapes
    return [(key, h, stride, kh, cin, cout, fm.cfg.weight_bits(key))
            for (key, h, stride, kh, kw, cin, cout) in conv_shapes(
                fm.arch, input_size=image_size)
            if kh in (1, 3) and key + '.weight_int' in fm.tensors]


def _graphed(fn: Callable, x: torch.Tensor) -> Callable:
    """``fn(x)`` :data:`GRAPH_CALLS` times in one CUDA graph, warmed on a
    side stream first; returns the graph's replay."""
    side = torch.cuda.Stream(x.device)
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(side):
        fn(x)
        fn(x)
    torch.cuda.current_stream(x.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn(x)
    return lambda _x: graph.replay()


def time_candidates(fns: Mapping[str, Callable], x: torch.Tensor,
                    n_iters: int = N_ITERS,
                    rounds: int = ROUNDS) -> Dict[str, float]:
    """Seconds per call of each ``fns[route](x)``: ``rounds`` rounds of
    ``time_per_iter(..., n_iters=n_iters)``, the candidates' order reversed
    every round, the median; on the card through CUDA-graph replay (module
    docstring)."""
    cuda = x.is_cuda
    runners = {r: _graphed(fn, x) if cuda else fn for r, fn in fns.items()}
    per = GRAPH_CALLS if cuda else 1
    times = {r: [] for r in fns}
    order = list(fns)
    for i in range(rounds):
        for r in (order if i % 2 == 0 else order[::-1]):
            times[r].append(time_per_iter(runners[r], x, n_iters=n_iters)
                            / per)
    return {r: float(np.median(t)) for r, t in times.items()}


def _device_name(device: torch.device) -> str:
    if device.type == 'cuda':
        return torch.cuda.get_device_name(device)
    return 'cpu'


def _resume(checkpoint_path: Optional[str], device, batch) -> Dict:
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        with open(checkpoint_path) as f:
            table = json.load(f)
        check_routing(table)
        return table
    return {'_device': _device_name(device), '_batch': batch, '_us': {}}


def _record(table, key, times, checkpoint_path, verbose) -> None:
    table[key] = min(times, key=times.get)      # 'int8' first: ties to it
    table['_us'][key] = {r: t * 1e6 for r, t in times.items()}
    if checkpoint_path is not None:
        save_routing(checkpoint_path, table)
    if verbose:
        desc = '  '.join(f'{r} {t * 1e6:8.2f}us' for r, t in times.items())
        print(f'{key:50s} -> {table[key]:5s} [{desc}]', flush=True)


def autotune_routing(fm: FrozenModel, batch: int = 8, image_size: int = 224,
                     verbose: bool = True,
                     checkpoint_path: Optional[str] = None,
                     device='cuda', n_iters: int = N_ITERS,
                     rounds: int = ROUNDS) -> Dict:
    """Time every routable unit conv of a ResNet v1 with each of its routes
    on ``device`` (the card by default), through the engine's own conv
    routes on random int8 inputs of the conv's shape at ``batch``; return
    the table (module docstring).  With ``checkpoint_path`` the table is
    written after every site, and a table there already resumes the sweep."""
    from hawq_tpu_torch.configs.bit_config import RESNET_CONVS_PER_UNIT
    from hawq_tpu_torch.inference.engine import (build_resnet_engine,
                                                 engine_device)
    device = engine_device(device)
    convs = routable_convs(fm, image_size)
    engines = {r: build_resnet_engine(fm, routing={c[0]: r for c in convs},
                                      device=device)
               for r in ('int8', 'int4w')}
    bottleneck = RESNET_CONVS_PER_UNIT[fm.arch] == 3
    rng = np.random.RandomState(0)
    table = _resume(checkpoint_path, device, batch)
    for key, h, stride, kh, cin, cout, bits in convs:
        if key in table:
            continue
        x = torch.from_numpy(rng.randint(-128, 128, (batch, h, h, cin))
                             .astype(np.int8)).to(device)
        mult = None
        if key.endswith('quant_convbn1') or (
                bottleneck and key.endswith('quant_convbn2')):
            mult = torch.full((cout,), 1e-4, dtype=torch.float32,
                              device=device)

        def site(eng, key=key, stride=stride, mult=mult, kh=kh):
            conv = eng._conv1x1 if kh == 1 else eng._conv_kxk
            return lambda xi: conv(xi, key, stride, mult)
        fns = {r: site(engines[r]) for r in (('int8', 'int4w') if bits == 4
                                             else ('int8',))}
        _record(table, key, time_candidates(fns, x, n_iters, rounds),
                checkpoint_path, verbose)
    return table


def autotune_routing_1x1(sites, weight_bits: Callable[[str], int],
                         batch: int = 8, verbose: bool = True,
                         checkpoint_path: Optional[str] = None,
                         device='cuda', n_iters: int = N_ITERS,
                         rounds: int = ROUNDS) -> Dict:
    """The routing sweep over 1×1 site tables (MobileNetV2 / InceptionV3):
    ``sites`` (key, spatial, cin, cout, epilogue) from
    ``inference.routing``'s enumerators, ``weight_bits`` key → bits.  Each
    candidate is the ``Routed1x1`` the engine calls, on random weights of
    the site's bits and random int8 inputs: epilogue 'acc' the accumulator
    form (#2 / #4), 'requant' the fused requant with ReLU (#1 / #3)."""
    from hawq_tpu_torch.inference.engine import engine_device
    device = engine_device(device)
    rng = np.random.RandomState(0)
    table = _resume(checkpoint_path, device, batch)
    for key, spatial, cin, cout, epi in sites:
        if key in table:
            continue
        bits = weight_bits(key)
        qmax = 2 ** (bits - 1) - 1
        w = rng.randint(-qmax - 1, qmax + 1, (1, 1, cin, cout)).astype(
            np.int8)
        bias = rng.randint(-2 ** 15, 2 ** 15, (cout,)).astype(np.int32)
        mult = torch.full((cout,), 1e-4, dtype=torch.float32, device=device)
        x = torch.from_numpy(rng.randint(-128, 128, (
            batch, spatial, spatial, cin)).astype(np.int8)).to(device)
        kind = 'matmul' if epi == 'acc' else 'matmul_requant'

        def site(int4):
            r = Routed1x1.prepare(w, bias, int4, kind, device)
            if epi == 'acc':
                return r.acc
            return lambda xi: r.requant(xi, mult, out_bits=8, signed=True,
                                        relu=True)
        fns = {'int8': site(False)}
        if bits == 4:
            fns['int4w'] = site(True)
        _record(table, key, time_candidates(fns, x, n_iters, rounds),
                checkpoint_path, verbose)
    return table


def save_routing(path: str, table: Mapping) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'w') as f:
        json.dump(dict(table), f, indent=1, sort_keys=True)


def load_routing(path: str) -> Dict[str, str]:
    """The table at ``path`` without its comment keys; a table of TPU
    routes (the JAX package's ``benchmarks/routing_*.json``) is refused."""
    with open(path) as f:
        return check_routing(json.load(f))


def main(argv=None) -> int:
    """Write a routing table of a synthetic-weight model (seed 0), measured
    on the card (``--device cpu`` for the CPU)."""
    import argparse
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', default='resnet50')
    ap.add_argument('--scheme', default='uniform4')
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--image-size', type=int, default=None)
    ap.add_argument('--out', default=None,
                    help='table path (default chiprun_out/routing_<arch>_'
                         '<scheme>_b<batch>.json)')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    from hawq_tpu_torch.configs.bit_config import get_bit_config
    from hawq_tpu_torch.inference import routing as rt
    cfg = get_bit_config(args.arch, args.scheme)
    out = args.out or os.path.join(
        OUT_DIR, f'routing_{args.arch}_{args.scheme}_b{args.batch}.json')
    if args.arch == 'mobilenetv2':
        sites = rt.mobilenet_conv1x1_sites(image_size=args.image_size or 224)
        table = autotune_routing_1x1(sites, cfg.weight_bits, args.batch,
                                     checkpoint_path=out, device=args.device)
    elif args.arch == 'inceptionv3':
        sites = rt.inception_conv1x1_sites(args.image_size or 299)
        table = autotune_routing_1x1(sites, cfg.weight_bits, args.batch,
                                     checkpoint_path=out, device=args.device)
    elif args.arch.endswith('v2'):
        sys.stderr.write(f'{args.arch}: the ResNet v2 engine takes no '
                         f'routing table\n')
        return 2
    else:
        from hawq_tpu_torch.inference.synthetic import synthetic_frozen_resnet
        fm = synthetic_frozen_resnet(args.arch, cfg)
        table = autotune_routing(fm, args.batch, args.image_size or 224,
                                 checkpoint_path=out, device=args.device)
    save_routing(out, table)
    print('wrote', out)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
