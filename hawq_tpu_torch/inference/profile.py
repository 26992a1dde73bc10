"""Per-stage engine profile (port of hawq_tpu/inference/profile.py).

An engine truncated at a capture node runs the graph up to that node and no
further, so timing the engine truncated at successive nodes gives the
cumulative time to each and the time of each segment between them
(``utils.timing.time_per_iter``: CUDA events on the card).
``engine_flops_and_bytes`` gives a ResNet v1's integer operations and weight
bytes, the work a bound is computed from.

    python -m hawq_tpu_torch.inference.profile --arch resnet50 \\
        --scheme uniform8 --batch 8 --input-mode folded_float32 \\
        [--trace DIR] [--device cpu]
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hawq_tpu_torch.configs.bit_config import RESNET_UNITS
from hawq_tpu_torch.inference.freeze import FrozenModel
from hawq_tpu_torch.utils.timing import time_per_iter


def default_capture_points(fm: FrozenModel) -> List[str]:
    """Per-stage truncation points of any supported engine family."""
    if fm.arch == 'mobilenetv2':
        from hawq_tpu_torch.models.mobilenetv2 import MOBILENETV2_STAGES
        points = ['init']
        for i, stage in enumerate(MOBILENETV2_STAGES, start=1):
            points.append(
                f'features.stage{i}.unit{len(stage)}.quant_act_int32')
        return points + ['final', 'fc_input']
    if fm.arch == 'inceptionv3':
        from hawq_tpu_torch.models.inceptionv3 import INCEPTION_CHANNELS
        points = ['init']
        for i, stage in enumerate(INCEPTION_CHANNELS, start=1):
            points.append(
                f'features.stage{i}.unit{len(stage)}.q_rescaling_activ')
        return points + ['fc_input']
    base = fm.arch[:-2] if fm.arch.endswith('v2') else fm.arch
    points = ['init']
    for s, n_units in enumerate(RESNET_UNITS[base], start=1):
        points.append(f'stage{s}.unit{n_units}.quant_act_int32')
    points.append('fc_output' if not fm.arch.endswith('v2') else 'fc_input')
    return points


def profile_engine(fm: FrozenModel, x, points: Optional[Sequence[str]] = None,
                   verbose: bool = True, n_iters: Optional[int] = None,
                   **engine_kwargs) -> List[Tuple[str, float, float]]:
    """[(node, cumulative s, segment s)] for successive truncation points
    (default :func:`default_capture_points`), one engine each, built with
    ``engine_kwargs`` (``device`` among them, the card by default); ``x``
    the engine's input, moved to its device once.  ``n_iters`` as in
    ``time_per_iter``."""
    from hawq_tpu_torch.deploy import build_engine_for
    out = []
    prev = 0.0
    for pt in list(points or default_capture_points(fm)):
        eng = build_engine_for(fm, capture=pt, **engine_kwargs)
        xd = torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(eng.device)
        t = time_per_iter(eng, xd, n_iters=n_iters)
        out.append((pt, t, t - prev))
        if verbose:
            print(f'{pt:40s} cum {t * 1e3:8.3f} ms   seg '
                  f'{(t - prev) * 1e3:8.3f} ms', flush=True)
        prev = t
    return out


def engine_flops_and_bytes(fm: FrozenModel, batch: int,
                           image_size: int = 224) -> Dict[str, float]:
    """Integer operations (2 per multiply-add) of a ResNet v1's unit convs
    at ``batch`` and their weights' bytes at the config's bits."""
    from hawq_tpu_torch.inference.conv_shapes import conv_shapes
    total_macs = 0
    weight_bytes = 0
    for (key, h, stride, kh, kw, cin, cout) in conv_shapes(
            fm.arch, input_size=image_size):
        out_sp = h // stride
        total_macs += batch * out_sp * out_sp * kh * kw * cin * cout
        bits = fm.cfg.weight_bits(key)
        weight_bytes += kh * kw * cin * cout * bits // 8
    return {'int_ops': 2.0 * total_macs,
            'weight_bytes': float(weight_bytes)}


def main(argv=None) -> int:
    """Per-stage profile of a synthetic-weight engine (seed 0) on the card
    (``--device cpu`` for the CPU); ``--trace DIR`` also writes a
    ``torch.profiler`` chrome trace of the whole engine."""
    import argparse
    import json
    import os

    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', default='resnet50')
    ap.add_argument('--scheme', default='uniform8')
    ap.add_argument('--batch', type=int, default=64)
    ap.add_argument('--image-size', type=int, default=None)
    ap.add_argument('--points', default=None,
                    help='comma list of capture points (default per-stage)')
    ap.add_argument('--input-mode', default='float32',
                    help='ResNet v1: float32, folded_float32, uint8 or '
                         'folded_int8 (int16 carrier); the other families '
                         'take float32')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--n-iters', type=int, default=None,
                    help='calls a timing window (default: grown until the '
                         'window is well over its fixed cost)')
    ap.add_argument('--trace', default=None, metavar='DIR',
                    help='also write a torch.profiler chrome trace of the '
                         'full engine to DIR/trace.json')
    ap.add_argument('--trace-iters', type=int, default=8)
    args = ap.parse_args(argv)

    from hawq_tpu_torch.configs.bit_config import get_bit_config
    from hawq_tpu_torch.deploy import (build_engine_for, default_image_size,
                                       synthetic_frozen)
    fm = synthetic_frozen(args.arch, get_bit_config(args.arch, args.scheme))
    size = args.image_size or default_image_size(fm)
    x = np.random.RandomState(0).rand(args.batch, size, size, 3).astype(
        np.float32)
    kwargs = dict(device=args.device)
    if args.arch not in ('mobilenetv2', 'inceptionv3') \
            and not fm.arch.endswith('v2'):
        from hawq_tpu_torch.utils import preproc
        if args.input_mode.startswith('folded'):
            x = preproc.fold4_images(x)
        if args.input_mode == 'folded_int8':
            x = preproc.quantize_int8(x, fm.act_scale('quant_input'))
        elif args.input_mode == 'uint8':
            x = np.clip(x * 255.0, 0, 255).astype(np.uint8)
        kwargs.update(residual_dtype=torch.int16, input_mode=args.input_mode)
    points = args.points.split(',') if args.points else None
    profile_engine(fm, x, points=points, n_iters=args.n_iters, **kwargs)
    if fm.arch in RESNET_UNITS:
        print(json.dumps(engine_flops_and_bytes(fm, args.batch, size)))

    if args.trace:
        eng = build_engine_for(fm, **kwargs)
        xd = torch.from_numpy(x).to(eng.device)
        eng(xd)                                 # warm
        acts = [torch.profiler.ProfilerActivity.CPU]
        if eng.device.type == 'cuda':
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.trace_iters):
                eng(xd)
            if eng.device.type == 'cuda':
                torch.cuda.synchronize(eng.device)
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, 'trace.json')
        prof.export_chrome_trace(path)
        print(f'trace written to {path}', flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
