#!/usr/bin/env python3
"""Drive the PyTorch port (hawq_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from hawq_tpu_torch/kernels/csrc at first use (nvcc,
sm_90a) and runs, in order; any mismatch or error ends the run with a
non-zero exit and no result line:

 1. torch / CUDA versions, the card's name and power limit;
 2. the kernel build, with its time;
 3. the main path once — synthetic ResNet-50, 224×224, batch 8, uniform8,
    host-folded input, int16 residual carrier — with the launch counts set
    to 0 just before and read just after.  Every kernel call of that run is
    recorded; each is then repeated on the same inputs and held against its
    plain PyTorch version, bit for bit (tolerance 0), as are a few ragged
    shapes; then each call is timed (kernel, plain version, library call)
    and set beside its bound;
 4. the engine at full width: uniform8 and uniform4, on folded input with
    the int16 carrier and on raw float32 input with the int32 carrier —
    logits for the first two images equal the CPU (plain) engine's, finite,
    launch counts as the graph predicts, milliseconds per batch;
 5. serving: a DynamicBatcher over the CUDA engine answers 12 single-image
    requests, each equal to its row of a batched engine call;
 6. one JSON line with the kernels' numbers, then the result line.

Imports nothing of JAX or of the JAX package.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor-core rate
BATCH, SIZE = 8, 224

# entry point → (kernel source, TPU kernel it replaces)
KERNELS = {
    'int8_conv_requant': ('hawq_tpu_torch/kernels/csrc/conv.cu',
                          'hawq_tpu/kernels/conv.py:228'),
    'int8_conv_acc': ('hawq_tpu_torch/kernels/csrc/conv.cu',
                      'hawq_tpu/kernels/conv.py:243'),
    'int8_matmul_requant': ('hawq_tpu_torch/kernels/csrc/matmul.cu',
                            'hawq_tpu/kernels/matmul.py:68'),
    'int8_matmul_acc': ('hawq_tpu_torch/kernels/csrc/matmul.cu',
                        'hawq_tpu/kernels/matmul.py:189'),
    'maxpool_folded': ('hawq_tpu_torch/kernels/csrc/pool.cu',
                       'hawq_tpu/kernels/pool.py:69'),
}


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Device time of ``fn`` without the host's launch cost: ``reps`` calls
    captured into one CUDA graph, replayed and timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ms = cuda_ms(graph.replay, 5) / reps
    del graph
    return ms


# ---------------------------------------------------------------------------
# phase 3 helpers: recording, plain versions, bounds
# ---------------------------------------------------------------------------

def kernel_modules():
    from hawq_tpu_torch.kernels import conv, matmul, pool
    return {'int8_conv_requant': conv, 'int8_conv_acc': conv,
            'int8_matmul_requant': matmul, 'int8_matmul_acc': matmul,
            'maxpool_folded': pool}


@contextlib.contextmanager
def recording(calls):
    """Record every kernel-wrapper call (its inputs) while the engine runs."""
    mods = kernel_modules()
    orig = {name: getattr(mod, name) for name, mod in mods.items()}

    def recorder(name):
        def call(*args, **kw):
            calls.append((name, args, kw))
            return orig[name](*args, **kw)
        return call
    for name, mod in mods.items():
        setattr(mod, name, recorder(name))
    try:
        yield
    finally:
        for name, mod in mods.items():
            setattr(mod, name, orig[name])


def plain_call(name, args, kw):
    from hawq_tpu_torch.inference.fold import maxpool_3x3s2p1_folded
    from hawq_tpu_torch.kernels import conv as kc
    from hawq_tpu_torch.kernels import matmul as km
    if name == 'maxpool_folded':
        return maxpool_3x3s2p1_folded(*args)
    if name == 'int8_matmul_acc':
        return km.matmul_acc_plain(*args)
    if name == 'int8_conv_acc':
        return kc.conv_acc_plain(*args, **kw)
    lo, hi = km.epilogue_bounds(kw.get('out_bits', 8), kw.get('signed', True),
                                kw.get('relu', False))
    if name == 'int8_matmul_requant':
        return km.matmul_requant_plain(*args, lo, hi)
    geo = {k: kw[k] for k in ('taps', 'out_hw', 'cin')}
    return kc.conv_requant_plain(*args, lo=lo, hi=hi, **geo)


def kernel_call(name, args, kw):
    return getattr(kernel_modules()[name], name)(*args, **kw)


def work(name, args, kw, out):
    """(bytes moved, int8 ops, a short shape label) of one call: each input
    read once, each output written once."""
    nbytes = sum(t.numel() * t.element_size() for t in args
                 if isinstance(t, torch.Tensor))
    nbytes += out.numel() * out.element_size()
    if name == 'maxpool_folded':
        return nbytes, 0, 'x' + 'x'.join(map(str, args[0].shape))
    if name.startswith('int8_matmul'):
        (m, k), n = args[0].shape, args[1].shape[1]
        return nbytes, 2 * m * k * n, f'M{m} K{k} N{n}'
    k, n = args[1].shape
    b = args[0].shape[0]
    h, w = kw['out_hw']
    return (nbytes, 2 * b * h * w * k * n,
            f'B{b} {h}x{w} taps{kw["taps"][0]}x{kw["taps"][1]} '
            f'C{kw["cin"]} N{n}')


def library_call(name, args):
    """One PyTorch call over the same inputs as the yardstick, where one
    exists: torch._int_mm (int8 → int32 product, without bias or requant)
    under its shape rules.  None elsewhere (PyTorch has no int8 conv and
    no folded-layout pool)."""
    if not name.startswith('int8_matmul'):
        return None
    x, w = args[0], args[1]
    (m, k), n = x.shape, w.shape[1]
    if m > 16 and k % 8 == 0 and n % 8 == 0 and k >= 16:
        return lambda: torch._int_mm(x, w)
    return None


def ragged_calls(dev):
    """Unaligned shapes beside the main path's: odd M/K/N, small C (byte
    loads), s2d stride 2, int32/float32 pools."""
    from hawq_tpu_torch.kernels import conv as kc
    from hawq_tpu_torch.quant.ops import np_dyadic_multiplier
    rng = np.random.RandomState(7)

    def i8(*shape):
        return torch.tensor(rng.randint(-128, 128, shape).astype(np.int8),
                            device=dev)

    def vec(n):
        b = torch.tensor(rng.randint(-2 ** 16, 2 ** 16, n).astype(np.int32),
                         device=dev)
        m = torch.tensor(np_dyadic_multiplier(
            (rng.rand(n) * 2e-4 + 1e-5).astype(np.float32)), device=dev)
        return b, m
    calls = []
    for m, k, n in ((37, 45, 19), (1000, 2048, 1000), (3, 5, 2)):
        b, mu = vec(n)
        calls.append(('int8_matmul_requant', (i8(m, k), i8(k, n), b, mu),
                      dict(out_bits=4, signed=False, relu=True)))
        calls.append(('int8_matmul_acc', (i8(m, k), i8(k, n), b), {}))
    for shape, n, stride in (((2, 9, 7, 5), 11, 1), ((1, 12, 10, 32), 40, 2),
                             ((2, 33, 31, 64), 72, 1)):
        x8 = i8(*shape)
        w = rng.randint(-127, 128, (3, 3, shape[3], n)).astype(np.int8)
        bsz, h, wd, _ = shape
        if stride == 2:
            x2, w = kc.s2d_conv_transform(x8, w, 1)
            oh, ow = kc.s2d_output_hw(h, wd, 3, 3, 1)
            xp = kc.prepare_conv_input(x2, (0, 0))
        else:
            oh, ow = h, wd
            xp = kc.prepare_conv_input(x8, (1, 1))
        wf = torch.tensor(kc.flatten_conv_kernel(w), device=dev)
        b, mu = vec(n)
        geo = dict(taps=w.shape[:2], out_hw=(oh, ow), cin=w.shape[2])
        calls.append(('int8_conv_requant', (xp, wf, b, mu),
                      dict(geo, out_bits=8, signed=True, relu=True)))
        calls.append(('int8_conv_acc', (xp, wf, b), geo))
    for dt in (torch.int32, torch.float32, torch.int16):
        xf = torch.tensor(rng.randint(-2 ** 14, 2 ** 14, (2, 7, 9, 20)),
                          device=dev).to(dt)
        calls.append(('maxpool_folded', (xf,), {}))
    return calls


def check_and_time(main_calls, dev):
    """Hold every call against its plain version; time the main path's."""
    errs = {name: 0.0 for name in KERNELS}
    for name, args, kw in main_calls + ragged_calls(dev):
        got = kernel_call(name, args, kw)
        want = plain_call(name, args, kw)
        check(got.dtype == want.dtype and got.shape == want.shape,
              f'{name}: {got.dtype}{tuple(got.shape)} vs plain '
              f'{want.dtype}{tuple(want.shape)}')
        err = (got.to(torch.float64) - want.to(torch.float64)).abs().max()
        errs[name] = max(errs[name], float(err))
        check(torch.equal(got, want), f'{name} differs from its plain version '
              f'at {[tuple(a.shape) for a in args]}: max |err| {float(err)}')
    log('phase 3: every recorded and ragged call equals its plain version')

    # time each distinct call shape once; a shape repeated on the path counts
    # as many times as it was launched
    totals = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                         library_ok=True, bytes=0, ops=0) for name in KERNELS}
    seen = {}
    for name, args, kw in main_calls:
        key = (name, tuple(tuple(a.shape) for a in args
                           if isinstance(a, torch.Tensor)),
               tuple(sorted((k, str(v)) for k, v in kw.items())))
        if key not in seen:
            out = kernel_call(name, args, kw)
            nbytes, ops, label = work(name, args, kw, out)
            ms = graph_ms(lambda: kernel_call(name, args, kw), 20)
            host_ms = cuda_ms(lambda: kernel_call(name, args, kw), 20)
            plain_ms = graph_ms(lambda: plain_call(name, args, kw), 3)
            lib = library_call(name, args)
            lib_ms = graph_ms(lib, 20) if lib is not None else None
            bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
            seen[key] = dict(name=name, shape=label, n=0, ms=ms,
                             host_ms=host_ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound,
                             bytes=nbytes, ops=ops)
        seen[key]['n'] += 1
    for row in seen.values():
        t = totals[row['name']]
        for k in ('ms', 'plain_ms', 'bound_ms', 'bytes', 'ops'):
            t[k] += row[k] * row['n']
        if row['library_ms'] is None:
            t['library_ok'] = False
        else:
            t['library_ms'] += row['library_ms'] * row['n']
        lib = ('-' if row['library_ms'] is None
               else f"{row['library_ms']:.5f}")
        log(f"  {row['name']:20s} {row['shape']:34s} x{row['n']:<2d} "
            f"ms {row['ms']:.5f} host-bound {row['host_ms']:.5f} "
            f"plain {row['plain_ms']:.4f} "
            f"bound {row['bound_ms']:.5f} library {lib}")
    return errs, totals


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

EXPECTED_LAUNCHES = {   # per ResNet-50 forward: init + 16 conv2; 16 conv1;
    'int8_conv_acc': 1,         # 16 conv3 + 4 identity + FC; folded pool
    'int8_conv_requant': 16,
    'int8_matmul_requant': 16,
    'int8_matmul_acc': 21,
    'maxpool_folded': 1,
}


def engine_phase(fm_cache, images, scheme, mode, residual, dev):
    from hawq_tpu_torch.inference.engine import build_resnet_engine
    from hawq_tpu_torch.kernels import _build
    x = images[mode]
    fm = fm_cache[scheme]
    eng = build_resnet_engine(fm, input_mode=mode, residual_dtype=residual,
                              device=dev)
    eng(x)                                   # uploads weights, warms up
    torch.cuda.synchronize()
    _build.reset_launches()
    logits = eng(x)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    want = dict(EXPECTED_LAUNCHES)
    if mode != 'folded_float32':
        want.pop('maxpool_folded')
    check(counts == want, f'{scheme} {mode}: launches {counts}, expected '
          f'{want}')
    out = logits.cpu()
    check(out.shape == (BATCH, 1000) and bool(torch.isfinite(out).all()),
          f'{scheme} {mode}: logits {tuple(out.shape)} not finite/shaped')
    ref = build_resnet_engine(fm, input_mode=mode, residual_dtype=residual,
                              device='cpu')(x[:2].cpu())
    check(torch.equal(out[:2], ref), f'{scheme} {mode}: CUDA logits differ '
          f'from the CPU engine: max |err| '
          f'{float((out[:2] - ref).abs().max())}')
    # synthetic weights can saturate the head (uniform4 logits may not
    # depend on the image), so the pooled features are compared as well
    kw = dict(capture='avg_pool', input_mode=mode, residual_dtype=residual)
    got = build_resnet_engine(fm, device=dev, **kw)(x).cpu()
    ref = build_resnet_engine(fm, device='cpu', **kw)(x[:2].cpu())
    check(torch.equal(got[:2], ref), f'{scheme} {mode}: avg_pool differs')
    ms = cuda_ms(lambda: eng(x), 20)
    t0 = time.perf_counter()
    for _ in range(10):
        eng(x)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 10 * 1e3
    log(f'phase 4: resnet50 {scheme} {mode} {residual}: logits == CPU engine '
        f'(2 images), launches {counts}, {ms:.3f} ms/batch CUDA-event-timed, '
        f'{wall:.3f} ms/batch host-timed (batch {BATCH}, {SIZE}x{SIZE})')
    return eng


def port_kernel(name):
    """'port: conv' / 'port: matmul' / 'port: pool' for the port's kernels
    in a trace (demangled or mangled names), None for any other kernel."""
    if 'gemm_s8_kernel<true' in name or 'gemm_s8_kernelILb1' in name:
        return 'port: conv'
    if 'gemm_s8_kernel' in name:
        return 'port: matmul'
    if 'maxpool_folded_kernel' in name:
        return 'port: pool'
    return None


def trace_breakdown(eng, x):
    """Device-side breakdown of one forward from a torch.profiler trace:
    kernel time of the port's kernels and of the rest, and the share of the
    device timeline with no kernel running."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    eng(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng(x)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get('traceEvents', [])
    kernels = [e for e in events
               if e.get('cat') == 'kernel' and e.get('ph') == 'X']
    if not kernels:
        log('phase 4: the profiler trace holds no device kernels; device '
            'busy share not measured')
        return
    spans = sorted((float(e['ts']), float(e['ts']) + float(e['dur']))
                   for e in kernels)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    timeline = spans[-1][1] - spans[0][0]
    by_name = {}
    for e in kernels:
        key = port_kernel(e['name']) or e['name'][:60]
        c, t = by_name.get(key, (0, 0.0))
        by_name[key] = (c + 1, t + float(e['dur']))
    port_us = sum(t for k, (c, t) in by_name.items() if k.startswith('port'))
    total_us = sum(t for c, t in by_name.values())
    log(f'phase 4: trace of one forward: {len(kernels)} kernels, device busy '
        f'{busy / 1e3:.3f} ms of a {timeline / 1e3:.3f} ms device timeline '
        f'(idle share {1 - busy / timeline:.3f}); port kernels '
        f'{port_us / 1e3:.3f} ms, other kernels '
        f'{(total_us - port_us) / 1e3:.3f} ms')
    for k, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f'  {t / 1e3:8.4f} ms  x{c:<4d} {k}')


def serving_phase(eng, raw_images, dev):
    from hawq_tpu_torch.inference.fold import fold4_images
    from hawq_tpu_torch.parallel.serving import DynamicBatcher
    n_req = 12
    rng = np.random.RandomState(3)
    reqs = rng.randn(n_req, SIZE, SIZE, 3).astype(np.float32)
    batcher = DynamicBatcher(eng, BATCH, (SIZE, SIZE, 3), max_delay_ms=20,
                             host_transform=fold4_images, device=dev)
    try:
        slots = [batcher.submit(im) for im in reqs]
        answers = np.stack([s.get(timeout=120) for s in slots])
    finally:
        batcher.close()
    check(not batcher._collector.is_alive()
          and not batcher._completer.is_alive(), 'batcher threads still alive')
    n_pad = -(-n_req // BATCH) * BATCH
    padded = np.concatenate(
        [reqs, np.zeros((n_pad - n_req, SIZE, SIZE, 3), np.float32)])
    want = np.concatenate([
        eng(torch.from_numpy(fold4_images(padded[i:i + BATCH])).to(dev))
        .cpu().numpy() for i in range(0, n_pad, BATCH)])[:n_req]
    check(np.array_equal(answers, want), 'batcher answers differ from the '
          'batched engine call')
    log(f'phase 5: DynamicBatcher answered {n_req} requests, each equal to '
        f'its row of a batched call')


def main():
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: torch.cuda.is_available() is false; this '
                 'script needs an NVIDIA GPU')
    if not os.path.isdir(os.path.join(REPO, 'hawq_tpu_torch', 'kernels',
                                      'csrc')):
        sys.exit('chip_smoke: run from a checkout of the repository (no '
                 'hawq_tpu_torch/ beside this script)')
    sys.path.insert(0, REPO)
    from hawq_tpu_torch.configs.bit_config import get_bit_config
    from hawq_tpu_torch.inference.engine import build_resnet_engine
    from hawq_tpu_torch.inference.fold import fold4_images
    from hawq_tpu_torch.inference.synthetic import synthetic_frozen_resnet
    from hawq_tpu_torch.kernels import _build
    from hawq_tpu_torch.quant.ops import exact_div
    dev = torch.device('cuda')
    t_start = time.perf_counter()

    # ---- phase 1 ----
    log(f'phase 1: python {sys.version.split()[0]} torch {torch.__version__} '
        f'cuda {torch.version.cuda}')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])

    # ---- phase 2 ----
    _build.lib()
    info = _build.build_info
    log(f"phase 2: kernels built in {info['seconds']:.1f} s "
        f"(cached {info['cached']}) -> {os.path.relpath(info['path'], REPO)}")
    for line in str(info['log']).splitlines():
        if 'registers' in line or 'spill' in line or line.startswith('---'):
            log('  ' + line.strip())

    # ---- phase 3: the main path, recorded ----
    fms = {s: synthetic_frozen_resnet('resnet50',
                                      get_bit_config('resnet50', s), seed=0)
           for s in ('uniform8', 'uniform4')}
    raw = np.random.RandomState(1).randn(BATCH, SIZE, SIZE, 3).astype(
        np.float32)
    images = {'float32': torch.from_numpy(raw).to(dev),
              'folded_float32': torch.from_numpy(fold4_images(raw)).to(dev)}
    main_eng = build_resnet_engine(fms['uniform8'],
                                   input_mode='folded_float32',
                                   residual_dtype=torch.int16, device=dev)
    main_eng(images['folded_float32'])           # uploads weights
    torch.cuda.synchronize()
    calls = []
    with recording(calls):
        _build.reset_launches()
        main_logits = main_eng(images['folded_float32'])
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    check({k: v for k, v in launches.items() if v} == EXPECTED_LAUNCHES,
          f'main path launches {launches}, expected {EXPECTED_LAUNCHES}')
    check(bool(torch.isfinite(main_logits).all()), 'main path logits')
    log(f'phase 3: main path (resnet50 uniform8 folded_float32 int16, batch '
        f'{BATCH}) launches {launches}')
    x = torch.randn(1 << 22, generator=torch.Generator().manual_seed(0)) * 4
    for s in (np.float32(0.0517), 49):
        check(torch.equal(exact_div(x.to(dev), s).cpu(), exact_div(x, s)),
              'exact_div on the card differs from the CPU')
    errs, totals = check_and_time(calls, dev)

    # ---- phase 4 ----
    engines = {}
    for scheme in ('uniform8', 'uniform4'):
        for mode, residual in (('folded_float32', torch.int16),
                               ('float32', torch.int32)):
            engines[scheme, mode] = engine_phase(fms, images, scheme, mode,
                                                 residual, dev)

    trace_breakdown(engines['uniform8', 'folded_float32'],
                    images['folded_float32'])

    # ---- phase 5 ----
    serving_phase(engines['uniform8', 'folded_float32'], raw, dev)

    # ---- phase 6 ----
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = totals[name]
        kernels.append(dict(
            name=name, route='cuda', source=source, replaces=replaces,
            launches=launches.get(name, 0), max_abs_err=errs[name],
            ms=t['ms'], plain_ms=t['plain_ms'], bound_ms=t['bound_ms'],
            bound_by=('bytes' if t['bytes'] / HBM_BYTES_PER_S
                      >= t['ops'] / INT8_OPS_PER_S else 'operations'),
            library_ms=t['library_ms'] if t['library_ok'] else None))
    log(f'phase 6: all phases passed in {time.perf_counter() - t_start:.1f} s '
        f'(kernel ms, plain_ms, bound_ms and library_ms are totals over the '
        f'main path forward)')
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
