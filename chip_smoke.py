#!/usr/bin/env python3
"""Drive the PyTorch port (hawq_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from hawq_tpu_torch/kernels/csrc at first use (nvcc,
sm_90a) and runs, in order; any mismatch or error ends the run with a
non-zero exit and no result line:

 1. torch / CUDA versions, the card's name and power limit;
 2. the kernel build, with its time;
 3. the serving paths once each — synthetic ResNet-50 uniform8 (the main
    path), ResNet-50 uniform4 and bops_0.5 (nibble-packed int4 weights for
    the 4-bit layers) and ResNet-18 uniform4, all 224×224, batch 8,
    host-folded input, int16 residual carrier — each with the launch counts
    set to 0 just before it and read just after, and held against the
    counts its bit config predicts.  Every kernel call of those runs is
    recorded; each is then repeated on the same inputs and held against its
    plain PyTorch version, bit for bit (tolerance 0), as are a few ragged
    shapes; then each call of the path a kernel is reported on is timed
    (kernel, plain version, library call) and set beside its bound;
 4. the engine at full width: ResNet-50 uniform8 and uniform4, on folded
    input with the int16 carrier and on raw float32 input with the int32
    carrier, ResNet-50 bops_0.5 and ResNet-18 uniform4 on folded input, and
    ResNet-50 uniform4 on uint8 and on host-quantized folded_int8 input —
    logits and pooled features for the first two images equal the CPU
    (plain) engine's, finite, launch counts as the bit config predicts,
    milliseconds per batch; a profiler trace of the uniform8 and uniform4
    forwards;
 5. serving: DynamicBatchers over the uniform8 engine (folded input) and
    the bops_0.5 engine (folded_int8 input, quantized on the host) answer
    12 single-image requests each, each equal to its row of a batched
    engine call;
 6. one JSON line with the kernels' numbers, then the result line.

Imports nothing of JAX or of the JAX package.
"""

import contextlib
import json
import os
import re
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
    'int4w_matmul_requant': ('hawq_tpu_torch/kernels/csrc/matmul.cu',
                             'hawq_tpu/kernels/matmul.py:134'),
    'int4w_matmul_acc': ('hawq_tpu_torch/kernels/csrc/matmul.cu',
                         'hawq_tpu/kernels/matmul.py:234'),
    'int4w_conv_requant': ('hawq_tpu_torch/kernels/csrc/conv.cu',
                           'hawq_tpu/kernels/conv.py:254'),
    'int4w_conv_acc': ('hawq_tpu_torch/kernels/csrc/conv.cu',
                       'hawq_tpu/kernels/conv.py:265'),
}

# The serving paths of phase 3, (arch, scheme), all folded input, int16
# carrier, batch 8, 224²; the first is the main path.  Each kernel is
# reported on the first path that launches it.
PATHS = (('resnet50', 'uniform8'), ('resnet50', 'uniform4'),
         ('resnet50', 'bops_0.5'), ('resnet18', 'uniform4'))

# (bottleneck, unit conv) → the kernel family and epilogue that runs it
_UNIT_CONV = {(True, 'quant_convbn1'): 'matmul_requant',
              (True, 'quant_convbn2'): 'conv_requant',
              (True, 'quant_convbn3'): 'matmul_acc',
              (True, 'quant_identity_convbn'): 'matmul_acc',
              (False, 'quant_convbn1'): 'conv_requant',
              (False, 'quant_convbn2'): 'conv_acc',
              (False, 'quant_identity_convbn'): 'matmul_acc'}


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

def expected_launches(arch, cfg, input_mode):
    """Kernel launches of one engine forward, from the arch and the bit
    config: the init conv (int8), the folded pool, each unit conv by its
    place in the unit and its weight bits (``int4w_*`` for 4-bit weights),
    and the FC (int8)."""
    from hawq_tpu_torch.configs.bit_config import (RESNET_CONVS_PER_UNIT,
                                                   resnet_layer_keys)
    bottleneck = RESNET_CONVS_PER_UNIT[arch] == 3
    counts = {'int8_conv_acc': 1, 'int8_matmul_acc': 1}
    if input_mode.startswith('folded'):
        counts['maxpool_folded'] = 1
    for key in resnet_layer_keys(arch):
        conv = key.rsplit('.', 1)[-1]
        if not key.startswith('stage') or 'convbn' not in conv:
            continue
        name = (('int4w_' if cfg.weight_bits(key) == 4 else 'int8_')
                + _UNIT_CONV[bottleneck, conv])
        counts[name] = counts.get(name, 0) + 1
    return counts


def kernel_modules():
    from hawq_tpu_torch.kernels import conv, matmul, pool
    return {name: (pool if name == 'maxpool_folded' else
                   conv if '_conv' in name else matmul) for name in KERNELS}


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


def unpacked_weights(name, args, kw):
    """The int8 weights of a call: its own, or its packed int4 unpacked."""
    from hawq_tpu_torch.kernels import conv as kc
    from hawq_tpu_torch.kernels import matmul as km
    if name.startswith('int4w_matmul'):
        return km.unpack_int4(args[1])
    if name.startswith('int4w_conv'):
        return kc.unpack_int4_conv(args[1], kw['taps'][0] * kw['taps'][1])
    return args[1]


def plain_call(name, args, kw):
    from hawq_tpu_torch.inference.fold import maxpool_3x3s2p1_folded
    from hawq_tpu_torch.kernels import conv as kc
    from hawq_tpu_torch.kernels import matmul as km
    if name == 'maxpool_folded':
        return maxpool_3x3s2p1_folded(*args)
    args = (args[0], unpacked_weights(name, args, kw)) + tuple(args[2:])
    geo = {k: kw[k] for k in ('taps', 'out_hw', 'cin') if k in kw}
    if name.endswith('matmul_acc'):
        return km.matmul_acc_plain(*args)
    if name.endswith('conv_acc'):
        return kc.conv_acc_plain(*args, **geo)
    lo, hi = km.epilogue_bounds(kw.get('out_bits', 8), kw.get('signed', True),
                                kw.get('relu', False))
    if name.endswith('matmul_requant'):
        return km.matmul_requant_plain(*args, lo, hi)
    return kc.conv_requant_plain(*args, lo=lo, hi=hi, **geo)


def kernel_call(name, args, kw):
    return getattr(kernel_modules()[name], name)(*args, **kw)


def work(name, args, kw, out):
    """(bytes moved, int8 ops, a short shape label) of one call: each input
    read once as passed (int4 weights packed), each output written once;
    the operations over the unpacked K (taps·C for the conv, x's K for the
    matmul)."""
    nbytes = sum(t.numel() * t.element_size() for t in args
                 if isinstance(t, torch.Tensor))
    nbytes += out.numel() * out.element_size()
    if name == 'maxpool_folded':
        return nbytes, 0, 'x' + 'x'.join(map(str, args[0].shape))
    n = args[1].shape[1]
    if '_matmul' in name:
        m, k = args[0].shape
        return nbytes, 2 * m * k * n, f'M{m} K{k} N{n}'
    b = args[0].shape[0]
    h, w = kw['out_hw']
    kh, kw_ = kw['taps']
    return (nbytes, 2 * b * h * w * kh * kw_ * kw['cin'] * n,
            f'B{b} {h}x{w} taps{kh}x{kw_} C{kw["cin"]} N{n}')


def library_call(name, args, kw):
    """One PyTorch call over the same inputs as the yardstick, where one
    exists: torch._int_mm (int8 → int32 product, without bias or requant;
    int4 weights unpacked to int8 before the timing) under its shape
    rules.  None elsewhere (PyTorch has no int8 conv and no folded-layout
    pool)."""
    if '_matmul' not in name:
        return None
    x, w = args[0], unpacked_weights(name, args, kw)
    (m, k), n = x.shape, w.shape[1]
    if m > 16 and k % 8 == 0 and n % 8 == 0 and k >= 16:
        return lambda: torch._int_mm(x, w)
    return None


def ragged_calls(dev):
    """Unaligned shapes beside the paths': odd M/K/N, small C (byte loads),
    s2d stride 2, int32/float32 pools; for the int4w kernels odd M/N, C/2
    odd (C = 6, 10), s2d stride 2, nibbles -8 and 7."""
    from hawq_tpu_torch.kernels import conv as kc
    from hawq_tpu_torch.kernels import matmul as km
    from hawq_tpu_torch.quant.ops import np_dyadic_multiplier
    rng = np.random.RandomState(7)

    def i8(*shape):
        return torch.tensor(rng.randint(-128, 128, shape).astype(np.int8),
                            device=dev)

    def w4(*shape):
        w = rng.randint(-8, 8, shape).astype(np.int8)
        w.reshape(-1)[:2] = (-8, 7)
        return w

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
    for m, k, n in ((37, 46, 19), (1000, 2048, 1000), (3, 6, 2),
                    (130, 200, 72)):
        wp = torch.tensor(km.pack_int4(w4(k, n)), device=dev)
        b, mu = vec(n)
        calls.append(('int4w_matmul_requant', (i8(m, k), wp, b, mu),
                      dict(out_bits=4, signed=False, relu=True)))
        calls.append(('int4w_matmul_requant', (i8(m, k), wp, b, mu),
                      dict(out_bits=8, signed=True, relu=False)))
        calls.append(('int4w_matmul_acc', (i8(m, k), wp, b), {}))
    for shape, n, stride in (((2, 9, 7, 6), 11, 1), ((1, 12, 10, 10), 9, 2),
                             ((2, 33, 31, 64), 72, 1), ((1, 9, 7, 6), 5, 2),
                             ((1, 14, 14, 32), 40, 2)):
        x8 = i8(*shape)
        w = w4(3, 3, shape[3], n)
        bsz, h, wd, _ = shape
        if stride == 2:
            x2, w = kc.s2d_conv_transform(x8, w, 1)
            oh, ow = kc.s2d_output_hw(h, wd, 3, 3, 1)
            xp = kc.prepare_conv_input(x2, (0, 0))
        else:
            oh, ow = h, wd
            xp = kc.prepare_conv_input(x8, (1, 1))
        taps = w.shape[:2]
        wp = torch.tensor(kc.pack_int4_conv(kc.flatten_conv_kernel(w),
                                            taps[0] * taps[1]), device=dev)
        b, mu = vec(n)
        geo = dict(taps=taps, out_hw=(oh, ow), cin=w.shape[2])
        calls.append(('int4w_conv_requant', (xp, wp, b, mu),
                      dict(geo, out_bits=4, signed=False, relu=True)))
        calls.append(('int4w_conv_requant', (xp, wp, b, mu),
                      dict(geo, out_bits=8, signed=True, relu=False)))
        calls.append(('int4w_conv_acc', (xp, wp, b), geo))
    return calls


def check_calls(calls, dev):
    """Hold every recorded and ragged call against its plain version."""
    errs = {name: 0.0 for name in KERNELS}
    ragged = ragged_calls(dev)
    for name, args, kw in calls + ragged:
        got = kernel_call(name, args, kw)
        want = plain_call(name, args, kw)
        check(got.dtype == want.dtype and got.shape == want.shape,
              f'{name}: {got.dtype}{tuple(got.shape)} vs plain '
              f'{want.dtype}{tuple(want.shape)}')
        err = (got.to(torch.float64) - want.to(torch.float64)).abs().max()
        errs[name] = max(errs[name], float(err))
        check(torch.equal(got, want), f'{name} differs from its plain version '
              f'at {[tuple(a.shape) for a in args]} {kw}: max |err| '
              f'{float(err)}')
    log(f'phase 3: all {len(calls)} recorded and {len(ragged)} ragged calls '
        f'equal their plain versions')
    return errs


def time_calls(calls, totals):
    """Time each distinct call shape once and add it to ``totals`` as many
    times as the path launched it."""
    seen = {}
    for name, args, kw in calls:
        key = (name, tuple(tuple(a.shape) for a in args
                           if isinstance(a, torch.Tensor)),
               tuple(sorted((k, str(v)) for k, v in kw.items())))
        if key not in seen:
            out = kernel_call(name, args, kw)
            nbytes, ops, label = work(name, args, kw, out)
            ms = graph_ms(lambda: kernel_call(name, args, kw), 20)
            host_ms = cuda_ms(lambda: kernel_call(name, args, kw), 20)
            plain_ms = graph_ms(lambda: plain_call(name, args, kw), 3)
            lib = library_call(name, args, kw)
            lib_ms = graph_ms(lib, 20) if lib is not None else None
            bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
            seen[key] = dict(name=name, shape=label, n=0, ms=ms,
                             host_ms=host_ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound,
                             bytes=nbytes, ops=ops)
        seen[key]['n'] += 1
    for row in seen.values():
        t = totals.setdefault(row['name'], dict(
            ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
            library_ok=True, bytes=0, ops=0))
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


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def record_path(fm, x, dev):
    """One recorded forward of the folded int16 engine: its kernel calls
    and its launch counts, set to 0 just before and read just after."""
    from hawq_tpu_torch.inference.engine import build_resnet_engine
    from hawq_tpu_torch.kernels import _build
    eng = build_resnet_engine(fm, input_mode='folded_float32',
                              residual_dtype=torch.int16, device=dev)
    eng(x)                                       # uploads weights
    torch.cuda.synchronize()
    calls = []
    with recording(calls):
        _build.reset_launches()
        logits = eng(x)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    label = f'{fm.arch} {fm.cfg.name}'
    want = expected_launches(fm.arch, fm.cfg, 'folded_float32')
    check(launches == want, f'{label}: launches {launches}, expected {want}')
    check(bool(torch.isfinite(logits).all()), f'{label}: logits not finite')
    log(f'phase 3: {label} folded_float32 int16 batch {BATCH}: launches '
        f'{launches}')
    return calls, launches


def engine_input(fm, mode, raw, raw_u8, dev):
    from hawq_tpu_torch.inference.fold import fold4_images
    from hawq_tpu_torch.utils.preproc import quantize_int8
    x = {'float32': raw, 'uint8': raw_u8}.get(mode)
    if x is None:
        x = fold4_images(raw)
    if mode == 'folded_int8':
        x = quantize_int8(x, fm.act_scale('quant_input'))
    return torch.from_numpy(x).to(dev)


def engine_phase(fm, x, mode, residual, dev):
    from hawq_tpu_torch.inference.engine import build_resnet_engine
    from hawq_tpu_torch.kernels import _build
    label = f'{fm.arch} {fm.cfg.name} {mode} {residual}'
    eng = build_resnet_engine(fm, input_mode=mode, residual_dtype=residual,
                              device=dev)
    eng(x)                                   # uploads weights, warms up
    torch.cuda.synchronize()
    _build.reset_launches()
    logits = eng(x)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    want = expected_launches(fm.arch, fm.cfg, mode)
    check(counts == want, f'{label}: launches {counts}, expected {want}')
    out = logits.cpu()
    check(out.shape == (BATCH, 1000) and bool(torch.isfinite(out).all()),
          f'{label}: logits {tuple(out.shape)} not finite/shaped')
    ref = build_resnet_engine(fm, input_mode=mode, residual_dtype=residual,
                              device='cpu')(x[:2].cpu())
    check(torch.equal(out[:2], ref), f'{label}: CUDA logits differ from the '
          f'CPU engine: max |err| {float((out[:2] - ref).abs().max())}')
    # synthetic weights can saturate the head (uniform4 logits may not
    # depend on the image), so the pooled features are compared as well
    kw = dict(capture='avg_pool', input_mode=mode, residual_dtype=residual)
    got = build_resnet_engine(fm, device=dev, **kw)(x).cpu()
    ref = build_resnet_engine(fm, device='cpu', **kw)(x[:2].cpu())
    check(torch.equal(got[:2], ref), f'{label}: avg_pool differs')
    ms = cuda_ms(lambda: eng(x), 20)
    t0 = time.perf_counter()
    for _ in range(10):
        eng(x)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 10 * 1e3
    log(f'phase 4: {label}: logits and avg_pool == CPU engine (2 images), '
        f'launches {counts}, {ms:.3f} ms/batch CUDA-event-timed, '
        f'{wall:.3f} ms/batch host-timed (batch {BATCH}, {SIZE}x{SIZE})')
    return eng


_TEMPLATE = (re.compile(r'gemm_s8_kernel<(\w+), \w+, (\w+)>'),
             re.compile(r'gemm_s8_kernelILb(\d)ELb\dELb(\d)E'))


def port_kernel(name):
    """'port: conv' / 'port: matmul' (' int4' with packed weights) /
    'port: pool' for the port's kernels in a trace (demangled or mangled
    names), None for any other kernel."""
    for pattern in _TEMPLATE:
        m = pattern.search(name)
        if m:
            conv, int4 = (g in ('true', '1') for g in m.groups())
            return ('port: ' + ('conv' if conv else 'matmul')
                    + (' int4' if int4 else ''))
    if 'maxpool_folded_kernel' in name:
        return 'port: pool'
    return None


def trace_breakdown(eng, x, label):
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
        log(f'phase 4: {label}: the profiler trace holds no device kernels; '
            f'device busy share not measured')
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
    log(f'phase 4: trace of one {label} forward: {len(kernels)} kernels, '
        f'device busy {busy / 1e3:.3f} ms of a {timeline / 1e3:.3f} ms device '
        f'timeline (idle share {1 - busy / timeline:.3f}); port kernels '
        f'{port_us / 1e3:.3f} ms, other kernels '
        f'{(total_us - port_us) / 1e3:.3f} ms')
    for k, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:9]:
        log(f'  {t / 1e3:8.4f} ms  x{c:<4d} {k}')


def serving_phase(eng, host_transform, label, dev):
    from hawq_tpu_torch.parallel.serving import DynamicBatcher
    n_req = 12
    rng = np.random.RandomState(3)
    reqs = rng.randn(n_req, SIZE, SIZE, 3).astype(np.float32)
    batcher = DynamicBatcher(eng, BATCH, (SIZE, SIZE, 3), max_delay_ms=20,
                             host_transform=host_transform, device=dev)
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
        eng(torch.from_numpy(host_transform(padded[i:i + BATCH])).to(dev))
        .cpu().numpy() for i in range(0, n_pad, BATCH)])[:n_req]
    check(np.array_equal(answers, want), f'{label}: batcher answers differ '
          f'from the batched engine call')
    log(f'phase 5: DynamicBatcher over {label} answered {n_req} requests, '
        f'each equal to its row of a batched call')


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
    from hawq_tpu_torch.utils.preproc import quantize_int8
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

    # ---- phase 3: the serving paths, recorded ----
    fms = {(arch, scheme): synthetic_frozen_resnet(
        arch, get_bit_config(arch, scheme), seed=0)
        for arch, scheme in PATHS}
    raw = np.random.RandomState(1).randn(BATCH, SIZE, SIZE, 3).astype(
        np.float32)
    raw_u8 = np.random.RandomState(2).randint(
        0, 256, (BATCH, SIZE, SIZE, 3)).astype(np.uint8)
    folded = torch.from_numpy(fold4_images(raw)).to(dev)
    recorded = {path: record_path(fms[path], folded, dev) for path in PATHS}
    report = {}                      # kernel → the first path that ran it
    for path in PATHS:
        for name in recorded[path][1]:
            report.setdefault(name, path)
    check(set(report) == set(KERNELS), f'kernels launched on no path: '
          f'{set(KERNELS) - set(report)}')
    x = torch.randn(1 << 22, generator=torch.Generator().manual_seed(0)) * 4
    for s in (np.float32(0.0517), 49):
        check(torch.equal(exact_div(x.to(dev), s).cpu(), exact_div(x, s)),
              'exact_div on the card differs from the CPU')
    errs = check_calls([c for path in PATHS for c in recorded[path][0]], dev)
    totals = {}
    for path in PATHS:
        log(f'phase 3: timed on {path[0]} {path[1]}:')
        time_calls([c for c in recorded[path][0] if report[c[0]] == path],
                   totals)
    calls_kept = sum(len(recorded[p][0]) for p in PATHS)
    launches = {name: recorded[path][1][name] for name, path in report.items()}
    del recorded

    # ---- phase 4 ----
    variants = [('resnet50', 'uniform8', 'folded_float32', torch.int16),
                ('resnet50', 'uniform8', 'float32', torch.int32),
                ('resnet50', 'uniform4', 'folded_float32', torch.int16),
                ('resnet50', 'uniform4', 'float32', torch.int32),
                ('resnet50', 'bops_0.5', 'folded_float32', torch.int16),
                ('resnet18', 'uniform4', 'folded_float32', torch.int16),
                ('resnet50', 'uniform4', 'uint8', torch.int16),
                ('resnet50', 'uniform4', 'folded_int8', torch.int16)]
    engines = {}
    for arch, scheme, mode, residual in variants:
        fm = fms[arch, scheme]
        engines[arch, scheme, mode] = engine_phase(
            fm, engine_input(fm, mode, raw, raw_u8, dev), mode, residual, dev)
    for scheme in ('uniform8', 'uniform4'):
        trace_breakdown(engines['resnet50', scheme, 'folded_float32'], folded,
                        f'resnet50 {scheme} folded_float32 int16')

    # ---- phase 5 ----
    serving_phase(engines['resnet50', 'uniform8', 'folded_float32'],
                  fold4_images, 'resnet50 uniform8 folded_float32', dev)
    fm = fms['resnet50', 'bops_0.5']
    s_in = fm.act_scale('quant_input')
    serving_phase(build_resnet_engine(fm, input_mode='folded_int8',
                                      residual_dtype=torch.int16, device=dev),
                  lambda b: quantize_int8(fold4_images(b), s_in),
                  'resnet50 bops_0.5 folded_int8', dev)

    # ---- phase 6 ----
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = totals[name]
        arch, scheme = report[name]
        kernels.append(dict(
            name=name, route='cuda', source=source, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name],
            ms=t['ms'], plain_ms=t['plain_ms'], bound_ms=t['bound_ms'],
            bound_by=('bytes' if t['bytes'] / HBM_BYTES_PER_S
                      >= t['ops'] / INT8_OPS_PER_S else 'operations'),
            library_ms=t['library_ms'] if t['library_ok'] else None,
            path=f'{arch} {scheme} folded_float32 int16 b{BATCH} '
                 f'{SIZE}x{SIZE}'))
    log(f'phase 6: all phases passed in {time.perf_counter() - t_start:.1f} s '
        f'({calls_kept} recorded kernel calls; kernel ms, plain_ms, bound_ms '
        f'and library_ms are totals over one forward of the path named in '
        f'each entry)')
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
