"""Traffic kind ``batch_closed``: offline batch inference by one caller in
a closed loop, straight through the family's engine (no batcher).

Parameters: ``batch`` (images a call), ``pool_batches`` (distinct host
batches, drawn from the seed), ``input_mode`` (the engine's: ``uint8``
takes decoded pixels and normalizes them on the card), ``in_flight``
(calls sent ahead of the one whose logits the caller waits for),
``warmup_calls``, ``trace_calls`` (calls profiled after the window in a
traced run, in flight and then alone).

The pool sits in pinned host memory, as a loader's batches do.  Each call
uploads one host batch, runs the engine and copies the logits into a
pinned host buffer, none of it waiting for the card; the caller reads a
call's logits once ``in_flight`` later calls have been sent, so that a
stall of the host does not leave the card idle.  The pool's batches come
in an order drawn from the seed.  When the window's time is up the caller
sends nothing more, waits for every call it sent and then reads the
clock: the rate is the images of all those calls over all that time.
Every answer is held against the reference's logits of its batch.

While calls are in flight the engine's call blocks once the card's queue
is full, so its host time then reads the card's pace.  A traced run
therefore profiles two stretches after the window: ``trace_calls`` calls
in flight, whose device trace the slice's metrics read, and as many calls
made alone, each after the card has finished the one before, whose host
times (``dispatch_s``) and spans, the profiled stretch last, read the
engine's own cost.
"""

from __future__ import annotations

import collections
import time
from typing import Dict

import numpy as np
import torch

from portbench import common, inputs, program, trace, weights


def run(r: common.Run) -> Dict:
    cfg, mix, dev = r.config, r.mix, r.device
    size, batch, n_pool = (int(cfg['image_size']), int(mix['batch']),
                           int(mix['pool_batches']))
    mode, depth = mix['input_mode'], int(mix['in_flight'])
    cuda = dev.type == 'cuda'
    tensors = weights.generate(cfg, r.seed, dev)
    make = inputs.uint8_images if mode == 'uint8' else inputs.float_images
    pool = make(r.seed, n_pool * batch, size, dev)
    host = torch.from_numpy(pool)
    if cuda:
        host = host.pin_memory()
    eng = program.engine(program.frozen(cfg, tensors), dev, input_mode=mode)
    order = np.random.default_rng(weights.sub_seed(r.seed, 'order')
                                  ).permutation(n_pool)
    answers = common.Answers(n_pool)
    lone = []                        # host s of the engine's call, alone
    sent = collections.deque()       # (pool batch, host logits, copied)
    spare = []

    def collect() -> None:
        k, logits, copied = sent.popleft()
        if copied is not None:
            copied.synchronize()
        answers.add(k, logits.numpy())
        spare.append(logits)

    def call(k: int, alone: bool = False) -> None:
        x = host[k * batch:(k + 1) * batch].to(dev, non_blocking=True)
        if alone:
            common.sync(dev)
        t = time.perf_counter()
        with torch.profiler.record_function('portbench.dispatch'):
            out = eng(x)
        if alone:
            lone.append(time.perf_counter() - t)
        logits = (spare.pop() if spare else
                  torch.empty(out.shape, dtype=out.dtype, pin_memory=cuda))
        logits.copy_(out, non_blocking=True)
        copied = None
        if cuda:
            copied = torch.cuda.Event()
            copied.record()
        sent.append((k, logits, copied))
        while len(sent) > depth:
            collect()

    def drain() -> None:
        while sent:
            collect()

    for i in range(int(mix['warmup_calls'])):
        call(int(order[i % n_pool]))
    drain()
    if r.trace:
        trace.Slice.prime()
    common.sync(dev)
    r.setup_done()
    t0, n = r.first_timed, 0
    while time.perf_counter() - t0 < r.seconds:
        call(int(order[n % n_pool]))
        n += 1
    drain()
    window_s = time.perf_counter() - t0
    summary = None
    if r.trace:
        n_trace, made = int(mix['trace_calls']), [n]

        def calls(alone: bool = False) -> None:
            for _ in range(n_trace):
                call(int(order[made[0] % n_pool]), alone)
                made[0] += 1
                if alone:
                    drain()
            drain()

        summary = dict(trace.profiled(calls), forwards=n_trace)
        lone_slice = trace.Slice()
        lone_slice.start()
        calls(alone=True)
        lone_slice.stop()
    peak = common.memory_peak(dev)
    del eng
    common.release()

    common.log(f'batch: {n} calls of {batch} in {window_s:.3f} s')
    ref_img = common.reference_logits(cfg, tensors, pool, range(len(pool)),
                                      dev, input_mode=mode)
    ref = {k: np.stack([ref_img[k * batch + j] for j in range(batch)])
           for k in range(n_pool)}
    return dict(
        e2e={'images_per_s': n * batch / window_s},
        attempted=n * batch, failed=0,
        compared={'logit_max_abs_diff': (answers.max_gap(ref), 0.0)},
        memory_peak_bytes=peak, trace=summary,
        record=dict(dispatch_s=lone, window_s=window_s, forwards=n,
                    batch=batch, **common.work_record(cfg, batch)))
