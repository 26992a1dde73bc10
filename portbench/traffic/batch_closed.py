"""Traffic kind ``batch_closed``: offline batch inference by one caller in
a closed loop, straight through the family's engine (no batcher).

Parameters: ``batch`` (images a call), ``pool_batches`` (distinct host
batches, drawn from the seed), ``input_mode`` (the engine's: ``uint8``
takes decoded pixels and normalizes them on the card), ``warmup_calls``,
``trace_calls`` (calls profiled after the window in a traced run).

Each call uploads one host batch, runs the engine and fetches the logits
to the host; the pool's batches come in an order drawn from the seed.  The
rate is the images whose logits reached the host over the whole window,
which ends when the last call started inside it has returned.  Every
answer is held against the reference's logits of its batch.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from portbench import common, inputs, program, trace, weights


def run(r: common.Run) -> Dict:
    cfg, mix, dev = r.config, r.mix, r.device
    size, batch, n_pool = (int(cfg['image_size']), int(mix['batch']),
                           int(mix['pool_batches']))
    mode = mix['input_mode']
    tensors = weights.generate(cfg, r.seed, dev)
    make = inputs.uint8_images if mode == 'uint8' else inputs.float_images
    pool = make(r.seed, n_pool * batch, size, dev)
    eng = program.engine(program.frozen(cfg, tensors), dev, input_mode=mode)
    order = np.random.default_rng(weights.sub_seed(r.seed, 'order')
                                  ).permutation(n_pool)
    answers = common.Answers(n_pool)
    calls = []

    def call(k: int) -> None:
        x = torch.from_numpy(pool[k * batch:(k + 1) * batch]).to(dev)
        t = time.perf_counter()
        with torch.profiler.record_function('portbench.dispatch'):
            out = eng(x)
        calls.append(time.perf_counter() - t)
        answers.add(k, out.cpu().numpy())

    for i in range(int(mix['warmup_calls'])):
        call(int(order[i % n_pool]))
    if r.trace:
        trace.Slice.prime()
    common.sync(dev)
    calls.clear()
    r.setup_done()
    t0, n = r.first_timed, 0
    while time.perf_counter() - t0 < r.seconds:
        call(int(order[n % n_pool]))
        n += 1
    window_s = time.perf_counter() - t0
    window_calls = list(calls)
    summary = None
    if r.trace:
        tr = trace.Slice()
        tr.start()
        for i in range(int(mix['trace_calls'])):
            call(int(order[(n + i) % n_pool]))
        tr.stop()
        summary = tr.summary()
        summary['forwards'] = int(mix['trace_calls'])
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
        record=dict(dispatch_s=window_calls, window_s=window_s, forwards=n,
                    batch=batch, **common.work_record(cfg, batch)))
