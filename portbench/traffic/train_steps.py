"""Traffic kind ``train_steps``: quantization-aware training in a closed
loop of steps, through the program's unfolded QAT train step.

Parameters: ``batch``, ``pool_batches`` (distinct host batches of images
and labels, drawn from the seed; each step uploads one),
``calibration_batches`` (range calibration in set-up, over the pool's
batches in turn, batch norm unfolded as the steps run it: a float state
that no training made has only its initial statistics to fold),
``checked_steps`` (the first steps, driven in set-up through the same step
object on distinct batches, which the reference follows), ``lr``,
``momentum``, ``weight_decay``, ``trace_steps`` (steps profiled after the
window in a traced run), ``limits`` (the numbers of :func:`compare` that
the run is held to).

The window goes on training the same object, one uploaded batch a step,
and ends in a device sync; the rate is the images of the steps it ran over
its whole time.  Once it has closed, the reference calibrates and trains
from the same float state on the same batches, and the checked steps are
held against it (:func:`compare`).
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, Mapping

import numpy as np
import torch

from portbench import common, inputs, program, trace, weights
from portbench.work import common as work

# a leaf whose reference value is under this share of the median leaf's
# moves by round-off alone (the comparison leaves it out)
QUIET_LEAF = 1e-3


class Data:
    """The seed's float state, image and label batches, on the device."""

    def __init__(self, cfg: Mapping, mix: Mapping, seed: int, dev):
        size, self.batch, self.n_pool = (int(cfg['image_size']),
                                         int(mix['batch']),
                                         int(mix['pool_batches']))
        self.dev = dev
        self.params0, self.stats0 = weights.generate_float(cfg, seed, dev)
        self.images = inputs.float_images(
            seed, self.n_pool * self.batch, size, dev).reshape(
                self.n_pool, self.batch, size, size, 3)
        self.labels = np.random.default_rng(
            weights.sub_seed(seed, 'labels')).integers(
                0, cfg['num_classes'], (self.n_pool, self.batch))
        self.n_cal = int(mix['calibration_batches'])
        self.n_check = int(mix['checked_steps'])

    def upload(self, k: int):
        k %= self.n_pool
        return (torch.from_numpy(self.images[k]).to(self.dev),
                torch.from_numpy(self.labels[k]).to(self.dev))

    def calibration(self):
        return [self.upload(k)[0] for k in range(self.n_cal)]

    def steps(self):
        return [self.upload(k) for k in range(self.n_check)]


def checked(cfg: Mapping, mix: Mapping, data: Data):
    """Build the program's trainer, calibrate it and drive the checked
    steps through its step → (the trainer, what the check reads of it,
    keyed as :func:`reference` returns the reference's)."""
    wd = float(mix['weight_decay'])
    qat = program.QatTrainer(cfg, data.params0, data.stats0, data.dev,
                             float(mix['lr']), float(mix['momentum']), wd)
    for x in data.calibration():
        qat.calibrate(x)
    got = dict(losses=[], stats_cal=qat.stats())
    for k, (x, y) in enumerate(data.steps()):
        if k == 0:
            loss, logits = qat.step_and_logits(x, y)
            got.update(logits1=logits, stats1=qat.stats(), grad={
                n: m - wd * data.params0[n]
                for n, m in qat.momentum().items()})
        else:
            loss = qat.step(x, y)
        got['losses'].append(float(loss))
    got.update(params=qat.params(), stats=qat.stats())
    return qat, got


def reference(cfg: Mapping, mix: Mapping, data: Data, steps=None,
              **fault) -> Dict:
    """The reference's calibration and checked steps on ``data`` (or on
    ``steps``, (images, labels) batches), by the ``train`` of the family's
    plain QAT, ``reference/<family>_qat.py``; ``fault`` goes to it."""
    qat = common.reference_family(cfg['family'] + '_qat')
    return qat.train(
        cfg, data.params0, data.stats0, data.calibration(),
        steps or data.steps(), float(mix['lr']), float(mix['momentum']),
        float(mix['weight_decay']), **fault)


def run(r: common.Run) -> Dict:
    cfg, mix, dev = r.config, r.mix, r.device
    data = Data(cfg, mix, r.seed, dev)
    qat, got = checked(cfg, mix, data)
    if r.trace:
        trace.Slice.prime()
    common.sync(dev)
    r.setup_done()
    t0, n = r.first_timed, 0
    while time.perf_counter() - t0 < r.seconds:
        qat.step(*data.upload(data.n_check + n))
        n += 1
    common.sync(dev)
    window_s = time.perf_counter() - t0
    summary = None
    if r.trace:
        made = [n]

        def steps() -> None:
            for _ in range(int(mix['trace_steps'])):
                qat.step(*data.upload(data.n_check + made[0]))
                made[0] += 1

        summary = dict(trace.profiled(steps), steps=int(mix['trace_steps']))
    peak = common.memory_peak(dev)
    del qat
    common.release()

    common.log(f'train: {n} steps of {data.batch} in {window_s:.3f} s')
    ref = reference(cfg, mix, data)
    values = compare(got, ref, data.params0)
    fwd_ops = work.forward_ops(cfg, data.batch)
    return dict(
        e2e={'train_images_per_s': n * data.batch / window_s},
        attempted=n * data.batch, failed=0,
        compared={k: (values[k], float(v))
                  for k, v in mix['limits'].items()},
        memory_peak_bytes=peak, trace=summary,
        record=dict(window_s=window_s, steps=n, batch=data.batch,
                    least_step_s=least_step_s(fwd_ops, work.peaks())))


def least_step_s(fwd_ops: float, pk) -> float:
    """The least time of a QAT step: the integer forward at the int8 peak,
    the float backward (twice the forward's operations) at the dense bf16
    peak, an upper bound of any float32 backward's rate."""
    return (fwd_ops / pk['int8_ops_per_s']
            + 2 * fwd_ops / pk['bf16_flops_per_s'])


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.to(torch.float64)))


def leaf_gaps(got: Dict, ref: Dict):
    """Per leaf, the gap of the norms and the norm of the difference, each
    over max(the leaf's reference norm, the median leaf's), over the leaves
    whose reference norm is at least ``QUIET_LEAF`` of the median → (gaps,
    differences, the leaves left out)."""
    norms = {k: _norm(v) for k, v in ref.items()}
    med = statistics.median(norms.values())
    gaps, diffs, quiet = [], [], []
    for k, v in ref.items():
        if norms[k] < QUIET_LEAF * med:
            quiet.append(k)
            continue
        base = max(norms[k], med)
        gaps.append(abs(_norm(got[k]) - norms[k]) / base)
        diffs.append(_norm(got[k] - v) / base)
    return gaps, diffs, quiet


def _delta(after: Dict, before: Dict) -> Dict:
    return {k: after[k] - before[k] for k in before}


def compare(got: Mapping, ref: Mapping, params0: Mapping) -> Dict:
    """Every number of the check, also on standard error → {name: value}.

    The first step comes before any update, so there the two sides agree
    to rounding: its loss, its logits (rows both sides have), its
    gradients as the optimizer holds them, and its update of the running
    statistics and ranges (each leaf's change in the step).  The later
    losses, the parameters' change over the checked steps and the
    statistics after them follow any integer that a rounding flips after
    the first update, so they read wider: the worst leaf's change most of
    all, the median leaf's least."""
    g_gap, g_diff, g_quiet = leaf_gaps(got['grad'], ref['grad'])
    c_gap, _, c_quiet = leaf_gaps(_delta(got['params'], params0),
                                  _delta(ref['params'], params0))
    _, s_diff, s_quiet = leaf_gaps(_delta(got['stats1'], got['stats_cal']),
                                   _delta(ref['stats1'], ref['stats_cal']))
    _, s3_diff, _ = leaf_gaps(got['stats'], ref['stats'])
    rows = min(len(got['logits1']), len(ref['logits1']))
    logits = ref['logits1'][:rows]
    losses, ref_losses = got['losses'], ref['losses']
    values = {
        'loss1_rel_gap': abs(losses[0] - ref_losses[0]) / abs(ref_losses[0]),
        'loss_rel_gap': max(abs(a - b) / abs(b)
                            for a, b in zip(losses, ref_losses)),
        'logits1_gap': float((got['logits1'][:rows] - logits).abs().max()
                             / logits.abs().max()),
        'grad_norm_gap': max(g_gap), 'grad_diff': max(g_diff),
        'stats1_gap': max(s_diff),
        'change_norm_gap': max(c_gap),
        'change_median_gap': statistics.median(c_gap),
        'stats_gap': max(s3_diff)}
    common.log('train check: ' + ', '.join(
        f'{k} {v!r}' for k, v in values.items())
        + f'; quiet leaves: gradient {len(g_quiet)}, change {len(c_quiet)}, '
        f'first update of the statistics {len(s_quiet)}'
        f'; losses {losses}, reference {ref_losses}')
    return values
