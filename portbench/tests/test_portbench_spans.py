"""The readers of the program's spans (``portbench/spans.py`` and the six
``metrics/*_ms.*`` readers): sums a call of the profiled slice from
hand-made records, None where there is nothing whole to read; and on the
card, an engine call's device and host times within its wall time."""

from __future__ import annotations

import importlib.util
import math
import sys
import time

import pytest
import torch

from hawq_tpu_torch.utils import tracing
from portbench import program, run, weights
from portbench.tests import tiny

# reader → (span, device or host)
READERS = {
    'forward_ms.batch': ('engine.forward', 'device'),
    'engine_host_ms.batch': ('engine.forward', 'host'),
    'forward_ms.train': ('train.forward', 'device'),
    'backward_ms.train': ('train.backward', 'device'),
    'optimizer_ms.train': ('train.optimizer', 'device'),
    'step_host_ms.train': ('train.step', 'host'),
}
SITES = ('engine.input', 'engine.conv', 'engine.requant', 'engine.residual')
PHASES = ('train.forward', 'train.backward', 'train.optimizer')


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        'm_' + name.replace('.', '_'), run.reader_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _calls(top, children, n, first=0.0):
    """``n`` top-level spans ``top``, each with one span of every name in
    ``children`` twice: call k's spans take k + 1 ms on the host and
    (k + 1) / 10 ms on the device, plus ``first`` for call 0."""
    spans = []
    for k in range(n):
        call = len(spans)
        ms = k + 1 + (first if k == 0 else 0.0)
        for j, name in enumerate((top,) + children + children):
            spans.append(dict(name=name, parent=None if j == 0 else call,
                              call=call, t0_ns=0, t1_ns=int(ms * 1e6),
                              device_ms=ms / 10))
    return spans


def _records(monkeypatch, spans, dropped=0):
    monkeypatch.setattr(tracing, 'records',
                        lambda: tracing.Records(spans, dropped))


@pytest.mark.parametrize('name', sorted(READERS))
def test_reader_sums_the_slice_a_call(name, monkeypatch):
    """Three calls recorded, a slice of the last two: call 0 (taking 100
    ms more) is left out; a span a call counts once, a child twice."""
    span, kind = READERS[name]
    train = name.endswith('.train')
    top = 'train.step' if train else 'engine.forward'
    spans = _calls(top, PHASES if train else SITES, 3, first=100.0)
    _records(monkeypatch, spans)
    rec = {'trace': {'steps' if train else 'forwards': 2}}
    per_call = (2 + 3) / 2 * (1 if span == top else 2)
    want = per_call / 10 if kind == 'device' else per_call
    assert _reader(name)(rec) == pytest.approx(want)


@pytest.mark.parametrize('name', sorted(READERS))
def test_reader_has_nothing_to_read(name, monkeypatch):
    train = name.endswith('.train')
    kind = 'steps' if train else 'forwards'
    top = 'train.step' if train else 'engine.forward'
    full = _calls(top, PHASES if train else SITES, 2)
    rec = {'trace': {kind: 2}}
    read = _reader(name)
    for spans, dropped in (([], 0), (full, 1), (full[:len(full) // 2], 0)):
        _records(monkeypatch, spans, dropped)
        assert read(rec) is None
    _records(monkeypatch, full)
    assert read({'trace': None}) is None
    assert read({'trace': {kind: 0}}) is None
    other = 'forwards' if train else 'steps'
    assert read({'trace': {other: 2}}) is None
    if READERS[name][1] == 'device':           # the CPU: no device time
        _records(monkeypatch, [dict(r, device_ms=None) for r in full])
        assert read(rec) is None


def test_an_older_program_reads_nothing(monkeypatch):
    """A checkout whose program has no tracing module: None, no error."""
    import hawq_tpu_torch.utils
    monkeypatch.delattr(hawq_tpu_torch.utils, 'tracing')
    monkeypatch.setitem(sys.modules, 'hawq_tpu_torch.utils.tracing', None)
    for name in READERS:
        assert _reader(name)({'trace': {'forwards': 2, 'steps': 2}}) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')


@pytest.mark.cuda
def test_device_times_nest_on_the_card(card):
    """A tiny engine's traced calls on the card: the call's device and host
    times are there, and neither exceeds the wall time of the calls."""
    dev = torch.device('cuda', 0)
    cfg = tiny.RESNET
    eng = program.engine(program.frozen(cfg, weights.generate(cfg, 7, dev)),
                         dev, input_mode='uint8')
    x = torch.randint(0, 256, (4, cfg['image_size'], cfg['image_size'], 3),
                      dtype=torch.uint8, device=dev)
    eng(x)
    torch.cuda.synchronize(dev)
    tracing.clear()
    n = 3
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        for _ in range(n):
            eng(x)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rec = {'trace': {'forwards': n}}
    got = {name: _reader(name)(rec) for name in READERS
           if name.endswith('.batch')}
    assert all(v is not None and math.isfinite(v) and 0 < v <= wall_ms
               for v in got.values()), (got, wall_ms)
    spans, _ = tracing.records()
    assert {r['name'] for r in spans if r['device_ms'] is not None} == {
        'engine.forward'}
