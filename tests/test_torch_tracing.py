"""The port's spans (``hawq_tpu_torch.utils.tracing``): nothing recorded and
no profiler range opened outside a profiler; under one, records with
parents and call ids per thread, a bound with a dropped count, stamps on
the chrome trace's clock; and a fixed count of each engine site a forward
and of each QAT phase a step."""

from __future__ import annotations

import collections
import json
import os
import threading

import numpy as np
import pytest
import torch

from hawq_tpu_torch.configs.bit_config import get_bit_config
from hawq_tpu_torch.inference import profile as tprof
from hawq_tpu_torch.inference.engine import build_resnet_engine
from hawq_tpu_torch.inference.engine_inception import build_inceptionv3_engine
from hawq_tpu_torch.inference.synthetic import (synthetic_frozen_inception,
                                                synthetic_frozen_resnet)
from hawq_tpu_torch.train import train as tt
from hawq_tpu_torch.train.trainer import TrainerConfig, build_model
from hawq_tpu_torch.utils import preproc, tracing

torch.set_num_threads(1)
CPU = [torch.profiler.ProfilerActivity.CPU]

# spans a forward of each tiny engine, and a QAT step
ENGINE_SITES = {
    'tiny50': {'engine.forward': 1, 'engine.input': 1, 'engine.conv': 12,
               'engine.requant': 4, 'engine.residual': 3},
    'tiny18': {'engine.forward': 1, 'engine.input': 1, 'engine.conv': 8,
               'engine.requant': 4, 'engine.residual': 3},
    'resnet20_cifar': {'engine.forward': 1, 'engine.input': 1,
                       'engine.conv': 21, 'engine.requant': 10,
                       'engine.residual': 9},
}
# tiny50 with the int32 carrier: each unit's conv3 leaves through the
# residual epilogue, inside its engine.residual and without an engine.conv,
# and the conv3 of units 1 and 2 as the next unit's input too, without an
# engine.requant there
ENGINE_SITES_INT32 = {'tiny50': dict(ENGINE_SITES['tiny50'],
                                     **{'engine.conv': 9,
                                        'engine.requant': 2})}
# InceptionV3 at width_div 16: 94 convs; requants at 33 branch inputs (a
# pool branch's is A1's), after 45 accumulator-form convs, at the 4
# sub-branch concats of the C units and the FC's input; 11 unit concats,
# 9 A1 pools
INCEPTION_SITES = {'engine.forward': 1, 'engine.input': 1, 'engine.conv': 94,
                   'engine.requant': 83, 'engine.concat': 11,
                   'engine.avgpool': 9}
STEP_PHASES = {'train.step': 1, 'train.forward': 1, 'train.backward': 1,
               'train.optimizer': 1}


@pytest.fixture(autouse=True)
def _fresh():
    tracing.clear()
    yield
    tracing.clear()


def _images(mode, batch=2, size=32):
    x = np.random.RandomState(0).rand(batch, size, size, 3).astype(
        np.float32)
    if mode == 'uint8':
        return (x * 255).astype(np.uint8)
    if mode == 'folded_float32':
        return preproc.fold4_images(x)
    return x


def _engine(arch, mode='float32', carrier=torch.int16):
    fm = synthetic_frozen_resnet(arch, get_bit_config(arch, 'uniform8'),
                                 num_classes=10)
    return build_resnet_engine(fm, input_mode=mode, device='cpu',
                               residual_dtype=carrier)


def _qat_step():
    model, _ = build_model(TrainerConfig(arch='tiny50', scheme='uniform8',
                                         num_classes=10))
    state = tt.TrainState.create(model, tt.sgd_with_step_decay(model, 0.01))
    step = tt.make_train_step(model, folded=False)
    batch = {'image': torch.from_numpy(_images('float32')),
             'label': torch.tensor([1, 2])}
    return lambda: step(state, batch)


def _by_call(spans):
    """{call id: Counter of span names} over the closed records."""
    out = collections.defaultdict(collections.Counter)
    for r in spans:
        out[r['call']][r['name']] += 1
    return out


def test_off_is_the_shared_noop_and_records_nothing(monkeypatch):
    def entered(name):
        raise AssertionError(f'range {name!r} opened outside a profiler')
    monkeypatch.setattr(tracing, '_enter', entered)
    monkeypatch.setattr(torch.profiler, 'record_function', entered)
    assert tracing.span('a') is tracing.span('b', torch.device('cpu'))
    with tracing.span('a'):
        with tracing.span('b'):
            pass
    _engine('tiny50', 'uint8')(_images('uint8'))
    _qat_step()()
    assert tracing.records() == ([], 0)


def test_nesting_parents_and_calls():
    with torch.profiler.profile(activities=CPU):
        with tracing.span('top'):
            with tracing.span('mid'):
                with tracing.span('leaf'):
                    with tracing.span('mid'):     # same name: not opened
                        pass
            with tracing.span('leaf'):
                pass
        with tracing.span('top'):
            with tracing.span('leaf'):
                pass
    spans, dropped = tracing.records()
    assert dropped == 0
    assert [(r['name'], r['parent'], r['call']) for r in spans] == [
        ('top', None, 0), ('mid', 0, 0), ('leaf', 1, 0), ('leaf', 0, 0),
        ('top', None, 4), ('leaf', 4, 4)]
    for r in spans:
        assert r['t0_ns'] <= r['t1_ns'] and r['device_ms'] is None
    for r in spans:
        if r['parent'] is not None:
            p = spans[r['parent']]
            assert p['t0_ns'] <= r['t0_ns'] <= r['t1_ns'] <= p['t1_ns']


def test_two_threads_keep_their_own_parents():
    inside = threading.Barrier(2, timeout=30)

    def work(tag):
        with tracing.span(f'{tag}.top'):
            inside.wait()                    # both tops open at once
            with tracing.span(f'{tag}.child'):
                inside.wait()
    with torch.profiler.profile(activities=CPU):
        threads = [threading.Thread(target=work, args=(t,))
                   for t in ('a', 'b')]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    spans, _ = tracing.records()
    index = {r['name']: i for i, r in enumerate(spans)}
    assert len(spans) == 4
    for tag in ('a', 'b'):
        top, child = index[f'{tag}.top'], index[f'{tag}.child']
        assert spans[top]['parent'] is None and spans[top]['call'] == top
        assert spans[child]['parent'] == top
        assert spans[child]['call'] == top


def test_dropped_counts_past_the_bound(monkeypatch):
    monkeypatch.setattr(tracing, 'LIMIT', 3)
    with torch.profiler.profile(activities=CPU):
        for _ in range(5):
            with tracing.span('s'):
                pass
    spans, dropped = tracing.records()
    assert len(spans) == 3 and dropped == 2
    tracing.clear()
    assert tracing.records() == ([], 0)


def test_stamps_lie_on_the_trace_clock(tmp_path):
    with torch.profiler.profile(activities=CPU) as prof:
        for i in range(3):
            with tracing.span('stamp.outer'):
                torch.ones(64).add_(i)
                with tracing.span('stamp.inner'):
                    torch.ones(64).mul_(i)
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace['baseTimeNanoseconds'])
    spans, _ = tracing.records()
    for name in ('stamp.outer', 'stamp.inner'):
        events = sorted(float(e['ts']) for e in trace['traceEvents']
                        if e.get('ph') == 'X' and e.get('name') == name)
        ours = [r for r in spans if r['name'] == name]
        assert len(events) == len(ours) == 3
        for ts_us, r in zip(events, ours):
            assert abs(r['t0_ns'] - (ts_us * 1e3 + base)) < 1e6


@pytest.mark.parametrize('arch,mode', [('tiny50', 'uint8'),
                                       ('tiny50', 'float32'),
                                       ('tiny50', 'folded_float32'),
                                       ('tiny18', 'float32'),
                                       ('resnet20_cifar', 'float32')])
def test_engine_sites_a_forward(arch, mode):
    _check_sites(_engine(arch, mode), _images(mode), ENGINE_SITES[arch])


@pytest.mark.parametrize('mode', ['uint8', 'float32'])
def test_engine_sites_a_forward_int32_carrier(mode):
    _check_sites(_engine('tiny50', mode, torch.int32), _images(mode),
                 ENGINE_SITES_INT32['tiny50'])


@pytest.mark.parametrize('mode', ['uint8', 'float32'])
def test_inception_sites_a_forward(mode):
    fm = synthetic_frozen_inception(get_bit_config('inceptionv3', 'uniform8'),
                                    num_classes=10, width_div=16)
    eng = build_inceptionv3_engine(fm, input_mode=mode, input_hw=(75, 75),
                                   device='cpu')
    _check_sites(eng, _images(mode, size=75), INCEPTION_SITES)


def test_inception_records_nothing_outside_a_profiler(monkeypatch):
    def entered(name):
        raise AssertionError(f'range {name!r} opened outside a profiler')
    monkeypatch.setattr(tracing, '_enter', entered)
    fm = synthetic_frozen_inception(get_bit_config('inceptionv3', 'uniform8'),
                                    num_classes=10, width_div=16)
    build_inceptionv3_engine(fm, input_mode='uint8', input_hw=(75, 75),
                             device='cpu')(_images('uint8', size=75))
    assert tracing.records() == ([], 0)


def _check_sites(eng, x, want):
    """Two traced forwards equal to an untraced one, each with ``want``
    spans of each site, every site inside its ``engine.forward``."""
    plain = eng(x)
    with torch.profiler.profile(activities=CPU):
        traced = [eng(x), eng(x)]
    for out in traced:
        assert torch.equal(out, plain)
    spans, dropped = tracing.records()
    calls = _by_call(spans)
    assert dropped == 0 and len(calls) == 2
    for counts in calls.values():
        assert dict(counts) == want
    for r in spans:
        assert (r['parent'] is None) == (r['name'] == 'engine.forward')


def test_capture_ends_the_forward_span():
    """A forward truncated at a capture node closes its span."""
    fm = synthetic_frozen_resnet('tiny50', get_bit_config('tiny50',
                                                          'uniform8'),
                                 num_classes=10)
    eng = build_resnet_engine(fm, capture='stage1.unit1.input', device='cpu')
    with torch.profiler.profile(activities=CPU):
        eng(_images('float32'))
    spans, _ = tracing.records()
    assert [r['name'] for r in spans] == ['engine.forward', 'engine.input',
                                          'engine.conv', 'engine.requant']
    assert all(r['t1_ns'] is not None for r in spans)


def test_qat_step_phases():
    step = _qat_step()
    step()
    with torch.profiler.profile(activities=CPU):
        step()
        step()
    spans, _ = tracing.records()
    calls = _by_call(spans)
    assert len(calls) == 2
    for call, counts in calls.items():
        assert dict(counts) == STEP_PHASES
        assert spans[call]['name'] == 'train.step'
    for r in spans:
        if r['name'] != 'train.step':
            assert r['parent'] == r['call']


def test_profile_main_prints_the_spans(tmp_path, capsys):
    assert tprof.main(['--arch', 'tiny50', '--batch', '1', '--image-size',
                       '32', '--input-mode', 'uint8', '--device', 'cpu',
                       '--n-iters', '2', '--trace', str(tmp_path),
                       '--trace-iters', '3']) == 0
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        if line.startswith('span '):
            words = line.split()
            rows[words[1]] = words
    assert set(rows) == set(ENGINE_SITES['tiny50'])
    for name, words in rows.items():
        assert float(words[3]) == ENGINE_SITES['tiny50'][name]
        assert words[6] == 'n/a' and float(words[9]) > 0
    assert os.path.exists(tmp_path / 'trace.json')


def test_span_table_sums_a_forward():
    spans = [dict(name='f', t0_ns=0, t1_ns=4_000_000),
             dict(name='c', t0_ns=0, t1_ns=1_000_000),
             dict(name='c', t0_ns=0, t1_ns=1_000_000),
             dict(name='f', t0_ns=0, t1_ns=2_000_000),
             dict(name='f', t0_ns=0, t1_ns=None)]
    events = [dict(cat='gpu_user_annotation', name='f', dur=3000.0),
              dict(cat='gpu_user_annotation', name='c', dur=1000.0),
              dict(cat='gpu_user_annotation', name='c', dur=500.0),
              dict(cat='user_annotation', name='f', dur=9000.0),
              dict(cat='gpu_user_annotation', name='f', dur=1000.0),
              dict(cat='gpu_user_annotation', name='other', dur=7.0)]
    assert tprof.span_table(spans, 2, events) == [('f', 1.0, 2.0, 3.0),
                                                  ('c', 1.0, 0.75, 1.0)]
    assert tprof.span_table(spans[:1], 1) == [('f', 1.0, None, 4.0)]


class _FakeEvent:
    """A timing event on a fake clock that ticks at every record."""
    clock = 0
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        type(self).clock += 1
        self.t = type(self).clock

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_device_events_are_read_and_reused(monkeypatch):
    """On a (fake) card a span given the device times its work with two
    fresh events, read and let go by ``records()``; a span without the
    device, or nested in one of its name, takes none: two profiles of
    three calls of three timed spans make eighteen a profile."""
    monkeypatch.setattr(torch.cuda, 'Event', _FakeEvent)
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda device: None)
    monkeypatch.setattr(_FakeEvent, 'clock', 0)
    monkeypatch.setattr(_FakeEvent, 'made', 0)
    card = torch.device('cuda', 0)
    for profile in range(2):
        tracing.clear()
        with torch.profiler.profile(activities=CPU):
            for _ in range(3):
                with tracing.span('call', card):
                    with tracing.span('site', card):
                        pass
                    with tracing.span('site.host'):
                        pass
                    with tracing.span('site', card):   # nested: once
                        with tracing.span('site', card):
                            pass
        spans, _ = tracing.records()
        assert _FakeEvent.made == 18 * (profile + 1)
        assert all(r.events is None for r in tracing._STATE.spans)
        assert [(r['name'], r['device_ms']) for r in spans] == [
            ('call', 5.0), ('site', 1.0), ('site.host', None),
            ('site', 1.0)] * 3
