"""The benchmark's arithmetic: the work of a forward from its shapes, the
roofline bytes, the trace reductions and the per-layer readers."""

from __future__ import annotations

import importlib.util
import json
import os

import pytest

from portbench import run, trace
from portbench.tests import tiny
from portbench.work import common as work


def _config(name):
    with open(os.path.join(tiny.HERE, 'configs', name + '.json')) as f:
        return json.load(f)


def _reader(name):
    path = run.reader_path(name)
    spec = importlib.util.spec_from_file_location('m_' + name.replace(
        '.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_resnet50_work_is_he_et_al_table1():
    """ResNet-50 v1 (stride on the first 1×1) at 224²: 3.86 GMACs a
    forward, He et al.'s 3.8 × 10⁹ multiply-adds (4.1 GMACs is the count
    of the later variant with the stride on the 3×3), 2 operations a
    MAC; its strided 1×1 convs read a quarter of their input."""
    config = _config('resnet50_w8a8')
    layers = work.forward_layers(config, 1)
    macs = sum(l.macs for l in layers)
    assert macs == 3_857_973_248
    first = {l.key: l for l in layers}['stage2.unit1.quant_convbn1']
    assert (first.hw_in, first.hw_out, first.stride) == (56, 28, 2)
    assert work.forward_ops(config, 64) == 2 * 64 * macs
    assert len(layers) == 54                      # 53 convs and the FC


def test_roofline_bytes_and_bound():
    """A layer's bytes: its input at its bits once (of a strided 1×1 only
    the pixels read), its weights and int32 bias once, its output at the
    bits of the node it feeds."""
    pk = work.peaks()
    l3 = work.Layer('c', 2, 14, 14, 3, 3, 256, 256, 1, 8, 8, 8)
    assert l3.bytes == 2 * 14 * 14 * 256 + 9 * 256 * 256 + 4 * 256 + \
        2 * 14 * 14 * 256
    assert l3.bound_s(pk) == pytest.approx(max(
        l3.ops / 1.979e15, l3.bytes / 3.35e12))
    l1 = work.Layer('p', 1, 56, 28, 1, 1, 256, 512, 1, 8, 8, 16,
                    stride=2)
    assert l1.bytes == 28 * 28 * 256 + 256 * 512 + 4 * 512 + \
        28 * 28 * 512 * 2
    dw = work.Layer('d', 1, 56, 28, 3, 3, 144, 144, 144, 8, 8, 8)
    assert dw.macs == 28 * 28 * 144 * 9


def test_rectangular_kernel_counts_its_taps():
    """A 1×7 conv (InceptionV3's factorised 7×7) counts 7 taps a pixel,
    not 49, in its operations and its weight bytes."""
    l17 = work.Layer('f', 2, 17, 17, 1, 7, 192, 160, 1, 8, 8, 8)
    assert l17.macs == 2 * 17 * 17 * 160 * 7 * 192
    assert l17.bytes == 2 * 17 * 17 * 192 + 7 * 192 * 160 + 4 * 160 + \
        2 * 17 * 17 * 160
    l71 = work.Layer('f', 2, 17, 17, 7, 1, 192, 160, 1, 8, 8, 8)
    assert (l71.macs, l71.bytes) == (l17.macs, l17.bytes)


def test_resnet50_layers_count_as_before():
    """Each ResNet-50 layer's operations and bytes at the batch cell's 64
    images equal those recorded before the layers took ``kh`` and ``kw``
    (``resnet50_w8a8_work_b64.json``)."""
    with open(os.path.join(os.path.dirname(__file__),
                           'resnet50_w8a8_work_b64.json')) as f:
        before = [tuple(r) for r in json.load(f)]
    layers = work.forward_layers(_config('resnet50_w8a8'), 64)
    assert [(l.key, l.ops, l.bytes) for l in layers] == before


def test_trace_union_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (5.0, 5.5)]
    assert trace.union_s(spans) == pytest.approx(3.5)
    assert trace.gaps(spans) == [(2.0, 3.0), (4.0, 5.0)]


def _event(cat, name, corr):
    return {'cat': cat, 'name': name, 'ph': 'X', 'ts': 0, 'dur': 1,
            'args': {'correlation': corr}}


def test_trace_counts_enqueued_work_it_lacks():
    """A launch or copy without its device activity is lost; a call that
    enqueues no device work, and a host operation, are not."""
    events = [_event('cuda_runtime', 'cudaLaunchKernel', 1),
              _event('kernel', 'k', 1),
              _event('cuda_driver', 'cuLaunchKernelEx', 2),
              _event('cuda_runtime', 'cudaMemcpyAsync', 3),
              _event('gpu_memcpy', 'Memcpy HtoD', 3),
              _event('cuda_runtime', 'cudaMemsetAsync', 4),
              _event('cuda_runtime', 'cudaEventRecord', 5),
              _event('cpu_op', 'aten::add', 6)]
    assert trace.lost_share(events) == 0.5
    assert trace.lost_share(events[-2:]) == 0.0


@pytest.mark.parametrize('lost,tries', [([0.0], 1), ([0.01], 1),
                                        ([0.5, 0.002], 2),
                                        ([0.5, 0.5, 0.5, 0.5], 3)])
def test_a_slice_that_lost_work_is_profiled_anew(monkeypatch, lost, tries):
    readings = iter(lost)

    class Fake:
        def start(self):
            pass

        def stop(self):
            pass

        def summary(self):
            return {'lost_share': next(readings)}

    monkeypatch.setattr(trace, 'Slice', Fake)
    done = []
    summary = trace.profiled(lambda: done.append(1))
    assert (len(done) == tries
            and summary['lost_share'] == lost[tries - 1])


@pytest.mark.parametrize('name,want', [
    ('void gemm_s8_sm90_kernel<true, false, false, 128>(Params)',
     'port: conv sm90 acc'),
    ('_Z19gemm_s8_sm90_kernelILb0ELb1ELb0ELi64EEv6Params',
     'port: matmul sm90 requant'),
    ('void dwconv_kernel<true, 4>(...)', 'port: depthwise requant'),
    ('maxpool_folded_requant_kernel', 'port: pool requant'),
    ('void at::native::vectorized_elementwise_kernel<4, ...>', None)])
def test_port_kernel_names(name, want):
    assert trace.port_kernel(name) == want


def test_readers():
    rec = dict(dispatch_s=[0.008, 0.010],
               window_s=10.0, forwards=400, ops_per_forward=4.9e11,
               bound_s_per_forward=5.8e-4, peaks=work.peaks(),
               trace=dict(busy_s=0.3, wall_s=0.5, glue_s=0.2, port_s=0.05,
                          kernels=7000, forwards=20))
    assert _reader('host_dispatch_ms.batch')(rec) == pytest.approx(9.0)
    assert _reader('glue_share.batch')(rec) == pytest.approx(200 / 3)
    assert _reader('kernel_roofline.batch')(rec) == pytest.approx(
        100 * 5.8e-4 * 20 / 0.3)
    assert _reader('mfu.batch')(rec) == pytest.approx(
        100 * 4.9e11 * 400 / (10.0 * 1.979e15))
    assert _reader('device_idle.batch')(rec) == pytest.approx(40.0)
    train = dict(window_s=10.0, steps=28, least_step_s=1e-3,
                 trace=dict(busy_s=0.6, wall_s=0.8, kernels=14808, steps=2))
    assert _reader('device_idle.train')(train) == pytest.approx(25.0)
    assert _reader('kernels_per_step.train')(train) == 7404
    assert _reader('mfu.train')(train) == pytest.approx(0.28)
    empty = dict(rec, dispatch_s=[], trace=None, forwards=0)
    for name in ('host_dispatch_ms.batch', 'glue_share.batch',
                 'kernel_roofline.batch', 'mfu.batch', 'device_idle.batch'):
        assert _reader(name)(empty) is None
