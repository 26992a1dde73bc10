"""The port's per-stage profile (``hawq_tpu_torch.inference.profile``), its
conv shape tables (``inference.conv_shapes``) and ``utils.timing`` against
``hawq_tpu.inference.profile`` and ``benchmarks/latency_lut.py``: capture
points, shapes and the flops / bytes count equal; ``profile_engine`` and
``time_per_iter`` run on the CPU.
"""

import json
import math
import os
import types

import numpy as np
import pytest
import torch

from benchmarks import latency_lut
from hawq_tpu.configs.bit_config import get_bit_config as jget
from hawq_tpu.inference import profile as jprof
from hawq_tpu.inference.synthetic import synthetic_frozen_resnet as jsyn

from hawq_tpu_torch.configs.bit_config import get_bit_config as tget
from hawq_tpu_torch.inference import conv_shapes as tshapes
from hawq_tpu_torch.inference import profile as tprof
from hawq_tpu_torch.inference.synthetic import synthetic_frozen_resnet
from hawq_tpu_torch.utils.timing import time_per_iter

torch.set_num_threads(1)


@pytest.mark.parametrize('arch', ['tiny18', 'tiny50', 'resnet18', 'resnet50',
                                  'resnet20_cifar', 'resnet50v2',
                                  'tiny18v2', 'mobilenetv2', 'inceptionv3'])
def test_default_capture_points_equal(arch):
    fm = types.SimpleNamespace(arch=arch)
    assert tprof.default_capture_points(fm) == \
        jprof.default_capture_points(fm)


@pytest.mark.parametrize('arch', ['resnet18', 'resnet50', 'tiny18', 'tiny50'])
@pytest.mark.parametrize('size', [224, 32])
def test_conv_shapes_equal(arch, size):
    got = tshapes.conv_shapes(arch, input_size=size)
    assert got == latency_lut.conv_shapes(arch, input_size=size, batch=8)
    assert len(got) == {'resnet18': 19, 'resnet50': 52, 'tiny18': 7,
                        'tiny50': 11}[arch]


@pytest.mark.parametrize('size', [224, 96])
def test_mobilenetv2_conv_shapes_equal(size):
    assert tshapes.mobilenetv2_conv_shapes(size) == \
        latency_lut.mobilenetv2_conv_shapes(size)


@pytest.mark.parametrize('arch,scheme', [('resnet50', 'uniform4'),
                                         ('resnet50', 'bops_0.5'),
                                         ('resnet18', 'uniform8'),
                                         ('tiny50', 'uniform4')])
def test_engine_flops_and_bytes_equal(arch, scheme):
    jfm = jsyn(arch, jget(arch, scheme), num_classes=10, seed=0)
    tfm = synthetic_frozen_resnet(arch, tget(arch, scheme), num_classes=10,
                                  seed=0)
    for batch, size in ((8, 224), (3, 64)):
        assert tprof.engine_flops_and_bytes(tfm, batch, size) == \
            jprof.engine_flops_and_bytes(jfm, batch, size)


def test_profile_engine_rows_in_order():
    fm = synthetic_frozen_resnet('tiny18', tget('tiny18', 'uniform8'),
                                 num_classes=10, seed=1)
    x = np.random.RandomState(0).randn(1, 32, 32, 3).astype(np.float32)
    rows = tprof.profile_engine(fm, x, verbose=False, n_iters=2,
                                device='cpu')
    points = tprof.default_capture_points(fm)
    assert [r[0] for r in rows] == points
    assert all(r[1] > 0 and math.isfinite(r[1]) for r in rows)
    assert rows[0][2] == rows[0][1]
    for prev, row in zip(rows, rows[1:]):
        assert row[2] == pytest.approx(row[1] - prev[1])


def test_profile_main_writes_a_trace(tmp_path, capsys):
    assert tprof.main(['--arch', 'tiny18', '--batch', '1', '--image-size',
                       '32', '--input-mode', 'folded_float32', '--device',
                       'cpu', '--n-iters', '2', '--trace',
                       str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    points = tprof.default_capture_points(types.SimpleNamespace(
        arch='tiny18'))
    assert [l.split()[0] for l in out[:len(points)]] == points
    assert json.loads(out[len(points)])['int_ops'] > 0
    with open(os.path.join(tmp_path, 'trace.json')) as f:
        assert json.load(f)['traceEvents']


@pytest.mark.parametrize('n_iters', [None, 3])
def test_time_per_iter_on_the_cpu(n_iters):
    calls = []
    t = time_per_iter(lambda x: calls.append(x), torch.zeros(1),
                      n_iters=n_iters, max_iters=64)
    assert t > 0 and math.isfinite(t)
    assert len(calls) == 3 + (n_iters or 16 + 64)
    with pytest.raises(ValueError):
        time_per_iter(lambda x: x, torch.zeros(1), n_iters=1)
