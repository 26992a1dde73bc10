"""The reference's quantized-checkpoint format in hawq_tpu_torch == hawq_tpu's.

For tiny50, tiny18, the tiny MobileNetV2 (its 1×1-conv head through the
sixth 'conv_scaling_factor' slice) and InceptionV3 at width_div 16:

* JAX ``export_reference_quantized`` → the port's
  ``import_reference_quantized`` and the port's export → JAX's import give
  FrozenModels with the source's tensors, equal values and dtypes, and the
  two exports are the same dict;
* a ``quantized_checkpoint.pth.tar`` written by either package's
  ``save_reference_quantized`` loads with the other's
  ``load_reference_quantized``;
* incomplete, non-integer and out-of-range inputs raise ``ValueError``.
"""

import numpy as np
import pytest
import torch

from hawq_tpu.configs.bit_config import BitConfig as JBitConfig
from hawq_tpu.configs.bit_config import QuantSettings as JQuantSettings
from hawq_tpu.configs.bit_config import get_bit_config as jget
from hawq_tpu.inference import synthetic as jsyn
from hawq_tpu.models import mobilenetv2 as jm
from hawq_tpu.utils import checkpoint as jckpt

from hawq_tpu_torch.configs.bit_config import (BitConfig, QuantSettings,
                                               get_bit_config as tget)
from hawq_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_engine import _port_fm

torch.set_num_threads(1)

_TINY_MNV2 = dict(stages=jm.TINY_MNV2_STAGES, init_ch=jm.TINY_MNV2_INIT_CH,
                  final_ch=jm.TINY_MNV2_FINAL_CH)
MODELS = ['tiny50', 'tiny18', 'tiny_mnv2', 'inceptionv3_w16']


def _models(name):
    """(JAX FrozenModel, arch, JAX config, port config)."""
    if name == 'tiny_mnv2':
        jcfg = JBitConfig(name='tiny_mnv2_u8', table={},
                          settings=JQuantSettings())
        tcfg = BitConfig(name='tiny_mnv2_u8', table={},
                         settings=QuantSettings())
        return (jsyn.synthetic_frozen_mobilenet(jcfg, num_classes=10, seed=3,
                                                **_TINY_MNV2),
                'mobilenetv2', jcfg, tcfg)
    if name == 'inceptionv3_w16':
        jcfg, tcfg = jget('inceptionv3', 'uniform8'), tget('inceptionv3',
                                                           'uniform8')
        return (jsyn.synthetic_frozen_inception(jcfg, num_classes=10,
                                                width_div=16, seed=3),
                'inceptionv3', jcfg, tcfg)
    jcfg, tcfg = jget(name, 'uniform4'), tget(name, 'uniform4')
    return (jsyn.synthetic_frozen_resnet(name, jcfg, num_classes=10, seed=3),
            name, jcfg, tcfg)


def _assert_same(got, want):
    assert got.arch == want.arch and got.num_classes == want.num_classes
    assert sorted(got.tensors) == sorted(want.tensors)
    for k, v in want.tensors.items():
        g = np.asarray(got.tensors[k])
        assert g.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(g, np.asarray(v), err_msg=k)


def _assert_same_state(a, b):
    assert sorted(a) == sorted(b)
    for s in a:
        assert sorted(a[s]) == sorted(b[s]), s
        for k, v in a[s].items():
            w = np.asarray(b[s][k])
            assert np.asarray(v).dtype == w.dtype, k
            np.testing.assert_array_equal(np.asarray(v), w, err_msg=k)


@pytest.mark.parametrize('name', MODELS)
def test_round_trip_both_ways(name):
    jfm, arch, jcfg, tcfg = _models(name)
    tfm = _port_fm(jfm)
    jstate = jckpt.export_reference_quantized(jfm)
    tstate = tckpt.export_reference_quantized(tfm)
    _assert_same_state(tstate, jstate)
    if arch == 'mobilenetv2':
        assert list(tstate['conv_scaling_factor']) == [
            'module.output.conv_scaling_factor']
    else:
        assert 'conv_scaling_factor' not in tstate
    imported = tckpt.import_reference_quantized(jstate, arch, tcfg)
    _assert_same(imported, jfm)
    # the kernels take C-order tensors: the OIHW → HWIO transposes copy
    assert all(np.asarray(v).flags.c_contiguous
               for v in imported.tensors.values())
    _assert_same(jckpt.import_reference_quantized(tstate, arch, jcfg), jfm)
    # torch tensors as the slices' values, as the file holds them
    as_torch = {s: {k: torch.from_numpy(v) for k, v in d.items()}
                for s, d in jstate.items()}
    _assert_same(tckpt.import_reference_quantized(as_torch, arch, tcfg), jfm)


@pytest.mark.parametrize('name', MODELS)
def test_files_load_in_the_other_package(name, tmp_path):
    jfm, arch, jcfg, tcfg = _models(name)
    jpath = str(tmp_path / 'jax_quantized_checkpoint.pth.tar')
    tpath = str(tmp_path / 'torch_quantized_checkpoint.pth.tar')
    jckpt.save_reference_quantized(jpath, jfm)
    tckpt.save_reference_quantized(tpath, _port_fm(jfm))
    _assert_same(tckpt.load_reference_quantized(jpath, arch, tcfg), jfm)
    _assert_same(jckpt.load_reference_quantized(tpath, arch, jcfg), jfm)
    loaded = torch.load(tpath, map_location='cpu', weights_only=False)
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.float32
               for d in loaded.values() for t in d.values())


def _broken(state, slice_name, fn):
    out = {s: dict(v) for s, v in state.items()}
    k = next(iter(out[slice_name]))
    out[slice_name][k] = fn(out[slice_name][k])
    return out, k


@pytest.mark.parametrize('name', MODELS)
def test_import_rejects_bad_inputs(name):
    jfm, arch, _, tcfg = _models(name)
    state = tckpt.export_reference_quantized(_port_fm(jfm))

    def rejects(bad, match):
        with pytest.raises(ValueError, match=match):
            tckpt.import_reference_quantized(bad, arch, tcfg)
        return True

    assert rejects({s: v for s, v in state.items() if s != 'bias_integer'},
                   'missing slices')
    for s in ('act_scaling_factor', 'weight_integer', 'bias_integer',
              'convbn_scaling_factor'):
        incomplete = {t: dict(v) for t, v in state.items()}
        del incomplete[s][sorted(incomplete[s])[-1]]
        assert rejects(incomplete, 'incomplete')
    assert rejects(_broken(state, 'weight_integer', lambda w: w + 0.25)[0],
                   'non-integer')
    assert rejects(_broken(state, 'bias_integer', lambda b: b - 0.5)[0],
                   'non-integer')
    assert rejects(_broken(state, 'weight_integer',
                           lambda w: np.full_like(w, 128.0))[0], 'range')
    assert rejects(_broken(state, 'bias_integer',
                           lambda b: np.full_like(b, 2.0 ** 32))[0], 'range')
    assert rejects(_broken(state, 'weight_integer', lambda w: w[0])[0],
                   'rank')
    if arch == 'mobilenetv2':      # the reference's own five-slice recipe
        five = {s: v for s, v in state.items() if s != 'conv_scaling_factor'}
        assert rejects(five, 'conv_scaling_factor')
