"""QONNX and bundle export of hawq_tpu_torch == hawq_tpu's.

Frozen models are carried across (``frozen_from_numpy`` of hawq_tpu's
synthetic ones, every family at test size, 8- and 4-bit), then:

* ``export_qonnx`` writes the same file, byte for byte, as hawq_tpu's (for
  InceptionV3 this holds the exporter's walk over the port's unit tables
  against hawq_tpu's walk over its flax branch classes);
* every initializer read back equals the FrozenModel tensor or dyadic
  multiplier it came from;
* ``replay_qonnx`` of the file is bit-equal to the port's CPU engine;
* ``bundle_manifest`` is equal, the ``.bundle.json`` bytes equal, and the
  ``.npz`` arrays equal (not its bytes: its zip entries carry a write time);
* the protobuf module is hawq_tpu's byte for byte.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from hawq_tpu.configs.bit_config import get_bit_config as jget
from hawq_tpu.export import export as jexport
from hawq_tpu.export import qonnx as jqonnx
from hawq_tpu.inference import synthetic as jsyn

from hawq_tpu_torch.export import export as texport
from hawq_tpu_torch.export import qonnx as tq
from hawq_tpu_torch.inference.engine import build_resnet_engine
from hawq_tpu_torch.inference.engine_inception import (
    build_inceptionv3_engine)
from hawq_tpu_torch.inference.engine_mobilenet import (
    build_mobilenetv2_engine)
from hawq_tpu_torch.inference.engine_v2 import build_resnet_v2_engine
from hawq_tpu_torch.inference.freeze import frozen_from_numpy
from hawq_tpu_torch.models.mobilenetv2 import (TINY_MNV2_FINAL_CH,
                                               TINY_MNV2_INIT_CH,
                                               TINY_MNV2_STAGES)
from hawq_tpu_torch.quant.ops import np_dyadic_multiplier

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 16                       # InceptionV3's width_div at test size

# (family case, image size)
CASES = {
    'tiny18-uniform8': 32, 'tiny50-uniform4': 32, 'tiny18v2-uniform8': 32,
    'tiny50v2-uniform4': 32, 'mobilenetv2-uniform8': 32,
    'mobilenetv2-uniform4': 32, 'inceptionv3-uniform8': 75,
    'inceptionv3-uniform4': 75,
}


def _frozen(case):
    """(hawq_tpu's synthetic FrozenModel, the port's copy of it)."""
    arch, scheme = case.split('-')
    if arch == 'mobilenetv2':
        jfm = jsyn.synthetic_frozen_mobilenet(
            jget('mobilenetv2', scheme), 10, seed=3, stages=TINY_MNV2_STAGES,
            init_ch=TINY_MNV2_INIT_CH, final_ch=TINY_MNV2_FINAL_CH)
    elif arch == 'inceptionv3':
        jfm = jsyn.synthetic_frozen_inception(jget('inceptionv3', scheme),
                                              10, width_div=W, seed=3)
    elif arch.endswith('v2'):
        jfm = jsyn.synthetic_frozen_resnet_v2(arch, jget(arch[:-2], scheme),
                                              10, seed=3)
    else:
        jfm = jsyn.synthetic_frozen_resnet(arch, jget(arch, scheme), 10,
                                           seed=3)
    return jfm, frozen_from_numpy(jfm.arch, jfm.cfg.name, jfm.cfg.table,
                                  jfm.tensors, jfm.num_classes)


def _engine(fm, size):
    if fm.arch == 'mobilenetv2':
        return build_mobilenetv2_engine(fm, input_hw=(size, size),
                                        device='cpu')
    if fm.arch == 'inceptionv3':
        return build_inceptionv3_engine(fm, input_hw=(size, size),
                                        device='cpu')
    if fm.arch.endswith('v2'):
        return build_resnet_v2_engine(fm, device='cpu')
    return build_resnet_engine(fm, device='cpu')


@pytest.mark.parametrize('case', list(CASES))
def test_file_byte_equal_and_replay_bit_equal_to_the_engine(case, tmp_path):
    size = CASES[case]
    jfm, tfm = _frozen(case)
    jpath, tpath = str(tmp_path / 'j.onnx'), str(tmp_path / 't.onnx')
    jqonnx.export_qonnx(jfm, jpath, image_size=size)
    tq.export_qonnx(tfm, tpath, image_size=size)
    assert filecmp.cmp(jpath, tpath, shallow=False)

    x = np.random.RandomState(1).randn(2, size, size, 3).astype(np.float32)
    replay = tq.replay_qonnx(tq.load_qonnx(tpath), x)
    eng = _engine(tfm, size)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(replay.astype(np.float32), eng)
    assert np.isfinite(eng).all() and eng.shape == (2, 10)


@pytest.mark.parametrize('case', ['tiny50-uniform4', 'tiny50v2-uniform4',
                                  'mobilenetv2-uniform8',
                                  'inceptionv3-uniform8'])
def test_initializers_equal_the_frozen_model(case, tmp_path):
    """Every conv's weight, bias, weight scale and bits, and every Requant
    node's multiplier (a dyadic multiplier, as np_dyadic_multiplier makes
    them) read back from the file."""
    _, fm = _frozen(case)
    path = str(tmp_path / 'm.onnx')
    tq.export_qonnx(fm, path, image_size=CASES[case])
    m = tq.load_qonnx(path)
    inits = {t.name: tq._tensor_to_np(t) for t in m.graph.initializer}
    convs = [n for n in m.graph.node if n.op_type == 'Conv']
    assert len(convs) == sum(1 for k in fm.tensors
                             if k.endswith('.weight_int')) - 1   # the FC
    for n in convs:
        key = n.name
        np.testing.assert_array_equal(inits[key + '.weight'],
                                      fm[key + '.weight_int'])
        np.testing.assert_array_equal(inits[key + '.bias'],
                                      fm[key + '.bias_int'])
        np.testing.assert_array_equal(
            inits[key + '.weight_scale'],
            np.atleast_1d(fm[key + '.weight_scale'].astype(np.float32)))
        assert inits[key + '.weight_bits'][0] == fm.cfg.weight_bits(key)
    mults = [n.input[1] for n in m.graph.node if n.op_type == 'Requant']
    assert mults
    for name in mults:
        np.testing.assert_array_equal(np_dyadic_multiplier(inits[name]),
                                      inits[name], err_msg=name)


@pytest.mark.parametrize('case', ['tiny18-uniform8', 'tiny50-uniform4'])
def test_bundle_manifest_and_files_equal(case, tmp_path):
    jfm, tfm = _frozen(case)
    assert texport.bundle_manifest(tfm) == jexport.bundle_manifest(jfm)
    jpath, tpath = str(tmp_path / 'j' / 'm'), str(tmp_path / 't' / 'm')
    jexport.export_bundle(jpath, jfm)
    texport.export_bundle(tpath, tfm)
    assert filecmp.cmp(jpath + '.bundle.json', tpath + '.bundle.json',
                       shallow=False)
    with np.load(jpath + '.npz') as a, np.load(tpath + '.npz') as b:
        assert sorted(a.files) == sorted(b.files) == sorted(tfm.tensors)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(tpath + '.bundle.json') as f:
        manifest = json.load(f)
    assert manifest['arch'] == tfm.arch and manifest['graph']


def test_manifest_multipliers_rebuild_the_engine_multipliers():
    """(m, e) of every requant edge gives m·2⁻ᵉ, the engine's float32
    multiplier of the same scale ratio."""
    _, fm = _frozen('tiny50-uniform4')
    nodes = {n['name']: n for n in texport.bundle_manifest(fm)['graph']}
    p = 'stage1.unit1'
    ratio = (fm[f'{p}.quant_convbn1.weight_scale'].astype(np.float32)
             * np.float32(fm.act_scale(f'{p}.quant_act'))
             / np.float32(fm.act_scale(f'{p}.quant_act1')))
    n = nodes[f'{p}.requant1']
    got = np.ldexp(np.float32(n['m']), -np.asarray(n['e'])).astype(
        np.float32)
    np.testing.assert_array_equal(got, np_dyadic_multiplier(ratio))


def test_protobuf_module_is_hawq_tpus():
    assert filecmp.cmp(
        os.path.join(REPO, 'hawq_tpu', 'export', 'onnx_subset_pb2.py'),
        os.path.join(REPO, 'hawq_tpu_torch', 'export', 'onnx_subset_pb2.py'),
        shallow=False)
