"""MobileNetV2 of hawq_tpu_torch == hawq_tpu's: the host fold of the
3×3/s2 init, the integer engine, the synthetic weights, the QAT model, its
freezer and its trainer entry.

* ``build_mobilenetv2_engine`` (CPU: the kernels' plain versions, D1's
  among them) equals the reference engine bit for bit on the logits and on
  every capture node: the tiny variant × uniform 8- / 4-bit weights ×
  float32 / folded_float32 input × int32 / int16 carrier.
* ``QMobileNetV2`` with the flax variables carried across: calibration
  ranges, quantizer integers and logits bit-equal (flax eager, as in
  tests/test_torch_resnet_v2.py), train-step gradients within rtol 1e-4,
  ``freeze_mobilenetv2`` equal, and QAT eval logits, as integers, equal to
  the engine's on the frozen model (native requant).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.configs.bit_config import BitConfig as JBitConfig
from hawq_tpu.configs.bit_config import QuantSettings as JQuantSettings
from hawq_tpu.configs.bit_config import get_bit_config as jget
from hawq_tpu.inference import fold as jfold
from hawq_tpu.inference.engine_mobilenet import \
    build_mobilenetv2_engine as jax_engine
from hawq_tpu.inference.freeze import freeze_mobilenetv2 as jfreeze
from hawq_tpu.inference.synthetic import synthetic_frozen_mobilenet as jsyn
from hawq_tpu.models import mobilenetv2 as jm

from hawq_tpu_torch.configs.bit_config import (BitConfig, QuantSettings,
                                               get_bit_config as tget)
from hawq_tpu_torch.inference import fold as tfold
from hawq_tpu_torch.inference.engine_mobilenet import (
    build_mobilenetv2_engine, stages_from_frozen)
from hawq_tpu_torch.inference.freeze import freeze_mobilenetv2
from hawq_tpu_torch.inference.synthetic import synthetic_frozen_mobilenet
from hawq_tpu_torch.models import mobilenetv2 as tm
from hawq_tpu_torch.models.resnet import qat_from_numpy, qat_to_numpy
from hawq_tpu_torch.train import trainer as ttrainer
from hawq_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_engine import _port_fm, _reference_nodes
from tests.test_torch_resnet_v2 import (_assert_frozen_equal, _batch, _flat,
                                        _x, calibrate_both, check_calibration,
                                        check_train_step_gradients)

torch.set_num_threads(1)

_TINY = dict(stages=tm.TINY_MNV2_STAGES, init_ch=tm.TINY_MNV2_INIT_CH,
             final_ch=tm.TINY_MNV2_FINAL_CH)
_cache = {}


def _cfgs(scheme):
    """(reference, port) configs: the tiny variant's uniform 8-bit table, or
    the full model's uniform4 table (its keys cover the tiny units)."""
    if scheme == 'uniform8':
        return (JBitConfig(name='tiny_mnv2_u8', table={},
                           settings=JQuantSettings()),
                BitConfig(name='tiny_mnv2_u8', table={},
                          settings=QuantSettings()))
    return jget('mobilenetv2_w1', scheme), tget('mobilenetv2_w1', scheme)


def test_tables_equal():
    assert tm.MOBILENETV2_STAGES == tuple(map(tuple, jm.MOBILENETV2_STAGES))
    assert tm.TINY_MNV2_STAGES == tuple(map(tuple, jm.TINY_MNV2_STAGES))
    assert (tm.MOBILENETV2_INIT_CH, tm.MOBILENETV2_FINAL_CH,
            tm.TINY_MNV2_INIT_CH, tm.TINY_MNV2_FINAL_CH) == (
        jm.MOBILENETV2_INIT_CH, jm.MOBILENETV2_FINAL_CH,
        jm.TINY_MNV2_INIT_CH, jm.TINY_MNV2_FINAL_CH)


@pytest.mark.parametrize('size', [32, 30, 224, 17])
def test_fold_3x3s2_equal(size):
    rng = np.random.RandomState(size)
    for p0 in (0, 1):
        assert (tfold.fold4_3x3s2_geometry(size, p0)
                == jfold.fold4_3x3s2_geometry(size, p0))
    x = rng.randn(2, size, size + 2, 3).astype(np.float32)
    for p0 in (0, 1):
        np.testing.assert_array_equal(tfold.fold4_images_3x3s2(x, p0),
                                      jfold.fold4_images_3x3s2(x, p0))
    w = rng.randint(-127, 128, (3, 3, 3, 8)).astype(np.int8)
    np.testing.assert_array_equal(tfold.fold4_kernel_3x3s2(w),
                                  jfold.fold4_kernel_3x3s2(w))
    acc = rng.randint(-9, 9, (2, 5, 6, 32)).astype(np.int32)
    np.testing.assert_array_equal(
        tfold.depth_to_space_2x2(torch.from_numpy(acc)).numpy(),
        jfold.depth_to_space_2x2(acc))


@pytest.mark.parametrize('scheme', ['uniform8', 'uniform4'])
def test_synthetic_equal(scheme):
    jcfg, tcfg = _cfgs(scheme)
    _assert_frozen_equal(
        synthetic_frozen_mobilenet(tcfg, num_classes=10, seed=0, **_TINY),
        jsyn(jcfg, num_classes=10, seed=0, **_TINY))
    full = synthetic_frozen_mobilenet(tget('mobilenetv2_w1', scheme), seed=0)
    _assert_frozen_equal(full, jsyn(jget('mobilenetv2_w1', scheme), seed=0))
    assert stages_from_frozen(full) == tm.MOBILENETV2_STAGES


_GRID = [(scheme, mode, rd) for scheme in ('uniform8', 'uniform4')
         for mode in ('float32', 'folded_float32')
         for rd in ('int32', 'int16')]


@pytest.mark.parametrize('scheme,input_mode,residual', _GRID)
def test_engine_matches_reference(scheme, input_mode, residual):
    fm = jsyn(_cfgs(scheme)[0], num_classes=10, seed=1, **_TINY)
    x = _x(2)
    if input_mode == 'folded_float32':
        x = jfold.fold4_images_3x3s2(x, 1)
    jkw = dict(input_mode=input_mode, input_hw=(32, 32),
               residual_dtype=getattr(jnp, residual))
    tkw = dict(input_mode=input_mode, input_hw=(32, 32),
               residual_dtype=getattr(torch, residual), device='cpu')

    want = np.asarray(jax_engine(fm, jm.TINY_MNV2_STAGES, **jkw)(
        jnp.asarray(x)))
    got = build_mobilenetv2_engine(_port_fm(fm), **tkw)(x).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got, want)

    nodes = _reference_nodes(
        fm, x, build=lambda fm, **kw: jax_engine(fm, jm.TINY_MNV2_STAGES,
                                                 **kw), **jkw)
    assert len(np.unique(nodes['init'])) > 16      # a non-degenerate input
    assert len(nodes) == 4 + 3 * 3                 # 3 units, 3 nodes each
    for node, ref in nodes.items():
        port = build_mobilenetv2_engine(_port_fm(fm), capture=node,
                                        **tkw)(x).numpy()
        assert port.dtype == ref.dtype, node
        np.testing.assert_array_equal(port, ref, err_msg=node)


def test_folded_init_equals_direct_and_checks():
    fm = synthetic_frozen_mobilenet(_cfgs('uniform8')[1], num_classes=10,
                                    seed=3, **_TINY)
    x = _x(5)
    direct = build_mobilenetv2_engine(fm, device='cpu')(x)
    folded = build_mobilenetv2_engine(fm, input_mode='folded_float32',
                                      input_hw=(32, 32), device='cpu')
    assert torch.equal(folded(tfold.fold4_images_3x3s2(x, 1)), direct)
    with pytest.raises(ValueError):           # folded for another size
        folded(tfold.fold4_images_3x3s2(_x(5)[:, :24, :24], 1))
    with pytest.raises(ValueError):
        build_mobilenetv2_engine(fm, input_mode='uint8', device='cpu')
    with pytest.raises(ValueError):
        build_mobilenetv2_engine(fm, residual_dtype=torch.int8, device='cpu')
    with pytest.raises(TypeError):            # the TPU layout options
        build_mobilenetv2_engine(fm, conv_mode='f32', device='cpu')


# ---------------------------------------------------------------------------
# the QAT model
# ---------------------------------------------------------------------------

def _calibrated(scheme):
    if scheme not in _cache:
        jcfg, tcfg = _cfgs(scheme)
        jmodel = jm.QMobileNetV2(cfg=jcfg, num_classes=10, **_TINY)
        _cache[scheme] = (jmodel,) + calibrate_both(
            jmodel, lambda v: qat_from_numpy(tm.QMobileNetV2(
                tcfg, 10, **_TINY), v), _x(3))
    return _cache[scheme]


@pytest.mark.parametrize('scheme', ['uniform8', 'uniform4'])
def test_calibration_ranges_integers_and_logits_bit_equal(scheme):
    check_calibration(_calibrated(scheme)[3], min_nodes=15)


@pytest.mark.parametrize('scheme', ['uniform8', 'uniform4'])
def test_freeze_equal_and_qat_engine_parity(scheme):
    _, jv, tmodel, _ = _calibrated(scheme)
    jcfg, tcfg = _cfgs(scheme)
    tfm = freeze_mobilenetv2(qat_to_numpy(tmodel), tcfg,
                             tm.TINY_MNV2_STAGES, 10)
    _assert_frozen_equal(tfm, jfreeze(jv, jcfg, jm.TINY_MNV2_STAGES, 10))
    x = _x(3)
    with torch.no_grad():
        qat = tmodel(torch.from_numpy(x), folded=True,
                     update_stats=False).numpy()
    s = (tfm['output.weight_scale'].astype(np.float64)
         * np.float64(tfm.act_scale('quant_act_output')))
    for mode, images in (('float32', x),
                         ('folded_float32', tfold.fold4_images_3x3s2(x, 1))):
        eng = build_mobilenetv2_engine(tfm, input_mode=mode,
                                       input_hw=(32, 32),
                                       device='cpu')(images).numpy()
        np.testing.assert_array_equal(np.round(qat / s), np.round(eng / s))
    assert np.isfinite(qat).all() and qat.shape == (2, 10)


@pytest.mark.parametrize('folded', [True, False])
def test_train_step_gradients(folded):
    jmodel, jv, _, _ = _calibrated('uniform8')
    model = qat_from_numpy(tm.QMobileNetV2(_cfgs('uniform8')[1], 10,
                                           **_TINY), jv)
    check_train_step_gradients(jmodel, jv, model, _batch(6), folded)


def test_variables_round_trip():
    _, jv, tmodel, _ = _calibrated('uniform8')
    tv = qat_to_numpy(tmodel)
    assert sorted(p for p, _ in _flat(tv)) == sorted(p for p, _ in _flat(jv))


def test_float_mobilenet_matches():
    x = _x(1)
    jmodel = jm.FloatMobileNetV2(num_classes=10, **_TINY)
    v = jax.tree.map(np.asarray, dict(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(x))))
    tmodel = qat_from_numpy(tm.FloatMobileNetV2(10, **_TINY), v)
    want = np.asarray(jax.jit(jmodel.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=['batch_stats'])[0])(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), train=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_trainer_builds_and_freezes_mobilenet(tmp_path):
    model, bit_cfg = ttrainer.build_model(ttrainer.TrainerConfig(
        arch='mobilenetv2_w1', scheme='uniform4', num_classes=10))
    assert isinstance(model, tm.QMobileNetV2)
    assert model.stages == tm.MOBILENETV2_STAGES
    assert bit_cfg.weight_bits('features.stage2.unit1.conv2') == 4
    cfg = ttrainer.TrainerConfig(
        arch='tiny_mnv2', device='cpu', steps_per_epoch=2, epochs=1,
        batch_size=2, image_size=32, num_classes=10, fix_bn_threshold=1,
        calib_batches=1, eval_batches=1, save_path=str(tmp_path))
    tr = ttrainer.Trainer(cfg)
    assert 0.0 <= tr.run() <= 1.0
    fm = tckpt.load_frozen(str(tmp_path / 'quantized_checkpoint.npz'))
    assert stages_from_frozen(fm) == tm.TINY_MNV2_STAGES
    x = _x(8)
    with torch.no_grad():
        qat = tr.model(torch.from_numpy(x), folded=True,
                       update_stats=False).numpy()
    eng = build_mobilenetv2_engine(fm, input_hw=(32, 32),
                                   device='cpu')(x).numpy()
    s = (fm['output.weight_scale'].astype(np.float64)
         * np.float64(fm.act_scale('quant_act_output')))
    np.testing.assert_array_equal(np.round(qat / s), np.round(eng / s))


def test_batcher_serves_the_mobilenet_engine():
    """The DynamicBatcher over the folded MobileNetV2 engine: each answer
    equals its row of a batched call."""
    from hawq_tpu_torch.parallel.serving import DynamicBatcher
    fm = synthetic_frozen_mobilenet(_cfgs('uniform8')[1], num_classes=10,
                                    seed=4, **_TINY)
    engine = build_mobilenetv2_engine(fm, input_mode='folded_float32',
                                      input_hw=(32, 32),
                                      residual_dtype=torch.int16,
                                      device='cpu')

    def fold(b):
        return tfold.fold4_images_3x3s2(b, 1)
    imgs = _x(6, n=5)
    batcher = DynamicBatcher(engine, 4, (32, 32, 3), max_delay_ms=20,
                             host_transform=fold, device='cpu')
    try:
        answers = np.stack([s.get(timeout=60) for s in
                            [batcher.submit(im) for im in imgs]])
    finally:
        batcher.close()
    padded = np.concatenate([imgs, np.zeros((3, 32, 32, 3), np.float32)])
    want = np.concatenate([engine(fold(padded[i:i + 4])).numpy()
                           for i in (0, 4)])[:5]
    np.testing.assert_array_equal(answers, want)
