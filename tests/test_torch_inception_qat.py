"""The InceptionV3 QAT model of hawq_tpu_torch == hawq_tpu's, its freezer
and its trainer entry (the tables, synthetic weights and engine:
tests/test_torch_inception.py).

``QInceptionV3`` (width_div 16, 75²) with its variables carried into flax;
the port's model is the source, as flax's jitted init of this graph takes
most of a minute here:

* calibration ranges, quantizer integers and logits bit-equal, uniform8 and
  uniform4 tables (flax eager: under ``jax.jit`` XLA's CPU backend fuses the
  range EMA into one FMA);
* ``freeze_inceptionv3`` equal, and QAT eval logits, as integers, equal to
  the engine's on the frozen model, both input modes;
* a folded train step's gradients within rtol 1e-4 of flax's (dropout off;
  the float gradient convolutions sum in another order);
* dropout active only with a generator; the variables round trip;
* ``FloatInceptionV3`` within rtol 1e-4 of flax (1e-2 with batch
  statistics over a few values a channel), raw and folded input;
* the Trainer on ``tiny_inceptionv3``: it steps, freezes, and its frozen
  checkpoint serves logits equal as integers to the QAT eval logits.

Most of this file's time is flax's first eager forward (each primitive
compiled at first use) and the jitted gradient.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.configs.bit_config import get_bit_config as jget
from hawq_tpu.inference import engine_inception as jei
from hawq_tpu.inference import fold as jfold
from hawq_tpu.models import inceptionv3 as jm
from hawq_tpu.train import train as jtrain

from hawq_tpu_torch.configs.bit_config import get_bit_config as tget
from hawq_tpu_torch.inference import engine_inception as tei
from hawq_tpu_torch.models import inceptionv3 as tm
from hawq_tpu_torch.models.resnet import qat_from_numpy, qat_to_numpy
from hawq_tpu_torch.nn.layers import capture_q_int
from hawq_tpu_torch.train import train as ttrain
from hawq_tpu_torch.train import trainer as ttrainer
from hawq_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_inception import W, _x
from tests.test_torch_resnet_v2 import (_assert_frozen_equal, _flat,
                                        check_calibration)

torch.set_num_threads(1)

_cache = {}


def _calibrated(scheme, passes=3):
    """The port's model (seed 0) and its variables carried into the flax
    model, then ``passes`` calibration passes in both, the flax ones eager
    → (flax model, flax variables, port model, per-pass records)."""
    if scheme not in _cache:
        tmodel = tm.QInceptionV3(tget('inceptionv3', scheme), 10,
                                 width_div=W, seed=0)
        jmodel = jm.QInceptionV3(cfg=jget('inceptionv3', scheme),
                                 num_classes=10, width_div=W)
        v, x, records = qat_to_numpy(tmodel), _x(3), []
        for _ in range(passes):
            jlogits, mut = jmodel.apply(
                v, jnp.asarray(x), folded=True, update_stats=True,
                mutable=['quant_stats', 'batch_stats', 'intermediates'])
            v = {**v, 'quant_stats': jax.tree.map(np.asarray,
                                                  mut['quant_stats']),
                 'batch_stats': jax.tree.map(np.asarray,
                                             mut['batch_stats'])}
            with torch.no_grad(), capture_q_int(tmodel) as q:
                tlogits = tmodel(torch.from_numpy(x), folded=True,
                                 update_stats=True)
            records.append(dict(
                jq={'.'.join(p[:-1]): a[0] for p, a in _flat(jax.tree.map(
                    np.asarray, mut['intermediates']))},
                tq={k: t.numpy() for k, t in q.items()},
                jstats=dict(_flat(v['quant_stats'])),
                tstats=dict(_flat(qat_to_numpy(tmodel)['quant_stats'])),
                jlogits=np.asarray(jlogits), tlogits=tlogits.numpy()))
        _cache[scheme] = jmodel, v, tmodel, records
    return _cache[scheme]


@pytest.mark.parametrize('scheme', ['uniform8', 'uniform4'])
def test_calibration_ranges_integers_and_logits_bit_equal(scheme):
    check_calibration(_calibrated(scheme)[3], min_nodes=150)


@pytest.mark.parametrize('scheme', ['uniform8', 'uniform4'])
def test_freeze_equal_and_qat_engine_parity(scheme):
    _, jv, tmodel, _ = _calibrated(scheme)
    tfm = tei.freeze_inceptionv3(qat_to_numpy(tmodel),
                                 tget('inceptionv3', scheme), 10, W)
    _assert_frozen_equal(tfm, jei.freeze_inceptionv3(
        jv, jget('inceptionv3', scheme), 10, W))
    x = _x(3)
    with torch.no_grad():
        qat = tmodel(torch.from_numpy(x), folded=True,
                     update_stats=False).numpy()
    s = (tfm['output.q_fc.weight_scale'].astype(np.float64)
         * np.float64(tfm.act_scale('features.q_concat_activ')))
    for mode, images in (('float32', x),
                         ('folded_float32', jfold.fold4_images_3x3s2(x, 0))):
        eng = tei.build_inceptionv3_engine(tfm, input_mode=mode,
                                           input_hw=(75, 75),
                                           device='cpu')(images).numpy()
        np.testing.assert_array_equal(np.round(qat / s), np.round(eng / s))
    assert np.isfinite(qat).all() and qat.shape == (2, 10)
    assert len(np.unique(np.round(qat / s))) > 4


def test_train_step_gradients():
    """One folded train step from the calibrated state, dropout off in both
    models: loss within 1e-6, gradients within rtol 1e-4 with a floor of
    1e-6 × the largest leaf value.  (Not the unfolded step: at 75² the last
    stage's batch statistics are over two values a channel, and flax's own
    gradients reach 1e24 there, so two float orders of summation give
    unrelated last digits.)"""
    _, jv, _, _ = _calibrated('uniform8')
    jmodel = jm.QInceptionV3(cfg=jget('inceptionv3', 'uniform8'),
                             num_classes=10, width_div=W, dropout_rate=0.0)
    model = qat_from_numpy(tm.QInceptionV3(
        tget('inceptionv3', 'uniform8'), 10, width_div=W, dropout_rate=0.0),
        jv)
    rng = np.random.RandomState(5)
    batch = {'image': _x(6), 'label': rng.randint(0, 10, (2,))}
    jb = {k: jnp.asarray(a) for k, a in batch.items()}

    def loss_fn(params):
        logits, _ = jmodel.apply(
            {**jv, 'params': params}, jb['image'], folded=True,
            update_stats=True, mutable=['quant_stats', 'batch_stats'])
        return jtrain.cross_entropy(logits, jb['label'])
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, jv['params']))
    state = ttrain.TrainState.create(model,
                                     ttrain.sgd_with_step_decay(model, 1e-2))
    _, metrics = ttrain.make_train_step(model, folded=True)(
        state, {k: torch.from_numpy(a) for k, a in batch.items()})
    np.testing.assert_allclose(metrics['loss'], jloss, rtol=1e-6)
    grads = {tuple(n.split('.')): p.grad.numpy()
             for n, p in model.named_parameters()}
    jflat = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    assert sorted(jflat) == sorted(grads)
    floor = 1e-6 * max(float(np.abs(g).max()) for g in jflat.values())
    for path, want in jflat.items():
        np.testing.assert_allclose(grads[path], want, rtol=1e-4,
                                   atol=max(floor, 1e-6), err_msg=str(path))


def test_dropout_only_with_a_generator():
    _, jv, tmodel, _ = _calibrated('uniform8')
    x = torch.from_numpy(_x(7))
    with torch.no_grad():
        base = tmodel(x, folded=True)
        assert torch.equal(tmodel(x, folded=True), base)
        gen = lambda: torch.Generator().manual_seed(11)
        dropped = tmodel(x, folded=True, generator=gen())
        assert not torch.equal(dropped, base)
        assert torch.equal(tmodel(x, folded=True, generator=gen()), dropped)
    assert tmodel.q_dropout.rate == 0.5


def test_variables_round_trip():
    _, jv, tmodel, _ = _calibrated('uniform8')
    tv = qat_to_numpy(tmodel)
    assert sorted(p for p, _ in _flat(tv)) == sorted(p for p, _ in _flat(jv))
    again = qat_from_numpy(tm.QInceptionV3(tget('inceptionv3', 'uniform8'),
                                           10, width_div=W, seed=5), tv)
    for (p, a), (q, b) in zip(_flat(qat_to_numpy(again)), _flat(tv)):
        assert p == q
        np.testing.assert_array_equal(a, b, err_msg=str(p))


@pytest.mark.parametrize('folded_input', [False, True])
def test_float_inception_matches(folded_input):
    """The fp32 twin against flax on the same variables, eval and train
    mode: float32 sums in another order, so within rtol 1e-4; with batch
    statistics 1e-2, as the last stages normalize over 2–18 values a
    channel at 75², which amplifies the sums' last-digit differences (a
    near-equal pair's difference, divided by itself)."""
    x = _x(1)
    if folded_input:
        x = jfold.fold4_images_3x3s2(x, 0)
    tmodel = tm.FloatInceptionV3(10, width_div=W, folded_input=folded_input,
                                 input_hw=(75, 75), seed=2)
    v = qat_to_numpy(tmodel)
    v = {k: v[k] for k in ('params', 'batch_stats')}
    jmodel = jm.FloatInceptionV3(num_classes=10, width_div=W,
                                 folded_input=folded_input,
                                 input_hw=(75, 75))
    want = np.asarray(jax.jit(jmodel.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=['batch_stats'])[0])(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), train=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


def test_trainer_builds_steps_freezes_and_serves(tmp_path):
    model, bit_cfg = ttrainer.build_model(ttrainer.TrainerConfig(
        arch='inceptionv3', scheme='uniform4', num_classes=10))
    assert isinstance(model, tm.QInceptionV3) and model.width_div == 1
    assert bit_cfg.act_bits('features.stage1.unit1.q_rescaling_activ') == 16
    cfg = ttrainer.TrainerConfig(
        arch='tiny_inceptionv3', device='cpu', steps_per_epoch=2, epochs=1,
        batch_size=2, image_size=75, num_classes=10, fix_bn_threshold=1,
        calib_batches=1, eval_batches=1, save_path=str(tmp_path))
    tr = ttrainer.Trainer(cfg)
    assert 0.0 <= tr.run() <= 1.0
    fm = tckpt.load_frozen(str(tmp_path / 'quantized_checkpoint.npz'))
    assert fm.arch == 'inceptionv3' and tei.width_div_from_frozen(fm) == W
    x = _x(8)
    with torch.no_grad():
        qat = tr.model(torch.from_numpy(x), folded=True,
                       update_stats=False).numpy()
    eng = tei.build_inceptionv3_engine(fm, input_hw=(75, 75),
                                       device='cpu')(x).numpy()
    s = (fm['output.q_fc.weight_scale'].astype(np.float64)
         * np.float64(fm.act_scale('features.q_concat_activ')))
    np.testing.assert_array_equal(np.round(qat / s), np.round(eng / s))
