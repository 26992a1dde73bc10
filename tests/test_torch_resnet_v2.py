"""Pre-activation ResNet v2 of hawq_tpu_torch == hawq_tpu's: the integer
engine, the synthetic weights, the QAT model, its freezer and its trainer
entry.

* ``build_resnet_v2_engine`` (CPU, the kernels' plain versions) equals the
  reference engine bit for bit on the logits and on every capture node, on
  synthetic frozen models carried across as numpy, with uniform 8- and
  4-bit weights (4-bit weights stay int8 containers on both sides), and
  with an init accumulator above 2²⁴ going into the max-pool, which the
  port pools exactly in int32.
* ``QResNetV2`` with the flax variables carried across: three calibration
  passes give bit-equal ranges, quantizer integers and logits (the flax
  passes run eagerly: under ``jax.jit`` XLA's CPU backend fuses the range
  EMA into one FMA); a folded train step's gradients within rtol 1e-4 of
  the flax ones (the float gradient convolutions sum in another order);
  ``freeze_resnet_v2`` gives equal tensors; QAT eval logits, as integers,
  equal the engine's on the frozen model.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.configs.bit_config import get_bit_config as jget
from hawq_tpu.inference.engine import _maxpool_int
from hawq_tpu.inference.engine_v2 import build_resnet_v2_engine as jax_engine
from hawq_tpu.inference.engine_v2 import freeze_resnet_v2 as jfreeze
from hawq_tpu.inference.synthetic import (synthetic_frozen_resnet as jsyn_v1,
                                          synthetic_frozen_resnet_v2 as jsyn)
from hawq_tpu.models.resnet_v2 import QResNetV2 as JQResNetV2
from hawq_tpu.train import train as jtrain

from hawq_tpu_torch.configs.bit_config import get_bit_config as tget
from hawq_tpu_torch.inference import synthetic as tsyn
from hawq_tpu_torch.inference.engine import maxpool_int
from hawq_tpu_torch.inference.engine_v2 import (build_resnet_v2_engine,
                                                freeze_resnet_v2)
from hawq_tpu_torch.models.resnet import qat_from_numpy, qat_to_numpy
from hawq_tpu_torch.models.resnet_v2 import QResNetV2
from hawq_tpu_torch.nn.layers import capture_q_int
from hawq_tpu_torch.train import train as ttrain
from hawq_tpu_torch.train import trainer as ttrainer
from hawq_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_engine import _port_fm, _reference_nodes

torch.set_num_threads(1)

_CASES = [('tiny18v2', 'uniform8'), ('tiny50v2', 'uniform8'),
          ('tiny50v2', 'uniform4')]
_cache = {}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _x(seed=0, n=2):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def _assert_frozen_equal(tfm, jfm):
    assert sorted(tfm.tensors) == sorted(jfm.tensors)
    for k, want in jfm.tensors.items():
        assert np.asarray(tfm[k]).dtype == np.asarray(want).dtype, k
        np.testing.assert_array_equal(tfm[k], want, err_msg=k)


# ---------------------------------------------------------------------------
# synthetic weights and the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('arch', ['tiny18v2', 'resnet50v2'])
def test_synthetic_equal(arch):
    cfg = jget(arch, 'uniform4')
    _assert_frozen_equal(tsyn.synthetic_frozen_resnet_v2(arch, tget(
        arch, 'uniform4'), num_classes=10, seed=0),
        jsyn(arch, cfg, num_classes=10, seed=0))
    base = arch[:-2]
    _assert_frozen_equal(tsyn.synthetic_frozen_resnet(base, tget(
        base, 'uniform8'), num_classes=10, seed=0),
        jsyn_v1(base, jget(base, 'uniform8'), num_classes=10, seed=0))


@pytest.mark.parametrize('arch', ['tiny18v2', 'tiny50v2'])
@pytest.mark.parametrize('scheme', ['uniform8', 'uniform4'])
def test_engine_matches_reference(arch, scheme):
    fm = jsyn(arch, jget(arch, scheme), num_classes=10, seed=1)
    x = _x(2)
    want = np.asarray(jax_engine(fm)(jnp.asarray(x)))
    got = build_resnet_v2_engine(_port_fm(fm), device='cpu')(x).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got, want)

    nodes = _reference_nodes(fm, x, build=jax_engine)
    assert len(np.unique(nodes['init'])) > 16      # a non-degenerate input
    assert len(nodes) == 3 + 3 * 3                 # 3 units, 3 nodes each
    for node, ref in nodes.items():
        port = build_resnet_v2_engine(_port_fm(fm), capture=node,
                                      device='cpu')(x).numpy()
        assert port.dtype == ref.dtype, node
        np.testing.assert_array_equal(port, ref, err_msg=node)


def test_pool_of_accumulators_beyond_2_24():
    """The init accumulator above 2²⁴ into the max-pool: pooled exactly in
    int32, as the reference pools; a float32 pool would round these."""
    rng = np.random.RandomState(3)
    acc = (2 ** 25 + rng.randint(0, 64, (2, 9, 11, 8))).astype(np.int32)
    want = np.asarray(_maxpool_int(jnp.asarray(acc), (3, 3), (2, 2),
                                   ((1, 1), (1, 1))))
    got = maxpool_int(torch.from_numpy(acc)).numpy()
    np.testing.assert_array_equal(got, want)
    rounded = torch.nn.functional.max_pool2d(
        torch.from_numpy(acc).permute(0, 3, 1, 2).float(), 3, 2, 1)
    assert not np.array_equal(
        rounded.permute(0, 2, 3, 1).to(torch.int32).numpy(), want)

    # end to end: an init bias of 2²⁵ puts every accumulator above 2²⁴
    fm = jsyn('tiny18v2', jget('tiny18v2', 'uniform8'), num_classes=10,
              seed=2)
    fm.tensors['quant_init_conv.bias_int'] = (
        2 ** 25 + rng.randint(0, 2 ** 10, 16)).astype(np.int32)
    fm.tensors['quant_act_int32.act_scale'] = np.float32(
        fm.tensors['quant_act_int32.act_scale'] * 300)
    x = _x(4)
    for node in ('init', 'stage1.unit1.pre', None):
        want = np.asarray(jax_engine(fm, capture=node)(jnp.asarray(x)))
        got = build_resnet_v2_engine(_port_fm(fm), capture=node,
                                     device='cpu')(x).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(node))
    assert len(np.unique(want)) > 4


def test_engine_rejects_other_inputs():
    fm = _port_fm(jsyn('tiny18v2', jget('tiny18v2', 'uniform8'),
                       num_classes=10))
    eng = build_resnet_v2_engine(fm, device='cpu')
    with pytest.raises(ValueError):
        eng(np.zeros((1, 32, 32, 3), np.uint8))
    with pytest.raises(KeyError):
        build_resnet_v2_engine(fm, capture='stage9.unit1.pre',
                               device='cpu')(np.zeros((1, 32, 32, 3),
                                                      np.float32))


# ---------------------------------------------------------------------------
# the QAT model
# ---------------------------------------------------------------------------

def calibrate_both(jmodel, tmodel_of, x, passes=3):
    """The flax model initialized (jitted), its variables carried into the
    port's model (``tmodel_of(variables)``), then ``passes`` calibration
    passes in both, eager → (jax variables, torch model, per-pass
    records)."""
    v = jax.jit(lambda k, x: jmodel.init(k, x, folded=True,
                                         update_stats=True))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree.map(np.asarray, dict(v))
    tmodel = tmodel_of(v)
    records = []
    for _ in range(passes):
        jlogits, mut = jmodel.apply(
            v, jnp.asarray(x), folded=True, update_stats=True,
            mutable=['quant_stats', 'batch_stats', 'intermediates'])
        v = {**v, 'quant_stats': mut['quant_stats'],
             'batch_stats': mut['batch_stats']}
        with torch.no_grad(), capture_q_int(tmodel) as q:
            tlogits = tmodel(torch.from_numpy(x), folded=True,
                             update_stats=True)
        records.append(dict(
            jq={'.'.join(p[:-1]): a[0] for p, a in _flat(jax.tree.map(
                np.asarray, mut['intermediates']))},
            tq={k: t.numpy() for k, t in q.items()},
            jstats=dict(_flat(jax.tree.map(np.asarray, mut['quant_stats']))),
            tstats=dict(_flat(qat_to_numpy(tmodel)['quant_stats'])),
            jlogits=np.asarray(jlogits), tlogits=tlogits.numpy()))
    return jax.tree.map(np.asarray, v), tmodel, records


def check_calibration(records, min_nodes):
    for i, r in enumerate(records):
        assert sorted(r['tstats']) == sorted(r['jstats'])
        for k, want in r['jstats'].items():
            np.testing.assert_array_equal(r['tstats'][k], want,
                                          err_msg=f'pass {i} {k}')
        assert sorted(r['tq']) == sorted(r['jq'])
        assert len(r['tq']) >= min_nodes
        for k, want in r['jq'].items():
            np.testing.assert_array_equal(r['tq'][k], want,
                                          err_msg=f'pass {i} q_int {k}')
        np.testing.assert_array_equal(r['tlogits'], r['jlogits'])


def check_train_step_gradients(jmodel, v, model, batch, folded):
    """One train step from the same state: loss within 1e-6 (1e-4
    unfolded: batch statistics), gradients within rtol 1e-4 with a floor of
    1e-6 × the largest leaf value."""
    jb = {k: jnp.asarray(a) for k, a in batch.items()}

    def loss_fn(params):
        logits, _ = jmodel.apply(
            {**v, 'params': params}, jb['image'], folded=folded,
            update_stats=True, mutable=['quant_stats', 'batch_stats'])
        return jtrain.cross_entropy(logits, jb['label'])
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, v['params']))
    state = ttrain.TrainState.create(model,
                                     ttrain.sgd_with_step_decay(model, 1e-2))
    _, metrics = ttrain.make_train_step(model, folded=folded)(
        state, {k: torch.from_numpy(a) for k, a in batch.items()})
    np.testing.assert_allclose(metrics['loss'], jloss,
                               rtol=1e-6 if folded else 1e-4)
    grads = {tuple(n.split('.')): p.grad.numpy()
             for n, p in model.named_parameters()}
    jflat = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    assert sorted(jflat) == sorted(grads)
    floor = 1e-6 * max(float(np.abs(g).max()) for g in jflat.values())
    for path, want in jflat.items():
        np.testing.assert_allclose(grads[path], want, rtol=1e-4,
                                   atol=max(floor, 1e-6), err_msg=str(path))


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {'image': rng.randn(2, 32, 32, 3).astype(np.float32),
            'label': rng.randint(0, 10, (2,))}


def _calibrated(arch, scheme):
    if (arch, scheme) not in _cache:
        jmodel = JQResNetV2(arch=arch, cfg=jget(arch, scheme), num_classes=10)
        _cache[arch, scheme] = (jmodel,) + calibrate_both(
            jmodel, lambda v: qat_from_numpy(QResNetV2(
                arch, tget(arch, scheme), 10), v), _x(0))
    return _cache[arch, scheme]


@pytest.mark.parametrize('arch,scheme', _CASES)
def test_calibration_ranges_integers_and_logits_bit_equal(arch, scheme):
    check_calibration(_calibrated(arch, scheme)[3], min_nodes=10)


@pytest.mark.parametrize('arch,scheme', _CASES)
def test_freeze_equal_and_qat_engine_parity(arch, scheme):
    _, jv, tmodel, _ = _calibrated(arch, scheme)
    tfm = freeze_resnet_v2(qat_to_numpy(tmodel), arch, tget(arch, scheme), 10)
    _assert_frozen_equal(tfm, jfreeze(jv, arch, jget(arch, scheme), 10))
    x = _x(0)
    with torch.no_grad():
        qat = tmodel(torch.from_numpy(x), folded=True,
                     update_stats=False).numpy()
    eng = build_resnet_v2_engine(tfm, device='cpu')(x).numpy()
    s = (tfm['quant_output.weight_scale'].astype(np.float64)
         * np.float64(tfm.act_scale('quant_act_output')))
    np.testing.assert_array_equal(np.round(qat / s), np.round(eng / s))
    assert np.isfinite(qat).all() and qat.shape == (2, 10)


@pytest.mark.parametrize('folded', [True, False])
def test_train_step_gradients(folded):
    jmodel, jv, _, _ = _calibrated('tiny50v2', 'uniform8')
    model = qat_from_numpy(QResNetV2('tiny50v2', tget('tiny50v2', 'uniform8'),
                                     10), jv)
    check_train_step_gradients(jmodel, jv, model, _batch(5), folded)


def test_variables_round_trip():
    _, jv, tmodel, _ = _calibrated('tiny50v2', 'uniform8')
    tv = qat_to_numpy(tmodel)
    assert sorted(p for p, _ in _flat(tv)) == sorted(p for p, _ in _flat(jv))


def test_trainer_builds_and_freezes_v2(tmp_path):
    for arch in ('resnet50v2', 'tiny50v2'):
        model, bit_cfg = ttrainer.build_model(ttrainer.TrainerConfig(
            arch=arch, num_classes=10))
        assert isinstance(model, QResNetV2) and bit_cfg.name.startswith(arch)
    cfg = ttrainer.TrainerConfig(
        arch='tiny18v2', device='cpu', steps_per_epoch=2, epochs=1,
        batch_size=2, image_size=32, num_classes=10, fix_bn_threshold=1,
        calib_batches=1, eval_batches=1, save_path=str(tmp_path))
    tr = ttrainer.Trainer(cfg)
    assert 0.0 <= tr.run() <= 1.0
    fm = tckpt.load_frozen(str(tmp_path / 'quantized_checkpoint.npz'))
    assert fm.arch == 'tiny18v2'
    assert 'stage1.unit1.quant_bn.bn_factor' in fm.tensors
    x = _x(8)
    with torch.no_grad():
        qat = tr.model(torch.from_numpy(x), folded=True,
                       update_stats=False).numpy()
    eng = build_resnet_v2_engine(fm, device='cpu')(x).numpy()
    s = (fm['quant_output.weight_scale'].astype(np.float64)
         * np.float64(fm.act_scale('quant_act_output')))
    np.testing.assert_array_equal(np.round(qat / s), np.round(eng / s))
