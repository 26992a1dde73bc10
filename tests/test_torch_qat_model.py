"""The QAT ResNet of hawq_tpu_torch == hawq_tpu's, as a whole: calibration,
freeze, and the port's own QAT ↔ engine contract.

Each case initializes the flax model, carries its variables across with
``qat_from_numpy`` and runs three calibration passes in both packages:
every activation range, every quantizer's integer tensor and the logits are
bit-equal (tolerance 0).  Then ``freeze_resnet`` of both packages gives the
same tensors key by key, and the port's QAT eval logits, as integers, equal
its integer engine's.

The flax passes run eagerly (only ``init`` is jitted): under ``jax.jit``
XLA's CPU backend fuses the range EMA's multiply and add into one FMA, which
rounds once where the written op order rounds twice.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.configs.bit_config import get_bit_config as jget
from hawq_tpu.inference.freeze import freeze_resnet as jfreeze
from hawq_tpu.models.resnet import FloatResNet as JFloatResNet
from hawq_tpu.models.resnet import QResNet as JQResNet

from hawq_tpu_torch.configs.bit_config import get_bit_config as tget
from hawq_tpu_torch.inference.engine import build_resnet_engine
from hawq_tpu_torch.inference.freeze import freeze_resnet as tfreeze
from hawq_tpu_torch.models.resnet import (FloatResNet, QResNet,
                                          qat_from_numpy, qat_to_numpy)
from hawq_tpu_torch.nn.layers import capture_q_int

torch.set_num_threads(1)

_CASES = [('tiny18', 'uniform8'), ('tiny18', 'uniform4'),
          ('tiny50', 'uniform8'), ('tiny50', 'uniform4'),
          ('resnet20_cifar', 'uniform8')]
_cache = {}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _calibrated(arch, scheme):
    """Both models after three calibration passes on one batch, with what
    each pass produced: (jax variables, torch model, x, per-pass records)."""
    key = (arch, scheme)
    if key in _cache:
        return _cache[key]
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    jmodel = JQResNet(arch=arch, cfg=jget(arch, scheme), num_classes=10)
    v = jax.jit(lambda k, x: jmodel.init(k, x, folded=True,
                                         update_stats=True))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree.map(np.asarray, dict(v))
    tmodel = qat_from_numpy(QResNet(arch, tget(arch, scheme), 10), v)
    passes = []
    for _ in range(3):
        jlogits, mut = jmodel.apply(
            v, jnp.asarray(x), folded=True, update_stats=True,
            mutable=['quant_stats', 'batch_stats', 'intermediates'])
        v = {**v, 'quant_stats': mut['quant_stats'],
             'batch_stats': mut['batch_stats']}
        with torch.no_grad(), capture_q_int(tmodel) as q:
            tlogits = tmodel(torch.from_numpy(x), folded=True,
                             update_stats=True)
        passes.append(dict(
            jq={'.'.join(p[:-1]): a[0] for p, a in _flat(jax.tree.map(
                np.asarray, mut['intermediates']))},
            tq={k: t.numpy() for k, t in q.items()},
            jstats=dict(_flat(jax.tree.map(np.asarray, mut['quant_stats']))),
            tstats=dict(_flat(qat_to_numpy(tmodel)['quant_stats'])),
            jlogits=np.asarray(jlogits), tlogits=tlogits.numpy()))
    _cache[key] = (jax.tree.map(np.asarray, v), tmodel, x, passes)
    return _cache[key]


@pytest.mark.parametrize('arch,scheme', _CASES)
def test_calibration_ranges_integers_and_logits_bit_equal(arch, scheme):
    _, _, _, passes = _calibrated(arch, scheme)
    for i, p in enumerate(passes):
        assert sorted(p['tstats']) == sorted(p['jstats'])
        for k, want in p['jstats'].items():
            np.testing.assert_array_equal(p['tstats'][k], want,
                                          err_msg=f'pass {i} {k}')
        assert sorted(p['tq']) == sorted(p['jq']) and len(p['tq']) > 10
        for k, want in p['jq'].items():
            np.testing.assert_array_equal(p['tq'][k], want,
                                          err_msg=f'pass {i} q_int {k}')
        np.testing.assert_array_equal(p['tlogits'], p['jlogits'])


@pytest.mark.parametrize('arch,scheme', _CASES)
def test_freeze_equal_and_qat_engine_parity(arch, scheme):
    jv, tmodel, x, _ = _calibrated(arch, scheme)
    jfm = jfreeze(jv, arch, jget(arch, scheme), 10)
    tfm = tfreeze(qat_to_numpy(tmodel), arch, tget(arch, scheme), 10)
    assert sorted(tfm.tensors) == sorted(jfm.tensors)
    for k, want in jfm.tensors.items():
        assert tfm[k].dtype == np.asarray(want).dtype, k
        np.testing.assert_array_equal(tfm[k], want, err_msg=k)
    # the port's freeze reads hawq_tpu's variables tree as it is
    for k, want in tfreeze(jv, arch, tget(arch, scheme), 10).tensors.items():
        np.testing.assert_array_equal(tfm[k], want, err_msg=k)

    # the port's own contract: QAT eval logits, as integers, == its engine's
    with torch.no_grad():
        qat = tmodel(torch.from_numpy(x), folded=True,
                     update_stats=False).numpy()
    eng = build_resnet_engine(tfm, device='cpu')(x).numpy()
    out_scale = (tfm['quant_output.weight_scale'].astype(np.float64)
                 * np.float64(tfm.act_scale('quant_act_output')))
    np.testing.assert_array_equal(np.round(qat / out_scale),
                                  np.round(eng / out_scale))
    assert np.isfinite(qat).all() and qat.shape == (2, 10)


def test_variables_round_trip_and_errors():
    jv, tmodel, _, _ = _calibrated('tiny50', 'uniform8')
    tv = qat_to_numpy(tmodel)
    assert set(tv) == {'params', 'batch_stats', 'quant_stats'}
    assert sorted(p for p, _ in _flat(tv)) == sorted(p for p, _ in _flat(jv))
    for p, want in _flat(jv):
        node = tv
        for k in p:
            node = node[k]
        assert node.shape == want.shape, p
    fresh = qat_from_numpy(QResNet('tiny50', tget('tiny50', 'uniform8'), 10,
                                   seed=5), tv)
    for (n1, a), (n2, b) in zip(sorted(tmodel.state_dict().items()),
                                sorted(fresh.state_dict().items())):
        assert n1 == n2 and torch.equal(a, b), n1
    # a missing statistics collection leaves the buffers alone; a missing
    # or misshapen parameter raises
    qat_from_numpy(fresh, {'params': tv['params']})
    broken = {**tv, 'params': {k: v for k, v in tv['params'].items()
                               if k != 'quant_output'}}
    with pytest.raises(KeyError):
        qat_from_numpy(fresh, broken)
    broken = {**tv, 'params': {**tv['params'], 'quant_output': {
        'kernel': np.zeros((3, 3), np.float32),
        'bias': tv['params']['quant_output']['bias']}}}
    with pytest.raises(ValueError):
        qat_from_numpy(fresh, broken)


@pytest.mark.parametrize('arch', ['resnet18', 'resnet50', 'resnet50b',
                                  'resnet164_cifar', 'wide50'])
def test_every_arch_builds_with_the_reference_parameter_tree(arch):
    """Shapes only (no forward): the port's parameter and buffer tree equals
    the flax model's for the full-size archs."""
    jmodel = JQResNet(arch=arch, cfg=jget(arch, 'uniform8'), num_classes=7)
    shapes = jax.eval_shape(
        lambda k, x: jmodel.init(k, x, folded=True, update_stats=True),
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    want = {p: a.shape for p, a in _flat(
        jax.tree.map(lambda s: np.zeros(s.shape, np.int8), dict(shapes)))}
    tv = qat_to_numpy(QResNet(arch, tget(arch, 'uniform8'), 7))
    got = {p: a.shape for p, a in _flat(tv)}
    assert got == want


@pytest.mark.parametrize('arch', ['tiny18', 'tiny50'])
def test_float_resnet_matches(arch):
    """The fp32 twin (the KD teacher): carried-over variables, eval and
    train mode, within float32 summation-order tolerance."""
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    jmodel = JFloatResNet(arch=arch, num_classes=10)
    v = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree.map(np.asarray, dict(v))
    tmodel = qat_from_numpy(FloatResNet(arch, 10), v)
    want = np.asarray(jax.jit(jmodel.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    want, mut = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=['batch_stats']))(v, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), train=True).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-4)
    tv = qat_to_numpy(tmodel)
    for p, a in _flat(jax.tree.map(np.asarray, dict(mut['batch_stats']))):
        node = tv['batch_stats']
        for k in p:
            node = node[k]
        np.testing.assert_allclose(node, a, rtol=1e-4, atol=1e-6,
                                   err_msg=str(p))
