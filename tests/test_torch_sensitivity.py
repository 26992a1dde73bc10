"""Hutchinson sensitivity of hawq_tpu_torch == hawq_tpu's, and the
config-generation pipeline end to end.

Each model is the port's (seed 0), calibrated by one pass, its variables
carried into flax.  The probes are the port's (``rademacher_like`` on a
seeded CPU generator), handed to both packages as numpy:

* the quadratic case: exact traces;
* ``hvp`` against ``hawq_tpu.sensitivity.hessian.hvp`` per leaf,
  max |port − jax| ≤ 1e-4 · max |jax| (the float backward sums in another
  order), on tiny ResNet-18 uniform8, tiny ResNet-50 uniform4, tiny
  MobileNetV2 uniform8 (D1's plain accumulator form in the forward) and a
  tiny InceptionV3 (head dropout off in both);
* ``hutchinson_layer_traces`` against hawq_tpu's v·Hv sums over the same
  probes, rtol 1e-4;
* ``hvp`` raising under a narrow residual store;
* ``generate_mixed_config`` at tiny18 on the CPU against hawq_tpu's
  pipeline (examples/generate_mixed_config.py's steps) on the same
  weights, ranges and probes: the BitConfig JSON equal byte for byte.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.configs.bit_config import get_bit_config as jget
from hawq_tpu.models import inceptionv3 as jinc
from hawq_tpu.models.mobilenetv2 import QMobileNetV2 as JQMobileNetV2
from hawq_tpu.models.resnet import QResNet as JQResNet
from hawq_tpu.sensitivity import hessian as jh
from hawq_tpu.sensitivity import ilp as jilp
from hawq_tpu.train.train import cross_entropy as jce

from hawq_tpu_torch.configs.bit_config import get_bit_config as tget
from hawq_tpu_torch.models import inceptionv3 as tinc
from hawq_tpu_torch.models.mobilenetv2 import (QMobileNetV2,
                                               TINY_MNV2_FINAL_CH,
                                               TINY_MNV2_INIT_CH,
                                               TINY_MNV2_STAGES)
from hawq_tpu_torch.models.resnet import QResNet, qat_to_numpy
from hawq_tpu_torch.nn import layers as L
from hawq_tpu_torch.sensitivity import hessian as th
from hawq_tpu_torch.sensitivity import pipeline as tp

torch.set_num_threads(1)

TOL = 1e-4
MNV2 = dict(stages=TINY_MNV2_STAGES, init_ch=TINY_MNV2_INIT_CH,
            final_ch=TINY_MNV2_FINAL_CH)
# case → (image size, number of parameter leaves)
CASES = {'tiny18-uniform8': (32, 26), 'tiny50-uniform4': (32, 38),
         'mobilenetv2-uniform8': (32, 35), 'inceptionv3-uniform8': (75, None)}
_cache = {}


def _models(case):
    arch, scheme = case.split('-')
    if arch == 'mobilenetv2':
        return (QMobileNetV2(tget(arch, scheme), 10, seed=0, **MNV2),
                JQMobileNetV2(cfg=jget(arch, scheme), num_classes=10, **MNV2))
    if arch == 'inceptionv3':
        return (tinc.QInceptionV3(tget(arch, scheme), 10, width_div=16,
                                  dropout_rate=0.0, seed=0),
                jinc.QInceptionV3(cfg=jget(arch, scheme), num_classes=10,
                                  width_div=16, dropout_rate=0.0))
    return (QResNet(arch, tget(arch, scheme), 10, seed=0),
            JQResNet(arch=arch, cfg=jget(arch, scheme), num_classes=10))


def _nest(flat):
    """A dotted-name mapping of tensors → the nested tree of jnp arrays."""
    out = {}
    for k, t in flat.items():
        node = out
        parts = k.split('.')
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(t.detach().numpy())
    return out


def _setup(case, n_probes=2):
    """The calibrated port model, its loss, its probes, and hawq_tpu's HVP
    of each probe on the same variables → dict."""
    if case in _cache:
        return _cache[case]
    size, _ = CASES[case]
    tmodel, jmodel = _models(case)
    rng = np.random.RandomState(0)
    x = rng.rand(2, size, size, 3).astype(np.float32)
    y = rng.randint(0, 10, (2,))
    with torch.no_grad():
        tmodel(torch.from_numpy(x), folded=True, update_stats=True)
    v = qat_to_numpy(tmodel)
    params = dict(tmodel.named_parameters())
    gen = torch.Generator().manual_seed(7)
    probes = [th.rademacher_like(params, gen) for _ in range(n_probes)]

    def jloss(p):
        logits = jmodel.apply({**v, 'params': p}, jnp.asarray(x),
                              folded=True, update_stats=False)
        return jce(logits, jnp.asarray(y))
    jhvp = jax.jit(lambda p, w: jh.hvp(jloss, p, w))
    jparams = jax.tree.map(jnp.asarray, v['params'])
    jhv = [jh._flatten_with_paths(jax.tree.map(
        np.asarray, jhvp(jparams, _nest(probe)))) for probe in probes]
    _cache[case] = dict(model=tmodel, params=params, probes=probes, jhv=jhv,
                        loss=tp.qat_loss(tmodel, torch.from_numpy(x),
                                         torch.from_numpy(y)))
    return _cache[case]


def _worst(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def test_quadratic_traces_exact():
    """loss = ½ aᵀdiag(d_a)a + ½ bᵀdiag(d_b)b: the per-layer trace is Σd
    exactly, since vᵀdiag(d)v = Σd for v ∈ {−1, 1}ⁿ."""
    d_a, d_b = torch.arange(1.0, 5.0), torch.arange(1.0, 3.0)
    params = {'a.kernel': torch.ones(4), 'b.kernel': torch.ones(2)}

    def loss(p):
        return (0.5 * torch.sum(d_a * p['a.kernel'] ** 2)
                + 0.5 * torch.sum(d_b * p['b.kernel'] ** 2))

    traces = th.hutchinson_layer_traces(loss, params, n_probes=2,
                                        normalize=False)
    np.testing.assert_allclose(traces['a/kernel'], float(d_a.sum()),
                               rtol=1e-6)
    np.testing.assert_allclose(traces['b/kernel'], float(d_b.sum()),
                               rtol=1e-6)
    assert set(th.conv_layer_traces(traces)) == {'a', 'b'}
    normalized = th.hutchinson_layer_traces(loss, params, n_probes=2)
    np.testing.assert_allclose(normalized['a/kernel'], 10.0 / 4, rtol=1e-6)


def test_probes_are_seeded_signs_in_sorted_path_order():
    params = {'b.kernel': torch.zeros(3, 2), 'a.kernel': torch.zeros(5),
              'a.bias': torch.zeros(2, dtype=torch.float64)}
    one = th.rademacher_like(params, torch.Generator().manual_seed(3))
    two = th.rademacher_like(params, torch.Generator().manual_seed(3))
    assert list(one) == ['a.bias', 'a.kernel', 'b.kernel']
    for k, t in one.items():
        assert t.shape == params[k].shape and t.dtype == params[k].dtype
        assert set(t.unique().tolist()) <= {-1.0, 1.0}
        assert torch.equal(t, two[k])


@pytest.mark.parametrize('case', list(CASES))
def test_hvp_matches_hawq_tpu_per_leaf(case):
    s = _setup(case)
    n_leaves = CASES[case][1]
    for probe, jhv in zip(s['probes'], s['jhv']):
        hv = th.hvp(s['loss'], s['params'], probe)
        assert sorted(k.replace('.', '/') for k in hv) == sorted(jhv)
        if n_leaves is not None:
            assert len(hv) == n_leaves
        zero = 0
        for k, t in hv.items():
            want = jhv[k.replace('.', '/')]
            if np.abs(want).max() == 0:     # a branch dead at this size
                assert float(t.abs().max()) == 0, k
                zero += 1
                continue
            assert _worst(t.numpy(), want) <= TOL, (k, _worst(t.numpy(),
                                                              want))
        assert zero <= len(hv) // 50, zero


@pytest.mark.parametrize('case', ['tiny18-uniform8', 'mobilenetv2-uniform8'])
def test_traces_match_hawq_tpus_sums_over_the_same_probes(case):
    s = _setup(case)
    got = th.hutchinson_layer_traces(s['loss'], s['params'],
                                     n_probes=len(s['probes']),
                                     generator=torch.Generator().manual_seed(7))
    sizes = {k.replace('.', '/'): p.numel() for k, p in s['params'].items()}
    assert sorted(got) == sorted(sizes)
    for key, n in sizes.items():
        want = sum(float(np.sum(probe[key.replace('/', '.')].numpy()
                                * jhv[key]))
                   for probe, jhv in zip(s['probes'], s['jhv']))
        want = want / len(s['probes']) / n
        np.testing.assert_allclose(got[key], want, rtol=TOL, err_msg=key)


def test_hvp_leaves_the_model_untouched():
    """hvp reads the model's own parameters without writing .grad."""
    s = _setup('tiny18-uniform8')
    th.hvp(s['loss'], s['params'], s['probes'][0])
    assert all(p.grad is None for p in s['model'].parameters())


@pytest.mark.parametrize('dt', [torch.bfloat16, torch.float16])
def test_hvp_raises_under_a_narrow_residual_store(dt):
    s = _setup('tiny18-uniform8')
    with L.residual_store_dtype(dt):
        with pytest.raises(RuntimeError, match='narrow'):
            th.hvp(s['loss'], s['params'], s['probes'][0])
    th.hvp(s['loss'], s['params'], s['probes'][0])      # outside: runs


def test_perturbation_and_conv_traces_match_hawq_tpu():
    rng = np.random.RandomState(2)
    for shape in ((3, 3, 8, 16), (1, 1, 16, 4), (10,)):
        w = rng.randn(*shape).astype(np.float32)
        for bits in (4, 8):
            for per_channel in (True, False):
                assert th.quantization_perturbation(w, bits, per_channel) \
                    == jh.quantization_perturbation(w, bits, per_channel)
    traces = {'s1/c1/kernel': 1.5, 's1/c1/gamma': 2.0, 'fc/kernel': 3.0}
    assert th.conv_layer_traces(traces) == jh.conv_layer_traces(traces)


def test_generated_config_equals_hawq_tpus_pipeline(tmp_path):
    """generate_mixed_config('tiny18', 'bops', 0.5) on the CPU: the port
    builds QResNet seed 0, calibrates it on RandomState(0)'s batch, takes
    two probes from a CPU generator seeded 0.  hawq_tpu's pipeline steps
    on the same variables and probes give the same JSON; from a saved
    checkpoint of those variables, the port gives it again."""
    size, batch, probes = 32, 2, 2
    cfg = tp.generate_mixed_config('tiny18', 'bops', 0.5, device='cpu',
                                   batch=batch, image_size=size,
                                   probes=probes, num_classes=10)

    model = tp.build_qat_model('tiny18', 10)
    x, y = tp.calibration_batch(batch, size, 10)
    with torch.no_grad():
        model(torch.from_numpy(x), folded=True, update_stats=True)
    v = qat_to_numpy(model)
    jmodel = JQResNet(arch='tiny18', cfg=jget('tiny18', 'uniform8'),
                      num_classes=10)

    def jloss(p):
        return jce(jmodel.apply({**v, 'params': p}, jnp.asarray(x),
                                folded=True, update_stats=False),
                   jnp.asarray(y))
    params = dict(model.named_parameters())
    gen = torch.Generator().manual_seed(0)
    acc = {}
    for _ in range(probes):
        probe = th.rademacher_like(params, gen)
        hv = jh._flatten_with_paths(jax.tree.map(np.asarray, jh.hvp(
            jloss, jax.tree.map(jnp.asarray, v['params']), _nest(probe))))
        for k, t in probe.items():
            key = k.replace('.', '/')
            acc[key] = acc.get(key, 0.0) + np.float32(np.sum(
                t.numpy() * hv[key]))
    traces = jh.conv_layer_traces({k: float(a) / probes / params[
        k.replace('/', '.')].numel() for k, a in acc.items()})
    costs = jilp.resnet_layer_costs('tiny18', v['params'], traces,
                                    input_size=size)
    want = jilp.allocation_to_bit_config(
        'tiny18', jilp.allocate_bits(costs, 'bops', 0.5),
        'bops_0.5_generated')
    assert cfg.to_json() == want.to_json()
    assert 4 in cfg.table.values() and 8 in cfg.table.values()

    from hawq_tpu_torch.utils.checkpoint import save_train_checkpoint
    path = str(tmp_path / 'ckpt.npz')
    save_train_checkpoint(path, v)
    again = tp.generate_mixed_config('tiny18', 'bops', 0.5, device='cpu',
                                     batch=batch, image_size=size,
                                     probes=probes, num_classes=10,
                                     checkpoint=path)
    assert again.to_json() == cfg.to_json()
