"""hawq_tpu_torch numerics, configs, weights and fold helpers == hawq_tpu.

Same numpy inputs through the JAX reference and the PyTorch port; the
tolerance is 0 throughout (integer and float32 results are bit-equal).
"""

import ast
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.configs import bit_config as jcfg
from hawq_tpu.inference import engine as jengine
from hawq_tpu.inference import fold as jfold
from hawq_tpu.inference import freeze as jfreeze
from hawq_tpu.inference import synthetic as jsyn
from hawq_tpu.quant import ops as jops

from hawq_tpu_torch.configs import bit_config as tcfg
from hawq_tpu_torch.inference import fold as tfold
from hawq_tpu_torch.inference import freeze as tfreeze
from hawq_tpu_torch.inference import synthetic as tsyn
from hawq_tpu_torch.quant import ops as tops

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _accumulators(rng, n=4096):
    """Random int32 accumulators plus engineered half-way ties and values
    beyond 2²⁴ (where the f32 conversion itself rounds)."""
    acc = rng.randint(-2 ** 20, 2 ** 20, n)
    ties = (2 * rng.randint(-2 ** 10, 2 ** 10, 256) + 1) * 2 ** 7
    big = rng.randint(2 ** 24, 2 ** 30, 256) * rng.choice([-1, 1], 256)
    return np.concatenate([acc, ties, big]).astype(np.int32)


def _ratios(rng, n):
    return (rng.rand(n) * 0.05 + 1e-4).astype(np.float32)


def test_dyadic_multiplier_equal():
    rng = np.random.RandomState(0)
    r = np.concatenate([_ratios(rng, 1000), np.float32([2.0 ** -8, 1.0])])
    want = jengine._np_dyadic_multiplier(r)
    got = tops.np_dyadic_multiplier(r)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jops.dyadic_multiplier(jnp.asarray(r))))
    assert tops.DYADIC_MANTISSA_BITS == jops.DYADIC_MANTISSA_BITS


@pytest.mark.parametrize('bits,signed,out', [
    (8, True, 'int8'), (4, False, 'int8'), (16, True, 'int32'),
    (16, True, 'int16')])
def test_requant_int32_equal(bits, signed, out):
    rng = np.random.RandomState(bits + signed)
    acc = _accumulators(rng)
    # per-channel multipliers over the last axis, and the exact 2⁻⁸ that
    # makes the engineered ties land on x.5
    acc2 = acc.reshape(-1, 16)
    for mult in (tops.np_dyadic_multiplier(_ratios(rng, 16)),
                 np.full(16, 2.0 ** -8, np.float32)):
        want = np.asarray(jops.requant_int32(
            jnp.asarray(acc2), jnp.asarray(mult), bits, signed,
            getattr(jnp, out)))
        got = tops.requant_int32(torch.from_numpy(acc2),
                                 torch.from_numpy(mult), bits, signed,
                                 getattr(torch, out)).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_requant_add_int32_equal():
    rng = np.random.RandomState(5)
    acc = _accumulators(rng).reshape(-1, 16)
    ident = _accumulators(rng).reshape(-1, 16)[::-1].copy()
    m_acc = tops.np_dyadic_multiplier(_ratios(rng, 16))
    for m_id in (tops.np_dyadic_multiplier(np.float32(0.37)),
                 np.float32(2.0 ** -8)):
        want = np.asarray(jops.requant_add_int32(
            jnp.asarray(acc), jnp.asarray(m_acc), jnp.asarray(ident),
            jnp.asarray(m_id)))
        got = tops.requant_add_int32(
            torch.from_numpy(acc), torch.from_numpy(m_acc),
            torch.from_numpy(ident), torch.tensor(np.asarray(m_id))).numpy()
        np.testing.assert_array_equal(got, want)


def test_exact_div_and_round_half_up_equal():
    rng = np.random.RandomState(6)
    x = (rng.randn(100000) * 4).astype(np.float32)
    for s in (np.float32(0.0517), np.float32(0.0493), 49):
        # the quotients themselves: a reciprocal multiply differs by 1 ulp
        # on a few percent of them
        want = np.asarray(jops.exact_div(jnp.asarray(x), s))
        got = tops.exact_div(torch.from_numpy(x), s).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tops.round_half_up(torch.from_numpy(got)).numpy(),
            np.asarray(jops.round_half_up(jnp.asarray(want))))
    for b, s in ((8, True), (4, False), (16, True)):
        assert tops.requant_clip_bounds(b, s) == jops.requant_clip_bounds(b, s)


def _resnet_archs():
    return sorted(jcfg.RESNET_UNITS)


def test_bit_config_tables_equal():
    assert tcfg.RESNET_UNITS == jcfg.RESNET_UNITS
    assert tcfg.RESNET_CONVS_PER_UNIT == jcfg.RESNET_CONVS_PER_UNIT
    assert tcfg.RESNET_CIFAR_ARCHS == jcfg.RESNET_CIFAR_ARCHS
    assert tcfg.QuantSettings() == tcfg.QuantSettings(
        **vars(jcfg.QuantSettings()))
    n = 0
    for arch in _resnet_archs():
        assert list(tcfg.resnet_layer_keys(arch)) == \
            list(jcfg.resnet_layer_keys(arch))
        schemes = sorted(jcfg.available_schemes(arch))
        assert sorted(tcfg.available_schemes(arch)) == schemes
        for scheme in schemes:
            a, b = jcfg.get_bit_config(arch, scheme), \
                tcfg.get_bit_config(arch, scheme)
            assert (a.name, dict(a.table)) == (b.name, dict(b.table))
            assert vars(a.settings) == vars(b.settings)
            assert a.to_json() == b.to_json()
            n += 1
    assert n > 2 * len(_resnet_archs())     # the mixed JSON tables too


@pytest.mark.parametrize('arch,scheme', [('tiny50', 'uniform4'),
                                         ('tiny18', 'uniform8'),
                                         ('resnet20_cifar', 'uniform8'),
                                         ('resnet50', 'uniform8')])
def test_synthetic_weights_identical(arch, scheme):
    jfm = jsyn.synthetic_frozen_resnet(arch, jcfg.get_bit_config(arch, scheme),
                                       num_classes=10, seed=3)
    tfm = tsyn.synthetic_frozen_resnet(arch, tcfg.get_bit_config(arch, scheme),
                                       num_classes=10, seed=3)
    assert sorted(jfm.tensors) == sorted(tfm.tensors)
    for k, v in jfm.tensors.items():
        assert np.asarray(v).dtype == tfm[k].dtype, k
        np.testing.assert_array_equal(tfm[k], v, err_msg=k)
    assert tfreeze.model_size_bytes(tfm) == jfreeze.model_size_bytes(jfm)
    # carried across through plain numpy and dicts
    cfm = tfreeze.frozen_from_numpy(jfm.arch, jfm.cfg.name,
                                    dict(jfm.cfg.table), jfm.tensors,
                                    jfm.num_classes)
    assert cfm.cfg.table == dict(jfm.cfg.table)
    assert tfreeze.model_size_bytes(cfm) == jfreeze.model_size_bytes(jfm)
    assert cfm.act_scale('quant_input') == jfm.act_scale('quant_input')


def test_fold_helpers_equal():
    rng = np.random.RandomState(7)
    for h, w in ((32, 32), (224, 224), (36, 20)):
        assert tfold.fold4_geometry(h, w) == jfold.fold4_geometry(h, w)
    x = rng.randn(2, 36, 20, 3).astype(np.float32)
    np.testing.assert_array_equal(tfold.fold4_images(x),
                                  jfold.fold4_images(x))
    k = rng.randint(-127, 128, (7, 7, 3, 10)).astype(np.int8)
    np.testing.assert_array_equal(tfold.fold4_kernel(k),
                                  jfold.fold4_kernel(k))
    acc = rng.randint(-9, 9, (2, 5, 3, 4 * 6)).astype(np.int32)
    np.testing.assert_array_equal(tfold.depth_to_space_2x2(acc),
                                  jfold.depth_to_space_2x2(acc))
    with pytest.raises(ValueError):
        tfold.fold4_geometry(30, 32)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = [os.path.join(_REPO, 'chip_smoke.py')]
    for root, _, names in os.walk(os.path.join(_REPO, 'hawq_tpu_torch')):
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split('.')[0]
            assert top not in ('jax', 'jaxlib', 'flax', 'optax',
                               'hawq_tpu'), f'{f} imports {mod}'
