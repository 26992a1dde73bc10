"""The port's integer ResNet engine (CPU, plain kernel versions) ==
hawq_tpu.inference.engine.build_resnet_engine (default XLA route), bit for
bit on the logits and on every capture node.

Both engines get the same synthetic FrozenModel, carried across as numpy
through ``frozen_from_numpy``, and the same numpy images.  The reference's
logits come from its jitted program.  Its capture nodes are all recorded in
one eager (``jax.disable_jit``) forward: the capture name is a recorder that
compares equal to every node name, and it moves each emitted value out of
the engine's capture slot before the next node overwrites it.
"""

import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.configs.bit_config import get_bit_config
from hawq_tpu.inference import fold as jfold
from hawq_tpu.inference.engine import build_resnet_engine as jax_engine
from hawq_tpu.inference.synthetic import synthetic_frozen_resnet

from hawq_tpu_torch.inference.engine import build_resnet_engine
from hawq_tpu_torch.inference.freeze import frozen_from_numpy
from hawq_tpu_torch.kernels import matmul as km

torch.set_num_threads(1)


class _RecordAll(str):
    """Capture name equal to every node name; keeps each node's value."""

    def __new__(cls):
        obj = super().__new__(cls, '<every node>')
        obj.nodes, obj.slot = {}, None
        return obj

    def _flush(self):
        if self.nodes and 'value' in self.slot:
            last = next(reversed(self.nodes))
            self.nodes[last] = np.asarray(self.slot.pop('value'))

    def __eq__(self, name):
        self._flush()            # the previous node's value is in the slot
        self.nodes[name] = None
        return True

    __hash__ = str.__hash__


def _reference_nodes(fm, x, build=jax_engine, **kw):
    """Every capture node of the reference engine that ``build`` makes."""
    rec = _RecordAll()
    engine = build(fm, capture=rec, **kw)
    rec.slot = inspect.getclosurevars(engine.__wrapped__).nonlocals['captured']
    with jax.disable_jit():
        engine(jnp.asarray(x))
    rec._flush()
    return rec.nodes


def _port_fm(fm):
    return frozen_from_numpy(fm.arch, fm.cfg.name, dict(fm.cfg.table),
                             fm.tensors, fm.num_classes)


_GRID = [(arch, scheme, mode, rd)
         for arch in ('tiny18', 'tiny50')
         for scheme in ('uniform8', 'uniform4')
         for mode in ('float32', 'folded_float32')
         for rd in ('int32', 'int16')] + [
    ('resnet20_cifar', 'uniform8', 'float32', 'int32')]


@pytest.mark.parametrize('arch,scheme,input_mode,residual', _GRID)
def test_engine_matches_reference(arch, scheme, input_mode, residual):
    fm = synthetic_frozen_resnet(arch, get_bit_config(arch, scheme),
                                 num_classes=10, seed=1)
    x = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
    if input_mode == 'folded_float32':
        x = jfold.fold4_images(x)
    jkw = dict(input_mode=input_mode, residual_dtype=getattr(jnp, residual))
    tkw = dict(input_mode=input_mode, residual_dtype=getattr(torch, residual),
               device='cpu')

    want = np.asarray(jax_engine(fm, **jkw)(jnp.asarray(x)))
    got = build_resnet_engine(_port_fm(fm), **tkw)(x).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got, want)

    nodes = _reference_nodes(fm, x, **jkw)
    assert len(np.unique(nodes['init'])) > 16     # a non-degenerate input
    n_units = sum(1 for k in nodes if k.endswith('.quant_act_int32'))
    assert n_units == {'tiny18': 3, 'tiny50': 3, 'resnet20_cifar': 9}[arch]
    assert len(nodes) == 5 + n_units * (4 if arch == 'tiny50' else 3)
    for node, ref in nodes.items():
        port = build_resnet_engine(_port_fm(fm), capture=node, **tkw)(x)
        port = port.numpy()
        assert port.dtype == ref.dtype, node
        np.testing.assert_array_equal(port, ref, err_msg=node)


@pytest.mark.parametrize('scheme,input_mode,residual', [
    ('uniform8', 'folded_float32', 'int16'), ('uniform4', 'float32', 'int32')])
def test_resnet50_small_image_matches_reference(scheme, input_mode, residual):
    """Full-width ResNet-50 (the main path's graph: stride on the 1×1
    conv1, 2048-wide FC input) at 64×64, batch 1, against the eager
    reference."""
    fm = synthetic_frozen_resnet('resnet50', get_bit_config('resnet50', scheme),
                                 num_classes=16, seed=2)
    x = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
    if input_mode == 'folded_float32':
        x = jfold.fold4_images(x)
    nodes = _reference_nodes(fm, x, input_mode=input_mode,
                             residual_dtype=getattr(jnp, residual))
    assert len(nodes) == 5 + 16 * 4
    for node in ('init', 'stage2.unit1.conv1', 'stage4.unit3.quant_act_int32',
                 'avg_pool', 'fc_output'):
        port = build_resnet_engine(
            _port_fm(fm), capture=node, input_mode=input_mode,
            residual_dtype=getattr(torch, residual), device='cpu')(x).numpy()
        np.testing.assert_array_equal(port, nodes[node], err_msg=node)


@pytest.mark.parametrize('scheme,input_mode,routing', [
    ('uniform8', 'uint8', None), ('uniform4', 'float32', 'int8')])
def test_entry_requant_in_epilogue_matches_reference(monkeypatch, scheme,
                                                     input_mode, routing):
    """tiny50 with the int32 carrier, where each conv3 but the last also
    leaves as the next unit's entry requant (8-bit entries on uint8 images,
    the benchmark's input; 4-bit ones, every unit conv routed 'int8'): every
    capture node and the logits equal the JAX engine's.  A forward stores
    stage1.unit1's carrier only when that node is captured (stage2.unit1
    takes its identity from its own conv); a capture of any other node
    leaves it unstored."""
    fm = synthetic_frozen_resnet('tiny50', get_bit_config('tiny50', scheme),
                                 num_classes=10, seed=3)
    rng = np.random.RandomState(4)
    if input_mode == 'uint8':
        x = rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    else:
        x = rng.randn(2, 32, 32, 3).astype(np.float32)
    jkw = dict(input_mode=input_mode, residual_dtype=jnp.int32)
    port_fm = _port_fm(fm)
    table = None
    if routing is not None:
        table = {k[:-len('.weight_int')]: routing for k in port_fm.tensors
                 if k.startswith('stage') and k.endswith('.weight_int')}
    calls = []
    for name in (km.RESIDUAL, km.RESIDUAL_REQUANT, km.RESIDUAL_REQUANT_ONLY):
        def counted(*args, _name=name, _fn=getattr(km, name), **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(km, name, counted)

    def build(capture=None):
        return build_resnet_engine(port_fm, capture=capture,
                                   input_mode=input_mode, device='cpu',
                                   routing=table)
    np.testing.assert_array_equal(
        build()(x).numpy(), np.asarray(jax_engine(fm, **jkw)(jnp.asarray(x))))
    assert calls == [km.RESIDUAL_REQUANT_ONLY, km.RESIDUAL_REQUANT,
                     km.RESIDUAL]
    nodes = _reference_nodes(fm, x, **jkw)
    assert len(nodes) == 5 + 3 * 4
    for node, ref in nodes.items():
        calls.clear()
        port = build(node)(x).numpy()
        assert port.dtype == ref.dtype, node
        np.testing.assert_array_equal(port, ref, err_msg=node)
        if node == 'stage1.unit1.quant_act_int32':
            assert calls == [km.RESIDUAL_REQUANT]
        elif calls:
            assert calls[0] == km.RESIDUAL_REQUANT_ONLY, node


def test_int16_carrier_clamps_like_reference():
    """Residual scales shrunk 300× push the residual sums past 2¹⁵−1: the
    int16 carrier must clamp them (not wrap) exactly as the reference."""
    fm = synthetic_frozen_resnet('tiny18', get_bit_config('tiny18', 'uniform8'),
                                 num_classes=10, seed=1)
    for k in fm.tensors:
        if k.endswith('quant_act_int32.act_scale'):
            fm.tensors[k] = np.float32(fm.tensors[k] / 300)
    x = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
    node = 'stage1.unit1.quant_act_int32'
    wide = build_resnet_engine(_port_fm(fm), capture=node, device='cpu')(x)
    assert int(wide.max()) > 2 ** 15              # the clamp is exercised
    for capture in (node, None):
        want = np.asarray(jax_engine(fm, capture=capture,
                                     residual_dtype=jnp.int16)(jnp.asarray(x)))
        got = build_resnet_engine(_port_fm(fm), capture=capture,
                                  residual_dtype=torch.int16,
                                  device='cpu')(x).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(capture))


def test_engine_rejects_unsupported_options():
    fm = _port_fm(synthetic_frozen_resnet(
        'tiny18', get_bit_config('tiny18', 'uniform8'), num_classes=10))
    with pytest.raises(ValueError):
        build_resnet_engine(fm, input_mode='uint16', device='cpu')
    with pytest.raises(ValueError):             # images in the wrong dtype
        build_resnet_engine(fm, input_mode='uint8', device='cpu')(
            np.zeros((1, 32, 32, 3), np.float32))
    with pytest.raises(ValueError):
        build_resnet_engine(fm, residual_dtype=torch.int8, device='cpu')
    with pytest.raises(KeyError):
        build_resnet_engine(fm, capture='stage9.unit1.input', device='cpu')(
            np.zeros((1, 32, 32, 3), np.float32))
