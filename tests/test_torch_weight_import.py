"""The float-weight importers of hawq_tpu_torch == hawq_tpu's.

Random pytorchcv-shaped float state dicts (seeded numpy) for ResNet tiny18
and tiny50, the tiny MobileNetV2 and InceptionV3 at width_div 16 go
through ``import_torch_resnet`` / ``import_torch_mobilenetv2`` /
``import_torch_inceptionv3`` of both packages, onto the same target trees
(the port's QAT model's, ``qat_to_numpy``): the results are equal leaf for
leaf.  Loaded with ``qat_from_numpy``, the ResNets and the MobileNetV2 give
a QAT forward (folded BN, ranges from the batch) equal bit for bit to the
flax model's on the same variables; the InceptionV3 tree loads and runs
(its QAT forward against flax on shared variables is
tests/test_torch_inception_qat.py, whose flax side takes minutes).
``flatten_to_mutable`` and ``nest_two_level`` round-trip and equal JAX's.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.configs.bit_config import BitConfig as JBitConfig
from hawq_tpu.configs.bit_config import QuantSettings as JQuantSettings
from hawq_tpu.configs.bit_config import get_bit_config as jget
from hawq_tpu.models import mobilenetv2 as jm
from hawq_tpu.models.resnet import QResNet as JQResNet
from hawq_tpu.utils import checkpoint as jckpt

from hawq_tpu_torch.configs.bit_config import (BitConfig, QuantSettings,
                                               RESNET_CONVS_PER_UNIT,
                                               RESNET_UNITS,
                                               get_bit_config as tget)
from hawq_tpu_torch.inference.synthetic import (_INIT_FEATURES,
                                                _STAGE_CHANNELS)
from hawq_tpu_torch.models import inceptionv3 as mi
from hawq_tpu_torch.models import mobilenetv2 as tm
from hawq_tpu_torch.models.resnet import (QResNet, qat_from_numpy,
                                          qat_to_numpy)
from hawq_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_resnet_v2 import _flat

torch.set_num_threads(1)

_TINY = dict(stages=tm.TINY_MNV2_STAGES, init_ch=tm.TINY_MNV2_INIT_CH,
             final_ch=tm.TINY_MNV2_FINAL_CH)


class _StateDict(dict):
    """A pytorchcv-style float state dict filled from one RandomState."""

    def __init__(self, seed):
        super().__init__()
        self.rng = np.random.RandomState(seed)

    def convbn(self, prefix, cin, cout, k, depthwise=False):
        kh, kw = (k, k) if isinstance(k, int) else k
        r = self.rng
        self[prefix + 'conv.weight'] = (0.1 * r.randn(
            cout, 1 if depthwise else cin, kh, kw)).astype(np.float32)
        self[prefix + 'bn.weight'] = (1 + 0.1 * r.randn(cout)).astype(
            np.float32)
        self[prefix + 'bn.bias'] = (0.1 * r.randn(cout)).astype(np.float32)
        self[prefix + 'bn.running_mean'] = (0.01 * r.randn(cout)).astype(
            np.float32)
        self[prefix + 'bn.running_var'] = (1 + 0.1 * r.rand(cout)).astype(
            np.float32)


def _resnet_sd(arch, num_classes=10):
    """features.init_block.conv.{conv,bn}, features.stageS.unitU.body.
    convC.{conv,bn} and .identity_conv, output."""
    sd = _StateDict(0)
    bottleneck = RESNET_CONVS_PER_UNIT[arch] == 3
    mids, outs = _STAGE_CHANNELS[arch]
    in_ch = _INIT_FEATURES[arch]
    sd.convbn('features.init_block.conv.', 3, in_ch, 7)
    for s, n_units in enumerate(RESNET_UNITS[arch], start=1):
        for u in range(1, n_units + 1):
            pre = f'features.stage{s}.unit{u}.'
            out_ch = outs[s - 1]
            if bottleneck:
                mid = mids[s - 1]
                sd.convbn(pre + 'body.conv1.', in_ch, mid, 1)
                sd.convbn(pre + 'body.conv2.', mid, mid, 3)
                sd.convbn(pre + 'body.conv3.', mid, out_ch, 1)
            else:
                sd.convbn(pre + 'body.conv1.', in_ch, out_ch, 3)
                sd.convbn(pre + 'body.conv2.', out_ch, out_ch, 3)
            if u == 1 and (in_ch != out_ch or s > 1):
                sd.convbn(pre + 'identity_conv.', in_ch, out_ch, 1)
            in_ch = out_ch
    sd['output.weight'] = (0.1 * sd.rng.randn(num_classes, in_ch)).astype(
        np.float32)
    sd['output.bias'] = (0.1 * sd.rng.randn(num_classes)).astype(np.float32)
    return dict(sd)


def _mnv2_sd(num_classes=10):
    sd = _StateDict(1)
    sd.convbn('features.init_block.', 3, tm.TINY_MNV2_INIT_CH, 3)
    in_ch = tm.TINY_MNV2_INIT_CH
    for i, stage in enumerate(tm.TINY_MNV2_STAGES, start=1):
        for j, out_ch in enumerate(stage, start=1):
            mid = in_ch * (1 if (i == 1 and j == 1) else 6)
            p = f'features.stage{i}.unit{j}.'
            sd.convbn(p + 'conv1.', in_ch, mid, 1)
            sd.convbn(p + 'conv2.', mid, mid, 3, depthwise=True)
            sd.convbn(p + 'conv3.', mid, out_ch, 1)
            in_ch = out_ch
    sd.convbn('features.final_block.', in_ch, tm.TINY_MNV2_FINAL_CH, 1)
    sd['output.weight'] = (0.1 * sd.rng.randn(
        num_classes, tm.TINY_MNV2_FINAL_CH, 1, 1)).astype(np.float32)
    sd['output.bias'] = (0.1 * sd.rng.randn(num_classes)).astype(np.float32)
    return dict(sd)


def _inception_sd(width_div, num_classes=10):
    """features.init_block.conv{1..5}, features.stageI.unitJ.branches.
    branchK.{conv, conv_list.convN, conv1x3, conv3x1}, output.fc."""
    sd = _StateDict(2)
    c_in = 3
    for c, (cout, (_, k, _, _)) in enumerate(
            zip(mi.init_channels(width_div), mi.INIT_CONVS), start=1):
        sd.convbn(f'features.init_block.conv{c}.', c_in, cout, k)
        c_in = cout
    for i, j, unit in mi.units(width_div):
        for name, kind, kw in unit.branch_defs:
            pre = f'features.stage{i}.unit{j}.branches.{name}.'
            if kind in (mi.CONV1X1, mi.AVG_POOL):
                sd.convbn(pre + 'conv.', c_in, kw['features'], 1)
            elif kind in (mi.CONV_SEQ, mi.CONV_SEQ_3X3):
                b_in = c_in
                for n, (cout, k) in enumerate(zip(kw['out_channels'],
                                                  kw['kernels']), start=1):
                    sd.convbn(pre + f'conv_list.conv{n}.', b_in, cout,
                              mi._ksize(k))
                    b_in = cout
                if kind == mi.CONV_SEQ_3X3:
                    sd.convbn(pre + 'conv1x3.', b_in, b_in, (1, 3))
                    sd.convbn(pre + 'conv3x1.', b_in, b_in, (3, 1))
        c_in = mi.unit_out_channels(unit, c_in)
    sd['output.fc.weight'] = (0.1 * sd.rng.randn(num_classes, c_in)).astype(
        np.float32)
    sd['output.fc.bias'] = (0.1 * sd.rng.randn(num_classes)).astype(
        np.float32)
    return dict(sd)


def _assert_trees_equal(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=str(k))


def _import_both(name, tree):
    """(port's (params, batch_stats), JAX's) from the same state dict."""
    if name == 'tiny_mnv2':
        args = (_mnv2_sd(), tm.TINY_MNV2_STAGES)
        fns = tckpt.import_torch_mobilenetv2, jckpt.import_torch_mobilenetv2
    elif name == 'inceptionv3_w16':
        args = _inception_sd(16),
        fns = (lambda sd, *a: tckpt.import_torch_inceptionv3(
                   sd, tget('inceptionv3', 'uniform8'), *a, width_div=16),
               lambda sd, *a: jckpt.import_torch_inceptionv3(
                   sd, jget('inceptionv3', 'uniform8'), *a, width_div=16))
    else:
        args = (_resnet_sd(name), name)
        fns = tckpt.import_torch_resnet, jckpt.import_torch_resnet
    return [fn(*args, tree['params'], tree['batch_stats']) for fn in fns]


def _models(name):
    """(the port's QAT model, the flax model or None)."""
    if name == 'tiny_mnv2':
        cfg = BitConfig(name='t', table={}, settings=QuantSettings())
        jcfg = JBitConfig(name='t', table={}, settings=JQuantSettings())
        return (tm.QMobileNetV2(cfg, 10, **_TINY),
                jm.QMobileNetV2(cfg=jcfg, num_classes=10,
                                stages=jm.TINY_MNV2_STAGES,
                                init_ch=jm.TINY_MNV2_INIT_CH,
                                final_ch=jm.TINY_MNV2_FINAL_CH))
    if name == 'inceptionv3_w16':
        return mi.QInceptionV3(tget('inceptionv3', 'uniform8'), 10,
                               width_div=16), None
    return (QResNet(name, tget(name, 'uniform8'), 10),
            JQResNet(arch=name, cfg=jget(name, 'uniform8'), num_classes=10))


@pytest.mark.parametrize('name', ['tiny18', 'tiny50', 'tiny_mnv2',
                                  'inceptionv3_w16'])
def test_import_equal_and_qat_forward(name):
    model, jmodel = _models(name)
    tree = qat_to_numpy(model)
    (tparams, tstats), (jparams, jstats) = _import_both(name, tree)
    _assert_trees_equal(tparams, jparams)
    _assert_trees_equal(tstats, jstats)
    # every leaf of the targets replaced (the state dict covers the model)
    for p, v in _flat(tree['params']):
        node = tparams
        for k in p:
            node = node[k]
        assert not np.array_equal(node, v) or not v.any(), p
    variables = {**tree, 'params': tparams, 'batch_stats': tstats}
    qat_from_numpy(model, variables)
    size = 75 if name == 'inceptionv3_w16' else 32
    x = np.random.RandomState(4).randn(2, size, size, 3).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x), folded=True,
                    update_stats=True).numpy()
    assert got.shape == (2, 10) and np.isfinite(got).all()
    if jmodel is not None:
        want, _ = jmodel.apply(
            {**tree, 'params': jparams, 'batch_stats': jstats},
            jnp.asarray(x), folded=True, update_stats=True,
            mutable=['quant_stats', 'batch_stats'])
        np.testing.assert_array_equal(got, np.asarray(want))


def test_flatten_and_nest_round_trip():
    tree = qat_to_numpy(QResNet('tiny50', tget('tiny50', 'uniform8'), 10))
    for coll in ('params', 'batch_stats', 'quant_stats'):
        flat = tckpt.flatten_to_mutable(tree[coll])
        jflat = jckpt.flatten_to_mutable(tree[coll])
        assert list(flat) == list(jflat)
        assert any('/' in k for k in flat) and len(flat) > 10
        for k, leaves in flat.items():
            assert sorted(leaves) == sorted(jflat[k])
        _assert_trees_equal(tckpt.nest_two_level(flat), tree[coll])
        _assert_trees_equal(jckpt.nest_two_level(flat),
                            tckpt.nest_two_level(flat))
    assert tckpt.nest_two_level({'a/b/c': 1, 'a/d': 2}) == {
        'a': {'b': {'c': 1}, 'd': 2}}
