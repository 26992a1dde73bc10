"""InceptionV3 of hawq_tpu_torch == hawq_tpu's: the branch tables, the
synthetic weights and the integer engine (the QAT model, its freezer and
its trainer entry: tests/test_torch_inception_qat.py).

* ``build_inceptionv3_engine`` (CPU: the kernels' plain versions, A1's
  among them) equals the reference engine bit for bit on the logits and on
  the capture nodes 'input', 'init', every unit's 'q_rescaling_activ' (all
  five unit kinds) and 'fc_input': width_div 16 × the published uniform 8-
  and 4-bit tables × float32 / folded_float32 input × int32 / int16 wide
  container, at 75² (the smallest size the reductions allow) and 107².
  The reference runs eagerly (``jax.disable_jit``): one XLA compile of its
  whole program per case would cost more than the eager ops.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.configs.bit_config import BitConfig as JBitConfig
from hawq_tpu.configs.bit_config import get_bit_config as jget
from hawq_tpu.inference import fold as jfold
from hawq_tpu.inference import engine_inception as jei
from hawq_tpu.inference.synthetic import synthetic_frozen_inception as jsyn
from hawq_tpu.models import inceptionv3 as jm

from hawq_tpu_torch.configs.bit_config import BitConfig, get_bit_config as tget
from hawq_tpu_torch.inference import engine_inception as tei
from hawq_tpu_torch.inference.engine import IMAGENET_MEAN, IMAGENET_STD
from hawq_tpu_torch.inference.synthetic import synthetic_frozen_inception
from hawq_tpu_torch.models import inceptionv3 as tm
from hawq_tpu_torch.quant import ops as qops
from tests.test_torch_engine import _port_fm, _RecordAll
from tests.test_torch_resnet_v2 import _assert_frozen_equal

torch.set_num_threads(1)

W = 16                       # width_div of every test model
_KINDS = {jm._Conv1x1Branch: tm.CONV1X1, jm._ConvSeqBranch: tm.CONV_SEQ,
          jm._MaxPoolBranch: tm.MAX_POOL, jm._AvgPoolBranch: tm.AVG_POOL,
          jm._ConvSeq3x3Branch: tm.CONV_SEQ_3X3}
# one unit of each kind: A, Reduction-A, B, Reduction-B, C
_UNIT_NODES = tuple(f'features.stage{i}.unit{j}.q_rescaling_activ'
                    for i, j in ((1, 2), (2, 1), (2, 3), (3, 1), (3, 3)))


def _x(seed=0, n=2, size=75):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(
        np.float32)


def test_tables_equal():
    assert tm.INCEPTION_CHANNELS == jm.INCEPTION_CHANNELS
    assert tm.INCEPTION_B_MID == jm.INCEPTION_B_MID
    assert tm.INCEPTION_INIT_CH == jm.INCEPTION_INIT_CH
    for w in (1, 2, 16):
        got = [(i, j, u) for i, j, u in tm.units(w)]
        want = list(jei._units(JBitConfig(name='u8', table={}), w))
        assert len(got) == len(want) == 11
        for (i, j, unit), (ji, jj, junit) in zip(got, want):
            assert (i, j, unit.prefix, unit.name) == (ji, jj, junit.prefix,
                                                      junit.name)
            assert unit.branch_defs == tuple(
                (name, _KINDS[ctor], kwargs)
                for name, ctor, kwargs in junit.branch_defs)
    assert tm.init_channels(16) == (4, 4, 4, 5, 12)
    assert [(k, s, p) for _, k, s, p in tm.INIT_CONVS] == [
        (3, 2, 0), (3, 1, 0), (3, 1, 1), (1, 1, 0), (3, 1, 0)]


@pytest.mark.parametrize('scheme', ['uniform8', 'uniform4'])
def test_synthetic_equal(scheme):
    for w in (W, 1):
        _assert_frozen_equal(
            synthetic_frozen_inception(tget('inceptionv3', scheme),
                                       num_classes=10, width_div=w, seed=0),
            jsyn(jget('inceptionv3', scheme), num_classes=10, width_div=w,
                 seed=0))


@pytest.mark.parametrize('w', [1, 2, 8, 16, 32])
def test_width_div_from_frozen(w):
    fm = synthetic_frozen_inception(tget('inceptionv3', 'uniform8'),
                                    num_classes=10, width_div=w, seed=0)
    got = tei.width_div_from_frozen(fm)
    assert got == jei.width_div_from_frozen(fm)
    # the floor division can make two widths one graph (30 and 32): the
    # width read back builds the same one
    assert got == w or w == 32
    assert tm.init_channels(got) == tm.init_channels(w)
    assert list(tm.units(got)) == list(tm.units(w))


def test_every_conv_input_is_at_most_8_bits_in_the_published_tables():
    """W1 (a conv on activations wider than 8 bits) is on no published
    path: the walk covers every conv and the FC of the frozen namespace,
    and each of their input nodes has at most 8 bits; a crafted config
    with a 16-bit conv input makes the engine raise."""
    fm = synthetic_frozen_inception(tget('inceptionv3', 'uniform8'),
                                    num_classes=10, width_div=W)
    pairs = list(tei.conv_input_nodes(W))
    assert sorted(k for k, _ in pairs) == sorted(
        k[:-len('.weight_int')].replace('.q_convbn', '')
        for k in fm.tensors if k.endswith('.weight_int'))
    assert len(pairs) == 95                       # 94 convs and the FC
    for scheme in ('uniform8', 'uniform4'):
        cfg = tget('inceptionv3', scheme)
        wide = [k for k in cfg.table if cfg.act_bits(k) > 8]
        assert len(wide) == 71, scheme
        for conv, node in pairs:
            assert node in cfg.table and node.rsplit('.', 1)[-1] in (
                'q_input_activ', 'q_activ', 'q_input_act', 'q_pool_act',
                'q_concat_activ'), (conv, node)
            assert cfg.act_bits(node) <= 8, (scheme, conv, node)
        # the wide nodes feed requants, pools and concats only
        assert not set(wide) & {node for _, node in pairs}
    cfg = tget('inceptionv3', 'uniform8')
    node = 'features.stage2.unit2.branches.branch2.q_conv_list.q_conv1.q_activ'
    crafted = BitConfig(name='crafted', table={**cfg.table, node: 16})
    fm.cfg = crafted
    with pytest.raises(NotImplementedError, match='W1'):
        tei.build_inceptionv3_engine(fm, device='cpu')


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _reference(fm, x, **kw):
    """The reference engine's logits and every capture node, eagerly."""
    rec = _RecordAll()
    engine = jei.build_inceptionv3_engine(fm, width_div=W, capture=rec, **kw)
    import inspect
    rec.slot = inspect.getclosurevars(engine.__wrapped__).nonlocals[
        'captured']
    with jax.disable_jit():
        engine(jnp.asarray(x))
        rec._flush()
        logits = jei.build_inceptionv3_engine(fm, width_div=W, **kw)(
            jnp.asarray(x))
    return np.asarray(logits), rec.nodes


_GRID = [(scheme, mode, wide, 75) for scheme in ('uniform8', 'uniform4')
         for mode in ('float32', 'folded_float32')
         for wide in ('int32', 'int16')] + [
    ('uniform8', 'folded_float32', 'int16', 107),
    ('uniform4', 'float32', 'int32', 107)]


@pytest.mark.parametrize('scheme,input_mode,wide,size', _GRID)
def test_engine_matches_reference(scheme, input_mode, wide, size):
    fm = jsyn(jget('inceptionv3', scheme), num_classes=10, width_div=W,
              seed=1)
    x = _x(2, size=size)
    if input_mode == 'folded_float32':
        x = jfold.fold4_images_3x3s2(x, 0)
    jkw = dict(input_mode=input_mode, input_hw=(size, size),
               wide_dtype=getattr(jnp, wide))
    tkw = dict(input_mode=input_mode, input_hw=(size, size),
               wide_dtype=getattr(torch, wide), device='cpu')
    want, nodes = _reference(fm, x, **jkw)
    got = tei.build_inceptionv3_engine(_port_fm(fm), **tkw)(x).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got, want)
    assert len(nodes) == 3 + 11
    assert set(_UNIT_NODES) < set(nodes)
    assert len(np.unique(nodes['init'])) > 4       # a non-degenerate input
    for node, ref in nodes.items():
        port = tei.build_inceptionv3_engine(_port_fm(fm), capture=node,
                                            **tkw)(x).numpy()
        assert port.dtype == ref.dtype, node
        np.testing.assert_array_equal(port, ref, err_msg=node)


class _AsymmetricConfig(BitConfig):
    """A config whose every node is asymmetric, 16-bit ones included."""

    def act_mode(self, key):
        return 'asymmetric'


def test_engine_options_and_checks():
    fm = synthetic_frozen_inception(tget('inceptionv3', 'uniform8'),
                                    num_classes=10, width_div=W, seed=3)
    for option in (dict(conv_mode='f32'), dict(init_mode='f32cert')):
        with pytest.raises(TypeError):          # TPU layout options
            tei.build_inceptionv3_engine(fm, device='cpu', **option)
    with pytest.raises(ValueError, match='TPU'):   # a TPU routing table
        tei.build_inceptionv3_engine(
            fm, device='cpu',
            routing={'features.q_init_block.q_conv4.q_convbn': 'pallas4w'})
    with pytest.raises(ValueError, match='reference'):  # float32 input only
        tei.build_inceptionv3_engine(fm, requant_mode='reference',
                                     input_mode='folded_float32',
                                     device='cpu')
    # uint8 pixels, normalized on the device in the host's float32 op
    # order: the float32 engine's logits on the host-normalized images
    u8 = np.random.RandomState(5).randint(0, 256, (2, 75, 75, 3)).astype(
        np.uint8)
    host = qops.exact_div(qops.exact_div(torch.from_numpy(u8).float(), 255.0)
                          - torch.from_numpy(IMAGENET_MEAN), IMAGENET_STD)
    by_u8 = tei.build_inceptionv3_engine(fm, input_mode='uint8',
                                         input_hw=(75, 75), device='cpu')
    assert torch.equal(by_u8(u8), tei.build_inceptionv3_engine(
        fm, input_hw=(75, 75), device='cpu')(host))
    with pytest.raises(ValueError):             # uint8 mode takes uint8
        by_u8(host)
    with pytest.raises(ValueError):
        tei.build_inceptionv3_engine(fm, wide_dtype=torch.int8, device='cpu')
    # int16 containers need the wide nodes symmetric; by default they are
    # int16 where those are, in native mode, else int32
    asym = _port_fm(fm)
    asym.cfg = _AsymmetricConfig(name='asym', table=dict(fm.cfg.table))
    assert tei.build_inceptionv3_engine(asym, device='cpu').res_dt == \
        torch.int32
    assert tei.build_inceptionv3_engine(fm, device='cpu').res_dt == \
        torch.int16
    assert tei.build_inceptionv3_engine(
        fm, requant_mode='reference', device='cpu').res_dt == torch.int32
    with pytest.raises(ValueError, match='int16'):
        tei.build_inceptionv3_engine(asym, wide_dtype=torch.int16,
                                     device='cpu')
    x = _x(5, size=75)
    direct = tei.build_inceptionv3_engine(fm, input_hw=(75, 75),
                                          device='cpu')(x)
    folded = tei.build_inceptionv3_engine(fm, input_mode='folded_float32',
                                          input_hw=(75, 75), device='cpu')
    assert torch.equal(folded(jfold.fold4_images_3x3s2(x, 0)), direct)
    with pytest.raises(ValueError):             # folded for another size
        folded(jfold.fold4_images_3x3s2(_x(5, size=91), 0))
    with pytest.raises(ValueError):
        tei.build_inceptionv3_engine(fm, device='cpu')(
            x.astype(np.float64))
    with pytest.raises(KeyError):
        tei.build_inceptionv3_engine(fm, capture='stage9', device='cpu')(x)
