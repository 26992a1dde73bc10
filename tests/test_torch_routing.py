"""The port's routing (``hawq_tpu_torch.inference.routing``) and autotuner
(``inference.autotune``) on the CPU against ``hawq_tpu``: the site
enumerators give the JAX package's tuples; engines built with a routing
table of this card's routes ('int8' / 'int4w', every site packed or every
other one) equal ``hawq_tpu``'s unrouted engine bit for bit on the logits
and at every capture node (its own tests hold routed == unrouted there), and
run the packed kernels at exactly the sites the table routes; an odd K pads
to even; 'int4w' on 8-bit weights takes int8; the autotuner returns valid
tables that round-trip, and TPU tables are refused.
"""

import contextlib
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hawq_tpu.configs.bit_config import get_bit_config as jget
from hawq_tpu.inference import engine_inception as jei
from hawq_tpu.inference import routing as jrt
from hawq_tpu.inference import synthetic as jsyn
from hawq_tpu.inference.engine import build_resnet_engine as jresnet
from hawq_tpu.inference.engine_mobilenet import \
    build_mobilenetv2_engine as jmobilenet
from hawq_tpu.models import mobilenetv2 as jm

from hawq_tpu_torch.configs.bit_config import get_bit_config as tget
from hawq_tpu_torch.inference import autotune as tat
from hawq_tpu_torch.inference import routing as trt
from hawq_tpu_torch.inference.engine import build_resnet_engine
from hawq_tpu_torch.inference.engine_inception import build_inceptionv3_engine
from hawq_tpu_torch.inference.engine_mobilenet import \
    build_mobilenetv2_engine
from hawq_tpu_torch.kernels import matmul as km
from tests.test_torch_engine import _RecordAll, _port_fm

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 16                              # InceptionV3's width divisor here
_TINY = dict(stages=jm.TINY_MNV2_STAGES, init_ch=jm.TINY_MNV2_INIT_CH,
             final_ch=jm.TINY_MNV2_FINAL_CH)
# MobileNetV2 widths with odd K at the 1×1 convs (5, 7, 7 and 7)
_ODD = dict(stages=((5,), (7, 7)), init_ch=6, final_ch=12)


# ---------------------------------------------------------------------------
# the site enumerators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kw,size', [({}, 224), ({}, 96), (_TINY, 32),
                                     (_ODD, 32)])
def test_mobilenet_sites_equal(kw, size):
    got = trt.mobilenet_conv1x1_sites(image_size=size, **kw)
    assert got == jrt.mobilenet_conv1x1_sites(image_size=size, **kw)
    assert len(got) == 2 * sum(map(len, kw.get('stages',
                                              jm.MOBILENETV2_STAGES))) + 1


@pytest.mark.parametrize('width_div,size', [(1, 299), (W, 75), (2, 299)])
def test_inception_sites_equal(width_div, size):
    cfg = jget('inceptionv3', 'uniform4')
    got = trt.inception_conv1x1_sites(size, width_div)
    assert got == jrt.inception_conv1x1_sites(cfg, size, width_div)
    assert len(got) > 30


# ---------------------------------------------------------------------------
# routed engines against the JAX package's unrouted engine
# ---------------------------------------------------------------------------

def _jax_nodes(build, fm, x, **kw):
    """Logits and every capture node of a JAX engine, eagerly."""
    rec = _RecordAll()
    engine = build(fm, capture=rec, **kw)
    rec.slot = inspect.getclosurevars(engine.__wrapped__).nonlocals[
        'captured']
    with jax.disable_jit():
        engine(jnp.asarray(x))
        rec._flush()
        logits = np.asarray(build(fm, **kw)(jnp.asarray(x)))
    return logits, rec.nodes


@contextlib.contextmanager
def _counting(counts):
    """Count calls of the matmul and conv wrappers."""
    from hawq_tpu_torch.kernels import conv as kc
    names = [(km, n) for n in ('int8_matmul_requant', 'int8_matmul_acc',
                               'int4w_matmul_requant', 'int4w_matmul_acc',
                               'int8_matmul_acc_residual',
                               'int8_matmul_acc_residual_requant',
                               'int8_matmul_residual_requant')]
    names += [(kc, n) for n in ('int8_conv_requant', 'int8_conv_acc',
                                'int4w_conv_requant', 'int4w_conv_acc')]
    orig = {(m, n): getattr(m, n) for m, n in names}

    def wrap(m, n):
        def call(*a, **k):
            counts[n] = counts.get(n, 0) + 1
            return orig[m, n](*a, **k)
        return call
    for m, n in names:
        setattr(m, n, wrap(m, n))
    try:
        yield
    finally:
        for (m, n), f in orig.items():
            setattr(m, n, f)


def _port_nodes(eng, x):
    nodes = {}
    counts = {}
    with _counting(counts):
        logits = eng._forward(torch.from_numpy(x),
                              lambda n, v: nodes.__setitem__(n, v.numpy()))
    return logits.numpy(), nodes, counts


def _family(name):
    """(JAX FrozenModel, JAX builder, port builder, image, routable sites)
    of a tiny uniform4 model of the family."""
    x = np.random.RandomState(3).randn(1, 32, 32, 3).astype(np.float32)
    if name == 'resnet':
        fm = jsyn.synthetic_frozen_resnet('tiny50', jget('tiny50', 'uniform4'),
                                          num_classes=10, seed=2)
        sites = [c[0] for c in tat.routable_convs(fm, 32)]
        return (fm, jresnet, lambda fm, **kw: build_resnet_engine(
            fm, device='cpu', **kw), x, sites)
    if name in ('mobilenet', 'mobilenet_odd'):
        kw = _TINY if name == 'mobilenet' else _ODD
        fm = jsyn.synthetic_frozen_mobilenet(
            jget('mobilenetv2', 'uniform4'), num_classes=10, seed=2, **kw)
        sites = [s[0] for s in jrt.mobilenet_conv1x1_sites(image_size=32,
                                                           **kw)]
        return (fm, lambda fm, **k: jmobilenet(fm, kw['stages'], **k),
                lambda fm, **k: build_mobilenetv2_engine(fm, device='cpu',
                                                         **k), x, sites)
    fm = jsyn.synthetic_frozen_inception(jget('inceptionv3', 'uniform4'),
                                         num_classes=10, width_div=W, seed=2)
    x = np.random.RandomState(3).randn(1, 75, 75, 3).astype(np.float32)
    sites = [s[0] for s in jrt.inception_conv1x1_sites(
        fm.cfg, 75, W)]
    return (fm, lambda fm, **k: jei.build_inceptionv3_engine(
        fm, width_div=W, input_hw=(75, 75), **k),
        lambda fm, **k: build_inceptionv3_engine(fm, input_hw=(75, 75),
                                                 wide_dtype=torch.int32,
                                                 device='cpu', **k), x, sites)


_REFERENCE = {}


def _reference(name):
    if name not in _REFERENCE:
        fm, jbuild, _, x, _ = _family(name)
        _REFERENCE[name] = _jax_nodes(jbuild, fm, x)
    return _REFERENCE[name]


def _packed_sites(name, fm, table):
    """The sites where the port's rule packs: 'int4w', 4-bit weights, and
    for InceptionV3 a fused requant (a q_activ of at most 8 bits)."""
    cfg = fm.cfg
    out = [k for k, r in table.items()
           if r == 'int4w' and cfg.weight_bits(k) == 4]
    if name == 'inception':
        out = [k for k in out
               if cfg.act_bits(k[:-len('.q_convbn')] + '.q_activ') <= 8]
    return out


@pytest.mark.parametrize('name', ['resnet', 'mobilenet', 'mobilenet_odd',
                                  'inception'])
@pytest.mark.parametrize('kind', ['int4w', 'mixed'])
def test_routed_engine_equals_unrouted_reference(name, kind):
    fm, _, build, x, sites = _family(name)
    table = {k: ('int4w' if kind == 'int4w' or i % 2 == 0 else 'int8')
             for i, k in enumerate(sites)}
    want_logits, want = _reference(name)
    got_logits, got, counts = _port_nodes(build(_port_fm(fm),
                                                routing=table), x)
    np.testing.assert_array_equal(got_logits, want_logits)
    assert set(got) == set(want)
    for node, ref in want.items():
        assert got[node].dtype == ref.dtype, node
        np.testing.assert_array_equal(got[node], ref, err_msg=node)
    packed = _packed_sites(name, fm, table)
    assert packed                                 # the test routes some
    n4 = sum(v for k, v in counts.items() if k.startswith('int4w'))
    assert n4 == len(packed)
    form = {'resnet': None, 'inception': 'int4w_matmul_requant'}.get(
        name, 'int4w_matmul_acc')
    if form:
        assert counts.get(form) == len(packed), counts
    # the launch predictions chip_smoke.py holds the card's runs to
    import chip_smoke
    tfm = _port_fm(fm)
    if name == 'resnet':         # _port_nodes reads every carrier
        want = chip_smoke.expected_launches(tfm.arch, tfm.cfg, 'float32',
                                            routing=table,
                                            keep_carriers=True)
    elif name == 'inception':
        want = chip_smoke.expected_inception_launches(
            tfm, 'float32', routing=table).counts
    else:
        want = chip_smoke.expected_mobilenet_launches(
            tfm, 'float32', routing=table).counts
    assert counts == {k: v for k, v in want.items() if k in counts
                      or k.startswith(('int8_m', 'int8_c', 'int4w'))}


def test_odd_k_site_pads_with_zeros():
    """A packed 1×1 site with odd K: one zero row of weights, one zero
    column of activations; the accumulator and the requant equal the int8
    site's on every form."""
    rng = np.random.RandomState(0)
    w = rng.randint(-8, 8, (1, 1, 7, 24)).astype(np.int8)
    b = rng.randint(-500, 500, 24).astype(np.int32)
    x = torch.from_numpy(rng.randint(-128, 128, (2, 3, 5, 7)).astype(
        np.int8))
    mult = torch.full((24,), 0.003, dtype=torch.float32)
    packed = trt.Routed1x1.prepare(w, b, True, torch.device('cpu'))
    plain = trt.Routed1x1.prepare(w, b, False, torch.device('cpu'))
    assert packed.cin == 7 and packed.w.int4 and (packed.w.k, packed.w.n) == (
        8, 24)
    assert km.unprepare_weights(packed.w).shape == (4, 24)
    for requant in (False, True):
        if not requant:
            got, want = packed.acc(x), plain.acc(x)
            assert got.shape == (2, 3, 5, 24) and got.dtype == torch.int32
        else:
            got = packed.requant(x, mult, out_bits=8, signed=True, relu=True)
            want = plain.requant(x, mult, out_bits=8, signed=True, relu=True)
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        packed.acc(x[..., :6])


def test_int4w_on_8bit_weights_takes_int8():
    fm = jsyn.synthetic_frozen_resnet('tiny18', jget('tiny18', 'uniform8'),
                                      num_classes=10, seed=5)
    x = np.random.RandomState(6).randn(1, 32, 32, 3).astype(np.float32)
    table = {c[0]: 'int4w' for c in tat.routable_convs(fm, 32)}
    logits, _, counts = _port_nodes(build_resnet_engine(
        _port_fm(fm), routing=table, device='cpu'), x)
    assert counts and not any(k.startswith('int4w') for k in counts)
    np.testing.assert_array_equal(logits,
                                  np.asarray(jresnet(fm)(jnp.asarray(x))))


def test_table_checks():
    fm = _port_fm(jsyn.synthetic_frozen_resnet(
        'tiny18', jget('tiny18', 'uniform4'), num_classes=10, seed=5))
    assert trt.check_routing({'_note': 'x', 'a': 'int4w'}) == {'a': 'int4w'}
    with pytest.raises(ValueError, match='TPU'):
        build_resnet_engine(fm, routing={'stage1.unit1.quant_convbn1':
                                         'pallas8'}, device='cpu')
    with pytest.raises(ValueError, match='not one of'):
        trt.check_routing({'a': 'int16'})
    with pytest.raises(ValueError, match='reference'):
        build_resnet_engine(fm, routing={}, requant_mode='reference',
                            device='cpu')
    with pytest.raises(ValueError, match='readings of a TPU'):
        tat.load_routing(os.path.join(
            REPO, 'benchmarks', 'routing_resnet50_uniform4_b8.json'))


# ---------------------------------------------------------------------------
# the autotuner on the CPU
# ---------------------------------------------------------------------------

def _valid(table, keys, bits):
    assert set(k for k in table if not k.startswith('_')) == set(keys)
    for k in keys:
        assert table[k] in trt.ROUTES
        us = table['_us'][k]
        assert set(us) == ({'int8', 'int4w'} if bits(k) == 4 else {'int8'})
        assert all(v > 0 for v in us.values())
        assert table[k] == min(us, key=us.get)
    assert table['_device'] == 'cpu'


def test_autotune_1x1_on_cpu_sites_round_trips(tmp_path):
    sites = trt.mobilenet_conv1x1_sites(image_size=32, **_TINY)
    cfg = tget('mobilenetv2', 'uniform4')
    path = str(tmp_path / 'r.json')
    table = tat.autotune_routing_1x1(sites, cfg.weight_bits, batch=1,
                                     verbose=False, checkpoint_path=path,
                                     device='cpu', n_iters=2, rounds=2)
    _valid(table, [s[0] for s in sites], cfg.weight_bits)
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(table))
    tat.save_routing(str(tmp_path / 's.json'), table)
    assert tat.load_routing(str(tmp_path / 's.json')) == \
        trt.check_routing(table)
    # a table on disk resumes the sweep: nothing left to time
    assert tat.autotune_routing_1x1(sites, cfg.weight_bits, batch=1,
                                    verbose=False, checkpoint_path=path,
                                    device='cpu') == table


def test_autotune_resnet_on_cpu_and_serve(tmp_path):
    fm = _port_fm(jsyn.synthetic_frozen_resnet(
        'tiny18', jget('tiny18', 'uniform4'), num_classes=10, seed=7))
    table = tat.autotune_routing(fm, batch=1, image_size=32, verbose=False,
                                 device='cpu', n_iters=2, rounds=1)
    keys = [c[0] for c in tat.routable_convs(fm, 32)]
    _valid(table, keys, fm.cfg.weight_bits)
    x = np.random.RandomState(8).randn(1, 32, 32, 3).astype(np.float32)
    routed = build_resnet_engine(fm, routing=table, device='cpu')(x)
    assert torch.equal(routed, build_resnet_engine(fm, device='cpu')(x))


def test_autotune_main_writes_tables(tmp_path, capsys):
    out = str(tmp_path / 'inc.json')
    assert tat.main(['--arch', 'inceptionv3', '--scheme', 'uniform4',
                     '--batch', '1', '--image-size', '75', '--device', 'cpu',
                     '--out', out]) == 0
    table = tat.load_routing(out)
    assert len(table) == len(trt.inception_conv1x1_sites(75))
    assert tat.main(['--arch', 'resnet50v2', '--device', 'cpu']) == 2
