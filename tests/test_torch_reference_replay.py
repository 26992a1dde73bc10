"""``requant_mode='reference'`` — the replay of an imported reference
checkpoint with its own 31-bit float64 requant — in hawq_tpu_torch's
engines == hawq_tpu's (under ``jax.enable_x64``), bit for bit on the logits
and at every capture node.

* ResNet tiny50 and tiny18, uniform 8- and 4-bit, on all four input modes
  (float32, uint8, folded_float32, folded_int8), int32 carrier; the tiny
  MobileNetV2 and InceptionV3 at width_div 16, 75², on float32 input.
* Each on its synthetic model (seed 1) and on its ``dyadic_scales``
  variant, where the requant ratios are powers of two and accumulators
  land on ties: there the port's reference engine must differ from its
  native engine at one node or more, so the comparison bites.
* In reference mode no fused-requant kernel form is called (each raises
  here); the accumulator forms are, and on the folded ResNet path the
  standalone ``maxpool_folded``, in the MobileNetV2 D1's
  ``int8_dwconv_acc``, in the InceptionV3 A1's quotient form
  ``int_avgpool3x3``.
* The options JAX rejects in reference mode raise ``ValueError``.
* A1's quotient form — its plain version and the kernel's walk
  (``avgpool_walk_plain`` without multipliers) — == the JAX engine's own
  ``int_avgpool_3x3`` at the shapes of tests/test_torch_avgpool_walk.py.

The JAX side records its nodes in one eager forward (``jax.disable_jit``);
the port's in one forward through ``IntEngine._forward``.
"""

import contextlib
import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.configs.bit_config import BitConfig as JBitConfig
from hawq_tpu.configs.bit_config import QuantSettings as JQuantSettings
from hawq_tpu.configs.bit_config import get_bit_config as jget
from hawq_tpu.inference import engine_inception as jei
from hawq_tpu.inference import fold as jfold
from hawq_tpu.inference import synthetic as jsyn
from hawq_tpu.inference.engine import build_resnet_engine as jresnet
from hawq_tpu.inference.engine_mobilenet import (
    build_mobilenetv2_engine as jmobilenet)
from hawq_tpu.models import mobilenetv2 as jm

from hawq_tpu_torch.inference.engine import build_resnet_engine
from hawq_tpu_torch.inference.engine_inception import (
    build_inceptionv3_engine)
from hawq_tpu_torch.inference.engine_mobilenet import (
    build_mobilenetv2_engine)
from hawq_tpu_torch.inference.synthetic import dyadic_scales
from hawq_tpu_torch.kernels import avgpool as ka
from hawq_tpu_torch.kernels import conv as kc
from hawq_tpu_torch.kernels import depthwise as kd
from hawq_tpu_torch.kernels import matmul as km
from hawq_tpu_torch.kernels import pool as kp
from hawq_tpu_torch.utils.preproc import quantize_int8
from tests.test_torch_engine import _RecordAll, _port_fm

torch.set_num_threads(1)

_TINY_MNV2 = dict(stages=jm.TINY_MNV2_STAGES, init_ch=jm.TINY_MNV2_INIT_CH,
                  final_ch=jm.TINY_MNV2_FINAL_CH)
W = 16
# the forms that compute the native requant: never called in reference mode
_FUSED = ((kc, 'int8_conv_requant'), (kc, 'int4w_conv_requant'),
          (km, 'int8_matmul_requant'), (km, 'int4w_matmul_requant'),
          (kp, 'maxpool_folded_requant'), (kd, 'int8_dwconv_requant'),
          (ka, 'int_avgpool3x3_requant'))
_ACC = ((kc, 'int8_conv_acc'), (kc, 'int4w_conv_acc'),
        (km, 'int8_matmul_acc'), (km, 'int4w_matmul_acc'),
        (kp, 'maxpool_folded'), (kd, 'int8_dwconv_acc'),
        (ka, 'int_avgpool3x3'))


@contextlib.contextmanager
def _kernel_calls(monkeypatch):
    """Inside, every fused-requant form raises and the other kernel
    wrappers count their calls into the yielded dict."""
    calls = {}

    def fused(name):
        def call(*a, **k):
            raise AssertionError(f'{name} called in reference mode')
        return call

    def counted(mod, name):
        fn = getattr(mod, name)

        def call(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return call
    with monkeypatch.context() as m:
        for mod, name in _FUSED:
            m.setattr(mod, name, fused(name))
        for mod, name in _ACC:
            m.setattr(mod, name, counted(mod, name))
        yield calls


def _jax_run(build, fm, x, **kw):
    """The JAX reference-mode engine under x64: (logits, every node)."""
    rec = _RecordAll()
    with jax.enable_x64(), jax.disable_jit():
        engine = build(fm, capture=rec, requant_mode='reference', **kw)
        rec.slot = inspect.getclosurevars(
            engine.__wrapped__).nonlocals['captured']
        engine(jnp.asarray(x))
        rec._flush()
        logits = np.asarray(build(fm, requant_mode='reference', **kw)(
            jnp.asarray(x)))
    return logits, rec.nodes


def _port_run(engine, x):
    """One forward of a port engine: (logits, every node)."""
    nodes = {}
    logits = engine._forward(torch.from_numpy(np.asarray(x)),
                             lambda n, v: nodes.__setitem__(n, v.clone()))
    return logits.numpy(), {k: v.numpy() for k, v in nodes.items()}


def _check(jax_build, port_build, fm, x, dyadic, monkeypatch, want_calls):
    """The port's reference engine == JAX's at every node and on the
    logits; on the dyadic variant it differs from the port's native
    engine somewhere; the kernels it calls."""
    if dyadic:
        fm = dyadic_scales(fm)
    want, jnodes = _jax_run(jax_build, fm, x)
    with _kernel_calls(monkeypatch) as calls:
        got, tnodes = _port_run(port_build(_port_fm(fm),
                                           requant_mode='reference'), x)
    assert set(want_calls) <= set(calls), calls
    assert sorted(tnodes) == sorted(jnodes)
    for node, ref in jnodes.items():
        assert tnodes[node].dtype == ref.dtype, node
        np.testing.assert_array_equal(tnodes[node], ref, err_msg=node)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    _, native = _port_run(port_build(_port_fm(fm)), x)
    differ = [n for n in tnodes if not np.array_equal(native[n], tnodes[n])]
    if dyadic:
        assert differ, 'reference and native modes agree on the dyadic model'
    return differ


def _resnet_input(fm, x, mode):
    if mode == 'uint8':
        return (np.clip(x * 60 + 128, 0, 255)).astype(np.uint8)
    if mode.startswith('folded'):
        x = jfold.fold4_images(x)
    if mode == 'folded_int8':
        x = quantize_int8(x, fm.act_scale('quant_input'))
    return x


_RESNET = [(arch, scheme, mode, dyadic) for arch in ('tiny50', 'tiny18')
           for scheme in ('uniform8', 'uniform4')
           for mode in ('float32', 'uint8', 'folded_float32', 'folded_int8')
           for dyadic in (False, True)]


@pytest.mark.parametrize('arch,scheme,input_mode,dyadic', _RESNET)
def test_resnet_reference_mode(arch, scheme, input_mode, dyadic,
                               monkeypatch):
    fm = jsyn.synthetic_frozen_resnet(arch, jget(arch, scheme),
                                      num_classes=10, seed=1)
    x = _resnet_input(fm, np.random.RandomState(2).randn(
        2, 32, 32, 3).astype(np.float32), input_mode)
    want = ['int8_conv_acc', 'int8_matmul_acc']
    if scheme == 'uniform4':
        want.append('int4w_conv_acc')
        if arch == 'tiny50':
            want.append('int4w_matmul_acc')
    if input_mode.startswith('folded'):
        want.append('maxpool_folded')
    _check(lambda fm, **kw: jresnet(fm, input_mode=input_mode, **kw),
           lambda fm, **kw: build_resnet_engine(fm, input_mode=input_mode,
                                                device='cpu', **kw),
           fm, x, dyadic, monkeypatch, want)


@pytest.mark.parametrize('dyadic', [False, True])
def test_mobilenet_reference_mode(dyadic, monkeypatch):
    cfg = JBitConfig(name='tiny_mnv2_u8', table={}, settings=JQuantSettings())
    fm = jsyn.synthetic_frozen_mobilenet(cfg, num_classes=10, seed=1,
                                         **_TINY_MNV2)
    x = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
    _check(lambda fm, **kw: jmobilenet(fm, jm.TINY_MNV2_STAGES,
                                       input_hw=(32, 32), **kw),
           lambda fm, **kw: build_mobilenetv2_engine(fm, input_hw=(32, 32),
                                                     device='cpu', **kw),
           fm, x, dyadic, monkeypatch, ['int8_dwconv_acc', 'int8_conv_acc',
                                        'int8_matmul_acc'])


@pytest.mark.parametrize('dyadic', [False, True])
def test_inception_reference_mode(dyadic, monkeypatch):
    fm = jsyn.synthetic_frozen_inception(jget('inceptionv3', 'uniform8'),
                                         num_classes=10, width_div=W, seed=1)
    x = np.random.RandomState(2).randn(2, 75, 75, 3).astype(np.float32)
    differ = _check(
        lambda fm, **kw: jei.build_inceptionv3_engine(
            fm, width_div=W, input_hw=(75, 75), **kw),
        lambda fm, **kw: build_inceptionv3_engine(fm, input_hw=(75, 75),
                                                  device='cpu', **kw),
        fm, x, dyadic, monkeypatch, ['int_avgpool3x3', 'int8_conv_acc',
                                     'int8_matmul_acc'])
    if dyadic:
        assert 'fc_input' in differ


def test_reference_mode_rejects_what_jax_rejects():
    rfm = _port_fm(jsyn.synthetic_frozen_resnet(
        'tiny18', jget('tiny18', 'uniform8'), num_classes=10, seed=1))
    mfm = _port_fm(jsyn.synthetic_frozen_mobilenet(
        JBitConfig(name='t', table={}, settings=JQuantSettings()),
        num_classes=10, seed=1, **_TINY_MNV2))
    ifm = _port_fm(jsyn.synthetic_frozen_inception(
        jget('inceptionv3', 'uniform8'), num_classes=10, width_div=W,
        seed=1))
    ref = dict(requant_mode='reference', device='cpu')
    with pytest.raises(ValueError, match='reference'):
        build_resnet_engine(rfm, residual_dtype=torch.int16, **ref)
    with pytest.raises(ValueError, match='reference'):
        build_mobilenetv2_engine(mfm, residual_dtype=torch.int16, **ref)
    with pytest.raises(ValueError, match='reference'):
        build_mobilenetv2_engine(mfm, input_mode='folded_float32', **ref)
    with pytest.raises(ValueError, match='reference'):
        build_inceptionv3_engine(ifm, wide_dtype=torch.int16, **ref)
    with pytest.raises(ValueError, match='reference'):
        build_inceptionv3_engine(ifm, input_mode='folded_float32', **ref)
    for build, fm in ((build_resnet_engine, rfm),
                      (build_mobilenetv2_engine, mfm),
                      (build_inceptionv3_engine, ifm)):
        with pytest.raises(ValueError, match='requant_mode'):
            build(fm, requant_mode='exact', device='cpu')
    for mode in ('float32', 'uint8', 'folded_float32', 'folded_int8'):
        build_resnet_engine(rfm, input_mode=mode, **ref)


def _jax_int_avgpool_3x3():
    """The JAX InceptionV3 engine's own integer average pool (a closure of
    its forward)."""
    fm = jsyn.synthetic_frozen_inception(jget('inceptionv3', 'uniform8'),
                                         num_classes=10, width_div=W, seed=1)
    fwd = jei.build_inceptionv3_engine(fm, width_div=W,
                                       input_hw=(75, 75)).__wrapped__
    return fwd.__closure__[
        fwd.__code__.co_freevars.index('int_avgpool_3x3')].cell_contents


_HW = (1, 2, 3, 5, 8, 17, 35)
_C = (1, 3, 4, 12, 32, 288)
_DTYPES = ((np.int32, 32768), (np.int16, 32768), (np.int8, 128))


@pytest.mark.parametrize('h', _HW)
def test_avgpool_quotient_form_equals_jax(h):
    """int_avgpool3x3 (plain on the CPU) and the walk's quotient form, at
    the rule's plan and ragged tiles, == JAX's int_avgpool_3x3: every W at
    this H, C and the dtype cycled, with a saturated field and a constant
    −9 one (negative multiples of 9)."""
    from tests.test_torch_avgpool_walk import _TORCH, _plans
    pool = _jax_int_avgpool_3x3()
    rng = np.random.RandomState(h)
    for i, w in enumerate(_HW):
        c = _C[(i + h) % len(_C)]
        dt, hi = _DTYPES[(i + h) % 3]
        xs = [rng.randint(-hi, hi, (2, h, w, c)).astype(dt),
              np.full((1, h, w, c), -9, dt)]
        if i % 3 == 0:
            top = np.iinfo(dt).max if dt != np.int32 else 2 ** 31 // 9
            sat = np.full((1, h, w, c), top, dt)
            sat[:, ::2] = -top
            xs.append(sat)
        for k, x in enumerate(xs):
            want = np.asarray(pool(jnp.asarray(x)))
            assert want.dtype == np.int32
            tx = torch.from_numpy(x)
            got = ka.int_avgpool3x3(tx)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
            plans = _plans(x.shape, _TORCH[dt])
            if k or h * w * c > 17 * 17 * 4:   # the rule's plan, one ragged
                plans = plans[:2]
            for plan in plans:
                np.testing.assert_array_equal(
                    ka.avgpool_walk_plain(tx, None, plan=plan).numpy(), want,
                    err_msg=str(plan))
