"""W4A4 and mixed-precision serving in the port == hawq_tpu, bit for bit.

* the host packers and the plain ``int4w_*`` versions (CPU tensors) against
  the JAX package's packers and its Pallas ``int4w_*`` kernels run in
  interpret mode (``pltpu.force_tpu_interpret_mode``);
* the port's engine on 4-bit and mixed configs: ``wide50`` against the JAX
  engine's own packed Pallas route (``use_pallas=True``, interpret mode),
  the others against its default XLA route, on the logits and capture nodes;
* which kernel each layer takes: ``int4w_*`` for exactly the 4-bit layers;
* the ``uint8`` and ``folded_int8`` input modes.

Tolerance 0 everywhere.  The CUDA kernels are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import contextlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hawq_tpu.configs.bit_config import get_bit_config
from hawq_tpu.inference import fold as jfold
from hawq_tpu.inference.engine import build_resnet_engine as jax_engine
from hawq_tpu.inference.synthetic import synthetic_frozen_resnet
from hawq_tpu.kernels import conv as jkc
from hawq_tpu.kernels import matmul as jkm
from hawq_tpu.utils import preproc as jpreproc

import chip_smoke
from hawq_tpu_torch.inference.engine import build_resnet_engine
from hawq_tpu_torch.inference.fold import fold4_images
from hawq_tpu_torch.kernels import conv as tkc
from hawq_tpu_torch.kernels import matmul as tkm
from hawq_tpu_torch.quant.ops import np_dyadic_multiplier
from hawq_tpu_torch.utils.preproc import quantize_int8
from tests.test_torch_engine import _port_fm, _reference_nodes

torch.set_num_threads(1)

# (out_bits, signed, relu): signed 8-bit, with ReLU, unsigned 4-bit + ReLU
_EPILOGUES = [(8, True, False), (8, True, True), (4, False, True)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _w4(rng, shape):
    """int4 weights over the whole range, -8 and 7 included."""
    w = rng.randint(-8, 8, shape).astype(np.int8)
    w.reshape(-1)[:2] = (-8, 7)
    return w


def _vec(rng, n):
    bias = rng.randint(-2 ** 14, 2 ** 14, n).astype(np.int32)
    mult = np_dyadic_multiplier((rng.rand(n) * 2e-3 + 1e-4).astype(np.float32))
    return bias, mult


@pytest.mark.parametrize('k,n,taps', [(64, 32, 1), (10, 3, 1), (54, 7, 9),
                                      (40, 16, 4)])
def test_packers_match_reference(k, n, taps):
    rng = np.random.RandomState(k + n)
    w = _w4(rng, (k, n))
    packed = tkm.pack_int4(w)
    np.testing.assert_array_equal(packed, jkm.pack_int4(w))
    np.testing.assert_array_equal(tkm.unpack_int4(_t(packed)).numpy(),
                                  jkm.unpack_int4(packed))
    conv = tkc.pack_int4_conv(w, taps)
    np.testing.assert_array_equal(conv, jkc.pack_int4_conv(w, taps))
    np.testing.assert_array_equal(
        tkc.unpack_int4_conv(_t(conv), taps).numpy(), w)
    assert packed.dtype == conv.dtype == np.int8
    assert packed.nbytes == conv.nbytes == w.nbytes // 2


def test_packers_reject_bad_weights():
    with pytest.raises(ValueError):
        tkm.pack_int4(np.zeros((5, 4), np.int8))              # odd K
    with pytest.raises(ValueError):
        tkc.pack_int4_conv(np.zeros((9 * 3, 4), np.int8), 9)  # odd C per tap
    with pytest.raises(ValueError):
        tkm.pack_int4(np.full((4, 4), 8, np.int8))            # not int4


@pytest.mark.parametrize('m,k,n', [(64, 96, 40), (37, 46, 19), (8, 256, 128)])
def test_int4w_matmul_plain_matches_pallas(m, k, n):
    rng = np.random.RandomState(m + k + n)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = _w4(rng, (k, n))
    bias, mult = _vec(rng, n)
    wp = jkm.pack_int4(w)
    jx, jw, jb, jm = map(jnp.asarray, (x, wp, bias, mult))
    for out_bits, signed, relu in _EPILOGUES:
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jkm.int4w_matmul_requant(
                jx, jw, jb, jm, out_bits=out_bits, signed=signed, relu=relu))
        got = tkm.int4w_matmul_requant(_t(x), _t(wp), _t(bias), _t(mult),
                                       out_bits=out_bits, signed=signed,
                                       relu=relu).numpy()
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want,
                                      err_msg=f'{out_bits} {signed} {relu}')
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jkm.int4w_matmul_acc(jx, jw, jb))
    got = tkm.int4w_matmul_acc(_t(x), _t(wp), _t(bias)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('shape,cout,stride', [
    ((2, 6, 5, 8), 12, 1),       # stride 1
    ((1, 7, 7, 6), 9, 1),        # C/2 = 3, odd
    ((1, 8, 6, 10), 16, 2),      # space-to-depth stride 2: taps 2×2, C 40
    ((1, 9, 7, 6), 5, 2)])       # stride 2 over C/2 odd, odd H and W
def test_int4w_conv_plain_matches_pallas(shape, cout, stride):
    """The engine's routing of a 3×3/pad-1 conv: stride 1 over the padded
    slab, stride 2 through the space-to-depth rewrite, weights packed per
    tap."""
    rng = np.random.RandomState(sum(shape) + cout + stride)
    x8 = rng.randint(-128, 128, shape).astype(np.int8)
    w = _w4(rng, (3, 3, shape[3], cout))
    bias, mult = _vec(rng, cout)
    b, h, wd, _ = shape
    if stride == 2:
        x2, w = jkc.s2d_conv_transform(jnp.asarray(x8), w, 1)
        oh, ow = jkc.s2d_output_hw(h, wd, 3, 3, 1)
        xp = np.asarray(jkc.prepare_conv_input(x2, (0, 0)))
    else:
        oh, ow = h, wd
        xp = np.asarray(jkc.prepare_conv_input(jnp.asarray(x8), (1, 1)))
    taps = w.shape[:2]
    wp = tkc.pack_int4_conv(tkc.flatten_conv_kernel(w), taps[0] * taps[1])
    geo = dict(taps=taps, out_hw=(oh, ow), cin=w.shape[2])
    jx, jw, jb, jm = map(jnp.asarray, (xp, wp, bias, mult))
    for out_bits, signed, relu in _EPILOGUES:
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jkc.int4w_conv_requant(
                jx, jw, jb, jm, out_bits=out_bits, signed=signed, relu=relu,
                **geo))
        got = tkc.int4w_conv_requant(_t(xp), _t(wp), _t(bias), _t(mult),
                                     out_bits=out_bits, signed=signed,
                                     relu=relu, **geo).numpy()
        assert got.dtype == np.int8 and got.shape == (b, oh * ow, cout)
        np.testing.assert_array_equal(got, want,
                                      err_msg=f'{out_bits} {signed} {relu}')
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jkc.int4w_conv_acc(jx, jw, jb, **geo))
    got = tkc.int4w_conv_acc(_t(xp), _t(wp), _t(bias), **geo).numpy()
    np.testing.assert_array_equal(got, want)


def test_wide50_uniform4_matches_pallas_engine():
    """Against the JAX engine's own packed route: use_pallas=True sends
    wide50's 128-aligned 4-bit convs through its int4w Pallas kernels."""
    fm = synthetic_frozen_resnet('wide50', get_bit_config('wide50', 'uniform4'),
                                 num_classes=16, seed=3)
    x = np.random.RandomState(4).rand(1, 32, 32, 3).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_engine(fm, use_pallas=True)(jnp.asarray(x)))
    got = build_resnet_engine(_port_fm(fm), device='cpu')(x).numpy()
    np.testing.assert_array_equal(got, want)


_NODES = ('init', 'stage2.unit1.conv1', 'stage2.unit1.quant_act_int32',
          'avg_pool', 'fc_input', 'fc_output')


@pytest.mark.parametrize('arch,scheme,input_mode', [
    ('tiny18', 'uniform4', 'float32'), ('tiny50', 'uniform4', 'folded_float32'),
    ('resnet18', 'bops_0.5', 'folded_float32'),
    ('resnet50', 'bops_0.5', 'folded_float32')])
def test_int4_engine_matches_reference(arch, scheme, input_mode):
    """64×64, batch 1, int16 carrier: logits and capture nodes against the
    eager XLA reference (every node for the tiny archs)."""
    fm = synthetic_frozen_resnet(arch, get_bit_config(arch, scheme),
                                 num_classes=16, seed=5)
    x = np.random.RandomState(6).randn(1, 64, 64, 3).astype(np.float32)
    if input_mode == 'folded_float32':
        x = jfold.fold4_images(x)
    nodes = _reference_nodes(fm, x, input_mode=input_mode,
                             residual_dtype=jnp.int16)
    check = nodes if arch.startswith('tiny') else _NODES
    for node in check:
        port = build_resnet_engine(_port_fm(fm), capture=node,
                                   input_mode=input_mode,
                                   residual_dtype=torch.int16,
                                   device='cpu')(x).numpy()
        assert port.dtype == nodes[node].dtype, node
        np.testing.assert_array_equal(port, nodes[node], err_msg=node)
    want = np.asarray(jax_engine(fm, input_mode=input_mode,
                                 residual_dtype=jnp.int16)(jnp.asarray(x)))
    got = build_resnet_engine(_port_fm(fm), input_mode=input_mode,
                              residual_dtype=torch.int16, device='cpu')(x)
    np.testing.assert_array_equal(got.numpy(), want)


@contextlib.contextmanager
def _recording(calls):
    """Record (wrapper name, weight tensor) of every kernel-wrapper call."""
    names = {tkm: ('int8_matmul_requant', 'int8_matmul_acc',
                   'int4w_matmul_requant', 'int4w_matmul_acc',
                   'int8_matmul_acc_residual',
                   'int8_matmul_acc_residual_requant',
                   'int8_matmul_residual_requant'),
             tkc: ('int8_conv_requant', 'int8_conv_acc',
                   'int4w_conv_requant', 'int4w_conv_acc')}
    orig = {(mod, n): getattr(mod, n) for mod, ns in names.items()
            for n in ns}

    def recorder(mod, name):
        def call(*args, **kw):
            calls.append((name, args[1]))
            return orig[mod, name](*args, **kw)
        return call
    for mod, name in orig:
        setattr(mod, name, recorder(mod, name))
    try:
        yield
    finally:
        for (mod, name), fn in orig.items():
            setattr(mod, name, fn)


@pytest.mark.parametrize('arch,scheme', [('resnet50', 'bops_0.5'),
                                         ('resnet18', 'bops_0.5'),
                                         ('resnet50', 'uniform4')])
def test_int4w_kernels_take_exactly_the_4bit_layers(arch, scheme):
    cfg = get_bit_config(arch, scheme)
    fm = _port_fm(synthetic_frozen_resnet(arch, cfg, num_classes=10, seed=0))
    eng = build_resnet_engine(fm, input_mode='folded_float32', device='cpu')
    x = fold4_images(np.random.RandomState(1).randn(1, 32, 32, 3)
                     .astype(np.float32))
    calls = []
    with _recording(calls):
        eng(x)
    owner = {id(v[0]): (k if isinstance(k, str) else k[0])
             for k, v in eng._w.items()}
    layers = {}
    for name, w in calls:
        key = owner[id(w)]
        layers[key] = name
        want4 = key not in ('init', 'quant_output') and \
            cfg.weight_bits(key) == 4
        assert name.startswith('int4w') == want4, (key, name)
    convs = [k[:-len('.weight_int')] for k in fm.tensors
             if k.endswith('.weight_int')]
    assert len(layers) == len(convs)          # every conv and the FC, once
    n4 = sum(n.startswith('int4w') for n in layers.values())
    assert n4 == {('resnet50', 'bops_0.5'): 19, ('resnet18', 'bops_0.5'): 9,
                  ('resnet50', 'uniform4'): 52}[arch, scheme]
    counts = {}
    for name, _ in calls:
        counts[name] = counts.get(name, 0) + 1
    want = chip_smoke.expected_launches(arch, cfg, 'folded_float32')
    want.pop('maxpool_folded_requant')        # the folded init's pool
    want.pop('requant_int32')                 # the unit entry requants
    assert counts == want


def test_uint8_input_matches_reference():
    fm = synthetic_frozen_resnet('tiny18', get_bit_config('tiny18', 'uniform4'),
                                 num_classes=10, seed=7)
    u8 = np.random.RandomState(8).randint(0, 256, (2, 32, 32, 3)).astype(
        np.uint8)
    mean = np.array([0.5, 0.45, 0.4], np.float32)
    std = np.array([0.25, 0.2, 0.22], np.float32)
    for kw in ({}, dict(input_mean=mean, input_std=std)):
        for capture in ('input', None):
            want = np.asarray(jax_engine(fm, capture=capture, input_mode='uint8',
                                         **kw)(jnp.asarray(u8)))
            got = build_resnet_engine(_port_fm(fm), capture=capture,
                                      input_mode='uint8', device='cpu',
                                      **kw)(u8).numpy()
            np.testing.assert_array_equal(got, want, err_msg=str(capture))


def test_folded_int8_input_matches_reference():
    """Host fold + host quantization: the port's numpy quantize_int8 equals
    the JAX package's, the pad pixels quantize to 0, and the engine on the
    int8 input equals JAX's and its own folded_float32 run."""
    fm = synthetic_frozen_resnet('tiny50', get_bit_config('tiny50', 'uniform4'),
                                 num_classes=10, seed=9)
    x = np.random.RandomState(10).randn(2, 32, 32, 3).astype(np.float32) * 3
    s_in = fm.act_scale('quant_input')
    xf = fold4_images(x)
    x8 = quantize_int8(xf, s_in)
    np.testing.assert_array_equal(x8, jpreproc.quantize_int8(xf, s_in))
    pad_pixels = fold4_images(np.ones_like(x)) == 0
    assert pad_pixels.any() and not x8[pad_pixels].any()
    assert x8.min() == -128 and x8.max() == 127      # the clip is exercised
    want = np.asarray(jax_engine(fm, input_mode='folded_int8',
                                 residual_dtype=jnp.int16)(jnp.asarray(x8)))
    eng = build_resnet_engine(_port_fm(fm), input_mode='folded_int8',
                              residual_dtype=torch.int16, device='cpu')
    got = eng(x8).numpy()
    np.testing.assert_array_equal(got, want)
    flt = build_resnet_engine(_port_fm(fm), input_mode='folded_float32',
                              residual_dtype=torch.int16, device='cpu')(xf)
    np.testing.assert_array_equal(got, flt.numpy())
