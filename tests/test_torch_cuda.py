"""CUDA kernels == their plain PyTorch versions on the card, bit for bit
(the int8 and the nibble-packed int4-weight forms, the K-blocked matmul,
each class of operands the GEMM core's alignment step zero-pads, the
accumulator matmul's residual epilogue against the composition it
replaces, and with the next unit's entry requant against that epilogue
followed by the standalone requant, the folded pool and its requant-in-front form, the one-pass
min/max, D1's depthwise conv and A1's average pool, with and without the
requant in front), and the engines, the
integer conv of the QAT layers, a QAT forward and the Hutchinson HVP on
the card == on the CPU; a QONNX file's replay == the card engine; the
ServingEngine in a one-process ``nccl`` group == the engine, two
``gloo`` ranks sharing the card == one process's train step, and an
engine's saved ``torch.export`` program == the engine, its launches per
kernel included.

These need an NVIDIA GPU with nvcc (they build the kernels) and skip
without one.  They import only torch and hawq_tpu_torch, so they run on a
machine without JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from hawq_tpu_torch.configs.bit_config import get_bit_config
from hawq_tpu_torch.inference.engine import build_resnet_engine
from hawq_tpu_torch.inference.fold import fold4_images, maxpool_3x3s2p1_folded
from hawq_tpu_torch.inference.synthetic import synthetic_frozen_resnet
from hawq_tpu_torch.kernels import _build
from hawq_tpu_torch.kernels import avgpool as ka
from hawq_tpu_torch.kernels import conv as kc
from hawq_tpu_torch.kernels import matmul as km
from hawq_tpu_torch.kernels import pool as kp
from hawq_tpu_torch.kernels.pool import maxpool_folded
from hawq_tpu_torch.kernels.reduce import minmax_1pass, minmax_plain
from hawq_tpu_torch.models.resnet import QResNet
from hawq_tpu_torch.nn import layers as L
from hawq_tpu_torch.quant.ops import (dyadic_multiplier, exact_div,
                                      np_dyadic_multiplier)
from hawq_tpu_torch.utils.preproc import quantize_int8

pytestmark = pytest.mark.cuda

_EPILOGUES = [(8, True, False), (8, True, True), (4, False, True)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _operands(rng, m, k, n, dev):
    x = torch.tensor(rng.randint(-128, 128, (m, k)).astype(np.int8), device=dev)
    w = torch.tensor(rng.randint(-127, 128, (k, n)).astype(np.int8), device=dev)
    b = torch.tensor(rng.randint(-2 ** 16, 2 ** 16, n).astype(np.int32),
                     device=dev)
    mult = torch.tensor(np_dyadic_multiplier(
        (rng.rand(n) * 2e-4 + 1e-5).astype(np.float32)), device=dev)
    return x, w, b, mult


@pytest.mark.parametrize('m,k,n', [(37, 45, 19), (64, 64, 64), (130, 256, 72),
                                   (8, 2048, 1000), (392, 2048, 512), (3, 5, 2)])
def test_matmul_kernel_equals_plain(dev, m, k, n):
    rng = np.random.RandomState(m + k + n)
    x, w, b, mult = _operands(rng, m, k, n, dev)
    for out_bits, signed, relu in _EPILOGUES:
        lo, hi = km.epilogue_bounds(out_bits, signed, relu)
        got = km.int8_matmul_requant(x, w, b, mult, out_bits=out_bits,
                                     signed=signed, relu=relu)
        torch.testing.assert_close(got, km.matmul_requant_plain(
            x, w, b, mult, lo, hi), rtol=0, atol=0)
    torch.testing.assert_close(km.int8_matmul_acc(x, w, b),
                               km.matmul_acc_plain(x, w, b), rtol=0, atol=0)


@pytest.mark.parametrize('shape,cout,stride', [
    ((2, 9, 7, 5), 11, 1), ((2, 9, 7, 5), 11, 2), ((2, 14, 14, 64), 64, 1),
    ((1, 12, 10, 32), 40, 2), ((2, 16, 16, 3), 16, 1)])
def test_conv_kernel_equals_plain(dev, shape, cout, stride):
    rng = np.random.RandomState(sum(shape) + cout)
    x8 = torch.tensor(rng.randint(-128, 128, shape).astype(np.int8), device=dev)
    w = rng.randint(-127, 128, (3, 3, shape[3], cout)).astype(np.int8)
    b, h, wd, _ = shape
    if stride == 2:
        x2, w = kc.s2d_conv_transform(x8, w, 1)
        oh, ow = kc.s2d_output_hw(h, wd, 3, 3, 1)
        xp = kc.prepare_conv_input(x2, (0, 0))
    else:
        oh, ow = h, wd
        xp = kc.prepare_conv_input(x8, (1, 1))
    wf = torch.tensor(kc.flatten_conv_kernel(w), device=dev)
    _, _, bias, mult = _operands(rng, 1, 1, cout, dev)
    geo = dict(taps=w.shape[:2], out_hw=(oh, ow), cin=w.shape[2])
    for out_bits, signed, relu in _EPILOGUES:
        lo, hi = km.epilogue_bounds(out_bits, signed, relu)
        got = kc.int8_conv_requant(xp, wf, bias, mult, out_bits=out_bits,
                                   signed=signed, relu=relu, **geo)
        torch.testing.assert_close(got, kc.conv_requant_plain(
            xp, wf, bias, mult, lo=lo, hi=hi, **geo), rtol=0, atol=0)
    torch.testing.assert_close(kc.int8_conv_acc(xp, wf, bias, **geo),
                               kc.conv_acc_plain(xp, wf, bias, **geo),
                               rtol=0, atol=0)


def _w4(rng, shape):
    """int4 weights over the whole range, -8 and 7 included."""
    w = rng.randint(-8, 8, shape).astype(np.int8)
    w.reshape(-1)[:2] = (-8, 7)
    return w


@pytest.mark.parametrize('m,k,n', [(37, 46, 19), (3, 6, 2), (130, 200, 72),
                                   (392, 2048, 512)])     # last: stage-4 conv1
def test_int4w_matmul_kernel_equals_plain(dev, m, k, n):
    rng = np.random.RandomState(m + k + n)
    _, _, b, mult = _operands(rng, 1, 1, n, dev)
    x = torch.tensor(rng.randint(-128, 128, (m, k)).astype(np.int8),
                     device=dev)
    wp = torch.tensor(km.pack_int4(_w4(rng, (k, n))), device=dev)
    for out_bits, signed, relu in _EPILOGUES:
        lo, hi = km.epilogue_bounds(out_bits, signed, relu)
        got = km.int4w_matmul_requant(x, wp, b, mult, out_bits=out_bits,
                                      signed=signed, relu=relu)
        torch.testing.assert_close(got, km.matmul_requant_plain(
            x, km.unpack_int4(wp), b, mult, lo, hi), rtol=0, atol=0)
    torch.testing.assert_close(km.int4w_matmul_acc(x, wp, b),
                               km.matmul_acc_plain(x, km.unpack_int4(wp), b),
                               rtol=0, atol=0)


@pytest.mark.parametrize('shape,cout,stride', [
    ((2, 9, 7, 6), 11, 1), ((1, 12, 10, 10), 9, 2), ((1, 9, 7, 6), 5, 2),
    ((2, 33, 31, 64), 72, 1), ((8, 7, 7, 512), 512, 1)])  # last: stage-4 conv2
def test_int4w_conv_kernel_equals_plain(dev, shape, cout, stride):
    rng = np.random.RandomState(sum(shape) + cout)
    x8 = torch.tensor(rng.randint(-128, 128, shape).astype(np.int8), device=dev)
    w = _w4(rng, (3, 3, shape[3], cout))
    b, h, wd, _ = shape
    if stride == 2:
        x2, w = kc.s2d_conv_transform(x8, w, 1)
        oh, ow = kc.s2d_output_hw(h, wd, 3, 3, 1)
        xp = kc.prepare_conv_input(x2, (0, 0))
    else:
        oh, ow = h, wd
        xp = kc.prepare_conv_input(x8, (1, 1))
    taps = w.shape[:2]
    wp = torch.tensor(kc.pack_int4_conv(kc.flatten_conv_kernel(w),
                                        taps[0] * taps[1]), device=dev)
    wf = kc.unpack_int4_conv(wp, taps[0] * taps[1])
    _, _, bias, mult = _operands(rng, 1, 1, cout, dev)
    geo = dict(taps=taps, out_hw=(oh, ow), cin=w.shape[2])
    for out_bits, signed, relu in _EPILOGUES:
        lo, hi = km.epilogue_bounds(out_bits, signed, relu)
        got = kc.int4w_conv_requant(xp, wp, bias, mult, out_bits=out_bits,
                                    signed=signed, relu=relu, **geo)
        torch.testing.assert_close(got, kc.conv_requant_plain(
            xp, wf, bias, mult, lo=lo, hi=hi, **geo), rtol=0, atol=0)
    torch.testing.assert_close(kc.int4w_conv_acc(xp, wp, bias, **geo),
                               kc.conv_acc_plain(xp, wf, bias, **geo),
                               rtol=0, atol=0)


def test_int4w_wrappers_reject_odd_k(dev):
    x = torch.zeros((4, 5), dtype=torch.int8, device=dev)
    wp = torch.zeros((2, 8), dtype=torch.int8, device=dev)
    b = torch.zeros((8,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        km.int4w_matmul_acc(x, wp, b)
    xp = torch.zeros((1, 3, 3 * 3), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        kc.int4w_conv_acc(xp, torch.zeros((4, 8), dtype=torch.int8,
                                          device=dev), b,
                          taps=(3, 3), out_hw=(1, 1), cin=3)


@pytest.mark.parametrize('dtype', [torch.int16, torch.int32, torch.float32])
def test_pool_kernel_equals_plain(dev, dtype):
    rng = np.random.RandomState(1)
    for shape in ((2, 7, 9, 20), (2, 56, 56, 256)):
        xf = torch.tensor(rng.randint(-2 ** 14, 2 ** 14, shape),
                          device=dev).to(dtype)
        torch.testing.assert_close(maxpool_folded(xf),
                                   maxpool_3x3s2p1_folded(xf), rtol=0, atol=0)


def test_wrappers_check_layout(dev):
    x = torch.zeros((16, 32), dtype=torch.int8, device=dev)
    w = torch.zeros((32, 8), dtype=torch.int8, device=dev)
    b = torch.zeros((8,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        km.int8_matmul_acc(x.t(), w, b)                 # not contiguous
    with pytest.raises(ValueError):
        km.int8_matmul_acc(x, w, b.cpu())               # wrong device


def test_exact_div_cuda_equals_cpu(dev):
    x = torch.randn(1 << 20, generator=torch.Generator().manual_seed(0)) * 4
    for s in (np.float32(0.0517), np.float32(0.0493), 49):
        torch.testing.assert_close(exact_div(x.to(dev), s).cpu(),
                                   exact_div(x, s), rtol=0, atol=0)


@pytest.mark.parametrize('arch,mode,scheme', [
    ('tiny50', 'folded_float32', 'uniform8'), ('tiny18', 'float32', 'uniform8'),
    ('resnet20_cifar', 'float32', 'uniform8'),
    ('tiny18', 'float32', 'uniform4'), ('tiny18', 'uint8', 'uniform4'),
    ('tiny50', 'folded_int8', 'uniform4')])
def test_engine_cuda_equals_cpu(dev, arch, mode, scheme):
    fm = synthetic_frozen_resnet(arch, get_bit_config(arch, scheme),
                                 num_classes=10, seed=1)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    if mode == 'uint8':
        x = rng.randint(0, 256, x.shape).astype(np.uint8)
    if mode.startswith('folded'):
        x = fold4_images(x)
    if mode == 'folded_int8':
        x = quantize_int8(x, fm.act_scale('quant_input'))
    want = build_resnet_engine(fm, input_mode=mode, device='cpu')(x)
    _build.reset_launches()
    got = build_resnet_engine(fm, input_mode=mode, device=dev)(x)
    assert sum(_build.LAUNCHES.values()) > 0
    if scheme == 'uniform4':
        assert _build.LAUNCHES.get('int4w_conv_requant', 0) > 0
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.parametrize('shape', [(1,), (3,), (777,), (2, 56, 56, 128),
                                   (32, 112, 112, 64), (5, 1031), (4099,)])
def test_minmax_kernel_equals_plain(dev, shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(
        sum(shape))).to(dev)
    for t in (x, x.reshape(-1)[1:] if x.numel() > 1 else x,   # unaligned
              x.reshape(-1)[3:] if x.numel() > 3 else x):
        got, want = minmax_1pass(t), minmax_plain(t)
        for g, w_ in zip(got, want):
            assert g.shape == () and g.device == t.device
            torch.testing.assert_close(g, w_, rtol=0, atol=0)


@pytest.mark.parametrize('case', ['nan', 'posinf', 'neginf', 'strided',
                                  'nan_in_tail'])
def test_minmax_kernel_edge_cases(dev, case):
    x = torch.randn(70001, generator=torch.Generator().manual_seed(1)).to(dev)
    if case == 'nan':
        x[12345] = float('nan')
    elif case == 'nan_in_tail':
        x[-1] = float('nan')
    elif case == 'posinf':
        x[7] = float('inf')
    elif case == 'neginf':
        x[-2] = float('-inf')
    elif case == 'strided':
        x = x[::3]
    got, want = minmax_1pass(x), minmax_plain(x)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError):
        minmax_1pass(x[:0])
    with pytest.raises(ValueError):
        minmax_1pass(x.to(torch.float16))


def test_dyadic_multiplier_cuda_equals_host(dev):
    rng = np.random.RandomState(0)
    r = np.exp(rng.uniform(np.log(1e-7), np.log(50.0), 1 << 16)).astype(
        np.float32)
    got = dyadic_multiplier(torch.tensor(r, device=dev)).cpu().numpy()
    np.testing.assert_array_equal(got, np_dyadic_multiplier(r))


@pytest.mark.parametrize('k,s,pad,c,o,h', [
    (1, 1, 'VALID', 64, 256, 14), (1, 2, 'VALID', 256, 512, 14),
    (3, 1, ((1, 1), (1, 1)), 64, 64, 14), (3, 2, ((1, 1), (1, 1)), 32, 40, 13),
    (7, 2, ((3, 3), (3, 3)), 3, 64, 64), (3, 2, 'SAME', 5, 7, 10)])
def test_int_conv2d_cuda_equals_cpu(dev, k, s, pad, c, o, h):
    rng = np.random.RandomState(k + s + c)
    x = rng.randint(-128, 128, (2, h, h, c)).astype(np.float32)
    w = rng.randint(-127, 128, (k, k, c, o)).astype(np.float32)
    b = rng.randint(-2 ** 20, 2 ** 20, (o,)).astype(np.float32)
    with torch.no_grad():
        shape = L.int_conv2d(torch.tensor(x), torch.tensor(w),
                             torch.tensor(b), (s, s), pad).shape
    g = rng.randn(*shape).astype(np.float32)
    outs = {}
    for name, device in (('cpu', 'cpu'), ('cuda', dev)):
        tx, tw, tb = (torch.tensor(a, device=device, requires_grad=True)
                      for a in (x, w, b))
        with L.faithful_float_math():
            y = L.int_conv2d(tx, tw, tb, (s, s), pad)
            y.backward(torch.tensor(g, device=device))
        outs[name] = [t.detach().cpu() for t in (y, tx.grad, tw.grad,
                                                  tb.grad)]
    torch.testing.assert_close(outs['cuda'][0], outs['cpu'][0], rtol=0,
                               atol=0)
    # cuDNN against the CPU's float convolutions: other summation orders
    for got, want in zip(outs['cuda'][1:], outs['cpu'][1:]):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize('arch,scheme', [('tiny50', 'uniform8'),
                                         ('tiny18', 'uniform4')])
def test_qat_forward_cuda_equals_cpu(dev, arch, scheme):
    """Calibration passes and a frozen-range forward: ranges, every q_int
    and the logits on the card equal the CPU's."""
    x = np.random.RandomState(4).randn(2, 32, 32, 3).astype(np.float32)
    results = {}
    for name, device in (('cpu', torch.device('cpu')), ('cuda', dev)):
        model = QResNet(arch, get_bit_config(arch, scheme), 10, seed=3).to(
            device)
        xt = torch.tensor(x, device=device)
        _build.reset_launches()
        with torch.no_grad(), L.capture_q_int(model) as q:
            for _ in range(2):
                model(xt, folded=True, update_stats=True)
            logits = model(xt, folded=True, update_stats=False)
        results[name] = ({k: v.cpu() for k, v in q.items()},
                         {k: v.cpu() for k, v in model.named_buffers()},
                         logits.cpu())
    assert _build.LAUNCHES.get('minmax_1pass', 0) > 0
    assert _build.LAUNCHES.get('int8_conv_acc', 0) > 0
    for got, want in zip(results['cuda'][:2], results['cpu'][:2]):
        assert sorted(got) == sorted(want)
        for key in want:
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0,
                                       msg=key)
    torch.testing.assert_close(results['cuda'][2], results['cpu'][2], rtol=0,
                               atol=0)


def test_qat_train_step_cuda_equals_cpu(dev):
    """One folded train step of tiny18 (every int8_conv_acc call at widths
    the Hopper core takes: the channel-padded 7×7/s2 init, the 3×3 convs,
    the 3×3/s2 through space-to-depth) on the card == on the CPU: every
    q_int and range bit-equal, the loss and the gradients within rtol 1e-3
    (cuDNN / cuBLAS against the CPU's float convolutions)."""
    from hawq_tpu_torch.models.resnet import qat_from_numpy, qat_to_numpy
    from hawq_tpu_torch.train.train import (TrainState, make_train_step,
                                            sgd_with_step_decay)
    cfg = get_bit_config('tiny18', 'uniform8')
    rng = np.random.RandomState(4)
    images = rng.randn(2, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, (2,))
    cpu = QResNet('tiny18', cfg, 10, seed=0)
    with torch.no_grad():
        for _ in range(2):
            cpu(torch.from_numpy(images), folded=True, update_stats=True)
    card = qat_from_numpy(QResNet('tiny18', cfg, 10, seed=1).to(dev),
                          qat_to_numpy(cpu))
    out = {}
    for name, model, device in (('cpu', cpu, 'cpu'), ('card', card, dev)):
        state = TrainState.create(model, sgd_with_step_decay(model, 1e-4))
        batch = {'image': torch.from_numpy(images).to(device),
                 'label': torch.from_numpy(labels).to(device)}
        _build.reset_launches()
        with L.capture_q_int(model) as q:
            _, metrics = make_train_step(model, folded=True)(state, batch)
        out[name] = dict(
            q={k: v.cpu() for k, v in q.items()},
            ranges={k: v.cpu() for k, v in model.named_buffers()
                    if k.endswith(('x_min', 'x_max'))},
            grads={k: p.grad.cpu() for k, p in model.named_parameters()},
            loss=float(metrics['loss']))
    assert _counts()['int8_conv_acc'] == 7      # init + six 3×3
    for kind in ('q', 'ranges'):
        assert sorted(out['card'][kind]) == sorted(out['cpu'][kind])
        for k, want in out['cpu'][kind].items():
            torch.testing.assert_close(out['card'][kind][k], want, rtol=0,
                                       atol=0, msg=f'{kind} {k}')
    assert abs(out['card']['loss'] - out['cpu']['loss']) <= 1e-5 * abs(
        out['cpu']['loss'])
    for k, want in out['cpu']['grads'].items():
        torch.testing.assert_close(out['card']['grads'][k], want, rtol=1e-3,
                                   atol=1e-3 * float(want.abs().max()),
                                   msg=k)


# ---------------------------------------------------------------------------
# the Hopper GEMM core (csrc/gemm_s8_sm90.cuh) under the four matmuls and
# the four convs
# ---------------------------------------------------------------------------

# the int8_matmul_acc shapes of ResNet-50 at batch 8 (conv3, identity, FC)
# and of a batch-32 QAT step, then ragged ones: M, K, N off the tiles, K
# padded up to 64 and to 128, N = 1000, M = 1
_SM90_MATMULS = [(25088, 64, 256), (6272, 128, 512), (6272, 256, 512),
                 (1568, 256, 1024), (1568, 512, 1024), (392, 512, 2048),
                 (392, 1024, 2048), (8, 2048, 1000), (100352, 64, 256),
                 (100352, 256, 64), (32, 2048, 1000), (37, 48, 20),
                 (1000, 2048, 1000), (1, 16, 4), (130, 80, 72),
                 (65, 192, 36)]


@pytest.mark.parametrize('m,k,n', _SM90_MATMULS)
def test_sm90_matmul_acc_equals_plain(dev, m, k, n):
    rng = np.random.RandomState(m + k + n)
    x, w, b, _ = _operands(rng, m, k, n, dev)
    if k >= 2048:                   # saturated operands: |acc| passes 2**24
        x[0, :] = -128
        w[:, 0] = 127
        w[:, 1] = -127
    want = km.matmul_acc_plain(x, w, b)
    prepared = km.prepare_weights(w)
    torch.testing.assert_close(km.matmul_acc_kmajor_plain(x, prepared, b),
                               want, rtol=0, atol=0)
    _build.reset_launches()
    for tile_n in (None, 32, 64, 128):
        for weights in (w, prepared):
            got = km.int8_matmul_acc(x, weights, b, tile_n=tile_n)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert _counts() == {'int8_matmul_acc': 8}


# the residual form's operand regimes (``_residual_operands``)
RESIDUAL_CASES = ('carrier', 'id_conv', 'ties', 'past_2_24', 'negative')


def _residual_operands(case, m, k, n):
    """``int8_matmul_acc_residual``'s operands (x, w, bias, identity,
    mult_main, mult_id; numpy) in one regime: 'carrier', a non-negative
    identity (a previous carrier) with one multiplier, a 0-d array;
    'id_conv', a signed identity conv's accumulator with per-channel
    multipliers; 'ties', multipliers 2⁻¹ and 2⁻², whose products land on
    .5; 'past_2_24', unit multipliers and sums on both sides of 2²⁴, where
    int32 → float32 and the float32 add round; 'negative', most sums below
    0, which the ReLU zeroes."""
    rng = np.random.RandomState(m + k + n + RESIDUAL_CASES.index(case))
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    bias = rng.randint(-2 ** 16, 2 ** 16, n).astype(np.int32)

    def dyadic(scale, shape):       # multipliers of about ``scale``
        return np_dyadic_multiplier(
            np.asarray(scale * (0.5 + rng.rand(*shape)), np.float32))
    acc_rms = 5500.0 * np.sqrt(k)   # ≈ the accumulator's spread
    mult_main = dyadic(64 / acc_rms, (n,))
    identity = rng.randint(-2 ** 20, 2 ** 20, (m, n)).astype(np.int32)
    mult_id = dyadic(64 / 2 ** 20, (n,))
    if case == 'carrier':
        identity = rng.randint(0, 2 ** 15, (m, n)).astype(np.int32)
        mult_id = dyadic(64 / 2 ** 15, ())
    elif case == 'ties':
        mult_main = np.where(np.arange(n) % 2, 0.5, 0.25).astype(np.float32)
        mult_id = np.full(n, 0.5, np.float32)
        identity = rng.randint(-2 ** 10, 2 ** 10, (m, n)).astype(np.int32)
    elif case == 'past_2_24':
        x = rng.randint(-2, 3, (m, k)).astype(np.int8)
        w = rng.randint(-2, 3, (k, n)).astype(np.int8)
        bias = (2 ** 24 + rng.randint(-300, 300, n)).astype(np.int32)
        mult_main = np.ones(n, np.float32)
        identity = rng.randint(-300, 300, (m, n)).astype(np.int32)
        mult_id = np.ones(n, np.float32)
    elif case == 'negative':
        bias = np.full(n, -int(acc_rms), np.int32)
        identity = rng.randint(-2 ** 20, 2 ** 18, (m, n)).astype(np.int32)
    return x, w, bias, identity, mult_main, mult_id


# ResNet-50's conv3 (K, N, H = W), each stage's
_R50_CONV3 = [(64, 256, 56), (128, 512, 28), (256, 1024, 14), (512, 2048, 7)]


@pytest.mark.parametrize('identity', ['carrier', 'id_conv'])
@pytest.mark.parametrize('batch,k,n,hw', [(8, *s) for s in _R50_CONV3]
                         + [(1, 512, 2048, 7), (64, 64, 256, 56)])
def test_sm90_residual_equals_the_plain_composition(dev, batch, k, n, hw,
                                                    identity):
    """``int8_matmul_acc_residual`` at ResNet-50's conv3 shapes (b8, a b1
    of 49 rows: a ragged tile, one b64) on the Hopper core, on the handle
    and on plain weights, == the plain composition (the accumulator, then
    the requant-add and ReLU), bit for bit."""
    m = batch * hw * hw
    x, w, b, idt, mm, mi = (torch.tensor(a, device=dev) for a in
                            _residual_operands(identity, m, k, n))
    mi_n = mi.expand(n).contiguous()
    want = km.residual_epilogue(km.matmul_acc_plain(x, w, b), mm, idt, mi)
    prepared = km.prepare_weights(w)
    _build.reset_launches()
    got = km.int8_matmul_acc_residual(x, prepared, b, idt, mm, mi_n)
    plain_w = km.int8_matmul_acc_residual(x, w, b, idt, mm, mi_n)
    assert _counts() == {km.RESIDUAL: 2}
    torch.testing.assert_close(plain_w, want, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bool((got == 0).any()) and bool((got > 0).any())


@pytest.mark.parametrize('tile_n', [None, 32, 64, 128])
@pytest.mark.parametrize('m,k,n', [(130, 80, 72), (49, 512, 2048),
                                   (64, 64, 36), (1, 16, 4)])
@pytest.mark.parametrize('case', RESIDUAL_CASES)
def test_sm90_residual_regimes_equal_plain(dev, case, m, k, n, tile_n):
    """Every operand regime of ``_residual_operands`` at ragged shapes (M,
    K and N off the tiles, N off a 32-column chunk) and every tile width:
    the Hopper core == the plain composition, bit for bit."""
    x, w, b, idt, mm, mi = (torch.tensor(a, device=dev) for a in
                            _residual_operands(case, m, k, n))
    want = km.residual_epilogue(km.matmul_acc_plain(x, w, b), mm, idt, mi)
    got = km.int8_matmul_acc_residual(x, km.prepare_weights(w), b, idt, mm,
                                      mi.expand(n).contiguous(),
                                      tile_n=tile_n)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _entry_mult(carrier, hi=127):
    """A dyadic scalar multiplier that spreads ``carrier`` over the entry's
    range and past it (the clip), on its device."""
    return torch.tensor(np_dyadic_multiplier(np.float32(
        2 * hi / max(float(carrier.max()), 1.0))), device=carrier.device)


@pytest.mark.parametrize('carrier', [True, False])
@pytest.mark.parametrize('case,m,k,n,tile_n', [
    (case, 2 * hw * hw, k, n, None) for k, n, hw in _R50_CONV3
    for case in ('carrier', 'id_conv')]
    + [('id_conv', m, k, n, t) for m, k, n in ((130, 80, 72), (49, 64, 36))
       for t in (None, 32, 64, 128)])
def test_sm90_residual_requant_equals_residual_then_r1(dev, case, m, k, n,
                                                      tile_n, carrier):
    """``int8_matmul_acc_residual_requant`` (carrier and entry) and
    ``int8_matmul_residual_requant`` (the entry alone, the carrier not
    stored) on the Hopper core == ``int8_matmul_acc_residual``, then R1
    (``kernels.requant.requant_int32``) over its carrier, bit for bit:
    every ResNet-50 conv3 shape at b2, and ragged M, K and N (N off 16) at
    every tile width, so both ring depths and the three tile widths of the
    ENTRY epilogue run; one launch each."""
    from hawq_tpu_torch.kernels import requant as kr
    x, w, b, idt, mm, mi = (torch.tensor(a, device=dev) for a in
                            _residual_operands(case, m, k, n))
    mi = mi.expand(n).contiguous()
    prepared = km.prepare_weights(w)
    carried = km.int8_matmul_acc_residual(x, prepared, b, idt, mm, mi)
    mult_in = _entry_mult(carried)
    want = kr.requant_int32(carried, mult_in, out_bits=8, signed=True)
    assert bool((want == 127).any()) and bool((want == 0).any())
    args = (x, prepared, b, idt, mm, mi, mult_in)
    _build.reset_launches()
    if carrier:
        got_c, got = km.int8_matmul_acc_residual_requant(*args,
                                                         tile_n=tile_n)
        torch.testing.assert_close(got_c, carried, rtol=0, atol=0)
        assert _counts() == {km.RESIDUAL_REQUANT: 1}
    else:
        got = km.int8_matmul_residual_requant(*args, tile_n=tile_n)
        assert _counts() == {km.RESIDUAL_REQUANT_ONLY: 1}
    assert got.dtype == torch.int8 and got.shape == (m, n)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_resnet50_entry_requants_leave_through_conv3(dev):
    """ResNet-50 uniform8 on uint8 images with the int32 carrier (the batch
    cell's engine) at b2 64²: 3 R1 launches (the init, unit 1's entry, the
    FC input), 16 residual-epilogue calls, 15 of them with the next unit's
    entry and 3 of those without the carrier; the logits and each unit's
    input and carrier (captured, so stored) equal the CPU engine's."""
    import chip_smoke
    fm = synthetic_frozen_resnet('resnet50', get_bit_config(
        'resnet50', 'uniform8'), num_classes=16, seed=2)
    x = np.random.RandomState(3).randint(0, 256, (2, 64, 64, 3)).astype(
        np.uint8)
    want = build_resnet_engine(fm, input_mode='uint8', device='cpu')(x)
    engine = build_resnet_engine(fm, input_mode='uint8', device=dev)
    engine(torch.from_numpy(x).to(dev))
    got, counts = _program_launches(engine, torch.from_numpy(x).to(dev))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    assert counts == chip_smoke.expected_launches('resnet50', fm.cfg,
                                                  'uint8')
    assert (counts['requant_int32'], counts[km.RESIDUAL],
            counts[km.RESIDUAL_REQUANT],
            counts[km.RESIDUAL_REQUANT_ONLY]) == (3, 1, 12, 3)
    for node in ('stage1.unit3.quant_act_int32', 'stage2.unit1.input',
                 'stage2.unit2.quant_act_int32', 'stage4.unit1.input',
                 'stage3.unit6.quant_act_int32'):
        torch.testing.assert_close(
            build_resnet_engine(fm, capture=node, input_mode='uint8',
                                device=dev)(x).cpu(),
            build_resnet_engine(fm, capture=node, input_mode='uint8',
                                device='cpu')(x), rtol=0, atol=0, msg=node)


# (B, H, W, C), N, taps, of the slab conv: the four 3×3 stages of ResNet-50
# at batch 8 and a space-to-depth (2×2-tap) stride-2 conv, then ragged ones:
# images smaller than a tile, B = 1 and 3, a 1×1 tap, C below and between
# the K paddings, N off the tile widths
_SM90_CONVS = [((8, 56, 56, 64), 64, (3, 3)), ((8, 28, 28, 128), 128, (3, 3)),
               ((8, 14, 14, 256), 256, (3, 3)), ((8, 7, 7, 512), 512, (3, 3)),
               ((2, 28, 28, 512), 128, (2, 2)), ((1, 5, 5, 16), 16, (3, 3)),
               ((3, 1, 1, 32), 48, (3, 3)), ((2, 9, 7, 48), 32, (1, 1)),
               ((1, 14, 14, 80), 80, (3, 3)), ((3, 33, 31, 64), 144, (3, 3)),
               ((1, 7, 7, 192), 1008, (2, 2))]


@pytest.mark.parametrize('shape,n,taps', _SM90_CONVS)
def test_sm90_conv_requant_equals_plain(dev, shape, n, taps):
    rng = np.random.RandomState(sum(shape) + n)
    b, h, w, c = shape
    kh, kw = taps
    xp = torch.tensor(rng.randint(-128, 128, (b, h + kh - 1, (w + kw - 1) * c)
                                  ).astype(np.int8), device=dev)
    wf = torch.tensor(rng.randint(-127, 128, (kh * kw * c, n)).astype(np.int8),
                      device=dev)
    _, _, bias, mult = _operands(rng, 1, 1, n, dev)
    mult[::3] = 0.5          # odd accumulators land exactly on a .5 boundary
    geo = dict(taps=taps, out_hw=(h, w), cin=c)
    prepared = km.prepare_weights(wf, kh * kw)
    _build.reset_launches()
    for out_bits, signed, relu in _EPILOGUES:
        lo, hi = km.epilogue_bounds(out_bits, signed, relu)
        want = kc.conv_requant_plain(xp, wf, bias, mult, lo=lo, hi=hi, **geo)
        torch.testing.assert_close(kc.conv_requant_tiled_plain(
            xp, prepared, bias, mult, lo=lo, hi=hi, **geo), want, rtol=0,
            atol=0)
        epi = dict(geo, out_bits=out_bits, signed=signed, relu=relu)
        for tile_n in (None, 32, 64, 128):
            got = kc.int8_conv_requant(xp, prepared, bias, mult, tile_n=tile_n,
                                       **epi)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(kc.int8_conv_requant(xp, wf, bias, mult,
                                                        **epi), want,
                                   rtol=0, atol=0)
    assert _counts() == {'int8_conv_requant': 15}


@pytest.mark.parametrize('shape,n,taps,pad', [
    ((8, 56, 56, 64), 64, (3, 3), (1, 1)), ((8, 7, 7, 512), 512, (3, 3), (1, 1)),
    ((2, 14, 14, 256), 256, (3, 3), (1, 1)), ((3, 33, 31, 64), 144, (3, 3), (1, 1)),
    ((2, 9, 7, 48), 32, (3, 3), (1, 0)), ((2, 5, 6, 16), 16, (3, 3), (0, 1)),
    ((1, 12, 20, 32), 48, (5, 5), (2, 2)), ((1, 1, 1, 16), 16, (3, 3), (1, 1))])
def test_sm90_conv_with_the_border_left_to_tma(dev, shape, n, taps, pad):
    """``pad``: the kernel reads the unpadded activations and TMA's zero fill
    is the conv's border; it equals the slab call on the padded copy."""
    rng = np.random.RandomState(sum(shape) + n)
    b, h, w, c = shape
    kh, kw = taps
    x = torch.tensor(rng.randint(-128, 128, (
        b, h + kh - 1 - 2 * pad[0], (w + kw - 1 - 2 * pad[1]) * c)).astype(
            np.int8), device=dev)
    wf = torch.tensor(rng.randint(-127, 128, (kh * kw * c, n)).astype(np.int8),
                      device=dev)
    _, _, bias, mult = _operands(rng, 1, 1, n, dev)
    geo = dict(taps=taps, out_hw=(h, w), cin=c)
    xp = kc.pad_conv_input(x, pad, **geo)
    want = kc.conv_requant_plain(xp, wf, bias, mult, lo=0, hi=127, **geo)
    _build.reset_launches()
    for weights in (wf, km.prepare_weights(wf, kh * kw)):
        for tile_n in (None, 32, 128):
            got = kc.int8_conv_requant(x, weights, bias, mult, relu=True,
                                       pad=pad, tile_n=tile_n, **geo)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert _counts() == {'int8_conv_requant': 6}
    with pytest.raises(ValueError):             # the slab where x is expected
        kc.int8_conv_requant(xp, wf, bias, mult, pad=pad, **geo)


# the int8_matmul_requant shapes of ResNet-50 at batch 8 (conv1 of every
# unit; stride 2 is a slice first), then ragged ones: M and N off the tiles,
# K padded up to 64 and to 128, M = 1
_SM90_REQUANT_MATMULS = [(25088, 64, 64), (25088, 256, 64), (6272, 256, 128),
                         (6272, 512, 128), (1568, 512, 256),
                         (1568, 1024, 256), (392, 1024, 512),
                         (392, 2048, 512), (37, 48, 16), (1000, 2048, 1008),
                         (1, 16, 16), (130, 80, 80), (65, 192, 48)]


@pytest.mark.parametrize('m,k,n', _SM90_REQUANT_MATMULS)
def test_sm90_matmul_requant_equals_plain(dev, m, k, n):
    rng = np.random.RandomState(m + k + n)
    x, w, b, mult = _operands(rng, m, k, n, dev)
    mult[::3] = 0.5          # odd accumulators land exactly on a .5 boundary
    if k >= 2048:                   # saturated operands: |acc| passes 2**24
        x[0, :] = -128
        w[:, 0] = 127
        w[:, 1] = -127
    prepared = km.prepare_weights(w)
    _build.reset_launches()
    for out_bits, signed, relu in _EPILOGUES:
        lo, hi = km.epilogue_bounds(out_bits, signed, relu)
        epi = dict(out_bits=out_bits, signed=signed, relu=relu)
        want = km.matmul_requant_plain(x, w, b, mult, lo, hi)
        torch.testing.assert_close(km.matmul_requant_kmajor_plain(
            x, prepared, b, mult, lo, hi), want, rtol=0, atol=0)
        for tile_n in (None, 32, 64, 128):
            for weights in (w, prepared):
                got = km.int8_matmul_requant(x, weights, b, mult,
                                             tile_n=tile_n, **epi)
                torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(km.int8_matmul_requant(
            x, prepared, b, mult, smem_extra=4096, **epi), want, rtol=0,
            atol=0)
    assert _counts() == {'int8_matmul_requant': 27}


def _w4_conv(rng, shape, n, taps, dev):
    """Slab, int4 weights (flattened int8 values and their per-tap packed
    bytes), bias and multipliers of a conv on the card."""
    b, h, w, c = shape
    kh, kw = taps
    xp = torch.tensor(rng.randint(-128, 128, (b, h + kh - 1, (w + kw - 1) * c)
                                  ).astype(np.int8), device=dev)
    wf = _w4(rng, (kh * kw * c, n))
    wp = torch.tensor(kc.pack_int4_conv(wf, kh * kw), device=dev)
    _, _, bias, mult = _operands(rng, 1, 1, n, dev)
    return xp, torch.tensor(wf, device=dev), wp, bias, mult


@pytest.mark.parametrize('shape,n,taps', _SM90_CONVS)
def test_sm90_int4w_conv_equals_plain_and_int8_form(dev, shape, n, taps):
    """The packed form on the Hopper core == the plain version == the int8
    form of the same core on the unpacked weights (whose B tile TMA
    swizzles; here the kernel's unpack writes it)."""
    rng = np.random.RandomState(sum(shape) + n)
    b, h, w, c = shape
    kh, kw = taps
    xp, wf, wp, bias, mult = _w4_conv(rng, shape, n, taps, dev)
    mult[::3] = 0.5
    if c == 512:                    # |acc| = 9 * 512 * 128 * 8 passes 2**22
        xp[0] = -128
        wf[:, 0], wf[:, 1] = -8, 7
        wp = torch.tensor(kc.pack_int4_conv(wf.cpu().numpy(), kh * kw),
                          device=dev)
    geo = dict(taps=taps, out_hw=(h, w), cin=c)
    prepared = km.prepare_weights_int4(wp, kh * kw)
    torch.testing.assert_close(km.unprepare_weights(prepared), wp, rtol=0,
                               atol=0)
    _build.reset_launches()
    for out_bits, signed, relu in _EPILOGUES:
        lo, hi = km.epilogue_bounds(out_bits, signed, relu)
        want = kc.conv_requant_plain(xp, wf, bias, mult, lo=lo, hi=hi, **geo)
        torch.testing.assert_close(kc.conv_requant_tiled_plain(
            xp, prepared, bias, mult, lo=lo, hi=hi, **geo), want, rtol=0,
            atol=0)
        epi = dict(geo, out_bits=out_bits, signed=signed, relu=relu)
        for tile_n in (None, 32, 64, 128):
            got = kc.int4w_conv_requant(xp, prepared, bias, mult,
                                        tile_n=tile_n, **epi)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(kc.int4w_conv_requant(
            xp, wp, bias, mult, **epi), want, rtol=0, atol=0)
        torch.testing.assert_close(kc.int4w_conv_requant(
            xp, prepared, bias, mult, smem_extra=4096, **epi), want, rtol=0,
            atol=0)
        torch.testing.assert_close(kc.int8_conv_requant(
            xp, wf, bias, mult, **epi), want, rtol=0, atol=0)
    assert _counts() == {'int4w_conv_requant': 18,
                                'int8_conv_requant': 3}


@pytest.mark.parametrize('c,n', [(64, 32), (128, 128), (192, 80), (16, 16),
                                 (256, 256)])
def test_sm90_int4_unpack_places_every_nibble(dev, c, n):
    """A handle of known values through a 1×1 conv whose pixel p holds a
    single 1 at channel c0 + p: the output is W[c0 + p, :], so a nibble
    unpacked to the wrong unit, row or half of the swizzled tile shows up by
    position; every tile width."""
    cc, nn = np.meshgrid(np.arange(c), np.arange(n), indexing='ij')
    wf = ((cc * 7 + nn * 3 + cc // 16) % 16 - 8).astype(np.int8)
    wp = torch.tensor(kc.pack_int4_conv(wf, 1), device=dev)
    prepared = km.prepare_weights_int4(wp, 1)
    bias = torch.zeros(n, dtype=torch.int32, device=dev)
    mult = torch.ones(n, device=dev)
    for c0 in range(0, c, 64):
        x = torch.zeros((1, 8, 8, c), dtype=torch.int8, device=dev)
        for p_ in range(min(64, c - c0)):
            x[0, p_ // 8, p_ % 8, c0 + p_] = 1
        for tile_n in (32, 64, 128):
            got = kc.int4w_conv_requant(
                x.reshape(1, 8, 8 * c), prepared, bias, mult, taps=(1, 1),
                out_hw=(8, 8), cin=c, tile_n=tile_n)
            rows = min(64, c - c0)
            np.testing.assert_array_equal(
                got[0, :rows].cpu().numpy(), wf[c0:c0 + rows],
                err_msg=f'c0 {c0} tile_n {tile_n}')
            assert not got[0, rows:].any()


@pytest.mark.parametrize('shape,n,taps,pad', [
    ((8, 56, 56, 64), 64, (3, 3), (1, 1)), ((8, 7, 7, 512), 512, (3, 3), (1, 1)),
    ((3, 33, 31, 64), 144, (3, 3), (1, 1)), ((2, 9, 7, 48), 32, (3, 3), (1, 0)),
    ((1, 12, 20, 32), 48, (5, 5), (2, 2)), ((1, 1, 1, 16), 16, (3, 3), (1, 1))])
def test_sm90_int4w_conv_with_the_border_left_to_tma(dev, shape, n, taps, pad):
    rng = np.random.RandomState(sum(shape) + n)
    b, h, w, c = shape
    kh, kw = taps
    x = torch.tensor(rng.randint(-128, 128, (
        b, h + kh - 1 - 2 * pad[0], (w + kw - 1 - 2 * pad[1]) * c)).astype(
            np.int8), device=dev)
    wf = _w4(rng, (kh * kw * c, n))
    wp = torch.tensor(kc.pack_int4_conv(wf, kh * kw), device=dev)
    _, _, bias, mult = _operands(rng, 1, 1, n, dev)
    geo = dict(taps=taps, out_hw=(h, w), cin=c)
    xp = kc.pad_conv_input(x, pad, **geo)
    want = kc.conv_requant_plain(xp, torch.tensor(wf, device=dev), bias, mult,
                                 lo=0, hi=127, **geo)
    _build.reset_launches()
    for weights in (wp, km.prepare_weights_int4(wp, kh * kw)):
        for tile_n in (None, 32, 128):
            got = kc.int4w_conv_requant(x, weights, bias, mult, relu=True,
                                        pad=pad, tile_n=tile_n, **geo)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert _counts() == {'int4w_conv_requant': 6}
    with pytest.raises(ValueError):             # the slab where x is expected
        kc.int4w_conv_requant(xp, wp, bias, mult, pad=pad, **geo)


# (B, H, W, C), N, taps, pad of the accumulator convs: the engine's folded
# init at batch 8 (C = 48, on the slab), the QAT step's at batch 32 (the
# channel-padded 7×7/s2 init's 4×4-tap rewrite, C = 16, and the four 3×3
# stages of ResNet-50 with their border left to TMA), the four conv2 stages
# of ResNet-18 at batch 8; then ragged calls: N % 4 but not % 16, images
# smaller than a tile, B = 1 and 3, a 1×1 tap, a 2×2-tap stride-2 rewrite, C
# between the K paddings, a border on one axis only
_SM90_CONV_ACCS = [((8, 56, 56, 48), 256, (3, 3), (0, 0)),
                   ((32, 112, 112, 16), 64, (4, 4), (0, 0)),
                   ((32, 56, 56, 64), 64, (3, 3), (1, 1)),
                   ((32, 28, 28, 128), 128, (3, 3), (1, 1)),
                   ((32, 14, 14, 256), 256, (3, 3), (1, 1)),
                   ((32, 7, 7, 512), 512, (3, 3), (1, 1)),
                   ((8, 56, 56, 64), 64, (3, 3), (1, 1)),
                   ((8, 28, 28, 128), 128, (3, 3), (1, 1)),
                   ((8, 14, 14, 256), 256, (3, 3), (1, 1)),
                   ((8, 7, 7, 512), 512, (3, 3), (1, 1)),
                   ((2, 9, 7, 16), 20, (3, 3), (1, 1)),
                   ((1, 5, 5, 16), 16, (3, 3), (0, 0)),
                   ((3, 1, 1, 32), 44, (3, 3), (1, 1)),
                   ((2, 9, 7, 48), 32, (1, 1), (0, 0)),
                   ((1, 7, 7, 192), 1004, (2, 2), (0, 0)),
                   ((1, 14, 14, 80), 80, (3, 3), (1, 0)),
                   ((3, 33, 31, 64), 144, (3, 3), (1, 1))]


@pytest.mark.parametrize('int4', [False, True])
@pytest.mark.parametrize('shape,n,taps,pad', _SM90_CONV_ACCS)
def test_sm90_conv_acc_equals_plain(dev, shape, n, taps, pad, int4):
    """``int8_conv_acc`` / ``int4w_conv_acc`` on the Hopper core (the int32
    epilogue through a 4-D map) == the plain version == its walk, with a
    handle (a plain one, and where the call allows the one that reads a
    kernel row as one tap) and with plain weights (laid out at each call),
    at every tile width and with the border left to TMA."""
    rng = np.random.RandomState(sum(shape) + n + int4)
    b, h, w, c = shape
    kh, kw = taps
    x = torch.tensor(rng.randint(-128, 128, (
        b, h + kh - 1 - 2 * pad[0], (w + kw - 1 - 2 * pad[1]) * c)).astype(
            np.int8), device=dev)
    wf = (_w4(rng, (kh * kw * c, n)) if int4 else
          rng.randint(-127, 128, (kh * kw * c, n)).astype(np.int8))
    if c >= 256:                    # saturated operands: large |acc|
        x[0] = -128
        wf[:, 0], wf[:, 1] = (-8, 7) if int4 else (127, -127)
    if int4:
        weights = torch.tensor(kc.pack_int4_conv(wf, kh * kw), device=dev)
        prepared = km.prepare_weights_int4(weights, kh * kw)
        fn, name = kc.int4w_conv_acc, 'int4w_conv_acc'
    else:
        weights = torch.tensor(wf, device=dev)
        prepared = km.prepare_weights(weights, kh * kw)
        fn, name = kc.int8_conv_acc, 'int8_conv_acc'
    _, _, bias, _ = _operands(rng, 1, 1, n, dev)
    geo = dict(taps=taps, out_hw=(h, w), cin=c, pad=pad)
    xp = kc.pad_conv_input(x, pad, **{k: geo[k] for k in
                                      ('taps', 'out_hw', 'cin')})
    flat = dict(taps=taps, out_hw=(h, w), cin=c)
    handles = [prepared]
    rows = kc.prepare_conv_weights(weights, taps, c, pad, int4)
    if rows.row_taps > 1:
        handles.append(rows)
    want = kc.conv_acc_plain(xp, torch.tensor(wf, device=dev), bias, **flat)
    _build.reset_launches()
    for handle in handles:
        torch.testing.assert_close(kc.conv_acc_tiled_plain(
            xp, handle, bias, **flat), want, rtol=0, atol=0)
        for tile_n in (None, 32, 64, 128):
            torch.testing.assert_close(fn(x, handle, bias, tile_n=tile_n,
                                          **geo), want, rtol=0, atol=0)
    torch.testing.assert_close(fn(x, weights, bias, **geo), want, rtol=0,
                               atol=0)
    torch.testing.assert_close(fn(x, prepared, bias, smem_extra=4096, **geo),
                               want, rtol=0, atol=0)
    torch.testing.assert_close(fn(xp, weights, bias, **flat), want, rtol=0,
                               atol=0)
    assert _counts() == {name: 4 * len(handles) + 3}
    if pad != (0, 0):
        with pytest.raises(ValueError):         # the slab where x is expected
            fn(xp, weights, bias, **geo)


# (kind, M, K, N) of the packed matmuls: every int4w_matmul_requant
# ('matmul_requant') and int4w_matmul_acc ('matmul') shape of ResNet-50
# uniform4 at batch 8 (bops_0.5's five int4w_matmul_acc calls are among
# them), ResNet-18 uniform4's three identity convs, then ragged ones: M off
# the 64- and 128-row tiles, K = 48 and 80 (padded to 64 and 128), M = 1,
# N = 1000 and N % 4 only for the accumulator form
_SM90_INT4_MATMULS = [
    ('matmul_requant', 25088, 64, 64), ('matmul_requant', 25088, 256, 64),
    ('matmul_requant', 6272, 256, 128), ('matmul_requant', 6272, 512, 128),
    ('matmul_requant', 1568, 512, 256), ('matmul_requant', 1568, 1024, 256),
    ('matmul_requant', 392, 1024, 512), ('matmul_requant', 392, 2048, 512),
    ('matmul', 25088, 64, 256), ('matmul', 6272, 256, 512),
    ('matmul', 6272, 128, 512), ('matmul', 1568, 512, 1024),
    ('matmul', 1568, 256, 1024), ('matmul', 392, 1024, 2048),
    ('matmul', 392, 512, 2048), ('matmul', 6272, 64, 128),
    ('matmul', 1568, 128, 256), ('matmul', 392, 256, 512),
    ('matmul_requant', 37, 48, 16), ('matmul_requant', 300, 80, 48),
    ('matmul_requant', 1, 16, 16), ('matmul', 37, 48, 20),
    ('matmul', 300, 80, 1000), ('matmul', 1, 16, 4),
    ('matmul', 130, 2048, 1000)]


@pytest.mark.parametrize('kind,m,k,n', _SM90_INT4_MATMULS)
def test_sm90_int4w_matmul_equals_plain_and_int8_form(dev, kind, m, k, n):
    """The packed matmul on the Hopper core == the plain version on the
    unpacked weights == its walk == the int8 form of the same core on those
    weights, with the handle and with ``pack_int4``'s bytes (laid out at
    each call), at every tile width and with 64- and 128-row tiles."""
    rng = np.random.RandomState(m + k + n)
    _, _, bias, mult = _operands(rng, 1, 1, n, dev)
    mult[::3] = 0.5          # odd accumulators land exactly on a .5 boundary
    x = torch.tensor(rng.randint(-128, 128, (m, k)).astype(np.int8),
                     device=dev)
    w = _w4(rng, (k, n))
    if k >= 1024:                   # saturated operands: large |acc|
        x[0, :] = -128
        w[:, 0], w[:, 1] = -8, 7
    wp = torch.tensor(km.pack_int4(w), device=dev)
    w8 = torch.tensor(w, device=dev)
    prepared = km.prepare_weights_int4(wp)
    torch.testing.assert_close(km.unprepare_weights(prepared), wp, rtol=0,
                               atol=0)
    requant = kind == 'matmul_requant'
    name = 'int4w_matmul_requant' if requant else 'int4w_matmul_acc'
    epilogues = _EPILOGUES if requant else [None]
    _build.reset_launches()
    for epi in epilogues:
        if requant:
            lo, hi = km.epilogue_bounds(*epi)
            kw = dict(zip(('out_bits', 'signed', 'relu'), epi))
            want = km.matmul_requant_plain(x, w8, bias, mult, lo, hi)
            walk = km.matmul_requant_kmajor_plain(x, prepared, bias, mult, lo,
                                                  hi, name)
            fn = lambda wts, **o: km.int4w_matmul_requant(x, wts, bias, mult,
                                                          **kw, **o)
            twin = km.int8_matmul_requant(x, w8, bias, mult, **kw)
        else:
            want = km.matmul_acc_plain(x, w8, bias)
            walk = km.matmul_acc_kmajor_plain(x, prepared, bias, name)
            fn = lambda wts, **o: km.int4w_matmul_acc(x, wts, bias, **o)
            twin = km.int8_matmul_acc(x, w8, bias)
        torch.testing.assert_close(walk, want, rtol=0, atol=0)
        torch.testing.assert_close(twin, want, rtol=0, atol=0)
        for tile_m in (None, 64, 128):
            for tile_n in (None, 32, 64, 128):
                torch.testing.assert_close(
                    fn(prepared, tile_n=tile_n, tile_m=tile_m), want, rtol=0,
                    atol=0, msg=f'{epi} tile {tile_m} x {tile_n}')
        torch.testing.assert_close(fn(wp), want, rtol=0, atol=0)
        torch.testing.assert_close(fn(prepared, smem_extra=4096), want,
                                   rtol=0, atol=0)
    e = len(epilogues)
    assert _counts() == {name: 14 * e,
                                name.replace('int4w', 'int8'): e}


@pytest.mark.parametrize('k,n', [(64, 32), (128, 128), (192, 80), (16, 16),
                                 (256, 256), (48, 64)])
def test_sm90_int4w_matmul_places_every_nibble(dev, k, n):
    """A handle of known values times rows that each hold a single 1 at
    channel c0 + row: the output is W[c0 + row, :], so a nibble unpacked to
    the wrong unit, row or half of the swizzled tile shows up by position;
    every tile width, 64- and 128-row tiles."""
    kk, nn = np.meshgrid(np.arange(k), np.arange(n), indexing='ij')
    w = ((kk * 7 + nn * 3 + kk // 16) % 16 - 8).astype(np.int8)
    prepared = km.prepare_weights_int4(torch.tensor(km.pack_int4(w),
                                                    device=dev))
    bias = torch.zeros(n, dtype=torch.int32, device=dev)
    x = torch.zeros((200, k), dtype=torch.int8, device=dev)
    rows = torch.arange(200, device=dev)
    x[rows, rows % k] = 1
    want = torch.tensor(w, device=dev).to(torch.int32)[rows % k]
    for tile_m in (64, 128):
        for tile_n in (32, 64, 128):
            got = km.int4w_matmul_acc(x, prepared, bias, tile_m=tile_m,
                                      tile_n=tile_n)
            torch.testing.assert_close(got, want, rtol=0, atol=0,
                                       msg=f'tile {tile_m} x {tile_n}')


def test_sm90_pads_each_refused_class_of_the_int4w_matmuls(dev):
    """One call of each packed matmul per clause of the alignment step
    (``sm90_operands``: K % 16, the output's N, x's pointer % 16, and
    MobileNetV2's K = 24): it runs padded on the Hopper core, once, with
    the packed bytes and with their handle, and equals the plain
    version."""
    rng = np.random.RandomState(3)
    big = torch.tensor(rng.randint(-128, 128, 1 << 16).astype(np.int8),
                       device=dev)
    for requant, cases in (
            (False, ((40, 46, 20, 0), (40, 48, 18, 0), (40, 48, 20, 8),
                     (40, 24, 24, 0))),
            (True, ((40, 46, 16, 0), (40, 48, 24, 0), (40, 48, 16, 8),
                    (40, 24, 24, 0)))):
        name = 'int4w_matmul_requant' if requant else 'int4w_matmul_acc'
        for m, k, n, offset in cases:
            x = big[offset:offset + m * k].view(m, k)
            w = torch.tensor(_w4(rng, (k, n)), device=dev)
            wp = torch.tensor(km.pack_int4(w.cpu().numpy()), device=dev)
            _, _, b, _ = _operands(rng, 1, 1, n, dev)
            mult = torch.full((n,), 2.0 ** -9, device=dev)
            if requant:
                fn = lambda wts, **o: km.int4w_matmul_requant(x, wts, b, mult,
                                                              **o)
                want = km.matmul_requant_plain(x, w, b, mult, -128, 127)
            else:
                fn = lambda wts, **o: km.int4w_matmul_acc(x, wts, b, **o)
                want = km.matmul_acc_plain(x, w, b)
            for wts in (wp, km.prepare_weights_int4(wp)):
                _build.reset_launches()
                torch.testing.assert_close(fn(wts), want, rtol=0, atol=0)
                assert _counts() == {name: 1}


def test_sm90_pads_each_refused_class(dev):
    """One call per clause of the alignment step (``sm90_operands``): K or
    C % 16, the output's N (% 16 for int8, % 4 for int32), the pointer %
    16, among them MobileNetV2's K = 24 and N = 24 and the CIFAR init's C
    = 3 (its border left to TMA, and on the padded slab): it runs padded on
    the Hopper core, once, and equals the plain version."""
    rng = np.random.RandomState(0)
    big = torch.tensor(rng.randint(-128, 128, 1 << 16).astype(np.int8),
                       device=dev)

    def matmul_case(m, k, n, offset):
        x = big[offset:offset + m * k].view(m, k)
        _, w, b, _ = _operands(rng, 1, k, n, dev)
        return x, w, b
    for m, k, n, offset in ((40, 45, 20, 0), (40, 48, 18, 0),
                            (40, 48, 20, 8), (40, 24, 24, 0)):
        x, w, b = matmul_case(m, k, n, offset)
        for weights in (w, km.prepare_weights(w)):
            _build.reset_launches()
            torch.testing.assert_close(km.int8_matmul_acc(x, weights, b),
                                       km.matmul_acc_plain(x, w, b), rtol=0,
                                       atol=0)
            assert _counts() == {'int8_matmul_acc': 1}
    for m, k, n, offset in ((40, 45, 16, 0), (40, 48, 24, 0),
                            (40, 48, 16, 8), (40, 24, 24, 0)):
        x, w, b = matmul_case(m, k, n, offset)
        mult = torch.full((n,), 2.0 ** -9, device=dev)
        want = km.matmul_requant_plain(x, w, b, mult, -128, 127)
        for fn in (km.int8_matmul_requant, km.int8_matmul_requant_kblocked):
            _build.reset_launches()
            torch.testing.assert_close(fn(x, w, b, mult), want, rtol=0,
                                       atol=0)
            assert _counts() == {fn.__name__: 1}
    # the residual form: K % 16, N % 4, the pointers of x and the identity
    for m, k, n, offset, id_offset in ((40, 24, 24, 0, 0), (40, 48, 18, 0, 0),
                                       (40, 48, 16, 8, 0), (40, 48, 16, 0, 8)):
        x, w, b = matmul_case(m, k, n, offset)
        ids = torch.tensor(rng.randint(-2 ** 20, 2 ** 20, m * n + 4).astype(
            np.int32), device=dev)
        idt = ids[id_offset // 4:id_offset // 4 + m * n].view(m, n)
        mm = torch.full((n,), 2.0 ** -9, device=dev)
        mi = torch.full((n,), 2.0 ** -7, device=dev)
        want = km.residual_epilogue(km.matmul_acc_plain(x, w, b), mm, idt, mi)
        _build.reset_launches()
        torch.testing.assert_close(
            km.int8_matmul_acc_residual(x, w, b, idt, mm, mi), want, rtol=0,
            atol=0)
        assert _counts() == {km.RESIDUAL: 1}
    for c, n, offset in ((10, 16, 0), (16, 24, 0), (16, 16, 4), (24, 24, 0)):
        bsz, h, w_ = 2, 6, 5
        size = bsz * (h + 2) * (w_ + 2) * c
        xp = big[offset:offset + size].view(bsz, h + 2, (w_ + 2) * c)
        wf = _w4(rng, (9 * c, n))
        wp = torch.tensor(kc.pack_int4_conv(wf, 9), device=dev)
        _, _, bias, mult = _operands(rng, 1, 1, n, dev)
        geo = dict(taps=(3, 3), out_hw=(h, w_), cin=c)
        _build.reset_launches()
        torch.testing.assert_close(
            kc.int4w_conv_requant(xp, wp, bias, mult, **geo),
            kc.conv_requant_plain(xp, torch.tensor(wf, device=dev), bias, mult,
                                  lo=-128, hi=127, **geo), rtol=0, atol=0)
        assert _counts() == {'int4w_conv_requant': 1}
    for c, n, offset in ((5, 16, 0), (16, 24, 0), (16, 16, 4), (3, 16, 0)):
        bsz, h, w_ = 2, 6, 5
        size = bsz * (h + 2) * (w_ + 2) * c
        xp = big[offset:offset + size].view(bsz, h + 2, (w_ + 2) * c)
        _, wf, bias, mult = _operands(rng, 1, 9 * c, n, dev)
        geo = dict(taps=(3, 3), out_hw=(h, w_), cin=c)
        _build.reset_launches()
        torch.testing.assert_close(
            kc.int8_conv_requant(xp, wf, bias, mult, **geo),
            kc.conv_requant_plain(xp, wf, bias, mult, lo=-128, hi=127, **geo),
            rtol=0, atol=0)
        assert _counts() == {'int8_conv_requant': 1}
    for c, n, offset, pad in ((12, 16, 0, (0, 0)), (16, 18, 0, (0, 0)),
                              (16, 20, 4, (0, 0)), (3, 16, 0, (1, 1)),
                              (3, 64, 0, (0, 0))):
        bsz, h, w_ = 2, 6, 5
        size = bsz * (h + 2 - 2 * pad[0]) * (w_ + 2 - 2 * pad[1]) * c
        x = big[offset:offset + size].view(bsz, h + 2 - 2 * pad[0],
                                           (w_ + 2 - 2 * pad[1]) * c)
        wf = _w4(rng, (9 * c, n))
        wp = torch.tensor(kc.pack_int4_conv(wf, 9), device=dev) if c % 2 == 0 \
            else None
        wf = torch.tensor(wf, device=dev)
        _, _, bias, _ = _operands(rng, 1, 1, n, dev)
        geo = dict(taps=(3, 3), out_hw=(h, w_), cin=c)
        xp = kc.pad_conv_input(x, pad, **geo) if pad != (0, 0) else x
        want = kc.conv_acc_plain(xp, wf, bias, **geo)
        for fn, weights, name in ((kc.int8_conv_acc, wf, 'int8_conv_acc'),
                                  (kc.int4w_conv_acc, wp, 'int4w_conv_acc')):
            if weights is None:           # packing needs an even C
                continue
            for wts in (weights, kc.prepare_conv_weights(
                    weights, (3, 3), c, pad, name.startswith('int4w'))):
                _build.reset_launches()
                torch.testing.assert_close(fn(x, wts, bias, pad=pad, **geo),
                                           want, rtol=0, atol=0)
                assert _counts() == {name: 1}


def test_sm90_oversized_shared_memory_request_raises(dev):
    """A launch the card refuses is an error, not a run on another path."""
    rng = np.random.RandomState(1)
    x, w, b, mult = _operands(rng, 64, 64, 64, dev)
    _build.reset_launches()
    with pytest.raises(RuntimeError):
        km.int8_matmul_acc(x, w, b, smem_extra=1 << 20)
    xp = torch.zeros((1, 10, 10 * 64), dtype=torch.int8, device=dev)
    _, wf, _, _ = _operands(rng, 1, 9 * 64, 64, dev)
    with pytest.raises(RuntimeError):
        kc.int8_conv_requant(xp, wf, b, mult, taps=(3, 3), out_hw=(8, 8),
                             cin=64, smem_extra=1 << 20)
    with pytest.raises(RuntimeError):
        km.int8_matmul_requant(x, w, b, mult, smem_extra=1 << 20)
    wp = torch.tensor(kc.pack_int4_conv(_w4(rng, (9 * 64, 64)), 9), device=dev)
    with pytest.raises(RuntimeError):
        kc.int4w_conv_requant(xp, wp, b, mult, taps=(3, 3), out_hw=(8, 8),
                              cin=64, smem_extra=1 << 20)
    with pytest.raises(RuntimeError):
        kc.int8_conv_acc(xp, wf, b, taps=(3, 3), out_hw=(8, 8), cin=64,
                         smem_extra=1 << 20)
    with pytest.raises(RuntimeError):
        kc.int4w_conv_acc(xp, wp, b, taps=(3, 3), out_hw=(8, 8), cin=64,
                          smem_extra=1 << 20)
    wpm = torch.tensor(km.pack_int4(_w4(rng, (64, 64))), device=dev)
    for tile_m in (64, 128):
        with pytest.raises(RuntimeError):
            km.int4w_matmul_requant(x, wpm, b, mult, tile_m=tile_m,
                                    smem_extra=1 << 20)
        with pytest.raises(RuntimeError):
            km.int4w_matmul_acc(x, wpm, b, tile_m=tile_m, smem_extra=1 << 20)
    assert _counts() == {}
    # and the same calls go through afterwards
    torch.testing.assert_close(km.int8_matmul_acc(x, w, b),
                               km.matmul_acc_plain(x, w, b), rtol=0, atol=0)
    assert _counts() == {'int8_matmul_acc': 1}


@pytest.mark.parametrize('scheme,want', [
    ('uniform8', {'int8_conv_requant': 16, 'int8_matmul_acc': 21,
                  'int8_matmul_requant': 16, 'int8_conv_acc': 1}),
    ('uniform4', {'int4w_conv_requant': 16, 'int4w_matmul_requant': 16,
                  'int4w_matmul_acc': 20, 'int8_matmul_acc': 1,
                  'int8_conv_acc': 1}),
    ('bops_0.5', {'int8_conv_acc': 1, 'int8_matmul_acc': 16,
                  'int8_matmul_requant': 16, 'int8_conv_requant': 2,
                  'int4w_conv_requant': 14, 'int4w_matmul_acc': 5}),
    ('resnet18-uniform4', {'int8_conv_acc': 1, 'int8_matmul_acc': 1,
                           'int4w_conv_requant': 8,
                           'int4w_conv_acc': 8,
                           'int4w_matmul_acc': 3})])
def test_engine_cuda_runs_the_hopper_core(dev, scheme, want):
    """ResNet widths at a small image: the engine's prepared weights (the
    packed ones of the 4-bit layers too) go through the Hopper core and the
    logits equal the CPU engine's."""
    arch, scheme = (scheme.split('-') if '-' in scheme
                    else ('resnet50', scheme))
    fm = synthetic_frozen_resnet(arch, get_bit_config(arch, scheme),
                                 num_classes=1000, seed=2)
    x = fold4_images(np.random.RandomState(5).randn(2, 64, 64, 3).astype(
        np.float32))
    kw = dict(input_mode='folded_float32', residual_dtype=torch.int16)
    logits = build_resnet_engine(fm, device='cpu', **kw)(x)
    _build.reset_launches()
    got = build_resnet_engine(fm, device=dev, **kw)(x)
    assert {k: v for k, v in _counts().items()
            if k not in ('requant_int32', 'maxpool_folded_requant')} == want
    torch.testing.assert_close(got.cpu(), logits, rtol=0, atol=0)


def _unaligned(t):
    """``t``'s values one element into an allocation: a pointer that is not
    16-byte aligned."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    out = flat[1:].view(t.shape)
    assert out.data_ptr() % 16
    return out


@pytest.mark.parametrize('dtype', [torch.int16, torch.int32, torch.float32])
def test_pool_kernel_walks_equal_plain(dev, dtype):
    """Both channel-vector widths: 16-byte vectors where N · element size
    and the pointer allow, one channel on a ragged N or an unaligned input;
    Wq off the 4-column run."""
    rng = np.random.RandomState(2)
    for shape in ((2, 7, 9, 20), (8, 56, 56, 256), (1, 3, 17, 64)):
        xf = torch.tensor(rng.randint(-2 ** 14, 2 ** 14, shape),
                          device=dev).to(dtype)
        want = maxpool_3x3s2p1_folded(xf)
        for x in (xf, _unaligned(xf)):
            torch.testing.assert_close(maxpool_folded(x), want, rtol=0,
                                       atol=0)


def _requant_acc(rng, shape, out_bits, dev):
    b, hq, wq, n4 = shape
    acc = rng.randint(-2 ** 20, 2 ** 20, shape).astype(np.int32)
    acc[..., ::5] = rng.randint(-99, 100, acc[..., ::5].shape) * 2 + 1
    acc[0, 0, 0, :] = 2 ** (out_bits + 2)
    acc[-1, -1, -1, :] = -2 ** (out_bits + 2)
    mult = np_dyadic_multiplier(
        (rng.rand(n4) * 2 ** (3 - out_bits) + 1e-5).astype(np.float32))
    mult[::5] = 0.5
    mult[n4 // 4:n4 // 2] *= 3
    mult[0], mult[-1] = 4.0, 4.0
    return (torch.tensor(acc, device=dev),
            torch.tensor(mult.astype(np.float32), device=dev))


@pytest.mark.parametrize('out_dtype,out_bits,signed', [
    (torch.int16, 16, True), (torch.int32, 16, True), (torch.int16, 8, False),
    (torch.int32, 8, True)])
def test_pool_requant_kernel_equals_plain(dev, out_dtype, out_bits, signed):
    """maxpool_folded_requant == requant, ReLU, pool (the engine's former
    sequence): 4-channel vectors, and one channel on a ragged N or on
    unaligned accumulators or multipliers; with and without the ReLU."""
    rng = np.random.RandomState(out_bits)
    for shape in ((2, 7, 9, 20), (8, 56, 56, 256), (1, 3, 17, 64)):
        acc, mult = _requant_acc(rng, shape, out_bits, dev)
        for relu in (True, False):
            kw = dict(out_bits=out_bits, signed=signed, relu=relu,
                      out_dtype=out_dtype)
            want = kp.maxpool_folded_requant_plain(acc, mult, out_bits, signed,
                                                   relu, out_dtype)
            for a, m in ((acc, mult), (_unaligned(acc), mult),
                         (acc, _unaligned(mult))):
                got = kp.maxpool_folded_requant(a, m, **kw)
                assert got.dtype == out_dtype
                torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError):                # 16-bit values in int16
        kp.maxpool_folded_requant(acc, mult, out_bits=16, signed=False,
                                  relu=True, out_dtype=torch.int16)


@pytest.mark.parametrize('arch,mode', [('tiny50', 'folded_float32'),
                                       ('resnet50', 'folded_int8')])
def test_folded_engine_launches_the_fused_pool(dev, arch, mode):
    """The folded engine launches maxpool_folded_requant once a forward and
    maxpool_folded never; its 'init' node and logits equal the CPU
    engine's."""
    fm = synthetic_frozen_resnet(arch, get_bit_config(arch, 'uniform8'),
                                 num_classes=10, seed=3)
    x = fold4_images(np.random.RandomState(4).randn(2, 64, 64, 3).astype(
        np.float32))
    if mode == 'folded_int8':
        x = quantize_int8(x, fm.act_scale('quant_input'))
    kw = dict(input_mode=mode, residual_dtype=torch.int16)
    for capture in ('init', None):
        want = build_resnet_engine(fm, device='cpu', capture=capture, **kw)(x)
        eng = build_resnet_engine(fm, device=dev, capture=capture, **kw)
        _build.reset_launches()
        got = eng(x)
        assert _build.LAUNCHES.get('maxpool_folded_requant') == 1
        assert _build.LAUNCHES.get('maxpool_folded', 0) == 0
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


# #5's shapes: M, K and N off the tiles (K and N that are not multiples of
# 16 padded first), conv1 of ResNet-50's stage 4, the FC's N = 1000
_KBLOCKED_SHAPES = [(37, 45, 19), (8, 2048, 1000), (392, 2048, 512),
                    (392, 512, 2048), (3, 5, 2), (130, 200, 72), (64, 64, 64),
                    (130, 208, 80), (37, 1008, 48), (1568, 1024, 256),
                    (1, 4096, 16)]


@pytest.mark.parametrize('m,k,n', _KBLOCKED_SHAPES)
def test_kblocked_hopper_equals_plain_and_matmul_kernel(dev, m, k, n):
    """#5 on the Hopper core (K in one piece, on a handle and on plain
    weights) == #1 == the plain version, one launch each."""
    rng = np.random.RandomState(m + k + n)
    x, w, b, mult = _operands(rng, m, k, n, dev)
    prepared = km.prepare_weights(w)
    for out_bits, signed, relu in _EPILOGUES:
        lo, hi = km.epilogue_bounds(out_bits, signed, relu)
        kw = dict(out_bits=out_bits, signed=signed, relu=relu)
        want = km.matmul_requant_plain(x, w, b, mult, lo, hi)
        torch.testing.assert_close(km.int8_matmul_requant(x, prepared, b,
                                                          mult, **kw),
                                   want, rtol=0, atol=0)
        for weights in (prepared, w):
            _build.reset_launches()
            got = km.int8_matmul_requant_kblocked(x, weights, b, mult, **kw)
            assert _counts() == {'int8_matmul_requant_kblocked': 1}
            torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# D1, the depthwise conv, and the MobileNetV2 / ResNet v2 families
# ---------------------------------------------------------------------------

def _counts():
    return {k: v for k, v in _build.LAUNCHES.items() if v}


_DW_SHAPES = [((2, 7, 7, 8), 1), ((1, 9, 13, 24), 2), ((1, 7, 7, 40), 1),
              ((2, 15, 11, 16), 2), ((1, 1, 1, 32), 1), ((8, 56, 56, 144), 2),
              ((8, 112, 112, 32), 1), ((2, 14, 14, 960), 1),
              ((2, 5, 9, 3), 1), ((1, 2, 6, 12), 2), ((2, 9, 10, 20), 1)]


def _dw_plans(shape, stride, ptrs):
    """The rule's plan for these pointers, then every form they allow (4
    channels a thread with 16- and 4-byte staging copies, one channel) at
    each pixels-a-thread choice, with tiles that leave ragged edges."""
    from hawq_tpu_torch.kernels import depthwise as kd
    b, h, w, c = shape
    vec, copy = kd.dw_form(c, *ptrs)
    plans = [kd.dw_plan(b, h, w, c, stride, vec=vec, copy=copy)]
    forms = [(1, 1)] + ([(4, 4)] if vec == 4 else []) + (
        [(4, 16)] if copy == 16 else [])
    for v, cp in forms:
        cs = kd.dw_plan(b, h, w, c, stride, vec=v, copy=cp).cs
        for p in ((2, 4) if v == 4 else (4 // stride,)):
            for ng, rows in ((1, 1), (3, 2)):
                plans.append(kd.DwPlan(v, cp, p, cs, ng, rows))
    return plans


@pytest.mark.parametrize('shape,stride', _DW_SHAPES)
def test_dwconv_kernel_equals_plain(dev, shape, stride):
    """Both forms of D1 against their plain versions, bit for bit, at the
    rule's tile and at every form and pixels-a-thread choice the pointers
    allow, with ragged tile edges: 4 channels a thread (16- and 4-byte
    staging copies) and one (C off 4, an input one byte off alignment);
    an input 4 bytes off 16-byte alignment; saturated operands, .5
    requant boundaries, ReLU6 bounds binding on some channels."""
    from hawq_tpu_torch.inference.engine_mobilenet import relu6_bound
    from hawq_tpu_torch.kernels import depthwise as kd
    rng = np.random.RandomState(sum(shape) + stride)
    c = shape[3]
    x = torch.tensor(rng.randint(-128, 128, shape).astype(np.int8),
                     device=dev)
    w = torch.tensor(rng.randint(-127, 128, (3, 3, 1, c)).astype(np.int8),
                     device=dev)
    b = torch.tensor(rng.randint(-2 ** 18, 2 ** 18, c).astype(np.int32),
                     device=dev)
    acc_scale = (rng.rand(c) * 3e-4 + 2e-5).astype(np.float32)
    acc_scale[::2] = 6.0 / 40.0
    mult = np_dyadic_multiplier((rng.rand(c) * 0.02 + 1e-3).astype(
        np.float32))
    mult[1::3] = 0.5
    hi6 = torch.tensor(relu6_bound(acc_scale), device=dev)
    mult = torch.tensor(mult, device=dev)
    sat = (torch.full_like(x, -128), torch.full_like(w, -127))
    flat = torch.empty(x.numel() + 4, dtype=torch.int8, device=dev)
    flat[4:] = x.reshape(-1)
    off4 = flat[4:].view(x.shape)               # 4 bytes off 16
    big = shape[1] * shape[3] > 4000
    for xx, ww in ((x, w), sat, (_unaligned(x), w), (off4, w)):
        want = kd.dwconv_acc_plain(xx, ww, b, stride)
        wantq = {(lo, hi): kd.dwconv_requant_plain(xx, ww, b, hi6, mult,
                                                   stride, lo, hi)
                 for lo, hi in ((-128, 127), (0, 15))}
        plans = _dw_plans(shape, stride, (xx.data_ptr(), ww.data_ptr(), 0))
        for plan in plans[:1] if big else plans:
            _build.reset_launches()
            kw = dict(stride=stride, plan=plan)
            torch.testing.assert_close(kd.int8_dwconv_acc(xx, ww, b, **kw),
                                       want, rtol=0, atol=0)
            for (lo, hi), wq in wantq.items():
                got = kd.int8_dwconv_requant(xx, ww, b, hi6, mult, lo=lo,
                                             hi=hi, **kw)
                torch.testing.assert_close(got, wq, rtol=0, atol=0)
            assert _counts() == {'int8_dwconv_acc': 1,
                                 'int8_dwconv_requant': 2}
        # the rule's own plan, as the wrappers pick it
        torch.testing.assert_close(kd.int8_dwconv_acc(xx, ww, b,
                                                      stride=stride),
                                   want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        kd.int8_dwconv_acc(x, w, b, stride=3)
    with pytest.raises(ValueError):              # a CPU weight on the card
        kd.int8_dwconv_acc(x, w.cpu(), b, stride=1)
    with pytest.raises(ValueError):              # 4 channels a thread, but
        kd.int8_dwconv_acc(_unaligned(x), w, b, stride=stride,   # unaligned
                           plan=kd.DwPlan(4, 4, 2, 1, 1, 1))


@pytest.mark.parametrize('mode,residual', [('folded_float32', torch.int16),
                                           ('float32', torch.int32)])
def test_mobilenet_engine_cuda_equals_cpu(dev, mode, residual):
    """Full-width MobileNetV2 at 64×64: logits and every unit's nodes equal
    the CPU engine's; D1 17 times, the 1×1 convs on the Hopper core (K = 24
    zero-padded to 32 first)."""
    from hawq_tpu_torch.inference.engine_mobilenet import (
        build_mobilenetv2_engine)
    from hawq_tpu_torch.inference.fold import fold4_images_3x3s2
    from hawq_tpu_torch.inference.synthetic import synthetic_frozen_mobilenet
    fm = synthetic_frozen_mobilenet(get_bit_config('mobilenetv2_w1',
                                                   'uniform8'), seed=2)
    x = np.random.RandomState(5).randn(2, 64, 64, 3).astype(np.float32)
    if mode == 'folded_float32':
        x = fold4_images_3x3s2(x, 1)
    kw = dict(input_mode=mode, residual_dtype=residual, input_hw=(64, 64))
    want = build_mobilenetv2_engine(fm, device='cpu', **kw)(x)
    _build.reset_launches()
    got = build_mobilenetv2_engine(fm, device=dev, **kw)(x)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    assert _counts() == {'int8_conv_acc': 1, 'int8_matmul_acc': 36,
                         'int8_dwconv_requant': 17, 'requant_int32': 45}
    for node in ('init', 'features.stage2.unit2.conv2',
                 'features.stage4.unit5.quant_act_int32', 'final'):
        torch.testing.assert_close(
            build_mobilenetv2_engine(fm, capture=node, device=dev, **kw)(
                x).cpu(),
            build_mobilenetv2_engine(fm, capture=node, device='cpu', **kw)(
                x), rtol=0, atol=0, msg=node)


def test_resnet_v2_engine_cuda_equals_cpu(dev):
    from hawq_tpu_torch.inference.engine_v2 import build_resnet_v2_engine
    from hawq_tpu_torch.inference.synthetic import synthetic_frozen_resnet_v2
    fm = synthetic_frozen_resnet_v2(
        'resnet50v2', get_bit_config('resnet50v2', 'uniform8'), seed=2)
    x = np.random.RandomState(5).randn(2, 64, 64, 3).astype(np.float32)
    want = build_resnet_v2_engine(fm, device='cpu')(x)
    _build.reset_launches()
    got = build_resnet_v2_engine(fm, device=dev)(x)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    assert {k: v for k, v in _counts().items() if k != 'requant_int32'} == {
        'int8_conv_acc': 1, 'int8_matmul_requant': 16,
        'int8_conv_requant': 16, 'int8_matmul_acc': 21}
    for node in ('init', 'stage2.unit1.pre', 'stage4.unit3.quant_act_int32',
                 'fc_input'):
        torch.testing.assert_close(
            build_resnet_v2_engine(fm, capture=node, device=dev)(x).cpu(),
            build_resnet_v2_engine(fm, capture=node, device='cpu')(x),
            rtol=0, atol=0, msg=node)


@pytest.mark.parametrize('arch', ['tiny_mnv2', 'tiny50v2',
                                  'tiny_inceptionv3'])
def test_family_qat_forward_cuda_equals_cpu(dev, arch):
    """Calibration passes and a frozen-range forward of the tiny MobileNetV2
    (the depthwise convs through D1's accumulator form), ResNet v2 and
    InceptionV3 (75², its smallest size) on the card: ranges, every q_int
    and the logits equal the CPU's."""
    from hawq_tpu_torch.train.trainer import TrainerConfig, build_model
    size = 75 if 'inception' in arch else 32
    x = np.random.RandomState(4).randn(2, size, size, 3).astype(np.float32)
    results = {}
    for name, device in (('cpu', torch.device('cpu')), ('cuda', dev)):
        model = build_model(TrainerConfig(arch=arch, num_classes=10,
                                          seed=3))[0].to(device)
        xt = torch.tensor(x, device=device)
        _build.reset_launches()
        with torch.no_grad(), L.capture_q_int(model) as q:
            for _ in range(2):
                model(xt, folded=True, update_stats=True)
            logits = model(xt, folded=True, update_stats=False)
        results[name] = ({k: v.cpu() for k, v in q.items()},
                         {k: v.cpu() for k, v in model.named_buffers()},
                         logits.cpu())
    if arch == 'tiny_mnv2':
        assert _counts()['int8_dwconv_acc'] == 3 * 3
    for got, want in zip(results['cuda'][:2], results['cpu'][:2]):
        assert sorted(got) == sorted(want)
        for key in want:
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0,
                                       msg=key)
    torch.testing.assert_close(results['cuda'][2], results['cpu'][2], rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# InceptionV3: A1, the conv geometries, the engine
# ---------------------------------------------------------------------------

def _avgpool_check(x, mult, bits=8, signed=True, vec=None):
    want = ka.avgpool3x3_requant_plain(x.cpu(), mult.cpu(), bits, signed)
    got = ka.int_avgpool3x3_requant(x, mult, out_bits=bits, signed=signed)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    return want


@pytest.mark.parametrize('dtype', [torch.int32, torch.int16, torch.int8])
def test_avgpool_kernel_equals_plain(dev, dtype):
    """A1 over the ragged set: every H, W in {1, 2, 3, 5, 8, 17, 35} with C
    cycling through {1, 3, 4, 12, 32, 288}, per-tensor and per-channel
    multipliers, both forms (4 channels a thread; one, for C % 4 or an
    unaligned input), saturated inputs, negative multiples of 9, and
    requant products on a .5 boundary; one launch each."""
    rng = np.random.RandomState(7)
    hi = 128 if dtype == torch.int8 else 32768
    hws = (1, 2, 3, 5, 8, 17, 35)
    cs = (1, 3, 4, 12, 32, 288)
    _build.reset_launches()
    n = 0
    for i, h in enumerate(hws):
        for j, w in enumerate(hws):
            c = cs[(i + j) % len(cs)]
            x = torch.tensor(rng.randint(-hi, hi, (2, h, w, c)),
                             dtype=dtype, device=dev)
            scale = 64.0 if dtype == torch.int8 else 1.0
            per_t = torch.tensor(np_dyadic_multiplier(np.float32(
                scale * (rng.rand() * 0.01 + 0.002))), device=dev)
            per_c = torch.tensor(np_dyadic_multiplier((scale * (
                rng.rand(c) * 0.01 + 0.002)).astype(np.float32)), device=dev)
            _avgpool_check(x, per_t)
            _avgpool_check(_unaligned(x), per_c, 4, False)
            n += 2
    x = torch.full((2, 5, 7, 8), -hi + 1, dtype=dtype, device=dev)
    x[:, 2, 3, ::2] = hi - 1                     # saturated
    _avgpool_check(x, torch.tensor(np.float32(2 ** -12), device=dev))
    x = torch.full((1, 4, 5, 4), -9, dtype=dtype, device=dev)
    assert _avgpool_check(x, torch.tensor(np.float32(1.0), device=dev))[
        0, 1, 1, 0] == -8                         # trunc(-9 + 0.01)
    p = torch.arange(1, 128, 2, dtype=dtype, device=dev)
    x = p.expand(1, 3, 3, p.numel()).contiguous()
    want = _avgpool_check(x, torch.tensor(np.float32(0.5), device=dev))
    torch.testing.assert_close(want[0, 1, 1], torch.floor(
        p.cpu().float() * 0.5 + 0.5).clamp(-128, 127).to(torch.int8))
    n += 3
    assert _counts() == {'int_avgpool3x3_requant': n}
    x = torch.zeros((1, 3, 3, 4), dtype=dtype, device=dev)
    one = torch.tensor(np.float32(1.0), device=dev)
    with pytest.raises(ValueError):                  # 16 bits into int8
        ka.int_avgpool3x3_requant(x, one, out_bits=16, signed=True)
    with pytest.raises(ValueError):                  # a CPU multiplier
        ka.int_avgpool3x3_requant(x, one.cpu(), out_bits=8, signed=True)
    with pytest.raises(ValueError):                  # (C,) of another C
        ka.int_avgpool3x3_requant(x, one.expand(3).contiguous(), out_bits=8,
                                  signed=True)
    with pytest.raises(ValueError):
        ka.int_avgpool3x3_requant(x.float(), one, out_bits=8, signed=True)


def _fused_check(x, mult, in_mult, in_bits, in_signed, bits=8, signed=True,
                 plan=None):
    want = ka.avgpool3x3_requant_plain(
        x.cpu(), mult.cpu(), bits, signed, in_mult=in_mult.cpu(),
        in_bits=in_bits, in_signed=in_signed)
    got = ka.int_avgpool3x3_requant(x, mult, out_bits=bits, signed=signed,
                                    in_mult=in_mult, in_bits=in_bits,
                                    in_signed=in_signed, plan=plan)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0,
                               msg=f'{tuple(x.shape)} {x.dtype} {plan}')
    return want


@pytest.mark.parametrize('dtype', [torch.int32, torch.int16, torch.int8])
def test_avgpool_fused_kernel_equals_plain(dev, dtype):
    """A1 with the requant in front over the ragged set (every H, W in {1,
    2, 3, 5, 8, 17, 35}, C cycling through {1, 3, 4, 12, 32, 288}, aligned
    and unaligned inputs), into 16 bits signed and unsigned and into 8
    bits, per-tensor and per-channel multipliers in front and after; every
    form of the kernel at ragged tiles (16-byte copies, one-word copies,
    one channel a thread) of 1 to 9 rows; one launch each."""
    rng = np.random.RandomState(11)
    hi = 128 if dtype == torch.int8 else 32768
    base = 100.0 if dtype == torch.int8 else 1.0
    hws = (1, 2, 3, 5, 8, 17, 35)
    cs = (1, 3, 4, 12, 32, 288)
    fronts = ((16, True), (16, False), (8, True))
    _build.reset_launches()
    n = 0
    for i, h in enumerate(hws):
        for j, w in enumerate(hws):
            c = cs[(i + j) % len(cs)]
            in_bits, in_signed = fronts[(i + 2 * j) % 3]
            x = torch.tensor(rng.randint(-hi, hi, (2, h, w, c)),
                             dtype=dtype, device=dev)
            small = 1 / 64 if in_bits == 8 else 1.0
            in_t = torch.tensor(np_dyadic_multiplier(np.float32(
                base * small * (rng.rand() * 1.5 + 0.25))), device=dev)
            in_c = torch.tensor(np_dyadic_multiplier((base * small * (
                rng.rand(c) * 1.5 + 0.25)).astype(np.float32)), device=dev)
            per_t = torch.tensor(np_dyadic_multiplier(np.float32(
                rng.rand() * 0.01 + 0.002)), device=dev)
            per_c = torch.tensor(np_dyadic_multiplier((
                rng.rand(c) * 0.01 + 0.002).astype(np.float32)), device=dev)
            _fused_check(x, per_t, in_c, in_bits, in_signed)
            _fused_check(_unaligned(x), per_c, in_t, in_bits, in_signed, 4,
                         False)
            n += 2
    x = torch.tensor(rng.randint(-hi, hi, (2, 9, 11, 32)), dtype=dtype,
                     device=dev)
    in_m = torch.tensor(np.float32(base), device=dev)
    m = torch.tensor(np.float32(2 ** -7), device=dev)
    es = x.element_size()
    for plan in (ka.AvgPlan(4, 16, 16 // (4 * es), 3, 2),
                 ka.AvgPlan(4, 4 * es, 2 if es == 4 else 4, 11, 1),
                 ka.AvgPlan(4, 16, 8, 2, 9), ka.AvgPlan(4, 16, 8, 11, 4),
                 ka.AvgPlan(1, es, 32, 4, 3), ka.AvgPlan(1, es, 4, 11, 9)):
        _fused_check(x, m, in_m, 16, True, plan=plan)
        n += 1
    assert _counts() == {'int_avgpool3x3_requant': n}
    one = torch.tensor(np.float32(1.0), device=dev)
    with pytest.raises(ValueError):                  # 17 bits in front
        ka.int_avgpool3x3_requant(x, one, out_bits=8, signed=True,
                                  in_mult=one, in_bits=17, in_signed=True)
    with pytest.raises(ValueError):                  # a CPU multiplier
        ka.int_avgpool3x3_requant(x, one, out_bits=8, signed=True,
                                  in_mult=one.cpu(), in_bits=16,
                                  in_signed=True)


@pytest.mark.parametrize('dtype', [torch.int32, torch.int16, torch.int8])
def test_avgpool_fused_saturating_equals_plain(dev, dtype):
    """A requant in front that drives every input to the ends of 16 bits
    (±32767, and 65535 unsigned: window sums up to 9·65535, the integer
    quotient's bound), on int32 also inputs beyond 2²⁴; a constant −9
    field through a multiplier of 1 (trunc(−9 + 0.01) = −8); at the main
    path's shapes too."""
    top = torch.iinfo(dtype).max
    for shape in ((2, 5, 7, 8), (2, 5, 7, 3), (8, 17, 17, 768),
                  (8, 8, 8, 2048)):
        x = torch.full(shape, top, dtype=dtype, device=dev)
        x[:, 2, 3, ::2] = -top
        x[1] = -x[1]
        if dtype == torch.int32:
            x[0, 0, 0] = 2 ** 30 + 1
        for in_signed in (True, False):
            m_sat = torch.tensor(np.float32(2 ** 20 / min(top, 32767)),
                                 device=dev)
            half = torch.tensor(np.where(
                np.arange(shape[3]) % 2, 2 ** 20 / min(top, 32767),
                0.5).astype(np.float32), device=dev)
            for in_mult in (m_sat, half):
                _fused_check(x, torch.tensor(np.float32(2 ** -9), device=dev),
                             in_mult, 16, in_signed)
                _fused_check(x, torch.tensor(np.float32(2 ** -13),
                                             device=dev),
                             in_mult, 16, in_signed, 4, False)
    x = torch.full((1, 4, 5, 4), -9, dtype=dtype, device=dev)
    one = torch.tensor(np.float32(1.0), device=dev)
    assert _fused_check(x, one, one, 16, True)[0, 1, 1, 0] == -8


# InceptionV3's conv geometries on the Hopper core: (B, H, W, C), N, taps,
# stride, pad (ph, pw); tests/test_torch_inception_walk.py holds the walk
# at the same calls against the reference conv on the CPU
_INCEPTION_CONVS = [
    ((2, 17, 17, 32), 48, (1, 7), 1, (0, 3)),
    ((2, 17, 17, 32), 16, (7, 1), 1, (3, 0)),
    ((2, 17, 15, 16), 32, (1, 7), 1, (0, 3)),
    ((2, 8, 8, 64), 32, (1, 3), 1, (0, 1)),
    ((1, 8, 8, 48), 64, (3, 1), 1, (1, 0)),
    ((2, 9, 9, 16), 32, (5, 5), 1, (2, 2)),
    ((2, 17, 19, 32), 48, (3, 3), 1, (0, 0)),
    ((1, 10, 10, 80), 192, (3, 3), 1, (0, 0)),
    ((2, 35, 35, 16), 32, (3, 3), 2, (0, 0)),
    ((1, 17, 17, 32), 48, (3, 3), 2, (0, 0)),
    ((1, 35, 35, 3), 32, (3, 3), 2, (0, 0)),
    ((8, 17, 17, 768), 192, (1, 7), 1, (0, 3)),
    ((8, 17, 17, 160), 160, (7, 1), 1, (3, 0)),
    ((8, 8, 8, 448), 384, (3, 3), 1, (1, 1)),
    ((8, 8, 8, 384), 384, (1, 3), 1, (0, 1)),
    ((8, 35, 35, 48), 64, (5, 5), 1, (2, 2)),
    ((8, 73, 73, 80), 192, (3, 3), 1, (0, 0)),
    ((8, 147, 147, 32), 64, (3, 3), 1, (1, 1)),
    ((8, 149, 149, 32), 32, (3, 3), 1, (0, 0)),
    ((8, 299, 299, 3), 32, (3, 3), 2, (0, 0)),
    ((8, 35, 35, 288), 384, (3, 3), 2, (0, 0)),
    ((8, 17, 17, 192), 320, (3, 3), 2, (0, 0)),
]


@pytest.mark.parametrize('shape,n,taps,stride,pad', _INCEPTION_CONVS)
def test_sm90_conv_at_inception_geometries(dev, shape, n, taps, stride, pad):
    """#6 and #7 at InceptionV3's geometries (ragged and full-width shapes)
    on the Hopper core, by ``kernels.conv.conv_call``'s geometry with the
    border left to TMA, equal to the core's walk on the CPU
    (``conv_acc_tiled_plain`` / ``conv_requant_tiled_plain``)."""
    rng = np.random.RandomState(sum(shape) + n + sum(taps))
    x = torch.tensor(rng.randint(-128, 128, shape).astype(np.int8),
                     device=dev)
    w = rng.randint(-127, 128, (*taps, shape[3], n)).astype(np.int8)
    _, _, bias, mult = _operands(rng, 1, 1, n, dev)
    padding = ((pad[0], pad[0]), (pad[1], pad[1]))
    xp, geo = kc.conv_call(x, taps, (stride, stride), padding)
    wf = torch.tensor(kc.flatten_conv_kernel(kc.conv_call_kernel(
        w, (stride, stride))), device=dev)
    prepared = kc.prepare_conv_weights(wf, geo['taps'], geo['cin'],
                                       geo['pad'])
    walk = {k: geo[k] for k in ('taps', 'out_hw', 'cin')}
    slab = kc.pad_conv_input(xp.cpu(), geo['pad'], **walk)
    host = kc.prepare_conv_weights(wf.cpu(), geo['taps'], geo['cin'],
                                   geo['pad'])
    want_acc = kc.conv_acc_tiled_plain(slab, host, bias.cpu(), **walk)
    want_q = kc.conv_requant_tiled_plain(slab, host, bias.cpu(), mult.cpu(),
                                         lo=0, hi=127, **walk)
    _build.reset_launches()
    for weights in (prepared, wf):
        torch.testing.assert_close(
            kc.int8_conv_acc(xp, weights, bias, **geo).cpu(), want_acc,
            rtol=0, atol=0)
        torch.testing.assert_close(
            kc.int8_conv_requant(xp, weights, bias, mult, relu=True,
                                 **geo).cpu(), want_q, rtol=0, atol=0)
    assert _counts() == {'int8_conv_acc': 2, 'int8_conv_requant': 2}


@pytest.mark.parametrize('width_div,scheme,mode,wide', [
    (16, 'uniform8', 'folded_float32', torch.int16),
    (1, 'uniform8', 'folded_float32', torch.int32),
    (1, 'uniform4', 'float32', torch.int16)])
def test_inception_engine_cuda_equals_cpu(dev, width_div, scheme, mode,
                                          wide):
    """InceptionV3 at 75² on the card: logits and the capture nodes equal
    the CPU engine's; A1 nine times; at full width the 94 convs and the
    FC."""
    from hawq_tpu_torch.inference.engine_inception import (
        build_inceptionv3_engine)
    from hawq_tpu_torch.inference.fold import fold4_images_3x3s2
    from hawq_tpu_torch.inference.synthetic import synthetic_frozen_inception
    fm = synthetic_frozen_inception(get_bit_config('inceptionv3', scheme),
                                    width_div=width_div, seed=2)
    x = np.random.RandomState(5).randn(2, 75, 75, 3).astype(np.float32)
    if mode == 'folded_float32':
        x = fold4_images_3x3s2(x, 0)
    kw = dict(input_mode=mode, wide_dtype=wide, input_hw=(75, 75))
    want = build_inceptionv3_engine(fm, device='cpu', **kw)(x)
    _build.reset_launches()
    got = build_inceptionv3_engine(fm, device=dev, **kw)(x)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    counts = _counts()
    assert counts['int_avgpool3x3_requant'] == 9
    if width_div == 1:
        assert sum(v for k, v in counts.items()
                   if not k.startswith('requant_')) == 9 + 95, counts
    for node in ('init', 'features.stage1.unit3.q_rescaling_activ',
                 'features.stage2.unit1.q_rescaling_activ',
                 'features.stage2.unit5.q_rescaling_activ',
                 'features.stage3.unit1.q_rescaling_activ', 'fc_input'):
        torch.testing.assert_close(
            build_inceptionv3_engine(fm, capture=node, device=dev, **kw)(
                x).cpu(),
            build_inceptionv3_engine(fm, capture=node, device='cpu', **kw)(
                x), rtol=0, atol=0, msg=node)



# ---------------------------------------------------------------------------
# the reference-checkpoint replay: A1's quotient form, the float64 requant,
# the engines in reference mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.int32, torch.int16, torch.int8])
def test_avgpool_quotient_kernel_equals_plain(dev, dtype):
    """A1's quotient form (no requant, int32 out) over the ragged set: every
    H, W in {1, 2, 3, 5, 8, 17, 35} with C cycling through {1, 3, 4, 12,
    288}, both forms (an unaligned input takes one channel a thread),
    saturated inputs and a constant −9 field; one launch each."""
    rng = np.random.RandomState(11)
    top = min(torch.iinfo(dtype).max, 2 ** 31 // 9)    # int32: no overflow
    hws = (1, 2, 3, 5, 8, 17, 35)
    cs = (1, 3, 4, 12, 288)
    _build.reset_launches()
    n = 0

    def check(x):
        got = ka.int_avgpool3x3(x)
        assert got.dtype == torch.int32 and got.shape == x.shape
        torch.testing.assert_close(got.cpu(), ka.avgpool3x3_plain(x.cpu()),
                                   rtol=0, atol=0)
    for i, h in enumerate(hws):
        for j, w in enumerate(hws):
            c = cs[(i + j) % len(cs)]
            x = torch.tensor(rng.randint(-min(top, 2 ** 26), min(top, 2 ** 26),
                                         (2, h, w, c)),
                             dtype=dtype, device=dev)
            check(x)
            check(_unaligned(x))
            n += 2
    x = torch.full((2, 5, 7, 12), top, dtype=dtype, device=dev)
    x[:, 2, 3, ::2] = -top
    x[1] = -x[1]
    check(x)                                    # saturating sums
    check(torch.full((1, 4, 5, 4), -9, dtype=dtype, device=dev))
    n += 2
    assert _counts() == {'int_avgpool3x3': n}
    with pytest.raises(ValueError):
        ka.int_avgpool3x3(x.float())


def test_reference_requant_cuda_equals_cpu(dev):
    """requant_int32_ref / requant_add_int32_ref on the card (float64 on the
    device) == on the CPU: on dyadic ratios with accumulators on ties, and
    with mantissas near 2³¹ on |acc| up to 2³¹−1 (products above 2⁵³)."""
    from hawq_tpu_torch.quant import ops as qops
    from hawq_tpu_torch.quant import reference_oracle as ro
    rng = np.random.RandomState(3)
    c = 8
    dyadic = np.exp2(-np.arange(1, c + 1)).astype(np.float32)
    top = (np.float32(1.0) - rng.randint(1, 64, c).astype(np.float32)
           * np.float32(2 ** -24))
    ties = ((2 * rng.randint(-7000, 7000, (4, 5, 6, c)) + 1)
            << np.arange(c)).astype(np.int32)
    big = rng.randint(-2 ** 31 + 1, 2 ** 31, (4, 5, 6, c)).astype(np.int32)
    for acc_scale, out_scale, acc in ((dyadic, np.float32(1.0), ties),
                                      (top, np.float32(0.5), big)):
        m, inv2e = (torch.from_numpy(np.asarray(a))
                    for a in ro.decompose_ref(acc_scale, out_scale))
        a = torch.from_numpy(acc)
        for bits, signed in ((16, True), (8, True), (4, False)):
            want = qops.requant_int32_ref(a, m, inv2e, bits, signed,
                                          torch.int32)
            got = qops.requant_int32_ref(a.to(dev), m.to(dev), inv2e.to(dev),
                                         bits, signed, torch.int32)
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
        half = a >> 3
        want = qops.requant_add_int32_ref(half, m, inv2e, half.flip(0), m,
                                          inv2e)
        got = qops.requant_add_int32_ref(half.to(dev), m.to(dev),
                                         inv2e.to(dev), half.flip(0).to(dev),
                                         m.to(dev), inv2e.to(dev))
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def _every_node(engine, x):
    nodes = {}
    logits = engine._forward(x, lambda n, v: nodes.__setitem__(n, v.clone()))
    return logits.cpu(), {k: v.cpu() for k, v in nodes.items()}


_FUSED_FORMS = ('int8_conv_requant', 'int4w_conv_requant',
                'int8_matmul_requant', 'int4w_matmul_requant',
                'maxpool_folded_requant', 'int8_dwconv_requant',
                'int_avgpool3x3_requant', 'requant_int32', 'requant_concat')


@pytest.mark.parametrize('family,mode', [
    ('tiny50', 'folded_float32'), ('tiny18', 'float32'),
    ('tiny_mnv2', 'float32'), ('inceptionv3', 'float32')])
def test_reference_engine_cuda_equals_cpu(dev, family, mode):
    """Each family's reference-mode engine on its dyadic-scale synthetic
    model on the card == on the CPU at every capture node and on the
    logits; no fused-requant form launches; the dyadic model makes the
    mode differ from native."""
    from hawq_tpu_torch.configs.bit_config import BitConfig, QuantSettings
    from hawq_tpu_torch.inference.engine_inception import (
        build_inceptionv3_engine)
    from hawq_tpu_torch.inference.engine_mobilenet import (
        build_mobilenetv2_engine)
    from hawq_tpu_torch.inference.synthetic import (
        dyadic_scales, synthetic_frozen_inception, synthetic_frozen_mobilenet)
    from hawq_tpu_torch.models import mobilenetv2 as tm
    from hawq_tpu_torch.utils.checkpoint import (export_reference_quantized,
                                                 import_reference_quantized)
    size = 32
    if family == 'tiny_mnv2':
        fm = synthetic_frozen_mobilenet(
            BitConfig(name='t', table={}, settings=QuantSettings()),
            num_classes=10, seed=1, stages=tm.TINY_MNV2_STAGES,
            init_ch=tm.TINY_MNV2_INIT_CH, final_ch=tm.TINY_MNV2_FINAL_CH)
        build = lambda **kw: build_mobilenetv2_engine(fm, input_hw=(32, 32),
                                                      **kw)
        want_kernels = {'int8_dwconv_acc', 'int8_conv_acc', 'int8_matmul_acc'}
    elif family == 'inceptionv3':
        size = 75
        fm = synthetic_frozen_inception(get_bit_config('inceptionv3',
                                                       'uniform8'),
                                        num_classes=10, width_div=16, seed=1)
        build = lambda **kw: build_inceptionv3_engine(fm, input_hw=(75, 75),
                                                      **kw)
        want_kernels = {'int_avgpool3x3', 'int8_conv_acc', 'int8_matmul_acc'}
    else:
        fm = synthetic_frozen_resnet(family, get_bit_config(family,
                                                            'uniform4'),
                                     num_classes=10, seed=1)
        build = lambda **kw: build_resnet_engine(fm, input_mode=mode, **kw)
        want_kernels = {'int8_conv_acc', 'int4w_conv_acc', 'int8_matmul_acc'}
        if mode.startswith('folded'):
            want_kernels.add('maxpool_folded')
    # through the reference's checkpoint format, as a replay reads it
    fm = dyadic_scales(fm)
    fm.tensors = import_reference_quantized(
        export_reference_quantized(fm), fm.arch, fm.cfg).tensors
    x = np.random.RandomState(5).randn(2, size, size, 3).astype(np.float32)
    if mode == 'folded_float32':
        x = fold4_images(x)
    x = torch.from_numpy(x)
    want, want_nodes = _every_node(build(requant_mode='reference',
                                         device='cpu'), x)
    eng = build(requant_mode='reference', device=dev)
    eng(x.to(dev))
    _build.reset_launches()
    got, got_nodes = _every_node(eng, x.to(dev))
    counts = _counts()
    assert want_kernels <= set(counts) and not set(_FUSED_FORMS) & set(
        counts), counts
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert sorted(got_nodes) == sorted(want_nodes)
    for node, v in want_nodes.items():
        torch.testing.assert_close(got_nodes[node], v, rtol=0, atol=0,
                                   msg=node)
    native = _every_node(build(device=dev), x.to(dev))[1]
    assert any(not torch.equal(native[n], v) for n, v in got_nodes.items())


def test_hvp_cuda_equals_cpu(dev):
    """The Hutchinson HVP through tiny ResNet-18's QAT graph on the card
    (#7 and #2 in the forward, cuDNN's double backward with TF32 off) ==
    on the CPU for the same weights, ranges and probes, per leaf within
    1e-3 of the leaf's largest value; the traces likewise."""
    import copy
    from hawq_tpu_torch.sensitivity import hessian as th
    from hawq_tpu_torch.sensitivity.pipeline import qat_loss
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(2, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (2,)))
    cpu = QResNet('tiny18', get_bit_config('tiny18', 'uniform8'), 10, seed=0)
    with torch.no_grad():
        cpu(x, folded=True, update_stats=True)
    card = copy.deepcopy(cpu).to(dev)
    out = {}
    for name, model, d in (('cpu', cpu, 'cpu'), ('card', card, dev)):
        params = dict(model.named_parameters())
        probe = th.rademacher_like(params, torch.Generator().manual_seed(1))
        _build.reset_launches()
        hv = th.hvp(qat_loss(model, x.to(d), y.to(d)), params, probe)
        counts = _counts()
        traces = th.hutchinson_layer_traces(
            qat_loss(model, x.to(d), y.to(d)), params, n_probes=2)
        out[name] = ({k: v.cpu() for k, v in hv.items()}, traces, counts)
    assert {'int8_conv_acc', 'int8_matmul_acc'} <= set(out['card'][2])
    assert not out['cpu'][2]
    for k, want in out['cpu'][0].items():
        got = out['card'][0][k]
        assert float((got - want).abs().max()) <= 1e-3 * float(
            want.abs().max()), k
    for k, want in out['cpu'][1].items():
        assert abs(out['card'][1][k] - want) <= 1e-3 * abs(want) + 1e-12, k


def test_qonnx_replay_equals_card_engine(dev, tmp_path):
    """The QONNX file of a tiny ResNet-50 uniform4 model, replayed by the
    numpy int64 interpreter, == the card engine's logits (the packed int4
    kernels) on the same images."""
    from hawq_tpu_torch.export import qonnx
    fm = synthetic_frozen_resnet('tiny50', get_bit_config('tiny50',
                                                          'uniform4'),
                                 num_classes=10, seed=2)
    path = str(tmp_path / 'm.onnx')
    qonnx.export_qonnx(fm, path, image_size=32)
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    replay = qonnx.replay_qonnx(qonnx.load_qonnx(path), x)
    _build.reset_launches()
    eng = build_resnet_engine(fm, device=dev)(torch.from_numpy(x).to(dev))
    assert any(k.startswith('int4w_') for k in _counts())
    np.testing.assert_array_equal(replay.astype(np.float32),
                                  eng.cpu().numpy())


# ---------------------------------------------------------------------------
# the deployment surface: deploy, routed 1×1 sites, timing
# ---------------------------------------------------------------------------

def test_deploy_cuda_equals_cpu(dev, tmp_path, capsys):
    """``deploy.main`` on the card prints what it prints on the CPU (top-k;
    the capture's verdict and values)."""
    from hawq_tpu_torch import deploy
    from hawq_tpu_torch.utils.checkpoint import save_frozen
    fm = synthetic_frozen_resnet('tiny18', get_bit_config('tiny18',
                                                          'uniform4'),
                                 num_classes=10, seed=4)
    path = str(tmp_path / 'quantized_checkpoint.npz')
    save_frozen(path, fm)
    base = ['--frozen', path, '--image-size', '32', '--batch', '3']

    def run(args, device):
        assert deploy.main(base + args + ['--device', device]) == 0
        return [l for l in capsys.readouterr().out.splitlines()
                if not l.startswith('device=')]
    assert run([], 'cuda') == run([], 'cpu')
    node = ['--capture', 'stage2.unit1.quant_act_int32']
    run(node + ['--save-capture', str(tmp_path / 'cpu.npy')], 'cpu')
    got = run(node + ['--save-capture', str(tmp_path / 'card.npy'),
                      '--compare', str(tmp_path / 'cpu.npy')], 'cuda')
    assert any('100% matched!' in l for l in got)
    np.testing.assert_array_equal(np.load(tmp_path / 'card.npy'),
                                  np.load(tmp_path / 'cpu.npy'))


@pytest.mark.parametrize('family', ['mobilenetv2', 'inceptionv3'])
def test_routed_int4w_sites_equal_plain(dev, family):
    """Every 1×1 site of MobileNetV2 w1 (#4, the accumulator form) and of
    InceptionV3 w1 (#3 with ReLU) at b8 on nibble-packed 4-bit weights ==
    the plain version (the same site on the CPU), tolerance 0, on the
    Hopper core (MobileNetV2's K = 24 zero-padded first)."""
    from hawq_tpu_torch.inference import routing as rt
    sites = (rt.mobilenet_conv1x1_sites() if family == 'mobilenetv2'
             else rt.inception_conv1x1_sites())
    rng = np.random.RandomState(len(sites))
    cpu = torch.device('cpu')
    for key, spatial, cin, cout, epi in sites:
        w = rng.randint(-8, 8, (1, 1, cin, cout)).astype(np.int8)
        b = rng.randint(-2 ** 15, 2 ** 15, cout).astype(np.int32)
        x = torch.from_numpy(rng.randint(-128, 128, (
            8, spatial, spatial, cin)).astype(np.int8))
        card = rt.Routed1x1.prepare(w, b, True, dev)
        plain = rt.Routed1x1.prepare(w, b, True, cpu)
        if epi == 'acc':
            got, want = card.acc(x.to(dev)), plain.acc(x)
        else:
            mult = torch.tensor(np_dyadic_multiplier(
                (rng.rand(cout) * 2e-4 + 1e-5).astype(np.float32)))
            got = card.requant(x.to(dev), mult.to(dev), out_bits=8,
                               signed=True, relu=True)
            want = plain.requant(x, mult, out_bits=8, signed=True, relu=True)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0,
                                   msg=key)


def test_time_per_iter_on_a_cuda_engine(dev):
    from hawq_tpu_torch.utils.timing import time_per_iter
    fm = synthetic_frozen_resnet('tiny18', get_bit_config('tiny18',
                                                          'uniform8'),
                                 num_classes=10, seed=1)
    eng = build_resnet_engine(fm, device=dev)
    x = torch.randn(2, 32, 32, 3, device=dev)
    for n in (5, None):
        t = time_per_iter(eng, x, n_iters=n, max_iters=64)
        assert 0 < t < 1 and np.isfinite(t)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_serving_engine_nccl_world_1(dev):
    """The ServingEngine in a one-process ``nccl`` group: its replicas'
    logits (every visible card) == the engine's own call, bit for bit, from
    ``infer`` and from its batcher; throughput positive."""
    import functools
    import torch.distributed as dist
    from hawq_tpu_torch.parallel import distributed
    from hawq_tpu_torch.parallel.serving import ServingEngine
    fm = synthetic_frozen_resnet('tiny18', get_bit_config('tiny18',
                                                          'uniform8'),
                                 num_classes=10, seed=2)
    distributed.initialize(f'127.0.0.1:{_free_port()}', 1, 0)
    try:
        assert dist.get_backend() == 'nccl'
        n = torch.cuda.device_count()
        serving = ServingEngine(functools.partial(build_resnet_engine, fm),
                                batch_size=4 * n, image_shape=(32, 32, 3))
        x = np.random.RandomState(0).rand(4 * n, 32, 32, 3).astype(
            np.float32)
        want = build_resnet_engine(fm, device=dev)(x).cpu().numpy()
        np.testing.assert_array_equal(
            serving.fetch(serving.infer(serving.to_device(x))), want)
        b = serving.batcher(max_delay_ms=50.0)
        try:
            got = np.stack([s.get(timeout=60)
                            for s in [b.submit(im) for im in x]])
        finally:
            b.close()
        np.testing.assert_array_equal(got, want)
        assert serving.throughput() > 0
    finally:
        dist.destroy_process_group()


_CARD_RANK = r'''
import pickle, sys
import numpy as np
import torch
from hawq_tpu_torch.configs.bit_config import get_bit_config
from hawq_tpu_torch.models.resnet import QResNet
from hawq_tpu_torch.parallel import distributed
from hawq_tpu_torch.parallel import mesh as pmesh
from hawq_tpu_torch.train import train as ttrain
distributed.initialize(backend='gloo')
r = distributed.process_index()
dev = distributed.local_device('cuda')
batch = {k: torch.from_numpy(v[4 * r:4 * (r + 1)]).to(dev)
         for k, v in np.load(sys.argv[1] + '/batch.npz').items()}
model = QResNet('tiny18', get_bit_config('tiny18', 'uniform8'), 10).to(dev)
mesh = pmesh.make_mesh(2, 1, dev)
pmesh.distribute(model, mesh)
ttrain.make_calibration_step(model)(batch['image'])
state = ttrain.TrainState.create(model, ttrain.sgd_with_step_decay(model,
                                                                   1e-2))
state, m = ttrain.make_train_step(model, folded=True, mesh=mesh)(state,
                                                                  batch)
with open(sys.argv[1] + f'/rank{r}.pkl', 'wb') as f:
    pickle.dump(dict(loss=float(m['loss']), after=state.variables()), f)
torch.distributed.destroy_process_group()
'''


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_two_ranks_share_the_card_gloo_train_step(dev, tmp_path):
    """Two processes on one card over ``gloo`` (a data group of two):
    calibration and a folded tiny18 step == one process's on the global
    batch on the card: loss within 1e-5 relative, ranges exact, parameters
    within rtol 1e-5."""
    import os
    import pickle
    import subprocess
    import sys
    from hawq_tpu_torch.models.resnet import qat_to_numpy
    from hawq_tpu_torch.train import train as ttrain
    rng = np.random.RandomState(3)
    np.savez(tmp_path / 'batch.npz',
             image=rng.randn(8, 32, 32, 3).astype(np.float32),
             label=rng.randint(0, 10, 8))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, '-c', _CARD_RANK, str(tmp_path)], cwd=repo,
        env=dict(os.environ, PYTHONPATH=repo,
                 HAWQ_COORDINATOR=f'127.0.0.1:{port}',
                 HAWQ_NUM_PROCESSES='2', HAWQ_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail('a rank hung past 180 s')
        assert p.returncode == 0, out[-3000:]
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in np.load(tmp_path / 'batch.npz').items()}
    model = QResNet('tiny18', get_bit_config('tiny18', 'uniform8'),
                    10).to(dev)
    ttrain.make_calibration_step(model)(batch['image'])
    state = ttrain.TrainState.create(model, ttrain.sgd_with_step_decay(
        model, 1e-2))
    state, m = ttrain.make_train_step(model, folded=True)(state, batch)
    want = qat_to_numpy(model)
    for r in range(2):
        with open(tmp_path / f'rank{r}.pkl', 'rb') as f:
            got = pickle.load(f)
        assert abs(got['loss'] - float(m['loss'])) <= 1e-5 * abs(
            float(m['loss']))
        stats = dict(_leaves(got['after']['quant_stats']))
        for path, w in _leaves(want['quant_stats']):
            np.testing.assert_array_equal(stats[path], w, str(path))
        params = dict(_leaves(got['after']['params']))
        for path, w in _leaves(want['params']):
            np.testing.assert_allclose(params[path], w, rtol=1e-5,
                                       atol=1e-7, err_msg=str(path))


# ---------------------------------------------------------------------------
# the engine as a saved torch.export program
# ---------------------------------------------------------------------------

def _program_launches(fn, x):
    """(output, launches per kernel) of one ``fn(x)``, the counts set to 0
    just before it and read just after."""
    _build.reset_launches()
    out = fn(x)
    torch.cuda.synchronize()
    return out, _counts()


@pytest.mark.parametrize('arch,scheme,mode', [
    ('tiny18', 'uniform8', 'float32'), ('tiny50', 'uniform4', 'float32'),
    ('resnet18', 'uniform4', 'float32')])
def test_loaded_program_equals_engine(dev, arch, scheme, mode):
    """``load_program(export_program(fm))`` on the card: logits equal to the
    engine's, and the same launches per kernel, which are the bit config's
    prediction."""
    import chip_smoke
    from hawq_tpu_torch.export.export import export_program, load_program
    fm = synthetic_frozen_resnet(arch, get_bit_config(arch, scheme),
                                 num_classes=10, seed=1)
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 32, 32, 3).astype(
        np.float32)).to(dev)
    engine = build_resnet_engine(fm, device=dev)
    program = load_program(export_program(fm, 2, 32, device=dev))
    want, counts = _program_launches(engine, x)
    got, got_counts = _program_launches(program, x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got_counts == counts == chip_smoke.expected_launches(
        arch, fm.cfg, mode)


def test_card_program_loads_on_the_cpu(dev):
    """A program exported on the card and loaded with ``device='cpu'``
    (``load_program``'s move) runs the kernels' CPU implementations: logits
    equal to the CPU engine's and to the card program's."""
    from hawq_tpu_torch.export.export import export_program, load_program
    fm = synthetic_frozen_resnet('tiny50', get_bit_config(
        'tiny50', 'uniform4'), num_classes=10, seed=1)
    x = np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32)
    blob = export_program(fm, 2, 32, device=dev)
    on_card = load_program(blob)(torch.from_numpy(x).to(dev))
    _build.reset_launches()
    got = load_program(blob, device='cpu')(torch.from_numpy(x))
    assert got.device.type == 'cpu' and not _counts()
    want = build_resnet_engine(fm, device='cpu')(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(on_card.cpu(), want, rtol=0, atol=0)


def _family_engine(family, dev):
    """(engine on ``image_dependent(fm)``, two batches of its (2, …) input)
    of a folded ResNet (int16 carrier), a full-width MobileNetV2 at 64² or
    an InceptionV3 of width / 8 at 75² (normal images: at width / 16, or on
    uniform ones, every image gives the same logits)."""
    import chip_smoke
    from hawq_tpu_torch.inference import synthetic as syn
    from hawq_tpu_torch.inference.fold import fold4_images_3x3s2
    rngs = [np.random.RandomState(seed) for seed in (4, 5)]
    if family == 'resnet_folded':
        fm = synthetic_frozen_resnet('tiny50', get_bit_config(
            'tiny50', 'uniform4'), num_classes=10, seed=1)
        engine = build_resnet_engine(chip_smoke.image_dependent(fm),
                                     input_mode='folded_float32',
                                     residual_dtype=torch.int16, device=dev)
        xs = [fold4_images(rng.rand(2, 32, 32, 3).astype(np.float32))
              for rng in rngs]
    elif family == 'mobilenetv2':
        from hawq_tpu_torch.inference.engine_mobilenet import (
            build_mobilenetv2_engine)
        fm = syn.synthetic_frozen_mobilenet(get_bit_config(
            'mobilenetv2_w1', 'uniform8'), seed=2)
        engine = build_mobilenetv2_engine(chip_smoke.image_dependent(fm),
                                          input_hw=(64, 64), device=dev)
        xs = [rng.rand(2, 64, 64, 3).astype(np.float32) for rng in rngs]
    else:
        from hawq_tpu_torch.inference.engine_inception import (
            build_inceptionv3_engine)
        fm = syn.synthetic_frozen_inception(get_bit_config(
            'inceptionv3', 'uniform8'), width_div=8, seed=2)
        engine = build_inceptionv3_engine(
            chip_smoke.image_dependent(fm), input_mode='folded_float32',
            input_hw=(75, 75), device=dev)
        xs = [fold4_images_3x3s2(rng.randn(2, 75, 75, 3).astype(
            np.float32), 0) for rng in rngs]
    return engine, [torch.from_numpy(x).to(dev) for x in xs]


@pytest.mark.parametrize('family', ['resnet_folded', 'mobilenetv2',
                                    'inceptionv3'])
def test_exported_engine_equals_engine(dev, family):
    """``export_engine`` of a folded ResNet (int16 carrier), a full-width
    MobileNetV2 at 64² and an InceptionV3 of width / 8 at 75², on
    ``image_dependent`` weights, saved and loaded: logits and launches per
    kernel equal the engine's on the traced batch, and on
    another batch the logits equal the engine's and differ from the first
    batch's (the program reads its input)."""
    import io
    from hawq_tpu_torch.export.export import export_engine, load_program
    engine, (x, x2) = _family_engine(family, dev)
    buf = io.BytesIO()
    torch.export.save(export_engine(engine, x), buf)
    program = load_program(buf.getvalue())
    want, counts = _program_launches(engine, x)
    got, got_counts = _program_launches(program, x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got_counts == counts
    got2 = program(x2)
    torch.testing.assert_close(got2, engine(x2), rtol=0, atol=0)
    assert not torch.equal(got2, got)
