"""The Hopper core's conv walk at InceptionV3's geometries, on the CPU.

The card holds its conv kernels (#6 ``int8_conv_requant``, #7
``int8_conv_acc``) against this walk's plain versions
(``conv_acc_tiled_plain`` / ``conv_requant_tiled_plain``: the output image
cut into the core's pixel rectangles, each tap a box of the slab, the
weights K-major), so the walk must be right at the geometries this family
adds: 1×7 / 7×1 / 1×3 / 3×1 taps with a one-axis border, 5×5 with a
border of 2, 3×3 with no border at stride 1 (C = 80 takes the "kernel row
read as one tap" walk), and 3×3/s2/p0 through space-to-depth on odd sizes
(the RGB stem's C = 3 filled to 4).  Each call goes through
``kernels.conv.conv_call`` — the geometry the engine and the QAT layers
share — onto weights prepared for the Hopper core, the border left to the
kernel (on the CPU the wrapper pads, then walks), and is held bit-equal to
``hawq_tpu.inference.engine._conv_i8`` + bias and, for the requant form,
to ``hawq_tpu.quant.ops.requant_int32`` of the ReLU'd accumulator.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.inference.engine import _conv_i8
from hawq_tpu.quant import ops as jops

from hawq_tpu_torch.kernels import conv as tkc
from hawq_tpu_torch.kernels import matmul as tkm
from hawq_tpu_torch.quant.ops import np_dyadic_multiplier

torch.set_num_threads(1)

# (B, H, W, C), N, taps, stride, pad (ph, pw), operands
_CASES = [
    ((2, 17, 17, 32), 48, (1, 7), 1, (0, 3), 'random'),
    ((2, 17, 17, 32), 16, (7, 1), 1, (3, 0), 'random'),
    ((2, 17, 15, 16), 32, (1, 7), 1, (0, 3), 'saturated'),
    ((2, 8, 8, 64), 32, (1, 3), 1, (0, 1), 'random'),
    ((1, 8, 8, 48), 64, (3, 1), 1, (1, 0), 'random'),
    ((2, 9, 9, 16), 32, (5, 5), 1, (2, 2), 'random'),
    ((1, 8, 8, 48), 16, (5, 5), 1, (2, 2), 'saturated'),
    ((2, 17, 19, 32), 48, (3, 3), 1, (0, 0), 'random'),
    ((1, 10, 10, 80), 192, (3, 3), 1, (0, 0), 'random'),
    ((1, 10, 10, 80), 16, (3, 3), 1, (0, 0), 'saturated'),
    ((2, 35, 35, 16), 32, (3, 3), 2, (0, 0), 'random'),
    ((1, 17, 17, 32), 48, (3, 3), 2, (0, 0), 'random'),
    ((1, 15, 15, 48), 16, (3, 3), 2, (0, 0), 'saturated'),
    ((1, 35, 35, 3), 32, (3, 3), 2, (0, 0), 'random'),
]


def _operands(shape, n, taps, case):
    rng = np.random.RandomState(sum(shape) + n + sum(taps))
    x = rng.randint(-128, 128, shape).astype(np.int8)
    w = rng.randint(-127, 128, (*taps, shape[3], n)).astype(np.int8)
    if case == 'saturated':
        x[:] = -128
        w[..., 0], w[..., 1] = 127, -127
    bias = rng.randint(-2 ** 14, 2 ** 14, n).astype(np.int32)
    ratio = (0.5 + rng.rand(n)).astype(np.float32) / np.float32(
        2 * 127 * 127 * taps[0] * taps[1])
    return x, w, bias, np_dyadic_multiplier(ratio)


@pytest.mark.parametrize('shape,n,taps,stride,pad,case', _CASES)
def test_walk_equals_the_reference_conv(shape, n, taps, stride, pad, case):
    x, w, bias, mult = _operands(shape, n, taps, case)
    padding = ((pad[0], pad[0]), (pad[1], pad[1]))
    want = np.asarray(_conv_i8(jnp.asarray(x), jnp.asarray(w),
                               (stride, stride), padding)) + bias
    want_q = np.asarray(jops.requant_int32(
        jnp.maximum(jnp.asarray(want), 0), jnp.asarray(mult), 8, True))
    b, oh, ow = want.shape[:3]

    xp, geo = tkc.conv_call(torch.from_numpy(x), taps, (stride, stride),
                            padding)
    assert geo['out_hw'] == (oh, ow)
    assert geo['pad'] == (pad if stride == 1 else (0, 0))
    wf = torch.from_numpy(tkc.flatten_conv_kernel(
        tkc.conv_call_kernel(w, (stride, stride))))
    if stride == 1:
        assert torch.equal(tkc.flatten_conv_kernel_torch(tkc.conv_call_kernel(
            torch.from_numpy(w), (1, 1))), wf)
    else:                        # the QAT layers rewrite on the device
        assert torch.equal(tkc.flatten_conv_kernel_torch(tkc.conv_call_kernel(
            torch.from_numpy(w), (2, 2))), wf)
    cin, ctaps = geo['cin'], geo['taps']
    prepared = tkc.prepare_conv_weights(wf, ctaps, cin, geo['pad'])
    row_taps = ctaps[1] if cin % 64 and geo['pad'][1] == 0 else 1
    assert prepared.row_taps == row_taps
    if shape[3] == 80:
        assert row_taps == 3                      # the stem's q_conv5

    bias_t, mult_t = torch.from_numpy(bias), torch.from_numpy(mult)
    # InceptionV3's widths need no padding on the card
    xc = xp.clone()
    step = tkm.sm90_operands(xc, prepared, (bias_t, mult_t), 1)
    assert step[0] is xc and step[1] is prepared and step[2][0] is bias_t
    call = dict(geo, taps=ctaps)
    slab = tkc.pad_conv_input(xp, geo['pad'], taps=ctaps,
                              out_hw=geo['out_hw'], cin=cin)
    walk = dict(taps=ctaps, out_hw=geo['out_hw'], cin=cin)
    acc = tkc.conv_acc_tiled_plain(slab, prepared, bias_t, **walk)
    q = tkc.conv_requant_tiled_plain(slab, prepared, bias_t, mult_t, lo=0,
                                     hi=127, **walk)
    np.testing.assert_array_equal(acc.reshape(b, oh, ow, n).numpy(), want)
    np.testing.assert_array_equal(q.reshape(b, oh, ow, n).numpy(), want_q)
    # the wrappers on the CPU: the border padded, then the same walk
    got = tkc.int8_conv_acc(xp, prepared, bias_t, **call)
    np.testing.assert_array_equal(got.reshape(b, oh, ow, n).numpy(), want)
    got = tkc.int8_conv_requant(xp, prepared, bias_t, mult_t, relu=True,
                                **call)
    np.testing.assert_array_equal(got.reshape(b, oh, ow, n).numpy(), want_q)
    if case == 'saturated':
        assert np.abs(want - bias).max() >= 127 * 128 * ctaps[0]
