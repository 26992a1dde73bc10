"""The integer engine as a saved ``torch.export`` program
(``hawq_tpu_torch.export.export``) against ``hawq_tpu``'s StableHLO export.

* Every kernel operator (``torch.ops.hawq.*``) passes
  ``torch.library.opcheck`` on small CPU inputs: the int8 and nibble-packed
  int4 matmuls and convs and the int8 matmul's residual forms (with the
  next unit's entry requant, with and without the carrier), on plain
  weights and on the Hopper core's handle, both forms of the folded pool,
  of D1 and of A1, and the standalone requant and its concat form.
* ``load_program(export_program(fm))`` gives logits bit-equal (tolerance 0)
  to the port's engine and to ``load_stablehlo(export_stablehlo(fm))`` on
  the same numpy images and weights (``frozen_from_numpy``), at tiny50
  uniform8 and uniform4, 32², batch 1 and 2.
* The program's ``hawq`` nodes, counted per operator, are the launches the
  bit config predicts (``chip_smoke.expected_launches``), and every true
  division divides by a tensor (``quant.ops.exact_div``), not a scalar.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hawq_tpu.configs.bit_config import get_bit_config as jget
from hawq_tpu.export.export import export_stablehlo, load_stablehlo
from hawq_tpu.inference import synthetic as jsyn

from hawq_tpu_torch.export.export import export_program, load_program
from hawq_tpu_torch.inference.engine import build_resnet_engine
from hawq_tpu_torch.inference.freeze import frozen_from_numpy
from hawq_tpu_torch.kernels import avgpool as ka
from hawq_tpu_torch.kernels import conv as kc
from hawq_tpu_torch.kernels import depthwise as kd
from hawq_tpu_torch.kernels import matmul as km
from hawq_tpu_torch.kernels import pool as kp
from hawq_tpu_torch.kernels import requant as kr

torch.set_num_threads(1)


def _i8(rng, shape, lo=-128, hi=128):
    return torch.tensor(rng.randint(lo, hi, shape).astype(np.int8))


def _mult(rng, n):
    return torch.tensor((rng.rand(n) * 1e-3 + 1e-4).astype(np.float32))


def _bias(rng, n):
    return torch.tensor(rng.randint(-2 ** 12, 2 ** 12, n).astype(np.int32))


def _matmul_args(name, prepared):
    rng = np.random.RandomState(0)
    int4, requant = name.startswith('int4w'), name.endswith('requant')
    x = _i8(rng, (5, 32))
    w = _i8(rng, (32, 16), -8, 8)
    if int4:
        w = torch.tensor(km.pack_int4(w.numpy()))
    cpad = 0
    if prepared:
        h = km.prepare_weights_int4(w) if int4 else km.prepare_weights(w)
        w, cpad = h.wt, h.cpad
    epilogue = (_mult(rng, 16), 0, 127) if requant else (None, 0, 0)
    return (x, w, cpad, _bias(rng, 16), *epilogue, -1, -1, 0)


def _residual_args(prepared):
    rng = np.random.RandomState(5)
    x, w = _i8(rng, (5, 32)), _i8(rng, (32, 16))
    cpad = 0
    if prepared:
        h = km.prepare_weights(w)
        w, cpad = h.wt, h.cpad
    identity = torch.tensor(rng.randint(-2 ** 20, 2 ** 20, (5, 16))
                            .astype(np.int32))
    return (x, w, cpad, _bias(rng, 16), identity, _mult(rng, 16),
            _mult(rng, 16), -1, 0)


def _residual_requant_args(prepared):
    """The residual form's arguments, the entry requant's one multiplier
    and its bits (4, unsigned: the ReLU'd carrier spread over 0..15)."""
    args = _residual_args(prepared)
    return args[:7] + (torch.tensor(np.float32(3e-5)), 4, False) + args[7:]


def _conv_args(name, prepared, pad):
    rng = np.random.RandomState(1)
    int4, requant = name.startswith('int4w'), name.endswith('requant')
    taps, out_hw, cin, n = (3, 3), (4, 5), 16, 8
    xp = _i8(rng, kc._slab_shape(2, taps, out_hw, cin, pad))
    w = _i8(rng, (9 * cin, n), -8, 8)
    if int4:
        w = torch.tensor(kc.pack_int4_conv(w.numpy(), 9))
    cpad, row_taps = 0, 1
    if prepared:
        h = kc.prepare_conv_weights(w, taps, cin, pad, int4)
        w, cpad, row_taps = h.wt, h.cpad, h.row_taps
    epilogue = (_mult(rng, n), -128, 127) if requant else (None, 0, 0)
    return (xp, w, cpad, row_taps, _bias(rng, n), *epilogue, list(taps),
            list(out_hw), cin, list(pad), -1, 0)


def _pool_args(name):
    rng = np.random.RandomState(2)
    if name == 'maxpool_folded':
        return (torch.tensor(rng.randint(-999, 999, (2, 3, 4, 16))
                             .astype(np.int32)),)
    acc = torch.tensor(rng.randint(-2 ** 20, 2 ** 20, (2, 3, 4, 16))
                       .astype(np.int32))
    return (acc, _mult(rng, 16), 16, True, True, 0)


def _dw_args(name):
    rng = np.random.RandomState(3)
    c = 8
    args = (_i8(rng, (2, 5, 6, c)), _i8(rng, (3, 3, 1, c)), _bias(rng, c))
    if name == 'int8_dwconv_acc':
        return args + (2, [])
    hi6 = torch.full((c,), 2 ** 12, dtype=torch.int32)
    return args + (hi6, _mult(rng, c), 1, -128.0, 127.0, [])


def _avg_args(name, in_front=False):
    rng = np.random.RandomState(4)
    x = torch.tensor(rng.randint(-2 ** 14, 2 ** 14, (2, 5, 4, 6))
                     .astype(np.int16))
    if name == 'int_avgpool3x3':
        return (x, [])
    in_mult = _mult(rng, 6) * 40 if in_front else None
    return (x, _mult(rng, 6), 8, False, in_mult, 12 if in_front else -1,
            True, [])


def _requant_args(name, per_channel):
    rng = np.random.RandomState(6)
    x = torch.tensor(rng.randint(-2 ** 20, 2 ** 20, (2, 3, 4, 16))
                     .astype(np.int32))
    m = _mult(rng, 16) if per_channel else torch.tensor(np.float32(7e-4))
    if name == 'requant_int32':
        return (x, m, 16, True, True, 1)
    y = torch.tensor(rng.randint(-2 ** 14, 2 ** 14, (2, 3, 4, 8))
                     .astype(np.int16))
    return ([x, y], [m, _mult(rng, 8) * 40], 8, True, 0)


_RESIDUALS = (km.RESIDUAL, km.RESIDUAL_REQUANT, km.RESIDUAL_REQUANT_ONLY)
_CASES = (
    [(km, n, (lambda n=n, p=p: _matmul_args(n, p)), f'{n}-{p}')
     for n in km.OPS if n not in _RESIDUALS for p in (False, True)]
    + [(km, km.RESIDUAL, (lambda p=p: _residual_args(p)),
        f'{km.RESIDUAL}-{p}') for p in (False, True)]
    + [(km, n, (lambda p=p: _residual_requant_args(p)), f'{n}-{p}')
       for n in _RESIDUALS[1:] for p in (False, True)]
    + [(kc, n, (lambda n=n, p=p, pad=pad: _conv_args(n, p, pad)),
        f'{n}-{p}-{pad}')
       for n in kc.OPS for p in (False, True) for pad in ((0, 0), (1, 1))]
    + [(kp, n, (lambda n=n: _pool_args(n)), n) for n in kp.OPS]
    + [(kd, n, (lambda n=n: _dw_args(n)), n) for n in kd.OPS]
    + [(ka, 'int_avgpool3x3_requant',
        (lambda f=f: _avg_args('int_avgpool3x3_requant', f)),
        f'int_avgpool3x3_requant-{f}') for f in (False, True)]
    + [(ka, 'int_avgpool3x3', (lambda: _avg_args('int_avgpool3x3')),
        'int_avgpool3x3')]
    + [(kr, n, (lambda n=n, pc=pc: _requant_args(n, pc)), f'{n}-{pc}')
       for n in kr.OPS for pc in (False, True)])


@pytest.mark.parametrize('mod,name,args', [c[:3] for c in _CASES],
                         ids=[c[3] for c in _CASES])
def test_operator_passes_opcheck(mod, name, args):
    op = mod.OPS[name]
    assert op.overload is getattr(torch.ops.hawq, name).default
    args = args()
    torch.library.opcheck(op.overload, args)
    # an eager call skips the dispatcher and gives the operator's value
    torch.testing.assert_close(op(*args), op.overload(*args), rtol=0,
                               atol=0)


def test_operator_on_meta_raises_and_wrapper_keeps_its_value():
    """A meta tensor has no kernel (the fake implementation serves only
    tracing), and a wrapper's value is its plain version's."""
    args = _matmul_args('int8_matmul_requant', False)
    with pytest.raises(ValueError, match='no kernel'):
        km.OPS['int8_matmul_requant'](args[0].to('meta'), *args[1:])
    x, w, _, bias, mult = args[:5]
    assert torch.equal(km.int8_matmul_requant(x, w, bias, mult, relu=True),
                       km.matmul_requant_plain(x, w, bias, mult, 0, 127))


@pytest.fixture(scope='module')
def models():
    """tiny50 uniform8 / uniform4 of hawq_tpu (seed 3) and their port
    twins."""
    out = {}
    for scheme in ('uniform8', 'uniform4'):
        jfm = jsyn.synthetic_frozen_resnet('tiny50', jget('tiny50', scheme),
                                           num_classes=10, seed=3)
        out[scheme] = jfm, frozen_from_numpy(
            jfm.arch, jfm.cfg.name, dict(jfm.cfg.table), jfm.tensors,
            jfm.num_classes)
    return out


@pytest.mark.parametrize('scheme', ['uniform8', 'uniform4'])
@pytest.mark.parametrize('batch', [1, 2])
def test_program_equals_engine_and_stablehlo(models, scheme, batch):
    import chip_smoke
    jfm, fm = models[scheme]
    blob = export_program(fm, batch_size=batch, image_size=32, device='cpu')
    program = load_program(blob, device='cpu' if batch == 2 else None)
    x = np.random.RandomState(batch).rand(batch, 32, 32, 3).astype(
        np.float32)
    got = program(torch.from_numpy(x))
    want = build_resnet_engine(fm, device='cpu')(x)
    assert got.dtype == torch.float32 and got.shape == (batch, 10)
    assert torch.equal(got, want)
    jax_logits = np.asarray(load_stablehlo(export_stablehlo(
        jfm, batch_size=batch, image_size=32))(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), jax_logits)

    nodes = [n for n in program.graph.nodes if n.op == 'call_function']
    ops = Counter(n.target.name().split('::')[1].split('.')[0]
                  for n in nodes if str(n.target).startswith('hawq.'))
    assert ops == chip_smoke.expected_launches(fm.arch, fm.cfg, 'float32')
    divs = [n for n in nodes if n.target is torch.ops.aten.div.Tensor]
    assert len(divs) == 2        # the input quantizer and the average pool
    assert all(isinstance(n.args[1], torch.fx.Node) for n in divs)
