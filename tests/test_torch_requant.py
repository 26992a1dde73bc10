"""The engines' standalone requant (``kernels/requant.py``,
csrc/requant.cu): its plain version equals ``quant.ops.requant_int32`` with
the ReLU in front, bit for bit, for every dtype pair, bit width, sign,
multiplier kind and .5 tie; the kernel's walk (vectors, tail, channel,
output row and offset) equals the plain version; the concat form equals
requant-then-``torch.cat``; every native requant site of a forward calls the
operator once and nothing else reaches ``quant.ops.requant_int32``.  The
``cuda`` cases hold the kernel to the plain version on the card.

Imports only torch, numpy, hawq_tpu_torch and ``chip_smoke``, so the card
cases run on a machine without JAX:

    python -m pytest tests/test_torch_requant.py -q --noconftest -m cuda
"""

import contextlib
import itertools
import os
import sys

import numpy as np
import pytest
import torch

from hawq_tpu_torch.configs.bit_config import get_bit_config
from hawq_tpu_torch.inference.synthetic import (synthetic_frozen_inception,
                                                synthetic_frozen_mobilenet,
                                                synthetic_frozen_resnet,
                                                synthetic_frozen_resnet_v2)
from hawq_tpu_torch.kernels import _build
from hawq_tpu_torch.kernels import requant as kr
from hawq_tpu_torch.quant import ops as qops

INTS = (torch.int8, torch.int16, torch.int32)
PAIRS = list(itertools.product(INTS, INTS))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _fits(bits, dtype):
    return bits <= torch.iinfo(dtype).bits


def _operands(rng, shape, in_dtype, bits, per_channel):
    """Values spread over the input dtype and beyond the output range, odd
    and multiple-of-4 integers that land on .5 under the multipliers 0.5 and
    2⁻³ (both signs), and dyadic multipliers sized so that the outputs
    cover the range, clip at both ends, and tie."""
    info = torch.iinfo(in_dtype)
    lo, hi = max(info.min, -2 ** 22), min(info.max, 2 ** 22)
    x = rng.randint(lo, hi + 1, shape, dtype=np.int64)
    flat = x.reshape(-1)
    flat[::7] = rng.randint(-60, 61, flat[::7].shape) * 2 + 1   # odd: ·0.5
    flat[1::11] = rng.randint(-30, 31, flat[1::11].shape) * 8 + 4   # ·2⁻³
    np.clip(x, info.min, info.max, out=x)
    flat[2::13] = info.max
    flat[3::13] = info.min
    c = shape[-1]
    span = float(hi - lo) / 2 ** bits
    if per_channel:
        m = qops.np_dyadic_multiplier(
            (rng.rand(c) * 4 / span + 1e-7).astype(np.float32))
        m[::3] = 0.5
        m[1::5] = 0.125
    else:
        m = np.float32(0.5 if bits > 8 else 0.125)
    return (torch.from_numpy(x).to(in_dtype),
            torch.tensor(np.asarray(m, np.float32)))


def _before(x, mult, bits, signed, relu, out_dtype):
    """What the engines computed before the kernel: the ReLU, then
    ``quant.ops.requant_int32``."""
    return qops.requant_int32(torch.clamp_min(x, 0) if relu else x, mult,
                              bits, signed, out_dtype)


_SHAPES = [(2, 5, 7, 48), (3, 33), (1, 3, 5, 17), (64,)]


@pytest.mark.parametrize('in_dtype,out_dtype', PAIRS)
@pytest.mark.parametrize('bits', [4, 8, 16])
def test_plain_equals_quant_ops(in_dtype, out_dtype, bits):
    """The wrapper on the CPU (the operator's plain version) == ReLU then
    ``quant.ops.requant_int32``, bit for bit: signed and unsigned, with and
    without the ReLU, scalar and per-channel multipliers, .5 ties; a bit
    width wider than the output dtype raises."""
    rng = np.random.RandomState(bits + 3 * INTS.index(in_dtype))
    for shape, signed, relu, pc in itertools.product(
            _SHAPES, (True, False), (True, False), (True, False)):
        x, m = _operands(rng, shape, in_dtype, bits, pc)
        kw = dict(out_bits=bits, signed=signed, relu=relu,
                  out_dtype=out_dtype)
        if not _fits(bits + (not signed), out_dtype):
            with pytest.raises(ValueError):
                kr.requant_int32(x, m, **kw)
            continue
        got = kr.requant_int32(x, m, **kw)
        want = _before(x, m, bits, signed, relu, out_dtype)
        assert got.dtype == out_dtype and got.shape == x.shape
        assert torch.equal(got, want), (shape, signed, relu, pc)


def test_ties_round_half_up():
    """.5 products round up on both signs: ±2.5 → 3, −2; ±0.5 → 1, 0."""
    x = torch.tensor([5, -5, 1, -1, 3, -3], dtype=torch.int32)
    got = kr.requant_int32(x, torch.tensor(0.5), out_bits=8, signed=True,
                           out_dtype=torch.int8)
    assert got.tolist() == [3, -2, 1, 0, 2, -1]


def _walk_cases():
    """(leading shape, the pieces' widths, dtypes, per channel, address
    offsets of the middle piece's input / output / multiplier in elements):
    the standalone form and slices of a concat, C on and off the vector, a
    ragged tail, pointers off 16 bytes.  Every piece takes the input dtype;
    the middle one takes the per-channel multiplier."""
    for (a, b), pc in itertools.product(PAIRS, (False, True)):
        yield (2, 3, 5), (32,), a, b, pc, (0, 0, 0)
        yield (3, 7), (9,), a, b, pc, (0, 0, 0)              # ragged C
        yield (2, 3, 4), (32, 32, 32), a, b, pc, (0, 0, 0)   # a slice
        yield (2, 3, 4), (8, 24, 24), a, b, pc, (0, 0, 0)
        yield (2, 2, 2), (32,), a, b, pc, (1, 0, 0)          # unaligned x
        yield (2, 2, 2), (16, 32, 16), a, b, pc, (0, 0, 1)   # and mult
        yield (5,), (3,), a, b, pc, (0, 0, 0)


@pytest.mark.parametrize('case', list(_walk_cases()))
def test_walk_equals_plain(case):
    """The kernel's walk (:func:`kernels.requant.rq_plan`'s vectors and
    tails, the pieces' steps end to end, each step's channel and row from
    its offset) writes the plain version's values into every element of
    the output: the vector form where every piece's pointers and C allow
    it, one element a step otherwise."""
    lead, widths, in_dtype, out_dtype, pc, shifts = case
    rng = np.random.RandomState(sum(lead) + sum(widths))
    mid = len(widths) // 2
    pieces, mults = [], []
    for i, c in enumerate(widths):
        x, m = _operands(rng, lead + (c,), in_dtype, 8, pc and i == mid)
        pieces.append(x)
        mults.append(m)
    lo, hi = qops.requant_clip_bounds(8, True)
    isize = pieces[0].element_size()
    osize = torch.tensor([], dtype=out_dtype).element_size()
    ld, v = sum(widths), 16 // min(isize, osize)
    records, vector = [], True
    for i, (x, c) in enumerate(zip(pieces, widths)):
        z = shifts if i == mid else (0, 0, 0)
        p = (z[0] * isize, (sum(widths[:i]) + z[1]) * osize, z[2] * 4)
        pci = pc and i == mid
        records.append((x.numel(), c, isize, pci) + p)
        vector = vector and not any(q % 16 for q in p[:2 + pci]) and (
            not (pci or ld != c) or (c % v == 0 and ld * osize % 16 == 0))
    plan = kr.rq_plan(records, ld, osize)
    n = [x.numel() for x in pieces]
    assert plan == (kr.RqPlan(v, tuple(k // v for k in n),
                              tuple(k % v for k in n)) if vector
                    else kr.RqPlan(1, tuple(n), (0,) * len(n)))
    sentinel = 77
    out = torch.full(lead + (ld,), sentinel, dtype=out_dtype)
    kr.requant_walk_plain(pieces, mults, out, lo, hi, plan)
    want = torch.cat([qops.requant_int32(x, m, 8, True, out_dtype)
                      for x, m in zip(pieces, mults)], dim=-1)
    assert torch.equal(out, want)


def _pieces(rng, lead, widths, dtypes, bits):
    pieces, mults = [], []
    for i, (c, dt) in enumerate(zip(widths, dtypes)):
        x, m = _operands(rng, lead + (c,), dt, bits, per_channel=i % 2 == 1)
        pieces.append(x)
        mults.append(m)
    return pieces, mults


_CONCATS = [((2, 5, 5), (64, 96, 96, 32), (torch.int16, torch.int16,
                                          torch.int16, torch.int8)),
            ((1, 3, 4), (3, 5, 7), (torch.int32, torch.int8, torch.int16)),
            ((4,), (48, 16), (torch.int32, torch.int32)),
            ((2, 2, 2), (17,), (torch.int16,))]


@pytest.mark.parametrize('lead,widths,dtypes', _CONCATS)
@pytest.mark.parametrize('bits,signed,out_dtype', [
    (16, True, torch.int16), (8, True, torch.int8), (8, False, torch.int32)])
def test_concat_equals_requant_then_cat(lead, widths, dtypes, bits, signed,
                                        out_dtype):
    """``requant_concat`` == each piece's requant with its own multiplier
    (scalar and per-channel, mixed input dtypes), then ``torch.cat``; and
    the same through the kernel's walk of one launch into one buffer."""
    rng = np.random.RandomState(sum(widths) + bits)
    pieces, mults = _pieces(rng, lead, widths, dtypes, bits)
    want = torch.cat([qops.requant_int32(p, m, bits, signed, out_dtype)
                      for p, m in zip(pieces, mults)], dim=-1)
    got = kr.requant_concat(pieces, mults, out_bits=bits, signed=signed,
                            out_dtype=out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)
    lo, hi = qops.requant_clip_bounds(bits, signed)
    out = torch.zeros_like(want)
    esize, offs = out.element_size(), np.cumsum([0] + list(widths[:-1]))
    plan = kr.rq_plan([(p.numel(), p.shape[-1], p.element_size(),
                        m.numel() != 1, 0, int(o) * esize, 0)
                       for p, m, o in zip(pieces, mults, offs)],
                      out.shape[-1], esize)
    kr.requant_walk_plain(pieces, mults, out, lo, hi, plan)
    assert torch.equal(out, want)


def test_wrappers_refuse_what_they_do_not_take():
    x = torch.zeros((2, 4), dtype=torch.int32)
    m = torch.tensor(0.5)
    with pytest.raises(ValueError):                  # 16 bits into int8
        kr.requant_int32(x, m, out_bits=16, signed=True)
    with pytest.raises(ValueError):
        kr.requant_int32(x, m, out_bits=8, signed=True,
                         out_dtype=torch.float32)
    with pytest.raises(ValueError):
        kr.requant_concat([x], [m, m], out_bits=8, signed=True)
    with pytest.raises(ValueError):
        kr.requant_concat([], [], out_bits=8, signed=True)
    with pytest.raises(ValueError):                  # more than one launch
        kr.requant_concat([x] * (kr.RQ_MAX_PIECES + 1),
                          [m] * (kr.RQ_MAX_PIECES + 1), out_bits=8,
                          signed=True)


# ---------------------------------------------------------------------------
# the engines: one operator call a native requant site
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _counting():
    """Counts of the two operators' calls, and of the calls that an engine
    module makes to ``quant.ops.requant_int32`` itself (a native requant
    that missed the kernel; the kernels' plain versions call it)."""
    counts = {'requant_int32': 0, 'requant_concat': 0, 'outside': 0}
    real_ops = dict(kr.OPS)
    real = qops.requant_int32

    def op(name):
        def call(*args):
            counts[name] += 1
            return real_ops[name](*args)
        return call

    def direct(*args, **kw):
        caller = sys._getframe(1).f_globals['__name__']
        if caller.startswith('hawq_tpu_torch.inference'):
            counts['outside'] += 1
        return real(*args, **kw)

    for name in real_ops:
        kr.OPS[name] = op(name)
    qops.requant_int32 = direct
    try:
        yield counts
    finally:
        kr.OPS.update(real_ops)
        qops.requant_int32 = real


def _family(name):
    """(engine builder on the CPU, images, predicted Launches counts)."""
    import chip_smoke
    from hawq_tpu_torch.inference.engine import build_resnet_engine
    from hawq_tpu_torch.inference.engine_inception import (
        build_inceptionv3_engine)
    from hawq_tpu_torch.inference.engine_mobilenet import (
        build_mobilenetv2_engine)
    from hawq_tpu_torch.inference.engine_v2 import build_resnet_v2_engine
    from hawq_tpu_torch.models import mobilenetv2 as tm
    rng = np.random.RandomState(4)
    if name == 'resnet50':
        fm = synthetic_frozen_resnet('tiny50', get_bit_config(
            'tiny50', 'uniform8'), num_classes=10, seed=1)
        x = rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
        return (lambda **kw: build_resnet_engine(fm, input_mode='uint8',
                                                 **kw), x,
                chip_smoke.expected_launches('tiny50', fm.cfg, 'uint8'))
    if name == 'inceptionv3':
        fm = synthetic_frozen_inception(get_bit_config(
            'inceptionv3', 'uniform8'), num_classes=10, width_div=16, seed=1)
        x = rng.randint(0, 256, (2, 75, 75, 3)).astype(np.uint8)
        return (lambda **kw: build_inceptionv3_engine(
            fm, input_mode='uint8', input_hw=(75, 75), **kw), x,
            chip_smoke.expected_inception_launches(fm, 'uint8').counts)
    if name == 'mobilenetv2':
        fm = synthetic_frozen_mobilenet(
            get_bit_config('mobilenetv2_w1', 'uniform8'), num_classes=10,
            seed=1, stages=tm.TINY_MNV2_STAGES, init_ch=tm.TINY_MNV2_INIT_CH,
            final_ch=tm.TINY_MNV2_FINAL_CH)
        x = rng.randn(2, 32, 32, 3).astype(np.float32)
        return (lambda **kw: build_mobilenetv2_engine(
            fm, input_hw=(32, 32), **kw), x,
            chip_smoke.expected_mobilenet_launches(fm, 'float32').counts)
    fm = synthetic_frozen_resnet_v2('tiny50v2', get_bit_config(
        'tiny50v2', 'uniform8'), num_classes=10, seed=1)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    return (lambda **kw: build_resnet_v2_engine(fm, **kw), x,
            chip_smoke.expected_v2_launches(fm).counts)


@pytest.mark.parametrize('name', ['resnet50', 'inceptionv3', 'mobilenetv2',
                                  'resnet50v2'])
def test_engine_calls_the_operator_once_a_site(name):
    """A forward of each family's engine calls ``requant_int32`` (and
    InceptionV3 ``requant_concat``) once a native requant site, as
    ``chip_smoke``'s launch predictions count them, and no native requant
    reaches ``quant.ops.requant_int32`` outside the operators."""
    build, x, want = _family(name)
    eng = build(device='cpu')
    with _counting() as counts:
        eng(x)
    assert counts['outside'] == 0, counts
    assert counts['requant_int32'] == want['requant_int32'] > 0
    assert counts['requant_concat'] == want.get('requant_concat', 0)


def test_full_depth_site_counts():
    """The predictions at full depth: ResNet-50's init, its FC input and
    its first unit's entry (the other 15 unit entries leave through the
    residual epilogue of the conv3 before them with the int32 carrier; all
    16 with the int16 one); InceptionV3's 33 branch inputs, 45
    accumulator-form convs and FC input (79), its 4 pair concats and 11
    unit concats (15)."""
    import chip_smoke
    cfg = get_bit_config('resnet50', 'uniform8')
    assert chip_smoke.expected_launches('resnet50', cfg, 'uint8')[
        'requant_int32'] == 3
    assert chip_smoke.expected_launches('resnet50', cfg, 'folded_float32')[
        'requant_int32'] == 2
    assert chip_smoke.expected_launches(
        'resnet50', cfg, 'uint8', residual_dtype=torch.int16)[
        'requant_int32'] == 18
    assert 'requant_int32' not in chip_smoke.expected_launches(
        'resnet50', cfg, 'float32', reference=True)
    fm = synthetic_frozen_inception(get_bit_config('inceptionv3',
                                                   'uniform8'),
                                    num_classes=10, width_div=16, seed=1)
    counts = chip_smoke.expected_inception_launches(fm, 'uint8').counts
    assert (counts['requant_int32'], counts['requant_concat']) == (79, 15)


_FRESH_LOAD = r"""
import sys
import torch
from hawq_tpu_torch.export.export import load_program
with open(sys.argv[1], 'rb') as f:
    program = load_program(f.read())
torch.save(program(torch.load(sys.argv[2])), sys.argv[3])
"""


@pytest.mark.parametrize('name', ['resnet50', 'inceptionv3'])
def test_saved_program_loads_in_a_fresh_process(name, tmp_path):
    """An engine's saved ``torch.export`` program, which calls the requant
    operators, loads and runs in a process that imports nothing but
    ``export.load_program``: its logits equal the engine's."""
    import io
    import subprocess
    from hawq_tpu_torch.export.export import export_engine
    build, x, _ = _family(name)
    eng = build(device='cpu')
    x = torch.from_numpy(x[:1])
    buf = io.BytesIO()
    torch.export.save(export_engine(eng, x), buf)
    paths = [tmp_path / n for n in ('program.pt2', 'x.pt', 'out.pt')]
    paths[0].write_bytes(buf.getvalue())
    torch.save(x, paths[1])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, '-c', _FRESH_LOAD, *map(str, paths)],
                   check=True, cwd=repo, timeout=600)
    assert torch.equal(torch.load(paths[2]), eng(x))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _unaligned(t):
    """``t``'s values one element into an allocation."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize('in_dtype,out_dtype', PAIRS)
def test_kernel_equals_plain(dev, in_dtype, out_dtype):
    """The kernel == the plain version bit for bit at bits 4 / 8 / 16,
    signed and unsigned, with and without the ReLU, scalar and per-channel
    multipliers, .5 ties: the vector form, a ragged tail, a ragged C and
    unaligned inputs and multipliers (the one-element form); one launch a
    call."""
    rng = np.random.RandomState(INTS.index(in_dtype) * 3
                                + INTS.index(out_dtype))
    for bits, shape, signed, relu, pc in itertools.product(
            (4, 8, 16), _SHAPES + [(8, 56, 56, 256), (3, 1001)],
            (True, False), (True, False), (True, False)):
        if (not _fits(bits + (not signed), out_dtype)
                or (shape[0] == 8 and bits != 8)):
            continue
        x, m = _operands(rng, shape, in_dtype, bits, pc)
        want = kr.requant_plain(x, m, bits, signed, relu, out_dtype)
        kw = dict(out_bits=bits, signed=signed, relu=relu,
                  out_dtype=out_dtype)
        xd, md = x.to(dev), m.to(dev)
        for a, b in ((xd, md), (_unaligned(xd), md), (xd, _unaligned(md))):
            _build.reset_launches()
            got = kr.requant_int32(a, b, **kw)
            torch.cuda.synchronize()
            assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
                'requant_int32': 1}
            assert torch.equal(got.cpu(), want), (bits, shape, signed, relu,
                                                  pc)


@pytest.mark.cuda
@pytest.mark.parametrize('lead,widths,dtypes', _CONCATS + [
    ((256, 8, 8), (320, 768, 768, 192), (torch.int16,) * 4),
    ((3, 5), (16, 48, 32, 16, 64, 32, 48, 16), INTS * 2 + INTS[:2]),
    ((3, 5), (16, 48, 5, 16, 64, 32, 48, 16), INTS * 2 + INTS[:2])])
def test_concat_kernel_equals_plain(dev, lead, widths, dtypes):
    """``requant_concat`` on the card == on the CPU: slices on and off 16
    bytes, mixed input dtypes, scalar and per-channel multipliers; one
    counted call."""
    rng = np.random.RandomState(sum(widths))
    for bits, signed, out_dtype in ((16, True, torch.int16),
                                    (8, True, torch.int8),
                                    (8, False, torch.int32)):
        pieces, mults = _pieces(rng, lead, widths, dtypes, bits)
        kw = dict(out_bits=bits, signed=signed, out_dtype=out_dtype)
        want = kr.requant_concat(pieces, mults, **kw)
        _build.reset_launches()
        got = kr.requant_concat([p.to(dev) for p in pieces],
                                [m.to(dev) for m in mults], **kw)
        torch.cuda.synchronize()
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
            'requant_concat': 1}
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['resnet50', 'inceptionv3', 'mobilenetv2',
                                  'resnet50v2'])
def test_engine_launches_once_a_site(dev, name):
    """Each family's engine on the card: logits equal the CPU engine's and
    ``LAUNCHES`` counts one requant launch a native site, as predicted."""
    build, x, want = _family(name)
    cpu = build(device='cpu')(x)
    eng = build(device=dev)
    _build.reset_launches()
    got = eng(torch.from_numpy(x).to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cpu)
    assert _build.LAUNCHES.get('requant_int32') == want['requant_int32']
    assert _build.LAUNCHES.get('requant_concat', 0) == want.get(
        'requant_concat', 0)
