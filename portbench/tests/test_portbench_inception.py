"""InceptionV3's family in the benchmark, on the CPU at the tiny cell's
sizes: the plain reference against the program's engine (logits and the
stem's and units' integers, uint8 and float32 input, int32 and int16 wide
containers), its bit rule against the program's registry, its layer counts
against the program's frozen model, the logits' spread over images and
the int4 control."""

from __future__ import annotations

import collections

import pytest
import torch

from portbench import inputs, program, weights
from portbench.reference import inception_v3 as ref
from portbench.reference import lower
from portbench.reference import numerics as nx
from portbench.tests import tiny
from portbench.work import inception_v3 as work

torch.set_num_threads(1)
SEED = 2 ** 33 + 11
CONFIG = tiny.CELLS['inceptionv3_w1_w8a8.batch_b256'][0]
FULL = tiny.load('inceptionv3_w1_w8a8.batch_b256')[0] | dict(
    image_size=299, num_classes=1000, width_div=1)
# the stem's output, then one unit of each kind: A, the grid reduction B,
# C, the grid reduction D, E
NODES = ('init',) + tuple(f'features.stage{i}.unit{j}.q_rescaling_activ'
                          for i, j in ((1, 1), (2, 1), (2, 3), (3, 1),
                                       (3, 3)))


def _images(mode, n=3, seed=SEED):
    make = inputs.uint8_images if mode == 'uint8' else inputs.float_images
    return torch.from_numpy(make(seed, n, CONFIG['image_size']))


@pytest.fixture(scope='module')
def tensors():
    return weights.generate(CONFIG, SEED)


def _engine(tensors, **kw):
    return program.engine(program.frozen(CONFIG, tensors), 'cpu', **kw)


@pytest.mark.parametrize('wide', ['int32', 'int16'])
@pytest.mark.parametrize('mode', ['uint8', 'float32'])
def test_reference_equals_program(tensors, mode, wide):
    """The reference's logits and its integers at the stem's output and at
    a unit of each kind equal the program's CPU engine's, bit for bit."""
    x = _images(mode)
    seen = {}
    want = ref.forward(CONFIG, tensors, x, mode,
                       emit=lambda name, v: seen.setdefault(name, v))
    kw = dict(input_mode=mode, wide_dtype=getattr(torch, wide))
    assert torch.equal(_engine(tensors, **kw)(x), want)
    assert len(seen) == 1 + 11
    for node in NODES:
        got = _engine(tensors, capture=node, **kw)(x)
        assert got.dtype == getattr(torch, wide), node   # 16-bit nodes
        assert torch.equal(got.permute(0, 3, 1, 2).to(torch.int64),
                           seen[node]), node


def test_uint8_equals_float32_normalized_on_the_host(tensors):
    """The engine's uint8 path equals its float32 path on the same pixels
    normalized by the host, u8/255, − mean, ÷ std in float32."""
    u8 = _images('uint8')
    host = nx.normalize_uint8(u8.permute(0, 3, 1, 2), inputs.MEAN,
                              inputs.STD).permute(0, 2, 3, 1).contiguous()
    assert host.dtype == torch.float32
    assert torch.equal(_engine(tensors, input_mode='uint8')(u8),
                       _engine(tensors)(host))


def test_bit_rule_is_the_published_table():
    """Every node of the program's inceptionv3 uniform8 table, the 95 convs
    and FC among them (at 8 bits, the weight bits), at the bits the rule
    gives: 257 nodes, 71 at 16 bits."""
    published = program.published_table(FULL)
    assert len(published) == 257
    assert sum(b == 16 for b in published.values()) == 71
    assert {k: ref.bits(FULL, k) for k in published} == published
    plan = weights.family_plan(FULL)
    keys = {f'{k}.weight_int': 0 for k, *_ in plan.convs}
    keys.update({f'{k}.act_scale': 0 for k in plan.acts})
    assert program.bit_table(FULL, keys) == published


@pytest.mark.parametrize('config', [CONFIG, FULL], ids=['w16', 'w1'])
def test_layers_are_the_frozen_models_weights(config):
    """``work.layers`` names each conv and the FC as the program's frozen
    model names its weights, with their kernels and widths; at the tiny
    size each conv's input and output sizes are those the reference's
    convs see."""
    from hawq_tpu_torch.configs.bit_config import get_bit_config
    from hawq_tpu_torch.inference.synthetic import synthetic_frozen_inception
    fm = synthetic_frozen_inception(
        get_bit_config('inceptionv3', 'uniform8'),
        num_classes=config['num_classes'], width_div=config['width_div'])
    layers = work.layers(config, 2)
    shapes = {k[:-len('.weight_int')]: v.shape
              for k, v in fm.tensors.items() if k.endswith('.weight_int')}
    assert len(layers) == len(shapes) == 95
    for l in layers:
        want = shapes[l.key]
        if l.key == ref.HEAD:
            assert (l.cin, l.cout) == tuple(want)
        else:
            assert (l.kh, l.kw, l.cin, l.cout) == tuple(want), l.key
    if config is FULL:
        # the paper's grids (35², 17², 8²) and ~5.7 GMACs an image
        assert [l.hw_out for l in layers if l.key.endswith(
            'unit1.branches.branch1.q_conv.q_convbn')] == [35]
        assert {l.hw_out for l in layers if '.stage3.unit3.' in l.key} == {8}
        assert 5.6e9 < sum(l.macs for l in layers) / 2 < 5.8e9
        return
    seen = []
    conv = nx.conv

    def recording(x, w, *args, **kw):
        y = conv(x, w, *args, **kw)
        seen.append((x.shape[2], y.shape[2], x.shape[3], y.shape[3]))
        return y
    tensors = weights.generate(config, SEED)
    mp = pytest.MonkeyPatch()
    mp.setattr(nx, 'conv', recording)
    try:
        ref.forward(config, tensors, _images('float32', 1))
    finally:
        mp.undo()
    convs = [l for l in layers if l.key != ref.HEAD]
    assert sorted(seen) == sorted((l.hw_in, l.hw_out, l.hw_in, l.hw_out)
                                  for l in convs)


def test_plan_grids_put_16_bit_nodes_on_wide_grids():
    """The weight generator's walk gives each node a scale, the 16-bit
    nodes their wide grid (T16 steps), and pairs every conv with the node
    that feeds it, as the program's graph does."""
    from hawq_tpu_torch.inference import engine_inception as tei
    plan = work.plan(CONFIG)
    fed = {key[:-len('.q_convbn')] if key != ref.HEAD else key: node
           for key, _, _, _, node in plan.convs}
    assert fed == dict(tei.conv_input_nodes(CONFIG['width_div']))
    kinds = collections.Counter(ref.bits(CONFIG, k) for k in plan.acts)
    assert kinds == {8: 162 - 71, 16: 71}


def test_logits_depend_on_the_image():
    """Every image gets logits of its own: each pair of images differs in
    nearly every one of the cell's 1000 logits, by many steps of the
    logits' grid."""
    config = dict(CONFIG, num_classes=1000)
    tensors = weights.generate(config, SEED)
    y = ref.forward(config, tensors, _images('uint8', 6), 'uint8')
    for i in range(6):
        for j in range(i):
            assert (y[i] != y[j]).float().mean() > 0.9
    assert float(y.std(0).mean()) > 1e-3 * float(y.abs().mean())


def test_control_is_not_correct(tensors):
    """The int4 control, in the program's place, reads a logit gap far
    above the limit 0 that the program's runs are held to; its 16-bit
    nodes keep their grids."""
    x = _images('uint8')
    c4, t4 = lower.int4(CONFIG, tensors)
    assert all(t4[k + '.act_scale'] == tensors[k + '.act_scale']
               for k in ref.wide_nodes())
    gap = float((ref.forward(c4, t4, x, 'uint8')
                 - ref.forward(CONFIG, tensors, x, 'uint8')).abs().max())
    assert gap > 0.01
