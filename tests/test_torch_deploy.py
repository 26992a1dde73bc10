"""The port's deployment CLI (``hawq_tpu_torch.deploy``, on the CPU) against
``hawq_tpu.deploy`` on the same artifacts: the same stdout lines (top-k,
capture verdicts, accuracy meters; the port's own ``device=`` and
``host_preprocessing=`` lines aside), goldens that one package saves matched
by the other, byte-equal QONNX files, the reference-checkpoint replay, the
flags that stay TPU-only (exit 2), the production-route table, and
``--dump-hlo``'s exported program of each family.
"""

import json

import numpy as np
import pytest
import torch

from hawq_tpu import deploy as jdeploy
from hawq_tpu.configs.bit_config import get_bit_config as jget
from hawq_tpu.inference import synthetic as jsyn
from hawq_tpu.utils import checkpoint as jckpt

from hawq_tpu_torch import deploy as tdeploy
from hawq_tpu_torch.configs.bit_config import get_bit_config as tget
from hawq_tpu_torch.inference.engine_inception import build_inceptionv3_engine
from hawq_tpu_torch.inference.engine_mobilenet import \
    build_mobilenetv2_engine
from hawq_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

_PORT_ONLY = ('device=', 'host_preprocessing=')


def _lines(out):
    return [l for l in out.splitlines() if not l.startswith(_PORT_ONLY)]


def _run(capsys, main, args):
    rc = main(args)
    return rc, capsys.readouterr().out


def _both(capsys, args):
    """(rc, stdout lines) of hawq_tpu.deploy and of the port on the CPU."""
    jrc, jout = _run(capsys, jdeploy.main, args)
    trc, tout = _run(capsys, tdeploy.main, args + ['--device', 'cpu'])
    return (jrc, _lines(jout)), (trc, _lines(tout)), tout


@pytest.fixture(scope='module')
def frozen(tmp_path_factory):
    """A tiny18 uniform4 artifact saved by hawq_tpu, and a batch of images."""
    d = tmp_path_factory.mktemp('deploy')
    fm = jsyn.synthetic_frozen_resnet('tiny18', jget('tiny18', 'uniform4'),
                                      num_classes=10, seed=4)
    path = str(d / 'quantized_checkpoint.npz')
    jckpt.save_frozen(path, fm)
    img = str(d / 'img.npy')
    np.save(img, np.random.RandomState(5).rand(3, 32, 32, 3)
            .astype(np.float32))
    return path, img


@pytest.mark.parametrize('mode', ['float32', 'folded_float32', 'uint8'])
def test_classify_topk_equal(frozen, capsys, tmp_path, mode):
    path, img = frozen
    args = ['--frozen', path, '--image-size', '32', '--classify', img,
            '--topk', '3', '--input-mode', mode]
    j, t, tout = _both(capsys, args)
    assert j == t and j[0] == 0
    assert sum(l.startswith('image ') for l in t[1]) == 3
    # a ResNet's host fold is numpy only (utils.preproc)
    assert ('host_preprocessing=numpy' in tout) == (mode == 'folded_float32')


def test_export_onnx_byte_equal_and_export_reference(frozen, capsys,
                                                     tmp_path):
    path, _ = frozen
    base = ['--frozen', path, '--image-size', '32', '--batch', '2']
    jonnx, tonnx = str(tmp_path / 'j.onnx'), str(tmp_path / 't.onnx')
    tref = str(tmp_path / 't.pth.tar')
    assert jdeploy.main(base + ['--export-onnx', jonnx]) == 0
    assert tdeploy.main(base + ['--export-onnx', tonnx, '--export-reference',
                                tref, '--device', 'cpu']) == 0
    out = capsys.readouterr().out
    assert f'exported ONNX → {tonnx}' in out
    with open(jonnx, 'rb') as a, open(tonnx, 'rb') as b:
        assert a.read() == b.read()
    fm = tckpt.load_frozen(path)
    back = tckpt.load_reference_quantized(tref, 'tiny18',
                                          tget('tiny18', 'uniform4'))
    assert set(back.tensors) == set(fm.tensors)
    for k, v in fm.tensors.items():
        np.testing.assert_array_equal(back.tensors[k], v, err_msg=k)


@pytest.mark.parametrize('arch,scheme,size,batch', [
    ('tiny18', 'uniform4', '32', '2'), ('tiny18v2', 'uniform8', '32', '2'),
    ('resnet20_cifar', 'uniform8', None, '2'),
    ('mobilenetv2', 'uniform8', '32', '1')])
def test_synthetic_archs_equal(capsys, arch, scheme, size, batch):
    args = ['--arch', arch, '--scheme', scheme, '--batch', batch] + (
        ['--image-size', size] if size else [])
    j, t, _ = _both(capsys, args)
    assert j == t and j[0] == 0
    assert t[1][0].startswith(f'arch={arch} ')


def test_capture_goldens_cross_packages(frozen, capsys, tmp_path):
    path, _ = frozen
    node = 'stage1.unit1.quant_act_int32'
    base = ['--frozen', path, '--image-size', '32', '--batch', '2',
            '--capture', node]
    jcap, tcap = str(tmp_path / 'j.npy'), str(tmp_path / 't.npy')
    j, t, _ = _both(capsys, base + ['--save-capture', jcap])
    assert j[0] == t[0] == 0
    assert tdeploy.main(base + ['--save-capture', tcap, '--device',
                                'cpu']) == 0
    capsys.readouterr()
    np.testing.assert_array_equal(np.load(tcap), np.load(jcap))
    # each package matches the other's golden
    assert tdeploy.main(base + ['--compare', jcap, '--device', 'cpu']) == 0
    assert '100% matched!' in capsys.readouterr().out
    assert jdeploy.main(base + ['--compare', tcap]) == 0
    assert '100% matched!' in capsys.readouterr().out
    bad = np.load(jcap)
    bad.flat[0] += 1
    np.save(str(tmp_path / 'bad.npy'), bad)
    j, t, _ = _both(capsys, base + ['--compare', str(tmp_path / 'bad.npy')])
    assert j == t and j[0] == 1
    assert any('1 MISMATCHES' in l for l in t[1])


def test_accuracy_meters_equal(frozen, capsys, tmp_path):
    from PIL import Image
    rng = np.random.RandomState(0)
    for cls in ['a', 'b']:
        d = tmp_path / 'val' / cls
        d.mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.randint(0, 255, (40, 36, 3), dtype=np.uint8)
                            ).save(d / f'{i}.png')
    path, _ = frozen
    j, t, _ = _both(capsys, ['--frozen', path, '--image-size', '32',
                             '--batch', '4', '--accuracy',
                             str(tmp_path / 'val'), '--print-freq', '1'])
    assert j == t and j[0] == 0
    assert '[1] top1' in t[1][-3]
    assert json.loads(t[1][-1])['images'] == 6       # the tail batch too


def _replay_check(capsys, tmp_path, jfm, arch, port_engine):
    """The port's deploy replays the reference-format checkpoint of
    ``jfm`` (written by hawq_tpu) in reference mode on the CPU: rc 0, the
    arch line, and top-k equal to ``port_engine``'s on the same images."""
    path = str(tmp_path / 'quantized_checkpoint.pth.tar')
    jckpt.save_reference_quantized(path, jfm)
    size = 75 if arch == 'inceptionv3' else 32
    rc, out = _run(capsys, tdeploy.main, [
        '--import-reference', path, '--arch', arch, '--scheme', 'uniform8',
        '--image-size', str(size), '--batch', '2', '--requant-mode',
        'reference', '--topk', '3', '--device', 'cpu'])
    assert rc == 0
    assert f'arch={arch} ' in out
    x = np.random.RandomState(0).rand(2, size, size, 3).astype(np.float32)
    fm = tckpt.load_reference_quantized(path, arch, tget(arch, 'uniform8'))
    logits = port_engine(fm)(x).numpy()
    top = np.argsort(logits, axis=-1)[:, ::-1][:, :3]
    want = [f'image {i}: top-3 classes {r.tolist()}'
            for i, r in enumerate(top)]
    assert [l for l in out.splitlines() if l.startswith('image ')] == want
    return logits


def test_import_reference_replay_resnet(capsys, tmp_path):
    """tiny18: the port's reference-mode logits equal hawq_tpu's engine in
    reference mode (float64, under x64) on the same imported weights."""
    import jax
    from hawq_tpu.inference.engine import build_resnet_engine as jengine
    jfm = jsyn.synthetic_frozen_resnet('tiny18', jget('tiny18', 'uniform8'),
                                       num_classes=10, seed=3)
    from hawq_tpu_torch.inference.engine import build_resnet_engine
    got = _replay_check(capsys, tmp_path, jfm, 'tiny18',
                        lambda fm: build_resnet_engine(
                            fm, requant_mode='reference', device='cpu'))
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    fm = jckpt.load_reference_quantized(
        str(tmp_path / 'quantized_checkpoint.pth.tar'), 'tiny18',
        jget('tiny18', 'uniform8'))
    with jax.enable_x64(True):
        want = np.asarray(jengine(fm, requant_mode='reference')(x))
    np.testing.assert_array_equal(got, want)


def test_import_reference_replay_mobilenet(capsys, tmp_path):
    from hawq_tpu.models import mobilenetv2 as jm
    jfm = jsyn.synthetic_frozen_mobilenet(
        jget('mobilenetv2', 'uniform8'), num_classes=10, seed=5,
        stages=jm.TINY_MNV2_STAGES, init_ch=jm.TINY_MNV2_INIT_CH,
        final_ch=jm.TINY_MNV2_FINAL_CH)
    _replay_check(capsys, tmp_path, jfm, 'mobilenetv2',
                  lambda fm: build_mobilenetv2_engine(
                      fm, requant_mode='reference', device='cpu'))


def test_import_reference_replay_inception(capsys, tmp_path):
    jfm = jsyn.synthetic_frozen_inception(jget('inceptionv3', 'uniform8'),
                                          num_classes=10, width_div=16,
                                          seed=5)
    _replay_check(capsys, tmp_path, jfm, 'inceptionv3',
                  lambda fm: build_inceptionv3_engine(
                      fm, requant_mode='reference', input_hw=(75, 75),
                      device='cpu'))


@pytest.mark.parametrize('args,says', [
    (['--conv-mode', 'bf16'], 'TPU layout'),
    (['--conv-mode', 'f32'], 'TPU layout'),
    (['--arch', 'tiny18v2', '--requant-mode', 'reference'], 'v2'),
    (['--routing', 'benchmarks/routing_resnet50_uniform4_b8.json'],
     'readings of a TPU'),
    (['--input-mode', 'uint8', '--accuracy', '/nonexistent'], 'accuracy'),
    (['--arch', 'mobilenetv2', '--input-mode', 'folded_float32'],
     'not supported')])
def test_what_stays_tpu_only_exits_2(frozen, capsys, args, says):
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = [os.path.join(repo, a) if a.startswith('benchmarks/') else a
            for a in args]
    base = [] if '--arch' in args else ['--frozen', frozen[0]]
    assert tdeploy.main(base + ['--image-size', '32', '--batch', '2',
                                '--device', 'cpu'] + args) == 2
    assert says in capsys.readouterr().err


def _tiny_artifact(family, tmp_path):
    """(path, image size, an operator its program must name) of a tiny
    synthetic artifact of ``family``, saved by the port."""
    from hawq_tpu_torch.inference import synthetic as tsyn
    from hawq_tpu_torch.models import mobilenetv2 as tm
    if family == 'mobilenetv2':
        fm = tsyn.synthetic_frozen_mobilenet(
            tget('mobilenetv2', 'uniform8'), num_classes=10, seed=2,
            stages=tm.TINY_MNV2_STAGES, init_ch=tm.TINY_MNV2_INIT_CH,
            final_ch=tm.TINY_MNV2_FINAL_CH)
        size, op = 32, 'hawq.int8_dwconv_requant'
    else:
        fm = tsyn.synthetic_frozen_inception(tget('inceptionv3', 'uniform8'),
                                             num_classes=10, width_div=16,
                                             seed=2)
        size, op = 75, 'hawq.int_avgpool3x3_requant'
    path = str(tmp_path / f'{family}.npz')
    tckpt.save_frozen(path, fm)
    return path, size, op


@pytest.mark.parametrize('case', ['resnet', 'resnet_folded',
                                  'resnet_uint8', 'mobilenetv2',
                                  'inceptionv3'])
def test_dump_hlo_writes_the_exported_program(frozen, capsys, tmp_path, case):
    """``--dump-hlo`` writes the engine's exported graph, whose kernels are
    ``torch.ops.hawq`` nodes, and the run goes on to print the same top-k
    as without it."""
    if case.startswith('resnet'):
        path, size, op = frozen[0], 32, 'hawq.int4w_conv_requant'
        extra = {'resnet': [],
                 'resnet_folded': ['--input-mode', 'folded_float32'],
                 'resnet_uint8': ['--input-mode', 'uint8']}[case]
    else:
        (path, size, op), extra = _tiny_artifact(case, tmp_path), []
    base = ['--frozen', path, '--image-size', str(size), '--batch', '2',
            '--device', 'cpu', '--topk', '3'] + extra
    rc, plain = _run(capsys, tdeploy.main, base)
    assert rc == 0
    graph = str(tmp_path / 'program.txt')
    rc, out = _run(capsys, tdeploy.main, base + ['--dump-hlo', graph])
    assert rc == 0
    with open(graph) as f:
        text = f.read()
    assert f'dumped exported program ({len(text)} chars) → {graph}' in out
    assert f'torch.ops.{op}.default' in text
    assert 'torch.ops.hawq.int8_conv_acc.default' in text     # the init
    tops = [l for l in out.splitlines() if l.startswith('image ')]
    assert len(tops) == 2
    assert tops == [l for l in plain.splitlines() if l.startswith('image ')]


def test_routing_table_serves_equal_logits(frozen, capsys, tmp_path):
    """A table of this card's routes (every unit conv 'int8', where the
    default rule packs the 4-bit ones) classifies as the default route."""
    from hawq_tpu_torch.inference.autotune import routable_convs
    path, img = frozen
    fm = tckpt.load_frozen(path)
    table = str(tmp_path / 'routing.json')
    with open(table, 'w') as f:
        json.dump({k[0]: 'int8' for k in routable_convs(fm, 32)}, f)
    base = ['--frozen', path, '--image-size', '32', '--classify', img,
            '--device', 'cpu']
    assert tdeploy.main(base) == 0
    want = capsys.readouterr().out
    assert tdeploy.main(base + ['--routing', table, '--time']) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[:-1] == want.splitlines()
    t = json.loads(got[-1])
    assert t['batch'] == 3 and t['ms_per_batch'] > 0


def test_no_card_without_device_cpu(frozen, capsys):
    """The CLI runs on the card unless --device cpu: without one it fails
    and says so (here, where there is no card)."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device exists')
    assert tdeploy.main(['--frozen', frozen[0], '--image-size', '32']) == 2
    assert '--device cpu' in capsys.readouterr().err


def test_production_route_table(capsys):
    """The port's auto route (the card's readings, PERF.md "production
    routes"): float32 images for every family and batch, so ``--input-mode
    auto`` prints what ``float32`` prints."""
    assert tdeploy.PRODUCTION_ROUTE == ('float32', 'int8')
    base = ['--arch', 'tiny18', '--scheme', 'uniform8', '--image-size',
            '32', '--batch', '2', '--device', 'cpu']
    auto = _run(capsys, tdeploy.main, base)
    assert auto == _run(capsys, tdeploy.main,
                        base + ['--input-mode', 'float32'])
    assert auto[0] == 0 and 'image 1: top-5' in auto[1]
