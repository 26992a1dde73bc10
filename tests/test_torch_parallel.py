"""hawq_tpu_torch's parallel path on the CPU: process groups over ``gloo``,
the ('data', 'model') mesh, global-batch statistics, the data-parallel and
head-split train step, the Trainer over two ranks and the ServingEngine,
each held against one process (and ``hawq_tpu``) on the global batch.

Two ranks are two processes, started through the HAWQ_COORDINATOR /
HAWQ_NUM_PROCESSES / HAWQ_PROCESS_ID protocol; one run of ``_WORKER`` does
every two-rank case and pickles what it saw, and the tests compare.  Every
join is bounded (``_JOIN_S``), so a hang fails in place.

Tolerances, and why: ranges, integers (``q_int``), frozen artifacts,
logits of the split head and served logits are exact (min / max and order
statistics do not depend on the row order; the head's logits are integer
products gathered); the train step's loss within 1e-6 relative and its
parameters within rtol 1e-5 (a mean of two rank means against one mean,
gradients averaged after the backward), gradients within rtol 1e-4 with an
absolute floor of 1e-6 × the largest leaf value, as in
tests/test_torch_qat_train.py; BN batch moments summed over ranks within
rtol 1e-5 of ``torch.mean`` / ``torch.var`` over the concatenated batch
(another summation order), and what follows them (the unfolded step's
ranges and running statistics) within rtol 1e-5, its loss, gradients and
parameters as the folded step's; a QuantBnAct output within one
quantization level (a moment in the last bit may flip a rounding).
"""

import dataclasses
import functools
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hawq_tpu.configs.bit_config import get_bit_config as jget
from hawq_tpu.inference.engine import build_resnet_engine as jax_engine
from hawq_tpu.inference.synthetic import synthetic_frozen_resnet
from hawq_tpu.models.resnet import QResNet as JQResNet
from hawq_tpu.parallel.serving import ServingEngine as JServingEngine
from hawq_tpu.train import train as jtrain

from hawq_tpu_torch.configs.bit_config import get_bit_config as tget
from hawq_tpu_torch.inference.engine import build_resnet_engine
from hawq_tpu_torch.inference.freeze import frozen_from_numpy
from hawq_tpu_torch.models.resnet import (QResNet, qat_from_numpy,
                                          qat_to_numpy)
from hawq_tpu_torch.nn import layers as L
from hawq_tpu_torch.parallel import distributed
from hawq_tpu_torch.parallel.serving import DynamicBatcher, ServingEngine
from hawq_tpu_torch.train import train as ttrain
from hawq_tpu_torch.train import trainer as ttrainer
from hawq_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JOIN_S = 120
_LR = 1e-2
_ARCH, _SCHEME, _CLASSES, _GLOBAL_B = 'tiny18', 'uniform8', 10, 8


# ---------------------------------------------------------------------------
# the two-rank worker
# ---------------------------------------------------------------------------

_WORKER = r'''
import dataclasses, functools, os, pickle, shutil, sys
import numpy as np
import torch
torch.set_num_threads(1)
from hawq_tpu_torch.configs.bit_config import get_bit_config
from hawq_tpu_torch.inference.engine import build_resnet_engine
from hawq_tpu_torch.inference.freeze import frozen_from_numpy
from hawq_tpu_torch.models.resnet import QResNet, qat_from_numpy, qat_to_numpy
from hawq_tpu_torch.nn import layers as L
from hawq_tpu_torch.parallel import collectives as coll
from hawq_tpu_torch.parallel import distributed
from hawq_tpu_torch.parallel import mesh as pmesh
from hawq_tpu_torch.parallel.serving import ServingEngine
from hawq_tpu_torch.train import train as ttrain
from hawq_tpu_torch.train import trainer as ttrainer
from hawq_tpu_torch.utils import checkpoint as tckpt

tmp = sys.argv[1]
with open(os.path.join(tmp, 'in.pkl'), 'rb') as f:
    inp = pickle.load(f)
distributed.initialize(device='cpu')             # the env protocol
r, world = distributed.process_index(), distributed.process_count()
assert world == 2, world
out = {}
rows = slice(4 * r, 4 * (r + 1))                 # this data rank's rows

out['psum_equal'] = distributed.psum_metrics(
    {'top1': np.float32(0.25 + 0.5 * r), 'loss': np.float32(2.0 * (r + 1))})
out['psum_uneven'] = distributed.psum_metrics(
    {'top1': np.float32(1.0 - r)}, count=3 - 2 * r)

dmesh = pmesh.make_mesh(2, 1, 'cpu')
mmesh = pmesh.make_mesh(n_model=2, device='cpu')
out['meshes'] = [(pmesh.mesh_shape(m), pmesh.data_shard(m),
                  pmesh.data_group(m) is not None,
                  pmesh.model_group(m) is not None) for m in (dmesh, mmesh)]
out['fc_classes'] = pmesh.fc_tensor_sharding(mmesh, 10)
dgroup = pmesh.data_group(dmesh)

# rank 0's state over its data group; this rank's rows on its device
model = QResNet('tiny18', get_bit_config('tiny18', 'uniform8'), 10, seed=r)
pmesh.replicate_state(dmesh, model)
out['replicated'] = qat_to_numpy(model)
shard = distributed.global_batch_from_host_shards(
    dmesh, {'image': inp['batch']['image'][rows]})
out['shard'] = (tuple(shard['image'].shape), str(shard['image'].device))

# ranges over the data group: min / max, percentile, asymmetric percentile
ranges = []
for kw in inp['act_kws']:
    act = L.QuantAct(**kw)
    act.data_group = dgroup
    for x in inp['act_x']:
        act(torch.from_numpy(x[rows]), update_stats=True)
    ranges.append((float(act.x_min), float(act.x_max)))
out['ranges'] = ranges

# BN batch moments over the data group, with their gradients
torch.manual_seed(0)
cb = L.QuantConvBn(4, 6, (3, 3))
bna = L.QuantBnAct(4)
qat_from_numpy(cb, inp['convbn'])
qat_from_numpy(bna, inp['bnact'])
for m in (cb, bna):
    m.data_group = dgroup
xi = torch.from_numpy(inp['bn_x'][rows])
s = torch.tensor(np.float32(inp['bn_scale']))
y, _, _ = cb(xi * s, s, folded=False, update_stats=True)
z, _ = bna(xi * s, s, folded=False, update_stats=True)
((y * y).mean() + (z * z).mean()).backward()
grads = {}
for prefix, m in (('convbn', cb), ('bnact', bna)):
    for n, p in m.named_parameters():
        g = p.grad.clone()
        torch.distributed.all_reduce(g, group=dgroup)
        grads[f'{prefix}.{n}'] = (g / 2).numpy()
out['bn'] = dict(y=y.detach().numpy(), z=z.detach().numpy(), grads=grads,
                 convbn=qat_to_numpy(cb), bnact=qat_to_numpy(bna))

# the folded and unfolded train steps over the data group
image = torch.from_numpy(inp['batch']['image'][rows])
label = torch.from_numpy(inp['batch']['label'][rows])
steps = {}
for folded in (True, False):
    model = qat_from_numpy(QResNet('tiny18', get_bit_config('tiny18',
                                                            'uniform8'), 10),
                           inp['variables'])
    pmesh.distribute(model, dmesh)
    state = ttrain.TrainState.create(
        model, ttrain.sgd_with_step_decay(model, inp['lr']))
    step = ttrain.make_train_step(model, folded=folded, mesh=dmesh)
    coll.reset_collectives()
    with L.capture_q_int(model) as q:
        state, metrics = step(state, {'image': image, 'label': label})
    steps[folded] = dict(
        loss=float(metrics['loss']), accuracy=float(metrics['accuracy']),
        grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()},
        after=state.variables(), q={k: v.numpy() for k, v in q.items()},
        collectives=dict(coll.COLLECTIVES))
out['steps'] = steps

# the head split over the model group, per-channel and per-tensor scales
heads = {}
for per_channel in (True, False):
    cfg = get_bit_config('tiny18', 'uniform8')
    cfg = dataclasses.replace(cfg, settings=dataclasses.replace(
        cfg.settings, per_channel=per_channel))
    model = qat_from_numpy(QResNet('tiny18', cfg, 10), inp['variables'])
    pmesh.distribute(model, mmesh)
    logits = model(torch.from_numpy(inp['batch']['image']), folded=True)
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(inp['batch']['label'])).backward()
    heads[per_channel] = dict(
        logits=logits.detach().numpy(), classes=model.quant_output.classes,
        grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()})
out['heads'] = heads

# the Trainer over both meshes, then its frozen model served
trainers = {}
for mp in (1, 2):
    path = os.path.join(tmp, f'trainer_mp{mp}')
    cfg = ttrainer.TrainerConfig(**inp['trainer'], model_parallel=mp,
                                 device='cpu', save_path=path)
    tr = ttrainer.Trainer(cfg)
    tr.calibrate()
    tr.save_checkpoint(0, False)
    if r == 0:
        shutil.copytree(path, path + '_calibrated')
    loss = tr.train_epoch(0)
    acc = tr.evaluate()
    tr.save_checkpoint(1, False)
    torch.distributed.barrier()
    fm = tckpt.load_frozen(os.path.join(path, 'quantized_checkpoint.npz'))
    serving = ServingEngine(functools.partial(build_resnet_engine, fm),
                            batch_size=8, image_shape=(32, 32, 3),
                            device='cpu')
    direct = serving(inp['serve_images'][rows])
    b = serving.batcher(max_delay_ms=100.0)
    slots = [b.submit(im) for im in inp['serve_images'][rows]]
    answers = np.stack([s_.get(timeout=60) for s_ in slots])
    b.close()
    trainers[mp] = dict(mesh=pmesh.mesh_shape(tr.mesh), loss=loss, acc=acc,
                        direct=direct, answers=answers,
                        batcher_alive=b._collector.is_alive()
                        or b._completer.is_alive())
out['trainers'] = trainers

# the ServingEngine on hawq_tpu's frozen model: two replicas a rank
jfm = inp['serve_fm']
fm = frozen_from_numpy(jfm['arch'], jfm['name'], jfm['table'],
                       jfm['tensors'], jfm['num_classes'])
serving = ServingEngine(functools.partial(build_resnet_engine, fm),
                        n_devices=2, batch_size=8, image_shape=(32, 32, 3),
                        device='cpu')
b = serving.batcher(max_delay_ms=100.0)
slots = [b.submit(im) for im in inp['serve_images'][rows]]
out['served'] = dict(host_batch=serving.host_batch,
                     answers=np.stack([s_.get(timeout=60) for s_ in slots]))
b.close()

with open(os.path.join(tmp, f'out{r}.pkl'), 'wb') as f:
    pickle.dump(out, f)
torch.distributed.destroy_process_group()
print(f'rank {r} OK', flush=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _start_ranks(src: str, tmp: str, world: int = 2):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, HAWQ_COORDINATOR=f'127.0.0.1:{port}',
                   HAWQ_NUM_PROCESSES=str(world), HAWQ_PROCESS_ID=str(rank),
                   PYTHONPATH=REPO, OMP_NUM_THREADS='1')
        procs.append(subprocess.Popen(
            [sys.executable, '-c', src, tmp], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _join_ranks(procs):
    """Wait for every rank, each within _JOIN_S; a rank that hangs or fails
    fails the test (the others are killed)."""
    outs = []
    for rank, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=_JOIN_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            pytest.fail(f'rank {rank} hung past {_JOIN_S} s:\n{out[-3000:]}')
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f'rank {rank} OK' in out, \
            f'rank {rank} failed ({p.returncode}):\n{out[-4000:]}'


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _close(got, want, rtol, floor, msg=''):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=floor, err_msg=msg)


def _grads_close(got, want, rtol=1e-4, what=''):
    assert sorted(got) == sorted(want)
    floor = 1e-6 * max(float(np.abs(g).max()) for g in want.values())
    for name, w in want.items():
        _close(got[name], w, rtol, max(floor, 1e-6), f'{what} grad {name}')


# ---------------------------------------------------------------------------
# the inputs, the two ranks and the one-process references
# ---------------------------------------------------------------------------

_ACT_KWS = [dict(bits=8), dict(bits=8, percentile=1.0),
            dict(bits=4, quant_mode='asymmetric', percentile=2.0),
            dict(bits=8, momentum=-1.0)]


def _calibrated_variables():
    """hawq_tpu's tiny18 uniform8 after init and two calibration passes
    (numpy): the common starting state."""
    jmodel = JQResNet(arch=_ARCH, cfg=jget(_ARCH, _SCHEME),
                      num_classes=_CLASSES)
    x = jnp.asarray(np.random.RandomState(1).randn(4, 32, 32, 3).astype(
        np.float32))
    v = jax.jit(lambda k, x: jmodel.init(k, x, folded=True,
                                         update_stats=True))(
        jax.random.PRNGKey(0), x)
    calib = jtrain.make_calibration_step(jmodel)
    for _ in range(2):
        v = calib(v, x)
    return jmodel, jax.tree.map(np.asarray, dict(v))


def _one_process_modules(inp):
    """The statistics modules of the worker on the whole batch, alone."""
    ranges = []
    for kw in _ACT_KWS:
        act = L.QuantAct(**kw)
        for x in inp['act_x']:
            act(torch.from_numpy(x), update_stats=True)
        ranges.append((float(act.x_min), float(act.x_max)))
    torch.manual_seed(0)
    cb = qat_from_numpy(L.QuantConvBn(4, 6, (3, 3)), inp['convbn'])
    bna = qat_from_numpy(L.QuantBnAct(4), inp['bnact'])
    x = torch.from_numpy(inp['bn_x'])
    s = torch.tensor(np.float32(inp['bn_scale']))
    y, _, _ = cb(x * s, s, folded=False, update_stats=True)
    z, _ = bna(x * s, s, folded=False, update_stats=True)
    ((y * y).mean() + (z * z).mean()).backward()
    grads = {f'{prefix}.{n}': p.grad.numpy()
             for prefix, m in (('convbn', cb), ('bnact', bna))
             for n, p in m.named_parameters()}
    return ranges, dict(y=y.detach().numpy(), z=z.detach().numpy(),
                        grads=grads, convbn=qat_to_numpy(cb),
                        bnact=qat_to_numpy(bna))


def _one_process_step(variables, batch, folded):
    model = qat_from_numpy(QResNet(_ARCH, tget(_ARCH, _SCHEME), _CLASSES),
                           variables)
    state = ttrain.TrainState.create(
        model, ttrain.sgd_with_step_decay(model, _LR))
    with L.capture_q_int(model) as q:
        state, metrics = ttrain.make_train_step(model, folded=folded)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return dict(loss=float(metrics['loss']),
                accuracy=float(metrics['accuracy']),
                grads={n: p.grad.numpy().copy()
                       for n, p in model.named_parameters()},
                after=state.variables(),
                q={k: v.numpy() for k, v in q.items()})


def _trainer_kw():
    return dict(arch=_ARCH, scheme=_SCHEME, num_classes=_CLASSES,
                image_size=32, batch_size=_GLOBAL_B, steps_per_epoch=2,
                calib_batches=1, eval_batches=1, fix_bn_threshold=1, lr=1e-3)


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp('ranks'))
    jmodel, variables = _calibrated_variables()
    rng = np.random.RandomState(7)
    scale = np.float32(0.0625)
    jfm = synthetic_frozen_resnet('tiny50', jget('tiny50', 'uniform8'),
                                  num_classes=16, seed=5)
    inp = dict(
        variables=variables, lr=_LR,
        batch={'image': rng.randn(_GLOBAL_B, 32, 32, 3).astype(np.float32),
               'label': rng.randint(0, _CLASSES, (_GLOBAL_B,))},
        act_kws=_ACT_KWS,
        act_x=[rng.randn(8, 5, 5, 3).astype(np.float32) * k
               for k in (1.0, 3.0)],
        bn_x=rng.randint(-60, 60, (8, 6, 6, 4)).astype(np.float32),
        bn_scale=scale,
        convbn=qat_to_numpy(L.QuantConvBn(
            4, 6, (3, 3), generator=torch.Generator().manual_seed(3))),
        bnact={'params': {'gamma': rng.rand(4).astype(np.float32) + 0.5,
                          'beta': rng.randn(4).astype(np.float32)}},
        trainer=_trainer_kw(),
        serve_images=rng.rand(_GLOBAL_B, 32, 32, 3).astype(np.float32),
        serve_fm=dict(arch=jfm.arch, name=jfm.cfg.name,
                      table=dict(jfm.cfg.table), tensors=jfm.tensors,
                      num_classes=jfm.num_classes))
    with open(os.path.join(tmp, 'in.pkl'), 'wb') as f:
        pickle.dump(inp, f)
    procs = _start_ranks(_WORKER, tmp)
    try:
        # the references, while the ranks run
        ref = {'modules': _one_process_modules(inp),
               'steps': {folded: _one_process_step(variables, inp['batch'],
                                                   folded)
                         for folded in (True, False)}}
        jbatch = {k: jnp.asarray(v) for k, v in inp['batch'].items()}
        jstate = jtrain.TrainState.create(
            jax.tree.map(jnp.asarray, variables),
            jtrain.sgd_with_step_decay(_LR))
        jstate, jmetrics = jtrain.make_train_step(jmodel, folded=True)(
            jstate, jbatch)
        # ranges and integers of the step's forward, run eagerly
        _, mut = jmodel.apply(
            variables, jbatch['image'], folded=True, update_stats=True,
            mutable=['quant_stats', 'batch_stats', 'intermediates'])
        ref['jax'] = dict(
            loss=float(jmetrics['loss']),
            params=dict(_flat(jax.tree.map(np.asarray, jstate.params))),
            stats=dict(_flat(jax.tree.map(np.asarray, mut['quant_stats']))),
            q={'.'.join(p[:-1]): a[0] for p, a in _flat(jax.tree.map(
                np.asarray, mut['intermediates']))})
        ref['serve_fm'] = jfm
    finally:
        _join_ranks(procs)
    outs = []
    for rank in range(2):
        with open(os.path.join(tmp, f'out{rank}.pkl'), 'rb') as f:
            outs.append(pickle.load(f))
    return tmp, inp, outs, ref


# ---------------------------------------------------------------------------
# one process: no group
# ---------------------------------------------------------------------------

def test_initialize_is_a_no_op_without_the_environment(monkeypatch):
    for k in ('HAWQ_COORDINATOR', 'MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE',
              'RANK', 'LOCAL_RANK'):
        monkeypatch.delenv(k, raising=False)
    distributed.initialize(device='cpu')
    assert not torch.distributed.is_initialized()
    assert distributed.process_index() == 0
    assert distributed.process_count() == 1
    assert distributed.psum_metrics({'top1': np.float32(0.5)},
                                    count=3) == {'top1': 0.5}
    assert distributed.local_device('cpu') == torch.device('cpu')


def test_batcher_hooks_and_their_defaults():
    """The hooks carry each batch (to_device) and its logits (fetch); without
    them a batch goes to ``device`` as one tensor and comes back as numpy."""
    seen = []
    double = lambda x: x * 2

    def to_device(arr):
        seen.append(('to_device', arr.shape))
        return [torch.from_numpy(np.ascontiguousarray(arr))]

    def fetch(out):
        seen.append(('fetch', out[0].shape))
        return out[0].numpy()
    imgs = np.random.RandomState(0).rand(5, 2, 2, 3).astype(np.float32)
    for hooks in (dict(to_device=to_device, fetch=fetch), {}):
        fn = (lambda parts: [double(parts[0])]) if hooks else double
        b = DynamicBatcher(fn, 4, (2, 2, 3), max_delay_ms=20, device='cpu',
                           **hooks)
        try:
            got = np.stack([s.get(timeout=30)
                            for s in [b.submit(im) for im in imgs]])
        finally:
            b.close()
        assert not b._collector.is_alive() and not b._completer.is_alive()
        np.testing.assert_array_equal(got, imgs * 2)
    assert seen == [('to_device', (4, 2, 2, 3)), ('fetch', (4, 2, 2, 3))] * 2
    b = DynamicBatcher(double, 4, (2, 2, 3), device='cpu')
    b.close()
    x = b.to_device(imgs)
    assert isinstance(x, torch.Tensor) and x.device == torch.device('cpu')
    np.testing.assert_array_equal(b.fetch(x), imgs)


def test_serving_engine_one_process_equals_hawq_tpu_mesh():
    """Two replicas on the CPU, the rows split between them, against
    ``hawq_tpu``'s ServingEngine sharded over the 8-device virtual mesh:
    bit-equal logits, from ``infer`` and from the batcher; throughput
    positive."""
    jfm = synthetic_frozen_resnet('tiny18', jget('tiny18', 'uniform8'),
                                  num_classes=16, seed=3)
    fm = frozen_from_numpy(jfm.arch, jfm.cfg.name, dict(jfm.cfg.table),
                           jfm.tensors, jfm.num_classes)
    x = np.random.RandomState(1).rand(8, 32, 32, 3).astype(np.float32)
    jserving = JServingEngine(jax_engine(jfm), batch_size=8,
                              image_shape=(32, 32, 3))
    assert len(jserving.mesh.devices.reshape(-1)) == 8
    want = np.asarray(jserving.infer(jserving.to_device(x)))
    serving = ServingEngine(functools.partial(build_resnet_engine, fm),
                            n_devices=2, batch_size=8,
                            image_shape=(32, 32, 3), device='cpu')
    assert serving.host_batch == 8 and len(serving.replicas) == 2
    parts = serving.to_device(x)
    assert [tuple(p.shape) for p in parts] == [(4, 32, 32, 3)] * 2
    np.testing.assert_array_equal(serving.fetch(serving.infer(parts)), want)
    b = serving.batcher(max_delay_ms=50.0)
    try:
        got = np.stack([s.get(timeout=60) for s in [b.submit(im)
                                                    for im in x]])
    finally:
        b.close()
    np.testing.assert_array_equal(got, want)
    assert serving.throughput() > 0
    with pytest.raises(ValueError):
        ServingEngine(functools.partial(build_resnet_engine, fm), n_devices=3,
                      batch_size=8, device='cpu')


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

def test_psum_metrics_over_two_processes(two_ranks):
    _, _, outs, _ = two_ranks
    for out in outs:
        assert out['psum_equal']['top1'] == pytest.approx(0.5, rel=1e-6)
        assert out['psum_equal']['loss'] == pytest.approx(3.0, rel=1e-6)
        # uneven eval tails: 3 samples at 1.0, 1 at 0.0
        assert out['psum_uneven']['top1'] == pytest.approx(0.75, rel=1e-6)


def test_make_mesh_shapes(two_ranks):
    _, _, outs, _ = two_ranks
    for rank, out in enumerate(outs):
        assert out['meshes'] == [
            ({'data': 2, 'model': 1}, (rank, 2), True, False),
            ({'data': 1, 'model': 2}, (0, 1), False, True)]
        assert out['fc_classes'] == slice(5 * rank, 5 * (rank + 1))


def test_replicate_state_and_host_shards(two_ranks):
    """replicate_state gives every rank of the data group rank 0's
    parameters and buffers (the ranks started from other seeds);
    global_batch_from_host_shards puts each rank's rows on its device."""
    _, _, outs, _ = two_ranks
    model = lambda seed: QResNet(_ARCH, tget(_ARCH, _SCHEME), _CLASSES,
                                 seed=seed)
    want = qat_to_numpy(model(0))
    other = dict(_flat(qat_to_numpy(model(1))['params']))
    assert any(not np.array_equal(other[path], w)
               for path, w in _flat(want['params']))
    for out in outs:
        for coll in ('params', 'batch_stats', 'quant_stats'):
            got = dict(_flat(out['replicated'][coll]))
            for path, w in _flat(want[coll]):
                np.testing.assert_array_equal(got[path], w,
                                              err_msg=str(path))
    for out in outs:
        assert out['shard'] == ((4, 32, 32, 3), 'cpu')


def test_global_ranges_exact(two_ranks):
    """QuantAct ranges over two ranks' shards == one process over the
    concatenated batch, exactly: min / max, both percentile modes, the
    running min / max."""
    _, _, outs, ref = two_ranks
    want = ref['modules'][0]
    assert outs[0]['ranges'] == outs[1]['ranges'] == want


def test_global_bn_moments(two_ranks):
    _, _, outs, ref = two_ranks
    want = ref['modules'][1]
    for rank, out in enumerate(outs):
        got = out['bn']
        for k in ('convbn', 'bnact'):
            for path, w in _flat(want[k]['batch_stats']):
                g = dict(_flat(got[k]['batch_stats']))[path]
                _close(g, w, 1e-5, 1e-7, f'rank {rank} {k} {path}')
            for path, w in _flat(want[k]['quant_stats']):
                g = dict(_flat(got[k]['quant_stats']))[path]
                _close(g, w, 1e-5, 0, f'rank {rank} {k} {path}')
        rows = slice(4 * rank, 4 * (rank + 1))
        _close(got['y'], want['y'][rows], 1e-5, 1e-6, f'rank {rank} convbn')
        _close(got['z'], want['z'][rows], 0, 1.01 * float(
            np.abs(want['z']).max()) / 127, f'rank {rank} bnact')
        _grads_close(got['grads'], want['grads'], 1e-4, f'rank {rank}')


def test_folded_train_step_against_hawq_tpu(two_ranks):
    """Two data ranks, folded uniform8, against hawq_tpu's single-device
    step on the global batch: loss, ranges, integers, parameters."""
    _, _, outs, ref = two_ranks
    j = ref['jax']
    q = {}
    for rank, out in enumerate(outs):
        got = out['steps'][True]
        _close(got['loss'], j['loss'], 1e-6, 0, f'rank {rank} loss')
        stats = dict(_flat(got['after']['quant_stats']))
        assert sorted(stats) == sorted(j['stats'])
        for path, want in j['stats'].items():
            np.testing.assert_array_equal(stats[path], want,
                                          err_msg=str(path))
        params = dict(_flat(got['after']['params']))
        for path, want in j['params'].items():
            _close(params[path], want, 1e-5, 1e-7, f'param {path}')
        for k, v in got['q'].items():
            q.setdefault(k, []).append(v)
    assert sorted(q) == sorted(j['q']) and len(q) > 10
    for k, want in j['q'].items():
        np.testing.assert_array_equal(np.concatenate(q[k]), want, err_msg=k)


@pytest.mark.parametrize('folded', [True, False])
def test_train_step_against_one_process(two_ranks, folded):
    """Two data ranks against the port's own step on the global batch: the
    loss, gradients (averaged by DistributedDataParallel), parameters,
    ranges and integers; the unfolded step also the BN running statistics
    (batch moments summed over the ranks)."""
    _, _, outs, ref = two_ranks
    want = ref['steps'][folded]
    q = {}
    for rank, out in enumerate(outs):
        got = out['steps'][folded]
        _close(got['loss'], want['loss'], 1e-6, 0, f'rank {rank} loss')
        assert got['accuracy'] == want['accuracy']
        _grads_close(got['grads'], want['grads'], 1e-4, f'rank {rank}')
        for path, w in _flat(want['after']['params']):
            _close(dict(_flat(got['after']['params']))[path], w, 1e-5, 1e-7,
                   f'param {path}')
        for path, w in _flat(want['after']['batch_stats']):
            _close(dict(_flat(got['after']['batch_stats']))[path], w, 1e-5,
                   1e-7, f'batch_stats {path}')
        stats = dict(_flat(got['after']['quant_stats']))
        for path, w in _flat(want['after']['quant_stats']):
            if folded:
                np.testing.assert_array_equal(stats[path], w, str(path))
            else:       # downstream of the summed batch moments
                _close(stats[path], w, 1e-5, 0, str(path))
        for k, v in got['q'].items():
            q.setdefault(k, []).append(v)
        # the collectives of one step, counted apart from the kernels: a
        # range a quantizer, two moments a BN (and their gradients), the
        # gradient buckets, the metrics
        c = got['collectives']
        assert c['ddp_all_reduce'] >= 1 and c['all_reduce_metrics'] == 1
        assert c['all_reduce_minmax'] == len(want['q'])
        n_bn = 0 if folded else 2 * sum(
            isinstance(m, L.QuantConvBn) for m in QResNet(
                _ARCH, tget(_ARCH, _SCHEME), _CLASSES).modules())
        assert c.get('all_reduce_moments', 0) == n_bn
        assert c.get('all_reduce_moments_grad', 0) == n_bn
    if folded:
        assert sorted(q) == sorted(want['q'])
        for k, w in want['q'].items():
            np.testing.assert_array_equal(np.concatenate(q[k]), w, err_msg=k)


@pytest.mark.parametrize('per_channel', [True, False])
def test_head_split_over_two_ranks(two_ranks, per_channel):
    """(data=1, model=2): the head's classes split over the ranks of the
    model group, from hawq_tpu's variables carried across; logits bit-equal
    to the unsplit model's, gradients within rtol 1e-5 of its (each rank its
    own classes of the head's; the sums over the batch and the classes run
    in another order)."""
    _, inp, outs, _ = two_ranks
    cfg = tget(_ARCH, _SCHEME)
    cfg = dataclasses.replace(cfg, settings=dataclasses.replace(
        cfg.settings, per_channel=per_channel))
    model = qat_from_numpy(QResNet(_ARCH, cfg, _CLASSES), inp['variables'])
    logits = model(torch.from_numpy(inp['batch']['image']), folded=True)
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(inp['batch']['label'])).backward()
    want = {n: p.grad.numpy() for n, p in model.named_parameters()}
    for rank, out in enumerate(outs):
        got = out['heads'][per_channel]
        np.testing.assert_array_equal(got['logits'], logits.detach().numpy())
        classes = got['classes']
        assert classes == slice(5 * rank, 5 * (rank + 1))
        mine = dict(want, **{
            'quant_output.kernel': want['quant_output.kernel'][:, classes],
            'quant_output.bias': want['quant_output.bias'][classes]})
        _grads_close(got['grads'], mine, 1e-5, f'rank {rank}')


@pytest.mark.parametrize('mp', [1, 2])
def test_trainer_over_two_ranks(two_ranks, mp, tmp_path):
    """The JAX dry run's path over two processes: calibrate, one epoch,
    evaluate, checkpoints (rank 0, the head whole), the frozen model served
    by a ServingEngine on each rank.  Against one process on the global
    batch: the calibrated checkpoint and frozen artifact equal file for
    file, the trained ones within the step's tolerance (frozen integers
    exact), each rank's served rows equal to the one-process engine's."""
    tmp, inp, outs, _ = two_ranks
    cfg = ttrainer.TrainerConfig(**_trainer_kw(), model_parallel=mp,
                                 device='cpu', save_path=str(tmp_path))
    tr = ttrainer.Trainer(cfg)
    assert tr.mesh is None                      # one process: unsharded
    tr.calibrate()
    tr.save_checkpoint(0, False)
    calibrated = {f: dict(np.load(tmp_path / f)) for f in (
        'checkpoint.npz', 'quantized_checkpoint.npz')}
    loss = tr.train_epoch(0)
    acc = tr.evaluate()
    tr.save_checkpoint(1, False)
    path = os.path.join(tmp, f'trainer_mp{mp}')
    for f, want in calibrated.items():
        got = np.load(os.path.join(path + '_calibrated', f))
        assert sorted(got.files) == sorted(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    got = np.load(os.path.join(path, 'checkpoint.npz'))
    want = np.load(tmp_path / 'checkpoint.npz')
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        _close(got[k], want[k], 1e-5, 1e-6, k)
    fm = tckpt.load_frozen(os.path.join(path, 'quantized_checkpoint.npz'))
    wfm = tckpt.load_frozen(str(tmp_path / 'quantized_checkpoint.npz'))
    for k, v in wfm.tensors.items():
        np.testing.assert_array_equal(fm[k], v, err_msg=k)
    single = build_resnet_engine(fm, device='cpu')(
        inp['serve_images']).numpy()
    for rank, out in enumerate(outs):
        t = out['trainers'][mp]
        assert t['mesh'] == {'data': 2 // mp, 'model': mp}
        _close(t['loss'], loss, 1e-6, 0, 'epoch loss')
        assert t['acc'] == acc and not t['batcher_alive']
        rows = slice(4 * rank, 4 * (rank + 1))
        np.testing.assert_array_equal(t['direct'], single[rows])
        np.testing.assert_array_equal(t['answers'], single[rows])


def test_serving_two_ranks_equal_hawq_tpu(two_ranks):
    """Each rank's batcher (two replicas, two rows each) answers its rows of
    the global batch bit-equal to hawq_tpu's single-device engine."""
    _, inp, outs, ref = two_ranks
    want = np.asarray(jax_engine(ref['serve_fm'])(
        jnp.asarray(inp['serve_images'])))
    for rank, out in enumerate(outs):
        assert out['served']['host_batch'] == 4
        np.testing.assert_array_equal(out['served']['answers'],
                                      want[4 * rank:4 * (rank + 1)])
