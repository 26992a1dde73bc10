"""End-to-end QAT trainer (port of hawq_tpu/train/trainer.py).

  build model (arch + scheme) → calibrate activation ranges → epoch loop
  { train (unfolded or folded BN per the fix-BN schedule) → eval with frozen
  ranges → save checkpoint + best copy + frozen integer artifact } → resume
  from either checkpoint flavor.

The fix-BN schedule is evaluated before every step (folded BN from step
``fix_bn_threshold`` on, also in the middle of an epoch).

The run is eager PyTorch, one process per device: the card by default,
``device='cpu'`` (``--device cpu``) on request.  Checkpoints are the
reference's npz + JSON files (utils/checkpoint.py), so either package
resumes the other's; the frozen artifact is the engine-ready FrozenModel.

Several processes (``torchrun --nproc-per-node=N``, or the HAWQ_COORDINATOR
/ HAWQ_NUM_PROCESSES / HAWQ_PROCESS_ID protocol of parallel/distributed.py)
train one model over a ``('data', 'model')`` mesh of N / model_parallel ×
model_parallel ranks: ``batch_size`` is the **global** batch, of which each
data rank takes its equal share of rows (where ``hawq_tpu``'s hosts each
yield ``batch_size`` rows); ranges and BN batch statistics are taken over
the global batch, gradients averaged over the data group, the ResNet head
split over the model group; evaluation is weighted over every rank; rank 0
alone logs to the file and writes checkpoints, the head gathered whole.

CLI: python -m hawq_tpu_torch.train.trainer --arch resnet50 --scheme uniform8 ...
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import shutil
import time
from typing import Iterator, Optional

import numpy as np
import torch

from hawq_tpu_torch.configs.bit_config import (BitConfig, QuantSettings,
                                               RESNET_UNITS, get_bit_config)
from hawq_tpu_torch.inference.engine_inception import freeze_inceptionv3
from hawq_tpu_torch.inference.engine_v2 import freeze_resnet_v2
from hawq_tpu_torch.inference.freeze import (FrozenModel, freeze_mobilenetv2,
                                             freeze_resnet)
from hawq_tpu_torch.models.inceptionv3 import QInceptionV3
from hawq_tpu_torch.models.mobilenetv2 import (QMobileNetV2,
                                               TINY_MNV2_FINAL_CH,
                                               TINY_MNV2_INIT_CH,
                                               TINY_MNV2_STAGES)
from hawq_tpu_torch.models.resnet import (FloatResNet, QResNet,
                                          qat_from_numpy, qat_to_numpy)
from hawq_tpu_torch.models.resnet_v2 import QResNetV2
from hawq_tpu_torch.parallel import distributed
from hawq_tpu_torch.parallel import mesh as pmesh
from hawq_tpu_torch.train import data as data_lib
from hawq_tpu_torch.train.train import (TrainState, make_train_step,
                                        make_eval_step,
                                        make_calibration_step, shard_tree,
                                        sgd_with_step_decay)
from hawq_tpu_torch.utils import checkpoint as ckpt


@dataclasses.dataclass
class TrainerConfig:
    arch: str = 'resnet50'
    scheme: str = 'uniform8'
    num_classes: int = 1000
    image_size: int = 224
    batch_size: int = 128
    epochs: int = 1
    lr: float = 1e-4
    momentum: float = 0.9
    weight_decay: float = 1e-4
    lr_decay_epochs: int = 30        # ×0.1 every N epochs
    fix_bn: bool = False             # start folded
    fix_bn_threshold: Optional[int] = None   # steps until forced folded
    calib_batches: int = 8
    distill_alpha: Optional[float] = None
    temperature: float = 6.0
    teacher_checkpoint: Optional[str] = None   # float checkpoint (npz) for KD
    teacher_arch: str = 'resnet101'            # KD teacher
    data_dir: Optional[str] = None   # None → synthetic data
    dataset: str = 'imagenet'        # 'imagenet' (ImageFolder) | 'cifar10'
    data_percentage: float = 1.0
    save_path: str = '/tmp/hawq_tpu_run'
    resume: Optional[str] = None
    resume_quantize: bool = False
    steps_per_epoch: Optional[int] = None    # cap (synthetic data)
    eval_batches: Optional[int] = None
    use_mesh: bool = True            # data-parallel over all processes
    model_parallel: int = 1          # tensor-shard the classifier head
    evaluate_times: int = 0          # mid-epoch evals per epoch
    print_freq: int = 0              # per-step log interval
    evaluate: bool = False           # eval-only, no training
    seed: int = 0                    # init/data seed
    grad_precision: Optional[str] = None   # backward convs: None = float32
                                     # without TF32; 'bfloat16'
    residual_store_dtype: Optional[str] = None   # 'bfloat16': narrow conv
                                     # backward residuals + bf16 gradient
                                     # convs (value-exact storage)
    workers: int = 4                 # loader threads
    start_epoch: int = 0             # epoch offset
    # QuantSettings overrides; None keeps the scheme's stored settings
    bias_bit: Optional[int] = None
    channel_wise: Optional[int] = None           # 0|1
    act_percentile: Optional[float] = None
    weight_percentile: Optional[float] = None
    act_range_momentum: Optional[float] = None
    fixed_point_quantization: bool = False
    device: str = 'cuda'             # 'cuda' | 'cuda:N' | 'cpu'


def _apply_quant_overrides(cfg: TrainerConfig, bit_cfg: BitConfig
                           ) -> BitConfig:
    """Fold the CLI quant flags into the scheme's QuantSettings."""
    repl = {}
    if cfg.bias_bit is not None:
        repl['bias_bit'] = int(cfg.bias_bit)
    if cfg.channel_wise is not None:
        repl['per_channel'] = bool(cfg.channel_wise)
    if cfg.act_percentile is not None:
        repl['act_percentile'] = float(cfg.act_percentile)
    if cfg.weight_percentile is not None:
        repl['weight_percentile'] = float(cfg.weight_percentile)
    if cfg.act_range_momentum is not None:
        repl['act_range_momentum'] = float(cfg.act_range_momentum)
    if cfg.fixed_point_quantization:
        repl['fixed_point_quantization'] = True
    if not repl:
        return bit_cfg
    return dataclasses.replace(
        bit_cfg, settings=dataclasses.replace(bit_cfg.settings, **repl))


def build_model(cfg: TrainerConfig):
    """→ (model on the CPU, its BitConfig): ResNet v1 and v2, MobileNetV2
    and InceptionV3.  The test-size variants ``tiny_mnv2`` and
    ``tiny_inceptionv3`` (width_div 16) take the uniform 8-bit table
    whatever the scheme, as in the reference."""
    if cfg.arch in ('tiny_mnv2', 'tiny_inceptionv3'):
        bit_cfg = _apply_quant_overrides(cfg, BitConfig(
            name=f'{cfg.arch}_{cfg.scheme}', table={},
            settings=QuantSettings()))
        if cfg.arch == 'tiny_inceptionv3':
            return QInceptionV3(bit_cfg, cfg.num_classes, width_div=16,
                                seed=cfg.seed), bit_cfg
        return QMobileNetV2(bit_cfg, cfg.num_classes, TINY_MNV2_STAGES,
                            TINY_MNV2_INIT_CH, TINY_MNV2_FINAL_CH,
                            seed=cfg.seed), bit_cfg
    v2 = cfg.arch.endswith('v2') and cfg.arch[:-2] in RESNET_UNITS
    if not (v2 or cfg.arch in RESNET_UNITS
            or cfg.arch in ('mobilenetv2_w1', 'inceptionv3')):
        raise ValueError(f'unknown arch {cfg.arch}')
    bit_cfg = _apply_quant_overrides(cfg, get_bit_config(cfg.arch,
                                                         cfg.scheme))
    if cfg.arch == 'inceptionv3':
        return QInceptionV3(bit_cfg, cfg.num_classes, seed=cfg.seed), bit_cfg
    if cfg.arch == 'mobilenetv2_w1':
        return QMobileNetV2(bit_cfg, cfg.num_classes, seed=cfg.seed), bit_cfg
    family = QResNetV2 if v2 else QResNet
    return family(cfg.arch, bit_cfg, cfg.num_classes, seed=cfg.seed), bit_cfg


def freeze_model(model, variables, cfg: TrainerConfig,
                 bit_cfg: BitConfig) -> FrozenModel:
    """The frozen integer artifact of a trained model, through its family's
    freezer."""
    if isinstance(model, QMobileNetV2):
        return freeze_mobilenetv2(variables, bit_cfg, model.stages,
                                  cfg.num_classes)
    if isinstance(model, QInceptionV3):
        return freeze_inceptionv3(variables, bit_cfg, cfg.num_classes,
                                  model.width_div)
    if isinstance(model, QResNetV2):
        return freeze_resnet_v2(variables, cfg.arch, bit_cfg,
                                cfg.num_classes)
    return freeze_resnet(variables, cfg.arch, bit_cfg, cfg.num_classes)


def _batches(cfg: TrainerConfig, train: bool, epoch: int,
             shard=(0, 1)) -> Iterator[dict]:
    """The batches of an epoch; ``shard`` = (index, count): this rank's
    rows, the index-th of count equal shares of each global batch."""
    index, count = shard
    rows = cfg.batch_size // count
    if cfg.data_dir is None:
        n = cfg.steps_per_epoch or 10
        for batch in data_lib.synthetic_batches(
                cfg.batch_size, cfg.image_size, cfg.num_classes, n,
                seed=epoch if train else 10_000):
            yield {k: v[index * rows:(index + 1) * rows]
                   for k, v in batch.items()}
        return
    if cfg.dataset == 'cifar10':
        yield from data_lib.cifar10_batches(
            cfg.data_dir, rows, train=train, seed=epoch,
            data_percentage=cfg.data_percentage, process_index=index,
            process_count=count)
        return
    split = 'train' if train else 'val'
    loader = data_lib.ImageFolderLoader(
        os.path.join(cfg.data_dir, split), rows, train=train,
        image_size=cfg.image_size, data_percentage=cfg.data_percentage,
        num_workers=cfg.workers, seed=cfg.seed, process_index=index,
        process_count=count)
    yield from loader.epoch(epoch)


class Trainer:
    def __init__(self, cfg: TrainerConfig):
        # the process group first (a no-op for one process): the rank
        # decides the device, the log and the mesh
        distributed.initialize(device=cfg.device)
        self.cfg = cfg
        self.device = distributed.local_device(cfg.device)
        self.rank = distributed.process_index()
        world = distributed.process_count()
        os.makedirs(cfg.save_path, exist_ok=True)
        handlers = [logging.StreamHandler()]
        if self.rank == 0:
            handlers.append(logging.FileHandler(
                os.path.join(cfg.save_path, 'log.log')))
        logging.basicConfig(
            level=logging.INFO if self.rank == 0 else logging.WARNING,
            handlers=handlers, format='%(asctime)s %(message)s', force=True)
        self.log = logging.getLogger('hawq_tpu_torch')
        self.model, self.bit_cfg = build_model(cfg)
        self.model.to(self.device)
        self.best_acc = 0.0
        self.start_epoch = cfg.start_epoch
        self._restored_quant_stats = False

        # the mesh over every process: batch rows over 'data', the ResNet
        # head's classes over 'model' (one process trains unsharded)
        self.mesh = None
        if cfg.use_mesh and world > 1 and cfg.batch_size % world == 0:
            if world % cfg.model_parallel:
                raise ValueError(f'model_parallel {cfg.model_parallel} does '
                                 f'not divide the {world} processes')
            self.mesh = pmesh.make_mesh(world // cfg.model_parallel,
                                        cfg.model_parallel, self.device)
            self.log.info('mesh: %s over %d processes (backend %s)',
                          pmesh.mesh_shape(self.mesh), world,
                          torch.distributed.get_backend())
        elif cfg.use_mesh and world > 1:
            self.log.warning('batch_size %d not divisible by %d processes — '
                             'each trains alone', cfg.batch_size, world)
        self.shard = pmesh.data_shard(self.mesh)
        pmesh.distribute(self.model, self.mesh)

        steps_per_epoch = cfg.steps_per_epoch or 1000
        tx = sgd_with_step_decay(
            self.model, cfg.lr, cfg.momentum, cfg.weight_decay,
            decay_every_steps=cfg.lr_decay_epochs * steps_per_epoch)
        self.state = TrainState.create(self.model, tx)

        if cfg.resume:
            self._resume(cfg.resume, cfg.resume_quantize)
            if self.mesh is not None:
                pmesh.replicate_state(self.mesh, self.model)

        # KD teacher: a float model applied per batch to produce soft targets
        self.teacher = None
        if cfg.distill_alpha is not None:
            self.teacher = FloatResNet(cfg.teacher_arch, cfg.num_classes,
                                       seed=1)
            if cfg.teacher_checkpoint:
                tvars, _ = ckpt.load_train_checkpoint(cfg.teacher_checkpoint)
                qat_from_numpy(self.teacher, tvars)
            else:
                self.log.warning(
                    'KD enabled without --teacher-checkpoint: the teacher is '
                    'randomly initialized and distillation will distill '
                    'noise — pass a trained float checkpoint for real runs')
            self.teacher.to(self.device)

    def _device_batch(self, batch, with_teacher: bool = False):
        """This rank's numpy rows → tensors on the trainer's device."""
        host = {'image': np.asarray(batch['image'], np.float32)}
        if 'label' in batch:
            host['label'] = np.asarray(batch['label'], np.int64)
        out = dict(distributed.global_batch_from_host_shards(
            self.mesh, host, self.device))
        if with_teacher and self.teacher is not None:
            with torch.no_grad():
                out['teacher_logits'] = self.teacher(out['image'])
        return out

    # -- checkpointing ------------------------------------------------------
    def _ckpt_path(self, name):
        return os.path.join(self.cfg.save_path, name)

    def save_checkpoint(self, epoch: int, is_best: bool):
        # every rank gathers (a split head is whole in both); rank 0 writes
        variables = self.state.variables()
        opt_leaves = self.state.opt_leaves()
        if self.rank != 0:
            return
        meta = {'epoch': epoch, 'arch': self.cfg.arch,
                'scheme': self.cfg.scheme, 'best_acc': self.best_acc,
                'step': int(self.state.step)}
        ckpt.save_train_checkpoint(self._ckpt_path('checkpoint.npz'),
                                   variables, meta, opt_leaves=opt_leaves)
        if is_best:
            shutil.copy(self._ckpt_path('checkpoint.npz'),
                        self._ckpt_path('model_best.npz'))
            shutil.copy(self._ckpt_path('checkpoint.npz.meta.json'),
                        self._ckpt_path('model_best.npz.meta.json'))
        # frozen integer artifact: the deployment hand-off
        fm = freeze_model(self.model, variables, self.cfg, self.bit_cfg)
        ckpt.save_frozen(self._ckpt_path('quantized_checkpoint.npz'), fm)

    def _resume(self, path: str, quantized: bool):
        """Two flavors:
        ``resume``: map the checkpoint's *weights + BN statistics* onto the
          model; activation ranges stay fresh and are recalibrated.
        ``resume_quantize``: quantized-training continuation: weights AND
          quantization state (ranges, BN stats) restore.
        Both restore epoch/best/step/optimizer when present; every rank
        loads, a split head its own classes."""
        variables, meta, opt_leaves = ckpt.load_train_checkpoint(
            path, return_opt=True)
        self._restored_quant_stats = quantized and 'quant_stats' in variables
        if quantized and not self._restored_quant_stats:
            self.log.warning(
                '--resume-quantize on a checkpoint without quantization '
                'state (%s) — activation ranges stay fresh and will be '
                'calibrated', path)
        merged = {k: variables[k] for k in ('params', 'batch_stats')
                  if k in variables}
        if self._restored_quant_stats:
            merged['quant_stats'] = variables['quant_stats']
        if 'params' in merged:
            merged['params'] = shard_tree(self.model, merged['params'])
        else:
            merged['params'] = qat_to_numpy(self.model)['params']
        qat_from_numpy(self.model, merged)
        if opt_leaves and not self.state.load_opt_leaves(opt_leaves):
            self.log.warning(
                'checkpoint optimizer state does not match the current '
                'optimizer (%d leaves) — reinitialized', len(opt_leaves))
        if meta:
            self.start_epoch = int(meta.get('epoch', 0))
            self.best_acc = float(meta.get('best_acc', 0.0))
            if 'step' in meta:
                self.state.step = int(meta['step'])
        self.log.info('resumed from %s (%s, epoch %d, best %.2f)', path,
                      'quantized' if quantized else 'float',
                      self.start_epoch, self.best_acc)

    # -- phases -------------------------------------------------------------
    def calibrate(self):
        calib = make_calibration_step(self.model, folded=True)
        for i, batch in enumerate(_batches(self.cfg, True, 0, self.shard)):
            if i >= self.cfg.calib_batches:
                break
            calib(self._device_batch({'image': batch['image']})['image'])
        self.log.info('calibrated on %d batches', self.cfg.calib_batches)

    def train_epoch(self, epoch: int):
        cfg = self.cfg
        steps = {}

        def step_fn(folded: bool):
            if folded not in steps:
                steps[folded] = make_train_step(
                    self.model, folded=folded,
                    distill_alpha=cfg.distill_alpha,
                    temperature=cfg.temperature, rng_seed=cfg.seed,
                    matmul_precision=cfg.grad_precision,
                    residual_store_dtype=cfg.residual_store_dtype,
                    mesh=self.mesh)
            return steps[folded]

        # mid-epoch evaluation
        eval_every = None
        if cfg.evaluate_times > 0 and cfg.steps_per_epoch:
            eval_every = max(cfg.steps_per_epoch // cfg.evaluate_times, 1)
        t0 = time.time()
        n, loss_sum, acc_sum, folded = 0, 0.0, 0.0, cfg.fix_bn
        for i, batch in enumerate(_batches(cfg, True, epoch, self.shard)):
            if cfg.steps_per_epoch and i >= cfg.steps_per_epoch:
                break
            # the fix-BN schedule, owned by the trainer: folded BN from
            # step fix_bn_threshold on
            folded = cfg.fix_bn or (
                cfg.fix_bn_threshold is not None
                and self.state.step >= cfg.fix_bn_threshold)
            batch = self._device_batch(batch, with_teacher=True)
            self.state, metrics = step_fn(folded)(self.state, batch)
            loss_sum += float(metrics['loss'])
            acc_sum += float(metrics['accuracy'])
            n += 1
            if cfg.print_freq and n % cfg.print_freq == 0:
                dt = time.time() - t0
                self.log.info(
                    'epoch %d [%d/%s] loss %.4f (%.4f) acc %.4f '
                    '(%.1f img/s)', epoch, n, cfg.steps_per_epoch or '?',
                    float(metrics['loss']), loss_sum / n, acc_sum / n,
                    n * cfg.batch_size / max(dt, 1e-9))
            if eval_every and n % eval_every == 0 \
                    and n != cfg.steps_per_epoch:
                acc = self.evaluate()
                if acc > self.best_acc:
                    self.best_acc = acc
                    self.save_checkpoint(epoch, is_best=True)
        self.log.info(
            'epoch %d: folded_bn=%s loss %.4f acc %.4f (%d steps, %.1fs)',
            epoch, folded, loss_sum / max(n, 1), acc_sum / max(n, 1), n,
            time.time() - t0)
        return loss_sum / max(n, 1)

    def evaluate(self) -> float:
        eval_fn = make_eval_step(self.model)
        tops, n, n_samples = 0.0, 0, 0
        for i, batch in enumerate(_batches(self.cfg, False, 0, self.shard)):
            if self.cfg.eval_batches and i >= self.cfg.eval_batches:
                break
            batch = self._device_batch(batch)
            bsz = int(batch['label'].shape[0])
            tops += float(eval_fn(batch)['top1']) * bsz
            n += 1
            n_samples += bsz
        # across processes weighted by their sample counts, so uneven final
        # batches do not skew the mean
        acc = distributed.psum_metrics({'top1': tops / max(n_samples, 1)},
                                       count=n_samples)['top1']
        self.log.info('eval top-1 %.4f (%d batches)', acc, n)
        return acc

    def run(self):
        # a quantized resume restores trained activation ranges: do not
        # recalibrate over them; if the checkpoint carried no quant_stats
        # the ranges are fresh and calibration still runs
        if not self._restored_quant_stats:
            self.calibrate()
        if self.cfg.evaluate:       # eval-only
            return self.evaluate()
        for epoch in range(self.start_epoch, self.cfg.epochs):
            self.train_epoch(epoch)
            acc = self.evaluate()
            is_best = acc > self.best_acc
            self.best_acc = max(self.best_acc, acc)
            self.save_checkpoint(epoch + 1, is_best)
        return self.best_acc


def main(argv=None):
    p = argparse.ArgumentParser(description='hawq-tpu QAT trainer (PyTorch)')
    none_types = {'fix_bn_threshold': int, 'steps_per_epoch': int,
                  'eval_batches': int, 'distill_alpha': float,
                  'data_dir': str, 'resume': str,
                  'teacher_checkpoint': str, 'bias_bit': int,
                  'channel_wise': int, 'act_percentile': float,
                  'weight_percentile': float, 'act_range_momentum': float,
                  'grad_precision': str, 'residual_store_dtype': str}
    for f in dataclasses.fields(TrainerConfig):
        name = '--' + f.name.replace('_', '-')
        if isinstance(f.default, bool):
            p.add_argument(name, action='store_true', default=f.default)
        else:
            typ = none_types.get(f.name, type(f.default)) \
                if f.default is None else type(f.default)
            p.add_argument(name, type=typ, default=f.default)
    args = p.parse_args(argv)
    return Trainer(TrainerConfig(**vars(args))).run()


if __name__ == '__main__':
    main()
