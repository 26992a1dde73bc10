"""The benchmark's one door into the program under test, ``hawq_tpu_torch``:
the frozen model built from the benchmark's arrays, its engines and its
QAT trainer.  No other module of the harness imports the program, and
the reference imports nothing of it."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from portbench import common
from portbench.work import common as work


def bit_table(config: Mapping, tensors: Mapping[str, np.ndarray]
              ) -> Dict[str, int]:
    """The configuration's bit rule (its family's ``reference`` module's
    ``bits``) as the program's name → bits table: every activation node at
    its bits, every conv and FC at ``weight_bits``."""
    bits = common.reference_family(config['family']).bits
    table = {}
    for name in tensors:
        key, kind = name.rsplit('.', 1)
        if kind == 'act_scale':
            table[key] = bits(config, key)
        elif kind == 'weight_int':
            table[key] = int(config['weight_bits'])
    return table


def frozen(config: Mapping, tensors: Mapping[str, np.ndarray]):
    """The program's FrozenModel of the benchmark's arrays."""
    from hawq_tpu_torch.inference.freeze import frozen_from_numpy
    return frozen_from_numpy(
        config['arch'], f"{config['name']}_{config['scheme']}",
        bit_table(config, tensors), tensors, config['num_classes'])


def published_table(config: Mapping) -> Dict[str, int]:
    """The program's own registry entry for the configuration's scheme
    (``get_bit_config``); the tests hold :func:`bit_table` to it."""
    from hawq_tpu_torch.configs.bit_config import get_bit_config
    return dict(get_bit_config(config.get('bit_config', config['arch']),
                               config['scheme']).table)


def engine(fm, device, **kw):
    """The family's integer engine (``deploy.build_engine_for``)."""
    from hawq_tpu_torch.deploy import build_engine_for
    return build_engine_for(fm, device=device, **kw)


class QatTrainer:
    """The program's QAT of the configuration's model (the trainer's
    ``build_model``) with the benchmark's float state loaded, SGD with
    momentum and weight decay (``sgd_with_step_decay``), the unfolded train
    step (``make_train_step(folded=False)``) and the calibration pass
    (``make_calibration_step``), batch norm unfolded in both.  The
    trainer's leaves are keyed as the benchmark's state by the family's
    ``work`` module's ``qat_key``, which a family with train cells
    brings."""

    def __init__(self, config: Mapping, params, stats, device, lr: float,
                 momentum: float, weight_decay: float):
        from hawq_tpu_torch.train import train as tt
        from hawq_tpu_torch.train.trainer import TrainerConfig, build_model
        model, _ = build_model(TrainerConfig(
            arch=config['arch'], scheme=config['scheme'],
            num_classes=config['num_classes']))
        model = model.to(device)
        self._key = work.family(config).qat_key
        values = dict(params, **stats)
        with torch.no_grad():
            for name, t in list(model.named_parameters()) + list(
                    model.named_buffers()):
                key = self._key(name)
                if key not in values:
                    raise LookupError(
                        f"family {config['family']!r}: the trainer's leaf "
                        f"{name!r} has no key in the benchmark's float "
                        f"state (looked for {key!r}, by the qat_key of "
                        f"portbench/work/{config['family']}.py)")
                t.copy_(values[key])
        self.model = model
        self.state = tt.TrainState.create(model, tt.sgd_with_step_decay(
            model, lr, momentum, weight_decay))
        self.train_step = tt.make_train_step(model, folded=False)
        self.calibrate = tt.make_calibration_step(model, folded=False)

    def step(self, images, labels):
        """One train step (enqueued) → the loss, a device tensor."""
        _, metrics = self.train_step(self.state, {'image': images,
                                                  'label': labels})
        return metrics['loss']

    def step_and_logits(self, images, labels):
        """One train step → (the loss, the logits of its forward), the
        logits taken by a forward hook on the model that the step removes
        again."""
        kept = []
        hook = self.model.register_forward_hook(
            lambda m, args, out: kept.append(out.detach().clone()))
        try:
            loss = self.step(images, labels)
        finally:
            hook.remove()
        return loss, kept[-1]

    def params(self):
        return {self._key(n): p.detach().clone()
                for n, p in self.model.named_parameters()}

    def stats(self):
        return {self._key(n): b.detach().clone()
                for n, b in self.model.named_buffers()}

    def momentum(self):
        """The optimizer's momentum trace of every parameter (zeros before
        its first step)."""
        opt = self.state.optimizer
        return {self._key(n): opt.state.get(p, {}).get(
            'momentum_buffer', torch.zeros_like(p)).detach().clone()
            for n, p in self.model.named_parameters()}
