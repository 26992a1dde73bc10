"""End-to-end mixed-precision config generation (port of the pipeline in
examples/generate_mixed_config.py).

  1. build the QAT model at uniform8, then calibrate its ranges on the
     calibration batch (or load trained variables from a checkpoint);
  2. estimate per-layer Hessian traces with Hutchinson probes on that batch
     (reverse-over-reverse HVPs through the QAT graph, on ``device``);
  3. compute per-layer ΔW² at 4/8 bits from the weights;
  4. solve the ILP under a model-size / BOPS / latency budget;
  5. expand the allocation into a BitConfig.

The latency mode needs a measured LUT {layer key: (ms at 4 bits, ms at 8
bits)} for the card the config is meant for; none is shipped:
``python -m hawq_tpu_torch.sensitivity.latency_lut`` measures one for a
ResNet v1 on the card.

Usage:
  python -m hawq_tpu_torch.sensitivity.pipeline --arch resnet50 --mode bops \\
      --fraction 0.5 [--device cuda] [--checkpoint ckpt.npz] [--out f.json]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from hawq_tpu_torch.configs.bit_config import BitConfig, get_bit_config
from hawq_tpu_torch.models.mobilenetv2 import QMobileNetV2
from hawq_tpu_torch.models.resnet import (QResNet, qat_from_numpy,
                                          qat_to_numpy)
from hawq_tpu_torch.sensitivity.hessian import (conv_layer_traces,
                                                hutchinson_layer_traces)
from hawq_tpu_torch.sensitivity.ilp import (
    LayerCost, allocate_bits, allocation_to_bit_config,
    mobilenet_allocation_to_bit_config, mobilenet_layer_costs,
    published_ilp_inputs, resnet_layer_costs)
from hawq_tpu_torch.train.train import cross_entropy
from hawq_tpu_torch.utils.checkpoint import load_train_checkpoint

MOBILENET_ARCHS = ('mobilenetv2', 'mobilenetv2_w1')

LatencyLut = Mapping[str, Tuple[float, float]]


def build_qat_model(arch: str, num_classes: int = 1000,
                    seed: int = 0) -> nn.Module:
    """The uniform8 QAT model of ``arch`` (a ResNet v1 arch or
    MobileNetV2 w1), on the CPU, weights from ``seed``."""
    cfg8 = get_bit_config(arch, 'uniform8')
    if arch in MOBILENET_ARCHS:
        return QMobileNetV2(cfg8, num_classes, seed=seed)
    return QResNet(arch, cfg8, num_classes, seed=seed)


def calibration_batch(batch: int, image_size: int, num_classes: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The seeded calibration batch: uniform [0, 1) NHWC images and random
    labels from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    x = rng.rand(batch, image_size, image_size, 3).astype(np.float32)
    return x, rng.randint(0, num_classes, (batch,))


def qat_loss(model: nn.Module, x: torch.Tensor, y: torch.Tensor):
    """``loss_fn(params)``: the cross-entropy of the QAT eval forward
    (folded BN, frozen ranges) on (x, y) with ``params`` in place of the
    model's parameters."""
    def loss_fn(params):
        logits = torch.func.functional_call(
            model, dict(params), (x,), dict(folded=True, update_stats=False))
        return cross_entropy(logits, y)
    return loss_fn


def _check_lut(costs: List[LayerCost], lut: LatencyLut) -> None:
    # a missing key would make a layer free in the latency constraint
    missing = [c.key for c in costs if c.key not in lut]
    if missing:
        raise KeyError(f'latency LUT is missing layer(s) {missing}')


def estimate_layer_costs(arch: str, *, device='cuda', batch: int = 8,
                         image_size: int = 224, probes: int = 4,
                         num_classes: int = 1000,
                         checkpoint: Optional[str] = None,
                         latency_lut: Optional[LatencyLut] = None
                         ) -> Tuple[nn.Module, List[LayerCost]]:
    """Steps 1–3 → (the calibrated uniform8 QAT model on ``device``, its
    LayerCosts).  Without a ``checkpoint`` the model (seed 0) is calibrated
    by one pass over the calibration batch; the probes come from a CPU
    generator seeded 0, so they are the same on every device."""
    model = build_qat_model(arch, num_classes).to(device)
    x, y = (torch.from_numpy(a).to(device)
            for a in calibration_batch(batch, image_size, num_classes))
    if checkpoint:
        qat_from_numpy(model, load_train_checkpoint(checkpoint)[0])
    else:
        with torch.no_grad():
            model(x, folded=True, update_stats=True)
    traces = conv_layer_traces(hutchinson_layer_traces(
        qat_loss(model, x, y), dict(model.named_parameters()),
        n_probes=probes))
    params = qat_to_numpy(model)['params']
    if isinstance(model, QMobileNetV2):
        costs = mobilenet_layer_costs(params, traces, stages=model.stages,
                                      input_size=image_size,
                                      latency_lut=latency_lut)
    else:
        costs = resnet_layer_costs(arch, params, traces,
                                   input_size=image_size,
                                   latency_lut=latency_lut)
    if latency_lut is not None:
        _check_lut(costs, latency_lut)
    return model, costs


def published_layer_costs(arch: str, latency_lut: Optional[LatencyLut] = None
                          ) -> List[LayerCost]:
    """The reference's published allocator inputs (resnet18 / resnet50),
    their latency columns replaced by ``latency_lut`` where given."""
    costs = published_ilp_inputs(arch)
    if latency_lut is None:
        return costs
    _check_lut(costs, latency_lut)
    return [dataclasses.replace(c, latency4=latency_lut[c.key][0],
                                latency8=latency_lut[c.key][1])
            for c in costs]


def to_bit_config(arch: str, alloc, scheme_name: str) -> BitConfig:
    """The full BitConfig of an allocation, named ``<arch>_<scheme_name>``
    (``mobilenetv2_w1_<scheme_name>`` for MobileNetV2)."""
    if arch in MOBILENET_ARCHS:
        return mobilenet_allocation_to_bit_config(alloc, scheme_name)
    return allocation_to_bit_config(arch, alloc, scheme_name)


def generate_mixed_config(arch: str, mode: str, fraction: float, *,
                          device='cuda', batch: int = 8,
                          image_size: int = 224, probes: int = 4,
                          num_classes: int = 1000,
                          checkpoint: Optional[str] = None,
                          published_traces: bool = False,
                          latency_lut: Optional[LatencyLut] = None
                          ) -> BitConfig:
    """The generated BitConfig ``<arch>_<mode>_<fraction>_generated``.

    ``published_traces``: the reference's published trace / ΔW² / params /
    BOPS arrays instead of estimated traces (no model is built).  ``mode``
    'latency' needs ``latency_lut``."""
    if mode == 'latency' and latency_lut is None:
        raise ValueError('the latency mode needs a latency LUT measured on '
                         'the target card (latency_lut)')
    if published_traces:
        if checkpoint:
            raise ValueError('published_traces uses the reference trace '
                             'arrays; a checkpoint has no effect')
        costs = published_layer_costs(arch, latency_lut)
    else:
        _, costs = estimate_layer_costs(
            arch, device=device, batch=batch, image_size=image_size,
            probes=probes, num_classes=num_classes, checkpoint=checkpoint,
            latency_lut=latency_lut)
    alloc = allocate_bits(costs, mode, fraction)
    return to_bit_config(arch, alloc, f'{mode}_{fraction}_generated')


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--arch', default='resnet50')
    p.add_argument('--mode', default='bops',
                   choices=['model_size', 'bops', 'latency'])
    p.add_argument('--fraction', type=float, default=0.5)
    p.add_argument('--checkpoint', default=None)
    p.add_argument('--image-size', type=int, default=224)
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--num-classes', type=int, default=1000)
    p.add_argument('--probes', type=int, default=4)
    p.add_argument('--device', default='cuda')
    p.add_argument('--published-traces', action='store_true',
                   help="use the reference's published Hutchinson trace / "
                        "ΔW² / params / BOPS arrays (configs/data/"
                        "ilp_inputs_<arch>.json) instead of estimating "
                        "traces")
    p.add_argument('--latency-lut', default=None,
                   help='JSON {layer key: [ms at 4 bits, ms at 8 bits]} '
                        'measured on the target card (required by '
                        '--mode latency; python -m hawq_tpu_torch.'
                        'sensitivity.latency_lut writes one)')
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    if args.mode == 'latency' and not args.latency_lut:
        p.error('--mode latency needs --latency-lut')
    lut = None
    if args.latency_lut:
        from hawq_tpu_torch.sensitivity.latency_lut import load_latency_lut
        lut = load_latency_lut(args.latency_lut)
    cfg = generate_mixed_config(
        args.arch, args.mode, args.fraction, device=args.device,
        batch=args.batch, image_size=args.image_size, probes=args.probes,
        num_classes=args.num_classes, checkpoint=args.checkpoint,
        published_traces=args.published_traces, latency_lut=lut)
    n4 = sum(1 for k, v in cfg.table.items() if v == 4)
    print(f'{cfg.name}: {n4} of {len(cfg.table)} table entries at 4 bits')
    out = args.out or f'{args.arch}_{args.mode}_{args.fraction}_generated.json'
    with open(out, 'w') as f:
        f.write(cfg.to_json())
    print('wrote', out)


if __name__ == '__main__':
    main()
