"""The latency LUT of the ILP's latency mode, measured on this card (the
port's counterpart of the JAX package's ``benchmarks/latency_lut.py``, whose
LUTs hold a TPU's readings and are never read here).

One sweep of ``inference.autotune.autotune_routing`` over a ResNet v1 with
synthetic uniform4 weights (seed 0), so that every unit conv has both
routes: each conv of ``autotune.routable_convs`` (the ILP's cost keys,
``sensitivity.ilp.resnet_layer_costs``: 19 for ResNet-18, 52 for ResNet-50)
timed through the engine's own conv routes ``'int8'`` and ``'int4w'`` by
CUDA-graph replay (``autotune.time_candidates``).  Per key:

  lat8 = the int8 route's time;
  lat4 = min(int4w, int8): a 4-bit layer never costs more than an 8-bit
         one, because the router can send it to the int8 kernels (the JAX
         script's definition).

The file is JSON ``{key: [lat4_ms, lat8_ms]}`` with the comment keys
``'_device'`` (the card's name and power limit, as ``nvidia-smi`` gives
them) and ``'_batch'``, which :func:`load_latency_lut` drops.

    python -m hawq_tpu_torch.sensitivity.latency_lut --arch resnet50 \\
        --batch 8 [--out lut.json] [--device cpu] [--image-size 32]

writes ``chiprun_out/latency_lut_<arch>_b<batch>.json`` unless ``--out``
names another file; ``python -m hawq_tpu_torch.sensitivity.pipeline --mode
latency --latency-lut <file>`` reads it.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Callable, Dict, Optional, Tuple

import torch

from hawq_tpu_torch.inference.autotune import OUT_DIR, autotune_routing


def device_label(device: torch.device) -> str:
    """The card's name and power limit (``nvidia-smi``'s csv), or 'cpu'."""
    if device.type != 'cuda':
        return 'cpu'
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    out = subprocess.run(
        ['nvidia-smi', f'--id={index}', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    line = out.stdout.strip()
    return line if out.returncode == 0 and line else \
        torch.cuda.get_device_name(device)


def measure_latency_lut(arch: str, batch: int = 8, image_size: int = 224, *,
                        device='cuda', timer: Optional[Callable] = None,
                        verbose: bool = False) -> Dict:
    """The LUT of a ResNet v1 ``arch`` at ``batch`` (module docstring), ms;
    ``timer`` as in ``autotune_routing`` (tests)."""
    from hawq_tpu_torch.configs.bit_config import get_bit_config
    from hawq_tpu_torch.inference.engine import engine_device
    from hawq_tpu_torch.inference.synthetic import synthetic_frozen_resnet
    device = engine_device(device)
    fm = synthetic_frozen_resnet(arch, get_bit_config(arch, 'uniform4'),
                                 seed=0)
    table = autotune_routing(fm, batch, image_size, verbose=verbose,
                             device=device, timer=timer)
    lut: Dict = {'_device': device_label(device), '_batch': batch}
    for key, us in table['_us'].items():
        lat8 = us['int8'] / 1e3
        lut[key] = [min(us.get('int4w', us['int8']) / 1e3, lat8), lat8]
    return lut


def save_latency_lut(path: str, lut: Dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'w') as f:
        json.dump(lut, f, indent=1, sort_keys=True)


def load_latency_lut(path: str) -> Dict[str, Tuple[float, float]]:
    """``{key: (lat4_ms, lat8_ms)}`` of a LUT file, its comment keys (those
    starting with '_') dropped."""
    with open(path) as f:
        return {k: tuple(v) for k, v in json.load(f).items()
                if not k.startswith('_')}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--arch', default='resnet50')
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--image-size', type=int, default=224)
    ap.add_argument('--out', default=None,
                    help='LUT path (default chiprun_out/latency_lut_<arch>_'
                         'b<batch>.json)')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    out = args.out or os.path.join(
        OUT_DIR, f'latency_lut_{args.arch}_b{args.batch}.json')
    lut = measure_latency_lut(args.arch, args.batch, args.image_size,
                              device=args.device, verbose=True)
    save_latency_lut(out, lut)
    layers = [v for k, v in lut.items() if not k.startswith('_')]
    print(f'{len(layers)} layers on {lut["_device"]} at batch {args.batch}: '
          f'sum lat4 {sum(v[0] for v in layers):.6f} ms, sum lat8 '
          f'{sum(v[1] for v in layers):.6f} ms')
    print('wrote', out)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
