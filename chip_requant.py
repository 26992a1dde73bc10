#!/usr/bin/env python3
"""R1, the engines' standalone requant kernel (csrc/requant.cu,
``kernels/requant.py``), timed at the requant sites of a b256 forward on one
NVIDIA GPU.

    python3 chip_requant.py [--batch 256]

For ResNet-50 uniform8 (uint8 images at 224², the int32 carrier) and
InceptionV3 w1 uniform8 (uint8 at 299², the default wide container), on
synthetic weights: one forward with every call of ``requant_int32`` and
``requant_concat`` recorded (``chip_smoke.recording``), then each distinct
call timed by CUDA-graph replay (``chip_smoke.graph_ms``, 20 launches)
beside its plain version (the six PyTorch elementwise ops of
``quant/ops.py requant_int32``, the ReLU where the call takes one, and the
concat form's ``torch.cat``; 3 launches) and its bound, bytes at 3.35 TB/s.
``chip_smoke.py`` holds every call to its plain version, bit for bit, at
b8.  Prints the card's name and power limit, a line a distinct call and one
JSON line a model with the sums over a forward, and writes the JSON lines
to ``chiprun_out/requant_kernel.json``.  Needs a GPU and nvcc (it builds the
kernels); exits non-zero without one.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def model(name, batch, dev):
    from hawq_tpu_torch.configs.bit_config import get_bit_config
    from hawq_tpu_torch.inference import synthetic as syn
    rng = np.random.RandomState(1)
    if name == 'resnet50':
        from hawq_tpu_torch.inference.engine import build_resnet_engine
        fm = syn.synthetic_frozen_resnet('resnet50', get_bit_config(
            'resnet50', 'uniform8'), seed=0)
        eng = build_resnet_engine(fm, input_mode='uint8', device=dev)
        size = 224
    else:
        from hawq_tpu_torch.inference.engine_inception import (
            build_inceptionv3_engine)
        fm = syn.synthetic_frozen_inception(get_bit_config(
            'inceptionv3', 'uniform8'), seed=0)
        eng = build_inceptionv3_engine(fm, input_mode='uint8', device=dev)
        size = 299
    x = torch.from_numpy(rng.randint(0, 256, (batch, size, size, 3)).astype(
        np.uint8)).to(dev)
    return eng, x


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('chip_requant: needs an NVIDIA GPU')
    dev = torch.device('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f'torch {torch.__version__} cuda {torch.version.cuda}; {card}',
          flush=True)
    lines = []
    for name in ('resnet50', 'inceptionv3'):
        eng, x = model(name, args.batch, dev)
        eng(x)                                       # warm: builds, caches
        calls = []
        with cs.recording(calls):
            eng(x)
        torch.cuda.synchronize()
        groups = {}
        for op, a, kw in calls:
            if op in cs.RQ:
                groups.setdefault(cs.call_key(op, a, kw), []).append((a, kw))
        total = dict(kernel_ms=0.0, plain_ms=0.0, bound_ms=0.0, gb=0.0)
        for key, same in groups.items():
            op, (a, kw) = key[0], same[0]
            nbytes, _, label = cs.work(op, a, kw, cs.kernel_call(op, a, kw))
            k_ms = cs.graph_ms(lambda: cs.kernel_call(op, a, kw), 20)
            p_ms = cs.graph_ms(lambda: cs.plain_call(op, a, kw), 3)
            bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
            n = len(same)
            total['kernel_ms'] += n * k_ms
            total['plain_ms'] += n * p_ms
            total['bound_ms'] += n * bound
            total['gb'] += n * nbytes / 1e9
            print(f'  {name} {op} x{n} {label}: kernel {k_ms:.4f} ms, plain '
                  f'{p_ms:.4f}, bound {bound:.4f} ({bound / k_ms:.1%})',
                  flush=True)
        line = dict(model=name, batch=args.batch, card=card,
                    launches={op: sum(c[0] == op for c in calls)
                              for op in cs.RQ},
                    distinct_calls=len(groups),
                    **{k: round(v, 4) for k, v in total.items()},
                    bound_share=round(total['bound_ms'] / total['kernel_ms'],
                                      4))
        print(json.dumps(line), flush=True)
        lines.append(line)
        del eng, x, calls, groups
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out', 'requant_kernel.json'),
              'w') as f:
        for line in lines:
            f.write(json.dumps(line) + '\n')


if __name__ == '__main__':
    main()
