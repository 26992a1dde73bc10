#!/usr/bin/env python3
"""What the ``torch.library`` dispatch of the kernels costs on the host, on
one NVIDIA GPU.

    python3 chip_op_dispatch.py [--rounds 3]

Host microseconds per call (``chip_smoke.host_us``: calls enqueued on the
host clock, the device not waited for) of a ResNet-50 3x3 conv at batch 8
(``int8_conv_requant``, 14x14x256 → 256, border left to TMA) and a 1x1
(``int8_matmul_acc``, 1568x1024 → 256), each on its prepared handle:

  wrapper             the public wrapper, as the engines call it;
  op_direct           the operator object (``kernels._build.Op``) on the
                      wrapper's operator arguments: its eager path, which
                      runs the CUDA implementation without the dispatcher;
  op_dispatcher       ``torch.ops.hawq.<name>.default`` on the same
                      arguments (``Library.define`` + ``impl``), the path
                      a traced or loaded program takes;
  custom_op           the same CUDA implementation registered as a
                      ``torch.library.custom_op`` (namespace
                      ``hawq_probe``), on the same arguments;
  wrapper_dispatched  the wrapper with ``Op`` sending every call through
                      the dispatcher;

and of a ResNet-50 uniform8 forward at batch 8, 224² (float32 images, int32
carrier): ``forward``, ``forward_dispatched`` (as above) and ``program``
(``export.load_program(export.export_program(fm))``, every node through the
dispatcher).  Every measurement runs once a round, in turns, the order
reversed every other round; the medians are printed as one JSON line after
the card's name and power limit.

In a tree whose kernels are not yet operators (no ``kernels._build.Op``)
only ``wrapper`` and ``forward`` are measured, so that two trees can be
compared in one call.  Needs a GPU and nvcc (it builds the kernels); exits
non-zero without one.
"""

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

OP_REPS, FORWARD_REPS = 1000, 50


def probe_op(op):
    """``op``'s CUDA implementation as a ``torch.library.custom_op``
    (schema of the conv operators)."""
    @torch.library.custom_op('hawq_probe::int8_conv_requant', mutates_args=(),
                             device_types='cuda')
    def probe(xp: torch.Tensor, w: torch.Tensor, cpad: int, row_taps: int,
              bias: torch.Tensor, mult: Optional[torch.Tensor], lo: int,
              hi: int, taps: List[int], out_hw: List[int], cin: int,
              pad: List[int], tile_n: int, smem_extra: int) -> torch.Tensor:
        return op.cuda(xp, w, cpad, row_taps, bias, mult, lo, hi, taps,
                       out_hw, cin, pad, tile_n, smem_extra)
    return probe


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--rounds', type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    import chip_smoke as cs
    from hawq_tpu_torch.configs.bit_config import get_bit_config
    from hawq_tpu_torch.inference.engine import build_resnet_engine
    from hawq_tpu_torch.inference.synthetic import synthetic_frozen_resnet
    from hawq_tpu_torch.kernels import _build
    from hawq_tpu_torch.kernels import conv as kc
    from hawq_tpu_torch.kernels import matmul as km

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _build.lib()
    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randint(-128, 128, (8, 14, 14 * 256)).astype(
        np.int8), device=dev)
    w = torch.tensor(rng.randint(-8, 8, (9 * 256, 256)).astype(np.int8),
                     device=dev)
    h = kc.prepare_conv_weights(w, (3, 3), 256, (1, 1))
    b = torch.zeros(256, dtype=torch.int32, device=dev)
    m = torch.full((256,), 1e-3, device=dev)
    xm = torch.tensor(rng.randint(-128, 128, (1568, 1024)).astype(np.int8),
                      device=dev)
    hm = km.prepare_weights(torch.tensor(
        rng.randint(-8, 8, (1024, 256)).astype(np.int8), device=dev))
    fm = synthetic_frozen_resnet('resnet50',
                                 get_bit_config('resnet50', 'uniform8'),
                                 seed=0)
    engine = build_resnet_engine(fm, device=dev)
    img = torch.from_numpy(np.random.RandomState(1).rand(
        8, 224, 224, 3).astype(np.float32)).to(dev)

    def conv():
        return kc.int8_conv_requant(x, h, b, m, taps=(3, 3), out_hw=(14, 14),
                                    cin=256, pad=(1, 1), relu=True)

    def matmul():
        return km.int8_matmul_acc(xm, hm, b)

    fns = {'conv3x3_requant.wrapper': (conv, OP_REPS),
           'matmul_acc.wrapper': (matmul, OP_REPS),
           'forward': (lambda: engine(img), FORWARD_REPS)}
    has_ops = hasattr(_build, 'Op')
    if has_ops:
        from hawq_tpu_torch.export.export import export_program, load_program
        lo, hi = km.epilogue_bounds(8, True, True)
        conv_op, matmul_op = kc.OPS['int8_conv_requant'], km.OPS[
            'int8_matmul_acc']
        conv_args = (x, h.wt, h.cpad, h.row_taps, b, m, lo, hi, [3, 3],
                     [14, 14], 256, [1, 1], -1, 0)
        matmul_args = (xm, hm.wt, hm.cpad, b, None, 0, 0, -1, -1, 0)
        probe = probe_op(conv_op)
        want = conv()
        for name, got in (('op_direct', conv_op(*conv_args)),
                          ('op_dispatcher', conv_op.overload(*conv_args)),
                          ('custom_op', probe(*conv_args))):
            if not torch.equal(got, want):
                raise SystemExit(f'{name}: the conv differs from the wrapper')
        program = load_program(export_program(fm, 8, 224, device=dev))
        if not torch.equal(program(img), engine(img)):
            raise SystemExit('the loaded program differs from the engine')
        direct_call = _build.Op.__call__

        fns.update({
            'conv3x3_requant.op_direct': (lambda: conv_op(*conv_args),
                                          OP_REPS),
            'conv3x3_requant.op_dispatcher': (
                lambda: conv_op.overload(*conv_args), OP_REPS),
            'conv3x3_requant.custom_op': (lambda: probe(*conv_args),
                                          OP_REPS),
            'matmul_acc.op_direct': (lambda: matmul_op(*matmul_args),
                                     OP_REPS),
            'matmul_acc.op_dispatcher': (
                lambda: matmul_op.overload(*matmul_args), OP_REPS),
            'program': (lambda: program(img), FORWARD_REPS)})
        # the patch held over the whole timed loop
        for name, (fn, reps) in (('conv3x3_requant.wrapper_dispatched',
                                  (conv, OP_REPS)),
                                 ('matmul_acc.wrapper_dispatched',
                                  (matmul, OP_REPS)),
                                 ('forward_dispatched',
                                  (lambda: engine(img), FORWARD_REPS))):
            fns[name] = (fn, reps, True)

    times = {k: [] for k in fns}
    order = list(fns)
    for i in range(args.rounds):
        for k in (order if i % 2 == 0 else order[::-1]):
            fn, reps, *patched = fns[k]
            if patched:
                _build.Op.__call__ = lambda op, *a: op.overload(*a)
            try:
                times[k].append(cs.host_us(fn, reps=reps))
            finally:
                if patched:
                    _build.Op.__call__ = direct_call
    print(json.dumps({'torch': torch.__version__, 'operators': has_ops,
                      'host_us': {k: float(np.median(v))
                                  for k, v in times.items()},
                      'rounds': args.rounds}))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
