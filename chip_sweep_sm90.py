#!/usr/bin/env python3
"""Sweep the Hopper GEMM core's tile width on one NVIDIA GPU.

    python3 chip_sweep_sm90.py

The measurements behind ``kernels.matmul.sm90_tile_n`` and the notes in
csrc/gemm_s8_sm90.cuh, each by CUDA-graph replay (``chip_smoke.graph_ms``):

 1. the fixed cost of a launch: a one-element PyTorch kernel, and the core's
    smallest call (one 64 x 32 tile, one K step);
 2. what one block alone takes in: one 64 x 32 tile over K = 4096 (32 steps
    of 12 KB), per step and in bytes per microsecond;
 3. every ``int8_matmul_acc``, ``int8_matmul_requant``, ``int8_conv_requant``
    and ``int4w_conv_requant`` shape of a ResNet-50 forward at batch 8,
    224 x 224 (the 3 x 3 convs with their zero border left to TMA, the
    stride-2 ones as their 2 x 2-tap space-to-depth rewrite), and the
    largest ``int8_matmul_acc`` shapes of a batch-32 QAT step, at tile
    widths 32, 64 and 128, with the width the rule picks marked ``*``; each
    result is first held against the plain version;
 4. the same for the accumulator convs: ``int8_conv_acc`` at the folded
    init of a batch-8 forward and at every call of a batch-32 QAT step of
    ResNet-50 (the channel-padded init's 4 x 4-tap rewrite, the 3 x 3s),
    and ``int8_conv_acc`` / ``int4w_conv_acc`` at the four conv2 shapes of
    a batch-8 ResNet-18 forward;
 5. the packed matmuls ``int4w_matmul_requant`` and ``int4w_matmul_acc`` at
    every shape of a batch-8 ResNet-50 uniform4 forward (and ResNet-18's
    identity convs): tile widths 32, 64 and 128 with 64-row tiles, then with
    128-row tiles (two consumer warpgroups), the widths and rows the rules
    pick marked ``*`` (``sm90_tile_n`` with ``SM90_INT4_MATMUL_WIDEST``,
    ``sm90_tile_m``), each result first held against the plain version;
    the two row counts are timed in turns (64, 128, 128, 64);
 6. the folded pool (``maxpool_folded``, int16) and its requant-in-front
    form (``maxpool_folded_requant``, int32 in, int16 out) at the main
    path's shape (8, 56, 56, 256): with the input in L2 (the same input at
    every launch) and streamed from device memory (``chip_smoke.cold_ms``:
    a launch per copy over copies that fill twice the L2), each with
    16-byte channel vectors and with one channel a thread (the input one
    element off 16-byte alignment), against the bytes bound at 3.35 TB/s.

Needs a GPU and nvcc (it builds the kernels); exits non-zero without one.
"""

import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

MATMULS = [(25088, 64, 256), (6272, 128, 512), (6272, 256, 512),
           (1568, 256, 1024), (1568, 512, 1024), (392, 512, 2048),
           (392, 1024, 2048), (8, 2048, 1000), (100352, 64, 256),
           (100352, 256, 64), (25088, 512, 128), (8448, 4096, 128)]
REQUANT_MATMULS = [(25088, 64, 64), (25088, 256, 64), (6272, 256, 128),
                   (6272, 512, 128), (1568, 512, 256), (1568, 1024, 256),
                   (392, 1024, 512), (392, 2048, 512)]
# B, H = W, C, N, taps per side: 3 x 3 taps with pad 1, or the 2 x 2 taps of a
# space-to-depth stride-2 conv on its slab
CONVS = [(8, 56, 64, 64, 3), (8, 28, 128, 128, 3), (8, 14, 256, 256, 3),
         (8, 7, 512, 512, 3), (8, 28, 512, 128, 2), (8, 14, 1024, 256, 2),
         (8, 7, 2048, 512, 2)]
# B, H = W, C, N, taps per side, border left to TMA, packed form too: the
# folded init (on its slab), the QAT step's init rewrite and 3 x 3s at batch
# 32, ResNet-18's conv2 at batch 8
ACC_CONVS = [(8, 56, 48, 256, 3, 0, False), (32, 112, 16, 64, 4, 0, False),
             (32, 56, 64, 64, 3, 1, False), (32, 28, 128, 128, 3, 1, False),
             (32, 14, 256, 256, 3, 1, False), (32, 7, 512, 512, 3, 1, False),
             (8, 56, 64, 64, 3, 1, True), (8, 28, 128, 128, 3, 1, True),
             (8, 14, 256, 256, 3, 1, True), (8, 7, 512, 512, 3, 1, True)]
# M, K, N of int4w_matmul_requant, then int4w_matmul_acc, at batch 8
INT4_REQUANT_MATMULS = REQUANT_MATMULS
INT4_MATMULS = [(25088, 64, 256), (6272, 128, 512), (6272, 256, 512),
                (1568, 256, 1024), (1568, 512, 1024), (392, 512, 2048),
                (392, 1024, 2048), (6272, 64, 128), (1568, 128, 256),
                (392, 256, 512)]
def main():
    if not torch.cuda.is_available():
        sys.exit('chip_sweep_sm90: needs an NVIDIA GPU')
    from chip_smoke import cold_ms, graph_ms
    from hawq_tpu_torch.kernels import conv as kc
    from hawq_tpu_torch.kernels import matmul as km
    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())

    def i8(*shape):
        return torch.tensor(rng.randint(-128, 128, shape).astype(np.int8),
                            device=dev)

    def matmul_us(m, k, n, tile_n, requant=False):
        x, w = i8(m, k), i8(k, n)
        bias = torch.zeros(n, dtype=torch.int32, device=dev)
        prepared = km.prepare_weights(w)
        if requant:
            mult = torch.full((n,), 2.0 ** -12, device=dev)
            run = lambda: km.int8_matmul_requant(x, prepared, bias, mult,
                                                 tile_n=tile_n)
            want = km.matmul_requant_plain(x, w, bias, mult, -128, 127)
        else:
            run = lambda: km.int8_matmul_acc(x, prepared, bias, tile_n=tile_n)
            want = km.matmul_acc_plain(x, w, bias)
        assert torch.equal(run(), want)
        return graph_ms(run, 50) * 1e3

    one = torch.zeros(1, device=dev)
    print(f'one-element add_: {graph_ms(lambda: one.add_(1), 50) * 1e3:.2f} '
          f'us per graph node')
    print(f'M64 K64 N32, one tile, one K step: {matmul_us(64, 64, 32, 32):.2f}'
          f' us')
    short, long = matmul_us(64, 128, 32, 32), matmul_us(64, 4096, 32, 32)
    step = (long - short) / 31
    print(f'M64 N32 one block: K128 {short:.2f} us, K4096 {long:.2f} us: '
          f'{step:.3f} us per 12 KB step, {12288 / step / 1e3:.1f} GB/s')

    sms = km.sm_count(dev)
    print('int8_matmul_acc  M K N: us at tile 32 / 64 / 128 (* = the rule)')
    for m, k, n in MATMULS:
        tile_k = 128 if k % 128 == 0 else 64
        pick = km.sm90_tile_n(-(-m // 64), n, -(-k // tile_k), sms)
        row = ' / '.join(f"{matmul_us(m, k, n, t):.2f}{'*' if t == pick else ''}"
                         for t in km.SM90_TILE_NS[::-1])
        print(f'  M{m} K{k} N{n}: {row}')
    print('int8_matmul_requant  M K N: us at tile 32 / 64 / 128')
    for m, k, n in REQUANT_MATMULS:
        tile_k = 128 if k % 128 == 0 else 64
        pick = km.sm90_tile_n(-(-m // 64), n, -(-k // tile_k), sms)
        row = ' / '.join(
            f"{matmul_us(m, k, n, t, True):.2f}{'*' if t == pick else ''}"
            for t in km.SM90_TILE_NS[::-1])
        print(f'  M{m} K{k} N{n}: {row}')

    def conv_row(b, h, c, n, side, pad, int4s, requant):
        taps, pad = (side, side), (pad, pad)
        x = i8(b, h + side - 1 - 2 * pad[0], (h + side - 1 - 2 * pad[1]) * c)
        wf = torch.tensor(rng.randint(-8, 8, (side * side * c, n)).astype(
            np.int8), device=dev)
        wp = torch.tensor(kc.pack_int4_conv(wf.cpu().numpy(), side * side),
                          device=dev)
        bias = torch.zeros(n, dtype=torch.int32, device=dev)
        mult = torch.full((n,), 2.0 ** -12, device=dev)
        geo = dict(taps=taps, out_hw=(h, h), cin=c)
        want = kc.conv_acc_plain(kc.pad_conv_input(x, pad, **geo), wf, bias,
                                 **geo)
        if requant:
            want = km.requant_epilogue(want, mult, -128, 127)
        for int4 in int4s:
            weights = kc.prepare_conv_weights(wp if int4 else wf, taps, c,
                                              pad, int4)
            name = ('int4w' if int4 else 'int8') + (
                '_conv_requant' if requant else '_conv_acc')
            fn = getattr(kc, name)
            args = (x, weights, bias, mult) if requant else (x, weights, bias)
            pick = kc.sm90_conv_tile_n(weights, b, (h, h), sms)
            row = []
            for t in km.SM90_TILE_NS[::-1]:
                run = lambda: fn(*args, tile_n=t, pad=pad, **geo)
                assert torch.equal(run(), want)
                row.append(f"{graph_ms(run, 50) * 1e3:.2f}"
                           f"{'*' if t == pick else ''}")
            print(f"  {name} B{b} {h}x{h} taps{side}x{side} C{c} N{n}: "
                  + ' / '.join(row))

    print('int8_conv_requant, then int4w_conv_requant  B HxW taps C N: us at '
          'tile 32 / 64 / 128')
    for b, h, c, n, side in CONVS:
        conv_row(b, h, c, n, side, 1 if side == 3 else 0, (False, True), True)
    print('int8_conv_acc (and int4w_conv_acc)  B HxW taps C N: us at tile 32 '
          '/ 64 / 128')
    for b, h, c, n, side, pad, packed in ACC_CONVS:
        conv_row(b, h, c, n, side, pad, (False, True) if packed else (False,),
                 False)

    def int4_matmul_row(m, k, n, requant):
        x = i8(m, k)
        w = rng.randint(-8, 8, (k, n)).astype(np.int8)
        prepared = km.prepare_weights_int4(torch.tensor(km.pack_int4(w),
                                                        device=dev))
        w = torch.tensor(w, device=dev)
        bias = torch.zeros(n, dtype=torch.int32, device=dev)
        if requant:
            mult = torch.full((n,), 2.0 ** -10, device=dev)
            fn = lambda **kw: km.int4w_matmul_requant(x, prepared, bias, mult,
                                                      **kw)
            want = km.matmul_requant_plain(x, w, bias, mult, -128, 127)
        else:
            fn = lambda **kw: km.int4w_matmul_acc(x, prepared, bias, **kw)
            want = km.matmul_acc_plain(x, w, bias)
        k_tiles = -(-k // prepared.tile_k)
        pick_n = km.sm90_tile_n(-(-m // 64), n, k_tiles, sms,
                                km.SM90_INT4_MATMUL_WIDEST)
        pick_m = km.sm90_tile_m(m, n, k_tiles, sms)
        us = {}
        for rows in (64, 128, 128, 64):
            for t in km.SM90_TILE_NS[::-1]:
                run = lambda: fn(tile_n=t, tile_m=rows)
                if (rows, t) not in us:
                    assert torch.equal(run(), want)
                    us[rows, t] = []
                us[rows, t].append(graph_ms(run, 50) * 1e3)
        cells = {key: sum(v) / len(v) for key, v in us.items()}
        rows_txt = [' / '.join(
            f"{cells[rows, t]:.2f}"
            f"{'*' if (rows, t) == (pick_m, pick_n) else ''}"
            for t in km.SM90_TILE_NS[::-1]) for rows in (64, 128)]
        best = min(cells, key=cells.get)
        name = 'int4w_matmul_requant' if requant else 'int4w_matmul_acc'
        print(f'  {name} M{m} K{k} N{n}: 64 rows {rows_txt[0]} | 128 rows '
              f'{rows_txt[1]} | fastest {best[0]} x {best[1]}')

    print('int4w_matmul_requant, then int4w_matmul_acc  M K N: us at tile 32 '
          '/ 64 / 128, with 64-row and with 128-row tiles (mean of two turns)')
    for m, k, n in INT4_REQUANT_MATMULS:
        int4_matmul_row(m, k, n, True)
    for m, k, n in INT4_MATMULS:
        int4_matmul_row(m, k, n, False)

    from hawq_tpu_torch.kernels import pool as kp
    print('maxpool_folded (int16) and maxpool_folded_requant (int32 -> int16) '
          'at (8, 56, 56, 256): us with the input in L2 / streamed from '
          'device memory; 16-byte channel vectors | one channel (the input '
          'one element off 16-byte alignment)')

    def unaligned(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)
    xf = torch.tensor(rng.randint(-2 ** 14, 2 ** 14, (8, 56, 56, 256)),
                      dtype=torch.int16, device=dev)
    acc = torch.tensor(rng.randint(-2 ** 20, 2 ** 20, (8, 56, 56, 256)),
                       dtype=torch.int32, device=dev)
    pmult = torch.full((256,), 2.0 ** -8, device=dev)
    requant = lambda a: kp.maxpool_folded_requant(
        a, pmult, out_bits=16, signed=True, relu=True, out_dtype=torch.int16)
    forms = {
        'maxpool_folded': (kp.maxpool_folded, xf,
                           kp.maxpool_3x3s2p1_folded(xf),
                           xf.numel() * 2 + xf.numel() // 4 * 2),
        'maxpool_folded_requant': (
            requant, acc,
            kp.maxpool_folded_requant_plain(acc, pmult, 16, True, True,
                                            torch.int16),
            acc.numel() * 4 + 256 * 4 + acc.numel() // 4 * 2)}
    for name, (fn, x, want, nbytes) in forms.items():
        cells = []
        for inp in (x, unaligned(x)):
            assert torch.equal(fn(inp), want)
            cells.append(f'{graph_ms(lambda: fn(inp), 50) * 1e3:.2f} / '
                         f'{cold_ms(fn, (inp,), 10) * 1e3:.2f}')
        print(f'  {name}: {cells[0]} | {cells[1]}; bound '
              f'{nbytes / 3.35e12 * 1e6:.2f} us')
    return 0


if __name__ == '__main__':
    sys.exit(main())
