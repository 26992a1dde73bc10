#!/usr/bin/env python3
"""Drive the PyTorch port (hawq_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from hawq_tpu_torch/kernels/csrc at first use (nvcc,
sm_90a) and runs, in order; any mismatch or error ends the run with a
non-zero exit and no result line:

 1. torch / CUDA versions, the card's name and power limit;
 2. the kernel build, with its time;
 3. the serving paths once each — synthetic ResNet-50 uniform8 (the main
    path), ResNet-50 uniform4 and bops_0.5 (nibble-packed int4 weights for
    the 4-bit layers) and ResNet-18 uniform4, all 224×224, batch 8,
    host-folded input, int16 residual carrier — each with the launch counts
    set to 0 just before it and read just after, and held against the
    counts its bit config predicts, per kernel and per GEMM core (every
    launch of the four convs and the four matmuls on the Hopper core
    csrc/gemm_s8_sm90.cuh; the folded init's requant and pool in one
    ``maxpool_folded_requant``).
    Every kernel call of those runs is recorded; each is then repeated on
    the same inputs and held against its plain PyTorch version, bit for bit
    (tolerance 0), as are ragged shapes, among them the Hopper core's (M
    off the tile, 7×7 and 14×14 images, N = 1000, B = 1, 1×1 and 2×2 taps,
    C = 16, saturated operands, requant inputs on a .5 boundary, packed
    int4 handles, 128-row tiles of the packed matmuls) and one call per
    clause of its shape rule, checked to have run on the core the rule
    names; the standalone ``maxpool_folded`` (on no path: the engine pools
    through ``maxpool_folded_requant``) held, timed and driven once at the
    main path's pre-pool tensor (its init accumulator requantized by the
    plain version); both channel-vector widths of the two pools (ragged N
    and unaligned inputs take one channel a thread) among the ragged calls;
    then each call of the path a kernel is reported on is timed
    (kernel, plain version, library call) and set beside its bound (the
    pools also with their input streamed from device memory) — the
    eight kernels on the Hopper core on both cores in turns (old, new, new,
    old), both equal to the plain version, with the wrapper's host time per
    call on each, and the packed ``int4w_*`` also beside their ``int8_*``
    twins on the same weights unpacked once to int8;
 4. the engine at full width: ResNet-50 uniform8 and uniform4, on folded
    input with the int16 carrier and on raw float32 input with the int32
    carrier, ResNet-50 bops_0.5 and ResNet-18 uniform4 on folded input, and
    ResNet-50 uniform4 on uint8 and on host-quantized folded_int8 input —
    logits and pooled features for the first two images equal the CPU
    (plain) engine's, finite, launch counts as the bit config predicts,
    milliseconds per batch; the ResNet-50 uniform8 (main path) and uniform4
    engines on the first core and on the Hopper core in turns; a profiler
    trace of both forwards on both cores, and on the Hopper core also with
    the init block's former sequence (requant as PyTorch glue, then
    ``maxpool_folded``): kernels per forward and glue time before and after;
    the raw-input engines' integer max-pool beside its float32 form on the
    pool's input (kernels, device ms, host µs per call) and those engines'
    kernels per forward;
 5. serving: DynamicBatchers over the uniform8 engine (folded input) and
    the bops_0.5 engine (folded_int8 input, quantized on the host) answer
    12 single-image requests each, each equal to its row of a batched
    engine call;
 6. the K-blocked matmul ``int8_matmul_requant_kblocked`` (on no path of
    the package: the reference has it beside its matmul kernel) on the 16
    recorded ``int8_matmul_requant`` calls of the ResNet-50 uniform8 path:
    on the engine's prepared handles on the Hopper core (K in one block,
    ``int8_matmul_requant``'s kernel) and on plain weights as the first
    core's split-K, both equal to its plain version and to that kernel's
    output, timed on both cores in turns beside it and set beside the
    core's smallest launch (its ragged calls and the calls its rule
    excludes run in phase 3); then those 16 calls once more as its own
    path, counted;
 7. QAT training through the Trainer: ResNet-50 uniform8 at full width and
    depth, 224×224, 1000 classes, batch 32, synthetic data, seed 0 — 2
    calibration batches, 4 steps with ``fix_bn_threshold=2`` (two unfolded,
    two folded), evaluation on 1 batch, the checkpoint with its frozen
    artifact.  Losses finite; the launch counts of every step equal to what
    the architecture predicts (``minmax_1pass`` once per activation
    quantizer, every conv and the FC through ``int8_conv_acc`` /
    ``int8_matmul_acc``, both on the Hopper core); every distinct kernel
    call of a step repeated on synthetic inputs of its shapes and held
    against its plain version, then timed (``int8_conv_acc`` and
    ``int8_matmul_acc`` on both cores in turns, with the K-major layout of
    their plain weights apart); ``minmax_1pass`` also on unaligned,
    one-element, NaN and ±inf
    inputs; one folded step at batch 2, 64×64 on the card against the same
    step on the CPU (integers and ranges equal, loss within 1e-5, gradients
    within 1e-3); the saved frozen checkpoint served by the integer engine
    on the card, its logits equal as integers to the trainer's QAT eval
    logits; ms per step, images/s, peak memory and a profiler trace of one
    step;
 8. MobileNetV2 w1 serving at full width, 224², batch 8, synthetic weights
    (seed 0): uniform8 on host-folded input with the int16 carrier (this
    family's main path: its launch counts set to 0 just before it, read
    just after, against the prediction from the model's widths per kernel
    and per core — D1 on its own, '@cuda' — every kernel call recorded),
    uniform8 on float32 input with int32, uniform4 and bops_0.5 folded;
    logits and the 'final' and 'fc_input' nodes for the first two images
    equal the CPU engine's;
    ms per batch; every recorded call and 44 ragged calls of D1 (the
    depthwise conv, ``int8_dwconv_requant`` / ``int8_dwconv_acc``; every
    form of its kernel: 4 channels a thread with 16- or 4-byte staging
    copies, one channel a thread) held against the plain version, bit for
    bit; D1 timed on the main path beside its bound, its plain version and
    cuDNN's float32 grouped conv, in L2 and streamed from device memory, a
    per-call table with the tile the rule chose, and each call at the
    rule's tile and at its alternatives (pixels a thread, rows, copy width,
    channels a thread) in turns; a trace of the forward;
 9. ResNet-50 v2 uniform8 serving, 224², batch 8, float32 input: the same
    checks against the CPU engine and the predicted launches, every call
    against its plain version, a trace;
10. QAT training through the Trainer on MobileNetV2 w1 (b32, 2 calibration
    batches, 2 unfolded and 2 folded steps) and ResNet-50 v2 (b32, 1 + 1
    steps) as in phase 7: losses finite, launches per step and per core
    as the model's layers predict, the frozen artifact through the
    family's engine equal as integers to the QAT eval logits, every
    distinct kernel call of a step against its plain version (D1's
    accumulator form timed, per call and at its alternative tiles, as in
    phase 8), one folded step at b2 64² on the card
    against the CPU, step times and a trace;
11. InceptionV3 w1 serving at full width and depth, 299², batch 8,
    synthetic weights (seed 0): uniform8 on host-folded input
    (``fold4_images_3x3s2(x, 0)``) with the int32 wide container (this
    family's main path: its launch counts set to 0 just before it, read
    just after, against ``expected_inception_launches`` from the model's
    widths and bit config, per kernel and per core — A1 on its own,
    '@cuda' — every kernel call recorded), uniform8 on float32 input,
    uniform8 folded with the int16 container, uniform4 folded; logits and
    the 'init' node (on the main path also a stage-2 unit's output) for
    the first two images equal the CPU engine's; ms per batch; every
    recorded call and 213 ragged calls of A1 (the integer 3×3 average pool
    with its requant, ``int_avgpool3x3_requant``, on the main path with the
    pool branch's input requant fused in front: int32, int16 and int8
    inputs, every form of its kernel, with and without the requant in
    front, one that saturates 16 bits) held against the plain version, bit
    for bit; A1 timed beside its bound, its plain version and
    ``F.avg_pool2d`` on float32, in L2 and streamed from device memory, a
    per-call table with the tile the rule chose; each call as the fused
    call, the unfused pair (``requant_int32``, then A1), the plain version,
    ``F.avg_pool2d`` and ``x.to(torch.int8)`` in turns; each call at the rule's tile and at its
    alternatives in turns; #1 / #2 / #6 / #7 timed at this path's calls on
    both cores in turns; a trace of the forward, and one with the pool
    branches unfused (kernels per forward before and after), ms per batch
    fused and unfused in turns;
12. QAT training through the Trainer on InceptionV3 uniform8 at full
    width, 299², b32 (1 calibration batch, one unfolded and one folded
    step) as in phase 7: launches per step and per core as the model's
    layers predict, the frozen artifact through the engine equal as
    integers to the QAT eval logits, every distinct kernel call of a step
    against its plain version, one folded step at b2 75² on the card
    against the CPU, step times and a trace;
13. the reference-checkpoint replay (``requant_mode='reference'``, the
    reference's 31-bit float64 requant) at full width, batch 8, int32
    carriers: ResNet-50 uniform8 on folded_float32 and float32 input,
    ResNet-50 uniform4 folded, MobileNetV2 w1 uniform8 and InceptionV3 w1
    uniform8 (299²) on float32, each model's synthetic weights (seed 0)
    exported, written as ``quantized_checkpoint.pth.tar`` and read back
    through ``load_reference_quantized``, on those weights and on a variant
    with power-of-two scales (``dyadic_scales``, where native and reference
    rounding differ: the logits must differ from the native engine's);
    launches per kernel and per core against the prediction (the
    accumulator forms, ``maxpool_folded`` on the folded ResNet path, D1's
    ``int8_dwconv_acc``, A1's quotient form ``int_avgpool3x3``; no
    fused-requant form), logits and an inner node for the first two images
    equal to the CPU reference engine's, every recorded call and 55 ragged
    calls of the quotient form against the plain versions; ms per batch of
    both modes in turns, a trace of each (kernels per forward, the float64
    glue's device time), the quotient form timed beside A1's fused form;
    the QAT-eval-against-engine checks of phases 7, 10 and 12 keep both
    checkpoints and walk the nodes of both sides on a mismatch
    (:func:`parity_evidence`);
14. mixed-precision sensitivity at full width, b8, 224², through
    ``sensitivity.pipeline.estimate_layer_costs``: first the HVP of
    ResNet-50 (b2 64², a CPU-calibrated model copied to the card) on the
    card against the CPU, per leaf within 1e-3 of the leaf's largest value;
    then for ResNet-50 and MobileNetV2 w1 (uniform8, seed 0) one
    calibration pass (``minmax_1pass`` per quantizer) and 4 Hutchinson
    probes, reverse-over-reverse through the QAT forward (``int8_conv_acc``,
    ``int8_matmul_acc``, D1's accumulator form), the launch counts set to 0
    before the calibration and read after it and after each probe, against
    the model's widths per kernel and per core; per probe ms, launches and
    peak memory beside a folded b8 train step's; a profiler trace of one
    probe; every distinct kernel call of a probe against its
    plain version; ResNet-50's 52 stage-conv traces
    and their Spearman rank correlation with the published ones; the ILP at
    bops and model_size 0.5; the bops config's QAT model (the same weights)
    calibrated on the card and frozen, served folded with the int16
    carrier: launches as the config predicts (4-bit layers on the packed
    int4 kernels), logits on the whole batch and an inner node equal to
    the CPU engine's, every recorded call against its plain version,
    ResNet-50's logits equal as integers to the QAT eval logits;
15. export: QONNX files of ResNet-50 uniform8, phase 14's generated
    config, ResNet-50 v2 uniform8, MobileNetV2 w1 and InceptionV3 w1
    uniform8 (full width), read back, every checked initializer equal to
    the FrozenModel tensor or the engine multiplier it came from, replayed
    by the numpy int64 interpreter on one image (64², InceptionV3 75²)
    bit-equal to the card engine's logits; the bundle of ResNet-50
    uniform8, its (m, e) rebuilding the engine's multipliers, its npz the
    model's tensors; export, load and replay times;
16. the deployment surface: ``python -m hawq_tpu_torch.deploy`` in a
    process of its own on ResNet-50 uniform8 b8 224² (synthetic weights,
    the auto route): top-5 of all 8 images equal to the CPU engine's,
    ``--time``, ``--export-onnx``; through ``deploy.main``, a capture of
    ``stage2.unit1.quant_act_int32`` on the host fold saved and "100%
    matched!" against the CPU engine's golden, MobileNetV2 w1 and
    InceptionV3 w1 on their routes, InceptionV3 also on the native fold,
    top-5 equal to the CPU engine's; the host preprocessing timed, native
    and numpy in turns where a function has both (``native_available``
    asserted); ``profile_engine`` on the main path and the bound of
    ``engine_flops_and_bytes``; the production-route readings (float32
    against folded_float32 input, b8 and b64, 20 runs a mode in turns);
    ``autotune_routing`` on ResNet-50 uniform4 b8 and ``autotune_routing_1x1``
    on MobileNetV2 w1 and InceptionV3 w1 uniform4 b8, the tables written
    under chiprun_out/ and served (with every site 'int4w' too for the two
    1×1 families): launches per kernel and per core as each table
    predicts, logits equal to the CPU engine's and to the unrouted card
    engine's, every recorded call against its plain version, each packed
    call timed beside its int8 twin; each table also routing
    ``image_dependent(fm)``, whose nodes all vary with the image: every node
    equal to the unrouted card engine's and the CPU engine's;
    ``deploy --frozen … --routing`` with a table; the seconds of each part;
17. a JSON line with phase 16's numbers, one with the kernels' numbers,
    then the result line.

Imports nothing of JAX or of the JAX package.
"""

import contextlib
import copy
import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# the run-output directory that .gitignore lists: evidence a failed check
# keeps (parity_evidence)
OUT_DIR = os.path.join(REPO, 'chiprun_out')
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor-core rate
BATCH, SIZE = 8, 224

# entry point → (kernel source, TPU kernel it replaces)
KERNELS = {
    'int8_conv_requant': ('hawq_tpu_torch/kernels/csrc/conv_sm90.cu',
                          'hawq_tpu/kernels/conv.py:228'),
    'int8_conv_acc': ('hawq_tpu_torch/kernels/csrc/conv_sm90.cu',
                      'hawq_tpu/kernels/conv.py:243'),
    'int8_matmul_requant': (
        'hawq_tpu_torch/kernels/csrc/matmul_requant_sm90.cu',
        'hawq_tpu/kernels/matmul.py:68'),
    'int8_matmul_acc': ('hawq_tpu_torch/kernels/csrc/matmul_sm90.cu',
                        'hawq_tpu/kernels/matmul.py:189'),
    'maxpool_folded': ('hawq_tpu_torch/kernels/csrc/pool.cu',
                       'hawq_tpu/kernels/pool.py:69'),
    'maxpool_folded_requant': ('hawq_tpu_torch/kernels/csrc/pool.cu',
                               'hawq_tpu/kernels/pool.py:69'),
    'int4w_matmul_requant': (
        'hawq_tpu_torch/kernels/csrc/matmul_int4_sm90.cu',
        'hawq_tpu/kernels/matmul.py:134'),
    'int4w_matmul_acc': ('hawq_tpu_torch/kernels/csrc/matmul_int4_sm90.cu',
                         'hawq_tpu/kernels/matmul.py:234'),
    'int4w_conv_requant': ('hawq_tpu_torch/kernels/csrc/conv_int4_sm90.cu',
                           'hawq_tpu/kernels/conv.py:254'),
    'int4w_conv_acc': ('hawq_tpu_torch/kernels/csrc/conv_int4_sm90.cu',
                       'hawq_tpu/kernels/conv.py:265'),
    'int8_matmul_requant_kblocked': (
        'hawq_tpu_torch/kernels/csrc/matmul_requant_sm90.cu',
        'hawq_tpu/kernels/matmul.py:322'),
    'minmax_1pass': ('hawq_tpu_torch/kernels/csrc/reduce.cu',
                     'hawq_tpu/kernels/reduce.py:63'),
    # D1: the TPU package has no Pallas kernel for the depthwise conv; it
    # runs XLA's grouped int8 conv or these nine shifted multiply-adds
    'int8_dwconv_requant': ('hawq_tpu_torch/kernels/csrc/depthwise.cu',
                            'hawq_tpu/inference/engine_mobilenet.py:42'),
    'int8_dwconv_acc': ('hawq_tpu_torch/kernels/csrc/depthwise.cu',
                        'hawq_tpu/inference/engine_mobilenet.py:42'),
    # A1: no Pallas kernel either; XLA's reduce_window, the truncating
    # division by 9 and the requant after it
    'int_avgpool3x3_requant': ('hawq_tpu_torch/kernels/csrc/avgpool.cu',
                               'hawq_tpu/inference/engine_inception.py:336'),
    # A1's quotient form (no requant): the window sum and the truncating
    # division alone, as the reference-checkpoint replay runs it
    'int_avgpool3x3': ('hawq_tpu_torch/kernels/csrc/avgpool.cu',
                       'hawq_tpu/inference/engine_inception.py:336'),
}
# the three kernels that no serving path launches: phase 3 (the standalone
# pool, at the main path's pre-pool tensor), 6 and 7 drive them
KBLOCKED, MINMAX = 'int8_matmul_requant_kblocked', 'minmax_1pass'
POOL, POOL_REQUANT = 'maxpool_folded', 'maxpool_folded_requant'
# D1's two forms: the MobileNetV2 engine's (phase 8) and the QAT forward's
# (phase 10)
DW_REQUANT, DW_ACC = 'int8_dwconv_requant', 'int8_dwconv_acc'
DW = (DW_REQUANT, DW_ACC)
# A1, the InceptionV3 engine's integer average pool (phase 11), and its
# quotient form, which the reference-checkpoint replay runs (phase 13)
AVGPOOL, AVGPOOL_Q = 'int_avgpool3x3_requant', 'int_avgpool3x3'
# the kernels on no ResNet serving path
SERVING_KERNELS = [k for k in KERNELS
                   if k not in (KBLOCKED, MINMAX, POOL, AVGPOOL, AVGPOOL_Q)
                   + DW]
TRAIN_BATCH = 32
# the phase that trains each arch through the Trainer
TRAIN_PHASE = {'resnet50': 7, 'mobilenetv2_w1': 10, 'resnet50v2': 10,
               'inceptionv3': 12}
# image sizes other than SIZE: InceptionV3 takes 299² (its card-against-CPU
# step 75², the smallest its reductions allow)
TRAIN_SIZE = {'inceptionv3': 299}
CARD_STEP_SIZE = {'inceptionv3': 75}
# InceptionV3 w1 serving (phase 11), 299², batch 8: (scheme, input mode,
# wide container); the first is this family's main path
INC_SIZE = 299
INC_PATHS = (('uniform8', 'folded_float32', torch.int32),
             ('uniform8', 'float32', torch.int32),
             ('uniform8', 'folded_float32', torch.int16),
             ('uniform4', 'folded_float32', torch.int32))
# the GEMM kernels the InceptionV3 engine runs
INC_GEMMS = ('int8_matmul_requant', 'int8_matmul_acc', 'int8_conv_requant',
             'int8_conv_acc')
# MobileNetV2 w1 serving (phase 8), 224², batch 8: (scheme, input mode,
# carrier); the first is this family's main path
MNV2_PATHS = (('uniform8', 'folded_float32', torch.int16),
              ('uniform8', 'float32', torch.int32),
              ('uniform4', 'folded_float32', torch.int16),
              ('bops_0.5', 'folded_float32', torch.int16))
# the kernels on the Hopper core (csrc/gemm_s8_sm90.cuh); the first core
# (csrc/gemm_s8.cuh) keeps the shapes their rule excludes, and is timed
# beside the new one
SM90_KERNELS = ('int8_conv_requant', 'int8_matmul_acc', 'int8_matmul_requant',
                'int4w_conv_requant', 'int8_conv_acc', 'int4w_conv_acc',
                'int4w_matmul_requant', 'int4w_matmul_acc', KBLOCKED)
POOLS = (POOL, POOL_REQUANT)
GEMM_KERNELS = [k for k in KERNELS
                if k not in POOLS + DW + (MINMAX, AVGPOOL, AVGPOOL_Q)]
# the kernels of their own (no GEMM core): launches counted on '@cuda'
OWN_CORE = DW + (AVGPOOL, AVGPOOL_Q)
# Reference-checkpoint replay (phase 13), batch 8, int32 carriers, 224²
# (InceptionV3 299²): (arch, scheme, input modes, the inner node held
# against the CPU engine); each model also with dyadic scales
REF_PATHS = (('resnet50', 'uniform8', ('folded_float32', 'float32'),
              'stage3.unit2.quant_act_int32'),
             ('resnet50', 'uniform4', ('folded_float32',),
              'stage3.unit2.quant_act_int32'),
             ('mobilenetv2', 'uniform8', ('float32',), 'final'),
             ('inceptionv3', 'uniform8', ('float32',),
              'features.stage2.unit1.q_rescaling_activ'))
# Phase 14: Hutchinson probes per model at b8 224²; the card HVP against the
# CPU HVP at this batch and image size
HVP_PROBES = 4
HVP_CHECK_BATCH, HVP_CHECK_SIZE = 2, 64
# Phase 15: the QONNX replay's image size (numpy int64, one image; the full
# size would take minutes), InceptionV3 the smallest its reductions allow
REPLAY_DEFAULT = 64
REPLAY_SIZE = {'inceptionv3': 75}
# the forms that compute the native requant: none launches in reference mode
FUSED_FORMS = ('int8_conv_requant', 'int4w_conv_requant',
               'int8_matmul_requant', 'int4w_matmul_requant', POOL_REQUANT,
               DW_REQUANT, AVGPOOL)

# The serving paths of phase 3, (arch, scheme), all folded input, int16
# carrier, batch 8, 224²; the first is the main path.  Each kernel is
# reported on the first path that launches it.
PATHS = (('resnet50', 'uniform8'), ('resnet50', 'uniform4'),
         ('resnet50', 'bops_0.5'), ('resnet18', 'uniform4'))

# (bottleneck, unit conv) → the kernel family and epilogue that runs it
_UNIT_CONV = {(True, 'quant_convbn1'): 'matmul_requant',
              (True, 'quant_convbn2'): 'conv_requant',
              (True, 'quant_convbn3'): 'matmul_acc',
              (True, 'quant_identity_convbn'): 'matmul_acc',
              (False, 'quant_convbn1'): 'conv_requant',
              (False, 'quant_convbn2'): 'conv_acc',
              (False, 'quant_identity_convbn'): 'matmul_acc'}


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def expected_inception_launches(fm, input_mode, reference=False,
                                routing=None):
    """Launches of one InceptionV3 engine forward, from the frozen model's
    widths and its bit config: each conv (the graph's walk,
    ``engine_inception.conv_input_nodes``) through the requant form where
    its ``q_activ`` has at most 8 bits, else the accumulator form — a 1×1
    through the matmul, a k×k through the conv (4·C, C filled to a multiple
    of 4, after a stride 2's space-to-depth); the folded stem's q_conv1
    through ``int8_conv_acc`` over the fold (C = 48, N = 4·32); A1 once for
    each pool branch; the FC through ``int8_matmul_acc``.  With a
    ``routing`` table a 1×1 with 4-bit weights and the requant form that
    the table routes to 'int4w' takes ``int4w_matmul_requant``.  With
    ``reference`` (``requant_mode='reference'``) every conv takes the
    accumulator form and every pool branch A1's quotient form."""
    from hawq_tpu_torch.inference.engine_inception import (
        conv_input_nodes, width_div_from_frozen)
    from hawq_tpu_torch.models import inceptionv3 as mi
    width_div = width_div_from_frozen(fm)
    stem = 'features.q_init_block.q_conv1'
    strides = {f'features.q_init_block.q_conv{c}': s
               for c, (_, _, s, _) in enumerate(mi.INIT_CONVS, start=1)}
    out = Launches()
    for _, _, unit in mi.units(width_div):
        for name, kind, kw in unit.branch_defs:
            bp = f'{unit.prefix}.branches.{name}'
            if kind == mi.AVG_POOL:
                out.add(AVGPOOL_Q if reference else AVGPOOL)
            for c, stride in enumerate(kw.get('strides', ()), start=1):
                strides[f'{bp}.q_conv_list.q_conv{c}'] = stride
    for key, _ in conv_input_nodes(width_div):
        if key == 'output.q_fc':
            out.add('int8_matmul_acc', 'matmul',
                    *fm[key + '.weight_int'].shape)
            continue
        kh, kw_, c, n = fm[key + '.q_convbn.weight_int'].shape
        acc = reference or fm.cfg.act_bits(key + '.q_activ') > 8
        if key == stem and input_mode == 'folded_float32':
            out.add('int8_conv_acc', 'conv_acc', 48, 4 * n)
        elif (kh, kw_) == (1, 1):
            site = key + '.q_convbn'
            if (not acc and routing is not None
                    and routing.get(site) == 'int4w'
                    and fm.cfg.weight_bits(site) == 4):
                out.add('int4w_matmul_requant', 'matmul_requant',
                        c + c % 2, n)
            else:
                out.add('int8_matmul_acc' if acc else 'int8_matmul_requant',
                        'matmul' if acc else 'matmul_requant', c, n)
        else:
            if strides.get(key, 1) == 2:
                c = 4 * (c + -c % 4)
            out.add('int8_conv_acc' if acc else 'int8_conv_requant',
                    'conv_acc' if acc else 'conv', c, n)
    return out


def avgpool_ragged_calls(dev):
    """A1 beside the path's shapes: H, W in {1, 2, 3, 5, 8, 17, 35} with C
    cycling through {1, 3, 4, 12, 32, 288}; int32, int16 and int8 inputs;
    inputs one element off alignment (one channel a thread); per-tensor and
    per-channel multipliers; 8-bit signed and 4-bit unsigned bounds;
    saturated ±32767; a constant −9 field (negative sums that are multiples
    of 9); odd quotients times 0.5 (requant products on a .5 boundary).
    Each of the H, W calls also with the requant in front (to 16 bits
    signed and unsigned, to 8 bits; per-tensor and per-channel), and a
    requant in front that drives every input to the ends of 16 bits (sums
    up to 9·65535, the bound of the kernel's integer quotient)."""
    from hawq_tpu_torch.quant.ops import np_dyadic_multiplier
    rng = np.random.RandomState(17)
    hws, cs = (1, 2, 3, 5, 8, 17, 35), (1, 3, 4, 12, 32, 288)
    dtypes = ((torch.int32, 32768), (torch.int16, 32768), (torch.int8, 128))
    fronts = ((16, True), (16, False), (8, True))
    calls = []

    def call(x, mult, bits=8, signed=True, front=None):
        kw = dict(out_bits=bits, signed=signed)
        if front is not None:
            in_mult, in_bits, in_signed = front
            kw.update(in_mult=torch.tensor(np.asarray(in_mult, np.float32),
                                           device=dev),
                      in_bits=in_bits, in_signed=in_signed)
        calls.append((AVGPOOL, (x, torch.tensor(np.asarray(mult, np.float32),
                                                device=dev)), kw))
    for i, h in enumerate(hws):
        for j, w in enumerate(hws):
            c = cs[(i + j) % len(cs)]
            dtype, hi = dtypes[(i + 2 * j) % 3]
            in_bits, in_signed = fronts[(i + j) % 3]
            x = torch.tensor(rng.randint(-hi, hi, (2, h, w, c)), dtype=dtype,
                             device=dev)
            scale = 64.0 if dtype == torch.int8 else 1.0
            base = (100.0 if dtype == torch.int8 else 1.0) * (
                1 / 64 if in_bits == 8 else 1.0)
            rescale = np.float32((16.0 if in_bits == 8 else 1.0) / scale)
            per_t = np_dyadic_multiplier(np.float32(
                scale * (rng.rand() * 0.01 + 0.002)))
            call(x, per_t)
            call(x, per_t * rescale, front=(np_dyadic_multiplier(
                np.float32(base * (rng.rand() * 1.5 + 0.25))), in_bits,
                in_signed))
            if (i + j) % 2:                    # one element off alignment
                flat = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
                flat[1:] = x.reshape(-1)
                x = flat[1:].view(x.shape)
            per_c = np_dyadic_multiplier((scale * (
                rng.rand(c) * 0.01 + 0.002)).astype(np.float32))
            call(x, per_c, 4, False)
            call(x, per_c * rescale, 4, False,
                 (np_dyadic_multiplier((base * (rng.rand(c) * 1.5 + 0.25))
                                       .astype(np.float32)), in_bits,
                  in_signed))
    x = torch.full((2, 5, 7, 8), -32767, dtype=torch.int32, device=dev)
    x[:, 2, 3, ::2] = 32767
    call(x, np.float32(2 ** -12))
    call(x.to(torch.int16), np.float32(2 ** -8))
    call(torch.full((1, 4, 5, 4), -9, dtype=torch.int32, device=dev),
         np.float32(1.0))
    call(torch.full((1, 4, 5, 4), -9, dtype=torch.int32, device=dev),
         np.float32(1.0), front=(np.float32(1.0), 16, True))
    p = torch.arange(1, 128, 2, dtype=torch.int16, device=dev)
    call(p.expand(1, 3, 3, p.numel()).contiguous(), np.float32(0.5))
    for dtype in (torch.int32, torch.int16, torch.int8):
        top = torch.iinfo(dtype).max
        x = torch.full((2, 5, 7, 12), top, dtype=dtype, device=dev)
        x[:, 2, 3, ::2] = -top
        x[1] = -x[1]
        sat = np.float32(2 ** 20 / min(top, 32767))
        for in_signed in (True, False):
            call(x, np.float32(2 ** -9), front=(sat, 16, in_signed))
            call(x, np.float32(2 ** -13), 4, False, (np.where(
                np.arange(12) % 2, sat, np.float32(0.5)).astype(np.float32),
                16, in_signed))
    return calls


def avgpool_front(kw):
    """The keyword arguments of A1's requant in front in ``kw``."""
    return {k: kw[k] for k in ('in_mult', 'in_bits', 'in_signed') if k in kw}


def avgpool_tile(args, kw=None):
    """(the plan A1's wrapper launches for a call, a short label of it)."""
    from hawq_tpu_torch.kernels import avgpool as ka
    plan = ka.call_plan(args[0], (kw or {}).get('plan'))
    b, h, w, c = args[0].shape
    return plan, (f'{plan.vec}ch/thr copy{plan.copy} {plan.th}x{plan.tw}px '
                  f'x{plan.cs * plan.vec}ch '
                  f'{ka.avgpool_grid(plan, b, h, w, c)}tiles '
                  f'{plan.cs * plan.tw}thr '
                  f'{ka.avgpool_smem(plan, args[0].dtype) // 1024}KB')


def avgpool_call_table(rows):
    """A1's per-call table: µs by graph replay in L2 and streamed from
    device memory, the bound, the share of it, ``F.avg_pool2d``'s µs, the
    tile."""
    log('  A1 per call: shape | launches | us in L2 | us streamed | bound us '
        '| share | F.avg_pool2d us | tile')
    for r in rows:
        log(f"    {r['shape']:24s} x{r['n']:<2d} {r['ms'] * 1e3:7.2f} "
            f"{r['cold_ms'] * 1e3:7.2f} {r['bound_ms'] * 1e3:7.3f} "
            f"{r['bound_ms'] / r['ms']:6.1%} {r['library_ms'] * 1e3:8.2f}  "
            f"{r['tiles']}")


def unfused_avgpool(args, kw):
    """A1's call as the engine made it before the fusion: the requant in
    front as ``requant_int32`` into the engine's container (x's dtype, int8
    for 8 bits), then A1 without it."""
    from hawq_tpu_torch.kernels import avgpool as ka
    from hawq_tpu_torch.quant.ops import requant_int32
    front = avgpool_front(kw)
    x = requant_int32(args[0], front['in_mult'], front['in_bits'],
                      front['in_signed'], torch.int8
                      if front['in_bits'] <= 8 else args[0].dtype)
    return ka.int_avgpool3x3_requant(x, args[1], out_bits=kw['out_bits'],
                                     signed=kw['signed'])


@contextlib.contextmanager
def unfused_pool_branch():
    """Inside, the InceptionV3 engine runs its pool branches as before the
    fusion (:func:`unfused_avgpool`)."""
    from hawq_tpu_torch.kernels import avgpool as ka
    fused = ka.int_avgpool3x3_requant

    def unfused(x, mult, **kw):
        ka.int_avgpool3x3_requant = fused
        try:
            return unfused_avgpool((x, mult), kw)
        finally:
            ka.int_avgpool3x3_requant = unfused
    ka.int_avgpool3x3_requant = unfused
    try:
        yield
    finally:
        ka.int_avgpool3x3_requant = fused


def avgpool_fusion_turns(calls, phase):
    """Each distinct A1 call of the path (requant in front) timed in turns
    by graph replay — the fused call, the unfused pair, the plain version,
    ``F.avg_pool2d`` (the sum only) and ``x.to(torch.int8)`` (PyTorch's
    elementwise pass over the same bytes: x read once, a byte an element
    written), then the same in reverse — the pair held equal to the fused
    call → the sums over the path's launches."""
    seen = {}
    for name, args, kw in calls:
        seen.setdefault(call_key(name, args, kw), [args, kw, 0])[2] += 1
    runs = ('fused', 'unfused', 'plain', 'library', 'elementwise')
    total = dict.fromkeys(runs, 0.0)
    log(f'{phase}: A1 fused / unfused pair / plain / F.avg_pool2d / '
        f'x.to(int8), us by graph replay in turns:')
    for args, kw, n in seen.values():
        check(same(unfused_avgpool(args, kw), kernel_call(AVGPOOL, args, kw)),
              f'{AVGPOOL}: the unfused pair differs from the fused call')
        fns = {'fused': lambda: kernel_call(AVGPOOL, args, kw, False),
               'unfused': lambda: unfused_avgpool(args, kw),
               'plain': lambda: plain_call(AVGPOOL, args, kw, False),
               'library': library_call(AVGPOOL, args, kw),
               'elementwise': lambda: args[0].to(torch.int8)}
        ms = {r: [] for r in runs}
        for r in runs + runs[::-1]:
            ms[r].append(graph_ms(fns[r], 3 if r == 'plain' else 20))
        mean = {r: sum(v) / len(v) for r, v in ms.items()}
        for r in runs:
            total[r] += mean[r] * n
        log(f'  {work(AVGPOOL, args, kw, fns["fused"]())[2]:24s} x{n}: '
            + ', '.join(f'{r} {mean[r] * 1e3:.2f}' for r in runs))
    log(f'{phase}: A1 over the path\'s launches: ' + ', '.join(
        f'{r} {total[r]:.4f} ms' for r in runs))
    return total


def avgpool_alternatives(plan, args):
    """Plans beside the rule's for one A1 call: the whole height, half and
    twice the rule's rows, the whole width, half and twice the channel
    slab, copies of one word, one channel a thread, and a grid of column
    shares (whole, half), row shares (whole, 1/2, 1/3, 1/4, 4 and 2 rows)
    and slabs (64–512 threads) — those the shape, the pointer and the
    kernel's limits allow."""
    from hawq_tpu_torch.kernels import avgpool as ka
    x = args[0]
    b, h, w, c = x.shape
    es = x.element_size()
    alts = [plan._replace(th=h), plan._replace(th=max(1, plan.th // 2)),
            plan._replace(th=min(h, 2 * plan.th)),
            plan._replace(tw=w, cs=max(1, plan.cs * plan.tw // w)),
            plan._replace(cs=plan.cs // 2), plan._replace(cs=plan.cs * 2)]
    if plan.vec == 4 and plan.copy == 16 and es < 4:
        alts.append(plan._replace(copy=4 * es))
    if plan.vec == 4:
        alts.append(plan._replace(vec=1, copy=es, cs=plan.cs * 4,
                                  tw=max(1, plan.tw // 4)))
    if plan.vec == 4:
        units = c // 4
        for tw in sorted({w, -(-w // 2)}):
            slabs = [d for d in range(1, units + 1)
                     if units % d == 0 and 64 <= tw * d <= ka.AP_THREADS]
            for cs in slabs[::max(1, len(slabs) // 4)]:
                for th in sorted({h, -(-h // 2), -(-h // 3), -(-h // 4),
                                  min(h, 4), min(h, 2)}):
                    alts.append(plan._replace(cs=cs, tw=tw, th=th))
    seen, out = {plan}, []
    for a in alts:
        wpc = a.copy // (4 * es) if a.vec == 4 else 1
        units = c // a.vec
        if (a not in seen and a.cs >= 1 and units % a.cs == 0
                and a.cs % wpc == 0 and a.cs * a.tw <= ka.AP_THREADS
                and ka.avgpool_smem(a, x.dtype) <= ka.AP_SMEM):
            seen.add(a)
            out.append(a)
    return out


def avgpool_plan_sweep(calls, phase):
    """Each distinct A1 call of a path at the rule's plan and at its
    alternatives (:func:`avgpool_alternatives`), each held against the
    plain version, then timed in turns (rule, alternatives, alternatives in
    reverse, rule) by graph replay; logs the sums over the path's launches
    at the rule's plans and at the fastest plan of each call."""
    seen = {}
    for name, args, kw in calls:
        seen.setdefault(call_key(name, args, kw), [args, kw, 0])[2] += 1
    rule_sum, best_sum = 0.0, 0.0
    log(f'{phase}: A1 tile choices, us by graph replay (rule first):')
    for args, kw, n in seen.values():
        plan, label = avgpool_tile(args)
        want = plain_call(AVGPOOL, args, kw)
        plans = [plan] + avgpool_alternatives(plan, args)
        for p in plans[1:]:
            check(same(kernel_call(AVGPOOL, args, dict(kw, plan=p)), want),
                  f'{AVGPOOL} at {p} differs from its plain version')
        ms = {p: [] for p in plans}
        for p in plans + plans[:0:-1] + [plan]:
            ms[p].append(graph_ms(
                lambda: kernel_call(AVGPOOL, args, dict(kw, plan=p), False),
                20))
        mean = {p: sum(v) / len(v) for p, v in ms.items()}
        rule_sum += mean[plan] * n
        best_sum += min(mean.values()) * n
        b, h, w, c = args[0].shape
        log(f'  B{b} {h}x{w} C{c} x{n}: rule {label} {mean[plan] * 1e3:.2f}; '
            + '; '.join(f'v{p.vec} copy{p.copy} cs{p.cs} tw{p.tw} th{p.th} '
                        f'{mean[p] * 1e3:.2f}' for p in plans[1:]))
    log(f'{phase}: A1 over the path\'s launches: rule {rule_sum:.4f} ms, '
        f'the fastest plan of each call {best_sum:.4f} ms')


def inception_phase(dev, errs, totals):
    """Phase 11: InceptionV3 w1 serving at full width, 299², batch 8, on
    synthetic weights (seed 0): the paths of ``INC_PATHS``, each against the
    CPU engine and its predicted launches; every kernel call of the first
    (the main path) and A1's ragged calls held against their plain
    versions; A1 timed on the main path (into ``totals``) in L2 and streamed
    from device memory, beside its bound, its plain version and
    ``F.avg_pool2d``; the four GEMM kernels timed on the main path; a trace
    of its forward → (the main path's launches per kernel, the GEMM kernels'
    totals on it)."""
    from hawq_tpu_torch.configs.bit_config import get_bit_config
    from hawq_tpu_torch.inference.engine_inception import (
        build_inceptionv3_engine)
    from hawq_tpu_torch.inference.fold import fold4_images_3x3s2
    from hawq_tpu_torch.inference.synthetic import synthetic_frozen_inception
    raw = np.random.RandomState(3).randn(BATCH, INC_SIZE, INC_SIZE, 3).astype(
        np.float32)
    images = {'float32': torch.from_numpy(raw).to(dev),
              'folded_float32': torch.from_numpy(
                  fold4_images_3x3s2(raw, 0)).to(dev)}
    fms, main = {}, None
    for scheme, mode, wide in INC_PATHS:
        if scheme not in fms:
            fms[scheme] = synthetic_frozen_inception(
                get_bit_config('inceptionv3', scheme), seed=0)
        fm = fms[scheme]
        want = expected_inception_launches(fm, mode)
        label = f'inceptionv3 {scheme} {mode} {wide}'
        calls = [] if main is None else None
        nodes = (('init', 'features.stage2.unit1.q_rescaling_activ')
                 if main is None else ('init',))
        eng, counts = engine_check(
            functools.partial(build_inceptionv3_engine, fm, input_mode=mode,
                              wide_dtype=wide,
                              input_hw=(INC_SIZE, INC_SIZE)),
            images[mode], want.counts, want.cores, nodes, label, dev,
            'phase 11', calls)
        if main is None:
            main = (eng, images[mode], calls, want, counts, label)
    eng, x, calls, want, counts, label = main
    check(want.counts[AVGPOOL] == 9
          and sum(want.counts.values()) == 9 + 95
          and not [k for k in want.cores if k.endswith('@mma')],
          f'{label}: predicted {want.counts}, per core {want.cores}')
    ragged = avgpool_ragged_calls(dev)
    check_calls(calls + ragged, errs, f'phase 11: all {len(calls)} recorded '
                f'calls of {label} and {len(ragged)} ragged A1 calls')
    a1 = [c for c in calls if c[0] == AVGPOOL]
    check(all('in_mult' in kw for _, _, kw in a1), f'{label}: a pool branch '
          f'without its requant in front')
    log(f'phase 11: timed {AVGPOOL} on {label}:')
    time_calls(a1, totals)
    totals[AVGPOOL].update(avgpool_fusion_turns(a1, 'phase 11'))
    avgpool_plan_sweep(a1, 'phase 11')
    gemm_totals = {}
    log(f'phase 11: timed the GEMM kernels on {label}:')
    time_calls([c for c in calls if c[0] in INC_GEMMS], gemm_totals)
    trace = trace_breakdown(eng, x, label, 'phase 11')
    if trace:
        port = {k: v for k, v in trace[3].items() if k.startswith('port')}
        log(f'phase 11: {label}: {trace[0]} kernels per forward, port '
            f'kernels ' + ', '.join(f'{k[6:]} x{c} {t / 1e3:.4f} ms'
                                    for k, (c, t) in sorted(port.items()))
            + f'; glue (non-port kernels) {trace[2]:.4f} ms')
        totals[AVGPOOL]['kernels_per_forward'] = trace[0]
    pool_branch_before_after(eng, x, label, trace, totals[AVGPOOL])
    return counts, gemm_totals


def pool_branch_before_after(eng, x, label, after, a1_totals):
    """The main path with its pool branches as before the fusion (the
    input requant as PyTorch glue, then A1) and as they are: equal logits,
    kernels per forward and glue time from a trace of each, ms per batch of
    each in turns (fused, unfused, unfused, fused; CUDA events / host
    clock)."""
    want = eng(x)
    with unfused_pool_branch():
        check(torch.equal(eng(x), want), f'{label}: the unfused pool branch '
              f'changes the logits')
        before = trace_breakdown(eng, x, f'{label} with the pool branch\'s '
                                 f'input requant as glue', 'phase 11')
    if before and after:
        a1_totals['kernels_per_forward_unfused'] = before[0]
        log(f'phase 11: {label}: pool branches before / after the fusion: '
            f'{before[0]} / {after[0]} kernels per forward, glue (non-port '
            f'kernels) {before[2]:.4f} / {after[2]:.4f} ms, port kernels '
            f'{before[1]:.4f} / {after[1]:.4f} ms')

    def ms_per_batch():
        event = cuda_ms(lambda: eng(x), 20)
        t0 = time.perf_counter()
        for _ in range(10):
            eng(x)
        torch.cuda.synchronize()
        return event, (time.perf_counter() - t0) / 10 * 1e3
    rows = []
    for form in ('fused', 'unfused', 'unfused', 'fused'):
        with (unfused_pool_branch() if form == 'unfused'
              else contextlib.nullcontext()):
            rows.append((form,) + ms_per_batch())
    log(f'phase 11: {label}: ms/batch (CUDA events / host clock) in turns: '
        + ', '.join(f'{f} {e:.3f} / {h:.3f}' for f, e, h in rows))


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Device time of ``fn`` without the host's launch cost: ``reps`` calls
    captured into one CUDA graph, replayed and timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ms = cuda_ms(graph.replay, 5) / reps
    del graph
    return ms


def cold_ms(fn, args, reps):
    """Device time of ``fn(*args)`` with its inputs streamed from device
    memory, not L2: copies of the tensor arguments that together fill twice
    the L2 (at least two), one call on each in turn, ``reps`` rounds
    captured into one CUDA graph (:func:`graph_ms`), per call."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    l2 = getattr(torch.cuda.get_device_properties(tensors[0].device),
                 'L2_cache_size', 50 << 20)
    copies = max(2, -(-2 * l2 // nbytes))
    sets = [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                  for a in args) for _ in range(copies)]

    def each():
        for one in sets:
            fn(*one)
    ms = graph_ms(each, reps) / copies
    del sets
    return ms


# ---------------------------------------------------------------------------
# phase 3 helpers: recording, plain versions, bounds
# ---------------------------------------------------------------------------

def expected_launches(arch, cfg, input_mode, reference=False, routing=None):
    """Kernel launches of one engine forward, from the arch and the bit
    config: the init conv (int8), the folded init's requant + pool, each
    unit conv by its place in the unit and its weight bits (``int4w_*`` for
    4-bit weights; with a ``routing`` table, for 4-bit weights the table
    routes to 'int4w'), and the FC (int8).  With ``reference``
    (``requant_mode='reference'``) every unit conv takes its accumulator
    form and the folded init the standalone pool."""
    from hawq_tpu_torch.configs.bit_config import (RESNET_CONVS_PER_UNIT,
                                                   resnet_layer_keys)
    bottleneck = RESNET_CONVS_PER_UNIT[arch] == 3
    counts = {'int8_conv_acc': 1, 'int8_matmul_acc': 1}
    if input_mode.startswith('folded'):
        counts[POOL if reference else POOL_REQUANT] = 1
    for key in resnet_layer_keys(arch):
        conv = key.rsplit('.', 1)[-1]
        if not key.startswith('stage') or 'convbn' not in conv:
            continue
        form = _UNIT_CONV[bottleneck, conv]
        int4 = cfg.weight_bits(key) == 4 and (
            routing is None or routing.get(key) == 'int4w')
        name = (('int4w_' if int4 else 'int8_')
                + (form.replace('_requant', '_acc') if reference else form))
        counts[name] = counts.get(name, 0) + 1
    return counts


def core_split(counts):
    """Launches per GEMM core that go with launches per kernel, where every
    call of the Hopper core's kernels (``SM90_KERNELS``) has widths that
    core takes (all full-width ResNets): those on 'sm90', every other GEMM
    kernel on 'mma'."""
    return {f"{k}@{'sm90' if k in SM90_KERNELS else 'mma'}": v
            for k, v in counts.items() if k in GEMM_KERNELS and v}


def core_launches():
    from hawq_tpu_torch.kernels import _build
    return {k: v for k, v in _build.CORE_LAUNCHES.items() if v}


class Launches:
    """Predicted launches per kernel and per core ('name@core': for a GEMM
    kernel the core the Hopper core's rule names for the call's widths,
    'cuda' for D1 and A1)."""

    def __init__(self):
        self.counts, self.cores = {}, {}

    def add(self, name, kind=None, k=0, n=0):
        from hawq_tpu_torch.kernels import matmul as km
        self.counts[name] = self.counts.get(name, 0) + 1
        core = ('cuda' if name in OWN_CORE else None if kind is None else
                'sm90' if km.sm90_route(kind, k=k, n=n, ptr=0) is None
                else 'mma')
        if core is not None:
            key = f'{name}@{core}'
            self.cores[key] = self.cores.get(key, 0) + 1
        return self


def expected_mobilenet_launches(fm, input_mode, reference=False,
                                routing=None):
    """Launches of one MobileNetV2 engine forward, from the frozen model's
    widths: the init conv (the fold's C = 48, N = 4·32, or the raw image's
    space-to-depth C = 16), every 1×1 conv (conv1, conv3, the final block,
    the head) through ``int8_matmul_acc`` — with a ``routing`` table, a
    conv1 / conv3 / final block with 4-bit weights that it routes to
    'int4w' through ``int4w_matmul_acc`` (K padded to even) — every
    depthwise conv2 through D1's requant form (with ``reference``, its
    accumulator form)."""
    n = fm['init_block.weight_int'].shape[-1]
    out = Launches().add('int8_conv_acc', 'conv_acc',
                         *((48, 4 * n) if input_mode.startswith('folded')
                           else (16, n)))
    for key, w in fm.tensors.items():
        if key.endswith('.conv2.weight_int'):
            out.add(DW_ACC if reference else DW_REQUANT)
        elif key.endswith('.weight_int') and key != 'init_block.weight_int':
            site = key[:-len('.weight_int')]
            k = w.shape[2]
            if (routing is not None and routing.get(site) == 'int4w'
                    and fm.cfg.weight_bits(site) == 4 and site != 'output'):
                out.add('int4w_matmul_acc', 'matmul', k + k % 2, w.shape[3])
            else:
                out.add('int8_matmul_acc', 'matmul', k, w.shape[3])
    return out


def expected_v2_launches(fm):
    """Launches of one bottleneck ResNet v2 engine forward (the one this
    script drives), from the frozen model's widths: the init conv
    (space-to-depth, C = 16); each unit's conv1 through
    ``int8_matmul_requant``, its 3×3 through ``int8_conv_requant``, conv3
    and the identity conv through ``int8_matmul_acc``; the FC."""
    kernel = {'quant_conv1': ('int8_matmul_requant', 'matmul_requant'),
              'quant_conv2': ('int8_conv_requant', 'conv'),
              'quant_conv3': ('int8_matmul_acc', 'matmul'),
              'quant_identity_conv': ('int8_matmul_acc', 'matmul')}
    out = Launches().add('int8_conv_acc', 'conv_acc', 16,
                         fm['quant_init_conv.weight_int'].shape[-1])
    for key, w in fm.tensors.items():
        if key.startswith('stage') and key.endswith('.weight_int'):
            out.add(*kernel[key.split('.')[2]], w.shape[2], w.shape[3])
    w = fm['quant_output.weight_int']
    return out.add('int8_matmul_acc', 'matmul', w.shape[0], w.shape[1])


def sm90_rule(name, args, kw):
    """The clause of the Hopper core's shape rule that excludes a call of
    one of its kernels, None where the core takes it."""
    from hawq_tpu_torch.kernels import matmul as km
    w = args[1]
    n = w.n if isinstance(w, km.PreparedWeights) else w.shape[1]
    if '_conv' in name:
        return km.sm90_route('conv_acc' if name.endswith('acc') else 'conv',
                             k=kw['cin'], n=n, ptr=args[0].data_ptr())
    kind = 'matmul_requant' if '_requant' in name else 'matmul'
    reason = km.sm90_route(kind, k=args[0].shape[1], n=n,
                           ptr=args[0].data_ptr())
    if name == KBLOCKED and reason is None and (kw.get('k_splits') or 1) > 1:
        return 'k_splits > 1'
    return reason


def cores_by_rule(calls):
    """Launches per core that the rule names for recorded calls (D1 and A1
    have their own)."""
    out = {}
    for name, args, kw in calls:
        if name in GEMM_KERNELS + list(OWN_CORE):
            core = ('cuda' if name in OWN_CORE else 'sm90'
                    if name in SM90_KERNELS
                    and sm90_rule(name, args, kw) is None else 'mma')
            out[f'{name}@{core}'] = out.get(f'{name}@{core}', 0) + 1
    return out


@contextlib.contextmanager
def first_core():
    """Inside, the Hopper core's rule excludes every call, so engines built
    and run here keep plain weights and run on csrc/gemm_s8.cuh alone."""
    from hawq_tpu_torch.kernels import matmul as km
    rule = km.sm90_route
    km.sm90_route = lambda kind, *, k, n, ptr: 'switched off'
    try:
        yield
    finally:
        km.sm90_route = rule


def kernel_modules():
    from hawq_tpu_torch.kernels import (avgpool, conv, depthwise, matmul,
                                        pool, reduce)
    return {name: (pool if name in POOLS else
                   avgpool if name in (AVGPOOL, AVGPOOL_Q) else
                   reduce if name == MINMAX else
                   depthwise if name in DW else
                   conv if '_conv' in name else matmul) for name in KERNELS}


def shapes_only(args):
    """Tensors replaced by storage-free stand-ins of their shape and dtype."""
    return tuple(torch.empty_like(a, device='meta')
                 if isinstance(a, torch.Tensor) else a for a in args)


@contextlib.contextmanager
def recording(calls, keep=lambda args: args):
    """Record every kernel-wrapper call while a path runs: its inputs, or
    with ``keep=shapes_only`` only their shapes and dtypes."""
    mods = kernel_modules()
    orig = {name: getattr(mod, name) for name, mod in mods.items()}

    def recorder(name):
        def call(*args, **kw):
            calls.append((name, keep(args), kw))
            return orig[name](*args, **kw)
        return call
    for name, mod in mods.items():
        setattr(mod, name, recorder(name))
    try:
        yield
    finally:
        for name, mod in mods.items():
            setattr(mod, name, orig[name])


def unpacked_weights(name, args, kw):
    """The int8 (K, N) weights of a call: its own (out of their handle), or
    its packed int4 unpacked."""
    from hawq_tpu_torch.kernels import conv as kc
    from hawq_tpu_torch.kernels import matmul as km
    w = first_core_weights(args[1])
    if name.startswith('int4w_matmul'):
        return km.unpack_int4(w)
    if name.startswith('int4w_conv'):
        return kc.unpack_int4_conv(w, kw['taps'][0] * kw['taps'][1])
    return w


def first_core_weights(w):
    """The weights as csrc/gemm_s8.cuh reads them: the (K, N) tensor, or the
    packed (K/2, N) bytes, out of a Hopper-core handle."""
    from hawq_tpu_torch.kernels import matmul as km
    return km.unprepare_weights(w) if isinstance(w, km.PreparedWeights) else w


def hopper_core_weights(name, w, kw):
    """The weights as csrc/gemm_s8_sm90.cuh reads them: their handle, laid
    out as the wrapper lays out plain weights (a conv's for the call's
    geometry, ``kw``)."""
    from hawq_tpu_torch.kernels import conv as kc
    from hawq_tpu_torch.kernels import matmul as km
    if isinstance(w, km.PreparedWeights):
        return w
    if '_conv' in name:
        return kc.prepare_conv_weights(w, kw['taps'], kw['cin'],
                                       kw.get('pad', (0, 0)),
                                       name.startswith('int4w'))
    return (km.prepare_weights_int4(w) if name.startswith('int4w')
            else km.prepare_weights(w))


def plain_call(name, args, kw, stack=True):
    from hawq_tpu_torch.inference.fold import maxpool_3x3s2p1_folded
    from hawq_tpu_torch.kernels import depthwise as kd
    from hawq_tpu_torch.kernels import pool as kp
    from hawq_tpu_torch.kernels import reduce as kr
    if name == POOL:
        return maxpool_3x3s2p1_folded(*args)
    if name == POOL_REQUANT:
        return kp.maxpool_folded_requant_plain(
            *args, kw['out_bits'], kw['signed'], kw['relu'], kw['out_dtype'])
    if name == MINMAX:
        out = kr.minmax_plain(*args)
        return torch.stack(out) if stack else out
    if name == DW_ACC:
        return kd.dwconv_acc_plain(*args, kw['stride'])
    if name == DW_REQUANT:
        return kd.dwconv_requant_plain(*args, kw['stride'], kw['lo'],
                                       kw['hi'])
    if name == AVGPOOL:
        from hawq_tpu_torch.kernels.avgpool import avgpool3x3_requant_plain
        return avgpool3x3_requant_plain(*args, kw['out_bits'], kw['signed'],
                                        **avgpool_front(kw))
    if name == AVGPOOL_Q:
        from hawq_tpu_torch.kernels.avgpool import avgpool3x3_plain
        return avgpool3x3_plain(*args)
    args = (args[0], unpacked_weights(name, args, kw)) + tuple(args[2:])
    return plain_gemm_call(name, args, kw)


def plain_gemm_call(name, args, kw):
    """The plain version of a GEMM kernel on unpacked (K, N) weights."""
    from hawq_tpu_torch.kernels import conv as kc
    from hawq_tpu_torch.kernels import matmul as km
    geo = {k: kw[k] for k in ('taps', 'out_hw', 'cin') if k in kw}
    if kw.get('pad', (0, 0)) != (0, 0):      # the border the kernel supplies
        args = (kc.pad_conv_input(args[0], kw['pad'], **geo),) + args[1:]
    if name.endswith('matmul_acc'):
        return km.matmul_acc_plain(*args)
    if name.endswith('conv_acc'):
        return kc.conv_acc_plain(*args, **geo)
    lo, hi = km.epilogue_bounds(kw.get('out_bits', 8), kw.get('signed', True),
                                kw.get('relu', False))
    if '_matmul_requant' in name:
        return km.matmul_requant_plain(*args, lo, hi)
    return kc.conv_requant_plain(*args, lo=lo, hi=hi, **geo)


def kernel_call(name, args, kw, stack=True):
    """The wrapper's result; the (min, max) pair stacked into one tensor
    unless ``stack`` is off (the timed calls)."""
    out = getattr(kernel_modules()[name], name)(*args, **kw)
    return torch.stack(out) if name == MINMAX and stack else out


def work(name, args, kw, out):
    """(bytes moved, int8 ops, a short shape label) of one call: each input
    read once as passed (int4 weights packed), each output written once;
    the operations over the unpacked K (taps·C for the conv, x's K for the
    matmul)."""
    from hawq_tpu_torch.kernels.matmul import PreparedWeights
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *kw.values())
                 if isinstance(t, torch.Tensor))
    nbytes += out.numel() * out.element_size()
    if name in POOLS + (MINMAX,):
        return nbytes, 0, 'x' + 'x'.join(map(str, args[0].shape))
    if name in (AVGPOOL, AVGPOOL_Q):   # 9 adds, a division, the requants
        return nbytes, 0, ('x' + 'x'.join(map(str, args[0].shape)) + ' '
                           + str(args[0].dtype).replace('torch.', '')
                           + (' +front' if 'in_mult' in kw else ''))
    if name in DW:                  # 9 multiply-adds an output
        b, h, w, c = args[0].shape
        return (nbytes, 2 * 9 * out.numel(),
                f'B{b} {h}x{w} C{c} stride {kw["stride"]}')
    if isinstance(args[1], PreparedWeights):   # counted unpadded, as passed
        n = args[1].n                          # to the reference: (K, N), or
        nbytes += args[1].k * n // (2 if args[1].int4 else 1)   # (K/2, N)
    else:
        n = args[1].shape[1]
    if '_matmul' in name:
        m, k = args[0].shape
        return nbytes, 2 * m * k * n, f'M{m} K{k} N{n}'
    b = args[0].shape[0]
    h, w = kw['out_hw']
    kh, kw_ = kw['taps']
    return (nbytes, 2 * b * h * w * kh * kw_ * kw['cin'] * n,
            f'B{b} {h}x{w} taps{kh}x{kw_} C{kw["cin"]} N{n}'
            + (' unpadded' if kw.get('pad', (0, 0)) != (0, 0) else ''))


def library_call(name, args, kw):
    """One PyTorch call over the same inputs as the yardstick, where one
    exists: torch._int_mm (int8 → int32 product, without bias or requant;
    int4 weights unpacked to int8 before the timing) under its shape
    rules, M ≤ 16 (the FC's 8 rows) with x zero-padded to 32 rows, whose
    first M rows of the product are the same integers, and None where
    cuBLASLt refuses the shape; torch.aminmax for
    the min/max.  None elsewhere (PyTorch has no int8 conv and no
    folded-layout pool); for D1 cuDNN's float32 grouped convolution (groups
    = C, TF32 off) on the same values, converted before the timing, which
    is exact here (|acc| < 9·128·128 + |bias| ≪ 2²⁴); for A1
    ``F.avg_pool2d`` with ``divisor_override=1`` (the window sum, without
    the division and requant) on float32, converted before the timing,
    exact here (|sum| ≤ 9·32767 < 2²⁴)."""
    if name == MINMAX:
        return lambda: torch.aminmax(args[0])
    if name in (AVGPOOL, AVGPOOL_Q):
        xf = args[0].permute(0, 3, 1, 2).float().contiguous(
            memory_format=torch.channels_last)
        return lambda: torch.nn.functional.avg_pool2d(xf, 3, 1, 1,
                                                      divisor_override=1)
    if name in DW:
        return cudnn_depthwise(args[0], args[1], args[2], kw['stride'])
    if '_conv' in name:
        return cudnn_conv(name, args, kw)
    if '_matmul' not in name:
        return None
    x, w = args[0], unpacked_weights(name, args, kw)
    (m, k), n = x.shape, w.shape[1]
    if k % 8 or n % 8 or k < 16:
        return None
    if m <= 16:
        x = torch.cat([x, x.new_zeros((32 - m, k))])

    def run():
        return torch._int_mm(x, w)
    try:
        run()
    except RuntimeError:        # cuBLASLt refuses some shapes (K 64, N 80)
        return None
    return run


def cudnn_conv(name, args, kw):
    """cuDNN's float32 convolution (TF32 off) over a conv kernel's inputs:
    the padded slab (NHWC in memory) and the weights unpacked to int8 (N,
    C, kh, kw), with the bias, converted before the timing — the product
    alone, without the requant, as ``torch._int_mm`` stands beside the
    matmuls.  Exact only while |acc| < 2²⁴ (a float32 sum); the yardstick
    is its time, not its values."""
    from hawq_tpu_torch.kernels import conv as kc
    from hawq_tpu_torch.nn.layers import faithful_float_math
    geo = {k: kw[k] for k in ('taps', 'out_hw', 'cin')}
    x = args[0]
    if kw.get('pad', (0, 0)) != (0, 0):
        x = kc.pad_conv_input(x, kw['pad'], **geo)
    (kh, kw_), (h, w), cin = kw['taps'], kw['out_hw'], kw['cin']
    xf = x.reshape(x.shape[0], h + kh - 1, w + kw_ - 1, cin).permute(
        0, 3, 1, 2).float().contiguous(memory_format=torch.channels_last)
    wq = unpacked_weights(name, args, kw)
    wf = wq.float().reshape(kh, kw_, cin, -1).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    bf = args[2].float()

    def run():
        with faithful_float_math():
            return torch.nn.functional.conv2d(xf, wf, bf)
    return run


def cudnn_depthwise(x8, w8, bias, stride):
    """cuDNN's float32 grouped conv over D1's inputs (NHWC in memory, TF32
    off): the yardstick call, and its result as int32."""
    from hawq_tpu_torch.nn.layers import faithful_float_math
    c = x8.shape[3]
    xf = x8.permute(0, 3, 1, 2).float().contiguous(
        memory_format=torch.channels_last)
    wf = w8.permute(3, 2, 0, 1).float().contiguous(
        memory_format=torch.channels_last)
    bf = bias.float()

    def run():
        with faithful_float_math():
            return torch.nn.functional.conv2d(xf, wf, bf, stride=stride,
                                              padding=1, groups=c)
    return run


def ragged_calls(dev):
    """Unaligned shapes beside the paths': odd M/K/N, small C (byte loads),
    s2d stride 2, int32/float32 pools; for the split-K matmul ragged K and
    every split count; for the int4w kernels odd M/N, C/2 odd (C = 6, 10),
    s2d stride 2, nibbles -8 and 7."""
    from hawq_tpu_torch.kernels import conv as kc
    from hawq_tpu_torch.kernels import matmul as km
    from hawq_tpu_torch.quant.ops import np_dyadic_multiplier
    rng = np.random.RandomState(7)

    def i8(*shape):
        return torch.tensor(rng.randint(-128, 128, shape).astype(np.int8),
                            device=dev)

    def w4(*shape):
        w = rng.randint(-8, 8, shape).astype(np.int8)
        w.reshape(-1)[:2] = (-8, 7)
        return w

    def vec(n):
        b = torch.tensor(rng.randint(-2 ** 16, 2 ** 16, n).astype(np.int32),
                         device=dev)
        m = torch.tensor(np_dyadic_multiplier(
            (rng.rand(n) * 2e-4 + 1e-5).astype(np.float32)), device=dev)
        return b, m
    calls = []

    def unaligned(t):
        """``t``'s values one element into an allocation: a pointer off
        16-byte alignment."""
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)
    for m, k, n in ((37, 45, 19), (1000, 2048, 1000), (3, 5, 2)):
        b, mu = vec(n)
        calls.append(('int8_matmul_requant', (i8(m, k), i8(k, n), b, mu),
                      dict(out_bits=4, signed=False, relu=True)))
        calls.append(('int8_matmul_acc', (i8(m, k), i8(k, n), b), {}))
    # split-K: K not a multiple of the 64-wide tile, M = 8, 1 to ⌈K/64⌉ pieces
    for m, k, n in ((8, 200, 72), (37, 45, 19), (8, 2048, 1000),
                    (130, 1000, 64)):
        x, w = i8(m, k), i8(k, n)
        b, mu = vec(n)
        for splits in sorted({1, min(2, -(-k // 64)), -(-k // 64)}) + [None]:
            calls.append((KBLOCKED, (x, w, b, mu), dict(
                out_bits=4, signed=False, relu=True, k_splits=splits)))
            calls.append((KBLOCKED, (x, w, b, mu), dict(k_splits=splits)))
    for shape, n, stride in (((2, 9, 7, 5), 11, 1), ((1, 12, 10, 32), 40, 2),
                             ((2, 33, 31, 64), 72, 1)):
        x8 = i8(*shape)
        w = rng.randint(-127, 128, (3, 3, shape[3], n)).astype(np.int8)
        bsz, h, wd, _ = shape
        if stride == 2:
            x2, w = kc.s2d_conv_transform(x8, w, 1)
            oh, ow = kc.s2d_output_hw(h, wd, 3, 3, 1)
            xp = kc.prepare_conv_input(x2, (0, 0))
        else:
            oh, ow = h, wd
            xp = kc.prepare_conv_input(x8, (1, 1))
        wf = torch.tensor(kc.flatten_conv_kernel(w), device=dev)
        b, mu = vec(n)
        geo = dict(taps=w.shape[:2], out_hw=(oh, ow), cin=w.shape[2])
        calls.append(('int8_conv_requant', (xp, wf, b, mu),
                      dict(geo, out_bits=8, signed=True, relu=True)))
        calls.append(('int8_conv_acc', (xp, wf, b), geo))
    for dt in (torch.int32, torch.float32, torch.int16):
        xf = torch.tensor(rng.randint(-2 ** 14, 2 ** 14, (2, 7, 9, 20)),
                          device=dev).to(dt)
        calls.append((POOL, (xf,), {}))
        xf = torch.tensor(rng.randint(-2 ** 14, 2 ** 14, (1, 3, 17, 64)),
                          device=dev).to(dt)
        calls.append((POOL, (xf,), {}))
        calls.append((POOL, (unaligned(xf),), {}))
    # the requant-in-front pool: N off the 4-channel vector, both carriers,
    # 8- and 16-bit bounds, with and without the ReLU, Wq off the 4-column
    # run, one channel a thread on unaligned inputs; saturated and
    # .5-boundary requant inputs
    for shape, out_dtype, bits, signed, relu in (
            ((2, 7, 9, 20), torch.int16, 16, True, True),
            ((2, 7, 9, 20), torch.int32, 8, False, False),
            ((1, 3, 17, 64), torch.int32, 16, True, True),
            ((3, 5, 6, 16), torch.int16, 8, True, False)):
        acc = rng.randint(-2 ** 20, 2 ** 20, shape).astype(np.int32)
        acc[..., ::3] = rng.randint(-99, 100, acc[..., ::3].shape) * 2 + 1
        acc[0, 0, 0], acc[-1, -1, -1] = 2 ** 22, -2 ** 22
        mult = np_dyadic_multiplier((rng.rand(shape[3]) * 2e-3 + 1e-5).astype(
            np.float32))
        mult[::3] = 0.5
        args = (torch.tensor(acc, device=dev), torch.tensor(mult, device=dev))
        kw = dict(out_bits=bits, signed=signed, relu=relu, out_dtype=out_dtype)
        calls.append((POOL_REQUANT, args, kw))
        calls.append((POOL_REQUANT, (unaligned(args[0]), args[1]), kw))
        calls.append((POOL_REQUANT, (args[0], unaligned(args[1])), kw))
    for m, k, n in ((37, 46, 19), (1000, 2048, 1000), (3, 6, 2),
                    (130, 200, 72)):
        wp = torch.tensor(km.pack_int4(w4(k, n)), device=dev)
        b, mu = vec(n)
        calls.append(('int4w_matmul_requant', (i8(m, k), wp, b, mu),
                      dict(out_bits=4, signed=False, relu=True)))
        calls.append(('int4w_matmul_requant', (i8(m, k), wp, b, mu),
                      dict(out_bits=8, signed=True, relu=False)))
        calls.append(('int4w_matmul_acc', (i8(m, k), wp, b), {}))
    for shape, n, stride in (((2, 9, 7, 6), 11, 1), ((1, 12, 10, 10), 9, 2),
                             ((2, 33, 31, 64), 72, 1), ((1, 9, 7, 6), 5, 2),
                             ((1, 14, 14, 32), 40, 2)):
        x8 = i8(*shape)
        w = w4(3, 3, shape[3], n)
        bsz, h, wd, _ = shape
        if stride == 2:
            x2, w = kc.s2d_conv_transform(x8, w, 1)
            oh, ow = kc.s2d_output_hw(h, wd, 3, 3, 1)
            xp = kc.prepare_conv_input(x2, (0, 0))
        else:
            oh, ow = h, wd
            xp = kc.prepare_conv_input(x8, (1, 1))
        taps = w.shape[:2]
        wp = torch.tensor(kc.pack_int4_conv(kc.flatten_conv_kernel(w),
                                            taps[0] * taps[1]), device=dev)
        b, mu = vec(n)
        geo = dict(taps=taps, out_hw=(oh, ow), cin=w.shape[2])
        calls.append(('int4w_conv_requant', (xp, wp, b, mu),
                      dict(geo, out_bits=4, signed=False, relu=True)))
        calls.append(('int4w_conv_requant', (xp, wp, b, mu),
                      dict(geo, out_bits=8, signed=True, relu=False)))
        calls.append(('int4w_conv_acc', (xp, wp, b), geo))
    return calls


def sm90_calls(dev):
    """Calls of the eight kernels on the Hopper core beside the paths' →
    (calls its rule admits, [(call, excluding clause)]).

    Admitted: M off the 64-row tile, K below and between the K paddings,
    N = 1000 and N off every tile width, M = 1; 7×7, 14×14, 5×5 and 1×1
    images, B = 1 and 3, a 1×1 tap and the 2×2 taps of a space-to-depth
    stride-2 conv, C below and between the paddings, the zero border left
    to TMA (``pad``); operands at -128 /
    ±127 over K = 2048 and 9·512 (|acc| passes 2²⁴), and multipliers of 0.5
    (odd accumulators sit exactly on a .5 boundary); for the packed int4
    conv the same conv shapes (C = 16 to 512, nibbles -8 and 7) with plain
    packed bytes and with their handle; for the accumulator convs N off 16,
    the 4×4 taps of the RGB init's rewrite and the rest as above; for the
    packed matmuls M off the 64- and 128-row tiles, K = 48 and 80, M = 1,
    N = 1000 (accumulator form), saturated operands, ``pack_int4``'s bytes
    and their handle, 128-row tiles asked for.
    For the K-blocked matmul: M off the tile and M = 1, K off the 64- and
    128-deep steps, K in one piece asked for or not, plain weights and the
    handle.
    Excluded: one call per clause of ``sm90_route`` for each of the nine
    kernels (the CIFAR init's C = 3 among them), and a K-blocked call that
    asks for K in pieces."""
    from hawq_tpu_torch.kernels import conv as kc
    from hawq_tpu_torch.kernels import matmul as km
    from hawq_tpu_torch.quant.ops import np_dyadic_multiplier
    rng = np.random.RandomState(11)

    def i8(*shape, offset=0):
        """A contiguous int8 tensor; with ``offset``, that many bytes into
        an aligned allocation."""
        n = int(np.prod(shape))
        flat = torch.tensor(rng.randint(-128, 128, n + offset).astype(
            np.int8), device=dev)
        return flat[offset:].view(*shape)

    def vec(n, half=True):
        b = torch.tensor(rng.randint(-2 ** 16, 2 ** 16, n).astype(np.int32),
                         device=dev)
        m = np_dyadic_multiplier((rng.rand(n) * 2e-4 + 1e-5).astype(
            np.float32))
        if half:
            m[::3] = 0.5
        return b, torch.tensor(m, device=dev)

    def matmul(m, k, n, offset=0, saturate=False, **epi):
        """``int8_matmul_acc``, or with an epilogue ``int8_matmul_requant``."""
        x, w = i8(m, k, offset=offset), i8(k, n)
        if saturate:
            x[0, :], w[:, 0], w[:, 1] = -128, 127, -127
        if epi:
            return ('int8_matmul_requant', (x, w) + vec(n), epi)
        return ('int8_matmul_acc', (x, w, vec(n)[0]), {})

    def matmul4(m, k, n, offset=0, saturate=False, **epi):
        """``int4w_matmul_acc``, or with an epilogue ``int4w_matmul_requant``,
        on ``pack_int4``'s bytes."""
        x = i8(m, k, offset=offset)
        w = rng.randint(-8, 8, (k, n)).astype(np.int8)
        w.reshape(-1)[:2] = (-8, 7)
        if saturate:
            x[0, :] = -128
            w[:, 0], w[:, 1] = 7, -8
        wp = torch.tensor(km.pack_int4(w), device=dev)
        if epi:
            return ('int4w_matmul_requant', (x, wp) + vec(n), epi)
        return ('int4w_matmul_acc', (x, wp, vec(n)[0]), {})

    def conv(shape, n, taps, offset=0, saturate=False, pad=(0, 0),
             int4=False, acc=False, **epi):
        """``int8_conv_requant``, or with ``int4`` ``int4w_conv_requant``
        on per-tap packed weights; with ``acc`` the accumulator forms."""
        b, h, w, c = shape
        kh, kw = taps
        xp = i8(b, h + kh - 1 - 2 * pad[0], (w + kw - 1 - 2 * pad[1]) * c,
                offset=offset)
        if pad != (0, 0):
            epi['pad'] = pad
        if int4:
            wf = rng.randint(-8, 8, (kh * kw * c, n)).astype(np.int8)
            wf.reshape(-1)[:2] = (-8, 7)
            if saturate:
                wf[:, 0], wf[:, 1] = 7, -8
            wf = torch.tensor(kc.pack_int4_conv(wf, kh * kw), device=dev)
        else:
            wf = i8(kh * kw * c, n)
        if saturate:
            xp[0] = -128
            if not int4:
                wf[:, 0], wf[:, 1] = 127, -127
        bias, mult = vec(n)
        name = ('int4w' if int4 else 'int8') + ('_conv_acc' if acc
                                                 else '_conv_requant')
        return (name, (xp, wf, bias) if acc else (xp, wf, bias, mult),
                dict(taps=taps, out_hw=(h, w), cin=c, **epi))
    admitted = [matmul(37, 48, 20), matmul(1000, 2048, 1000, saturate=True),
                matmul(1, 16, 4), matmul(130, 80, 72), matmul(65, 192, 36),
                matmul(8, 2048, 1000, saturate=True)]
    for shape, n, taps in (((8, 7, 7, 512), 512, (3, 3)),
                           ((1, 14, 14, 256), 256, (3, 3)),
                           ((1, 5, 5, 16), 16, (3, 3)),
                           ((3, 1, 1, 32), 48, (3, 3)),
                           ((2, 9, 7, 48), 32, (1, 1)),
                           ((1, 14, 14, 80), 80, (3, 3)),
                           ((3, 33, 31, 64), 144, (3, 3)),
                           ((1, 7, 7, 192), 1008, (2, 2))):
        for int4 in (False, True):
            admitted.append(conv(shape, n, taps, saturate=shape[3] == 512,
                                 int4=int4, out_bits=8, signed=True,
                                 relu=True))
            admitted.append(conv(shape, n, taps, int4=int4, out_bits=4,
                                 signed=False, relu=True))
            admitted.append(conv(shape, n, taps, int4=int4))
    # the prepared handle in place of the (K, N) weights / the packed bytes
    for name, args, kw in admitted[-4:-2]:
        admitted.append((name, (args[0], hopper_core_weights(name, args[1],
                                                             kw))
                         + args[2:], kw))
    # the zero border left to TMA: 3×3 / pad 1 on whole, ragged and
    # smaller-than-a-tile images, a border on one axis only, 5×5 / pad 2
    for shape, n, taps, pad in (((2, 14, 14, 64), 64, (3, 3), (1, 1)),
                                ((1, 7, 7, 128), 32, (3, 3), (1, 1)),
                                ((3, 33, 31, 64), 144, (3, 3), (1, 1)),
                                ((2, 9, 7, 48), 32, (3, 3), (1, 0)),
                                ((2, 5, 6, 16), 16, (3, 3), (0, 1)),
                                ((1, 12, 20, 32), 48, (5, 5), (2, 2)),
                                ((1, 1, 1, 16), 16, (3, 3), (1, 1))):
        admitted.append(conv(shape, n, taps, pad=pad, relu=True))
        admitted.append(conv(shape, n, taps, pad=pad, int4=True, relu=True))
    for name, args, kw in admitted[-2:]:
        admitted.append((name, (args[0], hopper_core_weights(name, args[1],
                                                             kw))
                         + args[2:], kw))
    name, args, kw = admitted[3]
    admitted.append((name, (args[0], km.prepare_weights(args[1]), args[2]),
                     kw))
    # the accumulator convs: N % 4 only, images smaller than a tile, B = 1
    # and 3, 1×1 and 2×2 taps, C below and between the paddings, saturated
    # operands (|acc| passes 2²⁴), the border left to TMA, the handles
    n_before = len(admitted)
    for shape, n, taps, pad in (((2, 9, 7, 16), 20, (3, 3), (1, 1)),
                                ((1, 5, 5, 16), 16, (3, 3), (0, 0)),
                                ((3, 1, 1, 32), 44, (3, 3), (1, 1)),
                                ((2, 9, 7, 48), 32, (1, 1), (0, 0)),
                                ((1, 7, 7, 192), 1004, (2, 2), (0, 0)),
                                ((1, 14, 14, 80), 80, (3, 3), (1, 0)),
                                ((8, 7, 7, 512), 512, (3, 3), (1, 1)),
                                ((2, 12, 12, 16), 64, (4, 4), (0, 0))):
        for int4 in (False, True):
            admitted.append(conv(shape, n, taps, pad=pad, int4=int4,
                                 acc=True, saturate=shape[3] == 512))
    # their handles: a plain one, and where the call reads a kernel row as
    # one tap (C = 16, no border along x) the row-folded one
    for name, args, kw in admitted[n_before:n_before + 4]:
        admitted.append((name, (args[0], hopper_core_weights(name, args[1],
                                                             kw), args[2]),
                         kw))
    for name, args, kw in admitted[n_before + 14:n_before + 16]:
        prepare = (km.prepare_weights_int4 if name.startswith('int4w')
                   else km.prepare_weights)
        admitted.append((name, (args[0], prepare(args[1], 16), args[2]), kw))
    # the requant matmul: M and N off the tiles, K between the paddings,
    # M = 1, saturated operands, the handle in place of the (K, N) weights
    u4 = dict(out_bits=4, signed=False, relu=True)
    admitted += [matmul(37, 48, 16, relu=True), matmul(1, 16, 16, **u4),
                 matmul(1000, 2048, 1008, saturate=True, signed=True),
                 matmul(130, 80, 80, **u4), matmul(65, 192, 48, relu=True),
                 matmul(392, 2048, 512, saturate=True, **u4)]
    name, args, kw = admitted[-2]
    admitted.append((name, (args[0], km.prepare_weights(args[1])) + args[2:],
                     kw))
    # the packed matmuls, their handles, and 128-row tiles asked for
    n_before = len(admitted)
    admitted += [matmul4(37, 48, 16, relu=True), matmul4(300, 80, 48, **u4),
                 matmul4(1, 16, 16, **u4),
                 matmul4(392, 2048, 512, saturate=True, signed=True),
                 matmul4(37, 48, 20), matmul4(300, 80, 1000),
                 matmul4(1, 16, 4), matmul4(1000, 2048, 1000, saturate=True),
                 matmul4(130, 80, 72)]
    for i in (0, 1, 5, 6):
        name, args, kw = admitted[n_before + i]
        admitted.append((name, (args[0], km.prepare_weights_int4(args[1]))
                         + args[2:], kw))
    for i in (1, 3, 5, 7):
        name, args, kw = admitted[n_before + i]
        admitted.append((name, args, dict(kw, tile_m=128)))
    # the K-blocked matmul: K in one block of the Hopper core
    for m, k, n in ((37, 1008, 48), (130, 208, 80), (1, 4096, 16),
                    (392, 2048, 512)):
        name, args, kw = matmul(m, k, n, saturate=m == 392, relu=True)
        for splits in (None, 1):
            admitted.append((KBLOCKED, args, dict(kw, k_splits=splits)))
        admitted.append((KBLOCKED, (args[0], km.prepare_weights(args[1]))
                         + args[2:], kw))
    excluded = [(matmul(40, 45, 20), 'K % 16'), (matmul(40, 48, 18), 'N % 4'),
                (matmul(40, 48, 20, offset=8), 'pointer % 16'),
                (matmul(40, 45, 16, relu=True), 'K % 16'),
                (matmul(40, 48, 24, relu=True), 'N % 16'),
                (matmul(40, 48, 16, offset=8, relu=True), 'pointer % 16'),
                (conv((2, 6, 5, 5), 16, (3, 3)), 'C % 16'),
                (conv((2, 6, 5, 16), 24, (3, 3)), 'N % 16'),
                (conv((2, 6, 5, 16), 16, (3, 3), offset=4), 'pointer % 16'),
                (conv((2, 6, 5, 5), 16, (3, 3), pad=(1, 1)), 'C % 16'),
                (conv((2, 6, 5, 10), 16, (3, 3), int4=True), 'C % 16'),
                (conv((2, 6, 5, 16), 24, (3, 3), int4=True), 'N % 16'),
                (conv((2, 6, 5, 16), 16, (3, 3), offset=4, int4=True),
                 'pointer % 16'),
                (conv((2, 6, 5, 10), 16, (3, 3), pad=(1, 1), int4=True),
                 'C % 16')]
    for int4 in (False, True):
        excluded += [(conv((2, 6, 5, 12), 16, (3, 3), int4=int4, acc=True),
                      'C % 16'),
                     (conv((2, 6, 5, 16), 18, (3, 3), int4=int4, acc=True),
                      'N % 4'),
                     (conv((2, 6, 5, 16), 20, (3, 3), offset=4, int4=int4,
                           acc=True), 'pointer % 16')]
    excluded.append((conv((1, 8, 8, 3), 64, (3, 3), pad=(1, 1), acc=True),
                     'C % 16'))
    for call, clause in ((matmul(40, 45, 16, relu=True), 'K % 16'),
                         (matmul(40, 48, 24, relu=True), 'N % 16'),
                         (matmul(40, 48, 16, offset=8, relu=True),
                          'pointer % 16'),
                         (matmul(40, 1024, 16, relu=True), 'k_splits > 1')):
        excluded.append(((KBLOCKED, call[1], dict(call[2], k_splits=(
            9 if clause == 'k_splits > 1' else None))), clause))
    excluded += [(matmul4(40, 46, 20), 'K % 16'),
                 (matmul4(40, 48, 18), 'N % 4'),
                 (matmul4(40, 48, 20, offset=8), 'pointer % 16'),
                 (matmul4(40, 46, 16, relu=True), 'K % 16'),
                 (matmul4(40, 48, 24, relu=True), 'N % 16'),
                 (matmul4(40, 48, 16, offset=8, relu=True), 'pointer % 16')]
    return admitted, excluded


def sm90_rule_phase(dev, errs):
    """The Hopper core's ragged calls and one call per clause of its rule:
    each equal to its plain version, each on the core the rule names."""
    from hawq_tpu_torch.kernels import _build
    admitted, excluded = sm90_calls(dev)
    for call in admitted:
        check(sm90_rule(*call) is None, f'rule excludes {call_key(*call)}')
    _build.reset_launches()
    check_calls(admitted, errs, f'phase 3: {len(admitted)} ragged calls of '
                f'the Hopper core')
    want = {}
    for name, _, _ in admitted:
        want[f'{name}@sm90'] = want.get(f'{name}@sm90', 0) + 1
    check(core_launches() == want, f'ragged calls of the Hopper core ran as '
          f'{core_launches()}, expected {want}')
    for call, clause in excluded:
        name, args, kw = call
        check(sm90_rule(*call) == clause, f'{call_key(*call)}: rule says '
              f'{sm90_rule(*call)}, expected {clause}')
        _build.reset_launches()
        check_calls([call], errs, f'phase 3: {name} excluded by "{clause}"')
        check(core_launches() == {f'{name}@mma': 1}, f'{name} excluded by '
              f'"{clause}" ran as {core_launches()}')
        try:
            kernel_call(name, args, dict(kw, core='sm90'))
        except ValueError:
            continue
        raise RuntimeError(f'{name} excluded by "{clause}" was taken by the '
                           f'Hopper core when asked')
    log(f'phase 3: the {len(admitted)} ragged calls ran on the Hopper core, '
        f'the {len(excluded)} calls its rule excludes (one per clause) on '
        f'the first core')


def same(got, want):
    """Bit-equal, a NaN equal to a NaN."""
    if got.is_floating_point():
        return bool(((got == want) | (got.isnan() & want.isnan())).all())
    return torch.equal(got, want)


def check_calls(calls, errs, what):
    """Hold every call against its plain version, bit for bit; the largest
    absolute difference per kernel goes into ``errs``."""
    for name, args, kw in calls:
        got = kernel_call(name, args, kw)
        want = plain_call(name, args, kw)
        check(got.dtype == want.dtype and got.shape == want.shape,
              f'{name}: {got.dtype}{tuple(got.shape)} vs plain '
              f'{want.dtype}{tuple(want.shape)}')
        err = float(torch.nan_to_num(
            (got.to(torch.float64) - want.to(torch.float64)).abs(),
            nan=0.0).max())
        errs[name] = max(errs[name], err)
        check(same(got, want), f'{name} differs from its plain version '
              f'at {call_key(name, args, kw)[1]} {kw}: max |err| {err}')
    log(f'{what} equal their plain versions')


def call_key(name, args, kw):
    """What makes two kernel calls the same work: name, shapes, dtypes and
    keyword arguments."""
    from hawq_tpu_torch.kernels.matmul import PreparedWeights
    shapes = tuple(((a.k, a.n), 'prepared int4' if a.int4 else 'prepared')
                   if isinstance(a, PreparedWeights)
                   else (tuple(a.shape), str(a.dtype)) for a in args
                   if isinstance(a, (torch.Tensor, PreparedWeights)))
    return (name, shapes, tuple(sorted(
        (k, (tuple(v.shape), str(v.dtype)) if isinstance(v, torch.Tensor)
         else str(v)) for k, v in kw.items())))


def host_us(fn, reps=1000):
    """Host microseconds per call of ``fn``: ``reps`` enqueues on the host
    clock, the device not waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def sm90_tiles(name, args, kw):
    """'m-tiles x n-tiles of 64xN' of a call on the Hopper core."""
    from hawq_tpu_torch.kernels import conv as kc
    from hawq_tpu_torch.kernels import matmul as km
    w = hopper_core_weights(name, args[1], kw)
    n = w.n
    sms = km.sm_count(args[0].device)
    if '_conv' in name:
        th, tw = kc.conv_tile_plan(*kw['out_hw'])
        m_tiles = (args[0].shape[0] * -(-kw['out_hw'][0] // th)
                   * -(-kw['out_hw'][1] // tw))
        shape = f'{th}x{tw} px'
        tile_n = kc.sm90_conv_tile_n(w, args[0].shape[0], kw['out_hw'], sms)
        if w.row_taps > 1:
            shape += f', {w.row_taps} taps a row read as one'
    else:
        m, k_tiles = args[0].shape[0], w.cpad // w.tile_k
        rows = km.sm90_tile_m(m, n, k_tiles, sms) if w.int4 else 64
        m_tiles, shape = -(-m // rows), str(rows)
        tile_n = km.sm90_tile_n(-(-m // km.SM90_TILE_M), n, k_tiles, sms,
                                km.SM90_INT4_MATMUL_WIDEST if w.int4 else 128)
    return f'{m_tiles}x{-(-n // tile_n)} tiles of {shape} x {tile_n}'


def twin_name(name):
    """The int8 kernel beside a packed int4w kernel: the same call on
    weights unpacked once to int8."""
    return name.replace('int4w', 'int8')


def time_both_cores(name, args, kw):
    """One call of a kernel of the Hopper core on both cores, in turns (old,
    new, new, old; CUDA-graph replay), both held against the plain version
    → dict(ms, old_ms, host_us, old_host_us, prep_ms: laying out the
    weights; for the packed ``int4w_*`` also int8_twin_ms).  The
    kernels are timed on inputs each core reads as they are: (K, N) weights
    (packed (K/2, N) bytes for an int4w kernel) and the padded slab for the
    first core, the K-major handle (and the unpadded activations, where the
    path passes them) for the Hopper core.
    Where the path passes plain weights (training: they change every step)
    the wrapper lays them out on the device at each call: that glue is
    timed on its own, and is part of the host time, which is taken with the
    arguments as the path passed them.
    ``int8_twin_ms`` is the ``int8_*`` twin on the Hopper core over the
    same call with the weights unpacked once to int8: what streaming them
    packed, and unpacking them in the kernel, saves or costs."""
    from hawq_tpu_torch.kernels import matmul as km
    from hawq_tpu_torch.kernels import conv as kc
    plain_w = unpacked_weights(name, args, kw)
    old_args = (args[0], first_core_weights(args[1])) + tuple(args[2:])
    old_kw = dict(kw)
    if kw.get('pad', (0, 0)) != (0, 0):      # the first core reads the slab
        geo = {k: kw[k] for k in ('taps', 'out_hw', 'cin')}
        old_args = (kc.pad_conv_input(args[0], old_kw.pop('pad'), **geo),) \
            + old_args[1:]
    prep_ms = 0.0
    if not isinstance(args[1], km.PreparedWeights):
        prep_ms = graph_ms(
            lambda: hopper_core_weights(name, args[1], kw), 20)
    new_args = (args[0], hopper_core_weights(name, args[1], kw)) \
        + tuple(args[2:])
    want = plain_gemm_call(name, (old_args[0], plain_w) + old_args[2:],
                           old_kw)
    runs = {'mma': lambda: kernel_call(name, old_args,
                                       dict(old_kw, core='mma')),
            'sm90': lambda: kernel_call(name, new_args,
                                        dict(kw, core='sm90'))}
    if name.startswith('int4w'):
        twin_w = (kc.prepare_conv_weights(plain_w, kw['taps'], kw['cin'],
                                          kw.get('pad', (0, 0)))
                  if '_conv' in name else km.prepare_weights(plain_w))
        twin_args = (args[0], twin_w) + tuple(args[2:])
        runs['twin'] = lambda: kernel_call(twin_name(name), twin_args,
                                           dict(kw, core='sm90'))
    for core, run in runs.items():
        check(same(run(), want), f'{name} on the {core} core differs from '
              f'its plain version at {call_key(name, args, kw)[1]} {kw}')
    ms = {core: [] for core in runs}
    for core in ('mma', 'sm90', 'twin', 'twin', 'sm90', 'mma'):
        if core in runs:
            ms[core].append(graph_ms(runs[core], 20))
    out = dict(ms=sum(ms['sm90']) / 2, old_ms=sum(ms['mma']) / 2,
               host_us=host_us(lambda: kernel_call(name, args,
                                                   dict(kw, core='sm90'))),
               old_host_us=host_us(runs['mma']), prep_ms=prep_ms)
    if 'twin' in runs:
        out['int8_twin_ms'] = sum(ms['twin']) / 2
    return out


def time_calls(calls, totals):
    """Time each distinct call shape once and add it to ``totals`` as many
    times as the path launched it."""
    seen = {}
    for name, args, kw in calls:
        key = call_key(name, args, kw)
        if key not in seen:
            out = kernel_call(name, args, kw)
            nbytes, ops, label = work(name, args, kw, out)
            extra = {}
            if name in SM90_KERNELS:
                check(sm90_rule(name, args, kw) is None, f'{name} at {label}: '
                      f'the Hopper core\'s rule excludes a call of the path')
                extra = dict(time_both_cores(name, args, kw),
                             tiles=sm90_tiles(name, args, kw))
                ms = extra.pop('ms')
            else:
                ms = graph_ms(lambda: kernel_call(name, args, kw, False), 20)
            if name in POOLS + OWN_CORE:
                extra['cold_ms'] = cold_ms(
                    lambda *a: kernel_call(name, a, kw, False), args, 10)
            if name in DW:
                extra['tiles'] = dw_tile(args, kw, out)[1]
            if name in (AVGPOOL, AVGPOOL_Q):
                extra['tiles'] = avgpool_tile(args, kw)[1]
            host_ms = cuda_ms(lambda: kernel_call(name, args, kw, False), 20)
            plain_ms = graph_ms(lambda: plain_call(name, args, kw, False), 3)
            lib = library_call(name, args, kw)
            lib_ms = graph_ms(lib, 20) if lib is not None else None
            bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
            seen[key] = dict(name=name, shape=label, n=0, ms=ms,
                             host_ms=host_ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound,
                             bytes=nbytes, ops=ops, **extra)
        seen[key]['n'] += 1
    for row in seen.values():
        t = totals.setdefault(row['name'], dict(
            ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
            library_ok=True, library_calls=0,
            bytes=0, ops=0, old_ms=0.0, host_us=0.0, old_host_us=0.0,
            prep_ms=0.0, int8_twin_ms=0.0, cold_ms=0.0))
        for k in ('ms', 'plain_ms', 'bound_ms', 'bytes', 'ops', 'old_ms',
                  'host_us', 'old_host_us', 'prep_ms', 'int8_twin_ms',
                  'cold_ms'):
            t[k] += row.get(k, 0.0) * row['n']
        if row['library_ms'] is None:
            t['library_ok'] = False
        else:
            t['library_ms'] += row['library_ms'] * row['n']
            t['library_calls'] += row['n']
        lib = ('-' if row['library_ms'] is None
               else f"{row['library_ms']:.5f}")
        both = ''
        if 'cold_ms' in row:
            both = (f" | input streamed from device memory "
                    f"{row['cold_ms']:.5f} ms")
        if 'old_ms' in row:
            both = (f" | first core {row['old_ms']:.5f} ms, x"
                    f"{row['old_ms'] / row['ms']:.2f}; {row['tiles']}; host "
                    f"us/call {row['host_us']:.1f} (first core "
                    f"{row['old_host_us']:.1f})")
            if row['prep_ms']:
                both += (f"; weights laid out K-major at each call: "
                         f"+{row['prep_ms']:.5f} ms of glue")
            if 'int8_twin_ms' in row:
                both += (f"; {twin_name(row['name'])} on the weights "
                         f"unpacked to int8 {row['int8_twin_ms']:.5f} ms")
        log(f"  {row['name']:20s} {row['shape']:34s} x{row['n']:<2d} "
            f"ms {row['ms']:.5f} host-bound {row['host_ms']:.5f} "
            f"plain {row['plain_ms']:.4f} "
            f"bound {row['bound_ms']:.5f} library {lib}{both}")
    dw_rows = [r for r in seen.values() if r['name'] in DW]
    if dw_rows:
        dw_call_table(dw_rows)
    avg_rows = [r for r in seen.values() if r['name'] in (AVGPOOL, AVGPOOL_Q)]
    if avg_rows:
        avgpool_call_table(avg_rows)
    for name in SM90_KERNELS:
        if name in totals and any(r['name'] == name for r in seen.values()):
            t = totals[name]
            log(f"  {name}: Hopper core {t['ms']:.4f} ms, first core "
                f"{t['old_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms summed "
                f"over the path's launches; host us summed {t['host_us']:.0f}"
                f" (first core {t['old_host_us']:.0f}); laying out plain "
                f"weights {t['prep_ms']:.4f} ms; library over the "
                f"{t['library_calls']} calls it takes {t['library_ms']:.4f} ms"
                + (f"; {twin_name(name)} on the same calls with the weights "
                   f"unpacked once to int8 {t['int8_twin_ms']:.4f} ms"
                   if name.startswith('int4w') else ''))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def record_path(fm, x, dev):
    """One recorded forward of the folded int16 engine: its kernel calls
    and its launch counts, set to 0 just before and read just after."""
    from hawq_tpu_torch.inference.engine import build_resnet_engine
    from hawq_tpu_torch.kernels import _build
    eng = build_resnet_engine(fm, input_mode='folded_float32',
                              residual_dtype=torch.int16, device=dev)
    eng(x)                                       # uploads weights
    torch.cuda.synchronize()
    calls = []
    with recording(calls):
        _build.reset_launches()
        logits = eng(x)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        cores = core_launches()
    label = f'{fm.arch} {fm.cfg.name}'
    want = expected_launches(fm.arch, fm.cfg, 'folded_float32')
    check(launches == want, f'{label}: launches {launches}, expected {want}')
    # per core: what the rule says of each recorded call, which at these
    # widths is the Hopper core for every call of its kernels
    by_rule = cores_by_rule(calls)
    check(cores == by_rule == core_split(want), f'{label}: launches per core '
          f'{cores}, by the rule {by_rule}, expected {core_split(want)}')
    check(bool(torch.isfinite(logits).all()), f'{label}: logits not finite')
    log(f'phase 3: {label} folded_float32 int16 batch {BATCH}: launches '
        f'{launches}; per core {cores}')
    return calls, launches


def engine_input(fm, mode, raw, raw_u8, dev):
    from hawq_tpu_torch.inference.fold import fold4_images
    from hawq_tpu_torch.utils.preproc import quantize_int8
    x = {'float32': raw, 'uint8': raw_u8}.get(mode)
    if x is None:
        x = fold4_images(raw)
    if mode == 'folded_int8':
        x = quantize_int8(x, fm.act_scale('quant_input'))
    return torch.from_numpy(x).to(dev)


def engine_check(build, x, want, want_cores, nodes, label, dev, phase,
                 calls=None):
    """One engine at full width: built by ``build(device=...)``, launch
    counts (set to 0 just before a forward, read just after) against the
    prediction per kernel and per GEMM core, logits and the capture
    ``nodes`` for the first two images equal the CPU (plain) engine's,
    ms/batch → (the engine, the counted forward's launches per kernel).
    With ``calls`` (a list), the counted forward's kernel calls are
    recorded into it, and the per-core counts are also held against what
    the rule says of each recorded call."""
    from hawq_tpu_torch.kernels import _build
    eng = build(device=dev)
    eng(x)                                   # uploads weights, warms up
    torch.cuda.synchronize()
    with recording(calls if calls is not None else []):
        _build.reset_launches()
        logits = eng(x)
        torch.cuda.synchronize()
        counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        cores = core_launches()
    check(counts == want, f'{label}: launches {counts}, expected {want}')
    check(cores == want_cores, f'{label}: launches per core {cores}, '
          f'expected {want_cores}')
    if calls is not None:
        by_rule = cores_by_rule(calls)
        check(by_rule == cores, f'{label}: launches per core {cores}, by '
              f'the rule {by_rule}')
    out = logits.cpu()
    check(out.shape == (BATCH, 1000) and bool(torch.isfinite(out).all()),
          f'{label}: logits {tuple(out.shape)} not finite/shaped')
    ref = build(device='cpu')(x[:2].cpu())
    check(torch.equal(out[:2], ref), f'{label}: CUDA logits differ from the '
          f'CPU engine: max |err| {float((out[:2] - ref).abs().max())}')
    # synthetic weights can saturate the head (uniform4 logits may not
    # depend on the image), so inner nodes are compared as well
    for node in nodes:
        got = build(capture=node, device=dev)(x).cpu()
        ref = build(capture=node, device='cpu')(x[:2].cpu())
        check(torch.equal(got[:2], ref), f'{label}: {node} differs')
    ms = cuda_ms(lambda: eng(x), 20)
    t0 = time.perf_counter()
    for _ in range(10):
        eng(x)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 10 * 1e3
    what = f'logits and {", ".join(nodes)}' if nodes else 'logits'
    log(f'{phase}: {label}: {what} == CPU engine (2 '
        f'images), launches {counts}, per core {cores}, {ms:.3f} ms/batch '
        f'CUDA-event-timed, {wall:.3f} ms/batch host-timed (input '
        f'{tuple(x.shape)} {str(x.dtype).replace("torch.", "")})')
    return eng, counts


def engine_phase(fm, x, mode, residual, dev):
    from hawq_tpu_torch.inference.engine import build_resnet_engine
    want = expected_launches(fm.arch, fm.cfg, mode)
    return engine_check(
        functools.partial(build_resnet_engine, fm, input_mode=mode,
                          residual_dtype=residual), x, want,
        core_split(want), ('avg_pool',),
        f'{fm.arch} {fm.cfg.name} {mode} {residual}', dev, 'phase 4')[0]


def raw_pool_cost(engines, fms, raw, raw_u8, dev):
    """Phase 4: the raw-input ResNet engines' max-pool, ``maxpool_int``
    (four strided integer maxima, exact at any magnitude), beside the
    float32 ``max_pool2d`` form (exact only below 2²⁴) on the pool's input:
    device kernels, device ms and host µs per call of each; and the raw
    engines' kernels per forward."""
    import torch.nn.functional as F
    from hawq_tpu_torch.inference.engine import maxpool_int

    def float_pool(x):
        y = F.max_pool2d(x.permute(0, 3, 1, 2).to(torch.float32), 3, 2, 1)
        return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()

    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.int32, torch.int16):
        x = torch.randint(0, 2 ** 15, (BATCH, SIZE // 2, SIZE // 2, 64),
                          generator=gen, device=dev).to(dtype)
        check(torch.equal(maxpool_int(x), float_pool(x)),
              f'maxpool_int differs from the float32 pool on {dtype}')
        log(f'phase 4: the raw-input pool on {tuple(x.shape)} {dtype}: '
            + '; '.join(
                f'{label} {len(device_kernels(lambda: fn(x)))} device '
                f'kernels, {cuda_ms(lambda: fn(x), 50):.4f} ms device, '
                f'{host_us(lambda: fn(x), 50):.1f} µs host per call'
                for label, fn in (('maxpool_int', maxpool_int),
                                  ('float32 max_pool2d', float_pool))))
    for scheme, mode in (('uniform8', 'float32'), ('uniform4', 'float32'),
                         ('uniform4', 'uint8')):
        eng = engines['resnet50', scheme, mode]
        x = engine_input(fms['resnet50', scheme], mode, raw, raw_u8, dev)
        log(f'phase 4: resnet50 {scheme} {mode}: '
            f'{len(device_kernels(lambda: eng(x)))} device kernels per '
            f'forward')


def engine_both_cores(fm, x, eng, dev):
    """A folded int16 engine on the first core (built and run with every
    GEMM call sent there) and on the Hopper core (``eng``), in turns: equal
    logits, the first core's launch counts, ms per batch of each → the
    first-core engine."""
    from hawq_tpu_torch.inference.engine import build_resnet_engine
    from hawq_tpu_torch.kernels import _build
    with first_core():
        old = build_resnet_engine(fm, input_mode='folded_float32',
                                  residual_dtype=torch.int16, device=dev)
        old(x)
        torch.cuda.synchronize()
        _build.reset_launches()
        logits = old(x)
        torch.cuda.synchronize()
        want = {f'{k}@mma': v for k, v in expected_launches(
            fm.arch, fm.cfg, 'folded_float32').items() if k in GEMM_KERNELS}
        check(core_launches() == want, f'engine on the first core: launches '
              f'per core {core_launches()}, expected {want}')
    check(torch.equal(logits, eng(x)), 'engine logits on the first core '
          'differ from those on the Hopper core')

    def ms_per_batch(engine):
        event = cuda_ms(lambda: engine(x), 20)
        t0 = time.perf_counter()
        for _ in range(10):
            engine(x)
        torch.cuda.synchronize()
        return event, (time.perf_counter() - t0) / 10 * 1e3
    rows = []
    for core in ('mma', 'sm90', 'sm90', 'mma'):
        if core == 'mma':
            with first_core():
                rows.append((core,) + ms_per_batch(old))
        else:
            rows.append((core,) + ms_per_batch(eng))
    log(f'phase 4: {fm.arch} {fm.cfg.name} folded_float32 int16 engine, '
        f'first core and Hopper core in turns, equal logits; ms/batch '
        f'(CUDA events / host clock): '
        + ', '.join(f'{c} {e:.3f} / {h:.3f}' for c, e, h in rows))
    return old


_TEMPLATE = (re.compile(r'gemm_s8_kernel<(\w+), \w+, (\w+)>'),
             re.compile(r'gemm_s8_kernelILb(\d)ELb\dELb(\d)E'))


_SM90_TEMPLATE = (
    re.compile(r'gemm_s8_sm90_kernel<(\w+), (\w+), (\w+),'),
    re.compile(r'gemm_s8_sm90_kernelILb(\d)ELb(\d)ELb(\d)E'))


_DW_TEMPLATE = re.compile(r'dwconv_kernel(?:<(\w+),|ILb(\d)E)')
_AVG_TEMPLATE = re.compile(r'avgpool3x3_kernel(?:<[^<>]*?(true|false)>'
                           r'|I\w*?Lb\dELb(\d)E)')


def port_kernel(name):
    """'port: conv' / 'port: matmul' (' sm90' on the Hopper core, there
    ' requant' for the matmul with the requant epilogue, ' acc' for the
    conv with the int32 one; ' int4' with packed weights; ' split-K' on the
    first core) /
    'port: pool' / 'port: pool requant' / 'port: avgpool' / 'port: minmax'
    / 'port: depthwise ...' for the port's
    kernels in a trace (demangled or mangled names), None for any other
    kernel."""
    for pattern in _SM90_TEMPLATE:
        m = pattern.search(name)
        if m:
            conv, requant, int4 = (g in ('true', '1') for g in m.groups())
            return ('port: ' + ('conv' if conv else 'matmul') + ' sm90'
                    + (' requant' if requant and not conv else '')
                    + (' acc' if conv and not requant else '')
                    + (' int4' if int4 else ''))
    for pattern in _TEMPLATE:
        m = pattern.search(name)
        if m:
            conv, int4 = (g in ('true', '1') for g in m.groups())
            return ('port: ' + ('conv' if conv else 'matmul')
                    + (' int4' if int4 else ''))
    if 'gemm_s8_splitk_kernel' in name:
        return 'port: matmul split-K'
    m = _DW_TEMPLATE.search(name)
    if m:
        requant = m.group(1) in ('true', '1') or m.group(2) in ('true', '1')
        return 'port: depthwise ' + ('requant' if requant else 'acc')
    m = _AVG_TEMPLATE.search(name)
    if m:                 # the last template flag: the requant after it
        return 'port: avgpool' + ('' if (m.group(1) or m.group(2)) in (
            'true', '1') else ' quotient')
    if 'maxpool_folded_requant_kernel' in name:
        return 'port: pool requant'
    if 'maxpool_folded_kernel' in name:
        return 'port: pool'
    if 'minmax_partial_kernel' in name or 'minmax_finish_kernel' in name:
        return 'port: minmax'
    return None


def device_kernels(fn):
    """The device kernels of one call of ``fn`` (after a warm-up call), from
    a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get('traceEvents', [])
    return [e for e in events
            if e.get('cat') == 'kernel' and e.get('ph') == 'X']


def busy_and_timeline(kernels):
    """(µs with a kernel running, µs from the first kernel's start to the
    last one's end)."""
    spans = sorted((float(e['ts']), float(e['ts']) + float(e['dur']))
                   for e in kernels)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy, spans[-1][1] - spans[0][0]


def trace_breakdown(eng, x, label, phase='phase 4'):
    """Device-side breakdown of one forward from a torch.profiler trace:
    kernel time of the port's kernels and of the rest (and of those of the
    rest whose names carry ``double``: float64 glue), and the share of the
    device timeline with no kernel running → (kernels, port ms, other ms,
    {name: (count, µs)}, float64 ms), None without a trace."""
    kernels = device_kernels(lambda: eng(x))
    if not kernels:
        log(f'{phase}: {label}: the profiler trace holds no device kernels; '
            f'device busy share not measured')
        return None
    busy, timeline = busy_and_timeline(kernels)
    by_name = {}
    for e in kernels:
        key = port_kernel(e['name']) or e['name'][:60]
        c, t = by_name.get(key, (0, 0.0))
        by_name[key] = (c + 1, t + float(e['dur']))
    port_us = sum(t for k, (c, t) in by_name.items() if k.startswith('port'))
    total_us = sum(t for c, t in by_name.values())
    f64_us = sum(float(e['dur']) for e in kernels
                 if 'double' in e['name'] and not port_kernel(e['name']))
    log(f'{phase}: trace of one {label} forward: {len(kernels)} kernels, '
        f'device busy {busy / 1e3:.3f} ms of a {timeline / 1e3:.3f} ms device '
        f'timeline (idle share {1 - busy / timeline:.3f}); port kernels '
        f'{port_us / 1e3:.3f} ms, other kernels '
        f'{(total_us - port_us) / 1e3:.3f} ms, of which float64 (names with '
        f"'double') {f64_us / 1e3:.3f} ms")
    for k, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:9]:
        log(f'  {t / 1e3:8.4f} ms  x{c:<4d} {k}')
    return (len(kernels), port_us / 1e3, (total_us - port_us) / 1e3,
            by_name, f64_us / 1e3)


@contextlib.contextmanager
def unfused_init_pool():
    """Inside, the folded engines run their init block as before the
    requant-in-front pool: the requant and ReLU as PyTorch elementwise
    passes, then ``maxpool_folded``."""
    from hawq_tpu_torch.kernels import pool as kp
    from hawq_tpu_torch.quant.ops import requant_int32
    fused = kp.maxpool_folded_requant

    def unfused(acc, mult, *, out_bits, signed, relu, out_dtype, **_):
        x = requant_int32(acc, mult, out_bits, signed, out_dtype)
        return kp.maxpool_folded(torch.clamp_min(x, 0) if relu else x)
    kp.maxpool_folded_requant = unfused
    try:
        yield
    finally:
        kp.maxpool_folded_requant = fused


def init_block_before_after(eng, x, label):
    """The folded forward traced with the init block's former sequence
    (requant glue + ``maxpool_folded``) and with ``maxpool_folded_requant``:
    equal logits, kernels per forward and glue time of each."""
    want = eng(x)
    with unfused_init_pool():
        check(torch.equal(eng(x), want), f'{label}: the unfused init block '
              f'changes the logits')
        before = trace_breakdown(eng, x, f'{label} with the init requant as '
                                 f'glue and maxpool_folded')
    after = trace_breakdown(eng, x, f'{label} with maxpool_folded_requant')
    if before and after:
        log(f'phase 4: {label}: init block before / after the requant-in-'
            f'front pool: {before[0]} / {after[0]} kernels per forward, glue '
            f'(non-port kernels) {before[2]:.4f} / {after[2]:.4f} ms, port '
            f'kernels {before[1]:.4f} / {after[1]:.4f} ms')


def serving_phase(eng, host_transform, label, dev):
    from hawq_tpu_torch.parallel.serving import DynamicBatcher
    n_req = 12
    rng = np.random.RandomState(3)
    reqs = rng.randn(n_req, SIZE, SIZE, 3).astype(np.float32)
    batcher = DynamicBatcher(eng, BATCH, (SIZE, SIZE, 3), max_delay_ms=20,
                             host_transform=host_transform, device=dev)
    try:
        slots = [batcher.submit(im) for im in reqs]
        answers = np.stack([s.get(timeout=120) for s in slots])
    finally:
        batcher.close()
    check(not batcher._collector.is_alive()
          and not batcher._completer.is_alive(), 'batcher threads still alive')
    n_pad = -(-n_req // BATCH) * BATCH
    padded = np.concatenate(
        [reqs, np.zeros((n_pad - n_req, SIZE, SIZE, 3), np.float32)])
    want = np.concatenate([
        eng(torch.from_numpy(host_transform(padded[i:i + BATCH])).to(dev))
        .cpu().numpy() for i in range(0, n_pad, BATCH)])[:n_req]
    check(np.array_equal(answers, want), f'{label}: batcher answers differ '
          f'from the batched engine call')
    log(f'phase 5: DynamicBatcher over {label} answered {n_req} requests, '
        f'each equal to its row of a batched call')


def pool_phase(main_calls, errs, totals):
    """The standalone ``maxpool_folded`` at the main path's pre-pool tensor:
    the recorded ``maxpool_folded_requant`` call's accumulator requantized
    by the plain version, held against the plain pool, timed, then driven
    once as its own path → its launch count."""
    from hawq_tpu_torch.kernels import _build
    from hawq_tpu_torch.quant.ops import requant_int32
    fused = [c for c in main_calls if c[0] == POOL_REQUANT]
    check(len(fused) == 1, f'{len(fused)} {POOL_REQUANT} calls on the main '
          f'path, expected 1')
    _, (acc, mult), kw = fused[0]
    x = requant_int32(acc, mult, kw['out_bits'], kw['signed'], kw['out_dtype'])
    calls = [(POOL, (torch.clamp_min(x, 0) if kw['relu'] else x,), {})]
    check_calls(calls, errs, f'phase 3: {POOL} at the main path\'s pre-pool '
                f'tensor {tuple(calls[0][1][0].shape)}')
    log(f'phase 3: timed {POOL} at the main path\'s pre-pool tensor:')
    time_calls(calls, totals)
    _build.reset_launches()
    kernel_call(*calls[0])
    torch.cuda.synchronize()
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    check(counts == {POOL: 1}, f'phase 3: {POOL} launches {counts}')
    return 1


def kblocked_phase(conv1_calls, errs, totals):
    """Phase 6: the K-blocked matmul on the recorded
    ``int8_matmul_requant`` calls of the ResNet-50 uniform8 path, on the
    engine's prepared handles (the Hopper core: K in one block) and on
    plain weights (the first core's split-K) in turns, set beside the
    core's smallest launch → its launch count when those calls are driven
    once through it."""
    from hawq_tpu_torch.kernels import _build
    from hawq_tpu_torch.kernels import matmul as km
    check(len(conv1_calls) == 16, f'{len(conv1_calls)} recorded '
          f'int8_matmul_requant calls on resnet50 uniform8, expected 16')
    calls = [(KBLOCKED, args, kw) for _, args, kw in conv1_calls]
    first = [(KBLOCKED, (args[0], first_core_weights(args[1])) + args[2:],
              dict(kw, core='mma')) for _, args, kw in calls]
    _build.reset_launches()
    check_calls(calls + first, errs, f'phase 6: {KBLOCKED} on the 16 recorded '
                f'int8_matmul_requant calls, on both cores')
    check(core_launches() == {f'{KBLOCKED}@sm90': 16, f'{KBLOCKED}@mma': 16},
          f'phase 6: launches per core {core_launches()}')
    for (_, args, kw) in calls:
        check(torch.equal(kernel_call(KBLOCKED, args, kw),
                          km.int8_matmul_requant(*args, **kw)),
              f'{KBLOCKED} differs from int8_matmul_requant at '
              f'{[tuple(a.shape) for a in args[:1]]}')
    sm = km.sm_count(calls[0][1][0].device)
    splits = [km.default_k_splits(a[0].shape[0], a[0].shape[1], a[1].n, sm)
              for _, a, _ in calls]
    log(f'phase 6: equal to int8_matmul_requant on all 16; the first core\'s '
        f'K splits on {sm} SMs: {splits}; timed (Hopper core on the handles, '
        f'first core on plain weights, in turns):')
    time_calls(calls, totals)
    # the core's smallest launch: one 64 x 32 tile, one 64-deep K step
    x, w = calls[0][1][0][:64, :64].contiguous(), calls[0][1][1]
    w = km.prepare_weights(first_core_weights(w)[:64, :32].contiguous())
    b, mult = calls[0][1][2][:32], calls[0][1][3][:32]
    floor = graph_ms(lambda: km.int8_matmul_requant(x, w, b, mult), 50)
    t = totals[KBLOCKED]
    beside = totals['int8_matmul_requant']       # the same calls, phase 3
    log(f"phase 6: over the 16 calls {KBLOCKED} {t['ms']:.4f} ms on the "
        f"Hopper core, {t['old_ms']:.4f} ms on the first; bound "
        f"{t['bound_ms']:.4f} ms; the core's smallest launch {floor:.5f} ms, "
        f"x16 = {16 * floor:.4f} ms; int8_matmul_requant in phase 3 of this "
        f"run {beside['ms']:.4f} ms on the Hopper core, {beside['old_ms']:.4f}"
        f" ms on the first (a reading, not a claim)")
    _build.reset_launches()
    for name, args, kw in calls:
        kernel_call(name, args, kw)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    check(counts == {KBLOCKED: 16} and core_launches() == {
        f'{KBLOCKED}@sm90': 16}, f'phase 6: launches {counts}, per core '
        f'{core_launches()}')
    return 16, floor


def expected_train_launches(model):
    """Kernel launches of one QAT forward (a train, calibration or eval
    step; ``minmax_1pass`` only where the ranges update), from the model's
    layers: one ``minmax_1pass`` per activation quantizer, every 1×1 conv
    and the FC through ``int8_matmul_acc``, every depthwise conv through
    ``int8_dwconv_acc``, every other conv through ``int8_conv_acc`` (4·C
    after the space-to-depth of a stride 2, C zero-filled to a multiple of
    4) → Launches."""
    from hawq_tpu_torch.nn import layers as L
    out = Launches()
    for m in model.modules():
        if isinstance(m, (L.QuantAct, L.QuantBnAct)):
            if getattr(m, 'percentile', 0) == 0:
                out.add(MINMAX)
        elif isinstance(m, L.QuantLinear):
            out.add('int8_matmul_acc', 'matmul', *m.kernel.shape)
        elif isinstance(m, (L.QuantConvBn, L.QuantConv2d)):
            kh, kw, c, n = m.kernel.shape
            if m.groups > 1:
                out.add(DW_ACC)
            elif (kh, kw) == (1, 1):
                out.add('int8_matmul_acc', 'matmul', c, n)
            else:
                c = c if m.strides == (1, 1) else 4 * (c + -c % 4)
                out.add('int8_conv_acc', 'conv_acc', c, n)
    return out


def synthesize(args, dev, gen):
    """Random tensors on the card in place of recorded shapes and dtypes."""
    out = []
    for a in args:
        if not isinstance(a, torch.Tensor):
            out.append(a)
        elif a.dtype == torch.float32:
            out.append(torch.randn(a.shape, device=dev, generator=gen) * 3)
        else:
            hi = 128 if a.dtype == torch.int8 else 2 ** 16
            out.append(torch.randint(-hi, hi, a.shape, device=dev,
                                     dtype=a.dtype, generator=gen))
    return tuple(out)


def minmax_edge_calls(dev, gen):
    """Unaligned, one-element, NaN and ±inf inputs of the min/max."""
    x = torch.randn(1 << 20, device=dev, generator=gen)
    nan, pinf, ninf = x.clone(), x.clone(), x.clone()
    nan[12345], pinf[7], ninf[-2] = float('nan'), float('inf'), float('-inf')
    tail_nan = x[:4099].clone()
    tail_nan[-1] = float('nan')
    return [(MINMAX, (t,), {}) for t in (
        x[1:], x[3:70001], x[:1], x[5:6], nan, pinf, ninf, tail_nan,
        x[::3])]


_LIBRARY_KERNEL = re.compile(
    r'cudnn|cublas|cutlass|xmma|gemm|gemv|wgrad|dgrad|fprop|convolve|conv2d|'
    r'implicit|winograd|nchw|nhwc|sm\d\d_|ampere|hopper', re.I)


def train_trace_breakdown(step, label, phase=7):
    """Device-side breakdown of one train step from a profiler trace: the
    port's kernels, the library's (cuDNN / cuBLAS: the float backward),
    PyTorch's elementwise and reduction glue, and the idle share."""
    kernels = device_kernels(step)
    if not kernels:
        log(f'phase {phase}: {label}: the profiler trace holds no device '
            f'kernels; breakdown not measured')
        return None
    busy, timeline = busy_and_timeline(kernels)
    groups, by_name = {}, {}
    for e in kernels:
        port = port_kernel(e['name'])
        group = ('port' if port else 'library'
                 if _LIBRARY_KERNEL.search(e['name']) else 'glue')
        c, t = groups.get(group, (0, 0.0))
        groups[group] = (c + 1, t + float(e['dur']))
        key = port or e['name'][:70]
        c, t = by_name.get(key, (0, 0.0))
        by_name[key] = (c + 1, t + float(e['dur']))
    parts = ', '.join(f'{g} {t / 1e3:.3f} ms x{c}'
                      for g, (c, t) in sorted(groups.items()))
    log(f'phase {phase}: trace of one {label}: {len(kernels)} kernels, '
        f'device busy '
        f'{busy / 1e3:.3f} ms of a {timeline / 1e3:.3f} ms device timeline '
        f'(idle share {1 - busy / timeline:.3f}); {parts} (port = this '
        f"package's kernels, library = cuDNN/cuBLAS, glue = PyTorch "
        f'elementwise and reduction kernels)')
    for k, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f'  {t / 1e3:8.4f} ms  x{c:<4d} {k}')
    return groups


def serving_engine(fm, dev):
    """The frozen artifact's family engine on float32 input → (engine, its
    predicted Launches, the key of its output weight scale, the key of the
    activation that feeds the head)."""
    from hawq_tpu_torch.inference.engine import build_resnet_engine
    from hawq_tpu_torch.inference.engine_inception import (
        build_inceptionv3_engine)
    from hawq_tpu_torch.inference.engine_mobilenet import (
        build_mobilenetv2_engine)
    from hawq_tpu_torch.inference.engine_v2 import build_resnet_v2_engine
    if fm.arch == 'mobilenetv2':
        return (build_mobilenetv2_engine(fm, input_hw=(SIZE, SIZE),
                                         device=dev),
                expected_mobilenet_launches(fm, 'float32'), 'output',
                'quant_act_output')
    if fm.arch == 'inceptionv3':
        return (build_inceptionv3_engine(fm, input_hw=(INC_SIZE, INC_SIZE),
                                         device=dev),
                expected_inception_launches(fm, 'float32'), 'output.q_fc',
                'features.q_concat_activ')
    if fm.arch.endswith('v2'):
        return (build_resnet_v2_engine(fm, device=dev),
                expected_v2_launches(fm), 'quant_output', 'quant_act_output')
    want = expected_launches(fm.arch, fm.cfg, 'float32')
    out = Launches()
    out.counts, out.cores = want, core_split(want)
    return (build_resnet_engine(fm, device=dev), out, 'quant_output',
            'quant_act_output')


def run_trainer(arch, batch_size, dev, steps, fix_bn_threshold, calib):
    """The Trainer run at one batch size → what it measured."""
    from hawq_tpu_torch.kernels import _build
    from hawq_tpu_torch.train import trainer as tt
    from hawq_tpu_torch.train.data import synthetic_batches
    from hawq_tpu_torch.utils.checkpoint import load_frozen
    size = TRAIN_SIZE.get(arch, SIZE)
    records, specs = [], []
    real = tt.make_train_step

    def instrumented(model, *, folded, **kw):
        step = real(model, folded=folded, **kw)

        def run(state, batch):
            del specs[:]
            torch.cuda.synchronize()
            before = dict(_build.LAUNCHES)
            cores_before = dict(_build.CORE_LAUNCHES)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            with recording(specs, keep=shapes_only):
                out = step(state, batch)
            t1.record()
            torch.cuda.synchronize()
            counts = {k: v - before.get(k, 0)
                      for k, v in _build.LAUNCHES.items()
                      if v - before.get(k, 0)}
            cores = {k: v - cores_before.get(k, 0)
                     for k, v in _build.CORE_LAUNCHES.items()
                     if v - cores_before.get(k, 0)}
            records.append(dict(step=state.step - 1, folded=folded,
                                ms=t0.elapsed_time(t1), counts=counts,
                                cores=cores, loss=float(out[1]['loss'])))
            return out
        return run

    with tempfile.TemporaryDirectory() as tmp:
        cfg = tt.TrainerConfig(
            arch=arch, scheme='uniform8', num_classes=1000,
            image_size=size, batch_size=batch_size, epochs=1,
            steps_per_epoch=steps, fix_bn_threshold=fix_bn_threshold,
            calib_batches=calib, eval_batches=1, seed=0, save_path=tmp,
            device='cuda')
        tt.make_train_step = instrumented
        try:
            trainer = tt.Trainer(cfg)
            want = expected_train_launches(trainer.model)
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            t0 = time.perf_counter()
            trainer.run()      # calibrate, the steps, evaluate, checkpoint
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            total = {k: v for k, v in _build.LAUNCHES.items() if v}
        finally:
            tt.make_train_step = real
        label = f'{arch} uniform8 b{batch_size} {size}x{size}'
        schedule = [i >= fix_bn_threshold for i in range(steps)]
        check([s['folded'] for s in records] == schedule,
              f'fix-BN schedule ran {[s["folded"] for s in records]}')
        for s in records:
            check(np.isfinite(s['loss']), f'step {s["step"]}: loss '
                  f'{s["loss"]}')
            check(s['counts'] == want.counts, f'step {s["step"]}: launches '
                  f'{s["counts"]}, expected {want.counts}')
            check(s['cores'] == want.cores, f'step {s["step"]}: launches per '
                  f'core {s["cores"]}, expected {want.cores}')
        # the calibration passes and the steps update the ranges, the eval
        # batch does not
        want_total = {k: v * (calib + steps + (k != MINMAX))
                      for k, v in want.counts.items()}
        check(total == want_total, f'{label}: launches of the whole run '
              f'{total}, expected {want_total}')
        log(f'phase {TRAIN_PHASE[arch]}: Trainer on {label}: {calib} '
            f'calibration batches, steps '
            + ', '.join(f"{s['step']} "
                        f"({'folded' if s['folded'] else 'unfolded'} BN) "
                        f"loss {s['loss']:.4f} {s['ms']:.1f} ms"
                        for s in records)
            + f', 1 eval batch, checkpoint; {wall:.1f} s in all; launches '
            f'per step {want.counts} (per core {want.cores}), whole run '
            f'{total}')
        for name in ('checkpoint.npz', 'checkpoint.npz.meta.json',
                     'quantized_checkpoint.npz',
                     'quantized_checkpoint.npz.manifest.json'):
            check(os.path.exists(os.path.join(tmp, name)), f'{name} missing')
        fm = load_frozen(os.path.join(tmp, 'quantized_checkpoint.npz'))

        # the parity contract on the card: the frozen checkpoint through the
        # family's integer engine == the trainer's QAT eval logits, as integers
        images = torch.from_numpy(next(synthetic_batches(
            batch_size, size, 1000, 1, seed=10_000))['image']).to(dev)
        with torch.no_grad():
            qat = trainer.model(images, folded=True, update_stats=False)
        eng, want_eng, head, head_act = serving_engine(fm, dev)
        _build.reset_launches()
        logits = eng(images)
        torch.cuda.synchronize()
        counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        check(counts == want_eng.counts, f'engine on the frozen checkpoint: '
              f'launches {counts}, expected {want_eng.counts}')
        check(core_launches() == want_eng.cores, f'engine on the frozen '
              f'checkpoint: launches per core {core_launches()}, expected '
              f'{want_eng.cores}')
        scale = (torch.from_numpy(fm[head + '.weight_scale']).to(
            dev).double() * float(fm.act_scale(head_act)))
        qat_int = torch.round(qat.double() / scale)
        eng_int = torch.round(logits.double() / scale)
        check(qat.shape == (batch_size, 1000)
              and bool(torch.isfinite(qat).all()),
              'QAT eval logits not finite/shaped')
        if not torch.equal(qat_int, eng_int):
            parity_evidence(tmp, arch, trainer.model, fm, images, qat_int,
                            eng_int, dev)
    log(f'phase {TRAIN_PHASE[arch]}: quantized_checkpoint.npz → load_frozen '
        f'→ {type(eng).__name__} on the card: integer logits equal the '
        f"trainer's QAT eval logits on all {qat_int.numel()} "
        f'(launches {counts})')

    # steadier step times: a fixed batch, one warm-up, CUDA events
    batch = trainer._device_batch(next(synthetic_batches(
        batch_size, size, 1000, 1, seed=0)))
    timed = {}
    for folded in (False, True):
        step = real(trainer.model, folded=folded)
        run = lambda: step(trainer.state, batch)
        timed[folded] = cuda_ms(run, 3)
    peak = torch.cuda.max_memory_allocated()
    log(f'phase {TRAIN_PHASE[arch]}: {label}: {timed[False]:.2f} ms per '
        f'unfolded step, {timed[True]:.2f} ms per folded step (CUDA events '
        f'around 3 whole steps after a warm-up), '
        f'{batch_size / timed[True] * 1e3:.1f} images/s folded, peak memory '
        f'allocated {peak / 2 ** 30:.2f} GiB')
    step = real(trainer.model, folded=True)
    groups = train_trace_breakdown(lambda: step(trainer.state, batch),
                                   f'folded step of {label}',
                                   TRAIN_PHASE[arch])
    return dict(batch=batch_size, counts=records[-1]['counts'],
                specs=list(specs), timed=timed, peak=peak, groups=groups)


def qat_node_names(node):
    """The QAT quantizers (``capture_q_int`` names, one per family) whose
    integers an engine capture node holds."""
    fixed = {'input': ('quant_input', 'q_input_activ'),
             'init': ('quant_act_int32',), 'final': ('quant_act_int32_final',),
             'fc_input': ('quant_act_output', 'q_concat_activ')}
    if node in fixed:
        return fixed[node]
    m = re.match(r'(?:features\.)?stage(\d+)\.unit(\d+)\.(\w+)$', node)
    if not m:
        return ()
    leaf = {'input': 'quant_act', 'conv1': 'quant_act1', 'conv2': 'quant_act2',
            'pre': 'quant_bn'}.get(m[3], m[3])
    return (f'stage{m[1]}_unit{m[2]}.{leaf}',)


def parity_evidence(tmp, arch, model, fm, images, qat_int, eng_int, dev,
                    phase=None):
    """A QAT-eval-against-engine mismatch (phases 7, 10, 12, 14): keep the
    trainer's checkpoint and its frozen artifact (copied from ``tmp`` into a
    directory under ``OUT_DIR``, its path printed), then walk both sides on
    the card and on the CPU — the engine's capture nodes and the QAT
    forward's integers at the matching quantizers — over the images whose
    logits differ (at most 4); log the first node where the engine and the
    QAT forward differ and which side moved between the CPU and the card;
    then fail."""
    from hawq_tpu_torch.nn.layers import capture_q_int
    phase = phase or f'phase {TRAIN_PHASE[arch]}'
    keep = os.path.join(OUT_DIR, f"parity_{arch}_{time.strftime('%H%M%S')}")
    os.makedirs(keep, exist_ok=True)
    for name in os.listdir(tmp):
        if name.startswith(('checkpoint.npz', 'quantized_checkpoint.npz')):
            shutil.copy2(os.path.join(tmp, name), keep)
    bad = (qat_int != eng_int).any(dim=1).nonzero().flatten()[:4]
    log(f'{phase}: engine and QAT eval logits differ on '
        f'{int((qat_int != eng_int).sum())} of {qat_int.numel()}, in images '
        f'{bad.tolist()} and more; checkpoints kept in {keep}')
    try:
        x = images[bad.to(images.device)]
        sides = {}
        for where, device in (('card', dev), ('cpu', torch.device('cpu'))):
            m = model if where == 'card' else copy.deepcopy(model).cpu()
            nodes = {}
            serving_engine(fm, device)[0]._forward(
                x.to(device), lambda n, v: nodes.__setitem__(n, v.cpu()))
            with torch.no_grad(), capture_q_int(m) as q:
                m(x.to(device), folded=True, update_stats=False)
            sides[where] = (nodes, {k: v.cpu() for k, v in q.items()})
        walked = 0
        for node, card_eng in sides['card'][0].items():
            names = [n for n in qat_node_names(node) if n in sides['card'][1]
                     and sides['card'][1][n].numel() == card_eng.numel()]
            if not names:
                continue
            walked += 1
            # a carrier's quantizer holds its integers before the ReLU that
            # the engine has applied
            relu = (lambda t: t.clamp_min(0)) if card_eng.min() >= 0 else (
                lambda t: t)
            card_q = relu(sides['card'][1][names[0]].reshape(card_eng.shape))
            cpu_eng = sides['cpu'][0][node]
            cpu_q = relu(sides['cpu'][1][names[0]].reshape(card_eng.shape))
            if torch.equal(card_eng.double(), card_q.double()):
                continue
            log(f'{phase}: first differing node {node} (QAT {names[0]}): '
                f'{int((card_eng.double() != card_q.double()).sum())} of '
                f'{card_eng.numel()} on the card, '
                f'{int((cpu_eng.double() != cpu_q.double()).sum())} on the '
                f'CPU; engine card vs CPU '
                f"{'equal' if torch.equal(card_eng, cpu_eng) else 'MOVED'}, "
                f"QAT card vs CPU "
                f"{'equal' if torch.equal(card_q, cpu_q) else 'MOVED'}")
            break
        else:
            log(f'{phase}: all {walked} walked nodes agree; the logits alone '
                f'differ')
    except Exception as e:            # the walk is evidence, the check fails
        log(f'{phase}: the node walk failed: {type(e).__name__}: {e}')
    check(False, f'engine logits differ from the QAT eval logits as integers '
          f'on {int((qat_int != eng_int).sum())} of {qat_int.numel()} '
          f'(evidence in {keep})')


def card_vs_cpu_step(arch, dev):
    """One folded train step of ``arch`` (uniform8) at batch 2, 64×64
    (InceptionV3: 75×75, its head dropout off) on the card against the same
    step on the CPU from the same state."""
    from hawq_tpu_torch.models.resnet import qat_from_numpy, qat_to_numpy
    from hawq_tpu_torch.nn.layers import QuantDropout, capture_q_int
    from hawq_tpu_torch.train.train import (TrainState, make_train_step,
                                            sgd_with_step_decay)
    from hawq_tpu_torch.train.trainer import TrainerConfig, build_model
    rng = np.random.RandomState(4)
    size = CARD_STEP_SIZE.get(arch, 64)
    images = rng.randn(2, size, size, 3).astype(np.float32)
    labels = rng.randint(0, 1000, (2,))
    cpu, _ = build_model(TrainerConfig(arch=arch, seed=0))
    with torch.no_grad():
        for _ in range(2):
            cpu(torch.from_numpy(images), folded=True, update_stats=True)
    card = qat_from_numpy(build_model(TrainerConfig(arch=arch, seed=1))[0]
                          .to(dev), qat_to_numpy(cpu))
    for model in (cpu, card):       # InceptionV3's head dropout off: the
        for m in model.modules():   # two devices' generators draw other masks
            if isinstance(m, QuantDropout):
                m.rate = 0.0
    out = {}
    for name, model, device in (('cpu', cpu, 'cpu'), ('card', card, dev)):
        state = TrainState.create(model, sgd_with_step_decay(model, 1e-4))
        batch = {'image': torch.from_numpy(images).to(device),
                 'label': torch.from_numpy(labels).to(device)}
        with capture_q_int(model) as q:
            _, metrics = make_train_step(model, folded=True)(state, batch)
        out[name] = dict(
            q={k: v.cpu() for k, v in q.items()},
            ranges={k: v.cpu() for k, v in model.named_buffers()
                    if k.endswith(('x_min', 'x_max'))},
            grads={k: p.grad.cpu() for k, p in model.named_parameters()},
            loss=float(metrics['loss']))
    for kind in ('q', 'ranges'):
        for k, want in out['cpu'][kind].items():
            check(torch.equal(out['card'][kind][k], want),
                  f'card step: {kind} {k} differs from the CPU step')
    rel = (abs(out['card']['loss'] - out['cpu']['loss'])
           / abs(out['cpu']['loss']))
    check(rel <= 1e-5, f'card step: loss {out["card"]["loss"]} vs CPU '
          f'{out["cpu"]["loss"]}')
    worst = 0.0
    for k, want in out['cpu']['grads'].items():
        got = out['card']['grads'][k]
        # cuDNN / cuBLAS against the CPU's float convolutions: rtol 1e-3,
        # with a floor of 1e-3 of the leaf's largest value
        tol = 1e-3 * want.abs() + 1e-3 * float(want.abs().max())
        check(bool(((got - want).abs() <= tol).all()),
              f'card step: gradient {k} differs from the CPU step')
        worst = max(worst, float((got - want).abs().max()
                                 / (want.abs().max() + 1e-30)))
    log(f"phase {TRAIN_PHASE[arch]}: one folded step of {arch} uniform8 b2 "
        f"{size}x{size} on the card == on the CPU: "
        f"{len(out['cpu']['q'])} q_int "
        f"tensors and {len(out['cpu']['ranges'])} ranges bit-equal, loss "
        f"{out['card']['loss']:.6f} vs {out['cpu']['loss']:.6f}, "
        f"{len(out['cpu']['grads'])} gradient leaves within rtol 1e-3 "
        f"(worst |err| / max|g| {worst:.2e})")


def training_phase(arch, errs, dev, timed=None, steps=4, fix_bn_threshold=2,
                   calib=2):
    """Phases 7 and 10: the Trainer on ``arch``, every distinct kernel call
    of its last folded step held against the plain version, those of the
    kernels in ``timed`` (all, if None) timed, one card step against a CPU
    step → (launches per step as counted in the last step, totals per
    kernel over one step, the batch it ran at)."""
    phase = f'phase {TRAIN_PHASE[arch]}'
    batch = TRAIN_BATCH
    while True:
        try:
            run = run_trainer(arch, batch, dev, steps, fix_bn_threshold,
                              calib)
            break
        except torch.cuda.OutOfMemoryError as e:
            check(batch > 1, f'{phase}: out of memory at batch 1: {e}')
            log(f'{phase}: batch {batch} does not fit in the card\'s memory '
                f'in eager mode ({str(e).splitlines()[0]}); halving it')
            batch //= 2
            torch.cuda.empty_cache()
    # every distinct kernel call of the last folded step, on synthetic
    # inputs of its shapes: against the plain version, then timed
    gen = torch.Generator(device=dev).manual_seed(0)
    distinct = {}
    for name, args, kw in run['specs']:
        key = call_key(name, args, kw)
        if key not in distinct:
            distinct[key] = (name, synthesize(args, dev, gen), kw)
    calls = [distinct[call_key(*spec)] for spec in run['specs']]
    shapes = {k for k in distinct if k[0] == MINMAX}
    edges = minmax_edge_calls(dev, gen) if timed is None else []
    check_calls(list(distinct.values()) + edges, errs,
                f'{phase}: the {len(distinct)} distinct kernel calls of a '
                f'step of {arch} ({len(shapes)} minmax_1pass shapes) and '
                f'{len(edges)} minmax_1pass edge inputs')
    train_totals = {}
    log(f'{phase}: timed at the shapes of one step of {arch} (batch '
        f'{batch}):')
    time_calls([c for c in calls if timed is None or c[0] in timed],
               train_totals)
    if timed and DW_ACC in timed:
        dw_plan_sweep([c for c in calls if c[0] == DW_ACC], phase)
    card_vs_cpu_step(arch, dev)
    return run['counts'], train_totals, batch


def dw_ragged_calls(dev):
    """D1 beside the paths' shapes: C = 3, 8, 24 and 40 and inputs one byte
    off alignment (one channel a thread), C = 12 and 20 and an input 4
    bytes off 16-byte alignment (4 channels a thread, 4-byte staging
    copies), 16 / 32 (16-byte copies); output widths that are not a
    multiple of the pixels a thread takes; 7×7, odd, 1×1 and 2-row (at
    stride 2) images; B = 1; both strides; saturated operands; requant
    multipliers of 0.5 (odd accumulators on a .5 boundary); ReLU6 bounds
    that bind on some channels and not on others; 8- and 4-bit, signed and
    unsigned bounds."""
    from hawq_tpu_torch.inference.engine_mobilenet import relu6_bound
    from hawq_tpu_torch.quant.ops import np_dyadic_multiplier
    rng = np.random.RandomState(13)
    calls = []
    for (b, h, w, c), stride in (((2, 7, 7, 8), 1), ((1, 9, 13, 24), 2),
                                 ((1, 7, 7, 40), 1), ((2, 15, 11, 16), 2),
                                 ((1, 1, 1, 32), 1), ((3, 14, 14, 32), 2),
                                 ((1, 5, 6, 16), 1), ((2, 5, 9, 3), 1),
                                 ((1, 2, 6, 12), 2), ((2, 9, 10, 20), 1),
                                 ((1, 6, 7, 16), 1)):
        x = rng.randint(-128, 128, (b, h, w, c)).astype(np.int8)
        wt = rng.randint(-127, 128, (3, 3, 1, c)).astype(np.int8)
        if c == 40:                            # saturated
            x[:], wt[:] = -128, -127
        bias = rng.randint(-2 ** 18, 2 ** 18, c).astype(np.int32)
        acc_scale = (rng.rand(c) * 3e-4 + 2e-5).astype(np.float32)
        acc_scale[::2] = 6.0 / 40.0            # hi6 = 40 binds here
        mult = np_dyadic_multiplier((rng.rand(c) * 0.02 + 1e-3)
                                    .astype(np.float32))
        mult[1::3] = 0.5
        args = [torch.tensor(a, device=dev) for a in (x, wt, bias)]
        off = {5: 1, 6: 4}.get(h, 0) if c == 16 else 0
        if off:                                # x 1 or 4 bytes off 16
            flat = torch.empty(x.size + off, dtype=torch.int8, device=dev)
            flat[off:] = args[0].reshape(-1)
            args[0] = flat[off:].view(x.shape)
        calls.append((DW_ACC, tuple(args), dict(stride=stride)))
        vecs = (torch.tensor(relu6_bound(acc_scale), device=dev),
                torch.tensor(mult, device=dev))
        for lo, hi in ((-128, 127), (0, 15), (-8, 7)):
            calls.append((DW_REQUANT, tuple(args) + vecs,
                          dict(stride=stride, lo=lo, hi=hi)))
    return calls


def dw_tile(args, kw, out):
    """(the plan D1's wrapper launches for a call, a short label of it)."""
    from hawq_tpu_torch.kernels import depthwise as kd
    plan = kd.call_plan(args[0], args[1], out, kw['stride'])
    b, h, w, c = args[0].shape
    return plan, (f'{plan.vec}ch/thr copy{plan.copy} P{plan.p} '
                  f'{plan.rows}x{plan.ng * plan.p}px x{plan.cs * plan.vec}ch '
                  f'{kd.dw_grid(plan, b, h, w, c, kw["stride"])}blk '
                  f'{plan.cs * plan.ng * plan.rows}thr')


def dw_call_table(rows):
    """D1's per-call table: µs by graph replay in L2 and streamed from
    device memory, the bound, the share of it, the tile, cuDNN's µs."""
    log(f"  D1 per call ({rows[0]['name']}): shape | launches | us in L2 | "
        f"us streamed | bound us | share | cuDNN us | tile")
    for r in rows:
        log(f"    {r['shape']:26s} x{r['n']:<2d} {r['ms'] * 1e3:7.2f} "
            f"{r['cold_ms'] * 1e3:7.2f} {r['bound_ms'] * 1e3:7.3f} "
            f"{r['bound_ms'] / r['ms']:6.1%} {r['library_ms'] * 1e3:8.2f}  "
            f"{r['tiles']}")


def dw_alternatives(plan, args, kw):
    """Plans beside the rule's for one D1 call: p = 2, half and twice the
    rows, 4-byte staging copies, one channel a thread — those the shape
    and the pointers allow."""
    from hawq_tpu_torch.kernels import depthwise as kd
    b, h, w, c = args[0].shape
    oh = kd.dw_output_hw(h, w, kw['stride'])[0]
    alts = [plan._replace(p=2), plan._replace(rows=max(1, plan.rows // 2)),
            plan._replace(rows=min(oh, 2 * plan.rows))]
    if plan.copy == 16:
        alts.append(plan._replace(copy=4))
    if plan.vec == 4:
        one = kd.dw_plan(b, h, w, c, kw['stride'], vec=1, copy=1)
        alts.append(one._replace(ng=plan.ng, rows=min(
            plan.rows, kd.DW_THREADS // (one.cs * plan.ng))))
    seen, out = {plan}, []
    for a in alts:
        if a not in seen and a.cs * a.ng * a.rows <= kd.DW_THREADS:
            seen.add(a)
            out.append(a)
    return out


def dw_plan_sweep(calls, phase):
    """Each distinct D1 call of a path at the rule's plan and at its
    alternatives (:func:`dw_alternatives`), each held against the plain
    version, then timed in turns (rule, alternatives, alternatives in
    reverse, rule) by graph replay → the sums over the path's launches."""
    seen = {}
    for name, args, kw in calls:
        key = call_key(name, args, kw)
        seen.setdefault(key, [name, args, kw, 0])[3] += 1
    rule_sum, best_sum = 0.0, 0.0
    log(f'{phase}: D1 tile choices, us by graph replay (rule first):')
    for name, args, kw, n in seen.values():
        out = kernel_call(name, args, kw)
        plan, label = dw_tile(args, kw, out)
        want = plain_call(name, args, kw)
        plans = [plan] + dw_alternatives(plan, args, kw)
        for p in plans[1:]:
            check(same(kernel_call(name, args, dict(kw, plan=p)), want),
                  f'{name} at {p} differs from its plain version')
        ms = {p: [] for p in plans}
        for p in plans + plans[:0:-1] + [plan]:
            ms[p].append(graph_ms(
                lambda: kernel_call(name, args, dict(kw, plan=p), False), 20))
        mean = {p: sum(v) / len(v) for p, v in ms.items()}
        rule_sum += mean[plan] * n
        best_sum += min(mean.values()) * n
        b, h, w, c = args[0].shape
        log(f'  B{b} {h}x{w} C{c} s{kw["stride"]} x{n}: rule {label} '
            f'{mean[plan] * 1e3:.2f}; ' + '; '.join(
                f'v{p.vec} copy{p.copy} P{p.p} rows{p.rows} ng{p.ng} '
                f'{mean[p] * 1e3:.2f}' for p in plans[1:]))
    log(f'{phase}: D1 over the path\'s launches: rule {rule_sum:.4f} ms, '
        f'the fastest plan of each call {best_sum:.4f} ms')


def mobilenet_phase(raw, dev, errs, totals):
    """Phase 8: MobileNetV2 w1 serving at full width, 224², batch 8, on
    synthetic weights (seed 0): the paths of ``MNV2_PATHS``, each against
    the CPU engine and its predicted launches; every kernel call of the
    first (the main path) and D1's ragged calls held against their plain
    versions; D1 timed on the main path; a trace of its forward → D1's
    launches in the main path's counted forward."""
    from hawq_tpu_torch.configs.bit_config import get_bit_config
    from hawq_tpu_torch.inference.engine_mobilenet import (
        build_mobilenetv2_engine)
    from hawq_tpu_torch.inference.fold import fold4_images_3x3s2
    from hawq_tpu_torch.inference.synthetic import synthetic_frozen_mobilenet
    images = {'float32': torch.from_numpy(raw).to(dev),
              'folded_float32': torch.from_numpy(
                  fold4_images_3x3s2(raw, 1)).to(dev)}
    fms, main = {}, None
    for scheme, mode, residual in MNV2_PATHS:
        if scheme not in fms:
            fms[scheme] = synthetic_frozen_mobilenet(
                get_bit_config('mobilenetv2_w1', scheme), seed=0)
        fm = fms[scheme]
        want = expected_mobilenet_launches(fm, mode)
        label = f'mobilenetv2_w1 {scheme} {mode} {residual}'
        calls = [] if main is None else None
        eng, counts = engine_check(
            functools.partial(build_mobilenetv2_engine, fm, input_mode=mode,
                              residual_dtype=residual, input_hw=(SIZE, SIZE)),
            images[mode], want.counts, want.cores, ('final', 'fc_input'),
            label, dev, 'phase 8', calls)
        if main is None:
            main = (eng, images[mode], calls, want.counts, counts, label)
    eng, x, calls, want, counts, label = main
    check(want[DW_REQUANT] == 17 and want['int8_matmul_acc'] == 36
          and want['int8_conv_acc'] == 1, f'{label}: predicted {want}')
    ragged = dw_ragged_calls(dev)
    check_calls(calls + ragged, errs, f'phase 8: all {len(calls)} recorded '
                f'calls of {label} and {len(ragged)} ragged D1 calls')
    log(f'phase 8: timed {DW_REQUANT} on {label}:')
    time_calls([c for c in calls if c[0] == DW_REQUANT], totals)
    dw_plan_sweep([c for c in calls if c[0] == DW_REQUANT], 'phase 8')
    trace = trace_breakdown(eng, x, label, 'phase 8')
    if trace:
        port = {k: v for k, v in trace[3].items() if k.startswith('port')}
        log(f'phase 8: {label}: {trace[0]} kernels per forward, port kernels '
            + ', '.join(f'{k[6:]} x{c} {t / 1e3:.4f} ms'
                        for k, (c, t) in sorted(port.items()))
            + f'; glue (non-port kernels) {trace[2]:.4f} ms')
    return counts[DW_REQUANT]


def resnet_v2_phase(raw, dev, errs):
    """Phase 9: ResNet-50 v2 uniform8 serving at full width, 224², batch 8,
    float32 input, on synthetic weights (seed 0): against the CPU engine
    and its predicted launches, every kernel call held against its plain
    version, a trace of the forward."""
    from hawq_tpu_torch.configs.bit_config import get_bit_config
    from hawq_tpu_torch.inference.engine_v2 import build_resnet_v2_engine
    from hawq_tpu_torch.inference.synthetic import synthetic_frozen_resnet_v2
    fm = synthetic_frozen_resnet_v2(
        'resnet50v2', get_bit_config('resnet50v2', 'uniform8'), seed=0)
    want = expected_v2_launches(fm)
    x = torch.from_numpy(raw).to(dev)
    label = 'resnet50v2 uniform8 float32 int32'
    calls = []
    eng, _ = engine_check(functools.partial(build_resnet_v2_engine, fm), x,
                          want.counts, want.cores,
                          ('fc_input', 'stage4.unit3.quant_act_int32'),
                          label, dev, 'phase 9', calls)
    check_calls(calls, errs, f'phase 9: all {len(calls)} recorded calls of '
                f'{label}')
    trace_breakdown(eng, x, label, 'phase 9')


# ---------------------------------------------------------------------------
# phase 13: the reference-checkpoint replay
# ---------------------------------------------------------------------------

def reference_checkpoint(arch, scheme, dyadic, tmp):
    """The synthetic model (seed 0) of ``arch`` at full width — with
    ``dyadic``, its ``dyadic_scales`` variant — written as the reference's
    ``quantized_checkpoint.pth.tar`` (``save_reference_quantized``) into
    ``tmp`` and read back (``load_reference_quantized``): the FrozenModel
    the replay serves, held equal to the one written."""
    from hawq_tpu_torch.configs.bit_config import get_bit_config
    from hawq_tpu_torch.inference import synthetic as syn
    from hawq_tpu_torch.utils.checkpoint import (load_reference_quantized,
                                                 save_reference_quantized)
    cfg = get_bit_config(arch, scheme)
    fm = (syn.synthetic_frozen_mobilenet(cfg, seed=0) if arch == 'mobilenetv2'
          else syn.synthetic_frozen_inception(cfg, seed=0)
          if arch == 'inceptionv3'
          else syn.synthetic_frozen_resnet(arch, cfg, seed=0))
    if dyadic:
        fm = syn.dyadic_scales(fm)
    kind = 'dyadic' if dyadic else 'synthetic'
    path = os.path.join(tmp, f'{arch}_{scheme}_{kind}.pth.tar')
    save_reference_quantized(path, fm)
    got = load_reference_quantized(path, fm.arch, cfg)
    check(got.num_classes == fm.num_classes
          and sorted(got.tensors) == sorted(fm.tensors)
          and all(np.asarray(got[k]).dtype == np.asarray(v).dtype
                  and np.array_equal(got[k], v)
                  for k, v in fm.tensors.items()),
          f'{os.path.basename(path)}: the checkpoint read back differs from '
          f'the one written')
    return got


def reference_builder(fm, mode, requant_mode):
    """The family's engine builder for ``fm`` on ``mode`` input, int32
    carriers, in ``requant_mode``."""
    from hawq_tpu_torch.inference.engine import build_resnet_engine
    from hawq_tpu_torch.inference.engine_inception import (
        build_inceptionv3_engine)
    from hawq_tpu_torch.inference.engine_mobilenet import (
        build_mobilenetv2_engine)
    if fm.arch == 'mobilenetv2':
        return functools.partial(build_mobilenetv2_engine, fm,
                                 input_mode=mode, input_hw=(SIZE, SIZE),
                                 requant_mode=requant_mode)
    if fm.arch == 'inceptionv3':
        return functools.partial(build_inceptionv3_engine, fm,
                                 input_mode=mode,
                                 input_hw=(INC_SIZE, INC_SIZE),
                                 requant_mode=requant_mode)
    return functools.partial(build_resnet_engine, fm, input_mode=mode,
                             requant_mode=requant_mode)


def expected_reference_launches(fm, mode):
    """Launches of one reference-mode forward of the family's engine, from
    the model's widths (the accumulator forms throughout) → Launches."""
    if fm.arch == 'mobilenetv2':
        return expected_mobilenet_launches(fm, mode, reference=True)
    if fm.arch == 'inceptionv3':
        return expected_inception_launches(fm, mode, reference=True)
    out = Launches()
    out.counts = expected_launches(fm.arch, fm.cfg, mode, reference=True)
    out.cores = core_split(out.counts)
    return out


def reference_timing(eng, native, x, label):
    """ms per batch of the reference and the native engine in turns
    (reference, native, native, reference; CUDA events), and a trace of a
    forward of each (kernels per forward, the float64 glue)."""
    ms = {'reference': [], 'native': []}
    for mode in ('reference', 'native', 'native', 'reference'):
        e = eng if mode == 'reference' else native
        ms[mode].append(cuda_ms(lambda: e(x), 10))
    log(f'phase 13: {label}: ms/batch in turns (reference, native, native, '
        f'reference): ' + ', '.join(f'{a:.3f}' for a in (
            ms['reference'][0], *ms['native'], ms['reference'][1])))
    for mode, e in (('reference', eng), ('native', native)):
        trace_breakdown(e, x, f'{label} in {mode} mode', 'phase 13')


def avgpool_quotient_ragged_calls(dev):
    """A1's quotient form beside the path's shapes: H, W in {1, 2, 3, 5, 8,
    17, 35} with C cycling through {1, 3, 4, 12, 288} and the dtype through
    int32, int16 and int8, every other call one element off alignment (one
    channel a thread); per dtype a field of ± its largest value (int32:
    2³¹/9, the largest whose sums fit) and a constant −9 one (negative
    multiples of 9)."""
    rng = np.random.RandomState(19)
    hws, cs = (1, 2, 3, 5, 8, 17, 35), (1, 3, 4, 12, 288)
    dtypes = (torch.int32, torch.int16, torch.int8)
    calls = []
    for i, h in enumerate(hws):
        for j, w in enumerate(hws):
            c = cs[(i + j) % len(cs)]
            dtype = dtypes[(i + 2 * j) % 3]
            top = min(torch.iinfo(dtype).max, 2 ** 31 // 9)
            x = torch.tensor(rng.randint(-top, top + 1, (2, h, w, c)),
                             dtype=dtype, device=dev)
            if (i + j) % 2:
                flat = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
                flat[1:] = x.reshape(-1)
                x = flat[1:].view(x.shape)
            calls.append((AVGPOOL_Q, (x,), {}))
    for dtype in dtypes:
        top = min(torch.iinfo(dtype).max, 2 ** 31 // 9)
        x = torch.full((2, 5, 7, 12), top, dtype=dtype, device=dev)
        x[:, 2, 3, ::2] = -top
        x[1] = -x[1]
        calls.append((AVGPOOL_Q, (x,), {}))
        calls.append((AVGPOOL_Q, (torch.full((1, 4, 5, 4), -9, dtype=dtype,
                                             device=dev),), {}))
    return calls


def reference_phase(raw, dev, errs, totals):
    """Phase 13: the reference-checkpoint replay at full width, batch 8
    (``REF_PATHS``): each model written as the reference's
    ``quantized_checkpoint.pth.tar`` and read back, then served with
    ``requant_mode='reference'`` — launches per kernel and per core against
    the prediction, no fused-requant form, logits and an inner node for the
    first two images equal to the CPU reference engine's, every recorded
    call against its plain version — on its synthetic weights and on its
    dyadic-scale variant, where the logits must differ from the native
    engine's; on the synthetic weights ms per batch and a trace of both
    modes; A1's quotient form held on its recorded and ragged calls and
    timed → (launches per kernel per path, A1's quotient-form launches on
    the InceptionV3 path, that path's label)."""
    from hawq_tpu_torch.inference.fold import fold4_images
    images = {'float32': torch.from_numpy(raw).to(dev),
              'folded_float32': torch.from_numpy(fold4_images(raw)).to(dev)}
    inc_x = torch.from_numpy(np.random.RandomState(3).randn(
        BATCH, INC_SIZE, INC_SIZE, 3).astype(np.float32)).to(dev)
    per_path, a1q = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        for arch, scheme, modes, node in REF_PATHS:
            for dyadic in (False, True):
                fm = reference_checkpoint(arch, scheme, dyadic, tmp)
                for mode in modes:
                    x = inc_x if arch == 'inceptionv3' else images[mode]
                    label = (f"{arch} {scheme}{' dyadic' if dyadic else ''} "
                             f'{mode} int32 b{BATCH} reference')
                    want = expected_reference_launches(fm, mode)
                    calls = []
                    eng, counts = engine_check(
                        reference_builder(fm, mode, 'reference'), x,
                        want.counts, want.cores, (node,), label, dev,
                        'phase 13', calls)
                    check(not set(FUSED_FORMS) & set(counts),
                          f'{label}: a fused-requant form launched: '
                          f'{counts}')
                    check_calls(calls, errs, f'phase 13: all {len(calls)} '
                                f'recorded calls of {label}')
                    native = reference_builder(fm, mode, 'native')(
                        device=dev)
                    n_diff = int((eng(x) != native(x)).sum())
                    check(n_diff > 0 or not dyadic, f'{label}: the logits '
                          f'equal the native engine\'s: the mode took no '
                          f'effect')
                    log(f'phase 13: {label}: {n_diff} of {BATCH * 1000} '
                        f'logits differ from the native engine\'s')
                    if not dyadic:
                        for name, n in counts.items():
                            per_path.setdefault(name, {})[label] = n
                        if arch == 'inceptionv3':
                            a1q = ([c for c in calls if c[0] == AVGPOOL_Q],
                                   counts[AVGPOOL_Q], label)
                        reference_timing(eng, native, x, label)
                    del calls, eng, native
    calls, n, label = a1q
    ragged = avgpool_quotient_ragged_calls(dev)
    check(n == 9 and len(calls) == 9, f'{label}: {n} {AVGPOOL_Q} launches')
    check_calls(calls + ragged, errs, f'phase 13: the {len(calls)} recorded '
                f'{AVGPOOL_Q} calls of {label} and {len(ragged)} ragged ones')
    log(f'phase 13: timed {AVGPOOL_Q} on {label}:')
    time_calls(calls, totals)
    q, f = totals[AVGPOOL_Q], totals[AVGPOOL]
    log(f"phase 13: {AVGPOOL_Q} over its {n} launches: {q['ms']:.4f} ms "
        f"(streamed {q['cold_ms']:.4f}), bound {q['bound_ms']:.4f} ms "
        f"({q['bound_ms'] / q['ms']:.1%} of it), plain {q['plain_ms']:.4f} "
        f"ms, F.avg_pool2d {q['library_ms']:.4f} ms; beside it A1's fused "
        f"form over the 9 launches of phase 11's path {f['ms']:.4f} ms, "
        f"bound {f['bound_ms']:.4f} ms")
    return per_path, n, label


# ---------------------------------------------------------------------------
# phase 14: sensitivity → allocation → serve; phase 15: export
# ---------------------------------------------------------------------------

def spearman(a, b):
    """Spearman's rank correlation of two sequences (no ties expected)."""
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra, rb = ra - ra.mean(), rb - rb.mean()
    return float((ra * rb).sum() / np.sqrt((ra ** 2).sum() * (rb ** 2).sum()))


@contextlib.contextmanager
def probes_observed(records, specs):
    """Inside, every ``sensitivity.hessian.hvp`` call (one Hutchinson
    probe) is observed: CUDA events around it, its launches per kernel and
    per core (counts read before and after), its peak allocated memory
    above what was allocated before it, and the launches counted before
    the first probe; the first probe's kernel calls are recorded (shapes
    only) into ``specs``."""
    from hawq_tpu_torch.kernels import _build
    from hawq_tpu_torch.sensitivity import hessian
    real = hessian.hvp

    def observed(loss_fn, params, v):
        torch.cuda.synchronize()
        before = {k: v for k, v in _build.LAUNCHES.items() if v}
        cores_before = core_launches()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        with recording([] if records else specs, keep=shapes_only):
            out = real(loss_fn, params, v)
        t1.record()
        torch.cuda.synchronize()
        records.append(dict(
            ms=t0.elapsed_time(t1), before=before,
            counts={k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                    if v - before.get(k, 0)},
            cores={k: v - cores_before.get(k, 0)
                   for k, v in core_launches().items()
                   if v - cores_before.get(k, 0)},
            peak=torch.cuda.max_memory_allocated() - base))
        return out
    hessian.hvp = observed
    try:
        yield
    finally:
        hessian.hvp = real


def sensitivity_traces(arch, dev, errs):
    """Phase 14's traces of ``arch`` at full width, b8, ``SIZE``²
    (``pipeline.estimate_layer_costs``: the uniform8 QAT model of seed 0,
    one calibration pass, ``HVP_PROBES`` probes), the launch counts set to 0
    just before and read after the calibration pass and each probe, held
    against the model's widths per kernel and per core; every distinct
    kernel call of a probe against its plain version → (model, costs,
    probe records)."""
    from hawq_tpu_torch.kernels import _build
    from hawq_tpu_torch.sensitivity import pipeline as sp
    records, specs = [], []
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with probes_observed(records, specs):
        model, costs = sp.estimate_layer_costs(
            arch, device=dev, batch=BATCH, image_size=SIZE,
            probes=HVP_PROBES)
    wall = time.perf_counter() - t0
    label = f'{arch} uniform8 b{BATCH} {SIZE}x{SIZE}'
    want = expected_train_launches(model)
    check(len(records) == HVP_PROBES, f'{label}: {len(records)} probes')
    check(records[0]['before'] == want.counts, f'{label}: calibration pass '
          f'launches {records[0]["before"]}, expected {want.counts}')
    per_probe = {k: v for k, v in want.counts.items() if k != MINMAX}
    for i, r in enumerate(records):
        check(r['counts'] == per_probe, f'{label}: probe {i} launches '
              f'{r["counts"]}, expected {per_probe}')
        check(r['cores'] == want.cores, f'{label}: probe {i} launches per '
              f'core {r["cores"]}, expected {want.cores}')
    check(all(np.isfinite(c.trace) and np.isfinite(c.delta_w4)
              for c in costs), f'{label}: a trace is not finite')
    log(f'phase 14: {label}: calibration pass launches {want.counts}; '
        f'{HVP_PROBES} HVP probes, each launching {per_probe} (per core '
        f'{want.cores}): ' + ', '.join(
            f"{r['ms']:.1f} ms / peak +{r['peak'] / 2 ** 30:.2f} GiB"
            for r in records) + f'; {wall:.1f} s in all (model build, '
        f'calibration, probes, costs)')
    gen = torch.Generator(device=dev).manual_seed(0)
    distinct = {}
    for name, args, kw in specs:
        distinct.setdefault(call_key(name, args, kw),
                            (name, synthesize(args, dev, gen), kw))
    check_calls(list(distinct.values()), errs, f'phase 14: the '
                f'{len(distinct)} distinct kernel calls of a probe of {arch}')
    return model, costs, records


def train_step_beside(model, dev):
    """One folded b8 train step on a copy of ``model`` at the calibration
    batch, after a warm-up: (CUDA-event ms, peak allocated bytes above what
    was allocated before it)."""
    from hawq_tpu_torch.sensitivity import pipeline as sp
    from hawq_tpu_torch.train.train import (TrainState, make_train_step,
                                            sgd_with_step_decay)
    m = copy.deepcopy(model)
    x, y = sp.calibration_batch(BATCH, SIZE, 1000)
    batch = {'image': torch.from_numpy(x).to(dev),
             'label': torch.from_numpy(y).to(dev)}
    state = TrainState.create(m, sgd_with_step_decay(m, 1e-4))
    step = make_train_step(m, folded=True)
    step(state, batch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(state, batch), 1)
    peak = torch.cuda.max_memory_allocated() - base
    del m, state, step
    return ms, peak


def hvp_card_vs_cpu(arch, dev):
    """The HVP of ``arch`` (full width, uniform8, seed 0, calibrated on the
    CPU at b``HVP_CHECK_BATCH`` ``HVP_CHECK_SIZE``²) on the card against the
    CPU for the same weights, ranges and probe: per leaf
    max |card − cpu| ≤ 1e-3 · max |cpu| (cuDNN's float sums in another
    order) → the worst leaf and its ratio."""
    from hawq_tpu_torch.sensitivity import hessian as sh
    from hawq_tpu_torch.sensitivity import pipeline as sp
    cpu = sp.build_qat_model(arch)
    x, y = (torch.from_numpy(a) for a in sp.calibration_batch(
        HVP_CHECK_BATCH, HVP_CHECK_SIZE, 1000))
    with torch.no_grad():
        cpu(x, folded=True, update_stats=True)
    card = copy.deepcopy(cpu).to(dev)
    out, secs = {}, {}
    for name, model, d in (('cpu', cpu, 'cpu'), ('card', card, dev)):
        params = dict(model.named_parameters())
        probe = sh.rademacher_like(params, torch.Generator().manual_seed(1))
        t0 = time.perf_counter()
        hv = sh.hvp(sp.qat_loss(model, x.to(d), y.to(d)), params, probe)
        out[name] = {k: v.cpu() for k, v in hv.items()}
        secs[name] = time.perf_counter() - t0
    ratios = {}
    for k, want in out['cpu'].items():
        got = out['card'][k]
        check(bool(torch.isfinite(got).all()), f'card HVP {k} not finite')
        ratios[k] = float((got - want).abs().max()
                          / (want.abs().max() + 1e-30))
    worst = max(ratios, key=ratios.get)
    check(ratios[worst] <= 1e-3, f'{arch}: card HVP leaf {worst} differs '
          f'from the CPU HVP by {ratios[worst]:.2e} of its largest value')
    log(f'phase 14: {arch} uniform8 b{HVP_CHECK_BATCH} {HVP_CHECK_SIZE}x'
        f'{HVP_CHECK_SIZE}: card HVP == CPU HVP on all {len(ratios)} leaves '
        f'within 1e-3 of each leaf\'s largest value (worst {worst}: '
        f'{ratios[worst]:.2e}); {secs["card"]:.2f} s on the card, '
        f'{secs["cpu"]:.2f} s on the CPU')
    return worst, ratios[worst]


def allocations(arch, costs):
    """allocate_bits at 'bops' and 'model_size', fraction 0.5, expanded to
    BitConfigs → {mode: BitConfig}."""
    from hawq_tpu_torch.sensitivity import ilp
    from hawq_tpu_torch.sensitivity import pipeline as sp
    out = {}
    for mode in ('bops', 'model_size'):
        t0 = time.perf_counter()
        alloc = ilp.allocate_bits(costs, mode, 0.5)
        secs = time.perf_counter() - t0
        n4 = sum(1 for b in alloc.bits.values() if b == 4)
        check(0 < n4 < len(alloc.bits) and alloc.resource_used
              <= alloc.resource_limit * (1 + 1e-9),
              f'{arch} {mode} 0.5: {n4} of {len(alloc.bits)} layers at 4 '
              f'bits, resource {alloc.resource_used} of '
              f'{alloc.resource_limit}')
        out[mode] = sp.to_bit_config(arch, alloc, f'{mode}_0.5_generated')
        log(f'phase 14: {arch} {mode} 0.5: {n4} of {len(alloc.bits)} layers '
            f'at 4 bits, resource {alloc.resource_used:.6g} of '
            f'{alloc.resource_limit:.6g}, objective {alloc.objective:.6g} '
            f'({secs * 1e3:.1f} ms); 4-bit: ' + ', '.join(
                k for k, b in alloc.bits.items() if b == 4))
    return out


def generated_model(model8, cfg, x, dev):
    """The QAT model at the generated config with ``model8``'s weights and
    BN statistics, its ranges calibrated afresh on ``x`` on the card →
    (model, its frozen artifact)."""
    from hawq_tpu_torch.inference.freeze import (freeze_mobilenetv2,
                                                 freeze_resnet)
    from hawq_tpu_torch.models.mobilenetv2 import QMobileNetV2
    from hawq_tpu_torch.models.resnet import (QResNet, qat_from_numpy,
                                              qat_to_numpy)
    v = qat_to_numpy(model8)
    mobilenet = isinstance(model8, QMobileNetV2)
    model = (QMobileNetV2(cfg, 1000) if mobilenet
             else QResNet(model8.arch, cfg, 1000)).to(dev)
    qat_from_numpy(model, {'params': v['params'],
                           'batch_stats': v['batch_stats']})
    with torch.no_grad():
        model(x, folded=True, update_stats=True)
    v = qat_to_numpy(model)
    fm = (freeze_mobilenetv2(v, cfg, model.stages, 1000) if mobilenet
          else freeze_resnet(v, model.arch, cfg, 1000))
    return model, fm


def qat_engine_parity(model, fm, eng, images, engine_images, dev, label):
    """The generated model's QAT eval logits on ``images`` == the card
    engine's on ``engine_images`` as integers (phase 7's contract); on a
    mismatch the evidence is kept (:func:`parity_evidence`)."""
    from hawq_tpu_torch.models.resnet import qat_to_numpy
    from hawq_tpu_torch.utils.checkpoint import (save_frozen,
                                                 save_train_checkpoint)
    with torch.no_grad():
        qat = model(images, folded=True, update_stats=False)
    logits = eng(engine_images)
    scale = (torch.from_numpy(fm['quant_output.weight_scale']).to(dev)
             .double() * float(fm.act_scale('quant_act_output')))
    qat_int = torch.round(qat.double() / scale)
    eng_int = torch.round(logits.double() / scale)
    if not torch.equal(qat_int, eng_int):
        with tempfile.TemporaryDirectory() as tmp:
            save_train_checkpoint(os.path.join(tmp, 'checkpoint.npz'),
                                  qat_to_numpy(model))
            save_frozen(os.path.join(tmp, 'quantized_checkpoint.npz'), fm)
            parity_evidence(tmp, fm.arch, model, fm, images, qat_int,
                            eng_int, dev, phase='phase 14')
    log(f'phase 14: {label}: the engine\'s integer logits equal the QAT '
        f'eval logits on all {qat_int.numel()}')


def sensitivity_phase(dev, errs):
    """Phase 14: ResNet-50 then MobileNetV2 w1 at full width, b8, 224²:
    traces, the allocations, the generated config's QAT model calibrated
    and frozen on the card, served folded with the int16 carrier against
    the prediction and the CPU engine (ResNet-50 also against the QAT eval
    logits) → (the generated ResNet-50 frozen model, launches of the
    calibration pass and per probe {arch: counts}, path labels)."""
    from hawq_tpu_torch.inference.engine import build_resnet_engine
    from hawq_tpu_torch.inference.engine_mobilenet import (
        build_mobilenetv2_engine)
    from hawq_tpu_torch.inference.fold import (fold4_images,
                                               fold4_images_3x3s2)
    from hawq_tpu_torch.sensitivity import hessian as sh
    from hawq_tpu_torch.sensitivity import ilp
    from hawq_tpu_torch.sensitivity import pipeline as sp
    x_np, y_np = sp.calibration_batch(BATCH, SIZE, 1000)
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
    worst = hvp_card_vs_cpu('resnet50', dev)
    calib, per_probe, labels, out = {}, {}, {}, {}
    for arch in ('resnet50', 'mobilenetv2'):
        model8, costs, records = sensitivity_traces(arch, dev, errs)
        calib[arch], per_probe[arch] = records[0]['before'], records[-1][
            'counts']
        labels[arch] = (f'{arch} uniform8 b{BATCH} {SIZE}x{SIZE}: the '
                        f'calibration pass, and one Hutchinson probe (the '
                        f'QAT eval forward, then two backward passes)')
        step_ms, step_peak = train_step_beside(model8, dev)
        later = [r['ms'] for r in records[1:]]     # the first warms cuDNN
        log(f'phase 14: {arch}: ms per probe after the first '
            f'{min(later):.1f}–{max(later):.1f} (median '
            f'{np.median(later):.1f}; the first {records[0]["ms"]:.1f}) '
            f'beside a folded b{BATCH} train step {step_ms:.1f} ms '
            f'({np.median(later) / step_ms:.2f}×); peak allocated above the '
            f'probe\'s start {max(r["peak"] for r in records) / 2 ** 30:.2f} '
            f'GiB beside the step\'s {step_peak / 2 ** 30:.2f} GiB')
        params = dict(model8.named_parameters())
        probe = sh.rademacher_like(params, torch.Generator().manual_seed(0))
        loss = sp.qat_loss(model8, x, y)
        train_trace_breakdown(lambda: sh.hvp(loss, params, probe),
                              f'HVP probe of {arch} uniform8 b{BATCH} '
                              f'{SIZE}x{SIZE}', 14)
        del params, probe, loss
        if arch == 'resnet50':
            pub = {c.key: c.trace for c in ilp.published_ilp_inputs(arch)}
            check(len(costs) == 52 and sorted(c.key for c in costs)
                  == sorted(pub), f'{arch}: {len(costs)} stage convs')
            ours = [c.trace for c in costs]
            rho = spearman(ours, [pub[c.key] for c in costs])
            log(f'phase 14: {arch}: the 52 stage-conv traces (trace / '
                f'#params, random weights): ' + ', '.join(
                    f'{c.key.replace(".quant_", ".")}={c.trace:.4g}'
                    for c in costs) + f'; Spearman against '
                f'published_ilp_inputs: {rho:.4f} (not a gate)')
        cfgs = allocations(arch, costs)
        model, fm = generated_model(model8, cfgs['bops'], x, dev)
        label = f'{fm.cfg.name} folded_float32 int16'
        calls = []
        if arch == 'resnet50':
            want = expected_launches(arch, fm.cfg, 'folded_float32')
            want_cores = core_split(want)
            build = functools.partial(build_resnet_engine, fm,
                                      input_mode='folded_float32',
                                      residual_dtype=torch.int16)
            images = torch.from_numpy(fold4_images(x_np)).to(dev)
            check(any(k.startswith('int4w_') for k in want), f'{label}: no '
                  f'4-bit layer: {want}')
        else:
            w = expected_mobilenet_launches(fm, 'folded_float32')
            want, want_cores = w.counts, w.cores
            build = functools.partial(build_mobilenetv2_engine, fm,
                                      input_mode='folded_float32',
                                      input_hw=(SIZE, SIZE),
                                      residual_dtype=torch.int16)
            images = torch.from_numpy(fold4_images_3x3s2(x_np, 1)).to(dev)
        eng, _ = engine_check(build, images, want, want_cores,
                              ('avg_pool' if arch == 'resnet50' else 'final',),
                              label, dev, 'phase 14', calls)
        check_calls(calls, errs, f'phase 14: all {len(calls)} recorded calls '
                    f'of {label}')
        logits = eng(images).cpu()
        check(torch.equal(logits, build(device='cpu')(images.cpu())),
              f'{label}: the card engine\'s logits differ from the CPU '
              f'engine\'s on the batch')
        log(f'phase 14: {label}: logits equal the CPU engine\'s on all '
            f'{BATCH} images')
        if arch == 'resnet50':
            qat_engine_parity(model, fm, eng, x, images, dev, label)
            out['fm'] = fm
        del model8, model, eng, calls
    log(f'phase 14: worst card HVP leaf {worst[0]} {worst[1]:.2e}')
    return out['fm'], calib, per_probe, labels


def replay_engine(fm, size, dev):
    """The family's float32-input engine at ``size``² on ``dev``."""
    from hawq_tpu_torch.inference.engine import build_resnet_engine
    from hawq_tpu_torch.inference.engine_inception import (
        build_inceptionv3_engine)
    from hawq_tpu_torch.inference.engine_mobilenet import (
        build_mobilenetv2_engine)
    from hawq_tpu_torch.inference.engine_v2 import build_resnet_v2_engine
    if fm.arch == 'mobilenetv2':
        return build_mobilenetv2_engine(fm, input_hw=(size, size),
                                        device=dev)
    if fm.arch == 'inceptionv3':
        return build_inceptionv3_engine(fm, input_hw=(size, size),
                                        device=dev)
    if fm.arch.endswith('v2'):
        return build_resnet_v2_engine(fm, device=dev)
    return build_resnet_engine(fm, device=dev)


# each family's FC, the activation that feeds it and the input quantizer
_HEAD = {'mobilenetv2': 'output', 'inceptionv3': 'output.q_fc'}
_HEAD_ACT = {'inceptionv3': 'features.q_concat_activ'}
_INPUT_ACT = {'inceptionv3': 'features.q_init_block.q_input_activ'}


def check_initializers(fm, m, eng, label):
    """Every initializer of the QONNX file ``m`` read back against what it
    came from: each Conv's weight, bias, weight scale and bits, the FC's
    weight and bias, the input and output scales against the FrozenModel;
    each dyadic multiplier against the engine's multiplier of the same site
    (by name, else by value) → (initializers checked, of all, multipliers
    matched by site, by value).  The rest (MobileNetV2's ReLU6 bounds,
    ResNet v2's BN biases and head scales) are held by the replay."""
    from hawq_tpu_torch.export import qonnx
    inits = {t.name: qonnx._tensor_to_np(t) for t in m.graph.initializer}
    done = set()

    def equal(name, want):
        got = inits[name]
        check(got.shape == np.shape(want) and np.array_equal(got, want),
              f'{label}: initializer {name} differs from the model')
        done.add(name)
    for node in m.graph.node:
        if node.op_type == 'Conv':
            key = node.name
            equal(key + '.weight', fm[key + '.weight_int'])
            equal(key + '.bias', fm[key + '.bias_int'])
            equal(key + '.weight_scale', np.atleast_1d(
                fm[key + '.weight_scale'].astype(np.float32)))
            equal(key + '.weight_bits',
                  np.asarray([fm.cfg.weight_bits(key)], np.int32))
        elif node.op_type == 'MatMul':
            head = _HEAD.get(fm.arch, 'quant_output')
            w = fm[head + '.weight_int']
            equal(node.input[1], w.reshape(w.shape[-2], w.shape[-1]))
    head = _HEAD.get(fm.arch, 'quant_output')
    equal(head.split('.')[0] + '.bias', fm[head + '.bias_int'])
    equal('input.scale', np.float32(
        fm.act_scale(_INPUT_ACT.get(fm.arch, 'quant_input'))).reshape(1))
    equal('output.scale', np.atleast_1d(
        fm[head + '.weight_scale'].astype(np.float32) * np.float32(
            fm.act_scale(_HEAD_ACT.get(fm.arch, 'quant_act_output')))))
    mults = {k: v.cpu().numpy() for k, v in eng._mult.items()}
    by_name = by_value = 0
    for name, got in inits.items():
        if not name.endswith('.mult'):
            continue
        site = 'init_requant' if name == 'init.mult' else name[:-5]
        if site in mults:
            check(np.array_equal(got, np.atleast_1d(mults[site])),
                  f'{label}: multiplier {name} differs from the engine\'s')
            by_name += 1
        else:
            check(any(np.array_equal(got, np.atleast_1d(v))
                      for v in mults.values()), f'{label}: multiplier '
                  f'{name} is none of the engine\'s')
            by_value += 1
        done.add(name)
    return len(done), len(inits), by_name, by_value


def export_phase(fm_gen, dev):
    """Phase 15: QONNX files of the full-width frozen models (synthetic,
    seed 0, and phase 14's generated config), read back, every initializer
    against its origin, replayed by the numpy int64 interpreter on one
    image at a reduced size bit-equal to the card engine's logits; the
    bundle of ResNet-50 uniform8, its (m, e) against the engine's
    multipliers and its npz against the model."""
    from hawq_tpu_torch.configs.bit_config import get_bit_config
    from hawq_tpu_torch.export import export as ex
    from hawq_tpu_torch.export import qonnx
    from hawq_tpu_torch.inference import synthetic as syn
    fms = [syn.synthetic_frozen_resnet(
               'resnet50', get_bit_config('resnet50', 'uniform8'), seed=0),
           fm_gen,
           syn.synthetic_frozen_resnet_v2(
               'resnet50v2', get_bit_config('resnet50v2', 'uniform8'),
               seed=0),
           syn.synthetic_frozen_mobilenet(
               get_bit_config('mobilenetv2', 'uniform8'), seed=0),
           syn.synthetic_frozen_inception(
               get_bit_config('inceptionv3', 'uniform8'), seed=0)]
    engines = {}
    with tempfile.TemporaryDirectory() as tmp:
        for fm in fms:
            label = fm.cfg.name
            path = os.path.join(tmp, f'{fm.cfg.name}.onnx')
            t0 = time.perf_counter()
            qonnx.export_qonnx(fm, path)
            t1 = time.perf_counter()
            m = qonnx.load_qonnx(path)
            t2 = time.perf_counter()
            size = REPLAY_SIZE.get(fm.arch, REPLAY_DEFAULT)
            img = np.random.RandomState(6).randn(1, size, size, 3).astype(
                np.float32)
            replay = qonnx.replay_qonnx(m, img)
            t3 = time.perf_counter()
            eng = replay_engine(fm, size, dev)
            logits = eng(torch.from_numpy(img).to(dev)).cpu().numpy()
            check(logits.shape == (1, 1000) and np.isfinite(logits).all(),
                  f'{label}: engine logits {logits.shape} not finite')
            check(np.array_equal(replay.astype(np.float32), logits),
                  f'{label}: the QONNX replay differs from the card engine '
                  f'on {int((replay.astype(np.float32) != logits).sum())} '
                  f'of 1000 logits')
            n, total, by_name, by_value = check_initializers(fm, m, eng,
                                                             label)
            log(f'phase 15: {label}: export_qonnx {(t1 - t0) * 1e3:.1f} ms '
                f'({os.path.getsize(path) / 2 ** 20:.1f} MiB, '
                f'{len(m.graph.node)} nodes), load_qonnx '
                f'{(t2 - t1) * 1e3:.1f} ms, replay of one {size}x{size} '
                f'image {t3 - t2:.2f} s bit-equal to the card engine; '
                f'{n} of {total} initializers checked against the model '
                f'and the engine ({by_name} multipliers by site, {by_value} '
                f'by value)')
            engines[fm.cfg.name] = eng
        fm = fms[0]
        eng = engines[fm.cfg.name]
        path = os.path.join(tmp, 'bundle', 'resnet50_uniform8')
        t0 = time.perf_counter()
        ex.export_bundle(path, fm)
        secs = time.perf_counter() - t0
        with open(path + '.bundle.json') as f:
            manifest = json.load(f)
        check(manifest == ex.bundle_manifest(fm), 'the bundle manifest '
              'read back differs')
        with np.load(path + '.npz') as z:
            check(sorted(z.files) == sorted(fm.tensors) and all(
                np.array_equal(z[k], fm[k]) and z[k].dtype == fm[k].dtype
                for k in z.files), 'the bundle npz differs from the model')
        site = {'init_requant': 'init_requant', 'fc_requant': 'fc_in'}
        n = 0
        for node in manifest['graph']:
            pairs = []
            if node['op'] == 'requantize':
                p = node['name'].rsplit('.', 1)
                name = site.get(node['name']) or (
                    f'{p[0]}.in' if p[1] == 'input_requant'
                    else f'{p[0]}.a{p[1][-1]}')
                pairs.append((name, node['m'], node['e']))
            elif node['op'] == 'requantize_add':
                p = node['name'].rsplit('.', 1)[0]
                pairs += [(f'{p}.res_main', node['m_main'], node['e_main']),
                          (f'{p}.res_id', node['m_identity'],
                           node['e_identity'])]
            for name, m_, e_ in pairs:
                got = np.ldexp(np.asarray(m_, np.float32),
                               -np.asarray(e_)).astype(np.float32)
                want = np.atleast_1d(eng._mult[name].cpu().numpy())
                check(np.array_equal(got, want), f'bundle: (m, e) of {name} '
                      f'do not rebuild the engine\'s multiplier')
                n += 1
        log(f'phase 15: export_bundle of resnet50 uniform8 in {secs:.2f} s: '
            f'the manifest\'s (m, e) rebuild all {n} of the engine\'s float32 '
            f'multipliers, the npz equals the model\'s {len(fm.tensors)} '
            f'tensors')


# ---------------------------------------------------------------------------
# phase 16: the deployment surface — deploy CLI, host preprocessing, the
# per-stage profile, production routes, the autotuned routing tables
# ---------------------------------------------------------------------------

DEPLOY_NODE = 'stage2.unit1.quant_act_int32'
# production-route readings: batches, alternating runs per input mode
ROUTE_BATCHES = (8, 64)
ROUTE_RUNS = 20
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# the routed paths: (arch, input mode, carrier), 224² (InceptionV3 299²)
ROUTED = (('resnet50', 'folded_float32', torch.int16),
          ('mobilenetv2', 'folded_float32', torch.int16),
          ('inceptionv3', 'folded_float32', torch.int32))


def deploy_cli(args, what):
    """``python -m hawq_tpu_torch.deploy`` in a process of its own, on the
    card → its stdout lines."""
    r = subprocess.run([sys.executable, '-m', 'hawq_tpu_torch.deploy',
                        *args], cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    check(r.returncode == 0, f'phase 16: deploy {what}: rc {r.returncode}\n'
          f'{r.stdout[-2000:]}\n{r.stderr[-3000:]}')
    return r.stdout.splitlines()


def deploy_main(args):
    """``deploy.main(args)`` in this process → (rc, stdout lines)."""
    import io
    from hawq_tpu_torch import deploy
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = deploy.main(args)
    return rc, buf.getvalue().splitlines()


def topk_lines(logits, k=5):
    top = np.argsort(logits.numpy(), axis=-1)[:, ::-1][:, :k]
    return [f'image {i}: top-{k} classes {r.tolist()}'
            for i, r in enumerate(top)]


def deploy_cli_phase(tmp):
    """The CLI as a user runs it, in a process of its own, on ResNet-50
    uniform8 b8 224² (synthetic weights, seed 0, the auto route): top-5 of
    all 8 images equal to the CPU engine's, ``--time``, ``--export-onnx``;
    then, through ``deploy.main`` in this process, a capture on the host
    fold (numpy, as ``utils.preproc`` runs it) saved and compared against
    the CPU engine's golden, and MobileNetV2 w1 and InceptionV3 w1 b2 on
    their routes and InceptionV3 also on the native fold, top-5 equal to
    the CPU engine's → the ``--time`` reading."""
    from hawq_tpu_torch import deploy
    from hawq_tpu_torch.configs.bit_config import get_bit_config
    from hawq_tpu_torch.export.qonnx import load_qonnx
    from hawq_tpu_torch.utils import preproc
    fm = deploy.synthetic_frozen('resnet50',
                                 get_bit_config('resnet50', 'uniform8'))
    mode = deploy.PRODUCTION_ROUTE[0]
    x = np.random.RandomState(0).rand(BATCH, SIZE, SIZE, 3).astype(
        np.float32)
    xin = preproc.fold4_images(x) if mode == 'folded_float32' else x
    nodes = {}
    t0 = time.perf_counter()
    cpu = deploy.build_engine_for(fm, input_mode=mode, device='cpu')
    logits = cpu._forward(torch.from_numpy(xin),
                          lambda n, v: nodes.__setitem__(n, v))
    cpu_s = time.perf_counter() - t0
    golden = os.path.join(tmp, 'cpu_golden.npy')
    np.save(golden, nodes[DEPLOY_NODE].numpy())
    onnx = os.path.join(tmp, 'resnet50.onnx')
    base = ['--arch', 'resnet50', '--scheme', 'uniform8', '--batch',
            str(BATCH), '--image-size', str(SIZE)]
    t0 = time.perf_counter()
    out = deploy_cli(base + ['--time', '--export-onnx', onnx], 'classify')
    cli_s = time.perf_counter() - t0
    got = [l for l in out if l.startswith('image ')]
    check(got == topk_lines(logits), f'phase 16: deploy top-5 {got} differ '
          f'from the CPU engine\'s {topk_lines(logits)}')
    check(('host_preprocessing=numpy' in out) == (mode == 'folded_float32'),
          f'phase 16: deploy printed another host fold: {out[:3]}')
    timed = json.loads(out[-1])
    check(timed['batch'] == BATCH and timed['ms_per_batch'] > 0,
          f'phase 16: --time printed {out[-1]}')
    check(len(load_qonnx(onnx).graph.node) > 100, 'phase 16: the exported '
          'ONNX graph is too small')
    card = os.path.join(tmp, 'card.npy')
    rc, out = deploy_main(base + ['--capture', DEPLOY_NODE, '--save-capture',
                                  card, '--compare', golden, '--input-mode',
                                  'folded_float32'])
    check(rc == 0 and any(l.startswith('100% matched!') for l in out)
          and 'host_preprocessing=numpy' in out,
          f'phase 16: deploy --compare: {out}')
    check(np.array_equal(np.load(card), np.load(golden)), 'phase 16: the '
          'saved capture differs from the CPU golden')
    log(f'phase 16: python -m hawq_tpu_torch.deploy resnet50 uniform8 '
        f'b{BATCH} {SIZE}x{SIZE} (auto route {mode}): top-5 of all '
        f'{BATCH} images == CPU engine ({cpu_s:.1f} s on the CPU), '
        f'--time {json.dumps(timed)}, --export-onnx '
        f'{os.path.getsize(onnx) / 1e6:.1f} MB, {cli_s:.1f} s in its own '
        f'process; in this one {DEPLOY_NODE} on the host fold '
        f'(folded_float32, numpy) "100% matched!" against the CPU golden')
    for arch, size, mode in (('mobilenetv2', SIZE, None),
                             ('inceptionv3', INC_SIZE, None),
                             ('inceptionv3', INC_SIZE, 'folded_float32')):
        fm = deploy.synthetic_frozen(arch, get_bit_config(arch, 'uniform8'))
        args = ['--arch', arch, '--scheme', 'uniform8', '--batch', '2',
                '--image-size', str(size)]
        if mode is None:
            mode = deploy.PRODUCTION_ROUTE[0]
        else:
            args += ['--input-mode', mode]
        rc, out = deploy_main(args)
        check(rc == 0, f'phase 16: deploy {arch}: rc {rc}')
        x = np.random.RandomState(0).rand(2, size, size, 3).astype(
            np.float32)
        eng_kw = {'input_hw': (size, size)}
        if mode == 'folded_float32':
            x = preproc.fold4_images_3x3s2(x, 0)
            check('host_preprocessing=native' in out,
                  f'phase 16: deploy {arch} did not fold natively')
        want = topk_lines(deploy.build_engine_for(
            fm, input_mode=mode, device='cpu', **eng_kw)(x))
        got = [l for l in out if l.startswith('image ')]
        check(got == want, f'phase 16: deploy {arch} top-5 {got} differ '
              f'from the CPU engine\'s {want}')
        log(f'phase 16: deploy {arch} uniform8 b2 ({mode}): top-5 == CPU '
            f'engine')
    return timed


@contextlib.contextmanager
def numpy_preprocessing():
    """Inside, ``utils.preproc`` takes its numpy paths."""
    from hawq_tpu_torch.utils import preproc
    load = preproc._load
    preproc._load = lambda: None
    try:
        yield
    finally:
        preproc._load = load


def host_prep_phase():
    """Host ms per b8 batch of each function of ``utils.preproc`` that the
    serving paths run, 5 rounds of 4 runs, the median; where it has a native
    path (``preprocess_batch``, ``fold4_images_3x3s2``) that and the numpy
    path in turns (native, numpy, numpy, native), the native results equal
    to the numpy ones (``preprocess_batch``'s resizes differ)."""
    from hawq_tpu_torch.utils import preproc
    check(preproc.native_available(), 'phase 16: the native preprocessing '
          'library did not build')
    rng = np.random.RandomState(11)
    x224 = rng.rand(BATCH, 224, 224, 3).astype(np.float32)
    x299 = rng.rand(BATCH, 299, 299, 3).astype(np.float32)
    u8 = rng.randint(0, 256, (BATCH, 256, 341, 3)).astype(np.uint8)
    f224 = preproc.fold4_images(x224)
    # label → (fn, whether it has a native path)
    ops = {'fold4_images b8 224x224x3 f32':
           (lambda: preproc.fold4_images(x224), False),
           'fold4_images_3x3s2 p0 b8 299x299x3 f32':
           (lambda: preproc.fold4_images_3x3s2(x299, 0), True),
           'quantize_int8 b8 folded 224':
           (lambda: preproc.quantize_int8(f224, 0.0517), False),
           'preprocess_batch b8 uint8 256x341 -> 224':
           (lambda: preproc.preprocess_batch(u8, 256, 224, IMAGENET_MEAN,
                                             IMAGENET_STD), True)}
    out = {}
    for label, (fn, native) in ops.items():
        paths = ('native', 'numpy', 'numpy', 'native') if native else (
            'numpy',) * 4
        if native:
            got = fn()
            with numpy_preprocessing():
                plain = fn()
            if label.startswith('preprocess_batch'):
                check(got.shape == plain.shape
                      and bool(np.isfinite(got).all()),
                      f'phase 16: {label}: {got.shape} / {plain.shape}')
            else:
                check(np.array_equal(got, plain), f'phase 16: {label}: '
                      f'native differs from numpy')
        ms = {p: [] for p in paths}
        for _ in range(5):
            for path in paths:
                with (numpy_preprocessing() if path == 'numpy'
                      else contextlib.nullcontext()):
                    t0 = time.perf_counter()
                    fn()
                    ms[path].append((time.perf_counter() - t0) * 1e3)
        out[label] = {p: float(np.median(v)) for p, v in ms.items()}
        log(f'phase 16: host {label}: ' + ', '.join(
            f'{p} {v:.3f} ms' for p, v in out[label].items())
            + f' per batch ({os.cpu_count()} host cores)')
    return out


def profile_phase(fm, x, dev):
    """``profile_engine`` on the main path (cumulative and segment ms per
    stage, CUDA events, 20 forwards a window), then the whole forward beside
    the bound of ``engine_flops_and_bytes`` (its unit convs' int8 operations
    and weight bytes, with the input read and the logits written once)."""
    from hawq_tpu_torch.inference.profile import (engine_flops_and_bytes,
                                                  profile_engine)
    rows = profile_engine(fm, x, verbose=False, n_iters=20, device=dev,
                          input_mode='folded_float32',
                          residual_dtype=torch.int16)
    for node, cum, seg in rows:
        log(f'phase 16: profile {node:32s} cum {cum * 1e3:8.3f} ms   seg '
            f'{seg * 1e3:8.3f} ms')
    fb = engine_flops_and_bytes(fm, BATCH, SIZE)
    nbytes = (fb['weight_bytes'] + x.numel() * x.element_size()
              + BATCH * fm.num_classes * 4)
    bound = max(nbytes / HBM_BYTES_PER_S, fb['int_ops'] / INT8_OPS_PER_S)
    whole = rows[-1][1]
    by = ('bytes' if nbytes / HBM_BYTES_PER_S > fb['int_ops'] / INT8_OPS_PER_S
          else 'operations')
    log(f"phase 16: the whole forward {whole * 1e3:.3f} ms; "
        f"engine_flops_and_bytes {fb['int_ops'] / 1e9:.2f} G int8 ops, "
        f"{fb['weight_bytes'] / 1e6:.2f} MB of weights: bound "
        f"{bound * 1e3:.4f} ms ({by}), {bound / whole:.3f} of the forward")
    return dict(rows=[(n, c * 1e3, s * 1e3) for n, c, s in rows],
                bound_ms=bound * 1e3, **fb)


def production_routes(dev):
    """ms per batch of each family's float-image input modes where its
    deploy accepts more than one (ResNet-50 and InceptionV3 w1 uniform8:
    float32 and folded_float32), end to end as ``deploy`` runs a batch: the
    native host fold, the upload, the forward, a sync (host clock);
    ``ROUTE_RUNS`` runs a mode in alternating order, median and spread."""
    from hawq_tpu_torch import deploy
    from hawq_tpu_torch.configs.bit_config import get_bit_config
    from hawq_tpu_torch.utils import preproc
    rows = {}
    for arch, size in (('resnet50', SIZE), ('inceptionv3', INC_SIZE)):
        fm = deploy.synthetic_frozen(arch, get_bit_config(arch, 'uniform8'))
        for batch in ROUTE_BATCHES:
            raw = np.random.RandomState(batch).rand(
                batch, size, size, 3).astype(np.float32)
            runs = {}
            for mode in ('float32', 'folded_float32'):
                kw = dict(input_mode=mode, device=dev)
                if arch == 'inceptionv3':
                    kw['input_hw'] = (size, size)
                    if batch >= 32:
                        kw['wide_dtype'] = torch.int16
                eng = deploy.build_engine_for(fm, **kw)
                fold = (None if mode == 'float32' else
                        preproc.fold4_images if arch == 'resnet50' else
                        (lambda a: preproc.fold4_images_3x3s2(a, 0)))

                def run(eng=eng, fold=fold):
                    t0 = time.perf_counter()
                    x = raw if fold is None else fold(raw)
                    t1 = time.perf_counter()
                    eng(torch.from_numpy(x).to(dev))
                    torch.cuda.synchronize()
                    return time.perf_counter() - t0, t1 - t0
                run()
                runs[mode] = (run, [], [])
            order = list(runs)
            for i in range(ROUTE_RUNS):
                for mode in (order if i % 2 == 0 else order[::-1]):
                    total, fold_s = runs[mode][0]()
                    runs[mode][1].append(total * 1e3)
                    runs[mode][2].append(fold_s * 1e3)
            row = {m: dict(median=float(np.median(t)), lo=float(min(t)),
                           hi=float(max(t)), fold=float(np.median(f)))
                   for m, (_, t, f) in runs.items()}
            rows[f'{arch} b{batch}'] = row
            log(f'phase 16: route {arch} uniform8 b{batch} {size}x{size}, '
                f'{ROUTE_RUNS} runs a mode in turns (host fold + upload + '
                f'forward + sync, host clock): ' + '; '.join(
                    f"{m} median {r['median']:.3f} ms [{r['lo']:.3f}, "
                    f"{r['hi']:.3f}] (host fold {r['fold']:.3f})"
                    for m, r in row.items())
                + f"; deploy's route {deploy.PRODUCTION_ROUTE[0]}")
            del runs
    return rows


def routed_turns(calls, label):
    """Each distinct packed call of a routed path (the calls on ``int4w_*``)
    beside its int8 twin (the same call on the weights unpacked once to
    int8, on the same core) in turns (packed, twin, twin, packed; CUDA-graph
    replay), the twin held against the plain version → per kernel: launches,
    launches per core, ms, twin ms and bound summed over the path."""
    from hawq_tpu_torch.kernels import conv as kc
    from hawq_tpu_torch.kernels import matmul as km
    seen = {}
    for name, args, kw in calls:
        key = call_key(name, args, kw)
        if key not in seen:
            core = 'mma' if sm90_rule(name, args, kw) else 'sm90'
            plain_w = unpacked_weights(name, args, kw)
            twin_w = plain_w
            if core == 'sm90':
                twin_w = (kc.prepare_conv_weights(
                    plain_w, kw['taps'], kw['cin'], kw.get('pad', (0, 0)))
                    if '_conv' in name else km.prepare_weights(plain_w))
            twin_args = (args[0], twin_w) + tuple(args[2:])
            runs = (lambda: kernel_call(name, args, kw, False),
                    lambda: kernel_call(twin_name(name), twin_args, kw,
                                        False))
            out = runs[0]()
            check(same(runs[1](), plain_call(name, args, kw)),
                  f'phase 16: {twin_name(name)} twin differs at {key[1]}')
            ms = ([], [])
            for i in (0, 1, 1, 0):
                ms[i].append(graph_ms(runs[i], 20))
            nbytes, ops, shape = work(name, args, kw, out)
            seen[key] = dict(name=name, core=core, shape=shape, n=0,
                             ms=sum(ms[0]) / 2, twin_ms=sum(ms[1]) / 2,
                             bound_ms=max(nbytes / HBM_BYTES_PER_S,
                                          ops / INT8_OPS_PER_S) * 1e3)
        seen[key]['n'] += 1
    totals = {}
    for row in seen.values():
        t = totals.setdefault(row['name'], dict(launches=0, cores={}, ms=0.0,
                                                int8_twin_ms=0.0,
                                                bound_ms=0.0))
        t['launches'] += row['n']
        t['cores'][row['core']] = t['cores'].get(row['core'], 0) + row['n']
        for k in ('ms', 'bound_ms'):
            t[k] += row[k] * row['n']
        t['int8_twin_ms'] += row['twin_ms'] * row['n']
    for name, t in totals.items():
        log(f"phase 16: {label}: {name} x{t['launches']} (per core "
            f"{t['cores']}) {t['ms']:.4f} ms, its int8 twin "
            f"{t['int8_twin_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"summed over the path")
    return totals


def table_summary(table, default, routable):
    """Sites, the choices, and µs saved per forward by the table over the
    engine's rule without one (``default(key)``: 'int4w' or 'int8'), over
    the sites the engine routes (``routable``)."""
    keys = [k for k in table if not k.startswith('_')]
    us = table['_us']
    saved = sum(us[k][default(k)] - us[k][table[k]] for k in keys
                if routable(k))
    chose = {r: sum(table[k] == r for k in keys) for r in ('int8', 'int4w')}
    return dict(sites=len(keys), routed=sum(map(routable, keys)),
                chose=chose, saved_us=saved,
                default_us=sum(us[k][default(k)] for k in keys
                               if routable(k)))


# the model the routed engines' nodes are held on (``image_dependent``):
# 4-bit layers' weight scales times this, every bias shifted right by that
ROUTED_WEIGHT_SCALE, ROUTED_BIAS_SHIFT = 32, 8


def image_dependent(fm):
    """``fm`` made to depend on its image at every node, for the routed
    engines' node checks: its 4-bit activations at 8 bits, its 4-bit layers'
    weight scales ×``ROUTED_WEIGHT_SCALE``, its biases shifted right by
    ``ROUTED_BIAS_SHIFT``.  Synthetic uniform4 models (4-bit weights of
    small magnitude against biases up to ±2^16, 4-bit activations) give the
    same node for every image past ResNet-50's stage 2, MobileNetV2's first
    unit and InceptionV3's init block (PERF.md §6), where a wrong route could
    not show.  The routes read only the weights' bits and shapes, which
    stay."""
    from hawq_tpu_torch.configs.bit_config import BitConfig
    acts = {k[:-len('.act_scale')] for k in fm.tensors
            if k.endswith('.act_scale')}
    cfg = BitConfig(f'{fm.cfg.name}_a8', {
        k: 8 if k in acts and b == 4 else b for k, b in fm.cfg.table.items()},
        fm.cfg.settings)
    tensors = {}
    for k, v in fm.tensors.items():
        if k.endswith('.bias_int'):
            v = v >> ROUTED_BIAS_SHIFT
        elif (k.endswith('.weight_scale')
              and cfg.weight_bits(k[:-len('.weight_scale')]) == 4):
            v = v * np.float32(ROUTED_WEIGHT_SCALE)
        tensors[k] = v
    return dataclasses.replace(fm, cfg=cfg, tensors=tensors)


def engine_nodes(eng, x):
    """Every node ``eng``'s forward emits on ``x``, in order, and its
    logits → {name: tensor on the engine's device}."""
    nodes = {}
    logits = eng._forward(x, lambda n, v: nodes.setdefault(n, v.clone()))
    nodes['logits'] = logits
    return nodes


def routing_phase(dev, errs, tmp):
    """``autotune_routing`` on ResNet-50 uniform4 b8 and
    ``autotune_routing_1x1`` on MobileNetV2 w1 and InceptionV3 w1 uniform4 b8,
    the tables written under chiprun_out/ and read back by ``load_routing``
    (as ``deploy --routing`` reads them); each served folded (``ROUTED``):
    launches per kernel and per core as the table predicts, logits equal to
    the CPU engine's and the unrouted card engine's, every recorded call
    against its plain version, the packed calls in turns beside their int8
    twins; MobileNetV2 and InceptionV3 also with every site 'int4w'.  The
    same table also routes ``image_dependent(fm)``: as many packed launches,
    every node the forward emits equal to the unrouted card engine's (8
    images) and the CPU engine's (2 images), and the logits different across
    the images.  Then ``deploy --frozen`` of that ResNet-50 with ``--routing``
    captures its deepest node that differs between two images, equal to the
    capture without a table → ({path label: routed totals}, {arch: table
    summary})."""
    from hawq_tpu_torch import deploy
    from hawq_tpu_torch.configs.bit_config import get_bit_config
    from hawq_tpu_torch.inference import autotune as at
    from hawq_tpu_torch.inference import routing as rt
    from hawq_tpu_torch.inference.fold import (fold4_images,
                                               fold4_images_3x3s2)
    from hawq_tpu_torch.kernels import _build
    from hawq_tpu_torch.utils.checkpoint import save_frozen
    routed, summaries = {}, {}
    for arch, mode, carrier in ROUTED:
        size = INC_SIZE if arch == 'inceptionv3' else SIZE
        cfg = get_bit_config('mobilenetv2_w1' if arch == 'mobilenetv2'
                             else arch, 'uniform4')
        fm = deploy.synthetic_frozen(arch, cfg)
        fm_n = image_dependent(fm)
        path = os.path.join(OUT_DIR, f'routing_{arch}_uniform4_b{BATCH}.json')
        if os.path.exists(path):
            os.remove(path)
        t0 = time.perf_counter()
        if arch == 'resnet50':
            at.autotune_routing(fm, BATCH, size, verbose=False,
                                checkpoint_path=path, device=dev)
            default = lambda k: 'int4w' if cfg.weight_bits(k) == 4 else 'int8'
            routable = lambda k: True
        else:
            sites = (rt.mobilenet_conv1x1_sites(image_size=size)
                     if arch == 'mobilenetv2'
                     else rt.inception_conv1x1_sites(size))
            at.autotune_routing_1x1(sites, cfg.weight_bits, BATCH,
                                    verbose=False, checkpoint_path=path,
                                    device=dev)
            default = lambda k: 'int8'
            routable = ((lambda k: True) if arch == 'mobilenetv2' else
                        (lambda k: cfg.act_bits(
                            k[:-len('.q_convbn')] + '.q_activ') <= 8))
        sweep_s = time.perf_counter() - t0
        with open(path) as f:
            raw_table = json.load(f)
        summaries[arch] = dict(table_summary(raw_table, default, routable),
                               sweep_s=sweep_s, file=os.path.relpath(
                                   path, REPO))
        log(f'phase 16: autotune {arch} uniform4 b{BATCH}: {sweep_s:.1f} s, '
            f'{json.dumps(summaries[arch])}')
        table = at.load_routing(path)
        raw = np.random.RandomState(13).randn(BATCH, size, size, 3).astype(
            np.float32)
        if arch == 'resnet50':
            x = torch.from_numpy(fold4_images(raw)).to(dev)
        else:
            x = torch.from_numpy(fold4_images_3x3s2(
                raw, 1 if arch == 'mobilenetv2' else 0)).to(dev)
        tables = [('autotuned', table)]
        if arch != 'resnet50':
            tables.append(('every site int4w',
                           {k: 'int4w' for k in table}))
        for what, tab in tables:
            kw = dict(input_mode=mode)
            if arch == 'resnet50':
                kw['residual_dtype'] = carrier
                counts = expected_launches('resnet50', cfg, mode, routing=tab)
                want = (counts, core_split(counts))
            else:
                if arch == 'mobilenetv2':
                    kw.update(residual_dtype=carrier, input_hw=(size, size))
                    w = expected_mobilenet_launches(fm, mode, routing=tab)
                else:
                    kw.update(wide_dtype=carrier, input_hw=(size, size))
                    w = expected_inception_launches(fm, mode, routing=tab)
                want = (w.counts, w.cores)
            label = (f'{arch} uniform4 {mode} '
                     f'{str(carrier).replace("torch.", "")} b{BATCH}, '
                     f'{what} table')
            calls = []
            t0 = time.perf_counter()
            eng, counts = engine_check(
                functools.partial(deploy.build_engine_for, fm, routing=tab,
                                  **kw), x, *want, (),
                label, dev, 'phase 16', calls)
            plain = deploy.build_engine_for(fm, device=dev, **kw)
            check(torch.equal(eng(x), plain(x)), f'phase 16: {label}: logits '
                  f'differ from the unrouted engine\'s')
            got = engine_nodes(eng, x)
            vary4 = [n for n, v in got.items() if bool((v != v[:1]).any())]
            del eng, plain, got
            check_calls(calls, errs, f'phase 16: all {len(calls)} recorded '
                        f'calls of {label}')
            n4 = sum(v for k, v in counts.items() if k.startswith('int4w'))
            eng = deploy.build_engine_for(fm_n, routing=tab, device=dev, **kw)
            eng(x)
            _build.reset_launches()
            got = engine_nodes(eng, x)
            torch.cuda.synchronize()
            n4_n = sum(v for k, v in _build.LAUNCHES.items()
                       if k.startswith('int4w'))
            want_n = engine_nodes(deploy.build_engine_for(fm_n, device=dev,
                                                          **kw), x)
            cpu = engine_nodes(deploy.build_engine_for(
                fm_n, routing=tab, device='cpu', **kw), x[:2].cpu())
            check(n4_n == n4, f'phase 16: {label}: image_dependent model: '
                  f'{n4_n} packed launches, the table gives {n4}')
            check(list(got) == list(want_n) == list(cpu), f'phase 16: '
                  f'{label}: the engines emit other nodes')
            bad = [n for n, v in got.items() if not torch.equal(v, want_n[n])
                   or not torch.equal(v[:2].cpu(), cpu[n])]
            check(not bad, f'phase 16: {label}: {len(bad)} nodes differ from '
                  f'the unrouted card engine or the CPU engine: {bad[:5]}')
            varying = [n for n, v in got.items() if bool((v != v[:1]).any())]
            check('logits' in varying, f'phase 16: {label}: the '
                  f'image_dependent logits are the same for all {BATCH} '
                  f'images ({len(varying)} of {len(got)} nodes vary)')
            if arch == 'resnet50' and what == 'autotuned':
                deploy_node = [n for n in varying if n != 'logits' and not
                               torch.equal(got[n][0], got[n][1])][-1]
                deploy_want = got[deploy_node][:2].cpu().numpy()
            log(f'phase 16: {label}: logits == unrouted card engine, '
                f'{n4} packed launches, {len(vary4)} of its {len(got)} nodes '
                f'and logits vary across the {BATCH} images (the deepest '
                f'{vary4[-1] if vary4 else None}); the table on '
                f'image_dependent(fm): {n4_n} '
                f'packed launches, logits and all {len(got) - 1} nodes == '
                f'unrouted card engine ({BATCH} images) and CPU engine (2 '
                f'images), {len(varying)} of {len(got)} vary; served and '
                f'checked in {time.perf_counter() - t0:.1f} s')
            del eng, got, want_n, cpu
            routed[label] = routed_turns(
                [c for c in calls if c[0].startswith('int4w')], label)
            del calls
        if arch == 'resnet50':
            frozen = os.path.join(tmp, 'resnet50_image_dependent.npz')
            save_frozen(frozen, fm_n)
    node = deploy_node
    img = os.path.join(tmp, 'routing_images.npy')
    np.save(img, np.random.RandomState(13).randn(2, SIZE, SIZE, 3).astype(
        np.float32))              # the first two images of the routed runs
    args = ['--frozen', frozen, '--classify', img, '--image-size', str(SIZE),
            '--input-mode', 'folded_float32', '--capture', node]
    caps = [os.path.join(tmp, f'routing_{i}.npy') for i in range(2)]
    rc, out = deploy_main(args + ['--save-capture', caps[0]])
    rc2, out2 = deploy_main(args + ['--save-capture', caps[1], '--routing',
                                    os.path.join(OUT_DIR, f'routing_resnet50_'
                                                 f'uniform4_b{BATCH}.json')])
    cap = [np.load(c) for c in caps]
    check(rc == rc2 == 0 and np.array_equal(*cap)
          and np.array_equal(cap[0], deploy_want),
          f'phase 16: deploy --routing captures {node} otherwise: {out2} / '
          f'{out}')
    log(f'phase 16: deploy --frozen (resnet50 image_dependent) b2 --routing '
        f'(the autotuned table): {node} equal to the capture without one and '
        f'to the routed engine\'s, and differs between the 2 images')
    return routed, summaries


def deployment_phase(fm, folded, dev, errs):
    """Phase 16 → the numbers of the JSON line ``deploy``, with the seconds
    each part took."""
    os.makedirs(OUT_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix='deploy_', dir=OUT_DIR)
    seconds = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(f'phase 16: {name} took {seconds[name]:.1f} s')
        return out
    try:
        timed = part('deploy_cli', deploy_cli_phase, tmp)
        host = part('host_preprocessing', host_prep_phase)
        prof = part('profile', profile_phase, fm, folded, dev)
        routes = part('production_routes', production_routes, dev)
        routed, tables = part('routing', routing_phase, dev, errs, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f'phase 16: {sum(seconds.values()):.1f} s: ' + ', '.join(
        f'{k} {v:.1f}' for k, v in seconds.items()))
    return dict(deploy_time=timed, host_preprocessing_ms=host, profile=prof,
                production_routes=routes, routing_tables=tables,
                routed_paths=routed, seconds=seconds)


def main():
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: torch.cuda.is_available() is false; this '
                 'script needs an NVIDIA GPU')
    if not os.path.isdir(os.path.join(REPO, 'hawq_tpu_torch', 'kernels',
                                      'csrc')):
        sys.exit('chip_smoke: run from a checkout of the repository (no '
                 'hawq_tpu_torch/ beside this script)')
    sys.path.insert(0, REPO)
    from hawq_tpu_torch.configs.bit_config import get_bit_config
    from hawq_tpu_torch.inference.engine import build_resnet_engine
    from hawq_tpu_torch.inference.fold import fold4_images
    from hawq_tpu_torch.inference.synthetic import synthetic_frozen_resnet
    from hawq_tpu_torch.kernels import _build
    from hawq_tpu_torch.quant.ops import exact_div
    from hawq_tpu_torch.utils.preproc import quantize_int8
    dev = torch.device('cuda')
    t_start = time.perf_counter()

    # ---- phase 1 ----
    log(f'phase 1: python {sys.version.split()[0]} torch {torch.__version__} '
        f'cuda {torch.version.cuda}')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])

    # ---- phase 2 ----
    _build.lib()
    info = _build.build_info
    log(f"phase 2: kernels built in {info['seconds']:.1f} s "
        f"(cached {info['cached']}) -> {os.path.relpath(info['path'], REPO)}")
    for line in str(info['log']).splitlines():
        entry = re.search(r"entry function '(\w+)'", line)
        if entry:                     # the mangled name, its template values
            log('  ' + entry.group(1)[:96])
        if 'registers' in line or 'spill' in line or line.startswith('---'):
            log('  ' + line.strip())

    # ---- phase 3: the serving paths, recorded ----
    fms = {(arch, scheme): synthetic_frozen_resnet(
        arch, get_bit_config(arch, scheme), seed=0)
        for arch, scheme in PATHS}
    raw = np.random.RandomState(1).randn(BATCH, SIZE, SIZE, 3).astype(
        np.float32)
    raw_u8 = np.random.RandomState(2).randint(
        0, 256, (BATCH, SIZE, SIZE, 3)).astype(np.uint8)
    folded = torch.from_numpy(fold4_images(raw)).to(dev)
    recorded = {path: record_path(fms[path], folded, dev) for path in PATHS}
    report = {}                      # kernel → the first path that ran it
    for path in PATHS:
        for name in recorded[path][1]:
            report.setdefault(name, path)
    check(set(report) == set(SERVING_KERNELS), f'kernels launched on no '
          f'path: {set(SERVING_KERNELS) - set(report)}')
    x = torch.randn(1 << 22, generator=torch.Generator().manual_seed(0)) * 4
    for s in (np.float32(0.0517), 49):
        check(torch.equal(exact_div(x.to(dev), s).cpu(), exact_div(x, s)),
              'exact_div on the card differs from the CPU')
    errs = {name: 0.0 for name in KERNELS}
    n_recorded = sum(len(recorded[path][0]) for path in PATHS)
    ragged = ragged_calls(dev)
    check_calls([c for path in PATHS for c in recorded[path][0]] + ragged,
                errs, f'phase 3: all {n_recorded} recorded and {len(ragged)} '
                f'ragged calls')
    sm90_rule_phase(dev, errs)
    totals = {}
    for path in PATHS:
        log(f'phase 3: timed on {path[0]} {path[1]}:')
        time_calls([c for c in recorded[path][0] if report[c[0]] == path],
                   totals)
    calls_kept = sum(len(recorded[p][0]) for p in PATHS)
    launches = {name: recorded[path][1][name] for name, path in report.items()}
    launches[POOL] = pool_phase(recorded['resnet50', 'uniform8'][0], errs,
                                totals)
    conv1_calls = [c for c in recorded['resnet50', 'uniform8'][0]
                   if c[0] == 'int8_matmul_requant']
    del recorded

    # ---- phase 4 ----
    variants = [('resnet50', 'uniform8', 'folded_float32', torch.int16),
                ('resnet50', 'uniform8', 'float32', torch.int32),
                ('resnet50', 'uniform4', 'folded_float32', torch.int16),
                ('resnet50', 'uniform4', 'float32', torch.int32),
                ('resnet50', 'bops_0.5', 'folded_float32', torch.int16),
                ('resnet18', 'uniform4', 'folded_float32', torch.int16),
                ('resnet50', 'uniform4', 'uint8', torch.int16),
                ('resnet50', 'uniform4', 'folded_int8', torch.int16)]
    engines = {}
    for arch, scheme, mode, residual in variants:
        fm = fms[arch, scheme]
        engines[arch, scheme, mode] = engine_phase(
            fm, engine_input(fm, mode, raw, raw_u8, dev), mode, residual, dev)
    raw_pool_cost(engines, fms, raw, raw_u8, dev)
    for scheme in ('uniform8', 'uniform4'):     # W8A8 and W4A4 serving
        eng = engines['resnet50', scheme, 'folded_float32']
        old_engine = engine_both_cores(fms['resnet50', scheme], folded, eng,
                                       dev)
        with first_core():
            trace_breakdown(old_engine, folded, f'resnet50 {scheme} '
                            f'folded_float32 int16 on the first core')
        del old_engine
        init_block_before_after(eng, folded,
                                f'resnet50 {scheme} folded_float32 int16')

    # ---- phase 5 ----
    serving_phase(engines['resnet50', 'uniform8', 'folded_float32'],
                  fold4_images, 'resnet50 uniform8 folded_float32', dev)
    fm = fms['resnet50', 'bops_0.5']
    s_in = fm.act_scale('quant_input')
    serving_phase(build_resnet_engine(fm, input_mode='folded_int8',
                                      residual_dtype=torch.int16, device=dev),
                  lambda b: quantize_int8(fold4_images(b), s_in),
                  'resnet50 bops_0.5 folded_int8', dev)

    # ---- phase 6 ----
    launches[KBLOCKED], launch_floor = kblocked_phase(conv1_calls, errs,
                                                      totals)
    del conv1_calls

    # ---- phase 7 ----
    train_launches, train_totals, train_batch = training_phase(
        'resnet50', errs, dev)
    launches[MINMAX] = train_launches[MINMAX]
    totals[MINMAX] = train_totals[MINMAX]

    # ---- phase 8: MobileNetV2 serving, D1 ----
    launches[DW_REQUANT] = mobilenet_phase(raw, dev, errs, totals)

    # ---- phase 9: ResNet-50 v2 serving ----
    resnet_v2_phase(raw, dev, errs)

    # ---- phase 10: MobileNetV2 and ResNet-50 v2 training ----
    mnv2_launches, mnv2_totals, mnv2_batch = training_phase(
        'mobilenetv2_w1', errs, dev, timed=(DW_ACC,))
    launches[DW_ACC] = mnv2_launches[DW_ACC]
    totals[DW_ACC] = mnv2_totals[DW_ACC]
    training_phase('resnet50v2', errs, dev, timed=(), steps=2,
                   fix_bn_threshold=1, calib=1)

    # ---- phase 11: InceptionV3 serving, A1 ----
    inc_counts, inc_totals = inception_phase(dev, errs, totals)
    launches[AVGPOOL] = inc_counts[AVGPOOL]

    # ---- phase 12: InceptionV3 training ----
    inc_train_launches, _, inc_batch = training_phase(
        'inceptionv3', errs, dev, timed=(), steps=2, fix_bn_threshold=1,
        calib=1)
    train_label = f'QAT train step resnet50 uniform8 b{train_batch} ' \
                  f'{SIZE}x{SIZE}'
    labels = {name: f'{arch} {scheme} folded_float32 int16 b{BATCH} '
                    f'{SIZE}x{SIZE}' for name, (arch, scheme) in report.items()}
    labels[KBLOCKED] = (f'the 16 int8_matmul_requant calls of resnet50 '
                        f'uniform8 b{BATCH}, driven once through it (on no '
                        f'path of the package)')
    labels[POOL] = (f'the pre-pool tensor of resnet50 uniform8 '
                    f'folded_float32 int16 b{BATCH} {SIZE}x{SIZE} (its init '
                    f'accumulator requantized by the plain version), driven '
                    f'once through it (the folded engine runs {POOL_REQUANT} '
                    f'in its place)')
    labels[MINMAX] = train_label
    labels[DW_REQUANT] = (f'mobilenetv2_w1 uniform8 folded_float32 int16 '
                          f'b{BATCH} {SIZE}x{SIZE}')
    labels[DW_ACC] = (f'QAT train step mobilenetv2_w1 uniform8 '
                      f'b{mnv2_batch} {SIZE}x{SIZE}')
    labels[AVGPOOL] = (f'inceptionv3 {INC_PATHS[0][0]} {INC_PATHS[0][1]} '
                       f'int32 b{BATCH} {INC_SIZE}x{INC_SIZE}')
    inc_train_label = (f'QAT train step inceptionv3 uniform8 b{inc_batch} '
                       f'{TRAIN_SIZE["inceptionv3"]}x'
                       f'{TRAIN_SIZE["inceptionv3"]}')

    # ---- phase 13: the reference-checkpoint replay ----
    ref_launches, launches[AVGPOOL_Q], labels[AVGPOOL_Q] = reference_phase(
        raw, dev, errs, totals)

    # ---- phase 14: sensitivity → allocation → serve ----
    fm_gen, sens_calib, sens_probe, sens_labels = sensitivity_phase(dev, errs)

    # ---- phase 15: export ----
    export_phase(fm_gen, dev)
    del fm_gen

    # ---- phase 16: the deployment surface ----
    deployment = deployment_phase(fms['resnet50', 'uniform8'], folded, dev,
                                  errs)

    # ---- phase 17 ----
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = totals[name]
        entry = dict(
            name=name, route='cuda', source=source, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name],
            ms=t['ms'], plain_ms=t['plain_ms'], bound_ms=t['bound_ms'],
            bound_by=('bytes' if t['bytes'] / HBM_BYTES_PER_S
                      >= t['ops'] / INT8_OPS_PER_S else 'operations'),
            library_ms=t['library_ms'] if t['library_ok'] else None,
            path=labels[name])
        if name in SM90_KERNELS:
            entry.update(core='sm90', old_ms=t['old_ms'],
                         host_us_per_call=t['host_us'] / launches[name],
                         old_host_us_per_call=(t['old_host_us']
                                               / launches[name]))
            if not t['library_ok'] and t['library_calls']:
                entry.update(library_partial_ms=t['library_ms'],
                             library_partial_calls=t['library_calls'])
            if name.startswith('int4w'):
                entry[f'{twin_name(name)}_on_unpacked_weights_ms'] = t[
                    'int8_twin_ms']
        if name in POOLS + OWN_CORE:  # ms: the input L2-resident
            entry['cold_ms'] = t['cold_ms']
        if name == AVGPOOL:           # phase 11: the fusion in turns
            entry.update({f'{k}_turns_ms': t[k] for k in (
                'fused', 'unfused', 'plain', 'library', 'elementwise')})
            entry.update({k: t[k] for k in (
                'kernels_per_forward', 'kernels_per_forward_unfused')
                if k in t})
        if name in INC_GEMMS:
            # the InceptionV3 engine's main path (phase 11)
            it = inc_totals[name]
            entry.update(inception_path=labels[AVGPOOL],
                         inception_launches=inc_counts[name],
                         inception_ms=it['ms'],
                         inception_plain_ms=it['plain_ms'],
                         inception_bound_ms=it['bound_ms'],
                         inception_library_ms=(it['library_ms']
                                               if it['library_ok'] else None),
                         inception_old_ms=it['old_ms'])
        if name in ('int8_conv_acc', 'int8_matmul_acc', MINMAX):
            entry.update(inception_train_path=inc_train_label,
                         inception_train_launches=inc_train_launches[name])
        if name == KBLOCKED:
            entry['smallest_launch_ms'] = launch_floor
        for label, totals_r in deployment['routed_paths'].items():
            if name in totals_r:      # phase 16: routed by a table
                entry.setdefault('routed_paths', []).append(
                    dict(path=label, **totals_r[name]))
        if name in ref_launches:     # phase 13's paths, synthetic weights
            entry['reference_launches'] = ref_launches[name]
        for arch in sens_probe:      # phase 14: calibration, HVP probes
            if name in sens_probe[arch] or name in sens_calib[arch]:
                entry.setdefault('sensitivity', []).append(dict(
                    path=sens_labels[arch],
                    calibration_launches=sens_calib[arch].get(name, 0),
                    launches_per_probe=sens_probe[arch].get(name, 0)))
        if name != MINMAX and name in train_totals:
            # the accumulator kernels' second path: one QAT train step
            tt = train_totals[name]
            entry.update(train_path=train_label,
                         train_launches=train_launches[name],
                         train_ms=tt['ms'], train_plain_ms=tt['plain_ms'],
                         train_bound_ms=tt['bound_ms'],
                         train_library_ms=(tt['library_ms']
                                           if tt['library_ok'] else None))
            if name in SM90_KERNELS:
                entry.update(train_old_ms=tt['old_ms'],
                             train_weight_layout_ms=tt['prep_ms'])
        kernels.append(entry)
    log(json.dumps({'deploy': {k: v for k, v in deployment.items()
                               if k != 'routed_paths'}}))
    log(f'phase 17: all phases passed in '
        f'{time.perf_counter() - t_start:.1f} s '
        f'({calls_kept} recorded kernel calls; kernel ms, plain_ms, bound_ms '
        f'and library_ms are totals over one forward, or one train step, of '
        f'the path named in each entry)')
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
