"""The deployment CLI (port of hawq_tpu/deploy.py): load a frozen integer
artifact, or build one with synthetic weights, and drive it on the card.

  python -m hawq_tpu_torch.deploy --frozen run/quantized_checkpoint.npz \\
      [--classify img.npy] [--time] [--batch 8] \\
      [--capture stage1.unit1.quant_act_int32 --save-capture out.npy] \\
      [--compare golden.npy] [--export-onnx model.onnx] \\
      [--routing table.json] [--accuracy val_dir] [--dump-hlo graph.txt] \\
      [--device cpu]

With no --frozen, --arch / --scheme build a synthetic-weight model (seed 0).
The engine runs on the card unless ``--device cpu`` asks for the CPU.  The
host folds of the folded input modes run ``utils.preproc`` (InceptionV3's
native where the box has a C++ compiler, ResNet's numpy; the path is
printed).  ``--dump-hlo`` writes the text of the engine's ``torch.export``
program (``export.export.export_engine``: the engine built here, on the
batch prepared here), as the JAX package writes its compiled program's.
``--conv-mode f32|bf16`` (TPU layout options) exit 2 and say why.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from hawq_tpu_torch.configs.bit_config import BitConfig
from hawq_tpu_torch.inference.freeze import FrozenModel


def build_engine_for(fm: FrozenModel, **kw):
    """The engine of any FrozenModel's family; ``kw`` goes to the family's
    builder (a keyword the family does not take raises TypeError)."""
    arch = fm.arch
    if arch == 'mobilenetv2':
        from hawq_tpu_torch.inference.engine_mobilenet import \
            build_mobilenetv2_engine
        return build_mobilenetv2_engine(fm, **kw)
    if arch == 'inceptionv3':
        from hawq_tpu_torch.inference.engine_inception import \
            build_inceptionv3_engine
        return build_inceptionv3_engine(fm, **kw)
    if arch.endswith('v2'):
        from hawq_tpu_torch.inference.engine_v2 import build_resnet_v2_engine
        return build_resnet_v2_engine(fm, **kw)
    from hawq_tpu_torch.inference.engine import build_resnet_engine
    return build_resnet_engine(fm, **kw)


# (input_mode, conv_mode) of every family and batch: 'float32' images, and
# 'int8', the only conv mode this package has.  On the card the host fold
# costs more than the folded init saves: a batch's host fold, upload,
# forward and sync took, medians of 20 runs a mode in turns (one H100 80GB
# HBM3, 700 W, ``chip_smoke.py`` phase 16; PERF.md "production routes"),
# for ResNet-50 uniform8 11.1 ms on float32 against 14.0 folded at b8
# (spreads overlapping), 28.6 against 45.7 at b64; for InceptionV3 20.8
# against 23.6 at b8, 33.4 against 67.2 at b64.  Where the spreads overlap
# the rule takes 'float32', which has no host fold.  Neither the family nor
# the batch decides it (the JAX package's production_route(fm, batch) reads
# both), nor InceptionV3's wide containers: the engine's own default
# (``engine_inception.default_wide_dtype``) picks them, so that this CLI
# and ``build_engine_for`` build the same engine.
PRODUCTION_ROUTE = ('float32', 'int8')


def default_image_size(fm: FrozenModel) -> int:
    from hawq_tpu_torch.configs.bit_config import RESNET_CIFAR_ARCHS
    if fm.arch == 'inceptionv3':
        return 299
    return 32 if fm.arch in RESNET_CIFAR_ARCHS else 224


def synthetic_frozen(arch: str, cfg: BitConfig) -> FrozenModel:
    """A synthetic-weight FrozenModel (seed 0) of any supported arch."""
    from hawq_tpu_torch.configs.bit_config import RESNET_UNITS
    from hawq_tpu_torch.inference import synthetic as syn
    if arch in ('mobilenetv2', 'mobilenetv2_w1'):
        return syn.synthetic_frozen_mobilenet(cfg)
    if arch == 'inceptionv3':
        return syn.synthetic_frozen_inception(cfg)
    if arch.endswith('v2') and arch[:-2] in RESNET_UNITS:
        return syn.synthetic_frozen_resnet_v2(arch, cfg)
    return syn.synthetic_frozen_resnet(arch, cfg)


def _load_frozen_or_synthetic(args) -> FrozenModel:
    from hawq_tpu_torch.configs.bit_config import get_bit_config
    if getattr(args, 'import_reference', None):
        # the reference's quantized_checkpoint.pth.tar hand-off artifact
        from hawq_tpu_torch.utils.checkpoint import load_reference_quantized
        return load_reference_quantized(
            args.import_reference, args.arch,
            get_bit_config(args.arch, args.scheme))
    if args.frozen:
        from hawq_tpu_torch.utils.checkpoint import load_frozen
        return load_frozen(args.frozen)
    return synthetic_frozen(args.arch, get_bit_config(args.arch, args.scheme))


def _fail(msg: str) -> int:
    sys.stderr.write(msg + '\n')
    return 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description='hawq-tpu deployment CLI '
                                            '(PyTorch / CUDA)')
    p.add_argument('--frozen', help='quantized_checkpoint.npz path')
    p.add_argument('--import-reference',
                   help="reference quantized_checkpoint.pth.tar to import "
                        "(needs --arch/--scheme for the bit config)")
    p.add_argument('--requant-mode', default='native',
                   choices=['native', 'reference'],
                   help="'reference': replay with the reference's 31-bit / "
                        "float64 dyadic rounding (imported checkpoints; not "
                        "the ResNet v2 engine)")
    p.add_argument('--arch', default='resnet50',
                   help='synthetic-weight arch when no --frozen')
    p.add_argument('--scheme', default='uniform8')
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--image-size', type=int, default=None)
    p.add_argument('--classify', help='npy of (H,W,3) f32 or (B,H,W,3)')
    p.add_argument('--topk', type=int, default=5)
    p.add_argument('--time', action='store_true',
                   help='report ms/batch + images/sec (utils.timing)')
    p.add_argument('--capture',
                   help='truncate at this node, emit its integer tensor')
    p.add_argument('--save-capture', help='npy path for --capture output')
    p.add_argument('--compare',
                   help='golden npy; exact integer comparison against the '
                        'capture (the reference --debug-unit flow)')
    p.add_argument('--export-onnx', help='write the QONNX ONNX file here')
    p.add_argument('--export-reference',
                   help='write the model as a reference-format '
                        'quantized_checkpoint.pth.tar')
    p.add_argument('--routing',
                   help="routing table JSON of this card's routes "
                        "(python -m hawq_tpu_torch.inference.autotune)")
    p.add_argument('--accuracy',
                   help='val ImageFolder dir: run the integer engine over '
                        'the dataset and report top-1/top-5')
    p.add_argument('--max-batches', type=int, default=None)
    p.add_argument('--print-freq', type=int, default=10)
    p.add_argument('--dump-hlo',
                   help="write the engine's torch.export graph (its kernels "
                        "as torch.ops.hawq.* nodes) as text to this path")
    p.add_argument('--input-mode', default='auto',
                   choices=['auto', 'float32', 'folded_float32', 'uint8'],
                   help='engine input path; folded_* folds on host '
                        '(resnet: fold4, inception: fold4_3x3s2).  auto '
                        'picks PRODUCTION_ROUTE')
    p.add_argument('--conv-mode', default='auto',
                   choices=['auto', 'int8', 'f32', 'bf16'],
                   help="int8 (auto): the port's kernels; f32 / bf16 are "
                        "TPU layout options and exit 2")
    p.add_argument('--device', default='cuda',
                   help="the engine's device: the card (default), or cpu")
    args = p.parse_args(argv)

    if args.conv_mode in ('f32', 'bf16'):
        return _fail(f'--conv-mode {args.conv_mode} is a TPU layout option '
                     f'(float containers for the TPU\'s convolutions); this '
                     f'package runs its int8 kernels only')
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        return _fail('no CUDA device: the engine runs on the card; pass '
                     '--device cpu for the CPU')
    fm = _load_frozen_or_synthetic(args)
    size = args.image_size or default_image_size(fm)
    if args.input_mode == 'auto':
        args.input_mode = PRODUCTION_ROUTE[0]
    from hawq_tpu_torch.inference.freeze import model_size_bytes
    print(f'arch={fm.arch} scheme={fm.cfg.name} classes={fm.num_classes} '
          f'tensors={len(fm.tensors)} image_size={size} '
          f'deployed_size={model_size_bytes(fm) / 1e6:.2f}MB')
    print(f'device={device}' + (f' ({torch.cuda.get_device_name(device)})'
                                if device.type == 'cuda' else ''))

    if args.export_onnx:
        from hawq_tpu_torch.export.qonnx import export_qonnx
        export_qonnx(fm, args.export_onnx, image_size=size)
        print(f'exported ONNX → {args.export_onnx}')

    if args.export_reference:
        from hawq_tpu_torch.utils.checkpoint import save_reference_quantized
        save_reference_quantized(args.export_reference, fm)
        print(f'exported reference-format checkpoint → '
              f'{args.export_reference}')

    v2 = fm.arch != 'mobilenetv2' and fm.arch.endswith('v2')
    kw = dict(device=device)
    if args.requant_mode != 'native':
        if v2:
            return _fail('--requant-mode reference is not supported for the '
                         'pre-activation v2 engine')
        if args.routing:
            return _fail('--requant-mode reference takes no --routing')
        kw['requant_mode'] = args.requant_mode
    if args.routing:
        if v2:
            return _fail('--routing: the pre-activation v2 engine takes no '
                         'routing table')
        from hawq_tpu_torch.inference.autotune import load_routing
        try:
            kw['routing'] = load_routing(args.routing)
        except ValueError as e:
            return _fail(f'--routing {args.routing}: {e}')
    if args.capture:
        kw['capture'] = args.capture

    if args.classify:
        x = np.load(args.classify).astype(np.float32)
        if x.ndim == 3:
            x = x[None]
    else:
        x = np.random.RandomState(0).rand(
            args.batch, size, size, 3).astype(np.float32)

    # input-mode plumbing: the host applies the matching fold
    fold_fn = None
    if args.input_mode != 'float32':
        if fm.arch == 'mobilenetv2' or v2:
            return _fail(f'--input-mode {args.input_mode} is not supported '
                         f'for {fm.arch}')
        kw['input_mode'] = args.input_mode
        if args.input_mode == 'folded_float32':
            from hawq_tpu_torch.utils import preproc
            if fm.arch == 'inceptionv3':
                kw['input_hw'] = (size, size)
                fold_fn = lambda a: preproc.fold4_images_3x3s2(a, 0)
            else:
                fold_fn = preproc.fold4_images
            # fold4_images is numpy only (utils.preproc)
            print('host_preprocessing=' + (
                'native' if fm.arch == 'inceptionv3'
                and preproc.native_available() else 'numpy'))
        elif args.input_mode == 'uint8':
            x = np.clip(x * 255.0, 0, 255).astype(np.uint8)
    if fold_fn is not None:
        x = fold_fn(x)

    engine = build_engine_for(fm, **kw)
    xd = torch.from_numpy(np.ascontiguousarray(x)).to(engine.device)

    if args.dump_hlo:
        from hawq_tpu_torch.export.export import export_engine
        text = str(export_engine(engine, xd))
        with open(args.dump_hlo, 'w') as f:
            f.write(text)
        print(f'dumped exported program ({len(text)} chars) → '
              f'{args.dump_hlo}')

    if args.accuracy:
        if args.input_mode == 'uint8':
            return _fail('--accuracy feeds normalized f32 batches; use '
                         'float32 or folded_float32')
        from hawq_tpu_torch.train.data import ImageFolderLoader
        # keep the tail batch: accuracy covers the whole val set
        loader = ImageFolderLoader(args.accuracy, args.batch, train=False,
                                   image_size=size, drop_remainder=False)
        top1 = top5 = seen = 0
        for i, batch in enumerate(loader.epoch(0)):
            if args.max_batches and i >= args.max_batches:
                break
            img = batch['image']
            if fold_fn is not None:
                img = fold_fn(np.asarray(img))
            logits = engine(img).cpu().numpy()
            lbl = np.asarray(batch['label'])
            pred = np.argsort(logits, axis=-1)[:, ::-1]
            top1 += int((pred[:, 0] == lbl).sum())
            top5 += int((pred[:, :5] == lbl[:, None]).sum())
            seen += len(lbl)
            if (i + 1) % args.print_freq == 0:
                print(f'[{i + 1}] top1 {top1 / seen:.4f} '
                      f'top5 {top5 / seen:.4f} ({seen} images)')
        print(json.dumps({'top1': round(top1 / max(seen, 1), 4),
                          'top5': round(top5 / max(seen, 1), 4),
                          'images': seen}))
        return 0

    out = engine(xd).cpu().numpy()

    if args.capture:
        print(f'capture {args.capture}: shape={out.shape} dtype={out.dtype} '
              f'range=[{out.min()}, {out.max()}]')
        if args.save_capture:
            np.save(args.save_capture, out)
            print(f'saved → {args.save_capture}')
        if args.compare:
            golden = np.load(args.compare)
            mism = int(np.sum(golden.astype(np.int64)
                              != out.astype(np.int64)))
            verdict = ('100% matched!' if mism == 0
                       else f'{mism} MISMATCHES')
            print(f'{verdict} ({out.size} values)')
            return 0 if mism == 0 else 1
    else:
        top = np.argsort(out, axis=-1)[:, ::-1][:, :args.topk]
        for i, row in enumerate(top):
            print(f'image {i}: top-{args.topk} classes {row.tolist()}')

    if args.time:
        from hawq_tpu_torch.utils.timing import time_per_iter
        t = time_per_iter(engine, xd)
        print(json.dumps({'ms_per_batch': round(t * 1e3, 3),
                          'images_per_sec': round(len(x) / t, 1),
                          'batch': len(x)}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
