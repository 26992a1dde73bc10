"""Integer inference engine for quantized MobileNetV2 (port of
hawq_tpu/inference/engine_mobilenet.py, its plain int8 route, in native and
reference requant modes).

ReLU6 on the integer side: relu6 acts on value = acc · acc_scale, so the
accumulator clamp is [0, floor(6/acc_scale + 0.5)] per channel, the bound
computed on the host in numpy float32 (:func:`relu6_bound`), the QAT
graph's ``relu6_int`` on the device giving the same integers.

Routing (every integer conv through the port's kernels, their plain
versions on a CPU device):

  * the 3×3/s2 init conv on raw float32 images → ``int8_conv_acc`` through
    its space-to-depth rewrite (C 3 → 4, so 16 after the rewrite); on
    host-folded images (``input_mode='folded_float32'``,
    ``inference.fold.fold4_images_3x3s2(x, 1)``) → ``int8_conv_acc`` over
    the 2×2/s1 fold, C = 48, N = 4·32, then ReLU6 and the requant in the
    folded layout (per-channel vectors tiled over the 4 stride-2 origins),
    depth-to-space and the slice to the output size;
  * every 1×1 conv (conv1, conv3, the final block, the head on the pooled
    vector) → ``int8_matmul_acc``, then the ReLU6 clamp as PyTorch ops and
    the requant through ``kernels.requant.requant_int32``; with a routing
    table (``inference.routing``) the conv1, conv3 and final-block sites it
    routes to 'int4w' whose weights are 4-bit → ``int4w_matmul_acc`` on
    nibble-packed weights, the same epilogue after it;
  * the depthwise 3×3 conv2 → ``int8_dwconv_requant`` (D1), which takes in
    the bias, the ReLU6 clamp and the requant;
  * the residual add through ``requant_add_int32``, clamped to the int16
    carrier's range before the cast where it is int16.

``requant_mode='reference'`` replays an imported reference checkpoint with
its own float64 requant (``engine.py`` notes), on float32 input and the
int32 carrier only: the ReLU6 bound is :func:`relu6_bound_ref`, and the
depthwise conv2 runs D1's ``int8_dwconv_acc``, then the clamp and the
float64 requant as PyTorch ops (``int8_dwconv_requant`` computes the native
requant).

The reference's ``conv_mode``, ``init_mode`` and ``dw_mode`` (TPU layout
choices) are not ported.  ``capture=<node>``
returns the raw integer tensor at a named node: 'input', 'init',
'<unit>.conv1', '<unit>.conv2', '<unit>.quant_act_int32', 'final',
'fc_input'.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hawq_tpu_torch.inference import fold as _fold
from hawq_tpu_torch.inference.engine import IntEngine, engine_device
from hawq_tpu_torch.inference.freeze import FrozenModel
from hawq_tpu_torch.kernels import depthwise as kd
from hawq_tpu_torch.models.mobilenetv2 import unit_plan
from hawq_tpu_torch.quant import ops as qops

INPUT_MODES = ('float32', 'folded_float32')


def relu6_bound(acc_scale) -> np.ndarray:
    """The integer ReLU6 bound floor(6/acc_scale + 0.5) per channel, in
    float32 with the QAT graph's op order, capped at 2³¹−1 → int32."""
    hi = np.floor(np.float32(6.0) / np.asarray(acc_scale, np.float32)
                  + np.float32(0.5))
    return np.minimum(hi, np.float32(2 ** 31 - 1)).astype(np.int64
                                                          ).astype(np.int32)


def relu6_bound_ref(a_scale, w_scale) -> np.ndarray:
    """The reference checkpoint's ReLU6 bound per channel: the clamped float
    6.0 maps to rint(f32(6) / f32(a_scale) / f32(w_scale)), two sequential
    float32 divisions rounded half-even (where :func:`relu6_bound` rounds
    half-up over the fused product), capped at 2³¹−1 → int32."""
    hi = np.rint(np.float32(6.0) / np.float32(a_scale)
                 / np.asarray(w_scale, np.float32))
    return np.minimum(hi, np.float32(2 ** 31 - 1)).astype(np.int64
                                                          ).astype(np.int32)


def stages_from_frozen(fm: FrozenModel):
    """The stage channel structure of a frozen MobileNetV2 (each unit's
    conv3 output channels), so that the engine builds from the artifact
    alone."""
    units = {}
    for k, v in fm.tensors.items():
        if k.startswith('features.stage') and k.endswith('.conv3.weight_int'):
            head = k.split('.')[1:3]               # ['stageI', 'unitJ']
            units[int(head[0][5:]), int(head[1][4:])] = int(v.shape[-1])
    return tuple(tuple(units[i, j] for j in sorted(j for i2, j in units
                                                   if i2 == i))
                 for i in sorted({i for i, _ in units}))


class MobilenetEngine(IntEngine):
    """Callable integer MobileNetV2; see :func:`build_mobilenetv2_engine`."""

    def __init__(self, fm: FrozenModel,
                 capture: Optional[str], residual_dtype: torch.dtype,
                 input_mode: str, input_hw: Sequence[int],
                 device: torch.device, requant_mode: str = 'native',
                 routing=None):
        super().__init__(fm, capture, INPUT_MODES, input_mode, residual_dtype,
                         device, requant_mode, ('float32',), routing)
        self.stages = stages_from_frozen(fm)
        self.folded = input_mode == 'folded_float32'
        if self.folded:
            self.out_hw, self.fold_hw = zip(*(
                _fold.fold4_3x3s2_geometry(n, 1)[:2] for n in input_hw))

    def _hi6(self, name: str, w_scale, a_scale) -> torch.Tensor:
        """The ReLU6 bound of the conv with weight scales ``w_scale`` on
        activations at ``a_scale``, in the engine's mode."""
        if (name, 'hi6') not in self._w:
            self._w[name, 'hi6'] = self._dev(
                relu6_bound_ref(a_scale, w_scale) if self.reference else
                relu6_bound(np.asarray(w_scale, np.float32)
                            * np.float32(a_scale)))
        return self._w[name, 'hi6']

    def _relu6(self, acc: torch.Tensor, name: str, w_scale,
               a_scale) -> torch.Tensor:
        return torch.minimum(torch.clamp_min(acc, 0),
                             self._hi6(name, w_scale, a_scale))

    def _dw_w(self, key: str):
        if (key, 'dw') not in self._w:
            self._w[key, 'dw'] = (self._dev(self.fm[key + '.weight_int']),
                                  self._dev(self.fm[key + '.bias_int']))
        return self._w[key, 'dw']

    def _init_block(self, x8: torch.Tensor, s_in, s16, b16, sg16):
        """The init conv, ReLU6 and requant to the carrier."""
        w_scale = self.fm['init_block.weight_scale']
        acc_scale = self._scale('init_block', s_in)
        if not self.folded:
            acc = self._conv_kxk(x8, 'init_block', 2)
            acc = self._relu6(acc, 'init', w_scale, s_in)
            return self._requant(
                acc, self.requant_mult('init_rq', acc_scale, s16), b16, sg16,
                self.res_dt)
        acc = self._fold3x3s2_acc(x8, 'init_block')
        acc = self._relu6(acc, 'init', _fold.tile4(w_scale), s_in)
        xq = self._requant(
            acc, self.requant_mult('init_rq_f', _fold.tile4(acc_scale), s16),
            b16, sg16, self.res_dt)
        oh, ow = self.out_hw
        return _fold.depth_to_space_2x2(xq)[:, :oh, :ow, :].contiguous()

    def _forward(self, images: torch.Tensor, emit) -> torch.Tensor:
        fm = self.fm
        s_in = fm.act_scale('quant_input')
        x8 = self._quantize_float(images)
        emit('input', x8)
        s16, b16, sg16 = self.act_info('quant_act_int32')
        x = self._init_block(x8, s_in, s16, b16, sg16)
        prev_scale = np.float32(s16)
        emit('init', x)

        init_ch = fm['init_block.weight_int'].shape[-1]
        for i, j, in_ch, out_ch, stride, _ in unit_plan(self.stages, init_ch):
            p = f'features.stage{i}.unit{j}'
            sa, ba, sga = self.act_info(f'{p}.quant_act')
            xa = self._requant(
                x, self.requant_mult(f'{p}.in', prev_scale, sa), ba, sga)

            # expansion 1×1 → ReLU6 → requant
            key = f'{p}.conv1'
            acc_scale = self._scale(key, sa)
            acc = self._relu6(self._conv1x1(xa, key, 1), key,
                              fm[key + '.weight_scale'], sa)
            sa1, ba1, sg1 = self.act_info(f'{p}.quant_act1')
            h = self._requant(
                acc, self.requant_mult(f'{p}.a1', acc_scale, sa1), ba1, sg1)
            emit(f'{p}.conv1', h)

            # depthwise 3×3 with its bias, ReLU6 and requant in one kernel
            # (in reference mode the kernel's accumulator form, then the
            # clamp and the requant)
            key = f'{p}.conv2'
            acc_scale = self._scale(key, sa1)
            sa2, ba2, sg2 = self.act_info(f'{p}.quant_act2')
            w2, b2 = self._dw_w(key)
            hi6 = self._hi6(key, fm[key + '.weight_scale'], sa1)
            mult = self.requant_mult(f'{p}.a2', acc_scale, sa2)
            if self.reference:
                acc = kd.int8_dwconv_acc(h, w2, b2, stride=stride)
                h = self._requant(torch.minimum(torch.clamp_min(acc, 0), hi6),
                                  mult, ba2, sg2)
            else:
                lo, hi = qops.requant_clip_bounds(ba2, sg2)
                h = kd.int8_dwconv_requant(h, w2, b2, hi6, mult,
                                           stride=stride, lo=lo, hi=hi)
            emit(f'{p}.conv2', h)

            # linear projection 1×1, no activation
            acc = self._conv1x1(h, f'{p}.conv3', 1)
            acc_scale = self._scale(f'{p}.conv3', sa2)
            s_out, b_out, sg_out = self.act_info(f'{p}.quant_act_int32')
            m_main = self.requant_mult(f'{p}.res_main', acc_scale, s_out)
            if in_ch == out_ch and stride == 1:
                # the sum in int32 first: clamp it before narrowing
                x = self._requant_add(
                    acc, m_main, x,
                    self.requant_mult(f'{p}.res_id', prev_scale, s_out))
                if self.res_dt != torch.int32:
                    info = torch.iinfo(self.res_dt)
                    x = torch.clamp(x, info.min, info.max)
                x = x.to(self.res_dt)
            else:
                x = self._requant(acc, m_main, b_out, sg_out, self.res_dt)
            prev_scale = np.float32(s_out)
            emit(f'{p}.quant_act_int32', x)

        # final 1×1 block → ReLU6 → requant (int32)
        sa, ba, sga = self.act_info('quant_act_before_final_block')
        xa = self._requant(
            x, self.requant_mult('final_in', prev_scale, sa), ba, sga)
        key = 'features.final_block'
        acc_scale = self._scale(key, sa)
        acc = self._relu6(self._conv1x1(xa, key, 1), 'final',
                          fm[key + '.weight_scale'], sa)
        sf, bf, sgf = self.act_info('quant_act_int32_final')
        x = self._requant(acc, self.requant_mult('final_rq', acc_scale, sf),
                          bf, sgf, torch.int32)
        emit('final', x)

        # integer global average pool (truncating), the output requant, and
        # the 1×1 head on the pooled vector
        pooled = self._avg_pool(x).to(torch.int32)
        so, bo, sgo = self.act_info('quant_act_output')
        f8 = self._requant(pooled, self.requant_mult(
            'out_rq', np.float32(sf), so), bo, sgo)
        emit('fc_input', f8)
        return self._head(f8, 'output', so)


def build_mobilenetv2_engine(fm: FrozenModel,
                             residual_dtype: torch.dtype = torch.int32,
                             capture: Optional[str] = None,
                             input_mode: str = 'float32',
                             input_hw: Sequence[int] = (224, 224),
                             requant_mode: str = 'native',
                             routing: Optional[Dict[str, str]] = None,
                             device='cuda') -> MobilenetEngine:
    """Build ``engine(images) -> logits f32`` of a frozen QMobileNetV2 on
    ``device``.

    The channel structure comes from the artifact
    (:func:`stages_from_frozen`).  ``input_mode``: 'float32' takes raw
    (B, H, W, 3) float32 images; 'folded_float32' takes (B, fh, fw, 48)
    images the host folded with ``inference.fold.fold4_images_3x3s2(x, 1)``,
    and
    ``input_hw`` is the images' size before the fold.  ``residual_dtype``
    is the carrier between units, torch.int32 or torch.int16 (clamps).
    ``requant_mode``: 'native', or 'reference' (float32 input and the int32
    carrier only).  ``routing``: a table of ``inference.routing`` for the
    1×1 convs (native mode only).  With ``capture``, the engine returns the
    raw tensor at that node instead of the logits."""
    return MobilenetEngine(fm, capture, residual_dtype, input_mode,
                           input_hw, engine_device(device), requant_mode,
                           routing)
