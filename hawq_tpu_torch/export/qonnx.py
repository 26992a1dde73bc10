"""QONNX-style ONNX emission of the frozen integer graph + replay validator
(port of hawq_tpu/export/qonnx.py; numpy and protobuf only).

The reference exports trained HAWQ models to ONNX files with custom
quantization ops in their own domain for FPGA toolchains
(utils/export/manager.py:111-142 two-pass export, custom domain
'hawq2qonnx'; function.py:8-141 Quant/Trunc symbolic ops).  This module
serializes a FrozenModel (inference/freeze.py) into a real ONNX protobuf —
wire-compatible with stock onnx tooling via the transcribed schema subset
(``onnx_subset_pb2``, generated from hawq_tpu/export/onnx_subset.proto and
copied as it is; the `onnx` package is not required) — and ships a
replay interpreter that executes the emitted integer graph and must
reproduce the engine's logits bit-for-bit (the exporter's correctness
test).  The files are equal, byte for byte, to hawq_tpu's for the same
FrozenModel.

Dialect (domain 'hawq2qonnx', mirroring the reference's custom domain):
  Quant(x, scale)        attrs bitwidth, signed     → clip(round_half_up(x/scale))
                         (integer-valued output; the input-quantization node)
  BipolarQuant(x, scale)                             → where(x ≥ 0, 1, −1)
                         (1-bit binary quantizer, value = q·scale; emitted by
                         quant_node for bitwidth 1 — reference
                         function.py:37-50, 127-130)
  Requant(x, mult)       attrs bits, signed, relu   → clip(floor(x·mult + 0.5))
                         (the dyadic requant; mult = m·2⁻ᵉ exact f32)
  RequantAdd(a, ma, b, mb)                           → ⌊a·ma+0.5⌋ + ⌊b·mb+0.5⌋
                         (dual-scale residual add, unclamped like the engine)
  Trunc(x)               attr eps                   → trunc(x + eps)
                         (integer average-pool division, quant_utils.py:324)
  RequantBn(x, mult, bias) attrs bits, signed       → clip(relu(⌊x·mult+0.5⌋
                         + bias)) (pre-activation ResNet v2's standalone
                         integer batch-norm, engine_v2.py)
Standard-domain ops: Conv (int8 weight + int32 bias initializers; `group`
for depthwise), Relu, Min (integer ReLU6: Relu then Min against a
per-channel round(6/acc_scale) int32 initializer), Clip, MaxPool,
AveragePool (integer window sum, f32 division — always followed by Trunc),
GlobalAveragePool, Concat, Reshape, MatMul, Add, Mul.

Every Conv additionally carries self-description initializers
`<key>.weight_scale` (f32 per-channel) and `<key>.weight_bits` (int32) so
downstream toolchains can dequantize the integer weights (the role of the
reference Quant op's scale/bitwidth operands).  `export_qonnx` dispatches
on FrozenModel.arch across all four graph families.

All activation tensors are integer-valued; the requant multiplies replay in
float32 (matching the engine's arithmetic exactly), the convolutions in
int64 (exact).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from hawq_tpu_torch.configs.bit_config import (RESNET_UNITS,
                                               RESNET_CONVS_PER_UNIT)
from hawq_tpu_torch.export import onnx_subset_pb2 as P
from hawq_tpu_torch.inference.engine_inception import width_div_from_frozen
from hawq_tpu_torch.inference.engine_mobilenet import stages_from_frozen
from hawq_tpu_torch.inference.freeze import FrozenModel
from hawq_tpu_torch.models import inceptionv3 as mi
from hawq_tpu_torch.quant.ops import np_dyadic_multiplier

QDOMAIN = 'hawq2qonnx'


def quant_node(b: '_Builder', x: str, scale: str, bitwidth: int,
               signed: int = 1) -> str:
    """Emit the bit-appropriate quantizer: BipolarQuant for 1-bit, Quant
    otherwise — mirroring the reference's get_quant_func dispatch
    (utils/export/function.py:127-130).  BipolarQuant(x,
    scale) produces integer values in {−1, +1} (value = q·scale), the
    QONNX binary-network quantizer; no published HAWQ config uses 1-bit,
    but the dialect is complete with it."""
    if bitwidth == 1:
        return b.node('BipolarQuant', [x, scale], domain=QDOMAIN)
    return b.node('Quant', [x, scale], domain=QDOMAIN, bitwidth=bitwidth,
                  signed=signed)


# ---------------------------------------------------------------------------
# graph builder
# ---------------------------------------------------------------------------

class _Builder:
    def __init__(self, name: str):
        self.model = P.ModelProto(ir_version=8, producer_name='hawq_tpu',
                                  producer_version='0.2')
        self.model.opset_import.add(domain='', version=13)
        self.model.opset_import.add(domain=QDOMAIN, version=1)
        self.g = self.model.graph
        self.g.name = name
        self._n = 0

    def init_tensor(self, name: str, arr: np.ndarray) -> str:
        t = self.g.initializer.add()
        t.name = name
        t.dims.extend(arr.shape)
        if arr.dtype == np.int8:
            t.data_type = P.TensorProto.INT8
        elif arr.dtype == np.int32:
            t.data_type = P.TensorProto.INT32
        elif arr.dtype == np.float32:
            t.data_type = P.TensorProto.FLOAT
        else:
            raise TypeError(arr.dtype)
        t.raw_data = np.ascontiguousarray(arr).tobytes()
        return name

    def node(self, op: str, inputs: List[str], domain: str = '',
             name: str = None, **attrs) -> str:
        self._n += 1
        out = f'{op.lower()}_{self._n}'
        n = self.g.node.add()
        n.op_type = op
        n.domain = domain
        n.name = name or out
        n.input.extend(inputs)
        n.output.append(out)
        for k, v in attrs.items():
            a = n.attribute.add()
            a.name = k
            if isinstance(v, float):
                a.type = P.AttributeProto.FLOAT
                a.f = v
            elif isinstance(v, int):
                a.type = P.AttributeProto.INT
                a.i = v
            elif isinstance(v, str):
                a.type = P.AttributeProto.STRING
                a.s = v.encode()
            elif isinstance(v, (list, tuple)):
                a.type = P.AttributeProto.INTS
                a.ints.extend(int(x) for x in v)
            else:
                raise TypeError((k, v))
        return out

    def io(self, coll, name: str, shape, elem=P.TensorProto.FLOAT):
        vi = coll.add()
        vi.name = name
        vi.type.tensor_type.elem_type = elem
        for d in shape:
            dim = vi.type.tensor_type.shape.dim.add()
            if isinstance(d, int):
                dim.dim_value = d
            else:
                dim.dim_param = d


class _GraphCtx:
    """Shared emission helpers over (_Builder, FrozenModel): activation
    lookups, dyadic-multiplier initializers, int8 Conv nodes — used by every
    family's exporter."""

    def __init__(self, b: '_Builder', fm: FrozenModel):
        self.b = b
        self.fm = fm
        self.cfg = fm.cfg

    def act_info(self, key):
        return (float(self.fm.act_scale(key)), self.cfg.act_bits(key),
                int(self.cfg.act_mode(key) == 'symmetric'))

    def mult_init(self, name, acc_scale, out_scale):
        ratio = (np.asarray(acc_scale, np.float32)
                 / np.float32(out_scale)).astype(np.float32)
        return self.b.init_tensor(name,
                                  np.atleast_1d(np_dyadic_multiplier(ratio)))

    def conv(self, x, key, strides, pads, group: int = 1):
        """Conv node (HWIO weights, NHWC data — the channels-last QONNX
        dialect, the layout the reference's to_channels_last pass produces)
        + int32 bias initializer.

        Also emits self-description metadata initializers
        ``<key>.weight_scale`` (f32, per-channel) and ``<key>.weight_bits``
        (int32) so a downstream toolchain can dequantize the weights — the
        role of the reference's Quant-op scale/bitwidth operands
        (utils/export/function.py:8-141)."""
        w = np.asarray(self.fm[key + '.weight_int'], np.int8)
        bias = np.asarray(self.fm[key + '.bias_int'], np.int32)
        wi = self.b.init_tensor(key + '.weight', w)
        bi = self.b.init_tensor(key + '.bias', bias)
        self.b.init_tensor(
            key + '.weight_scale',
            np.atleast_1d(self.fm[key + '.weight_scale'].astype(np.float32)))
        self.b.init_tensor(key + '.weight_bits',
                           np.asarray([self.cfg.weight_bits(key)], np.int32))
        return self.b.node('Conv', [x, wi, bi], name=key,
                           kernel_shape=w.shape[:2], strides=strides,
                           pads=pads, group=group), w

    def requant(self, x, mult, bits, signed):
        return self.b.node('Requant', [x, mult], domain=QDOMAIN,
                           bits=bits, signed=signed)

    def requant_to(self, x, act_key, mult_name, from_scale):
        """Requant x (at from_scale) to act_key's scale; returns (node, s)."""
        s, bits, sg = self.act_info(act_key)
        m = self.mult_init(mult_name + '.mult', from_scale, s)
        return self.requant(x, m, bits, sg), np.float32(s)


def export_qonnx_resnet(fm: FrozenModel, path: str, image_size: int = 224
                        ) -> None:
    """Serialize the frozen ResNet integer graph as an ONNX file.

    Mirrors inference/engine.py's build_resnet_engine graph construction
    (same dyadic multipliers, same op order) so the replayed file is
    bit-equal to the engine.
    """
    arch, cfg = fm.arch, fm.cfg
    bottleneck = RESNET_CONVS_PER_UNIT[arch] == 3
    conv1_stride = arch == 'resnet50'
    init_key = 'quant_init_convbn' if bottleneck else 'quant_init_block_convbn'

    b = _Builder(f'{arch}_{cfg.name}')
    ctx = _GraphCtx(b, fm)
    b.io(b.g.input, 'image', ('N', image_size, image_size, 3))
    act_info, mult_init = ctx.act_info, ctx.mult_init

    def conv(x, key, strides, pads):
        return ctx.conv(x, key, strides, pads)[0]

    s_in, _, _ = act_info('quant_input')
    si = b.init_tensor('input.scale', np.float32(s_in).reshape(1))
    x = quant_node(b, 'image', si, bitwidth=8, signed=1)

    # init block
    w_scale = fm[init_key + '.weight_scale'].astype(np.float32)
    acc = conv(x, init_key, (2, 2), (3, 3, 3, 3))
    s16, b16, sg16 = act_info('quant_act_int32')
    m = mult_init('init.mult', w_scale * np.float32(s_in), s16)
    x = b.node('Requant', [acc, m], domain=QDOMAIN, bits=b16, signed=sg16)
    x = b.node('Relu', [x])
    x = b.node('MaxPool', [x], kernel_shape=(3, 3), strides=(2, 2),
               pads=(1, 1, 1, 1))
    prev_scale = np.float32(s16)

    for si_, n_units in enumerate(RESNET_UNITS[arch], start=1):
        for u in range(1, n_units + 1):
            p = f'stage{si_}.unit{u}'
            stride = 2 if (u == 1 and si_ > 1) else 1
            has_id = f'{p}.quant_identity_convbn.weight_int' in fm.tensors

            sa, ba, sga = act_info(f'{p}.quant_act')
            m = mult_init(f'{p}.in.mult', prev_scale, sa)
            xa = b.node('Requant', [x, m], domain=QDOMAIN, bits=ba,
                        signed=sga)

            if has_id:
                id_key = f'{p}.quant_identity_convbn'
                id_acc = conv(xa, id_key, (stride, stride), (0, 0, 0, 0))
                id_scale = (fm[id_key + '.weight_scale'].astype(np.float32)
                            * np.float32(sa))
            else:
                id_acc = x
                id_scale = prev_scale

            s1 = (stride, stride) if (bottleneck and conv1_stride) else \
                ((1, 1) if bottleneck else (stride, stride))
            s2 = (1, 1) if (bottleneck and conv1_stride) else \
                ((stride, stride) if bottleneck else (1, 1))

            key1 = f'{p}.quant_convbn1'
            pad1 = (0, 0, 0, 0) if bottleneck else (1, 1, 1, 1)
            acc = conv(xa, key1, s1, pad1)
            acc = b.node('Relu', [acc])
            acc_scale = (fm[key1 + '.weight_scale'].astype(np.float32)
                         * np.float32(sa))
            sa1, ba1, sg1 = act_info(f'{p}.quant_act1')
            m = mult_init(f'{p}.a1.mult', acc_scale, sa1)
            h = b.node('Requant', [acc, m], domain=QDOMAIN, bits=ba1,
                       signed=sg1)

            key2 = f'{p}.quant_convbn2'
            acc = conv(h, key2, s2, (1, 1, 1, 1))
            acc_scale = (fm[key2 + '.weight_scale'].astype(np.float32)
                         * np.float32(sa1))

            if bottleneck:
                acc = b.node('Relu', [acc])
                sa2, ba2, sg2 = act_info(f'{p}.quant_act2')
                m = mult_init(f'{p}.a2.mult', acc_scale, sa2)
                h = b.node('Requant', [acc, m], domain=QDOMAIN, bits=ba2,
                           signed=sg2)
                key3 = f'{p}.quant_convbn3'
                acc = conv(h, key3, (1, 1), (0, 0, 0, 0))
                acc_scale = (fm[key3 + '.weight_scale'].astype(np.float32)
                             * np.float32(sa2))

            s_out, _, _ = act_info(f'{p}.quant_act_int32')
            mm = mult_init(f'{p}.res_main.mult', acc_scale, s_out)
            mi = mult_init(f'{p}.res_id.mult', id_scale, s_out)
            x = b.node('RequantAdd', [acc, mm, id_acc, mi], domain=QDOMAIN)
            x = b.node('Relu', [x])
            prev_scale = np.float32(s_out)

    x = b.node('GlobalAveragePool', [x])
    x = b.node('Trunc', [x], domain=QDOMAIN, eps=0.01)
    s_fc, b_fc, sg_fc = act_info('quant_act_output')
    m = mult_init('fc_in.mult', prev_scale, s_fc)
    f8 = b.node('Requant', [x, m], domain=QDOMAIN, bits=b_fc, signed=sg_fc)

    wfc = b.init_tensor('quant_output.weight',
                        np.asarray(fm['quant_output.weight_int'], np.int8))
    bfc = b.init_tensor('quant_output.bias',
                        np.asarray(fm['quant_output.bias_int'], np.int32))
    acc = b.node('MatMul', [f8, wfc])
    acc = b.node('Add', [acc, bfc])
    out_scale = (fm['quant_output.weight_scale'].astype(np.float32)
                 * np.float32(s_fc))
    so = b.init_tensor('output.scale', np.atleast_1d(out_scale))
    logits = b.node('Mul', [acc, so], name='logits')
    b.io(b.g.output, logits, ('N', fm['quant_output.weight_int'].shape[1]))

    with open(path, 'wb') as f:
        f.write(b.model.SerializeToString())


def export_qonnx_mobilenetv2(fm: FrozenModel, path: str, stages,
                             image_size: int = 224) -> None:
    """Serialize the frozen MobileNetV2 integer graph as an ONNX file.

    Mirrors inference/engine_mobilenet.py's build_mobilenetv2_engine (same
    dyadic multipliers, same op order) so the replayed file is bit-equal to
    the engine.  Integer ReLU6 is expressed with standard ops: Relu then
    Min against a per-channel round_half_up(6 / acc_scale) int32
    initializer (the exact bound _relu6_clip computes)."""
    b = _Builder(f'mobilenetv2_{fm.cfg.name}')
    ctx = _GraphCtx(b, fm)
    b.io(b.g.input, 'image', ('N', image_size, image_size, 3))

    def relu6(acc, key, acc_scale):
        hi = np.floor(np.float32(6.0)
                      / np.asarray(acc_scale, np.float32) + np.float32(0.5))
        hi = np.minimum(hi, np.float32(2 ** 31 - 1)).astype(np.int64
                                                            ).astype(np.int32)
        h = b.node('Relu', [acc])
        hi_i = b.init_tensor(key + '.relu6_hi', np.atleast_1d(hi))
        return b.node('Min', [h, hi_i])

    s_in = float(fm.act_scale('quant_input'))
    si = b.init_tensor('input.scale', np.float32(s_in).reshape(1))
    x = quant_node(b, 'image', si, bitwidth=8, signed=1)

    acc, w = ctx.conv(x, 'init_block', (2, 2), (1, 1, 1, 1))
    acc_scale = (fm['init_block.weight_scale'].astype(np.float32)
                 * np.float32(s_in))
    acc = relu6(acc, 'init_block', acc_scale)
    x, prev_scale = ctx.requant_to(acc, 'quant_act_int32', 'init_rq',
                                   acc_scale)

    in_ch = w.shape[-1]
    for i, stage in enumerate(stages, start=1):
        for j, out_ch in enumerate(stage, start=1):
            p = f'features.stage{i}.unit{j}'
            stride = 2 if (j == 1 and i != 1) else 1
            residual = (in_ch == out_ch) and (stride == 1)

            xa, sa = ctx.requant_to(x, f'{p}.quant_act', f'{p}.in',
                                    prev_scale)
            acc, _ = ctx.conv(xa, f'{p}.conv1', (1, 1), (0, 0, 0, 0))
            acc_scale = (fm[f'{p}.conv1.weight_scale'].astype(np.float32)
                         * sa)
            acc = relu6(acc, f'{p}.conv1', acc_scale)
            h, sa1 = ctx.requant_to(acc, f'{p}.quant_act1', f'{p}.a1',
                                    acc_scale)

            mid = fm[f'{p}.conv2.weight_int'].shape[-1]
            acc, _ = ctx.conv(h, f'{p}.conv2', (stride, stride),
                              (1, 1, 1, 1), group=mid)
            acc_scale = (fm[f'{p}.conv2.weight_scale'].astype(np.float32)
                         * sa1)
            acc = relu6(acc, f'{p}.conv2', acc_scale)
            h, sa2 = ctx.requant_to(acc, f'{p}.quant_act2', f'{p}.a2',
                                    acc_scale)

            acc, _ = ctx.conv(h, f'{p}.conv3', (1, 1), (0, 0, 0, 0))
            acc_scale = (fm[f'{p}.conv3.weight_scale'].astype(np.float32)
                         * sa2)

            s_out, b_out, sg_out = ctx.act_info(f'{p}.quant_act_int32')
            mm = ctx.mult_init(f'{p}.res_main.mult', acc_scale, s_out)
            if residual:
                mi = ctx.mult_init(f'{p}.res_id.mult', prev_scale, s_out)
                x = b.node('RequantAdd', [acc, mm, x, mi], domain=QDOMAIN)
            else:
                x = ctx.requant(acc, mm, b_out, sg_out)
            prev_scale = np.float32(s_out)
            in_ch = out_ch

    xa, sa = ctx.requant_to(x, 'quant_act_before_final_block', 'final_in',
                            prev_scale)
    acc, _ = ctx.conv(xa, 'features.final_block', (1, 1), (0, 0, 0, 0))
    acc_scale = (fm['features.final_block.weight_scale'].astype(np.float32)
                 * sa)
    acc = relu6(acc, 'features.final_block', acc_scale)
    x, sf = ctx.requant_to(acc, 'quant_act_int32_final', 'final_rq',
                           acc_scale)

    x = b.node('GlobalAveragePool', [x])
    x = b.node('Trunc', [x], domain=QDOMAIN, eps=0.01)
    f8, so = ctx.requant_to(x, 'quant_act_output', 'out_rq', sf)

    w8 = np.asarray(fm['output.weight_int'], np.int8)   # (1,1,C,O) conv head
    w2d = w8.reshape(w8.shape[2], w8.shape[3])
    wfc = b.init_tensor('output.weight', w2d)
    bfc = b.init_tensor('output.bias',
                        np.asarray(fm['output.bias_int'], np.int32))
    acc = b.node('MatMul', [f8, wfc])
    acc = b.node('Add', [acc, bfc])
    out_scale = fm['output.weight_scale'].astype(np.float32) * so
    so_i = b.init_tensor('output.scale', np.atleast_1d(out_scale))
    logits = b.node('Mul', [acc, so_i], name='logits')
    b.io(b.g.output, logits, ('N', w2d.shape[1]))

    with open(path, 'wb') as f:
        f.write(b.model.SerializeToString())


def export_qonnx_inceptionv3(fm: FrozenModel, path: str, width_div: int = 1,
                             image_size: int = 299) -> None:
    """Serialize the frozen InceptionV3 integer graph as an ONNX file.

    Mirrors inference/engine_inception.py's build_inceptionv3_engine: each
    branch is requantized to the unit's shared scale before a standard
    Concat node (the multi-branch concat requant).  The integer 3×3
    average pool is AveragePool (window sum, f32 division) followed by
    Trunc(eps=0.01) — exactly the engine's trunc(sum/9 + 0.01).  The units
    and branches are walked from ``models.inceptionv3``'s tables
    (:func:`~hawq_tpu_torch.models.inceptionv3.units`), the structure the
    model, freezer and engine share."""
    cfg = fm.cfg
    b = _Builder(f'inceptionv3_{cfg.name}')
    ctx = _GraphCtx(b, fm)
    b.io(b.g.input, 'image', ('N', image_size, image_size, 3))

    def pads4(p):
        if isinstance(p, int):
            return (p, p, p, p)
        return (p[0], p[1], p[0], p[1])

    def maxpool(h):
        return b.node('MaxPool', [h], kernel_shape=(3, 3), strides=(2, 2),
                      pads=(0, 0, 0, 0))

    def incept_conv(h, a, key_prefix, stride, padding):
        acc, _ = ctx.conv(h, f'{key_prefix}.q_convbn', (stride, stride),
                          pads4(padding))
        acc = b.node('Relu', [acc])        # relu before requant (monotone)
        acc_scale = (fm[f'{key_prefix}.q_convbn.weight_scale']
                     .astype(np.float32) * np.float32(a))
        return ctx.requant_to(acc, f'{key_prefix}.q_activ',
                              f'{key_prefix}.rq', acc_scale)

    ip = 'features.q_init_block'
    s_in, b_in, _ = ctx.act_info(f'{ip}.q_input_activ')
    si = b.init_tensor('input.scale', np.float32(s_in).reshape(1))
    x = quant_node(b, 'image', si, bitwidth=b_in, signed=1)
    s = np.float32(s_in)
    for c, (_, _, stride, pad) in enumerate(mi.INIT_CONVS, start=1):
        x, s = incept_conv(x, s, f'{ip}.q_conv{c}', stride, pad)
        if c in mi.INIT_POOLS:
            x = maxpool(x)

    for _, _, unit in mi.units(width_div):
        p = unit.prefix
        outs, scales = [], []
        for name, kind, kwargs in unit.branch_defs:
            bp = f'{p}.branches.{name}'
            h, a = ctx.requant_to(x, f'{bp}.q_input_act', f'{bp}.in', s)
            if kind == mi.CONV1X1:
                h, a = incept_conv(h, a, f'{bp}.q_conv', 1, 0)
            elif kind in (mi.CONV_SEQ, mi.CONV_SEQ_3X3):
                for c, (st_, pd) in enumerate(
                        zip(kwargs['strides'], kwargs['paddings']), start=1):
                    h, a = incept_conv(h, a, f'{bp}.q_conv_list.q_conv{c}',
                                       st_, pd)
            elif kind == mi.MAX_POOL:
                h = maxpool(h)
            elif kind == mi.AVG_POOL:
                h = b.node('AveragePool', [h], kernel_shape=(3, 3),
                           strides=(1, 1), pads=(1, 1, 1, 1))
                h = b.node('Trunc', [h], domain=QDOMAIN, eps=0.01)
                h, a = ctx.requant_to(h, f'{bp}.q_pool_act', f'{bp}.pool', a)
                h, a = incept_conv(h, a, f'{bp}.q_conv', 1, 0)
            if kind == mi.CONV_SEQ_3X3:
                y1, a1 = incept_conv(h, a, f'{bp}.q_conv1x3', 1, (0, 1))
                y2, a2 = incept_conv(h, a, f'{bp}.q_conv3x1', 1, (1, 0))
                r1, ssub = ctx.requant_to(y1, f'{bp}.q_rescaling_activ',
                                          f'{bp}.rs1', a1)
                r2, _ = ctx.requant_to(y2, f'{bp}.q_rescaling_activ',
                                       f'{bp}.rs2', a2)
                h = b.node('Concat', [r1, r2], axis=3)
                a = ssub
            outs.append(h)
            scales.append(a)

        # concat requant: each branch to the unit's shared scale
        pieces, s_unit = [], None
        for bi, (h, a) in enumerate(zip(outs, scales)):
            r, s_unit = ctx.requant_to(h, f'{p}.q_rescaling_activ',
                                       f'{p}.cat{bi}', a)
            pieces.append(r)
        x = b.node('Concat', pieces, axis=3)
        s = s_unit

    x = b.node('GlobalAveragePool', [x])
    x = b.node('Trunc', [x], domain=QDOMAIN, eps=0.01)
    f8, s_fc = ctx.requant_to(x, 'features.q_concat_activ', 'fc_in', s)
    wfc = b.init_tensor('output.weight',
                        np.asarray(fm['output.q_fc.weight_int'], np.int8))
    bfc = b.init_tensor('output.bias',
                        np.asarray(fm['output.q_fc.bias_int'], np.int32))
    acc = b.node('MatMul', [f8, wfc])
    acc = b.node('Add', [acc, bfc])
    out_scale = fm['output.q_fc.weight_scale'].astype(np.float32) * s_fc
    so = b.init_tensor('output.scale', np.atleast_1d(out_scale))
    logits = b.node('Mul', [acc, so], name='logits')
    b.io(b.g.output, logits, ('N', fm['output.q_fc.weight_int'].shape[1]))

    with open(path, 'wb') as f:
        f.write(b.model.SerializeToString())


def export_qonnx_resnet_v2(fm: FrozenModel, path: str, image_size: int = 224
                           ) -> None:
    """Serialize the frozen pre-activation ResNet v2 integer graph.

    Mirrors inference/engine_v2.py's build_resnet_v2_engine.  The
    v2-specific standalone integer batch-norm is the custom RequantBn op:
    clip(relu(round_half_up(x·mult) + bias)), with bias =
    round_half_up(bn_bias / act_scale) as an f32 initializer.  The direct
    head quantizer (QuantAct case (a)) is Mul by the residual scale
    followed by Quant at the output scale — the engine's exact f32 op
    order."""
    arch, cfg = fm.arch, fm.cfg
    base = arch[:-2]
    bottleneck = RESNET_CONVS_PER_UNIT[base] == 3

    b = _Builder(f'{arch}_{cfg.name}')
    ctx = _GraphCtx(b, fm)
    b.io(b.g.input, 'image', ('N', image_size, image_size, 3))

    s_in, _, _ = ctx.act_info('quant_input')
    si = b.init_tensor('input.scale', np.float32(s_in).reshape(1))
    x = quant_node(b, 'image', si, bitwidth=8, signed=1)

    acc, _ = ctx.conv(x, 'quant_init_conv', (2, 2), (3, 3, 3, 3))
    acc = b.node('Relu', [acc])
    acc = b.node('MaxPool', [acc], kernel_shape=(3, 3), strides=(2, 2),
                 pads=(1, 1, 1, 1))
    s_init = (fm['quant_init_conv.weight_scale'].astype(np.float32)
              * np.float32(s_in))
    x, prev_scale = ctx.requant_to(acc, 'quant_act_int32', 'init_rq', s_init)

    for si_, n_units in enumerate(RESNET_UNITS[base], start=1):
        for u in range(1, n_units + 1):
            p = f'stage{si_}.unit{u}'
            stride = 2 if (u == 1 and si_ > 1) else 1
            resize = f'{p}.quant_identity_conv.weight_int' in fm.tensors

            sa, ba, sga = ctx.act_info(f'{p}.quant_act')
            bn_a = (np.float32(prev_scale)
                    * fm[f'{p}.quant_bn.bn_factor']).astype(np.float32)
            m = ctx.mult_init(f'{p}.bn.mult', bn_a, sa)
            b1 = np.floor(fm[f'{p}.quant_bn.bn_bias'] / np.float32(sa)
                          + np.float32(0.5)).astype(np.float32)
            bi = b.init_tensor(f'{p}.bn.bias', b1)
            pre = b.node('RequantBn', [x, m, bi], domain=QDOMAIN, bits=ba,
                         signed=int(sga))

            if resize:
                id_acc, _ = ctx.conv(pre, f'{p}.quant_identity_conv',
                                     (stride, stride), (0, 0, 0, 0))
                id_scale = (fm[f'{p}.quant_identity_conv.weight_scale']
                            .astype(np.float32) * np.float32(sa))
            else:
                id_acc, id_scale = x, prev_scale

            pad1 = (0, 0, 0, 0) if bottleneck else (1, 1, 1, 1)
            acc, _ = ctx.conv(pre, f'{p}.quant_conv1', (stride, stride),
                              pad1)
            acc = b.node('Relu', [acc])
            acc_scale = (fm[f'{p}.quant_conv1.weight_scale']
                         .astype(np.float32) * np.float32(sa))
            h, sa1 = ctx.requant_to(acc, f'{p}.quant_act1', f'{p}.a1',
                                    acc_scale)

            acc, _ = ctx.conv(h, f'{p}.quant_conv2', (1, 1), (1, 1, 1, 1))
            acc_scale = (fm[f'{p}.quant_conv2.weight_scale']
                         .astype(np.float32) * sa1)
            if bottleneck:
                acc = b.node('Relu', [acc])
                h, sa2 = ctx.requant_to(acc, f'{p}.quant_act2', f'{p}.a2',
                                        acc_scale)
                acc, _ = ctx.conv(h, f'{p}.quant_conv3', (1, 1),
                                  (0, 0, 0, 0))
                acc_scale = (fm[f'{p}.quant_conv3.weight_scale']
                             .astype(np.float32) * sa2)

            s_out, _, _ = ctx.act_info(f'{p}.quant_act_int32')
            mm = ctx.mult_init(f'{p}.res_m.mult', acc_scale, s_out)
            mi = ctx.mult_init(f'{p}.res_i.mult', id_scale, s_out)
            x = b.node('RequantAdd', [acc, mm, id_acc, mi], domain=QDOMAIN)
            prev_scale = np.float32(s_out)

    # head: relu → integer avg pool → direct quant → fc
    x = b.node('Relu', [x])
    x = b.node('GlobalAveragePool', [x])
    x = b.node('Trunc', [x], domain=QDOMAIN, eps=0.01)
    s_fc, b_fc, sg_fc = ctx.act_info('quant_act_output')
    ps = b.init_tensor('head.prev_scale', np.float32(prev_scale).reshape(1))
    x = b.node('Mul', [x, ps])
    sfc = b.init_tensor('head.scale', np.float32(s_fc).reshape(1))
    f8 = quant_node(b, x, sfc, bitwidth=b_fc, signed=int(sg_fc))

    wfc = b.init_tensor('quant_output.weight',
                        np.asarray(fm['quant_output.weight_int'], np.int8))
    bfc = b.init_tensor('quant_output.bias',
                        np.asarray(fm['quant_output.bias_int'], np.int32))
    acc = b.node('MatMul', [f8, wfc])
    acc = b.node('Add', [acc, bfc])
    out_scale = (fm['quant_output.weight_scale'].astype(np.float32)
                 * np.float32(s_fc))
    so = b.init_tensor('output.scale', np.atleast_1d(out_scale))
    logits = b.node('Mul', [acc, so], name='logits')
    b.io(b.g.output, logits, ('N', fm['quant_output.weight_int'].shape[1]))

    with open(path, 'wb') as f:
        f.write(b.model.SerializeToString())


def export_qonnx(fm: FrozenModel, path: str, image_size: int = None) -> None:
    """Arch-dispatching export: serialize any FrozenModel to ONNX.

    The analog of the reference's model-agnostic ExportManager entry point
    (utils/export/manager.py:39-142) — structure parameters (MobileNetV2
    stages, Inception width_div) are recovered from the artifact itself."""
    arch = fm.arch
    if arch == 'mobilenetv2':
        return export_qonnx_mobilenetv2(fm, path, stages_from_frozen(fm),
                                        image_size or 224)
    if arch == 'inceptionv3':
        return export_qonnx_inceptionv3(fm, path, width_div_from_frozen(fm),
                                        image_size or 299)
    if arch.endswith('v2'):
        return export_qonnx_resnet_v2(fm, path, image_size or 224)
    return export_qonnx_resnet(fm, path, image_size or 224)


# ---------------------------------------------------------------------------
# replay interpreter
# ---------------------------------------------------------------------------

def _tensor_to_np(t) -> np.ndarray:
    dt = {P.TensorProto.FLOAT: np.float32, P.TensorProto.INT8: np.int8,
          P.TensorProto.INT32: np.int32, P.TensorProto.INT64: np.int64}[
              t.data_type]
    return np.frombuffer(t.raw_data, dt).reshape(tuple(t.dims)).copy()


def load_qonnx(path: str):
    m = P.ModelProto()
    with open(path, 'rb') as f:
        m.ParseFromString(f.read())
    return m


def _conv_int(x: np.ndarray, w: np.ndarray, bias: np.ndarray, strides, pads,
              group: int = 1) -> np.ndarray:
    """Exact int64 NHWC/HWIO convolution (im2col, small models only)."""
    if group != 1:
        cpg = w.shape[2]                   # in-channels per group
        opg = w.shape[3] // group          # out-channels per group
        outs = [
            _conv_int(x[..., g * cpg:(g + 1) * cpg],
                      w[..., g * opg:(g + 1) * opg],
                      bias[g * opg:(g + 1) * opg], strides, pads)
            for g in range(group)]
        return np.concatenate(outs, axis=-1)
    x = x.astype(np.int64)
    w = w.astype(np.int64)
    kh, kw, cin, cout = w.shape
    ph0, pw0, ph1, pw1 = pads
    xp = np.pad(x, ((0, 0), (ph0, ph1), (pw0, pw1), (0, 0)))
    bsz, hp, wp, _ = xp.shape
    ho = (hp - kh) // strides[0] + 1
    wo = (wp - kw) // strides[1] + 1
    cols = np.empty((bsz, ho, wo, kh * kw * cin), np.int64)
    for dy in range(kh):
        for dx in range(kw):
            piece = xp[:, dy:dy + ho * strides[0]:strides[0],
                       dx:dx + wo * strides[1]:strides[1], :]
            cols[..., (dy * kw + dx) * cin:(dy * kw + dx + 1) * cin] = piece
    out = cols.reshape(-1, kh * kw * cin) @ w.reshape(kh * kw * cin, cout)
    return out.reshape(bsz, ho, wo, cout) + bias.astype(np.int64)


def _requant_np(acc: np.ndarray, mult: np.ndarray, bits: int, signed: int
                ) -> np.ndarray:
    """float32 mirror of the engine's requant_int32 (quant/ops.py)."""
    out = np.floor(acc.astype(np.float32) * mult.astype(np.float32)
                   + np.float32(0.5))
    if signed:
        q = 2 ** (bits - 1) - 1
        return np.clip(out, -q - 1, q).astype(np.int64)
    return np.clip(out, 0, 2 ** bits - 1).astype(np.int64)


def replay_qonnx(model, image: np.ndarray) -> np.ndarray:
    """Execute the emitted integer graph; must be bit-equal to the engine."""
    g = model.graph
    env: Dict[str, np.ndarray] = {g.input[0].name: image}
    for t in g.initializer:
        env[t.name] = _tensor_to_np(t)

    def attrs(n):
        out = {}
        for a in n.attribute:
            if a.type == P.AttributeProto.INT:
                out[a.name] = int(a.i)
            elif a.type == P.AttributeProto.FLOAT:
                out[a.name] = float(a.f)
            elif a.type == P.AttributeProto.INTS:
                out[a.name] = tuple(a.ints)
            elif a.type == P.AttributeProto.STRING:
                out[a.name] = a.s.decode()
        return out

    for n in g.node:
        ins = [env[i] for i in n.input]
        at = attrs(n)
        op = n.op_type
        if op == 'Quant':
            x, scale = ins
            q = np.floor(x.astype(np.float32) / scale.astype(np.float32)
                         + np.float32(0.5))
            hi = 2 ** (at['bitwidth'] - 1) - 1
            out = np.clip(q, -hi - 1, hi).astype(np.int64)
        elif op == 'BipolarQuant':
            x, scale = ins          # integer output in {-1,+1}; value = q·scale
            out = np.where(x >= 0, 1, -1).astype(np.int64)
        elif op == 'Conv':
            out = _conv_int(ins[0], ins[1], ins[2], at['strides'],
                            at['pads'], at.get('group', 1))
        elif op == 'Requant':
            out = _requant_np(ins[0], ins[1], at['bits'], at['signed'])
        elif op == 'RequantBn':
            pre = (np.floor(ins[0].astype(np.float32)
                            * ins[1].astype(np.float32) + np.float32(0.5))
                   + ins[2].astype(np.float32))
            pre = np.maximum(pre, np.float32(0.0))
            if at['signed']:
                q = 2 ** (at['bits'] - 1) - 1
                out = np.clip(pre, -q - 1, q).astype(np.int64)
            else:
                out = np.clip(pre, 0, 2 ** at['bits'] - 1).astype(np.int64)
        elif op == 'RequantAdd':
            a_ = np.floor(ins[0].astype(np.float32)
                          * ins[1].astype(np.float32) + np.float32(0.5))
            b_ = np.floor(ins[2].astype(np.float32)
                          * ins[3].astype(np.float32) + np.float32(0.5))
            out = (a_ + b_).astype(np.int64)
        elif op == 'Relu':
            out = np.maximum(ins[0], 0)
        elif op == 'MaxPool':
            x = ins[0]
            kh, kw = at['kernel_shape']
            sh, sw = at['strides']
            p = at['pads']
            xmin = np.iinfo(np.int64).min
            xp = np.pad(x, ((0, 0), (p[0], p[2]), (p[1], p[3]), (0, 0)),
                        constant_values=xmin)
            ho = (xp.shape[1] - kh) // sh + 1
            wo = (xp.shape[2] - kw) // sw + 1
            out = np.full((x.shape[0], ho, wo, x.shape[3]), xmin, np.int64)
            for dy in range(kh):
                for dx in range(kw):
                    out = np.maximum(
                        out, xp[:, dy:dy + ho * sh:sh, dx:dx + wo * sw:sw, :])
        elif op == 'Min':
            out = np.minimum(ins[0], ins[1].astype(np.int64))
        elif op == 'Concat':
            out = np.concatenate(ins, axis=at['axis'])
        elif op == 'AveragePool':
            # integer window sum, then f32 division — the engine's exact
            # arithmetic (trunc happens in the following Trunc node)
            x = ins[0]
            kh, kw = at['kernel_shape']
            sh, sw = at['strides']
            p = at['pads']
            xp = np.pad(x, ((0, 0), (p[0], p[2]), (p[1], p[3]), (0, 0)))
            ho = (xp.shape[1] - kh) // sh + 1
            wo = (xp.shape[2] - kw) // sw + 1
            acc = np.zeros((x.shape[0], ho, wo, x.shape[3]), np.int64)
            for dy in range(kh):
                for dx in range(kw):
                    acc += xp[:, dy:dy + ho * sh:sh, dx:dx + wo * sw:sw, :]
            out = acc.astype(np.float32) / np.float32(kh * kw)
        elif op == 'GlobalAveragePool':
            # integer sum (exact in int64), f32 division — mirrors the
            # engines' trunc(f32(sum)/hw + eps) bit-for-bit
            out = (ins[0].sum(axis=(1, 2), dtype=np.int64).astype(np.float32)
                   / np.float32(ins[0].shape[1] * ins[0].shape[2]))
        elif op == 'Trunc':
            out = np.trunc(ins[0].astype(np.float32)
                           + np.float32(at['eps'])).astype(np.int64)
        elif op == 'MatMul':
            out = ins[0].astype(np.int64) @ ins[1].astype(np.int64)
        elif op == 'Add':
            out = ins[0] + ins[1].astype(ins[0].dtype)
        elif op == 'Mul':
            out = (ins[0].astype(np.float32)
                   * ins[1].astype(np.float32)).astype(np.float32)
        else:
            raise NotImplementedError(op)
        env[n.output[0]] = out
    return env[g.output[0].name]
