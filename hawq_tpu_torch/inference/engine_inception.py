"""Freezer and integer inference engine for quantized InceptionV3 (port of
hawq_tpu/inference/engine_inception.py, its plain int8 route, in native and
reference requant modes), built from
the branch specifications the QAT model uses (``models.inceptionv3``
``build_unit``), so the graph's structure lives in one place.

The multi-branch concat requant: each branch ends in an integer tensor at
its own scale; the engine requantizes every branch output to the unit's
shared scale with its own dyadic multiplier before the concatenation,
which equals the training graph's per-channel-slice requant of the
concatenated tensor (``QuantAct``'s branch case).

Routing (every integer conv and the FC through the port's kernels, their
plain versions on a CPU device):

  * a conv whose ``q_activ`` is at most 8 bits → the requant form with
    ReLU (``int8_matmul_requant`` for a 1×1 — ``int4w_matmul_requant`` on
    nibble-packed weights where a routing table (``inference.routing``)
    routes the site to 'int4w' and its weights are 4-bit —
    ``int8_conv_requant`` for a
    k×k: 1×7, 7×1, 1×3, 3×1, 3×3 and 5×5 at stride 1, the border left to
    TMA where the Hopper core takes the call; the 3×3/s2 convs, the raw
    init among them, through space-to-depth, ``kernels.conv.conv_call``);
  * a conv whose ``q_activ`` is wider (the last conv of a branch, the
    stem's q_conv5) → ``int8_matmul_acc`` / ``int8_conv_acc``, then ReLU
    and the requant into the wide container as PyTorch ops;
  * the folded stem (``input_mode='folded_float32'``,
    ``inference.fold.fold4_images_3x3s2(x, 0)``) → ``int8_conv_acc`` over
    the 2×2/s1 rewrite of the 3×3/s2 q_conv1 (C = 48, N = 4·32), ReLU and
    the requant with the fourfold multipliers, depth-to-space and the slice;
  * the pool branches' ``q_input_act`` requant, their 3×3/s1/p1 average
    pool and its ``q_pool_act`` requant → one ``int_avgpool3x3_requant``
    on the unit input (A1, csrc/avgpool.cu, the requant fused in front);
  * the 3×3/s2 VALID max-pools → ``engine.maxpool_int`` (integer maxima);
  * the head: an int32 sum, ``trunc(sum / hw + 0.01)``, the requant, then
    the FC through ``int8_matmul_acc``.

Activations of 9–16 bits (the concat outputs, the inputs of the pool
branches, the last conv of each branch) live in ``wide_dtype``, torch.int32
or torch.int16; every other node in int8.  The kernels take int8
activations only, so a conv whose input node is wider than 8 bits raises
``NotImplementedError`` (W1 in ROADMAP.md; neither published config has
one, :func:`conv_input_nodes`).

``requant_mode='reference'`` replays an imported reference checkpoint with
its own float64 requant (``engine.py`` notes), on float32 input with the
int32 wide container only: every conv takes its accumulator form, then
ReLU and the float64 requant, the concat requants likewise, and a pool
branch runs in three steps — the requant to ``q_input_act`` into its
container, :func:`kernels.avgpool.int_avgpool3x3` (A1's quotient form, no
requant), the requant to ``q_pool_act``.

The reference's ``conv_mode`` and ``init_mode`` (TPU layout choices) are
not ported.  ``capture=<node>`` returns the raw
integer tensor at a named node: 'input', 'init', '<unit
prefix>.q_rescaling_activ', 'fc_input'.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from hawq_tpu_torch.configs.bit_config import BitConfig
from hawq_tpu_torch.inference import fold as _fold
from hawq_tpu_torch.inference.engine import (IntEngine, engine_device,
                                             maxpool_int)
from hawq_tpu_torch.inference.freeze import (FrozenModel,
                                             _act_scale_from_stats,
                                             _freeze_convbn, _freeze_linear)
from hawq_tpu_torch.kernels import avgpool as ka
from hawq_tpu_torch.models import inceptionv3 as mi
from hawq_tpu_torch.quant import ops as qops

INPUT_MODES = ('float32', 'folded_float32')
_IP = 'features.q_init_block'


def conv_input_nodes(width_div: int = 1) -> Iterator[Tuple[str, str]]:
    """(conv or FC key, key of the activation node that feeds it) of every
    conv of the graph, and of the FC, in order."""
    prev = f'{_IP}.q_input_activ'
    for c in range(1, len(mi.INIT_CONVS) + 1):
        yield f'{_IP}.q_conv{c}', prev
        prev = f'{_IP}.q_conv{c}.q_activ'
    for _, _, unit in mi.units(width_div):
        for name, kind, kwargs in unit.branch_defs:
            bp = f'{unit.prefix}.branches.{name}'
            a = f'{bp}.q_pool_act' if kind == mi.AVG_POOL else \
                f'{bp}.q_input_act'
            if kind in (mi.CONV1X1, mi.AVG_POOL):
                yield f'{bp}.q_conv', a
            elif kind in (mi.CONV_SEQ, mi.CONV_SEQ_3X3):
                for c in range(1, len(kwargs['out_channels']) + 1):
                    yield f'{bp}.q_conv_list.q_conv{c}', a
                    a = f'{bp}.q_conv_list.q_conv{c}.q_activ'
                if kind == mi.CONV_SEQ_3X3:
                    yield f'{bp}.q_conv1x3', a
                    yield f'{bp}.q_conv3x1', a
    yield 'output.q_fc', 'features.q_concat_activ'


# ---------------------------------------------------------------------------
# freeze
# ---------------------------------------------------------------------------

def freeze_inceptionv3(variables: Mapping, cfg: BitConfig,
                       num_classes: int = 1000,
                       width_div: int = 1) -> FrozenModel:
    """QInceptionV3 QAT variables (a flax variables tree of numpy arrays, as
    ``models.resnet.qat_to_numpy`` gives it) → FrozenModel, in numpy
    float32 with the QAT graph's op order."""
    params = variables['params']
    bstats = variables.get('batch_stats', {})
    qstats = variables['quant_stats']
    st = cfg.settings
    tensors: Dict[str, np.ndarray] = {}

    def act(key: str, path) -> np.float32:
        node = qstats
        for part in path:
            node = node[part]
        s = _act_scale_from_stats(node, cfg.act_bits(key), cfg.act_mode(key))
        tensors[key + '.act_scale'] = np.float32(s)
        return s

    def incept_conv(key_prefix: str, path, in_scale: np.float32):
        """conv+bn, then its requant activ; returns the activ scale."""
        p, b = params, bstats
        for part in (*path, 'q_convbn'):
            p = p[part]
            b = b[part]
        key = f'{key_prefix}.q_convbn'
        for k, v in _freeze_convbn(p, b, cfg.weight_bits(key), st.bias_bit,
                                   in_scale, st.per_channel).items():
            tensors[f'{key}.{k}'] = v
        return act(f'{key_prefix}.q_activ', (*path, 'q_activ'))

    s = act(f'{_IP}.q_input_activ', ('q_input_activ',))
    for c in range(1, len(mi.INIT_CONVS) + 1):
        s = incept_conv(f'{_IP}.q_conv{c}', (f'q_conv{c}',), s)

    for _, _, unit in mi.units(width_div):
        for name, kind, kwargs in unit.branch_defs:
            bp = f'{unit.prefix}.branches.{name}'
            path = (unit.name, name)
            a = act(f'{bp}.q_input_act', (*path, 'q_input_act'))
            if kind == mi.AVG_POOL:
                a = act(f'{bp}.q_pool_act', (*path, 'q_pool_act'))
            if kind in (mi.CONV1X1, mi.AVG_POOL):
                incept_conv(f'{bp}.q_conv', (*path, 'q_conv'), a)
            elif kind in (mi.CONV_SEQ, mi.CONV_SEQ_3X3):
                for c in range(1, len(kwargs['out_channels']) + 1):
                    a = incept_conv(f'{bp}.q_conv_list.q_conv{c}',
                                    (*path, f'q_conv{c}'), a)
                if kind == mi.CONV_SEQ_3X3:
                    incept_conv(f'{bp}.q_conv1x3', (*path, 'q_conv1x3'), a)
                    incept_conv(f'{bp}.q_conv3x1', (*path, 'q_conv3x1'), a)
                    act(f'{bp}.q_rescaling_activ',
                        (*path, 'q_rescaling_activ'))
        s = act(f'{unit.prefix}.q_rescaling_activ',
                (unit.name, 'q_rescaling_activ'))

    out_sc = act('features.q_concat_activ', ('q_concat_activ',))
    for k, v in _freeze_linear(params['q_fc'], cfg.weight_bits('output.q_fc'),
                               st.bias_bit, out_sc, st.per_channel).items():
        tensors[f'output.q_fc.{k}'] = v
    return FrozenModel(arch='inceptionv3', cfg=cfg, tensors=tensors,
                       num_classes=num_classes)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def width_div_from_frozen(fm: FrozenModel) -> int:
    """width_div from the stem convs' output channels (32 / 64 / 192 at full
    width), so that the engine builds from the artifact alone; where the
    floor division makes neighbouring widths agree on those, the final
    concat's width (unit C: 320 + 4·384 + 192) tells them apart."""
    probes = {'q_conv1': 32, 'q_conv3': 64, 'q_conv5': 192}
    got = {c: int(fm[f'{_IP}.{c}.q_convbn.weight_int'].shape[-1])
           for c in probes}
    if got == probes:
        return 1
    fc_in = int(fm['output.q_fc.weight_int'].shape[0])
    for w in range(2, 513):
        if (all(mi._cdiv(full, w) == got[c] for c, full in probes.items())
                and mi._cdiv(320, w) + 4 * mi._cdiv(384, w)
                + mi._cdiv(192, w) == fc_in):
            return w
    raise ValueError(f'cannot infer width_div from channels {got}')


class InceptionEngine(IntEngine):
    """Callable integer InceptionV3; see :func:`build_inceptionv3_engine`."""

    def __init__(self, fm: FrozenModel, width_div: int,
                 capture: Optional[str], input_mode: str,
                 input_hw: Sequence[int], wide_dtype: torch.dtype,
                 device: torch.device, requant_mode: str = 'native',
                 routing=None):
        super().__init__(fm, capture, INPUT_MODES, input_mode, wide_dtype,
                         device, requant_mode, ('float32',), routing)
        cfg = fm.cfg
        if wide_dtype == torch.int16:
            # an asymmetric >8-bit range [0, 2^b − 1] would not fit int16;
            # the published configs keep those nodes symmetric
            bad = [k for k in cfg.table
                   if cfg.act_bits(k) > 8 and cfg.act_mode(k) != 'symmetric']
            if bad:
                raise ValueError(f'int16 wide container unsafe for '
                                 f'{bad[:3]}')
        wide = [(conv, node) for conv, node in conv_input_nodes(width_div)
                if cfg.act_bits(node) > 8]
        if wide:
            raise NotImplementedError(
                f'{wide[0][0]} takes {cfg.act_bits(wide[0][1])}-bit '
                f'activations ({wide[0][1]}): a conv on activations wider '
                f'than 8 bits has no kernel (W1 in ROADMAP.md); '
                f'{len(wide)} such convs in {cfg.name}')
        self.units = [u for _, _, u in mi.units(width_div)]
        self.folded = input_mode == 'folded_float32'
        if self.folded:
            self.out_hw, self.fold_hw = zip(*(
                _fold.fold4_3x3s2_geometry(n, 0)[:2] for n in input_hw))

    def _routable(self, key: str) -> bool:
        """A table routes a 1×1 conv whose requant fuses: its ``q_activ``
        at most 8 bits (the JAX package's rule)."""
        node = key[:-len('.q_convbn')] + '.q_activ'
        return super()._routable(key) and self.fm.cfg.act_bits(node) <= 8

    def _container(self, bits: int) -> torch.dtype:
        return torch.int8 if bits <= 8 else self.res_dt

    def _requant_to(self, x, from_scale, key: str, name: str):
        """→ (the tensor requantized to node ``key``, its scale)."""
        s, b, sg = self.act_info(key)
        mult = self.requant_mult(name, from_scale, s)
        return self._requant(x, mult, b, sg, self._container(b)), np.float32(s)

    def _incept_conv(self, h, a_scale, kp: str, stride=1, pad=0):
        """conv+BN → ReLU → requant to ``<kp>.q_activ`` → (tensor, scale)."""
        key = f'{kp}.q_convbn'
        acc_scale = self._scale(key, a_scale)
        s, b, sg = self.act_info(f'{kp}.q_activ')
        mult = self.requant_mult(f'{kp}.rq', acc_scale, s)
        kh, kw = self.fm[key + '.weight_int'].shape[:2]
        one = (kh, kw) == (1, 1)
        if b <= 8:     # the requant (monotone, 0 → 0) takes the ReLU in
            if one:
                return self._conv1x1(h, key, stride, mult, b, sg), s
            return self._conv_kxk(h, key, stride, mult, b, sg, pad=pad), s
        acc = (self._conv1x1(h, key, stride) if one
               else self._conv_kxk(h, key, stride, pad=pad))
        return self._requant(torch.clamp_min(acc, 0), mult, b, sg,
                             self.res_dt), s

    def _stem_conv1(self, x8, s_in):
        """The stem's 3×3/s2 q_conv1 → (tensor, scale): through
        space-to-depth on raw images, or over the host fold as its 2×2/s1
        rewrite (``int8_conv_acc``, C = 48), then ReLU and the requant with
        the fourfold multipliers, depth-to-space and the slice."""
        kp = f'{_IP}.q_conv1'
        if not self.folded:
            return self._incept_conv(x8, s_in, kp, 2, 0)
        key = f'{kp}.q_convbn'
        acc = self._fold3x3s2_acc(x8, key)
        s, bits, sg = self.act_info(f'{kp}.q_activ')
        mult = self.requant_mult(f'{kp}.rq_f',
                                 _fold.tile4(self._scale(key, s_in)), s)
        xq = self._requant(torch.clamp_min(acc, 0), mult, bits, sg,
                           self._container(bits))
        oh, ow = self.out_hw
        return _fold.depth_to_space_2x2(xq)[:, :oh, :ow, :].contiguous(), s

    def _branch(self, x, s, bp: str, kind: str, kwargs):
        """One branch on the unit input ``x`` at scale ``s`` → (its integer
        output, its scale).  A pool branch hands ``x`` to A1 with its input
        requant fused in front of the pool (in reference mode: the input
        requant, A1's quotient form, the pool requant)."""
        if kind == mi.AVG_POOL and self.reference:
            h, a = self._requant_to(x, s, f'{bp}.q_input_act', f'{bp}.in')
            h, sp = self._requant_to(ka.int_avgpool3x3(h), a,
                                     f'{bp}.q_pool_act', f'{bp}.pool')
            return self._incept_conv(h, sp, f'{bp}.q_conv')
        if kind == mi.AVG_POOL:
            a, a_bits, a_sg = self.act_info(f'{bp}.q_input_act')
            sp, bp_bits, sgp = self.act_info(f'{bp}.q_pool_act')
            h = ka.int_avgpool3x3_requant(
                x, self.requant_mult(f'{bp}.pool', np.float32(a), sp),
                out_bits=bp_bits, signed=sgp,
                in_mult=self.requant_mult(f'{bp}.in', s, a), in_bits=a_bits,
                in_signed=a_sg)
            return self._incept_conv(h, np.float32(sp), f'{bp}.q_conv')
        h, a = self._requant_to(x, s, f'{bp}.q_input_act', f'{bp}.in')
        if kind == mi.MAX_POOL:
            return maxpool_int(h, pad=0), a
        if kind == mi.CONV1X1:
            return self._incept_conv(h, a, f'{bp}.q_conv')
        for c, (st, pd) in enumerate(zip(kwargs['strides'],
                                         kwargs['paddings']), start=1):
            h, a = self._incept_conv(h, a, f'{bp}.q_conv_list.q_conv{c}', st,
                                     pd)
        if kind == mi.CONV_SEQ:
            return h, a
        y1, a1 = self._incept_conv(h, a, f'{bp}.q_conv1x3', 1, (0, 1))
        y2, a2 = self._incept_conv(h, a, f'{bp}.q_conv3x1', 1, (1, 0))
        key = f'{bp}.q_rescaling_activ'
        r1, s_sub = self._requant_to(y1, a1, key, f'{bp}.rs1')
        r2, _ = self._requant_to(y2, a2, key, f'{bp}.rs2')
        return torch.cat([r1.to(r2.dtype), r2], dim=-1), s_sub

    def _forward(self, images: torch.Tensor, emit) -> torch.Tensor:
        s_in, b_in, _ = self.act_info(f'{_IP}.q_input_activ')
        n = 2 ** (b_in - 1) - 1
        x = torch.clamp(qops.round_half_up(qops.exact_div(images, s_in)),
                        -n - 1, n).to(torch.int8)
        emit('input', x)
        x, s = self._stem_conv1(x, np.float32(s_in))
        for c, (_, _, stride, pad) in enumerate(mi.INIT_CONVS[1:], start=2):
            x, s = self._incept_conv(x, s, f'{_IP}.q_conv{c}', stride, pad)
            if c in mi.INIT_POOLS:
                x = maxpool_int(x, pad=0)
        emit('init', x)

        for unit in self.units:
            key = f'{unit.prefix}.q_rescaling_activ'
            cat_dt = self._container(self.act_info(key)[1])
            pieces = []
            for bi, (name, kind, kwargs) in enumerate(unit.branch_defs):
                h, a = self._branch(x, s, f'{unit.prefix}.branches.{name}',
                                    kind, kwargs)
                # each branch to the unit's shared scale, then the concat
                r, s_unit = self._requant_to(h, a, key,
                                             f'{unit.prefix}.cat{bi}')
                pieces.append(r.to(cat_dt))
            x, s = torch.cat(pieces, dim=-1), s_unit
            emit(key, x)

        # head: integer global average pool → requant → FC
        pooled = self._avg_pool(x).to(torch.int32)
        f8, s_fc = self._requant_to(pooled, s, 'features.q_concat_activ',
                                    'fc_in')
        emit('fc_input', f8)
        return self._head(f8, 'output.q_fc', s_fc)


def build_inceptionv3_engine(fm: FrozenModel, width_div: Optional[int] = None,
                             capture: Optional[str] = None,
                             input_mode: str = 'float32',
                             input_hw: Sequence[int] = (299, 299),
                             wide_dtype: torch.dtype = torch.int32,
                             requant_mode: str = 'native',
                             routing: Optional[Dict[str, str]] = None,
                             device='cuda') -> InceptionEngine:
    """Build ``engine(images) -> logits f32`` of a frozen QInceptionV3 on
    ``device``.

    ``width_div``: the channel divisor the model was built with (None: read
    from the artifact, :func:`width_div_from_frozen`).  ``input_mode``:
    'float32' takes raw (B, H, W, 3) float32 images; 'folded_float32' takes
    (B, fh, fw, 48) images the host folded with
    ``inference.fold.fold4_images_3x3s2(x, 0)``, and ``input_hw`` is the
    images' size before the fold.  ``wide_dtype``: the container of the
    9–16-bit activation nodes, torch.int32 or torch.int16 (half the bytes;
    the values are clamped to the 16-bit range, so the narrowing is exact
    where those nodes are symmetric, which int16 requires).  With
    ``requant_mode``: 'native', or 'reference' (float32 input and the
    int32 container only).  ``routing``: a table of ``inference.routing``
    for the 1×1 convs whose requant fuses (native mode only).  With
    ``capture``, the engine returns the raw tensor at that node instead of
    the logits."""
    if width_div is None:
        width_div = width_div_from_frozen(fm)
    return InceptionEngine(fm, width_div, capture, input_mode, input_hw,
                           wide_dtype, engine_device(device), requant_mode,
                           routing)
