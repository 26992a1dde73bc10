"""Integer-only ResNet inference engine (port of hawq_tpu/inference/engine.py
``build_resnet_engine``, native and reference requant modes).

A FrozenModel becomes a callable ``engine(images) -> logits``: int8
activations, int8×int8→int32 convolutions with dyadic requant epilogues and
int32 or int16 residual carriers, bit-identical to the reference engine on
logits and on every capture node.  All multipliers are computed on the host
in numpy (float32; float64 pairs in reference mode) and uploaded once.

Routing (every integer conv and the FC go through the port's kernels; on a
CPU device the kernels' plain versions run instead):

  * 1×1 convs → ``int8_matmul_requant`` / ``int8_matmul_acc``; stride 2 is a
    slice, made contiguous, then the matmul;
  * 3×3 convs → ``int8_conv_requant`` / ``int8_conv_acc`` by the geometry
    of ``kernels.conv.conv_call`` (``IntEngine._conv_kxk``, which takes any
    k×k kernel and per-axis border); stride 2 through the space-to-depth
    rewrite;
  * every unit conv whose weights are 4-bit (``cfg.weight_bits(key) == 4``,
    the reference's rule with ``routing=None``) takes the ``int4w_*`` form of
    the same kernel instead, with its weights nibble-packed once on the host
    (``pack_int4`` / ``pack_int4_conv``); with a routing table
    (``inference.routing``: 'int8' / 'int4w' per unit conv) only the unit
    convs it routes to 'int4w' do; the init conv and the FC always take the
    int8 kernels, as in the reference;
  * the folded init (``input_mode='folded_float32'`` or ``'folded_int8'``)
    → ``int8_conv_acc`` over the 3×3, C=48, N=4·64 fold, then
    ``maxpool_folded_requant``: requant + ReLU in the folded layout and the
    max-pool in one kernel;
  * the raw 7×7/s2 init (``input_mode='float32'`` or ``'uint8'``) →
    ``int8_conv_acc`` over its space-to-depth 4×4 rewrite, with the image's
    3 channels and the weights' zero-padded to 4 (C=16 after the rewrite);
    its max-pool is :func:`maxpool_int`, four strided integer maxima
    after a pad (ResNet v2 pools its raw int32 accumulator the same way);
  * the FC → ``int8_matmul_acc`` (a float product of 2048·127·127 would not
    be exact);
  * a bottleneck's conv3 in native mode with the int32 carrier, where its
    weights are int8 → ``int8_matmul_acc_residual``: the unit's residual
    requant-add and ReLU in the matmul's epilogue, so that the conv leaves
    as the carrier (:meth:`ResnetEngine._fused_residual`); every other unit
    conv3 and every basic block's conv2 take the accumulator form, then the
    requant-add, ReLU (and int16 clamp) as PyTorch ops;
  * such a conv3 of every unit but the last, where the next unit's
    activation has at most 8 bits, also leaves as the next unit's entry
    requant (``int8_matmul_acc_residual_requant``,
    :meth:`ResnetEngine._entry_in_epilogue`), which that unit takes as its
    input; where nothing reads the carrier (the next unit takes its identity
    from its own conv, and the forward's emit does not read the unit's
    ``quant_act_int32`` node) it is not stored
    (``int8_matmul_residual_requant``);
  * every other native requant (a unit's entry, the raw init's with its
    ReLU, the FC's input; in the other families also the requants after
    accumulator-form convs and, in InceptionV3, the requants of a concat's
    pieces into it, ``InceptionEngine._concat_to``) → ``kernels.requant``
    (:meth:`IntEngine._requant`), one pass over the integers;
  * the weights of every conv and matmul call (the init conv's too) are
    cached in the Hopper GEMM core's K-major layout (``prepare_weights``;
    the 4-bit convs' and 1×1 convs' ``prepare_weights_int4``, still
    nibble-packed), on a CPU device too, where the wrappers then run the
    plain versions of that core's walk; the stride-1 k×k convs take
    unpadded activations (TMA supplies the zero border).

``requant_mode='reference'`` replays an imported reference checkpoint
(``utils.checkpoint.import_reference_quantized``) with the reference's own
requant: 31-bit Decimal-rounded mantissas (``quant.reference_oracle``)
evaluated in float64 on the engine's device, round-half-even
(``quant.ops.requant_int32_ref`` / ``requant_add_int32_ref``).  No fused
requant kernel computes that, so in this mode every conv takes its
accumulator form (``int8_conv_acc`` / ``int4w_conv_acc``,
``int8_matmul_acc`` / ``int4w_matmul_acc``), then ReLU and the float64
requant as PyTorch ops; the folded init runs ``int8_conv_acc``, the
requant, ReLU, then ``maxpool_folded`` on the int32 carrier.  Every input
mode is accepted, and the int32 carrier only.

``capture=<node>`` returns the raw integer tensor at a named node instead of
the logits, and the forward stops there (``inference.profile`` times the
engine truncated at successive nodes): 'input', 'init', '<stage>.<unit>.input'
/ '.conv1' / '.conv2' / '.quant_act_int32', 'avg_pool', 'fc_input',
'fc_output'.

Spans (``utils.tracing``, recorded only while a profiler records):
``engine.forward``, every family's whole call; ``engine.conv``, each conv
through :meth:`IntEngine._conv_kxk` / :meth:`IntEngine._conv1x1` and the
folded or CIFAR init conv, with its own layout glue; and in the ResNet v1
engine ``engine.input`` (normalization and quantization of the images),
``engine.requant`` (each unit's entry requant that conv3's epilogue does
not take, and the FC's input) and ``engine.residual`` (each unit's
requant-add, ReLU, clamp and cast; where conv3 takes the residual epilogue,
that conv with them, in place of its ``engine.conv``, and the next unit's
entry requant where the epilogue takes it); the InceptionV3 engine's own
sites are listed in
``engine_inception.py``.  The ResNet pools and head have none.  Here only
``engine.forward`` takes a device time (two timing events a call); the
sites' device times are their ranges in the profiler's trace.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hawq_tpu_torch.configs.bit_config import (RESNET_UNITS,
                                               RESNET_CONVS_PER_UNIT,
                                               RESNET_CIFAR_ARCHS)
from hawq_tpu_torch.inference import fold as _fold
from hawq_tpu_torch.inference.freeze import FrozenModel
from hawq_tpu_torch.inference.routing import check_routing, make_router
from hawq_tpu_torch.kernels import conv as kc
from hawq_tpu_torch.kernels import pool as kp
from hawq_tpu_torch.kernels import requant as kr
from hawq_tpu_torch.quant import ops as qops
from hawq_tpu_torch.quant import reference_oracle as ro
from hawq_tpu_torch.utils.tracing import span

# input mode → the dtype its images arrive in
INPUT_MODES = {'float32': torch.float32, 'folded_float32': torch.float32,
               'uint8': torch.uint8, 'folded_int8': torch.int8}
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
REQUANT_MODES = ('native', 'reference')


def maxpool_int(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """3×3/s2 max-pool of an NHWC integer tensor with a border of ``pad``
    (1, or 0 for VALID), exactly at any magnitude: the maximum over a
    window's three columns, then over its three rows, of strided slices,
    the border the dtype minimum (the reference's ``reduce_window`` init)."""
    b, h, w, c = x.shape
    oh, ow = (h + 2 * pad - 3) // 2 + 1, (w + 2 * pad - 3) // 2 + 1
    xp = x
    if pad:
        xp = F.pad(x, (0, 0, pad, pad, pad, pad),
                   value=torch.iinfo(x.dtype).min)
    cols = xp[:, :, 0:2 * ow - 1:2]
    for dx in (1, 2):
        cols = torch.maximum(cols, xp[:, :, dx:dx + 2 * ow - 1:2])
    out = cols[:, 0:2 * oh - 1:2]
    for dy in (1, 2):
        out = torch.maximum(out, cols[:, dy:dy + 2 * oh - 1:2])
    return out.contiguous()


def engine_device(device) -> torch.device:
    """The device an engine runs on; a bare 'cuda' means the current card."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


class _Truncated(Exception):
    """An engine's capture node reached: its value ends the forward."""

    def __init__(self, value: torch.Tensor):
        super().__init__('capture')
        self.value = value


class _Capture:
    """The emit of an engine call: the capture node's value ends the
    forward; :meth:`wants` tells the forward that no other node's value is
    read."""

    __slots__ = ('node',)

    def __init__(self, node: Optional[str]):
        self.node = node

    def wants(self, name: str) -> bool:
        return name == self.node

    def __call__(self, name: str, value) -> None:
        if name == self.node:
            raise _Truncated(value)


def _emit_reads(emit, name: str) -> bool:
    """Whether a forward's ``emit`` reads node ``name``'s value: an engine
    call's reads its capture node alone; any other emit (a caller's record
    of every node) reads each one."""
    wants = getattr(emit, 'wants', None)
    return wants is None or wants(name)


class IntEngine:
    """What the integer engines share: the frozen model and its device
    constants (weights laid out for the kernels, dyadic multipliers), the
    1×1 and k×k conv routes (the raw init convs through space-to-depth
    among them), the requants of either mode, and the checks of a call.
    Subclasses define ``_forward``.  ``reference_input_modes``: the input
    modes that ``requant_mode='reference'`` takes; ``routing``: a table of
    ``inference.routing`` (native mode only); ``input_mean`` /
    ``input_std``: the normalization of 'uint8' input."""

    input_node = 'quant_input'       # the activation node of the images

    def __init__(self, fm: FrozenModel, capture: Optional[str],
                 input_modes, input_mode: str, residual_dtype: torch.dtype,
                 device: torch.device, requant_mode: str = 'native',
                 reference_input_modes=None, routing=None,
                 input_mean: np.ndarray = IMAGENET_MEAN,
                 input_std: np.ndarray = IMAGENET_STD):
        if input_mode not in input_modes:
            raise ValueError(f'input_mode {input_mode!r} not in '
                             f'{tuple(input_modes)}')
        if residual_dtype not in (torch.int32, torch.int16):
            raise ValueError(f'residual_dtype {residual_dtype} must be '
                             f'torch.int32 or torch.int16')
        if requant_mode not in REQUANT_MODES:
            raise ValueError(f'requant_mode {requant_mode!r} not in '
                             f'{REQUANT_MODES}')
        self.reference = requant_mode == 'reference'
        if self.reference:
            modes = tuple(reference_input_modes or input_modes)
            if input_mode not in modes:
                raise ValueError(f"requant_mode='reference' takes input_mode "
                                 f"{' or '.join(map(repr, modes))}, not "
                                 f"{input_mode!r}")
            if residual_dtype != torch.int32:
                raise ValueError(f"requant_mode='reference' takes the "
                                 f"torch.int32 carrier only, not "
                                 f"{residual_dtype}")
        self.routing = check_routing(routing)
        if self.reference and self.routing is not None:
            raise ValueError("requant_mode='reference' takes no routing "
                             "table")
        self.fm = fm
        self.capture = capture
        self.res_dt = residual_dtype
        self.input_mode = input_mode
        self.device = device
        self._mult: Dict[str, torch.Tensor] = {}
        self._w: Dict[Tuple, tuple] = {}
        self._route = make_router(fm, device, self._w)
        # uint8 input: the host preprocessing u8/255 → (v − mean)/std,
        # replayed on the device in the same float32 op order
        self._u8_mean = self._dev(np.asarray(input_mean, np.float32))
        self._u8_std = np.asarray(input_std, np.float32)

    # -- host-side constants ----------------------------------------------
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, in C order (a transposed
        view, as an imported checkpoint holds, keeps its strides through
        ``torch.tensor``; the kernels take contiguous tensors)."""
        return torch.tensor(np.asarray(a, order='C'), device=self.device)

    def requant_mult(self, name: str, acc_scale, out_scale,
                     channels: Optional[int] = None):
        """The multiplier of requant site ``name`` (``acc_scale`` scalar or
        per-channel) on the engine's device: in native mode one float32
        23-bit dyadic multiplier, with ``channels`` repeated to that many
        (a kernel's per-channel operand); in reference mode the reference's
        float64 pair (m, 2⁻ᵉ), ``reference_oracle.decompose_ref``."""
        if name not in self._mult:
            if self.reference:
                self._mult[name] = tuple(
                    self._dev(a) for a in ro.decompose_ref(acc_scale,
                                                           out_scale))
            else:
                ratio = (np.asarray(acc_scale, np.float32)
                         / np.float32(out_scale)).astype(np.float32)
                if channels is not None:
                    ratio = np.broadcast_to(ratio, (channels,))
                self._mult[name] = self._dev(
                    qops.np_dyadic_multiplier(ratio))
        return self._mult[name]

    def _requant(self, acc, mult, bits: int, signed: bool,
                 out_dtype=torch.int8, *, relu: bool = False) -> torch.Tensor:
        """The requant of the engine's mode (``mult`` from
        :meth:`requant_mult`), with ``relu`` the ReLU before it (the
        requant, monotone and 0 → 0, takes it in): in native mode one
        ``kernels.requant.requant_int32``."""
        if self.reference:
            y = qops.requant_int32_ref(acc, *mult, bits, signed, out_dtype)
            return torch.clamp_min(y, 0) if relu else y
        return kr.requant_int32(acc, mult, out_bits=bits, signed=signed,
                                relu=relu, out_dtype=out_dtype)

    def _requant_add(self, acc, mult_main, identity, mult_id,
                     out_dtype=torch.int32) -> torch.Tensor:
        """The residual requant-add of the engine's mode, unclamped."""
        if self.reference:
            return qops.requant_add_int32_ref(acc, *mult_main, identity,
                                              *mult_id, out_dtype)
        return qops.requant_add_int32(acc, mult_main, identity, mult_id,
                                      out_dtype)

    def act_info(self, key: str) -> Tuple[np.float32, int, bool]:
        cfg = self.fm.cfg
        return (self.fm.act_scale(key), cfg.act_bits(key),
                cfg.act_mode(key) == 'symmetric')

    def _int4(self, key: str) -> bool:
        """Whether conv ``key`` runs on nibble-packed int4 weights: with a
        routing table, where the table routes it to 'int4w', its weights are
        4-bit and the engine routes such a site (:meth:`_routable`); without
        one, by the engine's own rule (:meth:`_default_int4`)."""
        if self.routing is None:
            return self._default_int4(key)
        return (self.routing.get(key) == 'int4w'
                and self.fm.cfg.weight_bits(key) == 4 and self._routable(key))

    def _default_int4(self, key: str) -> bool:
        """The engine's packed rule without a table: never, unless the
        engine has one (the ResNet v1 engine)."""
        return False

    def _routable(self, key: str) -> bool:
        """Whether a routing table may send conv ``key`` to the packed
        kernels: a 1×1 conv (the JAX package's ``make_router``)."""
        return self.fm[key + '.weight_int'].shape[:2] == (1, 1)

    def _scale(self, key: str, act_scale) -> np.ndarray:
        """weight scale × input activation scale of a conv, float32."""
        return (self.fm[key + '.weight_scale'].astype(np.float32)
                * np.float32(act_scale))

    @staticmethod
    def _avg_pool(x: torch.Tensor) -> torch.Tensor:
        """Integer global average pool of an NHWC integer tensor, truncating
        (trunc(sum/hw + 0.01), a true division) → float32 (B, C)."""
        pooled = torch.sum(x, dim=(1, 2), dtype=torch.int32)
        return torch.trunc(qops.exact_div(pooled.to(torch.float32),
                                          x.shape[1] * x.shape[2]) + 0.01)

    def _head(self, f8: torch.Tensor, key: str, act_scale) -> torch.Tensor:
        """The FC (or 1×1 head) on the int8 pooled vector through
        ``int8_matmul_acc`` (a float product of 2048·127·127 would not be
        exact) → float32 logits."""
        acc = self._route(key, False).acc(f8)
        if 'out_scale' not in self._mult:
            self._mult['out_scale'] = self._dev(self._scale(key, act_scale))
        return acc.to(torch.float32) * self._mult['out_scale']

    def _conv_w(self, key: str, stride: int, pad: Tuple[int, int],
                int4: bool):
        """Flattened conv weights (rewritten for ``stride`` by
        ``kernels.conv.conv_call_kernel``; per-tap nibble-packed with
        ``int4``), taps, cin, bias.  They are prepared for the Hopper core,
        the packed ones still packed, for calls with ``pad``, the border
        :func:`kernels.conv.conv_call` leaves to the kernel."""
        if (key, stride) not in self._w:
            w = kc.conv_call_kernel(np.asarray(self.fm[key + '.weight_int']),
                                    (stride, stride))
            self._w[key, stride] = self._conv_weights(
                w, self.fm[key + '.bias_int'], pad, int4)
        return self._w[key, stride]

    def _conv_weights(self, w: np.ndarray, bias: np.ndarray,
                      pad: Tuple[int, int], int4: bool = False):
        """(weights, taps, cin, bias) of an HWIO kernel on the device: the
        Hopper-core handle of the flattened (or per-tap packed) tensor for
        calls with ``pad``."""
        wf = kc.flatten_conv_kernel(w)
        taps = (w.shape[0], w.shape[1])
        if int4:
            wf = kc.pack_int4_conv(wf, taps[0] * taps[1])
        wd = kc.prepare_conv_weights(self._dev(wf), taps, w.shape[2], pad,
                                     int4)
        return wd, taps, w.shape[2], self._dev(bias)

    def _fold3x3s2_acc(self, x8: torch.Tensor, key: str) -> torch.Tensor:
        """The 3×3/s2 conv ``key`` over host-folded images
        (``inference.fold.fold4_images_3x3s2``; ``self.fold_hw`` their
        folded size) as its 2×2/s1 rewrite through ``int8_conv_acc`` (C =
        48, 4·N outputs) → the int32 accumulator + bias in the fold's (py,
        px, n) channel order."""
        b = x8.shape[0]
        fh, fw = self.fold_hw
        if tuple(x8.shape[1:3]) != (fh, fw):
            raise ValueError(f'folded input {tuple(x8.shape[1:3])} does not '
                             f'match input_hw: expected {(fh, fw)} folded '
                             f'rows')
        if 'init' not in self._w:
            w = np.asarray(self.fm[key + '.weight_int'])
            self._w['init'] = self._conv_weights(
                _fold.fold4_kernel_3x3s2(w),
                _fold.tile4(self.fm[key + '.bias_int']), (0, 0))
        wf, taps, cin, bias = self._w['init']
        with span('engine.conv'):
            return kc.int8_conv_acc(kc.prepare_conv_input(x8, (0, 0)), wf,
                                    bias, taps=taps, out_hw=(fh - 1, fw - 1),
                                    cin=cin).reshape(b, fh - 1, fw - 1, -1)

    def _quantize_float(self, images: torch.Tensor) -> torch.Tensor:
        """float32 images (or a folded layout) → the int8 input integers,
        floor(v/s_in + 0.5) with a true division, s_in the scale of the
        family's input node (``input_node``); the fold's pad zeros quantize
        to 0, like the conv's padding."""
        s_in = self.fm.act_scale(self.input_node)
        return torch.clamp(qops.round_half_up(qops.exact_div(images, s_in)),
                           -128, 127).to(torch.int8)

    def _quantize_input(self, images: torch.Tensor) -> torch.Tensor:
        """Images → the int8 input integers (true divisions throughout:
        :func:`qops.exact_div`): uint8 pixels normalized first, u8/255 →
        (v − mean)/std; 'folded_int8' images as they come."""
        if self.input_mode == 'folded_int8':
            return images            # quantized and folded on the host
        if self.input_mode == 'uint8':
            images = qops.exact_div(
                qops.exact_div(images.to(torch.float32), 255.0)
                - self._u8_mean, self._u8_std)
        return self._quantize_float(images)

    # -- layers -------------------------------------------------------------
    def _conv_kxk(self, x8, key, stride, mult=None, bits=8, signed=True, *,
                  pad=1):
        """k×k conv (the taps of the frozen weights) with stride 1 or 2 and
        ``pad`` rows and columns of zero border (an int, or (ph, pw)), by
        the geometry of ``kernels.conv.conv_call``: requant+ReLU to int8,
        or (mult None) the int32 accumulator + bias.  In reference mode the
        requant follows the accumulator form."""
        b = x8.shape[0]
        ph, pw = (pad, pad) if isinstance(pad, int) else pad
        kh, kw = self.fm[key + '.weight_int'].shape[:2]
        with span('engine.conv'):
            xp, geo = kc.conv_call(x8, (kh, kw), (stride, stride),
                                   ((ph, ph), (pw, pw)))
            int4 = self._int4(key)
            fused = mult is not None and not self.reference
            wf, taps, cin, bias = self._conv_w(key, stride, geo['pad'], int4)
            if not fused:
                fn = kc.int4w_conv_acc if int4 else kc.int8_conv_acc
                y = fn(xp, wf, bias, **geo)
                if mult is not None:
                    y = self._requant(y, mult, bits, signed, relu=True)
            else:
                fn = kc.int4w_conv_requant if int4 else kc.int8_conv_requant
                y = fn(xp, wf, bias, mult, out_bits=bits, signed=signed,
                       relu=True, **geo)
            return y.reshape(b, *geo['out_hw'], -1)

    def _conv1x1(self, x8, key, stride, mult=None, bits=8, signed=True):
        """1×1 conv as a matmul (``inference.routing.Routed1x1``, packed by
        :meth:`_int4`): requant+ReLU to int8, or int32 acc.  In reference
        mode the requant follows the accumulator form."""
        with span('engine.conv'):
            if stride > 1:
                x8 = x8[:, ::stride, ::stride, :].contiguous()
            fused = mult is not None and not self.reference
            site = self._route(key, self._int4(key))
            if fused:
                return site.requant(x8, mult, out_bits=bits, signed=signed,
                                    relu=True)
            y = site.acc(x8)
            if mult is not None:
                y = self._requant(y, mult, bits, signed, relu=True)
            return y

    # -- forward ------------------------------------------------------------
    def __call__(self, images) -> torch.Tensor:
        """``images``: a tensor on the engine's device in the input mode's
        dtype (float32, or uint8 / int8 for 'uint8' / 'folded_int8'), or a
        host numpy array, which is uploaded to it."""
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.asarray(images)).to(self.device)
        if images.device != self.device:
            raise ValueError(f'images on {images.device}, engine on '
                             f'{self.device}')
        want = INPUT_MODES[self.input_mode]
        if images.dtype != want:
            raise ValueError(f'input_mode {self.input_mode!r} takes {want} '
                             f'images, got {images.dtype}')
        try:
            with span('engine.forward', self.device):
                logits = self._forward(images, _Capture(self.capture))
        except _Truncated as t:          # the forward stops at the capture
            return t.value
        if self.capture is not None:
            raise KeyError(f'no capture node {self.capture!r}')
        return logits


class ResnetEngine(IntEngine):
    """Callable integer ResNet; see :func:`build_resnet_engine`."""

    def __init__(self, fm: FrozenModel, capture: Optional[str],
                 residual_dtype: torch.dtype, input_mode: str,
                 input_mean: np.ndarray, input_std: np.ndarray,
                 device: torch.device, requant_mode: str = 'native',
                 routing=None):
        super().__init__(fm, capture, INPUT_MODES, input_mode, residual_dtype,
                         device, requant_mode, routing=routing,
                         input_mean=input_mean, input_std=input_std)
        arch = fm.arch
        self.bottleneck = RESNET_CONVS_PER_UNIT[arch] == 3
        self.conv1_stride = arch == 'resnet50'
        self.cifar = arch in RESNET_CIFAR_ARCHS
        self.init_key = ('quant_init_convbn' if self.bottleneck
                         else 'quant_init_block_convbn')
        self.folded = input_mode.startswith('folded')
        init_k = fm[self.init_key + '.weight_int'].shape[:2]
        if self.folded and init_k != (7, 7):
            raise ValueError('folded input needs the 7×7/s2 init conv')
        self.units = [(si, u) for si, n in enumerate(RESNET_UNITS[arch], 1)
                      for u in range(1, n + 1)]

    def _default_int4(self, key: str) -> bool:
        """Without a table a unit conv streams nibble-packed int4 weights
        where they are 4-bit."""
        return self.fm.cfg.weight_bits(key) == 4

    def _routable(self, key: str) -> bool:
        """A table routes every unit conv, 1×1 and 3×3 (not the init
        conv)."""
        return key.startswith('stage')

    def _fused_residual(self, key3: str) -> bool:
        """Whether a bottleneck's conv3 ``key3`` takes the residual
        epilogue: native requant, the int32 carrier and int8 weights (not
        packed by the bit config's rule or the routing table)."""
        return (not self.reference and self.res_dt == torch.int32
                and not self._int4(key3))

    def _entry_in_epilogue(self, i: int, s_out, emit):
        """(mult, bits, signed, carrier) of the next unit's entry requant
        where the fused conv3 of unit ``i`` (:meth:`_fused_residual`) takes
        it in its epilogue: a next unit whose activation has at most 8 bits
        (the int8 entry; ``s_out`` the carrier's scale).  ``carrier``:
        whether the carrier is stored, i.e. read: as the next unit's identity
        (it has no identity conv), or as this unit's ``quant_act_int32``
        node by ``emit``.  None for the last unit, or a wider activation."""
        if i + 1 == len(self.units):
            return None
        q = 'stage{}.unit{}'.format(*self.units[i + 1])
        sa, ba, signed = self.act_info(f'{q}.quant_act')
        if ba > 8:
            return None
        p = 'stage{}.unit{}'.format(*self.units[i])
        own_identity = (f'{q}.quant_identity_convbn.weight_int'
                        in self.fm.tensors)
        carrier = not own_identity or _emit_reads(emit,
                                                  f'{p}.quant_act_int32')
        return (self.requant_mult(f'{q}.in', np.float32(s_out), sa), ba,
                signed, carrier)

    def _init_w(self):
        """Weights of the init conv that does not take the space-to-depth
        route: the 3×3 fold (folded input) or the CIFAR 3×3 (C = 3, which
        the card's alignment step zero-fills to 16 at each call)."""
        if 'init' not in self._w:
            w = np.asarray(self.fm[self.init_key + '.weight_int'])
            b = np.asarray(self.fm[self.init_key + '.bias_int'])
            if self.folded:
                w, b = _fold.fold4_kernel(w), np.tile(b, 4)
            self._w['init'] = self._conv_weights(w, b, (0, 0))
        return self._w['init']

    def _forward(self, images: torch.Tensor, emit) -> torch.Tensor:
        fm = self.fm

        # ---- input quantization and init block ----
        s_in = fm.act_scale('quant_input')
        with span('engine.input'):
            x8 = self._quantize_input(images)
        emit('input', x8)
        s16, b16, signed16 = self.act_info('quant_act_int32')
        s_init = self._scale(self.init_key, s_in)
        if self.folded or self.cifar:
            wf, taps, cin, bias = self._init_w()
            b, h, w, _ = x8.shape
            if self.folded:
                # per-channel vectors tiled over the 4 stride-2 origins, in
                # the fold's (py, px, n) channel order
                s_init = np.tile(s_init, 4)
                oh, ow, pad = h - 2, w - 2, (0, 0)
            else:
                oh, ow, pad = h, w, (1, 1)
            with span('engine.conv'):
                acc = kc.int8_conv_acc(kc.prepare_conv_input(x8, pad), wf,
                                       bias, taps=taps, out_hw=(oh, ow),
                                       cin=cin).reshape(b, oh, ow, -1)
        else:
            acc = self._conv_kxk(x8, self.init_key, 2, pad=3)
        # requant + ReLU before the pool (monotone, so it commutes with the
        # training graph's pool → requant → relu order); on the folded path
        # one kernel requantizes each value of a window, then takes the max
        # (in reference mode the requant and ReLU run first, then the pool)
        mult = self.requant_mult('init_requant', s_init, s16)
        if self.folded and not self.reference:
            x = kp.maxpool_folded_requant(acc, mult, out_bits=b16,
                                          signed=signed16, relu=True,
                                          out_dtype=self.res_dt)
        else:
            x = self._requant(acc, mult, b16, signed16, self.res_dt,
                              relu=True)
            if self.folded:
                x = kp.maxpool_folded(x)
            elif not self.cifar:
                x = maxpool_int(x)
        emit('init', x)
        prev_scale = np.float32(s16)

        # ---- units ----
        entry = None     # a unit's input, where the conv3 before took it
        for i, (si, u) in enumerate(self.units):
            p = f'stage{si}.unit{u}'
            stride = 2 if (u == 1 and si > 1) else 1
            sa, ba, signed_a = self.act_info(f'{p}.quant_act')
            if entry is None:
                mult = self.requant_mult(f'{p}.in', prev_scale, sa)
                with span('engine.requant'):
                    xa = self._requant(x, mult, ba, signed_a)
            else:
                xa, entry = entry, None
            emit(f'{p}.input', xa)

            id_key = f'{p}.quant_identity_convbn'
            if id_key + '.weight_int' in fm.tensors:
                id_scale = self._scale(id_key, sa)
                id_acc = self._conv1x1(xa, id_key, stride)
            else:
                id_acc, id_scale = x, prev_scale

            key1 = f'{p}.quant_convbn1'
            sa1, ba1, sg1 = self.act_info(f'{p}.quant_act1')
            mult = self.requant_mult(f'{p}.a1', self._scale(key1, sa), sa1)
            key2 = f'{p}.quant_convbn2'
            acc_scale = self._scale(key2, sa1)
            fused = False
            if self.bottleneck:
                s1, s2 = (stride, 1) if self.conv1_stride else (1, stride)
                h = self._conv1x1(xa, key1, s1, mult, ba1, sg1)
                emit(f'{p}.conv1', h)
                sa2, ba2, sg2 = self.act_info(f'{p}.quant_act2')
                mult = self.requant_mult(f'{p}.a2', acc_scale, sa2)
                h = self._conv_kxk(h, key2, s2, mult, ba2, sg2)
                emit(f'{p}.conv2', h)
                key3 = f'{p}.quant_convbn3'
                acc_scale = self._scale(key3, sa2)
                fused = self._fused_residual(key3)
                if not fused:
                    acc = self._conv1x1(h, key3, 1)
            else:
                h = self._conv_kxk(xa, key1, stride, mult, ba1, sg1)
                emit(f'{p}.conv1', h)
                acc = self._conv_kxk(h, key2, 1)

            # residual requant-add at 16-bit precision; the unclamped sum
            # stays int32 until the ReLU and the int16 clamp
            s_out = self.act_info(f'{p}.quant_act_int32')[0]
            n = id_acc.shape[-1] if fused else None
            mult_main = self.requant_mult(f'{p}.res_main', acc_scale, s_out,
                                          n)
            mult_id = self.requant_mult(f'{p}.res_id', id_scale, s_out, n)
            with span('engine.residual'):
                nxt = self._entry_in_epilogue(i, s_out, emit) if fused \
                    else None
                if nxt is not None:   # conv3 leaves as the next unit's input
                    x, entry = self._route(key3, False).residual_requant(
                        h, id_acc, mult_main, mult_id, *nxt)
                elif fused:           # conv3 leaves as the carrier
                    x = self._route(key3, False).residual(
                        h, id_acc, mult_main, mult_id)
                else:
                    x_wide = torch.clamp_min(self._requant_add(
                        acc, mult_main, id_acc, mult_id), 0)
                    if self.res_dt != torch.int32:
                        x_wide = torch.clamp(x_wide, 0,
                                             torch.iinfo(self.res_dt).max)
                    x = x_wide.to(self.res_dt)
            prev_scale = np.float32(s_out)
            emit(f'{p}.quant_act_int32', x)

        # ---- head: integer average pool with truncation, then the FC ----
        pooled = self._avg_pool(x)
        emit('avg_pool', pooled)
        s_fc, b_fc, sg_fc = self.act_info('quant_act_output')
        mult = self.requant_mult('fc_in', prev_scale, s_fc)
        with span('engine.requant'):
            f8 = self._requant(pooled.to(torch.int32), mult, b_fc, sg_fc)
        emit('fc_input', f8)
        logits = self._head(f8, 'quant_output', s_fc)
        emit('fc_output', logits)
        return logits


def build_resnet_engine(fm: FrozenModel, capture: Optional[str] = None,
                        residual_dtype: torch.dtype = torch.int32,
                        input_mode: str = 'float32',
                        input_mean: np.ndarray = IMAGENET_MEAN,
                        input_std: np.ndarray = IMAGENET_STD,
                        requant_mode: str = 'native',
                        routing: Optional[Dict[str, str]] = None,
                        device='cuda') -> ResnetEngine:
    """Build ``engine(images_nhwc) -> logits_f32`` on ``device``.

    ``input_mode``: 'float32' takes raw (B, H, W, 3) float32 images,
    quantized on the device; 'uint8' takes raw (B, H, W, 3) uint8 pixels,
    normalized with ``input_mean`` / ``input_std`` and quantized on the
    device with the host preprocessing's float32 op order (u8/255 →
    (v − mean)/std → floor(v/s_in + 0.5)); 'folded_float32' takes
    (B, (H+8)/4, (W+8)/4, 48) float32 images that the host folded with
    ``inference.fold.fold4_images``; 'folded_int8' takes the same layout as
    int8, which the host also quantized (``utils.preproc.quantize_int8``
    with the model's input scale).
    ``residual_dtype`` is the carrier between units: torch.int32, or
    torch.int16 (clamps sums above 2¹⁵−1).  ``requant_mode``: 'native'
    (the framework's 23-bit float32 requant) or 'reference' (the reference
    checkpoint's own 31-bit float64 one; any input mode, the int32 carrier
    only).  ``routing``: a table of ``inference.routing`` ('int8' /
    'int4w' per unit conv; native mode only), in place of the rule that
    packs every 4-bit unit conv.  With ``capture``, the engine returns the
    raw tensor at that node instead of the logits."""
    return ResnetEngine(fm, capture, residual_dtype, input_mode, input_mean,
                        input_std, engine_device(device), requant_mode,
                        routing)
