"""Quantized neural-net layers (port of hawq_tpu/nn/layers.py), threading
(int·scale, scale) pairs.

Every quantized layer consumes and produces a pair ``(value, scale)`` with
``value = integer_tensor * scale`` exactly; downstream layers divide by the
incoming scale to recover exact integers, which is what makes the QAT graph
match the frozen integer engine bit for bit.

How the port differs from the flax modules it mirrors:

  * layers are ``torch.nn.Module``s; the running statistics (activation
    ranges ``x_min`` / ``x_max``, BN ``mean`` / ``var``) are buffers, updated
    **in place**, detached, when ``update_stats`` is set.  The "uninitialized"
    test ``x_min == x_max`` is a ``torch.where`` on device values, so no
    statistic ever synchronizes with the host;
  * parameters keep the flax names and layouts (``kernel`` HWIO, ``gamma``,
    ``beta``, ``bias``; activations NHWC), so carrying weights across is a
    rename, not a transpose;
  * the convolution/matmul forward runs *true integer* int8×int8→int32
    through the port's accumulator kernels (``int8_conv_acc``,
    ``int8_matmul_acc``; CUDA PyTorch has no integer convolution), with a
    float straight-through backward (cuDNN / cuBLAS, as the reference leaves
    these to XLA);
  * ``QuantAct`` keeps its integer tensor only on request
    (:func:`capture_q_int`), where the flax module sows it always;
  * of the grouped convolutions (``groups > 1``) the depthwise 3×3 (one
    channel a group, pad 1, stride 1 or 2: MobileNetV2's) runs through
    ``int8_dwconv_acc``; any other grouping raises ``NotImplementedError``;
  * the statistics sites (``QuantAct`` and ``QuantBnAct`` ranges, the BN
    batch moments of ``QuantConvBn`` and ``QuantBnAct``) take an optional
    ``data_group``: with one, a statistic is taken over the rows of every
    rank of the group, as ``hawq_tpu``'s jitted step takes it over the
    global batch; ``QuantLinear`` can split its output classes over a
    ``model_group`` (:meth:`QuantLinear.shard_classes`).  Without a group
    (the default) the code path is the single-process one.

The forward is written for eager execution (see quant/ops.py on
``exact()``); keep it out of ``torch.compile``.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from hawq_tpu_torch.kernels import conv as kc
from hawq_tpu_torch.kernels import depthwise as kd
from hawq_tpu_torch.kernels import matmul as km
from hawq_tpu_torch.parallel import collectives as coll
from hawq_tpu_torch.quant import ops as qops


# ---------------------------------------------------------------------------
# Exact integer conv / matmul with STE backward
# ---------------------------------------------------------------------------

# Thread-local settings of the conv backward, read when the forward runs:
# ``store`` is the dtype the residuals (x_int, w_int) are saved in, ``grad``
# the dtype the gradient convolutions compute in.  Both integer tensors are
# bounded by the 8-bit ranges, which bfloat16 represents exactly, so a
# bfloat16 store halves what the forward keeps for the backward with
# value-exact residuals (the one non-integer case, the image input of the
# init conv, is perturbed by ≤2⁻⁸ relative on that conv's dw only).
_BACKWARD = threading.local()
_NARROW = (torch.bfloat16, torch.float16)


@contextlib.contextmanager
def residual_store_dtype(dt: Optional[torch.dtype]):
    """Store the conv backward residuals in ``dt`` (None: as given, float32)
    for forwards run inside the context.  Narrow residuals also run the
    gradient convolutions in that dtype (upcasting them again would undo the
    saving); the cotangent's truncation is the one numerics deviation, about
    2⁻⁸ relative on conv gradients."""
    old = getattr(_BACKWARD, 'store', None)
    _BACKWARD.store = dt
    try:
        yield
    finally:
        _BACKWARD.store = old


@contextlib.contextmanager
def gradient_conv_dtype(dt: Optional[torch.dtype]):
    """Compute the gradient convolutions of forwards run inside the context
    in ``dt`` (None: float32) whatever the residuals are stored in."""
    old = getattr(_BACKWARD, 'grad', None)
    _BACKWARD.grad = dt
    try:
        yield
    finally:
        _BACKWARD.grad = old


@contextlib.contextmanager
def faithful_float_math():
    """TF32 off for cuDNN convolutions and cuBLAS products inside the
    context (restored after): the float32 gradient convolutions then carry
    float32 precision, as on the CPU."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def _store(t: torch.Tensor) -> torch.Tensor:
    dt = getattr(_BACKWARD, 'store', None)
    return t if dt is None else t.to(dt)


def resolve_padding(padding: Any, in_hw: Tuple[int, int],
                    kernel: Tuple[int, int], strides: Tuple[int, int]
                    ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((top, bottom), (left, right)) of 'VALID', 'SAME' (XLA's rule: the
    extra pixel goes to the end) or explicit pairs."""
    if isinstance(padding, str):
        if padding.upper() == 'VALID':
            return (0, 0), (0, 0)
        if padding.upper() != 'SAME':
            raise ValueError(f'unknown padding {padding!r}')
        pads = []
        for n, k, s in zip(in_hw, kernel, strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads[0], pads[1]
    (t, b), (l, r) = padding
    return (int(t), int(b)), (int(l), int(r))


def _int_conv_acc(x8: torch.Tensor, w8: torch.Tensor, b32: torch.Tensor,
                  strides: Tuple[int, int], pad) -> torch.Tensor:
    """int8 NHWC × int8 HWIO + int32 bias → int32 NHWC through the
    accumulator kernels (their plain versions on the CPU): a 1×1 conv is a
    strided slice and ``int8_matmul_acc``; a k×k conv ``int8_conv_acc`` by
    the geometry of ``kernels.conv.conv_call`` (stride 1 with a symmetric
    border on the unpadded activations, the Hopper core's TMA supplying the
    border; stride 2 through the space-to-depth rewrite)."""
    kh, kw, cin, cout = w8.shape
    b = x8.shape[0]
    if (kh, kw) == (1, 1):
        x8 = kc.pad_nhwc(x8, pad)
        if tuple(strides) != (1, 1):
            x8 = x8[:, ::strides[0], ::strides[1], :]
        x8 = x8.contiguous()
        oh, ow = x8.shape[1:3]
        acc = km.int8_matmul_acc(x8.reshape(b * oh * ow, cin),
                                 w8.reshape(cin, cout).contiguous(), b32)
        return acc.reshape(b, oh, ow, cout)
    xp, geo = kc.conv_call(x8, (kh, kw), strides, pad)
    w8 = kc.conv_call_kernel(w8, strides)
    acc = kc.int8_conv_acc(xp, kc.flatten_conv_kernel_torch(w8), b32, **geo)
    return acc.reshape(b, *geo['out_hw'], cout)


def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` with its gradient: a maximum and then a
    minimum, which split the gradient evenly where ``x`` meets a bound
    (``torch.clamp`` passes all of it).  Integer-valued tensors meet their
    bounds often, so the QAT graph's clamps of them take this form."""
    if lo is not None:
        if not isinstance(lo, torch.Tensor):
            lo = qops._constant(float(lo), x.dtype, x.device)
        x = torch.maximum(x, lo)
    if hi is not None:
        if not isinstance(hi, torch.Tensor):
            hi = qops._constant(float(hi), x.dtype, x.device)
        x = torch.minimum(x, hi)
    return x


def _round_to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return qops.round_half_up(t).to(dtype)


def _check_groups(x_shape, w_shape, strides, pad, groups: int) -> None:
    """Raise unless ``groups`` is 1 or the depthwise 3×3 that
    ``int8_dwconv_acc`` runs: one input and one output channel a group, pad
    1 on every side, equal strides of 1 or 2."""
    if groups == 1:
        return
    kh, kw, cin_g, cout = w_shape
    if not (cin_g == 1 and groups == x_shape[3] == cout and (kh, kw) == (3, 3)
            and pad == ((1, 1), (1, 1)) and strides in ((1, 1), (2, 2))):
        raise NotImplementedError(
            f'int_conv2d: {groups} groups with a {tuple(w_shape)} kernel, '
            f'strides {strides}, padding {pad}: of the grouped convolutions '
            f'only the depthwise 3×3, pad 1, stride 1 or 2 has an integer '
            f'kernel')


class _IntConv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_int, w_int, bias_int, strides, pad, groups):
        x8 = _round_to(x_int, torch.int8)
        w8 = _round_to(w_int, torch.int8)
        b32 = _round_to(bias_int, torch.int32)
        if groups == 1:
            acc = _int_conv_acc(x8, w8, b32, strides, pad)
        else:
            acc = kd.int8_dwconv_acc(x8.contiguous(), w8.contiguous(), b32,
                                     stride=strides[0])
        ctx.save_for_backward(_store(x_int), _store(w_int))
        ctx.geometry = (strides, pad, groups)
        ctx.grad_dtype = getattr(_BACKWARD, 'grad', None)
        return acc.to(torch.float32)        # one rounding, after acc + bias

    @staticmethod
    def backward(ctx, g):
        x_int, w_int = ctx.saved_tensors
        strides, pad, groups = ctx.geometry
        # narrow residuals, or an explicit gradient dtype, run the gradient
        # convolutions narrow; float32 (float64) residuals stay faithful
        dt = x_int.dtype if x_int.dtype in _NARROW else ctx.grad_dtype
        if dt is None:
            dt = g.dtype
        (t, b), (l, r) = pad
        symmetric = t == b and l == r
        # NHWC storage seen as NCHW channels_last: no layout copy
        x = (x_int if symmetric else kc.pad_nhwc(x_int, pad)).to(dt).permute(
            0, 3, 1, 2)
        w = w_int.to(dt).permute(3, 2, 0, 1)
        gd = g.to(dt).permute(0, 3, 1, 2)
        padding = (t, l) if symmetric else (0, 0)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(x.shape, w, gd, stride=strides,
                                            padding=padding, groups=groups)
            if not symmetric:
                dx = dx[:, :, t:dx.shape[2] - b, l:dx.shape[3] - r]
            dx = dx.permute(0, 2, 3, 1).to(g.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x, w.shape, gd, stride=strides,
                                             padding=padding, groups=groups)
            dw = dw.permute(2, 3, 1, 0).to(g.dtype)
        db = g.sum(dim=(0, 1, 2)) if ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None, None


def int_conv2d(x_int: torch.Tensor, w_int: torch.Tensor,
               bias_int: torch.Tensor, strides: Tuple[int, int], padding: Any,
               feature_group_count: int = 1) -> torch.Tensor:
    """Exact int8×int8→int32 convolution + int32 bias add, returned as
    float32.

    x_int, w_int, bias_int are integer-valued float tensors (NHWC / HWIO /
    (Cout,)) whose values fit int8 / int32.  The forward rounds and casts
    them, accumulates in int32 in the port's kernels and adds the bias **in
    int32 before the float32 cast**, so the result is exactly f32(acc + b),
    the same single rounding the frozen engine performs, even for
    accumulators beyond 2**24.  The backward treats the op as the ordinary
    float convolution (straight-through) on the saved x_int, w_int, with
    ``feature_group_count`` groups.  Of the grouped convolutions only the
    depthwise 3×3 (pad 1, stride 1 or 2) has an integer kernel
    (``int8_dwconv_acc``); any other grouping raises."""
    strides = (int(strides[0]), int(strides[1]))
    pad = resolve_padding(padding, x_int.shape[1:3], w_int.shape[:2], strides)
    _check_groups(x_int.shape, w_int.shape, strides, pad, feature_group_count)
    return _IntConv2d.apply(x_int, w_int, bias_int, strides, pad,
                            feature_group_count)


class _IntMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_int, w_int, bias_int):
        acc = km.int8_matmul_acc(
            _round_to(x_int, torch.int8).contiguous(),
            _round_to(w_int, torch.int8).contiguous(),
            _round_to(bias_int, torch.int32))
        ctx.save_for_backward(x_int, w_int)
        return acc.to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        x_int, w_int = ctx.saved_tensors
        return g @ w_int.t(), x_int.t() @ g, g.sum(dim=0)


def int_matmul(x_int: torch.Tensor, w_int: torch.Tensor,
               bias_int: torch.Tensor) -> torch.Tensor:
    """Exact int8×int8→int32 matmul + int32 bias (x: [B, F], w: [F, O]),
    returned as float32; float straight-through backward."""
    return _IntMatmul.apply(x_int, w_int, bias_int)


# ---------------------------------------------------------------------------
# shared pieces of the modules
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def capture_q_int(model: nn.Module):
    """Collect the integer tensor of every activation quantizer of ``model``
    during the forwards run inside the context: yields a dict that fills
    with module name → detached ``q_int`` (the golden-featuremap hook).
    Outside it the quantizers keep nothing."""
    captured: Dict[str, torch.Tensor] = {}
    nodes = [(name, m) for name, m in model.named_modules()
             if isinstance(m, (QuantAct, QuantBnAct))]
    for name, m in nodes:
        m._capture = (captured, name)
    try:
        yield captured
    finally:
        for _, m in nodes:
            m._capture = None


def _sow(module: nn.Module, q: torch.Tensor) -> None:
    if module._capture is not None:
        captured, name = module._capture
        captured[name] = q.detach()


def _update_range(x_min: torch.Tensor, x_max: torch.Tensor,
                  cur_min: torch.Tensor, cur_max: torch.Tensor,
                  momentum: float, running: bool = False) -> None:
    """In-place EMA (or, with ``running``, running min/max) of a range; the
    first observation (x_min == x_max) replaces the initial zeros."""
    uninit = x_min == x_max
    if running:
        new_min = torch.minimum(x_min, cur_min)
        new_max = torch.maximum(x_max, cur_max)
    else:
        new_min = x_min * momentum + cur_min * (1 - momentum)
        new_max = x_max * momentum + cur_max * (1 - momentum)
    x_min.copy_(torch.where(uninit, cur_min, new_min))
    x_max.copy_(torch.where(uninit, cur_max, new_max))


def _weight_range(w_flat: torch.Tensor, per_channel: bool):
    if per_channel:
        return torch.amin(w_flat, dim=0), torch.amax(w_flat, dim=0)
    return torch.amin(w_flat), torch.amax(w_flat)


def _observed_minmax(x: torch.Tensor, group) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """(min, max) of an activation tensor, over every rank of ``group``
    where one is given: exactly the min and max of the global batch."""
    cur_min, cur_max = qops.fused_minmax(x)
    if group is None:
        return cur_min, cur_max
    return coll.min_max(cur_min, cur_max, group)


def _batch_moments(x: torch.Tensor, group) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """BN batch statistics of an NHWC tensor over (N, H, W): the mean and
    the unbiased variance.  Without a group ``torch.mean`` / ``torch.var``;
    over a data group in two passes, each summed over the ranks (with its
    gradient): Σx → mean, then Σ(x − mean)² → variance, over the global
    count of rows × pixels."""
    if group is None:
        return (torch.mean(x, dim=(0, 1, 2)),
                torch.var(x, dim=(0, 1, 2), unbiased=True))
    n = x.shape[0] * x.shape[1] * x.shape[2] * dist.get_world_size(group)
    mean = coll.sum_over(x.sum(dim=(0, 1, 2)), group) / n
    d = x - mean
    var = coll.sum_over((d * d).sum(dim=(0, 1, 2)), group) / (n - 1)
    return mean, var


def _he_normal_(t: torch.Tensor, fan_in: int, gain: float,
                generator: Optional[torch.Generator]) -> None:
    """Truncated normal (±2σ) of variance gain / fan_in, flax's
    ``variance_scaling(..., 'truncated_normal')``."""
    std = math.sqrt(gain / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


# ---------------------------------------------------------------------------
# QuantAct — activation quantizer + requantization node
# ---------------------------------------------------------------------------

class QuantAct(nn.Module):
    """Activation range tracker + quantizer + dyadic requant node.

    Four forward cases:
      (a) no incoming scale (input quantization) or ``fixed_point`` mode:
          direct fake-quant with this node's scale;
      (b) ``branch_scales`` given (multi-branch concat): per-channel-slice
          dyadic requant of each branch to one scale;
      (c) normal: dyadic requant of the int32 accumulator;
      (d) residual: the same with an identity branch carrying its own
          (act, weight) scales.

    Returns ``(int_value * scale, scale)``."""

    def __init__(self, bits: int = 8, momentum: float = 0.99,
                 quant_mode: str = 'symmetric', percentile: float = 0.0,
                 fixed_point: bool = False):
        super().__init__()
        self.bits = bits
        self.momentum = momentum
        self.quant_mode = quant_mode
        self.percentile = percentile
        self.fixed_point = fixed_point
        self.register_buffer('x_min', torch.zeros((), dtype=torch.float32))
        self.register_buffer('x_max', torch.zeros((), dtype=torch.float32))
        self._capture = None
        self.data_group = None        # ranges over the group's ranks

    def _observe(self, x: torch.Tensor) -> None:
        # the ranges are buffers: no gradient may flow from the scales back
        # into the reductions
        with torch.no_grad():
            xd = x.detach()
            if self.percentile == 0:
                cur_min, cur_max = _observed_minmax(xd, self.data_group)
            else:
                xd = xd.reshape(-1)
                if self.data_group is not None:
                    # an order statistic needs every row: the ranks'
                    # tensors gathered (the sort makes their order moot)
                    xd = coll.cat_over(xd, self.data_group)
                # asymmetric is always post-ReLU with zero point 0: lower
                # bound pinned to 0
                lower = (100.0 - self.percentile
                         if self.quant_mode == 'symmetric' else 0.0)
                cur_min, cur_max = qops.percentile_bounds(xd, lower,
                                                          self.percentile)
            _update_range(self.x_min, self.x_max, cur_min, cur_max,
                          self.momentum, running=self.momentum < 0)

    def forward(self, x, pre_act_scale=None, pre_weight_scale=None,
                identity=None, identity_scale=None,
                identity_weight_scale=None,
                branch_scales: Optional[Sequence] = None,
                branch_channels: Optional[Sequence[int]] = None,
                *, x_int=None, identity_int=None, update_stats: bool = False):
        if update_stats:
            self._observe(x)
        signed = self.quant_mode == 'symmetric'
        if signed:
            scale = qops.symmetric_quant_scale(self.bits, self.x_min,
                                               self.x_max)
        else:
            scale = qops.asymmetric_quant_scale(self.bits, self.x_min,
                                                self.x_max)

        if pre_act_scale is None or self.fixed_point:
            if signed:
                q = qops.quantize_symmetric(x, scale, self.bits)
            else:
                q = qops.quantize_asymmetric(x, scale, self.bits)
        elif branch_scales is not None:
            pieces, start = [], 0
            for b_scale, c in zip(branch_scales, branch_channels):
                pieces.append(qops.dyadic_requant(
                    x[..., start:start + c], b_scale, scale, self.bits,
                    signed))
                start += c
            q = torch.cat(pieces, dim=-1)
        else:
            acc_scale = (pre_act_scale if pre_weight_scale is None
                         else pre_act_scale * pre_weight_scale)
            if identity is None:
                q = qops.dyadic_requant(x, acc_scale, scale, self.bits,
                                        signed, z_int=x_int)
            else:
                id_scale = (identity_scale if identity_weight_scale is None
                            else identity_scale * identity_weight_scale)
                q = qops.dyadic_requant_residual(
                    x, acc_scale, identity, id_scale, scale, z_int=x_int,
                    identity_int=identity_int)
        _sow(self, q)
        return q * scale, scale


# ---------------------------------------------------------------------------
# QuantConvBn — conv + folded/unfolded BN
# ---------------------------------------------------------------------------

class QuantConvBn(nn.Module):
    """Quantized conv2d with batch norm, foldable.

    Two modes, selected by the ``folded`` call argument (the trainer owns the
    fix-BN schedule):

      * unfolded (early QAT): integer conv with weight-only quantization,
        then batch-statistics BN in float; the returned weight scale is
        conv_scale · γ/√(var + ε) per channel;
      * folded (late QAT / frozen): BN folded into weight and bias, folded
        weight quantized per channel, bias at 32 bits, integer conv.

    Returns ``(value, weight_scale, acc)`` where ``acc`` is the exact
    integer accumulator (f32(int32 conv + bias), folded mode) or None
    (unfolded).  Models thread ``acc`` into the following QuantAct so the
    requant runs on exact integers.  Weight layout HWIO; per-channel ranges
    over the output-channel axis."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), padding: Any = 'SAME',
                 groups: int = 1, weight_bit: int = 8, bias_bit: int = 32,
                 per_channel: bool = True, weight_percentile: float = 0.0,
                 bn_eps: float = 1e-5, bn_momentum: float = 0.99,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        self.strides = tuple(strides)
        self.padding = padding
        self.groups = groups
        self.weight_bit = weight_bit
        self.bias_bit = bias_bit
        self.per_channel = per_channel
        self.weight_percentile = weight_percentile
        self.bn_eps = bn_eps
        self.bn_momentum = bn_momentum
        kh, kw = kernel_size
        in_ch = in_features // groups
        self.kernel = nn.Parameter(torch.empty(kh, kw, in_ch, features))
        _he_normal_(self.kernel, kh * kw * in_ch, 2.0, generator)
        self.gamma = nn.Parameter(torch.ones(features))
        self.beta = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))
        self.data_group = None        # batch moments over the group's ranks

    def forward(self, x, pre_act_scale, *, folded: bool = True,
                update_stats: bool = False):
        kernel = self.kernel
        if not folded:
            # weight ranges from the detached kernel: the gradient reaches
            # the kernel only through the STE quantizer, never the scale
            w_min, w_max = _weight_range(
                kernel.detach().reshape(-1, self.features), self.per_channel)
            conv_scale = qops.symmetric_quant_scale(self.weight_bit, w_min,
                                                    w_max)
            w_int = qops.quantize_symmetric(kernel, conv_scale,
                                            self.weight_bit)
            x_int = x / pre_act_scale
            conv_out = int_conv2d(
                x_int, w_int, torch.zeros_like(self.beta), self.strides,
                self.padding, self.groups) * conv_scale * pre_act_scale

            batch_mean, batch_var = _batch_moments(conv_out, self.data_group)
            if update_stats:
                with torch.no_grad():
                    self.mean.copy_(self.mean * self.bn_momentum
                                    + batch_mean * (1 - self.bn_momentum))
                    self.var.copy_(self.var * self.bn_momentum
                                   + batch_var * (1 - self.bn_momentum))
            output_factor = qops.bn_inv_factor(self.gamma, batch_var,
                                               self.bn_eps)
            out = output_factor * (conv_out - batch_mean) + self.beta
            return out, conv_scale * output_factor, None

        bn_factor = qops.bn_inv_factor(self.gamma, self.var, self.bn_eps)
        scaled_weight = kernel * bn_factor          # broadcast over Cout
        scaled_bias = (torch.zeros_like(self.mean) - self.mean) * bn_factor \
            + self.beta

        # ranges from the detached folded weight: the scale carries no
        # gradient
        w_flat = scaled_weight.detach().reshape(-1, self.features)
        if self.weight_percentile == 0:
            w_min, w_max = _weight_range(w_flat, self.per_channel)
        elif self.per_channel:
            w_min, w_max = qops.weight_percentile_bounds_per_channel(
                w_flat, self.weight_percentile)
        else:
            w_min, w_max = qops.percentile_bounds(
                w_flat.reshape(-1), 100 - self.weight_percentile,
                self.weight_percentile)

        weight_scale = qops.symmetric_quant_scale(self.weight_bit, w_min,
                                                  w_max)
        w_int = qops.quantize_symmetric(scaled_weight, weight_scale,
                                        self.weight_bit)
        bias_scale = weight_scale * pre_act_scale
        b_int = qops.quantize_symmetric(scaled_bias, bias_scale,
                                        self.bias_bit)
        x_int = x / pre_act_scale
        # acc = f32(int32 conv + int32 bias): bit-identical to the engine's
        # accumulator at any magnitude
        acc = int_conv2d(x_int, w_int, b_int, self.strides, self.padding,
                         self.groups)
        return acc * bias_scale, weight_scale, acc


class QuantConv2d(nn.Module):
    """Bare quantized conv (no BN): the MobileNetV2 1×1 output head."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), padding: Any = 'SAME',
                 groups: int = 1, weight_bit: int = 8, bias_bit: int = 32,
                 per_channel: bool = True, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        self.strides = tuple(strides)
        self.padding = padding
        self.groups = groups
        self.weight_bit = weight_bit
        self.bias_bit = bias_bit
        self.per_channel = per_channel
        kh, kw = kernel_size
        in_ch = in_features // groups
        self.kernel = nn.Parameter(torch.empty(kh, kw, in_ch, features))
        _he_normal_(self.kernel, kh * kw * in_ch, 2.0, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x, pre_act_scale):
        w_min, w_max = _weight_range(
            self.kernel.detach().reshape(-1, self.features), self.per_channel)
        weight_scale = qops.symmetric_quant_scale(self.weight_bit, w_min,
                                                  w_max)
        w_int = qops.quantize_symmetric(self.kernel, weight_scale,
                                        self.weight_bit)
        bias_scale = weight_scale * pre_act_scale
        x_int = x / pre_act_scale
        if self.bias is not None:
            b_int = qops.quantize_symmetric(self.bias, bias_scale,
                                            self.bias_bit)
        else:
            b_int = torch.zeros(self.features, dtype=x.dtype, device=x.device)
        acc = int_conv2d(x_int, w_int, b_int, self.strides, self.padding,
                         self.groups)
        return acc * bias_scale, weight_scale, acc


class QuantLinear(nn.Module):
    """Quantized dense head.

    :meth:`shard_classes` splits its output classes over a model group
    (``hawq_tpu``'s ``P(None, 'model')`` kernel, ``P('model')`` bias): each
    rank keeps ``kernel[:, classes]`` and ``bias[classes]``, its input passes
    through :func:`collectives.copy_to` and its logits through
    :func:`collectives.gather_from`, so every rank of the group returns the
    full logits, bit-equal to the unsplit layer's, and computes the same
    loss.  A per-channel weight scale is per class and stays local; a
    per-tensor one takes its range over the whole kernel (``MAX`` over the
    group)."""

    def __init__(self, in_features: int, features: int, weight_bit: int = 8,
                 bias_bit: int = 32, per_channel: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight_bit = weight_bit
        self.bias_bit = bias_bit
        self.per_channel = per_channel
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        _he_normal_(self.kernel, in_features, 1.0, generator)
        self.bias = nn.Parameter(torch.zeros(features))
        self.model_group = None
        self.classes = slice(0, features)

    def shard_classes(self, group, classes: slice) -> None:
        """Keep the output ``classes`` (this rank's equal share, in the rank
        order of ``group``) as new parameters; make the optimizer after
        this."""
        count, index = dist.get_world_size(group), dist.get_rank(group)
        n = self.kernel.shape[1]
        width = n // count
        if (self.model_group is not None or n % count
                or (classes.start, classes.stop) != (width * index,
                                                     width * (index + 1))):
            raise ValueError(f'QuantLinear.shard_classes: classes {classes} '
                             f'of {n} at rank {index} of {count} (already '
                             f'split: {self.model_group is not None})')
        self.classes = classes
        self.kernel = nn.Parameter(self.kernel.detach()[:, classes].clone())
        self.bias = nn.Parameter(self.bias.detach()[classes].clone())
        self.model_group = group

    def shards(self):
        """(parameter, axis of the classes) of a split layer, else ()."""
        if self.model_group is None:
            return ()
        return ((self.kernel, 1), (self.bias, 0))

    def forward(self, x, pre_act_scale):
        group = self.model_group
        if group is not None:
            x = coll.copy_to(x, group)
        w_min, w_max = _weight_range(self.kernel.detach(), self.per_channel)
        if group is not None and not self.per_channel:
            w_min, w_max = coll.min_max(w_min, w_max, group)
        weight_scale = qops.symmetric_quant_scale(self.weight_bit, w_min,
                                                  w_max)
        w_int = qops.quantize_symmetric(self.kernel, weight_scale,
                                        self.weight_bit)
        bias_scale = weight_scale * pre_act_scale
        b_int = qops.quantize_symmetric(self.bias, bias_scale, self.bias_bit)
        x_int = x / pre_act_scale
        logits = int_matmul(x_int, w_int, b_int) * bias_scale
        if group is not None:
            logits = coll.gather_from(logits, group)
        return logits


class QuantBnAct(nn.Module):
    """Standalone integer batch-norm + requantization (pre-activation nets).

    Pre-activation units apply BN to the residual *stream*, which feeds both
    the shortcut and the convs, so it cannot fold into any conv.  Canonical
    integer semantics (shared verbatim by the engine):

        A  = in_scale · γ/√(σ²+ε)          (per channel, f32)
        b1 = round_half_up((β − μ·γ/√(σ²+ε)) / s_out)
        y  = clip(round_half_up(x_int · dyadic(A / s_out)) + b1)

    ``relu`` clamps the low end at 0 (after the BN affine, before the clip).
    Unfolded mode (early QAT) runs float batch-stats BN on the value tensor
    instead."""

    def __init__(self, features: int, bits: int = 8, momentum: float = 0.99,
                 quant_mode: str = 'symmetric', relu: bool = True,
                 bn_eps: float = 1e-5, bn_momentum: float = 0.99):
        super().__init__()
        self.bits = bits
        self.momentum = momentum
        self.quant_mode = quant_mode
        self.relu = relu
        self.bn_eps = bn_eps
        self.bn_momentum = bn_momentum
        self.gamma = nn.Parameter(torch.ones(features))
        self.beta = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))
        self.register_buffer('x_min', torch.zeros((), dtype=torch.float32))
        self.register_buffer('x_max', torch.zeros((), dtype=torch.float32))
        self._capture = None
        self.data_group = None        # ranges and moments over its ranks

    def forward(self, x, in_scale, *, x_int=None, folded: bool = True,
                update_stats: bool = False):
        if not folded:
            batch_mean, batch_var = _batch_moments(x, self.data_group)
            if update_stats:
                with torch.no_grad():
                    self.mean.copy_(self.mean * self.bn_momentum
                                    + batch_mean * (1 - self.bn_momentum))
                    self.var.copy_(self.var * self.bn_momentum
                                   + batch_var * (1 - self.bn_momentum))
            bn_factor = qops.bn_inv_factor(self.gamma, batch_var, self.bn_eps)
            y = (x - batch_mean) * bn_factor + self.beta
        else:
            bn_factor = qops.bn_inv_factor(self.gamma, self.var, self.bn_eps)
            if x_int is None:
                x_int = qops.ste_recover_int(x, in_scale)
            y = x_int * (in_scale * bn_factor) \
                + (self.beta - self.mean * bn_factor)
        if self.relu:
            y = F.relu(y)

        if update_stats:
            with torch.no_grad():
                cur_min, cur_max = _observed_minmax(y.detach(),
                                                    self.data_group)
                _update_range(self.x_min, self.x_max, cur_min, cur_max,
                              self.momentum)

        signed = self.quant_mode == 'symmetric'
        if signed:
            scale = qops.symmetric_quant_scale(self.bits, self.x_min,
                                               self.x_max)
        else:
            scale = qops.asymmetric_quant_scale(self.bits, self.x_min,
                                                self.x_max)

        if not folded:
            q = (qops.quantize_symmetric(y, scale, self.bits) if signed
                 else qops.quantize_asymmetric(y, scale, self.bits))
            _sow(self, q)
            return q * scale, scale

        # folded: pure-integer BN affine + requant, engine-identical
        a_scale = in_scale * bn_factor
        b1 = qops.ste_round((self.beta - self.mean * bn_factor) / scale)
        q = qops.requant_core_ste(x_int, a_scale, scale, None, signed) + b1
        if self.relu:
            q = clip(q, 0.0)
        q = clip(q, *qops.requant_clip_bounds(self.bits, signed))
        _sow(self, q)
        return q * scale, scale


# ---------------------------------------------------------------------------
# Dropout and pooling
# ---------------------------------------------------------------------------

class QuantDropout(nn.Module):
    """Scale-passthrough dropout.

    Dropout rescales surviving activations by 1/(1-p), which breaks the
    int·scale invariant during training; it is applied on the value tensor
    (fake-quant semantics recover at the next QuantAct) and is the identity
    at inference."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, scale, *, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None):
        """``deterministic=None`` keys off the generator: the layer drops
        only when the caller passes one (the train step does, seeded from
        the step counter; eval and calibration do not)."""
        if deterministic is None:
            deterministic = generator is None
        if self.rate > 0.0 and not deterministic:
            keep = torch.rand(x.shape, generator=generator,
                              device=x.device) >= self.rate
            x = x * keep / (1.0 - self.rate)
        return x, scale


def _pool_nhwc(fn, x, window, strides, padding, pad_value):
    pad = resolve_padding(padding, x.shape[1:3], window, strides)
    y = fn(kc.pad_nhwc(x, pad, pad_value).permute(0, 3, 1, 2), tuple(window),
           tuple(strides))
    return y.permute(0, 2, 3, 1)


def quant_max_pool(x, scale, window=(3, 3), strides=(2, 2), padding='SAME'):
    """Max pool is scale-invariant: the scale passes through."""
    y = _pool_nhwc(F.max_pool2d, x, window, strides, padding, float('-inf'))
    return y, scale


def quant_avg_pool(x, scale, window, strides=(1, 1), padding='VALID'):
    """Integer average pooling: divide out the scale, round to exact ints,
    sum each window, divide (a true division), truncate the float average
    to the integer division a hardware pool performs, rescale."""
    x_int = qops.ste_round(x / scale)
    summed = _pool_nhwc(
        lambda t, k, s: F.avg_pool2d(t, k, s, divisor_override=1), x_int,
        window, strides, padding, 0.0)
    pooled = qops.exact_div(summed, float(window[0] * window[1]))
    return qops.ste_floor_eps(pooled) * scale, scale


def quant_global_avg_pool(x, scale):
    """Global spatial integer average pool → (B, C)."""
    h, w = x.shape[1], x.shape[2]
    y, s = quant_avg_pool(x, scale, (h, w))
    return y.reshape(y.shape[0], -1), s
