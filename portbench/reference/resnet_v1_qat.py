"""Plain quantization-aware training of a ResNet v1 with bottleneck units
(HAWQ-V3's QAT, Yao et al. 2021, with the network of ``resnet_v1.py``),
for the benchmark's comparison of the train step.

Each conv is quantized in training the way HAWQ-V3 trains before batch
norm is fixed ("unfolded"): the float kernel is quantized per output
channel on its own min/max range (8 bits, symmetric, straight-through
gradient), the input is the previous node's integers, the product is the
exact integer conv, and batch norm then runs on the rescaled output with
the batch's statistics (its running statistics updated with momentum
0.99).  An activation node tracks its range as an exponential moving
average (momentum 0.99; its first reading replaces the initial zeros),
takes its symmetric scale max(|min|, |max|) / (2^(b−1) − 1), and brings
the previous value to its integer grid by the dyadic requant of
``numerics`` (the value divided by the accumulator scale and rounded,
times the 23-bit dyadic multiplier, rounded, clipped), with
straight-through gradients; a residual node requantizes the two branches
on their own and adds them.  The global average pool sums the integers
and truncates their mean; the head quantizes its kernel per class and its
bias at 32 bits.  Loss: cross entropy; optimizer: SGD with momentum and
weight decay (PyTorch's form: the decay added to the gradient, then the
momentum trace).  Calibration runs the forward without gradients and
updates the ranges and the running statistics.

Tensors are NHWC; the float convolutions of the backward run in float32
with TF32 off unless ``tf32`` asks for it (the control).  Departures from
the published description: those of ``resnet_v1.py``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from portbench.reference.resnet_v1 import units

BN_EPS = 1e-5
MOMENTUM = 0.99
EPS = 1e-8


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim constant on ``like``'s device (a true division by it)."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def round_half_up(x):
    return torch.floor(x + 0.5)


def sym_scale(bits: int, lo, hi):
    n = 2 ** (bits - 1) - 1
    bound = torch.maximum(torch.abs(lo), torch.abs(hi))
    b = torch.clamp(bound, min=EPS)
    return b / _c(float(n), b)


def pow2(k: torch.Tensor) -> torch.Tensor:
    """Exact float32 2^k of int32 k, from the exponent bits."""
    return ((k + 127).clamp(1, 254) << 23).view(torch.float32)


def dyadic(ratio: torch.Tensor) -> torch.Tensor:
    mant, exp = torch.frexp(ratio.to(torch.float32))
    m = round_half_up(mant * (2.0 ** 23))
    return m * pow2(-(23 - exp).to(torch.int32))


class Quantize(torch.autograd.Function):
    """clip(round(x / scale)); gradient g / scale."""
    @staticmethod
    def forward(ctx, x, scale, lo, hi):
        ctx.save_for_backward(scale)
        return torch.clamp(round_half_up(x / scale), lo, hi)

    @staticmethod
    def backward(ctx, g):
        scale, = ctx.saved_tensors
        return g / scale, None, None, None


class Recover(torch.autograd.Function):
    """round(z / scale): the integers of a value; gradient g / scale."""
    @staticmethod
    def forward(ctx, z, scale):
        ctx.save_for_backward(scale)
        return round_half_up(z / scale)

    @staticmethod
    def backward(ctx, g):
        scale, = ctx.saved_tensors
        return g / scale, None


class Requant(torch.autograd.Function):
    """round(z_int · dyadic(acc / out)), clipped where bounds are given;
    gradient g · acc / out."""
    @staticmethod
    def forward(ctx, z_int, acc_scale, out_scale, lo, hi):
        ctx.save_for_backward(acc_scale, out_scale)
        out = round_half_up(z_int * dyadic(acc_scale / out_scale))
        return out if lo is None else torch.clamp(out, lo, hi)

    @staticmethod
    def backward(ctx, g):
        acc_scale, out_scale = ctx.saved_tensors
        return g * acc_scale / out_scale, None, None, None, None


class StraightRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_half_up(x)

    @staticmethod
    def backward(ctx, g):
        return g


class StraightFloorEps(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.trunc(x + 0.01)

    @staticmethod
    def backward(ctx, g):
        return g


class IntConv(torch.autograd.Function):
    """The exact integer conv of NHWC / HWIO float tensors rounded to their
    integers (float64 sums), + the rounded bias, as float32; its backward
    the float32 conv's gradients on the unrounded tensors."""
    @staticmethod
    def forward(ctx, x_int, w_int, bias, stride, pad, tf32):
        x8 = round_half_up(x_int).to(torch.float64)
        w8 = round_half_up(w_int).to(torch.float64)
        y = F.conv2d(x8.permute(0, 3, 1, 2), w8.permute(3, 2, 0, 1),
                     stride=stride, padding=pad)
        y = y.permute(0, 2, 3, 1) + round_half_up(bias).to(torch.float64)
        ctx.save_for_backward(x_int, w_int)
        ctx.geo = (stride, pad, tf32)
        return y.to(torch.float32).contiguous()

    @staticmethod
    def backward(ctx, g):
        x_int, w_int = ctx.saved_tensors
        stride, pad, tf32 = ctx.geo
        x = x_int.permute(0, 3, 1, 2)
        w = w_int.permute(3, 2, 0, 1)
        gd = g.permute(0, 3, 1, 2)
        old = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            dx = torch.nn.grad.conv2d_input(x.shape, w, gd, stride=stride,
                                            padding=pad)
            dw = torch.nn.grad.conv2d_weight(x, w.shape, gd, stride=stride,
                                             padding=pad)
        finally:
            torch.backends.cudnn.allow_tf32 = old
        return (dx.permute(0, 2, 3, 1), dw.permute(2, 3, 1, 0),
                g.sum(dim=(0, 1, 2)), None, None, None)


class IntMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_int, w_int, bias):
        y = (round_half_up(x_int).to(torch.float64)
             @ round_half_up(w_int).to(torch.float64))
        ctx.save_for_backward(x_int, w_int)
        return (y + round_half_up(bias).to(torch.float64)).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        x_int, w_int = ctx.saved_tensors
        return g @ w_int.t(), x_int.t() @ g, g.sum(dim=0)


def _quantize(x, scale, bits):
    n = 2 ** (bits - 1) - 1
    return Quantize.apply(x, scale, float(-n - 1), float(n))


def _requant_bounds(bits):
    n = 2 ** (bits - 1) - 1
    return float(-n - 1), float(n)


class Model:
    """The parameters (``params``: kernels, γ, β, the head's kernel and
    bias) and statistics (``stats``: BN running mean and variance, the
    activation ranges) of a QAT ResNet v1, keyed as the frozen model
    is, and its forward."""

    def __init__(self, config: Mapping, params: Dict[str, torch.Tensor],
                 stats: Dict[str, torch.Tensor], tf32: bool = False):
        self.config, self.params, self.stats = config, params, stats
        self.tf32 = tf32
        self.bits = {k: 16 if 'quant_act_int32' in k else config['act_bits']
                     for k in stats if k.endswith('.x_min')}

    # -- nodes --------------------------------------------------------------
    def _observe(self, key, x, update):
        if not update:
            return
        with torch.no_grad():
            cur_min, cur_max = torch.amin(x.detach()), torch.amax(x.detach())
            lo, hi = self.stats[key + '.x_min'], self.stats[key + '.x_max']
            uninit = lo == hi
            new_lo = lo * MOMENTUM + cur_min * (1 - MOMENTUM)
            new_hi = hi * MOMENTUM + cur_max * (1 - MOMENTUM)
            lo.copy_(torch.where(uninit, cur_min, new_lo))
            hi.copy_(torch.where(uninit, cur_max, new_hi))

    def _scale(self, key):
        return sym_scale(self.bits[key + '.x_min'], self.stats[key + '.x_min'],
                         self.stats[key + '.x_max'])

    def act(self, key, x, update, acc_scale=None):
        """A node: fake-quantize ``x`` (no ``acc_scale``) or requantize it
        from ``acc_scale`` → (value, scale)."""
        self._observe(key, x, update)
        scale = self._scale(key)
        bits = self.bits[key + '.x_min']
        if acc_scale is None:
            q = _quantize(x, scale, bits)
        else:
            q = Requant.apply(Recover.apply(x, acc_scale), acc_scale, scale,
                              *_requant_bounds(bits))
        return q * scale, scale

    def residual(self, key, h, identity, acc_scale, id_scale, update):
        x = h + identity
        self._observe(key, x, update)
        scale = self._scale(key)
        z_int = Recover.apply(x - identity, acc_scale)
        id_int = Recover.apply(identity, id_scale)
        q = (Requant.apply(z_int, acc_scale, scale, None, None)
             + Requant.apply(id_int, id_scale, scale, None, None))
        return q * scale, scale

    def convbn(self, key, x, pre_scale, stride, pad, update):
        """The unfolded conv and batch norm → (value, the scale of its
        integers before the norm's factor, times the factor)."""
        p, s = self.params, self.stats
        kernel = p[key + '.kernel']
        cout = kernel.shape[-1]
        flat = kernel.detach().reshape(-1, cout)
        conv_scale = sym_scale(8, torch.amin(flat, 0), torch.amax(flat, 0))
        w_int = _quantize(kernel, conv_scale, 8)
        out = IntConv.apply(x / pre_scale, w_int, torch.zeros_like(
            p[key + '.beta']), stride, pad, self.tf32) * conv_scale \
            * pre_scale
        mean = torch.mean(out, dim=(0, 1, 2))
        var = torch.var(out, dim=(0, 1, 2), unbiased=True)
        if update:
            with torch.no_grad():
                s[key + '.mean'].copy_(s[key + '.mean'] * MOMENTUM
                                       + mean * (1 - MOMENTUM))
                s[key + '.var'].copy_(s[key + '.var'] * MOMENTUM
                                      + var * (1 - MOMENTUM))
        factor = _bn_factor(p[key + '.gamma'], var)
        return factor * (out - mean) + p[key + '.beta'], conv_scale * factor

    # -- the network --------------------------------------------------------
    def __call__(self, images, update: bool):
        cfg = self.config
        x, a_scale = self.act('quant_input', images, update)
        k = cfg['init_kernel']
        x, w_scale = self.convbn('quant_init_convbn', x, a_scale, 2, k // 2,
                                 update)
        x = _maxpool(x)
        x, a_scale = self.act('quant_act_int32', x, update, a_scale * w_scale)
        x = F.relu(x)
        for p, _, _, _, stride, proj in units(cfg):
            x, a_scale = self._unit(p, x, a_scale, stride, proj, update)
        x, a_scale = _global_avg_pool(x, a_scale)
        x, a_scale = self.act('quant_act_output', x, update)
        return self._head(x, a_scale)

    def _unit(self, p, x, in_scale, stride, proj, update):
        xq, a_scale = self.act(f'{p}.quant_act', x, update, in_scale)
        if proj:
            identity, id_w = self.convbn(f'{p}.quant_identity_convbn', xq,
                                         a_scale, stride, 0, update)
            id_scale = a_scale * id_w
        else:
            identity, id_scale = x, in_scale
        h, w = self.convbn(f'{p}.quant_convbn1', xq, a_scale, stride, 0,
                           update)
        h, a_scale = self.act(f'{p}.quant_act1', F.relu(h), update,
                              a_scale * w)
        h, w = self.convbn(f'{p}.quant_convbn2', h, a_scale, 1, 1, update)
        h, a_scale = self.act(f'{p}.quant_act2', F.relu(h), update,
                              a_scale * w)
        h, w = self.convbn(f'{p}.quant_convbn3', h, a_scale, 1, 0, update)
        hq, out_scale = self.residual(f'{p}.quant_act_int32', h, identity,
                                      a_scale * w, id_scale, update)
        return F.relu(hq), out_scale

    def _head(self, x, pre_scale):
        kernel, bias = self.params['quant_output.kernel'], \
            self.params['quant_output.bias']
        k = kernel.detach()
        w_scale = sym_scale(8, torch.amin(k, 0), torch.amax(k, 0))
        w_int = _quantize(kernel, w_scale, 8)
        bias_scale = w_scale * pre_scale
        b_int = _quantize(bias, bias_scale, 32)
        return IntMatmul.apply(x / pre_scale, w_int, b_int) * bias_scale


def _bn_factor(gamma, var):
    """γ / √(var + ε), the root taken in float64 and rounded."""
    return gamma / torch.sqrt((var + BN_EPS).to(torch.float64)).to(var.dtype)


def _maxpool(x):
    y = F.max_pool2d(F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                           value=float('-inf')), 3, 2)
    return y.permute(0, 2, 3, 1)


def _global_avg_pool(x, scale):
    x_int = StraightRound.apply(x / scale)
    h, w = x.shape[1], x.shape[2]
    summed = F.avg_pool2d(x_int.permute(0, 3, 1, 2), (h, w), (1, 1),
                          divisor_override=1).permute(0, 2, 3, 1)
    pooled = summed / _c(float(h * w), summed)
    y = StraightFloorEps.apply(pooled) * scale
    return y.reshape(y.shape[0], -1), scale


def sgd_step(params: Dict[str, torch.Tensor], momentum: Dict, lr: float,
             mu: float, wd: float) -> None:
    """d = g + wd·p; the trace m = d at the first step, else mu·m + d;
    p −= lr·m."""
    with torch.no_grad():
        for k, p in params.items():
            d = p.grad + wd * p
            if k in momentum:
                momentum[k].mul_(mu).add_(d)
            else:
                momentum[k] = d.clone()
            p.add_(momentum[k], alpha=-lr)


def train(config: Mapping, params0: Mapping[str, torch.Tensor],
          stats0: Mapping[str, torch.Tensor], calibration, steps,
          lr: float, mu: float, wd: float, tf32: bool = False,
          step_updates=('params', 'stats')) -> Dict:
    """Calibrate on ``calibration`` (image batches, batch norm on the
    batch's statistics, as the steps run it), then train on ``steps``
    ((images, labels) batches) → {``losses``; ``logits1``, the first
    step's logits; ``grad``, its gradients as the optimizer holds them
    (its momentum trace less the decay); ``stats_cal``, ``stats1``,
    ``stats``: the statistics after the calibration, after the first step
    and after the last; ``params``, the parameters after the last}.
    ``step_updates`` leaves out the parameters' or the statistics' update
    of every step: the control's planted faults."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    stats = {k: v.detach().clone() for k, v in stats0.items()}
    model = Model(config, params, stats, tf32)
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return _train(model, params0, calibration, steps, lr, mu, wd,
                      step_updates)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def _clone(d):
    return {k: v.detach().clone() for k, v in d.items()}


def _train(model, params0, calibration, steps, lr, mu, wd, step_updates):
    params, stats = model.params, model.stats
    with torch.no_grad():
        for images in calibration:
            model(images, update=True)
    out = dict(losses=[], stats_cal=_clone(stats))
    trace = {}
    for images, labels in steps:
        for p in params.values():
            p.grad = None
        logits = model(images, update='stats' in step_updates)
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        if 'params' in step_updates:
            sgd_step(params, trace, lr, mu, wd)
        if 'grad' not in out:      # as the optimizer holds it
            out.update(grad={k: trace.get(k, torch.zeros_like(p))
                             - wd * params0[k] for k, p in params.items()},
                       logits1=logits.detach().clone(),
                       stats1=_clone(stats))
        out['losses'].append(float(loss.detach()))
    out.update(params=_clone(params), stats=stats)
    return out
