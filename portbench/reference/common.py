"""Plain PyTorch layers of the reference models.

NHWC tensors, float32 throughout, no kernel and no module of the program
under test. Module and parameter names follow the published models' (the
flax names the port also uses), so one state dict made by the benchmark
loads into the program and into the reference alike.

Every layer rounds where the program holds a tensor in its compute dtype
(bfloat16): each weight as a product reads it, and each activation it
returns. A model's ``Precision`` says how: the reference proper rounds
nowhere (``F32``); the control (``FP8``) computes one precision step
below the program, in float8.
"""

from __future__ import annotations

import dataclasses
import math
import typing as t

import torch
import torch.nn.functional as F
from torch import nn

#: float8 e4m3's and e5m2's largest finite values
E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` at a per-tensor scale that maps its
    largest magnitude to ``top``."""
    scale = top / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Float8Weight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        return _round(w, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Float8Activation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


@dataclasses.dataclass(frozen=True)
class Precision:
    """Where a model rounds: ``weight`` on each weight as a product reads
    it, ``act`` on each activation the program holds in its compute dtype
    (the input, and every conv, BatchNorm, gate, resize and activation
    output), forward and, on its gradient, backward."""

    name: str
    weight: t.Callable[[torch.Tensor], torch.Tensor]
    act: t.Callable[[torch.Tensor], torch.Tensor]


#: the reference proper: float32 everywhere
F32 = Precision("float32", identity, identity)
#: the control: the configurations' bfloat16 one step lower, float8 by
#: the usual training recipe, each at a per-tensor scale: weights and
#: activations e4m3, the activations' gradients e5m2; sums, BatchNorm
#: statistics, the gate's products and the losses stay float32, as the
#: program keeps them
FP8 = Precision("float8", _Float8Weight.apply, _Float8Activation.apply)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """Conv2d on NHWC, weight OIHW, padding ``(k - 1) // 2`` on each side."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 3, bias: bool = True, stride: int = 1,
                 groups: int = 1, precision: Precision = F32):
        super().__init__()
        self.stride, self.groups, self.precision = stride, groups, precision
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, k, k))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def init_bounds(self) -> t.Dict[str, float]:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        return {"weight": bound, **({"bias": bound} if self.bias is not None else {})}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, p = self.weight.shape[-1], self.precision
        y = F.conv2d(nchw(p.act(x)), p.weight(self.weight), self.bias, stride=self.stride,
                     padding=(k - 1) // 2, groups=self.groups)
        return p.act(nhwc(y))


class ConvTranspose(nn.Module):
    """2x2 stride-2 transposed conv on NHWC, weight (in, out, 2, 2)."""

    def __init__(self, in_ch: int, out_ch: int, precision: Precision = F32):
        super().__init__()
        self.precision = precision
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, 2, 2))
        self.bias = nn.Parameter(torch.empty(out_ch))

    def init_bounds(self) -> t.Dict[str, float]:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        return {"weight": bound, "bias": bound}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.precision
        y = F.conv_transpose2d(nchw(p.act(x)), p.weight(self.weight), self.bias, stride=2)
        return p.act(nhwc(y))


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, training: bool,
               eps: float = 1e-5, calibrate: bool = False) -> torch.Tensor:
    """BatchNorm over the last dim of ``x``: in training with the batch's
    mean and biased variance (the running statistics are not updated: the
    comparisons read parameters only), else with ``mean`` and ``var``.
    ``calibrate`` (eval mode) first sets ``mean`` and ``var`` in place to
    the batch's."""
    dims = tuple(range(x.dim() - 1))
    if training or calibrate:
        batch_var, batch_mean = torch.var_mean(x, dim=dims, correction=0)
        if training:
            var, mean = batch_var, batch_mean
        else:
            mean.copy_(batch_mean)
            var.copy_(batch_var)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


@torch.no_grad()
def calibrate_(model: nn.Module, x: torch.Tensor) -> None:
    """Sets every BatchNorm's running statistics to those its input has in
    an eval-mode forward of ``x`` (layer by layer, each BN seeing the
    statistics set before it), so that a model with drawn weights serves
    well-scaled activations."""
    bns = [m for m in model.modules() if isinstance(m, (BatchNorm, GateChain))]
    model.eval()
    for m in bns:
        m.calibrate = True
    try:
        model(x)
    finally:
        for m in bns:
            m.calibrate = False


class BatchNorm(nn.Module):
    def __init__(self, ch: int, precision: Precision = F32):
        super().__init__()
        self.precision = precision
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    calibrate = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.precision.act(batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var, self.training,
            calibrate=self.calibrate))


class ConvBNAct(nn.Module):
    """conv (no bias) -> BN -> ReLU."""

    def __init__(self, in_ch: int, out_ch: int, precision: Precision = F32):
        super().__init__()
        self.Conv_0 = Conv(in_ch, out_ch, bias=False, precision=precision)
        self.BatchNorm_0 = BatchNorm(out_ch, precision)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(self.Conv_0(x)))


class DoubleConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, precision: Precision = F32):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(in_ch, out_ch, precision)
        self.ConvBNAct_1 = ConvBNAct(out_ch, out_ch, precision)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvBNAct_1(self.ConvBNAct_0(x))


class GateChain(nn.Module):
    """MTAN's attention gate: ``shared * sigmoid(BN2(relu(BN1(x w1 + b1))
    w2 + b2))``, the BNs over the rows of the batch."""

    calibrate = False

    def __init__(self, in_ch: int, hidden: int, out_ch: int, precision: Precision = F32):
        super().__init__()
        self.precision = precision
        self.w1 = nn.Parameter(torch.empty(in_ch, hidden))
        self.b1 = nn.Parameter(torch.empty(hidden))
        self.w2 = nn.Parameter(torch.empty(hidden, out_ch))
        self.b2 = nn.Parameter(torch.empty(out_ch))
        self.scale1 = nn.Parameter(torch.ones(hidden))
        self.bias1 = nn.Parameter(torch.zeros(hidden))
        self.scale2 = nn.Parameter(torch.ones(out_ch))
        self.bias2 = nn.Parameter(torch.zeros(out_ch))
        self.register_buffer("mean1", torch.zeros(hidden))
        self.register_buffer("var1", torch.ones(hidden))
        self.register_buffer("mean2", torch.zeros(out_ch))
        self.register_buffer("var2", torch.ones(out_ch))

    def init_bounds(self) -> t.Dict[str, float]:
        b1, b2 = 1.0 / math.sqrt(self.w1.shape[0]), 1.0 / math.sqrt(self.w2.shape[0])
        return {"w1": b1, "b1": b1, "w2": b2, "b2": b2}

    def forward(self, x: torch.Tensor, shared: torch.Tensor) -> torch.Tensor:
        act = self.precision.act  # the gate's inside is float32, as in the program
        x, shared = act(x), act(shared)
        h = x @ self.w1 + self.b1
        h = torch.relu(batch_norm(h, self.scale1, self.bias1, self.mean1, self.var1,
                                  self.training, calibrate=self.calibrate))
        a = h @ self.w2 + self.b2
        a = batch_norm(a, self.scale2, self.bias2, self.mean2, self.var2, self.training,
                       calibrate=self.calibrate)
        return act(shared * torch.sigmoid(a))


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    return nhwc(F.max_pool2d(nchw(x), 2))


def resize_align_corners(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if x.shape[1:3] == (h, w):
        return x
    return nhwc(F.interpolate(nchw(x), size=(h, w), mode="bilinear", align_corners=True))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def pad_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Zero-pad ``x`` spatially, centred, to ``(h, w)``."""
    dy, dx = h - x.shape[1], w - x.shape[2]
    return F.pad(x, (0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


def init_bounds(model: nn.Module) -> t.Dict[str, float]:
    """Every parameter drawn uniform in +-bound, by its full name; the other
    parameters and buffers keep the values the modules give them."""
    out = {}
    for prefix, module in model.named_modules():
        if hasattr(module, "init_bounds"):
            for name, bound in module.init_bounds().items():
                out[f"{prefix}.{name}" if prefix else name] = bound
    return out
