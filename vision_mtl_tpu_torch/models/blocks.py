"""Shared NHWC building blocks (counterpart of
``vision_mtl_tpu/models/blocks.py``).

Every block takes and returns NHWC tensors. PyTorch's convolutions and
BatchNorm want channels at dim 1, so the blocks work on the NCHW view of
their input: a permutation of an NHWC tensor is a ``channels_last`` tensor
and costs no copy. Parameters and BN statistics are float32; convolutions
compute in the block's ``dtype`` (bfloat16 by default), BN computes in f32
and returns its input's dtype, as in the JAX package.

``module.train()`` and ``module.eval()`` switch BatchNorm between batch and
running statistics, as the JAX package's ``train`` argument does.

``FoldedConv``, ``FoldedBatchNorm`` and ``FoldedConvBNAct`` are the same
blocks on a space-to-depth folded tensor (``ops/fold.py``), with the same
parameters at the same names. :func:`checkpointed` rematerialises a block
in the backward pass, as flax's ``nn.remat`` does.

Inside ``parallel.multihost.global_batch`` (the train step under a mesh of
several ranks) a train-mode BatchNorm normalises with the statistics of the
ranks' rows together, as a JAX BatchNorm over a batch sharded on the mesh's
``data`` axis does: each rank's (rows, mean, M2) are gathered and combined
in f64 in rank order, and the backward all-reduces the two per-channel sums
it needs (:class:`GlobalBatchNorm`). Inside ``parallel.halo.spatial_rows``
(the mesh's ``spatial`` axis) every map holds this rank's image rows:
:func:`conv_nhwc` takes the rows its conv reads from the neighbouring ranks
and the squeeze-excite mean sums over them; the BatchNorms stay as they
are, their statistics global over data x spatial.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
import typing as t

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from vision_mtl_tpu_torch.kernels import small_conv as small_conv_kernel
from vision_mtl_tpu_torch.ops import fold as fold_ops
from vision_mtl_tpu_torch.ops import small_conv as small_conv_op
from vision_mtl_tpu_torch.parallel.halo import halo_rows, rows_comm, spatial_rows
from vision_mtl_tpu_torch.parallel.multihost import (
    Comm,
    all_gather_exact,
    all_reduce_sum,
    batch_comm,
    combine_moments,
    global_batch,
)

#: When True, the running-variance update of every train-mode BatchNorm
#: (and of the attention gate's BNs) uses torch's UNBIASED n/(n-1) batch
#: variance instead of flax's biased one; normalisation uses the biased
#: variance either way. Off by default (flax semantics, as in the JAX
#: package); VMTL_TORCH_BN_VAR=1 or set_torch_bn_running_var() turns it on.
#: Read at every train-mode forward.
_TORCH_BN_VAR = os.environ.get("VMTL_TORCH_BN_VAR", "0") == "1"
#: fraction of a running statistic retained per train-mode step (flax's
#: momentum 0.9 == torch's 0.1)
MOMENTUM = 0.9


def set_torch_bn_running_var(enabled: bool) -> None:
    global _TORCH_BN_VAR
    _TORCH_BN_VAR = bool(enabled)


def torch_bn_running_var() -> bool:
    return _TORCH_BN_VAR


# set while torch.utils.checkpoint recomputes a block for the backward pass
# (on the thread that runs the recompute)
_recompute = threading.local()


@contextlib.contextmanager
def _recomputing(
    comm: t.Optional[Comm] = None, rows: t.Optional[Comm] = None
) -> t.Iterator[None]:
    before = getattr(_recompute, "active", False)
    _recompute.active = True
    try:
        # the recompute runs in the backward pass, maybe on autograd's own
        # thread: it takes the forward's ranks and spatial group, so that it
        # calls the same collectives in the same order on every rank
        with global_batch(comm), spatial_rows(rows):
            yield
    finally:
        _recompute.active = before


def _remat_contexts() -> t.Tuple[t.ContextManager[None], t.ContextManager[None]]:
    return contextlib.nullcontext(), _recomputing(batch_comm(), rows_comm())


def checkpointed(module: nn.Module, *args: t.Any) -> t.Any:
    """``module(*args)``, rematerialised when the module is in train mode
    and gradients are on: its activations are dropped after the forward and
    recomputed in the backward pass (``torch.utils.checkpoint``,
    non-reentrant), as flax's ``nn.remat`` does. The recompute leaves every
    running statistic as the first pass left it (:func:`update_running_stats`
    does nothing during it), so the batch is counted once, as under flax.
    Eval and no-grad forwards run the module as it is."""
    if not (module.training and torch.is_grad_enabled()):
        return module(*args)
    return torch.utils.checkpoint.checkpoint(
        module, *args, use_reentrant=False, context_fn=_remat_contexts
    )


def update_running_stats(
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    n: int,
) -> None:
    """flax's running-statistics update in place, retaining ``MOMENTUM``.
    ``var`` is the biased batch variance over ``n`` rows; under the
    torch-running-var switch it is scaled to the unbiased one first. Does
    nothing while :func:`checkpointed` recomputes a block: the first pass
    updated the statistics already."""
    if getattr(_recompute, "active", False):
        return
    with torch.no_grad():
        if _TORCH_BN_VAR:
            var = var * (n / max(n - 1, 1))
        running_mean.mul_(MOMENTUM).add_(mean.float(), alpha=1.0 - MOMENTUM)
        running_var.mul_(MOMENTUM).add_(var.float(), alpha=1.0 - MOMENTUM)


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _uniform_(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    # torch's Conv2d default: kaiming_uniform(a=sqrt(5)) == U(+-1/sqrt(fan_in)),
    # the same bound as its bias init
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        p.uniform_(-bound, bound, generator=generator)


def conv_halo(kh: int, stride: int) -> t.Tuple[int, int]:
    """(lo, hi): the rows above and below its own that a rank needs for a
    conv of ``kh`` rows at ``stride`` with padding ``(kh-1)//2``, when it
    holds a multiple of ``stride`` rows: its first output row reads from
    ``lo`` rows up, its last ``hi`` rows past its own."""
    lo = (kh - 1) // 2
    return lo, max(kh - stride - lo, 0)


def conv_nhwc(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: t.Optional[torch.Tensor],
    dtype: torch.dtype,
    strides: t.Tuple[int, int] = (1, 1),
    groups: int = 1,
    small_conv: bool = False,
) -> torch.Tensor:
    """Conv2d on NHWC with an OIHW weight and torch padding ``(k-1)//2`` for
    every stride, computed in ``dtype``. ``small_conv`` routes a 3x3
    stride-1 dense conv through kernel B3 (``ops.small_conv``), which adds
    the bias in f32 before its one cast; otherwise PyTorch's conv runs in
    ``dtype`` with the bias in ``dtype``.

    Inside ``parallel.halo.spatial_rows`` x is this rank's rows of the map:
    it is extended by the halo rows the conv reads (``halo_rows``) and the
    same conv runs on them with no row padding, giving this rank's output
    rows. B3 pads one row itself: it runs on x with one halo row each side,
    and its first and last output rows, which that padding made wrong, are
    dropped."""
    kh, kw = weight.shape[2:]
    comm = rows_comm()
    if small_conv:
        k = weight.permute(2, 3, 1, 0)
        if comm is None:
            return small_conv_op.conv3x3_small(x.to(dtype), k, bias)
        return small_conv_op.conv3x3_small(halo_rows(x.to(dtype), 1, 1, comm), k, bias)[:, 1:-1]
    pad_h = (kh - 1) // 2
    if comm is not None:  # the rows travel in the conv's dtype
        x = halo_rows(x.to(dtype), *conv_halo(kh, strides[0]), comm)
        pad_h = 0
    y = F.conv2d(
        _to_nchw(x).to(dtype), weight.to(dtype), None if bias is None else bias.to(dtype),
        stride=strides, padding=(pad_h, (kw - 1) // 2), groups=groups,
    )
    return _to_nhwc(y)


class Conv(nn.Module):
    """Conv2d on NHWC with torch padding ``(k-1)//2``; weight OIHW, (O, C /
    groups, kh, kw) (depthwise: (O, 1, kh, kw)).

    ``small_conv=True`` asks for kernel B3; the conv takes it when it is a
    3x3 stride-1 dense conv with C, O < 100 (``self.small_conv`` says
    whether it does)."""

    def __init__(
        self,
        in_ch: int,
        features: int,
        kernel_size: t.Tuple[int, int] = (3, 3),
        use_bias: bool = True,
        dtype: torch.dtype = torch.bfloat16,
        strides: t.Tuple[int, int] = (1, 1),
        groups: int = 1,
        small_conv: bool = False,
    ):
        super().__init__()
        kh, kw = kernel_size
        self.dtype = dtype
        self.strides = tuple(strides)
        self.groups = groups
        self.small_conv = (
            small_conv and (kh, kw) == (3, 3) and self.strides == (1, 1) and groups == 1
            and small_conv_kernel.fits(in_ch, features)
        )
        self.weight = nn.Parameter(torch.empty(features, in_ch // groups, kh, kw))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        _uniform_(self.weight, fan_in, generator)
        if self.bias is not None:
            _uniform_(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(
            x, self.weight, self.bias, self.dtype, self.strides, self.groups, self.small_conv
        )


class ConvTranspose(nn.Module):
    """Stride-2 2x2 transposed conv on NHWC (flax ``nn.ConvTranspose`` with
    ``padding="VALID"``); weight in torch's (in, out, kh, kw) layout."""

    def __init__(self, in_ch: int, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_ch, features, 2, 2))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        _uniform_(self.weight, fan_in, generator)
        _uniform_(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(
            _to_nchw(x).to(self.dtype), self.weight.to(self.dtype),
            self.bias.to(self.dtype), stride=2,
        )
        return _to_nhwc(y)


class BatchNorm(nn.Module):
    """BatchNorm over NHWC channels, eps 1e-5, statistics in f32, output in
    the input's dtype.

    Eval mode normalises with the running statistics. Train mode normalises
    with the batch mean and biased variance and then updates the running
    statistics as flax does (:func:`update_running_stats`).
    ``F.batch_norm`` is not given the running buffers in train mode: it would
    update them with torch's momentum and unbiased variance whatever the
    switch says.
    """

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm_nhwc(
            x, self.weight, self.bias, self.running_mean, self.running_var, self.eps,
            self.training,
        )


def batch_norm_nhwc(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    eps: float,
    training: bool,
) -> torch.Tensor:
    """:class:`BatchNorm`'s function on NHWC ``x`` with these (C,) tensors
    (views of larger ones are updated in place)."""
    if not training:
        y = F.batch_norm(
            _to_nchw(x), running_mean, running_var, weight, bias, False, 0.0, eps
        )
        return _to_nhwc(y)
    comm = batch_comm()
    if comm is not None:
        y, mean, var = GlobalBatchNorm.apply(_to_nchw(x), weight, bias, eps, comm)
        n = x.numel() // x.shape[-1] * comm.world
        update_running_stats(running_mean, running_var, mean, var, n)
        return _to_nhwc(y)
    # native_batch_norm returns the batch mean and 1/sqrt(var + eps) it
    # normalised with; its backward differentiates through both
    y, mean, invstd = torch.native_batch_norm(
        _to_nchw(x), weight, bias, None, None, True, 0.0, eps
    )
    var = invstd.detach().double().pow(-2).sub(eps).clamp(min=0.0)
    update_running_stats(running_mean, running_var, mean.detach(), var, x.numel() // x.shape[-1])
    return _to_nhwc(y)


class GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of an NCHW ``x`` over the rows of every rank of
    ``comm`` (each holds as many): ``(y, mean, var)`` with the global batch
    mean and biased variance (f64, not differentiable).

    Each rank's per-channel (rows, mean, M2) are taken in f32 (f64 for f64),
    gathered exactly and combined in f64 in rank order (Chan's formula), so
    every rank normalises with the same bits. The backward all-reduces
    Σdy and Σdy·x̂ and returns this rank's rows' gradient; the weight's and
    the bias's gradients are this rank's share, summed with the others'
    by the step's gradient all-reduce."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, comm):
        cd = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(cd)
        rows = x.numel() // x.shape[1]
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        mean_d = mean.double()
        local = torch.stack([torch.full_like(mean_d, rows), mean_d, var.double() * rows])
        n, gmean, m2 = combine_moments(all_gather_exact(local, comm)).unbind(0)
        gvar = (m2 / n).clamp(min=0.0)
        mean_c = gmean.to(cd)
        invstd = torch.rsqrt(gvar + eps).to(cd)
        x_hat = (xf - mean_c[:, None, None]) * invstd[:, None, None]
        y = x_hat * weight.to(cd)[:, None, None] + bias.to(cd)[:, None, None]
        ctx.save_for_backward(x, weight, mean_c, invstd)
        ctx.comm, ctx.n = comm, rows * comm.world
        ctx.mark_non_differentiable(gmean, gvar)
        return y.to(x.dtype), gmean, gvar

    @staticmethod
    def backward(ctx, dy, *_):
        x, weight, mean_c, invstd = ctx.saved_tensors
        cd = mean_c.dtype
        x_hat = (x.to(cd) - mean_c[:, None, None]) * invstd[:, None, None]
        dyf = dy.to(cd)
        local = torch.stack([dyf.sum((0, 2, 3)), (dyf * x_hat).sum((0, 2, 3))])
        sum_dy, sum_dy_xhat = ctx.comm.all_reduce_(local.clone()) / ctx.n
        dx = (weight.to(cd) * invstd)[:, None, None] * (
            dyf - sum_dy[:, None, None] - x_hat * sum_dy_xhat[:, None, None]
        )
        return dx.to(x.dtype), local[1].to(weight.dtype), local[0].to(weight.dtype), None, None


class RawBatchNorm(BatchNorm):
    """A flax ``nn.BatchNorm`` used directly, not through the ``BatchNorm``
    wrapper (the encoder's ``_stem_bn`` and ``_head_bn``): the same
    computation, with its leaves one level higher in the JAX tree."""


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


ACTIVATIONS: t.Dict[str, t.Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu,
    "hardswish": hard_swish,
}


class ConvBNAct(nn.Module):
    """conv (no bias) -> BN -> ReLU."""

    def __init__(
        self,
        in_ch: int,
        features: int,
        kernel_size: t.Tuple[int, int] = (3, 3),
        dtype: torch.dtype = torch.bfloat16,
        small_conv: bool = False,
    ):
        super().__init__()
        self.Conv_0 = Conv(
            in_ch, features, kernel_size, use_bias=False, dtype=dtype, small_conv=small_conv
        )
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(self.Conv_0(x)))


class FoldedConv(Conv):
    """A stride-1 conv on a space-to-depth FOLDED input (B, Hf, Wf, 4C) ->
    (B, Hf, Wf, 4O) (``ops.fold.folded_conv``): a plain conv in ``dtype`` on
    the folded kernel built at each call. The weight keeps ``Conv``'s
    unfolded (O, C, kh, kw) shape and name, so fold on or off is
    checkpoint-identical. ``in_splits``: the input is separately folded
    groups of these channel counts, concatenated."""

    def __init__(
        self,
        in_ch: int,
        features: int,
        kernel_size: t.Tuple[int, int] = (3, 3),
        in_splits: t.Optional[t.Tuple[int, ...]] = None,
        use_bias: bool = True,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__(in_ch, features, kernel_size, use_bias=use_bias, dtype=dtype)
        self.in_splits = in_splits

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fold_ops.folded_conv(
            x, self.weight.permute(2, 3, 1, 0), self.bias, in_splits=self.in_splits,
            dtype=self.dtype,
        )


class FoldedBatchNorm(BatchNorm):
    """BatchNorm on a FOLDED tensor, its statistics tied across the 4 phases:
    the unfolded BatchNorm's function. Parameters and running statistics
    keep their unfolded (C,) shapes and names. The train-mode running
    variance counts all four phases' rows (``n = y.numel() // C``)."""

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return fold_ops.folded_batch_norm(
                y, self.running_mean, self.running_var, self.weight, self.bias, self.eps
            )
        c = y.shape[-1] // 4
        if batch_comm() is not None:
            # the four phases are four more pixels of each channel: the
            # unfolded BatchNorm over the ranks on a (B, Hf, Wf * 4, C) view
            b, hf, wf, _ = y.shape
            out = batch_norm_nhwc(
                y.reshape(b, hf, wf * 4, c), self.weight, self.bias, self.running_mean,
                self.running_var, self.eps, True,
            )
            return out.reshape(y.shape)
        mean, var = fold_ops.folded_batch_stats(y)
        update_running_stats(
            self.running_mean, self.running_var, mean.detach(), var.detach(), y.numel() // c
        )
        return fold_ops.folded_batch_norm(y, mean, var, self.weight, self.bias, self.eps)


class FoldedConvBNAct(nn.Module):
    """conv (no bias) -> BN -> ReLU on a folded tensor, with ``ConvBNAct``'s
    children (``Conv_0``, ``BatchNorm_0``) and parameters."""

    def __init__(
        self,
        in_ch: int,
        features: int,
        kernel_size: t.Tuple[int, int] = (3, 3),
        in_splits: t.Optional[t.Tuple[int, ...]] = None,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.Conv_0 = FoldedConv(
            in_ch, features, kernel_size, in_splits=in_splits, use_bias=False, dtype=dtype
        )
        self.BatchNorm_0 = FoldedBatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(self.Conv_0(x)))


class DoubleConv(nn.Module):
    """(conv3x3 -> BN -> ReLU) * 2."""

    def __init__(
        self,
        in_ch: int,
        features: int,
        mid_features: t.Optional[int] = None,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        mid = mid_features or features
        self.ConvBNAct_0 = ConvBNAct(in_ch, mid, dtype=dtype)
        self.ConvBNAct_1 = ConvBNAct(mid, features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvBNAct_1(self.ConvBNAct_0(x))


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel_size=2, stride=2) NHWC; odd sizes are floored."""
    return _to_nhwc(F.max_pool2d(_to_nchw(x), 2))


class SqueezeExcite(nn.Module):
    """MobileNetV3 squeeze-excite: the f32 spatial mean, 1x1 conv, ReLU, 1x1
    conv (both with bias, in the block's dtype), then x times the hard
    sigmoid of the result taken in f32 and cast to x's dtype. Under
    ``parallel.halo.spatial_rows`` the mean is the whole image's: the rows'
    sums are summed over the spatial group."""

    def __init__(self, channels: int, reduced: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(channels, reduced, (1, 1), dtype=dtype)
        self.Conv_1 = Conv(reduced, channels, (1, 1), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f32 = torch.promote_types(x.dtype, torch.float32)
        comm = rows_comm()
        if comm is None:
            s = x.to(f32).mean((1, 2), keepdim=True)
        else:  # the image's mean: the sum over the group's rows
            s = all_reduce_sum(x.to(f32).sum((1, 2), keepdim=True), comm)
            s = s / (x.shape[1] * comm.world * x.shape[2])
        s = self.Conv_1(torch.relu(self.Conv_0(s)))
        return x * hard_sigmoid(s.to(f32)).to(x.dtype)


def make_divisible(v: float, divisor: int = 8, min_value: t.Optional[int] = None) -> int:
    """Channel rounding used throughout the MobileNetV3 family."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def init_weights(model: nn.Module, seed: int) -> None:
    """Fresh torch-default weights for every block of ``model``, drawn from
    one ``torch.Generator`` seeded with ``seed`` in module order."""
    generator = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
