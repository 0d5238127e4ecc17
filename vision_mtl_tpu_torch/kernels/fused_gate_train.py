"""MTAN's train-mode attention gate: CUDA kernel, plain version, gradient.

Counterpart of ``fused_attention_gate_train`` in
``vision_mtl_tpu/ops/pallas/fused_gate.py``. In train mode both BatchNorms
of the gate chain

    attn = sigmoid(BN2(conv1x1_2(relu(BN1(conv1x1_1(x))))));  out = shared * attn

normalise with the batch's own statistics, so the chain needs two global
reductions before it can write its output. The CUDA kernel
(``csrc/fused_gate.cu``, three passes) recomputes the (N, hidden) and (N, C2)
intermediates instead of storing them and returns
``(out, mean1, var1, mean2, var2)``: the raw biased batch statistics, which
the caller folds into its running statistics.
:func:`fused_attention_gate_train_plain` computes the same function with
PyTorch ops and is what runs for CPU tensors.

:func:`fused_attention_gate_train` is differentiable. Its backward is
PyTorch ops by design (the JAX package differentiates this chain with XLA and
has no backward kernel): it recomputes h and a from the saved inputs and the
saved statistics and applies the BatchNorm gradient with batch statistics.
Between forward and backward it holds only its inputs and the four
statistics, never an (N, hidden) or (N, C2) intermediate.
"""

from __future__ import annotations

import ctypes
import typing as t

import torch

from vision_mtl_tpu_torch.kernels._build import LaunchCounter, load
from vision_mtl_tpu_torch.kernels.fused_gate import SOURCE, check_gate_args

launches = LaunchCounter()

_SIGNATURE = (
    [ctypes.c_void_p] * 13
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int]
    + [ctypes.c_void_p]
)
_SCRATCH_SIGNATURE = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    # f32 math for f32 and bf16 activations; f64 stays f64 (gradcheck)
    return torch.promote_types(x.dtype, torch.float32)


def _batch_stats(z: torch.Tensor) -> t.Tuple[torch.Tensor, torch.Tensor]:
    """Mean and biased variance over rows, accumulated in f64."""
    zd = z.double()
    mean = zd.mean(0)
    var = (zd - mean).square().mean(0)
    return mean.to(z.dtype), var.to(z.dtype)


def fused_attention_gate_train_plain(
    x: torch.Tensor,
    shared: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    scale1: torch.Tensor,
    bias1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    scale2: torch.Tensor,
    bias2: torch.Tensor,
    eps: float = 1e-5,
) -> t.Tuple[torch.Tensor, ...]:
    """The kernel's function in PyTorch ops: f32 math (f64 for f64 inputs),
    statistics accumulated in f64, output in shared's dtype. Returns
    ``(out, mean1, var1, mean2, var2)``."""
    cd = _compute_dtype(x)
    cin, c2ch = x.shape[-1], shared.shape[-1]
    h = x.reshape(-1, cin).to(cd) @ w1.to(cd) + b1.to(cd)
    mean1, var1 = _batch_stats(h)
    inv1 = scale1.to(cd) / torch.sqrt(var1 + eps)
    h = torch.relu((h - mean1) * inv1 + bias1.to(cd))
    a = h @ w2.to(cd) + b2.to(cd)
    mean2, var2 = _batch_stats(a)
    inv2 = scale2.to(cd) / torch.sqrt(var2 + eps)
    attn = torch.sigmoid((a - mean2) * inv2 + bias2.to(cd))
    out = (shared.reshape(-1, c2ch).to(cd) * attn).to(shared.dtype).reshape(shared.shape)
    return out, mean1, var1, mean2, var2


def _launch(x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2, eps):
    """The CUDA kernel's forward; raises unless every tensor fits it."""
    _check(x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2)
    b, h, w, cin = x.shape
    hidden, c2ch = w2.shape
    n = b * h * w
    out = torch.empty_like(shared)
    stats = torch.empty(2 * (hidden + c2ch), dtype=torch.float32, device=x.device)
    nbytes = load(
        SOURCE, "vmtl_fused_attention_gate_train_scratch_bytes", _SCRATCH_SIGNATURE,
        restype=ctypes.c_longlong,
    )(n, hidden, c2ch)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    fn = load(SOURCE, "vmtl_fused_attention_gate_train", _SIGNATURE)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), shared.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            scale1.data_ptr(), bias1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            scale2.data_ptr(), bias2.data_ptr(), out.data_ptr(), stats.data_ptr(),
            scratch.data_ptr(), n, cin, hidden, c2ch, eps, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_attention_gate_train: kernel launch failed, CUDA error {rc}")
    launches.add()
    mean1, var1, mean2, var2 = stats.split([hidden, hidden, c2ch, c2ch])
    return out, mean1, var1, mean2, var2


def _bn_backward(dy_hat: torch.Tensor, z_hat: torch.Tensor, rstd: torch.Tensor) -> torch.Tensor:
    """Gradient through a batch-statistic normalisation z_hat = (z - mean) *
    rstd, given the gradient with respect to z_hat."""
    return rstd * (dy_hat - dy_hat.mean(0) - z_hat * (dy_hat * z_hat).mean(0))


class _FusedGateTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2, eps):
        args = (x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2, eps)
        if x.device.type == "cpu":
            out, *stats = fused_attention_gate_train_plain(*args)
        else:
            out, *stats = _launch(*args)
        ctx.eps = eps
        ctx.save_for_backward(x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2, *stats)
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def backward(ctx, dout, *_):
        saved = ctx.saved_tensors
        x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2, m1, v1, m2, v2 = saved
        cd = _compute_dtype(x)
        cin, c2ch = x.shape[-1], shared.shape[-1]
        xf = x.reshape(-1, cin).to(cd)
        sf = shared.reshape(-1, c2ch).to(cd)
        dout = dout.reshape(-1, c2ch).to(cd)
        w1, w2 = w1.to(cd), w2.to(cd)
        scale1, scale2 = scale1.to(cd), scale2.to(cd)
        # recompute the forward from the saved inputs and statistics
        rstd1 = torch.rsqrt(v1.to(cd) + ctx.eps)
        h_hat = (xf @ w1 + b1.to(cd) - m1.to(cd)) * rstd1
        z1 = h_hat * scale1 + bias1.to(cd)
        r = torch.relu(z1)
        rstd2 = torch.rsqrt(v2.to(cd) + ctx.eps)
        a_hat = (r @ w2 + b2.to(cd) - m2.to(cd)) * rstd2
        attn = torch.sigmoid(a_hat * scale2 + bias2.to(cd))
        # and back
        dshared = dout * attn
        dz2 = dout * sf * attn * (1.0 - attn)
        da = _bn_backward(dz2 * scale2, a_hat, rstd2)
        dr = (da @ w2.T) * (z1 > 0)
        dh = _bn_backward(dr * scale1, h_hat, rstd1)
        grads = (
            (dh @ w1.T).reshape(x.shape), dshared.reshape(shared.shape),
            xf.T @ dh, dh.sum(0), (dr * h_hat).sum(0), dr.sum(0),
            r.T @ da, da.sum(0), (dz2 * a_hat).sum(0), dz2.sum(0),
        )
        return (*(g.to(i.dtype) for g, i in zip(grads, saved)), None)


def fused_attention_gate_train(
    x: torch.Tensor,
    shared: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    scale1: torch.Tensor,
    bias1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    scale2: torch.Tensor,
    bias2: torch.Tensor,
    eps: float = 1e-5,
) -> t.Tuple[torch.Tensor, ...]:
    """Train-mode gate with batch-statistic BNs, NHWC; differentiable in all
    ten tensors.

    Args:
      x: (B, H, W, Cin) gate input; shared: (B, H, W, C2) features to
        modulate, same dtype as x (f32 or bf16 for the kernel).
      w1: (Cin, hidden), b1: (hidden,) — first conv1x1; scale1, bias1:
        (hidden,) — BN1's gamma and beta.
      w2: (hidden, C2), b2: (C2,) — second conv1x1; scale2, bias2: (C2,) —
        BN2's gamma and beta.

    Returns ``(out, mean1, var1, mean2, var2)``: out in shared's dtype and
    the raw biased batch statistics, f32 and not differentiable.

    CPU tensors take :func:`fused_attention_gate_train_plain`. CUDA tensors
    launch the kernel (f32 weights, all contiguous, hidden and C2 multiples
    of 4 up to 128 and 512) or raise; there is no fallback.
    """
    return _FusedGateTrain.apply(x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2, eps)


def _check(x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2) -> None:
    check_gate_args(
        "fused_attention_gate_train", x, shared, w1, w2,
        {"b1": b1, "scale1": scale1, "bias1": bias1},
        {"b2": b2, "scale2": scale2, "bias2": bias2},
    )
    if x.shape[:3].numel() == 0:
        raise ValueError("fused_attention_gate_train: batch statistics need at least one row")
