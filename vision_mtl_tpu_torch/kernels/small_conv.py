"""3x3 stride-1 convolution for small channel counts: CUDA kernel and its
plain version.

Counterpart of ``_conv3x3_pallas`` in ``vision_mtl_tpu/ops/pallas/small_conv.py``:
an NHWC 3x3 conv with one pixel of zero padding, plus bias, for C, O < 100.
The input and the weights take x's dtype before the products (bf16 or f32),
products are summed in f32, the f32 bias is added in f32 and the result is
cast to x's dtype once. The CUDA source (``csrc/small_conv.cu``) dispatches
on the dtype: bf16 runs an implicit GEMM on the tensor cores (mma.sync, f32
sums) that rounds the f32 weights to bf16 as it stages them, f32 a SIMT
kernel on f32 FMAs. :func:`conv3x3_small_plain` computes the same function
with PyTorch ops and is what runs for CPU tensors. The differentiable entry
point is ``vision_mtl_tpu_torch.ops.small_conv.conv3x3_small``: the operator
below has no autograd formula of its own, and that entry point's autograd
Function calls it for the forward and for dx (its forward runs without
autograd, so a Python autograd layer on the operator would only add host
time to every call).

Both are the two kernels of one PyTorch operator,
``torch.ops.vmtl.conv3x3_small``, registered when this module is imported:
the dispatcher runs the plain version for CPU tensors and the CUDA launch
for CUDA tensors, and its fake version gives the output's shape, dtype and
strides (NHWC, contiguous) to tracers, so ``torch.export`` keeps the
operator itself in an exported graph.
"""

from __future__ import annotations

import ctypes
import typing as t

import torch
import torch.nn.functional as F

from vision_mtl_tpu_torch.kernels._build import LaunchCounter, load

SOURCE = "small_conv"
#: the kernel takes C and O up to this (the Pallas kernel's own limit)
MAX_CHANNELS = 99

launches = LaunchCounter()

_SIGNATURE = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4
    + [ctypes.c_int, ctypes.c_void_p]
)


def fits(in_ch: int, out_ch: int) -> bool:
    """Whether a 3x3 stride-1 conv with these channel counts is one the
    kernel takes."""
    return 0 < in_ch <= MAX_CHANNELS and 0 < out_ch <= MAX_CHANNELS


def conv3x3_small_plain(
    x: torch.Tensor, kernel: torch.Tensor, bias: t.Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The kernel's function in PyTorch ops: x and kernel rounded to x's
    dtype, the conv and the bias in f32 (f64 for f64), one cast back."""
    cd = torch.promote_types(x.dtype, torch.float32)
    w = kernel.to(x.dtype).to(cd).permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(x.permute(0, 3, 1, 2).to(cd), w, padding=1)
    if bias is not None:
        y = y + bias.to(cd)[:, None, None]
    return y.permute(0, 2, 3, 1).to(x.dtype)


def conv3x3_small(
    x: torch.Tensor, kernel: torch.Tensor, bias: t.Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(B, H, W, O) in x's dtype: the 3x3 stride-1 conv of x (B, H, W, C)
    with kernel (3, 3, C, O), plus bias (O,) when given, through the
    operator ``torch.ops.vmtl.conv3x3_small``. Not differentiable (see
    ``ops.small_conv``).

    CPU tensors take :func:`conv3x3_small_plain`. CUDA tensors launch the
    kernel (x contiguous, bf16 or f32; C, O <= 99) or raise; there is no
    fallback, and tensors on any other device raise too. bf16 passes the
    weights in f32 at any strides (the kernel rounds them as it stages
    them); f32 makes them contiguous. The bias goes in f32.
    """
    return torch.ops.vmtl.conv3x3_small(x, kernel, bias)


def _launch(x: torch.Tensor, kernel: torch.Tensor, bias: t.Optional[torch.Tensor]) -> torch.Tensor:
    """The operator's CUDA kernel: checks the tensors, launches, counts."""
    _check(x, kernel, bias)
    b, h, w, c = x.shape
    o = kernel.shape[-1]
    out = torch.empty((b, h, w, o), dtype=x.dtype, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    k = kernel.to(torch.float32) if bf16 else kernel.to(torch.float32).contiguous()
    bias32 = None if bias is None else bias.to(torch.float32).contiguous()
    fn = load(SOURCE, "vmtl_conv3x3_small", _SIGNATURE)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), k.data_ptr(), None if bias32 is None else bias32.data_ptr(),
            out.data_ptr(), b, h, w, c, o, *k.stride(), int(bf16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"conv3x3_small: kernel launch failed, CUDA error {rc}")
    launches.add()
    return out


def _fake(x: torch.Tensor, kernel: torch.Tensor, bias: t.Optional[torch.Tensor]) -> torch.Tensor:
    """The operator's output from metadata alone; off the CPU the tensors
    must fit the kernel, as the CUDA launch checks."""
    if x.device.type != "cpu":
        _check(x, kernel, bias)
    b, h, w, _ = x.shape
    return x.new_empty((b, h, w, kernel.shape[-1]))


# the plain version is looked up at each call (tests replace it)
_lib = torch.library.Library("vmtl", "FRAGMENT")
_lib.define("conv3x3_small(Tensor x, Tensor kernel, Tensor? bias) -> Tensor")
_lib.impl(
    "conv3x3_small",
    lambda x, kernel, bias: conv3x3_small_plain(x, kernel, bias).contiguous(),
    "CPU",
)
_lib.impl("conv3x3_small", _launch, "CUDA")
torch.library.register_fake("vmtl::conv3x3_small", _fake, lib=_lib)


def _check(x: torch.Tensor, kernel: torch.Tensor, bias: t.Optional[torch.Tensor]) -> None:
    tensors = {"x": x, "kernel": kernel}
    if bias is not None:
        tensors["bias"] = bias
    for name, v in tensors.items():
        if v.device != x.device or v.device.type != "cuda":
            raise ValueError(
                f"conv3x3_small: {name} is on {v.device}; the kernel takes CUDA "
                f"tensors on one device (x is on {x.device})"
            )
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3x3_small: x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("conv3x3_small: x is not contiguous (NHWC)")
    if x.dim() != 4 or kernel.dim() != 4 or kernel.shape[:2] != (3, 3):
        raise ValueError(
            f"conv3x3_small: x must be (B, H, W, C) and kernel (3, 3, C, O), got "
            f"{tuple(x.shape)} and {tuple(kernel.shape)}"
        )
    c, o = kernel.shape[2], kernel.shape[3]
    if x.shape[-1] != c:
        raise ValueError(f"conv3x3_small: x has {x.shape[-1]} channels, kernel {c}")
    if not fits(c, o):
        raise ValueError(
            f"conv3x3_small: the kernel takes 1..{MAX_CHANNELS} input and output "
            f"channels, got {c} -> {o}"
        )
    if bias is not None and tuple(bias.shape) != (o,):
        raise ValueError(f"conv3x3_small: bias has shape {tuple(bias.shape)}, want ({o},)")
    if x.shape[0] > 65535:
        raise ValueError(f"conv3x3_small: batch {x.shape[0]} exceeds 65535")
