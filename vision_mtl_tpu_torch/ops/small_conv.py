"""3x3 stride-1 convolution for small channel counts, differentiable
(counterpart of ``conv3x3_small`` in ``vision_mtl_tpu/ops/pallas/small_conv.py``
with its custom VJP).

The forward runs kernel B3 through its operator
``torch.ops.vmtl.conv3x3_small`` (``kernels/small_conv.py``), which
``torch.export`` keeps in an exported graph. The backward computes dx with
the same operator: correlating the output gradient with the
flipped, transposed weights ``k[::-1, ::-1].transpose(C, O)`` is another
small-channel 3x3 conv, with no bias, as the JAX ``_bwd`` does. dw comes
from PyTorch's conv weight gradient in x's dtype (the JAX package leaves it
to XLA: its contraction runs over B*H*W, where the library is efficient)
and db is the f32 sum of the output gradient.
"""

from __future__ import annotations

import typing as t

import torch

from vision_mtl_tpu_torch.kernels import small_conv as kernel_b3


class _Conv3x3Small(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias):
        x = x.contiguous()
        ctx.save_for_backward(x, kernel)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return kernel_b3.conv3x3_small(x, kernel, bias)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            k_t = kernel.flip(0, 1).transpose(2, 3)  # (3, 3, O, C)
            dx = kernel_b3.conv3x3_small(g, k_t)
        if ctx.needs_input_grad[1]:
            c, o = kernel.shape[2], kernel.shape[3]
            dw = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), (o, c, 3, 3), g.permute(0, 3, 1, 2), padding=1
            )
            dw = dw.permute(2, 3, 1, 0).to(kernel.dtype)
        if ctx.needs_input_grad[2]:
            db = g.to(torch.promote_types(g.dtype, torch.float32)).sum((0, 1, 2))
            db = db.to(ctx.bias_dtype)
        return dx, dw, db


def conv3x3_small(
    x: torch.Tensor, kernel: torch.Tensor, bias: t.Optional[torch.Tensor] = None
) -> torch.Tensor:
    """3x3 stride-1 conv with one pixel of zero padding, NHWC, for C, O < 100:
    x (B, H, W, C), kernel (3, 3, C, O) (f32 parameters), bias (O,) or None.
    Computes in x's dtype with f32 accumulation and the bias added in f32;
    returns (B, H, W, O) in x's dtype. Differentiable in all three.

    CPU tensors take the kernel's plain version, forward and dx. CUDA tensors
    launch kernel B3 for both or raise; there is no fallback.
    """
    return _Conv3x3Small.apply(x, kernel, bias)
