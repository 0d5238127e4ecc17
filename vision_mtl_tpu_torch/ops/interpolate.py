"""Resize / padding primitives for NHWC feature maps (counterpart of
``vision_mtl_tpu/ops/interpolate.py``).

Inputs and outputs are NHWC. PyTorch's kernels want channels at dim 1, so
each function works on the NCHW view of its input: a permutation of an NHWC
tensor, which costs no copy (it is a ``channels_last`` tensor).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample, NHWC: every pixel repeated in a 2x2
    block (torch's nearest interpolation at scale 2, exactly)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True, NHWC, to exactly
    ``(out_h, out_w)``; computed in f32 (f64 for f64), returned in x's dtype."""
    _, h, w, _ = x.shape
    if h == out_h and w == out_w:
        return x
    y = F.interpolate(
        x.permute(0, 3, 1, 2).to(torch.promote_types(x.dtype, torch.float32)),
        size=(out_h, out_w),
        mode="bilinear",
        align_corners=True,
    )
    return y.permute(0, 2, 3, 1).to(x.dtype)


def pad_to_match(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Zero-pad x1 spatially (centered) to x2's H,W — NHWC equivalent of the
    reference's concat_slightly_diff_sized_tensors padding step."""
    dy = x2.shape[1] - x1.shape[1]
    dx = x2.shape[2] - x1.shape[2]
    return F.pad(x1, (0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))


def pad_concat(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """concat([x2, pad(x1)]) along channels — the skip (x2) first."""
    return torch.cat([x2, pad_to_match(x1, x2)], dim=-1)
