"""Resize / padding primitives for NHWC feature maps (counterpart of
``vision_mtl_tpu/ops/interpolate.py``).

Inputs and outputs are NHWC. PyTorch's kernels want channels at dim 1, so
each function works on the NCHW view of its input: a permutation of an NHWC
tensor, which costs no copy (it is a ``channels_last`` tensor).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vision_mtl_tpu_torch.parallel.halo import gather_rows, halo_rows, rows_comm


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample, NHWC: every pixel repeated in a 2x2
    block (torch's nearest interpolation at scale 2, exactly)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True, NHWC, to exactly
    ``(out_h, out_w)``; computed in f32 (f64 for f64), returned in x's dtype.

    Inside ``parallel.halo.spatial_rows`` x holds this rank's rows of a map
    and ``out_h`` is its rows of the output: output row i of the map samples
    input row ``i (H_in - 1) / (H_out - 1)``, which for a resize of at most
    2x lies within one row of the rank's own, so the rows are interpolated
    in the map's coordinates on x with one halo row each side (W first,
    then H, the order of PyTorch's kernel)."""
    _, h, w, _ = x.shape
    if h == out_h and w == out_w:
        return x
    comm = rows_comm()
    if comm is None:
        y = F.interpolate(
            x.permute(0, 3, 1, 2).to(torch.promote_types(x.dtype, torch.float32)),
            size=(out_h, out_w),
            mode="bilinear",
            align_corners=True,
        )
        return y.permute(0, 2, 3, 1).to(x.dtype)
    if out_h > 2 * h:
        raise ValueError(f"a resize of {h} rows a rank to {out_h} reads past one halo row")
    cd = torch.promote_types(x.dtype, torch.float32)
    xh = halo_rows(x, 1, 1, comm).to(cd)  # global rows s h - 1 .. (s + 1) h
    if w != out_w:
        xh = F.interpolate(xh.permute(0, 3, 1, 2), size=(h + 2, out_w), mode="bilinear",
                           align_corners=True).permute(0, 2, 3, 1)
    n_in, n_out = h * comm.world, out_h * comm.world
    scale = torch.tensor((n_in - 1) / (n_out - 1) if n_out > 1 else 0.0, dtype=cd)
    dst = torch.arange(comm.rank * out_h, (comm.rank + 1) * out_h, dtype=cd)
    src = scale * dst
    i0 = src.long().clamp(max=n_in - 1)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    lam1 = (src - i0.to(cd)).to(xh.device)
    lam0 = 1.0 - lam1
    base = comm.rank * h - 1  # the global row of xh's first row
    r0 = xh.index_select(1, (i0 - base).to(xh.device))
    r1 = xh.index_select(1, (i1 - base).to(xh.device))
    shape = (1, out_h, 1, 1)
    y = r0 * lam0.reshape(shape) + r1 * lam1.reshape(shape)
    return y.to(x.dtype)


def pad_to_match(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Zero-pad x1 spatially (centered) to x2's H,W — NHWC equivalent of the
    reference's concat_slightly_diff_sized_tensors padding step.

    Inside ``parallel.halo.spatial_rows`` both hold this rank's rows of
    their maps. Equal row counts pad W alone; a taller x2 (CSNet's zero-pad
    merge) centres x1's map in x2's rows, which moves rows across ranks:
    the whole of x1's map is gathered (``halo.gather_rows``) and the rank
    keeps its rows of the padded map."""
    dy = x2.shape[1] - x1.shape[1]
    dx = x2.shape[2] - x1.shape[2]
    comm = rows_comm()
    if comm is None or dy == 0:
        return F.pad(x1, (0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    h2 = x2.shape[1]
    full = gather_rows(x1, comm)
    dy = h2 * comm.world - full.shape[1]
    padded = F.pad(full, (0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    return padded[:, comm.rank * h2:(comm.rank + 1) * h2]


def pad_concat(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """concat([x2, pad(x1)]) along channels — the skip (x2) first."""
    return torch.cat([x2, pad_to_match(x1, x2)], dim=-1)
