"""Space-to-depth folding (counterpart of ``vision_mtl_tpu/ops/fold.py``):
exact layout rewrites of small-channel, full-resolution NHWC tensors.

Folding (B, H, W, C) -> (B, H/2, W/2, 4C) packs the 4 spatial phases of
each 2x2 window into the channels. Every op here is an EXACT transform of
its unfolded counterpart (the same sums, reassociated): a stride-1 odd-k
conv is a folded conv with a structured (k', k', 4C, 4O) kernel built from
the original (k, k, C, O) one; BatchNorm ties its statistics across the 4
phases; a nearest x2 upsample becomes a channel tile; a 2x2/2 max pool a
max over the phases; a 2x2/2 transposed conv a folded 1x1 conv. Parameters
keep their UNFOLDED shapes, so fold on or off is checkpoint-identical; the
folded kernels are built at each call from the unfolded ones.

Phase layout: fold(x)[b, i, j, (pr*2+pc)*C + c] = x[b, 2i+pr, 2j+pc, c]
("phase-major"). ``in_splits`` supports tensors built by concatenating
separately folded groups: concat([fold(a), fold(b)]) has the layout
[(phase-major over Ca), (phase-major over Cb)], a channel permutation of
fold(concat([a, b])), which the folded kernels absorb.

Kernels here are HWIO (kh, kw, in, out), as in the JAX package; the conv
blocks hold OIHW weights and hand them over transposed. The folded convs
are plain ``F.conv2d`` calls in the compute dtype, as the JAX package
computes them with ``lax.conv`` outside any Pallas kernel.
"""

from __future__ import annotations

import functools
import typing as t

import numpy as np
import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), phase-major channel layout."""
    b, h, w, c = x.shape
    assert h % 2 == 0 and w % 2 == 0, (h, w)
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space(y: torch.Tensor) -> torch.Tensor:
    """(B, Hf, Wf, 4C) -> (B, 2Hf, 2Wf, C), the inverse of space_to_depth."""
    b, hf, wf, c4 = y.shape
    assert c4 % 4 == 0, c4
    c = c4 // 4
    y = y.reshape(b, hf, wf, 2, 2, c)
    y = y.permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, 2 * hf, 2 * wf, c)


def tile_for_upsample(x: torch.Tensor) -> torch.Tensor:
    """fold(upsample_nearest_2x(x)) without the upsample: all 4 phases equal
    x, so the folded tensor is a channel 4-tile."""
    return x.repeat(1, 1, 1, 4)


def phase_max(y: torch.Tensor) -> torch.Tensor:
    """The 2x2/2 max pool of the unfolded tensor: the max over the 4 phases
    of the folded one; the output is UNFOLDED, (B, Hf, Wf, C)."""
    b, hf, wf, c4 = y.shape
    return y.reshape(b, hf, wf, 4, c4 // 4).amax(dim=3)


@functools.lru_cache(maxsize=64)
def _fold_gather_index(
    k: int, in_ch: int, out_ch: int, in_splits: t.Tuple[int, ...]
) -> t.Tuple[np.ndarray, np.ndarray]:
    """Static index maps to build the folded kernel by gather.

    Returns (src, mask): int and bool arrays of shape (k', k', 4*in_ch,
    4*out_ch), k' the folded spatial extent (1 for k = 1, 3 for k = 3 or
    5). src flat-indexes the original (k, k, in_ch, out_ch) kernel; mask
    zeroes the structurally absent taps.
    """
    assert k % 2 == 1, k
    half = (k - 1) // 2
    # the folded offsets that output phase p in {0, 1} reaches
    offs = sorted({(p + u - half) // 2 for p in (0, 1) for u in range(k)})
    kf = len(offs)
    off_to_idx = {o: i for i, o in enumerate(offs)}

    # channel layout: groups folded independently, then concatenated; the
    # in-channel position of (group g, phase P, channel c of the group) is
    # base(g) + P*split[g] + c with base(g) = 4 * sum(split[:g]); its
    # original in-channel is sum(split[:g]) + c
    in_pos = np.zeros((4, in_ch), dtype=np.int64)  # [phase, orig_ch] -> folded pos
    base = 0
    orig_base = 0
    for g in in_splits:
        for P in range(4):
            for c in range(g):
                in_pos[P, orig_base + c] = base + P * g + c
        base += 4 * g
        orig_base += g

    src = np.zeros((kf, kf, 4 * in_ch, 4 * out_ch), dtype=np.int64)
    mask = np.zeros((kf, kf, 4 * in_ch, 4 * out_ch), dtype=bool)
    for p in (0, 1):  # output row phase
        for q in (0, 1):  # output col phase
            for u in range(k):
                for v in range(k):
                    du, dv = p + u - half, q + v - half
                    fr, ir = du // 2, du % 2
                    fc, ic = dv // 2, dv % 2
                    a, b_ = off_to_idx[fr], off_to_idx[fc]
                    ip = ir * 2 + ic  # input phase
                    for cin in range(in_ch):
                        row = in_pos[ip, cin]
                        # the original kernel's flat index at [u, v, cin, :]
                        flat = ((u * k) + v) * in_ch + cin
                        cols = (p * 2 + q) * out_ch + np.arange(out_ch)
                        src[a, b_, row, cols] = flat * out_ch + np.arange(out_ch)
                        mask[a, b_, row, cols] = True
    return src, mask


def fold_kernel(
    kernel: torch.Tensor, in_splits: t.Optional[t.Sequence[int]] = None
) -> torch.Tensor:
    """(k, k, C, O) stride-1 odd-k conv kernel -> folded (k', k', 4C, 4O)
    kernel such that conv(fold(x), folded) == fold(conv(x, kernel)) with
    padding (k'-1)/2 in folded space (exact: the extra padded row and column
    in original space only meet structurally zero taps)."""
    k, k2, cin, cout = kernel.shape
    assert k == k2, kernel.shape
    splits = tuple(in_splits) if in_splits is not None else (cin,)
    assert sum(splits) == cin, (splits, cin)
    src, mask = _fold_gather_index(k, cin, cout, splits)
    flat = kernel.reshape(-1)
    kf = flat[torch.from_numpy(src.reshape(-1)).to(kernel.device)].reshape(src.shape)
    return torch.where(torch.from_numpy(mask).to(kernel.device), kf, torch.zeros_like(kf))


def fold_vector(v: torch.Tensor) -> torch.Tensor:
    """A per-out-channel vector (bias, BN scale) -> its folded (4O,)
    phase-major tile."""
    return v.repeat(4)


def fold_conv_transpose_2x2_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """flax ConvTranspose kernel (2, 2, Cin, Cout), stride 2 -> a folded 1x1
    conv kernel (1, 1, Cin, 4Cout): output (2i+p, 2j+q, o) = sum_c x[i, j,
    c] * K[1-p, 1-q, c, o] (non-overlapping taps, spatially flipped), so each
    output phase is a 1x1 projection of the same unfolded input pixel."""
    k = kernel.flip(0, 1).permute(2, 0, 1, 3)  # (Cin, 2, 2, Cout)
    cin = kernel.shape[2]
    return k.reshape(cin, 4 * kernel.shape[3])[None, None]


def folded_conv(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: t.Optional[torch.Tensor] = None,
    in_splits: t.Optional[t.Sequence[int]] = None,
    dtype: t.Optional[torch.dtype] = None,
) -> torch.Tensor:
    """An unfolded-parameter (k, k, C, O) stride-1 conv applied to a FOLDED
    input (B, Hf, Wf, 4C); returns the folded (B, Hf, Wf, 4O). With
    ``dtype`` the conv computes in it; the bias is added after, in the
    output's dtype."""
    kf = fold_kernel(kernel, in_splits)
    if dtype is not None:
        x = x.to(dtype)
        kf = kf.to(dtype)
    pad = (kf.shape[0] - 1) // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), kf.permute(3, 2, 0, 1), padding=pad)
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + fold_vector(bias).to(y.dtype)
    return y


def folded_batch_norm(
    y: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    epsilon: float = 1e-5,
) -> torch.Tensor:
    """Normalise a folded tensor with UNFOLDED (C,) statistics and affine
    parameters, tied across the 4 phases: exactly the unfolded BN. f32 math
    (f64 for f64), output in y's dtype."""
    yf = y.to(torch.promote_types(y.dtype, torch.float32))
    m = fold_vector(mean)
    v = fold_vector(var)
    s = fold_vector(scale)
    b = fold_vector(bias)
    out = (yf - m) * torch.rsqrt(v + epsilon) * s + b
    return out.to(y.dtype)


def folded_batch_stats(y: torch.Tensor) -> t.Tuple[torch.Tensor, torch.Tensor]:
    """Batch mean and biased variance over (B, Hf, Wf, phases) of a folded
    tensor: the unfolded batch statistics (the phase axis is spatial). f32
    (f64 for f64)."""
    b, hf, wf, c4 = y.shape
    c = c4 // 4
    yf = y.to(torch.promote_types(y.dtype, torch.float32)).reshape(b, hf, wf, 4, c)
    m = yf.mean(dim=(0, 1, 2, 3))
    v = (yf - m).square().mean(dim=(0, 1, 2, 3))
    return m, v
