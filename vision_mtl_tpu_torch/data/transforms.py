"""Host-side resizes executed by the input pipeline (counterpart of
``vision_mtl_tpu/data/transforms.py``), on CPU tensors and without PIL.

Bilinear is ``F.interpolate(mode="bilinear", align_corners=False,
antialias=True)``: a triangle filter over pixel centres that widens with the
scale on a downscale and renormalises at the borders, which is PIL's
``BILINEAR`` both ways, within 1e-5 of the largest input magnitude (an
output one pixel wide differs more). Nearest takes PIL's ``NEAREST`` source pixels:
PIL steps the source coordinate by in/out in float64, starting at half a
step, and truncates. ``F.interpolate(mode="nearest-exact")`` computes the
same coordinate as a product and picks the next pixel where that lands on
an integer (64 to 25 columns: column 12), so it is not used. An array
already at the target size is returned as it is.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vision_mtl_tpu_torch.cfg import ResizeSpec


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """PIL's nearest source index per output pixel: a float64 running sum
    of in/out steps from half a step, truncated."""
    step = n_in / n_out
    coord = np.add.accumulate(np.concatenate([[step * 0.5], np.full(n_out - 1, step)]))
    return np.minimum(coord.astype(np.int64), n_in - 1)


def _resize2d(arr: np.ndarray, h: int, w: int, bilinear: bool) -> np.ndarray:
    """(H, W) array to (h, w). Bilinear computes in float32 and returns
    float32; nearest returns the input's dtype."""
    if arr.shape[0] == h and arr.shape[1] == w:
        return arr
    if bilinear:
        x = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))[None, None]
        out = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=True)
        return out[0, 0].numpy()
    rows, cols = _nearest_index(arr.shape[0], h), _nearest_index(arr.shape[1], w)
    return np.ascontiguousarray(arr[rows[:, None], cols[None, :]])


def resize_image(img: np.ndarray, spec: ResizeSpec) -> np.ndarray:
    """(H, W, 3) image, bilinear, per channel in float32."""
    if img.shape[0] == spec.height and img.shape[1] == spec.width:
        return img
    chans = [_resize2d(img[..., c], spec.height, spec.width, True) for c in range(img.shape[-1])]
    return np.stack(chans, axis=-1)


def resize_mask(mask: np.ndarray, spec: ResizeSpec, bilinear: bool = False) -> np.ndarray:
    """(H, W) labels. Nearest by default; ``bilinear=True`` is NYUv2's
    antialiased label resize (float32 out). int64 ids come back as int32,
    as the JAX package's do."""
    if mask.shape[0] == spec.height and mask.shape[1] == spec.width:
        return mask
    if bilinear:
        return _resize2d(mask, spec.height, spec.width, True)
    if mask.dtype == np.int64:
        mask = mask.astype(np.int32)
    return _resize2d(mask, spec.height, spec.width, False)


def resize_depth(depth: np.ndarray, spec: ResizeSpec, bilinear: bool = False) -> np.ndarray:
    """(H, W) or (H, W, 1) depth, float32 out. Nearest for Cityscapes,
    bilinear for NYUv2."""
    squeeze = depth.ndim == 3
    d2 = depth[..., 0] if squeeze else depth
    out = _resize2d(d2.astype(np.float32), spec.height, spec.width, bilinear)
    return out[..., None] if squeeze else out
