"""Visualisation (counterpart of ``vision_mtl_tpu/vis.py``): matplotlib
grids of predictions and annotated masks over NHWC numpy arrays (or CPU
tensors).

matplotlib is optional and imported inside the functions, behind the JAX
package's backend switch: Agg unless ``DISPLAY`` is exactly ``":0"``.
"""

from __future__ import annotations

import os
import typing as t

import numpy as np

from vision_mtl_tpu_torch.cfg import cfg


def _pyplot() -> t.Any:
    """``matplotlib.pyplot``, on Agg unless ``DISPLAY`` is ``":0"``."""
    if os.environ.get("DISPLAY", "") != ":0":
        import matplotlib

        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(x: t.Any) -> np.ndarray:
    return np.asarray(x)


def _img(x: t.Any) -> np.ndarray:
    """Image to float [0,1], decoding the compact wire format (uint8)."""
    arr = np.asarray(x)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    return np.clip(arr, 0, 1)


def _depth(x: t.Any) -> np.ndarray:
    """Depth to float, decoding the compact wire format (uint16)."""
    arr = np.asarray(x)
    if arr.dtype == np.uint16:
        arr = arr.astype(np.float32) / 65535.0
    return arr


def colorize_mask(mask: np.ndarray, palette: t.Optional[np.ndarray] = None) -> np.ndarray:
    """(H,W) ids -> (H,W,3) uint8 in the config's palette; ids outside it are
    clipped to its ends."""
    if palette is None:
        palette = cfg.vis.rgb_palette
    mask = _np(mask).astype(np.int64)
    mask = np.clip(mask, 0, len(palette) - 1)
    return palette[mask].astype(np.uint8)


def plot_sample(img: np.ndarray, mask: np.ndarray, depth: np.ndarray) -> t.Any:
    """1x3 grid: image / mask / depth."""
    plt = _pyplot()
    fig, axs = plt.subplots(1, 3, figsize=(12, 4))
    axs[0].imshow(_img(img))
    axs[0].set_title("img")
    axs[1].imshow(colorize_mask(mask))
    axs[1].set_title("mask")
    axs[2].imshow(_depth(depth).squeeze(), cmap="viridis")
    axs[2].set_title("depth")
    for ax in axs:
        ax.axis("off")
    fig.tight_layout()
    return fig


def plot_batch(batch: t.Mapping[str, np.ndarray], max_rows: int = 4) -> t.Any:
    """B x 3 grid over a batch dict (at most ``max_rows`` rows)."""
    plt = _pyplot()
    imgs, masks, depths = batch["img"], batch["mask"], batch["depth"]
    n = min(len(imgs), max_rows)
    fig, axs = plt.subplots(n, 3, figsize=(12, 4 * n), squeeze=False)
    for i in range(n):
        axs[i][0].imshow(_img(imgs[i]))
        axs[i][1].imshow(colorize_mask(masks[i]))
        axs[i][2].imshow(_depth(depths[i]).squeeze(), cmap="viridis")
        for ax in axs[i]:
            ax.axis("off")
    fig.tight_layout()
    return fig


def plot_annotated_segm_mask(
    img: np.ndarray,
    mask: np.ndarray,
    class_names: t.Sequence[str],
    alpha: float = 0.5,
) -> t.Any:
    """The mask's palette over the image, with a legend of the classes
    present."""
    plt = _pyplot()
    import matplotlib.patches as mpatches

    mask = _np(mask).astype(np.int64)
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.imshow(_img(img))
    ax.imshow(colorize_mask(mask), alpha=alpha)
    present = np.unique(mask)
    palette = cfg.vis.rgb_palette
    # the legend clips ids as the overlay does, so an id of -1 or 255 gets
    # the colour its pixels were painted in
    handles = [
        mpatches.Patch(
            color=palette[int(np.clip(c, 0, len(palette) - 1))] / 255.0,
            label=class_names[c] if 0 <= c < len(class_names) else str(c),
        )
        for c in present
    ]
    ax.legend(handles=handles, bbox_to_anchor=(1.02, 1), loc="upper left")
    ax.axis("off")
    fig.tight_layout()
    return fig


def plot_preds(
    batch_size: int,
    inputs_batch: t.Mapping[str, np.ndarray],
    preds_batch: t.Mapping[str, np.ndarray],
) -> t.Any:
    """B x 5 grid: RGB / GT depth / pred depth / GT mask / pred mask, the
    plot of each validation epoch's benchmark batch and of the predict
    sweep."""
    plt = _pyplot()
    imgs = _img(inputs_batch["img"])
    gt_depth = _depth(inputs_batch["depth"]) if "depth" in inputs_batch else None
    gt_mask = _np(inputs_batch["mask"]) if "mask" in inputs_batch else None
    pred_depth = _depth(preds_batch["depth"])
    pred_mask = _np(preds_batch["segm"])

    n = min(batch_size, len(imgs), len(pred_mask))
    fig, axs = plt.subplots(n, 5, figsize=(18, 3 * n), squeeze=False)
    titles = ["img", "gt depth", "pred depth", "gt mask", "pred mask"]
    for i in range(n):
        axs[i][0].imshow(imgs[i])
        if gt_depth is not None:
            axs[i][1].imshow(gt_depth[i].squeeze(), cmap="viridis")
        axs[i][2].imshow(pred_depth[i].squeeze(), cmap="viridis")
        if gt_mask is not None:
            axs[i][3].imshow(colorize_mask(gt_mask[i]))
        axs[i][4].imshow(colorize_mask(pred_mask[i]))
        for j, ax in enumerate(axs[i]):
            if i == 0:
                ax.set_title(titles[j])
            ax.axis("off")
    fig.tight_layout()
    return fig


def convert_figure_to_image(fig: t.Any) -> np.ndarray:
    """The figure rasterised to an (H,W,3) uint8 RGB array."""
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3]
