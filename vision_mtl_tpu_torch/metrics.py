"""Streaming metrics as additive accumulators on the device (counterpart of
``vision_mtl_tpu/metrics.py``).

  * Accuracy (micro): correct / total over all pixels.
  * JaccardIndex: per-class IoU from the confusion matrix; classes with an
    empty union score 0 and ARE included in the unweighted mean.
  * FBetaScore (beta=1, weighted by target support), 0/0 -> 0.
  * MeanAbsoluteError: sum |pred - target| / count.

The confusion matrix of each update goes through the CUDA kernel
(``kernels/confmat.py``), which counts in integers: exact up to 2^32 - 1
pixels per cell in one update, beyond the 2^31 that the JAX package
promises. The cross-batch accumulation is f32, as there: exact until a
cell's total passes 2^24, then rounded with relative error <= 2^-24.

Under several ranks each rank accumulates its own rows, and
:func:`reduce_metrics` makes the state global: the ranks' confusion counts
and pixel counts summed exactly, the absolute-error sums in f64. The loss
sums and the step count stay as they are: every step's losses are already
the global batch's (``losses.py``), the same on every rank.
"""

from __future__ import annotations

import dataclasses
import typing as t

import torch

from vision_mtl_tpu_torch.device import resolve_device
from vision_mtl_tpu_torch.kernels.confmat import confusion_matrix


@dataclasses.dataclass
class MetricState:
    """Additive metric accumulators. Merging two states = adding fields."""

    confmat: torch.Tensor  # (C, C) f32 counts; [target, pred]
    mae_sum: torch.Tensor  # scalar f32
    mae_count: torch.Tensor
    loss_sum: torch.Tensor
    loss_segm_sum: torch.Tensor
    loss_depth_sum: torch.Tensor
    num_steps: torch.Tensor

    @property
    def num_classes(self) -> int:
        return self.confmat.shape[0]


def init_metrics(num_classes: int, device: t.Union[str, torch.device] = "cuda") -> MetricState:
    device = resolve_device(device)

    def z() -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=device)

    return MetricState(
        confmat=torch.zeros((num_classes, num_classes), dtype=torch.float32, device=device),
        mae_sum=z(),
        mae_count=z(),
        loss_sum=z(),
        loss_segm_sum=z(),
        loss_depth_sum=z(),
        num_steps=z(),
    )


def update_metrics(
    state: MetricState,
    segm_preds: torch.Tensor,
    gt_mask: torch.Tensor,
    depth_preds: torch.Tensor,
    gt_depth: torch.Tensor,
    losses: t.Optional[t.Dict[str, torch.Tensor]] = None,
    valid: t.Optional[torch.Tensor] = None,
) -> MetricState:
    """Accumulate one batch; returns a new state.

    Args:
      segm_preds: (B, H, W) int argmax class predictions.
      gt_mask: (B, H, W) int targets.
      depth_preds: (B, H, W, 1) float depth predictions.
      gt_depth: (B, H, W, 1) float depth targets.
      losses: optional {"loss","loss_segm","loss_depth"} scalars.
      valid: optional (B,) per-sample 0/1 weights (padded final batches);
        padded samples contribute nothing to any accumulator.
    """
    b, h, w = gt_mask.shape[:3]
    px_mask = None
    if valid is not None:
        px_mask = (valid > 0)[:, None, None].expand(b, h, w).contiguous()
    cm = confusion_matrix(
        gt_mask.to(torch.int32).contiguous(),
        segm_preds.to(torch.int32).contiguous(),
        state.num_classes,
        px_mask,
    )

    abs_err = torch.abs(depth_preds.float() - gt_depth.float())
    depth_px = abs_err.numel() // b
    if valid is None:
        mae_add = abs_err.sum()
        mae_cnt = float(abs_err.numel())
    else:
        vf = valid.float()
        mae_add = (abs_err.reshape(b, -1) * vf[:, None]).sum()
        mae_cnt = vf.sum() * depth_px
    losses = losses or {}
    zero = torch.zeros((), dtype=torch.float32, device=cm.device)
    return MetricState(
        confmat=state.confmat + cm,
        mae_sum=state.mae_sum + mae_add,
        mae_count=state.mae_count + mae_cnt,
        loss_sum=state.loss_sum + losses.get("loss", zero),
        loss_segm_sum=state.loss_segm_sum + losses.get("loss_segm", zero),
        loss_depth_sum=state.loss_depth_sum + losses.get("loss_depth", zero),
        num_steps=state.num_steps + 1.0,
    )


def compute_metrics(state: MetricState) -> t.Dict[str, torch.Tensor]:
    """Finalize accumulators into the reference's metric dict."""
    cm = state.confmat
    total = torch.clamp(cm.sum(), min=1.0)
    tp = torch.diagonal(cm)
    support = cm.sum(dim=1)  # target counts per class (rows = target)
    pred_count = cm.sum(dim=0)

    accuracy = tp.sum() / total

    union = support + pred_count - tp
    iou = torch.where(union > 0, tp / torch.clamp(union, min=1.0), 0.0)
    jaccard = iou.mean()  # absent classes score 0 and are included

    precision = torch.where(pred_count > 0, tp / torch.clamp(pred_count, min=1.0), 0.0)
    recall = torch.where(support > 0, tp / torch.clamp(support, min=1.0), 0.0)
    denom = precision + recall
    f1 = torch.where(
        denom > 0, 2.0 * precision * recall / torch.clamp(denom, min=1e-12), 0.0
    )
    fbeta = (support / total * f1).sum()

    mae = state.mae_sum / torch.clamp(state.mae_count, min=1.0)
    steps = torch.clamp(state.num_steps, min=1.0)
    return {
        "accuracy": accuracy,
        "jaccard_index": jaccard,
        "fbeta_score": fbeta,
        "mae": mae,
        "loss": state.loss_sum / steps,
        "loss_segm": state.loss_segm_sum / steps,
        "loss_depth": state.loss_depth_sum / steps,
    }


def merge_metrics(a: MetricState, b: MetricState) -> MetricState:
    """Combine two accumulator states (e.g., across processes)."""
    return MetricState(
        **{f.name: getattr(a, f.name) + getattr(b, f.name) for f in dataclasses.fields(a)}
    )


def reduce_metrics(state: MetricState, comm: t.Any) -> MetricState:
    """The state of every rank's rows together, the same on every rank
    (``comm``: ``parallel.multihost.Comm``; None or one rank returns
    ``state``). Collective: every rank calls it at the same point."""
    if comm is None or comm.world <= 1:
        return state
    summed = torch.cat([state.confmat.reshape(-1), state.mae_sum.reshape(1),
                        state.mae_count.reshape(1)]).double()
    summed = comm.all_reduce_(summed).float()
    c = state.num_classes
    return dataclasses.replace(
        state,
        confmat=summed[: c * c].reshape(c, c),
        mae_sum=summed[c * c],
        mae_count=summed[c * c + 1],
    )


def rank_part(state: MetricState, comm: t.Any) -> MetricState:
    """The part of a reduced ``state`` this rank carries so that
    :func:`reduce_metrics` of the ranks' parts gives ``state`` back: rank 0
    keeps it, the other ranks zero the summed fields (a resumed epoch's
    accumulators restored on every rank)."""
    if comm is None or comm.world <= 1 or comm.rank == 0:
        return state
    return dataclasses.replace(
        state,
        confmat=torch.zeros_like(state.confmat),
        mae_sum=torch.zeros_like(state.mae_sum),
        mae_count=torch.zeros_like(state.mae_count),
    )
