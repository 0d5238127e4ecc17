"""Task losses (counterpart of ``vision_mtl_tpu/losses.py``).

  * Segmentation: mean softmax cross-entropy over all pixels (over the valid
    samples only when ``valid`` weights are given).
  * Depth: SILog, 10*sqrt(Var_unbiased(g) + 0.15*mean(g)^2) over masked
    pixels, g = log(pred) - log(target), mask = target > min_depth AND valid.
  * Combined: w_segm * CE + w_depth * SILog.

All math is f32 for bf16 and f32 inputs, and f64 for f64 inputs.

Inside ``parallel.multihost.global_batch`` (a step under a mesh of several
ranks) both losses are those of every rank's rows together, as the JAX
losses over a batch sharded on the ``data`` axis: the cross-entropy's sum
and count, and SILog's n, sum of g and then sum of (g - mean)^2, are summed
over the ranks (``all_reduce_sum``, whose backward sums too). Every rank
then holds the same loss; the train step back-propagates ``1 / world`` of
it on each rank and sums the gradients (``train/step.py``).
"""

from __future__ import annotations

import typing as t

import torch

from vision_mtl_tpu_torch.parallel.multihost import all_reduce_sum, batch_comm


def _at_least_f32(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    valid: t.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean softmax cross-entropy.

    Args:
      logits: (B, H, W, C) float.
      labels: (B, H, W) int class ids in [0, C).
      valid: optional (B,) per-sample weights; the mean is taken over valid
        samples only.
    """
    logits = logits.to(_at_least_f32(logits))
    c = logits.shape[-1]
    lse = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    # a label outside [0, C) selects nothing, as the JAX one-hot does (and
    # never indexes out of bounds)
    in_range = (labels >= 0) & (labels < c)
    picked = torch.gather(logits, -1, labels.clamp(0, c - 1).unsqueeze(-1)).squeeze(-1)
    nll = lse - picked * in_range
    comm = batch_comm()
    if valid is None:
        if comm is None:
            return nll.mean()
        num, count = nll.sum(), torch.tensor(float(nll.numel()), dtype=nll.dtype)
    else:
        w = valid.to(nll.dtype)[:, None, None]
        num, count = (nll * w).sum(), w.sum() * nll.shape[1] * nll.shape[2]
    if comm is not None:
        num, count = all_reduce_sum(torch.stack([num, count.to(num.device)]), comm).unbind(0)
    return num / torch.clamp(count, min=1.0)


def silog_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: t.Optional[torch.Tensor] = None,
    min_depth: float = 1e-3,
    valid: t.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scale-invariant log loss with validity masking.

    Args:
      pred: (B, H, W, 1) strictly-positive depth predictions (post-sigmoid).
      target: (B, H, W, 1) ground-truth depth.
      mask: optional boolean validity mask; defaults to target > min_depth.
      valid: optional (B,) per-sample weights, AND-ed into the mask.
    """
    pred = pred.to(_at_least_f32(pred))
    target = target.to(pred.dtype)
    if mask is None:
        mask = target > min_depth
    if valid is not None:
        mask = mask & (valid > 0).reshape((-1,) + (1,) * (mask.dim() - 1))
    comm = batch_comm()
    n = mask.to(pred.dtype).sum()
    one = torch.ones((), device=pred.device)
    safe_target = torch.where(mask, target, one)
    safe_pred = torch.where(mask, torch.clamp(pred, min=1e-12), one)
    g = torch.where(mask, torch.log(safe_pred) - torch.log(safe_target), 0.0)
    sum_g = g.sum()
    if comm is not None:
        n, sum_g = all_reduce_sum(torch.stack([n, sum_g]), comm).unbind(0)
    mean_g = sum_g / torch.clamp(n, min=1.0)
    # unbiased variance (torch.var default) with masked denominator n-1
    sq = torch.where(mask, (g - mean_g) ** 2, 0.0).sum()
    if comm is not None:
        sq = all_reduce_sum(sq, comm)
    var_g = sq / torch.clamp(n - 1.0, min=1.0)
    dg = var_g + 0.15 * mean_g**2
    return 10.0 * torch.sqrt(torch.clamp(dg, min=0.0))


def mtl_loss(
    segm_logits: torch.Tensor,
    depth_pred: torch.Tensor,
    gt_mask: torch.Tensor,
    gt_depth: torch.Tensor,
    loss_segm_weight: float = 1.0,
    loss_depth_weight: float = 1.0,
    valid: t.Optional[torch.Tensor] = None,
) -> t.Dict[str, torch.Tensor]:
    """Weighted MTL objective; returns {"loss","loss_segm","loss_depth"}."""
    loss_segm = cross_entropy_loss(segm_logits, gt_mask, valid=valid)
    loss_depth = silog_loss(depth_pred, gt_depth, valid=valid)
    loss = loss_segm_weight * loss_segm + loss_depth_weight * loss_depth
    return {"loss": loss, "loss_segm": loss_segm, "loss_depth": loss_depth}
