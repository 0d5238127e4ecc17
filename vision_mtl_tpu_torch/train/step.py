"""Inference steps (counterpart of the predict part of
``vision_mtl_tpu/train/step.py``).

A step is a plain function over tensors already on the model's device; the
model carries its own weights. Steps run under ``torch.inference_mode`` and
return without synchronising: reading a result on the host is the sync.
"""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from vision_mtl_tpu_torch.losses import mtl_loss
from vision_mtl_tpu_torch.metrics import MetricState, update_metrics

Batch = t.Dict[str, torch.Tensor]


def decode_batch(batch: Batch) -> Batch:
    """Device-side decode of the compact wire format: uint8 images /255,
    uint16 depth /65535, masks to int32."""
    out = dict(batch)
    if batch["img"].dtype == torch.uint8:
        out["img"] = batch["img"].float() / 255.0
    if "depth" in batch and batch["depth"].dtype == torch.uint16:
        out["depth"] = batch["depth"].float() / 65535.0
    if "mask" in batch and batch["mask"].dtype != torch.int32:
        out["mask"] = batch["mask"].to(torch.int32)
    return out


def postprocess_raw_out(out: t.Dict[str, torch.Tensor]) -> t.Dict[str, torch.Tensor]:
    """argmax for segm (int32), sigmoid in f32 for depth."""
    segm_logits = out["segm"]
    return {
        "segm_logits": segm_logits,
        "segm_predictions": torch.argmax(segm_logits, dim=-1).to(torch.int32),
        "depth_predictions": torch.sigmoid(out["depth"].float()),
    }


def make_predict_step(model: nn.Module) -> t.Callable[[torch.Tensor], Batch]:
    """Returns ``step(img) -> {"segm": argmax ids, "depth": sigmoid depths}``;
    a uint8 image is normalised on the device."""

    @torch.inference_mode()
    def step(img: torch.Tensor) -> Batch:
        if img.dtype == torch.uint8:
            img = img.float() / 255.0
        post = postprocess_raw_out(model(img))
        return {"segm": post["segm_predictions"], "depth": post["depth_predictions"]}

    return step


def make_predict_eval_step(
    model: nn.Module,
    loss_segm_weight: float = 1.0,
    loss_depth_weight: float = 1.0,
) -> t.Callable[[Batch, MetricState], t.Tuple[Batch, MetricState, t.Dict[str, torch.Tensor]]]:
    """Returns ``step(batch, mstate) -> (preds, mstate, losses)``: one pass
    that returns predictions and, when the batch has ground truth ("mask"
    and "depth"), its losses and the metric state updated with it."""

    @torch.inference_mode()
    def step(batch: Batch, mstate: MetricState):
        batch = decode_batch(batch)
        post = postprocess_raw_out(model(batch["img"]))
        preds = {"segm": post["segm_predictions"], "depth": post["depth_predictions"]}
        if "mask" not in batch or "depth" not in batch:
            return preds, mstate, {}
        valid = batch.get("valid")
        losses = mtl_loss(
            post["segm_logits"],
            post["depth_predictions"],
            batch["mask"],
            batch["depth"],
            loss_segm_weight,
            loss_depth_weight,
            valid=valid,
        )
        mstate = update_metrics(
            mstate,
            post["segm_predictions"],
            batch["mask"],
            post["depth_predictions"],
            batch["depth"],
            losses,
            valid=valid,
        )
        return preds, mstate, losses

    return step
