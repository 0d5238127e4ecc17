"""Inference helpers (counterpart of ``vision_mtl_tpu/utils/inference.py``)."""

from __future__ import annotations

import typing as t

import torch


def get_segm_preds(
    valid_mask: torch.Tensor,
    segm_logits: torch.Tensor,
    num_classes: t.Optional[int] = None,
) -> t.Tuple[torch.Tensor, torch.Tensor]:
    """Softmax probabilities and argmax predictions restricted to a validity
    mask; invalid pixels get probability 0 and class -1. Works on tensors
    of any device.

    Args:
      valid_mask: (B, H, W) bool.
      segm_logits: (B, H, W, C) float (NHWC).
    Returns (probs (B,H,W,C) float32, preds (B,H,W) int32).
    """
    del num_classes  # taken from the logits; kept for the signature
    valid_mask = valid_mask.to(torch.bool)
    probs = torch.softmax(segm_logits.to(torch.float32), dim=-1)
    probs = torch.where(valid_mask[..., None], probs, torch.zeros((), dtype=probs.dtype,
                                                                   device=probs.device))
    preds = torch.where(valid_mask, torch.argmax(probs, dim=-1).to(torch.int32),
                        torch.full((), -1, dtype=torch.int32, device=probs.device))
    return probs, preds
