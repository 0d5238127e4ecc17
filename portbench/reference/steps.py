"""The reference's training steps and served outputs.

Training: mean softmax cross-entropy over every pixel plus the
scale-invariant log loss (Eigen et al., 2014; ``10 sqrt(Var_unbiased(g) +
0.15 mean(g)^2)``, g = log pred - log target over pixels whose target
exceeds 1e-3), weighted 1:1 as the configuration states, back-propagated
and stepped by ``torch.optim.Adam`` (betas 0.9/0.999, eps 1e-8); the
confusion matrix of each step's argmax by ``torch.bincount``. Serving: the
eval-mode forward's logits and sigmoid depth.

Float32 with TF32 off, so that no product rounds below float32.
"""

from __future__ import annotations

import contextlib
import typing as t

import torch
from torch import nn

Batch = t.Dict[str, torch.Tensor]

MIN_DEPTH = 1e-3


@contextlib.contextmanager
def full_f32() -> t.Iterator[None]:
    """TF32 off for matrix products and convolutions, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def decode(batch: Batch, device: torch.device) -> Batch:
    """Wire format to float32: uint8 images / 255, uint16 depth / 65535."""
    img = batch["img"].to(device)
    out = {"img": img.float() / 255.0 if img.dtype == torch.uint8 else img.float()}
    if "mask" in batch:
        out["mask"] = batch["mask"].to(device).long()
    if "depth" in batch:
        d = batch["depth"].to(device)
        out["depth"] = d.float() / 65535.0 if d.dtype == torch.uint16 else d.float()
    return out


def losses(segm_logits: torch.Tensor, depth_pred: torch.Tensor, mask: torch.Tensor,
           depth: torch.Tensor, w_segm: float, w_depth: float) -> t.Dict[str, torch.Tensor]:
    ce = torch.nn.functional.cross_entropy(segm_logits.permute(0, 3, 1, 2), mask)
    valid = depth > MIN_DEPTH
    g = torch.log(depth_pred.clamp(min=1e-12)[valid]) - torch.log(depth[valid])
    silog = 10.0 * torch.sqrt(torch.clamp(g.var() + 0.15 * g.mean() ** 2, min=0.0))
    return {"loss": w_segm * ce + w_depth * silog, "loss_segm": ce, "loss_depth": silog}


def confusion_matrix(mask: torch.Tensor, pred: torch.Tensor, classes: int) -> torch.Tensor:
    """(classes, classes) counts, rows the target, columns the prediction."""
    idx = mask.reshape(-1) * classes + pred.reshape(-1)
    return torch.bincount(idx, minlength=classes * classes).reshape(classes, classes)


def train_steps(model: nn.Module, batches: t.Sequence[Batch], lr: float, w_segm: float,
                w_depth: float, classes: int, device: torch.device) -> t.Dict[str, t.Any]:
    """Adam steps of ``model`` (train mode), one on each batch in turn.
    Returns each step's loss, each parameter's gradient norm at the first
    step, each parameter's norm of change after the last step, and the
    first step's confusion matrix."""
    model.train()
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    out: t.Dict[str, t.Any] = {"loss": []}
    with full_f32():
        for i, raw in enumerate(batches):
            b = decode(raw, device)
            opt.zero_grad(set_to_none=True)
            pred = model(b["img"])
            depth_pred = torch.sigmoid(pred["depth"])
            ls = losses(pred["segm"], depth_pred, b["mask"], b["depth"], w_segm, w_depth)
            ls["loss"].backward()
            out["loss"].append(float(ls["loss"].detach()))
            if i == 0:
                out["grad_norm"] = {k: float(p.grad.norm()) for k, p in params.items()}
                out["confmat"] = confusion_matrix(
                    b["mask"], pred["segm"].detach().argmax(-1), classes).cpu()
            del pred, depth_pred, ls
            opt.step()
    out["change_norm"] = {k: float((p.detach() - start[k]).norm()) for k, p in params.items()}
    return out


@torch.no_grad()
def serve_outputs(model: nn.Module, frames: torch.Tensor, device: torch.device,
                  block: int = 16) -> t.Tuple[torch.Tensor, torch.Tensor]:
    """The eval-mode forward on uint8 NHWC ``frames``, ``block`` at a time:
    ``(segm logits (N, H, W, C), depth (N, H, W))`` on the host."""
    model.eval()
    logits, depth = [], []
    with full_f32():
        for i in range(0, frames.shape[0], block):
            out = model(decode({"img": frames[i:i + block]}, device)["img"])
            logits.append(out["segm"].cpu())
            depth.append(torch.sigmoid(out["depth"][..., 0]).cpu())
    return torch.cat(logits), torch.cat(depth)
