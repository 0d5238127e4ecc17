"""Train state: the model (parameters and BatchNorm statistics) and its Adam
optimizer with a mutable learning rate (counterpart of
``vision_mtl_tpu/train/state.py``).

Where the JAX state carries params, batch_stats and opt_state as values,
the port's carries the ``nn.Module``, which holds the first two, and the
``torch.optim.Adam`` that holds the third. Both are updated in place by the
train step.
"""

from __future__ import annotations

import dataclasses
import typing as t

import torch
from torch import nn

from vision_mtl_tpu_torch.device import resolve_device


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(
    model: nn.Module,
    lr: float,
    device: t.Union[str, torch.device] = "cuda",
) -> TrainState:
    """Moves ``model`` to ``device`` (raises if that is CUDA and no card is
    present), puts it in train mode and gives it a fresh Adam with torch's
    defaults (betas 0.9/0.999, eps 1e-8). That is what
    ``optax.inject_hyperparams(optax.adam)`` computes: both add eps after
    the bias correction."""
    model = model.to(resolve_device(device)).train()
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model=model, optimizer=optimizer)


def get_lr(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def set_lr(state: TrainState, lr: float) -> TrainState:
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


def param_count(state: TrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())
