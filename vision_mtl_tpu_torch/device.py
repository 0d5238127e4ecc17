"""Device selection for the port's entry points."""

from __future__ import annotations

import typing as t

import torch


def resolve_device(device: t.Union[str, torch.device] = "cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when no card is
    present: an entry point runs on the card unless the caller asks for the
    CPU explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but no CUDA device is available; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is None:  # "cuda" means the current card, as tensors say
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
