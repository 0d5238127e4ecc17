"""Hand-written CUDA kernels for Hopper, one module each, beside their plain
PyTorch versions. ``KERNELS`` maps each kernel's name to its module (or, for
the gates' task-axis launches and the train gate's staged launch across
ranks, to the module's ``tasks`` or ``ranks`` entry point), whose
``SOURCE`` names its ``csrc/<SOURCE>.cu`` (two kernels may share one source)
and whose ``launches`` counter the wrapper bumps once per launch."""

from __future__ import annotations

import typing as t

from vision_mtl_tpu_torch.kernels import confmat, fused_gate, fused_gate_train, small_conv
from vision_mtl_tpu_torch.kernels._build import build

KERNELS = {
    "fused_attention_gate": fused_gate,
    "fused_attention_gate_train": fused_gate_train,
    "fused_attention_gate_tasks": fused_gate.tasks,
    "fused_attention_gate_train_tasks": fused_gate_train.tasks,
    "fused_attention_gate_train_ranks": fused_gate_train.ranks,
    "confusion_matrix": confmat,
    "conv3x3_small": small_conv,
}


def build_all() -> None:
    """Compile every kernel in parallel (one nvcc per source)."""
    build(sorted({mod.SOURCE for mod in KERNELS.values()}))


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches.reset()


def launch_counts() -> t.Dict[str, int]:
    return {name: mod.launches.value for name, mod in KERNELS.items()}
