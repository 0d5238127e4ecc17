"""Confusion matrix: CUDA kernel and its plain version.

Counterpart of ``vision_mtl_tpu/ops/pallas/confmat.py``. The JAX function
takes float weights; the metric path only ever passes 0/1 per-sample
``valid`` weights, so the port takes them as a boolean ``mask`` and counts
in integers (``csrc/confmat.cu`` states the exactness bound).
:func:`confusion_matrix_plain` computes the same function with PyTorch ops
and is what runs for CPU tensors.
"""

from __future__ import annotations

import ctypes
import typing as t

import torch

from vision_mtl_tpu_torch.kernels._build import LaunchCounter, load

SOURCE = "confmat"
#: (C, C) uint32 histograms must fit a block's 48 KB of shared memory
MAX_CLASSES = 110

launches = LaunchCounter()

_SIGNATURE = (
    [ctypes.c_void_p] * 3
    + [ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_void_p] * 3
)


def confusion_matrix_plain(
    targets: torch.Tensor,
    preds: torch.Tensor,
    num_classes: int,
    mask: t.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in PyTorch ops, with int64 counts."""
    c = num_classes
    tf = targets.reshape(-1).long()
    pf = preds.reshape(-1).long()
    keep = (tf >= 0) & (tf < c) & (pf >= 0) & (pf < c)
    if mask is not None:
        keep &= mask.reshape(-1)
    idx = torch.where(keep, tf * c + pf, torch.full_like(tf, c * c))
    counts = torch.bincount(idx, minlength=c * c + 1)[: c * c]
    return counts.reshape(c, c).float()


def confusion_matrix(
    targets: torch.Tensor,
    preds: torch.Tensor,
    num_classes: int,
    mask: t.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(C, C) float32 confusion matrix (rows = target, cols = pred).

    Args:
      targets, preds: int32 tensors of any (matching) shape. Ids outside
        [0, C) add nothing.
      mask: optional bool tensor of the same shape; only samples where it is
        True count.

    CPU tensors take :func:`confusion_matrix_plain`. CUDA tensors launch the
    kernel or raise; there is no fallback.
    """
    if targets.device.type == "cpu":
        return confusion_matrix_plain(targets, preds, num_classes, mask)
    _check(targets, preds, num_classes, mask)
    c = num_classes
    n = targets.numel()
    scratch = torch.zeros(c * c + 1, dtype=torch.int32, device=targets.device)
    out = torch.empty((c, c), dtype=torch.float32, device=targets.device)
    fn = load(SOURCE, "vmtl_confusion_matrix", _SIGNATURE)
    with torch.cuda.device(targets.device):
        rc = fn(
            targets.data_ptr(), preds.data_ptr(),
            None if mask is None else mask.data_ptr(),
            n, c, scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(targets.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"confusion_matrix: kernel launch failed, CUDA error {rc}")
    launches.add()
    return out


def _check(targets, preds, num_classes, mask) -> None:
    tensors = {"targets": targets, "preds": preds}
    if mask is not None:
        tensors["mask"] = mask
    for name, v in tensors.items():
        if v.device != targets.device or v.device.type != "cuda":
            raise ValueError(
                f"confusion_matrix: {name} is on {v.device}; the kernel takes "
                f"CUDA tensors on one device (targets is on {targets.device})"
            )
        if not v.is_contiguous():
            raise ValueError(f"confusion_matrix: {name} is not contiguous")
        if v.shape != targets.shape:
            raise ValueError(
                f"confusion_matrix: {name} has shape {tuple(v.shape)}, targets "
                f"{tuple(targets.shape)}"
            )
    if targets.dtype != torch.int32 or preds.dtype != torch.int32:
        raise TypeError(
            f"confusion_matrix: targets and preds must be int32, got "
            f"{targets.dtype} and {preds.dtype}"
        )
    if mask is not None and mask.dtype != torch.bool:
        raise TypeError(f"confusion_matrix: mask must be bool, got {mask.dtype}")
    if not 0 < num_classes <= MAX_CLASSES:
        raise ValueError(
            f"confusion_matrix: the kernel takes 1..{MAX_CLASSES} classes, "
            f"got {num_classes}"
        )
