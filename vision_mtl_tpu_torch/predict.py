"""Inference/eval sweep (counterpart of ``vision_mtl_tpu/predict.py``):
run the predict-eval step over batches, collect per-batch
``{"segm","depth"}`` predictions, accumulate predict-stage metrics when
the batches carry ground truth, and optionally plot each batch's
predictions (``vis.plot_preds``) to the experiment; ``save_preds`` writes
the predictions.

Under a ``mesh`` of several ranks each rank runs its block of every batch
(its rows, and under ``spatial`` its image rows of them); the ranks'
predictions are gathered exactly and put back whole (``Mesh.gather``, as
JAX's ``replicate_gather``) and the metrics reduced, so every rank returns
the whole sweep's; rank 0 writes ``preds.npz`` (``training.py``)."""

from __future__ import annotations

import typing as t

import numpy as np
import torch
from torch import nn

from vision_mtl_tpu_torch.data.loader import prefetch_to_device
from vision_mtl_tpu_torch.device import resolve_device
from vision_mtl_tpu_torch.metrics import compute_metrics, init_metrics, reduce_metrics
from vision_mtl_tpu_torch.parallel.mesh import local_batches
from vision_mtl_tpu_torch.train.step import make_predict_eval_step


def predict(
    batches: t.Iterable[t.Mapping[str, np.ndarray]],
    model: nn.Module,
    num_classes: int,
    do_plot_preds: bool = False,
    exp: t.Any = None,
    do_show_preds: bool = False,
    loss_segm_weight: float = 1.0,
    loss_depth_weight: float = 1.0,
    device: t.Union[str, torch.device] = "cuda",
    mesh: t.Any = None,
) -> t.Tuple[t.List[t.Dict[str, np.ndarray]], t.Dict[str, float]]:
    """Returns (list of per-batch pred dicts, predict-stage metrics).

    ``batches`` yields dicts of numpy arrays: "img" (B,H,W,3) float32 or
    uint8, and optionally "mask" (B,H,W), "depth" (B,H,W,1) float32 or
    uint16, "valid" (B,) 0/1 weights of a padded final batch. Predictions of
    padded rows are dropped. Without ground truth the metrics are ``{}``.
    Batches reach the device through ``prefetch_to_device`` (two in
    flight). With ``do_plot_preds`` each batch's plot goes to ``exp`` (and
    to the screen with ``do_show_preds``); a failed plot is printed and the
    sweep goes on. Under a ``mesh`` (several ranks) ``batches`` yields this
    rank's rows, or under ``spatial`` whole batches of which the rank keeps
    its block (``mesh.local_batches``); ``device`` is its device, and only
    rank 0 plots.
    """
    comm = mesh.comm if mesh is not None and mesh.world > 1 else None
    dev = mesh.device if mesh is not None else resolve_device(device)
    step = make_predict_eval_step(
        model, loss_segm_weight=loss_segm_weight, loss_depth_weight=loss_depth_weight, mesh=mesh
    )
    mstate = init_metrics(num_classes, dev)
    preds: t.List[t.Dict[str, np.ndarray]] = []
    for batch in prefetch_to_device(local_batches(batches, mesh), dev, size=2):
        batch_preds, mstate, _ = step(batch, mstate)
        valid = batch.get("valid")
        if comm is not None:
            # every rank's block in its place: the global batch
            batch_preds = {k: mesh.gather(v) for k, v in batch_preds.items()}
            if valid is not None:
                valid = mesh.gather(valid)
        host_preds = {k: v.cpu().numpy() for k, v in batch_preds.items()}
        if valid is not None:
            n_valid = int(valid.sum())
            host_preds = {k: v[:n_valid] for k, v in host_preds.items()}
        preds.append(host_preds)
        if do_plot_preds and (comm is None or comm.rank == 0):
            try:
                from vision_mtl_tpu_torch.vis import plot_preds

                import matplotlib.pyplot as plt

                fig = plot_preds(
                    batch_size=host_preds["segm"].shape[0],
                    inputs_batch={k: v.cpu().numpy() for k, v in batch.items()},
                    preds_batch=host_preds,
                )
                if exp:
                    exp.log_figure("preds", fig)
                if do_show_preds:
                    plt.show()
                plt.close(fig)
            except Exception as e:
                print("plot failed:", e)
    if float(mstate.num_steps) == 0.0:
        return preds, {}
    mstate = reduce_metrics(mstate, comm)
    predict_metrics = {f"predict/{k}": float(v) for k, v in compute_metrics(mstate).items()}
    return preds, predict_metrics


def save_preds(preds: t.List[t.Dict[str, np.ndarray]], path: str) -> None:
    """The concatenated predictions as a compressed ``.npz`` (``segm``,
    ``depth``); nothing is written for no predictions."""
    if not preds:
        return
    np.savez_compressed(
        path,
        segm=np.concatenate([p["segm"] for p in preds], axis=0),
        depth=np.concatenate([p["depth"] for p in preds], axis=0),
    )
