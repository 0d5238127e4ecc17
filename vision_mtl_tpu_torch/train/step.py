"""Train, eval and predict steps (counterpart of
``vision_mtl_tpu/train/step.py``).

A step is a plain function over tensors; the model carries its own weights
and BatchNorm statistics, the train state its optimizer. The train step is
decode -> train-mode forward -> postprocess -> losses -> backward -> Adam
step -> metric update; it runs with autograd on. The eval and predict steps
run under ``torch.inference_mode``. Each step sets the model's mode for its
own forward and restores it after. Steps return without synchronising:
reading a result on the host is the sync.

Given a ``mesh`` of several ranks (``parallel/mesh.py``: the ``data`` and
``spatial`` axes), each rank's step takes its own block of the global
batch (its rows, and under ``spatial`` its image rows of them) and runs
inside ``multihost.global_batch``: train-mode batch statistics and the
losses are the global batch's. Under ``spatial`` the forward also runs
inside ``halo.spatial_rows`` with the rank's spatial group, where the
convolutions take their halo rows from the neighbouring ranks. The train
step back-propagates ``1 / world`` of the global loss on every rank and
then sums the gradients over the ranks, once per step, in one flat buffer,
before Adam: every rank's parameters and Adam moments stay bit for bit
equal. The metric states stay per rank until ``metrics.reduce_metrics``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import typing as t

import torch
from torch import nn

from vision_mtl_tpu_torch.device import resolve_device
from vision_mtl_tpu_torch.losses import mtl_loss
from vision_mtl_tpu_torch.metrics import MetricState, update_metrics
from vision_mtl_tpu_torch.parallel.halo import spatial_rows
from vision_mtl_tpu_torch.parallel.mesh import check_rows
from vision_mtl_tpu_torch.parallel.multihost import Comm, global_batch
from vision_mtl_tpu_torch.train.state import TrainState

Batch = t.Dict[str, torch.Tensor]
Losses = t.Dict[str, torch.Tensor]


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


def _at_least_f32(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def postprocess_raw_out(out: t.Dict[str, torch.Tensor]) -> t.Dict[str, torch.Tensor]:
    """argmax for segm (int32), sigmoid in f32 (f64 for f64) for depth."""
    segm_logits = out["segm"]
    return {
        "segm_logits": segm_logits,
        "segm_predictions": torch.argmax(segm_logits, dim=-1).to(torch.int32),
        "depth_predictions": torch.sigmoid(out["depth"].to(_at_least_f32(out["depth"]))),
    }


def make_predict_step(model: nn.Module, mesh: t.Any = None) -> t.Callable[[torch.Tensor], Batch]:
    """Returns ``step(img) -> {"segm": argmax ids, "depth": sigmoid depths}``:
    an eval-mode forward (running statistics, which stay as they are); a
    uint8 image is normalised on the device. Under a ``mesh`` with a
    ``spatial`` axis, ``img`` is this rank's block and so is the answer."""

    @torch.inference_mode()
    def step(img: torch.Tensor) -> Batch:
        with _mode(model, False), _rows(mesh, model, img):
            return predict_outputs(model, img)

    return step


def predict_outputs(model: nn.Module, img: torch.Tensor) -> Batch:
    """The predict function in the model's current mode: a uint8 image
    normalised, the forward, argmax ids and sigmoid depth. Shared by
    :func:`make_predict_step` and the exported program
    (``serving.export_model``)."""
    if img.dtype == torch.uint8:
        img = img.float() / 255.0
    post = postprocess_raw_out(model(img))
    return {"segm": post["segm_predictions"], "depth": post["depth_predictions"]}


def _losses(post: Batch, batch: Batch, loss_segm_weight: float, loss_depth_weight: float) -> Losses:
    return mtl_loss(
        post["segm_logits"],
        post["depth_predictions"],
        batch["mask"],
        batch["depth"],
        loss_segm_weight,
        loss_depth_weight,
        valid=batch.get("valid"),
    )


def _update(mstate: MetricState, post: Batch, batch: Batch, losses: Losses) -> MetricState:
    return update_metrics(
        mstate,
        post["segm_predictions"],
        batch["mask"],
        post["depth_predictions"],
        batch["depth"],
        losses,
        valid=batch.get("valid"),
    )


def _comm(mesh: t.Any) -> t.Optional[Comm]:
    """The mesh's ranks when there are several, else None."""
    return mesh.comm if mesh is not None and mesh.world > 1 else None


def _rows(mesh: t.Any, model: nn.Module, img: torch.Tensor) -> t.ContextManager[None]:
    """The forward's ``spatial_rows`` context: the mesh's spatial group,
    once the image's height (``img`` holds this rank's rows) is checked to
    split over it at every level of ``model`` (``mesh.check_rows``)."""
    rows = mesh.spatial_comm if mesh is not None else None
    if rows is not None:
        check_rows(img.shape[1] * rows.world, rows.world, model.row_stride,
                   type(model).__name__)
    return spatial_rows(rows)


def make_predict_eval_step(
    model: nn.Module,
    loss_segm_weight: float = 1.0,
    loss_depth_weight: float = 1.0,
    mesh: t.Any = None,
) -> t.Callable[[Batch, MetricState], t.Tuple[Batch, MetricState, Losses]]:
    """Returns ``step(batch, mstate) -> (preds, mstate, losses)``: one
    eval-mode pass that returns predictions and, when the batch has ground
    truth ("mask" and "depth"), its losses (the global batch's under a
    ``mesh``) and the metric state updated with it."""
    comm = _comm(mesh)

    @torch.inference_mode()
    def step(batch: Batch, mstate: MetricState):
        batch = decode_batch(batch)
        with _mode(model, False), _rows(mesh, model, batch["img"]):
            post = postprocess_raw_out(model(batch["img"]))
        preds = {"segm": post["segm_predictions"], "depth": post["depth_predictions"]}
        if "mask" not in batch or "depth" not in batch:
            return preds, mstate, {}
        with global_batch(comm):
            losses = _losses(post, batch, loss_segm_weight, loss_depth_weight)
        return preds, _update(mstate, post, batch, losses), losses

    return step


@contextlib.contextmanager
def _mode(model: nn.Module, train: bool) -> t.Iterator[None]:
    was = model.training
    model.train(train)
    try:
        yield
    finally:
        model.train(was)


def _to_device(batch: Batch, dev: torch.device) -> Batch:
    return decode_batch({k: v.to(dev, non_blocking=True) for k, v in batch.items()})


def make_train_step(
    loss_segm_weight: float = 1.0,
    loss_depth_weight: float = 1.0,
    grad_accum_steps: int = 1,
    device: t.Union[str, torch.device] = "cuda",
    mesh: t.Any = None,
) -> t.Callable[[TrainState, Batch, MetricState], t.Tuple[TrainState, MetricState, Losses]]:
    """Returns ``step(state, batch, mstate) -> (state, mstate, losses)``: one
    optimizer step of ``state.model`` on the batch, moved to ``device`` first
    (where ``create_train_state`` put the model). The model and the optimizer
    are updated in place; ``losses`` are detached scalars.

    ``grad_accum_steps > 1`` runs the batch as that many microbatches in
    turn, as the JAX step's scan does: BatchNorm statistics are per
    microbatch (ghost BN) and the running statistics chain from one
    microbatch to the next; gradients and losses are averaged; the metric
    state counts one step, with the loss sums corrected to add the averages.
    The SILog depth loss is not linear in the batch, so the accumulated loss
    differs from the full-batch one. Under a ``mesh`` of several ranks,
    ``batch`` is this rank's rows and ``device`` its device; microbatch i is
    every rank's i-th slice of its rows together.
    """
    dev = resolve_device(device)
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    comm = _comm(mesh)
    # every rank holds the global loss: each back-propagates its share
    seed = 1.0 / (grad_accum_steps * (comm.world if comm is not None else 1))

    def micro(model: nn.Module, mb: Batch, mstate: MetricState) -> t.Tuple[Losses, MetricState]:
        with _rows(mesh, model, mb["img"]):
            post = postprocess_raw_out(model(mb["img"]))
        losses = _losses(post, mb, loss_segm_weight, loss_depth_weight)
        (losses["loss"] * seed).backward()
        with torch.no_grad():  # the metric state keeps no graph alive
            losses = {k: v.detach() for k, v in losses.items()}
            return losses, _update(mstate, post, mb, losses)

    def step(state: TrainState, batch: Batch, mstate: MetricState):
        batch = _to_device(batch, dev)
        state.optimizer.zero_grad(set_to_none=True)
        with _mode(state.model, True), global_batch(comm):
            if grad_accum_steps == 1:
                losses, mstate = micro(state.model, batch, mstate)
            else:
                bs = batch["img"].shape[0]
                if bs % grad_accum_steps:
                    raise ValueError(
                        f"batch size {bs} is not a multiple of grad_accum_steps "
                        f"{grad_accum_steps}"
                    )
                k = grad_accum_steps
                sums: Losses = {}
                for mb in _split(batch, k):
                    mlosses, mstate = micro(state.model, mb, mstate)
                    sums = {name: sums.get(name, 0.0) + v for name, v in mlosses.items()}
                losses = {name: v / k for name, v in sums.items()}
                # the microbatches counted k steps and added k losses: make
                # that one step that added the average (every key of
                # mtl_loss is corrected here)
                mstate = dataclasses.replace(
                    mstate,
                    num_steps=mstate.num_steps - (k - 1),
                    loss_sum=mstate.loss_sum - losses["loss"] * (k - 1),
                    loss_segm_sum=mstate.loss_segm_sum - losses["loss_segm"] * (k - 1),
                    loss_depth_sum=mstate.loss_depth_sum - losses["loss_depth"] * (k - 1),
                )
        if comm is not None:
            all_reduce_grads(state.model, comm)
        state.optimizer.step()
        state.step += 1
        return state, mstate, losses

    return step


def all_reduce_grads(model: nn.Module, comm: Comm) -> None:
    """Sum every parameter's gradient over the ranks: one all-reduce of one
    flat buffer per gradient dtype, in parameter order."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    for dtype in dict.fromkeys(g.dtype for g in grads):
        group = [g for g in grads if g.dtype == dtype]
        flat = comm.all_reduce_(torch.cat([g.reshape(-1) for g in group]))
        for g, part in zip(group, flat.split([g.numel() for g in group])):
            g.copy_(part.view_as(g))


def _split(batch: Batch, k: int) -> t.List[Batch]:
    chunks = {name: v.chunk(k) for name, v in batch.items()}
    return [{name: c[i] for name, c in chunks.items()} for i in range(k)]


def make_eval_step(
    loss_segm_weight: float = 1.0,
    loss_depth_weight: float = 1.0,
    device: t.Union[str, torch.device] = "cuda",
    mesh: t.Any = None,
) -> t.Callable[[TrainState, Batch, MetricState], t.Tuple[MetricState, Losses]]:
    """Returns ``step(state, batch, mstate) -> (mstate, losses)``: an
    eval-mode forward of ``state.model`` (running statistics) with losses
    (the global batch's under a ``mesh``) and the metric update, under
    ``torch.inference_mode``."""
    dev = resolve_device(device)
    comm = _comm(mesh)

    @torch.inference_mode()
    def step(state: TrainState, batch: Batch, mstate: MetricState):
        batch = _to_device(batch, dev)
        with _mode(state.model, False), _rows(mesh, state.model, batch["img"]):
            post = postprocess_raw_out(state.model(batch["img"]))
        with global_batch(comm):
            losses = _losses(post, batch, loss_segm_weight, loss_depth_weight)
        return _update(mstate, post, batch, losses), losses

    return step
