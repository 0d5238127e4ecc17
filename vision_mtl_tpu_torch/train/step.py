"""Train, eval and predict steps (counterpart of
``vision_mtl_tpu/train/step.py``).

A step is a plain function over tensors; the model carries its own weights
and BatchNorm statistics, the train state its optimizer. The train step is
decode -> train-mode forward -> postprocess -> losses -> backward -> Adam
step -> metric update; it runs with autograd on. The eval and predict steps
run under ``torch.inference_mode``. Each step sets the model's mode for its
own forward and restores it after. Steps return without synchronising:
reading a result on the host is the sync. While a profiler session is on,
the train step records the spans ``train.step`` and, inside it,
``train.forward`` (forward, postprocess, losses), ``train.backward`` and
``train.optimizer`` (``utils/profiling.span``).

Given a ``mesh`` of several ranks (``parallel/mesh.py``), each rank's step
takes its own block of the global batch (its rows, and under ``spatial``
its image rows of them) and runs inside ``multihost.global_batch`` with
the rank's replica group (its data x spatial ranks): train-mode batch
statistics and the losses are the global batch's. Under ``spatial`` the
forward also runs inside ``halo.spatial_rows`` with the rank's spatial
group, where the convolutions take their halo rows from the neighbouring
ranks and the levels whose rows do not split run whole. Under ``model``
(the state placed by ``mesh.shard_state``) the sharded layers gather their
output channels over the rank's model group, whose ranks hold the same
block and compute the same global loss.

The train step back-propagates ``1 / R`` of the global loss on every rank
(R the replica group's size) and then, once per step, before Adam, sums
each sharded leaf's gradient over the replica group, and each replicated
leaf's over every rank divided by the ``model`` axis's size (one flat
buffer a dtype for each). The ranks of a model group compute the same
replicated gradients up to the order of the atomic adds of some CUDA
backward kernels; taking their mean keeps every rank's replicated leaves
and Adam moments bit for bit equal, as are the sharded ones across the
ranks of a slice. The metric states stay per rank until
``metrics.reduce_metrics`` over the replica group.
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
from vision_mtl_tpu_torch.parallel.mesh import model_slices
from vision_mtl_tpu_torch.parallel.multihost import Comm, global_batch
from vision_mtl_tpu_torch.train.state import TrainState
from vision_mtl_tpu_torch.utils.profiling import span

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
        with _mode(model, False), _rows(mesh):
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
    """The mesh's replica group (the ranks of every batch-wide sum) when it
    has several ranks, else None."""
    return mesh.replica_comm if mesh is not None else None


def _rows(mesh: t.Any) -> t.ContextManager[None]:
    """The forward's ``spatial_rows`` context: the mesh's spatial group, and
    its data group for the levels that run whole."""
    if mesh is None or mesh.spatial_comm is None:
        return spatial_rows(None)
    return spatial_rows(mesh.spatial_comm, mesh.data_comm)


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
        with _mode(model, False), _rows(mesh):
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
    every rank's i-th slice of its rows together. Under a ``model`` axis the
    state must have been placed by ``parallel.mesh.shard_state``.
    """
    dev = resolve_device(device)
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    comm = _comm(mesh)
    # every rank holds the global loss: each back-propagates its share
    seed = 1.0 / (grad_accum_steps * (comm.world if comm is not None else 1))

    def micro(model: nn.Module, mb: Batch, mstate: MetricState) -> t.Tuple[Losses, MetricState]:
        with span("train.forward", device_time=True):
            with _rows(mesh):
                post = postprocess_raw_out(model(mb["img"]))
            losses = _losses(post, mb, loss_segm_weight, loss_depth_weight)
        with span("train.backward", device_time=True):
            (losses["loss"] * seed).backward()
        with torch.no_grad():  # the metric state keeps no graph alive
            losses = {k: v.detach() for k, v in losses.items()}
            return losses, _update(mstate, post, mb, losses)

    def run(state: TrainState, batch: Batch, mstate: MetricState):
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
        with span("train.optimizer", device_time=True):
            if mesh is not None and mesh.world > 1:
                reduce_grads(state.model, mesh)
            state.optimizer.step()
        state.step += 1
        return state, mstate, losses

    def step(state: TrainState, batch: Batch, mstate: MetricState):
        with span("train.step"):
            return run(state, batch, mstate)

    return step


def all_reduce_grads(grads: t.Sequence[torch.Tensor], comm: Comm, scale: float = 1.0) -> None:
    """Sum ``grads`` over the ranks of ``comm`` in place, times ``scale``:
    one all-reduce of one flat buffer per gradient dtype, in order."""
    for dtype in dict.fromkeys(g.dtype for g in grads):
        group = [g for g in grads if g.dtype == dtype]
        flat = comm.all_reduce_(torch.cat([g.reshape(-1) for g in group]))
        if scale != 1.0:
            flat.mul_(scale)
        for g, part in zip(group, flat.split([g.numel() for g in group])):
            g.copy_(part.view_as(g))


def reduce_grads(model: nn.Module, mesh: t.Any) -> None:
    """The step's gradient sums over the ranks of ``mesh``: each sharded
    leaf's over its replica group, its slices never summed across slices;
    each replicated leaf's over every rank times ``1 / model``, the mean of
    its model group's equal copies (without a ``model`` axis, a sum over
    the replica group, which is then every rank)."""
    slices = model_slices(model)
    sliced = {id(p) for k, p in model.named_parameters() if k in slices}
    sharded, replicated = [], []
    for p in model.parameters():
        if p.grad is not None:
            (sharded if id(p) in sliced else replicated).append(p.grad)
    replica = mesh.replica_comm
    if sharded and replica is not None:
        all_reduce_grads(sharded, replica)
    if replicated:
        all_reduce_grads(replicated, mesh.comm, 1.0 / mesh.size("model"))


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
        with _mode(state.model, False), _rows(mesh):
            post = postprocess_raw_out(state.model(batch["img"]))
        with global_batch(comm):
            losses = _losses(post, batch, loss_segm_weight, loss_depth_weight)
        return _update(mstate, post, batch, losses), losses

    return step
