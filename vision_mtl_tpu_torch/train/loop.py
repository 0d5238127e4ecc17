"""The training loop (counterpart of ``vision_mtl_tpu/train/loop.py``).

Per epoch: the train steps over batches copied to the device ahead of use
(``prefetch_to_device``), the epoch's metrics, every ``val_epoch_freq``
epochs a validation sweep and the plateau scheduler stepped on the summed
validation loss, and a checkpoint every ``save_epoch_freq`` epochs and at
the last one. Metric names are the JAX package's: ``step/{stage}/{k}``,
``epoch/{stage}/{k}``; ``epoch_metrics`` is keyed ``{stage}/{k}``.

Nothing in the step loop reads the device: a step's losses are fetched
after the next step has been queued (``_LaggedLossLog``), and the epoch's
metrics are the one read that waits for the epoch's work. The metrics also
go to a live comet experiment (``exp``); ``log_param_histograms_every``
logs the parameters' histograms to TensorBoard under their JAX paths; a
validation epoch with ``--do_plot_preds`` or a live experiment predicts the
datamodule's benchmark batch and logs the plot (``vis.plot_preds``).

A ``PreemptionGuard`` (``train/preempt.py``) is polled after every train
and validation step and once after each epoch's checkpoint; a request
writes a checkpoint and exits 143 (``_preempt_exit``).

Under a ``mesh`` of several ranks every rank runs this loop in step with
the others on its own block of each batch (its rows, decoded alone by the
loader; under ``spatial`` and ``model`` cut from the whole batch that every
rank decodes: ``mesh.local_batches``) and device: the epoch's metrics are
the reduced ones of the rank's replica group (``metrics.reduce_metrics``),
rank 0 writes the checkpoints and prunes old ones while the others wait at
a barrier, and the benchmark batch is used only when every rank loaded it.
The state is placed on the mesh first (``mesh.shard_state``, as the JAX
loop does): under ``model`` each rank then holds its slice of the sharded
leaves and their Adam moments, every rank runs the benchmark batch's
forward (its sharded layers gather over the model group) and rank 0 plots
it, and the parameter histograms are taken of the leaves gathered whole.
"""

from __future__ import annotations

import argparse
import time
import typing as t
from collections import defaultdict

import torch

from vision_mtl_tpu_torch.data.datamodule import MTLDataModule, configure_host_sharded_loading
from vision_mtl_tpu_torch.data.loader import prefetch_to_device
from vision_mtl_tpu_torch.device import resolve_device
from vision_mtl_tpu_torch.metrics import MetricState, compute_metrics, init_metrics, reduce_metrics
from vision_mtl_tpu_torch.parallel.mesh import local_batches, model_slices, shard_state
from vision_mtl_tpu_torch.parallel.multihost import all_processes_agree
from vision_mtl_tpu_torch.train.checkpoint import prune_old_ckpts, save_ckpt, save_preempt_ckpt
from vision_mtl_tpu_torch.train.plateau import ReduceLROnPlateau
from vision_mtl_tpu_torch.train.state import TrainState, get_lr, set_lr
from vision_mtl_tpu_torch.train.step import make_eval_step, make_predict_step, make_train_step

METRIC_KEYS = ("loss", "accuracy", "jaccard_index", "fbeta_score", "mae")


def _host_floats(values: t.Mapping[str, torch.Tensor]) -> t.Dict[str, float]:
    """Scalar tensors to floats through one device-to-host copy."""
    keys = list(values)
    stacked = torch.stack([values[k].detach().float().reshape(()) for k in keys])
    return dict(zip(keys, stacked.cpu().tolist()))


def _metrics_float(mstate: MetricState) -> t.Dict[str, float]:
    return _host_floats(compute_metrics(mstate))


class _LaggedLossLog:
    """One-step-lagged step-loss logging: step N's losses are read only
    after step N+1 has been queued, so the read overlaps the device's work
    instead of draining it; one copy per logged step. Call ``flush()`` after
    the loop for the last pending step."""

    def __init__(self, prefix: str, logger: t.Any, exp: t.Any = None):
        self._prefix, self._logger, self._exp = prefix, logger, exp
        self._pending: t.Optional[t.Tuple[int, t.Mapping[str, torch.Tensor]]] = None

    def offer(self, step_no: int, step_losses: t.Mapping[str, torch.Tensor], want: bool) -> None:
        self.flush()
        if self._logger is not None and want:
            self._pending = (step_no, step_losses)

    def flush(self) -> None:
        if self._pending is None:
            return
        step_no, step_losses = self._pending
        self._pending = None
        stats = {f"{self._prefix}/{k}": v for k, v in _host_floats(step_losses).items()}
        self._logger.log_metrics(stats, step=step_no)
        if self._exp:
            for k, v in stats.items():
                self._exp.log_metric(k, v, step=step_no)


def _log_param_histograms(logger: t.Any, model: torch.nn.Module, step: int) -> None:
    """One TensorBoard histogram per parameter, tagged with its flax path
    (``a/b/kernel``) in the JAX layout, as the JAX loop logs
    ``state.params``; the buffers (``batch_stats``) are not logged. A no-op
    without a TensorBoard writer; the first failing write ends the call.
    Collective when the model is sharded over the mesh's ``model`` axis:
    every rank gathers the leaves whole, whether or not it has a writer."""
    from vision_mtl_tpu_torch.weights import jax_variables_from_model

    tb = getattr(logger, "_tb", None)
    variables = jax_variables_from_model(model) if tb is not None or model_slices(model) else None
    if tb is None:
        return

    def leaves(tree: t.Mapping[str, t.Any], prefix: str) -> t.Iterator[t.Tuple[str, t.Any]]:
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], f"{prefix}{k}/")
            else:
                yield prefix + k, tree[k]

    for name, value in leaves(variables["params"], ""):
        try:
            tb.add_histogram(name, value, step)
        except Exception:
            return


def _plot_benchmark(args: argparse.Namespace, benchmark_batch: t.Mapping[str, t.Any],
                    preds: t.Mapping[str, torch.Tensor], exp: t.Any, logger: t.Any,
                    epoch: int) -> None:
    """Plot the benchmark batch's predictions (``vis.plot_preds``) to
    ``exp`` and the logger's TensorBoard; best-effort: a failure is
    printed."""
    try:
        from vision_mtl_tpu_torch.vis import plot_preds

        fig = plot_preds(
            batch_size=benchmark_batch["img"].shape[0],
            inputs_batch=benchmark_batch,
            preds_batch={k: v.cpu().numpy() for k, v in preds.items()},
        )
        if exp:
            exp.log_figure("preds", fig)
        if logger is not None:
            logger.log_figure("preds", fig, step=epoch)
        import matplotlib.pyplot as plt

        if getattr(args, "do_show_preds", False):
            plt.show()
        plt.close(fig)
    except Exception as e:
        print("benchmark plot failed:", e)


def run_pipe(
    args: argparse.Namespace,
    state: TrainState,
    datamodule: MTLDataModule,
    num_epochs: int,
    num_classes: int,
    exp: t.Any = None,
    logger: t.Any = None,
    log_every_n_steps: int = 1,
    log_param_histograms_every: int = 0,
    scheduler: t.Optional[ReduceLROnPlateau] = None,
    start_epoch: int = 0,
    epoch_callback: t.Optional[t.Callable[[int, t.Dict[str, float]], None]] = None,
    preempt_guard: t.Any = None,
    start_batch: int = 0,
    initial_train_mstate: t.Optional[MetricState] = None,
    start_val_step: int = 0,
    device: t.Union[str, torch.device] = "cuda",
    mesh: t.Any = None,
) -> t.Tuple[TrainState, t.Dict[str, t.Dict[str, list]]]:
    """Train ``state`` from ``start_epoch`` to ``num_epochs``; returns the
    state and the epoch metrics. Checkpoints go to ``logger.log_dir``.
    ``epoch_callback(epoch, val_metrics)`` runs after each validation; its
    exceptions propagate (a tuning trial's pruning callback raises
    ``TrialPruned``). ``exp`` receives the step and epoch metrics and the
    checkpoints when it is a live experiment; every
    ``log_param_histograms_every`` steps (0: never) the parameters'
    histograms go to the logger's TensorBoard.

    ``preempt_guard`` is polled at every step boundary; when it fires, a
    preemption checkpoint is written and the process exits 143.
    ``start_batch``, ``initial_train_mstate`` and ``start_val_step``
    continue an interrupted epoch exactly (``checkpoint.restore_preempt``):
    the loader skips the batches of ``start_epoch``'s order already
    trained, and the epoch's accumulators go on from where they stopped.

    ``mesh`` (``parallel/mesh.py``, several ranks): this rank's part of a
    run over the mesh's axes on ``mesh.device``; every rank calls
    ``run_pipe`` with the same arguments. The state is placed on the mesh
    here (``mesh.shard_state``; the returned state holds the slices)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    comm = mesh.comm if mesh is not None else None
    replicas = mesh.replica_comm if mesh is not None else None
    rank0 = comm is None or comm.rank == 0
    if mesh is not None:
        state = shard_state(state, mesh)
    # a sharded model's forward is collective over its model group
    sharded = bool(model_slices(state.model))
    configure_host_sharded_loading(datamodule, mesh)
    train_step = make_train_step(
        loss_segm_weight=args.loss_segm_weight,
        loss_depth_weight=args.loss_depth_weight,
        grad_accum_steps=getattr(args, "grad_accum_steps", 1),
        device=dev,
        mesh=mesh,
    )
    eval_step = make_eval_step(
        loss_segm_weight=args.loss_segm_weight,
        loss_depth_weight=args.loss_depth_weight,
        device=dev,
        mesh=mesh,
    )
    predict_step = make_predict_step(state.model)
    if scheduler is None:
        scheduler = ReduceLROnPlateau(patience=2, factor=0.9)
    benchmark_batch = datamodule.benchmark_batch
    # every rank or none: a rank whose load failed would leave the others'
    # plots out of step with its own
    if not all_processes_agree(benchmark_batch is not None, "benchmark_batch", comm):
        if benchmark_batch is not None:
            print("benchmark batch dropped: at least one rank failed to load it")
        benchmark_batch = None
    if benchmark_batch is None:
        print("A batch for benchmarking is not found.")
    # only rank 0 has a live experiment: a sharded forward needs every rank
    want_benchmark = bool(exp) or getattr(args, "do_plot_preds", False)
    if sharded:
        want_benchmark = bool(comm.host_all_reduce([int(want_benchmark)], "max")[0])

    # a resumed run continues the step axis (restore_session set state.step)
    global_step = int(state.step)
    val_step = start_val_step
    if logger is None:
        print(
            "WARNING: run_pipe called without a logger — no checkpoints "
            "will be saved (save_dir comes from logger.log_dir)."
        )
    epoch_metrics: t.Dict[str, t.Dict[str, list]] = {
        "train": defaultdict(list),
        "val": defaultdict(list),
    }

    # one loader across epochs: its seeded reshuffle advances with its epoch
    # counter, which a resumed run sets to continue the shuffle stream
    train_loader = datamodule.train_dataloader()
    train_loader.epoch = start_epoch
    train_loader.skip_batches = start_batch

    def _preempt_exit(batches: t.Any, epoch: int, batch_in_epoch: int,
                      mstate_: MetricState, val_step_: int) -> None:
        """Stop the loader, let the device finish what is queued (the
        steps and the copies in flight), write the preemption checkpoint
        and exit 143. A request during validation saves the whole epoch's
        train state: the resumed run trains no batch of it again and
        validates from the top."""
        batches.close()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if logger is not None:
            save_preempt_ckpt(state, scheduler, epoch, batch_in_epoch,
                              reduce_metrics(mstate_, replicas), val_step_, save_dir=logger.log_dir)
        else:
            print("Preemption requested but run_pipe has no logger: no checkpoint dir to "
                  "write; exiting without saving.")
        print(f"Preempted at epoch {epoch + 1} step {global_step}; resume with --resume_dir.")
        raise SystemExit(143)

    for epoch in range(start_epoch, num_epochs):
        print(f"### Epoch {epoch + 1}/{num_epochs} ###")
        epoch_t0 = time.perf_counter()
        if epoch == start_epoch and initial_train_mstate is not None:
            # the interrupted epoch's accumulators: its train metrics come
            # out as the uninterrupted run's
            mstate = initial_train_mstate
        else:
            mstate = init_metrics(num_classes, dev)
        batch_in_epoch = start_batch if epoch == start_epoch else 0
        epoch_start_batch = batch_in_epoch

        step_log = _LaggedLossLog("step/train", logger, exp)
        batches = prefetch_to_device(local_batches(train_loader, mesh), dev, size=2)
        for batch in batches:
            state, mstate, losses = train_step(state, batch, mstate)
            step_log.offer(global_step, losses, global_step % log_every_n_steps == 0)
            if log_param_histograms_every and global_step % log_param_histograms_every == 0:
                # opt-in: every parameter is copied to the host
                _log_param_histograms(logger, state.model, global_step)
            global_step += 1
            batch_in_epoch += 1
            if preempt_guard is not None and preempt_guard.requested(global_step):
                step_log.flush()
                _preempt_exit(batches, epoch, batch_in_epoch, mstate, val_step)
        step_log.flush()

        # reading the metrics waits for the epoch's work: the epoch's time
        # is end to end (host decode, copies and steps)
        train_metrics = _metrics_float(reduce_metrics(mstate, replicas))
        epoch_dt = time.perf_counter() - epoch_t0
        imgs_seen = (batch_in_epoch - epoch_start_batch) * train_loader.batch_size
        if epoch_dt > 0 and imgs_seen > 0:
            ips = imgs_seen / epoch_dt
            print(
                f"epoch/train throughput: {ips:.1f} img/s end-to-end "
                f"({imgs_seen} imgs in {epoch_dt:.1f}s)"
            )
            if logger is not None:
                logger.log_metrics({"epoch/train/imgs_per_sec": ips}, step=epoch)
        for k, v in train_metrics.items():
            epoch_metrics["train"][f"train/{k}"].append(v)
        print("epoch/train: " + " ".join(f"{k}: {train_metrics[k]:.3f}" for k in METRIC_KEYS))
        if logger is not None:
            logger.log_metrics({f"epoch/train/{k}": v for k, v in train_metrics.items()}, step=epoch)
        if exp:
            exp.log_metrics({f"epoch/train/{k}": v for k, v in train_metrics.items()}, step=epoch)

        if (epoch + 1) % args.val_epoch_freq == 0:
            if benchmark_batch is not None and want_benchmark and (rank0 or sharded):
                # the eval-mode forward; only the plotting is best-effort
                preds = predict_step(torch.from_numpy(benchmark_batch["img"]).to(dev))
                if rank0:
                    _plot_benchmark(args, benchmark_batch, preds, exp, logger, epoch)

            val_mstate = init_metrics(num_classes, dev)
            val_log = _LaggedLossLog("step/val", logger, exp)
            val_step0 = val_step  # a preempted sweep is run again from here
            batches = prefetch_to_device(local_batches(datamodule.val_dataloader(), mesh), dev,
                                         size=2)
            for batch in batches:
                val_mstate, losses = eval_step(state, batch, val_mstate)
                val_log.offer(val_step, losses, val_step % log_every_n_steps == 0)
                val_step += 1
                if preempt_guard is not None and preempt_guard.requested(global_step):
                    val_log.flush()
                    _preempt_exit(batches, epoch, batch_in_epoch, mstate, val_step0)
            val_log.flush()

            val_mstate = reduce_metrics(val_mstate, replicas)
            val_metrics = _host_floats(
                {**compute_metrics(val_mstate), "loss_sum": val_mstate.loss_sum}
            )
            # the summed validation loss drives the plateau scheduler
            val_loss_sum = val_metrics.pop("loss_sum")
            for k, v in val_metrics.items():
                epoch_metrics["val"][f"val/{k}"].append(v)
            print("epoch/val: " + " ".join(f"{k}: {val_metrics[k]:.3f}" for k in METRIC_KEYS))
            if logger is not None:
                logger.log_metrics({f"epoch/val/{k}": v for k, v in val_metrics.items()}, step=epoch)
            if exp:
                exp.log_metrics({f"epoch/val/{k}": v for k, v in val_metrics.items()}, step=epoch)

            new_lr = scheduler.step(val_loss_sum, get_lr(state))
            if new_lr != get_lr(state):
                print(f"Plateau: reducing lr to {new_lr:.3e}")
                state = set_lr(state, new_lr)

            if epoch_callback is not None:
                epoch_callback(epoch, val_metrics)

        epoch_saved = (epoch + 1) % args.save_epoch_freq == 0 or epoch == num_epochs - 1
        if epoch_saved and logger is not None:
            save_ckpt(state, scheduler, epoch, save_dir=logger.log_dir, exp=exp)
            if rank0:
                prune_old_ckpts(logger.log_dir, getattr(args, "keep_ckpt_last_k", 0))

        # a request after the epoch's last poll: the epoch, its scheduler
        # step included, is complete, so an epoch checkpoint resumes it
        # exactly at the next epoch
        if preempt_guard is not None and preempt_guard.requested(global_step):
            if logger is not None and not epoch_saved:
                save_ckpt(state, scheduler, epoch, save_dir=logger.log_dir, exp=exp)
            print(f"Preempted after epoch {epoch + 1}; resume with --resume_dir.")
            raise SystemExit(143)

    return state, epoch_metrics
