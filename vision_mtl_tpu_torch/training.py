"""Training CLI (counterpart of ``vision_mtl_tpu/training.py``): parse the
args, set up the configs and the device, optionally sweep the loss weights
(``--do_optimize``, ``tuning.run_study``) and train with the best, build the
datamodule, model, experiment and logger, optionally resume, train
(``run_pipe``), run the predict sweep, write ``preds.npz`` beside the run's
metrics and checkpoints, and register the run in the run registry
(``tracking/artifacts.py``) when it wrote a checkpoint.

    python -m vision_mtl_tpu_torch.training --dataset_name cityscapes \
        --model_name mtan --num_epochs 20 --batch_size 8 --lr 5e-4

It runs on the card; ``--device cpu`` runs it on the CPU. Run dirs are
``<log_root>/training-<model>[/<run_name>]/version_N`` (``VMTL_LOG_ROOT``
sets the root). ``--preempt_save`` turns a SIGTERM (or
``VMTL_PREEMPT_AT_STEP``) into a mid-epoch checkpoint and exit 143;
``--resume_dir`` (or ``--auto_resume``) continues from the newest
checkpoint of a run, a preemption one included.

Data parallelism: launched by ``torchrun`` (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), every process joins the
process group before any other work and trains its rows of each global
batch on ``cuda:(LOCAL_RANK % device_count)``; ``--mesh_shape`` (default
``data:-1``) lays the ranks out over its ``data``, ``spatial`` and
``model`` axes (``data:2,spatial:2``: each rank a quarter of every batch,
half its rows of half its images; ``data:2,model:2``: each rank half of
every batch and half the output channels of each large conv, its Adam
moments with them; ``--fold_tasks`` and ``--fold_tail`` shard their
task-stacked and folded leaves as JAX does).
``--device cpu:N`` starts N ranks of this CLI on the CPU (gloo, one thread
each) and returns rank 0's run dir; a rank that fails fails the run.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import typing as t

from vision_mtl_tpu_torch.cfg import cfg, fetch_data_cfg
from vision_mtl_tpu_torch.device import resolve_device
from vision_mtl_tpu_torch.metrics import rank_part
from vision_mtl_tpu_torch.parallel import multihost
from vision_mtl_tpu_torch.parallel.mesh import Mesh, check_rows, create_mesh, parse_mesh_shape
from vision_mtl_tpu_torch.pipeline import create_main_components, create_tools
from vision_mtl_tpu_torch.predict import predict, save_preds
from vision_mtl_tpu_torch.tracking.artifacts import register_run, run_registry_key
from vision_mtl_tpu_torch.train.checkpoint import _epochs
from vision_mtl_tpu_torch.train.loop import run_pipe
from vision_mtl_tpu_torch.utils.args import (
    check_ported,
    cpu_ranks,
    parse_args,
    torch_device,
    update_args,
)

#: where rank 0 of a ``--device cpu:N`` launch leaves its run dir for the
#: launching process
RUN_DIR_FILE_ENV = "VMTL_RUN_DIR_FILE"


def main(argv: t.Optional[t.Sequence[str]] = None) -> str:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` by default); returns the
    run dir. Under a launcher it joins the process group first and leaves it
    on every exit, a ``SystemExit`` (the preemption's 143) included."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    check_ported(args)
    n_ranks = cpu_ranks(args.device)
    if n_ranks > 1 and not os.environ.get("RANK"):
        return _launch_cpu_ranks(args, argv, n_ranks)
    owns_group = multihost.maybe_initialize_distributed(torch_device(args.device))
    try:
        run_dir = _main(args)
    except SystemExit:
        if owns_group:
            multihost.shutdown_distributed()
        raise
    if owns_group:
        multihost.shutdown_distributed()
    return run_dir


def _launch_cpu_ranks(args: argparse.Namespace, argv: t.List[str], n_ranks: int) -> str:
    """``--device cpu:N``: this CLI as N gloo ranks on the CPU; rank 0's run
    dir. The mesh and the batch are checked here first, with the ranks'
    messages."""
    check_mesh(args, n_ranks)
    fd, path = tempfile.mkstemp(prefix="vmtl_run_dir_")
    os.close(fd)
    os.environ[RUN_DIR_FILE_ENV] = path
    try:
        multihost.launch_local_ranks("vision_mtl_tpu_torch.training", argv, n_ranks)
        with open(path) as f:
            return f.read()
    finally:
        os.environ.pop(RUN_DIR_FILE_ENV, None)
        os.unlink(path)


def check_mesh(args: argparse.Namespace, world: int) -> t.Dict[str, int]:
    """The mesh of ``--mesh_shape`` over ``world`` ranks; SystemExit when its
    data axis does not divide ``--batch_size`` (JAX's message) or when its
    spatial axis does not divide the dataset's image height (JAX's rule,
    ``parallel.mesh.check_rows``)."""
    axes = parse_mesh_shape(args.mesh_shape, world)
    data_shards = axes.get("data", 1)
    if args.batch_size % data_shards:
        raise SystemExit(
            f"--batch_size {args.batch_size} must be divisible by the "
            f"mesh data axis ({data_shards}); pick a multiple or adjust "
            f"--mesh_shape."
        )
    data_cfg = fetch_data_cfg(args.dataset_name)
    height = (data_cfg.train_transform or data_cfg).height
    check_rows(height, axes.get("spatial", 1))
    return axes


def _main(args: argparse.Namespace) -> str:
    cfg.update_fields_with_args(args)
    comm = multihost.current()
    mesh: t.Optional[Mesh] = None
    if comm is not None and comm.world > 1:
        check_mesh(args, comm.world)
        mesh = create_mesh(args.mesh_shape, comm)
        print(f"Mesh: {mesh.shape} over {mesh.world} ranks (rank {mesh.rank} on {mesh.device})")
    device = mesh.device if mesh is not None else resolve_device(torch_device(args.device))
    rank0 = mesh is None or mesh.rank == 0

    data_cfg = fetch_data_cfg(args.dataset_name)
    if getattr(args, "data_dir", None):
        data_cfg.data_dir = args.data_dir

    if args.auto_resume and not args.resume_dir:
        # a relaunch of the same command line finds its own interrupted run
        from vision_mtl_tpu_torch.train.checkpoint import find_latest_resumable_run

        base = os.path.join(str(cfg.log_root_dir), f"training-{args.model_name}")
        if args.run_name:
            base = os.path.join(base, args.run_name)
        found = find_latest_resumable_run(base) if rank0 else None
        if mesh is not None:  # one answer on every rank: rank 0's
            found = mesh.comm.broadcast_object(found)
        if found:
            args.resume_dir = found
            print(f"--auto_resume: resuming {found}")
        else:
            print("--auto_resume: no resumable run found; starting fresh")

    if args.do_optimize:
        from vision_mtl_tpu_torch.tuning import run_study

        optimal_params = run_study(args, data_cfg, mesh=mesh)
        update_args(args, optimal_params)
        args.exp_tags = list(args.exp_tags) + ["best_trial"]

    # the registry key from the user's args: create_tools may set run_name
    # to the comet experiment's name
    registry_key = run_registry_key(args)

    tools = create_tools(args)
    exp, logger = tools["exp"], tools["logger"]
    try:
        components = create_main_components(args, data_cfg, device)
        datamodule = components["datamodule"]
        state = components["state"]

        scheduler = None
        start_epoch = start_batch = start_val_step = 0
        initial_train_mstate = None
        if args.resume_dir:
            from vision_mtl_tpu_torch.train.checkpoint import (
                resolve_resume,
                restore_preempt,
                restore_session,
            )
            from vision_mtl_tpu_torch.train.plateau import ReduceLROnPlateau

            scheduler = ReduceLROnPlateau(patience=2, factor=0.9)
            if resolve_resume(args.resume_dir) == "preempt":
                # the preemption checkpoint is the newest state: resume
                # inside the interrupted epoch
                (state, scheduler, start_epoch, start_batch, initial_train_mstate,
                 start_val_step) = restore_preempt(
                    state, scheduler, args.resume_dir, data_cfg.num_classes)
                # the saved accumulators are the ranks' reduced ones
                initial_train_mstate = rank_part(
                    initial_train_mstate, mesh.replica_comm if mesh is not None else None)
                print(f"Resumed preempted run {args.resume_dir} at epoch {start_epoch} "
                      f"batch {start_batch}")
            else:
                state, scheduler, start_epoch = restore_session(state, scheduler, args.resume_dir)
                print(f"Resumed from {args.resume_dir} at epoch {start_epoch}")

        preempt_guard = None
        if args.preempt_save:
            from vision_mtl_tpu_torch.train.preempt import PreemptionGuard

            preempt_guard = PreemptionGuard()

        state, _ = run_pipe(
            args,
            state,
            datamodule,
            num_epochs=args.num_epochs,
            num_classes=data_cfg.num_classes,
            exp=exp,
            logger=logger,
            log_param_histograms_every=args.log_param_histograms_every,
            scheduler=scheduler,
            start_epoch=start_epoch,
            preempt_guard=preempt_guard,
            start_batch=start_batch,
            initial_train_mstate=initial_train_mstate,
            start_val_step=start_val_step,
            device=device,
            mesh=mesh,
        )

        preds, predict_metrics = predict(
            datamodule.predict_dataloader(),
            state.model,
            num_classes=data_cfg.num_classes,
            do_plot_preds=args.do_plot_preds,
            exp=exp,
            do_show_preds=args.do_show_preds,
            loss_segm_weight=args.loss_segm_weight,
            loss_depth_weight=args.loss_depth_weight,
            device=device,
            mesh=mesh,
        )
        if rank0:  # every rank ran the sweep; one writes
            save_preds(preds, os.path.join(logger.log_dir, "preds.npz"))
        print("predict: " + " ".join(f"{k}: {v:.3f}" for k, v in predict_metrics.items()))
        logger.log_metrics(predict_metrics, step=args.num_epochs)
        # only a run dir that holds a checkpoint of this launch: a relaunch
        # of a finished run trains no epoch and must not replace its entry
        if rank0 and _epochs(logger.log_dir, "model"):
            reg = register_run(args.model_name, args.dataset_name, logger.log_dir,
                               key=registry_key)
            print(f"Registered run {registry_key!r} in {reg}")
        elif rank0:
            print(f"Not registering {logger.log_dir}: no model checkpoints "
                  f"written by this launch (already-completed run?)")
        if exp:
            exp.log_metrics({f"epoch/{k}": v for k, v in predict_metrics.items()},
                            step=args.num_epochs)
            exp.end()
    finally:
        logger.close()
    if rank0 and os.environ.get(RUN_DIR_FILE_ENV):
        with open(os.environ[RUN_DIR_FILE_ENV], "w") as f:
            f.write(logger.log_dir)
    return logger.log_dir


if __name__ == "__main__":
    main()
