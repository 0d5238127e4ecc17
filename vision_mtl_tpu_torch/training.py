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
checkpoint of a run, a preemption one included. The mesh waits for a later
slice (ROADMAP.md A10).
"""

from __future__ import annotations

import argparse
import os
import typing as t

from vision_mtl_tpu_torch.cfg import cfg, fetch_data_cfg
from vision_mtl_tpu_torch.device import resolve_device
from vision_mtl_tpu_torch.pipeline import create_main_components, create_tools
from vision_mtl_tpu_torch.predict import predict, save_preds
from vision_mtl_tpu_torch.tracking.artifacts import register_run, run_registry_key
from vision_mtl_tpu_torch.train.checkpoint import _epochs
from vision_mtl_tpu_torch.train.loop import run_pipe
from vision_mtl_tpu_torch.utils.args import check_ported, parse_args, torch_device, update_args


def main(argv: t.Optional[t.Sequence[str]] = None) -> str:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` by default); returns the
    run dir."""
    args = parse_args(argv)
    check_ported(args)
    return _main(args)


def _main(args: argparse.Namespace) -> str:
    cfg.update_fields_with_args(args)
    device = resolve_device(torch_device(args.device))

    data_cfg = fetch_data_cfg(args.dataset_name)
    if getattr(args, "data_dir", None):
        data_cfg.data_dir = args.data_dir

    if args.auto_resume and not args.resume_dir:
        # a relaunch of the same command line finds its own interrupted run
        from vision_mtl_tpu_torch.train.checkpoint import find_latest_resumable_run

        base = os.path.join(str(cfg.log_root_dir), f"training-{args.model_name}")
        if args.run_name:
            base = os.path.join(base, args.run_name)
        found = find_latest_resumable_run(base)
        if found:
            args.resume_dir = found
            print(f"--auto_resume: resuming {found}")
        else:
            print("--auto_resume: no resumable run found; starting fresh")

    if args.do_optimize:
        from vision_mtl_tpu_torch.tuning import run_study

        optimal_params = run_study(args, data_cfg)
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
        )
        save_preds(preds, os.path.join(logger.log_dir, "preds.npz"))
        print("predict: " + " ".join(f"{k}: {v:.3f}" for k, v in predict_metrics.items()))
        logger.log_metrics(predict_metrics, step=args.num_epochs)
        # only a run dir that holds a checkpoint of this launch: a relaunch
        # of a finished run trains no epoch and must not replace its entry
        if _epochs(logger.log_dir, "model"):
            reg = register_run(args.model_name, args.dataset_name, logger.log_dir,
                               key=registry_key)
            print(f"Registered run {registry_key!r} in {reg}")
        else:
            print(f"Not registering {logger.log_dir}: no model checkpoints "
                  f"written by this launch (already-completed run?)")
        if exp:
            exp.log_metrics({f"epoch/{k}": v for k, v in predict_metrics.items()},
                            step=args.num_epochs)
            exp.end()
    finally:
        logger.close()
    return logger.log_dir


if __name__ == "__main__":
    main()
