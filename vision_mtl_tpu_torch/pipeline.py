"""Pipeline factories (counterpart of ``vision_mtl_tpu/pipeline.py``): the
model and train state from the CLI args, the datamodule, and the run's
tools: its comet experiment (a falsy ``NullExperiment`` when tracking is
off), its metrics logger and ``train_args.yaml``."""

from __future__ import annotations

import argparse
import os
import typing as t

import torch

from vision_mtl_tpu_torch.cfg import DataConfig, cfg, fetch_data_cfg
from vision_mtl_tpu_torch.data.datamodule import MTLDataModule
from vision_mtl_tpu_torch.models.blocks import set_torch_bn_running_var
from vision_mtl_tpu_torch.models.registry import build_model
from vision_mtl_tpu_torch.tracking import MetricsLogger
from vision_mtl_tpu_torch.parallel.multihost import process_info
from vision_mtl_tpu_torch.tracking.comet import NullExperiment, create_tracking_exp, log_params_to_exp
from vision_mtl_tpu_torch.tracking.logger import publish_logger_failure
from vision_mtl_tpu_torch.train.checkpoint import (
    _maybe_reference_torch_ckpt,
    load_args,
    log_args,
    restore_model,
    restore_state,
)
from vision_mtl_tpu_torch.train.state import TrainState, create_train_state


#: the training flags that shape the model, and their defaults
MODEL_OPTIONS: t.Dict[str, t.Any] = {
    "fold_tail": False,
    "remat_tail": 0,
    "remat_encoder": False,
    "remat_attention": False,
    "remat_shared": False,
    "fold_tasks": False,
}


def compute_dtype(args: argparse.Namespace) -> torch.dtype:
    return torch.bfloat16 if getattr(args, "precision", "bf16") == "bf16" else torch.float32


def model_from_args(
    args: argparse.Namespace, data_cfg: DataConfig, device: t.Union[str, torch.device]
) -> torch.nn.Module:
    """The model a run's args name, as the JAX registry builds it from them:
    the precision, the seed, ``merge_heads`` and ``channel_wise_stitching``
    (False unless the flag was given), the model options (``fold_tail``,
    ``remat_tail``, ``remat_encoder``, ``remat_attention``, ``remat_shared``,
    ``fold_tasks``; off where the args lack them), and the BatchNorm
    running-variance switch (``--torch_bn_var``), set for every build."""
    set_torch_bn_running_var(bool(getattr(args, "torch_bn_var", False)))
    return build_model(
        args.model_name,
        data_cfg,
        dtype=compute_dtype(args),
        device=device,
        seed=getattr(args, "seed", cfg.seed),
        merge_heads=getattr(args, "merge_heads", True),
        channel_wise_stitching=getattr(args, "channel_wise_stitching", True),
        **{name: getattr(args, name, default) for name, default in MODEL_OPTIONS.items()},
    )


def init_model(
    args: argparse.Namespace, data_cfg: DataConfig, device: t.Union[str, torch.device]
) -> t.Tuple[torch.nn.Module, TrainState]:
    """Model and train state; the imagenet encoder with
    ``--backbone_weights imagenet``, then a weights-only warm start from
    ``--ckpt_dir`` if given (a port run dir or a reference one)."""
    model = model_from_args(args, data_cfg, device)
    state = create_train_state(model, args.lr, device=device)
    if getattr(args, "backbone_weights", None) == "imagenet":
        from vision_mtl_tpu_torch.utils.torch_port import apply_imagenet_backbone

        apply_imagenet_backbone(model, args.model_name)
    if getattr(args, "ckpt_dir", None):
        state = restore_state(state, args.ckpt_dir)
    return model, state


def create_main_components(
    args: argparse.Namespace, data_cfg: DataConfig, device: t.Union[str, torch.device]
) -> t.Dict[str, t.Any]:
    """Datamodule (set up), model and train state. Under several ranks each
    rank builds the whole model from the same seed (or restores the same
    checkpoint) on its own device."""
    datamodule = MTLDataModule(
        dataset_name=args.dataset_name,
        batch_size=args.batch_size,
        do_overfit=args.do_overfit,
        num_workers=args.num_workers,
        train_transform=data_cfg.train_transform,
        test_transform=data_cfg.test_transform,
        seed=getattr(args, "seed", cfg.seed),
        wire_format=getattr(args, "wire_format", None),
    )
    datamodule.setup()
    model, state = init_model(args, data_cfg, device)
    return {"datamodule": datamodule, "model": model, "state": state}


def create_tools(args: argparse.Namespace, rendezvous_tag: str = "main") -> t.Dict[str, t.Any]:
    """The comet experiment and the metrics logger, whose run dir
    ``{log_root}/training-{model}[/{run_name}]/version_N`` also receives
    ``train_args.yaml`` and the checkpoints. A live experiment names the
    run (``args.run_name``) and gets the args and the tags (model, dataset,
    ``--exp_tags``).

    Under several ranks only rank 0 has an experiment (the others a falsy
    ``NullExperiment``) and writes ``train_args.yaml``; every rank gets the
    one run dir (the logger's rendezvous, keyed by ``rendezvous_tag``). A
    failure of rank 0 before its logger reaches the other ranks."""
    rank0 = process_info()[0] == 0
    try:
        exp = create_tracking_exp(args) if rank0 else NullExperiment()
        if not args.exp_disabled and exp:
            args.run_name = exp.name
        log_params_to_exp(exp, vars(args), "args")
        if exp:
            exp.add_tags([args.model_name, args.dataset_name] + args.exp_tags)
    except Exception as e:
        publish_logger_failure(
            f"tracking setup raised on rank 0 before the logger rendezvous "
            f"({rendezvous_tag}): {type(e).__name__}: {e}"
        )
        raise
    log_subdir_name = f"training-{args.model_name}"
    if args.run_name:
        log_subdir_name += f"/{args.run_name}"
    logger = MetricsLogger(str(cfg.log_root_dir), log_subdir_name, rendezvous_tag=rendezvous_tag)
    if rank0:
        log_args(args, f"{logger.log_dir}/train_args.yaml", exp=exp)
    return {"exp": exp, "logger": logger}


def load_run_model(
    run_dir: str,
    device: t.Union[str, torch.device],
    model_name: t.Optional[str] = None,
    dataset_name: t.Optional[str] = None,
    defaults: t.Optional[t.Mapping[str, t.Any]] = None,
    overrides: t.Optional[t.Mapping[str, t.Any]] = None,
    epoch: t.Optional[int] = None,
) -> t.Tuple[torch.nn.Module, DataConfig, argparse.Namespace]:
    """A trained run's model in eval mode on ``device``: rebuilt from its
    ``train_args.yaml`` (``model_name`` and ``dataset_name`` override the
    recorded ones; ``defaults`` fill args the file lacks, ``overrides``
    replace them) with the weights of its checkpoint of ``epoch`` (the
    newest by default): the port's ``model_{e}/``, or a reference
    ``model_{e}.pt``, imported as ``restore_state`` does. A reference CSNet
    run whose args do not record ``channel_wise_stitching`` takes the
    stitch layout of its checkpoint. Returns ``(model, data_cfg,
    run_args)``."""
    args_path = os.path.join(run_dir, "train_args.yaml")
    run_args = load_args(args_path) if os.path.exists(args_path) else argparse.Namespace()
    ref_pt = _maybe_reference_torch_ckpt(run_dir, epoch)
    ref_sd = None
    if ref_pt is not None and not hasattr(run_args, "channel_wise_stitching"):
        from vision_mtl_tpu_torch.utils.ckpt_import import reference_stitching_is_channel_wise
        from vision_mtl_tpu_torch.utils.torch_port import load_state_dict_file

        ref_sd = load_state_dict_file(ref_pt)
        channel_wise = reference_stitching_is_channel_wise(ref_sd)
        if channel_wise is not None:
            run_args.channel_wise_stitching = channel_wise
    for k, v in (defaults or {}).items():
        if not hasattr(run_args, k):
            setattr(run_args, k, v)
    for k, v in (overrides or {}).items():
        setattr(run_args, k, v)
    run_args.model_name = model_name or getattr(run_args, "model_name", None)
    run_args.dataset_name = dataset_name or getattr(run_args, "dataset_name", None)
    if not run_args.model_name or not run_args.dataset_name:
        raise SystemExit(
            f"{run_dir} has no train_args.yaml — pass --model_name and --dataset_name explicitly"
        )
    data_cfg = fetch_data_cfg(run_args.dataset_name)
    model = model_from_args(run_args, data_cfg, device)
    restore_model(model, run_dir, epoch, reference_sd=ref_sd)
    return model.eval(), data_cfg, run_args
