"""The training CLI's arguments (counterpart of
``vision_mtl_tpu/utils/args.py``): flag for flag, the same defaults, except
``--device``, which defaults to ``cuda`` and takes ``cpu``.

Flags whose feature the port does not have yet are parsed, and
:func:`check_ported` refuses a value other than their default, naming the
ROADMAP.md item that ports it; it also refuses a ``--mesh_shape`` axis the
port does not run (``model`` above 1, ROADMAP.md A10c).
``--device cpu:N`` runs N ranks on the CPU (``training.main``).
"""

from __future__ import annotations

import argparse
import typing as t


def parse_args(argv: t.Optional[t.Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()

    pipe_args = parser.add_argument_group("pipe")
    pipe_args.add_argument("--do_overfit", action="store_true")
    pipe_args.add_argument("--do_optimize", action="store_true")
    pipe_args.add_argument("--do_plot_preds", action="store_true")
    pipe_args.add_argument("--do_show_preds", action="store_true")
    pipe_args.add_argument("--exp_disabled", action="store_true")
    pipe_args.add_argument("--ckpt_dir")
    pipe_args.add_argument(
        "--resume_dir",
        help="Exact-resume a run: restore params, optimizer, lr, plateau "
        "scheduler and epoch from this run dir and continue training.",
    )
    pipe_args.add_argument(
        "--auto_resume",
        action="store_true",
        help="Resume the newest resumable run dir for this model/run_name; "
        "starts fresh when none exists. Ignored when --resume_dir is given.",
    )
    pipe_args.add_argument("--run_name")
    pipe_args.add_argument(
        "--device",
        default="cuda",
        help="'cuda' (default: the card; raises without one), 'cpu', or 'cpu:N' for N "
        "data-parallel ranks on the CPU.",
    )
    pipe_args.add_argument("--exp_tags", nargs="*", default=[])

    model_args = parser.add_argument_group("model")
    model_args.add_argument("--model_name", choices=["basic", "mtan", "csnet"], default="basic")
    model_args.add_argument("--backbone_weights", choices=["imagenet"])
    model_args.add_argument("--channel_wise_stitching", action="store_true")

    data_args = parser.add_argument_group("data")
    data_args.add_argument(
        "--dataset_name", choices=["cityscapes", "nyuv2", "synthetic"], default="cityscapes"
    )
    data_args.add_argument("--batch_size", type=int, default=1)
    data_args.add_argument("--num_workers", type=int, default=0)
    data_args.add_argument(
        "--data_dir",
        default=None,
        help="Override the dataset's data directory (default: the config "
        "singleton's path under vision_mtl_tpu_torch/data/).",
    )

    optuna_args = parser.add_argument_group("opt")
    optuna_args.add_argument("--n_trials", type=int, default=7)
    optuna_args.add_argument("--n_jobs", type=int, default=2)

    trainer_args = parser.add_argument_group("trainer")
    trainer_args.add_argument("--lr", type=float, default=5e-3)
    trainer_args.add_argument("--loss_segm_weight", type=float, default=1.0)
    trainer_args.add_argument("--loss_depth_weight", type=float, default=1.0)
    trainer_args.add_argument("--num_epochs", type=int, default=10)
    trainer_args.add_argument("--val_epoch_freq", type=int, default=1)
    trainer_args.add_argument("--save_epoch_freq", type=int, default=10)

    dev_args = parser.add_argument_group("device")
    dev_args.add_argument("--mesh_shape", type=str, default="data:-1")
    dev_args.add_argument("--seed", type=int, default=11)
    dev_args.add_argument(
        "--precision", choices=["bf16", "f32"], default="bf16",
        help="Compute precision (params always f32).",
    )
    dev_args.add_argument("--log_param_histograms_every", type=int, default=0)
    dev_args.add_argument(
        "--wire_format", choices=["f32", "compact"], default=None,
        help="Host-to-device batch encoding; default per dataset config.",
    )
    dev_args.add_argument("--fold_tail", action="store_true")
    dev_args.add_argument("--remat_tail", type=int, default=0)
    dev_args.add_argument("--remat_encoder", action="store_true")
    dev_args.add_argument("--remat_attention", action="store_true")
    dev_args.add_argument("--remat_shared", action="store_true")
    dev_args.add_argument(
        "--keep_ckpt_last_k", type=int, default=0,
        help="Keep only the newest K epoch checkpoint pairs (0 = keep all).",
    )
    dev_args.add_argument(
        "--preempt_save", action="store_true",
        help="On SIGTERM (or VMTL_PREEMPT_AT_STEP=k) write a mid-epoch checkpoint at the "
        "next step boundary and exit 143; --resume_dir continues it exactly.",
    )
    dev_args.add_argument("--fold_tasks", action="store_true")
    dev_args.add_argument(
        "--torch_bn_var",
        action="store_true",
        help="BatchNorm running-var updates use torch's unbiased (N/(N-1)) "
        "estimator instead of flax's biased one.",
    )
    dev_args.add_argument(
        "--grad_accum_steps", type=int, default=1,
        help="Microbatches per optimizer step (batch_size must be divisible). "
        "Ghost-BN semantics per microbatch.",
    )

    args, _ = parser.parse_known_args(argv)
    return args


# flag: (its default, the ROADMAP.md item that ports its feature); none is
# left
NOT_PORTED: t.Dict[str, t.Tuple[t.Any, str]] = {}


def update_args(args: argparse.Namespace, kv_map: t.Mapping[str, t.Any]) -> argparse.Namespace:
    """Set existing keys of ``args`` to new values (an unknown key is an
    AssertionError)."""
    for k, v in kv_map.items():
        assert hasattr(args, k), k
        setattr(args, k, v)
    return args


def check_ported(args: argparse.Namespace) -> None:
    """Refuse, with SystemExit, a flag whose feature is not ported and a
    ``--device`` the port cannot run."""
    for flag, (default, item) in NOT_PORTED.items():
        if getattr(args, flag) != default:
            raise SystemExit(
                f"--{flag} {getattr(args, flag)!r}: not ported to vision_mtl_tpu_torch "
                f"yet, see ROADMAP.md {item}"
            )
    cpu_ranks(args.device)


def cpu_ranks(device: str) -> int:
    """N of ``--device cpu:N`` (1 for ``cpu``, 0 for a card); SystemExit for
    a malformed N."""
    if not device.startswith("cpu"):
        return 0
    if device == "cpu":
        return 1
    n = device[len("cpu:"):]
    if not device.startswith("cpu:") or not n.isdigit() or int(n) < 1:
        raise SystemExit(f"--device {device!r}: expected cpu or cpu:N with N >= 1")
    return int(n)


def torch_device(device: str) -> str:
    """The torch device string of a ``--device`` value (``cpu:N`` runs each
    rank on the CPU)."""
    return "cpu" if device.startswith("cpu") else device

