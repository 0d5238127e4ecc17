"""Evaluation of finished runs (counterpart of
``vision_mtl_tpu/eval_harness.py``): load each run's newest checkpoint,
run the predict sweep over the holdout loader, and print, and optionally
write as CSV, a table of the metrics rounded to 3 decimals.

    python -m vision_mtl_tpu_torch.eval_harness --dataset_name nyuv2 \\
        --runs basic=/path/to/run_dir mtan:tuned=/path/to/run_dir2 \\
        [--data_dir DIR] [--out metrics.csv] [--compare_baseline]
    python -m vision_mtl_tpu_torch.eval_harness --dataset_name cityscapes \
        --from_registry [--registry PATH]

Each ``--runs`` entry is ``{model_name}[:tag]={run_dir}``: the run
directory holding ``model_{epoch}`` checkpoints (the newest is taken) and
``train_args.yaml``, from which the architecture is rebuilt. The table is
a dict of dicts, ``table[metric][tag]``, its rows in ``METRIC_ORDER``.
``--from_registry`` evaluates every run of the dataset in the run registry
(``tracking/artifacts.py``), which the training CLI fills, each under its
key. A run dir of the JAX package (Orbax checkpoints) is refused by name.
It runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import re
import typing as t

import numpy as np
import torch

from vision_mtl_tpu_torch.cfg import fetch_data_cfg
from vision_mtl_tpu_torch.data.datamodule import MTLDataModule
from vision_mtl_tpu_torch.device import resolve_device
from vision_mtl_tpu_torch.pipeline import load_run_model as load_pipeline_run_model
from vision_mtl_tpu_torch.predict import predict

METRIC_ORDER = ["loss", "accuracy", "jaccard_index", "fbeta_score", "mae"]

Table = t.Dict[str, t.Dict[str, float]]


def load_run_model(
    model_name: str,
    ckpt_dir: str,
    dataset_name: str,
    channel_wise_stitching: bool = False,
    precision: t.Optional[str] = None,
    device: t.Union[str, torch.device] = "cuda",
) -> t.Tuple[torch.nn.Module, t.Any, t.Dict[str, t.Any]]:
    """The architecture a run dir was trained with, in eval mode, with its
    newest checkpoint. Returns ``(model, data_cfg, run_args)``. Without a
    ``train_args.yaml`` the training CLI's defaults apply
    (``channel_wise_stitching`` False, bf16); an explicit ``precision``
    wins over the recorded one."""
    if not os.path.exists(os.path.join(ckpt_dir, "train_args.yaml")) and model_name == "csnet":
        print(
            f"WARNING: {ckpt_dir} has no train_args.yaml; assuming "
            f"channel_wise_stitching={channel_wise_stitching}. Pass the flag explicitly if "
            "the checkpoint was trained otherwise."
        )
    model, data_cfg, run_args = load_pipeline_run_model(
        ckpt_dir,
        device,
        model_name=model_name,
        dataset_name=dataset_name,
        defaults={"channel_wise_stitching": channel_wise_stitching, "precision": "bf16"},
        overrides={"precision": precision} if precision else None,
    )
    return model, data_cfg, vars(run_args)


def evaluate_run(
    model_name: str,
    ckpt_dir: str,
    dataset_name: str,
    batch_size: int = 8,
    loss_segm_weight: float = 1.0,
    loss_depth_weight: float = 1.0,
    channel_wise_stitching: bool = False,
    precision: t.Optional[str] = None,
    device: t.Union[str, torch.device] = "cuda",
    data_dir: t.Optional[str] = None,
) -> t.Dict[str, float]:
    """The predict sweep's metrics of a run over the dataset's holdout
    stage, keyed without the ``predict/`` prefix. The run's recorded loss
    weights win over the arguments. ``data_dir`` points the dataset's
    config elsewhere for this call."""
    dev = resolve_device(device)
    model, data_cfg, run_args = load_run_model(
        model_name, ckpt_dir, dataset_name, channel_wise_stitching, precision, dev
    )
    loss_segm_weight = run_args.get("loss_segm_weight", loss_segm_weight)
    loss_depth_weight = run_args.get("loss_depth_weight", loss_depth_weight)
    saved_dir = data_cfg.data_dir
    if data_dir:
        data_cfg.data_dir = data_dir
    try:
        dm = MTLDataModule(
            dataset_name,
            batch_size=batch_size,
            num_workers=data_cfg.num_workers,
            train_transform=data_cfg.train_transform,
            test_transform=data_cfg.test_transform,
        )
        dm.setup(stage="predict")
        _, metrics = predict(
            dm.predict_dataloader(),
            model,
            num_classes=data_cfg.num_classes,
            loss_segm_weight=loss_segm_weight,
            loss_depth_weight=loss_depth_weight,
            device=dev,
        )
    finally:
        data_cfg.data_dir = saved_dir
    return {k.replace("predict/", ""): v for k, v in metrics.items()}


def _refuse_jax_checkpoint(run_dir: str) -> None:
    """SystemExit when ``run_dir``'s checkpoints are all the JAX package's:
    ``model_{e}/`` directories without the port's ``model.pt`` (Orbax),
    and no reference ``model_{e}.pt``."""
    if not os.path.isdir(run_dir):
        return
    from vision_mtl_tpu_torch.train.checkpoint import MODEL_FILE, _epochs

    dirs = [os.path.join(run_dir, f"model_{e}") for e in _epochs(run_dir, "model")]
    dirs = [d for d in dirs if os.path.isdir(d)]
    reference = [f for f in os.listdir(run_dir) if re.fullmatch(r"model_\d+\.pt", f)]
    if dirs and not reference and not any(
            os.path.exists(os.path.join(d, MODEL_FILE)) for d in dirs):
        raise SystemExit(
            f"{run_dir}: a JAX (Orbax) checkpoint — its model_{{epoch}}/ directories hold no "
            f"{MODEL_FILE}; the port reads its own run dirs and the reference's model_{{epoch}}.pt"
            ", not Orbax. Evaluate it with vision_mtl_tpu.eval_harness."
        )


def _round3(v: float) -> float:
    # numpy's rounding (scale, round half to even, unscale), which the JAX
    # package's pandas tables use
    return float(np.round(v, 3))


def _columns(table: Table) -> t.List[str]:
    return list(next(iter(table.values())).keys()) if table else []


def build_table(results: t.Mapping[str, t.Mapping[str, float]]) -> Table:
    """Rows are metrics in ``METRIC_ORDER``, columns the run tags, values
    rounded to 3 decimals; a metric a run lacks is NaN."""
    return {
        m: {tag: _round3(res.get(m, math.nan)) for tag, res in results.items()}
        for m in METRIC_ORDER
    }


#: The reference's published validation tables, by dataset and baseline
#: column (reference README.md:249-255 and :270-276).
REFERENCE_BASELINES: t.Dict[str, t.Dict[str, t.Dict[str, float]]] = {
    "cityscapes": {
        "HS": {"loss": 4.537, "accuracy": 0.805, "jaccard_index": 0.279,
               "fbeta_score": 0.795, "mae": 0.043},
        "HS (P)": {"loss": 3.395, "accuracy": 0.856, "jaccard_index": 0.358,
                   "fbeta_score": 0.851, "mae": 0.045},
        "HS tuned": {"loss": 4.455, "accuracy": 0.783, "jaccard_index": 0.248,
                     "fbeta_score": 0.770, "mae": 0.041},
        "CSNet": {"loss": 5.912, "accuracy": 0.753, "jaccard_index": 0.222,
                  "fbeta_score": 0.731, "mae": 0.057},
        "MTAN": {"loss": 3.633, "accuracy": 0.860, "jaccard_index": 0.385,
                 "fbeta_score": 0.856, "mae": 0.060},
    },
    "nyuv2": {
        "HS": {"loss": 4.893, "accuracy": 0.511, "jaccard_index": 0.226,
               "fbeta_score": 0.501, "mae": 0.049},
        "HS (P)": {"loss": 4.904, "accuracy": 0.508, "jaccard_index": 0.222,
                   "fbeta_score": 0.496, "mae": 0.050},
        "HS tuned": {"loss": 6.048, "accuracy": 0.329, "jaccard_index": 0.109,
                     "fbeta_score": 0.307, "mae": 0.079},
        "CSNet": {"loss": 5.978, "accuracy": 0.411, "jaccard_index": 0.136,
                  "fbeta_score": 0.366, "mae": 0.083},
        "MTAN": {"loss": 5.759, "accuracy": 0.501, "jaccard_index": 0.223,
                 "fbeta_score": 0.483, "mae": 0.073},
    },
}

#: model_name -> baseline column; a basic run's tag picks its HS variant
_MODEL_TO_BASELINE = {"basic": "HS", "csnet": "CSNet", "mtan": "MTAN"}


def _baseline_column(model_name: str, tag: str) -> t.Optional[str]:
    col = _MODEL_TO_BASELINE.get(model_name)
    if col == "HS":
        low = tag.lower()
        if "tuned" in low or "best_trial" in low:
            return "HS tuned"
        if "(p)" in low or low.endswith("_p") or "pretrained" in low:
            return "HS (P)"
    return col


def compare_to_baseline(
    table: Table, dataset_name: str, tag_to_model: t.Mapping[str, str]
) -> t.Optional[Table]:
    """Ours minus the reference's published numbers, per metric and run
    (``"{tag} vs {column}"``), rounded to 3 decimals; a negative loss or
    mae and a positive accuracy, jaccard or fbeta delta is better. None
    when the dataset has no published table or no run maps to a column."""
    base = REFERENCE_BASELINES.get(dataset_name)
    if not base:
        return None
    deltas: t.Dict[str, t.Dict[str, float]] = {}
    for tag in _columns(table):
        col = _baseline_column(tag_to_model.get(tag, tag), tag)
        if col is None or col not in base:
            continue
        deltas[f"{tag} vs {col}"] = {
            m: table[m][tag] - ref
            for m, ref in base[col].items()
            if m in table and not math.isnan(table[m][tag])
        }
    if not deltas:
        return None
    return {m: {name: _round3(d.get(m, math.nan)) for name, d in deltas.items()}
            for m in METRIC_ORDER}


def format_table(table: Table) -> str:
    """The table as aligned text, one row per metric."""
    cols = _columns(table)
    cells = [[""] + cols] + [[m] + [str(table[m][c]) for c in cols] for m in table]
    widths = [max(len(row[i]) for row in cells) for i in range(len(cells[0]))]
    return "\n".join(
        "  ".join(cell.ljust(w) if i == 0 else cell.rjust(w)
                  for i, (cell, w) in enumerate(zip(row, widths)))
        for row in cells
    )


def write_csv(table: Table, path: str) -> None:
    """The table as CSV, laid out as the JAX package's ``to_csv`` writes
    it: an unnamed index column of metrics, a NaN as an empty cell."""
    cols = _columns(table)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + cols)
        for m, row in table.items():
            w.writerow([m] + ["" if math.isnan(row[c]) else repr(row[c]) for c in cols])


def main(argv: t.Optional[t.Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_name", default="cityscapes")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: the card; raises without one) or 'cpu'.")
    p.add_argument("--runs", nargs="+", default=None,
                   help="entries like model_name[:tag]=run_dir")
    p.add_argument("--from_registry", action="store_true",
                   help="evaluate every registered run for --dataset_name (the local registry "
                   "training runs publish to; tracking/artifacts.py)")
    p.add_argument("--registry", default=None,
                   help="registry file override (default: {log_root}/run_registry.json)")
    p.add_argument("--data_dir", default=None,
                   help="the dataset's directory (default: its config's)")
    p.add_argument("--out", default=None, help="CSV output path")
    p.add_argument("--compare_baseline", action="store_true",
                   help="also print deltas against the reference README's validation "
                   "tables; meaningful only on the real Cityscapes or NYUv2 data")
    args = p.parse_args(argv)
    if bool(args.runs) == bool(args.from_registry):
        raise SystemExit("pass exactly one of --runs / --from_registry")
    device = resolve_device(args.device)
    fetch_data_cfg(args.dataset_name)  # an unknown dataset fails before any run loads

    todo: t.List[t.Tuple[str, str, str]] = []  # (tag, model_name, run_dir)
    if args.from_registry:
        from vision_mtl_tpu_torch.tracking.artifacts import registered_runs

        entries = registered_runs(args.dataset_name, path=args.registry)
        if not entries:
            raise SystemExit(
                f"no registered runs for dataset {args.dataset_name!r} — "
                f"train something first (training.main registers runs on "
                f"completion) or pass --runs explicitly."
            )
        todo = [(tag, e["model_name"], e["run_dir"]) for tag, e in entries.items()]
    else:
        for entry in args.runs:
            spec, _, ckpt_dir = entry.partition("=")
            model_name, _, tag = spec.partition(":")
            todo.append((tag or model_name, model_name, ckpt_dir))
    for _, _, ckpt_dir in todo:  # before any run loads
        _refuse_jax_checkpoint(ckpt_dir)

    results: t.Dict[str, t.Dict[str, float]] = {}
    for tag, model_name, ckpt_dir in todo:
        if tag in results:
            raise SystemExit(
                f"duplicate tag {tag!r} in --runs — give each run a unique tag "
                "(model_name:tag=dir), or the first result is lost."
            )
        print(f"Evaluating {tag} ({model_name}) from {ckpt_dir} ...")
        results[tag] = evaluate_run(model_name, ckpt_dir, args.dataset_name, args.batch_size,
                                    device=device, data_dir=args.data_dir)

    table = build_table(results)
    print(format_table(table))
    if args.compare_baseline:
        cmp = compare_to_baseline(table, args.dataset_name, {tag: m for tag, m, _ in todo})
        if cmp is None:
            print("(no reference baseline table for this dataset)")
        else:
            print("\ndelta vs reference README (ours - reference; loss/mae negative = better, "
                  "others positive = better):")
            print(format_table(cmp))
    if args.out:
        write_csv(table, args.out)
        print(f"Wrote {args.out}")


if __name__ == "__main__":
    main()
