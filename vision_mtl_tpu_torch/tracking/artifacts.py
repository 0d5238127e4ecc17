"""Trained runs: the comet artifact download and the local registry of
finished runs (counterpart of ``vision_mtl_tpu/tracking/artifacts.py``).

The download needs ``comet_ml`` and the credentials, and raises without
them; a test passes its own ``api``. A downloaded ``model_{e}`` directory
is the port's checkpoint layout, ``model_{e}/model.pt``.

The registry is a JSON file under the run-dir root, filled by
``training.main`` at the end of every run that wrote a checkpoint and read
by ``eval_harness --from_registry``: ``{key: {dataset: {"model_name",
"run_dir"}}}``, the newest run of a key and dataset winning. Its bytes are
the JAX package's for the same calls, so either package reads the
other's.
"""

from __future__ import annotations

import json
import os
import re
import typing as t

from vision_mtl_tpu_torch.cfg import cfg

# model key -> dataset -> comet experiment name (empty until runs are
# published)
model_to_exp_name: t.Dict[str, t.Dict[str, str]] = {}


def _api():
    try:
        from comet_ml.api import API
    except ImportError as e:
        raise RuntimeError("comet_ml is not installed; artifact download unavailable") from e
    if cfg.logger.api_key is None:
        raise RuntimeError("comet credentials missing (.env)")
    return API(api_key=cfg.logger.api_key)


def get_latest_ckpt_epoch(
    exp_name: str,
    model_name_regex: str = r"model_(\d+)",
    project_name: t.Optional[str] = None,
    api: t.Any = None,
) -> int:
    """The newest checkpoint epoch among an experiment's assets."""
    api = api or _api()
    project_name = project_name or cfg.logger.project_name
    exp_api = api.get(f"{cfg.logger.username}/{project_name}/{exp_name}")
    epochs = [
        int(m.group(1))
        for x in exp_api.get_asset_list(asset_type="all")
        if (m := re.match(model_name_regex, x["fileName"]))
    ]
    if not epochs:
        raise ValueError(f"No checkpoints found in {exp_name}")
    return max(epochs)


def load_artifacts_from_comet(
    exp_name: str,
    local_artifacts_dir: str,
    model_artifact_name: str = "model",
    args_name_no_ext: str = "train_args",
    session_artifact_name: t.Optional[str] = None,
    project_name: t.Optional[str] = None,
    api: t.Any = None,
    epoch: t.Optional[int] = None,
) -> t.Dict[str, t.Optional[str]]:
    """Download an experiment's args, its checkpoint of ``epoch`` (the
    newest by default) and optionally a session artifact into
    ``local_artifacts_dir``; what is already there is not downloaded again.
    Returns the local paths ``{"checkpoint_path", "args_path"[,
    "session_path"]}``, None for an asset that was not found."""
    api = api or _api()
    project_name = project_name or cfg.logger.project_name
    exp_api = api.get(f"{cfg.logger.username}/{project_name}/{exp_name}")
    os.makedirs(local_artifacts_dir, exist_ok=True)
    assets = exp_api.get_asset_list(asset_type="all")

    def fetch(match: str, dst: str) -> t.Optional[str]:
        if os.path.exists(dst):
            return dst
        hits = [x for x in assets if match in x["fileName"]]
        if not hits:
            print(f"No asset found matching {match}")
            return None
        api.download_experiment_asset(exp_api.id, hits[0]["assetId"], dst)
        return dst

    def fetch_ckpt_dir(prefix: str, dst_dir: str) -> t.Optional[str]:
        """A checkpoint directory logged file by file as
        ``{prefix}/<relpath>``: the match is anchored at a path boundary
        (``model_5`` never takes ``model_50/...``), and each file lands at
        its relative path."""
        if os.path.exists(dst_dir):
            return dst_dir
        pat = re.compile(rf"{re.escape(prefix)}(/|$)")
        hits = [x for x in assets if pat.match(x["fileName"])]
        if not hits:
            print(f"No asset found matching {prefix}")
            return None
        multi = any(x["fileName"] != prefix for x in hits)
        for x in hits:
            rel = x["fileName"][len(prefix):].lstrip("/")
            if not rel and multi:
                # a file at dst_dir would shadow the directory its siblings fill
                print(f"Skipping asset {x['fileName']!r}: names the "
                      f"checkpoint dir itself, not a file within it")
                continue
            # asset names come from the server: no '..' out of dst_dir (the
            # lstrip above already made every name relative)
            if rel and os.path.normpath(rel).split(os.sep)[0] == "..":
                print(f"Skipping asset {x['fileName']!r}: path escapes "
                      f"the artifacts dir")
                continue
            # a lone asset named like the prefix is a one-file checkpoint
            dst = os.path.join(dst_dir, rel) if rel else dst_dir
            os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
            api.download_experiment_asset(exp_api.id, x["assetId"], dst)
        return dst_dir

    args_path = fetch(
        args_name_no_ext, os.path.join(local_artifacts_dir, f"{args_name_no_ext}.yaml")
    )
    if epoch is None:
        epoch = get_latest_ckpt_epoch(exp_name, project_name=project_name, api=api)
    ckpt_path = fetch_ckpt_dir(
        f"{model_artifact_name}_{epoch}",
        os.path.join(local_artifacts_dir, f"{model_artifact_name}_{epoch}"),
    )
    results: t.Dict[str, t.Optional[str]] = {"checkpoint_path": ckpt_path, "args_path": args_path}
    if session_artifact_name is not None:
        results["session_path"] = fetch_ckpt_dir(
            session_artifact_name, os.path.join(local_artifacts_dir, session_artifact_name)
        )
    return results


def registry_path() -> str:
    """The default registry: ``{log_root}/run_registry.json``."""
    return os.path.join(str(cfg.log_root_dir), "run_registry.json")


def run_registry_key(args: t.Any) -> str:
    """A finished run's key: ``--run_name`` when given, else the model name
    with ``_pretrained`` for imagenet encoder weights and ``_tuned`` after a
    ``--do_optimize`` sweep."""
    if getattr(args, "run_name", None):
        return str(args.run_name)
    key = str(args.model_name)
    if getattr(args, "backbone_weights", None):
        key += "_pretrained"
    if getattr(args, "do_optimize", False):
        key += "_tuned"
    return key


def load_registry(path: t.Optional[str] = None) -> t.Dict[str, t.Any]:
    """The registry's ``{key: {dataset: {"model_name", "run_dir"}}}``; {}
    when the file does not exist."""
    path = path or registry_path()
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: expected a JSON object at top level")
    return data


def register_run(
    model_name: str,
    dataset_name: str,
    run_dir: str,
    key: t.Optional[str] = None,
    path: t.Optional[str] = None,
) -> str:
    """Record a trained run under ``key`` (default: the model name) for
    ``dataset_name``, replacing that key's run of the dataset. The
    read-modify-write holds an ``flock`` on a ``.lock`` sibling, so runs
    finishing at once keep both entries, and the write is atomic. Returns
    the registry path."""
    from vision_mtl_tpu_torch.utils.io import atomic_write_json, file_lock

    path = path or registry_path()
    key = key or model_name
    with file_lock(path + ".lock"):
        data = load_registry(path)
        data.setdefault(key, {})[dataset_name] = {
            "model_name": model_name,
            "run_dir": os.path.abspath(run_dir),
        }
        atomic_write_json(path, data, indent=2, sort_keys=True)
    return path


def registered_runs(
    dataset_name: str, path: t.Optional[str] = None
) -> t.Dict[str, t.Dict[str, str]]:
    """``{key: {"model_name", "run_dir"}}`` of one dataset, by key; an entry
    whose run dir no longer exists is skipped with a note."""
    out: t.Dict[str, t.Dict[str, str]] = {}
    for key, per_ds in sorted(load_registry(path).items()):
        entry = per_ds.get(dataset_name)
        if entry is None:
            continue
        if not os.path.isdir(entry["run_dir"]):
            print(f"registry: skipping {key!r} — run dir no longer exists: {entry['run_dir']}")
            continue
        out[key] = entry
    return out
