"""Checkpoint and resume (counterpart of ``vision_mtl_tpu/train/checkpoint.py``).

Each save epoch writes two directories into the run dir, with the JAX
package's names: ``model_{e}/`` (the model's ``state_dict``: parameters
and BatchNorm statistics) and ``session_{e}/`` (the optimizer's
``state_dict``, the lr, the plateau scheduler, ``epoch`` and ``step``),
each holding one ``torch.save`` file with every tensor on the CPU. Each is
written under a temporary name and renamed into place, so a reader finds a
complete artifact or none. The CLI args go to ``train_args.yaml``, a flat
YAML mapping under ``args:`` written and read without PyYAML.

A preemption (``train/preempt.py``) writes ``preempt_model/`` and
``preempt_session/`` the same way, the session with the interrupted
epoch's position and metric accumulators, and a ``preempt_meta.json``
sidecar with the position, which ``resolve_resume`` compares with the
newest epoch checkpoint.

Under several ranks every rank holds the same state: rank 0 writes each
checkpoint, then every rank passes a barrier, so no rank goes on (or
restores) before the files are complete. Every rank restores.

The names ``model_{e}.pt`` and ``session_{e}.pt`` belong to the reference
PyTorch code's checkpoints (and to the JAX package's export of its runs):
``restore_state`` and ``restore_session`` import a run dir that holds them
(``utils/ckpt_import.py``), and the port's own ``model_{e}/`` artifacts win
where both are present. ``load_args`` reads the ``train_args.yaml`` that
PyYAML writes for the reference and the JAX package as well as the port's
own.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import tempfile
import typing as t

import torch

from vision_mtl_tpu_torch.metrics import MetricState
from vision_mtl_tpu_torch.parallel.multihost import current, process_info
from vision_mtl_tpu_torch.train.plateau import ReduceLROnPlateau
from vision_mtl_tpu_torch.train.state import TrainState, get_lr, set_lr
from vision_mtl_tpu_torch.utils.io import atomic_write_json

MODEL_FILE = "model.pt"
SESSION_FILE = "session.pt"


def _to_cpu(tree: t.Any) -> t.Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _save_dir_atomic(obj: t.Any, path: str, filename: str) -> None:
    """``torch.save(obj)`` as ``path/filename``: written into a temporary
    directory beside ``path``, then renamed onto it (an existing ``path`` is
    removed first, as the JAX package's forced save overwrites)."""
    parent = os.path.dirname(path)
    tmp = tempfile.mkdtemp(prefix=f".{os.path.basename(path)}.", dir=parent)
    try:
        torch.save(obj, os.path.join(tmp, filename))
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _rank0_writes(write: t.Callable[[], None]) -> None:
    """``write()`` on rank 0 (the only rank in one process), then a barrier
    of every rank."""
    if process_info()[0] == 0:
        write()
    comm = current()
    if comm is not None and comm.world > 1:
        comm.barrier()


def save_ckpt(
    state: TrainState, scheduler: ReduceLROnPlateau, epoch: int, save_dir: str,
    exp: t.Any = None,
) -> t.Tuple[str, str]:
    """Write ``model_{epoch}`` and ``session_{epoch}``, and log both to
    ``exp`` if it is a live experiment; returns their paths. Blocks until
    both are on disk. Collective under several ranks (rank 0 writes)."""
    model_path = os.path.abspath(os.path.join(save_dir, f"model_{epoch}"))
    session_path = os.path.abspath(os.path.join(save_dir, f"session_{epoch}"))
    _rank0_writes(lambda: _write_ckpt(state, scheduler, epoch, save_dir, exp, model_path,
                                      session_path))
    return model_path, session_path


def _write_ckpt(state: TrainState, scheduler: ReduceLROnPlateau, epoch: int, save_dir: str,
                exp: t.Any, model_path: str, session_path: str) -> None:
    os.makedirs(save_dir, exist_ok=True)
    _save_dir_atomic(_to_cpu(state.model.state_dict()), model_path, MODEL_FILE)
    session = {
        "optimizer": _to_cpu(state.optimizer.state_dict()),
        "lr": get_lr(state),
        "scheduler": scheduler.state_dict(),
        "epoch": epoch,
        "step": int(state.step),
    }
    _save_dir_atomic(session, session_path, SESSION_FILE)
    if exp:
        from vision_mtl_tpu_torch.tracking.comet import log_ckpt_to_exp

        log_ckpt_to_exp(exp, model_path)
        log_ckpt_to_exp(exp, session_path)
    print(f"Saved model to {model_path}")


def _epochs(ckpt_dir: str, prefix: str) -> t.List[int]:
    pattern = re.compile(rf"{prefix}_(\d+)$")
    return [int(m.group(1)) for f in os.listdir(ckpt_dir) if (m := pattern.match(f))]


def _latest_epoch(ckpt_dir: str, prefix: str) -> int:
    epochs = _epochs(ckpt_dir, prefix)
    if not epochs:
        raise ValueError(f"No {prefix} ckpt found in {ckpt_dir}")
    return max(epochs)


def _latest_common_epoch(ckpt_dir: str) -> int:
    """The latest epoch with both a model and a session artifact: a crash
    between the two saves can leave model_N without session_N."""
    common = set(_epochs(ckpt_dir, "model")) & set(_epochs(ckpt_dir, "session"))
    if not common:
        raise ValueError(
            f"No epoch with both model_* and session_* artifacts in "
            f"{ckpt_dir} — cannot exact-resume (use --ckpt_dir for a "
            f"weights-only warm start)."
        )
    return max(common)


def load_ckpt_model(ckpt_dir: str, epoch: t.Optional[int] = None) -> t.Dict[str, torch.Tensor]:
    """The model ``state_dict`` of ``epoch`` (the latest by default), on the
    CPU."""
    if epoch is None:
        epoch = _latest_epoch(ckpt_dir, "model")
    path = os.path.abspath(os.path.join(ckpt_dir, f"model_{epoch}"))
    print(f"Loading model from {path}")
    return torch.load(os.path.join(path, MODEL_FILE), map_location="cpu", weights_only=True)


def load_ckpt_session(ckpt_dir: str, epoch: t.Optional[int] = None) -> t.Dict[str, t.Any]:
    if epoch is None:
        epoch = _latest_epoch(ckpt_dir, "session")
    path = os.path.join(ckpt_dir, f"session_{epoch}", SESSION_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


def _maybe_reference_torch_ckpt(ckpt_dir: str, epoch: t.Optional[int]) -> t.Optional[str]:
    """Path to a reference-format torch ``model_{e}.pt`` when ``ckpt_dir``
    holds one (and no ``model_{e}/`` artifacts of the port, which always
    win), else None. Accepts a direct ``*.pt`` file path too, so
    ``--ckpt_dir``, ``serve --run_dir`` and the harness take reference run
    dirs as they are."""
    from vision_mtl_tpu_torch.utils.ckpt_import import find_reference_checkpoint

    if os.path.isfile(ckpt_dir) and ckpt_dir.endswith(".pt"):
        return ckpt_dir
    if not os.path.isdir(ckpt_dir) or _epochs(ckpt_dir, "model"):
        return None
    if epoch is not None:
        path = os.path.join(ckpt_dir, f"model_{epoch}.pt")
        return path if os.path.isfile(path) else None
    return find_reference_checkpoint(ckpt_dir)


def restore_model(
    model: torch.nn.Module,
    ckpt_dir: str,
    epoch: t.Optional[int] = None,
    reference_sd: t.Optional[t.Mapping[str, t.Any]] = None,
) -> None:
    """The checkpoint's parameters and BatchNorm statistics into ``model``
    in place (shapes checked, strict both ways): the port's ``model_{e}/``,
    or a reference ``model_{e}.pt``, which is imported
    (``utils/ckpt_import.py``); ``reference_sd`` is that file's state_dict
    when the caller has read it already."""
    ref_pt = _maybe_reference_torch_ckpt(ckpt_dir, epoch)
    if ref_pt is not None:
        from vision_mtl_tpu_torch.utils.ckpt_import import import_model
        from vision_mtl_tpu_torch.utils.torch_port import load_state_dict_file

        print(f"Importing reference torch checkpoint {ref_pt}")
        import_model(model, reference_sd if reference_sd is not None
                     else load_state_dict_file(ref_pt))
        return
    model.load_state_dict(load_ckpt_model(ckpt_dir, epoch))


def restore_state(state: TrainState, ckpt_dir: str, epoch: t.Optional[int] = None) -> TrainState:
    """Warm start: the checkpoint's parameters and BatchNorm statistics
    into ``state.model`` (:func:`restore_model`); the optimizer stays
    fresh."""
    restore_model(state.model, ckpt_dir, epoch)
    return state


def restore_session(
    state: TrainState,
    scheduler: ReduceLROnPlateau,
    ckpt_dir: str,
    epoch: t.Optional[int] = None,
) -> t.Tuple[TrainState, ReduceLROnPlateau, int]:
    """Exact resume: weights, BatchNorm statistics, Adam's moments and
    steps, the lr, the plateau scheduler and the step counter. Returns
    ``(state, scheduler, start_epoch)``, the epoch after the checkpoint's.
    The optimizer's state is loaded after the model sits on its device, so
    the moments land beside their parameters.

    Also resumes from the reference's torch artifact pair (``model_{e}.pt``
    + ``session_{e}.pt``): weights, Adam's moments, lr, plateau state and
    epoch all import (``utils/ckpt_import.py``), so a reference-trained run
    continues here."""
    ref_pt = _maybe_reference_torch_ckpt(ckpt_dir, epoch)
    if ref_pt is not None:
        from vision_mtl_tpu_torch.utils.ckpt_import import (
            import_into_state,
            import_reference_session,
            load_reference_session,
        )
        from vision_mtl_tpu_torch.utils.torch_port import load_state_dict_file

        base = os.path.basename(ref_pt)
        if not base.startswith("model_"):
            raise ValueError(
                f"{ref_pt} is a torch checkpoint, but a session sibling can "
                "only be inferred from the reference's model_{e}.pt naming — "
                "for a weights-only warm start use --ckpt_dir instead of "
                "--resume_dir."
            )
        sess_pt = os.path.join(os.path.dirname(ref_pt), base.replace("model_", "session_", 1))
        if not os.path.isfile(sess_pt):
            raise ValueError(
                f"found reference torch checkpoint {ref_pt} but no matching "
                f"{os.path.basename(sess_pt)} — a full resume needs the "
                "session artifact (optimizer/scheduler/epoch). For a "
                "weights-only warm start use --ckpt_dir instead."
            )
        sd = load_state_dict_file(ref_pt)  # loaded once for both steps
        state = import_into_state(state, sd)
        print(f"Imported reference torch checkpoint {ref_pt}; importing session {sess_pt}")
        return import_reference_session(sd, load_reference_session(sess_pt), state, scheduler)
    if epoch is None:
        epoch = _latest_common_epoch(ckpt_dir)
    state = restore_state(state, ckpt_dir, epoch)
    session = load_ckpt_session(ckpt_dir, epoch)
    state.optimizer.load_state_dict(session["optimizer"])
    state = set_lr(state, float(session["lr"]))
    state.step = int(session["step"])
    scheduler.load_state_dict(session["scheduler"])
    return state, scheduler, int(session["epoch"]) + 1


PREEMPT_MODEL = "preempt_model"
PREEMPT_SESSION = "preempt_session"
PREEMPT_META = "preempt_meta.json"


def save_preempt_ckpt(
    state: TrainState,
    scheduler: ReduceLROnPlateau,
    epoch: int,
    batch_in_epoch: int,
    train_mstate: MetricState,
    val_step: int,
    save_dir: str,
) -> t.Tuple[str, str]:
    """The mid-epoch checkpoint of a preemption: the model, and a session
    with the optimizer, lr, scheduler, step, the interrupted ``epoch``, the
    ``batch_in_epoch`` batches of it already trained, its train metric
    accumulators and the validation step counter. The caller waits for the
    device's queued work first. The position sidecar goes last, written
    atomically and synced: this runs inside the grace period, and a torn
    sidecar would stop every later ``--auto_resume``. Collective under
    several ranks (rank 0 writes)."""
    model_path = os.path.abspath(os.path.join(save_dir, PREEMPT_MODEL))
    session_path = os.path.abspath(os.path.join(save_dir, PREEMPT_SESSION))
    _rank0_writes(lambda: _write_preempt_ckpt(
        state, scheduler, epoch, batch_in_epoch, train_mstate, val_step, save_dir, model_path,
        session_path))
    return model_path, session_path


def _write_preempt_ckpt(state: TrainState, scheduler: ReduceLROnPlateau, epoch: int,
                        batch_in_epoch: int, train_mstate: MetricState, val_step: int,
                        save_dir: str, model_path: str, session_path: str) -> None:
    os.makedirs(save_dir, exist_ok=True)
    _save_dir_atomic(_to_cpu(state.model.state_dict()), model_path, MODEL_FILE)
    session = {
        "optimizer": _to_cpu(state.optimizer.state_dict()),
        "lr": get_lr(state),
        "scheduler": scheduler.state_dict(),
        "epoch": epoch,
        "step": int(state.step),
        "batch_in_epoch": batch_in_epoch,
        "val_step": int(val_step),
        "train_metrics": {
            f.name: _to_cpu(getattr(train_mstate, f.name))
            for f in dataclasses.fields(train_mstate)
        },
    }
    _save_dir_atomic(session, session_path, SESSION_FILE)
    atomic_write_json(
        os.path.join(save_dir, PREEMPT_META),
        {"epoch": epoch, "batch_in_epoch": batch_in_epoch},
        fsync=True,
    )
    print(f"Preemption checkpoint saved to {model_path} (epoch {epoch}, batch {batch_in_epoch})")


def _has_preempt_ckpt(ckpt_dir: str) -> bool:
    return (
        os.path.isdir(os.path.join(ckpt_dir, PREEMPT_MODEL))
        and os.path.isdir(os.path.join(ckpt_dir, PREEMPT_SESSION))
        and os.path.exists(os.path.join(ckpt_dir, PREEMPT_META))
    )


def resolve_resume(ckpt_dir: str) -> str:
    """``"preempt"`` when the preemption checkpoint is the newest training
    state in ``ckpt_dir``, else ``"epoch"``: positions compare as ``(epoch,
    batch_in_epoch)`` against ``(latest epoch + 1, 0)``, so a preemption
    checkpoint that later epoch saves superseded loses."""
    if not _has_preempt_ckpt(ckpt_dir):
        return "epoch"
    try:
        with open(os.path.join(ckpt_dir, PREEMPT_META)) as f:
            meta = json.load(f)
        preempt_pos = (int(meta["epoch"]), int(meta["batch_in_epoch"]))
    except (ValueError, KeyError, TypeError, OSError) as e:
        # the sidecar only caches the position, which the session holds:
        # without epoch checkpoints the preemption one is the only state;
        # with them, recency cannot be decided and the epoch ones are taken
        # (at worst the interrupted epoch is trained again from its start)
        try:
            _latest_common_epoch(ckpt_dir)
        except ValueError:
            choice = "preempt"
        else:
            choice = "epoch"
        print(
            f"WARNING: unreadable {PREEMPT_META} in {ckpt_dir} ({type(e).__name__}: {e}); "
            f"resuming from the {'preemption' if choice == 'preempt' else 'epoch'} checkpoint."
        )
        return choice
    try:
        epoch_pos = (_latest_common_epoch(ckpt_dir) + 1, 0)
    except ValueError:
        return "preempt"
    return "preempt" if preempt_pos > epoch_pos else "epoch"


def restore_preempt(
    state: TrainState,
    scheduler: ReduceLROnPlateau,
    ckpt_dir: str,
    num_classes: int,
) -> t.Tuple[TrainState, ReduceLROnPlateau, int, int, MetricState, int]:
    """Restore a preemption checkpoint. Returns ``(state, scheduler, epoch,
    batch_in_epoch, train_mstate, val_step)``: ``epoch`` is the interrupted
    one, to continue (not the next), and ``batch_in_epoch`` the number of
    its batches already trained. The accumulators land on the model's
    device."""
    path = os.path.join(ckpt_dir, PREEMPT_MODEL, MODEL_FILE)
    state.model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    session = torch.load(os.path.join(ckpt_dir, PREEMPT_SESSION, SESSION_FILE),
                         map_location="cpu", weights_only=True)
    state.optimizer.load_state_dict(session["optimizer"])
    state = set_lr(state, float(session["lr"]))
    state.step = int(session["step"])
    scheduler.load_state_dict(session["scheduler"])
    device = next(state.model.parameters()).device
    saved = session["train_metrics"]
    if saved["confmat"].shape != (num_classes, num_classes):
        raise ValueError(
            f"{ckpt_dir}: the preemption checkpoint counts {saved['confmat'].shape[0]} "
            f"classes, not {num_classes}"
        )
    mstate = MetricState(**{k: v.to(device) for k, v in saved.items()})
    return (
        state,
        scheduler,
        int(session["epoch"]),
        int(session["batch_in_epoch"]),
        mstate,
        int(session["val_step"]),
    )


def _is_resumable(d: str) -> bool:
    if _has_preempt_ckpt(d):
        return True
    try:
        _latest_common_epoch(d)
        return True
    except (ValueError, OSError):
        return False


def prune_old_ckpts(save_dir: str, keep_last_k: int) -> t.List[int]:
    """Delete all but the newest ``keep_last_k`` epochs' model and session
    pairs (both go together); returns the pruned epochs. ``keep_last_k <=
    0`` keeps every epoch."""
    if keep_last_k <= 0:
        return []
    epochs = sorted(set(_epochs(save_dir, "model")) | set(_epochs(save_dir, "session")))
    pruned = epochs[:-keep_last_k] if len(epochs) > keep_last_k else []
    for e in pruned:
        for prefix in ("model", "session"):
            shutil.rmtree(os.path.join(save_dir, f"{prefix}_{e}"), ignore_errors=True)
    return pruned


def find_latest_resumable_run(base_dir: str) -> t.Optional[str]:
    """The most recently written run dir under ``base_dir`` (``version_*``,
    or one level deeper under a run name) that holds a preemption
    checkpoint or a complete model and session epoch pair; None when there
    is none. Backs ``--auto_resume``."""
    if not os.path.isdir(base_dir):
        return None
    pattern = re.compile(r"version_(\d+)$")
    candidates: t.List[str] = []
    for name in os.listdir(base_dir):
        d = os.path.join(base_dir, name)
        if not os.path.isdir(d):
            continue
        if pattern.match(name):
            candidates.append(d)
        else:  # a run-name level
            candidates.extend(
                os.path.join(d, sub)
                for sub in os.listdir(d)
                if pattern.match(sub) and os.path.isdir(os.path.join(d, sub))
            )
    resumable = [d for d in candidates if _is_resumable(d)]
    if not resumable:
        return None
    return max(resumable, key=os.path.getmtime)


# ---- train_args.yaml without PyYAML ---------------------------------------
# The port writes values as JSON scalars, which YAML reads as the same
# values, except floats: YAML 1.1 (PyYAML) reads a float only with a dot and
# a signed exponent, and names infinities and NaN .inf / .nan. It reads
# back its own files and the subset of YAML that PyYAML's ``yaml.dump(...,
# default_flow_style=False)`` writes for a flat mapping of args (plain,
# single- and double-quoted scalars, block and empty lists), as the
# reference and the JAX package write ``train_args.yaml``.


def _yaml_float(v: float) -> str:
    if math.isnan(v):
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    mant, _, exp = repr(v).partition("e")
    if "." not in mant:
        mant += ".0"
    if exp and exp[0] not in "+-":
        exp = "+" + exp
    return f"{mant}e{exp}" if exp else mant


def _yaml_scalar(v: t.Any) -> str:
    if isinstance(v, bool) or v is None:
        return json.dumps(v)
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _yaml_float(v)
    if isinstance(v, str):
        return json.dumps(v)
    raise TypeError(f"train_args.yaml takes scalars and lists of them, not {type(v).__name__}")


def _yaml_value(v: t.Any) -> str:
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_scalar(x) for x in v) + "]"
    return _yaml_scalar(v)


# YAML 1.1's implicit types as PyYAML resolves plain scalars
_YAML_SPECIALS = {".inf": math.inf, ".Inf": math.inf, ".INF": math.inf, "+.inf": math.inf,
                  "-.inf": -math.inf, "-.Inf": -math.inf, "-.INF": -math.inf,
                  ".nan": math.nan, ".NaN": math.nan, ".NAN": math.nan,
                  "~": None, "null": None, "Null": None, "NULL": None}
_YAML_BOOLS = {w: v for words, v in (("yes Yes YES true True TRUE on On ON", True),
                                     ("no No NO false False FALSE off Off OFF", False))
               for w in words.split()}
_YAML_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)")
_YAML_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?")


def _read_scalar(text: str) -> t.Any:
    if text in _YAML_SPECIALS:
        return _YAML_SPECIALS[text]
    if text in _YAML_BOOLS:
        return _YAML_BOOLS[text]
    if text.startswith('"'):
        return json.loads(text)
    if text.startswith("'"):
        if len(text) < 2 or not text.endswith("'"):
            raise ValueError(f"unterminated quoted scalar {text!r}")
        return text[1:-1].replace("''", "'")
    if _YAML_INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _YAML_FLOAT.fullmatch(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    if text[0] in "!&*{}[]|>%@`#," or (text[0] in "-?:" and text[1:2] in ("", " ")):
        raise ValueError(f"not a plain scalar: {text!r}")
    return text


def _read_value(text: str) -> t.Any:
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        if not inner:
            return []
        # items are JSON scalars: split on commas outside strings
        return [_read_scalar(x) for x in _split_items(inner)]
    return _read_scalar(text)


def _split_items(text: str) -> t.List[str]:
    items, cur, in_str, esc = [], [], False, False
    for ch in text:
        if in_str:
            cur.append(ch)
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
        elif ch == '"':
            in_str = True
            cur.append(ch)
        elif ch == ",":
            items.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    items.append("".join(cur).strip())
    return items


def log_args(
    args: t.Union[argparse.Namespace, t.Mapping[str, t.Any]], save_path: str, exp: t.Any = None
) -> None:
    """Write the CLI args to ``save_path`` as ``args:`` and one indented
    ``key: value`` line per arg, keys sorted, and log the file to ``exp``
    if it is a live experiment. ``yaml.load(..., Loader=yaml.FullLoader)
    ["args"]`` reads back the same dict."""
    args_map = vars(args) if isinstance(args, argparse.Namespace) else dict(args)
    lines = ["args:"] + [f"  {k}: {_yaml_value(args_map[k])}" for k in sorted(args_map)]
    with open(save_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    if exp:
        exp.log_asset(save_path)


def load_args(load_path: str) -> argparse.Namespace:
    """Read a ``train_args.yaml`` that :func:`log_args` or PyYAML wrote (see
    above); raises ``ValueError`` naming the first line it cannot read."""
    with open(load_path) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    if not lines or lines[0].rstrip() != "args:":
        raise ValueError(f"{load_path}: expected an 'args:' mapping")
    args: t.Dict[str, t.Any] = {}
    block: t.Optional[str] = None  # the key whose block list is being read
    for ln in lines[1:]:
        body = ln.strip()
        if block is not None and body.startswith("- ") and ln.startswith("  "):
            try:
                args[block] = (args[block] or []) + [_read_scalar(body[2:].strip())]
            except ValueError as e:
                raise ValueError(f"{load_path}: cannot read line {ln!r}") from e
            continue
        block = None
        key, sep, value = body.partition(":")
        if not ln.startswith("  ") or ln.startswith("   ") or not sep or (value and value[0] != " "):
            raise ValueError(f"{load_path}: cannot read line {ln!r}")
        if not value.strip():
            # a block list follows, or the key is null
            args[key], block = None, key
            continue
        try:
            args[key] = _read_value(value.strip())
        except (ValueError, KeyError) as e:
            raise ValueError(f"{load_path}: cannot read the value of {key!r}: {value!r}") from e
    return argparse.Namespace(**args)
