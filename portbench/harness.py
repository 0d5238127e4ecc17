"""The benchmark's general part: it finds a cell's configuration, traffic
mix, limits and per-layer metrics by the names ``BENCHMARK.json`` gives,
runs the traffic's kind, and assembles the result line.

Files, each found by name (a later change adds files and entries, and
edits none):

* ``configs/<config>.json``: the model configuration as it is run.
* ``traffic/<traffic>.json``: the traffic mix's parameters; its ``kind``
  names the general generator, ``kinds/<kind>.py``.
* ``workloads/<cell>.json``: the limits of the cell's comparison with the
  plain reference, and the readings they were set from.
* ``metrics/<metric>.py``: one per-layer metric's reader.
* ``reference/<model>.py``: the plain reference of the configuration's
  ``model`` (``reference.build``); the program's model comes from the
  port's registry under the same name (``program_model``).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import typing as t
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: top-level module names that may not be loaded once the window has
#: closed: JAX, its libraries and the JAX package the program was ported
#: from (the program's own name begins with the last, so names are
#: compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "vision_mtl_tpu")


@dataclasses.dataclass
class Run:
    """One run of one cell."""

    cell: str
    config: t.Dict[str, t.Any]
    traffic: t.Dict[str, t.Any]
    limits: t.Dict[str, float]
    chips: int
    seed: int
    seconds: float
    trace: bool
    device: t.Any  # torch.device
    t0: float  # process start, time.perf_counter()
    #: what the run found beside its numbers, printed to standard error
    notes: t.Dict[str, t.Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Outcome:
    """What a kind returns: its end-to-end values by metric name, the
    numbers compared with the reference, the window's counts, and for a
    traced run what the per-layer readers read."""

    values: t.Dict[str, float]
    compared: t.Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    readings: t.Any = None  # metrics.Readings


def load_benchmark(root: Path) -> t.Dict[str, t.Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str) -> t.Dict[str, t.Any]:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path.relative_to(HERE.parent)}")
    with open(path) as f:
        return json.load(f)


def cell_entry(bench: t.Mapping[str, t.Any], cell: str) -> t.Dict[str, t.Any]:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")


def kind_module(name: str) -> t.Any:
    return importlib.import_module(f"portbench.kinds.{name}")


def metric_module(name: str) -> t.Any:
    """``metrics/<name>.py``, loaded by path (metric names hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def end_to_end_for(bench: t.Mapping[str, t.Any], cell: str) -> t.List[t.Dict[str, t.Any]]:
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer_for(bench: t.Mapping[str, t.Any], cell: str) -> t.List[t.Dict[str, t.Any]]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose ``moves`` metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_for(bench, cell)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e else [])]


def make_run(bench: t.Mapping[str, t.Any], cell: str, seed: int, seconds: float, trace: bool,
             device: t.Any, t0: float) -> Run:
    entry = cell_entry(bench, cell)
    config = load_json("configs", entry["config"])
    traffic = load_json("traffic", entry["traffic"])
    limits = load_json("workloads", cell)["limits"]
    return Run(cell=cell, config=config, traffic=traffic, limits=limits, chips=entry["chips"],
               seed=seed, seconds=seconds, trace=trace, device=device, t0=t0)


#: ``build_model``'s arguments that ``program_model`` sets itself
SET_HERE = {"model_name", "data_cfg", "dtype", "device", "seed"}


def program_model(config: t.Mapping[str, t.Any], device: t.Any, dtype: t.Any = None) -> t.Any:
    """The program's model for ``config`` on ``device``, in ``dtype``
    (default: the configuration's ``compute_dtype``), built by the port's
    registry with the configuration's ``program_options`` (keyword
    arguments of ``build_model``, such as ``fold_tasks``; none by default).
    Raises where an option is not one of ``build_model``'s, or where the
    model's parameter count is not the configuration's ``parameters``."""
    import inspect
    import types

    import torch

    from vision_mtl_tpu_torch.models.registry import build_model

    options = dict(config.get("program_options", {}))
    known = set(inspect.signature(build_model).parameters) - SET_HERE
    unknown = sorted(set(options) - known)
    if unknown:
        raise ValueError(f"program_options {unknown} are not build_model's; "
                         f"it takes {sorted(known)}")
    if dtype is None:
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[config["compute_dtype"]]
    model = build_model(config["model"], types.SimpleNamespace(num_classes=config["num_classes"]),
                        dtype=dtype, device=device, **options)
    count = sum(p.numel() for p in model.parameters())
    if count != config["parameters"]:
        raise ValueError(f"the program's {config['model']!r} model has {count} parameters; "
                         f"the configuration states {config['parameters']}")
    return model


def checks(compared: t.Mapping[str, float], limits: t.Mapping[str, float]) -> t.Dict[str, t.Any]:
    """Each number compared with the reference beside its limit."""
    return {k: {"value": compared.get(k, math.nan), "limit": limits[k]} for k in limits}


def is_correct(checked: t.Mapping[str, t.Mapping[str, float]], failed: int) -> bool:
    """Every number within its limit (a missing or non-finite number is
    not), and no request that failed or never came."""
    return failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checked.values())


def forbidden_modules() -> t.List[str]:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit_w() -> t.Optional[float]:
    """The first card's power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def result(bench: t.Mapping[str, t.Any], run: Run, outcome: Outcome,
           device: t.Dict[str, t.Any]) -> t.Dict[str, t.Any]:
    """The result line, ``checks`` last."""
    checked = checks(outcome.compared, run.limits)
    line: t.Dict[str, t.Any] = {
        "correct": is_correct(checked, outcome.failed),
        "attempted": outcome.attempted,
        "failed": outcome.failed,
    }
    if run.trace:
        values, units = {}, {}
        for m in per_layer_for(bench, run.cell):
            v = metric_module(m["name"]).read(outcome.readings)
            if v is not None:
                values[m["name"]], units[m["name"]] = v, m["unit"]
        line["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items()}
        trace = outcome.readings.trace
        device = dict(device, busy_s=trace.busy_us() / 1e6, window_s=trace.window_us / 1e6)
        line["device"] = device
        line["breakdown"] = {"device_ops": trace.categories(), "idle_gaps": trace.idle_gaps()}
    else:
        line["metrics"] = {}
        for m in end_to_end_for(bench, run.cell):
            if m["name"] not in outcome.values:
                raise RuntimeError(f"{run.cell}: the run measured no {m['name']}")
            line["metrics"][m["name"]] = {"value": outcome.values[m["name"]], "unit": m["unit"]}
        line["device"] = device
    line["checks"] = checked
    return line
