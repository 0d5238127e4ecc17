"""BENCHMARK.json against the contract's form, and every configuration,
traffic mix, cell and per-layer metric found by its name, also one added
as new files in a copy of the benchmark."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from portbench import harness
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark(tiny.ROOT)


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(os.path.isdir(tiny.ROOT / p) for p in BENCH["paths"])
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    assert len(layers) <= len(BENCH["per_layer"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    """Its configuration, mix, limits and kind load; it reports setup_s, one
    other end-to-end metric and one per-layer metric, each with a reader."""
    r = harness.make_run(BENCH, cell, 1, 1.0, False, None, 0.0)
    assert harness.kind_module(r.traffic["kind"]).run
    assert r.limits
    e2e = [m["name"] for m in harness.end_to_end_for(BENCH, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.per_layer_for(BENCH, cell)
    assert per_layer
    for m in per_layer:
        module = harness.metric_module(m["name"])
        assert (module.UNIT, module.LAYER, module.MOVES) == (m["unit"], m["layer"], m["moves"])
        assert m["moves"] in e2e


#: each data set's published sizes as the port's ``cfg.py`` trains them
#: (NYUv2's 480x640 frames resized to 256x256, 13 classes and the void)
DATASETS = {"cityscapes": {"height": 128, "width": 256, "num_classes": 19},
            "nyuv2": {"height": 256, "width": 256, "num_classes": 14}}


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_files_hold_their_published_sizes(name):
    """A configuration's sizes are its data set's, except those its entry's
    ``reduced`` names."""
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    with open(tiny.ROOT / entry["file"]) as f:
        cfg = json.load(f)
    assert cfg["source"] == entry["source"]
    published = DATASETS[cfg["dataset"]]
    differ = {k for k, v in published.items() if cfg[k] != v}
    assert differ <= set(entry["reduced"]), (differ, entry["reduced"])


ADDED = {
    "portbench/configs/tiny-mtan.json": None,  # filled from mtan-cityscapes
    "portbench/traffic/train-b2.json": {"kind": "train", "batch": 2, "lr": 0.005,
                                        "loss_weights": [1.0, 1.0], "trace_steps": 1},
    "portbench/workloads/tiny-mtan.train-b2.json": {"limits": {"loss_gap": 1.0}},
}
METRIC = textwrap.dedent('''
    UNIT, LAYER, MOVES = "1", "train step", "train_img_per_s"


    def read(r):
        return r.rate * 2
''')


def test_a_cell_config_and_metric_added_as_files(tmp_path):
    """A copy of the benchmark with one configuration, mix, cell and metric
    added as new files and entries, no file edited: the harness finds them
    all by name."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny.ROOT / "portbench/configs/mtan-cityscapes.json").read_text())
    ADDED["portbench/configs/tiny-mtan.json"] = dict(cfg, height=32, width=64)
    for path, body in ADDED.items():
        (root / path).write_text(json.dumps(body))
    (root / "portbench/metrics/double_rate.train.py").write_text(METRIC)
    bench["configs"].append({"name": "tiny-mtan", "source": cfg["source"],
                             "file": "portbench/configs/tiny-mtan.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny-mtan.train-b2", "config": "tiny-mtan",
                               "traffic": "train-b2", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("tiny-mtan.train-b2")
    bench["per_layer"].append({"name": "double_rate.train", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "train step",
                               "moves": "train_img_per_s", "workloads": ["tiny-mtan.train-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    script = textwrap.dedent('''
        import json, sys
        from pathlib import Path
        from portbench import harness
        bench = harness.load_benchmark(Path("."))
        r = harness.make_run(bench, "tiny-mtan.train-b2", 1, 1.0, True, None, 0.0)
        names = [m["name"] for m in harness.per_layer_for(bench, "tiny-mtan.train-b2")]
        reader = harness.metric_module("double_rate.train")
        print(json.dumps({"height": r.config["height"], "batch": r.traffic["batch"],
                          "limits": r.limits, "metrics": names,
                          "read": reader.read(type("R", (), {"rate": 3.0})()),
                          "e2e": [m["name"] for m in harness.end_to_end_for(bench, r.cell)]}))
    ''')
    out = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(root)), timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"height": 32, "batch": 2, "limits": {"loss_gap": 1.0},
                   "metrics": ["double_rate.train"], "read": 6.0,
                   "e2e": ["train_img_per_s", "setup_s"]}


TWIN = textwrap.dedent('''
    """basic's reference at the configuration's decoder width: a model the
    benchmark did not have, added as one file."""

    from portbench.reference.basic import Basic
    from portbench.reference.common import F32


    def build(config, precision=F32):
        arch = config["architecture"]
        return Basic(config["num_classes"], arch["decoder_first_channel"],
                     arch["num_decoder_layers"], precision=precision)
''')


def test_a_model_added_as_files(tmp_path):
    """A copy of the benchmark with a model it did not have (its reference
    module, configuration, mix, limits and cell) added as new files and
    entries, every file that was there byte for byte the repository's: the
    reference is found by the model's name, the weights are drawn from the
    seed, the cell is found; the program's registry, which has no such
    model, is the one thing left to add."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    basic = json.loads((tiny.ROOT / "portbench/configs/basic-cityscapes.json").read_text())
    twin = dict(basic, model="twin", architecture=dict(basic["architecture"],
                                                       decoder_first_channel=256))
    added = {
        "portbench/reference/twin.py": TWIN,
        "portbench/configs/twin-cityscapes.json": json.dumps(twin),
        "portbench/traffic/train-b4.json": json.dumps(
            {"kind": "train", "batch": 4, "lr": 0.005, "loss_weights": [1.0, 1.0],
             "trace_steps": 1}),
        "portbench/workloads/twin-cityscapes.train-b4.json": json.dumps(
            {"limits": {"grad_gap": 0.4}}),
    }
    for path, body in added.items():
        assert not (root / path).exists(), path
        (root / path).write_text(body)
    bench["configs"].append({"name": "twin-cityscapes", "source": basic["source"],
                             "file": "portbench/configs/twin-cityscapes.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "twin-cityscapes.train-b4", "config": "twin-cityscapes",
                               "traffic": "train-b4", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for path in (tiny.ROOT / "portbench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            copy = root / path.relative_to(tiny.ROOT)
            assert copy.read_bytes() == path.read_bytes(), copy
    script = textwrap.dedent('''
        import json
        from pathlib import Path
        import torch
        from portbench import harness, reference, seeded
        bench = harness.load_benchmark(Path("."))
        r = harness.make_run(bench, "twin-cityscapes.train-b4", 2**31 + 9, 1.0, False, None, 0.0)
        with torch.device("meta"):
            parameters = sum(p.numel() for p in reference.build(r.config).parameters())
        weights = seeded.weights(r.config, r.seed, torch.device("cpu"))
        again = seeded.weights(r.config, r.seed, torch.device("cpu"))
        try:
            harness.program_model(r.config, "cpu")
            program = "built"
        except NotImplementedError as e:
            program = str(e)
        try:
            reference.build(dict(r.config, model="triplet"))
            missing = ""
        except ValueError as e:
            missing = str(e)
        print(json.dumps({
            "model": r.config["model"], "batch": r.traffic["batch"], "limits": r.limits,
            "reference": type(reference.build(r.config)).__module__, "parameters": parameters,
            "weights": sum(v.numel() for v in weights.values()),
            "same": all(torch.equal(weights[k], again[k]) for k in weights),
            "program": program, "missing": missing, "from": harness.__file__}))
    ''')
    # the copy's benchmark first, then the program from the repository
    path = os.pathsep.join([str(root), str(tiny.ROOT)])
    out = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=path), timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["from"] == str(root / "portbench/harness.py")
    assert got["model"] == "twin" and got["batch"] == 4 and got["limits"] == {"grad_gap": 0.4}
    assert got["reference"] == "portbench.reference.basic"  # twin.py builds basic's class
    assert 0 < got["parameters"] < basic["parameters"]
    assert got["weights"] >= got["parameters"] and got["same"]
    assert got["program"] == "Unknown model name: twin"
    assert "portbench/reference/triplet.py" in got["missing"]


def test_program_model_holds_the_configuration():
    """The program's model is built with the configuration's
    ``program_options`` and its parameter count is held to the
    configuration's ``parameters``."""
    cfg = tiny.config("mtan-cityscapes")
    folded = harness.program_model(dict(cfg, program_options={"fold_tasks": True}), "cpu")
    assert any("_folded." in k for k, _ in folded.named_parameters())
    wrong = dict(cfg, parameters=cfg["parameters"] + 1)
    with pytest.raises(ValueError, match=f"has {cfg['parameters']} parameters; the "
                                         f"configuration states {cfg['parameters'] + 1}"):
        harness.program_model(wrong, "cpu")
    with pytest.raises(ValueError, match=r"\['merge_head'\] are not build_model's"):
        harness.program_model(dict(cfg, program_options={"merge_head": True}), "cpu")
