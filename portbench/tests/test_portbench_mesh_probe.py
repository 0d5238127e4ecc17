"""``mesh_probe.py`` on the CPU: two gloo ranks of the data-parallel train
step at a small size, from a copy of the benchmark with a small mix added,
print one result line and leave no rank running."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from portbench.tests import tiny


def test_mesh_probe_runs_two_gloo_ranks(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(tiny.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "portbench/traffic/train-b1.json").write_text(json.dumps(
        {"kind": "train", "batch": 1, "lr": 0.005, "loss_weights": [1.0, 1.0],
         "trace_steps": 1}))
    out = subprocess.run(
        [sys.executable, "portbench/mesh_probe.py", "--config", "mtan-cityscapes",
         "--traffic", "train-b1", "--ranks", "2", "--seed", str(2**31 + 11), "--seconds", "0.2",
         "--device", "cpu", "--height", "32"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(tiny.ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["ranks"] == 2 and line["steps"] >= 1
    assert line["img_per_s"] > 0 and line["setup_s"] > 0
