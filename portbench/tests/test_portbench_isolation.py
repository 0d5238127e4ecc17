"""What runs on the card loads neither JAX nor the JAX package, and the
reference loads nothing of the program; the entry point refuses a machine
without a card, and a checkout without the program, printing no result."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import harness
from portbench.tests import tiny

HERE = tiny.ROOT / "portbench"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _run(code: str, cwd: Path = tiny.ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(cwd)))


def test_harness_loads_no_jax():
    """Every module of the benchmark imported in one process, with the
    program's modules the kinds use: no top-level name of sys.modules is
    jax, jaxlib, flax or vision_mtl_tpu (names compared whole)."""
    mods = sorted({f"portbench.{p.relative_to(HERE).with_suffix('').as_posix().replace('/', '.')}"
                   for p in HERE.rglob("*.py") if "tests" not in p.parts
                   and p.parent.name != "metrics"})
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
            "from portbench import harness\n"
            "for p in (harness.HERE / 'metrics').glob('*.py'): harness.metric_module(p.stem)\n"
            "print(json.dumps(harness.forbidden_modules()))\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    forbidden, loaded = (json.loads(x) for x in out.stdout.strip().splitlines()[-2:])
    assert forbidden == []
    assert "vision_mtl_tpu_torch" in loaded and "vision_mtl_tpu" not in loaded


def test_forbidden_names_compared_whole():
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "vision_mtl_tpu")
    sys.modules.setdefault("vision_mtl_tpu_torch", sys.modules.get("vision_mtl_tpu_torch"))
    assert "vision_mtl_tpu" not in [n for n in harness.forbidden_modules()
                                    if n == "vision_mtl_tpu_torch"]


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert not top.startswith("vision_mtl_tpu") and top not in ("jax", "jaxlib", "flax")
            assert top != "portbench" or name.startswith("portbench.reference"), (path, name)
    code = ("import sys\nimport portbench.reference, portbench.reference.steps, "
            "portbench.reference.mtan, portbench.reference.basic\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "vision_mtl_tpu_torch" not in out.stdout and "jax" not in out.stdout


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "mtan-cityscapes.train-b32", "--seed", str(2**31 + 3), "--seconds",
                          "1", "--trace", "0"], cwd=tiny.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_checkout_without_the_program_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: the run fails before
    any result, wherever it stops."""
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "mtan-cityscapes.train-b32", "--seed", "5", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    code = "import portbench.kinds.train"
    out = _run(code, cwd=tmp_path)
    assert out.returncode != 0 and "vision_mtl_tpu_torch" in out.stderr
