"""The port stands alone: importing it loads neither JAX nor the JAX
package, nor a package the port does not depend on (PIL, yaml, orbax,
matplotlib, comet_ml, pandas), and its entry points refuse to run on a
missing card unless the caller asks for the CPU."""

import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import vision_mtl_tpu_torch
from vision_mtl_tpu_torch.cfg import fetch_data_cfg
from vision_mtl_tpu_torch.kernels import fused_gate_train, small_conv
from vision_mtl_tpu_torch.metrics import init_metrics
from vision_mtl_tpu_torch.models.registry import build_model
from vision_mtl_tpu_torch.parallel import multihost
from vision_mtl_tpu_torch.predict import predict
from vision_mtl_tpu_torch.serving import BatchingServer, Predictor
from vision_mtl_tpu_torch.train.state import create_train_state
from vision_mtl_tpu_torch.train.step import make_eval_step, make_train_step

REPO = Path(__file__).resolve().parents[1]


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(
            vision_mtl_tpu_torch.__path__, prefix="vision_mtl_tpu_torch."
        )
    )


def test_port_imports_nothing_of_jax():
    modules = _port_modules()
    assert "vision_mtl_tpu_torch.serve" in modules and len(modules) >= 17
    assert "vision_mtl_tpu_torch.train.state" in modules
    assert "vision_mtl_tpu_torch.kernels.fused_gate_train" in modules
    for name in ("kernels.small_conv", "ops.small_conv", "models.basic",
                 "models.mobilenetv3", "models.unet_decoder", "models.cross_stitch",
                 "data.loader", "data.datamodule", "data.cityscapes", "data.transforms",
                 "train.loop", "train.checkpoint", "train.plateau", "tracking.logger",
                 "utils.args", "pipeline", "training", "data.native", "data.nyuv2",
                 "data.nyu_cache", "train.preempt", "utils.io", "eval_harness",
                 "utils.ckpt_import", "utils.torch_port", "export_torch_ckpt", "tuning", "vis",
                 "tracking.comet", "tracking.artifacts", "utils.inference", "utils.profiling",
                 "utils.debug", "parallel.mesh", "parallel.multihost", "parallel.halo"):
        assert f"vision_mtl_tpu_torch.{name}" in modules
    code = textwrap.dedent(
        f"""
        import importlib, runpy, sys
        for name in {modules!r}:
            importlib.import_module(name)
        runpy.run_path({str(REPO / "chip_smoke.py")!r}, run_name="chip_smoke_import")
        banned = ("jax", "flax", "vision_mtl_tpu", "PIL", "yaml", "orbax", "matplotlib",
                  "comet_ml", "pandas")
        bad = sorted(
            m for m in sys.modules
            if m in banned or m.startswith(tuple(b + "." for b in banned))
        )
        print(",".join(bad))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"the port loaded: {out.stdout.strip()}"


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = fetch_data_cfg("synthetic")
    for name in ("mtan", "basic", "csnet"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(name, cfg)
    model = build_model("mtan", cfg, dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(model, 1, cfg.height, cfg.width)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchingServer(model, cfg.height, cfg.width)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_metrics(cfg.num_classes)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict([{"img": np.zeros((1, cfg.height, cfg.width, 3), np.float32)}], model, 7)
    # a rank of a launch: refused before it joins a process group
    for var, value in (("RANK", "0"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "0"),
                       ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "29500")):
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(torch.distributed, "init_process_group", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.maybe_initialize_distributed()
    assert multihost.current() is None


def test_predictor_rejects_a_model_elsewhere():
    cfg = fetch_data_cfg("synthetic")
    model = build_model("mtan", cfg, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="move the model"):
        Predictor(model, 1, cfg.height, cfg.width, device="meta")
    with pytest.raises(ValueError, match="eval"):
        Predictor(model.train(), 1, cfg.height, cfg.width, device="cpu")


def test_train_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model("mtan", fetch_data_cfg("synthetic"), dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(model, 1e-3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_eval_step()
    state = create_train_state(model, 1e-3, device="cpu")
    assert model.training and not build_model(
        "mtan", fetch_data_cfg("synthetic"), dtype=torch.float32, device="cpu"
    ).training
    make_train_step(device="cpu")
    make_eval_step(device="cpu")


def test_train_gate_wrapper_never_falls_back():
    """A tensor that is not on the CPU never reaches the plain version of the
    train-mode gate: the wrapper checks it for the kernel and raises."""
    def meta(*shape):
        return torch.empty(*shape, device="meta")

    args = (meta(1, 2, 2, 3), meta(1, 2, 2, 4), meta(3, 8), meta(8), meta(8), meta(8),
            meta(8, 4), meta(4), meta(4), meta(4))
    before = fused_gate_train.launches.value
    with pytest.raises(ValueError, match="CUDA"):
        fused_gate_train.fused_attention_gate_train(*args)
    assert fused_gate_train.launches.value == before


def test_small_conv_wrapper_never_falls_back(monkeypatch):
    """A tensor that is not on the CPU never reaches the plain version of
    kernel B3, forward or through the differentiable entry point: the
    wrapper checks it for the kernel and raises."""
    from vision_mtl_tpu_torch.ops.small_conv import conv3x3_small

    def plain(*args):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(small_conv, "conv3x3_small_plain", plain)
    x = torch.empty(1, 4, 4, 5, device="meta")
    k = torch.empty(3, 3, 5, 7, device="meta")
    before = small_conv.launches.value
    with pytest.raises(ValueError, match="CUDA"):
        small_conv.conv3x3_small(x, k)
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3_small(x.requires_grad_(), k, torch.empty(7, device="meta"))
    assert small_conv.launches.value == before


def test_cli_entry_points_refuse_a_missing_card(monkeypatch, tmp_path):
    """``training``, ``serve --run_dir``, ``eval_harness`` and
    ``export_torch_ckpt`` run on the card unless ``--device cpu`` is given; without a card they raise before writing a
    run dir, and the device copy of a batch has no host fallback."""
    from vision_mtl_tpu_torch import eval_harness, export_torch_ckpt, serve, training
    from vision_mtl_tpu_torch.cfg import cfg
    from vision_mtl_tpu_torch.data.loader import prefetch_to_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cfg, "log_root_dir", tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training.main(["--dataset_name", "synthetic", "--model_name", "mtan"])
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--run_dir", str(tmp_path), "--model_name", "mtan",
                    "--dataset_name", "synthetic"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_harness.main(["--dataset_name", "synthetic", "--runs", f"mtan={tmp_path}"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_torch_ckpt.main([str(tmp_path)])
    with pytest.raises((RuntimeError, AssertionError)):
        next(prefetch_to_device([{"img": np.zeros((1, 2, 2, 3), np.float32)}], "cuda"))
