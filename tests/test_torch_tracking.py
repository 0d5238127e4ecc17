"""The port's tracking against the JAX package's on the CPU: the run
registry (the same bytes and the same runs for the same calls), the comet
artifact download against a fake API, the disabled experiment, the
parameter histograms under JAX's tags, and the logger's figure sink."""

import argparse
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_mtl_tpu.models.mtan import MTANMiniUnet as JaxMTAN
from vision_mtl_tpu.tracking import artifacts as jax_artifacts
from vision_mtl_tpu.tracking import comet as jax_comet
from vision_mtl_tpu.train import loop as jax_loop
from vision_mtl_tpu.utils.args import parse_args as jax_parse_args
from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet
from vision_mtl_tpu_torch.tracking import artifacts, comet
from vision_mtl_tpu_torch.tracking.logger import MetricsLogger
from vision_mtl_tpu_torch.train import loop
from vision_mtl_tpu_torch.utils.args import parse_args
from vision_mtl_tpu_torch.weights import load_jax_variables

TASKS = {"depth": 1, "segm": 5}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _registry_calls(tmp_path):
    """One sequence of registry calls: a first run per key, a newer run of
    one key and dataset (it wins), a second dataset."""
    runs = {name: tmp_path / "runs" / name for name in ("a", "b", "c", "d")}
    for d in runs.values():
        d.mkdir(parents=True)
    return runs, [
        ("mtan", "cityscapes", runs["a"], None),
        ("basic", "cityscapes", runs["b"], "basic_tuned"),
        ("mtan", "nyuv2", runs["c"], None),
        ("mtan", "cityscapes", runs["d"], None),
    ]


def test_registry_matches_jax(tmp_path, capsys):
    runs, calls = _registry_calls(tmp_path)
    paths = {pkg: str(tmp_path / pkg / "run_registry.json") for pkg in ("jax", "port")}
    for pkg, mod in (("jax", jax_artifacts), ("port", artifacts)):
        for model_name, dataset, run_dir, key in calls:
            assert mod.register_run(model_name, dataset, str(run_dir), key=key,
                                    path=paths[pkg]) == paths[pkg]
    port_bytes = open(paths["port"], "rb").read()
    assert port_bytes == open(paths["jax"], "rb").read()
    assert json.loads(port_bytes)["mtan"]["cityscapes"]["run_dir"] == str(runs["d"])
    assert artifacts.load_registry(paths["port"]) == jax_artifacts.load_registry(paths["jax"])

    os.rmdir(runs["b"])  # a deleted run dir is skipped, with a note
    notes = {}
    for dataset in ("cityscapes", "nyuv2", "synthetic"):
        want = jax_artifacts.registered_runs(dataset, path=paths["jax"])
        notes[dataset] = capsys.readouterr().out
        assert artifacts.registered_runs(dataset, path=paths["port"]) == want
        assert capsys.readouterr().out == notes[dataset]
    assert "skipping 'basic_tuned'" in notes["cityscapes"] and not notes["nyuv2"]
    assert list(artifacts.registered_runs("cityscapes", path=paths["port"])) == ["mtan"]

    missing = str(tmp_path / "none.json")
    assert artifacts.load_registry(missing) == jax_artifacts.load_registry(missing) == {}
    assert artifacts.registered_runs("cityscapes", path=missing) == {}
    bad = tmp_path / "list.json"
    bad.write_text("[1, 2]")
    for mod in (jax_artifacts, artifacts):
        with pytest.raises(ValueError, match="expected a JSON object at top level"):
            mod.load_registry(str(bad))


@pytest.mark.parametrize("argv", [
    ["--model_name", "mtan"],
    ["--model_name", "basic", "--backbone_weights", "imagenet"],
    ["--model_name", "basic", "--do_optimize"],
    ["--model_name", "csnet", "--backbone_weights", "imagenet", "--do_optimize"],
    ["--model_name", "csnet", "--do_optimize", "--run_name", "mine"],
])
def test_run_registry_key_matches_jax(argv):
    assert artifacts.run_registry_key(parse_args(argv)) == jax_artifacts.run_registry_key(
        jax_parse_args(argv))


class _FakeExp:
    id = "exp123"

    def __init__(self, assets):
        self._assets = assets

    def get_asset_list(self, asset_type="all"):
        return self._assets


class _FakeAPI:
    def __init__(self, assets):
        self._assets = assets
        self.downloads = []

    def get(self, path):
        return _FakeExp(self._assets)

    def download_experiment_asset(self, exp_id, asset_id, dst):
        self.downloads.append(asset_id)
        with open(dst, "w") as f:
            f.write(f"payload:{asset_id}")


_ASSETS = [
    {"fileName": "model_7/model.pt", "assetId": "m7"},
    {"fileName": "model_70/model.pt", "assetId": "m70"},
    {"fileName": "model_7/../../evil", "assetId": "evil"},
    {"fileName": "model_7", "assetId": "shadow"},
    {"fileName": "session_7/session.pt", "assetId": "s7"},
    {"fileName": "train_args.yaml", "assetId": "args"},
    {"fileName": "model_3/model.pt", "assetId": "m3"},
]


def _tree(root):
    return {
        os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f)).read()
        for d, _, files in os.walk(root) for f in files
    }


def test_artifact_download_matches_jax(tmp_path, capsys):
    """The same assets land at the same relative paths with the same
    payloads; the path-escaping and directory-shadowing names are skipped;
    the newest epoch is found by the anchored ``model_{e}`` match."""
    trees, downloads, outs = {}, {}, {}
    for pkg, mod in (("jax", jax_artifacts), ("port", artifacts)):
        api = _FakeAPI(_ASSETS)
        assert mod.get_latest_ckpt_epoch("run", api=api, project_name="p") == 70
        out = mod.load_artifacts_from_comet("run", str(tmp_path / pkg), epoch=7,
                                            session_artifact_name="session_7",
                                            project_name="p", api=api)
        assert {k: os.path.relpath(v, tmp_path / pkg) for k, v in out.items()} == {
            "checkpoint_path": "model_7", "args_path": "train_args.yaml",
            "session_path": "session_7"}
        trees[pkg], downloads[pkg] = _tree(tmp_path / pkg), api.downloads
        outs[pkg] = capsys.readouterr().out
        n = len(api.downloads)  # a second call finds everything in place
        mod.load_artifacts_from_comet("run", str(tmp_path / pkg), epoch=7, project_name="p",
                                      api=api)
        assert len(api.downloads) == n
    assert trees["port"] == trees["jax"] == {
        "model_7/model.pt": "payload:m7", "train_args.yaml": "payload:args",
        "session_7/session.pt": "payload:s7"}
    assert downloads["port"] == downloads["jax"]
    assert outs["port"] == outs["jax"] and "escapes" in outs["port"] and "names the" in outs["port"]
    assert not (tmp_path / "evil").exists()
    for mod in (jax_artifacts, artifacts):
        with pytest.raises(ValueError, match="No checkpoints found in run"):
            mod.get_latest_ckpt_epoch("run", api=_FakeAPI(_ASSETS[5:6]), project_name="p")


def test_artifact_download_without_comet(monkeypatch):
    """JAX's errors without comet_ml, and without the credentials."""
    monkeypatch.setitem(sys.modules, "comet_ml", None)
    for mod in (jax_artifacts, artifacts):
        with pytest.raises(RuntimeError, match="^comet_ml is not installed; artifact download "
                           "unavailable$"):
            mod.load_artifacts_from_comet("run", "unused")
    fake = types.ModuleType("comet_ml")
    fake.api = types.ModuleType("comet_ml.api")
    fake.api.API = lambda api_key: pytest.fail("no API without credentials")
    monkeypatch.setitem(sys.modules, "comet_ml", fake)
    monkeypatch.setitem(sys.modules, "comet_ml.api", fake.api)
    for mod in (jax_artifacts, artifacts):
        monkeypatch.setattr(mod.cfg.logger, "api_key", None)
        with pytest.raises(RuntimeError, match=r"^comet credentials missing \(\.env\)$"):
            mod.get_latest_ckpt_epoch("run")


def test_tracking_disabled_without_comet(monkeypatch):
    """Without comet_ml (or with --exp_disabled) the experiment is a falsy
    NullExperiment that absorbs every call, as in JAX."""
    monkeypatch.setitem(sys.modules, "comet_ml", None)
    monkeypatch.setattr(comet, "_comet_importable", None)
    monkeypatch.setattr(comet.cfg.logger, "disabled", False)
    for exp_disabled in (False, True):
        args = argparse.Namespace(exp_disabled=exp_disabled)
        exp = comet.create_tracking_exp(args)
        assert isinstance(exp, comet.NullExperiment) and not exp and exp.name == "disabled"
        assert not comet.comet_enabled(args)
        assert exp.log_metric("x", 1.0, step=0) is None and exp.end() is None
    comet.log_params_to_exp(exp, {"a": 1}, "args")
    comet.log_ckpt_to_exp(exp, "path")
    want = jax_comet.create_tracking_exp(argparse.Namespace(exp_disabled=False))
    assert type(want).__name__ == type(exp).__name__ and bool(want) is bool(exp)


class _Writer:
    def __init__(self):
        self.histograms = {}

    def add_histogram(self, tag, values, step):
        self.histograms[tag] = (np.sort(np.asarray(values, np.float64).ravel()), step)


@pytest.mark.parametrize("fold_tasks", [False, True])
def test_param_histograms_match_jax(fold_tasks):
    """The same weights (through ``load_jax_variables``) give JAX's tags,
    the flax paths of ``state.params``, and each tag the same values."""
    kw = dict(task_subnets_hidden_channels=8, encoder_first_channel=8, encoder_num_channels=2,
              fold_tasks=fold_tasks)
    jmodel = JaxMTAN(map_tasks_to_num_channels=TASKS, dtype=jnp.float32, **kw)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)),
                                                train=False))
    rng = np.random.default_rng(5)
    variables = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    model = MTANMiniUnet(TASKS, dtype=torch.float32, **kw)
    load_jax_variables(model, variables)

    got, want = _Writer(), _Writer()
    loop._log_param_histograms(types.SimpleNamespace(_tb=got), model, 7)
    jax_loop._log_param_histograms(types.SimpleNamespace(_tb=want),
                                   types.SimpleNamespace(params=variables["params"]), 7)
    assert got.histograms.keys() == want.histograms.keys()
    assert not any("mean" in k or k.endswith("/var") for k in got.histograms)
    for tag, (values, step) in want.histograms.items():
        assert step == got.histograms[tag][1] == 7
        np.testing.assert_allclose(got.histograms[tag][0], values, rtol=0, atol=1e-6,
                                   err_msg=tag)
    loop._log_param_histograms(types.SimpleNamespace(_tb=None), model, 0)  # no writer: no-op


def test_log_figure_is_best_effort(tmp_path, monkeypatch):
    """``log_figure`` hands the figure to TensorBoard, swallows a failing
    write, and is a no-op without a writer."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = MetricsLogger(str(tmp_path), "run")
    assert logger._tb is None
    logger.log_figure("preds", object(), step=1)
    figures = []

    class Writer:
        def add_figure(self, tag, fig, step):
            figures.append((tag, fig, step))
            if fig is None:
                raise ValueError("bad figure")

        def close(self):
            pass

    logger._tb = Writer()
    logger.log_figure("preds", "fig", step=2)
    logger.log_figure("preds", None)
    logger.close()
    assert figures == [("preds", "fig", 2), ("preds", None, 0)]
