"""The port's training loop, checkpoints and CLI on the CPU: ``run_pipe``
against the JAX package's on a tiny f32 MTAN, exact resume, the
``train_args.yaml`` format, ``training.main`` and ``serve --run_dir`` at the
full MTAN width on a tiny synthetic set, the refusal of unported flags, the
sweep, plotting and histogram flags reaching their features, and the model
options the CLI passes to the registry, the six model option flags among
them."""

import argparse
import io
import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_mtl_tpu.data import datamodule as jax_datamodule
from vision_mtl_tpu.data import synthetic as jax_synthetic
from vision_mtl_tpu.models.mtan import MTANMiniUnet as JaxMTAN
from vision_mtl_tpu.models.registry import build_model as jax_build_model
from vision_mtl_tpu.train import checkpoint as jax_checkpoint
from vision_mtl_tpu.train import loop as jax_loop
from vision_mtl_tpu.train.plateau import ReduceLROnPlateau as JaxPlateau
from vision_mtl_tpu.train.state import create_train_state as jax_create_train_state
from vision_mtl_tpu.train.state import get_lr as jax_get_lr
from vision_mtl_tpu.utils.args import parse_args as jax_parse_args
from vision_mtl_tpu_torch import serve, training
from vision_mtl_tpu_torch.cfg import cfg, fetch_data_cfg
from vision_mtl_tpu_torch.data import datamodule, loader, synthetic
from vision_mtl_tpu_torch.models import blocks
from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet
from vision_mtl_tpu_torch.pipeline import compute_dtype, model_from_args
from vision_mtl_tpu_torch.train import checkpoint
from vision_mtl_tpu_torch.train.loop import run_pipe
from vision_mtl_tpu_torch.train.plateau import ReduceLROnPlateau
from vision_mtl_tpu_torch.train.state import create_train_state, get_lr
from vision_mtl_tpu_torch.train.step import make_predict_step
from vision_mtl_tpu_torch.utils.args import NOT_PORTED, parse_args
from vision_mtl_tpu_torch.weights import jax_variables_from_model, load_jax_variables

NC = 5
LR = 2e-3
TASKS = {"depth": 1, "segm": NC}
# 12 samples: 9 train (2 steps of 4, the last dropped) and 3 val (1 padded step)
TINY = dict(height=16, width=24, num_classes=NC, num_train=12, num_val=4)
ARGS = argparse.Namespace(
    loss_segm_weight=1.0, loss_depth_weight=1.0, val_epoch_freq=1, save_epoch_freq=10,
    do_plot_preds=False, do_show_preds=False, grad_accum_steps=1, keep_ckpt_last_k=0,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def tiny_synthetic(monkeypatch):
    for mod in (jax_synthetic, synthetic):
        for k, v in TINY.items():
            monkeypatch.setattr(mod.synthetic_data_cfg, k, v)


@pytest.fixture
def no_tensorboard(monkeypatch):
    """The card's machine has no tensorboard, and where TensorFlow is
    installed importing it loads TensorFlow (~13 s). The logger then keeps
    only metrics.jsonl."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _tiny_port_model(seed=0):
    return MTANMiniUnet(TASKS, task_subnets_hidden_channels=8, encoder_first_channel=8,
                        encoder_num_channels=2, dtype=torch.float32, seed=seed)


def _datamodule():
    dm = datamodule.MTLDataModule("synthetic", batch_size=4, seed=11)
    dm.setup()
    return dm


def test_run_pipe_matches_jax(tiny_synthetic, capsys):
    """Two epochs of 2 train steps and 1 val step from the same weights:
    epoch metrics within the early tolerances of
    tests/test_torch_train.py's trajectory, the plateau (patience 0) in the
    same state, the same lr."""
    jmodel = JaxMTAN(map_tasks_to_num_channels=TASKS, task_subnets_hidden_channels=8,
                     encoder_first_channel=8, encoder_num_channels=2, dtype=jnp.float32)
    jstate = jax_create_train_state(jmodel, jax.random.key(0), jnp.zeros((4, 16, 24, 3)), LR)
    variables = jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats})
    jdm = jax_datamodule.MTLDataModule("synthetic", batch_size=4, seed=11)
    jdm.setup()
    jsched = JaxPlateau(patience=0)
    jstate, want = jax_loop.run_pipe(ARGS, jmodel, jstate, jdm, num_epochs=2, num_classes=NC,
                                     scheduler=jsched)

    model = _tiny_port_model()
    load_jax_variables(model, variables)
    state = create_train_state(model, LR, device="cpu")
    sched = ReduceLROnPlateau(patience=0)
    state, got = run_pipe(ARGS, state, _datamodule(), num_epochs=2, num_classes=NC,
                          scheduler=sched, device="cpu")
    out = capsys.readouterr().out
    assert out.count("### Epoch") == 4 and out.count("epoch/val:") == 4
    assert state.step == 4
    for stage in ("train", "val"):
        assert got[stage].keys() == want[stage].keys()
        for key, values in want[stage].items():
            assert len(got[stage][key]) == len(values) == 2, key
            for g, w in zip(got[stage][key], values):
                k = key.split("/")[1]
                if k.startswith("loss"):
                    assert g == pytest.approx(w, rel=5e-3), key
                elif k == "mae":
                    assert g == pytest.approx(w, rel=2e-2, abs=5e-3), key
                else:
                    assert g == pytest.approx(w, abs=0.08), key
    assert get_lr(state) == pytest.approx(jax_get_lr(jstate), rel=1e-7)
    assert sched.num_bad_epochs == jsched.num_bad_epochs
    assert sched.best == pytest.approx(jsched.best, rel=5e-3)


def _state_bits(state):
    """Parameters, buffers and Adam's per-parameter state, as CPU copies."""
    out = {f"model.{k}": v.detach().clone() for k, v in state.model.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        for k, v in s.items():
            out[f"adam.{i}.{k}"] = v.detach().clone()
    return out


def test_exact_resume(tiny_synthetic, tmp_path, monkeypatch):
    """Three epochs straight against two, save_ckpt, and a resume into a
    model of other weights for the third: parameters, buffers, Adam's
    moments and steps, the lr, the scheduler, the step counter and the
    third epoch's batch order are equal bit for bit."""
    orders = []
    index_batches = loader.DataLoader._index_batches

    def record(self):
        batches = index_batches(self)
        if self.shuffle:
            orders.append([b.tolist() for b in batches])
        return batches

    monkeypatch.setattr(loader.DataLoader, "_index_batches", record)
    sched_a = ReduceLROnPlateau(patience=0)
    state_a = create_train_state(_tiny_port_model(seed=1), LR, device="cpu")
    state_a, _ = run_pipe(ARGS, state_a, _datamodule(), 3, NC, scheduler=sched_a, device="cpu")
    orders_a, orders[:] = list(orders), []

    sched_b = ReduceLROnPlateau(patience=0)
    state_b = create_train_state(_tiny_port_model(seed=1), LR, device="cpu")
    state_b, _ = run_pipe(ARGS, state_b, _datamodule(), 2, NC, scheduler=sched_b, device="cpu")
    checkpoint.save_ckpt(state_b, sched_b, 1, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["model_1", "session_1"]

    sched_c = ReduceLROnPlateau()
    state_c = create_train_state(_tiny_port_model(seed=2), 1.0, device="cpu")
    state_c, sched_c, start = checkpoint.restore_session(state_c, sched_c, str(tmp_path))
    assert start == 2 and state_c.step == 4
    before = _state_bits(state_c)
    for k, v in _state_bits(state_b).items():
        assert torch.equal(before[k], v), k
    orders[:] = []
    state_c, _ = run_pipe(ARGS, state_c, _datamodule(), 3, NC, scheduler=sched_c,
                          start_epoch=start, device="cpu")
    assert orders == orders_a[2:] and orders_a[2] != orders_a[1]

    assert state_c.step == state_a.step == 6
    assert get_lr(state_c) == get_lr(state_a)
    assert sched_c.state_dict() == sched_a.state_dict()
    got, want = _state_bits(state_c), _state_bits(state_a)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_train_args_yaml_reads_back_in_jax(tmp_path):
    """The port writes train_args.yaml without PyYAML; JAX's load_args
    (PyYAML) reads it into the Namespace its own log_args round-trips, and
    the port's load_args reads the same."""
    argv = ["--model_name", "csnet", "--lr", "1e-05", "--run_name", 'a: "b" #c',
            "--exp_tags", "x", "y z", "--data_dir", "/d/ü", "--loss_depth_weight", "1e16",
            "--channel_wise_stitching"]
    args = parse_args(argv)
    args.extra_inf = float("inf")
    port_path, jax_path = str(tmp_path / "port.yaml"), str(tmp_path / "jax.yaml")
    checkpoint.log_args(args, port_path)
    jax_checkpoint.log_args(args, jax_path)
    want = jax_checkpoint.load_args(jax_path)
    assert want == args
    assert jax_checkpoint.load_args(port_path) == want
    assert checkpoint.load_args(port_path) == want
    assert set(vars(jax_parse_args(argv))) == set(vars(args)) - {"extra_inf"}


def test_cli_trains_and_serves(tiny_synthetic, no_tensorboard, tmp_path, monkeypatch):
    """``training.main`` at the full MTAN width on the CPU (8 synthetic
    samples of 16x16, batch 2), then ``serve --run_dir`` on its run dir
    answers a request with what the trained model predicts; ``--auto_resume``
    finds that run and continues it; ``--ckpt_dir`` starts a fresh run from
    its weights."""
    monkeypatch.setattr(synthetic.synthetic_data_cfg, "height", 16)
    monkeypatch.setattr(synthetic.synthetic_data_cfg, "width", 16)
    monkeypatch.setattr(synthetic.synthetic_data_cfg, "num_train", 8)
    monkeypatch.setattr(synthetic.synthetic_data_cfg, "num_val", 2)
    monkeypatch.setattr(cfg, "log_root_dir", tmp_path)
    trained = {}
    real_run_pipe = training.run_pipe

    def keep_state(args, state, *rest, **kwargs):
        trained["start"] = {k: v.clone() for k, v in state.model.state_dict().items()}
        trained["start_epoch"] = kwargs.get("start_epoch", 0)
        trained["state"], metrics = real_run_pipe(args, state, *rest, **kwargs)
        return trained["state"], metrics

    monkeypatch.setattr(training, "run_pipe", keep_state)
    argv = ["--device", "cpu", "--dataset_name", "synthetic", "--model_name", "mtan",
            "--batch_size", "2", "--num_epochs", "1"]
    run_dir = training.main(argv)
    assert run_dir == str(tmp_path / "training-mtan" / "version_0")
    assert sorted(os.listdir(run_dir)) == [
        "metrics.jsonl", "model_0", "preds.npz", "session_0", "train_args.yaml"]
    records = [json.loads(ln) for ln in open(os.path.join(run_dir, "metrics.jsonl"))]
    keys = set().union(*records)
    for k in ("step/train/loss", "step/val/loss", "epoch/train/imgs_per_sec",
              "epoch/train/jaccard_index", "epoch/val/mae", "predict/accuracy"):
        assert k in keys, k
    assert [r["step"] for r in records if "step/train/loss" in r] == [0, 1, 2]
    preds = np.load(os.path.join(run_dir, "preds.npz"))
    assert preds["segm"].shape == (2, 16, 16) and preds["depth"].shape == (2, 16, 16, 1)
    model = trained["state"].model
    assert checkpoint.load_args(os.path.join(run_dir, "train_args.yaml")).model_name == "mtan"

    servers = []
    make = serve.make_server

    def capture(*args, **kwargs):
        servers.append(make(*args, **kwargs))
        return servers[-1]

    monkeypatch.setattr(serve, "make_server", capture)
    th = threading.Thread(
        target=serve.main,
        args=(["--run_dir", run_dir, "--device", "cpu", "--port", "0", "--buckets", "1"],),
        daemon=True,
    )
    th.start()
    deadline = time.monotonic() + 60
    while not servers and time.monotonic() < deadline:
        time.sleep(0.05)
    assert servers, "the server did not start"
    httpd = servers[0]
    img = np.random.default_rng(0).uniform(size=(16, 16, 3)).astype(np.float32)
    try:
        buf = io.BytesIO()
        np.save(buf, img)
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(
            urllib.request.Request(url + "/predict", data=buf.getvalue()), timeout=60
        ) as r:
            out = np.load(io.BytesIO(r.read()))
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            info = json.loads(r.read())
    finally:
        httpd.shutdown()
        th.join(timeout=60)
    assert not th.is_alive()
    assert info["model"] == "mtan" and info["run_dir"] == run_dir
    want = make_predict_step(model.eval())(torch.from_numpy(img[None]))
    np.testing.assert_array_equal(out["segm"], want["segm"].numpy())
    np.testing.assert_array_equal(out["depth"], want["depth"].numpy())

    saved = checkpoint.load_ckpt_model(run_dir)
    resumed_dir = training.main(argv[:-1] + ["2", "--auto_resume"])
    assert resumed_dir.endswith("version_1") and trained["start_epoch"] == 1
    assert all(torch.equal(trained["start"][k], v) for k, v in saved.items())
    records = [json.loads(ln) for ln in open(os.path.join(resumed_dir, "metrics.jsonl"))]
    assert [r["step"] for r in records if "step/train/loss" in r] == [3, 4, 5]
    assert "model_1" in os.listdir(resumed_dir)
    warm_dir = training.main(argv + ["--ckpt_dir", run_dir])
    assert warm_dir.endswith("version_2") and trained["start_epoch"] == 0
    assert all(torch.equal(trained["start"][k], v) for k, v in saved.items())
    assert trained["state"].step == 3  # a fresh optimizer and step axis


@pytest.mark.parametrize(
    "flag", sorted(NOT_PORTED) + ["mesh_shape", "device"]
)
def test_unported_flags_exit_naming_their_roadmap_item(flag, monkeypatch):
    """A flag whose feature is not ported exits before anything is built.
    Every mesh axis is ported now: ``--mesh_shape`` with a model axis, and
    ``--device cpu:4`` with one beside the spatial axis, pass the CLI's
    checks and reach the launch of the ranks, and so they do beside
    ``--fold_tasks`` (mtan) or ``--fold_tail`` (basic), whose leaves the
    model axis shards as JAX does."""
    values = {"backbone_weights": "imagenet", "remat_tail": "2",
              "mesh_shape": "model:2 --device cpu:2 --model_name mtan",
              "log_param_histograms_every": "25",
              "device": "cpu:4 --mesh_shape spatial:2,model:2 --model_name basic"}
    folded = {"mesh_shape": "--fold_tasks", "device": "--fold_tail"}
    argv = [f"--{flag}"] + (values[flag].split() if flag in values else [])
    monkeypatch.setattr(training, "create_tools", None)  # nothing may be set up
    monkeypatch.setattr(training.multihost, "launch_local_ranks", None)
    if flag in folded:

        def launch(module, launched_argv, world):
            raise SystemExit(f"launched {world} ranks")

        monkeypatch.setattr(training.multihost, "launch_local_ranks", launch)
        world = 2 if flag == "mesh_shape" else 4
        for extra in ([folded[flag]], []):
            with pytest.raises(SystemExit, match=f"launched {world} ranks"):
                training.main(argv + extra + ["--dataset_name", "synthetic"])
        return
    with pytest.raises(SystemExit, match=r"ROADMAP\.md A\d+"):
        training.main(argv + ["--dataset_name", "synthetic"])


# the flags ported with the tuning, tracking and plotting modules: their
# argv beside the tiny CLI run's
SURFACE_FLAGS = {
    "do_optimize": ["--do_optimize"],
    "do_plot_preds": ["--do_plot_preds"],
    "do_show_preds": ["--do_show_preds", "--do_plot_preds"],
    "log_param_histograms_every": ["--log_param_histograms_every", "1"],
}


@pytest.mark.parametrize("flag", sorted(SURFACE_FLAGS))
def test_surface_flags_reach_their_feature(flag, tiny_synthetic, tmp_path, monkeypatch, capsys):
    """Each flag that was refused until its module was ported is accepted
    by ``training.main`` and reaches its feature in a one-epoch tiny run:
    the sweep's best weights train the run registered as ``mtan_tuned``
    (the sweep itself is stubbed here; tests/test_torch_tuning.py runs a
    real one); the benchmark batch and every predict batch are plotted;
    the plots are shown; every step logs one histogram per parameter under
    its JAX path."""
    from vision_mtl_tpu_torch import tuning, vis

    monkeypatch.setattr(cfg, "log_root_dir", tmp_path)
    seen = {"plots": 0, "shown": 0, "histograms": [], "study": []}
    real_plot = vis.plot_preds

    def plot(*args, **kwargs):
        seen["plots"] += 1
        return real_plot(*args, **kwargs)

    def study(args, data_cfg, mesh=None):
        seen["study"].append(args.num_epochs)
        return {"loss_segm_weight": 0.25, "loss_depth_weight": 0.75}

    class Writer:
        def __init__(self, log_dir):
            pass

        def add_scalar(self, *a):
            pass

        def add_histogram(self, tag, values, step):
            seen["histograms"].append((tag, step))

        def close(self):
            pass

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        argparse.Namespace(SummaryWriter=Writer))
    monkeypatch.setattr(vis, "plot_preds", plot)
    monkeypatch.setattr(tuning, "run_study", study)
    import matplotlib.pyplot as plt

    monkeypatch.setattr(plt, "show", lambda: seen.__setitem__("shown", seen["shown"] + 1))
    run_dir = training.main(["--device", "cpu", "--dataset_name", "synthetic", "--model_name",
                             "mtan", "--batch_size", "4", "--num_epochs", "1"]
                            + SURFACE_FLAGS[flag])
    out = capsys.readouterr().out
    assert "plot failed" not in out and os.path.exists(os.path.join(run_dir, "model_0"))
    plotted = flag in ("do_plot_preds", "do_show_preds")
    # the benchmark batch after the epoch, then the predict sweep's one batch
    assert seen["plots"] == (2 if plotted else 0)
    assert seen["shown"] == (2 if flag == "do_show_preds" else 0)
    assert seen["study"] == ([1] if flag == "do_optimize" else [])
    key = "mtan_tuned" if flag == "do_optimize" else "mtan"
    assert f"Registered run {key!r}" in out
    run_args = checkpoint.load_args(os.path.join(run_dir, "train_args.yaml"))
    if flag == "do_optimize":
        assert (run_args.loss_segm_weight, run_args.loss_depth_weight) == (0.25, 0.75)
        assert run_args.exp_tags == ["best_trial"]
    tags = sorted({tag for tag, _ in seen["histograms"]})
    if flag == "log_param_histograms_every":
        model = model_from_args(run_args, fetch_data_cfg("synthetic"), "cpu")
        params = jax_variables_from_model(model)["params"]
        want = sorted("/".join(path) for path in _paths(params))
        assert tags == want and len(seen["histograms"]) == 2 * len(want)
    else:
        assert tags == []


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def test_cli_model_options_reach_the_registry():
    """``--model_name csnet`` builds layer-wise stitch units unless
    ``--channel_wise_stitching`` is given, as JAX's CLI does;
    ``--torch_bn_var`` sets the running-variance switch; ``--precision``
    picks the compute dtype."""
    cfg_syn = fetch_data_cfg("synthetic")
    for flags, channel_wise in (([], False), (["--channel_wise_stitching"], True)):
        argv = ["--model_name", "csnet"] + flags
        assert jax_build_model(jax_parse_args(argv), cfg_syn).channel_wise_stitching is channel_wise
        model = model_from_args(parse_args(argv), cfg_syn, "cpu")
        shapes = {tuple(p.shape) for n, p in model.named_parameters() if n.endswith(".weights")}
        assert shapes and all(len(s) == (3 if channel_wise else 2) for s in shapes), shapes
    try:
        model = model_from_args(parse_args(["--model_name", "mtan", "--torch_bn_var",
                                            "--precision", "f32"]), cfg_syn, "cpu")
        assert blocks.torch_bn_running_var()
        assert not model.training
    finally:
        blocks.set_torch_bn_running_var(False)
    model_from_args(parse_args(["--model_name", "basic"]), cfg_syn, "cpu")
    assert not blocks.torch_bn_running_var()
    assert compute_dtype(parse_args([])) is torch.bfloat16
    assert compute_dtype(parse_args(["--precision", "f32"])) is torch.float32


# each model option flag: its argv and the model it shapes
MODEL_OPTION_FLAGS = {
    "fold_tail": (["--fold_tail"], "basic"),
    "remat_tail": (["--remat_tail", "2"], "csnet"),
    "remat_encoder": (["--remat_encoder"], "basic"),
    "remat_attention": (["--remat_attention"], "mtan"),
    "remat_shared": (["--remat_shared"], "mtan"),
    "fold_tasks": (["--fold_tasks"], "mtan"),
}


def _model_options(model):
    """The model options a port model was built with, under the JAX
    models' field names."""
    if isinstance(model, MTANMiniUnet):
        return {k: getattr(model, k) for k in ("remat_attention", "remat_shared", "fold_tasks")}
    if model.__class__.__name__ == "BasicMTLModel":
        return {"fold_tail": model.fold_tail, "remat_tail": model.backbone.decoder.remat_tail,
                "remat_encoder": model.backbone.encoder.remat}
    return {"remat_encoder": model.encoders_0.remat and model.encoders_1.remat,
            "remat_tail": model.remat_tail}


@pytest.mark.parametrize("flag", sorted(MODEL_OPTION_FLAGS))
def test_model_option_flags_reach_the_model(flag):
    """Each model option flag, given to ``parse_args``, builds through
    ``model_from_args`` the model that JAX's ``build_model`` builds from the
    same argv, with the same option set; the port's parameter tree has
    JAX's names and shapes (the tree-shaping ``fold_tasks`` and the
    tree-keeping ``fold_tail`` included)."""
    flags, name = MODEL_OPTION_FLAGS[flag]
    cfg_syn = fetch_data_cfg("synthetic")
    argv = ["--model_name", name] + flags
    jmodel = jax_build_model(jax_parse_args(argv), cfg_syn)
    model = model_from_args(parse_args(argv), cfg_syn, "cpu")
    got = _model_options(model)
    assert got == {k: getattr(jmodel, k) for k in got}
    assert got[flag] not in (False, 0)
    if flag in ("fold_tasks", "fold_tail"):
        want = jax.eval_shape(lambda: jmodel.init(
            jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
        tree = jax_variables_from_model(model)
        assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda a: a.shape, want)


def test_checkpoint_dir_helpers(tmp_path):
    """Epoch selection by name, pruning in pairs, and the resumable-run
    search (a run name level included) on directories alone."""
    base = tmp_path / "training-mtan"
    runs = {"version_0": ["model_0", "session_0", "model_1"], "version_1": ["model_0"],
            "exp/version_0": [f"{p}_{e}" for e in range(4) for p in ("model", "session")]}
    for run, entries in runs.items():
        for e in entries:
            (base / run / e).mkdir(parents=True)
        os.utime(base / run, (time.time() + len(run), time.time() + len(run)))
    assert checkpoint._latest_common_epoch(str(base / "version_0")) == 0
    assert checkpoint._latest_epoch(str(base / "version_0"), "model") == 1
    with pytest.raises(ValueError, match="exact-resume"):
        checkpoint._latest_common_epoch(str(base / "version_1"))
    assert checkpoint.find_latest_resumable_run(str(base)) == str(base / "exp" / "version_0")
    assert checkpoint.find_latest_resumable_run(str(tmp_path / "none")) is None
    assert checkpoint.prune_old_ckpts(str(base / "exp" / "version_0"), 2) == [0, 1]
    assert sorted(os.listdir(base / "exp" / "version_0")) == [
        "model_2", "model_3", "session_2", "session_3"]
    assert checkpoint.prune_old_ckpts(str(base / "exp" / "version_0"), 0) == []
    (tmp_path / "ref").mkdir()
    (tmp_path / "ref" / "model_3.pt").write_bytes(b"")
    with pytest.raises(ValueError, match="No model ckpt"):
        checkpoint.load_ckpt_model(str(tmp_path / "ref"))
    # restore_state imports a reference dir's model_{e}.pt; the port's own
    # model_{e}/ wins where both are present
    ref = str(tmp_path / "ref")
    assert checkpoint._maybe_reference_torch_ckpt(ref, None) == os.path.join(ref, "model_3.pt")
    (tmp_path / "ref" / "model_0").mkdir()
    assert checkpoint._maybe_reference_torch_ckpt(ref, None) is None

