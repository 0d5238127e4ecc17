"""The port's reference-checkpoint interop (``utils/ckpt_import.py``,
``utils/torch_port.py``, ``weights.jax_variables_from_model``, the reference
paths of ``train/checkpoint.py``, ``pipeline.py`` and the CLI) against the
JAX package's, in f32, on the same seeded reference-layout state dicts:
imported forwards, exports key for key and bit for bit, the round trip,
a reference session's Adam moments, lr, plateau state and epoch, the error
diffs, the directory helpers, the imagenet encoder, PyYAML's
``train_args.yaml`` and the CLI on reference run dirs. Small widths: basic
and CSNet at ``decoder_first_channel=32``, MTAN at ``encoder_first_channel=8``
with 16 hidden gate channels, 32x32 inputs."""

import argparse
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_ckpt_import import _RefMiniUnet, _rand_basic_sd, _rand_csnet_sd, _randomize_module
from tests.test_torch_port import _rand_sd
from vision_mtl_tpu.models.basic import BasicMTLModel as JaxBasic
from vision_mtl_tpu.models.cross_stitch import CSNet as JaxCSNet
from vision_mtl_tpu.models.mtan import MTANMiniUnet as JaxMTAN
from vision_mtl_tpu.train import checkpoint as jax_checkpoint
from vision_mtl_tpu.train.plateau import ReduceLROnPlateau as JaxPlateau
from vision_mtl_tpu.train.state import TrainState as JaxTrainState
from vision_mtl_tpu.train.state import make_optimizer
from vision_mtl_tpu.utils import ckpt_import as jax_ci
from vision_mtl_tpu.utils import torch_port as jax_tp
from vision_mtl_tpu_torch import eval_harness, training
from vision_mtl_tpu_torch.cfg import cfg
from vision_mtl_tpu_torch.data import synthetic
from vision_mtl_tpu_torch.models.basic import BasicMTLModel
from vision_mtl_tpu_torch.models.cross_stitch import CSNet
from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet
from vision_mtl_tpu_torch.models.registry import build_model
from vision_mtl_tpu_torch.pipeline import load_run_model
from vision_mtl_tpu_torch.train import checkpoint
from vision_mtl_tpu_torch.train.plateau import ReduceLROnPlateau
from vision_mtl_tpu_torch.train.state import create_train_state, get_lr
from vision_mtl_tpu_torch.utils import ckpt_import, torch_port
from vision_mtl_tpu_torch.weights import (
    _leaves,
    jax_variables_from_model,
    load_jax_variables,
    port_tensors,
)

NC = 5
TASKS = {"depth": 1, "segm": NC}
CHANNELS = [32, 16, 8, 4, 2]  # decoder_first_channel=32
HW = (32, 32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port(name, channel_wise=True, merge_heads=True):
    if name == "mtan":
        return MTANMiniUnet(TASKS, task_subnets_hidden_channels=16, encoder_first_channel=8,
                            encoder_num_channels=4, dtype=torch.float32)
    if name == "basic":
        return BasicMTLModel(NC, decoder_first_channel=32, merge_heads=merge_heads,
                             dtype=torch.float32)
    return CSNet(TASKS, decoder_first_channel=32, channel_wise_stitching=channel_wise,
                 dtype=torch.float32)


def _jax(name, channel_wise=True):
    if name == "mtan":
        return JaxMTAN(map_tasks_to_num_channels=TASKS, task_subnets_hidden_channels=16,
                       encoder_first_channel=8, encoder_num_channels=4, dtype=jnp.float32)
    if name == "basic":
        return JaxBasic(segm_classes=NC, decoder_first_channel=32, dtype=jnp.float32)
    return JaxCSNet(task_channels=TASKS, decoder_first_channel=32,
                    channel_wise_stitching=channel_wise, dtype=jnp.float32)


_JAX_FORWARDS = {}


def _jax_forward(name, variables, x, channel_wise=True):
    """JAX's eval forward, jitted once per architecture and shape."""
    key = (name, channel_wise, x.shape)
    if key not in _JAX_FORWARDS:
        model = _jax(name, channel_wise)
        _JAX_FORWARDS[key] = jax.jit(lambda v, a: model.apply(v, a, train=False))
    return _JAX_FORWARDS[key](variables, x)


def _reference_sd(name, seed, channel_wise=True):
    """A seeded state_dict in the reference's layout, with the Lightning
    wrapper's ``model.`` prefix (MTAN's from torch modules with the
    reference's attribute names)."""
    rng = np.random.default_rng(seed)
    if name == "mtan":
        replica = _RefMiniUnet(TASKS, first=8, levels=4, hidden=16).eval()
        _randomize_module(replica, rng)
        sd = {k: v.detach().numpy().copy() for k, v in replica.state_dict().items()}
    elif name == "basic":
        sd = _rand_basic_sd(rng, CHANNELS, segm_classes=NC)
    else:
        sd = _rand_csnet_sd(rng, CHANNELS, segm_classes=NC, channel_wise=channel_wise)
    return {f"model.{k}": v for k, v in sd.items()}


CASES = {  # id: (model, channel_wise, seed)
    "mtan": ("mtan", True, 17), "basic": ("basic", True, 31),
    "csnet_cw": ("csnet", True, 23), "csnet_lw": ("csnet", False, 29),
}


def _image(seed=2):
    return np.random.default_rng(seed).uniform(size=(1, *HW, 3)).astype(np.float32)


def _assert_close(got, want):
    for k in want:
        want_k = np.asarray(want[k])
        np.testing.assert_allclose(got[k], want_k, rtol=2e-4,
                                   atol=2e-4 * float(np.abs(want_k).max()), err_msg=k)


def _same_state(got, want):
    """Two modules with equal state dicts, bit for bit (each read once)."""
    got, want = got.state_dict(), want.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def _same_tree(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _same_tree(a[k], b[k])
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_import_forward_matches_jax(case):
    """A reference checkpoint through the port's import and forward, and
    through JAX's import and forward: the same JAX tree bit for bit, the
    same outputs (basic with merged heads and with separate ones)."""
    name, cw, seed = CASES[case]
    sd = _reference_sd(name, seed, cw)
    model = _port(name, cw)
    assert ckpt_import.import_reference_checkpoint(name, sd, model) is model
    variables = jax_ci.import_reference_checkpoint(name, sd, jax_variables_from_model(model))
    _same_tree(jax_variables_from_model(model), jax.device_get(variables))
    x = _image()
    with torch.no_grad():
        got = {k: v.numpy() for k, v in model(torch.from_numpy(x)).items()}
    _assert_close(got, _jax_forward(name, variables, x, cw))
    if name == "basic":
        # both heads keep their own paths: the separate heads' forward
        # agrees with the merged one (one conv on the concatenated kernels)
        separate = ckpt_import.import_reference_checkpoint(
            name, sd, _port(name, merge_heads=False))
        with torch.no_grad():
            apart = {k: v.numpy() for k, v in separate(torch.from_numpy(x)).items()}
        for k in got:
            np.testing.assert_allclose(apart[k], got[k], rtol=1e-5,
                                       atol=1e-5 * float(np.abs(got[k]).max()), err_msg=k)


def _random_variables(model, seed):
    rng = np.random.default_rng(seed)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else
                rng.normal(scale=0.5, size=v.shape).astype(np.float32) for k, v in tree.items()}

    return fill(jax_variables_from_model(model))


@pytest.mark.parametrize("case", ["mtan", "basic", "csnet_cw"])
def test_export_equals_jax_bit_for_bit(case):
    """The port's ``export_reference_checkpoint`` equals JAX's key for key
    and bit for bit, the ``model.`` prefix and ``num_batches_tracked``
    included (MTAN's keys in the reference module's own order, which a
    session's optimizer indices follow); then port -> reference -> port is
    the identity."""
    name, cw, _ = CASES[case]
    model = _port(name, cw)
    variables = _random_variables(model, 57)
    load_jax_variables(model, variables)
    for module_level in (True, False):
        got = ckpt_import.export_reference_checkpoint(name, model, module_level=module_level)
        want = jax_ci.export_reference_checkpoint(name, variables, module_level=module_level)
        assert sorted(got) == sorted(want)
        assert all(k.startswith("model.") == module_level for k in got)
        if name == "mtan" and not module_level:
            assert list(got) == list(_RefMiniUnet(TASKS, first=8, levels=4, hidden=16).state_dict())
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = ckpt_import.import_reference_checkpoint(
        name, ckpt_import.export_reference_checkpoint(name, model), _port(name, cw))
    _same_state(back, model)


def test_shared_layouts_pass_unchanged():
    """Composing the entry table with the weight bridge is the identity
    wherever the reference and the port share torch's layout (convs, the
    transposed convs, BatchNorm, stitches): only the gates' 1x1 convs
    change, (out, in, 1, 1) -> (in, out)."""
    for case in ("mtan", "csnet_lw"):
        name, cw, seed = CASES[case]
        sd = ckpt_import.normalize_reference_state_dict(_reference_sd(name, seed, cw))
        model = ckpt_import.import_reference_checkpoint(name, sd, _port(name, cw))
        port_key = {key: torch_key for torch_key, key, _ in _leaves(model)}
        state = model.state_dict()
        kinds = set()
        for ref_key, col, path, kind in ckpt_import._MAPPINGS[name]():
            got = state[port_key["/".join((col,) + path)]].numpy()
            want = sd[ref_key][:, :, 0, 0].T if kind == "gate_w" else sd[ref_key]
            np.testing.assert_array_equal(got, want, err_msg=ref_key)
            kinds.add(kind)
        assert kinds == ({"conv", "convt", "gate_w", "direct"} if name == "mtan"
                         else {"conv", "direct"})


def test_from_jax_to_the_port_through_reference_files(tmp_path):
    """JAX's ``save_reference_checkpoint`` writes a run dir's ``model_2.pt``;
    the port's ``restore_state`` on that dir gives JAX's forward."""
    model = _port("mtan")
    variables = _random_variables(model, 61)
    jax_ci.save_reference_checkpoint(str(tmp_path / "model_2.pt"), "mtan", variables)
    state = create_train_state(_port("mtan"), 1e-3, device="cpu")
    state = checkpoint.restore_state(state, str(tmp_path))
    x = _image(3)
    with torch.no_grad():
        got = {k: v.numpy() for k, v in state.model.eval()(torch.from_numpy(x)).items()}
    _assert_close(got, _jax_forward("mtan", variables, x))


def _reference_run(tmp_path, epoch=4):
    """A reference run dir: the replica trained 3 Adam steps, its plateau
    scheduler stepped twice, ``model_{epoch}.pt`` and ``session_{epoch}.pt``
    in the reference's save format. Returns the replica and its optimizer."""
    rng = np.random.default_rng(43)
    replica = _RefMiniUnet(TASKS, first=8, levels=4, hidden=16).train()
    _randomize_module(replica, rng)
    opt = torch.optim.Adam(replica.parameters(), lr=5e-4)
    sched = torch.optim.lr_scheduler.ReduceLROnPlateau(opt, patience=2, factor=0.9)
    x = torch.from_numpy(rng.uniform(size=(1, 3, *HW)).astype(np.float32))
    for _ in range(3):
        opt.zero_grad()
        out = replica(x)
        (out["depth"].square().mean() + out["segm"].square().mean()).backward()
        opt.step()
    sched.step(1.0)
    sched.step(2.0)  # worse: num_bad_epochs becomes 1
    torch.save({"model": {f"model.{k}": v for k, v in replica.state_dict().items()}},
               tmp_path / f"model_{epoch}.pt")
    torch.save({"optimizer": opt.state_dict(), "scheduler": sched.state_dict(), "epoch": epoch},
               tmp_path / f"session_{epoch}.pt")
    return replica, opt


def test_session_import_matches_jax(tmp_path):
    """A reference ``session_{e}.pt`` imports to JAX's moments (mapped onto
    the port's layout by name), lr, plateau state, step and epoch; then one
    Adam step of the port equals one step of the reference's own torch Adam
    from the same numbers, mapped; and the port's session exports back to
    the same optimizer state."""
    import optax

    replica, opt = _reference_run(tmp_path)
    state = create_train_state(_port("mtan"), 1e-3, device="cpu")
    state, sched, start = checkpoint.restore_session(
        state, ReduceLROnPlateau(patience=5, factor=0.5), str(tmp_path))

    # JAX's TrainState over the same tree (flax's init would only shape it),
    # made in one jitted call: eagerly, each of its zero moments is a dispatch
    fresh = jax_variables_from_model(_port("mtan"))
    apply = _jax("mtan").apply
    jstate = jax.jit(lambda p, b: JaxTrainState.create(
        apply_fn=apply, params=p, tx=make_optimizer(1e-3), batch_stats=b))(
        fresh["params"], fresh["batch_stats"])
    jstate, jsched, jstart = jax_checkpoint.restore_session(
        jstate, JaxPlateau(patience=5, factor=0.5), str(tmp_path))
    assert start == jstart == 5 and state.step == int(jstate.step) == 3
    assert get_lr(state) == pytest.approx(5e-4, rel=1e-9)
    assert sched.state_dict() == jsched.state_dict()
    adam = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    stats = jax.device_get(jstate.batch_stats)
    opt_state = state.optimizer.state_dict()["state"]
    names = [n for n, _ in state.model.named_parameters()]
    for field, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = port_tensors(state.model, {"params": jax.device_get(tree), "batch_stats": stats})
        for i, n in enumerate(names):
            np.testing.assert_array_equal(opt_state[i][field].numpy(), want[n], err_msg=n)
            assert float(opt_state[i]["step"]) == 3.0

    # one more step from the same numbers on both sides, with one gradient
    rng = np.random.default_rng(5)
    grads = {k: rng.normal(size=p.shape).astype(np.float32)
             for k, p in replica.named_parameters()}
    for k, p in replica.named_parameters():
        p.grad = torch.from_numpy(grads[k])
    opt.step()
    ref_sd = {k: v.detach().numpy() for k, v in replica.state_dict().items()}
    port_grads = ckpt_import._moments_by_port_name("mtan", state.model, grads, ref_sd)
    for n, p in state.model.named_parameters():
        p.grad = torch.from_numpy(port_grads[n])
    state.optimizer.step()
    want = ckpt_import.import_reference_checkpoint("mtan", ref_sd, _port("mtan"))
    got_sd = state.model.state_dict()
    for k, v in want.state_dict().items():
        torch.testing.assert_close(got_sd[k], v, rtol=1e-6, atol=1e-7)

    exported = ckpt_import.export_reference_session("mtan", state, sched, 5)
    again = create_train_state(_port("mtan"), 1e-3, device="cpu")
    ckpt_import.import_reference_checkpoint("mtan", ref_sd, again.model)
    again, sched2, start2 = ckpt_import.import_reference_session(
        ref_sd, exported, again, ReduceLROnPlateau())
    assert start2 == 6 and again.step == 4 and sched2.state_dict() == sched.state_dict()
    got_state = again.optimizer.state_dict()["state"]
    want_state = state.optimizer.state_dict()["state"]
    for i in opt_state:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got_state[i][k], want_state[i][k])


def test_import_errors_match_jax(tmp_path):
    """The missing/unused key diff, a channel-wise CSNet checkpoint into a
    layer-wise model, and a resume without a session, with JAX's texts."""
    sd = _reference_sd("basic", 5)
    del sd["model.backbone.decoder.blocks.2.conv1.0.weight"]
    sd["model.backbone.totally_unrelated.weight"] = np.zeros(3, np.float32)
    sd = {k[len("model."):]: v for k, v in sd.items()}
    model = _port("basic")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for fn, target in ((ckpt_import.import_reference_checkpoint, model),
                       (jax_ci.import_reference_checkpoint, jax_variables_from_model(model))):
        with pytest.raises(ValueError) as ei:
            fn("basic", sd, target)
        assert "backbone.decoder.blocks.2.conv1.0.weight" in str(ei.value)
        assert "backbone.totally_unrelated.weight" in str(ei.value)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())

    sd = _reference_sd("csnet", 7, channel_wise=True)
    with pytest.raises(ValueError, match="weights") as ei:
        ckpt_import.import_reference_checkpoint("csnet", sd, _port("csnet", channel_wise=False))
    assert "channel_wise_stitching=False" in str(ei.value)
    with pytest.raises(ValueError, match="weights"):
        jax_ci.import_reference_checkpoint(
            "csnet", sd, jax_variables_from_model(_port("csnet", channel_wise=False)))

    replica = _RefMiniUnet(TASKS, first=8, levels=4, hidden=16)
    torch.save({"model": {f"model.{k}": v for k, v in replica.state_dict().items()}},
               tmp_path / "model_3.pt")
    state = create_train_state(_port("mtan"), 1e-3, device="cpu")
    with pytest.raises(ValueError, match="session_3.pt"):
        checkpoint.restore_session(state, ReduceLROnPlateau(), str(tmp_path))
    (tmp_path / "best.pt").write_bytes((tmp_path / "model_3.pt").read_bytes())
    with pytest.raises(ValueError, match="weights-only"):
        checkpoint.restore_session(state, ReduceLROnPlateau(), str(tmp_path / "best.pt"))
    (tmp_path / "session_3.pt").write_bytes(b"not a pickle")
    with pytest.raises(ValueError, match="session_3.pt"):
        checkpoint.restore_session(state, ReduceLROnPlateau(), str(tmp_path))


def test_csnet_dir_without_args_takes_the_checkpoints_stitching(tmp_path):
    """A reference CSNet run dir whose args do not say how it stitches is
    rebuilt with its checkpoint's stitch layout (channel-wise here, against
    the harness's layer-wise default)."""
    from vision_mtl_tpu_torch.cfg import fetch_data_cfg

    src = build_model("csnet", fetch_data_cfg("synthetic"), dtype=torch.float32, device="cpu",
                      seed=2, channel_wise_stitching=True)
    ckpt_import.save_reference_checkpoint(str(tmp_path / "model_0.pt"), "csnet", src)
    model, _, run_args = load_run_model(str(tmp_path), "cpu", "csnet", "synthetic",
                                        defaults={"channel_wise_stitching": False})
    assert run_args.channel_wise_stitching is True
    _same_state(model, src)


def test_helpers_match_jax(tmp_path):
    """``find_reference_checkpoint`` and ``infer_reference_model_name`` give
    JAX's answers; ``normalize_reference_state_dict`` strips the wrapper."""
    for d in ("empty", "run", "nope"):
        if d != "nope":
            (tmp_path / d).mkdir()
    for f in ("model_3.pt", "model_10.pt", "session_10.pt", "model_x.pt", "model_2.pt.tmp"):
        (tmp_path / "run" / f).write_bytes(b"x")
    for d in ("empty", "run", "nope"):
        path = str(tmp_path / d)
        assert ckpt_import.find_reference_checkpoint(path) == jax_ci.find_reference_checkpoint(path)
    assert ckpt_import.find_reference_checkpoint(str(tmp_path / "run")).endswith("model_10.pt")
    for name, cw, seed in CASES.values():
        sd = _reference_sd(name, seed, cw)
        bare = ckpt_import.normalize_reference_state_dict(sd)
        assert bare == jax_ci.normalize_reference_state_dict(sd)
        assert not any(k.startswith("model.") for k in bare)
        assert ckpt_import.infer_reference_model_name(bare) == \
            jax_ci.infer_reference_model_name(bare) == name
        assert ckpt_import.reference_param_order(bare) == jax_ci.reference_param_order(bare)
    with pytest.raises(ValueError, match="roots"):
        ckpt_import.infer_reference_model_name({"head.weight": 0})


@pytest.fixture(scope="module")
def timm_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("timm") / "mobilenetv3_large_100.npz"
    sd = _rand_sd(np.random.default_rng(71))
    np.savez(path, **{f"encoder.model.{k}": v for k, v in sd.items()})
    return str(path)


def test_imagenet_backbone_matches_jax(timm_npz, capsys):
    """A timm-layout state dict gives the same encoder through JAX's
    converter as through the port's: the same tree bit for bit, the same
    pyramid; both CSNet encoders take it; MTAN has none; a missing file
    returns False."""
    model = _port("basic")
    assert torch_port.apply_imagenet_backbone(model, "basic", timm_npz)
    jvars = jax_variables_from_model(model)
    params, stats, loaded = jax_tp.apply_imagenet_backbone(
        jvars["params"], jvars["batch_stats"], "basic", timm_npz)
    assert loaded
    _same_tree(jvars["params"]["backbone"]["encoder"], params["backbone"]["encoder"])
    _same_tree(jvars["batch_stats"]["backbone"]["encoder"], stats["backbone"]["encoder"])
    # the encoder outputs of both conversions (the bridge's forward is held
    # to flax's by tests/test_torch_basic.py)
    jax_loaded = _port("basic")
    jax_loaded.backbone.encoder.load_state_dict(model.backbone.encoder.state_dict())
    load_jax_variables(jax_loaded.backbone.encoder, {
        "params": params["backbone"]["encoder"], "batch_stats": stats["backbone"]["encoder"]})
    x = torch.from_numpy(_image(4))
    with torch.no_grad():
        for g, w in zip(model.backbone.encoder(x), jax_loaded.backbone.encoder(x), strict=True):
            assert torch.equal(g, w)

    cs = _port("csnet", channel_wise=False)
    assert torch_port.apply_imagenet_backbone(cs, "csnet", timm_npz)
    _same_state(cs.encoders_0, model.backbone.encoder)
    _same_state(cs.encoders_1, model.backbone.encoder)
    assert not torch_port.apply_imagenet_backbone(_port("mtan"), "mtan", timm_npz)
    missing = timm_npz.replace(".npz", "_missing.npz")
    assert not torch_port.apply_imagenet_backbone(_port("basic"), "basic", missing)
    assert "no imagenet weights" in capsys.readouterr().out
    assert torch_port.DEFAULT_WEIGHTS.endswith(
        os.path.join("vision_mtl_tpu", "weights", "mobilenetv3_large_100.npz"))
    assert os.path.dirname(torch_port.DEFAULT_WEIGHTS) == jax_tp.WEIGHTS_DIR


def test_train_args_written_by_pyyaml_read_alike(tmp_path):
    """The port reads the ``train_args.yaml`` that PyYAML writes for the
    reference and the JAX package (block lists, quoted strings, nulls,
    floats), and raises naming a line it cannot read."""
    args = argparse.Namespace(
        model_name="csnet", dataset_name="cityscapes", lr=5e-4, batch_size=8, seed=11,
        exp_tags=["reference", "run 1", "true", "7"], ckpt_dir=None, backbone_weights="imagenet",
        channel_wise_stitching=True, mesh_shape="data:-1", run_name="", loss_weight=1e-05,
        extra=[], flag=False,
    )
    jax_checkpoint.log_args(args, str(tmp_path / "train_args.yaml"))
    assert "  exp_tags:\n  - reference\n" in (tmp_path / "train_args.yaml").read_text()
    assert vars(checkpoint.load_args(str(tmp_path / "train_args.yaml"))) == vars(args)
    (tmp_path / "bad.yaml").write_text("args:\n  name: &anchor x\n")
    with pytest.raises(ValueError, match="name"):
        checkpoint.load_args(str(tmp_path / "bad.yaml"))
    (tmp_path / "wrapped.yaml").write_text("args:\n  a: 1\n    continued\n")
    with pytest.raises(ValueError, match="continued"):
        checkpoint.load_args(str(tmp_path / "wrapped.yaml"))


@pytest.fixture
def tiny_cli(monkeypatch, tmp_path):
    """Synthetic 32x32 set of 4 train and 2 val samples; runs under
    tmp_path; no TensorBoard (importing it loads TensorFlow here)."""
    for k, v in dict(height=32, width=32, num_classes=NC, num_train=4, num_val=2).items():
        monkeypatch.setattr(synthetic.synthetic_data_cfg, k, v)
    monkeypatch.setattr(cfg, "log_root_dir", tmp_path / "logs")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    seen = {}
    real = training.run_pipe

    def recording(args, state, *rest, **kw):
        seen["start"] = {k: v.clone() for k, v in state.model.state_dict().items()}
        seen["start_epoch"] = kw.get("start_epoch", 0)
        seen["lr"] = get_lr(state)
        return real(args, state, *rest, **kw)

    monkeypatch.setattr(training, "run_pipe", recording)
    return seen


def test_cli_takes_reference_run_dirs(tiny_cli, tmp_path, monkeypatch, timm_npz, capsys):
    """A reference run dir (registry-width MTAN, ``model_1.pt``, a synthetic
    ``session_1.pt``, PyYAML's ``train_args.yaml``) loads through ``serve
    --run_dir``'s and the harness's loader; ``--device cpu`` with
    ``--resume_dir`` and ``--ckpt_dir`` on it, and ``--backbone_weights
    imagenet``, run instead of exiting: the resume starts at epoch 2 with
    the session's lr, the warm start at epoch 0, both from the checkpoint's
    weights; basic starts from the imagenet encoder."""
    ref = tmp_path / "reference"
    ref.mkdir()
    src = build_model("mtan", synthetic.synthetic_data_cfg, dtype=torch.float32, device="cpu",
                      seed=9)
    ckpt_import.save_reference_checkpoint(str(ref / "model_1.pt"), "mtan", src)
    ref_sd = ckpt_import.export_reference_checkpoint("mtan", src, module_level=False)
    order = ckpt_import.reference_param_order(ref_sd)
    rng = np.random.default_rng(3)
    torch.save({
        "optimizer": {"state": {i: {"step": torch.tensor(8.0),
                                    "exp_avg": torch.from_numpy(
                                        rng.normal(size=ref_sd[k].shape).astype(np.float32)),
                                    "exp_avg_sq": torch.from_numpy(
                                        rng.uniform(size=ref_sd[k].shape).astype(np.float32))}
                                for i, k in enumerate(order)},
                      "param_groups": [{"lr": 7e-4, "betas": (0.9, 0.999), "eps": 1e-8,
                                        "weight_decay": 0, "amsgrad": False,
                                        "params": list(range(len(order)))}]},
        "scheduler": {"patience": 2, "factor": 0.9, "best": 3.5, "num_bad_epochs": 1,
                      "min_lrs": [0.0], "threshold": 1e-4},
        "epoch": 1,
    }, ref / "session_1.pt")
    # serve --run_dir's and the harness's loader on the dir, with the
    # train_args.yaml PyYAML writes
    jax_checkpoint.log_args(argparse.Namespace(model_name="mtan", dataset_name="synthetic",
                                               exp_tags=["ref"], precision="f32"),
                            str(ref / "train_args.yaml"))
    served, _, run_args = load_run_model(str(ref), "cpu")
    assert run_args.exp_tags == ["ref"] and not served.training
    _same_state(served, src)
    eval_harness.main(["--dataset_name", "synthetic", "--device", "cpu", "--runs",
                       f"mtan={ref}"])
    assert "mtan" in capsys.readouterr().out

    common = ["--device", "cpu", "--dataset_name", "synthetic", "--batch_size", "2"]
    training.main(common + ["--model_name", "mtan", "--num_epochs", "3", "--resume_dir",
                            str(ref)])
    assert tiny_cli["start_epoch"] == 2 and tiny_cli["lr"] == pytest.approx(7e-4)
    for k, v in src.state_dict().items():
        assert torch.equal(tiny_cli["start"][k], v), k
    training.main(common + ["--model_name", "mtan", "--num_epochs", "0", "--ckpt_dir", str(ref)])
    assert tiny_cli["start_epoch"] == 0
    for k, v in src.state_dict().items():
        assert torch.equal(tiny_cli["start"][k], v), k

    monkeypatch.setattr(torch_port, "DEFAULT_WEIGHTS", timm_npz)
    training.main(common + ["--model_name", "basic", "--num_epochs", "0", "--backbone_weights",
                            "imagenet"])
    want = _port("basic")
    torch_port.apply_imagenet_backbone(want, "basic", timm_npz)
    for k, v in want.backbone.encoder.state_dict().items():
        assert torch.equal(tiny_cli["start"][f"backbone.encoder.{k}"], v), k


def test_export_cli_writes_what_jax_imports(tmp_path):
    """``python -m vision_mtl_tpu_torch.export_torch_ckpt <run_dir> --device cpu`` on a
    port run dir writes ``model_{e}.pt`` in the reference's format, which
    the JAX package's importer takes strictly, to the port's own tree."""
    from vision_mtl_tpu_torch import export_torch_ckpt
    from vision_mtl_tpu_torch.cfg import fetch_data_cfg

    data_cfg = fetch_data_cfg("synthetic")
    state = create_train_state(build_model("mtan", data_cfg, dtype=torch.float32, device="cpu",
                                           seed=5), 1e-3, device="cpu")
    checkpoint.save_ckpt(state, ReduceLROnPlateau(), 2, str(tmp_path))
    checkpoint.log_args({"model_name": "mtan", "dataset_name": "synthetic"},
                        str(tmp_path / "train_args.yaml"))
    out = export_torch_ckpt.main([str(tmp_path), "--device", "cpu"])
    assert out == str(tmp_path / "model_2.pt")
    tree = jax_variables_from_model(state.model)
    _same_tree(jax.device_get(jax_ci.import_reference_checkpoint("mtan", out, tree)), tree)
    npz = export_torch_ckpt.main([str(tmp_path), "--epoch", "2", "--out", str(tmp_path / "m.npz"),
                               "--device", "cpu"])
    with np.load(npz) as z:
        sd = torch.load(out, map_location="cpu", weights_only=True)["model"]
        assert sorted(z.files) == sorted(sd)
        assert all(np.array_equal(z[k], sd[k].numpy()) for k in z.files)
