"""MTAN's ``fold_tasks`` on the CPU: each level's T attention modules as one
module over a leading task axis, against the JAX package's ``nn.vmap``
version (MTAN with encoder_first_channel 8, 3 levels, hidden 16, 32x32, as
``tests/test_fold_tasks.py``): ``fold_task_state_dict`` against
``fold_task_variables`` through the weight bridge (exactly), the folded
parameter tree against JAX's ``eval_shape`` of ``MTANMiniUnet(fold_tasks=
True)`` (names and shapes), the folded eval forward in f32 and one folded
train step in f64 against JAX's; the task-axis plain versions of B1 and B4
against per-task calls; a ``--fold_tasks`` run's checkpoint through
``load_run_model`` and ``--resume_dir``; a CPU export of a folded MTAN."""

import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_basic import _random_variables
from vision_mtl_tpu.models import blocks as jax_blocks
from vision_mtl_tpu.models.mtan import MTANMiniUnet as JaxMTAN
from vision_mtl_tpu.models.mtan import fold_task_variables
from vision_mtl_tpu.train import step as jax_step
from vision_mtl_tpu_torch import training
from vision_mtl_tpu_torch.cfg import cfg, fetch_data_cfg
from vision_mtl_tpu_torch.data import synthetic
from vision_mtl_tpu_torch.kernels import fused_gate, fused_gate_train
from vision_mtl_tpu_torch.metrics import init_metrics
from vision_mtl_tpu_torch.models import blocks
from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet, fold_task_state_dict
from vision_mtl_tpu_torch.models.registry import build_model
from vision_mtl_tpu_torch.pipeline import load_run_model
from vision_mtl_tpu_torch.serving import Predictor, export_model, load_exported
from vision_mtl_tpu_torch.train import checkpoint
from vision_mtl_tpu_torch.train.state import create_train_state
from vision_mtl_tpu_torch.train.step import make_train_step
from vision_mtl_tpu_torch.utils import ckpt_import
from vision_mtl_tpu_torch.weights import jax_variables_from_model, load_jax_variables

NC = 5
TASKS = {"depth": 1, "segm": NC}
KW = dict(task_subnets_hidden_channels=16, encoder_first_channel=8, encoder_num_channels=3)
HW = (32, 32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_model(fold_tasks, dtype=jnp.float32):
    return JaxMTAN(map_tasks_to_num_channels=TASKS, fold_tasks=fold_tasks, dtype=dtype, **KW)


def _port(fold_tasks, dtype=torch.float32):
    model = MTANMiniUnet(TASKS, fold_tasks=fold_tasks, dtype=dtype, **KW)
    return model.double() if dtype == torch.float64 else model


@pytest.fixture(scope="module")
def trees():
    """Seeded values of the unfolded JAX tree and JAX's folded conversion."""
    shapes = jax.eval_shape(lambda: _jax_model(False).init(
        jax.random.key(0), jnp.zeros((1, *HW, 3)), train=False))
    variables = _random_variables(shapes, np.random.default_rng(8))
    return variables, jax.device_get(fold_task_variables(variables, 2))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_fold_task_state_dict_matches_fold_task_variables(trees):
    variables, folded_vars = trees
    unfolded = _port(False)
    load_jax_variables(unfolded, variables)
    folded = _port(True)
    folded.load_state_dict(fold_task_state_dict(unfolded.state_dict(), 2))
    got, want = _leaves(jax_variables_from_model(folded)), _leaves(folded_vars)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    twin = _port(True)
    load_jax_variables(twin, folded_vars)
    for k, v in folded.state_dict().items():
        assert torch.equal(twin.state_dict()[k], v), k
    with pytest.raises(ValueError, match="tasks"):
        fold_task_state_dict(unfolded.state_dict(), 3)


def test_folded_tree_matches_jax_eval_shape():
    """Names and shapes of the folded model against flax's; at the trained
    config the parameter count is the unfolded model's, and a folded model
    drawn from a seed holds the converted weights of the unfolded one."""
    want = jax.eval_shape(lambda: _jax_model(True).init(
        jax.random.key(0), jnp.zeros((1, *HW, 3)), train=False))
    got = jax_variables_from_model(_port(True))
    assert {k: v.shape for k, v in _leaves(got).items()} == {
        jax.tree_util.keystr(p): v.shape
        for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert "enc_attn_0_folded" in got["params"] and "enc_attn_0_task0" not in got["params"]
    data_cfg = fetch_data_cfg("cityscapes")
    plain = build_model("mtan", data_cfg, device="cpu", seed=3)
    folded = build_model("mtan", data_cfg, device="cpu", seed=3, fold_tasks=True)
    assert sum(p.numel() for p in folded.parameters()) == 13_277_908
    converted = fold_task_state_dict(plain.state_dict(), 2)
    for k, v in folded.state_dict().items():
        assert torch.equal(converted[k], v), k


def test_folded_eval_forward_matches_jax(trees, monkeypatch):
    """f32: within 2e-4 of JAX's folded forward; bit for bit the port's
    unfolded forward; one task-axis gate call per level (6 here), no
    one-task call."""
    variables, folded_vars = trees
    x = np.random.default_rng(0).uniform(size=(2, *HW, 3)).astype(np.float32)
    jmodel = _jax_model(True)
    want = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(folded_vars, jnp.asarray(x))
    model = _port(True)
    load_jax_variables(model, folded_vars)
    plain_model = _port(False)
    load_jax_variables(plain_model, variables)
    calls = {"tasks": 0, "one": 0}
    real_tasks = fused_gate.fused_attention_gate_tasks_plain
    real_one = fused_gate.fused_attention_gate_plain
    monkeypatch.setattr(fused_gate, "fused_attention_gate_tasks_plain",
                        lambda *a: calls.__setitem__("tasks", calls["tasks"] + 1) or real_tasks(*a))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        monkeypatch.setattr(fused_gate, "fused_attention_gate_tasks_plain", real_tasks)
        monkeypatch.setattr(fused_gate, "fused_attention_gate_plain",
                            lambda *a: calls.__setitem__("one", calls["one"] + 1) or real_one(*a))
        unfolded = plain_model(torch.from_numpy(x))
    assert calls == {"tasks": 6, "one": 12}
    for k in ("segm", "depth"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=2e-4,
                                   atol=2e-4 * float(np.abs(w).max()), err_msg=k)
        assert torch.equal(got[k], unfolded[k]), k


# biases that feed a batch-statistic BN: their gradient is 0 up to rounding
ZERO_GRAD = re.compile(r"(GateChain_0\.b[12]|_attn_\d+_folded\.Conv_\d\.bias)$")


@pytest.mark.parametrize("torch_var", [False, True])
def test_folded_train_step_matches_jax(trees, torch_var):
    """One train step of the folded model in f64 against JAX's folded step
    under ``jax.enable_x64``, with flax's running variance and under the
    torch-running-var switch (each task's statistics count its own rows, in
    the task's BN and the task-axis gate). JAX's gate chain takes its two
    products with f32 results even there (``preferred_element_type=
    jnp.float32``), so its step carries f32 rounding (about 2e-6 of a leaf
    here): loss within 1e-6, every gradient within 1e-5 of its leaf's
    largest magnitude (``ZERO_GRAD``: both under 1e-6 of the model's
    largest gradient), running statistics within 1e-5. Under the switch
    JAX's ``TorchVarBatchNorm`` computes in f32 as well, so the gradients are
    held as f32 steps are (1e-3 of each leaf's largest); the running
    variances, whose n/(n-1) tells a task's rows from both tasks', stay
    within 1e-5."""
    _, folded_vars = trees
    prev = jax_blocks.torch_bn_running_var(), blocks.torch_bn_running_var()
    jax_blocks.set_torch_bn_running_var(torch_var)
    blocks.set_torch_bn_running_var(torch_var)
    try:
        _folded_train_step_matches_jax(folded_vars, 1e-3 if torch_var else 1e-5)
    finally:
        jax_blocks.set_torch_bn_running_var(prev[0])
        blocks.set_torch_bn_running_var(prev[1])


def _folded_train_step_matches_jax(folded_vars, grad_tol):
    rng = np.random.default_rng(2)
    batch = {
        "img": rng.uniform(size=(2, *HW, 3)),
        "mask": rng.integers(0, NC, (2, *HW)).astype(np.int32),
        "depth": rng.uniform(0.1, 1.0, (2, *HW, 1)),
    }
    with jax.enable_x64(True):
        jmodel = _jax_model(True, jnp.float64)

        def loss_fn(params, batch_stats, b):
            losses, _, new_stats = jax_step._forward_and_losses(
                jmodel, params, batch_stats, b, True, 1.0, 1.0)
            return losses["loss"], new_stats

        f64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), folded_vars)
        (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            f64["params"], f64["batch_stats"], jax.tree.map(jnp.asarray, batch))
        loss, grads, new_stats = float(loss), jax.device_get(grads), jax.device_get(new_stats)
    model = _port(True, torch.float64)
    load_jax_variables(model, folded_vars)
    state = create_train_state(model, 1e-3, device="cpu")
    _, _, losses = make_train_step(device="cpu")(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, init_metrics(NC, "cpu"))
    assert float(losses["loss"]) == pytest.approx(loss, rel=1e-6)

    def as_port(tree, coll):
        other = "batch_stats" if coll == "params" else "params"
        twin = _port(True, torch.float64)
        load_jax_variables(twin, {coll: tree, other: folded_vars[other]})
        return dict(twin.named_parameters() if coll == "params" else twin.named_buffers())

    want = {k: v.detach() for k, v in as_port(grads, "params").items()}
    top = max(float(w.abs().max()) for w in want.values())
    for name, p in model.named_parameters():
        scale = float(want[name].abs().max())
        if ZERO_GRAD.search(name):
            assert max(scale, float(p.grad.abs().max())) <= 1e-6 * top, name
        else:
            assert float((p.grad - want[name]).abs().max()) <= grad_tol * scale, name
    stats = as_port(new_stats, "batch_stats")
    for name, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("n_tasks", [2, 3])
def test_task_axis_plain_versions_equal_per_task_calls(n_tasks):
    """B1's and B4's plain versions with the task axis: each task exactly
    its own one-task call; B4's backward over the task axis within 1e-12 of
    the per-task backwards (f64), shared's gradient their sum."""
    g = torch.Generator().manual_seed(n_tasks)
    b, h, w, cin, hidden, c2 = 2, 5, 7, 12, 8, 16

    def r(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    x, shared = r(n_tasks, b, h, w, cin), r(b, h, w, c2)
    w1, c1, w2, c2v = r(n_tasks, cin, hidden), r(n_tasks, hidden), r(n_tasks, hidden, c2), r(
        n_tasks, c2)
    out = fused_gate.fused_attention_gate_tasks(x, shared, w1, c1, w2, c2v)
    for t in range(n_tasks):
        assert torch.equal(out[t], fused_gate.fused_attention_gate(
            x[t], shared, w1[t], c1[t], w2[t], c2v[t]))
    train_args = [x, shared, w1, r(n_tasks, hidden), r(n_tasks, hidden).abs() + 0.5,
                  r(n_tasks, hidden), w2, r(n_tasks, c2), r(n_tasks, c2).abs() + 0.5,
                  r(n_tasks, c2)]
    leaves = [a.clone().requires_grad_() for a in train_args]
    got = fused_gate_train.fused_attention_gate_train_tasks(*leaves)
    cot = r(*got[0].shape)
    (got[0] * cot).sum().backward()
    shared_grad = torch.zeros_like(shared)
    for t in range(n_tasks):
        per = [leaves[1].detach().clone().requires_grad_()] + [
            a[t].detach().clone().requires_grad_() for i, a in enumerate(leaves) if i != 1]
        per = [per[1], per[0]] + per[2:]
        alone = fused_gate_train.fused_attention_gate_train(*per)
        for a, b_ in zip(got, alone):
            assert torch.equal(a[t], b_)
        (alone[0] * cot[t]).sum().backward()
        shared_grad += per[1].grad
        for i, leaf in enumerate(leaves):
            if i != 1:
                torch.testing.assert_close(leaf.grad[t], per[i].grad, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(leaves[1].grad, shared_grad, rtol=1e-12, atol=1e-12)


def test_fold_tasks_run_restores_and_resumes(tmp_path, monkeypatch):
    """``training --fold_tasks --remat_attention`` (full MTAN width, 16x16)
    writes a run whose ``model_0/`` restores through ``load_run_model`` into
    a folded model, the options read back from ``train_args.yaml``, and
    into no unfolded one; ``--resume_dir`` continues it from those weights;
    a reference checkpoint of an unfolded MTAN does not load into the
    folded model, as in the JAX package."""
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard", None)
    for k, v in dict(height=16, width=16, num_classes=NC, num_train=4, num_val=2).items():
        monkeypatch.setattr(synthetic.synthetic_data_cfg, k, v)
    monkeypatch.setattr(cfg, "log_root_dir", tmp_path)
    argv = ["--device", "cpu", "--dataset_name", "synthetic", "--model_name", "mtan",
            "--batch_size", "2", "--num_epochs", "1", "--fold_tasks", "--remat_attention"]
    run_dir = training.main(argv)
    model, _, run_args = load_run_model(run_dir, "cpu")
    assert run_args.fold_tasks and run_args.remat_attention
    assert model.fold_tasks and model.remat_attention and not model.training
    saved = checkpoint.load_ckpt_model(run_dir)
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    unfolded = build_model("mtan", synthetic.synthetic_data_cfg, device="cpu")
    with pytest.raises(RuntimeError, match="_folded"):
        unfolded.load_state_dict(saved)

    started = {}
    real_run_pipe = training.run_pipe

    def keep(args, state, *rest, **kw):
        started["weights"] = {k: v.clone() for k, v in state.model.state_dict().items()}
        started["epoch"] = kw.get("start_epoch")
        return real_run_pipe(args, state, *rest, **kw)

    monkeypatch.setattr(training, "run_pipe", keep)
    resumed = training.main(argv[:-3] + ["2", "--fold_tasks", "--remat_attention",
                                         "--resume_dir", run_dir])
    assert started["epoch"] == 1 and "model_1" in os.listdir(resumed)
    for k, v in saved.items():
        assert torch.equal(started["weights"][k], v), k

    ref = tmp_path / "reference"
    ref.mkdir()
    src = build_model("mtan", synthetic.synthetic_data_cfg, dtype=torch.float32, device="cpu")
    ckpt_import.save_reference_checkpoint(str(ref / "model_0.pt"), "mtan", src)
    checkpoint.log_args(vars(run_args), str(ref / "train_args.yaml"))
    with pytest.raises(ValueError, match="_folded"):
        load_run_model(str(ref), "cpu")


def test_folded_export_answers_as_the_model(tmp_path, monkeypatch):
    """A CPU export of a small folded MTAN keeps the task-axis gate as its
    operator, one per level (4 here), and the loaded program answers as
    ``Predictor`` does."""
    model = MTANMiniUnet(TASKS, task_subnets_hidden_channels=16, encoder_first_channel=8,
                         encoder_num_channels=2, fold_tasks=True, dtype=torch.float32, seed=4)
    hw = (16, 24)
    path = str(tmp_path / "folded.pt2")
    program = export_model(model, 2, *hw, path, device="cpu")
    ops = [str(n.target) for n in program.graph.nodes
           if n.op == "call_function" and str(n.target).startswith("vmtl.")]
    assert ops == ["vmtl.fused_attention_gate_tasks.default"] * 4
    imgs = np.random.default_rng(5).uniform(size=(2, *hw, 3)).astype(np.float32)
    want = Predictor(model, 2, *hw, device="cpu")(imgs)
    ran = []
    plain = fused_gate.fused_attention_gate_tasks_plain
    monkeypatch.setattr(fused_gate, "fused_attention_gate_tasks_plain",
                        lambda *a: ran.append(1) or plain(*a))
    got = load_exported(path)(imgs)
    assert len(ran) == 4
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
