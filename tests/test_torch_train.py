"""The port's training path against the JAX package at a tiny size, in f32:
train-mode BatchNorm, one ``make_train_step`` (loss, every gradient, running
statistics), a 24-step trajectory, gradient accumulation and
``make_eval_step``."""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vision_mtl_tpu.data.synthetic import SyntheticConfig, SyntheticMTLDataset
from vision_mtl_tpu.metrics import compute_metrics as jax_compute_metrics
from vision_mtl_tpu.metrics import init_metrics as jax_init_metrics
from vision_mtl_tpu.models import blocks as jax_blocks
from vision_mtl_tpu.models.mtan import MTANMiniUnet as JaxMTAN
from vision_mtl_tpu.train import step as jax_step
from vision_mtl_tpu.train.state import create_train_state as jax_create_train_state
from vision_mtl_tpu_torch.metrics import compute_metrics, init_metrics
from vision_mtl_tpu_torch.models import blocks
from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet
from vision_mtl_tpu_torch.train.state import create_train_state, get_lr, param_count, set_lr
from vision_mtl_tpu_torch.train.step import make_eval_step, make_train_step
from vision_mtl_tpu_torch.weights import load_jax_variables

# the setup of tests/test_mtan_trajectory.py
NC = 5
LR = 2e-3
N_LEVELS = 2
HIDDEN = 8
STEPS = 24
TASKS = {"depth": 1, "segm": NC}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_model(variables):
    model = MTANMiniUnet(
        TASKS, task_subnets_hidden_channels=HIDDEN, encoder_first_channel=8,
        encoder_num_channels=N_LEVELS, dtype=torch.float32,
    )
    load_jax_variables(model, variables)
    return model


@pytest.fixture(scope="module")
def setup():
    """The JAX model, its initial variables, three batches of two synthetic
    samples, and the jitted value-and-gradient of its train-mode loss."""
    ds = SyntheticMTLDataset(
        stage="train", cfg=SyntheticConfig(height=16, width=24, num_classes=NC, num_train=6)
    )
    batches = []
    for bi in range(3):
        samples = [ds[bi * 2 + k] for k in range(2)]
        batches.append({
            "img": np.stack([s["img"] for s in samples]).astype(np.float32),
            "mask": np.stack([s["mask"] for s in samples]).astype(np.int32),
            "depth": np.stack([s["depth"] for s in samples]).astype(np.float32),
        })
    jmodel = JaxMTAN(
        map_tasks_to_num_channels=TASKS, task_subnets_hidden_channels=HIDDEN,
        encoder_first_channel=8, encoder_num_channels=N_LEVELS, dtype=jnp.float32,
    )
    state = jax_create_train_state(jmodel, jax.random.key(0), jnp.asarray(batches[0]["img"]), LR)
    variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})

    def loss_fn(params, batch_stats, batch):
        losses, _, new_stats = jax_step._forward_and_losses(
            jmodel, params, batch_stats, batch, True, 1.0, 1.0
        )
        return losses["loss"], new_stats

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return jmodel, state, variables, batches, grad_fn


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# biases that feed a batch-statistic BN: their gradient is 0 up to rounding
ZERO_GRAD = re.compile(r"(GateChain_0\.b[12]|_attn_\d+_task\d+\.Conv_\d\.bias)$")


def _assert_grads_match(model, jax_grads, batch_stats):
    """Every port gradient against JAX's, bridged into a twin module: within
    1e-3 of the leaf's largest magnitude. Where the gradient is 0 up to
    rounding (``ZERO_GRAD``; at this size under 1e-6 of the model's largest
    gradient, while every other leaf is above 2e-5 of it) both sides must
    stay under 1e-5 of the model's largest gradient."""
    twin = _port_model({"params": jax_grads, "batch_stats": batch_stats})
    want = {name: p.detach() for name, p in twin.named_parameters()}
    top = max(float(w.abs().max()) for w in want.values())
    for name, p in model.named_parameters():
        scale = float(want[name].abs().max())
        if ZERO_GRAD.search(name):
            assert max(scale, float(p.grad.abs().max())) <= 1e-5 * top, (name, scale, top)
        else:
            err = float((p.grad - want[name]).abs().max())
            assert err <= 1e-3 * scale, (name, err, scale)


def _assert_stats_match(model, params, batch_stats):
    """The port's running statistics against JAX's batch_stats."""
    want = dict(_port_model({"params": params, "batch_stats": batch_stats}).named_buffers())
    for name, b in model.named_buffers():
        np.testing.assert_allclose(
            b.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-5, err_msg=name
        )


@pytest.mark.parametrize("torch_var", [False, True])
def test_batchnorm_train_matches_flax(rng, torch_var):
    """Output and running statistics over two train-mode steps, with flax's
    biased running variance and under the torch-running-var switch."""
    x0 = rng.normal(loc=1.5, scale=2.0, size=(2, 5, 7, 6)).astype(np.float32)
    jbn = jax_blocks.BatchNorm(use_running_average=False)
    variables = jax.device_get(jbn.init(jax.random.key(0), x0))
    variables["params"]["BatchNorm_0"] = {
        "scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
        "bias": rng.uniform(-0.3, 0.3, 6).astype(np.float32),
    }
    bn = blocks.BatchNorm(6).train()
    load_jax_variables(bn, variables)
    prev_jax, prev_port = jax_blocks.torch_bn_running_var(), blocks.torch_bn_running_var()
    jax_blocks.set_torch_bn_running_var(torch_var)
    blocks.set_torch_bn_running_var(torch_var)
    try:
        for x in (x0, rng.normal(size=(2, 5, 7, 6)).astype(np.float32)):
            want, mutated = jbn.apply(variables, x, mutable=["batch_stats"])
            variables = {"params": variables["params"], **mutated}
            got = bn(torch.from_numpy(x))
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    finally:
        jax_blocks.set_torch_bn_running_var(prev_jax)
        blocks.set_torch_bn_running_var(prev_port)
    stats = variables["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], rtol=1e-5, atol=1e-6)


def test_one_train_step_matches_jax(setup):
    jmodel, _, variables, batches, grad_fn = setup
    (loss, new_stats), grads = grad_fn(
        variables["params"], variables["batch_stats"], jax.tree.map(jnp.asarray, batches[0])
    )
    model = _port_model(variables)
    state = create_train_state(model, LR, device="cpu")
    assert param_count(state) == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(grads))
    step = make_train_step(device="cpu")
    state, mstate, losses = step(state, _torch_batch(batches[0]), init_metrics(NC, "cpu"))
    assert state.step == 1 and model.training
    assert float(losses["loss"]) == pytest.approx(float(loss), rel=1e-5)
    _assert_grads_match(model, jax.device_get(grads), variables["batch_stats"])
    _assert_stats_match(model, variables["params"], jax.device_get(new_stats))
    assert float(mstate.num_steps) == 1.0
    assert float(mstate.loss_sum) == pytest.approx(float(loss), rel=1e-5)
    assert get_lr(set_lr(state, 1e-4)) == pytest.approx(1e-4)


def test_train_trajectory_matches_jax(setup):
    """24 steps over the cycled 3-batch stream, the tolerance schedule of
    tests/test_mtan_trajectory.py: both sides in f32 from the same init."""
    jmodel, jstate, variables, batches, _ = setup
    jstep = jax_step.make_train_step(jmodel, donate=False)
    model = _port_model(variables)
    state = create_train_state(model, LR, device="cpu")
    step = make_train_step(device="cpu")
    jbatches = [jax.tree.map(jnp.asarray, b) for b in batches]
    tbatches = [_torch_batch(b) for b in batches]
    for i in range(STEPS):
        jstate, jm, jl = jstep(jstate, jbatches[i % 3], jax_init_metrics(NC))
        state, m, tl = step(state, tbatches[i % 3], init_metrics(NC, "cpu"))
        jmet, met = jax_compute_metrics(jm), compute_metrics(m)
        rel = 5e-3 if i < 8 else (2e-2 if i < 16 else 6e-2)
        assert float(tl["loss"]) == pytest.approx(float(jl["loss"]), rel=rel), i
        assert float(met["mae"]) == pytest.approx(
            float(jmet["mae"]), rel=max(rel * 4, 2e-2), abs=5e-3
        ), i
        assert float(met["accuracy"]) == pytest.approx(float(jmet["accuracy"]), abs=0.08), i
        if i == 0:
            first = float(tl["loss"])
    assert float(tl["loss"]) < first * 0.95  # both sides learn


def test_grad_accumulation_matches_jax(setup):
    """Two microbatches of two: averaged losses and gradients, chained
    running statistics (ghost BN) and a metric state that counts one step.
    The JAX step returns no gradients, so its scan is replayed with the same
    jitted gradient per microbatch."""
    jmodel, jstate, variables, batches, grad_fn = setup
    big = {k: np.concatenate([batches[0][k], batches[1][k]]) for k in batches[0]}
    jstep = jax_step.make_train_step(jmodel, donate=False, grad_accum_steps=2)
    jstate1, jm, jl = jstep(jstate, jax.tree.map(jnp.asarray, big), jax_init_metrics(NC))
    stats, grads = variables["batch_stats"], None
    for b in batches[:2]:
        (_, stats), g = grad_fn(variables["params"], stats, jax.tree.map(jnp.asarray, b))
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    grads = jax.device_get(jax.tree.map(lambda g: g * 0.5, grads))

    model = _port_model(variables)
    state = create_train_state(model, LR, device="cpu")
    step = make_train_step(grad_accum_steps=2, device="cpu")
    state, m, losses = step(state, _torch_batch(big), init_metrics(NC, "cpu"))
    for k in ("loss", "loss_segm", "loss_depth"):
        assert float(losses[k]) == pytest.approx(float(jl[k]), rel=1e-5), k
    _assert_grads_match(model, grads, variables["batch_stats"])
    _assert_stats_match(model, variables["params"], jax.device_get(jstate1.batch_stats))
    assert float(m.num_steps) == float(jm.num_steps) == 1.0
    for k in ("loss_sum", "loss_segm_sum", "loss_depth_sum", "mae_sum", "mae_count"):
        assert float(getattr(m, k)) == pytest.approx(float(getattr(jm, k)), rel=1e-5), k
    np.testing.assert_array_equal(m.confmat.numpy(), np.asarray(jm.confmat))
    with pytest.raises(ValueError, match="multiple"):
        step(state, _torch_batch(batches[2]) | {"img": torch.zeros(3, 16, 24, 3)},
             init_metrics(NC, "cpu"))


def test_eval_step_matches_jax(setup, rng):
    """Eval-mode forward with random running statistics: losses and the
    metric state; the model's mode is left as it was."""
    jmodel, jstate, variables, batches, _ = setup
    stats = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"]
    )
    jm, jl = jax_step.make_eval_step(jmodel)(
        jstate.replace(batch_stats=stats), jax.tree.map(jnp.asarray, batches[1]),
        jax_init_metrics(NC),
    )
    model = _port_model({"params": variables["params"], "batch_stats": stats})
    state = create_train_state(model, LR, device="cpu")
    m, losses = make_eval_step(device="cpu")(
        state, _torch_batch(batches[1]), init_metrics(NC, "cpu")
    )
    assert model.training
    for k in ("loss", "loss_segm", "loss_depth"):
        assert float(losses[k]) == pytest.approx(float(jl[k]), rel=1e-5), k
    np.testing.assert_array_equal(m.confmat.numpy(), np.asarray(jm.confmat))
    assert float(m.mae_sum) == pytest.approx(float(jm.mae_sum), rel=1e-5)
