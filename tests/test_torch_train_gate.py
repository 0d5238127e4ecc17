"""Port's train-mode attention gate (plain version, autograd Function,
GateChain in train mode) against the JAX package's three-pass Pallas kernel
in interpret mode and its GateChain train path."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vision_mtl_tpu.models import blocks as jax_blocks
from vision_mtl_tpu.models.mtan import GateChain as JaxGateChain
from vision_mtl_tpu.ops.pallas.fused_gate import fused_attention_gate_train as jax_gate_train
from vision_mtl_tpu_torch.kernels import fused_gate_train
from vision_mtl_tpu_torch.models import blocks
from vision_mtl_tpu_torch.models.mtan import GateChain
from vision_mtl_tpu_torch.weights import load_jax_variables

PARAMS = ("w1", "b1", "scale1", "bias1", "w2", "b2", "scale2", "bias2")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(rng, b, h, w, cin, hid, c2):
    """x, shared and the eight parameters in the order of PARAMS."""
    return (
        rng.normal(size=(b, h, w, cin)).astype(np.float32),
        rng.normal(size=(b, h, w, c2)).astype(np.float32),
        rng.normal(scale=0.3, size=(cin, hid)).astype(np.float32),
        rng.normal(size=(hid,)).astype(np.float32),
        rng.uniform(0.5, 1.5, hid).astype(np.float32),
        rng.normal(size=(hid,)).astype(np.float32),
        rng.normal(scale=0.3, size=(hid, c2)).astype(np.float32),
        rng.normal(size=(c2,)).astype(np.float32),
        rng.uniform(0.5, 1.5, c2).astype(np.float32),
        rng.normal(size=(c2,)).astype(np.float32),
    )


# Cin = 3 is the first encoder level; N = 35 and 234 are ragged against the
# Pallas kernel's 1024-row tiles
@pytest.mark.parametrize(
    "shape", [(1, 5, 7, 3, 8, 4), (2, 9, 13, 20, 16, 12), (2, 8, 16, 3, 32, 16)]
)
def test_plain_train_gate_matches_pallas_interpret(rng, shape):
    arrays = _inputs(rng, *shape)
    want = jax_gate_train(*map(jnp.asarray, arrays), interpret=True)
    got = fused_gate_train.fused_attention_gate_train_plain(*map(torch.from_numpy, arrays))
    assert got[0].shape == want[0].shape and got[0].dtype == torch.float32
    # the tolerances of tests/test_fused_gate.py::test_train_kernel_matches_jnp
    for name, g, w, atol in zip(
        ("out", "mean1", "var1", "mean2", "var2"), got, want, (1e-4, 1e-5, 1e-4, 1e-4, 1e-3)
    ):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, err_msg=name)


def _jax_gatechain(arrays):
    x, shared = arrays[:2]
    hid, c2 = arrays[2].shape[1], arrays[1].shape[-1]
    jgc = JaxGateChain(hidden=hid, gate_features=c2, dtype=jnp.float32)
    variables = jax.device_get(jgc.init(jax.random.key(0), x, shared, True))
    params = dict(zip(PARAMS, arrays[2:]))
    stats = {k: np.asarray(v) for k, v in variables["batch_stats"].items()}
    return jgc, {"params": params, "batch_stats": stats}


def test_gate_gradients_match_jax_grad(rng):
    """Gradients of <out, g> for x, shared and all eight parameters: the
    Function's backward against jax.grad of the JAX GateChain train path."""
    arrays = _inputs(rng, 2, 5, 7, 6, 8, 12)
    cot = rng.normal(size=arrays[1].shape).astype(np.float32)
    jgc, variables = _jax_gatechain(arrays)

    def loss(params, x, shared):
        out, _ = jgc.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            x, shared, True, mutable=["batch_stats"],
        )
        return jnp.sum(out * cot)

    gp, gx, gs = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        variables["params"], jnp.asarray(arrays[0]), jnp.asarray(arrays[1])
    )
    want = {"x": gx, "shared": gs, **gp}

    tensors = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fused_gate_train.fused_attention_gate_train(*tensors)[0]
    (out * torch.from_numpy(cot)).sum().backward()
    for name, tensor in zip(("x", "shared") + PARAMS, tensors):
        got, ref = tensor.grad.numpy(), np.asarray(want[name])
        if name in ("b1", "b2"):
            # a batch-statistic BN removes the bias: both gradients are 0 up
            # to rounding
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6, err_msg=name)


def test_gate_gradcheck_f64(rng):
    arrays = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
              for a in _inputs(rng, 2, 3, 2, 3, 8, 4)]
    assert torch.autograd.gradcheck(
        lambda *a: fused_gate_train.fused_attention_gate_train(*a)[0], arrays
    )


@pytest.mark.parametrize("torch_var", [False, True])
def test_gatechain_train_matches_flax(rng, torch_var):
    """Two train-mode steps: output and the running statistics against the
    JAX GateChain's, with flax's biased running variance and under the
    torch-running-var switch (unbiased n/(n-1))."""
    arrays = _inputs(rng, 2, 5, 7, 3, 8, 4)
    jgc, variables = _jax_gatechain(arrays)
    gc = GateChain(3, 8, 4).train()
    load_jax_variables(gc, variables)
    xs = [(arrays[0], arrays[1]), _inputs(rng, 2, 5, 7, 3, 8, 4)[:2]]
    prev_jax, prev_port = jax_blocks.torch_bn_running_var(), blocks.torch_bn_running_var()
    jax_blocks.set_torch_bn_running_var(torch_var)
    blocks.set_torch_bn_running_var(torch_var)
    try:
        for x, shared in xs:
            want, mutated = jgc.apply(variables, x, shared, True, mutable=["batch_stats"])
            variables = {"params": variables["params"], **mutated}
            with torch.no_grad():
                got = gc(torch.from_numpy(x), torch.from_numpy(shared))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    finally:
        jax_blocks.set_torch_bn_running_var(prev_jax)
        blocks.set_torch_bn_running_var(prev_port)
    for name, want in variables["batch_stats"].items():
        np.testing.assert_allclose(
            getattr(gc, name).numpy(), np.asarray(want), rtol=1e-5, atol=1e-6, err_msg=name
        )
