"""Port's attention gate (plain version + fold_bn + GateChain) against the
JAX package's Pallas kernel in interpret mode and its GateChain eval path."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vision_mtl_tpu.models.mtan import GateChain as JaxGateChain
from vision_mtl_tpu.ops.pallas.fused_gate import fold_bn as jax_fold_bn
from vision_mtl_tpu.ops.pallas.fused_gate import fused_attention_gate as jax_gate
from vision_mtl_tpu_torch.kernels import fused_gate
from vision_mtl_tpu_torch.models.mtan import GateChain
from vision_mtl_tpu_torch.weights import load_jax_variables


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gate_inputs(rng, b, h, w, cin, hid, c2):
    return (
        rng.normal(size=(b, h, w, cin)).astype(np.float32),
        rng.normal(size=(b, h, w, c2)).astype(np.float32),
        rng.normal(scale=0.3, size=(cin, hid)).astype(np.float32),
        rng.normal(size=(hid,)).astype(np.float32),
        rng.normal(scale=0.3, size=(hid, c2)).astype(np.float32),
        rng.normal(size=(c2,)).astype(np.float32),
    )


# Cin = 3 is the first encoder level; N = 1*5*7 = 35 and 2*9*13 = 234 are
# ragged against the Pallas kernel's 1024-row tiles
@pytest.mark.parametrize(
    "shape", [(1, 5, 7, 3, 8, 4), (2, 9, 13, 20, 16, 12), (2, 8, 16, 3, 32, 16)]
)
def test_plain_gate_matches_pallas_interpret(rng, shape):
    arrays = _gate_inputs(rng, *shape)
    want = jax_gate(*map(jnp.asarray, arrays), interpret=True)
    got = fused_gate.fused_attention_gate(*map(torch.from_numpy, arrays))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_plain_gate_keeps_shared_dtype(rng):
    arrays = [torch.from_numpy(a) for a in _gate_inputs(rng, 1, 4, 4, 3, 8, 4)]
    arrays[0] = arrays[0].bfloat16()
    arrays[1] = arrays[1].bfloat16()
    out = fused_gate.fused_attention_gate(*arrays)
    assert out.dtype == torch.bfloat16
    ref = fused_gate.fused_attention_gate_plain(
        arrays[0].float(), arrays[1].float(), *arrays[2:]
    )
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=8e-3, atol=1e-6)


def test_fold_bn_matches_jax(rng):
    bias, g, b, m = (rng.normal(size=(8,)).astype(np.float32) for _ in range(4))
    v = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    want = jax_fold_bn(*map(jnp.asarray, (bias, g, b, m, v)))
    got = fused_gate.fold_bn(*map(torch.from_numpy, (bias, g, b, m, v)))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, atol=1e-6)


def test_gatechain_eval_matches_jax(rng):
    """Folded-BN port GateChain against the JAX GateChain's unfused f32 eval
    path, with random BN statistics."""
    cin, hid, c2 = 3, 8, 4
    x = rng.normal(size=(1, 5, 7, cin)).astype(np.float32)
    shared = rng.normal(size=(1, 5, 7, c2)).astype(np.float32)
    jgc = JaxGateChain(hidden=hid, gate_features=c2, dtype=jnp.float32)
    variables = jax.device_get(jgc.init(jax.random.key(0), x, shared, False))
    variables = {
        "params": {
            **variables["params"],
            "scale1": rng.uniform(0.5, 1.5, hid).astype(np.float32),
            "bias2": rng.uniform(-0.3, 0.3, c2).astype(np.float32),
        },
        "batch_stats": {
            "mean1": rng.uniform(-0.3, 0.3, hid).astype(np.float32),
            "var1": rng.uniform(0.5, 1.5, hid).astype(np.float32),
            "mean2": rng.uniform(-0.3, 0.3, c2).astype(np.float32),
            "var2": rng.uniform(0.5, 1.5, c2).astype(np.float32),
        },
    }
    want = jgc.apply(variables, x, shared, False)
    gc = GateChain(cin, hid, c2).eval()
    load_jax_variables(gc, variables)
    with torch.no_grad():
        got = gc(torch.from_numpy(x), torch.from_numpy(shared))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_kernel_wrapper_never_falls_back():
    """A tensor that is not on the CPU never reaches the plain version: the
    wrapper checks it for the kernel and raises."""
    x = torch.empty(1, 2, 2, 3, device="meta")
    shared = torch.empty(1, 2, 2, 4, device="meta")
    w1, c1 = torch.empty(3, 8, device="meta"), torch.empty(8, device="meta")
    w2, c2 = torch.empty(8, 4, device="meta"), torch.empty(4, device="meta")
    before = fused_gate.launches.value
    with pytest.raises(ValueError, match="CUDA"):
        fused_gate.fused_attention_gate(x, shared, w1, c1, w2, c2)
    assert fused_gate.launches.value == before
