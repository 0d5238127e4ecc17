"""The port's confusion matrix (plain version), losses and streaming metrics
against the JAX package on the same numpy inputs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vision_mtl_tpu import losses as jax_losses
from vision_mtl_tpu import metrics as jax_metrics
from vision_mtl_tpu.ops.pallas.confmat import confusion_matrix as jax_confmat
from vision_mtl_tpu_torch import losses, metrics
from vision_mtl_tpu_torch.kernels import confmat


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# N = 5000 and 4097 are ragged against the Pallas kernel's 4096-sample tiles
@pytest.mark.parametrize("n,c,masked", [(5000, 19, True), (4097, 7, False), (37, 3, True)])
def test_plain_confmat_matches_pallas_interpret(rng, n, c, masked):
    t = rng.integers(-2, c + 2, size=n).astype(np.int32)  # out-of-range ids too
    p = rng.integers(-1, c + 1, size=n).astype(np.int32)
    mask = rng.uniform(size=n) < 0.7 if masked else None
    want = jax_confmat(
        jnp.asarray(t), jnp.asarray(p), c,
        None if mask is None else jnp.asarray(mask.astype(np.float32)),
        interpret=True,
    )
    got = confmat.confusion_matrix(
        torch.from_numpy(t), torch.from_numpy(p), c,
        None if mask is None else torch.from_numpy(mask),
    )
    assert got.dtype == torch.float32 and got.shape == (c, c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_confmat_wrapper_never_falls_back():
    t = torch.empty(8, dtype=torch.int32, device="meta")
    before = confmat.launches.value
    with pytest.raises(ValueError, match="CUDA"):
        confmat.confusion_matrix(t, t, 4)
    assert confmat.launches.value == before


def _batch(rng, b=3, h=6, w=10, c=5):
    return dict(
        logits=rng.normal(size=(b, h, w, c)).astype(np.float32),
        depth_pred=rng.uniform(0.01, 1.0, size=(b, h, w, 1)).astype(np.float32),
        mask=rng.integers(0, c, size=(b, h, w)).astype(np.int32),
        # some targets under min_depth, so the SILog mask bites
        depth=rng.uniform(-0.1, 1.0, size=(b, h, w, 1)).astype(np.float32),
    )


@pytest.mark.parametrize("valid", [None, [1.0, 0.0, 1.0]])
def test_mtl_loss_matches_jax(rng, valid):
    d = _batch(rng)
    v = None if valid is None else np.asarray(valid, np.float32)
    want = jax_losses.mtl_loss(
        jnp.asarray(d["logits"]), jnp.asarray(d["depth_pred"]),
        jnp.asarray(d["mask"]), jnp.asarray(d["depth"]), 0.7, 1.3,
        valid=None if v is None else jnp.asarray(v),
    )
    got = losses.mtl_loss(
        torch.from_numpy(d["logits"]), torch.from_numpy(d["depth_pred"]),
        torch.from_numpy(d["mask"]), torch.from_numpy(d["depth"]), 0.7, 1.3,
        valid=None if v is None else torch.from_numpy(v),
    )
    for k in ("loss", "loss_segm", "loss_depth"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def _update_both(rng, jstate, tstate, valid):
    d = _batch(rng)
    preds = np.argmax(d["logits"], -1).astype(np.int32)
    jl = {"loss": 1.5, "loss_segm": 1.0, "loss_depth": 0.5}
    v = None if valid is None else np.asarray(valid, np.float32)
    jstate = jax_metrics.update_metrics(
        jstate, jnp.asarray(preds), jnp.asarray(d["mask"]),
        jnp.asarray(d["depth_pred"]), jnp.asarray(d["depth"]),
        {k: jnp.float32(x) for k, x in jl.items()},
        valid=None if v is None else jnp.asarray(v),
    )
    tstate = metrics.update_metrics(
        tstate, torch.from_numpy(preds), torch.from_numpy(d["mask"]),
        torch.from_numpy(d["depth_pred"]), torch.from_numpy(d["depth"]),
        {k: torch.tensor(x) for k, x in jl.items()},
        valid=None if v is None else torch.from_numpy(v),
    )
    return jstate, tstate


def _assert_metrics_equal(jstate, tstate):
    np.testing.assert_array_equal(tstate.confmat.numpy(), np.asarray(jstate.confmat))
    want = jax_metrics.compute_metrics(jstate)
    got = metrics.compute_metrics(tstate)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


def test_metrics_stream_matches_jax(rng):
    c = 5
    jstate = jax_metrics.init_metrics(c)
    tstate = metrics.init_metrics(c, device="cpu")
    for valid in (None, [1.0, 1.0, 0.0], [0.0, 1.0, 1.0]):
        jstate, tstate = _update_both(rng, jstate, tstate, valid)
    _assert_metrics_equal(jstate, tstate)


def test_merge_metrics_matches_jax(rng):
    c = 5
    ja, ta = _update_both(rng, jax_metrics.init_metrics(c), metrics.init_metrics(c, "cpu"), None)
    jb, tb = _update_both(
        rng, jax_metrics.init_metrics(c), metrics.init_metrics(c, "cpu"), [1.0, 0.0, 1.0]
    )
    _assert_metrics_equal(jax_metrics.merge_metrics(ja, jb), metrics.merge_metrics(ta, tb))


def test_absent_classes_score_zero_and_count():
    """Class 2 never occurs: its IoU is 0 and it still counts in the mean."""
    state = metrics.init_metrics(3, "cpu")
    t = torch.tensor([[[0, 1], [0, 1]]], dtype=torch.int32)
    d = torch.zeros(1, 2, 2, 1)
    state = metrics.update_metrics(state, t, t, d, d)
    out = metrics.compute_metrics(state)
    assert float(out["accuracy"]) == 1.0
    assert float(out["jaccard_index"]) == pytest.approx(2.0 / 3.0)
