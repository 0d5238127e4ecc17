"""The port's space-to-depth folding (``ops/fold.py``) and the basic model's
``fold_tail`` on the CPU: every function of ``ops/fold.py`` against
``vision_mtl_tpu.ops.fold`` on seeded numpy inputs (the layout functions
exactly, the convs and BNs in f32 within 1e-6 relative), the ``fold_tail``
model's eval forward against JAX's ``fold_tail`` model in f32, its
parameters against the unfolded model's, and one f64 train step of the
``fold_tail`` model against the port's unfolded step (loss, every gradient
and every running statistic within 1e-10 relative)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_basic import NC, WIDTH, _random_variables
from vision_mtl_tpu.data.synthetic import SyntheticConfig, SyntheticMTLDataset
from vision_mtl_tpu.models.basic import BasicMTLModel as JaxBasic
from vision_mtl_tpu.ops import fold as jax_fold
from vision_mtl_tpu_torch.cfg import fetch_data_cfg
from vision_mtl_tpu_torch.metrics import init_metrics
from vision_mtl_tpu_torch.models import blocks
from vision_mtl_tpu_torch.models.basic import BasicMTLModel
from vision_mtl_tpu_torch.models.registry import build_model
from vision_mtl_tpu_torch.ops import fold
from vision_mtl_tpu_torch.ops import small_conv as small_conv_op
from vision_mtl_tpu_torch.train.state import create_train_state
from vision_mtl_tpu_torch.train.step import make_train_step
from vision_mtl_tpu_torch.weights import jax_variables_from_model, load_jax_variables

HW = (64, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(fn_name, *arrays, **kw):
    """``fn_name`` of the port on torch tensors and of JAX on the same numpy
    arrays, as numpy."""
    got = getattr(fold, fn_name)(*(torch.from_numpy(a) for a in arrays), **kw)
    want = getattr(jax_fold, fn_name)(*(jnp.asarray(a) for a in arrays), **kw)
    if isinstance(got, tuple):
        return [g.numpy() for g in got], [np.asarray(w) for w in want]
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize(
    "fn_name,shapes",
    [
        ("space_to_depth", [(2, 6, 8, 3)]),
        ("depth_to_space", [(2, 3, 4, 20)]),
        ("tile_for_upsample", [(2, 3, 5, 7)]),
        ("phase_max", [(2, 3, 4, 12)]),
        ("fold_vector", [(7,)]),
        ("fold_conv_transpose_2x2_kernel", [(2, 2, 5, 3)]),
    ],
)
def test_layout_functions_match_jax_exactly(fn_name, shapes):
    rng = np.random.default_rng(0)
    got, want = _both(fn_name, *(_rand(rng, *s) for s in shapes))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_space_to_depth_round_trip_and_upsample_tile():
    x = torch.from_numpy(_rand(np.random.default_rng(1), 2, 6, 8, 5))
    assert torch.equal(fold.depth_to_space(fold.space_to_depth(x)), x)
    up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    assert torch.equal(fold.space_to_depth(up), fold.tile_for_upsample(x))


@pytest.mark.parametrize(
    "k,in_ch,out_ch,splits", [(1, 3, 2, (3,)), (3, 4, 5, (4,)), (3, 5, 3, (2, 3)), (5, 2, 2, (2,))]
)
def test_fold_gather_index_and_fold_kernel_match_jax(k, in_ch, out_ch, splits):
    src, mask = fold._fold_gather_index(k, in_ch, out_ch, splits)
    want_src, want_mask = jax_fold._fold_gather_index(k, in_ch, out_ch, splits)
    np.testing.assert_array_equal(src, want_src)
    np.testing.assert_array_equal(mask, want_mask)
    kernel = _rand(np.random.default_rng(k), k, k, in_ch, out_ch)
    got, want = _both("fold_kernel", kernel, in_splits=splits)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,splits,bias", [(3, None, True), (3, (2, 3), False), (1, None, True),
                                           (5, None, False)])
def test_folded_conv_matches_jax_and_the_unfolded_conv(k, splits, bias):
    rng = np.random.default_rng(7)
    c, o = 5, 4
    x = _rand(rng, 2, 4, 6, 4 * c)
    kernel = _rand(rng, k, k, c, o)
    b = _rand(rng, o) if bias else None
    arrays = (x, kernel) + ((b,) if bias else ())
    got = fold.folded_conv(*(torch.from_numpy(a) for a in arrays), in_splits=splits,
                           dtype=torch.float32).numpy()
    want = np.asarray(jax_fold.folded_conv(*(jnp.asarray(a) for a in arrays), in_splits=splits,
                                           dtype=jnp.float32))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    if splits is None:  # fold(conv(x)) == folded_conv(fold(x))
        xu = fold.depth_to_space(torch.from_numpy(x))
        w = torch.from_numpy(kernel).permute(3, 2, 0, 1)
        ref = blocks.conv_nhwc(xu, w, None if b is None else torch.from_numpy(b), torch.float32)
        np.testing.assert_allclose(fold.space_to_depth(ref).numpy(), got, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_folded_batch_norm_and_stats_match_jax():
    rng = np.random.default_rng(3)
    y = _rand(rng, 2, 3, 5, 4 * 6) * 2 + 1
    mean, var = _rand(rng, 6), np.abs(_rand(rng, 6)) + 0.5
    scale, bias = _rand(rng, 6), _rand(rng, 6)
    got, want = _both("folded_batch_norm", y, mean, var, scale, bias)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    got, want = _both("folded_batch_stats", y)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def _batch(dtype=np.float32):
    ds = SyntheticMTLDataset(
        stage="train", cfg=SyntheticConfig(height=HW[0], width=HW[1], num_classes=NC, num_train=2)
    )
    samples = [ds[k] for k in range(2)]
    return {
        "img": np.stack([s["img"] for s in samples]).astype(dtype),
        "mask": np.stack([s["mask"] for s in samples]).astype(np.int32),
        "depth": np.stack([s["depth"] for s in samples]).astype(dtype),
    }


@pytest.fixture(scope="module")
def variables():
    """Seeded values for the basic tree at WIDTH, which fold_tail leaves as
    it is (JAX's eval_shape of the fold_tail model)."""
    jmodel = JaxBasic(segm_classes=NC, decoder_first_channel=WIDTH, num_decoder_layers=5,
                      fold_tail=True, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, *HW, 3)), train=False)
    )
    return _random_variables(shapes, np.random.default_rng(5))


def _port(variables, fold_tail, dtype=torch.float32):
    model = BasicMTLModel(NC, decoder_first_channel=WIDTH, num_decoder_layers=5,
                          fold_tail=fold_tail, dtype=dtype)
    if dtype == torch.float64:
        model.double()
    load_jax_variables(model, variables)
    return model


def test_fold_tail_keeps_the_parameters_and_skips_b3_in_the_tail(variables):
    """fold_tail changes no parameter name or shape; the folded block's and
    the heads' convs are plain convolutions, block 3's stay on B3."""
    plain, folded = _port(variables, False), _port(variables, True)
    assert {k: v.shape for k, v in plain.state_dict().items()} == {
        k: v.shape for k, v in folded.state_dict().items()}
    tree = jax_variables_from_model(folded)
    assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, variables)
    routed = [n for n, m in folded.named_modules() if isinstance(m, blocks.Conv) and m.small_conv]
    assert routed and not [n for n in routed if "block_4" in n or "head" in n]
    trained = build_model("basic", fetch_data_cfg("cityscapes"), device="cpu", fold_tail=True)
    routed = [n for n, m in trained.named_modules() if isinstance(m, blocks.Conv) and m.small_conv]
    assert routed == ["backbone.decoder.block_3.ConvBNAct_1.Conv_0"]
    assert folded.fold_tail and not folded.merge_heads
    assert isinstance(folded.segm_head.Conv_0, blocks.FoldedConv)
    # with 4 decoder layers the last block takes a skip: nothing folds
    short = BasicMTLModel(NC, decoder_first_channel=WIDTH, num_decoder_layers=4, fold_tail=True)
    assert not short.fold_tail and short.merge_heads


def test_fold_tail_eval_forward_matches_jax(variables, monkeypatch):
    batch = _batch()
    jmodel = JaxBasic(segm_classes=NC, decoder_first_channel=WIDTH, num_decoder_layers=5,
                      fold_tail=True, dtype=jnp.float32)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(batch["img"]))
    calls = []
    real = small_conv_op.conv3x3_small
    monkeypatch.setattr(small_conv_op, "conv3x3_small",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    model = _port(variables, True)
    with torch.no_grad():
        got = model(torch.from_numpy(batch["img"]))
    routed = [m for m in model.modules() if isinstance(m, blocks.Conv) and m.small_conv]
    assert len(calls) == len(routed)  # none in the folded tail
    for k in ("segm", "depth"):
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=2e-4,
                                   atol=2e-4 * float(np.abs(w).max()), err_msg=k)


def test_fold_tail_train_step_matches_the_unfolded_step(variables):
    """One f64 train step with fold_tail against the port's unfolded step:
    loss, every gradient (within 1e-10 of its leaf's largest magnitude, or
    of 1e-6 of the model's largest gradient where a gradient is 0 up to
    rounding) and every running statistic within 1e-10 relative; the
    folded BNs counted all four phases' rows."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(np.float64).items()}
    results = []
    for fold_tail in (False, True):
        model = _port(variables, fold_tail, torch.float64)
        state = create_train_state(model, 1e-3, device="cpu")
        _, _, losses = make_train_step(device="cpu")(state, batch, init_metrics(NC, "cpu"))
        results.append((
            float(losses["loss"]),
            {k: p.grad.clone() for k, p in model.named_parameters()},
            {k: b.clone() for k, b in model.named_buffers()},
        ))
    (loss, grads, bufs), (f_loss, f_grads, f_bufs) = results
    assert f_loss == pytest.approx(loss, rel=1e-10)
    top = max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        scale = max(float(g.abs().max()), 1e-6 * top)
        assert float((f_grads[k] - g).abs().max()) <= 1e-10 * scale, k
    for k, b in bufs.items():
        np.testing.assert_allclose(f_bufs[k].numpy(), b.numpy(), rtol=1e-10, atol=1e-12,
                                   err_msg=k)
    tail = "backbone.decoder.block_4.ConvBNAct_0.BatchNorm_0.running_var"
    assert not torch.equal(f_bufs[tail], torch.ones_like(f_bufs[tail]))
