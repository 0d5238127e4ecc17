"""The mesh's ``spatial`` axis in the port: image rows split over ranks,
with a halo exchange around every conv and resize (``parallel/halo.py``).

The ranks are threads of one process (``ThreadGroup`` / ``ThreadComm``),
one torch thread, f32, tiny shapes. Held here:

  * each rank's (batch rows, H rows) against JAX's device index map for the
    same mesh spec (no compile);
  * ``conv_nhwc`` under ``spatial:2`` and ``spatial:4`` against the
    unsharded conv: k 1, 3, 5, stride 1 and 2, dense and depthwise, a halo
    deeper than a rank's rows, and the B3 route through its plain version;
    forward, dx and dw within ``CONV_ATOL``;
  * the bilinear resize, the squeeze-excite mean, CSNet's centred pad,
    the folded conv and ``halo_rows``' own backward, forward and gradient;
  * MTAN's predict-eval step under ``data:2,spatial:2`` against JAX's
    ``make_predict_eval_step`` under ``create_mesh("data:2,spatial:2")``;
  * one train step of MTAN, basic and CSNet (and fold_tasks, fold_tail and
    remat_attention, whose recompute runs the halo'd convs again) under
    ``data:2,spatial:2`` against the port's
    one-process step, with every rank's updated weights bit for bit equal;
  * B4's plain split over data x spatial ranks, the refusals, the
    full-batch loading mode against JAX's, and ``Predictor`` /
    ``BatchingServer(mesh=)`` against one process;
  * the epoch loop and the predict sweep in process, then the CLI through
    its launcher as four processes (``--device cpu:4``): a preemption on
    one rank, its exit 143, and the resume.
"""

import argparse
import json
import os
import threading
import typing as t
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from vision_mtl_tpu.data import loader as jax_loader
from vision_mtl_tpu.data.synthetic import SyntheticMTLDataset as JaxSynthetic
from vision_mtl_tpu.metrics import compute_metrics as jax_compute_metrics
from vision_mtl_tpu.metrics import init_metrics as jax_init_metrics
from vision_mtl_tpu.models.mtan import MTANMiniUnet as JaxMTAN
from vision_mtl_tpu.parallel import mesh as jax_mesh
from vision_mtl_tpu.parallel import multihost as jax_multihost
from vision_mtl_tpu.train.step import make_predict_eval_step as jax_predict_eval_step
from vision_mtl_tpu_torch import training
from vision_mtl_tpu_torch.data import loader
from vision_mtl_tpu_torch.data.datamodule import configure_host_sharded_loading
from vision_mtl_tpu_torch.data.synthetic import SyntheticMTLDataset
from vision_mtl_tpu_torch.kernels import fused_gate_train
from vision_mtl_tpu_torch.metrics import compute_metrics, init_metrics, reduce_metrics
from vision_mtl_tpu_torch.models import blocks
from vision_mtl_tpu_torch.models.basic import BasicMTLModel
from vision_mtl_tpu_torch.models.cross_stitch import CSNet
from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet
from vision_mtl_tpu_torch.models.registry import row_stride
from vision_mtl_tpu_torch.ops import fold, interpolate
from vision_mtl_tpu_torch.parallel import halo, mesh, multihost
from vision_mtl_tpu_torch.parallel.multihost import ThreadComm, ThreadGroup
from vision_mtl_tpu_torch.train.state import create_train_state
from vision_mtl_tpu_torch.train.step import make_predict_eval_step, make_train_step
from vision_mtl_tpu_torch.weights import load_jax_variables

#: forward, dx and dw of a conv over row blocks against the unsharded conv
#: (f32, inputs and cotangents scaled so that every value is of magnitude
#: about 1 or less: the sums differ only in their order)
CONV_ATOL = 1e-6
#: the resize, SE mean, pad and folded conv, forward and gradient (the
#: cotangents scaled as for the convs)
OP_ATOL = 1e-6
NC = 5
TASKS = {"depth": 1, "segm": NC}
MTAN_KW = dict(task_subnets_hidden_channels=8, encoder_first_channel=8, encoder_num_channels=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def on_ranks(fn, world):
    """``fn(comm)`` on ``world`` threads, each a rank of one ThreadGroup;
    the results in rank order (an exception on any rank is raised)."""
    group = ThreadGroup(world, timeout=60.0)
    out: t.List[t.Any] = [None] * world

    def run(r):
        try:
            out[r] = fn(ThreadComm(group, r))
        except BaseException as e:  # handed to the caller
            out[r] = e

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive(), "a rank did not finish"
    for r in out:
        if isinstance(r, BaseException):
            raise r
    return out


def on_mesh(fn, spec):
    """``fn(mesh)`` on the ranks of ``spec``'s mesh, each a thread."""
    axes = mesh.parse_mesh_shape(spec, int(np.prod([int(p.split(":")[1])
                                                    for p in spec.split(",")])))
    return on_ranks(lambda c: fn(mesh.Mesh(dict(axes), c)), int(np.prod(list(axes.values()))))


def _uniform(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.uniform(-scale, scale, shape).astype(np.float32))


# ---- the rank layout ----------------------------------------------------------


@pytest.mark.parametrize("spec", ["data:2,spatial:2", "spatial:2,data:2", "spatial:4",
                                  "data:4,spatial:2"])
def test_rank_layout_matches_jax_device_index_map(spec):
    """Rank r's (batch rows, H rows), and its block of a batch, are device
    r's indices in JAX's ``NamedSharding(create_mesh(spec),
    _leaf_spec(...)).devices_indices_map``; ``Mesh.gather`` of the blocks
    gives the batch back."""
    n = int(np.prod([int(p.split(":")[1]) for p in spec.split(",")]))
    jm = jax_mesh.create_mesh(spec, jax.devices()[:n])
    shape = (8, 16, 4, 3)
    index = NamedSharding(jm, jax_mesh._leaf_spec(4, jm)).devices_indices_map(shape)
    valid_index = NamedSharding(jm, jax_mesh._leaf_spec(1, jm)).devices_indices_map((8,))
    axes = mesh.parse_mesh_shape(spec, n)
    batch = {"img": np.arange(np.prod(shape)).reshape(shape), "valid": np.arange(8)}
    for r in range(n):
        m = mesh.Mesh(dict(axes), multihost.Comm(r, n))
        rows, hrows = index[jax.devices()[r]][:2]
        assert m.batch_rows(8).indices(8) == rows.indices(8), r
        assert m.image_rows(16).indices(16) == hrows.indices(16), r
        block = m.block(batch)
        np.testing.assert_array_equal(block["img"], batch["img"][rows, hrows])
        np.testing.assert_array_equal(block["valid"], batch["valid"][valid_index[jax.devices()[r]]])

    x = torch.from_numpy(batch["img"]).float()
    v = torch.from_numpy(batch["valid"]).float()
    for got in on_mesh(lambda m: (m.gather(torch.from_numpy(m.block({"x": x.numpy()})["x"])),
                                  m.gather(v[m.batch_rows(8)])), spec):
        assert torch.equal(got[0], x) and torch.equal(got[1], v)


# ---- ops on row blocks ------------------------------------------------------------

# (spatial, k, stride, depthwise, H, B3): H / spatial rows a rank
CONV_CASES = [
    (2, 1, 1, False, 16, False), (2, 3, 1, False, 16, False), (2, 3, 2, False, 16, False),
    (2, 5, 1, True, 16, False), (2, 5, 2, True, 16, False), (4, 3, 1, False, 16, False),
    (4, 3, 2, True, 16, False), (4, 5, 2, True, 8, False),
    (4, 5, 1, True, 4, False),  # 1 row a rank, a halo of 2 each side
    (2, 3, 1, False, 16, True), (4, 3, 1, False, 4, True),  # B3, plain version
]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "S{}-k{}-s{}-{}-H{}{}".format(
    c[0], c[1], c[2], "dw" if c[3] else "dense", c[4], "-b3" if c[5] else ""))
def test_conv_over_row_blocks_matches_unsharded(case):
    """``conv_nhwc`` inside ``spatial_rows``: each rank's output rows, its
    rows' dx and its share of dw (summed over the ranks) against the
    unsharded conv, within ``CONV_ATOL``."""
    spatial, k, stride, depthwise, height, b3 = case
    rng = np.random.default_rng(k * 10 + stride)
    c = 6
    o, groups = (c, c) if depthwise else (4, 1)
    x = _uniform(rng, 2, height, 8, c)
    w = _uniform(rng, o, c // groups, k, k, scale=0.5)
    b = _uniform(rng, o)
    cot = _uniform(rng, 2, height // stride, 8 // stride, o, scale=0.1)

    def run(xs, cs, comm=None):
        xs, ws = xs.clone().requires_grad_(), w.clone().requires_grad_()
        with halo.spatial_rows(comm):
            y = blocks.conv_nhwc(xs, ws, b, torch.float32, (stride, stride), groups, b3)
        y.backward(cs)
        return y.detach(), xs.grad, ws.grad

    want = run(x, cot)
    h = height // spatial

    def rank(comm):
        s = comm.rank
        return run(x[:, s * h:(s + 1) * h], cot[:, s * h // stride:(s + 1) * h // stride], comm)

    got = on_ranks(rank, spatial)
    tol = dict(rtol=0, atol=CONV_ATOL)
    torch.testing.assert_close(torch.cat([g[0] for g in got], 1), want[0], **tol)
    torch.testing.assert_close(torch.cat([g[1] for g in got], 1), want[1], **tol)
    torch.testing.assert_close(sum(g[2] for g in got), want[2], **tol)


def _op_resize(x):
    return interpolate.resize_bilinear_align_corners(x, 2 * x.shape[1], 2 * x.shape[2] - 1)


def _op_squeeze_excite(x):
    se = blocks.SqueezeExcite(6, 4, dtype=torch.float32)
    blocks.init_weights(se, 0)
    return se(x)


def _op_pad(x):  # CSNet's merge: the map centred in one twice as tall
    return interpolate.pad_to_match(x, torch.zeros(1, 2 * x.shape[1], x.shape[2] + 3, 1))


def _op_folded_conv(x):
    kernel = torch.from_numpy(np.random.default_rng(4).uniform(-0.5, 0.5, (5, 5, 6, 3))
                              .astype(np.float32))
    return fold.folded_conv(fold.space_to_depth(x), kernel, dtype=torch.float32)


def _op_halo(x):
    comm = halo.rows_comm()
    return x if comm is None else halo.halo_rows(x, 3, 2, comm)


OPS = {"resize": _op_resize, "squeeze_excite": _op_squeeze_excite, "csnet_pad": _op_pad,
       "folded_conv": _op_folded_conv, "halo_rows": _op_halo}


@pytest.mark.parametrize("spatial", [2, 4])
@pytest.mark.parametrize("name", list(OPS))
def test_op_over_row_blocks_matches_unsharded(name, spatial):
    """The ops that read across rows, inside ``spatial_rows``, against the
    unsharded op: forward and x's gradient within ``OP_ATOL``. ``halo_rows``
    (3 rows above, 2 below, 2 rows a rank under ``spatial:4``) against the
    rows it must return, zeros past the edges, and its backward against the
    sum of every rank's cotangent for each row."""
    rng = np.random.default_rng(7)
    height = 8
    x = _uniform(rng, 2, height, 6, 6)
    h = height // spatial
    op = OPS[name]

    def run(xs, comm=None):
        xs = xs.clone().requires_grad_()
        with halo.spatial_rows(comm):
            y = op(xs)
        return y, xs

    if name == "halo_rows":
        padded = torch.nn.functional.pad(x, (0, 0, 0, 0, 3, 2))
        cot = _uniform(rng, spatial, 2, h + 5, 6, 6)
        want_grad = torch.zeros_like(padded)
        for s in range(spatial):
            want_grad[:, s * h:s * h + h + 5] += cot[s]
        want_grad = want_grad[:, 3:3 + height]

        def rank(comm):
            y, xs = run(x[:, comm.rank * h:(comm.rank + 1) * h], comm)
            y.backward(cot[comm.rank])
            return y.detach(), xs.grad

        got = on_ranks(rank, spatial)
        for s, (y, _) in enumerate(got):
            assert torch.equal(y, padded[:, s * h:s * h + h + 5]), s
        torch.testing.assert_close(torch.cat([g[1] for g in got], 1), want_grad,
                                   rtol=0, atol=OP_ATOL)
        return

    y, xs = run(x)
    cot = _uniform(rng, *y.shape, scale=0.25)
    y.backward(cot)
    ho = y.shape[1] // spatial

    def rank(comm):
        y, xs = run(x[:, comm.rank * h:(comm.rank + 1) * h], comm)
        y.backward(cot[:, comm.rank * ho:(comm.rank + 1) * ho])
        return y.detach(), xs.grad

    got = on_ranks(rank, spatial)
    tol = dict(rtol=0, atol=OP_ATOL)
    torch.testing.assert_close(torch.cat([g[0] for g in got], 1), y.detach(), **tol)
    torch.testing.assert_close(torch.cat([g[1] for g in got], 1), xs.grad, **tol)


# ---- MTAN's predict-eval step against JAX's under the same mesh -------------------


class _State(t.NamedTuple):
    params: t.Any
    batch_stats: t.Any


def _fill(tree, rng, coll):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _fill(v, rng, coll)
            continue
        if coll == "batch_stats":
            out[k] = rng.uniform(-0.3, 0.3, v.shape) if k == "mean" else \
                rng.uniform(0.5, 1.5, v.shape)
        elif k in ("kernel", "w1", "w2"):
            bound = np.sqrt(3.0 / np.prod(v.shape[:-1]))
            out[k] = rng.uniform(-bound, bound, v.shape)
        elif k.startswith("scale"):
            out[k] = rng.uniform(0.5, 1.5, v.shape)
        else:
            out[k] = rng.uniform(-0.3, 0.3, v.shape)
        out[k] = np.asarray(out[k], np.float32)
    return out


def _eval_batch(rng, n=4, hw=(32, 16)):
    return {
        "img": rng.uniform(size=(n, *hw, 3)).astype(np.float32),
        "mask": rng.integers(0, NC, (n, *hw)).astype(np.int32),
        "depth": rng.uniform(0.05, 1.0, (n, *hw, 1)).astype(np.float32),
        "valid": np.asarray([1, 1, 1, 0], np.float32),
    }


def test_mtan_predict_eval_matches_jax_under_data_and_spatial():
    """MTAN's predict-eval step under ``data:2,spatial:2`` (four thread
    ranks) against JAX's ``make_predict_eval_step`` under
    ``create_mesh("data:2,spatial:2", jax.devices()[:4])`` on the same
    seeded weights and batch (a padded row included, so the cross-entropy's
    ``valid`` count, which each rank takes over its own image rows, is
    summed over the ranks): predictions gathered whole on every rank (argmax ids equal on all but 1 pixel in 500, depth
    within 1e-5), losses within 1e-4 relative, the reduced metrics within
    1e-4 relative (1e-6 absolute)."""
    jmodel = JaxMTAN(map_tasks_to_num_channels=TASKS, dtype=jnp.float32, **MTAN_KW)
    rng = np.random.default_rng(11)
    batch = _eval_batch(rng)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.asarray(batch["img"]),
                                                train=False))
    variables = {coll: _fill(tree, rng, coll) for coll, tree in shapes.items()}
    jm = jax_mesh.create_mesh("data:2,spatial:2", jax.devices()[:4])
    jstep = jax_predict_eval_step(jmodel, mesh=jm)
    state = _State(jax.tree.map(jnp.asarray, variables["params"]),
                   jax.tree.map(jnp.asarray, variables["batch_stats"]))
    jpreds, jmstate, jlosses = jstep(state, jax_mesh.put_batch(batch, jm), jax_init_metrics(NC))
    jpreds = jax.device_get(jpreds)
    want_metrics = {k: float(v) for k, v in jax_compute_metrics(jmstate).items()}

    def rank(m):
        model = MTANMiniUnet(TASKS, dtype=torch.float32, **MTAN_KW)
        load_jax_variables(model, variables)
        step = make_predict_eval_step(model, mesh=m)
        block = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in m.block(batch).items()}
        preds, mstate, losses = step(block, init_metrics(NC, "cpu"))
        preds = {k: m.gather(v) for k, v in preds.items()}
        mstate = reduce_metrics(mstate, m.comm)
        return preds, {k: float(v) for k, v in losses.items()}, \
            {k: float(v) for k, v in compute_metrics(mstate).items()}

    for preds, losses, got_metrics in on_mesh(rank, "data:2,spatial:2"):
        assert preds["segm"].shape == (4, 32, 16) and preds["depth"].shape == (4, 32, 16, 1)
        assert np.mean(preds["segm"].numpy() != jpreds["segm"]) <= 0.002
        np.testing.assert_allclose(preds["depth"].numpy(), jpreds["depth"], rtol=0, atol=1e-5)
        for k, v in losses.items():
            assert v == pytest.approx(float(jlosses[k]), rel=1e-4), k
        for k, v in want_metrics.items():
            assert got_metrics[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k


# ---- one train step of each model under data:2,spatial:2 --------------------------


def _build(name: str):
    if name.startswith("mtan"):
        return MTANMiniUnet(TASKS, dtype=torch.float32, seed=0, fold_tasks="fold" in name,
                            remat_attention="remat" in name, **MTAN_KW)
    if name.startswith("basic"):
        return BasicMTLModel(NC, decoder_first_channel=16, num_decoder_layers=5,
                             fold_tail="fold" in name, dtype=torch.float32, seed=0)
    return CSNet(TASKS, decoder_first_channel=16, num_decoder_layers=5, dtype=torch.float32,
                 seed=0)


def _train_batch(n, hw):
    rng = np.random.default_rng(13)
    return {"img": torch.from_numpy(rng.uniform(size=(n, *hw, 3)).astype(np.float32)),
            "mask": torch.from_numpy(rng.integers(0, NC, (n, *hw)).astype(np.int32)),
            "depth": torch.from_numpy(rng.uniform(0.1, 1.0, (n, *hw, 1)).astype(np.float32))}


def _train_step(name, batch, m=None):
    model = _build(name)
    state = create_train_state(model, 1e-3, device="cpu")
    block = m.block(batch) if m is not None else batch
    _, mstate, losses = make_train_step(device="cpu", mesh=m)(
        state, block, init_metrics(NC, "cpu"))
    mstate = reduce_metrics(mstate, m.comm if m is not None else None)
    return (float(losses["loss"]), {k: float(v) for k, v in compute_metrics(mstate).items()},
            {k: p.grad.clone() for k, p in model.named_parameters()},
            torch.cat([p.detach().reshape(-1) for p in model.parameters()]))


#: model -> (global batch, H, W): H splits over spatial 2 at every level
TRAIN_CASES = {"mtan": (4, 16, 16), "mtan_fold_tasks": (4, 16, 16),
               "mtan_remat_attention": (4, 16, 16), "basic": (4, 64, 32),
               "basic_fold_tail": (4, 64, 32), "csnet": (4, 64, 16)}
#: loss and metrics (relative), and each gradient leaf within GRAD_RTOL of
#: its largest magnitude plus GRAD_ATOL of the model's largest gradient
#: (f32: the BatchNorms combine the ranks' statistics in f64, the convs sum
#: their halo rows in another order)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-6, 5e-4, 5e-6


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_train_step_over_data_and_spatial_matches_one_process(name):
    """One f32 train step under ``data:2,spatial:2`` (four thread ranks,
    each a quarter of the global batch: half its images, half their rows)
    against the port's one-process step on the global batch: the loss and
    the reduced metrics, every gradient leaf, and every rank's updated
    weights bit for bit equal."""
    n, *hw = TRAIN_CASES[name]
    batch = _train_batch(n, hw)
    want = _train_step(name, batch)
    got = on_mesh(lambda m: _train_step(name, batch, m), "data:2,spatial:2")
    top = max(float(g.abs().max()) for g in want[2].values())
    for loss, metrics_, grads, weights in got:
        assert loss == pytest.approx(want[0], rel=LOSS_RTOL)
        for k, v in want[1].items():
            assert metrics_[k] == pytest.approx(v, rel=LOSS_RTOL, abs=1e-7), k
        for k, w in want[2].items():
            err = float((grads[k] - w).abs().max())
            assert err <= GRAD_RTOL * float(w.abs().max()) + GRAD_ATOL * top, (k, err)
        assert torch.equal(weights.view(torch.int32), got[0][3].view(torch.int32))


# ---- B4, the refusals, loading, serving ------------------------------------------


def test_gate_train_plain_split_over_data_and_spatial():
    """B4's plain version over ``data:2,spatial:2`` (each rank a quarter of
    the pixels: half the images, half their rows; the statistics combined
    over all four) against one process on the whole batch, f64 within 1e-10:
    the output blocks and x's gradient, the statistics (the same bits on
    every rank), the summed weight gradients."""
    g = torch.Generator().manual_seed(1)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, dtype=torch.float64) * scale

    x, shared = r(4, 6, 5, 6), r(4, 6, 5, 8)
    weights = (r(6, 8, scale=0.4), r(8, scale=0.1), r(8).abs() + 0.5, r(8, scale=0.2),
               r(8, 8, scale=0.35), r(8, scale=0.1), r(8).abs() + 0.5, r(8, scale=0.2))
    cot = r(4, 6, 5, 8)

    def run(xs, ss, cs, comm=None):
        leaves = [v.clone().requires_grad_() for v in (xs, ss, *weights)]
        out, *stats = fused_gate_train.fused_attention_gate_train(*leaves, comm=comm)
        out.backward(cs)
        return out.detach(), stats, [v.grad for v in leaves]

    want = run(x, shared, cot)

    def rank(m):
        blk = m.block({"x": x, "s": shared, "c": cot})
        return run(blk["x"], blk["s"], blk["c"], m.comm)

    got = on_mesh(rank, "data:2,spatial:2")
    tol = dict(rtol=1e-10, atol=1e-10)
    m0 = mesh.Mesh({"data": 2, "spatial": 2}, multihost.Comm(0, 4))
    for r_, (out, stats, grads) in enumerate(got):
        rows, hrows = m0.batch_rows(4, r_), m0.image_rows(6, r_)
        torch.testing.assert_close(out, want[0][rows, hrows], **tol)
        torch.testing.assert_close(grads[0], want[2][0][rows, hrows], **tol)
        for a, b, w in zip(stats, got[0][1], want[1]):
            assert torch.equal(a, b)
            torch.testing.assert_close(a, w, **tol)
    for i in range(2, 10):
        torch.testing.assert_close(sum(gg[2][i] for gg in got), want[2][i], **tol)


@pytest.mark.parametrize("argv,match", [
    (["--mesh_shape", "data:2,model:2"], r"model axis .*ROADMAP\.md A10c"),
    (["--mesh_shape", "spatial:4", "--model_name", "basic"],
     r"height 64 .*spatial x 32 = 128"),
])
def test_cli_refuses_the_model_axis_and_heights_that_do_not_split(monkeypatch, argv, match):
    """Under ``--device cpu:4`` the launcher checks the mesh before it
    starts a rank: a ``model`` axis names ROADMAP A10c; the synthetic set's
    64 rows do not split over ``spatial:4`` for basic (stride 32), which is
    refused naming the rule; ``create_mesh`` refuses ``model`` too."""
    monkeypatch.setattr(multihost, "launch_local_ranks", None)  # no rank may start
    with pytest.raises(SystemExit, match=match):
        training.main(["--device", "cpu:4", "--dataset_name", "synthetic"] + argv)
    with pytest.raises(SystemExit, match=r"ROADMAP\.md A10c"):
        mesh.create_mesh("spatial:2,model:2", multihost.Comm(0, 4))
    assert {m: row_stride(m) for m in ("mtan", "basic", "csnet")} == {
        "mtan": 16, "basic": 32, "csnet": 32}


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_full_batch_loading_matches_jax(monkeypatch, mode):
    """Under a ``spatial`` axis that spans processes the loaders decode the
    whole global batch on every rank (``shard_rows`` False, as JAX's
    ``configure_host_sharded_loading`` sets), and each rank's block, as
    ``mesh.local_batches`` yields it, is JAX's
    ``global_batch_from_local(..., full_local=True)`` shard of its device
    (``_process_shard`` monkeypatched on both loaders, 4 ranks)."""
    kw = (dict(shuffle=True, seed=3, drop_last=True) if mode == "train"
          else dict(pad_last=True))
    jds, pds = JaxSynthetic(stage="train"), SyntheticMTLDataset(stage="train")
    jds.length = pds.length = 11
    jm = jax_mesh.create_mesh("data:2,spatial:2", jax.devices()[:4])
    m = mesh.Mesh({"data": 2, "spatial": 2}, multihost.Comm(0, 4))

    class _DM:
        pass

    dm = _DM()
    configure_host_sharded_loading(dm, m)
    assert dm.shard_rows is False
    monkeypatch.setattr(jax_loader.DataLoader, "_process_shard", staticmethod(lambda: (1, 4)))
    monkeypatch.setattr(loader.DataLoader, "_process_shard", staticmethod(lambda: (1, 4)))
    want = list(jax_loader.DataLoader(jds, batch_size=4, shard_rows=False, **kw))
    got = list(loader.DataLoader(pds, batch_size=4, shard_rows=dm.shard_rows, **kw))
    assert len(got) == len(want) == (2 if mode == "train" else 3)
    blocks = [list(mesh.local_batches(got, mesh.Mesh({"data": 2, "spatial": 2},
                                                     multihost.Comm(r, 4))))
              for r in range(4)]
    for i, w in enumerate(want):
        arrays = jax_multihost.global_batch_from_local(w, jm, full_local=True)
        for r in range(4):
            block = mesh.put_batch(blocks[r][i], m)
            for k, arr in arrays.items():
                (shard,) = [s for s in arr.addressable_shards if s.device == jax.devices()[r]]
                np.testing.assert_array_equal(block[k].numpy(), np.asarray(shard.data),
                                              err_msg=f"{k} rank {r}")
    with pytest.raises(ValueError, match="row-sliced loader"):
        next(iter(mesh.local_batches(loader.DataLoader(pds, batch_size=4, **kw), m)))


def test_predictor_and_batching_server_over_data_and_spatial():
    """``Predictor(mesh=)`` over ``data:2,spatial:2``: each rank runs its
    block of the padded batch and every rank returns the whole answer,
    equal to one process's (ids exactly, depth within 1e-6).
    ``BatchingServer(mesh=)``: rank 0 takes the requests, the others follow
    its batches; each answer is the one-process Predictor's."""
    from vision_mtl_tpu_torch.serving import BatchingServer, Predictor

    def model():
        return MTANMiniUnet(TASKS, dtype=torch.float32, seed=0, **MTAN_KW).eval()

    imgs = np.random.default_rng(6).uniform(size=(3, 16, 8, 3)).astype(np.float32)
    want = Predictor(model(), 4, 16, 8, device="cpu")(imgs)

    def rank(m):
        got = Predictor(model(), 4, 16, 8, mesh=m)(imgs)
        server = BatchingServer(model(), 16, 8, buckets=(2, 4), max_wait_ms=50.0, mesh=m)
        if m.rank == 0:
            futures = [server.submit(img) for img in imgs]
            answers = [f.result(timeout=60) for f in futures]
            server.close()
        else:
            server.follow()
            answers = None
        return got, answers

    out = on_mesh(rank, "data:2,spatial:2")
    for got, _ in out:
        np.testing.assert_array_equal(got["segm"], want["segm"])
        np.testing.assert_allclose(got["depth"], want["depth"], rtol=0, atol=1e-6)
    for i, answer in enumerate(out[0][1]):
        np.testing.assert_array_equal(answer["segm"], want["segm"][i])
        np.testing.assert_allclose(answer["depth"], want["depth"][i], rtol=0, atol=1e-6)


# ---- the epoch loop and the predict sweep, in process --------------------------

#: what the weights compute after the epoch's Adam steps, against one
#: process: metrics relative, depth absolute (measured 8e-4 and 1e-4)
AFTER_ADAM_RTOL, AFTER_ADAM_DEPTH_ATOL = 2e-3, 5e-4
LOOP_ARGS = argparse.Namespace(
    loss_segm_weight=1.0, loss_depth_weight=1.0, val_epoch_freq=1, save_epoch_freq=10,
    do_plot_preds=False, do_show_preds=False, grad_accum_steps=1, keep_ckpt_last_k=0,
)


def test_run_pipe_and_predict_over_data_and_spatial_match_one_process(monkeypatch, capsys):
    """``run_pipe`` (one epoch: 2 train steps, a padded val batch) and the
    predict sweep over ``data:2,spatial:2`` (four thread ranks; the loaders
    in the full-batch mode, each rank cutting its block): every rank's
    weights bit for bit equal; against the one-process run (f32) the train
    epoch's metrics within 1e-5 relative, and after the epoch's Adam steps
    the val metrics, the sweep's metrics (``AFTER_ADAM_RTOL``) and its
    predictions, whole on every rank (ids equal on all but 1 pixel in 500,
    depth within ``AFTER_ADAM_DEPTH_ATOL``). Adam's first steps move each
    weight by about lr whatever its gradient's size, so a rounding-level
    gradient can flip a step: the weights are held through these outputs,
    and the gradients themselves by the train-step test above."""
    from vision_mtl_tpu_torch.data import datamodule, synthetic
    from vision_mtl_tpu_torch.predict import predict
    from vision_mtl_tpu_torch.train.loop import run_pipe

    for k, v in dict(height=16, width=16, num_classes=NC, num_train=10, num_val=3).items():
        monkeypatch.setattr(synthetic.synthetic_data_cfg, k, v)

    def run(m=None):
        model = MTANMiniUnet(TASKS, dtype=torch.float32, seed=0, **MTAN_KW)
        dm = datamodule.MTLDataModule("synthetic", batch_size=4, seed=11)
        dm.setup()
        state = create_train_state(model, 1e-3, device="cpu")
        state, epochs = run_pipe(LOOP_ARGS, state, dm, num_epochs=1, num_classes=NC,
                                 device="cpu", mesh=m)
        preds, metrics_ = predict(dm.predict_dataloader(), state.model, NC, device="cpu", mesh=m)
        weights = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        return weights, epochs, preds, metrics_

    want = run()
    got = on_mesh(run, "data:2,spatial:2")
    assert capsys.readouterr().out.count("### Epoch") == 1 + 4
    for weights, epochs, preds, metrics_ in got:
        assert torch.equal(weights.view(torch.int32), got[0][0].view(torch.int32))
        for stage, rel in (("train", 1e-5), ("val", AFTER_ADAM_RTOL)):
            for key, values in want[1][stage].items():
                assert epochs[stage][key] == pytest.approx(values, rel=rel, abs=1e-7), key
        assert [p["segm"].shape for p in preds] == [p["segm"].shape for p in want[2]]
        for p, w in zip(preds, want[2]):
            assert np.mean(p["segm"] != w["segm"]) <= 0.002
            np.testing.assert_allclose(p["depth"], w["depth"], rtol=0, atol=AFTER_ADAM_DEPTH_ATOL)
        assert metrics_ == pytest.approx(want[3], rel=AFTER_ADAM_RTOL, abs=1e-7)


# ---- the CLI launched over four CPU ranks ----------------------------------------

#: the launched ranks' synthetic set (MTAN's 16 row stride x spatial 2 = 32
#: rows; 6 train rows after the split, 2 steps of 4), read through a
#: sitecustomize on their path, which also requests the preemption on one
#: rank alone
LAUNCH_TINY = dict(height=32, width=16, num_train=8, num_val=2)
LAUNCH_SITECUSTOMIZE = f"""
import os, sys
sys.modules["torch.utils.tensorboard"] = None  # it would load TensorFlow here
from vision_mtl_tpu_torch.data import synthetic
for k, v in {LAUNCH_TINY!r}.items():
    setattr(synthetic.synthetic_data_cfg, k, v)
if os.environ.get("RANK") == os.environ.get("VMTL_TEST_PREEMPT_RANK"):
    os.environ["VMTL_PREEMPT_AT_STEP"] = "1"
"""


def test_cli_launch_over_data_and_spatial_preempts_and_resumes(tmp_path, monkeypatch, capfd):
    """``training.main(["--device", "cpu:4", "--mesh_shape", "data:2,spatial:2",
    ...])`` end to end: the launcher starts 4 processes with torchrun's
    environment, each joins the process group and runs the CLI on its
    block of every batch (MTAN at full width, f32). A preemption requested
    on rank 3 alone stops every rank at the same step, and the launch exits
    143. ``--resume_dir`` of that run finishes the epoch, and the launch
    returns the run dir that rank 0 handed back: one checkpoint, the
    epoch's metrics, and the predict sweep's whole predictions."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(LAUNCH_SITECUSTOMIZE)
    monkeypatch.setenv("PYTHONPATH", f"{site}:{Path(__file__).resolve().parents[1]}")
    monkeypatch.setenv("VMTL_LOG_ROOT", str(tmp_path / "logs"))
    for var in multihost.LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    logs = tmp_path / "logs" / "training-mtan"
    argv = ["--device", "cpu:4", "--mesh_shape", "data:2,spatial:2", "--dataset_name",
            "synthetic", "--model_name", "mtan", "--batch_size", "4", "--precision", "f32",
            "--exp_disabled", "--num_epochs", "1"]

    monkeypatch.setenv("VMTL_TEST_PREEMPT_RANK", "3")
    with pytest.raises(SystemExit) as e:
        training.main(argv + ["--preempt_save"])
    assert e.value.code == 143
    assert capfd.readouterr().out.count("Preempted at epoch 1 step 1;") == 4
    preempted = str(logs / "version_0")
    assert json.load(open(Path(preempted) / "preempt_meta.json")) == \
        {"epoch": 0, "batch_in_epoch": 1}

    monkeypatch.delenv("VMTL_TEST_PREEMPT_RANK")
    run_dir = training.main(argv + ["--resume_dir", preempted])
    assert run_dir == str(logs / "version_1")
    entries = sorted(os.listdir(run_dir))
    assert [e for e in entries if e.startswith(("model_", "session_"))] == \
        ["model_0", "session_0"]
    records = [json.loads(ln) for ln in open(Path(run_dir) / "metrics.jsonl")]
    trained = [r for r in records if "epoch/train/loss" in r]
    assert [r["step"] for r in trained] == [0] and np.isfinite(trained[0]["epoch/train/loss"])
    with np.load(Path(run_dir) / "preds.npz") as preds:
        assert preds["segm"].shape == (2, 32, 16) and preds["depth"].shape == (2, 32, 16, 1)
        assert np.isfinite(preds["depth"]).all()
