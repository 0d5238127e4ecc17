"""The mesh's ``model`` axis in the port: conv kernels sharded by output
channel, with their Adam moments; the output channels gathered over the
model group; every batch-wide sum kept to the ranks of one slice.

The ranks are threads of one process (``ThreadGroup`` / ``ThreadComm``),
one torch thread, f32, tiny shapes. Held here:

  * ``param_shardings`` against JAX's ``param_shardings`` for MTAN, basic
    and CSNet at full width under ``model:2`` and ``model:4``, and at the
    tests' tiny width with ``min_size=0`` on JAX's own tree
    (``jax.eval_shape``; nothing compiles);
  * each sharded op against the unsharded one under ``model:2``: a 3x3, a
    1x1, a depthwise and the 2x2 transposed conv, a squeeze-excite block,
    the gate with its ``w1`` gathered through B1's and B4's plain versions,
    and B3's plain version on a 10-channel output slice; forward and
    gradients;
  * MTAN's predict-eval step under ``data:2,model:2`` against JAX's
    ``make_predict_eval_step`` under ``create_mesh("data:2,model:2")``,
    with JAX's parameters placed by its ``param_shardings(min_size=0)``;
    and under ``spatial:2,model:2`` against one process;
  * one train step of MTAN, basic and CSNet under ``data:2,model:2`` at
    ``min_size=0`` against the port's one-process step (the BatchNorms'
    running variances with torch's n/(n-1), which counts the rows);
    replicated leaves bit for bit on all four ranks, sharded leaves and
    their Adam moments across the data ranks of a slice;
  * the three axes at once: tiny MTAN under ``data:2,spatial:2,model:2``
    (eight ranks) in f64 against one process, and each rank's groups
    against JAX's device array for the same spec;
  * checkpoints written under the mesh against a one-process save, and
    restored into one process and back under ``model:2``;
  * ``run_pipe``, the predict sweep, ``Predictor`` and
    ``BatchingServer(mesh=)`` under ``data:1,model:2`` against one process;
  * the options' layouts: ``fold_tasks`` (MTAN's task-stacked leaves) and
    ``fold_tail`` (basic's folded tail) against JAX's at full width (29 and
    21 leaves) and at ``min_size=0``; a sliced ``FoldedConv`` against the
    whole one; their train steps under ``data:2,model:2``; MTAN
    ``fold_tasks``' predict-eval against JAX's under the same mesh; their
    checkpoints, ``fold_task_state_dict`` and ``Predictor(mesh=)``.
"""

import argparse
import copy
import os
import threading
import typing as t

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_mtl_tpu.metrics import compute_metrics as jax_compute_metrics
from vision_mtl_tpu.metrics import init_metrics as jax_init_metrics
from vision_mtl_tpu.cfg import fetch_data_cfg as jax_data_cfg
from vision_mtl_tpu.models.mtan import MTANMiniUnet as JaxMTAN
from vision_mtl_tpu.models.registry import build_model as jax_build_model
from vision_mtl_tpu.parallel import mesh as jax_mesh
from vision_mtl_tpu.train.step import make_predict_eval_step as jax_predict_eval_step
from vision_mtl_tpu_torch.cfg import fetch_data_cfg
from vision_mtl_tpu_torch.metrics import compute_metrics, init_metrics, reduce_metrics
from vision_mtl_tpu_torch.models import blocks
from vision_mtl_tpu_torch.models.basic import BasicMTLModel
from vision_mtl_tpu_torch.models.cross_stitch import CSNet
from vision_mtl_tpu_torch.models.mtan import GateChain, MTANMiniUnet, fold_task_state_dict
from vision_mtl_tpu_torch.ops import fold
from vision_mtl_tpu_torch.models.registry import build_model
from vision_mtl_tpu_torch.parallel import mesh, multihost
from vision_mtl_tpu_torch.parallel.multihost import ThreadComm, ThreadGroup, global_batch
from vision_mtl_tpu_torch.train import checkpoint
from vision_mtl_tpu_torch.train.plateau import ReduceLROnPlateau
from vision_mtl_tpu_torch.train.state import create_train_state, param_count
from vision_mtl_tpu_torch.train.step import make_predict_eval_step, make_train_step
from vision_mtl_tpu_torch.weights import _leaves, jax_variables_from_model, load_jax_variables

NC = 5
TASKS = {"depth": 1, "segm": NC}
MTAN_KW = dict(task_subnets_hidden_channels=8, encoder_first_channel=8, encoder_num_channels=2)
#: a sharded op's forward and gradients against the unsharded op, relative
#: to the largest magnitude of each (f32: the same sums, split by channel)
OP_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def on_mesh(fn, spec):
    """``fn(mesh)`` on the ranks of ``spec``'s mesh, each a thread of one
    ThreadGroup, the mesh made by ``create_mesh``; the results in rank
    order (an exception on any rank is raised)."""
    world = int(np.prod([int(p.split(":")[1]) for p in spec.split(",")]))
    group = ThreadGroup(world, timeout=60.0)
    out: t.List[t.Any] = [None] * world

    def run(r):
        try:
            out[r] = fn(mesh.create_mesh(spec, ThreadComm(group, r)))
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


def _uniform(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.uniform(-scale, scale, shape).astype(np.float32))


def _close(got, want, what):
    err = float((got - want).abs().max())
    assert err <= OP_RTOL * float(want.abs().max()), (what, err)


# ---- the layout against JAX's ----------------------------------------------------


def _jax_sharded(params, size, min_size=2**16):
    jm = jax_mesh.create_mesh(f"model:{size}", jax.devices()[:size])
    specs = jax.tree_util.tree_flatten_with_path(jax_mesh.param_shardings(jm, params, min_size))
    return {"params/" + "/".join(k.key for k in path)
            for path, s in specs[0] if "model" in tuple(s.spec)}


def _port_sharded(model, size, min_size=2**16):
    flax_key = {tk: fk for tk, fk, _ in _leaves(model)}
    layout = mesh.param_shardings(model, mesh.Mesh({"model": size}, multihost.Comm(0, size)),
                                  min_size)
    return {flax_key[k] for k, d in layout.items() if d is not None}


#: (model, model axis) -> leaves sharded at full width (JAX's counts too:
#: basic's three kernels of 135 and 67 outputs stay replicated at model:2)
FULL_WIDTH = {("mtan", 2): 31, ("mtan", 4): 31, ("basic", 2): 21, ("basic", 4): 19,
              ("csnet", 2): 44, ("csnet", 4): 44}


@pytest.mark.parametrize("name,size", list(FULL_WIDTH))
def test_param_shardings_match_jax_at_full_width(name, size):
    """At Cityscapes' full width the port shards exactly the leaves that
    JAX's ``param_shardings`` shards in the model's JAX tree, on the torch
    dim that holds JAX's last one. The tree is the bridge's
    (``jax_variables_from_model``), which ``test_torch_{mtan,basic,csnet}``
    hold leaf for leaf against JAX's ``eval_shape`` of the registry's
    models; below it JAX's own tree is used at the tiny width. The rank's
    slices then hold 1/size of each sharded leaf, and ``param_count`` still
    reports the whole model (13,277,908 for MTAN)."""
    model = build_model(name, fetch_data_cfg("cityscapes"), dtype=torch.float32, device="cpu")
    want = _jax_sharded(jax_variables_from_model(model)["params"], size)
    assert _port_sharded(model, size) == want and len(want) == FULL_WIDTH[(name, size)]
    if size == 2 and name == "mtan":
        whole = sum(p.numel() for p in model.parameters())
        m = mesh.Mesh({"model": 2}, multihost.Comm(1, 2))
        state = mesh.shard_state(create_train_state(model, 1e-3, device="cpu"), m)
        local = sum(p.numel() for p in model.parameters())
        assert param_count(state) == whole == 13_277_908
        assert local / whole == pytest.approx(0.5 + (1 - 0.9279148) / 2, abs=1e-6)
        assert "dec_attn_0_task0.GateChain_0.w1" in mesh.model_slices(model)


#: basic's width under ``fold_tail``: its folded block's two kernels (2
#: outputs) are sharded at ``min_size=0``
FOLD_TAIL_WIDTH = 32


def _tiny(name, dtype=torch.float32, **kw):
    """The tests' tiny model ``name``; a name ``model_option`` (``mtan_fold_tasks``,
    ``basic_fold_tail``) turns the option on."""
    name, _, option = name.partition("_")
    if option:
        kw[option] = True
    if name == "mtan":
        model = MTANMiniUnet(TASKS, dtype=dtype, seed=0, **MTAN_KW, **kw)
    elif name == "basic":
        width = FOLD_TAIL_WIDTH if kw.get("fold_tail") else 16
        model = BasicMTLModel(NC, decoder_first_channel=width, num_decoder_layers=5,
                              dtype=dtype, seed=0, **kw)
    else:
        model = CSNet(TASKS, decoder_first_channel=16, num_decoder_layers=5, dtype=dtype, seed=0,
                      **kw)
    return model.to(dtype)


def test_param_shardings_match_jax_at_min_size_0():
    """At the tests' tiny width with ``min_size=0`` every kernel, the gates'
    matrices and CSNet's stitch weights whose last JAX dim divides the axis
    are sharded, as JAX's rule shards them in the model's JAX tree (the
    bridge's, as above; MTAN's predict-eval test below holds the layout on
    JAX's own ``eval_shape`` tree too)."""
    for name in ("mtan", "basic", "csnet"):
        model = _tiny(name)
        params = jax_variables_from_model(model)["params"]
        for size in (2, 4):
            assert _port_sharded(model, size, 0) == _jax_sharded(params, size, 0), (name, size)


# ---- each sharded op against the unsharded one ----------------------------------------


def _op_conv3x3():
    conv = blocks.Conv(6, 8, (3, 3), dtype=torch.float32)
    return conv, lambda m, x: m(x)


def _op_conv1x1():
    conv = blocks.Conv(6, 8, (1, 1), use_bias=False, dtype=torch.float32, strides=(2, 2))
    return conv, lambda m, x: m(x)


def _op_depthwise():
    conv = blocks.Conv(6, 6, (5, 5), use_bias=False, dtype=torch.float32, groups=6,
                       strides=(2, 2))
    return conv, lambda m, x: m(x)


def _op_conv_transpose():
    return blocks.ConvTranspose(6, 4, dtype=torch.float32), lambda m, x: m(x)


def _op_squeeze_excite():
    return blocks.SqueezeExcite(6, 4, dtype=torch.float32), lambda m, x: m(x)


def _op_small_conv_slice():  # B3's plain version on a 10-channel output slice
    conv = blocks.Conv(6, 20, (3, 3), dtype=torch.float32, small_conv=True)
    assert conv.small_conv
    return conv, lambda m, x: m(x)


def _op_gate(train):
    def make():
        gate = GateChain(6, 8, 6)
        blocks.init_weights(gate, 0)
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():  # statistics of their own, not the defaults
            gate.mean1.uniform_(-0.3, 0.3, generator=gen)
            gate.var1.uniform_(0.5, 1.5, generator=gen)
        gate.train(train)

        def run(m, x):
            if not train:
                return m(x, x.flip(-1))
            with global_batch(None):
                return m(x, x.flip(-1))

        return gate, run
    return make


def _op_folded_conv():  # fold_tail's conv: 4 outputs, its input two folded groups
    conv = blocks.FoldedConv(6, 4, (3, 3), in_splits=(2, 4), dtype=torch.float32)
    return conv, lambda m, x: m(torch.cat([fold.space_to_depth(x[..., :2]),
                                           fold.space_to_depth(x[..., 2:])], -1))


OPS = {"conv3x3": _op_conv3x3, "conv1x1": _op_conv1x1, "depthwise": _op_depthwise,
       "conv_transpose": _op_conv_transpose, "squeeze_excite": _op_squeeze_excite,
       "b3_slice": _op_small_conv_slice, "gate_b1": _op_gate(False), "gate_b4": _op_gate(True),
       "folded_conv": _op_folded_conv}


@pytest.mark.parametrize("name", list(OPS))
def test_sharded_op_matches_unsharded(name, monkeypatch):
    """Each op with its leaves sharded over ``model:2`` (``shard_model`` at
    ``min_size=0``) against the same op unsharded: the output whole on both
    ranks, x's gradient, and each leaf's gradient (a sharded leaf's slices
    gathered), within ``OP_RTOL`` of the largest magnitude (the eval gate
    B1 has no backward: its forward alone); the slices are as the layout
    says (B1, B4 and B3 run their plain versions on the CPU)."""
    rng = np.random.default_rng(3)
    x = _uniform(rng, 2, 8, 8, 6)
    backward = name != "gate_b1"

    def run(m=None):
        module, fn = OPS[name]()
        if not name.startswith("gate"):
            blocks.init_weights(module, 0)
        if m is not None:
            mesh.shard_model(module, m, min_size=0)
        xs = x.clone().requires_grad_(backward)
        y = fn(module, xs)
        slices = mesh.model_slices(module)
        shapes = {k: tuple(p.shape) for k, p in module.named_parameters() if k in slices}
        if not backward:
            return y.detach(), None, {}, shapes
        cot = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, y.shape)
                               .astype(np.float32))
        y.backward(cot)
        grads = {k: (slices[k].gather(p.grad) if k in slices else p.grad)
                 for k, p in module.named_parameters()}
        return y.detach(), xs.grad, grads, shapes

    want = run()
    for y, dx, grads, sliced in on_mesh(run, "model:2"):
        assert sliced, "no leaf was sharded"
        _close(y, want[0], "out")
        if backward:
            _close(dx, want[1], "dx")
        for k, g in want[2].items():
            _close(grads[k], g, k)
    if name == "b3_slice":
        assert sliced == {"weight": (10, 6, 3, 3)}
    if name == "folded_conv":  # each rank folds 2 of the 4 outputs' kernels
        assert sliced == {"weight": (2, 6, 3, 3)}
    if name.startswith("gate"):
        assert sliced == {"w1": (6, 4), "w2": (8, 3)}


# ---- MTAN's predict-eval step against JAX's under the same mesh ---------------------


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


def _predict_eval_on(m, variables, batch, fold_tasks=False):
    model = MTANMiniUnet(TASKS, dtype=torch.float32, fold_tasks=fold_tasks, **MTAN_KW)
    load_jax_variables(model, variables)
    if m is not None:
        mesh.shard_model(model, m, min_size=0)
        load_jax_variables(model, variables)  # cut again: the same slices
    step = make_predict_eval_step(model, mesh=m)
    block = m.block(batch) if m is not None else batch
    block = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in block.items()}
    preds, mstate, losses = step(block, init_metrics(NC, "cpu"))
    if m is not None:
        preds = {k: m.gather(v) for k, v in preds.items()}
        mstate = reduce_metrics(mstate, m.replica_comm)
    return preds, mstate, {k: float(v) for k, v in losses.items()}


@pytest.mark.parametrize("spec", ["data:2,model:2", "spatial:2,model:2"])
def test_mtan_predict_eval_under_the_model_axis(spec):
    """MTAN's predict-eval step with every leaf that JAX's rule shards at
    ``min_size=0`` sharded. Under ``data:2,model:2`` against JAX's step under
    ``create_mesh("data:2,model:2", jax.devices()[:4])`` with the parameters
    placed by JAX's ``param_shardings(min_size=0)``: predictions whole on
    every rank (depth within 1e-5, argmax ids equal), the confusion counts
    exact, losses and metrics within 1e-5 relative; the port's layout is
    JAX's on JAX's own ``eval_shape`` tree. Under
    ``spatial:2,model:2`` against the port's one-process step: ids equal,
    depth within 1e-5, counts exact."""
    rng = np.random.default_rng(11)
    batch = _eval_batch(rng)
    jmodel = JaxMTAN(map_tasks_to_num_channels=TASKS, dtype=jnp.float32, **MTAN_KW)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.asarray(batch["img"]),
                                                train=False))
    variables = {coll: _fill(tree, rng, coll) for coll, tree in shapes.items()}
    assert _port_sharded(MTANMiniUnet(TASKS, **MTAN_KW), 2, 0) == \
        _jax_sharded(shapes["params"], 2, 0)
    if spec.startswith("data"):
        jm = jax_mesh.create_mesh(spec, jax.devices()[:4])
        params = jax.tree.map(jnp.asarray, variables["params"])
        params = jax.device_put(params, jax_mesh.param_shardings(jm, params, 0))
        state = _State(params, jax.tree.map(jnp.asarray, variables["batch_stats"]))
        jpreds, jmstate, jlosses = jax_predict_eval_step(jmodel, mesh=jm)(
            state, jax_mesh.put_batch(batch, jm), jax_init_metrics(NC))
        want_preds = {k: np.asarray(v) for k, v in jax.device_get(jpreds).items()}
        want_cm = np.asarray(jmstate.confmat)
        want_losses = {k: float(v) for k, v in jlosses.items()}
        want_metrics = {k: float(v) for k, v in jax_compute_metrics(jmstate).items()}
    else:
        preds, mstate, want_losses = _predict_eval_on(None, variables, batch)
        want_preds = {k: v.numpy() for k, v in preds.items()}
        want_cm = mstate.confmat.numpy()
        want_metrics = {k: float(v) for k, v in compute_metrics(mstate).items()}

    for preds, mstate, losses in on_mesh(lambda m: _predict_eval_on(m, variables, batch), spec):
        np.testing.assert_array_equal(preds["segm"].numpy(), want_preds["segm"])
        np.testing.assert_allclose(preds["depth"].numpy(), want_preds["depth"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(mstate.confmat.numpy(), want_cm)
        for k, v in losses.items():
            assert v == pytest.approx(want_losses[k], rel=1e-5), k
        for k, v in compute_metrics(mstate).items():
            assert float(v) == pytest.approx(want_metrics[k], rel=1e-5, abs=1e-7), k


# ---- one train step of each model under data:2,model:2 ----------------------------

#: model -> (global batch, H, W), as the spatial axis's tests take them
TRAIN_CASES = {"mtan": (4, 16, 16), "basic": (4, 64, 32), "csnet": (4, 64, 16),
               "mtan_fold_tasks": (4, 16, 16), "basic_fold_tail": (4, 32, 32)}
#: loss (relative), the gathered gradient (relative L2 over every leaf),
#: the running statistics (absolute, against values about 1: rows counted
#: twice would move a running variance by 0.1 var / 2n, 2e-5 for basic's
#: largest population and far more for the deep ones). The steps run in
#: f64: basic's and CSNet's last-stage BatchNorms see 2 values a channel,
#: where f32 rounding of the one-process step alone moves the gradients by
#: 2e-5 to 2e-4 relative (``data:4`` without a model axis, f32, 1.96e-5)
LOSS_RTOL, GRAD_REL_L2, STATS_ATOL = 1e-5, 1e-5, 1e-6


def _train_step(name, batch, m=None):
    model = _tiny(name, torch.float64)
    state = create_train_state(model, 1e-3, device="cpu")
    if m is not None:
        state = mesh.shard_state(state, m, min_size=0)
    block = m.block(batch) if m is not None else batch
    _, mstate, losses = make_train_step(device="cpu", mesh=m)(
        state, block, init_metrics(NC, "cpu"))
    slices = mesh.model_slices(model)
    grads = {k: (slices[k].gather(p.grad) if k in slices else p.grad)
             for k, p in model.named_parameters()}
    adam = [state.optimizer.state[p][k] for p in model.parameters()
            for k in ("exp_avg", "exp_avg_sq")]
    return (float(losses["loss"]), grads, dict(model.named_buffers()),
            {k: p.detach().clone() for k, p in model.named_parameters()}, adam,
            set(slices), mstate)


def _bits(tensors):
    return torch.cat([v.detach().reshape(-1) for v in tensors]).view(torch.int64)


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_train_step_over_data_and_model_matches_one_process(name):
    """One f64 train step under ``data:2,model:2`` (``shard_state`` at
    ``min_size=0``; each rank half the batch and half the output channels of
    every sharded leaf) against the port's one-process step on the global
    batch, with torch's unbiased running variance on: the loss, the
    gradient gathered whole, the BatchNorms' running statistics, and the
    confusion counts reduced over the replica group. Every replicated leaf
    (parameters and Adam moments) holds the same bits on all four ranks;
    each sharded leaf and its moments the same bits on the two data ranks
    of its slice, and its slices tile the one-process leaf's shape. Under
    ``fold_tasks`` the task-stacked leaves are sharded one dim further on
    and the (T, C) vectors are gathered whole; under ``fold_tail`` the
    folded block's convs compute their slices of the folded outputs."""
    n, *hw = TRAIN_CASES[name]
    rng = np.random.default_rng(13)
    batch = {"img": torch.from_numpy(rng.uniform(size=(n, *hw, 3))),
             "mask": torch.from_numpy(rng.integers(0, NC, (n, *hw)).astype(np.int32)),
             "depth": torch.from_numpy(rng.uniform(0.1, 1.0, (n, *hw, 1)))}
    blocks.set_torch_bn_running_var(True)
    try:
        want = _train_step(name, batch)


        def rank(m):
            step = _train_step(name, batch, m)
            return m.coords(), step, reduce_metrics(step[6], m.replica_comm)

        got = on_mesh(rank, "data:2,model:2")
    finally:
        blocks.set_torch_bn_running_var(False)
    flat_want = torch.cat([g.reshape(-1) for g in want[1].values()])
    want_metrics = {k: float(v) for k, v in compute_metrics(want[6]).items()}
    for coords, (loss, grads, buffers, params, adam, sliced, _), mstate in got:
        assert sliced, "nothing was sharded"
        assert loss == pytest.approx(want[0], rel=LOSS_RTOL)
        flat = torch.cat([grads[k].reshape(-1) for k in want[1]])
        assert float((flat - flat_want).norm() / flat_want.norm()) <= GRAD_REL_L2
        for k, v in want[2].items():
            err = float((buffers[k].float() - v.float()).abs().max())
            assert err <= STATS_ATOL, (k, err)
        assert float(mstate.confmat.sum()) == float(want[6].confmat.sum()) == n * hw[0] * hw[1]
        for k, v in compute_metrics(mstate).items():
            assert float(v) == pytest.approx(want_metrics[k], rel=LOSS_RTOL, abs=1e-7), k
        for k in sliced:
            assert params[k].shape[0] * 2 == want[3][k].shape[0] or \
                params[k].shape[1] * 2 == want[3][k].shape[1] or \
                params[k].shape[-1] * 2 == want[3][k].shape[-1], k
    replicated = [k for k in want[3] if k not in got[0][1][5]]
    ref = {k: got[0][1][3][k] for k in replicated}
    names = list(want[3])
    for coords, (_, _, _, params, adam, sliced, _), _ in got:
        assert torch.equal(_bits(params[k] for k in replicated), _bits(ref.values()))
        rep_adam = [a for i, a in enumerate(adam) if names[i // 2] not in sliced]
        assert torch.equal(_bits(rep_adam), _bits(
            a for i, a in enumerate(got[0][1][4]) if names[i // 2] not in sliced))
    by_slice: t.Dict[int, t.List[t.Any]] = {}
    for coords, step, _ in got:
        by_slice.setdefault(coords["model"], []).append(step)
    for first, second in by_slice.values():
        shard = [k for k in names if k in first[5]]
        assert torch.equal(_bits(first[3][k] for k in shard), _bits(second[3][k] for k in shard))
        assert torch.equal(_bits(a for i, a in enumerate(first[4]) if names[i // 2] in first[5]),
                           _bits(a for i, a in enumerate(second[4])
                                 if names[i // 2] in second[5]))


# ---- the three axes at once ---------------------------------------------------------

#: f64: loss (relative), the gathered gradient (relative L2 over every
#: leaf), the running statistics (absolute, torch's n/(n-1) on)
THREE_AXES_LOSS_RTOL, THREE_AXES_GRAD_REL_L2, THREE_AXES_STATS_ATOL = 1e-12, 1e-10, 1e-12


def _members(comm, rank):
    """The global ranks of ``comm`` in its order (``[rank]`` for None)."""
    if comm is None:
        return [rank]
    return [v - 1 for v in comm.host_all_reduce(
        [rank + 1 if i == comm.rank else 0 for i in range(comm.world)], "sum")]


def _three_axes_step(batch, m=None):
    model = _tiny("mtan", torch.float64)
    state = create_train_state(model, 1e-3, device="cpu")
    if m is not None:
        state = mesh.shard_state(state, m, min_size=0)
    block = m.block(batch) if m is not None else batch
    _, _, losses = make_train_step(device="cpu", mesh=m)(state, block, init_metrics(NC, "cpu"))
    slices = mesh.model_slices(model)
    grads = torch.cat([(slices[k].gather(p.grad) if k in slices else p.grad).reshape(-1)
                       for k, p in model.named_parameters()])
    weights = torch.cat([v.reshape(-1) for v in mesh.full_state_dict(model).values()])
    groups = None
    if m is not None:
        groups = {"coords": m.coords(), **{
            axis: _members(getattr(m, f"{axis}_comm"), m.rank)
            for axis in ("data", "spatial", "model", "replica")}}
    return (float(losses["loss"]), grads, dict(model.named_buffers()), weights, len(slices),
            groups)


def test_three_axes_at_once_match_one_process():
    """Tiny MTAN under ``data:2,spatial:2,model:2``: eight thread ranks,
    each two of the batch's four images, half their rows (8 of 16: every
    level splits) and half the output channels of every leaf that
    ``shard_state(min_size=0)`` shards. One f64 train step against the
    port's one-process step with torch's unbiased running variance on: the
    loss, the gradient gathered whole, the running statistics, and every
    rank's weights gathered whole, bit for bit. Each rank's groups hold the
    ranks of JAX's ``create_mesh("data:2,spatial:2,model:2")`` device array
    along their axes, in its order: ``spatial_comm`` and ``model_comm`` one
    axis each, ``data_comm`` the data axis, ``replica_comm`` the data and
    spatial axes (row-major)."""
    spec = "data:2,spatial:2,model:2"
    rng = np.random.default_rng(13)
    n, h, w = 4, 16, 16
    batch = {"img": torch.from_numpy(rng.uniform(size=(n, h, w, 3))),
             "mask": torch.from_numpy(rng.integers(0, NC, (n, h, w)).astype(np.int32)),
             "depth": torch.from_numpy(rng.uniform(0.1, 1.0, (n, h, w, 1)))}
    blocks.set_torch_bn_running_var(True)
    try:
        want = _three_axes_step(batch)
        got = on_mesh(lambda m: _three_axes_step(batch, m), spec)
    finally:
        blocks.set_torch_bn_running_var(False)
    devices = jax.devices()[:8]
    ids = np.vectorize(devices.index, otypes=[int])(
        jax_mesh.create_mesh(spec, devices).devices)
    assert ids.shape == (2, 2, 2)
    for r, (loss, grads, stats, weights, n_sliced, groups) in enumerate(got):
        assert n_sliced > 0
        assert loss == pytest.approx(want[0], rel=THREE_AXES_LOSS_RTOL)
        assert float((grads - want[1]).norm() / want[1].norm()) <= THREE_AXES_GRAD_REL_L2
        for k, v in want[2].items():
            assert float((stats[k] - v).abs().max()) <= THREE_AXES_STATS_ATOL, k
        assert torch.equal(weights.view(torch.int64), got[0][3].view(torch.int64))
        (d, s, m_), = np.argwhere(ids == r)
        assert groups["coords"] == {"data": d, "spatial": s, "model": m_}
        assert groups["data"] == ids[:, s, m_].tolist()
        assert groups["spatial"] == ids[d, :, m_].tolist()
        assert groups["model"] == ids[d, s, :].tolist()
        assert groups["replica"] == ids[:, :, m_].reshape(-1).tolist()


# ---- checkpoints -------------------------------------------------------------------


def _mtan_state(m=None, min_size=0, dtype=torch.float32):
    state = create_train_state(_tiny("mtan", dtype), 1e-3, device="cpu")
    return mesh.shard_state(state, m, min_size) if m is not None else state


#: the directories of an epoch checkpoint and of a preemption's
SAVES = {"epoch": ("model_0", "session_0"), "preempt": ("preempt_model", "preempt_session")}


def _saved(run_dir, kind):
    model_dir, session_dir = SAVES[kind]
    return (torch.load(os.path.join(run_dir, model_dir, checkpoint.MODEL_FILE)),
            torch.load(os.path.join(run_dir, session_dir, checkpoint.SESSION_FILE)))


def _same_tree(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert a == b


def test_checkpoints_under_the_model_axis_are_one_process_checkpoints(tmp_path):
    """A state after one Adam step, saved in one process; each rank of
    ``data:2,model:2`` shards a copy of it (its moments cut) and saves it
    again, epoch and preemption checkpoints: every file holds the
    one-process save's keys, shapes and bits. Restored back into a state already sharded under ``model:2``
    (the leaves and moments cut on load) each rank holds its slices of the
    one-process tensors, and the mesh's save restores into one process as
    the one-process save does."""
    rng = np.random.default_rng(4)
    batch = {"img": torch.from_numpy(rng.uniform(size=(4, 16, 16, 3)).astype(np.float32)),
             "mask": torch.from_numpy(rng.integers(0, NC, (4, 16, 16)).astype(np.int32)),
             "depth": torch.from_numpy(rng.uniform(0.1, 1, (4, 16, 16, 1)).astype(np.float32))}
    state = _mtan_state()
    make_train_step(device="cpu")(state, batch, init_metrics(NC, "cpu"))
    sched = ReduceLROnPlateau(patience=2, factor=0.9)
    one = str(tmp_path / "one")
    checkpoint.save_ckpt(state, sched, 0, one)
    mstate = init_metrics(NC, "cpu")
    checkpoint.save_preempt_ckpt(state, sched, 0, 1, mstate, 0, one)
    want = {kind: _saved(one, kind) for kind in SAVES}

    def rank(m):
        mine = str(tmp_path / f"rank{m.rank}")
        restored = mesh.shard_state(copy.deepcopy(state), m, 0)
        checkpoint.save_ckpt(restored, sched, 0, mine)
        checkpoint.save_preempt_ckpt(restored, sched, 0, 1, mstate, 0, mine)
        back, _, _ = checkpoint.restore_session(_mtan_state(m), ReduceLROnPlateau(), one)
        slices = mesh.model_slices(back.model)
        params = dict(back.model.named_parameters())
        cut = {k: slices[k].of(v) if k in slices else v
               for k, v in state.model.state_dict().items()}
        for k, v in back.model.state_dict().items():
            assert torch.equal(v, cut[k]), k
        for i, (k, p) in enumerate(params.items()):
            for field in ("exp_avg", "exp_avg_sq"):
                whole = state.optimizer.state[dict(state.model.named_parameters())[k]][field]
                assert torch.equal(back.optimizer.state[p][field],
                                   slices[k].of(whole) if k in slices else whole), (k, field)
        return mine, len(slices)

    for mine, n_sliced in on_mesh(rank, "data:2,model:2"):
        assert n_sliced > 0
        for kind in SAVES:
            _same_tree(_saved(mine, kind), want[kind])
    back = _mtan_state()
    checkpoint.restore_session(back, ReduceLROnPlateau(), str(tmp_path / "rank3"))
    _same_tree(back.model.state_dict(), state.model.state_dict())
    _same_tree(back.optimizer.state_dict(), state.optimizer.state_dict())


# ---- the epoch loop, the predict sweep and serving, in process ----------------------

#: the epoch's and the sweep's metrics (relative) and predicted depths
#: (absolute) against one process. f64: in f32 Adam's first steps move a
#: weight whose gradient is at rounding level (a bias before a BatchNorm)
#: by about lr either way, so the sums' order alone would show after them
LOOP_RTOL, LOOP_DEPTH_ATOL = 1e-6, 1e-7
LOOP_ARGS = argparse.Namespace(
    loss_segm_weight=1.0, loss_depth_weight=1.0, val_epoch_freq=1, save_epoch_freq=10,
    do_plot_preds=False, do_show_preds=False, grad_accum_steps=1, keep_ckpt_last_k=0,
)


def test_run_pipe_predict_and_serving_over_the_model_axis_match_one_process(monkeypatch):
    """Under ``data:1,model:2`` (the state sharded at ``min_size=0`` before
    ``run_pipe``, which places it again and changes nothing): one epoch of
    ``run_pipe`` (2 train steps, a padded val batch; the loaders in the
    full-batch mode) and the predict sweep. Both ranks' weights, gathered
    whole, hold the same bits; against one process the train epoch's
    metrics, the val and sweep metrics after the Adam steps and the sweep's
    predictions within ``LOOP_*`` (f64). Then a f32
    ``Predictor`` and a ``BatchingServer(mesh=)`` of a sharded eval model
    answer whole on both ranks as one process's do (ids exactly, depth
    within 1e-6)."""
    from vision_mtl_tpu_torch.data import datamodule, synthetic
    from vision_mtl_tpu_torch.predict import predict
    from vision_mtl_tpu_torch.serving import BatchingServer, Predictor
    from vision_mtl_tpu_torch.train.loop import run_pipe

    for k, v in dict(height=16, width=16, num_classes=NC, num_train=10, num_val=3).items():
        monkeypatch.setattr(synthetic.synthetic_data_cfg, k, v)
    imgs = np.random.default_rng(6).uniform(size=(3, 16, 8, 3)).astype(np.float32)

    def run(m=None):
        state = _mtan_state(m, dtype=torch.float64)
        dm = datamodule.MTLDataModule("synthetic", batch_size=4, seed=11)
        dm.setup()
        state, epochs = run_pipe(LOOP_ARGS, state, dm, num_epochs=1, num_classes=NC,
                                 device="cpu", mesh=m)
        preds, metrics_ = predict(dm.predict_dataloader(), state.model, NC, device="cpu", mesh=m)
        weights = torch.cat([v.reshape(-1) for v in mesh.full_state_dict(state.model).values()])
        model = _tiny("mtan").eval()
        if m is not None:
            mesh.shard_model(model, m, 0)
        served = Predictor(model, 4, 16, 8, device="cpu", mesh=m)(imgs)
        if m is None:
            return weights, epochs, preds, metrics_, served, None
        server = BatchingServer(model, 16, 8, buckets=(2, 4), max_wait_ms=50.0, mesh=m)
        if m.rank == 0:
            futures = [server.submit(img) for img in imgs]
            answers = [f.result(timeout=60) for f in futures]
            server.close()
        else:
            server.follow()
            answers = None
        return weights, epochs, preds, metrics_, served, answers

    want = run()
    got = on_mesh(run, "data:1,model:2")
    for weights, epochs, preds, metrics_, served, _ in got:
        assert torch.equal(weights.view(torch.int64), got[0][0].view(torch.int64))
        for stage in ("train", "val"):
            for key, values in want[1][stage].items():
                assert epochs[stage][key] == pytest.approx(values, rel=LOOP_RTOL, abs=1e-9), key
        assert [p["segm"].shape for p in preds] == [p["segm"].shape for p in want[2]]
        for p, w in zip(preds, want[2]):
            np.testing.assert_array_equal(p["segm"], w["segm"])
            np.testing.assert_allclose(p["depth"], w["depth"], rtol=0, atol=LOOP_DEPTH_ATOL)
        assert metrics_ == pytest.approx(want[3], rel=LOOP_RTOL, abs=1e-9)
        np.testing.assert_array_equal(served["segm"], want[4]["segm"])
        np.testing.assert_allclose(served["depth"], want[4]["depth"], rtol=0, atol=1e-6)
    for i, answer in enumerate(got[0][5]):
        np.testing.assert_array_equal(answer["segm"], want[4]["segm"][i])
        np.testing.assert_allclose(answer["depth"], want[4]["depth"][i], rtol=0, atol=1e-6)


# ---- the model options: fold_tasks and fold_tail ----------------------------------

#: option -> leaves JAX shards at Cityscapes' full width under model:2
FOLDED_FULL_WIDTH = {"mtan_fold_tasks": 29, "basic_fold_tail": 21}


@pytest.mark.parametrize("name", list(FOLDED_FULL_WIDTH))
def test_folded_options_are_placed_as_jax_places_them(name):
    """``fold_tasks`` (MTAN) and ``fold_tail`` (basic) under the model axis:
    at Cityscapes' full width the port shards exactly the leaves that JAX's
    ``param_shardings`` shards in JAX's own tree of the option
    (``jax.eval_shape`` of its registry's model; 29 and 21 leaves at
    ``model:2``); at the tests' tiny width with ``min_size=0``, at
    ``model:2`` and ``model:4``, as JAX shards the bridge's tree (the
    task-stacked (T, C) vectors and the folded block's kernels too); and
    ``shard_model`` cuts each of them on that dim."""
    model_name, _, option = name.partition("_")
    args = argparse.Namespace(model_name=model_name, **{option: True})
    jmodel = jax_build_model(args, jax_data_cfg("cityscapes"), dtype=jnp.float32)
    # the leaves' shapes do not depend on the image's: trace a small one
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                                train=False))
    model = build_model(model_name, fetch_data_cfg("cityscapes"), dtype=torch.float32,
                        device="cpu", **{option: True})
    want = _jax_sharded(shapes["params"], 2)
    assert _port_sharded(model, 2) == want and len(want) == FOLDED_FULL_WIDTH[name]
    tiny = _tiny(name)
    params = jax_variables_from_model(tiny)["params"]
    for size in (2, 4):
        assert _port_sharded(tiny, size, 0) == _jax_sharded(params, size, 0), size
    layout = mesh.param_shardings(tiny, mesh.Mesh({"model": 2}, multihost.Comm(0, 2)), 0)
    whole = {k: tuple(p.shape) for k, p in tiny.named_parameters()}
    mesh.shard_model(tiny, mesh.Mesh({"model": 2}, multihost.Comm(1, 2)), 0)
    slices = mesh.model_slices(tiny)
    assert {k for k, d in layout.items() if d is not None} == set(slices)
    for k, sl in slices.items():
        assert sl.dim == layout[k] and sl.shape == whole[k]
        assert tiny.get_parameter(k).shape[sl.dim] * 2 == whole[k][sl.dim]


def _folded_state(name, m=None):
    state = create_train_state(_tiny(name), 1e-3, device="cpu")
    return mesh.shard_state(state, m, 0) if m is not None else state


@pytest.mark.parametrize("name", list(FOLDED_FULL_WIDTH))
def test_folded_checkpoints_and_serving_under_the_model_axis(name, tmp_path):
    """A folded state after one Adam step, sharded under ``data:1,model:2``
    (``min_size=0``): each rank's epoch checkpoint is the one-process
    folded checkpoint bit for bit, and restores into one process; a sharded
    eval copy answers through ``Predictor(mesh=)`` as one process's does
    (ids exactly, depth within 1e-6). For ``fold_tasks`` an unfolded
    model's weights, converted by ``fold_task_state_dict``, restore into
    the sharded folded model as its slices, and gather back whole."""
    from vision_mtl_tpu_torch.serving import Predictor

    n, h, w = TRAIN_CASES[name]
    rng = np.random.default_rng(4)
    batch = {"img": torch.from_numpy(rng.uniform(size=(n, h, w, 3)).astype(np.float32)),
             "mask": torch.from_numpy(rng.integers(0, NC, (n, h, w)).astype(np.int32)),
             "depth": torch.from_numpy(rng.uniform(0.1, 1, (n, h, w, 1)).astype(np.float32))}
    state = _folded_state(name)
    make_train_step(device="cpu")(state, batch, init_metrics(NC, "cpu"))
    sched = ReduceLROnPlateau(patience=2, factor=0.9)
    one = str(tmp_path / "one")
    checkpoint.save_ckpt(state, sched, 0, one)
    want = _saved(one, "epoch")
    imgs = batch["img"][:3].numpy()
    served = Predictor(copy.deepcopy(state.model).eval(), 4, h, w, device="cpu")(imgs)
    unfolded = _tiny(name.partition("_")[0]) if name == "mtan_fold_tasks" else None

    def rank(m):
        mine = str(tmp_path / f"rank{m.rank}")
        sharded = mesh.shard_state(copy.deepcopy(state), m, 0)
        checkpoint.save_ckpt(sharded, sched, 0, mine)
        got = Predictor(copy.deepcopy(sharded.model).eval(), 4, h, w, mesh=m)(imgs)
        converted = None
        if unfolded is not None:
            mesh.load_full_state_dict(sharded.model, fold_task_state_dict(
                unfolded.state_dict(), len(TASKS)))
            converted = mesh.full_state_dict(sharded.model)
        return mine, len(mesh.model_slices(sharded.model)), got, converted

    for mine, n_sliced, got, converted in on_mesh(rank, "data:1,model:2"):
        assert n_sliced > 0
        _same_tree(_saved(mine, "epoch"), want)
        np.testing.assert_array_equal(got["segm"], served["segm"])
        np.testing.assert_allclose(got["depth"], served["depth"], rtol=0, atol=1e-6)
        if converted is not None:
            _same_tree(converted, fold_task_state_dict(unfolded.state_dict(), len(TASKS)))
    back = _folded_state(name)
    checkpoint.restore_session(back, ReduceLROnPlateau(), str(tmp_path / "rank1"))
    _same_tree(back.model.state_dict(), state.model.state_dict())
    _same_tree(back.optimizer.state_dict(), state.optimizer.state_dict())


def test_mtan_fold_tasks_predict_eval_under_the_model_axis_matches_jax():
    """MTAN ``fold_tasks``' predict-eval step under ``data:2,model:2`` with
    every leaf that JAX's rule shards at ``min_size=0`` sharded, against
    JAX's ``fold_tasks`` step under ``create_mesh("data:2,model:2")`` with
    its parameters placed by JAX's ``param_shardings(min_size=0)``, on
    JAX's own ``eval_shape`` tree: the layout JAX's, predictions whole on
    every rank (depth within 1e-5, ids equal), the confusion counts exact,
    losses and metrics within 1e-5 relative."""
    rng = np.random.default_rng(12)
    batch = _eval_batch(rng)
    jmodel = JaxMTAN(map_tasks_to_num_channels=TASKS, dtype=jnp.float32, fold_tasks=True,
                     **MTAN_KW)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.asarray(batch["img"]),
                                                train=False))
    variables = {coll: _fill(tree, rng, coll) for coll, tree in shapes.items()}
    assert _port_sharded(_tiny("mtan_fold_tasks"), 2, 0) == _jax_sharded(shapes["params"], 2, 0)
    jm = jax_mesh.create_mesh("data:2,model:2", jax.devices()[:4])
    params = jax.tree.map(jnp.asarray, variables["params"])
    params = jax.device_put(params, jax_mesh.param_shardings(jm, params, 0))
    state = _State(params, jax.tree.map(jnp.asarray, variables["batch_stats"]))
    jpreds, jmstate, jlosses = jax_predict_eval_step(jmodel, mesh=jm)(
        state, jax_mesh.put_batch(batch, jm), jax_init_metrics(NC))
    want_preds = {k: np.asarray(v) for k, v in jax.device_get(jpreds).items()}
    want_metrics = {k: float(v) for k, v in jax_compute_metrics(jmstate).items()}
    got = on_mesh(lambda m: _predict_eval_on(m, variables, batch, fold_tasks=True),
                  "data:2,model:2")
    for preds, mstate, losses in got:
        np.testing.assert_array_equal(preds["segm"].numpy(), want_preds["segm"])
        np.testing.assert_allclose(preds["depth"].numpy(), want_preds["depth"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(mstate.confmat.numpy(), np.asarray(jmstate.confmat))
        for k, v in losses.items():
            assert v == pytest.approx(float(jlosses[k]), rel=1e-5), k
        for k, v in compute_metrics(mstate).items():
            assert float(v) == pytest.approx(want_metrics[k], rel=1e-5, abs=1e-7), k
