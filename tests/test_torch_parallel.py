"""The port's data-parallel layer in one process, against the JAX package
where it has a counterpart: ``parse_mesh_shape`` and
``process_index_range`` (same dicts, same error texts), the loaders' row
slices and ``valid`` under two ranks (``_process_shard`` monkeypatched on
both packages' ``DataLoader``, as ``tests/test_multihost.py`` does), the
launcher-environment contract of ``maybe_initialize_distributed``, the
CLI's refusals, and, through an in-process group of two threads
(``ThreadComm``), ``all_processes_agree``, the logger's run-dir
rendezvous, the global BatchNorm, kernel B4's plain split, the global
losses and ``reduce_metrics`` against the one-process results on the
concatenated rows. Nothing here compiles through JAX."""

import threading

import numpy as np
import pytest
import torch

from vision_mtl_tpu.data import loader as jax_loader
from vision_mtl_tpu.data.synthetic import SyntheticMTLDataset as JaxSynthetic
from vision_mtl_tpu.parallel import mesh as jax_mesh
from vision_mtl_tpu.parallel import multihost as jax_multihost
from vision_mtl_tpu_torch import training
from vision_mtl_tpu_torch.data import loader
from vision_mtl_tpu_torch.data.datamodule import configure_host_sharded_loading
from vision_mtl_tpu_torch.data.synthetic import SyntheticMTLDataset
from vision_mtl_tpu_torch.kernels import fused_gate_train
from vision_mtl_tpu_torch.losses import mtl_loss
from vision_mtl_tpu_torch.metrics import (
    compute_metrics,
    init_metrics,
    reduce_metrics,
    update_metrics,
)
from vision_mtl_tpu_torch.models import blocks
from vision_mtl_tpu_torch.parallel import mesh, multihost
from vision_mtl_tpu_torch.parallel.multihost import ThreadComm, ThreadGroup, global_batch
from vision_mtl_tpu_torch.tracking.logger import MetricsLogger, publish_logger_failure


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def on_ranks(fn, world=2):
    """``fn(comm)`` on ``world`` threads, each a rank of one ThreadGroup;
    the results (or exceptions) in rank order."""
    group = ThreadGroup(world, timeout=30.0)
    out = [None] * world

    def run(r):
        try:
            out[r] = fn(ThreadComm(group, r))
        except BaseException as e:  # handed to the caller
            out[r] = e

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return out


MESH_SPECS = [
    ("data:-1", 1), ("data:-1", 2), ("data:-1", 8), ("data:2", 2), ("data:2,model:2", 4),
    ("data:4,spatial:2", 8), ("data:-1,model:2", 8), ("spatial:2,data:-1", 4),
    ("foo:2", 2), ("data:2,data:2", 4), ("data:-1,model:-1", 4), ("data:-1,model:3", 8),
    ("data:2", 4), ("data", 2),
]


@pytest.mark.parametrize("spec,n", MESH_SPECS)
def test_parse_mesh_shape_matches_jax(spec, n):
    """The same dicts, and the same ValueError texts, for the same spec and
    count (the world size in the port, the device count in JAX)."""
    try:
        want = jax_mesh.parse_mesh_shape(spec, n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.parse_mesh_shape(spec, n)
        assert str(got.value) == str(e)
    else:
        assert mesh.parse_mesh_shape(spec, n) == want
    assert mesh.MESH_AXES == jax_mesh.MESH_AXES


def test_unported_axes_are_refused_naming_a10b():
    """``model`` above 1 is refused (ROADMAP A10c; ``spatial``, A10b, is
    ported); size 1 is accepted."""
    comm = multihost.Comm(0, 4)
    for spec in ("data:2,model:2", "spatial:2,model:2", "model:-1"):
        with pytest.raises(SystemExit, match=r"ROADMAP\.md A10c"):
            mesh.create_mesh(spec, comm)
    m = mesh.create_mesh("data:-1,spatial:1,model:1", comm)
    assert m.shape == {"data": 4, "spatial": 1, "model": 1}
    assert mesh.process_spanning_axes(m) == ("data",)
    assert mesh.process_spanning_axes(mesh.create_mesh("data:1", multihost.Comm(0, 1))) == ()
    # row-sliced loading needs data to be the one axis across processes;
    # spatial takes the full-batch mode, model neither
    configure_host_sharded_loading(None, m)
    with pytest.raises(ValueError, match="model.*A10c"):
        configure_host_sharded_loading(None, mesh.Mesh({"data": 2, "model": 2}, comm))


def test_process_index_range_matches_jax():
    for n, pc in ((103, 4), (8, 2), (5, 3), (0, 2)):
        for pi in range(pc):
            assert multihost.process_index_range(n, pi, pc) == \
                jax_multihost.process_index_range(n, pi, pc)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_loader_row_slices_match_jax(monkeypatch, mode):
    """Under two ranks each loader yields its rank's contiguous half of
    every global batch, with JAX's row slices and ``valid``: train batches
    drop the ragged last batch, eval batches pad the global batch with its
    last sample."""
    kw = (dict(shuffle=True, seed=3, drop_last=True) if mode == "train"
          else dict(pad_last=True))
    jds, pds = JaxSynthetic(stage="train"), SyntheticMTLDataset(stage="train")
    jds.length = pds.length = 11
    full = list(loader.DataLoader(pds, batch_size=4, **kw))
    for rank in (0, 1):
        monkeypatch.setattr(jax_loader.DataLoader, "_process_shard",
                            staticmethod(lambda r=rank: (r, 2)))
        monkeypatch.setattr(loader.DataLoader, "_process_shard",
                            staticmethod(lambda r=rank: (r, 2)))
        want = list(jax_loader.DataLoader(jds, batch_size=4, **kw))
        got = list(loader.DataLoader(pds, batch_size=4, **kw))
        assert len(got) == len(want) == (2 if mode == "train" else 3)
        for g, w, f in zip(got, want, full):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g["img"].shape[0] == 2
            np.testing.assert_array_equal(g["img"], f["img"][2 * rank:2 * rank + 2])
    monkeypatch.setattr(loader.DataLoader, "_process_shard", staticmethod(lambda: (0, 2)))
    with pytest.raises(ValueError, match="must divide"):
        next(iter(loader.DataLoader(pds, batch_size=3, drop_last=True)))


LAUNCH = {"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "h0",
          "MASTER_PORT": "1234"}


def test_launcher_environment_contract(monkeypatch):
    """``maybe_initialize_distributed`` (a) is a no-op without launch
    markers, (b) joins with torchrun's values (gloo on the CPU), (c) raises
    on a partial environment and (d) on non-integers, (e) raises when the
    init fails: no fallback to one process."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(multihost, "_COMM", None)
    monkeypatch.setattr(multihost, "_OWNS_GROUP", False)
    for var in (*LAUNCH, "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)

    assert multihost.maybe_initialize_distributed("cpu") is False  # (a)
    assert calls == [] and multihost.current() is None

    for var, value in LAUNCH.items():
        monkeypatch.setenv(var, value)
    assert multihost.maybe_initialize_distributed("cpu") is True  # (b)
    (args, kw), = calls
    assert args == ("gloo",) and kw["init_method"] == "tcp://h0:1234"
    assert (kw["rank"], kw["world_size"]) == (1, 4)
    assert multihost.process_info() == (1, 4) and multihost.current().device.type == "cpu"
    monkeypatch.setattr(multihost, "_COMM", None)

    monkeypatch.delenv("MASTER_PORT")  # (c)
    with pytest.raises(RuntimeError, match="MASTER_PORT not set"):
        multihost.maybe_initialize_distributed("cpu")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4n")  # (d)
    with pytest.raises(RuntimeError, match="not integers"):
        multihost.maybe_initialize_distributed("cpu")
    monkeypatch.setenv("WORLD_SIZE", "4")

    def broken(*a, **kw):
        raise ValueError("no rendezvous")

    monkeypatch.setattr(torch.distributed, "init_process_group", broken)  # (e)
    with pytest.raises(RuntimeError, match="init_process_group.*no rendezvous"):
        multihost.maybe_initialize_distributed("cpu")
    assert multihost.current() is None


def test_backend_choice(monkeypatch):
    """NCCL when every rank on the host has a card of its own; gloo on the
    CPU and when ranks share a card."""
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert multihost.pick_backend(cuda, 2) == "gloo"
    assert multihost.pick_backend(cuda, 1) == "nccl"
    assert multihost.pick_backend(torch.device("cpu"), 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert multihost.pick_backend(cuda, 4) == "nccl"
    assert multihost.rank_device("cuda", 6) == torch.device("cuda", 2)


def test_all_processes_agree_over_ranks():
    """A MIN over the ranks; a rank that calls out of step raises."""
    assert on_ranks(lambda c: multihost.all_processes_agree(True, "x", c)) == [True, True]
    assert on_ranks(lambda c: multihost.all_processes_agree(c.rank == 0, "x", c)) == \
        [False, False]
    out = on_ranks(lambda c: multihost.all_processes_agree(True, f"what{c.rank}", c))
    assert all(isinstance(e, RuntimeError) and "out of step" in str(e) for e in out)
    assert multihost.all_processes_agree(False, "x", None) is False


def test_logger_rendezvous_over_ranks(tmp_path, monkeypatch):
    """Every rank gets rank 0's run dir, only rank 0 writes metrics; a tag
    mismatch raises; rank 0's published failure reaches the waiting rank."""
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)

    def make(c, tag="main"):
        return MetricsLogger(str(tmp_path), "training-x", rendezvous_tag=tag, comm=c)

    loggers = on_ranks(make)
    assert loggers[0].log_dir == loggers[1].log_dir == str(tmp_path / "training-x" / "version_0")
    for lg in loggers:
        lg.log_metrics({"a": 1.0}, step=0)
        lg.close()
    assert open(tmp_path / "training-x" / "version_0" / "metrics.jsonl").read().count("\n") == 1

    out = on_ranks(lambda c: make(c, tag=f"trial_{c.rank}"))
    assert isinstance(out[1], RuntimeError) and "desync" in str(out[1])

    def fail_on_rank0(c):
        if c.rank == 0:
            publish_logger_failure("comet said no", c)
            return None
        return make(c)

    out = on_ranks(fail_on_rank0)
    assert isinstance(out[1], RuntimeError) and "comet said no" in str(out[1])


def test_cli_refuses_unported_mesh_and_odd_batch(monkeypatch):
    """Under ``--device cpu:2`` the launcher checks the mesh and the batch
    before it starts a rank: the model axis names ROADMAP A10c, an odd
    batch gets JAX's message."""
    monkeypatch.setattr(multihost, "launch_local_ranks", None)  # no rank may start
    argv = ["--device", "cpu:2", "--dataset_name", "synthetic"]
    with pytest.raises(SystemExit, match=r"model axis .*ROADMAP\.md A10c"):
        training.main(argv + ["--mesh_shape", "data:2,model:2"])
    with pytest.raises(SystemExit) as e:
        training.main(argv + ["--batch_size", "3"])
    assert str(e.value) == ("--batch_size 3 must be divisible by the mesh data axis (2); "
                            "pick a multiple or adjust --mesh_shape.")


def _bn_case():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 3, 5, 6, generator=g, dtype=torch.float64) * 2 + 1
    w = torch.rand(6, generator=g, dtype=torch.float64) + 0.5
    b = torch.randn(6, generator=g, dtype=torch.float64)
    cot = torch.randn(4, 3, 5, 6, generator=g, dtype=torch.float64)
    return x, w, b, cot


def _bn(x, w, b, cot, comm=None):
    x, w, b = (v.clone().requires_grad_() for v in (x, w, b))
    rm, rv = torch.zeros(6, dtype=torch.float64), torch.ones(6, dtype=torch.float64)
    with global_batch(comm):
        y = blocks.batch_norm_nhwc(x, w, b, rm, rv, 1e-5, True)
    y.backward(cot)
    return y.detach(), x.grad, w.grad, b.grad, rm, rv


@pytest.mark.parametrize("torch_var", [False, True])
def test_global_batchnorm_over_two_ranks(torch_var):
    """Two ranks' rows through the global BatchNorm equal one process's
    BatchNorm on all the rows (f64, within 1e-12): the output, x's
    gradient, the summed weight and bias gradients and the running
    statistics, whose n/(n-1) under the switch counts every rank's rows."""
    x, w, b, cot = _bn_case()
    prev = blocks.torch_bn_running_var()
    blocks.set_torch_bn_running_var(torch_var)
    try:
        want = _bn(x, w, b, cot)
        got = on_ranks(lambda c: _bn(x[2 * c.rank:2 * c.rank + 2], w, b,
                                     cot[2 * c.rank:2 * c.rank + 2], c))
    finally:
        blocks.set_torch_bn_running_var(prev)
    assert not any(isinstance(r, BaseException) for r in got), got
    tol = dict(rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(torch.cat([got[0][0], got[1][0]]), want[0], **tol)
    torch.testing.assert_close(torch.cat([got[0][1], got[1][1]]), want[1], **tol)
    for i in (2, 3):  # the step sums the ranks' parameter gradients
        torch.testing.assert_close(got[0][i] + got[1][i], want[i], **tol)
    for i in (4, 5):
        torch.testing.assert_close(got[0][i], want[i], **tol)
        assert torch.equal(got[0][i], got[1][i])


def _gate_case(n_tasks=None):
    g = torch.Generator().manual_seed(1)

    def r(*shape, scale=1.0):
        lead = (n_tasks,) if n_tasks else ()
        return torch.randn(*lead, *shape, generator=g, dtype=torch.float64) * scale

    x = torch.randn(*((n_tasks,) if n_tasks else ()), 4, 3, 5, 6, generator=g,
                    dtype=torch.float64)
    shared = torch.randn(4, 3, 5, 8, generator=g, dtype=torch.float64)
    weights = (r(6, 8, scale=0.4), r(8, scale=0.1), r(8).abs() + 0.5, r(8, scale=0.2),
               r(8, 8, scale=0.35), r(8, scale=0.1), r(8).abs() + 0.5, r(8, scale=0.2))
    cot = torch.randn(*((n_tasks,) if n_tasks else ()), 4, 3, 5, 8, generator=g,
                      dtype=torch.float64)
    return x, shared, weights, cot


def _gate(x, shared, weights, cot, comm=None):
    leaves = [v.clone().requires_grad_() for v in (x, shared, *weights)]
    fn = (fused_gate_train.fused_attention_gate_train_tasks if x.dim() == 5
          else fused_gate_train.fused_attention_gate_train)
    out, *stats = fn(*leaves, comm=comm)
    out.backward(cot)
    return out.detach(), stats, [v.grad for v in leaves]


@pytest.mark.parametrize("n_tasks", [None, 2])
def test_gate_train_plain_split_over_two_ranks(n_tasks):
    """B4's plain version under two ranks (its kernel's staged call's
    function) against one process on all the rows, one task and a task axis
    of 2: output rows and x's and shared's gradient rows, the statistics
    (the same on both ranks), the summed weight gradients; f64, within
    1e-10 (the statistics combine f64 partials in another order)."""
    x, shared, weights, cot = _gate_case(n_tasks)
    want = _gate(x, shared, weights, cot)

    def rank(c):
        rows = slice(2 * c.rank, 2 * c.rank + 2)
        xs = x[:, rows] if n_tasks else x[rows]
        cs = cot[:, rows] if n_tasks else cot[rows]
        return _gate(xs, shared[rows], weights, cs, c)

    got = on_ranks(rank)
    assert not any(isinstance(r, BaseException) for r in got), got
    tol = dict(rtol=1e-10, atol=1e-10)
    dim = 1 if n_tasks else 0
    torch.testing.assert_close(torch.cat([got[0][0], got[1][0]], dim), want[0], **tol)
    for a, b, w in zip(got[0][1], got[1][1], want[1]):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, w, **tol)
    torch.testing.assert_close(torch.cat([got[0][2][0], got[1][2][0]], dim), want[2][0], **tol)
    torch.testing.assert_close(torch.cat([got[0][2][1], got[1][2][1]]), want[2][1], **tol)
    for a, b, w in zip(got[0][2][2:], got[1][2][2:], want[2][2:]):
        torch.testing.assert_close(a + b, w, **tol)


def test_global_losses_and_reduced_metrics_over_two_ranks():
    """The losses of two ranks' rows with ``valid`` masks, inside
    ``global_batch``, equal one process's on all rows (f64, 1e-12), as do
    their gradients once summed with each rank back-propagating half; the
    reduced metric state holds one process's confusion counts and pixel
    counts exactly and its absolute-error sum within 1e-6 relative."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(size=(4, 3, 5, 4)))
    depth = torch.from_numpy(rng.uniform(0.05, 1.0, (4, 3, 5, 1)))
    mask = torch.from_numpy(rng.integers(0, 4, (4, 3, 5)).astype(np.int32))
    gt = torch.from_numpy(rng.uniform(0.0, 1.0, (4, 3, 5, 1)))
    valid = torch.tensor([1.0, 1.0, 1.0, 0.0], dtype=torch.float64)

    def run(rows, comm=None, share=1.0):
        lg, dp = logits[rows].clone().requires_grad_(), depth[rows].clone().requires_grad_()
        with global_batch(comm):
            losses = mtl_loss(lg, dp, mask[rows], gt[rows], 1.0, 1.0, valid=valid[rows])
        (losses["loss"] * share).backward()
        mstate = update_metrics(init_metrics(4, "cpu"), lg.argmax(-1), mask[rows], dp.detach(),
                                gt[rows], {k: v.detach() for k, v in losses.items()},
                                valid=valid[rows])
        return {k: float(v.detach()) for k, v in losses.items()}, lg.grad, dp.grad, \
            reduce_metrics(mstate, comm)

    want = run(slice(0, 4))
    got = on_ranks(lambda c: run(slice(2 * c.rank, 2 * c.rank + 2), c, share=0.5))
    assert not any(isinstance(r, BaseException) for r in got), got
    for k, v in want[0].items():
        assert got[0][0][k] == pytest.approx(v, rel=1e-12) and got[1][0][k] == got[0][0][k]
    for i in (1, 2):
        torch.testing.assert_close(torch.cat([got[0][i], got[1][i]]), want[i],
                                   rtol=1e-12, atol=1e-12)
    for r in got:
        assert torch.equal(r[3].confmat, want[3].confmat)
        assert float(r[3].mae_count) == float(want[3].mae_count)
        assert float(r[3].mae_sum) == pytest.approx(float(want[3].mae_sum), rel=1e-6)
        assert compute_metrics(r[3])["loss"] == pytest.approx(
            float(compute_metrics(want[3])["loss"]), rel=1e-6)


def test_grad_accumulation_over_two_ranks():
    """``grad_accum_steps=2`` under two ranks: microbatch i is both ranks'
    i-th local row, so the step equals one process's accumulated step on
    the global batch reordered to put those rows together (rows 0, 2 then
    1, 3): loss, gradients and running statistics within 1e-10 of each
    leaf's largest magnitude plus 1e-12 (a tiny MTAN in f64)."""
    from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet
    from vision_mtl_tpu_torch.train.state import create_train_state
    from vision_mtl_tpu_torch.train.step import make_train_step

    rng = np.random.default_rng(5)
    batch = {"img": torch.from_numpy(rng.uniform(size=(4, 8, 8, 3))),
             "mask": torch.from_numpy(rng.integers(0, 3, (4, 8, 8)).astype(np.int32)),
             "depth": torch.from_numpy(rng.uniform(0.1, 1.0, (4, 8, 8, 1)))}

    def run(rows, comm=None):
        model = MTANMiniUnet({"depth": 1, "segm": 3}, task_subnets_hidden_channels=4,
                             encoder_first_channel=4, encoder_num_channels=2,
                             dtype=torch.float64, seed=0).double()
        state = create_train_state(model, 1e-3, device="cpu")
        m = mesh.Mesh({"data": 2}, comm) if comm is not None else None
        step = make_train_step(grad_accum_steps=2, device="cpu", mesh=m)
        _, _, losses = step(state, {k: v[rows] for k, v in batch.items()}, init_metrics(3, "cpu"))
        return float(losses["loss"]), {k: p.grad.clone() for k, p in model.named_parameters()}, \
            {k: b.clone() for k, b in model.named_buffers()}

    want = run([0, 2, 1, 3])
    got = on_ranks(lambda c: run(slice(2 * c.rank, 2 * c.rank + 2), c))
    assert not any(isinstance(r, BaseException) for r in got), got
    assert got[0][0] == pytest.approx(want[0], rel=1e-12)
    top = max(float(g.abs().max()) for g in want[1].values())
    for i in (1, 2):
        for k, w in want[i].items():
            assert torch.equal(got[0][i][k], got[1][i][k]), k
            err = float((got[0][i][k] - w).abs().max())
            assert err <= 1e-10 * float(w.abs().max()) + 1e-12 * (top if i == 1 else 1.0), k


def test_predictor_and_batching_server_over_two_ranks():
    """``Predictor(mesh=)``: each rank runs its half of the padded batch
    and every rank returns the whole answer, equal to one process's (ids
    exactly, depth within 1e-6: the ranks' forwards see 2 rows, not 4).
    ``BatchingServer(mesh=)``: rank 0 takes the requests, rank 1 follows
    its batches until rank 0 closes; each answer is the one-process
    Predictor's for that image. A batch the ranks do not divide is
    refused."""
    from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet
    from vision_mtl_tpu_torch.serving import BatchingServer, Predictor

    def model():
        return MTANMiniUnet({"depth": 1, "segm": 3}, task_subnets_hidden_channels=4,
                            encoder_first_channel=4, encoder_num_channels=2,
                            dtype=torch.float32, seed=0).eval()

    imgs = np.random.default_rng(6).uniform(size=(3, 8, 8, 3)).astype(np.float32)
    want = Predictor(model(), 4, 8, 8, device="cpu")(imgs)

    def rank(c):
        m = mesh.Mesh({"data": 2}, c)
        with pytest.raises(ValueError, match="does not divide"):
            Predictor(model(), 3, 8, 8, mesh=m)
        got = Predictor(model(), 4, 8, 8, mesh=m)(imgs)
        server = BatchingServer(model(), 8, 8, buckets=(2, 4), max_wait_ms=50.0, mesh=m)
        if c.rank == 0:
            futures = [server.submit(img) for img in imgs]
            answers = [f.result(timeout=30) for f in futures]
            server.close()
        else:
            with pytest.raises(RuntimeError, match="submit requests on rank 0"):
                server.submit(imgs[0])
            server.follow()
            answers = None
        return got, answers

    out = on_ranks(rank)
    assert not any(isinstance(r, BaseException) for r in out), out
    for got, _ in out:
        np.testing.assert_array_equal(got["segm"], want["segm"])
        np.testing.assert_allclose(got["depth"], want["depth"], rtol=0, atol=1e-6)
    for i, answer in enumerate(out[0][1]):
        np.testing.assert_array_equal(answer["segm"], want["segm"][i])
        np.testing.assert_allclose(answer["depth"], want["depth"][i], rtol=0, atol=1e-6)
