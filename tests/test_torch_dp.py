"""Data parallelism over two gloo ranks on the CPU: two processes, each a
rank, started from this file's ``__main__`` block (they meet through a
``FileStore`` under the test's temporary dir, so concurrent test workers
never share a port, and are killed on a timeout). One launch of the pair
runs every step-level check and writes each rank's results to an ``.npz``,
then runs the training CLI in both ranks (below):

  * a tiny MTAN (16x24, hidden 8, 2 levels) in f64 at global batch 6, 3
    rows a rank: the loss, the all-reduced gradients and the BatchNorm and
    gate running statistics, against one jitted JAX ``value_and_grad`` on
    the global batch and against the port's one-process step;
  * the same step with ``remat_attention``, bit for bit the plain 2-rank
    step;
  * the basic model (kernel B3's plain path at decoder width 16, 32x32) and
    its ``fold_tail`` (the folded BatchNorm), one f64 step against one
    process;
  * kernel B4's plain split, forward and backward, against the one-process
    plain version on the concatenated rows;
  * two f32 MTAN steps, after which both ranks hold the same parameters and
    Adam moments, bit for bit;
  * an eval step on a padded batch, its reduced metrics against one
    process (the counts exactly);
  * ``Comm.split`` (the mesh's spatial groups) over gloo, with a halo
    exchange across the pair.

Then the training CLI in both ranks of the pair (``training.main``, which
adopts their process group; the synthetic set at full MTAN width, 16x16,
f32): one epoch with a predict sweep whose ``preds.npz`` rank 0 writes, a
resume to the second epoch, and a run with a preemption injected on one
rank that stops both at the same step with exit 143. Running them in the
pair's processes spares three launches of ranks; the ``--device cpu:N``
launcher (``multihost.launch_local_ranks`` and the run dir rank 0 hands
back) is held on its own at the end, on processes that import no torch."""

import contextlib
import glob
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from vision_mtl_tpu_torch.kernels import fused_gate_train
from vision_mtl_tpu_torch.metrics import compute_metrics, init_metrics, reduce_metrics
from vision_mtl_tpu_torch.models.basic import BasicMTLModel
from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet
from vision_mtl_tpu_torch.parallel import mesh, multihost
from vision_mtl_tpu_torch.train.state import create_train_state
from vision_mtl_tpu_torch.train.step import make_eval_step, make_train_step

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
BATCH = 6  # global; 3 rows a rank
PER = BATCH // WORLD
NC = 5
TASKS = {"depth": 1, "segm": NC}
MTAN_KW = dict(task_subnets_hidden_channels=8, encoder_first_channel=8, encoder_num_channels=2)
HW = (16, 24)
BASIC_HW = (32, 32)
LR = 2e-3
RANKS_TIMEOUT_S = 240
# the CLI runs: the tiny synthetic set (6 train rows after the split, 2
# val, 2 predict)
TINY = dict(height=16, width=16, num_train=8, num_val=2)
ARGV = ["--dataset_name", "synthetic", "--model_name", "mtan", "--batch_size", "4",
        "--precision", "f32", "--exp_disabled", "--save_epoch_freq", "1"]
# the preemption run: requested at this step on this rank alone
PREEMPT_RANK, PREEMPT_AT = 1, 1


def _batch(seed, n=BATCH, hw=HW, valid=None):
    rng = np.random.default_rng(seed)
    out = {
        "img": torch.from_numpy(rng.uniform(size=(n, *hw, 3))),
        "mask": torch.from_numpy(rng.integers(0, NC, (n, *hw)).astype(np.int32)),
        "depth": torch.from_numpy(rng.uniform(0.1, 1.0, (n, *hw, 1))),
    }
    if valid is not None:
        out["valid"] = torch.tensor(valid, dtype=torch.float64)
    return out


def _mtan(dtype=torch.float64, **kw):
    model = MTANMiniUnet(TASKS, dtype=dtype, seed=0, **MTAN_KW, **kw)
    return model.to(dtype)


def _basic(fold_tail):
    model = BasicMTLModel(NC, decoder_first_channel=16, num_decoder_layers=5,
                          fold_tail=fold_tail, dtype=torch.float64, seed=0)
    return model.double()


def _gate_case():
    g = torch.Generator().manual_seed(1)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, dtype=torch.float64) * scale

    x, shared = r(BATCH, 3, 5, 6), r(BATCH, 3, 5, 8)
    weights = (r(6, 8, scale=0.4), r(8, scale=0.1), r(8).abs() + 0.5, r(8, scale=0.2),
               r(8, 8, scale=0.35), r(8, scale=0.1), r(8).abs() + 0.5, r(8, scale=0.2))
    return x, shared, weights, r(BATCH, 3, 5, 8)


def _gate(x, shared, weights, cot, comm=None):
    leaves = [v.clone().requires_grad_() for v in (x, shared, *weights)]
    out, *stats = fused_gate_train.fused_attention_gate_train(*leaves, comm=comm)
    out.backward(cot)
    return {"out": out.detach(), **{f"stat{i}": s for i, s in enumerate(stats)},
            **{f"grad{i}": v.grad for i, v in enumerate(leaves)}}


def _step(model, batch, mesh_=None, steps=1):
    """``steps`` train steps; the model's gradients, buffers, parameters and
    Adam moments after them, and the last loss."""
    state = create_train_state(model, LR, device="cpu")
    step = make_train_step(device="cpu", mesh=mesh_)
    for _ in range(steps):
        _, _, losses = step(state, batch, init_metrics(NC, "cpu"))
    rec = {f"grad/{k}": p.grad for k, p in model.named_parameters()}
    rec.update({f"buf/{k}": b for k, b in model.named_buffers()})
    rec.update({f"param/{k}": p.detach() for k, p in model.named_parameters()})
    rec.update({f"adam/{i}/{k}": v for i, p in enumerate(model.parameters())
                for k, v in state.optimizer.state[p].items() if k != "step"})
    rec["loss"] = losses["loss"].detach()
    return {k: v.detach().numpy().copy() for k, v in rec.items()}


def _eval(batch, mesh_=None):
    model = _mtan(torch.float64)
    state = create_train_state(model, LR, device="cpu")
    mstate, _ = make_eval_step(device="cpu", mesh=mesh_)(state, batch, init_metrics(NC, "cpu"))
    mstate = reduce_metrics(mstate, mesh_.comm if mesh_ is not None else None)
    return {"confmat": mstate.confmat.numpy(), "mae_count": mstate.mae_count.numpy(),
            "mae_sum": mstate.mae_sum.numpy(),
            **{f"metric/{k}": v.numpy() for k, v in compute_metrics(mstate).items()}}


def _split(comm) -> dict:
    """``Comm.split`` over gloo: the rank's group alone and both ranks
    together (``dist.new_group`` on every rank in the same order), a sum in
    each, an object broadcast and a barrier in the pair's group, and a halo
    exchange of 2 rows each way over it (one row a rank: the halo reaches
    past the image's edge)."""
    from vision_mtl_tpu_torch.parallel.halo import halo_rows

    alone = comm.split([[0], [1]])
    pair = comm.split([[0, 1]])
    x = torch.full((1, 1, 2, 3), float(comm.rank + 1), dtype=torch.float64)
    halo = halo_rows(x.requires_grad_(), 2, 2, pair)
    halo.backward(torch.ones_like(halo))
    pair.barrier()
    return {"alone": (alone.rank, alone.world, float(alone.all_reduce_(torch.ones(1)))),
            "pair": (pair.rank, pair.world, float(pair.all_reduce_(torch.ones(1)))),
            "object": pair.broadcast_object(f"from {comm.rank}"),
            "halo": halo.detach().numpy()[0, :, 0, 0].tolist(),
            "halo_grad": x.grad.numpy()[0, :, 0, 0].tolist()}


def _rank_main(rank: int, out_dir: str, store_path: str) -> None:
    """One rank of the pair: joins through the FileStore and writes
    ``rank_{rank}.npz`` and ``split_{rank}.json``, then runs
    :func:`_rank_cli`."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD)
    multihost.maybe_initialize_distributed("cpu")  # adopts the group
    m = mesh.create_mesh("data:-1")

    def mine(batch):
        return {k: v[rank * PER:(rank + 1) * PER] for k, v in batch.items()}

    x, shared, weights, cot = _gate_case()
    rows = slice(rank * PER, (rank + 1) * PER)
    out = {}
    for name, rec in (
        ("mtan", _step(_mtan(), mine(_batch(0)), m)),
        ("remat", _step(_mtan(remat_attention=True), mine(_batch(0)), m)),
        ("basic", _step(_basic(False), mine(_batch(4, hw=BASIC_HW)), m)),
        ("fold_tail", _step(_basic(True), mine(_batch(4, hw=BASIC_HW)), m)),
        ("f32", _step(_mtan(torch.float32), mine({k: v.float() if v.is_floating_point() else v
                                                  for k, v in _batch(1).items()}), m, steps=2)),
        ("gate", _gate(x[rows], shared[rows], weights, cot[rows], comm=m.comm)),
        ("eval", _eval(mine(_batch(2, valid=[1, 1, 1, 1, 0, 0])), m)),
    ):
        out.update({f"{name}:{k}": np.asarray(v) for k, v in rec.items()})
    np.savez(os.path.join(out_dir, f"rank_{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"split_{rank}.json"), "w") as f:
        json.dump(_split(m.comm), f)
    _rank_cli(rank, out_dir)
    dist.barrier()
    dist.destroy_process_group()


def _rank_cli(rank: int, out_dir: str) -> None:
    """The CLI in this rank of the pair (``training.main`` adopts its process
    group): one epoch, a resume of that run to the second epoch, then a run
    whose preemption is requested on rank ``PREEMPT_RANK`` alone; writes
    ``cli_{rank}.json`` (run dirs, exit codes, the preempted run's
    output)."""
    from vision_mtl_tpu_torch import training
    from vision_mtl_tpu_torch.cfg import cfg
    from vision_mtl_tpu_torch.data import synthetic

    sys.modules["torch.utils.tensorboard"] = None  # it would load TensorFlow here
    for k, v in TINY.items():
        setattr(synthetic.synthetic_data_cfg, k, v)
    cfg.log_root_dir = Path(out_dir) / "logs"
    run_dir = training.main(ARGV + ["--device", "cpu", "--num_epochs", "1"])
    rec = {"run_dir": run_dir,
           "resumed": training.main(ARGV + ["--device", "cpu", "--num_epochs", "2",
                                            "--resume_dir", run_dir])}
    cfg.log_root_dir = Path(out_dir) / "preempt_logs"
    if rank == PREEMPT_RANK:
        os.environ["VMTL_PREEMPT_AT_STEP"] = str(PREEMPT_AT)
    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            training.main(ARGV + ["--device", "cpu", "--num_epochs", "2", "--preempt_save"])
        rec["preempt_code"] = 0
    except SystemExit as e:
        rec["preempt_code"] = e.code
    os.environ.pop("VMTL_PREEMPT_AT_STEP", None)
    rec["preempt_out"] = log.getvalue()
    with open(os.path.join(out_dir, f"cli_{rank}.json"), "w") as f:
        json.dump(rec, f)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """One launch of the pair: ``(out dir, both ranks' step results, both
    ranks' CLI records)``."""
    out = tmp_path_factory.mktemp("dp")
    env = {k: v for k, v in os.environ.items() if k not in multihost.LAUNCH_VARS}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_dp", str(r), str(out), str(out / "store")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=RANKS_TIMEOUT_S)[0].decode() for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the two ranks did not finish in time")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    results, cli = [], []
    for r in range(WORLD):
        with np.load(out / f"rank_{r}.npz") as f:
            results.append({k: f[k] for k in f.files})
        cli.append(json.load(open(out / f"cli_{r}.json")))
        results[r]["split"] = json.load(open(out / f"split_{r}.json"))
    return out, results, cli


@pytest.fixture(scope="module")
def ranks(launched):
    """Both ranks' step results."""
    return launched[1]


def _part(rec, name):
    return {k[len(name) + 1:]: v for k, v in rec.items() if k.startswith(name + ":")}


ZERO_GRAD = re.compile(r"(GateChain_0\.b[12]|_attn_\d+_task\d+\.Conv_\d\.bias)$")


def _assert_same_bits(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), k


def test_ranks_hold_the_same_state(ranks):
    """After each step both ranks hold the same gradients, statistics,
    parameters and Adam moments, bit for bit (two f32 steps included)."""
    for name in ("mtan", "remat", "basic", "fold_tail", "f32"):
        _assert_same_bits(_part(ranks[0], name), _part(ranks[1], name))


def test_comm_split_over_gloo(ranks):
    """Sub-groups of the process group (the mesh's spatial groups): each
    rank alone, then the pair; sums within each, rank 0's object on both,
    and a halo exchange of 2 rows each way over 1 row a rank: the other
    rank's row on one side and zeros past the image's edge, its gradient
    (all ones) sent back and added to the row's own."""
    for rank, rec in enumerate(r["split"] for r in ranks):
        assert rec["alone"] == [0, 1, 1.0] and rec["pair"] == [rank, 2, 2.0]
        assert rec["object"] == "from 0"
    assert ranks[0]["split"]["halo"] == [0.0, 0.0, 1.0, 2.0, 0.0]
    assert ranks[1]["split"]["halo"] == [0.0, 1.0, 2.0, 0.0, 0.0]
    for r in ranks:  # its own row once, and once as the other's halo row
        assert r["split"]["halo_grad"] == [2.0]


def test_remat_attention_is_bit_for_bit_its_plain_step(ranks):
    """``remat_attention`` under two ranks: the recompute calls the same
    collectives, and leaves the statistics as the first pass left them."""
    _assert_same_bits(_part(ranks[0], "mtan"), _part(ranks[0], "remat"))


@pytest.mark.parametrize("name", ["mtan", "basic", "fold_tail"])
def test_step_over_two_ranks_matches_one_process(ranks, name):
    """The 2-rank f64 step against the one-process step on the global
    batch (the same function, only the order of the sums differs): the
    loss, the running statistics and every gradient within 1e-9 of the
    leaf's largest magnitude plus 1e-12 (of the model's largest gradient
    for a gradient: some leaves' gradients, and some running means, are 0
    up to rounding), and the parameters after
    Adam within 1e-9 where the gradient is not such a 0 (Adam turns a
    rounding-level gradient into a step of +-lr)."""
    if name == "mtan":
        model, batch = _mtan(), _batch(0)
    else:
        model, batch = _basic(name == "fold_tail"), _batch(4, hw=BASIC_HW)
    want = _step(model, batch)
    got = _part(ranks[0], name)
    assert got.keys() == want.keys()
    top = max(float(np.abs(w).max()) for k, w in want.items() if k.startswith("grad/"))
    for k, w in want.items():
        kind, leaf = k.split("/", 1) if "/" in k else (k, "")
        scale = float(np.abs(w).max())
        if kind == "adam" or (kind == "param" and
                              float(np.abs(want[f"grad/{leaf}"]).max()) <= 1e-8 * top):
            continue
        err = float(np.abs(got[k] - w).max())
        floor = 1e-12 * top if kind == "grad" else 1e-12
        assert err <= 1e-9 * scale + floor, (k, err, scale)


def test_mtan_step_over_two_ranks_matches_jax(ranks):
    """The 2-rank tiny MTAN step against one jitted JAX ``value_and_grad``
    of the global batch under ``jax.enable_x64``: JAX's gate chain takes its
    products with f32 results even there, so the loss is held within 1e-6,
    every gradient within 1e-5 of its leaf's largest magnitude (``ZERO_GRAD``:
    under 1e-6 of the model's largest gradient on both sides), the running
    statistics within 1e-5."""
    import jax
    import jax.numpy as jnp

    from vision_mtl_tpu.models.mtan import MTANMiniUnet as JaxMTAN
    from vision_mtl_tpu.train import step as jax_step
    from vision_mtl_tpu_torch.weights import jax_variables_from_model, load_jax_variables

    variables = jax_variables_from_model(_mtan(torch.float64))
    batch = {k: v.numpy() for k, v in _batch(0).items()}
    with jax.enable_x64(True):
        jmodel = JaxMTAN(map_tasks_to_num_channels=TASKS, dtype=jnp.float64, **MTAN_KW)

        def loss_fn(params, batch_stats, b):
            losses, _, new_stats = jax_step._forward_and_losses(
                jmodel, params, batch_stats, b, True, 1.0, 1.0)
            return losses["loss"], new_stats

        f64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            f64["params"], f64["batch_stats"], jax.tree.map(jnp.asarray, batch))
        loss, grads, new_stats = float(loss), jax.device_get(grads), jax.device_get(new_stats)

    def as_port(tree, coll):
        other = "batch_stats" if coll == "params" else "params"
        twin = _mtan(torch.float64)
        load_jax_variables(twin, {coll: tree, other: variables[other]})
        named = twin.named_parameters() if coll == "params" else twin.named_buffers()
        return {k: v.detach().numpy() for k, v in named}

    got = _part(ranks[0], "mtan")
    assert float(got["loss"]) == pytest.approx(loss, rel=1e-6)
    want = as_port(grads, "params")
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        g = got[f"grad/{k}"]
        if ZERO_GRAD.search(k):
            assert max(float(np.abs(w).max()), float(np.abs(g).max())) <= 1e-6 * top, k
        else:
            assert float(np.abs(g - w).max()) <= 1e-5 * float(np.abs(w).max()), k
    for k, w in as_port(new_stats, "batch_stats").items():
        np.testing.assert_allclose(got[f"buf/{k}"], w, rtol=1e-5, atol=1e-6, err_msg=k)


def test_gate_train_plain_split_over_gloo(ranks):
    """Kernel B4's plain version under two gloo ranks against one process
    on the concatenated rows (f64, within 1e-10): the output and x's and
    shared's gradient rows, the statistics, the summed weight gradients."""
    x, shared, weights, cot = _gate_case()
    want = _gate(x, shared, weights, cot)
    got = [_part(r, "gate") for r in ranks]
    tol = dict(rtol=1e-10, atol=1e-10)
    for k in ("out", "grad0", "grad1"):
        np.testing.assert_allclose(np.concatenate([got[0][k], got[1][k]]), want[k].numpy(),
                                   err_msg=k, **tol)
    for i in range(4):
        assert np.array_equal(got[0][f"stat{i}"], got[1][f"stat{i}"])
        np.testing.assert_allclose(got[0][f"stat{i}"], want[f"stat{i}"].numpy(), **tol)
    for i in range(2, 10):
        np.testing.assert_allclose(got[0][f"grad{i}"] + got[1][f"grad{i}"],
                                   want[f"grad{i}"].numpy(), err_msg=f"grad{i}", **tol)


def test_reduced_metrics_match_one_process(ranks):
    """An eval step of a padded batch (4 of 6 rows valid: rank 1 holds both
    padded rows), its metric state reduced over the ranks: the confusion
    counts and pixel counts exactly, the sums and metrics within 1e-6."""
    want = _eval(_batch(2, valid=[1, 1, 1, 1, 0, 0]))
    for r in ranks:
        got = _part(r, "eval")
        np.testing.assert_array_equal(got["confmat"], want["confmat"])
        np.testing.assert_array_equal(got["mae_count"], want["mae_count"])
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-9, err_msg=k)


# ---- the CLI over two CPU ranks ----------------------------------------------


def test_cli_over_two_cpu_ranks_trains_resumes_and_predicts(launched, monkeypatch):
    """One epoch over two ranks: one run dir with one checkpoint, the same
    on both ranks, and a ``preds.npz`` (written by rank 0) equal to a
    one-process predict sweep of the saved model (ids exactly, depth within
    1e-5: the ranks' forwards see 2 rows, the sweep 4). A resume to epoch 2
    writes one more run dir holding epoch 1's checkpoint alone."""
    from vision_mtl_tpu_torch.data import datamodule, synthetic
    from vision_mtl_tpu_torch.pipeline import load_run_model
    from vision_mtl_tpu_torch.predict import predict

    out, _, cli = launched
    logs = out / "logs" / "training-mtan"
    run_dir, resumed = cli[0]["run_dir"], cli[0]["resumed"]
    assert (cli[1]["run_dir"], cli[1]["resumed"]) == (run_dir, resumed)
    assert sorted(glob.glob(str(logs / "version_*"))) == sorted([run_dir, resumed])
    entries = sorted(os.listdir(run_dir))
    assert [e for e in entries if e.startswith(("model_", "session_"))] == \
        ["model_0", "session_0"]
    assert {"preds.npz", "metrics.jsonl", "train_args.yaml"} <= set(entries)

    for k, v in TINY.items():
        monkeypatch.setattr(synthetic.synthetic_data_cfg, k, v)
    model, data_cfg, _ = load_run_model(run_dir, "cpu")
    dm = datamodule.MTLDataModule("synthetic", batch_size=4, seed=11)
    dm.setup()
    preds, _ = predict(dm.predict_dataloader(), model, data_cfg.num_classes, device="cpu")
    saved = np.load(os.path.join(run_dir, "preds.npz"))
    np.testing.assert_array_equal(saved["segm"], np.concatenate([p["segm"] for p in preds]))
    np.testing.assert_allclose(saved["depth"], np.concatenate([p["depth"] for p in preds]),
                               atol=1e-5, rtol=0)

    assert [e for e in sorted(os.listdir(resumed)) if e.startswith(("model_", "session_"))] \
        == ["model_1", "session_1"]
    records = [json.loads(ln) for ln in open(os.path.join(resumed, "metrics.jsonl"))]
    assert [r["step"] for r in records if "epoch/train/loss" in r] == [1]


def test_cli_preempts_every_rank_at_the_same_step(launched):
    """``VMTL_PREEMPT_AT_STEP`` on rank 1 alone: both ranks save together
    at the same step and ``training.main`` exits 143 on both."""
    out, _, cli = launched
    assert [c["preempt_code"] for c in cli] == [143] * WORLD
    (run_dir,) = glob.glob(str(out / "preempt_logs" / "training-mtan" / "version_*"))
    meta = json.load(open(os.path.join(run_dir, "preempt_meta.json")))
    assert meta == {"epoch": 0, "batch_in_epoch": 1}
    for c in cli:
        assert c["preempt_out"].count(f"Preempted at epoch 1 step {PREEMPT_AT};") == 1


def test_cpu_launcher_runs_ranks_and_fails_with_them(capfd):
    """``multihost.launch_local_ranks`` (``--device cpu:N``) starts N
    processes with torchrun's environment, each its own ``RANK``, and waits
    for all; a rank that fails fails the launch with its exit code. The
    ranks here run ``python -m json.tool``, which imports no torch."""
    assert multihost.launch_local_ranks("json.tool", ["--help"], 2) == {"returncodes": [0, 0]}
    with pytest.raises(SystemExit) as e:
        multihost.launch_local_ranks("json.tool", [str(REPO / "no such file")], 2, grace_s=5.0)
    assert e.value.code not in (0, None)
    assert "ranks exited with" in capfd.readouterr().out


def test_cpu_launch_returns_rank_0s_run_dir(monkeypatch, tmp_path):
    """``training.main(["--device", "cpu:2", ...])`` checks the mesh, launches
    the CLI's module as 2 ranks with the launch argv, and returns the run
    dir that rank 0 wrote to ``VMTL_RUN_DIR_FILE`` (the launch stubbed)."""
    from vision_mtl_tpu_torch import training

    for var in multihost.LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    seen = {}

    def launch(module, argv, world):
        seen.update(module=module, argv=argv, world=world)
        with open(os.environ[training.RUN_DIR_FILE_ENV], "w") as f:
            f.write(str(tmp_path / "run"))
        return {"returncodes": [0] * world}

    monkeypatch.setattr(multihost, "launch_local_ranks", launch)
    argv = ARGV + ["--device", "cpu:2", "--num_epochs", "1"]
    assert training.main(argv) == str(tmp_path / "run")
    assert seen == {"module": "vision_mtl_tpu_torch.training", "argv": argv, "world": 2}
    assert training.RUN_DIR_FILE_ENV not in os.environ


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
