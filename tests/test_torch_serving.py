"""The port's Predictor, BatchingServer, HTTP front end and predict-eval step
against the JAX package's on the same small MTAN (weights bridged), on the
CPU."""

import concurrent.futures
import copy
import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vision_mtl_tpu import metrics as jax_metrics
from vision_mtl_tpu.models.mtan import MTANMiniUnet as JaxMTAN
from vision_mtl_tpu.serving import Predictor as JaxPredictor
from vision_mtl_tpu.train.state import create_train_state
from vision_mtl_tpu.train.step import make_predict_eval_step as jax_predict_eval_step
from vision_mtl_tpu_torch import metrics, serve
from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet
from vision_mtl_tpu_torch.predict import predict
from vision_mtl_tpu_torch.serving import BatchingServer, Predictor, latency_bench
from vision_mtl_tpu_torch.train.state import create_train_state as torch_create_train_state
from vision_mtl_tpu_torch.train.step import (
    make_predict_eval_step,
    make_predict_step,
    make_train_step,
)
from vision_mtl_tpu_torch.weights import load_jax_variables

TASKS = {"depth": 1, "segm": 5}
H = W = 16
# argmax may flip where two logits tie to within the frameworks' f32
# rounding differences; allow one pixel in 500
MAX_SEGM_MISMATCH = 0.002


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX train state, port model) with the same weights."""
    jmodel = JaxMTAN(
        map_tasks_to_num_channels=TASKS,
        task_subnets_hidden_channels=8,
        encoder_first_channel=8,
        encoder_num_channels=2,
        dtype=jnp.float32,
    )
    state = create_train_state(jmodel, jax.random.key(0), jnp.zeros((1, H, W, 3)), lr=1e-3)
    model = MTANMiniUnet(
        TASKS, task_subnets_hidden_channels=8, encoder_first_channel=8,
        encoder_num_channels=2, dtype=torch.float32,
    )
    load_jax_variables(
        model,
        jax.device_get({"params": state.params, "batch_stats": state.batch_stats}),
    )
    return jmodel, state, model


def _assert_preds_close(got, want, n):
    assert got["segm"].shape == (n, H, W) and got["depth"].shape == (n, H, W, 1)
    assert np.mean(got["segm"] != np.asarray(want["segm"])) <= MAX_SEGM_MISMATCH
    np.testing.assert_allclose(
        got["depth"].astype(np.float32), np.asarray(want["depth"]).astype(np.float32),
        atol=1e-5,
    )


@pytest.mark.parametrize("wire", [np.float32, np.uint8])
def test_predictor_matches_jax_with_ragged_batch(models, rng, wire):
    jmodel, state, model = models
    if wire == np.uint8:
        imgs = rng.integers(0, 256, size=(3, H, W, 3), dtype=np.uint8)
    else:
        imgs = rng.uniform(size=(3, H, W, 3)).astype(np.float32)
    want = JaxPredictor(jmodel, state, 4, H, W, dtype=wire)(imgs)
    pred = Predictor(model, 4, H, W, dtype=wire, device="cpu")
    got = pred(imgs)  # 3 of 4: padded inside, trimmed on return
    assert got["segm"].dtype == np.int32 and got["depth"].dtype == np.float32
    _assert_preds_close(got, want, 3)
    with pytest.raises(ValueError):
        pred(np.zeros((5, H, W, 3), wire))
    with pytest.raises(ValueError):
        pred(np.zeros((0, H, W, 3), wire))


def test_compact_out_dtypes(models, rng):
    _, _, model = models
    imgs = rng.integers(0, 256, size=(2, H, W, 3), dtype=np.uint8)
    full = Predictor(model, 2, H, W, dtype=np.uint8, device="cpu")(imgs)
    compact = Predictor(model, 2, H, W, dtype=np.uint8, compact_out=True, device="cpu")(imgs)
    assert compact["segm"].dtype == np.uint8 and compact["depth"].dtype == np.float16
    np.testing.assert_array_equal(compact["segm"], full["segm"])
    np.testing.assert_array_equal(compact["depth"], full["depth"].astype(np.float16))


def test_batching_server_concurrent_submits(models, rng):
    _, _, model = models
    imgs = rng.uniform(size=(10, H, W, 3)).astype(np.float32)
    direct = Predictor(model, 1, H, W, device="cpu")
    want = [direct(imgs[i : i + 1]) for i in range(len(imgs))]
    with BatchingServer(model, H, W, buckets=(1, 4), max_wait_ms=20.0, device="cpu") as server:
        server.warmup()
        server.reset_stats()
        with concurrent.futures.ThreadPoolExecutor(10) as pool:
            outs = list(pool.map(server.predict, imgs))
        stats = server.stats()
        with pytest.raises(ValueError):
            server.submit(np.zeros((H, W, 3), np.uint8))  # float32 server
    assert stats["requests"] == 10 and stats["batched_images"] == 10
    assert stats["batches"] >= 3  # at most 4 images a batch
    assert 0.0 < stats["mean_batch_occupancy"] <= 1.0
    for o, w in zip(outs, want):
        assert o["segm"].shape == (H, W)
        assert np.mean(o["segm"] != w["segm"][0]) <= MAX_SEGM_MISMATCH
        np.testing.assert_allclose(o["depth"], w["depth"][0], atol=1e-5)
    with pytest.raises(RuntimeError):
        server.submit(imgs[0])  # closed


def test_http_front_end(models, rng):
    _, _, model = models
    with BatchingServer(
        model, H, W, buckets=(1, 2), dtype=np.uint8, compact_out=True, device="cpu"
    ) as batcher:
        httpd = serve.make_server(batcher, (H, W, 3), {"model": "mtan"}, wire_dtype=np.uint8)
        serve.serve_in_thread(httpd)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            imgs = rng.integers(0, 256, size=(3, H, W, 3), dtype=np.uint8)
            buf = io.BytesIO()
            np.save(buf, imgs)
            with urllib.request.urlopen(
                urllib.request.Request(base + "/predict", data=buf.getvalue()), timeout=60
            ) as r:
                out = np.load(io.BytesIO(r.read()))
            want = Predictor(model, 3, H, W, dtype=np.uint8, compact_out=True, device="cpu")(imgs)
            np.testing.assert_array_equal(out["segm"], want["segm"])
            assert out["depth"].dtype == np.float16
            with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
                assert json.loads(r.read()) == {"ok": True, "model": "mtan"}
            with urllib.request.urlopen(base + "/stats", timeout=60) as r:
                assert json.loads(r.read())["requests"] == 3
            buf = io.BytesIO()
            np.save(buf, imgs.astype(np.float32))  # float body on a uint8 server
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(
                    urllib.request.Request(base + "/predict", data=buf.getvalue()), timeout=60
                )
            assert e.value.code == 400
        finally:
            httpd.shutdown()
            httpd.server_close()


def _eval_batch(rng, n=4, valid=None):
    batch = {
        "img": rng.integers(0, 256, size=(n, H, W, 3), dtype=np.uint8),
        "mask": rng.integers(0, TASKS["segm"], size=(n, H, W)).astype(np.int32),
        "depth": rng.integers(0, 65536, size=(n, H, W, 1)).astype(np.uint16),
    }
    if valid is not None:
        batch["valid"] = np.asarray(valid, np.float32)
    return batch


def test_predict_eval_step_matches_jax(models, rng):
    jmodel, state, model = models
    jstep = jax_predict_eval_step(jmodel)
    step = make_predict_eval_step(model)
    c = TASKS["segm"]
    jm = jax_metrics.init_metrics(c)
    tm = metrics.init_metrics(c, device="cpu")
    for valid in (None, [1, 1, 1, 0]):
        batch = _eval_batch(rng, valid=valid)
        jpreds, jm, jlosses = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()}, jm)
        preds, tm, losses = step({k: torch.from_numpy(v) for k, v in batch.items()}, tm)
        _assert_preds_close({k: v.numpy() for k, v in preds.items()}, jpreds, 4)
        for k in ("loss", "loss_segm", "loss_depth"):
            np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-4, err_msg=k)
    want = jax_metrics.compute_metrics(jm)
    got = metrics.compute_metrics(tm)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-6, err_msg=k)

    # no ground truth: predictions only, metric state untouched
    img = {"img": torch.from_numpy(_eval_batch(rng)["img"])}
    preds, same, losses = step(img, tm)
    assert same is tm and losses == {} and preds["segm"].shape == (4, H, W)


def test_predict_sweep(models, rng):
    _, _, model = models
    batches = [_eval_batch(rng), _eval_batch(rng, valid=[1, 1, 0, 0])]
    preds, got = predict(batches, model, TASKS["segm"], device="cpu")
    assert [p["segm"].shape[0] for p in preds] == [4, 2]  # padded rows dropped
    step = make_predict_eval_step(model)
    mstate = metrics.init_metrics(TASKS["segm"], device="cpu")
    for b in batches:
        _, mstate, _ = step({k: torch.from_numpy(v) for k, v in b.items()}, mstate)
    want = {f"predict/{k}": float(v) for k, v in metrics.compute_metrics(mstate).items()}
    assert got == pytest.approx(want, rel=1e-6)
    # a sweep without ground truth has no metrics
    preds, got = predict([{"img": batches[0]["img"]}], model, TASKS["segm"], device="cpu")
    assert got == {} and preds[0]["depth"].shape == (4, H, W, 1)


def test_predict_step_and_latency_bench(models, rng):
    _, _, model = models
    imgs = rng.integers(0, 256, size=(2, H, W, 3), dtype=np.uint8)
    out = make_predict_step(model)(torch.from_numpy(imgs))
    want = Predictor(model, 2, H, W, dtype=np.uint8, device="cpu")(imgs)
    np.testing.assert_array_equal(out["segm"].numpy(), want["segm"])
    pred = Predictor(model, 2, H, W, dtype=np.uint8, device="cpu")
    lat = latency_bench(pred, imgs, n=3, warmup=1)
    assert set(lat) == {"p50_ms", "p95_ms", "p99_ms", "mean_ms"}
    assert lat["p50_ms"] > 0


def test_predict_steps_run_in_eval_mode(models, rng):
    """A model left in train mode (as ``create_train_state`` leaves it)
    predicts as in eval mode: both predict steps give exactly the eval-mode
    outputs, leave every running statistic as it was and the model in train
    mode."""
    _, _, model = models
    trained = copy.deepcopy(model)
    torch_create_train_state(trained, 1e-3, device="cpu")
    assert trained.training
    before = {k: b.clone() for k, b in trained.named_buffers()}
    batch = {k: torch.from_numpy(v) for k, v in _eval_batch(rng).items()}
    with torch.no_grad():  # the step has teeth: train mode predicts otherwise
        assert not torch.equal(trained(batch["img"].float() / 255.0)["depth"],
                               model(batch["img"].float() / 255.0)["depth"])
    for k, b in trained.named_buffers():
        b.copy_(before[k])
    c = TASKS["segm"]
    got = make_predict_step(trained)(batch["img"])
    want = make_predict_step(model)(batch["img"])
    got_eval = make_predict_eval_step(trained)(batch, metrics.init_metrics(c, device="cpu"))
    want_eval = make_predict_eval_step(model)(batch, metrics.init_metrics(c, device="cpu"))
    assert trained.training and not model.training
    for k, b in trained.named_buffers():
        assert torch.equal(b, before[k]), k
    for g, w in ((got, want), (got_eval[0], want_eval[0])):
        for k in ("segm", "depth"):
            assert torch.equal(g[k], w[k]), k
    for k in ("loss", "loss_segm", "loss_depth"):
        assert torch.equal(got_eval[2][k], want_eval[2][k]), k
    assert torch.equal(got_eval[1].confmat, want_eval[1].confmat)


def test_serve_cli_run_dir_not_ported():
    """``--run_dir`` is ported (tests/test_torch_loop.py serves a trained
    run); a dir without train_args.yaml needs the model and dataset named."""
    with pytest.raises(SystemExit, match="train_args.yaml"):
        serve.main(["--run_dir", "some/run"])
    with pytest.raises(SystemExit):
        serve.main([])  # neither --run_dir nor --demo


def test_predictor_serves_a_snapshot(models, rng):
    """A ``Predictor`` answers from the weights its module had at
    construction: two train steps on that module later leave its answers
    bit for bit as they were, its calls leave the module's mode alone, and
    a new ``Predictor`` on the trained module answers otherwise; a
    ``BatchingServer``'s buckets share one snapshot."""
    _, _, model = models
    module = copy.deepcopy(model).eval()
    imgs = _eval_batch(rng, n=2)["img"]
    pred = Predictor(module, 2, H, W, dtype=np.uint8, device="cpu")
    before = pred(imgs)
    state = torch_create_train_state(module, 1e-2, device="cpu")
    step = make_train_step(device="cpu")
    mstate = metrics.init_metrics(TASKS["segm"], device="cpu")
    for _ in range(2):
        batch = {k: torch.from_numpy(v) for k, v in _eval_batch(rng).items()}
        state, mstate, _ = step(state, batch, mstate)
    assert module.training
    after = pred(imgs)
    assert module.training and pred.model is not module and not pred.model.training
    for k in ("segm", "depth"):
        np.testing.assert_array_equal(after[k], before[k])
    fresh = Predictor(module.eval(), 2, H, W, dtype=np.uint8, device="cpu")(imgs)
    assert not np.array_equal(fresh["depth"], before["depth"])
    with BatchingServer(module, H, W, buckets=(1, 2), device="cpu") as server:
        snapshots = {id(p.model) for p in server._predictors.values()}
        assert len(snapshots) == 1 and id(module) not in snapshots
