"""The port's basic model (MobileNetV3 + Unet, merged heads) against the JAX
package at a small width, in f32: the registry's parameter count, which
convs take kernel B3, the weight bridge on the basic tree, the eval forward
(merged and unmerged heads), one ``make_train_step`` (loss, every gradient,
running statistics) and the torch-running-var switch; and the serving CLI's
``--demo --model_name basic``."""

import copy
import io
import json
import re
import threading
import time
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vision_mtl_tpu.cfg import fetch_data_cfg as jax_fetch_data_cfg
from vision_mtl_tpu.data.synthetic import SyntheticConfig, SyntheticMTLDataset
from vision_mtl_tpu.models import blocks as jax_blocks
from vision_mtl_tpu.models.basic import BasicMTLModel as JaxBasic
from vision_mtl_tpu.models.registry import build_model as jax_build_model
from vision_mtl_tpu.train import step as jax_step
from vision_mtl_tpu_torch import serve
from vision_mtl_tpu_torch.cfg import fetch_data_cfg
from vision_mtl_tpu_torch.metrics import init_metrics
from vision_mtl_tpu_torch.models import blocks
from vision_mtl_tpu_torch.models.basic import BasicMTLModel
from vision_mtl_tpu_torch.models.registry import build_model
from vision_mtl_tpu_torch.ops import small_conv as small_conv_op
from vision_mtl_tpu_torch.train.state import create_train_state
from vision_mtl_tpu_torch.train.step import make_train_step
from vision_mtl_tpu_torch.weights import load_jax_variables

NC = 5
WIDTH = 16  # decoder (16, 8, 4, 2, 1): every block but the first takes B3's plain path
HW = (64, 64)
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_model(merge_heads=True):
    return JaxBasic(
        segm_classes=NC, decoder_first_channel=WIDTH, num_decoder_layers=5,
        merge_heads=merge_heads, dtype=jnp.float32,
    )


def _random_variables(shapes, rng):
    """Seeded numpy values for the JAX variable tree (flax's own init runs
    eagerly here and takes tens of seconds): LeCun-uniform kernels, small
    biases, BN affine parameters and running statistics away from identity."""

    def fill(tree, coll):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v, coll)
                continue
            shape = v.shape
            if k == "kernel":
                bound = np.sqrt(3.0 / np.prod(shape[:-1]))
                a = rng.uniform(-bound, bound, shape)
            elif coll == "params" and k == "scale":
                a = rng.uniform(0.5, 1.5, shape)
            elif coll == "params":  # conv and BN biases
                a = rng.uniform(-0.3, 0.3, shape)
            elif k == "mean":
                a = rng.uniform(-0.3, 0.3, shape)
            else:  # var
                a = rng.uniform(0.5, 1.5, shape)
            out[k] = a.astype(np.float32)
        return out

    return {coll: fill(tree, coll) for coll, tree in shapes.items()}


@pytest.fixture(scope="module")
def setup():
    ds = SyntheticMTLDataset(
        stage="train", cfg=SyntheticConfig(height=HW[0], width=HW[1], num_classes=NC, num_train=2)
    )
    samples = [ds[k] for k in range(2)]
    batch = {
        "img": np.stack([s["img"] for s in samples]).astype(np.float32),
        "mask": np.stack([s["mask"] for s in samples]).astype(np.int32),
        "depth": np.stack([s["depth"] for s in samples]).astype(np.float32),
    }
    shapes = jax.eval_shape(
        lambda: _jax_model().init(jax.random.key(0), jnp.asarray(batch["img"]), train=False)
    )
    return _random_variables(shapes, np.random.default_rng(3)), batch


def _port(variables, merge_heads=True, dtype=torch.float32):
    model = BasicMTLModel(
        NC, decoder_first_channel=WIDTH, num_decoder_layers=5, merge_heads=merge_heads,
        dtype=dtype,
    )
    load_jax_variables(model, variables)
    return model


def test_registry_param_count_matches_jax():
    args = type("Args", (), {"model_name": "basic"})()
    jmodel = jax_build_model(args, jax_fetch_data_cfg("cityscapes"))
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 128, 256, 3)), train=False)
    )
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    model = build_model("basic", fetch_data_cfg("cityscapes"), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == want == 13_564_301
    assert not model.training and model.merge_heads
    # strict both ways on the trained tree: all 316 leaves, each consumed
    full = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    assert len(jax.tree.leaves(full)) == 316
    load_jax_variables(model, full)
    assert all(float(p.detach().abs().max()) == 0.0 for p in model.parameters())


def test_trained_width_routes_four_convs_through_b3(monkeypatch):
    """At decoder_first_channel=540 exactly the 67->67, 67->33, 33->33 decoder
    convs and the merged 33->20 head take kernel B3, one call each per
    forward; block_3's first conv (151 channels in) does not. Driven module
    by module on 1-pixel inputs, not through the full model."""
    model = build_model("basic", fetch_data_cfg("cityscapes"), dtype=torch.float32, device="cpu")
    routed = [n for n, m in model.named_modules() if isinstance(m, blocks.Conv) and m.small_conv]
    dec = "backbone.decoder."
    assert routed == [
        dec + "block_3.ConvBNAct_1.Conv_0", dec + "block_4.ConvBNAct_0.Conv_0",
        dec + "block_4.ConvBNAct_1.Conv_0", "segm_head.Conv_0", "depth_head.Conv_0",
    ]
    assert model.merged_head_small_conv
    calls = []
    real = small_conv_op.conv3x3_small

    def counting(x, kernel, bias=None):
        calls.append((x.shape[-1], kernel.shape[-1]))
        return real(x, kernel, bias)

    monkeypatch.setattr(small_conv_op, "conv3x3_small", counting)
    decoder = model.backbone.decoder
    with torch.no_grad():
        x = decoder.block_3(torch.zeros(1, 1, 1, 135), torch.zeros(1, 2, 2, 16))
        x = decoder.block_4(x)
        out = model.heads(x)
    assert calls == [(67, 67), (67, 33), (33, 33), (33, 20)]
    assert out["segm"].shape == (1, 4, 4, 19) and out["depth"].shape == (1, 4, 4, 1)


def test_bridge_is_strict_on_the_basic_tree(setup):
    variables, _ = setup
    model = _port(variables)
    before = copy.deepcopy(model.state_dict())

    missing = copy.deepcopy(variables)
    del missing["batch_stats"]["backbone"]["encoder"]["_stem_bn"]["var"]
    with pytest.raises(ValueError, match="backbone/encoder/_stem_bn/var"):
        load_jax_variables(model, missing)

    extra = copy.deepcopy(variables)
    extra["params"]["backbone"]["encoder"]["stages_0_0"]["Conv_2"] = {
        "Conv_0": {"kernel": np.zeros((1, 1, 16, 16), np.float32)}
    }
    with pytest.raises(ValueError, match="not consumed"):
        load_jax_variables(model, extra)

    wrong = copy.deepcopy(variables)
    dw = wrong["params"]["backbone"]["encoder"]["stages_1_0"]["Conv_1"]["Conv_0"]
    dw["kernel"] = np.zeros((3, 3, 2, 64), np.float32)  # a depthwise kernel is (3, 3, 1, 64)
    with pytest.raises(ValueError, match="stages_1_0/Conv_1/Conv_0/kernel"):
        load_jax_variables(model, wrong)

    for k, v in model.state_dict().items():  # a failed load leaves the model as it was
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("merge_heads", [True, False])
def test_eval_forward_matches_jax(setup, merge_heads):
    variables, batch = setup
    jmodel = _jax_model(merge_heads)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(batch["img"])
    )
    model = _port(variables, merge_heads)
    with torch.no_grad():
        got = model(torch.from_numpy(batch["img"]))
    for k in ("segm", "depth"):
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape and got[k].dtype == torch.float32, k
        np.testing.assert_allclose(
            got[k].numpy(), w, rtol=2e-4, atol=2e-4 * float(np.abs(w).max()), err_msg=k
        )


def test_bf16_forward_is_close(setup):
    """The default bf16 compute stays near the f32 forward (5% of scale)."""
    variables, batch = setup
    x = torch.from_numpy(batch["img"])
    with torch.no_grad():
        want = _port(variables)(x)
        got = _port(variables, dtype=torch.bfloat16)(x)
    for k in ("segm", "depth"):
        assert got[k].dtype == torch.bfloat16
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(
            got[k].float().numpy(), want[k].numpy(), atol=0.05 * scale, err_msg=k
        )


# the projection BN biases of stages 3 and 5 reach the loss only through a
# 1x1 conv followed by a batch-statistic BN: their gradient is 0 up to rounding
ZERO_GRAD = re.compile(r"stages_[35]_\d\.BatchNorm_2\.bias$")


def test_one_train_step_matches_jax(setup):
    """The port's f32 step against JAX's gradient of the same train-mode
    loss taken in f64: loss within 1e-5, every gradient within 1e-3 of its
    leaf's largest magnitude (``ZERO_GRAD``: both under 1e-6 of the largest
    gradient) and the running statistics, the encoder's raw ``_stem_bn`` and
    ``_head_bn`` among them, within 1e-5. JAX's own f32 step is no yardstick
    here: flax's BatchNorm takes the batch variance as E[x^2] - E[x]^2, and
    in f32 that moves some encoder gradients of this model by several
    percent, while the port (and JAX in f64) agree to ~1e-4."""
    variables, batch = setup
    with jax.enable_x64(True):
        jmodel = JaxBasic(
            segm_classes=NC, decoder_first_channel=WIDTH, num_decoder_layers=5,
            dtype=jnp.float64,
        )

        def loss_fn(params, batch_stats, b):
            losses, _, new_stats = jax_step._forward_and_losses(
                jmodel, params, batch_stats, b, True, 1.0, 1.0
            )
            return losses["loss"], new_stats

        f64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        jbatch = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32 else v.dtype)
                  for k, v in batch.items()}
        (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            f64["params"], f64["batch_stats"], jbatch
        )
        loss, grads, new_stats = float(loss), jax.device_get(grads), jax.device_get(new_stats)
    model = _port(variables)
    state = create_train_state(model, LR, device="cpu")
    _, _, losses = make_train_step(device="cpu")(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, init_metrics(NC, "cpu")
    )
    assert float(losses["loss"]) == pytest.approx(loss, rel=1e-5)

    def as_port(tree, coll):  # an f32 twin module holding the JAX tree
        other = "batch_stats" if coll == "params" else "params"
        twin = _port({coll: jax.tree.map(lambda a: np.asarray(a, np.float32), tree),
                      other: variables[other]})
        return dict(twin.named_parameters() if coll == "params" else twin.named_buffers())

    want = {k: v.detach() for k, v in as_port(grads, "params").items()}
    top = max(float(w.abs().max()) for w in want.values())
    for name, p in model.named_parameters():
        scale = float(want[name].abs().max())
        if ZERO_GRAD.search(name):
            assert max(scale, float(p.grad.abs().max())) <= 1e-6 * top, (name, scale, top)
        else:
            err = float((p.grad - want[name]).abs().max())
            assert err <= 1e-3 * scale, (name, err, scale)
    stats = as_port(new_stats, "batch_stats")
    for name, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    stem_var = variables["batch_stats"]["backbone"]["encoder"]["_stem_bn"]["var"]
    assert not np.allclose(model.backbone.encoder._stem_bn.running_var.numpy(), stem_var)


def test_torch_running_var_switch(setup):
    """One train-mode forward under the torch-running-var switch on both
    sides: the running statistics of every BN, raw or wrapped, within 1e-5."""
    variables, batch = setup
    jmodel = _jax_model()
    prev_jax, prev_port = jax_blocks.torch_bn_running_var(), blocks.torch_bn_running_var()
    jax_blocks.set_torch_bn_running_var(True)
    blocks.set_torch_bn_running_var(True)
    try:
        _, mutated = jax.jit(
            lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"])
        )(variables, jnp.asarray(batch["img"]))
        model = _port(variables).train()
        with torch.no_grad():
            model(torch.from_numpy(batch["img"]))
    finally:
        jax_blocks.set_torch_bn_running_var(prev_jax)
        blocks.set_torch_bn_running_var(prev_port)
    stats = dict(_port({"params": variables["params"],
                        "batch_stats": jax.device_get(mutated["batch_stats"])}).named_buffers())
    for name, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_serve_demo_basic(monkeypatch):
    """``serve --demo --model_name basic`` at the synthetic config on the
    CPU answers a request over HTTP."""
    servers = []
    make = serve.make_server

    def capture(*args, **kwargs):
        servers.append(make(*args, **kwargs))
        return servers[-1]

    monkeypatch.setattr(serve, "make_server", capture)
    argv = ["--demo", "--model_name", "basic", "--dataset_name", "synthetic",
            "--device", "cpu", "--port", "0", "--buckets", "1", "--wire_dtype", "uint8"]
    th = threading.Thread(target=serve.main, args=(argv,), daemon=True)
    th.start()
    deadline = time.monotonic() + 60
    while not servers and time.monotonic() < deadline:
        time.sleep(0.05)
    assert servers, "the demo server did not start"
    httpd = servers[0]
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        buf = io.BytesIO()
        np.save(buf, np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8))
        with urllib.request.urlopen(
            urllib.request.Request(base + "/predict", data=buf.getvalue()), timeout=60
        ) as r:
            out = np.load(io.BytesIO(r.read()))
        assert out["segm"].shape == (1, 64, 64) and out["depth"].shape == (1, 64, 64, 1)
        assert 0 <= out["segm"].min() and out["segm"].max() < 7
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            assert json.loads(r.read())["model"] == "basic"
    finally:
        httpd.shutdown()
        th.join(timeout=60)
    assert not th.is_alive()
