"""The port's CSNet (cross-stitch) against the JAX package at a small width:
the registry's parameter count, the weight bridge on the csnet tree, the
f32 eval forward at a size that is not a multiple of 32 under three option
sets, the stitch's bf16 rounding, one ``make_train_step`` (loss, every
gradient, running statistics) against JAX's step, both in f64, which convs
take kernel B3 at the trained width, the stitch-point names, and the
serving CLI's ``--demo --model_name csnet``."""

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
from vision_mtl_tpu.models import cross_stitch as jax_cross_stitch
from vision_mtl_tpu.models.registry import build_model as jax_build_model
from vision_mtl_tpu.train import step as jax_step
from vision_mtl_tpu_torch import serve
from vision_mtl_tpu_torch.cfg import fetch_data_cfg
from vision_mtl_tpu_torch.metrics import init_metrics
from vision_mtl_tpu_torch.models import blocks
from vision_mtl_tpu_torch.models import cross_stitch
from vision_mtl_tpu_torch.models.registry import build_model
from vision_mtl_tpu_torch.ops import small_conv as small_conv_op
from vision_mtl_tpu_torch.train.state import create_train_state
from vision_mtl_tpu_torch.train.step import make_train_step
from vision_mtl_tpu_torch.weights import load_jax_variables

NC = 5
TASKS = {"depth": 1, "segm": NC}
WIDTH = 16  # decoder (16, 8, 4, 2, 1): every 3x3 conv but block 0's first takes B3's plain path
EVAL_HW = (40, 72)  # not a multiple of 32: odd pads, and a crop under upsample_skips
# the last encoder stage is 2 x 2 here, so at batch 2 its batch-statistic
# BNs see 8 values a channel: at 32 x 32 they see 2, and f32 rounding moves
# the port's gradients far outside the test's tolerance
TRAIN_HW = (48, 48)
TRAIN_BATCH = 2
LR = 1e-3
OPTION_SETS = {
    "default": {},
    "full_mix_upsample_skips": {"full_mix": True, "upsample_skips": True},
    "scalar_stitch": {"channel_wise_stitching": False},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_model(dtype=jnp.float32, **options):
    return jax_cross_stitch.CSNet(
        task_channels=TASKS, decoder_first_channel=WIDTH, num_decoder_layers=5,
        dtype=dtype, **options,
    )


def _port(variables, dtype=torch.float32, **options):
    model = cross_stitch.CSNet(
        TASKS, decoder_first_channel=WIDTH, num_decoder_layers=5, dtype=dtype, **options
    )
    if dtype == torch.float64:  # parameters too, so the bridge copies f64 exactly
        model.double()
    load_jax_variables(model, variables)
    return model


def _random_variables(model, hw, rng):
    """Seeded numpy values for the JAX variable tree of ``model``, from
    ``jax.eval_shape`` (flax's own init takes tens of seconds here):
    LeCun-uniform kernels, small biases, stitch weights in [0.5, 1.5), BN
    affine parameters and running statistics away from identity."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.key(0), jnp.zeros((1, *hw, 3)), train=False)
    )

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
            elif k in ("scale", "weights") or k == "var":
                a = rng.uniform(0.5, 1.5, shape)
            else:  # conv and BN biases, running means
                a = rng.uniform(-0.3, 0.3, shape)
            out[k] = a.astype(np.float32)
        return out

    return {coll: fill(tree, coll) for coll, tree in shapes.items()}


@pytest.fixture(scope="module")
def variables():
    """Variable trees by stitch shape: channel-wise (T, T, C) and (T, T),
    the same but for the stitch weights."""
    rng = np.random.default_rng(5)
    tree = _random_variables(_jax_model(), TRAIN_HW, rng)
    params = {
        k: {"weights": rng.uniform(0.5, 1.5, (2, 2)).astype(np.float32)}
        if k.startswith(("enc_stitches_", "dec_stitches_")) else v
        for k, v in tree["params"].items()
    }
    return {True: tree, False: {"params": params, "batch_stats": tree["batch_stats"]}}


def test_registry_param_count_matches_jax():
    args = type("Args", (), {"model_name": "csnet"})()
    jmodel = jax_build_model(args, jax_fetch_data_cfg("cityscapes"))
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 128, 256, 3)), train=False)
    )
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    model = build_model("csnet", fetch_data_cfg("cityscapes"), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == want == 13_382_516
    assert not model.training and model.task_names == ["depth", "segm"]
    assert not model.upsample_skips
    assert tuple(model.enc_stitches_0.weights.shape) == (2, 2, 16)
    assert not model.enc_stitches_0.full_mix
    # strict both ways on the trained tree: every leaf consumed
    full = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    load_jax_variables(model, full)
    assert all(float(p.detach().abs().max()) == 0.0 for p in model.parameters())


def test_bridge_is_strict_on_the_csnet_tree(variables):
    tree = variables[True]
    model = _port(tree)
    before = copy.deepcopy(model.state_dict())

    missing = copy.deepcopy(tree)
    del missing["params"]["dec_stitches_2"]["weights"]
    with pytest.raises(ValueError, match="dec_stitches_2/weights"):
        load_jax_variables(model, missing)

    extra = copy.deepcopy(tree)
    extra["params"]["enc_stitches_6"] = {"weights": np.zeros((2, 2, 160), np.float32)}
    with pytest.raises(ValueError, match="not consumed"):
        load_jax_variables(model, extra)

    wrong = copy.deepcopy(tree)
    wrong["params"]["enc_stitches_1"]["weights"] = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError, match="enc_stitches_1/weights"):
        load_jax_variables(model, wrong)

    # the scalar-stitch tree does not fit the channel-wise model
    with pytest.raises(ValueError, match="weights"):
        load_jax_variables(model, variables[False])

    for k, v in model.state_dict().items():  # a failed load leaves the model as it was
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("options", list(OPTION_SETS))
def test_eval_forward_matches_jax(variables, options):
    opts = OPTION_SETS[options]
    tree = variables[opts.get("channel_wise_stitching", True)]
    img = np.random.default_rng(1).uniform(size=(2, *EVAL_HW, 3)).astype(np.float32)
    jmodel = _jax_model(**opts)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(tree, jnp.asarray(img))
    model = _port(tree, **opts)
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    assert list(got) == ["depth", "segm"]
    for k in TASKS:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape == (2, *EVAL_HW, TASKS[k]), k
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(
            got[k].numpy(), w, rtol=2e-4, atol=2e-4 * float(np.abs(w).max()), err_msg=k
        )


def test_stitch_keeps_bf16_and_computes_in_f32():
    """A bf16 map is scaled in f32 and rounded once, as JAX does, in both
    modes."""
    rng = np.random.default_rng(2)
    maps = [torch.from_numpy(rng.normal(size=(1, 3, 4, 6)).astype(np.float32)).bfloat16()
            for _ in range(2)]
    for full_mix in (False, True):
        layer = cross_stitch.CrossStitchLayer(2, 6, full_mix)
        layer.reset_parameters(torch.Generator().manual_seed(0))
        w = layer.weights.detach()
        got = layer(maps)
        x = [m.float() for m in maps]
        for a in range(2):
            want = w[a, 0] * x[0] + w[a, 1] * x[1] if full_mix else w[a, a] * x[a]
            assert got[a].dtype == torch.bfloat16
            assert torch.equal(got[a], want.bfloat16()), (full_mix, a)


# the projection BN biases of encoder stages 3 and 5 reach the loss only
# through a per-channel stitch scale, a 1x1 conv and a batch-statistic BN:
# their gradient is 0 up to rounding, as in the basic model
ZERO_GRAD = re.compile(r"stages_[35]_\d\.BatchNorm_2\.bias$")


def test_one_train_step_matches_jax(variables):
    """The port's step against JAX's gradient of the same train-mode loss,
    both in f64 (JAX's f32 BN variance drifts, ROADMAP C1): loss within
    1e-5, every gradient within 1e-3 of its leaf's largest magnitude
    (``ZERO_GRAD``: both under 1e-6 of the largest gradient), running
    statistics within 1e-5.

    The port runs in f64 as well: JAX's stitch casts to f32 even under x64,
    so its step carries f32 rounding at eleven points, and the port's f32
    step misses it by more than that limit in the encoders' head-BN running
    variance (8 values a channel). The f32 step is held to an f64 witness
    at full width on the card by ``chip_smoke.py``."""
    tree = variables[True]
    ds = SyntheticMTLDataset(
        stage="train",
        cfg=SyntheticConfig(height=TRAIN_HW[0], width=TRAIN_HW[1], num_classes=NC,
                            num_train=TRAIN_BATCH),
    )
    samples = [ds[k] for k in range(TRAIN_BATCH)]
    batch = {
        "img": np.stack([s["img"] for s in samples]).astype(np.float64),
        "mask": np.stack([s["mask"] for s in samples]).astype(np.int32),
        "depth": np.stack([s["depth"] for s in samples]).astype(np.float64),
    }
    with jax.enable_x64(True):
        jmodel = _jax_model(jnp.float64)

        def loss_fn(params, batch_stats, b):
            losses, _, new_stats = jax_step._forward_and_losses(
                jmodel, params, batch_stats, b, True, 1.0, 1.0
            )
            return losses["loss"], new_stats

        f64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            f64["params"], f64["batch_stats"], {k: jnp.asarray(v) for k, v in batch.items()}
        )
        loss, grads, new_stats = float(loss), jax.device_get(grads), jax.device_get(new_stats)
    model = _port(tree, torch.float64)
    state = create_train_state(model, LR, device="cpu")
    _, _, losses = make_train_step(device="cpu")(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, init_metrics(NC, "cpu")
    )
    assert losses["loss"].dtype == torch.float64
    assert float(losses["loss"]) == pytest.approx(loss, rel=1e-5)

    def as_port(sub, coll):  # an f64 twin module holding the JAX tree
        other = "batch_stats" if coll == "params" else "params"
        twin = _port({coll: sub, other: tree[other]}, torch.float64)
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
    assert float(model.dec_stitches_0.weights.grad.abs().max()) > 0.0


def test_trained_width_routes_twelve_convs_through_b3(monkeypatch):
    """At decoder_first_channel=256 exactly the 64->64, 80->32, 32->32,
    32->16 and 16->16 decoder convs and the 16->1 and 16->19 heads of each
    task take kernel B3, one call each per forward; block 2's first conv
    (152 channels in) does not. Driven module by module on tiny inputs, not
    through the full model."""
    model = build_model("csnet", fetch_data_cfg("cityscapes"), dtype=torch.float32, device="cpu")
    routed = [n for n, m in model.named_modules() if isinstance(m, blocks.Conv) and m.small_conv]
    per_task = ["2.ConvBNAct_1", "3.ConvBNAct_0", "3.ConvBNAct_1", "4.ConvBNAct_0",
                "4.ConvBNAct_1"]
    assert routed == [f"decoders_{t}_{b}.Conv_0" for t in (0, 1) for b in per_task] + [
        "heads_0.Conv_0", "heads_1.Conv_0"
    ]
    calls = []
    real = small_conv_op.conv3x3_small

    def counting(x, kernel, bias=None):
        calls.append((x.shape[-1], kernel.shape[-1]))
        return real(x, kernel, bias)

    monkeypatch.setattr(small_conv_op, "conv3x3_small", counting)
    with torch.no_grad():
        for t in (0, 1):
            x = getattr(model, f"decoders_{t}_2")(torch.zeros(1, 2, 2, 152))
            x = getattr(model, f"decoders_{t}_3")(torch.zeros(1, 2, 2, 80))
            x = getattr(model, f"decoders_{t}_4")(torch.zeros(1, 2, 2, 32))
            out = getattr(model, f"heads_{t}")(x)
            assert out.shape == (1, 2, 2, (1, 19)[t])
    block = [(64, 64), (80, 32), (32, 32), (32, 16), (16, 16)]
    assert calls == block + [(16, 1)] + block + [(16, 19)]


def test_joint_layer_names_match_jax():
    for n in (3, 5):
        assert cross_stitch.get_joint_layer_names(n) == jax_cross_stitch.get_joint_layer_names(n)


def test_serve_demo_csnet(monkeypatch):
    """``serve --demo --model_name csnet`` at the synthetic config on the
    CPU answers a request over HTTP."""
    servers = []
    make = serve.make_server

    def capture(*args, **kwargs):
        servers.append(make(*args, **kwargs))
        return servers[-1]

    monkeypatch.setattr(serve, "make_server", capture)
    argv = ["--demo", "--model_name", "csnet", "--dataset_name", "synthetic",
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
            assert json.loads(r.read())["model"] == "csnet"
    finally:
        httpd.shutdown()
        th.join(timeout=60)
    assert not th.is_alive()
