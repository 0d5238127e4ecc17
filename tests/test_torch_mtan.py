"""The port's MTAN forward against the JAX model through the weight bridge,
the bridge's strictness, the registry's parameter count and the resize /
pad primitives."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vision_mtl_tpu.cfg import fetch_data_cfg as jax_fetch_data_cfg
from vision_mtl_tpu.models.mtan import MTANMiniUnet as JaxMTAN
from vision_mtl_tpu.models.registry import build_model as jax_build_model
from vision_mtl_tpu.ops import interpolate as jax_interp
from vision_mtl_tpu_torch.cfg import fetch_data_cfg
from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet
from vision_mtl_tpu_torch.models.registry import build_model
from vision_mtl_tpu_torch.ops import interpolate
from vision_mtl_tpu_torch.weights import load_jax_variables

TASKS = {"depth": 1, "segm": 5}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _random_variables(jmodel, x, rng):
    """Seeded numpy values for the JAX variable tree, from ``jax.eval_shape``
    (flax's own init runs eagerly here and takes tens of seconds): kernels
    and the gates' w1, w2 uniform within torch's default bound
    1/sqrt(fan_in), as the JAX init draws them; biases, BN affine
    parameters and running statistics away from identity, as
    tests/test_mtan_csnet_parity.py does."""
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.key(0), jnp.asarray(x), train=False)
    )

    def walk(tree, coll):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, coll)
                continue
            shape = v.shape
            if k in ("kernel", "w1", "w2"):
                bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
                a = rng.uniform(-bound, bound, shape)
            elif k.startswith(("scale", "var")):
                a = rng.uniform(0.5, 1.5, shape)
            else:  # conv, gate and BN biases, running means
                a = rng.uniform(-0.3, 0.3, shape)
            out[k] = a.astype(np.float32)
        return out

    return {coll: walk(tree, coll) for coll, tree in shapes.items()}


@pytest.fixture(scope="module")
def small_mtan():
    rng = np.random.default_rng(7)
    jmodel = JaxMTAN(
        map_tasks_to_num_channels=TASKS,
        task_subnets_hidden_channels=8,
        encoder_first_channel=8,
        encoder_num_channels=3,
        dtype=jnp.float32,
    )
    x = rng.uniform(size=(2, 32, 48, 3)).astype(np.float32)
    return jmodel, _random_variables(jmodel, x, rng), x


def _port(variables):
    model = MTANMiniUnet(
        TASKS,
        task_subnets_hidden_channels=8,
        encoder_first_channel=8,
        encoder_num_channels=3,
        dtype=torch.float32,
    )
    load_jax_variables(model, variables)
    return model


def test_mtan_forward_matches_jax(small_mtan):
    jmodel, variables, x = small_mtan
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    model = _port(variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in TASKS:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]), rtol=2e-4, atol=2e-5, err_msg=k
        )


def test_mtan_bf16_forward_is_close(small_mtan):
    """The default bf16 activations stay near the f32 forward."""
    _, variables, x = small_mtan
    ref = _port(variables)
    model = MTANMiniUnet(
        TASKS, task_subnets_hidden_channels=8, encoder_first_channel=8,
        encoder_num_channels=3,
    )
    load_jax_variables(model, variables)
    with torch.no_grad():
        want = ref(torch.from_numpy(x))
        got = model(torch.from_numpy(x))
    for k in TASKS:
        assert got[k].dtype == torch.bfloat16
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(
            got[k].float().numpy(), want[k].numpy(), atol=0.05 * scale, err_msg=k
        )


def test_bridge_is_strict(small_mtan):
    _, variables, _ = small_mtan
    model = _port(variables)
    before = copy.deepcopy(model.state_dict())

    missing = copy.deepcopy(variables)
    del missing["params"]["enc_attn_1_task0"]["GateChain_0"]["w1"]
    with pytest.raises(ValueError, match="enc_attn_1_task0/GateChain_0/w1"):
        load_jax_variables(model, missing)

    extra = copy.deepcopy(variables)
    extra["batch_stats"]["head_segm"] = {"mean": np.zeros(5, np.float32)}
    with pytest.raises(ValueError, match="not consumed"):
        load_jax_variables(model, extra)

    wrong = copy.deepcopy(variables)
    wrong["params"]["dec_up_0"]["kernel"] = np.zeros((3, 3, 32, 16), np.float32)
    with pytest.raises(ValueError, match="dec_up_0/kernel"):
        load_jax_variables(model, wrong)

    # a failed load leaves the model as it was
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_registry_param_count_matches_jax():
    args = type("Args", (), {"model_name": "mtan"})()
    jmodel = jax_build_model(args, jax_fetch_data_cfg("cityscapes"))
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 128, 256, 3)), train=False)
    )
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    model = build_model("mtan", fetch_data_cfg("cityscapes"), device="cpu")
    got = sum(p.numel() for p in model.parameters())
    assert got == want == 13_277_908
    assert not model.training


@pytest.mark.parametrize("name", ["cross_stitch"])
def test_registry_other_models_not_ported(name):
    """Every model of the JAX registry is ported: a name it does not know
    raises in both."""
    args = type("Args", (), {"model_name": name})()
    with pytest.raises(NotImplementedError, match="Unknown model name"):
        jax_build_model(args, jax_fetch_data_cfg("synthetic"))
    with pytest.raises(NotImplementedError, match="Unknown model name"):
        build_model(name, fetch_data_cfg("synthetic"), device="cpu")


@pytest.mark.parametrize(
    "in_hw,out_hw", [((4, 6), (8, 12)), ((5, 7), (11, 13)), ((1, 3), (2, 6))]
)
def test_resize_bilinear_matches_jax(rng, in_hw, out_hw):
    x = rng.normal(size=(2, *in_hw, 3)).astype(np.float32)
    want = jax_interp.resize_bilinear_align_corners(jnp.asarray(x), *out_hw)
    got = interpolate.resize_bilinear_align_corners(torch.from_numpy(x), *out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_pad_concat_matches_jax(rng):
    x1 = rng.normal(size=(1, 5, 6, 2)).astype(np.float32)
    x2 = rng.normal(size=(1, 8, 9, 3)).astype(np.float32)
    want = jax_interp.pad_concat(jnp.asarray(x1), jnp.asarray(x2))
    got = interpolate.pad_concat(torch.from_numpy(x1), torch.from_numpy(x2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
