"""The port's ``vis``, ``utils/inference``, ``utils/debug`` and
``utils/profiling`` against the JAX package's on the CPU: masks coloured
exactly, figures rasterised pixel for pixel alike, ``get_segm_preds`` to
1e-6 with exact ids, the debug helpers' lookups, errors and printout, the
step timer under one clock, and a profiler trace that holds an annotated
region."""

import glob
import json
import os
import time

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vision_mtl_tpu import vis as jax_vis  # noqa: E402
from vision_mtl_tpu.cfg import cityscapes_data_cfg  # noqa: E402
from vision_mtl_tpu.utils import debug as jax_debug  # noqa: E402
from vision_mtl_tpu.utils import profiling as jax_profiling  # noqa: E402
from vision_mtl_tpu.utils.inference import get_segm_preds as jax_get_segm_preds  # noqa: E402
from vision_mtl_tpu_torch import vis  # noqa: E402
from vision_mtl_tpu_torch.cfg import cfg  # noqa: E402
from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet  # noqa: E402
from vision_mtl_tpu_torch.utils import debug, profiling  # noqa: E402
from vision_mtl_tpu_torch.utils.inference import get_segm_preds  # noqa: E402

B, H, W, C = 2, 8, 10, 19


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    plt.close("all")


def test_colorize_mask_matches_jax(rng):
    mask = rng.integers(-3, 25, size=(7, 9))
    got = vis.colorize_mask(mask)
    np.testing.assert_array_equal(got, jax_vis.colorize_mask(mask))
    np.testing.assert_array_equal(cfg.vis.rgb_palette, jax_vis.cfg.vis.rgb_palette)
    assert got.dtype == np.uint8 and got.shape == (7, 9, 3)
    palette = np.arange(12).reshape(4, 3)
    np.testing.assert_array_equal(vis.colorize_mask(mask, palette),
                                  jax_vis.colorize_mask(mask, palette))


def _raster(fig):
    arr = vis.convert_figure_to_image(fig)
    plt.close(fig)
    return arr


def _inputs(rng, wire):
    img = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    depth = rng.uniform(size=(B, H, W, 1)).astype(np.float32)
    if wire == "compact":
        img = (img * 255).astype(np.uint8)
        depth = (depth * 65535).astype(np.uint16)
    return {"img": img, "mask": rng.integers(0, C, size=(B, H, W)).astype(np.uint8),
            "depth": depth}


@pytest.mark.parametrize("wire", ["f32", "compact"])
def test_figures_match_jax_pixel_for_pixel(rng, wire):
    """``plot_preds`` (with ground truth and without), ``plot_sample``,
    ``plot_batch`` and ``plot_annotated_segm_mask`` rasterise to the JAX
    package's pixels on the same inputs, the compact wire decoded."""
    inputs = _inputs(rng, wire)
    preds = {"segm": rng.integers(0, C, size=(B, H, W)).astype(np.int32),
             "depth": rng.uniform(size=(B, H, W, 1)).astype(np.float32)}
    mask = inputs["mask"][0].astype(np.int64)
    mask[0, 0] = -1
    for name, args in (("plot_preds", (B, inputs, preds)),
                       ("plot_preds", (B, {"img": inputs["img"]}, preds)),
                       ("plot_sample", (inputs["img"][0], inputs["mask"][0], inputs["depth"][0])),
                       ("plot_batch", (inputs,)),
                       ("plot_annotated_segm_mask",
                        (inputs["img"][0], mask, cityscapes_data_cfg.class_names))):
        got = _raster(getattr(vis, name)(*args))
        want = _raster(getattr(jax_vis, name)(*args))
        assert got.shape == want.shape and got.dtype == np.uint8, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_get_segm_preds_matches_jax(rng):
    logits = rng.normal(size=(B, H, W, C)).astype(np.float32)
    valid = rng.uniform(size=(B, H, W)) > 0.4
    probs, preds = get_segm_preds(torch.from_numpy(valid), torch.from_numpy(logits).bfloat16())
    want_probs, want_preds = jax_get_segm_preds(valid, torch.from_numpy(logits).bfloat16()
                                                .float().numpy())
    assert probs.dtype == torch.float32 and preds.dtype == torch.int32
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(want_preds))
    assert (preds.numpy()[~valid] == -1).all() and (probs.numpy()[~valid] == 0).all()


def test_get_module_by_name():
    """A state dict (by its flat key, or walked as a mapping), a nested
    mapping and a module resolve a dotted path; a missing segment raises
    JAX's ``KeyError``."""
    model = MTANMiniUnet({"depth": 1, "segm": 3}, task_subnets_hidden_channels=4,
                         encoder_first_channel=4, encoder_num_channels=2, dtype=torch.float32)
    sd = model.state_dict()
    key = next(k for k in sd if k.count(".") >= 2)
    assert debug.get_module_by_name(sd, key) is sd[key]
    module_path, _, leaf = key.rpartition(".")
    sub = debug.get_module_by_name(model, module_path)
    assert isinstance(sub, torch.nn.Module) and torch.equal(getattr(sub, leaf), sd[key])
    assert torch.equal(debug.get_module_by_name(model, key), sd[key])
    tree = {"a": {"b": {"kernel": 1}}}
    assert debug.get_module_by_name(tree, "a.b.kernel") == 1
    for mod in (debug, jax_debug):
        with pytest.raises(KeyError) as e:
            mod.get_module_by_name(tree, "a.c.kernel")
        assert e.value.args[0] == "'a.c' not in tree (available: ['b'])"
    with pytest.raises(KeyError, match="'nope': node of type MTANMiniUnet has no "
                       "key/attribute 'nope'"):
        debug.get_module_by_name(model, "nope.x")
    with pytest.raises(KeyError, match="not in tree"):
        debug.get_module_by_name(sd, "missing.key")


def test_print_sample_stats_matches_jax(rng, capsys):
    sample = _inputs(rng, "compact")
    jax_debug.print_sample_stats(sample)
    want = capsys.readouterr().out
    debug.print_sample_stats(sample)
    assert capsys.readouterr().out == want
    debug.print_sample_stats({k: torch.from_numpy(v) for k, v in sample.items()})
    assert capsys.readouterr().out == want


def test_step_timer_matches_jax(monkeypatch):
    """Under one clock both timers report the same images per second,
    windowed the same way."""
    times = np.cumsum(np.random.default_rng(0).uniform(0.01, 0.2, size=20)).tolist()
    port, want = profiling.StepTimer(window=5), jax_profiling.StepTimer(window=5)
    assert port.images_per_sec == want.images_per_sec == 0.0
    for i, now in enumerate(times):
        monkeypatch.setattr(time, "perf_counter", lambda now=now: now)
        port.tick(8 + i % 3)
        want.tick(8 + i % 3)
        assert port.images_per_sec == want.images_per_sec
    assert port.images_per_sec > 0 and len(port._times) == 6


def test_trace_writes_an_annotated_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("vmtl_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(os.path.join(tmp_path, "*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name") == "vmtl_region" for e in events)
