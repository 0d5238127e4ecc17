"""What the benchmark counts on the CPU: the operations per image written
in the configurations, recounted on the reference; the kernels' bytes and
operations from the shape tables; the per-layer readers on a made trace;
the trace's union of device intervals."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import costs, harness, reference, seeded
from portbench.readings import Readings
from portbench.reference.common import init_bounds
from portbench.tests import tiny
from portbench.trace import Trace, parse

BENCH = harness.load_benchmark(tiny.ROOT)
CONFIGS = {c["name"]: json.loads((tiny.ROOT / c["file"]).read_text()) for c in BENCH["configs"]}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_flops_per_image_recounted(name):
    """``torch.utils.flop_counter`` over the reference on meta tensors at the
    configuration's shapes gives the operations written in its file."""
    cfg = CONFIGS[name]
    x = torch.empty(2, cfg["height"], cfg["width"], 3, device="meta")
    with torch.device("meta"):
        model = reference.build(cfg)
    with FlopCounterMode(display=False) as fwd:
        model(x)
    with FlopCounterMode(display=False) as step:
        out = model(x)
        (out["segm"].sum() + out["depth"].sum()).backward()
    assert fwd.get_total_flops() / 2 == cfg["flops_per_image"]["forward"]
    assert step.get_total_flops() / 2 == cfg["flops_per_image"]["train"]
    params = sum(p.numel() for p in model.parameters())
    assert params == cfg["parameters"]


#: per configuration, at ``tiny.SEED`` on the CPU: the leaves drawn from the
#: seed (those with an init bound) and the sum of the absolute values of all
#: the weights; read before the reference was found by the model's name, so
#: the draw's order is held across that move
WEIGHTS = {"mtan-cityscapes": (142, 182915.46139986732),
           "basic-cityscapes": (92, 195198.9368976745)}


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_seeded_weights_pinned(name):
    cfg = CONFIGS[name]
    with torch.device("meta"):
        drawn = len(init_bounds(reference.build(cfg)))
    weights = seeded.weights(cfg, tiny.SEED, torch.device("cpu"))
    total = sum(float(v.double().abs().sum()) for v in weights.values())
    assert (drawn, total) == (WEIGHTS[name][0], pytest.approx(WEIGHTS[name][1], rel=1e-12))


def test_gate_bytes_and_bound_at_batch_32():
    """B4 at MTAN's eight gate shapes, two tasks, batch 32, bf16: 2.35 GB of
    activations a step, bound by bytes (0.70 ms) rather than operations."""
    cfg = CONFIGS["mtan-cityscapes"]
    total_bytes = total_flops = 0.0
    for _, cin, c2, h, w in cfg["gate_shapes"]:
        flops, nbytes = costs.gate(32 * h * w, cin, c2, 128, 2, train=True)
        total_bytes += 2 * nbytes
        total_flops += 2 * flops
        assert costs.least_s(flops, nbytes)[1] == "bytes"
    act = sum(2 * 32 * h * w * (cin + 2 * c2) * 2 for _, cin, c2, h, w in cfg["gate_shapes"])
    assert act == pytest.approx(2.35e9, rel=0.01)
    assert total_bytes == pytest.approx(act, rel=0.01)
    assert total_bytes / costs.HBM_BYTES_PER_S == pytest.approx(7.0e-4, rel=0.02)
    assert total_flops / costs.BF16_FLOPS_PER_S < total_bytes / costs.HBM_BYTES_PER_S


def test_small_conv_counts():
    flops, nbytes = costs.conv3x3(64, 128, 256, 33, 20, True, 2)
    assert flops == 2 * 64 * 128 * 256 * 33 * 20 * 9
    assert nbytes == 2 * 64 * 128 * 256 * 53 + 4 * (9 * 33 * 20 + 20)
    assert costs.least_s(flops, nbytes)[1] == "bytes"


def _trace(device):
    return Trace(device=device, host=[("aten::copy_", 0.0, 100.0)], start_us=0.0,
                 end_us=100.0)


def test_union_of_overlapping_streams_and_gaps():
    t = _trace([("k1", 0.0, 10.0), ("nccl x", 5.0, 10.0), ("k2", 40.0, 20.0)])
    assert t.busy_us() == 35.0
    assert t.idle_gaps() == [["aten::copy_", 40e-6], ["aten::copy_", 25e-6]]
    cats = dict(map(tuple, t.categories()))
    assert cats["collectives (NCCL)"] == 10e-6


def test_parse_clips_to_the_window():
    chrome = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 10, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 55, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "c", "ts": 70, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 12, "dur": 3},
    ]}
    t = parse(chrome)
    assert t.device == [("a", 10.0, 10.0), ("b", 55.0, 5.0)]
    assert t.window_us == 50.0 and t.busy_us() == 15.0


def _readings(kind, cell, launches, device, steps=2, **extra):
    r = harness.make_run(BENCH, cell, 1, 1.0, True, None, 0.0)
    return Readings(kind=kind, config=r.config, traffic=r.traffic, chips=1, rate=100.0,
                    trace=_trace(device), launches=launches, steps=steps, **extra)


def test_b4_roofline_reads_the_launches_it_was_counted_for():
    reader = harness.metric_module("b4_roofline.train")
    cfg = CONFIGS["mtan-cityscapes"]
    least = sum(costs.least_s(*costs.gate(32 * h * w, cin, c2, 128, 2, True))[0]
                for _, cin, c2, h, w in cfg["gate_shapes"]) * 2 * 2
    device = [("void gate_train_kernel<bf16>", 0.0, 50.0), ("aten::add", 50.0, 10.0)]
    r = _readings("train", "mtan-cityscapes.train-b32", {"fused_attention_gate_train": 32}, device)
    assert reader.read(r) == pytest.approx(100.0 * least / 50e-6)
    r.launches = {"fused_attention_gate_train": 31}  # a launch not counted: no reading
    assert reader.read(r) is None
    r.launches, r.trace = {"fused_attention_gate_train": 32}, _trace([("aten::add", 0.0, 1.0)])
    assert reader.read(r) is None


def test_b3_and_b1_rooflines_and_serve_metrics():
    cfg = CONFIGS["basic-cityscapes"]
    r = _readings("train", "basic-cityscapes.train-b256", {"conv3x3_small": 16},
                  [("conv3x3_small_tc_kernel", 0.0, 80.0)])
    least = sum(costs.least_s(*costs.conv3x3(256, h, w, c, o, b, 2))[0] * n
                for _, c, o, h, w, b, n in cfg["small_conv_shapes"]) * 2
    assert harness.metric_module("b3_roofline.train").read(r) == pytest.approx(
        100.0 * least / 80e-6)
    window = {"batched_images": 90, "padded_slots": 10, "batches": 5}
    traced = {"batched_images": 40, "padded_slots": 8, "batches": 3}
    s = _readings("serve", "mtan-cityscapes.serve-over", {"fused_attention_gate": 48},
                  [("gate_kernel<bf16>", 0.0, 30.0), ("x", 40.0, 20.0)],
                  serve_window=window, serve_traced=traced)
    assert harness.metric_module("batch_fill.serve").read(s) == pytest.approx(90.0)
    assert harness.metric_module("idle_share.serve").read(s) == pytest.approx(50.0)
    mfu = harness.metric_module("mfu.serve").read(s)
    assert mfu == pytest.approx(100.0 * 33552334848 * 100.0 / 989e12)
    b1 = harness.metric_module("b1_roofline.serve").read(s)
    cfg = CONFIGS["mtan-cityscapes"]
    least = 0.0
    for _, cin, c2, h, w in cfg["gate_shapes"]:
        flops, nbytes = costs.gate(48 * h * w, cin, c2, 128, 2, False)
        nbytes += 2 * costs.gate(0, cin, c2, 128, 2, False)[1]
        least += 2 * costs.least_s(flops, nbytes)[0]
    assert b1 == pytest.approx(100.0 * (least / 48) / 30e-6)  # one kernel seen, 30 us
    s.launches = {"fused_attention_gate": 50}  # a batch half dispatched at an edge
    assert harness.metric_module("b1_roofline.serve").read(s) == pytest.approx(b1)
    s.launches = {"fused_attention_gate": 70}
    assert harness.metric_module("b1_roofline.serve").read(s) is None
