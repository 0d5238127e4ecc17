#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vision_mtl_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``vision_mtl_tpu_torch/csrc``,
holds each against its plain PyTorch version at the shapes of MTAN's main
path, then drives that path at the trained width (Cityscapes 128x256, 19
classes, seeded random weights): a ``BatchingServer`` answering concurrent
requests, a timed ``Predictor(8)``, and a predict-eval sweep with metrics.
The launch counters show that the path went through both kernels. Any
mismatch or error ends the run with a non-zero exit; without a CUDA card it
exits 2 and prints no result.

Tolerances, kernel against plain version:
  * fused_attention_gate, f32: max |diff| <= 1e-4 (sums of up to 640 f32
    products taken in another order);
  * fused_attention_gate, bf16: |diff| <= 2^-7 |plain| + 1e-6 elementwise
    (one bf16 rounding step of the f32 result);
  * confusion_matrix: exact (integer counts).

The model's output is held against a reference too: the f32 forward on the
card (kernels, cuDNN without TF32) against the same seeded weights on the
CPU (plain versions) on one full-width image, max |diff| <= 1e-4 of the
output's largest magnitude and argmax agreement >= 99.9%; the served bf16
answers against a direct ``Predictor(8)`` (>= 99% argmax agreement, depth
within 0.05); the predict-eval accuracy against an independent numpy count.

``bound_ms`` is the least time the card could take for the same work: the
larger of the bytes moved (each input read once, each output written once)
at 3.35 TB/s and the operations at the peak for their type (the gate's
products are f32: 67 TFLOP/s outside the tensor cores), from the H100 SXM
data sheet at 700 W.

Lines before the last: per-shape gate results, the model's numbers, the
``kernels`` JSON line, the card's name and power limit. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BATCH = 8
BUCKETS = (1, 4, 8)
N_REQUESTS = 16
N_EVAL_BATCHES = 3
GATES_PER_FORWARD = 16
# (level, Cin, C2, H, W) of MTAN's gates at 128x256, hidden 128
GATE_SHAPES = [
    ("enc0", 3, 32, 128, 256),
    ("enc1", 64, 64, 64, 128),
    ("enc2", 128, 128, 32, 64),
    ("enc3", 256, 256, 16, 32),
    ("dec0", 640, 256, 16, 32),
    ("dec1", 384, 128, 32, 64),
    ("dec2", 256, 64, 64, 128),
    ("dec3", 192, 32, 128, 256),
]
HIDDEN = 128


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_gate(dev, fused_gate) -> tuple:
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, totals = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0}
    by_flops = by_bytes = 0.0
    for level, cin, c2, h, w in GATE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(BATCH, h, w, cin, generator=gen, device=dev).to(dtype)
            shared = torch.randn(BATCH, h, w, c2, generator=gen, device=dev).to(dtype)
            w1 = (torch.rand(cin, HIDDEN, generator=gen, device=dev) * 2 - 1) / cin**0.5
            c1 = torch.randn(HIDDEN, generator=gen, device=dev) * 0.1
            w2 = (torch.rand(HIDDEN, c2, generator=gen, device=dev) * 2 - 1) / HIDDEN**0.5
            c2v = torch.randn(c2, generator=gen, device=dev) * 0.1
            args = (x, shared, w1, c1, w2, c2v)
            got = fused_gate.fused_attention_gate(*args)
            want = fused_gate.fused_attention_gate_plain(*args)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            if dtype == torch.float32:
                ok = err <= 1e-4
            else:
                ok = bool((diff <= want.float().abs() * 2**-7 + 1e-6).all())
            if not ok or not torch.isfinite(got).all():
                fail(f"fused_attention_gate {level} {dtype}: max |diff| {err}")
            n = BATCH * h * w
            es = x.element_size()
            nbytes = es * n * (cin + 2 * c2) + 4 * (cin * HIDDEN + HIDDEN + HIDDEN * c2 + c2)
            flops = 2.0 * n * (cin * HIDDEN + HIDDEN * c2)
            b_ms, b_by = bound(nbytes, flops)
            row = {
                "level": level, "dtype": str(dtype).replace("torch.", ""),
                "N": n, "Cin": cin, "C2": c2, "max_abs_err": err,
                "ms": time_ms(lambda: fused_gate.fused_attention_gate(*args)),
                "plain_ms": time_ms(lambda: fused_gate.fused_attention_gate_plain(*args)),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            rows.append(row)
            totals["err"] = max(totals["err"], err)
            if dtype == torch.bfloat16:  # the main path's dtype: 2 tasks per level
                for k in ("ms", "plain_ms", "bound_ms"):
                    totals[k] += 2 * row[k]
                by_flops += 2 * flops / F32_FLOPS_PER_S
                by_bytes += 2 * nbytes / HBM_BYTES_PER_S
    totals["bound_by"] = "operations" if by_flops >= by_bytes else "bytes"
    return rows, totals


def check_confmat(dev, confmat, num_classes: int) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1)
    shape = (BATCH, 128, 256)
    t = torch.randint(-1, num_classes + 2, shape, generator=gen, device=dev, dtype=torch.int32)
    t[0, :4, :4] = 255  # an ignore-style label outside [0, C)
    p = torch.randint(0, num_classes + 1, shape, generator=gen, device=dev, dtype=torch.int32)
    valid = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], device=dev, dtype=torch.bool)
    mask = valid[:, None, None].expand(shape).contiguous()
    got = confmat.confusion_matrix(t, p, num_classes, mask)
    want = confmat.confusion_matrix_plain(t, p, num_classes, mask)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if err != 0.0:
        fail(f"confusion_matrix: max |diff| {err}, want exact")
    n = t.numel()
    keep = mask & (t >= 0) & (t < num_classes) & (p >= 0) & (p < num_classes)
    idx = torch.where(keep, t * num_classes + p, num_classes * num_classes).long().reshape(-1)
    b_ms, b_by = bound(n * (4 + 4 + 1) + 4 * num_classes**2, float(n))
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: confmat.confusion_matrix(t, p, num_classes, mask)),
        "plain_ms": time_ms(lambda: confmat.confusion_matrix_plain(t, p, num_classes, mask)),
        "library_ms": time_ms(lambda: torch.bincount(idx, minlength=num_classes**2 + 1)),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


def check_model_against_cpu(cfg, build_model, dev) -> dict:
    """f32 forward of the full-width model on the card (kernels) against the
    same weights on the CPU (plain versions), one image."""
    img = np.random.default_rng(2).uniform(size=(1, cfg.height, cfg.width, 3)).astype(np.float32)
    ref = build_model("mtan", cfg, dtype=torch.float32, device="cpu", seed=0)
    gpu = build_model("mtan", cfg, dtype=torch.float32, device=dev, seed=0)
    with torch.inference_mode():
        want = ref(torch.from_numpy(img))
        got = {k: v.cpu() for k, v in gpu(torch.from_numpy(img).to(dev)).items()}
    out = {}
    for k in want:
        scale = float(want[k].abs().max())
        err = float((got[k] - want[k]).abs().max())
        out[f"{k}_max_abs_err"] = err
        out[f"{k}_max_abs"] = scale
        # cuDNN and the CPU sum in other orders: 1e-4 of the output's scale
        if not torch.isfinite(got[k]).all() or err > 1e-4 * scale:
            fail(f"MTAN f32 {k}: card vs CPU max |diff| {err} (scale {scale})")
    agree = float((got["segm"].argmax(-1) == want["segm"].argmax(-1)).float().mean())
    out["segm_argmax_agreement"] = agree
    if agree < 0.999:
        fail(f"MTAN f32 segm argmax agrees with the CPU on only {agree:.5f}")
    return out


def serve_requests(model, cfg, dev, kernels) -> dict:
    from vision_mtl_tpu_torch.serving import BatchingServer, Predictor

    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, size=(N_REQUESTS, cfg.height, cfg.width, 3), dtype=np.uint8)
    kernels.reset_launch_counts()
    with BatchingServer(
        model, cfg.height, cfg.width, buckets=BUCKETS, dtype=np.uint8,
        compact_out=True, device=dev,
    ) as server:
        server.warmup()
        with concurrent.futures.ThreadPoolExecutor(N_REQUESTS) as pool:
            outs = list(pool.map(server.predict, imgs))
        stats = server.stats()
    counts = kernels.launch_counts()
    forwards = len(BUCKETS) + stats["batches"]
    if counts["fused_attention_gate"] != GATES_PER_FORWARD * forwards or counts["confusion_matrix"]:
        fail(f"serving: launches {counts} for {forwards} forwards")
    if stats["requests"] != N_REQUESTS or stats["batched_images"] != N_REQUESTS:
        fail(f"serving: stats {stats}")
    direct = Predictor(model, BATCH, cfg.height, cfg.width, dtype=np.uint8, compact_out=True, device=dev)
    ref = {k: np.concatenate([direct(imgs[i:i + BATCH])[k] for i in range(0, N_REQUESTS, BATCH)])
           for k in ("segm", "depth")}
    for i, o in enumerate(outs):
        if o["segm"].shape != (cfg.height, cfg.width) or o["segm"].dtype != np.uint8:
            fail(f"serving: segm {o['segm'].shape} {o['segm'].dtype}")
        if o["depth"].shape != (cfg.height, cfg.width, 1) or o["depth"].dtype != np.float16:
            fail(f"serving: depth {o['depth'].shape} {o['depth'].dtype}")
        if not np.isfinite(o["depth"]).all() or o["segm"].max() >= cfg.num_classes:
            fail("serving: non-finite depth or class id out of range")
    segm = np.stack([o["segm"] for o in outs])
    depth = np.stack([o["depth"] for o in outs]).astype(np.float32)
    agree = float((segm == ref["segm"]).mean())
    depth_err = float(np.abs(depth - ref["depth"].astype(np.float32)).max())
    # batches of another size may take other convolution algorithms, so
    # bf16 argmax near-ties may flip; the depth stays within bf16 noise
    if agree < 0.99 or depth_err > 0.05:
        fail(f"serving vs Predictor(8): segm agreement {agree}, depth max |diff| {depth_err}")
    return {"launches": counts, "stats": stats, "segm_agreement_vs_predictor": agree,
            "depth_max_abs_err_vs_predictor": depth_err}


def time_predictor(model, cfg, dev, kernels) -> dict:
    from vision_mtl_tpu_torch.serving import Predictor, latency_bench

    imgs = np.random.default_rng(4).integers(
        0, 256, size=(BATCH, cfg.height, cfg.width, 3), dtype=np.uint8
    )
    pred = Predictor(model, BATCH, cfg.height, cfg.width, dtype=np.uint8, compact_out=True, device=dev)
    kernels.reset_launch_counts()
    lat = latency_bench(pred, imgs, n=30, warmup=3)
    counts = kernels.launch_counts()
    if counts["fused_attention_gate"] != GATES_PER_FORWARD * 33:
        fail(f"Predictor timing: launches {counts} for 33 forwards")
    x = torch.from_numpy(imgs).to(dev).float() / 255.0
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(x), iters=10)
    return {**lat, "img_per_s": BATCH / lat["p50_ms"] * 1e3, "forward_events_ms": fwd_ms,
            "launches": counts, "profile": profile_forward(model, x)}


def profile_forward(model, x, n: int = 5) -> dict:
    """Device time by kernel over ``n`` forwards, from torch.profiler: where
    a forward's time goes and how long the card idles. Reports "not
    measured" if the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / n * 1e3
    kernels = [
        (e.key, e.self_device_time_total / 1e3 / n, e.count // n)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    if not kernels:
        return {"device_busy_ms": "not measured", "wall_ms_profiled": wall_ms}
    busy = sum(ms for _, ms, _ in kernels)
    kernels.sort(key=lambda k: -k[1])
    return {
        "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "device_ops_per_forward": sum(c for _, _, c in kernels),
        "top": [{"name": k[:80], "ms": ms, "calls": c} for k, ms, c in kernels[:10]],
    }


def predict_eval(model, cfg, dev, kernels) -> dict:
    from vision_mtl_tpu_torch.predict import predict

    rng = np.random.default_rng(5)
    c, hw = cfg.num_classes, (cfg.height, cfg.width)
    batches = []
    for i in range(N_EVAL_BATCHES):
        valid = np.ones(BATCH, np.float32)
        if i == N_EVAL_BATCHES - 1:
            valid[-2:] = 0.0  # a padded final batch
        batches.append({
            "img": rng.integers(0, 256, size=(BATCH, *hw, 3), dtype=np.uint8),
            "mask": rng.integers(0, c, size=(BATCH, *hw)).astype(np.int32),
            "depth": rng.integers(0, 65536, size=(BATCH, *hw, 1)).astype(np.uint16),
            "valid": valid,
        })
    kernels.reset_launch_counts()
    preds, metrics = predict(batches, model, c, device=dev)
    counts = kernels.launch_counts()
    if counts != {"fused_attention_gate": GATES_PER_FORWARD * N_EVAL_BATCHES,
                  "confusion_matrix": N_EVAL_BATCHES}:
        fail(f"predict-eval: launches {counts}")
    if not all(np.isfinite(v) for v in metrics.values()) or len(metrics) != 7:
        fail(f"predict-eval: metrics {metrics}")
    # independent check of the confusion matrix: numpy counts over the
    # returned (valid) predictions
    cm = np.zeros((c, c), np.int64)
    for b, p in zip(batches, preds):
        n = p["segm"].shape[0]
        np.add.at(cm, (b["mask"][:n].ravel(), p["segm"].ravel()), 1)
    n_valid = int(sum(b["valid"].sum() for b in batches)) * hw[0] * hw[1]
    if cm.sum() != n_valid:
        fail(f"predict-eval: {cm.sum()} counted pixels, {n_valid} valid")
    accuracy = np.trace(cm) / cm.sum()
    if abs(metrics["predict/accuracy"] - accuracy) > 1e-6:
        fail(f"predict-eval: accuracy {metrics['predict/accuracy']} vs numpy {accuracy}")
    return {"launches": counts, "metrics": metrics, "valid_pixels": n_valid}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 2
    from vision_mtl_tpu_torch import kernels
    from vision_mtl_tpu_torch.cfg import fetch_data_cfg
    from vision_mtl_tpu_torch.kernels import confmat, fused_gate
    from vision_mtl_tpu_torch.models.registry import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0

    gate_rows, gate = check_gate(dev, fused_gate)
    print(json.dumps({"gate_shapes": gate_rows}), flush=True)
    cmat = check_confmat(dev, confmat, 19)

    cfg = fetch_data_cfg("cityscapes")
    reference = check_model_against_cpu(cfg, build_model, dev)
    model = build_model("mtan", cfg, dtype=torch.bfloat16, device=dev, seed=0)
    serving = serve_requests(model, cfg, dev, kernels)
    timing = time_predictor(model, cfg, dev, kernels)
    evaluation = predict_eval(model, cfg, dev, kernels)
    model_line = {
        "model": "mtan", "config": "cityscapes 128x256, 19 classes, bf16",
        "params": sum(p.numel() for p in model.parameters()),
        "reference_f32_vs_cpu": reference, "serving": serving,
        "predictor_8": timing, "predict_eval": evaluation,
        "gate_share_of_forward_events": gate["ms"] / timing["forward_events_ms"],
        "build_s": build_s, "total_s": time.perf_counter() - t_start,
    }
    print(json.dumps({"model": model_line}), flush=True)

    launches = {
        name: serving["launches"][name] + timing["launches"][name] + evaluation["launches"][name]
        for name in kernels.KERNELS
    }
    kernel_line = {"kernels": [
        {
            "name": "fused_attention_gate", "route": "cuda",
            "source": "vision_mtl_tpu_torch/csrc/fused_gate.cu",
            "replaces": "vision_mtl_tpu/ops/pallas/fused_gate.py:103",
            "launches": launches["fused_attention_gate"], "max_abs_err": gate["err"],
            "ms": gate["ms"], "plain_ms": gate["plain_ms"], "bound_ms": gate["bound_ms"],
            "bound_by": gate["bound_by"], "library_ms": None,
        },
        {
            "name": "confusion_matrix", "route": "cuda",
            "source": "vision_mtl_tpu_torch/csrc/confmat.cu",
            "replaces": "vision_mtl_tpu/ops/pallas/confmat.py:91",
            "launches": launches["confusion_matrix"], "max_abs_err": cmat["max_abs_err"],
            "ms": cmat["ms"], "plain_ms": cmat["plain_ms"], "bound_ms": cmat["bound_ms"],
            "bound_by": cmat["bound_by"], "library_ms": cmat["library_ms"],
        },
    ]}
    for k in kernel_line["kernels"]:
        if k["launches"] <= 0:
            fail(f"{k['name']} was never launched on the main path")
    print(json.dumps(kernel_line), flush=True)
    print(smi, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
