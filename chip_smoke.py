#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vision_mtl_tpu_torch) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels

Builds the hand-written CUDA kernels from ``vision_mtl_tpu_torch/csrc``,
holds each against its plain PyTorch version at the shapes of the main
paths, then drives those paths for both ported models at their trained
widths (Cityscapes 128x256, 19 classes, seeded random weights). MTAN:
serving (a ``BatchingServer`` answering concurrent requests, a timed
``Predictor(8)``), a predict-eval sweep with metrics, and training
(``create_train_state`` + ``make_train_step`` for a few warm-up and timed
bf16 steps at batch 8, then one ``make_eval_step``). The basic model
(MobileNetV3 + Unet): a timed ``Predictor(8)``, the predict-eval sweep and
the same training. The launch counters, set to 0 before each path and read
after it, show that each path went through its kernels (exact counts per
forward and per train step). Any mismatch or error ends the run with a
non-zero exit; without a CUDA card it exits 2 and prints no result.

``--kernels`` times the eval gate and the confusion matrix only (the
``gate_shapes`` and ``confmat_mixes`` lines, then the card's name and power
limit) and prints no ``ok`` line. Its wrappers' API is that of earlier
trees, so a copy of this script run from the root of an earlier checkout
times that checkout's kernels the same way: device time beside device
time.

Tolerances, kernel against plain version:
  * fused_attention_gate and the output of fused_attention_gate_train, f32:
    max |diff| <= 1e-4 (sums of up to 640 f32 products taken in another
    order);
  * the same in bf16: |diff| <= 2^-7 |plain| + 1e-6 elementwise (one bf16
    rounding step of the f32 result);
  * the batch statistics of fused_attention_gate_train:
    |diff| <= 1e-5 |plain| + 1e-6 (the plain version sums in f64), and
    bit-identical on a second launch (the kernel's sums run in a fixed
    order);
  * fused_attention_gate: bit-identical on a second launch (no atomics);
  * confusion_matrix: exact (integer counts) on every label mix;
  * conv3x3_small (B3), forward and dx shapes: f32 max |diff| <= 1e-4 of
    the output's largest magnitude (sums of up to 603 products in another
    order), bf16 within one bf16 rounding step as the gates, and
    bit-identical on a second launch.

The model's output is held against a reference too: the f32 forward on the
card (kernels, cuDNN without TF32) against the same seeded weights on the
CPU (plain versions) on one full-width image, max |diff| <= 1e-4 of the
output's largest magnitude and argmax agreement >= 99.9%, for each model;
MTAN's served bf16
answers against a direct ``Predictor(8)`` (>= 99% argmax agreement, depth
within 0.05); the predict-eval accuracy against an independent numpy count.
Training is held against the CPU too: one f32 train step of the same seeded
model at batch 2 on the card (kernels, no TF32) and on the CPU (plain
versions): loss within 1e-4 relative and running statistics within 1e-5
(relative beyond magnitude 1). Their gradients are held to a witness, the
same step in f64 on the CPU: the card's relative L2 distance from it, over
the whole gradient and per parameter, must stay within 3 times the CPU f32
step's (its worst parameter's, per parameter). Where the gradient is 0 up to
rounding (a bias feeding a batch-statistic BN, ``ZERO_GRAD``) both f32 sides
must stay under 1e-3 of the model's largest gradient. A control shows that
these limits can fail: the CPU f32 step with a gate whose input and weights
are rounded to bf16 must fall outside them. The bf16 steps must give finite
losses, and the loss on a repeated batch must fall.

``bound_ms`` is the least time the card could take for the same work: the
larger of the bytes moved (each input read once, each output written once)
at 3.35 TB/s and the operations at the peak for their type, from the H100
SXM data sheet at 700 W. B3's products are those of a bf16 dot with f32
accumulation in the TPU kernel, so its bf16 calls (the tensor-core kernel)
take the bf16 tensor-core peak, 989 TFLOP/s, and its f32 calls (the SIMT
kernel) the f32 peak, 67 TFLOP/s. B3's ``library_ms`` is one ``F.conv2d``
(cuDNN, no TF32) of the same inputs, timed here only. Each gate's function
needs each of its two products once, 2N(Cin hidden + hidden C2) operations
in f32: ``bound_f32_ms`` at the f32 peak. The kernels take them as 3xTF32,
three TF32 products each at 495 TFLOP/s (two for x @ w1 when x is bf16,
which TF32 holds exactly): ``bound_ms`` (the function's products once,
3xTF32, which a kernel could reach) and ``bound_design_ms`` state those
bounds beside them. The design of the eval gate takes x @ w1 once for
every 256 columns of C2 (once at MTAN's widths); that of the train gate runs
three passes, 3xTF32: the second product twice, the first once where pass
1 stores x @ w1 for the other two, with its bytes written once and read
twice, else three times. The confusion matrix's ``library_ms`` is one
``torch.bincount`` of the same cells.

Every kernel's ``ms``, ``plain_ms`` and ``library_ms`` are device time, the
kernels each call launches, each timed by torch.profiler as its mean over
the launches the tracer saw (:func:`device_times`); ``events_ms`` beside
them is
CUDA-event time over back-to-back calls, which the host's time to launch
them bounds once the kernels are short. The confusion matrix is timed on
three label mixes (:func:`confmat_mixes`); its ``kernels`` entry is the
main path's own ids.

Lines before the last: per-shape results of both gates and of B3, each
model's serving and evaluation numbers and training numbers, the confusion
matrix on its label mixes, the ``kernels`` JSON line, the card's name and
power limit. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_TC_FLOPS_PER_S = 495e12
BF16_TC_FLOPS_PER_S = 989e12
BATCH = 8
BUCKETS = (1, 4, 8)
N_REQUESTS = 16
N_EVAL_BATCHES = 3
# kernel launches of one eval forward and of one train step, by model
PER_FORWARD = {"mtan": {"fused_attention_gate": 16}, "basic": {"conv3x3_small": 4}}
PER_TRAIN_STEP = {
    "mtan": {"fused_attention_gate_train": 16, "confusion_matrix": 1},
    "basic": {"conv3x3_small": 8, "confusion_matrix": 1},  # 4 forward, 4 dx
}
LR = 1e-3
TRAIN_WARMUP = 3
TRAIN_TIMED = 12
TRAIN_BATCHES = 4  # cycled: each batch is seen every 4 steps
# device kernels by name, first match wins
PROFILE_CATEGORIES = (
    ("gate kernels (eval and train)", ("gate_kernel<", "gate_train_kernel<")),
    ("confusion matrix", ("confmat_kernel",)),
    ("small conv (B3)", ("conv3x3_small_kernel", "conv3x3_small_tc_kernel")),
    ("convolutions (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "cudnn")),
    ("matrix products (cuBLAS)", ("gemm", "gemv")),
    ("batch norm", ("batch_norm",)),
    ("optimizer (foreach)", ("multi_tensor_apply", "foreach")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise", "copy", "Functor", "fill")),
)
# parameters whose gradient is 0 up to rounding: biases that feed a
# batch-statistic BN (MTAN: the gates' b1, b2; the attention modules' 3x3
# conv biases, each followed by a BatchNorm; basic: the projection BN biases
# of encoder stages 3 and 5, whose outputs reach the loss only through a 1x1
# conv and a BatchNorm)
ZERO_GRAD = re.compile(
    r"(GateChain_0\.b[12]|_attn_\d+_task\d+\.Conv_\d\.bias|stages_[35]_\d\.BatchNorm_2\.bias)$"
)
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
# (call, C, O, H, W, bias) of kernel B3 in a basic train step at 128x256:
# the forward's four convs and the backward's four dx (the same kernel on the
# flipped, transposed weights, O and C swapped, no bias)
SMALL_CONV_SHAPES = [
    ("fwd block_3.conv1", 67, 67, 64, 128, False),
    ("fwd block_4.conv0", 67, 33, 128, 256, False),
    ("fwd block_4.conv1", 33, 33, 128, 256, False),
    ("fwd merged head", 33, 20, 128, 256, True),
    ("dx block_3.conv1", 67, 67, 64, 128, False),
    ("dx block_4.conv0", 33, 67, 128, 256, False),
    ("dx block_4.conv1", 33, 33, 128, 256, False),
    ("dx merged head", 20, 33, 128, 256, False),
]


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


def device_times(fn, n: int = 10, launches: tuple = (), sessions: int = 3) -> dict:
    """Device time of one call by kernel name (and memset or memcpy), from
    torch.profiler over ``sessions`` sessions of ``n`` calls. Unlike
    :func:`time_ms` it does not read the host's time to launch them, which a
    call whose kernels are short can exceed.

    The tracer does not record every launch: sessions have missed kernels
    of a few microseconds and memcopies, and a time summed over what was
    seen and divided by ``n`` would read the call faster than it is. So a
    kernel's time per call is its mean over the launches the sessions saw,
    times its launches per call: the most any session saw, per call,
    rounded. Fails if no session saw device activity, or if a pattern of
    ``launches`` (a regex on kernel names) matched no kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen: dict = {}  # name: [total us, launches seen, most launches a call]
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.self_device_time_total <= 0 or getattr(e, "is_user_annotation", False):
                continue
            total, count, per = seen.get(e.key, (0.0, 0, 0))
            seen[e.key] = (total + e.self_device_time_total, count + e.count,
                           max(per, round(e.count / n)))
    if not seen:
        fail("torch.profiler saw no device activity")
    for pattern in launches:
        if not any(re.search(pattern, k) for k in seen):
            fail(f"torch.profiler saw no kernel matching {pattern!r}; saw {sorted(seen)}")
    return {k: total / count * max(1, per) / 1e3 for k, (total, count, per) in seen.items()}


def device_ms(fn, n: int = 10, launches: tuple = ()) -> float:
    """Device time of one call, all its kernels (:func:`device_times`)."""
    return sum(device_times(fn, n, launches).values())


def output_ok(got: torch.Tensor, want: torch.Tensor, f32_tol: float = 1e-4) -> tuple:
    """(max |diff|, within tolerance) of a kernel's output against its plain
    version's: ``f32_tol`` in f32, one bf16 rounding step in bf16."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if got.dtype == torch.float32:
        ok = err <= f32_tol
    else:
        ok = bool((diff <= want.float().abs() * 2**-7 + 1e-6).all())
    return err, ok and bool(torch.isfinite(got).all())


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def expected(kernels, per: dict, n: int, **extra: int) -> dict:
    """Launch counts of ``n`` calls launching ``per`` each, plus ``extra``."""
    want = {name: 0 for name in kernels.KERNELS}
    for name, k in per.items():
        want[name] += k * n
    for name, k in extra.items():
        want[name] += k
    return want


def tf32_flops(n: int, cin: int, c2: int, x_bf16: bool, first_products: int = 1) -> float:
    """Operations of a gate's two products taken as 3xTF32: three TF32
    products for each f32 one, but two for x @ w1 when x is bf16, which TF32
    holds exactly; x @ w1 taken ``first_products`` times."""
    k1 = 2 if x_bf16 else 3
    return 2.0 * n * (first_products * k1 * cin * HIDDEN + 3 * HIDDEN * c2)


def check_gate(dev, fused_gate) -> tuple:
    """The eval gate against its plain version at the MTAN gate shapes:
    output and the same bits from a second launch; device times of the
    kernel and the plain version, the kernel's event time, and its bounds:
    the function's products once in 3xTF32 (``bound_ms``) and in f32
    (``bound_f32_ms``), and its design's (``bound_design_ms``: x @ w1 once
    for every 256 columns of C2, as csrc/fused_gate.cu pairs its blocks;
    at MTAN's widths the same as ``bound_ms``)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    totals = {"ms": 0.0, "events_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "bound_f32_ms": 0.0, "bound_design_ms": 0.0, "err": 0.0}
    by_flops = by_bytes = 0.0
    slower_than_plain = []
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
            again = fused_gate.fused_attention_gate(*args)
            want = fused_gate.fused_attention_gate_plain(*args)
            torch.cuda.synchronize()
            err, ok = output_ok(got, want)
            if not ok:
                fail(f"fused_attention_gate {level} {dtype}: max |diff| {err}")
            if not torch.equal(got, again):
                fail(f"fused_attention_gate {level} {dtype}: a second launch differs")
            n = BATCH * h * w
            es = x.element_size()
            nbytes = es * n * (cin + 2 * c2) + 4 * (cin * HIDDEN + HIDDEN + HIDDEN * c2 + c2)
            flops = 2.0 * n * (cin * HIDDEN + HIDDEN * c2)
            tc_flops = tf32_flops(n, cin, c2, es == 2)
            b_ms, b_by = bound(nbytes, tc_flops, TF32_TC_FLOPS_PER_S)
            pairs = -(-c2 // 256)
            design_ms, _ = bound(nbytes + (pairs - 1) * es * n * cin,
                                 tf32_flops(n, cin, c2, es == 2, pairs), TF32_TC_FLOPS_PER_S)

            def kernel():
                fused_gate.fused_attention_gate(*args)

            row = {
                "level": level, "dtype": str(dtype).replace("torch.", ""),
                "N": n, "Cin": cin, "C2": c2, "max_abs_err": err,
                "ms": device_ms(kernel, launches=("gate_kernel<",)),
                "events_ms": time_ms(kernel),
                "plain_ms": device_ms(lambda: fused_gate.fused_attention_gate_plain(*args)),
                "bound_ms": b_ms, "bound_by": b_by, "bound_f32_ms": bound(nbytes, flops)[0],
                "bound_design_ms": design_ms,
            }
            if row["ms"] > row["plain_ms"]:
                slower_than_plain.append(f"{level} {row['dtype']}")
            rows.append(row)
            totals["err"] = max(totals["err"], err)
            if dtype == torch.bfloat16:  # the main path's dtype: 2 tasks per level
                for k in ("ms", "events_ms", "plain_ms", "bound_ms", "bound_f32_ms",
                          "bound_design_ms"):
                    totals[k] += 2 * row[k]
                by_flops += 2 * tc_flops / TF32_TC_FLOPS_PER_S
                by_bytes += 2 * nbytes / HBM_BYTES_PER_S
    totals["bound_by"] = "operations" if by_flops >= by_bytes else "bytes"
    totals["slower_than_plain"] = slower_than_plain
    return rows, totals


def check_gate_train(dev, fused_gate_train) -> tuple:
    """The train-mode gate against its plain version at the MTAN gate
    shapes: output, the four statistics, and the same bits from a second
    launch; and the time of its backward (PyTorch ops)."""
    gen = torch.Generator(device=dev).manual_seed(10)
    rows = []
    totals = {"ms": 0.0, "events_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "bound_f32_ms": 0.0, "bound_design_ms": 0.0, "backward_ms": 0.0, "err": 0.0}
    by_flops = by_bytes = 0.0
    slower_than_plain = []
    for level, cin, c2, h, w in GATE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            def uniform(*shape, bound=1.0):
                return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * bound

            args = (
                torch.randn(BATCH, h, w, cin, generator=gen, device=dev).to(dtype),
                torch.randn(BATCH, h, w, c2, generator=gen, device=dev).to(dtype),
                uniform(cin, HIDDEN, bound=cin**-0.5), uniform(HIDDEN, bound=cin**-0.5),
                uniform(HIDDEN) * 0.5 + 1.0, uniform(HIDDEN, bound=0.3),
                uniform(HIDDEN, c2, bound=HIDDEN**-0.5), uniform(c2, bound=HIDDEN**-0.5),
                uniform(c2) * 0.5 + 1.0, uniform(c2, bound=0.3),
            )
            with torch.no_grad():
                got = fused_gate_train.fused_attention_gate_train(*args)
                again = fused_gate_train.fused_attention_gate_train(*args)
                want = fused_gate_train.fused_attention_gate_train_plain(*args)
            torch.cuda.synchronize()
            err, ok = output_ok(got[0], want[0])
            if not ok:
                fail(f"fused_attention_gate_train {level} {dtype}: output max |diff| {err}")
            stat_err = 0.0
            for name, g, r in zip(("mean1", "var1", "mean2", "var2"), got[1:], want[1:]):
                d = (g - r).abs()
                stat_err = max(stat_err, float(d.max()))
                if not bool((d <= 1e-5 * r.abs() + 1e-6).all()):
                    fail(f"fused_attention_gate_train {level} {dtype}: {name} max |diff| "
                         f"{float(d.max())}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"fused_attention_gate_train {level} {dtype}: a second launch differs")
            n = BATCH * h * w
            # x and shared read, out written; weights read, statistics written
            nbytes = args[0].element_size() * n * (cin + 2 * c2) + 4 * (
                cin * HIDDEN + 3 * HIDDEN + HIDDEN * c2 + 3 * c2 + 2 * (HIDDEN + c2)
            )
            flops = 2.0 * n * (cin * HIDDEN + HIDDEN * c2)
            x_bf16 = args[0].element_size() == 2
            tc_flops = tf32_flops(n, cin, c2, x_bf16)
            b_ms, b_by = bound(nbytes, tc_flops, TF32_TC_FLOPS_PER_S)
            f32_ms, _ = bound(nbytes, flops)
            # the three passes, 3xTF32: the second product twice; the first
            # once where pass 1 stores x @ w1 for passes 2 and 3 to read back
            # (Cin > 16, as csrc/gate_train.cu decides), else three times
            stores_h = cin > 16
            design_ms, _ = bound(
                nbytes + (3 * 4 * n * HIDDEN if stores_h else 0),
                tf32_flops(n, cin, c2, x_bf16, 1 if stores_h else 3)
                + 2.0 * n * 3 * HIDDEN * c2,
                TF32_TC_FLOPS_PER_S,
            )
            with torch.no_grad():
                def kernel():
                    fused_gate_train.fused_attention_gate_train(*args)

                def plain():
                    fused_gate_train.fused_attention_gate_train_plain(*args)

                # gate_train_kernel<T, pass - 1, tile>: the three passes, and
                # the memset of the statistics' completion counters
                pass_names = [rf"gate_train_kernel<[^,]+, {i}," for i in range(3)]
                times = device_times(kernel, launches=(*pass_names, "[Mm]emset"))
                passes = [sum(ms for name, ms in times.items() if re.search(p, name))
                          for p in pass_names]
                row = {
                    "level": level, "dtype": str(dtype).replace("torch.", ""),
                    "N": n, "Cin": cin, "C2": c2, "max_abs_err": err,
                    "stats_max_abs_err": stat_err,
                    "ms": sum(times.values()), "passes_ms": passes,
                    "events_ms": time_ms(kernel),
                    "plain_ms": device_ms(plain), "plain_events_ms": time_ms(plain),
                    "bound_ms": b_ms, "bound_by": b_by, "bound_f32_ms": f32_ms,
                    "bound_design_ms": design_ms,
                }
            if row["ms"] > row["plain_ms"]:
                slower_than_plain.append(f"{level} {row['dtype']}")
            # the Function's backward (PyTorch ops), timed as forward +
            # backward less the forward
            leaves = [a.detach().requires_grad_() for a in args]
            cot = torch.randn(got[0].shape, generator=gen, device=dev).to(dtype)

            def forward_backward():
                out = fused_gate_train.fused_attention_gate_train(*leaves)[0]
                torch.autograd.grad(out, leaves, cot)

            row["backward_ms"] = time_ms(forward_backward) - row["events_ms"]
            rows.append(row)
            totals["err"] = max(totals["err"], err)
            if dtype == torch.bfloat16:  # the main path's dtype: 2 tasks per level
                for k in ("ms", "events_ms", "plain_ms", "bound_ms", "bound_f32_ms",
                          "bound_design_ms", "backward_ms"):
                    totals[k] += 2 * row[k]
                by_flops += 2 * tc_flops / TF32_TC_FLOPS_PER_S
                by_bytes += 2 * nbytes / HBM_BYTES_PER_S
    totals["bound_by"] = "operations" if by_flops >= by_bytes else "bytes"
    totals["slower_than_plain"] = slower_than_plain
    return rows, totals


def confmat_mixes(dev, num_classes: int, main_path: tuple) -> dict:
    """Label mixes for the confusion matrix at batch 8 x 128 x 256, each
    (targets, preds, mask): uniform random ids (some outside [0, C), one
    sample left out of every eight by the mask); the main path's own ids
    (``main_path``, as MTAN's predict-eval passed them); and one class
    everywhere, every lane of a warp on one cell."""
    gen = torch.Generator(device=dev).manual_seed(1)
    shape = (BATCH, 128, 256)
    t = torch.randint(-1, num_classes + 2, shape, generator=gen, device=dev, dtype=torch.int32)
    t[0, :4, :4] = 255  # an ignore-style label outside [0, C)
    p = torch.randint(0, num_classes + 1, shape, generator=gen, device=dev, dtype=torch.int32)
    valid = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], device=dev, dtype=torch.bool)
    mask = valid[:, None, None].expand(shape).contiguous()
    one = torch.full(shape, num_classes - 1, device=dev, dtype=torch.int32)
    return {"uniform": (t, p, mask), "main_path": main_path,
            "one_class": (one, one.clone(), torch.ones(shape, device=dev, dtype=torch.bool))}


def check_confmat(confmat, num_classes: int, mixes: dict) -> dict:
    """The confusion matrix against its plain version on each label mix,
    exact; its device time and the kernels a call launches, its event
    time, the plain version's and one ``torch.bincount``'s device time on
    the same ids, and the bytes bound."""
    c = num_classes
    out = {}
    for name, (t, p, mask) in mixes.items():
        got = confmat.confusion_matrix(t, p, c, mask)
        want = confmat.confusion_matrix_plain(t, p, c, mask)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if err != 0.0:
            fail(f"confusion_matrix {name}: max |diff| {err}, want exact")

        def kernel():
            confmat.confusion_matrix(t, p, c, mask)

        n = t.numel()
        times = device_times(kernel, n=20)
        keep = (mask if mask is not None else True) & (t >= 0) & (t < c) & (p >= 0) & (p < c)
        idx = torch.where(keep, t * c + p, c * c).long().reshape(-1)
        b_ms, b_by = bound(n * (4 + 4 + (1 if mask is not None else 0)) + 4 * c * c, float(n))
        out[name] = {
            "max_abs_err": err, "N": n, "cells_hit": int((want > 0).sum()),
            "ms": sum(times.values()), "kernels_per_call": [k[:60] for k in sorted(times)],
            "events_ms": time_ms(kernel),
            "plain_ms": device_ms(lambda: confmat.confusion_matrix_plain(t, p, c, mask), n=20),
            "library_ms": device_ms(lambda: torch.bincount(idx, minlength=c * c + 1), n=20),
            "bound_ms": b_ms, "bound_by": b_by,
        }
    return out


@contextlib.contextmanager
def capture_confmat_inputs():
    """Records the (targets, preds, mask) of every confusion matrix the
    metric path asks for while inside, and passes each call on."""
    from vision_mtl_tpu_torch import metrics

    real = metrics.confusion_matrix
    seen = []

    def recording(targets, preds, num_classes, mask=None):
        seen.append((targets.clone(), preds.clone(), None if mask is None else mask.clone()))
        return real(targets, preds, num_classes, mask)

    metrics.confusion_matrix = recording
    try:
        yield seen
    finally:
        metrics.confusion_matrix = real


def check_small_conv(dev, small_conv) -> tuple:
    """Kernel B3 against its plain version at the eight shapes of a basic
    train step, bf16 and f32: output, the same bits from a second launch;
    times of the kernel, the plain version and one cuDNN ``F.conv2d``.
    Totals are for one bf16 train step (four forward and four dx calls)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(20)
    rows = []
    totals = {"ms": 0.0, "events_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "err": 0.0,
              "fwd_ms": 0.0, "dx_ms": 0.0, "fwd_library_ms": 0.0, "dx_library_ms": 0.0}
    step_bytes = step_flops = 0.0
    for call, c, o, h, w, has_bias in SMALL_CONV_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(BATCH, h, w, c, generator=gen, device=dev).to(dtype)
            k = (torch.rand(3, 3, c, o, generator=gen, device=dev) * 2 - 1) / (9 * c) ** 0.5
            bias = torch.randn(o, generator=gen, device=dev) * 0.1 if has_bias else None
            got = small_conv.conv3x3_small(x, k, bias)
            again = small_conv.conv3x3_small(x, k, bias)
            want = small_conv.conv3x3_small_plain(x, k, bias)
            torch.cuda.synchronize()
            err, ok = output_ok(got, want, 1e-4 * float(want.float().abs().max()))
            if not ok:
                fail(f"conv3x3_small {call} {dtype}: max |diff| {err}")
            if not torch.equal(got, again):
                fail(f"conv3x3_small {call} {dtype}: a second launch differs")
            es = x.element_size()
            n = BATCH * h * w
            nbytes = es * n * (c + o) + es * 9 * c * o + (4 * o if has_bias else 0)
            flops = 2.0 * n * 9 * c * o
            peak = BF16_TC_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
            b_ms, b_by = bound(nbytes, flops, peak)
            x_nchw = x.permute(0, 3, 1, 2)
            w_oihw = k.to(dtype).permute(3, 2, 0, 1).contiguous()
            b_lib = None if bias is None else bias.to(dtype)
            def kernel():
                small_conv.conv3x3_small(x, k, bias)

            row = {
                "call": call, "dtype": str(dtype).replace("torch.", ""), "N": n, "C": c, "O": o,
                "kernel": ("conv3x3_small_tc_kernel (mma.sync bf16)" if dtype == torch.bfloat16
                           else "conv3x3_small_kernel (SIMT f32)"),
                "max_abs_err": err,
                "ms": device_ms(kernel, launches=("conv3x3_small",)),
                "events_ms": time_ms(kernel),
                "plain_ms": device_ms(lambda: small_conv.conv3x3_small_plain(x, k, bias)),
                "library_ms": device_ms(lambda: F.conv2d(x_nchw, w_oihw, b_lib, padding=1)),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            rows.append(row)
            totals["err"] = max(totals["err"], err)
            if dtype == torch.bfloat16:  # the main path's dtype
                for key in ("ms", "events_ms", "plain_ms", "library_ms"):
                    totals[key] += row[key]
                part = call.split()[0]
                totals[f"{part}_ms"] += row["ms"]
                totals[f"{part}_library_ms"] += row["library_ms"]
                step_bytes += nbytes
                step_flops += flops
    totals["bound_ms"], totals["bound_by"] = bound(step_bytes, step_flops, BF16_TC_FLOPS_PER_S)
    totals["faster_than_library"] = totals["ms"] < totals["library_ms"]
    return rows, totals


def check_model_against_cpu(name, cfg, build_model, dev) -> dict:
    """f32 forward of the full-width model on the card (kernels) against the
    same weights on the CPU (plain versions), one image."""
    img = np.random.default_rng(2).uniform(size=(1, cfg.height, cfg.width, 3)).astype(np.float32)
    ref = build_model(name, cfg, dtype=torch.float32, device="cpu", seed=0)
    gpu = build_model(name, cfg, dtype=torch.float32, device=dev, seed=0)
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
            fail(f"{name} f32 {k}: card vs CPU max |diff| {err} (scale {scale})")
    agree = float((got["segm"].argmax(-1) == want["segm"].argmax(-1)).float().mean())
    out["segm_argmax_agreement"] = agree
    if agree < 0.999:
        fail(f"{name} f32 segm argmax agrees with the CPU on only {agree:.5f}")
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
    if counts != expected(kernels, PER_FORWARD["mtan"], forwards):
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


def time_predictor(name, model, cfg, dev, kernels) -> dict:
    from vision_mtl_tpu_torch.serving import Predictor, latency_bench

    imgs = np.random.default_rng(4).integers(
        0, 256, size=(BATCH, cfg.height, cfg.width, 3), dtype=np.uint8
    )
    pred = Predictor(model, BATCH, cfg.height, cfg.width, dtype=np.uint8, compact_out=True, device=dev)
    kernels.reset_launch_counts()
    lat = latency_bench(pred, imgs, n=30, warmup=3)
    counts = kernels.launch_counts()
    if counts != expected(kernels, PER_FORWARD[name], 33):
        fail(f"{name} Predictor timing: launches {counts} for 33 forwards")
    x = torch.from_numpy(imgs).to(dev).float() / 255.0
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(x), iters=10)
    return {**lat, "img_per_s": BATCH / lat["p50_ms"] * 1e3, "forward_events_ms": fwd_ms,
            "launches": counts, "profile": profile_forward(model, x)}


def profile_forward(model, x, n: int = 5) -> dict:
    """Device time by kernel over ``n`` forwards (see :func:`profile_device`)."""

    def forward():
        with torch.inference_mode():
            model(x)

    return profile_device(forward, n)


def profile_device(fn, n: int) -> dict:
    """Device time by kernel over ``n`` calls of ``fn``, from torch.profiler:
    where a call's time goes and how long the card idles. Reports "not
    measured" if the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    kernels = [
        (e.key, e.self_device_time_total / 1e3 / n, e.count // n)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        # a user annotation (Optimizer.step) spans kernels counted on their own
        and not getattr(e, "is_user_annotation", False)
    ]
    if not kernels:
        return {"device_busy_ms": "not measured", "wall_ms_profiled": wall_ms}
    busy = sum(ms for _, ms, _ in kernels)
    kernels.sort(key=lambda k: -k[1])
    by_category: dict = {}
    for name, ms, _ in kernels:
        cat = next((c for c, keys in PROFILE_CATEGORIES if any(k in name for k in keys)), "other")
        by_category[cat] = by_category.get(cat, 0.0) + ms
    return {
        "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "device_ops_per_call": sum(c for _, _, c in kernels),
        "by_category_ms": dict(sorted(by_category.items(), key=lambda kv: -kv[1])),
        "top": [{"name": k[:80], "ms": ms, "calls": c} for k, ms, c in kernels[:12]],
    }


def predict_eval(name, model, cfg, dev, kernels) -> dict:
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
    with capture_confmat_inputs() as confmat_inputs:
        preds, metrics = predict(batches, model, c, device=dev)
    counts = kernels.launch_counts()
    if counts != expected(kernels, PER_FORWARD[name], N_EVAL_BATCHES,
                          confusion_matrix=N_EVAL_BATCHES):
        fail(f"{name} predict-eval: launches {counts}")
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
    return {"launches": counts, "metrics": metrics, "valid_pixels": n_valid,
            "confmat_inputs": confmat_inputs[0]}


def train_batches(cfg, n: int, batch: int, seed: int) -> list:
    """Seeded synthetic batches in the compact wire format (uint8 img, int32
    mask, uint16 depth), learnable: the class and the depth are functions of
    the pixel, so the loss on a repeated batch falls as the model trains."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = rng.integers(0, 256, size=(batch, cfg.height, cfg.width, 3), dtype=np.uint8)
        mask = (img[..., 0].astype(np.int32) * cfg.num_classes) // 256
        depth = np.maximum(img[..., 1:2], 1).astype(np.uint16) * 257  # > min_depth
        out.append({"img": torch.from_numpy(img), "mask": torch.from_numpy(mask),
                    "depth": torch.from_numpy(depth)})
    return out


def grad_distance(a: dict, b: dict) -> tuple:
    """Relative L2 distance of gradients ``a`` from ``b``: over the whole
    gradient and per parameter, leaving out ``ZERO_GRAD``."""
    keys = [k for k in b if not ZERO_GRAD.search(k)]
    num = sum(float((a[k] - b[k]).square().sum()) for k in keys)
    den = sum(float(b[k].square().sum()) for k in keys)
    return (num / den) ** 0.5, {k: float((a[k] - b[k]).norm() / b[k].norm()) for k in keys}


def _bf16(v: torch.Tensor) -> torch.Tensor:
    """v rounded to bf16, in v's dtype; differentiable through the casts."""
    return v.to(torch.bfloat16).to(v.dtype)


@contextlib.contextmanager
def bf16_kernel_inputs(name: str):
    """The control of the f32 step check: the model's kernel fed inputs
    rounded to bf16 (MTAN: the train gate's input and weights; basic: B3's
    input and weights on its four convs)."""
    if name == "mtan":
        from vision_mtl_tpu_torch.models import mtan as module

        attr = "fused_attention_gate_train"
        real = module.fused_attention_gate_train

        def patched(x, shared, w1, b1, scale1, bias1, w2, *rest):
            return real(_bf16(x), shared, _bf16(w1), b1, scale1, bias1, _bf16(w2), *rest)
    else:
        from vision_mtl_tpu_torch.ops import small_conv as module

        attr = "conv3x3_small"
        real = module.conv3x3_small

        def patched(x, kernel, bias=None):
            return real(_bf16(x), _bf16(kernel), bias)

    setattr(module, attr, patched)
    try:
        yield
    finally:
        setattr(module, attr, real)


def check_train_step_against_cpu(name, cfg, build_model, dev) -> dict:
    """One train step of the same seeded full-width model at batch 2: in f32
    on the card (kernels) and on the CPU (plain versions), held to the same
    step in f64 on the CPU; and a control, the CPU f32 step with the model's
    kernel fed bf16-rounded inputs (:func:`bf16_kernel_inputs`), which the
    limits must refuse."""
    from vision_mtl_tpu_torch.metrics import init_metrics
    from vision_mtl_tpu_torch.train.state import create_train_state
    from vision_mtl_tpu_torch.train.step import make_train_step

    (batch,) = train_batches(cfg, 1, 2, seed=7)
    cpu = torch.device("cpu")

    def run(device, dtype) -> dict:
        t0 = time.perf_counter()
        model = build_model(name, cfg, dtype=dtype, device=device, seed=0).to(dtype)
        state = create_train_state(model, LR, device=device)
        _, _, losses = make_train_step(device=device)(
            state, batch, init_metrics(cfg.num_classes, device)
        )
        return {
            "loss": float(losses["loss"]),
            "grads": {k: p.grad.double().cpu() for k, p in model.named_parameters()},
            "bufs": {k: b.double().cpu() for k, b in model.named_buffers()},
            "s": time.perf_counter() - t0,
        }

    witness = run(cpu, torch.float64)
    cpu32 = run(cpu, torch.float32)
    card = run(dev, torch.float32)
    with bf16_kernel_inputs(name):
        control = run(cpu, torch.float32)

    loss, want_loss = card["loss"], cpu32["loss"]
    if not np.isfinite(loss) or abs(loss - want_loss) > 1e-4 * abs(want_loss):
        fail(f"{name} f32 train step: loss {loss} on the card, {want_loss} on the CPU")
    worst_buf = 0.0
    for k, want in cpu32["bufs"].items():
        d = float(((card["bufs"][k] - want).abs() / want.abs().clamp(min=1.0)).max())
        worst_buf = max(worst_buf, d)
        if not d <= 1e-5:
            fail(f"{name} f32 train step: running statistic {k} off by {d}")
    want_g = witness["grads"]
    top = max(float(g.abs().max()) for g in want_g.values())
    worst_zero = 0.0
    for k in filter(ZERO_GRAD.search, want_g):  # 0 up to rounding on both f32 sides
        zero = max(float(card["grads"][k].abs().max()), float(cpu32["grads"][k].abs().max()))
        worst_zero = max(worst_zero, zero / top)
        if not zero <= 1e-3 * top:
            fail(f"{name} f32 train step: gradient of {k} is {zero / top} of the largest, "
                 "want ~0")
    distance = {}
    for name, r in (("cpu_f32", cpu32), ("card_f32", card), ("control", control)):
        whole, per = grad_distance(r["grads"], want_g)
        worst = sorted(per.items(), key=lambda kv: -kv[1])[:3]
        within = sum(
            float((r["grads"][k] - want_g[k]).abs().max()) <= 1e-3 * float(want_g[k].abs().max())
            for k in per
        )
        distance[name] = {"rel_l2": whole, "worst_leaves": worst,
                          "leaves_within_1e-3_of_max": within, "loss": r["loss"], "s": r["s"]}
    whole_limit = 3 * distance["cpu_f32"]["rel_l2"]
    leaf_limit = 3 * distance["cpu_f32"]["worst_leaves"][0][1]

    def inside(name: str) -> bool:
        d = distance[name]
        return d["rel_l2"] <= whole_limit and d["worst_leaves"][0][1] <= leaf_limit

    out = {
        "loss_f64": witness["loss"], "loss_cpu": want_loss, "loss_card": loss,
        "running_stats_max_err": worst_buf, "zero_grad_max_share": worst_zero,
        "params_compared": sum(not ZERO_GRAD.search(k) for k in want_g),
        "grad_vs_f64": distance, "rel_l2_limit": whole_limit, "leaf_limit": leaf_limit,
        "f64_step_s": witness["s"],
    }
    if not inside("card_f32"):
        fail(f"{name} f32 train step: the card's gradients are off the f64 witness by more "
             f"than 3 times the CPU f32 step's: {json.dumps(out)}")
    if inside("control"):
        fail(f"{name} f32 train step: the bf16 control passed the gradient limits: "
             f"{json.dumps(out)}")
    return out


def train_model(name, cfg, build_model, dev, kernels) -> dict:
    """The training path at full width: bf16 train steps at batch 8 through
    create_train_state and make_train_step, then one make_eval_step."""
    from vision_mtl_tpu_torch.metrics import compute_metrics, init_metrics
    from vision_mtl_tpu_torch.train.state import create_train_state, param_count
    from vision_mtl_tpu_torch.train.step import make_eval_step, make_train_step

    batches = [{k: v.to(dev) for k, v in b.items()}
               for b in train_batches(cfg, TRAIN_BATCHES, BATCH, seed=6)]
    model = build_model(name, cfg, dtype=torch.bfloat16, device=dev, seed=0)
    state = create_train_state(model, LR, device=dev)
    step = make_train_step(device=dev)
    n_steps = TRAIN_WARMUP + TRAIN_TIMED
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_steps + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, t0 = [], time.perf_counter()
    events[0].record()
    for i in range(n_steps):
        state, mstate, step_losses = step(state, batches[i % TRAIN_BATCHES],
                                          init_metrics(cfg.num_classes, dev))
        events[i + 1].record()
        losses.append(step_losses["loss"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = expected(kernels, PER_TRAIN_STEP[name], n_steps)
    if counts != want:
        fail(f"{name} training: launches {counts}, want {want} for {n_steps} steps")
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        fail(f"{name} training: losses {losses}")
    last_seen = n_steps - 1 - (n_steps - 1) % TRAIN_BATCHES  # last step on batch 0
    if not losses[last_seen] < losses[0]:
        fail(f"{name} training: loss on batch 0 went {losses[0]} -> {losses[last_seen]}")
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(TRAIN_WARMUP, n_steps)]
    p50 = float(np.median(step_ms))
    peak = torch.cuda.max_memory_allocated()
    metrics = {k: float(v) for k, v in compute_metrics(mstate).items()}

    kernels.reset_launch_counts()
    eval_mstate, eval_losses = make_eval_step(device=dev)(
        state, batches[0], init_metrics(cfg.num_classes, dev)
    )
    eval_counts = kernels.launch_counts()
    want_eval = expected(kernels, PER_FORWARD[name], 1, confusion_matrix=1)
    if eval_counts != want_eval:
        fail(f"{name} eval step: launches {eval_counts}, want {want_eval}")
    eval_metrics = {k: float(v) for k, v in compute_metrics(eval_mstate).items()}
    if not all(np.isfinite(v) for v in eval_metrics.values()):
        fail(f"{name} eval step: metrics {eval_metrics}")

    def one_step():
        step(state, batches[0], init_metrics(cfg.num_classes, dev))

    return {
        "params": param_count(state), "steps": n_steps, "timed_steps": TRAIN_TIMED,
        "losses": losses, "loss_batch0_first_last": [losses[0], losses[last_seen]],
        "step_ms_p50": p50, "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
        "img_per_s": BATCH / p50 * 1e3, "wall_s": wall_s,
        "max_memory_allocated_bytes": peak, "launches": counts, "last_step_metrics": metrics,
        "eval_step": {"launches": eval_counts, "metrics": eval_metrics,
                      "loss": float(eval_losses["loss"])},
        "profile_one_step": profile_device(one_step, 2),
    }


def main(argv: list) -> int:
    kernels_only = argv == ["--kernels"]
    if argv and not kernels_only:
        print(f"chip_smoke: unknown arguments {argv}; takes none, or --kernels", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 2
    from vision_mtl_tpu_torch import kernels
    from vision_mtl_tpu_torch.cfg import fetch_data_cfg
    from vision_mtl_tpu_torch.kernels import confmat, fused_gate, fused_gate_train, small_conv
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
    cfg = fetch_data_cfg("cityscapes")
    if kernels_only:
        model = build_model("mtan", cfg, dtype=torch.bfloat16, device=dev, seed=0)
        main_ids = predict_eval("mtan", model, cfg, dev, kernels).pop("confmat_inputs")
        mixes = check_confmat(confmat, cfg.num_classes, confmat_mixes(dev, cfg.num_classes, main_ids))
        print(json.dumps({"gate_per_forward": gate, "confmat_mixes": mixes}), flush=True)
        print(smi, flush=True)
        return 0
    gate_train_rows, gate_train = check_gate_train(dev, fused_gate_train)
    print(json.dumps({"gate_train_shapes": gate_train_rows}), flush=True)
    conv_rows, conv = check_small_conv(dev, small_conv)
    print(json.dumps({"small_conv_shapes": conv_rows}), flush=True)
    print(json.dumps({"small_conv_per_train_step": conv}), flush=True)

    # the timed paths run first: after the CPU reference steps below, the
    # host launched the same train steps about 10% slower in this process
    model = build_model("mtan", cfg, dtype=torch.bfloat16, device=dev, seed=0)
    mtan_params = sum(p.numel() for p in model.parameters())
    serving = serve_requests(model, cfg, dev, kernels)
    mtan_timing = time_predictor("mtan", model, cfg, dev, kernels)
    mtan_eval = predict_eval("mtan", model, cfg, dev, kernels)
    # the confusion matrix on the ids MTAN's predict-eval gave it, and two more mixes
    main_ids = mtan_eval.pop("confmat_inputs")
    del model
    mtan_training = train_model("mtan", cfg, build_model, dev, kernels)
    model = build_model("basic", cfg, dtype=torch.bfloat16, device=dev, seed=0)
    basic_params = sum(p.numel() for p in model.parameters())
    basic_timing = time_predictor("basic", model, cfg, dev, kernels)
    basic_eval = predict_eval("basic", model, cfg, dev, kernels)
    basic_eval.pop("confmat_inputs")
    del model
    basic_training = train_model("basic", cfg, build_model, dev, kernels)
    phases = [  # launch counts of every main-path run
        serving["launches"], mtan_timing["launches"], mtan_eval["launches"],
        mtan_training["launches"], mtan_training["eval_step"]["launches"],
        basic_timing["launches"], basic_eval["launches"],
        basic_training["launches"], basic_training["eval_step"]["launches"],
    ]
    timed_s = time.perf_counter() - t_start
    cmat_mixes = check_confmat(confmat, cfg.num_classes, confmat_mixes(dev, cfg.num_classes, main_ids))
    print(json.dumps({"confmat_mixes": cmat_mixes}), flush=True)
    for name, mix in cmat_mixes.items():
        if len(mix["kernels_per_call"]) != 1 or "confmat_kernel" not in mix["kernels_per_call"][0]:
            fail(f"confusion_matrix {name}: a call ran {mix['kernels_per_call']}, want one kernel")
    cmat = {**cmat_mixes["main_path"],
            "max_abs_err": max(m["max_abs_err"] for m in cmat_mixes.values())}

    model_line = {
        "model": "mtan", "config": "cityscapes 128x256, 19 classes, bf16", "params": mtan_params,
        "reference_f32_vs_cpu": check_model_against_cpu("mtan", cfg, build_model, dev),
        "serving": serving, "predictor_8": mtan_timing, "predict_eval": mtan_eval,
        "gate_per_forward": {k: v for k, v in gate.items() if k != "err"},
        "gate_share_of_forward_events": gate["ms"] / mtan_timing["forward_events_ms"],
        "build_s": build_s,
    }
    print(json.dumps({"model": model_line}), flush=True)
    train_line = {
        "model": "mtan", "config": "cityscapes 128x256, 19 classes, bf16, batch 8, Adam lr 1e-3",
        "reference_f32_step_vs_cpu": check_train_step_against_cpu("mtan", cfg, build_model, dev),
        **mtan_training,
        "gate_train_ms_per_step": gate_train["ms"],
        "gate_train_bound_ms_per_step": gate_train["bound_ms"],
        "gate_train_bound_f32_ms_per_step": gate_train["bound_f32_ms"],
        "gate_train_bound_design_ms_per_step": gate_train["bound_design_ms"],
        "gate_train_levels_slower_than_plain": gate_train["slower_than_plain"],
        "gate_train_backward_ms_per_step": gate_train["backward_ms"],
        "gate_train_share_of_step_events": gate_train["ms"] / mtan_training["step_ms_p50"],
    }
    print(json.dumps({"train": train_line}), flush=True)
    model_line = {
        "model": "basic", "config": "cityscapes 128x256, 19 classes, bf16", "params": basic_params,
        "reference_f32_vs_cpu": check_model_against_cpu("basic", cfg, build_model, dev),
        "predictor_8": basic_timing, "predict_eval": basic_eval,
        "small_conv_fwd_share_of_forward_events": conv["fwd_ms"] / basic_timing["forward_events_ms"],
    }
    print(json.dumps({"model": model_line}), flush=True)
    train_line = {
        "model": "basic", "config": "cityscapes 128x256, 19 classes, bf16, batch 8, Adam lr 1e-3",
        "reference_f32_step_vs_cpu": check_train_step_against_cpu("basic", cfg, build_model, dev),
        **basic_training,
        "small_conv_ms_per_step": conv["ms"], "small_conv_bound_ms_per_step": conv["bound_ms"],
        "small_conv_share_of_step_events": conv["ms"] / basic_training["step_ms_p50"],
        "timed_paths_s": timed_s, "total_s": time.perf_counter() - t_start,
    }
    print(json.dumps({"train": train_line}), flush=True)

    launches = {name: sum(p[name] for p in phases) for name in kernels.KERNELS}
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
            "name": "fused_attention_gate_train", "route": "cuda",
            "source": "vision_mtl_tpu_torch/csrc/gate_train.cu",
            "replaces": "vision_mtl_tpu/ops/pallas/fused_gate.py:240,279",
            "launches": launches["fused_attention_gate_train"], "max_abs_err": gate_train["err"],
            "ms": gate_train["ms"], "plain_ms": gate_train["plain_ms"],
            "bound_ms": gate_train["bound_ms"], "bound_by": gate_train["bound_by"],
            "library_ms": None,
        },
        {
            "name": "confusion_matrix", "route": "cuda",
            "source": "vision_mtl_tpu_torch/csrc/confmat.cu",
            "replaces": "vision_mtl_tpu/ops/pallas/confmat.py:91",
            "launches": launches["confusion_matrix"], "max_abs_err": cmat["max_abs_err"],
            "ms": cmat["ms"], "plain_ms": cmat["plain_ms"], "bound_ms": cmat["bound_ms"],
            "bound_by": cmat["bound_by"], "library_ms": cmat["library_ms"],
        },
        {
            "name": "conv3x3_small", "route": "cuda",
            "source": "vision_mtl_tpu_torch/csrc/small_conv.cu",
            "replaces": "vision_mtl_tpu/ops/pallas/small_conv.py:100",
            "launches": launches["conv3x3_small"], "max_abs_err": conv["err"],
            "ms": conv["ms"], "plain_ms": conv["plain_ms"], "bound_ms": conv["bound_ms"],
            "bound_by": conv["bound_by"], "library_ms": conv["library_ms"],
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
    sys.exit(main(sys.argv[1:]))
