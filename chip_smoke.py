#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vision_mtl_tpu_torch) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels
    python3 chip_smoke.py --parallel

Builds the hand-written CUDA kernels from ``vision_mtl_tpu_torch/csrc``,
holds each against its plain PyTorch version at the shapes of the main
paths, then drives those paths for the three ported models at their trained
widths (Cityscapes 128x256, 19 classes, seeded random weights). MTAN:
serving (a ``BatchingServer`` answering concurrent requests, a timed
``Predictor(8)``), a predict-eval sweep with metrics, and training
(``create_train_state`` + ``make_train_step`` for a few warm-up and timed
bf16 steps at batch 8, then one ``make_eval_step``). The basic model
(MobileNetV3 + Unet) and CSNet (two MobileNetV3 + Unet networks joined by
cross-stitch units): a timed ``Predictor(8)``, the predict-eval sweep and
the same training. Then the ``cli`` phase runs the training CLI end to end
in process (``vision_mtl_tpu_torch.training.main``) on a Cityscapes-layout
tree of 40 train and 16 val seeded triples that it writes under
``build/chip_smoke/`` (about 45 MB): MTAN for 2 epochs at batch 8 with a
checkpoint each, then ``--resume_dir`` on that run to epoch 3 (it must
start at epoch 3 from ``model_1``'s weights bit for bit, continue the step
axis and the shuffle stream, and end with a lower epoch train loss than
the first run's first epoch), then ``serve --run_dir`` on the resumed run,
whose answer must equal ``Predictor`` on the trained model in memory (ids
exactly, depth within one bf16 step); basic and CSNet for one epoch each.
The launch counters, set to 0 before each path and read after it, show
that each path went through its kernels (exact counts per forward and per
train step; for a CLI run, what the loaders' lengths predict). Any
mismatch or error ends the run with a non-zero exit; without a CUDA card
it exits 2 and prints no result.

The ``surface`` phase runs next, in process, at MTAN's full width on the
``cli`` tree, its launch counters set to 0 at its start and read at its
end (each of B1, B2, B3 and B4 must launch in it): ``training
--do_optimize --n_trials 3 --num_epochs 1 --log_param_histograms_every 2
--do_plot_preds`` (it must say that its trials run one after another on
the card; each trial trains 3 epochs in a run dir of its own unless it is
pruned; the tuned run carries the best trial's weights and is registered
as ``mtan_tuned``; its launches are what the trials' epochs and the
loaders' lengths predict); ``eval_harness --from_registry`` over the
registry, which holds the ``cli`` phase's MTAN, basic and CSNet runs and
the tuned one (the table equal to each run's own predict metrics, as for
``--runs``); a ``Predictor(8)`` of the tuned model whose answer stays bit
for bit the same across two bf16 train steps of that model, which stays
in train mode, while a new ``Predictor`` answers otherwise;
``utils.profiling.trace`` around two more train steps, whose Chrome trace
must hold B4's and B2's kernels (run once more if it came back empty),
each step synchronised and timed by ``time.perf_counter``;
``get_segm_preds`` on the card against the CPU on the model's logits
(probabilities to 1e-6, ids exact). matplotlib and
tensorboard are optional: the phase prints which are installed, and where
one is absent its sink is the JAX package's best-effort no-op.

The ``nyuv2`` phase writes a NYUv2-layout tree under
``build/chip_smoke/nyuv2/`` (40 train and 16 test seeded triples at the
dataset's 480x640: 8-bit RGB, 8-bit ids 0-13 and 16-bit depth in metres x
1e4 as PNGs, written with zlib and struct, each row's filter type cycling
0-4), holds the native decoder to the written arrays, times the loader
alone (batch 4, 256x256) from the PNGs and from the prepared-array cache,
and runs the training CLI with basic at batch 4 (the reference's NYUv2
run) for one epoch from the PNGs, then from the cache. The MTAN
preemption drill then runs the CLI at batch 8 in four processes with
PyTorch's deterministic algorithms set: two uninterrupted 2-epoch runs, a
run that ``VMTL_PREEMPT_AT_STEP`` stops half way through its second
epoch, which must exit 143, and ``--resume_dir`` on it to the end.
``eval_harness`` then evaluates the phase's run dirs and two of the
``cli`` phase's, and a ``Predictor(8)`` of MTAN is timed at 256x256. The
kernels are also held against their plain versions at the NYUv2 shapes:
MTAN's gates at 256x256 and batch 8, basic's and CSNet's B3 convs at
256x256 and batch 4 (basic's merged head 33 -> 15, CSNet's segmentation
head 16 -> 14), B2 at 14 classes on basic's predict ids.

The ``interop`` phase (reference checkpoints and exported programs) runs
each model at Cityscapes 128x256, batch 8: 2 bf16 train steps from seeded
weights, then a reference run dir under ``build/chip_smoke/reference/``
(``model_1.pt`` from ``save_reference_checkpoint``, ``session_1.pt`` with
the port's Adam state re-keyed into the reference's parameter order, a
``train_args.yaml`` laid out as PyYAML writes it) beside the port's own
run dir of the same state. Through ``serve --run_dir``'s loader the import
must equal the source bit for bit and answer ``Predictor(8)`` as it does,
ids and depth exactly, with ``PER_FORWARD`` launches. For MTAN and basic,
``training --resume_dir`` on either dir, with PyTorch's deterministic
algorithms set, must start at epoch 2 with the same state and take the
same first step bit for bit; ``eval_harness`` on MTAN's reference dir
must give the import's own predict metrics. Each import is exported
(``export_model``, uint8 wire, batch 8; its graph must hold the kernel's
operator at each of its calls), then loaded and run in a fresh process
that imports no model code: each call launches ``PER_FORWARD`` kernels,
its ids equal ``Predictor(8)``'s and its depth lies within one bf16 step
of it (the ``serve --run_dir`` rule); its p50 is timed beside
``Predictor(8)``'s in that process. The eval gate's host cost per call
through its operator is timed against the direct launch.

The ``options`` phase (every model option of the JAX package) runs at the
same full width: B1 and B4 with a task axis at T = 2, at MTAN's 8 gate
shapes in both dtypes, each against its plain version and each task bit
for bit against its own T = 1 call, timed beside the two T = 1 calls (bf16);
MTAN with ``fold_tasks`` (weights from the seeded unfolded MTAN through
``fold_task_state_dict``): ``Predictor(8)`` against the unfolded model's
answer (bit for bit, or the serving rule) and its p50 beside the unfolded
p50, with the per-task 3x3 convs run per task (the model's way) and grouped
(``grouped_conv_bn_relu``), the p50s and each way's bf16 train steps timed in
interleaved rounds, one f32 train step against the unfolded step, leaf by
leaf; the basic model with ``fold_tail``: its
f32 forward against the unfolded model's, B3's launches per forward and
per step; the remat flags of each model: the step with all of a model's
flags against its plain step bit for bit under deterministic algorithms
(loss, every gradient, every buffer), and step ms and peak memory for each
flag alone and all together; then ``training --model_name mtan
--fold_tasks --remat_attention`` for one epoch on the ``cli`` tree and
``serve --run_dir`` on its run. Launches are counted exactly on each path
(the task-axis gates have their own counters and ``kernels`` entries).

The ``parallel`` phase (data parallelism, the mesh's ``data`` axis) runs
last, after every profiled phase. B4's staged call across ranks is first
held to its fused call at MTAN's 8 gate shapes in both dtypes (with the
other kernel checks): with one rank bit for bit, and with the rows cut in
two halves run by two threads of this process as two ranks, within the
gate's tolerances (:func:`check_gate_split`). The parent then computes
its one-process references (MTAN's f32 step on a seeded batch 8, a
``Predictor(8)`` of the f32 model) and starts the rank processes with
torchrun's environment: on a machine with one card, two that share
it over gloo (NCCL refuses two ranks on one device), whose times are not
a scaling figure; with several cards, one rank a card over NCCL. Each
rank takes its rows of the global batch 8 at full width:
one f32 MTAN step, whose all-reduced gradients are held to the
one-process step within the f32 check's own limits (whole and per-leaf
relative L2, ``ZERO_GRAD`` left out) and are the same bits on every rank;
1 + 3 bf16 steps, after which every rank holds the same parameters and
Adam moments bit for bit, their p50 printed beside the one-process step's;
B4's staged call timed at the 8 gate shapes against its plain split;
``Predictor(8, mesh=)`` against the one-process answer (depth within
1e-4, ids differing on at most 1e-4 of the pixels); and the training CLI
in process with ``--mesh_shape data:<ranks>`` for one MTAN epoch on the ``cli``
tree (one run dir, one checkpoint, the same weights on every rank). Each
path's launches are counted exactly per rank (B4's staged calls under
``fused_attention_gate_train_ranks``).

The ``spatial`` phase (the mesh's ``spatial`` axis: image rows split over
the ranks, a halo exchange around every conv and resize) runs in the same
rank processes right after, over ``spatial:2`` (two ranks sharing one
card) or ``data:N/2,spatial:2`` (a card each); each rank holds its block of
the global batch 8 (its images, their rows). For MTAN and basic at full
width: one f32 step held to a one-process f32 step the parent takes
(the f32 check's limits, each model's own); 1 + 3 bf16 steps after which
every rank holds the same parameters and Adam moments bit for bit, their
p50 beside the one-process step's; B3 timed on the halo'd row blocks
basic's step gave it, against its plain version; B4's staged call at the
blocks' gate shapes; MTAN's ``Predictor(8, mesh=)`` against the
one-process answer, whole on every rank; the training CLI in process for
one MTAN epoch over the mesh on the ``cli`` tree (every rank decodes whole
batches and keeps its block). Then two heights whose coarser levels do not
split over the two spatial ranks, which run those levels whole on both:
basic at 96 rows (3 rows at its stride 32) and MTAN at 112 (7 rows at its
16), the first 96 or 112 rows of the same batches: each one f32 step held
to the one-process step, 1 + 3 bf16 steps bit for bit on every rank, the
spatial group's all-reduces of a step by kind (the row gathers into the
whole levels among them), ``Predictor(8, mesh=)`` against the one-process
answer at that height, and the levels that ran whole. Launches are counted
exactly per rank: B4's staged calls and B3's convs run on the row blocks.

The ``model`` phase (the mesh's ``model`` axis: large conv kernels
sharded by output channel with their Adam moments, the output channels
gathered over the model group) runs in the same rank processes last, over
``model:2`` (two ranks sharing one card) or ``data:N/2,model:2`` (a card
each), at the default ``min_size``. For MTAN and basic at full width, each
rank the whole of its data block: the parameter-and-moment bytes a rank
holds against one process's (MTAN's must be 53.6% +- 1%); one f32 step
held to the one-process step as the other phases' are; 1 + 3 bf16 steps,
after which the replicated leaves and their moments hold the same bits on
every rank and each sharded one on the data ranks of its slice, their p50
beside the one-process step's; the model group's collectives of one step
by kind (copy-in, gather-out, the gate's whole weights). Then MTAN's
``Predictor(8, mesh=)`` of the sharded f32 model against the one-process
answer; the training CLI for one MTAN epoch over the mesh, whose
checkpoint must hold the trained state gathered whole bit for bit and
whose one-process f32 ``Predictor`` must answer as the same checkpoint
sharded over the mesh does; both gates at MTAN's shapes with ``dec0``'s
``w1`` gathered (B4 staged over the replica group when it has several
ranks). Then MTAN with ``fold_tasks`` and basic with ``fold_tail`` over
the same mesh, at the default ``min_size``, each as MTAN and basic above
(the bytes, the f32 step held to the folded model's one-process step, the
bf16 steps, the collectives by kind); the folded MTAN's ``Predictor(8,
mesh=)`` against the one-process answer (its seeded weights are the
unfolded ones, converted); B1 and B4 over the task axis at MTAN's shapes
with every task-stacked ``w1`` and ``w2`` that the layout shards gathered
over the model group inside the call. Launches are counted exactly per
rank: 8 task-axis B1 launches a folded forward, 8 task-axis B4 calls a
folded step.

``--parallel [phase ...]`` builds the kernels and runs the MTAN and basic f32 checks
against the CPU (for their limits), their bf16 steps (for the one-process
p50s) and the rank phases alone (all of ``parallel``, ``spatial`` and
``model``, or those named), then prints the
card's name and power limit and no ``ok`` line: a development run, and the
phases over several cards.

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
  * fused_attention_gate_tasks and fused_attention_gate_train_tasks (the
    task axis): the same limits as their one-task gates, and each task
    bit-identical to its own T = 1 launch;
  * confusion_matrix: exact (integer counts) on every label mix;
  * conv3x3_small (B3), at the forward and dx shapes of a basic and of a
    CSNet train step: f32 max |diff| <= 1e-4 of the output's largest
    magnitude (sums of up to 720 products in another order), bf16 within
    one bf16 rounding step as the gates, and bit-identical on a second
    launch.

NYUv2 and the CLI paths: ``read_png`` exact for the three formats; the
resumed drill run's final weights bit for bit those of the uninterrupted
run, or, where the two uninterrupted runs differ, within 10 times their
relative L2 distance; its position and batch order exactly; the
harness's table within one unit of its third decimal of the runs' own
predict metrics, rounded as it rounds.

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
(cuDNN, no TF32) of the same inputs, timed here only; its ``kernels``
entry sums one bf16 train step of the basic model and one of CSNet. Each
gate's function needs each of its two products once, 2N(Cin hidden +
hidden C2) operations in f32: ``bound_f32_ms`` at the f32 peak. The kernels take them as 3xTF32,
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

Lines before the last: per-shape results of both gates and of B3 (the
basic model's shapes, then CSNet's), each model's serving and evaluation
numbers and training numbers, the confusion matrix on its label mixes, one
``cli`` line per model (per run: end-to-end epoch train img/s, the train,
val and predict sweeps' img/s, checkpoint save and restore seconds, peak
memory above what was live when the run began, launches; beside them the
bare step's img/s of the training phase, the loader's img/s alone and with
the copies to the card, and the card's idle share over one more epoch of
the loop, from torch.profiler), the per-shape and per-call kernel lines at
the NYUv2 shapes and the ``nyuv2`` line, the ``task_gate_shapes`` line,
the ``interop``, ``options``, ``parallel``, ``spatial`` and ``model_axis`` lines, the
``timing`` line (the
kernels' build and the whole run, in seconds), the ``kernels`` JSON line (each entry
with its ``nyuv2`` numbers beside), the card's name and power limit. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import csv
import glob
import io
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import threading
import time
import types
import urllib.request
import zlib

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
PER_FORWARD = {
    "mtan": {"fused_attention_gate": 16},
    "basic": {"conv3x3_small": 4},
    "csnet": {"conv3x3_small": 12},  # 5 decoder convs and a head per task
    # the options phase: MTAN with fold_tasks (one task-axis gate a level;
    # remat_attention changes no eval forward), basic with fold_tail (the
    # folded tail and heads are plain convolutions)
    "mtan_folded": {"fused_attention_gate_tasks": 8},
    "mtan_folded_remat": {"fused_attention_gate_tasks": 8},
    "basic_fold_tail": {"conv3x3_small": 1},
}
BACKWARD = "fused_attention_gate_train_backward"  # B4's backward kernel: one call
# per gate call of a step (a rematerialised gate's recompute adds none)
PER_TRAIN_STEP = {
    "mtan": {"fused_attention_gate_train": 16, BACKWARD: 16, "confusion_matrix": 1},
    "basic": {"conv3x3_small": 8, "confusion_matrix": 1},  # 4 forward, 4 dx
    "csnet": {"conv3x3_small": 24, "confusion_matrix": 1},  # 12 forward, 12 dx
    "mtan_folded": {"fused_attention_gate_train_tasks": 8, BACKWARD: 8, "confusion_matrix": 1},
    # remat_attention's recompute relaunches each level's gate
    "mtan_folded_remat": {"fused_attention_gate_train_tasks": 16, BACKWARD: 8,
                          "confusion_matrix": 1},
    "basic_fold_tail": {"conv3x3_small": 2, "confusion_matrix": 1},
}
LR = 1e-3
TRAIN_WARMUP = 3
TRAIN_TIMED = 12
TRAIN_BATCHES = 4  # cycled: each batch is seen every 4 steps
# the cli phase's Cityscapes-layout tree and run dirs (under build/, which
# git ignores)
CLI_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
                        "cityscapes")
CLI_LOGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
                        "lightning_logs")
CLI_SAMPLES = {"train": 40, "val": 16}
# the nyuv2 phase's tree (PNGs at the dataset's 480x640) and the
# preemption drill's run dirs
NYU_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
                        "nyuv2")
NYU_DRILL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
                         "drill")
NYU_SAMPLES = {"train": 40, "test": 16}
NYU_HW = (480, 640)
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
# conv biases, each followed by a BatchNorm; basic and both CSNet encoders:
# the projection BN biases of encoder stages 3 and 5, whose outputs reach
# the loss only through a 1x1 conv and a BatchNorm, in CSNet after a
# per-channel stitch scale, which keeps a per-channel constant constant)
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
# the same at NYUv2's 256x256: every H doubles
GATE_SHAPES_NYU = [(level, cin, c2, 2 * h, w) for level, cin, c2, h, w in GATE_SHAPES]
HIDDEN = 128
# (call, C, O, H, W, bias, calls per train step) of kernel B3 on 128x256
# images, by model: the forward's convs and the backward's dx (the same kernel on the
# flipped, transposed weights, O and C swapped, no bias). CSNet runs each
# decoder conv once per task, each head once.
SMALL_CONV_SHAPES = {
    "basic": [
        ("fwd block_3.conv1", 67, 67, 64, 128, False, 1),
        ("fwd block_4.conv0", 67, 33, 128, 256, False, 1),
        ("fwd block_4.conv1", 33, 33, 128, 256, False, 1),
        ("fwd merged head", 33, 20, 128, 256, True, 1),
        ("dx block_3.conv1", 67, 67, 64, 128, False, 1),
        ("dx block_4.conv0", 33, 67, 128, 256, False, 1),
        ("dx block_4.conv1", 33, 33, 128, 256, False, 1),
        ("dx merged head", 20, 33, 128, 256, False, 1),
    ],
    # basic on NYUv2 (256x256, batch 4): the merged head is 14 classes + depth
    "basic_nyuv2": [
        ("fwd block_3.conv1", 67, 67, 128, 128, False, 1),
        ("fwd block_4.conv0", 67, 33, 256, 256, False, 1),
        ("fwd block_4.conv1", 33, 33, 256, 256, False, 1),
        ("fwd merged head", 33, 15, 256, 256, True, 1),
        ("dx block_3.conv1", 67, 67, 128, 128, False, 1),
        ("dx block_4.conv0", 33, 67, 256, 256, False, 1),
        ("dx block_4.conv1", 33, 33, 256, 256, False, 1),
        ("dx merged head", 15, 33, 256, 256, False, 1),
    ],
    # CSNet on NYUv2 (256x256, batch 4): the segmentation head is 16 -> 14
    "csnet_nyuv2": [
        ("fwd decoders_t_2.conv1", 64, 64, 64, 64, False, 2),
        ("fwd decoders_t_3.conv0", 80, 32, 128, 128, False, 2),
        ("fwd decoders_t_3.conv1", 32, 32, 128, 128, False, 2),
        ("fwd decoders_t_4.conv0", 32, 16, 256, 256, False, 2),
        ("fwd decoders_t_4.conv1", 16, 16, 256, 256, False, 2),
        ("fwd depth head", 16, 1, 256, 256, True, 1),
        ("fwd segm head", 16, 14, 256, 256, True, 1),
        ("dx decoders_t_2.conv1", 64, 64, 64, 64, False, 2),
        ("dx decoders_t_3.conv0", 32, 80, 128, 128, False, 2),
        ("dx decoders_t_3.conv1", 32, 32, 128, 128, False, 2),
        ("dx decoders_t_4.conv0", 16, 32, 256, 256, False, 2),
        ("dx decoders_t_4.conv1", 16, 16, 256, 256, False, 2),
        ("dx depth head", 1, 16, 256, 256, False, 1),
        ("dx segm head", 14, 16, 256, 256, False, 1),
    ],
    "csnet": [
        ("fwd decoders_t_2.conv1", 64, 64, 32, 64, False, 2),
        ("fwd decoders_t_3.conv0", 80, 32, 64, 128, False, 2),
        ("fwd decoders_t_3.conv1", 32, 32, 64, 128, False, 2),
        ("fwd decoders_t_4.conv0", 32, 16, 128, 256, False, 2),
        ("fwd decoders_t_4.conv1", 16, 16, 128, 256, False, 2),
        ("fwd depth head", 16, 1, 128, 256, True, 1),
        ("fwd segm head", 16, 19, 128, 256, True, 1),
        ("dx decoders_t_2.conv1", 64, 64, 32, 64, False, 2),
        ("dx decoders_t_3.conv0", 32, 80, 64, 128, False, 2),
        ("dx decoders_t_3.conv1", 32, 32, 64, 128, False, 2),
        ("dx decoders_t_4.conv0", 16, 32, 128, 256, False, 2),
        ("dx decoders_t_4.conv1", 16, 16, 128, 256, False, 2),
        ("dx depth head", 1, 16, 128, 256, False, 1),
        ("dx segm head", 19, 16, 128, 256, False, 1),
    ],
}


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


def device_times(fn, n: int = 10, launches: tuple = (), sessions: int = 2) -> dict:
    """Device time of one call by kernel name (and memset or memcpy), from
    torch.profiler over ``sessions`` sessions of ``n`` calls. Unlike
    :func:`time_ms` it does not read the host's time to launch them, which a
    call whose kernels are short can exceed.

    The tracer does not record every launch: sessions have missed kernels
    of a few microseconds and memcopies, and a time summed over what was
    seen and divided by ``n`` would read the call faster than it is. So a
    kernel's time per call is its mean over the launches the sessions saw,
    times its launches per call: the most any session saw, per call,
    rounded. A session that saw no device activity at all is run again
    with twice the calls, up to 6 times in all: after another process had
    used the card (the ``interop`` phase's loader), the tracer came back
    empty for many short sessions and for none of the longer ones (H100).
    Fails if no session saw device activity, or if a pattern of
    ``launches`` (a regex on kernel names) matched no kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen: dict = {}  # name: [total us, launches seen, most launches a call]
    done = empty = 0
    while done < sessions and empty < 6:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0
                  and not getattr(e, "is_user_annotation", False)]
        if not events:
            empty += 1
            n *= 2
            print(f"chip_smoke: a torch.profiler session saw no device activity; run again "
                  f"with {n} calls", file=sys.stderr, flush=True)
            continue
        done += 1
        for e in events:
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


def counts_since(kernels, mark: dict) -> dict:
    """Launches by kernel since ``mark`` (a ``launch_counts()``)."""
    return {name: n - mark[name] for name, n in kernels.launch_counts().items()}


def tf32_flops(n: int, cin: int, c2: int, x_bf16: bool, first_products: int = 1) -> float:
    """Operations of a gate's two products taken as 3xTF32: three TF32
    products for each f32 one, but two for x @ w1 when x is bf16, which TF32
    holds exactly; x @ w1 taken ``first_products`` times."""
    k1 = 2 if x_bf16 else 3
    return 2.0 * n * (first_products * k1 * cin * HIDDEN + 3 * HIDDEN * c2)


def check_gate(dev, fused_gate, shapes: list = GATE_SHAPES,
              dtypes: tuple = (torch.bfloat16, torch.float32)) -> tuple:
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
    for level, cin, c2, h, w in shapes:
        for dtype in dtypes:
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


def check_gate_split(fused_gate_train, args: tuple, fused: tuple) -> dict:
    """B4's staged call across ranks (``comm``) against its fused call on the
    same inputs: with one rank, bit for bit; with two ranks, the rows cut in
    two halves run by two threads of this process (``ThreadComm``), whose
    statistics the wrapper combines between the passes. The halves' output
    within :func:`output_ok`'s tolerance of the fused output (the same as
    against the plain version: only the order of the f64 sums differs), their
    statistics within 1e-5 relative, and the same on both ranks, bit for
    bit."""
    from vision_mtl_tpu_torch.parallel.multihost import ThreadComm, ThreadGroup

    dev = args[0].device
    with torch.no_grad():
        # below the wrapper, which runs one rank as the fused call
        one = fused_gate_train._launch(*args, 1e-5, comm=ThreadComm(ThreadGroup(1), 0, dev))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(one, fused)):
        fail("fused_attention_gate_train: the staged call with one rank differs from the fused "
             "call")
    threads, halves = ThreadGroup(2, timeout=60.0), [None, None]

    def rank(r: int) -> None:
        x, shared = (a.chunk(2)[r] for a in args[:2])
        with torch.no_grad():
            halves[r] = fused_gate_train.fused_attention_gate_train(
                x, shared, *args[2:], comm=ThreadComm(threads, r, dev))

    pool = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    torch.cuda.synchronize()
    if any(h is None for h in halves):
        fail("fused_attention_gate_train: a rank of the two-halves call raised")
    err, ok = output_ok(torch.cat([halves[0][0], halves[1][0]]), fused[0])
    if not ok:
        fail(f"fused_attention_gate_train: two halves' output max |diff| {err} from the fused call")
    stat_err = 0.0
    for i in range(1, 5):
        if not torch.equal(halves[0][i], halves[1][i]):
            fail("fused_attention_gate_train: the two ranks' statistics differ")
        d = (halves[0][i] - fused[i]).abs()
        stat_err = max(stat_err, float(d.max()))
        if not bool((d <= 1e-5 * fused[i].abs() + 1e-6).all()):
            fail(f"fused_attention_gate_train: two halves' statistic {i} max |diff| "
                 f"{float(d.max())} from the fused call")
    return {"one_rank_bit_for_bit": True, "halves_max_abs_err": err,
            "halves_stats_max_abs_err": stat_err}


def clear_of_the_kink(x, w1, b1, scale1, bias1, eps: float = 1e-5) -> None:
    """Moves BN1's beta (``bias1``, in place) so that each channel's relu
    threshold, h^ = -beta / gamma, lies mid-way in the widest gap of that
    channel's h^ values (f64) within 0.5 of where it was: at a pixel within
    rounding of the threshold two f32 computations of the gate's gradient
    decide the relu apart, and the gradient jumps there. BN1's statistics do
    not depend on beta."""
    h = x.reshape(-1, x.shape[-1]).double() @ w1.double() + b1.double()
    var, mean = torch.var_mean(h, 0, unbiased=False)
    hhat = ((h - mean) / torch.sqrt(var + eps)).sort(0).values
    target = -bias1.double() / scale1.double()
    gaps, mids = hhat[1:] - hhat[:-1], (hhat[1:] + hhat[:-1]) / 2
    best = torch.where((mids - target).abs() < 0.5, gaps, 0.0).argmax(0, keepdim=True)
    bias1.copy_((-mids.gather(0, best)[0] * scale1.double()).float())


def check_gate_train(dev, fused_gate_train, shapes: list = GATE_SHAPES,
                     split: bool = False,
                     dtypes: tuple = (torch.bfloat16, torch.float32)) -> tuple:
    """The train-mode gate against its plain version at the MTAN gate
    shapes: output, the four statistics, and the same bits from a second
    launch; its backward kernel's gradients against the plain backward's,
    and the kernel's time beside that version's and its bound. ``split``:
    also its staged call across ranks (:func:`check_gate_split`)."""
    gen = torch.Generator(device=dev).manual_seed(10)
    rows = []
    totals = {"ms": 0.0, "events_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "bound_f32_ms": 0.0, "bound_design_ms": 0.0, "backward_ms": 0.0,
              "backward_plain_ms": 0.0, "backward_bound_ms": 0.0, "err": 0.0}
    by_flops = by_bytes = 0.0
    slower_than_plain = []
    for level, cin, c2, h, w in shapes:
        for dtype in dtypes:
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
            clear_of_the_kink(*args[:1], *args[2:6])
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
            split_row = check_gate_split(fused_gate_train, args, got) if split else None
            if split_row is not None:
                totals["split_err"] = max(totals.get("split_err", 0.0),
                                          split_row["halves_max_abs_err"])
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
                if split_row is not None:
                    row["staged_across_ranks"] = split_row
            if row["ms"] > row["plain_ms"]:
                slower_than_plain.append(f"{level} {row['dtype']}")
            # the backward kernel: its ten gradients held to the plain
            # backward's on the card, its time against that version's and
            # against its bound (x, shared, dout read, dx and dshared
            # written once; its six products once each at 3xTF32)
            cot = torch.randn(got[0].shape, generator=gen, device=dev).to(dtype)
            saved = (*args, *got[1:])
            grads = fused_gate_train._launch_backward(
                1e-5, cot[None], args[0][None], args[1], *(v[None] for v in saved[2:]))
            plain_grads = fused_gate_train._gate_backward(1e-5, cot, *saved)
            torch.cuda.synchronize()
            top = max(float(v.abs().max()) for v in plain_grads)
            grad_err = 0.0
            for i, (g, r) in enumerate(zip(grads, plain_grads)):
                g, r = g.float().reshape(r.shape), r.float()
                d = float((g - r).abs().max())
                # b1, b2: 0 up to rounding (a batch-statistic BN follows)
                limit = 1e-4 * (top if i in (3, 7) else float(r.abs().max())) + 1e-6
                if g.dtype != r.dtype or i in (0, 1) and dtype == torch.bfloat16:
                    limit += float(r.abs().max()) * 2**-7
                if not d <= limit:
                    fail(f"fused_attention_gate_train backward {level} {dtype}: gradient {i} "
                         f"max |diff| {d} from the plain backward")
                if i not in (3, 7):
                    grad_err = max(grad_err, d / max(float(r.abs().max()), 1e-30))
            nbytes_bwd = args[0].element_size() * n * (2 * cin + 3 * c2)
            flops_bwd = 2.0 * n * ((2 if x_bf16 else 3) * 2 * cin * HIDDEN + 3 * cin * HIDDEN
                                   + 9 * HIDDEN * c2)
            row["backward_bound_ms"], row["backward_bound_by"] = bound(
                nbytes_bwd, flops_bwd, TF32_TC_FLOPS_PER_S)
            row["backward_ms"] = time_ms(lambda: fused_gate_train._launch_backward(
                1e-5, cot[None], args[0][None], args[1], *(v[None] for v in saved[2:])))
            row["backward_plain_ms"] = time_ms(
                lambda: fused_gate_train._gate_backward(1e-5, cot, *saved), iters=5)
            row["backward_max_rel_err"] = grad_err
            rows.append(row)
            totals["err"] = max(totals["err"], err)
            if dtype == torch.bfloat16:  # the main path's dtype: 2 tasks per level
                for k in ("ms", "events_ms", "plain_ms", "bound_ms", "bound_f32_ms",
                          "bound_design_ms", "backward_ms", "backward_plain_ms",
                          "backward_bound_ms"):
                    totals[k] += 2 * row[k]
                by_flops += 2 * tc_flops / TF32_TC_FLOPS_PER_S
                by_bytes += 2 * nbytes / HBM_BYTES_PER_S
    totals["bound_by"] = "operations" if by_flops >= by_bytes else "bytes"
    totals["slower_than_plain"] = slower_than_plain
    return rows, totals


def confmat_mixes(dev, num_classes: int, main_path: tuple, shape: tuple = (BATCH, 128, 256)) -> dict:
    """Label mixes for the confusion matrix at ``shape``, each
    (targets, preds, mask): uniform random ids (some outside [0, C), the
    last sample but one left out by the mask); the main path's own ids
    (``main_path``, as the path passed them); and one class
    everywhere, every lane of a warp on one cell."""
    gen = torch.Generator(device=dev).manual_seed(1)
    t = torch.randint(-1, num_classes + 2, shape, generator=gen, device=dev, dtype=torch.int32)
    t[0, :4, :4] = 255  # an ignore-style label outside [0, C)
    p = torch.randint(0, num_classes + 1, shape, generator=gen, device=dev, dtype=torch.int32)
    valid = torch.ones(shape[0], device=dev, dtype=torch.bool)
    valid[-2] = False
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


def check_small_conv(dev, small_conv, shapes: list, batch: int = BATCH) -> tuple:
    """Kernel B3 against its plain version at the shapes of one model's
    train step (``SMALL_CONV_SHAPES``), bf16 and f32: output, the same bits
    from a second launch; times of the kernel, the plain version and one
    cuDNN ``F.conv2d``. Totals are for one bf16 train step, each shape
    counted as often as the step calls it."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(20)
    rows = []
    totals = {"ms": 0.0, "events_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "err": 0.0,
              "fwd_ms": 0.0, "dx_ms": 0.0, "fwd_library_ms": 0.0, "dx_library_ms": 0.0,
              "bytes": 0.0, "flops": 0.0}
    slower_than_library = []
    for call, c, o, h, w, has_bias, per_step in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(batch, h, w, c, generator=gen, device=dev).to(dtype)
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
            n = batch * h * w
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
                "calls_per_step": per_step,
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
                    totals[key] += per_step * row[key]
                part = call.split()[0]
                totals[f"{part}_ms"] += per_step * row["ms"]
                totals[f"{part}_library_ms"] += per_step * row["library_ms"]
                totals["bytes"] += per_step * nbytes
                totals["flops"] += per_step * flops
                if row["ms"] >= row["library_ms"]:
                    slower_than_library.append(call)
    totals["bound_ms"], totals["bound_by"] = bound(
        totals["bytes"], totals["flops"], BF16_TC_FLOPS_PER_S
    )
    totals["faster_than_library"] = totals["ms"] < totals["library_ms"]
    totals["bf16_shapes_not_faster_than_library"] = slower_than_library
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
    rounded to bf16 (MTAN: the train gate's input and weights; basic and
    CSNet: B3's input and weights on every conv it takes)."""
    if name == "mtan":
        from vision_mtl_tpu_torch.models import mtan as module

        attr = "fused_attention_gate_train"
        real = module.fused_attention_gate_train

        def patched(x, shared, w1, b1, scale1, bias1, w2, *rest, **kw):
            return real(_bf16(x), shared, _bf16(w1), b1, scale1, bias1, _bf16(w2), *rest, **kw)
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


def write_cityscapes_tree(root: str, cfg, seed: int = 8) -> dict:
    """A Cityscapes-layout tree of seeded, learnable triples at the config's
    size: f32 images in [0, 1] (multiples of 1/255, so the compact wire
    holds them exactly), int64 labels that are a function of the pixel with
    some ignore ids -1, f32 inverse depth of the pixel."""
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(seed)
    nbytes = 0
    for stage, n in CLI_SAMPLES.items():
        for sub in ("image", "label", "depth"):
            os.makedirs(os.path.join(root, stage, sub))
        for i in range(n):
            px = rng.integers(0, 256, size=(cfg.height, cfg.width, 3))
            arrays = {
                "image": (px / 255.0).astype(np.float32),
                "label": np.where(px[..., 2] < 8, -1, (px[..., 0] * cfg.num_classes) // 256
                                  ).astype(np.int64),
                "depth": (np.maximum(px[..., 1], 1) / 255.0).astype(np.float32),
            }
            for sub, a in arrays.items():
                np.save(os.path.join(root, stage, sub, f"{i:04d}.npy"), a)
                nbytes += a.nbytes
    return {"root": root, "samples": dict(CLI_SAMPLES), "bytes": nbytes}


@contextlib.contextmanager
def probe_cli():
    """Records what one in-process CLI run did, passing every call on:
    ``run_pipe``'s args, datamodule, start epoch and start weights (copied)
    and its final state; the train loader's batch orders; each sweep's rows
    and seconds (ended by a synchronise); each checkpoint save and restore's
    seconds."""
    from vision_mtl_tpu_torch import predict as predict_mod
    from vision_mtl_tpu_torch import training
    from vision_mtl_tpu_torch.data import loader
    from vision_mtl_tpu_torch.train import checkpoint, loop

    rec: dict = {"orders": [], "sweeps": [], "save_s": [], "restore_s": []}
    real = {
        (training, "run_pipe"): training.run_pipe,
        (loader.DataLoader, "_index_batches"): loader.DataLoader._index_batches,
        (loop, "prefetch_to_device"): loop.prefetch_to_device,
        (predict_mod, "prefetch_to_device"): predict_mod.prefetch_to_device,
        (loop, "save_ckpt"): loop.save_ckpt,
        (checkpoint, "restore_session"): checkpoint.restore_session,
    }

    def run_pipe(args, state, datamodule, **kw):
        rec.update(args=args, datamodule=datamodule, start_epoch=kw.get("start_epoch", 0),
                   start_weights={k: v.detach().clone() for k, v in state.model.state_dict().items()})
        state, metrics = real[(training, "run_pipe")](args, state, datamodule, **kw)
        rec["state"] = state
        return state, metrics

    def index_batches(self):
        batches = real[(loader.DataLoader, "_index_batches")](self)
        if self.shuffle:
            rec["orders"].append([b.tolist() for b in batches])
        return batches

    def timed_sweeps(module, label):
        def prefetch(iterator, device, size=2):
            kind = label or ("train" if getattr(iterator, "shuffle", False) else "val")
            t0, rows = time.perf_counter(), 0
            for batch in real[(module, "prefetch_to_device")](iterator, device, size):
                rows += batch["img"].shape[0]
                yield batch
            torch.cuda.synchronize()
            rec["sweeps"].append({"kind": kind, "rows": rows, "s": time.perf_counter() - t0})
        return prefetch

    def timed(key, out):
        def call(*args, **kw):
            t0 = time.perf_counter()
            result = real[key](*args, **kw)
            rec[out].append(time.perf_counter() - t0)
            return result
        return call

    patches = {
        (training, "run_pipe"): run_pipe,
        (loader.DataLoader, "_index_batches"): index_batches,
        (loop, "prefetch_to_device"): timed_sweeps(loop, None),
        (predict_mod, "prefetch_to_device"): timed_sweeps(predict_mod, "predict"),
        (loop, "save_ckpt"): timed((loop, "save_ckpt"), "save_s"),
        (checkpoint, "restore_session"): timed((checkpoint, "restore_session"), "restore_s"),
    }
    for (obj, attr), fn in patches.items():
        setattr(obj, attr, fn)
    try:
        yield rec
    finally:
        for (obj, attr), fn in real.items():
            setattr(obj, attr, fn)


def run_cli(name: str, argv: list, cfg, kernels) -> dict:
    """One in-process run of ``python -m vision_mtl_tpu_torch.training``
    with the launch counters set to 0 just before and read just after; the
    launches must equal what the loaders' lengths predict (train steps,
    val and predict forwards)."""
    from vision_mtl_tpu_torch import training

    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with probe_cli() as rec:
        t0 = time.perf_counter()
        run_dir = training.main(argv)
        wall_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    args, dm = rec["args"], rec["datamodule"]
    epochs = args.num_epochs - rec["start_epoch"]
    n_train, n_val, n_pred = (len(dm.train_dataloader()), len(dm.val_dataloader()),
                              len(dm.predict_dataloader()))
    forwards = epochs * n_val + n_pred
    want = expected(kernels, PER_TRAIN_STEP[name], epochs * n_train, confusion_matrix=forwards)
    for k, v in PER_FORWARD[name].items():
        want[k] += v * forwards
    if counts != want:
        fail(f"{name} cli {argv}: launches {counts}, want {want} ({epochs} epochs of {n_train} "
             f"train and {n_val} val steps, {n_pred} predict steps)")
    records = [json.loads(ln) for ln in open(os.path.join(run_dir, "metrics.jsonl"))]
    epoch_loss = [r["epoch/train/loss"] for r in records if "epoch/train/loss" in r]
    if len(epoch_loss) != epochs or not all(np.isfinite(epoch_loss)):
        fail(f"{name} cli: epoch train losses {epoch_loss}")
    predict_metrics = {k: v for r in records for k, v in r.items() if k.startswith("predict/")}
    if len(predict_metrics) != 7 or not all(np.isfinite(list(predict_metrics.values()))):
        fail(f"{name} cli: predict metrics {predict_metrics}")
    preds = np.load(os.path.join(run_dir, "preds.npz"))
    n_pred_rows = len(dm.data_predict)
    spec = cfg.test_transform
    if preds["segm"].shape != (n_pred_rows, spec.height, spec.width) or preds["segm"].max() >= \
            cfg.num_classes or not np.isfinite(preds["depth"]).all():
        fail(f"{name} cli: preds.npz segm {preds['segm'].shape}, depth finite "
             f"{np.isfinite(preds['depth']).all()}")

    def img_per_s(kind):
        return [s["rows"] / s["s"] for s in rec["sweeps"] if s["kind"] == kind]

    return {
        "run_dir": run_dir, "rec": rec, "records": records, "launches": counts,
        "loader_lengths": {"train": n_train, "val": n_val, "predict": n_pred},
        "epoch_train_loss": epoch_loss,
        "first_logged_step": min(r["step"] for r in records if "step/train/loss" in r),
        "line": {
            "argv": argv, "wall_s": wall_s, "epochs": epochs, "launches": counts,
            "loader_lengths": {"train": n_train, "val": n_val, "predict": n_pred},
            "epoch_train_loss": epoch_loss,
            "epoch_train_img_per_s_end_to_end":
                [r["epoch/train/imgs_per_sec"] for r in records if "epoch/train/imgs_per_sec" in r],
            "train_sweep_img_per_s": img_per_s("train"),
            "val_sweep_img_per_s": img_per_s("val"),
            "predict_sweep_img_per_s": img_per_s("predict"),
            "ckpt_save_s": rec["save_s"], "ckpt_restore_s": rec["restore_s"],
            # what the run allocated beyond what was live when it began
            "peak_memory_above_start_bytes": torch.cuda.max_memory_allocated() - base_bytes,
            "predict_metrics": predict_metrics,
        },
    }


def time_loading(run: dict, dev) -> dict:
    """The host side of the loop alone, over one epoch of a fresh train
    loader of the run's datamodule: decode on the thread pool, collate and
    the compact wire; then the same through ``prefetch_to_device`` (pinning
    and the copies), ended by a synchronise. Images per second."""
    from vision_mtl_tpu_torch.data.loader import prefetch_to_device

    dm = run["rec"]["datamodule"]
    out = {}
    for key, wrap in (("loader_img_per_s", iter),
                      ("loader_and_copy_img_per_s", lambda it: prefetch_to_device(it, dev))):
        t0, rows = time.perf_counter(), 0
        for batch in wrap(dm.train_dataloader()):
            rows += batch["img"].shape[0]
        torch.cuda.synchronize()
        out[key] = rows / (time.perf_counter() - t0)
    return out


def profile_epoch(run: dict, cfg, dev) -> dict:
    """Where one more epoch of the run's loop (loading, copies, train steps
    and the val sweep, through ``run_pipe``) spends the card's time, and its
    idle share (:func:`profile_device`)."""
    from vision_mtl_tpu_torch.train.loop import run_pipe

    rec = run["rec"]
    args, dm, state = rec["args"], rec["datamodule"], rec["state"]
    n = args.num_epochs

    def epoch():
        run_pipe(args, state, dm, num_epochs=n + 1, num_classes=cfg.num_classes, start_epoch=n,
                 device=dev)

    return profile_device(epoch, 1)


def serve_run_dir(name: str, run_dir: str, model, cfg, dev, kernels) -> dict:
    """``python -m vision_mtl_tpu_torch.serve --run_dir`` (in process, on a
    free port, bucket 1, raw uint8 wire) answers one request: its ids equal
    ``Predictor`` on the trained model in memory, its depth within one bf16
    step of it. Launches: the bucket's warm-up forward and the request's."""
    from vision_mtl_tpu_torch import serve
    from vision_mtl_tpu_torch.serving import Predictor

    servers, errors = [], []
    make = serve.make_server

    def capture(*a, **k):
        servers.append(make(*a, **k))
        return servers[-1]

    def target():
        try:
            serve.main(["--run_dir", run_dir, "--port", "0", "--buckets", "1",
                        "--wire_dtype", "uint8"])
        except BaseException as e:  # reported by the caller's fail()
            errors.append(repr(e))

    img = np.random.default_rng(9).integers(0, 256, size=(cfg.height, cfg.width, 3),
                                            dtype=np.uint8)
    serve.make_server = capture
    kernels.reset_launch_counts()
    th = threading.Thread(target=target, daemon=True)
    th.start()
    try:
        deadline = time.monotonic() + 120
        while not servers and not errors and time.monotonic() < deadline:
            time.sleep(0.05)
        if not servers:
            fail(f"serve --run_dir {run_dir} did not start: {errors}")
        httpd = servers[0]
        try:
            buf = io.BytesIO()
            np.save(buf, img)
            t0 = time.perf_counter()
            with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{httpd.server_address[1]}/predict", data=buf.getvalue()),
                timeout=120) as r:
                out = np.load(io.BytesIO(r.read()))
            request_s = time.perf_counter() - t0
        finally:
            httpd.shutdown()
    finally:
        serve.make_server = make
        th.join(timeout=120)
    if th.is_alive() or errors:
        fail(f"serve --run_dir did not stop cleanly: alive {th.is_alive()}, {errors}")
    counts = kernels.launch_counts()
    if counts != expected(kernels, PER_FORWARD[name], 2):
        fail(f"serve --run_dir: launches {counts} for 2 forwards")
    want = Predictor(model.eval(), 1, cfg.height, cfg.width, dtype=np.uint8, device=dev)(img[None])
    if not np.array_equal(out["segm"], want["segm"]):
        fail(f"serve --run_dir: segm ids differ from Predictor on {(out['segm'] != want['segm']).sum()} "
             "pixels")
    depth_err = np.abs(out["depth"] - want["depth"])
    if not (depth_err <= np.abs(want["depth"]) * 2**-7 + 1e-6).all():
        fail(f"serve --run_dir: depth off Predictor by {depth_err.max()}")
    return {"launches": counts, "request_s": request_s,
            "depth_max_abs_err_vs_predictor": float(depth_err.max())}


def cli_phase(cfg, kernels, dev, bare_steps: dict) -> tuple:
    """The training CLI end to end on a Cityscapes-layout tree, in process:
    MTAN for 2 epochs with a checkpoint each, then ``--resume_dir`` on its
    run dir to epoch 3; basic and CSNet for one epoch each; ``serve
    --run_dir`` on MTAN's resumed run. Returns the ``cli`` lines, the
    runs' launch counts and the last run dir of each model."""
    from vision_mtl_tpu_torch.cfg import cfg as pipeline_cfg
    from vision_mtl_tpu_torch.train.checkpoint import load_ckpt_model

    tree = write_cityscapes_tree(CLI_DATA, cfg)
    shutil.rmtree(CLI_LOGS, ignore_errors=True)
    pipeline_cfg.log_root_dir = CLI_LOGS
    common = ["--dataset_name", "cityscapes", "--data_dir", CLI_DATA, "--batch_size", str(BATCH),
              "--num_workers", "4", "--lr", str(LR), "--save_epoch_freq", "1"]
    lines, launches = [], []

    mtan = run_cli("mtan", common + ["--model_name", "mtan", "--num_epochs", "2"], cfg, kernels)
    run_dir = mtan["run_dir"]
    for entry in ("model_0", "session_0", "model_1", "session_1", "train_args.yaml",
                  "metrics.jsonl", "preds.npz"):
        if not os.path.exists(os.path.join(run_dir, entry)):
            fail(f"mtan cli: {entry} missing from {run_dir}")
    resumed = run_cli("mtan", common + ["--model_name", "mtan", "--num_epochs", "3",
                                        "--resume_dir", run_dir], cfg, kernels)
    rec = resumed["rec"]
    if rec["start_epoch"] != 2:
        fail(f"mtan resume: started at epoch {rec['start_epoch'] + 1}, want 3")
    steps_before = 2 * mtan["loader_lengths"]["train"]
    if resumed["first_logged_step"] != steps_before:
        fail(f"mtan resume: step axis restarts at {resumed['first_logged_step']}, want "
             f"{steps_before}")
    fresh = rec["datamodule"].train_dataloader()
    fresh.epoch = 2
    if rec["orders"][:1] != [[b.tolist() for b in fresh._index_batches()]]:
        fail("mtan resume: epoch 3's batch order is not the shuffle stream's third")
    saved = load_ckpt_model(run_dir, 1)
    differ = [k for k, v in saved.items() if not torch.equal(rec["start_weights"][k].cpu(), v)]
    if differ or saved.keys() != rec["start_weights"].keys():
        fail(f"mtan resume: start weights differ from model_1 at {differ[:5]}")
    losses = mtan["epoch_train_loss"] + resumed["epoch_train_loss"]
    if not losses[-1] < losses[0]:
        fail(f"mtan cli: epoch train loss went {losses[0]} -> {losses[-1]}")
    served = serve_run_dir("mtan", resumed["run_dir"], rec["state"].model, cfg, dev, kernels)
    line = {
        "model": "mtan", "data": tree, "runs": [mtan["line"], resumed["line"]],
        "epoch_train_loss_first_last": [losses[0], losses[-1]],
        "resume": {"start_epoch": rec["start_epoch"] + 1, "first_logged_step":
                   resumed["first_logged_step"], "weights_equal_model_1": True,
                   "order_equals_fresh_loader_epoch_2": True},
        "serve_run_dir": served,
        "bare_step_img_per_s": bare_steps["mtan"],
        "host_loading": time_loading(resumed, dev),
        "profile_one_epoch": profile_epoch(resumed, cfg, dev),
    }
    lines.append(line)
    launches += [mtan["launches"], resumed["launches"], served["launches"]]
    run_dirs = {"mtan": resumed["run_dir"]}
    del mtan, resumed, rec, saved  # the runs' models and weights leave the card

    for name in ("basic", "csnet"):
        run = run_cli(name, common + ["--model_name", name, "--num_epochs", "1"], cfg, kernels)
        lines.append({"model": name, "data": tree, "runs": [run["line"]],
                      "bare_step_img_per_s": bare_steps[name],
                      "host_loading": time_loading(run, dev),
                      "profile_one_epoch": profile_epoch(run, cfg, dev)})
        launches.append(run["launches"])
        run_dirs[name] = run["run_dir"]
        del run
    return lines, launches, run_dirs


class _Tee(io.StringIO):
    """Keeps what is printed while passing it on."""

    def __init__(self, out):
        super().__init__()
        self._out = out

    def write(self, s: str) -> int:
        self._out.write(s)
        return super().write(s)


SWEEP_TRIALS = 3


def chrome_kernel_events(trace_dir: str) -> dict:
    """Kernel launches by name in the Chrome traces under ``trace_dir``."""
    names: dict = {}
    for path in glob.glob(os.path.join(trace_dir, "*.json")):
        with open(path) as f:
            for e in json.load(f).get("traceEvents", []):
                if e.get("cat") == "kernel":
                    names[e["name"]] = names.get(e["name"], 0) + 1
    return names


def surface_phase(cfg, kernels, dev, cli_run_dirs: dict) -> tuple:
    """The rest of the training surface at full MTAN width on the ``cli``
    phase's tree, in process, the launch counters set to 0 at its start and
    read at its end: ``training --do_optimize`` (3 trials of 3 epochs, run
    one after another on the card, then the tuned run for one epoch with
    ``--log_param_histograms_every 2 --do_plot_preds``, registered as
    ``mtan_tuned``); ``eval_harness --from_registry`` over the registry,
    which holds the ``cli`` phase's three runs and the tuned one; a
    ``Predictor`` of the tuned model held bit for bit across two train steps
    of that model (it serves a snapshot); ``utils.profiling.trace`` around
    two more train steps, whose Chrome trace must hold B4's and B2's
    kernels, each step synchronised and timed by ``time.perf_counter``;
    ``get_segm_preds`` on the card against the CPU on the model's own
    logits. matplotlib and tensorboard are
    optional: where one is absent the plot or histogram sink is a no-op, as
    in JAX, and the line says so. Returns the ``surface`` line and its
    launches."""
    import importlib.util

    from vision_mtl_tpu_torch import training, tuning
    from vision_mtl_tpu_torch.cfg import cfg as pipeline_cfg
    from vision_mtl_tpu_torch.data.datamodule import MTLDataModule
    from vision_mtl_tpu_torch.metrics import init_metrics
    from vision_mtl_tpu_torch.pipeline import load_run_model
    from vision_mtl_tpu_torch.serving import Predictor
    from vision_mtl_tpu_torch.tracking.artifacts import registered_runs, registry_path
    from vision_mtl_tpu_torch.train.checkpoint import load_args
    from vision_mtl_tpu_torch.train.state import create_train_state
    from vision_mtl_tpu_torch.train.step import make_train_step
    from vision_mtl_tpu_torch.utils.inference import get_segm_preds
    from vision_mtl_tpu_torch.utils.profiling import trace

    present = {m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "tensorboard")}
    sinks = {
        "plots": "rendered" if present["matplotlib"] else
                 "no matplotlib: each plot prints JAX's 'plot failed' and the run goes on",
        "histograms": "written" if present["tensorboard"] else
                      "no tensorboard: the logger has no TensorBoard writer, histograms are a no-op",
    }
    print(f"chip_smoke: surface: optional packages {present}", flush=True)
    pipeline_cfg.log_root_dir = CLI_LOGS
    registry = registry_path()
    before = registered_runs("cityscapes", path=registry)
    if {k: e["run_dir"] for k, e in before.items()} != cli_run_dirs:
        fail(f"surface: the registry holds {before}, want the cli phase's runs {cli_run_dirs}")

    trials, trial_dirs = [], []
    real_run_trial, real_create_tools = tuning._run_trial, tuning.create_tools

    def run_trial(args, data_cfg, weights, tag, epoch_callback=None, **kw):
        rec = {"tag": tag, "weights": dict(weights), "epochs": 0}

        def cb(epoch, val_metrics):
            rec["epochs"] += 1
            epoch_callback(epoch, val_metrics)

        t0 = time.perf_counter()
        try:
            rec["score"] = real_run_trial(args, data_cfg, weights, tag, epoch_callback=cb, **kw)
            return rec["score"]
        except Exception as e:
            rec["score"] = "pruned" if "Pruned" in type(e).__name__ else repr(e)
            raise
        finally:
            rec["s"] = time.perf_counter() - t0
            trials.append(rec)

    def create_tools(args, **kw):
        tools = real_create_tools(args, **kw)
        trial_dirs.append(tools["logger"].log_dir)
        return tools

    argv = ["--dataset_name", "cityscapes", "--data_dir", CLI_DATA, "--batch_size", str(BATCH),
            "--num_workers", "4", "--lr", str(LR), "--model_name", "mtan", "--do_optimize",
            "--n_trials", str(SWEEP_TRIALS), "--num_epochs", "1",
            "--log_param_histograms_every", "2", "--do_plot_preds"]
    torch.cuda.synchronize()
    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    tuning._run_trial, tuning.create_tools = run_trial, create_tools
    try:
        with contextlib.redirect_stdout(_Tee(sys.stdout)) as printed:
            run_dir = training.main(argv)
    finally:
        tuning._run_trial, tuning.create_tools = real_run_trial, real_create_tools
    sweep_s = time.perf_counter() - t_phase
    sweep_counts = kernels.launch_counts()
    out = printed.getvalue()
    if "n_jobs=2 ignored on cuda: trials share one device queue; running serially" not in out:
        fail("surface: the sweep did not say that its trials run one after another")
    if len(trials) != SWEEP_TRIALS or len(set(trial_dirs)) != SWEEP_TRIALS \
            or run_dir in trial_dirs:
        fail(f"surface: trials {trials} in run dirs {trial_dirs}, tuned run {run_dir}")
    completed = [t for t in trials if t["score"] != "pruned"]
    if len(completed) < 2 or any(t["epochs"] != 3 for t in completed) \
            or any(not isinstance(t["score"], float) or not np.isfinite(t["score"])
                   for t in completed):
        fail(f"surface: trials {trials}")
    best = max(completed, key=lambda t: t["score"])
    run_args = {k: v for k, v in vars(load_args(os.path.join(run_dir, "train_args.yaml"))).items()
                if k in ("loss_segm_weight", "loss_depth_weight", "exp_tags")}
    if run_args != {**best["weights"], "exp_tags": ["best_trial"]}:
        fail(f"surface: the tuned run's args {run_args}, the best trial {best}")
    registered = registered_runs("cityscapes", path=registry)
    if registered.get("mtan_tuned", {}).get("run_dir") != run_dir:
        fail(f"surface: mtan_tuned is not registered as {run_dir}: {registered}")
    dm = MTLDataModule("cityscapes", batch_size=BATCH, train_transform=cfg.train_transform,
                       test_transform=cfg.test_transform)
    dm.setup()
    n_train, n_val, n_pred = (len(dm.train_dataloader()), len(dm.val_dataloader()),
                              len(dm.predict_dataloader()))
    # every epoch of a trial and of the tuned run: its train steps, its val
    # forwards and, where the tree has a benchmark batch, its plot forward
    epochs = sum(t["epochs"] for t in trials) + 1
    bench = 0 if dm.benchmark_batch is None else epochs
    want = expected(kernels, PER_TRAIN_STEP["mtan"], epochs * n_train,
                    confusion_matrix=epochs * n_val + n_pred)
    for k, v in PER_FORWARD["mtan"].items():
        want[k] += v * (epochs * n_val + n_pred + bench)
    if sweep_counts != want:
        fail(f"surface sweep: launches {sweep_counts}, want {want} ({epochs} epochs of {n_train} "
             f"train and {n_val} val steps, {bench} benchmark forwards, {n_pred} predict steps)")
    plot_failures = out.count("plot failed:")
    if present["matplotlib"] and plot_failures:
        fail(f"surface: matplotlib is present but {plot_failures} plots failed")

    # the harness over the registry: the cli phase's three runs and the tuned one
    harness_runs = {**cli_run_dirs, "mtan_tuned": run_dir}
    harness = harness_check("cityscapes", harness_runs, CLI_DATA, CLI_SAMPLES["val"], BATCH,
                            kernels, dev, kinds={"mtan_tuned": "mtan"}, registry=registry)

    # C3: a Predictor serves a snapshot; two bf16 train steps on its module
    # leave its answers bit for bit
    mark = kernels.launch_counts()
    model, _, _ = load_run_model(run_dir, dev)
    imgs = np.random.default_rng(4).integers(0, 256, size=(BATCH, cfg.height, cfg.width, 3),
                                             dtype=np.uint8)
    pred = Predictor(model, BATCH, cfg.height, cfg.width, dtype=np.uint8, device=dev)
    answer = pred(imgs)
    state = create_train_state(model, LR, device=dev)
    step = make_train_step(device=dev)
    mstate = init_metrics(cfg.num_classes, dev)
    batches = train_batches(cfg, 4, BATCH, seed=21)
    for batch in batches[:2]:
        state, mstate, losses = step(state, batch, mstate)
    again = pred(imgs)
    same = all(np.array_equal(again[k], answer[k]) for k in answer)
    if not same or not model.training or pred.model.training:
        fail(f"surface C3: the predictor's answer changed ({not same}) or a mode moved (module "
             f"training {model.training}, snapshot training {pred.model.training})")
    fresh = Predictor(model.eval(), BATCH, cfg.height, cfg.width, dtype=np.uint8, device=dev)(imgs)
    model.train()
    if np.array_equal(fresh["depth"], answer["depth"]):
        fail("surface C3: a new Predictor on the trained module answers as the snapshot")
    c3_counts = counts_since(kernels, mark)
    want = expected(kernels, PER_TRAIN_STEP["mtan"], 2)
    for k, v in PER_FORWARD["mtan"].items():
        want[k] += 3 * v
    if c3_counts != want:
        fail(f"surface C3: launches {c3_counts}, want {want}")

    # two train steps under utils.profiling.trace, each synchronised and timed
    trace_dir = os.path.join(CLI_LOGS, "surface_trace")
    trace_runs = []
    mark = kernels.launch_counts()
    for attempt in range(2):
        shutil.rmtree(trace_dir, ignore_errors=True)
        with trace(trace_dir):
            torch.cuda.synchronize()
            start = time.perf_counter()
            for batch in batches[2:]:
                state, mstate, losses = step(state, batch, mstate)
                torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
        events = chrome_kernel_events(trace_dir)
        trace_runs.append({"kernel_events": sum(events.values()),
                           "img_per_s": len(batches[2:]) * BATCH / elapsed})
        if events:
            break
    b4 = sum(n for name, n in events.items() if "gate_train_kernel" in name)
    b2 = sum(n for name, n in events.items() if "confmat_kernel" in name)
    if not b4 or not b2:
        fail(f"surface: the Chrome trace holds {b4} B4 and {b2} B2 kernels; saw {sorted(events)}")
    trace_counts = counts_since(kernels, mark)
    if trace_counts != expected(kernels, PER_TRAIN_STEP["mtan"], 2 * len(trace_runs)):
        fail(f"surface trace: launches {trace_counts} for {2 * len(trace_runs)} train steps")

    # get_segm_preds on the card against the CPU, on the model's logits
    mark = kernels.launch_counts()
    with torch.inference_mode():
        logits = model.eval()(torch.from_numpy(imgs).to(dev).float() / 255.0)["segm"]
    valid = torch.from_numpy(np.random.default_rng(5).uniform(size=logits.shape[:3]) > 0.2)
    probs, preds = get_segm_preds(valid.to(dev), logits)
    want_probs, want_preds = get_segm_preds(valid, logits.cpu())
    probs_err = (probs.cpu() - want_probs).abs().max().item()
    if probs.device != logits.device or probs_err > 1e-6 or not torch.equal(preds.cpu(), want_preds):
        fail(f"surface get_segm_preds: probs off the CPU by {probs_err}, ids equal "
             f"{torch.equal(preds.cpu(), want_preds)}")
    if counts_since(kernels, mark) != expected(kernels, PER_FORWARD["mtan"], 1):
        fail("surface get_segm_preds: the forward's launches")
    counts = kernels.launch_counts()
    phase_s = time.perf_counter() - t_phase
    for name in ("fused_attention_gate", "fused_attention_gate_train", "confusion_matrix",
                 "conv3x3_small"):
        if counts[name] == 0:
            fail(f"surface: {name} was never launched in the phase")
    del model, pred, state, step
    line = {
        "config": "cityscapes 128x256, 19 classes, bf16, batch 8, MTAN", "s": phase_s,
        "optional_packages": present, "sinks": sinks, "plot_failures_printed": plot_failures,
        "launches": counts,
        "sweep": {"argv": argv, "s": sweep_s, "serial_trials": True, "launches": sweep_counts,
                  "trials": [{k: t[k] for k in ("tag", "weights", "score", "epochs", "s")}
                             for t in trials],
                  "trial_run_dirs": trial_dirs, "tuned_run_dir": run_dir,
                  "tuned_args": run_args, "registered": {k: e["run_dir"]
                                                         for k, e in registered.items()}},
        "harness": {k: harness[k] for k in ("table", "cells_equal", "cells", "wall_s",
                                            "launches")},
        "c3": {"answer_equal_after_2_train_steps": True, "module_training": True,
               "new_predictor_differs": True, "launches": c3_counts},
        "trace": {"attempts": trace_runs, "gate_train_kernel_events": b4,
                  "confmat_kernel_events": b2, "launches": trace_counts},
        "get_segm_preds": {"shape": list(logits.shape), "probs_max_abs_err_vs_cpu": probs_err,
                           "preds_equal": True},
    }
    return line, counts


def write_png(path: str, arr: np.ndarray, level: int = 6) -> None:
    """A PNG of a uint8 (H, W) or (H, W, 3) array, or a uint16 (H, W) one
    (16-bit big-endian gray), with the standard library alone (the port
    needs no PIL). Row y takes filter type y % 5, so each of a
    decoder's five unfilter paths runs."""
    h, w = arr.shape[:2]
    chans = 1 if arr.ndim == 2 else arr.shape[2]
    depth = 16 if arr.dtype == np.uint16 else 8
    bpp = chans * depth // 8
    raw = np.ascontiguousarray(arr.astype(">u2") if depth == 16 else arr.astype(np.uint8))
    rows = raw.view(np.uint8).reshape(h, w * bpp).astype(np.int32)
    up = np.vstack([np.zeros_like(rows[:1]), rows[:-1]])
    left = np.hstack([np.zeros_like(rows[:, :bpp]), rows[:, :-bpp]])
    upleft = np.hstack([np.zeros_like(up[:, :bpp]), up[:, :-bpp]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    ftype = np.arange(h) % 5
    filtered = (rows - np.choose(ftype[:, None], [0 * rows, left, up, (left + up) // 2, paeth])) & 0xFF
    body = np.hstack([ftype[:, None], filtered]).astype(np.uint8).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, {1: 0, 3: 2}[chans], 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(body, level)))
        f.write(chunk(b"IEND", b""))


def nyu_triple(rng, h: int, w: int) -> dict:
    """One seeded, learnable NYUv2 triple at the dataset's size: 8-bit RGB,
    ids 0-13 as a function of the pixel, depth in metres x 1e4 (0.5-10 m)
    as a function of the pixel, 16-bit."""
    rgb = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    seg = ((rgb[..., 0].astype(np.int32) * 14) // 256).astype(np.uint8)
    depth = (5000 + rgb[..., 1].astype(np.int32) * 370).astype(np.uint16)
    return {"rgb": rgb, "seg13": seg, "depth": depth}


def write_nyuv2_tree(root: str, seed: int = 12) -> dict:
    """A NYUv2-layout tree ``{stage}_{rgb,seg13,depth}/NNNN.png`` of seeded
    triples at 480x640; returns its size and each stage's first triple."""
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(seed)
    t0, nbytes, first = time.perf_counter(), 0, {}
    for stage, n in NYU_SAMPLES.items():
        for part in ("rgb", "seg13", "depth"):
            os.makedirs(os.path.join(root, f"{stage}_{part}"))
        for i in range(n):
            arrays = nyu_triple(rng, *NYU_HW)
            for part, a in arrays.items():
                path = os.path.join(root, f"{stage}_{part}", f"{i + 1:04d}.png")
                write_png(path, a)
                nbytes += os.path.getsize(path)
            first.setdefault(stage, arrays)
    return {"root": root, "samples": dict(NYU_SAMPLES), "png_bytes": nbytes,
            "write_s": time.perf_counter() - t0, "first": first}


def check_png_decode(tree: dict) -> dict:
    """The port's native decoder gives back exactly the arrays written, in
    the three formats (8-bit RGB, 8-bit gray, 16-bit gray); ms per decode."""
    from vision_mtl_tpu_torch.data import native

    out = {}
    for stage, arrays in tree["first"].items():
        for part, want in arrays.items():
            path = os.path.join(tree["root"], f"{stage}_{part}", "0001.png")
            got = native.read_png(path)
            if got.shape != want.shape or not np.array_equal(got, want.astype(np.float32)):
                fail(f"read_png {path}: differs from the written array")
            t0 = time.perf_counter()
            for _ in range(5):
                native.read_png(path)
            out[f"{stage}_{part}"] = {"exact": True, "ms": (time.perf_counter() - t0) / 5 * 1e3,
                                      "dtype": str(want.dtype), "shape": list(want.shape)}
    return out


def time_nyu_loader(batch: int, workers: int) -> dict:
    """One epoch of the train stage through the loader at 256x256 (no
    copies to the card): images per second."""
    from vision_mtl_tpu_torch.data.loader import DataLoader
    from vision_mtl_tpu_torch.data.nyuv2 import NYUv2

    dl = DataLoader(NYUv2(stage="train"), batch_size=batch, shuffle=True, drop_last=True,
                    num_workers=workers)
    t0, rows = time.perf_counter(), 0
    for b in dl:
        rows += b["img"].shape[0]
    return {"img_per_s": rows / (time.perf_counter() - t0), "images": rows,
            "batch": batch, "num_workers": workers}


# run in a fresh interpreter for the preemption drill: argv is
# [record.json, log root, *training args]; deterministic algorithms where
# PyTorch has them (warn_only: the bilinear upsample's backward has none)
DRILL_CODE = r"""
import json, sys, time
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.benchmark = False
torch.backends.cudnn.deterministic = True
torch.use_deterministic_algorithms(True, warn_only=True)
from vision_mtl_tpu_torch import kernels, training
from vision_mtl_tpu_torch.cfg import cfg
from vision_mtl_tpu_torch.data import loader
from vision_mtl_tpu_torch.train import checkpoint, loop

out_path, cfg.log_root_dir, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
rec = {"orders": [], "save_s": [], "restore_s": [], "exit": 0}
index_batches = loader.DataLoader._index_batches


def recording(self):
    batches = index_batches(self)
    if self.shuffle:
        rec["orders"].append({"epoch": self.epoch, "skip": self.skip_batches,
                              "order": [b.tolist() for b in batches]})
    return batches


def timed(module, name, key):
    real = getattr(module, name)

    def call(*a, **k):
        t0 = time.perf_counter()
        out = real(*a, **k)
        rec[key].append(time.perf_counter() - t0)
        return out

    setattr(module, name, call)


loader.DataLoader._index_batches = recording
timed(loop, "save_preempt_ckpt", "save_s")
timed(checkpoint, "restore_preempt", "restore_s")
kernels.reset_launch_counts()
t0 = time.perf_counter()
try:
    rec["run_dir"] = training.main(argv)
except SystemExit as e:
    rec["exit"] = e.code
finally:
    torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = kernels.launch_counts()
    with open(out_path, "w") as f:
        json.dump(rec, f)
sys.exit(rec["exit"])
"""


def drill_run(tag: str, argv: list, env_extra: dict) -> dict:
    """One training CLI run in its own process (:data:`DRILL_CODE`); returns
    its record, with the exit code and the run dir it wrote."""
    root = os.path.join(NYU_DRILL, tag)
    os.makedirs(root, exist_ok=True)
    out = os.path.join(root, "record.json")
    log = os.path.join(root, "output.txt")
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8", **env_extra}
    with open(log, "w") as f:
        proc = subprocess.run([sys.executable, "-c", DRILL_CODE, out, root, *argv], env=env,
                              stdout=f, stderr=subprocess.STDOUT, timeout=400,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
    if not os.path.exists(out):
        fail(f"drill {tag}: exited {proc.returncode} without a record; "
             f"{open(log).read()[-3000:]}")
    rec = json.load(open(out))
    rec["returncode"] = proc.returncode
    runs = sorted(glob.glob(os.path.join(root, "training-*", "version_*")), key=os.path.getmtime)
    rec.setdefault("run_dir", runs[-1] if runs else None)
    rec["log_tail"] = open(log).read()[-1500:]
    return rec


def weights_distance(a: str, b: str) -> dict:
    """Largest |difference| and the relative L2 distance of two runs' last
    model checkpoints."""
    from vision_mtl_tpu_torch.train.checkpoint import load_ckpt_model

    wa, wb = load_ckpt_model(a), load_ckpt_model(b)
    if wa.keys() != wb.keys():
        fail(f"drill: checkpoints of {a} and {b} hold other tensors")
    diff = num = 0.0
    max_abs = 0.0
    for k in wa:
        x, y = wa[k].double(), wb[k].double()
        max_abs = max(max_abs, float((x - y).abs().max()) if x.numel() else 0.0)
        diff += float(((x - y) ** 2).sum())
        num += float((x ** 2).sum())
    return {"max_abs": max_abs, "rel_l2": (diff / max(num, 1e-300)) ** 0.5,
            "bit_identical": max_abs == 0.0}


def preemption_drill(kernels, n_train: int, n_val: int, n_pred: int) -> dict:
    """MTAN at batch 8 on the NYUv2 tree through the CLI, each run in its own
    process with deterministic algorithms set: two uninterrupted 2-epoch
    runs (the second a control for run-to-run spread), a run with
    ``--preempt_save`` and ``VMTL_PREEMPT_AT_STEP`` half way through its
    second epoch, which must exit 143, and ``--resume_dir`` on it to the
    end. The resumed run must start at the preempted position, train the
    second epoch's remaining batches in the uninterrupted run's order, and
    end with its weights: bit for bit, or, where the control shows two
    uninterrupted runs differ, within 10 times their relative L2 distance."""
    shutil.rmtree(NYU_DRILL, ignore_errors=True)
    argv = ["--dataset_name", "nyuv2", "--data_dir", NYU_DATA, "--model_name", "mtan",
            "--batch_size", str(BATCH), "--num_workers", "4", "--lr", str(LR),
            "--num_epochs", "2"]
    at = n_train + n_train // 2
    straight = drill_run("straight", argv, {})
    control = drill_run("control", argv, {})
    preempted = drill_run("preempted", argv + ["--preempt_save"],
                          {"VMTL_PREEMPT_AT_STEP": str(at)})
    if preempted["returncode"] != 143 or preempted["exit"] != 143:
        fail(f"drill: the preempted run exited {preempted['returncode']}, want 143; "
             f"{preempted['log_tail']}")
    meta = json.load(open(os.path.join(preempted["run_dir"], "preempt_meta.json")))
    if (meta["epoch"], meta["batch_in_epoch"]) != (1, n_train // 2):
        fail(f"drill: preempted at {meta}, want epoch 1 batch {n_train // 2}")
    resumed = drill_run("resumed", argv + ["--resume_dir", preempted["run_dir"]], {})
    for rec in (straight, control, resumed):
        if rec["returncode"] != 0:
            fail(f"drill: a run exited {rec['returncode']}; {rec['log_tail']}")
    # launches: each run's own, as its loader lengths give
    forwards = {"straight": 2 * n_val + n_pred, "preempted": n_val,
                "resumed": n_val + n_pred}
    steps = {"straight": 2 * n_train, "preempted": at, "resumed": 2 * n_train - at}
    for tag, rec in (("straight", straight), ("preempted", preempted), ("resumed", resumed)):
        want = expected(kernels, PER_TRAIN_STEP["mtan"], steps[tag],
                        confusion_matrix=forwards[tag])
        want["fused_attention_gate"] += PER_FORWARD["mtan"]["fused_attention_gate"] * forwards[tag]
        if rec["launches"] != want:
            fail(f"drill {tag}: launches {rec['launches']}, want {want}")
    order = straight["orders"]
    if (preempted["orders"] != order or len(resumed["orders"]) != 1
            or resumed["orders"][0]["order"] != order[1]["order"]
            or resumed["orders"][0]["skip"] != n_train // 2):
        fail("drill: the batch orders differ from the uninterrupted run's")
    drill = weights_distance(straight["run_dir"], resumed["run_dir"])
    spread = weights_distance(straight["run_dir"], control["run_dir"])
    ok = drill["bit_identical"] or (
        not spread["bit_identical"] and drill["rel_l2"] <= 10 * spread["rel_l2"])
    if not ok:
        fail(f"drill: resumed weights off the uninterrupted run's by {drill}, two "
             f"uninterrupted runs by {spread}")
    return {
        "argv": argv, "preempt_at_step": at, "exit_code": preempted["returncode"],
        "preempted_position": meta, "resume_order_equal": True,
        "deterministic_algorithms": "torch.use_deterministic_algorithms(True, warn_only=True), "
                                    "cudnn.deterministic",
        "resumed_vs_uninterrupted": drill, "control_two_uninterrupted": spread,
        "preempt_save_s": preempted["save_s"], "preempt_restore_s": resumed["restore_s"],
        "wall_s": {t: r["wall_s"] for t, r in (("straight", straight), ("control", control),
                                               ("preempted", preempted), ("resumed", resumed))},
        "launches": {t: r["launches"] for t, r in (("straight", straight), ("control", control),
                                                   ("preempted", preempted),
                                                   ("resumed", resumed))},
        "run_dir": resumed["run_dir"],
    }


def harness_check(dataset: str, runs: dict, data_dir: str, n_holdout: int, batch: int, kernels,
                  dev, kinds: dict = None, registry: str = None) -> dict:
    """``python -m vision_mtl_tpu_torch.eval_harness --runs`` (in process) on
    run dirs the phases wrote (``runs``, tag to run dir; a tag names its
    model's launches per forward, or ``kinds`` does), or with ``registry``
    ``--from_registry`` on that registry, which must hold ``runs``: its
    table must equal the table of each run's own predict metrics
    (metrics.jsonl), rounded as the table rounds, up to one unit of the
    third decimal where the two sums round to either side (the harness
    rebuilds the model from its checkpoint, in another process than the
    drill's runs); the launches are the predict sweeps'."""
    from vision_mtl_tpu_torch import eval_harness

    out_csv = os.path.join(os.path.dirname(NYU_DATA), f"harness_{dataset}.csv")
    selection = (["--from_registry", "--registry", registry] if registry else
                 ["--runs", *(f"{m}={d}" for m, d in runs.items())])
    mark = kernels.launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        eval_harness.main(["--dataset_name", dataset, "--data_dir", data_dir, "--batch_size",
                           str(batch), "--out", out_csv, "--device", str(dev), *selection])
    wall_s = time.perf_counter() - t0
    counts = counts_since(kernels, mark)
    loop_metrics = {}
    for model, run_dir in runs.items():
        records = [json.loads(ln) for ln in open(os.path.join(run_dir, "metrics.jsonl"))]
        loop_metrics[model] = {k.replace("predict/", ""): v for r in records
                               for k, v in r.items() if k.startswith("predict/")}
    want = eval_harness.build_table(loop_metrics)
    with open(out_csv) as f:
        rows = list(csv.reader(f))
    got = {r[0]: {tag: float(v) for tag, v in zip(rows[0][1:], r[1:])} for r in rows[1:]}
    cells = [(got[m][tag], want[m][tag]) for m in want for tag in want[m]]
    if got.keys() != want.keys() or any(abs(g - w) > 1.0001e-3 for g, w in cells):
        fail(f"eval_harness {dataset}: table {got}, the loops' predict metrics {want}")
    n_pred = -(-n_holdout // batch)
    want_counts = expected(kernels, {}, 0, confusion_matrix=n_pred * len(runs))
    for tag in runs:
        for k, v in PER_FORWARD[(kinds or {}).get(tag, tag)].items():
            want_counts[k] += v * n_pred
    if counts != want_counts:
        fail(f"eval_harness {dataset}: launches {counts}, want {want_counts}")
    return {"table": got, "cells_equal": sum(g == w for g, w in cells), "cells": len(cells),
            "wall_s": wall_s, "launches": counts, "printed": printed.getvalue().splitlines()[-6:]}


def warm_up_shapes(name: str, build_model, cfg, batch: int, dev) -> float:
    """One bf16 train step and one eval step of a fresh model at the
    phase's shapes, before its timed runs: the first call at each new
    shape pays its one-time setup (cuDNN's, module loading), which would
    otherwise land in the first timed run alone. Returns its seconds."""
    from vision_mtl_tpu_torch.metrics import init_metrics
    from vision_mtl_tpu_torch.train.state import create_train_state
    from vision_mtl_tpu_torch.train.step import make_eval_step, make_train_step

    (b,) = train_batches(cfg, 1, batch, seed=13)
    b = {k: v.to(dev) for k, v in b.items()}
    t0 = time.perf_counter()
    state = create_train_state(build_model(name, cfg, dtype=torch.bfloat16, device=dev, seed=0),
                               LR, device=dev)
    make_train_step(device=dev)(state, b, init_metrics(cfg.num_classes, dev))
    make_eval_step(device=dev)(state, b, init_metrics(cfg.num_classes, dev))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def nyuv2_phase(kernels, dev, build_model, cityscapes_runs: dict) -> tuple:
    """NYUv2 end to end at 256x256, 14 classes: the tree, the decoder held to
    the written arrays, the loader alone raw and cached, the training CLI
    with basic at batch 4 (the reference's NYUv2 run) raw, then cached, the
    MTAN preemption drill, the harness on the phase's and on the ``cli``
    phase's run dirs (``cityscapes_runs``, model name to run dir), and a
    timed MTAN ``Predictor(8)``. Returns the ``nyuv2`` line, the launch
    counts of its runs (the drill's processes' included) and the confusion
    matrix's inputs from basic's last predict step."""
    from vision_mtl_tpu_torch.cfg import fetch_data_cfg
    from vision_mtl_tpu_torch.data import nyu_cache
    from vision_mtl_tpu_torch.data.datamodule import MTLDataModule
    from vision_mtl_tpu_torch.data.nyuv2 import NYUv2

    cfg = fetch_data_cfg("nyuv2")
    cfg.data_dir = NYU_DATA
    tree = write_nyuv2_tree(NYU_DATA)
    decode = check_png_decode(tree)
    tree.pop("first")
    loader_raw = time_nyu_loader(4, 4)
    hw_cfg = types.SimpleNamespace(height=256, width=256, num_classes=cfg.num_classes)
    warm_s = warm_up_shapes("basic", build_model, hw_cfg, 4, dev)
    common = ["--dataset_name", "nyuv2", "--data_dir", NYU_DATA, "--num_workers", "4",
              "--lr", str(LR), "--save_epoch_freq", "1", "--num_epochs", "1"]
    basic_argv = common + ["--model_name", "basic", "--batch_size", "4"]
    raw = run_cli("basic", basic_argv, cfg, kernels)
    t0 = time.perf_counter()
    for stage in ("train", "test"):
        nyu_cache.build_cache(NYUv2(stage=stage))
    cache_s = time.perf_counter() - t0
    loader_cached = time_nyu_loader(4, 4)
    with capture_confmat_inputs() as confmat_inputs:
        cached = run_cli("basic", basic_argv, cfg, kernels)
    if cached["rec"]["sweeps"][0]["rows"] != raw["rec"]["sweeps"][0]["rows"]:
        fail("nyuv2: the cached run trained on other rows than the raw one")
    idle = profile_epoch(cached, cfg, dev)
    del raw["rec"], cached["rec"]
    lengths = cached["loader_lengths"]

    mdm = MTLDataModule("nyuv2", batch_size=BATCH, train_transform=cfg.train_transform,
                        test_transform=cfg.test_transform)
    mdm.setup()
    drill = preemption_drill(kernels, len(mdm.train_dataloader()), len(mdm.val_dataloader()),
                             len(mdm.predict_dataloader()))
    harness = {
        "nyuv2": harness_check("nyuv2", {"basic": cached["run_dir"], "mtan": drill["run_dir"]},
                               NYU_DATA, NYU_SAMPLES["test"], 4, kernels, dev),
        "cityscapes": harness_check("cityscapes", cityscapes_runs, CLI_DATA, CLI_SAMPLES["val"],
                                    BATCH, kernels, dev),
    }
    model = build_model("mtan", cfg, dtype=torch.bfloat16, device=dev, seed=0)
    predictor = time_predictor("mtan", model, hw_cfg, dev, kernels)
    del model
    line = {
        "config": "nyuv2 480x640 PNGs resized to 256x256, 14 classes, bf16",
        "tree": tree, "png_decode": decode,
        "loader_train_epoch": {"raw": loader_raw, "cached": loader_cached,
                               "cache_build_s": cache_s},
        "cli_basic_batch4": {"raw": raw["line"], "cached": cached["line"],
                             "first_calls_at_these_shapes_s": warm_s,
                             "loader_lengths": lengths,
                             "profile_one_epoch_cached": idle},
        "preemption_drill_mtan_batch8": {k: v for k, v in drill.items() if k != "launches"},
        "eval_harness": harness,
        "mtan_predictor_8": predictor,
    }
    launches = [raw["launches"], cached["launches"], predictor["launches"],
                *(h["launches"] for h in harness.values()), *drill["launches"].values()]
    return line, launches, confmat_inputs[-1]


# the interop phase's reference run dirs (one per model, beside the port's
# own run dir of the same state) and exported programs
INTEROP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
                           "reference")
# train_args.yaml as PyYAML's yaml.dump(..., default_flow_style=False) lays
# out the reference's args: sorted keys, plain scalars, block lists
REFERENCE_ARGS = """args:
  batch_size: 8
  channel_wise_stitching: {cw}
  ckpt_dir: null
  dataset_name: cityscapes
  exp_tags:
  - reference
  - interop
  loss_depth_weight: 1.0
  loss_segm_weight: 1.0
  lr: 0.001
  model_name: {name}
  num_epochs: 2
  precision: bf16
  run_name: reference-{name}
  seed: 11
"""
EXPORT_CODE = r"""
import json, sys, time
import numpy as np
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from vision_mtl_tpu_torch import kernels
from vision_mtl_tpu_torch.serving import latency_bench, load_exported

jobs, out_path = json.loads(sys.argv[1]), sys.argv[2]
rec = {}
fns = {}
for name, job in jobs.items():
    imgs = np.load(job["imgs"])
    t0 = time.perf_counter()
    fns[name] = load_exported(job["program"])
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fns[name](imgs)
    first_call_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    out = fns[name](imgs)
    np.savez(job["out"], **out)
    rec[name] = {"load_s": load_s, "first_call_s": first_call_s,
                 "launches_per_call": kernels.launch_counts()}
rec["model_code_imported_to_load"] = sorted(
    m for m in sys.modules if m.startswith("vision_mtl_tpu_torch.models"))
# the exported call's latency beside Predictor(8)'s on the reference run
# dir's import, in this process, alternated
from vision_mtl_tpu_torch.pipeline import load_run_model
from vision_mtl_tpu_torch.serving import Predictor
for name, job in jobs.items():
    imgs = np.load(job["imgs"])
    model = load_run_model(job["run_dir"], job["device"])[0]
    pred = Predictor(model, imgs.shape[0], imgs.shape[1], imgs.shape[2], dtype=np.uint8,
                     device=job["device"])
    p50 = {"exported": [], "predictor": []}
    for kind in ("exported", "predictor", "predictor", "exported"):
        fn = fns[name] if kind == "exported" else pred
        p50[kind].append(latency_bench(fn, imgs, n=20, warmup=3)["p50_ms"])
    rec[name]["p50_ms"] = p50
    del model, pred
with open(out_path, "w") as f:
    json.dump(rec, f)
"""


@contextlib.contextmanager
def first_train_step():
    """Records the train state just before and just after the first train
    step of a ``run_pipe`` run (CPU copies of the weights, the BatchNorm
    statistics, Adam's state by parameter index, the lr and the step), and
    passes every call on."""
    from vision_mtl_tpu_torch.train import loop

    real = loop.make_train_step
    snap: dict = {}

    def copy(state) -> dict:
        out = {f"model.{k}": v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
        for i, entry in state.optimizer.state_dict()["state"].items():
            for k, v in entry.items():
                out[f"adam.{i}.{k}"] = v.detach().cpu().clone()
        return {"tensors": out, "lr": state.optimizer.param_groups[0]["lr"], "step": state.step}

    def make(*a, **k):
        step = real(*a, **k)

        def first(state, batch, mstate):
            if "before" not in snap:
                snap["before"] = copy(state)
            out = step(state, batch, mstate)
            if "after" not in snap:
                torch.cuda.synchronize()
                snap["after"] = copy(out[0])
            return out

        return first

    loop.make_train_step = make
    try:
        yield snap
    finally:
        loop.make_train_step = real


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms where it has them, as in the
    preemption drill, for the span of a comparison."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev[2], prev[3]


def snapshot_diff(a: dict, b: dict) -> list:
    """Names of the tensors, and of lr and step, that differ between two
    :func:`first_train_step` records."""
    diff = [k for k in ("lr", "step") if a[k] != b[k]]
    if a["tensors"].keys() != b["tensors"].keys():
        return diff + ["tensor names"]
    return diff + [k for k, v in a["tensors"].items() if not torch.equal(v, b["tensors"][k])]


def weight_only_nodes(program) -> dict:
    """An exported program's call nodes, and those that read only the
    weights (the gates' BatchNorm folding), which run on every call."""
    sig = program.graph_signature
    weights = set(sig.inputs_to_parameters) | set(sig.inputs_to_buffers)
    weight_only, calls = set(), 0
    for node in program.graph.nodes:
        if node.op == "placeholder" and node.name in weights:
            weight_only.add(node)
        elif node.op == "call_function":
            calls += 1
            inputs = node.all_input_nodes
            if inputs and all(n in weight_only for n in inputs):
                weight_only.add(node)
    n_weight_only = sum(1 for n in weight_only if n.op == "call_function")
    ops = [str(n.target) for n in program.graph.nodes if str(n.target).startswith("vmtl.")]
    return {"call_nodes": calls, "weight_only_call_nodes": n_weight_only, "vmtl_nodes": ops}


def gate_dispatch_cost(dev, fused_gate, n_calls: int = 200, rounds: int = 4) -> dict:
    """Host time per call of the eval gate (B1) through its operator
    (``torch.ops.vmtl.fused_attention_gate``) and through the direct
    ctypes launch it wraps, at MTAN's enc3 shape in bf16. The operator is
    timed under ``torch.inference_mode``, as ``Predictor``, the eval steps
    and exported programs call it, and with autograd on, where its autograd
    layer (a backward that raises) runs too. Each round times ``n_calls``
    calls without a synchronise (the enqueue), the kinds in turn, their
    order reversed every other round."""
    _, cin, c2, h, w = GATE_SHAPES[3]
    g = torch.Generator(device=dev).manual_seed(5)
    args = (torch.randn(BATCH, h, w, cin, generator=g, device=dev).bfloat16(),
            torch.randn(BATCH, h, w, c2, generator=g, device=dev).bfloat16(),
            torch.randn(cin, HIDDEN, generator=g, device=dev) * 0.1,
            torch.randn(HIDDEN, generator=g, device=dev),
            torch.randn(HIDDEN, c2, generator=g, device=dev) * 0.1,
            torch.randn(c2, generator=g, device=dev))

    def operator():
        return fused_gate.fused_attention_gate(*args)

    # kind: (call, whether it runs under inference mode)
    fns = {"operator": (operator, True), "operator_autograd_on": (operator, False),
           "direct": (lambda: fused_gate._launch(*args), False)}
    want = fused_gate._launch(*args)
    with torch.inference_mode():
        same = torch.equal(operator(), want)
    if not (same and torch.equal(operator(), want)):
        fail("fused_attention_gate: the operator and the direct launch differ")
    us = {k: [] for k in fns}
    for r in range(rounds):
        for kind in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            fn, inference = fns[kind]
            torch.cuda.synchronize()
            with torch.inference_mode(inference):
                t0 = time.perf_counter()
                for _ in range(n_calls):
                    fn()
                us[kind].append((time.perf_counter() - t0) / n_calls * 1e6)
            torch.cuda.synchronize()
    med = {k: float(np.median(v)) for k, v in us.items()}
    return {"shape": {"level": GATE_SHAPES[3][0], "B": BATCH, "H": h, "W": w, "Cin": cin,
                      "C2": c2, "dtype": "bf16"},
            "host_us_per_call": us, "median_us": med,
            "operator_minus_direct_us": med["operator"] - med["direct"],
            "autograd_on_minus_direct_us": med["operator_autograd_on"] - med["direct"]}


def interop_phase(cfg, kernels, dev, build_model, fused_gate) -> tuple:
    """Reference-checkpoint interop and exported programs at full width
    (Cityscapes 128x256, batch 8), for MTAN, basic and CSNet: a reference
    run dir under ``build/chip_smoke/reference/<model>/`` (``model_1.pt``
    from ``save_reference_checkpoint``, ``session_1.pt`` from the port's
    Adam after 2 train steps re-keyed into the reference's parameter order,
    a ``train_args.yaml`` in PyYAML's layout) beside the port's own run dir
    of the same state; the import through ``load_run_model`` (``serve
    --run_dir``'s path) equal to the source bit for bit, with equal
    ``Predictor(8)`` answers and ``PER_FORWARD`` launches; for MTAN and
    basic ``training --resume_dir`` on both dirs, deterministic, each
    starting at epoch 2 with the same state and the same first step; the
    harness on MTAN's reference dir equal to the import's own predict
    metrics; ``export_model`` of each import, loaded and timed in a fresh
    process beside ``Predictor(8)``, its answers held to ``Predictor(8)``
    under the ``serve --run_dir`` rule; the B1 operator's dispatch cost.
    Returns the ``interop`` line and the launch counts of its runs."""
    from vision_mtl_tpu_torch import eval_harness
    from vision_mtl_tpu_torch.data.datamodule import MTLDataModule
    from vision_mtl_tpu_torch.metrics import init_metrics
    from vision_mtl_tpu_torch.pipeline import load_run_model
    from vision_mtl_tpu_torch.predict import predict
    from vision_mtl_tpu_torch.serving import Predictor, export_model
    from vision_mtl_tpu_torch.train import checkpoint
    from vision_mtl_tpu_torch.train.plateau import ReduceLROnPlateau
    from vision_mtl_tpu_torch.train.state import create_train_state
    from vision_mtl_tpu_torch.train.step import make_train_step
    from vision_mtl_tpu_torch.utils.ckpt_import import (
        export_reference_session,
        save_reference_checkpoint,
    )

    shutil.rmtree(INTEROP_DIR, ignore_errors=True)
    t_phase = time.perf_counter()
    imgs = np.random.default_rng(23).integers(0, 256, size=(BATCH, cfg.height, cfg.width, 3),
                                              dtype=np.uint8)
    os.makedirs(INTEROP_DIR)
    np.save(os.path.join(INTEROP_DIR, "imgs.npy"), imgs)
    lines, launches, jobs, answers = {}, [], {}, {}
    common = ["--dataset_name", "cityscapes", "--data_dir", CLI_DATA, "--batch_size", str(BATCH),
              "--num_workers", "4", "--lr", str(LR), "--save_epoch_freq", "1",
              "--device", str(dev)]
    for name in ("mtan", "basic", "csnet"):
        ref_dir = os.path.join(INTEROP_DIR, name)
        port_dir = os.path.join(INTEROP_DIR, f"{name}_port")
        os.makedirs(ref_dir)
        channel_wise = name == "csnet"  # the registry's CSNet stitches channel-wise
        state = create_train_state(
            build_model(name, cfg, dtype=torch.bfloat16, device=dev, seed=0,
                        channel_wise_stitching=channel_wise), LR, device=dev)
        step = make_train_step(device=dev)
        for b in train_batches(cfg, 2, BATCH, seed=21):
            state, _, _ = step(state, {k: v.to(dev) for k, v in b.items()},
                               init_metrics(cfg.num_classes, dev))
        sched = ReduceLROnPlateau(patience=2, factor=0.9)
        sched.step(3.0, LR)  # a first validation loss: best 3.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_reference_checkpoint(os.path.join(ref_dir, "model_1.pt"), name, state.model)
        torch.save(export_reference_session(name, state, sched, 1),
                   os.path.join(ref_dir, "session_1.pt"))
        with open(os.path.join(ref_dir, "train_args.yaml"), "w") as f:
            f.write(REFERENCE_ARGS.format(name=name, cw=str(channel_wise).lower()))
        save_s = time.perf_counter() - t0
        checkpoint.save_ckpt(state, sched, 1, port_dir)
        checkpoint.log_args({"model_name": name, "dataset_name": "cityscapes",
                             "channel_wise_stitching": channel_wise},
                            os.path.join(port_dir, "train_args.yaml"))

        # import through serve --run_dir's path: the source's tensors bit for bit
        t0 = time.perf_counter()
        imported, _, run_args = load_run_model(ref_dir, dev)
        import_s = time.perf_counter() - t0
        source = state.model.eval()
        src_sd, imp_sd = source.state_dict(), imported.state_dict()
        differ = [k for k, v in src_sd.items() if not torch.equal(imp_sd[k], v)]
        if differ or src_sd.keys() != imp_sd.keys() or run_args.exp_tags != ["reference",
                                                                               "interop"]:
            fail(f"{name} interop: imported tensors differ from the source at {differ[:5]} "
                 f"(args {vars(run_args)})")
        want = Predictor(source, BATCH, cfg.height, cfg.width, dtype=np.uint8, device=dev)(imgs)
        pred = Predictor(imported, BATCH, cfg.height, cfg.width, dtype=np.uint8, device=dev)
        kernels.reset_launch_counts()
        got = pred(imgs)
        counts = kernels.launch_counts()
        if counts != expected(kernels, PER_FORWARD[name], 1):
            fail(f"{name} interop: Predictor(8) of the import launched {counts}")
        for k in want:
            if not np.array_equal(got[k], want[k]):
                fail(f"{name} interop: Predictor(8) {k} of the import differs from the source's")
        launches.append(counts)
        answers[name] = got
        line = {"reference_dir": ref_dir, "save_reference_s": save_s, "import_s": import_s,
                "imported_equal_bit_for_bit": True, "predictor_8_equal": True,
                "launches_per_forward": counts}

        if name in ("mtan", "basic"):
            # --resume_dir on the reference dir and on the port's own dir
            resumed = {}
            with deterministic():
                for kind, d in (("reference", ref_dir), ("port", port_dir)):
                    with first_train_step() as snap:
                        run = run_cli(name, common + ["--model_name", name, "--num_epochs", "3",
                                                      "--resume_dir", d], cfg, kernels)
                    if run["rec"]["start_epoch"] != 2:
                        fail(f"{name} interop: --resume_dir {kind} started at epoch "
                             f"{run['rec']['start_epoch']}, want 2")
                    resumed[kind] = (run, snap)
                    launches.append(run["launches"])
            before = snapshot_diff(resumed["reference"][1]["before"], resumed["port"][1]["before"])
            after = snapshot_diff(resumed["reference"][1]["after"], resumed["port"][1]["after"])
            if before or after:
                fail(f"{name} interop: resumed from the reference dir vs the port's own: state "
                     f"before the first step differs at {before[:5]}, after it at {after[:5]}")
            line["resume"] = {
                "start_epoch": 2, "state_before_first_step_equal": True,
                "first_step_equal_bit_for_bit": True,
                "runs": {k: v[0]["line"] for k, v in resumed.items()},
            }
            del resumed
        if name == "mtan":
            # the harness on the reference dir against the import's own predict
            dm = MTLDataModule("cityscapes", batch_size=BATCH, train_transform=cfg.train_transform,
                               test_transform=cfg.test_transform)
            saved_dir, cfg.data_dir = cfg.data_dir, CLI_DATA
            try:
                dm.setup(stage="predict")
                _, metrics = predict(dm.predict_dataloader(), imported, num_classes=cfg.num_classes,
                                     device=dev)
            finally:
                cfg.data_dir = saved_dir
            out_csv = os.path.join(INTEROP_DIR, "harness_mtan.csv")
            kernels.reset_launch_counts()
            with contextlib.redirect_stdout(io.StringIO()):
                eval_harness.main(["--dataset_name", "cityscapes", "--data_dir", CLI_DATA,
                                   "--batch_size", str(BATCH), "--out", out_csv, "--device",
                                   str(dev), "--runs", f"mtan={ref_dir}"])
            launches.append(kernels.launch_counts())
            want_t = eval_harness.build_table({"mtan": {k.replace("predict/", ""): v
                                                        for k, v in metrics.items()}})
            with open(out_csv) as f:
                rows = list(csv.reader(f))
            got_t = {r[0]: {tag: float(v) for tag, v in zip(rows[0][1:], r[1:])} for r in rows[1:]}
            cells = [(got_t[m][tag], want_t[m][tag]) for m in want_t for tag in want_t[m]]
            # as harness_check: within one unit of the third decimal, where
            # two sums round to either side
            if got_t.keys() != want_t.keys() or any(abs(g - w) > 1.0001e-3 for g, w in cells):
                fail(f"interop: eval_harness on the reference dir {got_t}, the import's "
                     f"predict {want_t}")
            line["eval_harness"] = {"table": got_t, "cells": len(cells),
                                    "cells_equal": sum(g == w for g, w in cells)}

        # the import exported: its program and what it keeps
        path = os.path.join(INTEROP_DIR, f"{name}.pt2")
        t0 = time.perf_counter()
        program = export_model(imported, BATCH, cfg.height, cfg.width, path, dtype=np.uint8,
                               device=dev)
        line["export_s"] = time.perf_counter() - t0
        line["program_bytes"] = os.path.getsize(path)
        line["graph"] = nodes = weight_only_nodes(program)
        op = "vmtl.fused_attention_gate.default" if name == "mtan" else "vmtl.conv3x3_small.default"
        if nodes["vmtl_nodes"] != [op] * sum(PER_FORWARD[name].values()):
            fail(f"{name} export: the graph holds {nodes['vmtl_nodes']}")
        jobs[name] = {"program": path, "imgs": os.path.join(INTEROP_DIR, "imgs.npy"),
                      "out": os.path.join(INTEROP_DIR, f"{name}_out.npz"), "run_dir": ref_dir,
                      "device": str(dev)}
        lines[name] = line
        del state, source, imported, pred, step, program
        torch.cuda.empty_cache()

    # load and run every program in a fresh process that imports no model code
    rec_path = os.path.join(INTEROP_DIR, "export_record.json")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EXPORT_CODE, json.dumps(jobs), rec_path],
                          capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    sub_s = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(rec_path):
        fail(f"interop: loading the exported programs exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    rec = json.load(open(rec_path))
    if rec["model_code_imported_to_load"]:
        fail(f"interop: loading imported {rec['model_code_imported_to_load']}")
    for name, job in jobs.items():
        got = np.load(job["out"])
        want = answers[name]
        if got["segm"].dtype != want["segm"].dtype or got["depth"].dtype != want["depth"].dtype:
            fail(f"{name} exported: dtypes {got['segm'].dtype}, {got['depth'].dtype}")
        ids_differ = np.argwhere(got["segm"] != want["segm"])
        depth_err = np.abs(got["depth"] - want["depth"])
        depth_bad = np.argwhere(~(depth_err <= np.abs(want["depth"]) * 2**-7 + 1e-6))
        if len(ids_differ) or len(depth_bad):
            fail(f"{name} exported vs Predictor(8): {len(ids_differ)} ids differ (first at "
                 f"{ids_differ[:5].tolist()}), {len(depth_bad)} depths beyond one bf16 step "
                 f"(first at {depth_bad[:5].tolist()}, max |diff| {float(depth_err.max())})")
        counts = rec[name]["launches_per_call"]
        if counts != expected(kernels, PER_FORWARD[name], 1):
            fail(f"{name} exported: a call launched {counts}")
        launches.append(counts)
        lines[name]["exported"] = {
            **{k: rec[name][k] for k in ("load_s", "first_call_s", "p50_ms")},
            "launches_per_call": counts, "ids_equal": True,
            "depth_max_abs_err_vs_predictor": float(depth_err.max()),
            "depth_equal_bit_for_bit": bool(np.array_equal(got["depth"], want["depth"])),
        }
    line = {"config": "cityscapes 128x256, 19 classes, bf16, batch 8, uint8 wire", **lines,
            "export_subprocess_s": sub_s, "gate_dispatch": gate_dispatch_cost(dev, fused_gate),
            "phase_s": time.perf_counter() - t_phase}
    return line, launches


# ---------------------------------------------------------------- options
# the model options of the options phase, by model: (the remat flags one at
# a time, then together)
REMAT_CONFIGS = {
    "mtan": [{"remat_attention": True}, {"remat_shared": True},
             {"remat_attention": True, "remat_shared": True}],
    "basic": [{"remat_tail": 2}, {"remat_encoder": True},
              {"remat_tail": 2, "remat_encoder": True}],
    "csnet": [{"remat_encoder": True}, {"remat_tail": 2},
              {"remat_encoder": True, "remat_tail": 2}],
}
# launches of one bf16 train step with every remat flag of a model on: the
# recompute relaunches the train gate (MTAN's attention modules) and B3 in
# the rematerialised decoder blocks (basic: block_3's second conv and both
# of block_4's; CSNet: both convs of blocks 3 and 4, per task); no kernel
# sits in the encoder's blocks or the shared DoubleConvs
PER_REMAT_STEP = {
    "mtan": {"fused_attention_gate_train": 32, BACKWARD: 16, "confusion_matrix": 1},
    "basic": {"conv3x3_small": 11, "confusion_matrix": 1},
    "csnet": {"conv3x3_small": 32, "confusion_matrix": 1},
}
OPTION_STEPS = 3  # timed bf16 train steps per configuration, after one untimed


def task_gate_args(gen, dev, n_tasks: int, cin: int, c2: int, h: int, w: int, dtype, train):
    """Seeded arguments of a task-axis gate call at one MTAN level: x and
    the weights with a leading task axis, one shared map."""
    def uniform(*shape, bound=1.0):
        return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * bound

    x = torch.randn(n_tasks, BATCH, h, w, cin, generator=gen, device=dev).to(dtype)
    shared = torch.randn(BATCH, h, w, c2, generator=gen, device=dev).to(dtype)
    if not train:
        return (x, shared, uniform(n_tasks, cin, HIDDEN, bound=cin**-0.5),
                torch.randn(n_tasks, HIDDEN, generator=gen, device=dev) * 0.1,
                uniform(n_tasks, HIDDEN, c2, bound=HIDDEN**-0.5),
                torch.randn(n_tasks, c2, generator=gen, device=dev) * 0.1)
    return (x, shared, uniform(n_tasks, cin, HIDDEN, bound=cin**-0.5),
            uniform(n_tasks, HIDDEN, bound=cin**-0.5), uniform(n_tasks, HIDDEN) * 0.5 + 1.0,
            uniform(n_tasks, HIDDEN, bound=0.3), uniform(n_tasks, HIDDEN, c2, bound=HIDDEN**-0.5),
            uniform(n_tasks, c2, bound=HIDDEN**-0.5), uniform(n_tasks, c2) * 0.5 + 1.0,
            uniform(n_tasks, c2, bound=0.3))


def check_task_gates(dev, fused_gate, fused_gate_train, n_tasks: int = 2) -> tuple:
    """B1 and B4 with the task axis at T = 2, at MTAN's 8 gate shapes in both
    dtypes: against their plain versions (B1's and B4's tolerances), each
    task bit for bit against its own T = 1 call, and, in bf16 (the main
    path's dtype), the device time of the task-axis call beside the two T = 1
    calls' and the plain version's. The totals are per MTAN forward (B1) and
    train step (B4) with fold_tasks: the 8 levels' bf16 calls."""
    gen = torch.Generator(device=dev).manual_seed(20)
    rows = []
    totals = {name: {"ms": 0.0, "per_task_calls_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "err": 0.0, "by_flops": 0.0, "by_bytes": 0.0}
              for name in ("fused_attention_gate_tasks", "fused_attention_gate_train_tasks")}
    for level, cin, c2, h, w in GATE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            n = BATCH * h * w
            es = 2 if dtype == torch.bfloat16 else 4
            for name, train in (("fused_attention_gate_tasks", False),
                                ("fused_attention_gate_train_tasks", True)):
                args = task_gate_args(gen, dev, n_tasks, cin, c2, h, w, dtype, train)
                if train:
                    call = fused_gate_train.fused_attention_gate_train_tasks
                    plain_fn = fused_gate_train.fused_attention_gate_train_tasks_plain
                    one = fused_gate_train.fused_attention_gate_train
                    pattern = "gate_train_kernel<"
                else:
                    call = fused_gate.fused_attention_gate_tasks
                    plain_fn = fused_gate.fused_attention_gate_tasks_plain
                    one = fused_gate.fused_attention_gate
                    pattern = "gate_kernel<"

                def per_task_calls():
                    return [one(args[0][t], args[1], *(a[t] for a in args[2:]))
                            for t in range(n_tasks)]

                with torch.no_grad():
                    got = call(*args)
                    want = plain_fn(*args)
                    alone = per_task_calls()
                torch.cuda.synchronize()
                outs = got if train else (got,)
                refs = want if train else (want,)
                err, ok = output_ok(outs[0], refs[0])
                if not ok:
                    fail(f"{name} {level} {dtype}: output max |diff| {err}")
                for s, r in zip(outs[1:], refs[1:]):  # B4's statistics, f64 in the plain
                    if not bool(((s - r).abs() <= 1e-5 * r.abs() + 1e-6).all()):
                        fail(f"{name} {level} {dtype}: statistics off the plain version")
                for t in range(n_tasks):
                    mine = [o[t] for o in outs]
                    theirs = alone[t] if train else (alone[t],)
                    if not all(torch.equal(a, b) for a, b in zip(mine, theirs)):
                        fail(f"{name} {level} {dtype}: task {t} differs from its T = 1 call")
                row = {"kernel": name, "level": level, "dtype": str(dtype).replace("torch.", ""),
                       "T": n_tasks, "N": n, "Cin": cin, "C2": c2, "max_abs_err": err,
                       "bit_equal_to_per_task_calls": True}
                if dtype == torch.bfloat16:
                    with torch.no_grad():
                        row["ms"] = device_ms(lambda: call(*args), n=5, launches=(pattern,))
                        row["per_task_calls_ms"] = device_ms(per_task_calls, n=5)
                        row["plain_ms"] = device_ms(lambda: plain_fn(*args), n=3)
                    # each task's bytes and products, as the one-task gate's bound
                    nbytes = n_tasks * (es * n * (cin + c2) + 4 * (cin * HIDDEN + HIDDEN
                                        + HIDDEN * c2 + c2)) + es * n * c2
                    if train:
                        nbytes += n_tasks * 4 * (2 * HIDDEN + 2 * c2 + 2 * (HIDDEN + c2))
                    flops = n_tasks * tf32_flops(n, cin, c2, True)
                    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, TF32_TC_FLOPS_PER_S)
                    tot = totals[name]
                    for k in ("ms", "per_task_calls_ms", "plain_ms", "bound_ms"):
                        tot[k] += row[k]
                    tot["by_flops"] += flops / TF32_TC_FLOPS_PER_S
                    tot["by_bytes"] += nbytes / HBM_BYTES_PER_S
                totals[name]["err"] = max(totals[name]["err"], err)
                rows.append(row)
    for tot in totals.values():
        tot["bound_by"] = "operations" if tot.pop("by_flops") >= tot.pop("by_bytes") else "bytes"
    return rows, totals


def step_times(state, step, batches, dev, n_steps: int) -> tuple:
    """``n_steps`` train steps of ``state`` (the first untimed): the losses
    and the last ``n_steps - 1`` step times from CUDA events."""
    from vision_mtl_tpu_torch.metrics import init_metrics

    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_steps + 1)]
    losses = []
    events[0].record()
    for i in range(n_steps):
        _, _, step_losses = step(state, batches[i % len(batches)], init_metrics(19, dev))
        events[i + 1].record()
        losses.append(step_losses["loss"])
    torch.cuda.synchronize()
    return ([float(v) for v in losses],
            [events[i].elapsed_time(events[i + 1]) for i in range(1, n_steps)])


def options_train_steps(model, batches, dev, n_steps: int) -> dict:
    """``n_steps`` train steps of ``model`` (the first untimed) with the
    launch counters set to 0 before them: step times from CUDA events, the
    peak memory above what was live before the first step, the losses and
    the launches; the train state and the step function."""
    from vision_mtl_tpu_torch import kernels
    from vision_mtl_tpu_torch.train.state import create_train_state
    from vision_mtl_tpu_torch.train.step import make_train_step

    state = create_train_state(model, LR, device=dev)
    step = make_train_step(device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, step_ms = step_times(state, step, batches, dev, n_steps)
    return {"losses": losses, "launches": kernels.launch_counts(),
            "step_ms_p50": float(np.median(step_ms)) if step_ms else None,
            "peak_memory_above_start_bytes": torch.cuda.max_memory_allocated() - base,
            "state": state, "step": step}


def one_step_snapshot(model, batch, dev) -> dict:
    """One train step of ``model`` on ``batch``: the loss, every gradient
    and every buffer after it (on the card), and its launches."""
    out = options_train_steps(model, [batch], dev, 1)
    out["grads"] = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    out["buffers"] = {k: b.detach().clone() for k, b in model.named_buffers()}
    return out


def grouped_conv_bn_relu(conv, bn, x: torch.Tensor) -> torch.Tensor:
    """The other way to run a task-folded level's 3x3 convs and BNs, timed
    beside the model's per-task one (``mtan.task_conv_bn_relu``): one
    grouped conv and one BN over the tasks' channels laid out task by
    task."""
    from vision_mtl_tpu_torch.models.blocks import batch_norm_nhwc, conv_nhwc

    n_tasks, b, h, w, c = x.shape
    y = conv_nhwc(x.permute(1, 2, 3, 0, 4).reshape(b, h, w, n_tasks * c),
                  conv.weight.flatten(0, 1), conv.bias.flatten(), conv.dtype, groups=n_tasks)
    y = torch.relu(batch_norm_nhwc(y, bn.weight.flatten(), bn.bias.flatten(),
                                   bn.running_mean.view(-1), bn.running_var.view(-1), bn.eps,
                                   bn.training))
    return y.reshape(b, h, w, n_tasks, -1).permute(3, 0, 1, 2, 4)


@contextlib.contextmanager
def conv_way(way: str):
    """The folded MTAN's per-task 3x3 convs and BNs run ``way``: "grouped"
    (:func:`grouped_conv_bn_relu`), else the model's own, per task."""
    from vision_mtl_tpu_torch.models import mtan

    per_task = mtan.task_conv_bn_relu
    if way == "grouped":
        mtan.task_conv_bn_relu = grouped_conv_bn_relu
    try:
        yield
    finally:
        mtan.task_conv_bn_relu = per_task


FOLD_WAYS = ("unfolded", "per_task", "grouped")
FOLD_ROUNDS = 2  # interleaved rounds of the p50s, each way in turn


def check_fold_tasks(cfg, kernels, dev, build_model) -> tuple:
    """MTAN with fold_tasks at Cityscapes 128x256, batch 8, bf16: weights
    from the seeded unfolded MTAN through ``fold_task_state_dict``.
    ``Predictor(8)`` ids and depth against the unfolded model's (bit for bit
    if they are, else within the serving rule: 99% of ids, depth within
    0.05). The unfolded model, the folded one (its per-task 3x3 convs and
    BNs per task, the model's way) and the folded one with them grouped
    (:func:`grouped_conv_bn_relu`), each: its launches, the device time of
    a forward and of a train step by category (``torch.profiler``), peak
    memory over 1 + 3 bf16 train steps; then ``FOLD_ROUNDS`` interleaved
    rounds, each way in turn, of the ``Predictor(8)`` p50 and the p50 of 3
    train steps. One f32 train step at batch 2 against the unfolded step
    under deterministic algorithms: loss within 1e-5 relative, every
    gradient leaf but ``ZERO_GRAD`` within 1e-4 rel. L2 (``ZERO_GRAD``
    stays under 1e-3 of the largest gradient), buffers within 1e-5.
    Launches: exactly 8 task-axis B1 per forward, 8 task-axis B4 and 1 B2
    per train step, nothing of the one-task gates."""
    from vision_mtl_tpu_torch.metrics import init_metrics
    from vision_mtl_tpu_torch.models import mtan
    from vision_mtl_tpu_torch.serving import Predictor, latency_bench

    imgs = np.random.default_rng(4).integers(0, 256, size=(BATCH, cfg.height, cfg.width, 3),
                                             dtype=np.uint8)
    x = torch.from_numpy(imgs).to(dev).float() / 255.0
    batches = [{k: v.to(dev) for k, v in b.items()}
               for b in train_batches(cfg, 2, BATCH, seed=21)]
    plain = build_model("mtan", cfg, dtype=torch.bfloat16, device=dev, seed=0)
    folded = build_model("mtan", cfg, dtype=torch.bfloat16, device=dev, seed=0, fold_tasks=True)
    converted = mtan.fold_task_state_dict(plain.state_dict(), 2)
    seeded_equal = all(torch.equal(converted[k], v) for k, v in folded.state_dict().items())
    folded.load_state_dict(converted)
    out: dict = {"seeded_folded_equals_converted": seeded_equal}
    want = Predictor(plain, BATCH, cfg.height, cfg.width, dtype=np.uint8, device=dev)(imgs)
    launches, preds, trains = [], {}, {}
    for way in FOLD_WAYS:
        model = plain if way == "unfolded" else folded
        per_forward = PER_FORWARD["mtan" if way == "unfolded" else "mtan_folded"]
        per_step = PER_TRAIN_STEP["mtan" if way == "unfolded" else "mtan_folded"]
        with conv_way(way):
            kernels.reset_launch_counts()
            got = Predictor(model, BATCH, cfg.height, cfg.width, dtype=np.uint8, device=dev)(imgs)
            counts = kernels.launch_counts()
            if counts != expected(kernels, per_forward, 1):
                fail(f"mtan {way}: launches {counts} for one forward")
            launches.append(counts)
            bit_equal = all(np.array_equal(got[k], want[k]) for k in want)
            agree = float((got["segm"] == want["segm"]).mean())
            depth_err = float(np.abs(got["depth"] - want["depth"]).max())
            if not bit_equal and (agree < 0.99 or depth_err > 0.05):
                fail(f"mtan fold_tasks ({way}) vs unfolded: ids agree {agree}, depth {depth_err}")
            preds[way] = Predictor(model, BATCH, cfg.height, cfg.width, dtype=np.uint8,
                                   compact_out=True, device=dev)
            forward_profile = profile_forward(model, x)
            trained = build_model("mtan", cfg, dtype=torch.bfloat16, device=dev, seed=0,
                                  fold_tasks=way != "unfolded").train()
            steps = options_train_steps(trained, batches, dev, 1 + OPTION_STEPS)
            if steps["launches"] != expected(kernels, per_step, 1 + OPTION_STEPS):
                fail(f"mtan {way} training: launches {steps['launches']}")
            if not all(np.isfinite(steps["losses"])):
                fail(f"mtan {way} training: losses {steps['losses']}")
            launches.append(steps["launches"])
            state, step = trains[way] = steps["state"], steps["step"]

            def one_step():
                step(state, batches[0], init_metrics(cfg.num_classes, dev))

            out[way] = {"predict_bit_equal_to_unfolded": bit_equal, "segm_agreement": agree,
                        "depth_max_abs_err": depth_err, "forward_profile": forward_profile,
                        "train_losses": steps["losses"],
                        "train_peak_memory_above_start_bytes":
                            steps["peak_memory_above_start_bytes"],
                        "train_step_profile": profile_device(one_step, 2),
                        "p50_ms_by_round": [], "train_step_ms_p50_by_round": []}
            del trained, steps
    out["launches_per_forward"] = launches[2]
    for r in range(FOLD_ROUNDS):
        for way in FOLD_WAYS[r % 3:] + FOLD_WAYS[:r % 3]:
            with conv_way(way):
                kernels.reset_launch_counts()
                out[way]["p50_ms_by_round"].append(
                    latency_bench(preds[way], imgs, n=30)["p50_ms"])
                losses, step_ms = step_times(*trains[way], batches, dev, 1 + OPTION_STEPS)
                if not all(np.isfinite(losses)):
                    fail(f"mtan {way} training: losses {losses}")
                out[way]["train_step_ms_p50_by_round"].append(float(np.median(step_ms)))
                launches.append(kernels.launch_counts())
    del preds, trains

    # one f32 train step at batch 2, folded against unfolded
    (batch,) = train_batches(cfg, 1, 2, seed=7)
    with deterministic():
        plain32 = build_model("mtan", cfg, dtype=torch.float32, device=dev, seed=0)
        folded32 = build_model("mtan", cfg, dtype=torch.float32, device=dev, seed=0,
                               fold_tasks=True)
        a = one_step_snapshot(plain32.train(), batch, dev)
        b = one_step_snapshot(folded32.train(), batch, dev)
    launches += [a["launches"], b["launches"]]
    if abs(a["losses"][0] - b["losses"][0]) > 1e-5 * abs(a["losses"][0]):
        fail(f"mtan fold_tasks f32 step: loss {b['losses'][0]} vs unfolded {a['losses'][0]}")
    want_g = mtan.fold_task_state_dict(a["grads"], 2)
    top = max(float(g.abs().max()) for g in want_g.values())
    worst_zero = 0.0
    for k, g in b["grads"].items():
        if ZERO_GRAD.search(k.replace("_folded.", "_task0.")):
            zero = max(float(g.abs().max()), float(want_g[k].abs().max())) / top
            worst_zero = max(worst_zero, zero)
            if zero > 1e-3:
                fail(f"mtan fold_tasks f32 step: gradient of {k} is {zero} of the largest")
    whole, per = grad_distance(
        {k.replace("_folded.", "_task0."): v for k, v in b["grads"].items()},
        {k.replace("_folded.", "_task0."): v for k, v in want_g.items()})
    worst = sorted(per.items(), key=lambda kv: -kv[1])
    if worst[0][1] > 1e-4:
        fail(f"mtan fold_tasks f32 step: gradient of {worst[0][0]} off the unfolded by "
             f"{worst[0][1]} (rel. L2)")
    want_b = mtan.fold_task_state_dict(a["buffers"], 2)
    worst_buf = max(float(((v - want_b[k]).abs() / want_b[k].abs().clamp(min=1.0)).max())
                    for k, v in b["buffers"].items())
    if worst_buf > 1e-5:
        fail(f"mtan fold_tasks f32 step: running statistics off the unfolded by {worst_buf}")
    folded_keys = [k for k in per if "_task0." in k]
    out["f32_step_vs_unfolded"] = {
        "loss": b["losses"][0], "loss_unfolded": a["losses"][0],
        "grad_rel_l2_vs_unfolded": whole, "worst_leaves_rel_l2": worst[:3],
        "leaves_compared": len(per), "leaves_bit_equal": sum(v == 0.0 for v in per.values()),
        "task_leaves": len(folded_keys),
        "task_leaves_bit_equal": sum(per[k] == 0.0 for k in folded_keys),
        "worst_task_leaf_rel_l2": max((per[k] for k in folded_keys), default=0.0),
        "zero_grad_max_share": worst_zero, "running_stats_max_err": worst_buf}
    return out, launches


def check_fold_tail(cfg, kernels, dev, build_model) -> tuple:
    """The basic model with fold_tail at 128x256: its f32 forward on one
    batch of 8 against the unfolded model's (the same seeded weights; max
    |diff| within 1e-4 of the output's largest magnitude, ids agreeing on
    99.9%); B3 launches per bf16 forward (1: block 3's 67 -> 67) and per
    bf16 train step (2: that conv and its dx), and 3 train steps with
    finite losses."""
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(BATCH, cfg.height, cfg.width, 3)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        want = build_model("basic", cfg, dtype=torch.float32, device=dev, seed=0)(x)
        got = build_model("basic", cfg, dtype=torch.float32, device=dev, seed=0,
                          fold_tail=True)(x)
    out: dict = {}
    for k in want:
        scale = float(want[k].abs().max())
        err = float((got[k] - want[k]).abs().max())
        out[f"f32_{k}_max_abs_err_vs_unfolded"] = err
        if not torch.isfinite(got[k]).all() or err > 1e-4 * scale:
            fail(f"basic fold_tail f32 {k}: max |diff| {err} vs unfolded (scale {scale})")
    agree = float((got["segm"].argmax(-1) == want["segm"].argmax(-1)).float().mean())
    out["f32_segm_argmax_agreement"] = agree
    if agree < 0.999:
        fail(f"basic fold_tail: argmax agrees with the unfolded model on only {agree}")
    model = build_model("basic", cfg, dtype=torch.bfloat16, device=dev, seed=0, fold_tail=True)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        model(x.to(torch.bfloat16))
    fwd = kernels.launch_counts()
    if fwd != expected(kernels, PER_FORWARD["basic_fold_tail"], 1):
        fail(f"basic fold_tail: launches {fwd} for one forward")
    batches = [{k: v.to(dev) for k, v in b.items()}
               for b in train_batches(cfg, 2, BATCH, seed=22)]
    steps = options_train_steps(model.train(), batches, dev, 1 + OPTION_STEPS)
    if steps["launches"] != expected(kernels, PER_TRAIN_STEP["basic_fold_tail"],
                                     1 + OPTION_STEPS):
        fail(f"basic fold_tail training: launches {steps['launches']}")
    if not all(np.isfinite(steps["losses"])):
        fail(f"basic fold_tail training: losses {steps['losses']}")
    out.update({"launches_per_forward": fwd,
                "launches_per_train_step": {k: v // (1 + OPTION_STEPS)
                                            for k, v in steps["launches"].items()},
                "train_step_ms_p50": steps["step_ms_p50"], "train_losses": steps["losses"]})
    return out, [fwd, steps["launches"]]


def check_remat(cfg, kernels, dev, build_model) -> tuple:
    """Each model's remat flags at 128x256, batch 8, bf16, under
    deterministic algorithms: the step with every flag on against the same
    seeded model's step without remat on the same batch, the loss, every
    gradient and every buffer bit for bit (the recompute must not count the
    batch twice in the running statistics); then, for the model without
    remat, each flag alone and all together, the step time (p50 of 3 after
    one untimed) and the peak memory above what was live before the first
    step, with the exact launches."""
    out, launches = {}, []
    batches = [{k: v.to(dev) for k, v in b.items()}
               for b in train_batches(cfg, 2, BATCH, seed=23)]
    for name, configs in REMAT_CONFIGS.items():
        with deterministic():
            plain = one_step_snapshot(
                build_model(name, cfg, dtype=torch.bfloat16, device=dev, seed=0).train(),
                batches[0], dev)
            remat = one_step_snapshot(
                build_model(name, cfg, dtype=torch.bfloat16, device=dev, seed=0,
                            **configs[-1]).train(), batches[0], dev)
        launches += [plain["launches"], remat["launches"]]
        if remat["launches"] != expected(kernels, PER_REMAT_STEP[name], 1):
            fail(f"{name} remat {configs[-1]}: launches {remat['launches']}")
        differ = [k for k in plain["grads"] if not torch.equal(plain["grads"][k],
                                                               remat["grads"][k])]
        differ += [k for k in plain["buffers"] if not torch.equal(plain["buffers"][k],
                                                                  remat["buffers"][k])]
        if plain["losses"] != remat["losses"] or differ:
            fail(f"{name} remat {configs[-1]}: step differs from the plain step: loss "
                 f"{remat['losses']} vs {plain['losses']}, tensors {differ[:5]}")
        line = {"bit_equal_to_plain_step": True, "launches_plain_step": plain["launches"],
                "launches_remat_step": remat["launches"], "by_config": {}}
        del plain, remat
        for opts in [{}] + configs:
            model = build_model(name, cfg, dtype=torch.bfloat16, device=dev, seed=0, **opts)
            steps = options_train_steps(model.train(), batches, dev, 1 + OPTION_STEPS)
            if not all(np.isfinite(steps["losses"])):
                fail(f"{name} {opts}: losses {steps['losses']}")
            launches.append(steps["launches"])
            line["by_config"][",".join(f"{k}={v}" for k, v in opts.items()) or "none"] = {
                "step_ms_p50": steps["step_ms_p50"],
                "peak_memory_above_start_bytes": steps["peak_memory_above_start_bytes"],
                "launches_per_step": {k: v // (1 + OPTION_STEPS)
                                      for k, v in steps["launches"].items()}}
            del model, steps
            torch.cuda.empty_cache()
        out[name] = line
    return out, launches


def options_phase(cfg, kernels, dev, build_model, fused_gate, fused_gate_train) -> tuple:
    """Every model option at full width (Cityscapes 128x256, batch 8, bf16,
    seeded weights): B1 and B4 with the task axis, MTAN's fold_tasks, the
    basic model's fold_tail, the remat flags of the three models, and the
    training CLI with ``--fold_tasks --remat_attention`` for one epoch on
    the ``cli`` phase's tree, then ``serve --run_dir`` on its run, which
    reads the flags back. Returns the ``options`` line, the task-axis
    kernels' totals and the main-path launches."""
    t_phase = time.perf_counter()
    task_rows, task_totals = check_task_gates(dev, fused_gate, fused_gate_train)
    print(json.dumps({"task_gate_shapes": task_rows}), flush=True)
    fold_tasks, launches = check_fold_tasks(cfg, kernels, dev, build_model)
    fold_tail, fold_tail_launches = check_fold_tail(cfg, kernels, dev, build_model)
    remat, remat_launches = check_remat(cfg, kernels, dev, build_model)
    common = ["--dataset_name", "cityscapes", "--data_dir", CLI_DATA, "--batch_size", str(BATCH),
              "--num_workers", "4", "--lr", str(LR), "--save_epoch_freq", "1"]
    run = run_cli("mtan_folded_remat", common + ["--model_name", "mtan", "--num_epochs", "1",
                                                 "--fold_tasks", "--remat_attention"],
                  cfg, kernels)
    model = run["rec"]["state"].model
    if not (model.fold_tasks and model.remat_attention):
        fail("options cli: the run's model lacks its flags")
    served = serve_run_dir("mtan_folded_remat", run["run_dir"], model, cfg, dev, kernels)
    line = {
        "config": "cityscapes 128x256, 19 classes, bf16, batch 8",
        "task_gates_per_mtan_call": {k: {kk: vv for kk, vv in v.items() if kk != "err"}
                                     for k, v in task_totals.items()},
        "mtan_fold_tasks": fold_tasks, "basic_fold_tail": fold_tail, "remat": remat,
        "cli": run["line"], "serve_run_dir": served, "phase_s": time.perf_counter() - t_phase,
    }
    return (line, task_totals,
            launches + fold_tail_launches + remat_launches + [run["launches"], served["launches"]])


PARALLEL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
                            "parallel")

PARALLEL_BF16_STEPS = 1  # timed two-rank bf16 steps, after one untimed
PARALLEL_BATCH_SEED = 31
PARALLEL_PREDICT_SEED = 41
PARALLEL_TIMEOUT_S = 600
# calls of a kernel, and of its plain version, timed with CUDA events in the
# rank phases (after one untimed)
RANK_TIMED_CALLS, RANK_PLAIN_CALLS = 5, 3
# a train step of MTAN under ranks: its 16 gates take B4's staged call
PER_RANK_TRAIN_STEP = {"fused_attention_gate_train_ranks": 16, BACKWARD: 16,
                       "confusion_matrix": 1}
# Predictor(8, mesh=) against the one-process Predictor(8), f32 weights: the
# ranks' convolutions see 4 images, not 8, and cuDNN may sum in another order
PARALLEL_DEPTH_TOL = 1e-4
PARALLEL_SEGM_MISMATCH_TOL = 1e-4  # share of pixels whose argmax may differ

PARALLEL_CODE = r"""
import sys
import chip_smoke
sys.exit(chip_smoke.parallel_rank(sys.argv[1], sys.argv[2:]))
"""
#: the phases the rank processes run, in order
PARALLEL_PHASES = ("parallel", "spatial", "model", "spatial4")
#: ranks of a phase that needs a number of its own (on one card a second
#: launch of rank processes sharing it); the others take parallel_world()
PHASE_WORLD = {"spatial4": 4}
# the spatial phase: the mesh's spatial axis over the same ranks, MTAN,
# basic and CSNet; 1 + SPATIAL_BF16_STEPS bf16 steps each
SPATIAL_MODELS = ("mtan", "basic", "csnet")
# then heights whose coarser levels' rows do not split over 2 ranks (those
# levels run whole on both): case -> (model, the batch's first rows)
SPATIAL_UNEVEN = {"basic_h96": ("basic", 96), "mtan_h112": ("mtan", 112)}
SPATIAL_BF16_STEPS = 1
# a train step under ranks: MTAN's gates take B4's staged call, basic's 4
# and CSNet's 12 B3 convs (and their dx) run on row blocks with one halo
# row each side
PER_SPATIAL_TRAIN_STEP = {"mtan": PER_RANK_TRAIN_STEP, "basic": PER_TRAIN_STEP["basic"],
                          "csnet": PER_TRAIN_STEP["csnet"]}
# the spatial4 phase: MTAN over spatial:4 (four ranks, each the whole batch
# and a quarter of its rows): case -> (model, the batch's first rows). At
# 112 rows (28 a rank) level 3 does not split and runs whole, its gates on
# the whole 14x32 map; at 128 rows (32 a rank) every level splits
SPATIAL4_CASES = {"mtan_h112": ("mtan", 112), "mtan_h128": ("mtan", 128)}
# the level of each of MTAN's gates (GATE_SHAPES): encoder level i at i,
# decoder level i at 3 - i
GATE_LEVELS = {"enc0": 0, "enc1": 1, "enc2": 2, "enc3": 3,
               "dec0": 3, "dec1": 2, "dec2": 1, "dec3": 0}
# the model phase: the mesh's model axis over the same ranks, MTAN, basic
# and CSNet, then MTAN with fold_tasks and basic with fold_tail
# (model_variant); 1 + MODEL_BF16_STEPS bf16 steps each
MODEL_MODELS = ("mtan", "basic", "csnet", "mtan_fold_tasks", "basic_fold_tail")
MODEL_BF16_STEPS = 1
# the share of one process's parameter and Adam-moment bytes a rank holds
# under model:2 at the default min_size: the layout of
# parallel/mesh.param_shardings at full width, counted on the CPU (31, 21,
# 44, 29 and 21 sharded leaves)
MODEL_BYTE_SHARES = {"mtan": 0.53604, "basic": 0.54386, "csnet": 0.54342,
                     "mtan_fold_tasks": 0.51692, "basic_fold_tail": 0.54386}
# the model axis with no data axis (one card): every rank sees the whole
# batch and no batch statistic is combined, so the f32 step differs from one
# process's only in the order of the model group's sums: measured 8.9e-7 to
# 1.6e-6 relative L2 whole, worst leaves 1e-5 (MTAN) and 4.5e-3 to 7.7e-3
# (basic's and CSNet's stage-1 BatchNorm weights, whose gradients nearly
# cancel); the limits are about 60 and 4 times those
MODEL_AXIS_F32_LIMITS = {"rel_l2_limit": 1e-4, "leaf_limit": 3e-2}


def model_variant(name: str) -> tuple:
    """(registry name, build options) of a rank phase's model:
    ``mtan_fold_tasks`` is MTAN with ``fold_tasks``, ``basic_fold_tail``
    basic with ``fold_tail``."""
    base, _, option = name.partition("_")
    return base, ({option: True} if option else {})


def first_rows(batch: dict, rows: int) -> dict:
    """A batch's first ``rows`` image rows (every leaf of three dims or more)."""
    return {k: v[:, :rows] if v.dim() >= 3 else v for k, v in batch.items()}


def spatial_spec(world: int) -> str:
    """The mesh of the ``spatial`` phase: two ranks (sharing one card) split
    the image rows; four (a card each) split the batch and the rows. (The
    ``spatial4`` phase splits the rows four ways over four ranks, on one
    card or on four.)"""
    return "spatial:2" if world == 2 else f"data:{world // 2},spatial:2"


def parallel_world() -> int:
    """Ranks of the ``parallel`` phase: one per card (NCCL) on a machine
    with several, else two sharing the one card (gloo)."""
    return max(2, torch.cuda.device_count())


def flat_bits(tensors) -> torch.Tensor:
    """f32 tensors as one int32 vector of their bits (NaN-proof equality)."""
    return torch.cat([t.detach().float().reshape(-1) for t in tensors]).view(torch.int32)


def same_on_every_rank(comm, tensors) -> bool:
    """True when ``tensors`` hold the same bits on every rank (an exact
    all-gather of their bits)."""
    from vision_mtl_tpu_torch.parallel.multihost import all_gather_exact

    gathered = all_gather_exact(flat_bits(tensors), comm)
    return all(torch.equal(gathered[0], g) for g in gathered[1:])


def train_tensors(state) -> list:
    """Parameters and Adam moments of a train state, in parameter order."""
    params = list(state.model.parameters())
    moments = [state.optimizer.state[p][k] for p in params for k in ("exp_avg", "exp_avg_sq")
               if p in state.optimizer.state]
    return params + moments


def rank_gate_times(fused_gate_train, comm, dev, rows: int = 0, split_h: int = 1,
                    height: int = 128) -> tuple:
    """B4's staged call at MTAN's 8 gate shapes on this rank's block of the
    batch (``rows`` images, ``BATCH / world`` by default, and ``1 /
    split_h`` of their rows, the image ``height`` rows; bf16, as the main
    path): against the plain
    version's split, timed with CUDA events around 10 calls (the gathers
    between the passes included). Per train step: two tasks a level."""
    gen = torch.Generator(device=dev).manual_seed(10 + comm.rank)
    per = rows or BATCH // comm.world
    rows, totals = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0}
    by_flops = by_bytes = 0.0
    for level, cin, c2, h, w in GATE_SHAPES:
        h = h * height // 128 // split_h
        def uniform(*shape, bound=1.0):
            return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * bound

        args = (
            torch.randn(per, h, w, cin, generator=gen, device=dev).to(torch.bfloat16),
            torch.randn(per, h, w, c2, generator=gen, device=dev).to(torch.bfloat16),
            uniform(cin, HIDDEN, bound=cin**-0.5), uniform(HIDDEN, bound=cin**-0.5),
            uniform(HIDDEN) * 0.5 + 1.0, uniform(HIDDEN, bound=0.3),
            uniform(HIDDEN, c2, bound=HIDDEN**-0.5), uniform(c2, bound=HIDDEN**-0.5),
            uniform(c2) * 0.5 + 1.0, uniform(c2, bound=0.3),
        )
        with torch.no_grad():
            def kernel():
                return fused_gate_train.fused_attention_gate_train(*args, comm=comm)

            def plain():
                return fused_gate_train.fused_attention_gate_train_plain(*args, comm=comm)

            got, want = kernel(), plain()
            err, ok = output_ok(got[0], want[0])
            if not ok:
                fail(f"staged fused_attention_gate_train {level} rank {comm.rank}: output max "
                     f"|diff| {err} from the plain split")
            for g, r in zip(got[1:], want[1:]):
                if not bool(((g - r).abs() <= 1e-5 * r.abs() + 1e-6).all()):
                    fail(f"staged fused_attention_gate_train {level}: a statistic is off the "
                         f"plain split's by {float((g - r).abs().max())}")
            comm.barrier()
            ms = time_ms(kernel, iters=RANK_TIMED_CALLS, warmup=1)
            comm.barrier()
            plain_ms = time_ms(plain, iters=RANK_PLAIN_CALLS, warmup=1)
        n = per * h * w
        nbytes = 2 * n * (cin + 2 * c2) + 4 * (
            cin * HIDDEN + 3 * HIDDEN + HIDDEN * c2 + 3 * c2 + 2 * (HIDDEN + c2))
        tc_flops = tf32_flops(n, cin, c2, True)
        b_ms, _ = bound(nbytes, tc_flops, TF32_TC_FLOPS_PER_S)
        rows.append({"level": level, "N_per_rank": n, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "max_abs_err": err})
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms)):
            totals[k] += 2 * v
        totals["err"] = max(totals["err"], err)
        by_flops += 2 * tc_flops / TF32_TC_FLOPS_PER_S
        by_bytes += 2 * nbytes / HBM_BYTES_PER_S
    totals["bound_by"] = "operations" if by_flops >= by_bytes else "bytes"
    return rows, totals


def time_recorded(calls: list, fn, plain) -> dict:
    """B3's wrapper ``fn`` on each input it was given in one step (the row
    blocks with their halo rows) against ``plain`` on the same inputs: max
    |diff| (bf16: within one bf16 step of the plain output), CUDA-event ms
    of all the calls together for the kernel, the plain version and one
    cuDNN ``F.conv2d`` each, and the bound of the calls' bytes and products
    (the input and weights read once, the output written once)."""
    import torch.nn.functional as F

    err = nbytes = flops = 0.0
    library_args = []
    with torch.no_grad():
        for x, k, bias in calls:
            got, want = fn(x, k, bias), plain(x, k, bias)
            d = float((got.float() - want.float()).abs().max())
            if not d <= max(2.0**-7 * float(want.float().abs().max()) + 1e-6, 1e-4):
                fail(f"conv3x3_small on a row block {tuple(x.shape)}: max |diff| {d}")
            err = max(err, d)
            n, (c, o) = x.shape[0] * x.shape[1] * x.shape[2], k.shape[2:]
            es = x.element_size()
            nbytes += es * n * (c + o) + es * 9 * c * o + (4 * o if bias is not None else 0)
            flops += 2.0 * n * 9 * c * o
            library_args.append((x.permute(0, 3, 1, 2), k.to(x.dtype).permute(3, 2, 0, 1)
                                 .contiguous(), None if bias is None else bias.to(x.dtype)))

        ms = time_ms(lambda: [fn(*a) for a in calls], iters=RANK_TIMED_CALLS, warmup=1)
        plain_ms = time_ms(lambda: [plain(*a) for a in calls], iters=RANK_PLAIN_CALLS,
                           warmup=1)
        library_ms = time_ms(lambda: [F.conv2d(x, w, b, padding=1) for x, w, b in library_args],
                             iters=RANK_TIMED_CALLS, warmup=1)
    bound_ms, bound_by = bound(nbytes, flops, BF16_TC_FLOPS_PER_S)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, "calls": len(calls),
            "shapes": sorted({tuple(x.shape) for x, _, _ in calls})}


def release_memory(comm) -> int:
    """This process's cached device memory given back to the card, then a
    barrier over ``comm``: the free bytes after. cuDNN picks a convolution's
    algorithm at the first call of its shape in a process, among those whose
    workspace fits in the memory then free, and keeps the pick: on the H100
    basic's f32 step takes FFT algorithms with the card to itself and
    others with 6 GB free, 8.5e-4 relative L2 apart (``chip_cudnn_memory.py``).
    A rank phase's f32 step is held to the one-process step, taken with the
    card to itself, so every rank calls this first."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    comm.barrier()
    return torch.cuda.mem_get_info()[0]


def predictor_ref(out_dir: str, name: str, rows: int) -> dict:
    """The one-process Predictor(8)'s answer for ``name``'s seeded f32
    weights on the batch's first ``rows`` rows (:func:`parallel_phase`
    writes it before the ranks start)."""
    return np.load(os.path.join(out_dir, f"predictor_ref_{name}_{rows}.npz"))


def held_answer(comm, answer: dict, want: dict, what: str) -> dict:
    """A ``Predictor(mesh=)`` answer against the one-process answer
    ``want``: depth within ``PARALLEL_DEPTH_TOL``, the ids differing on at
    most ``PARALLEL_SEGM_MISMATCH_TOL`` of the pixels, and the same bits on
    every rank of ``comm``."""
    depth_err = float(np.abs(answer["depth"] - want["depth"]).max())
    mismatch = float((answer["segm"] != want["segm"]).mean())
    if answer["segm"].shape != want["segm"].shape or not depth_err <= PARALLEL_DEPTH_TOL \
            or not mismatch <= PARALLEL_SEGM_MISMATCH_TOL:
        fail(f"{what} rank {comm.rank}: depth max |diff| {depth_err}, segm ids differ on "
             f"{mismatch} of the pixels, from the one-process Predictor")
    dev = torch.device("cuda", torch.cuda.current_device())
    if not same_on_every_rank(comm, [torch.from_numpy(answer["depth"]).to(dev),
                                     torch.from_numpy(answer["segm"]).to(dev).float()]):
        fail(f"{what}: the ranks' answers differ")
    return {"depth_max_abs_err": depth_err, "segm_mismatch_share": mismatch,
            "answers_equal_across_ranks": True}


def spatial_gate_step(rows: int) -> dict:
    """MTAN's launches in a train step over the spatial axis alone, each
    rank ``rows`` image rows: the gates of a level that runs whole take
    B4's fused call (its batch sums over the data group, here no rank
    else), the others its staged call over the spatial group."""
    from vision_mtl_tpu_torch.parallel.halo import first_whole_level

    whole = 2 * sum(level >= first_whole_level(rows) for level in GATE_LEVELS.values())
    return {"fused_attention_gate_train": whole,
            "fused_attention_gate_train_ranks": 2 * len(GATE_LEVELS) - whole,
            BACKWARD: 2 * len(GATE_LEVELS), "confusion_matrix": 1}


def spatial_case(mesh, step, tag: str, case: str, name: str, rows: int, per: dict,
                 out_dir: str, batch: dict, imgs: np.ndarray, add) -> tuple:
    """``name`` over ``mesh``'s spatial axis on the first ``rows`` image rows
    of the batches: the f32 step on ``batch`` (the all-reduced gradients the
    same on every rank; rank 0 saves them as ``{tag}_{case}_f32_grads.pt``
    for :func:`parallel_phase`), 1 + ``SPATIAL_BF16_STEPS`` bf16 steps after
    which every rank holds the same parameters and Adam moments bit for bit,
    each run's launches exactly ``per`` a step (``add``-ed to the phase's),
    the first, untimed, with the spatial group's all-reduces counted by kind
    (row gathers whenever a level runs whole), ``Predictor(8, mesh=)`` on
    ``imgs`` against the one-process answer. Returns (the case's record,
    B3's inputs in the first bf16 step)."""
    from vision_mtl_tpu_torch import kernels
    from vision_mtl_tpu_torch.cfg import fetch_data_cfg
    from vision_mtl_tpu_torch.kernels import small_conv
    from vision_mtl_tpu_torch.metrics import init_metrics
    from vision_mtl_tpu_torch.models.registry import build_model
    from vision_mtl_tpu_torch.parallel import halo
    from vision_mtl_tpu_torch.serving import Predictor
    from vision_mtl_tpu_torch.train.state import create_train_state

    cfg = fetch_data_cfg("cityscapes")
    comm, dev, rank = mesh.comm, mesh.device, mesh.rank
    model = build_model(name, cfg, dtype=torch.float32, device=dev, seed=0)
    state = create_train_state(model, LR, device=dev)
    free = release_memory(comm)
    kernels.reset_launch_counts()
    _, _, losses = step(state, mesh.block(first_rows(batch, rows)),
                        init_metrics(cfg.num_classes, dev))
    torch.cuda.synchronize()
    f32_counts = kernels.launch_counts()
    add(f32_counts)
    if f32_counts != expected(kernels, per, 1):
        fail(f"{tag} {case} f32 step rank {rank}: launches {f32_counts}")
    if not same_on_every_rank(comm, [p.grad for p in model.parameters()]):
        fail(f"{tag} {case} f32 step: the all-reduced gradients differ between the ranks")
    if rank == 0:
        torch.save({"grads": {k: p.grad.double().cpu() for k, p in model.named_parameters()},
                    "loss": float(losses["loss"])},
                   os.path.join(out_dir, f"{tag}_{case}_f32_grads.pt"))
    local = rows // mesh.size("spatial")
    first = halo.first_whole_level(local)
    levels = int(np.log2(model.row_stride))
    del model, state

    model = build_model(name, cfg, dtype=torch.bfloat16, device=dev, seed=0)
    state = create_train_state(model, LR, device=dev)
    n_steps = 1 + SPATIAL_BF16_STEPS
    blocks_ = [mesh.block(first_rows(b, rows))
               for b in train_batches(cfg, TRAIN_BATCHES, BATCH, seed=6)]
    calls, real_b3 = [], small_conv.conv3x3_small

    def recording(x, kernel, bias=None):
        if len(calls) < per.get("conv3x3_small", 0):  # the first step's
            calls.append((x.detach().clone(), kernel.detach().clone(),
                          None if bias is None else bias.detach().clone()))
        return real_b3(x, kernel, bias)

    kernels.reset_launch_counts()
    step_losses = []
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_steps + 1)]
    small_conv.conv3x3_small = recording
    try:
        events[0].record()
        for i in range(n_steps):
            def bf16_step():
                return step(state, blocks_[i % TRAIN_BATCHES], init_metrics(cfg.num_classes, dev))

            if i == 0:  # the untimed step: its collectives counted by what made them
                exchanges, (state, _, ls) = count_exchanges(mesh.spatial_comm, bf16_step)
            else:
                state, _, ls = bf16_step()
            events[i + 1].record()
            step_losses.append(ls["loss"])
        torch.cuda.synchronize()
    finally:
        small_conv.conv3x3_small = real_b3
    counts = kernels.launch_counts()
    add(counts)
    if counts != expected(kernels, per, n_steps):
        fail(f"{tag} {case} bf16 steps rank {rank}: launches {counts}")
    step_losses = [float(v) for v in step_losses]
    if not all(np.isfinite(step_losses)):
        fail(f"{tag} {case} bf16 steps: losses {step_losses}")
    if not same_on_every_rank(comm, train_tensors(state)):
        fail(f"{tag} {case} bf16 steps: parameters or Adam moments differ between the "
             f"ranks after {n_steps} steps")
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(1, n_steps)]
    # rows are gathered into a level that runs whole, and by CSNet's merges
    # (the coarse map centred in the skip's rows) at any height
    if bool(exchanges.get("gather_rows")) != (first <= levels or name == "csnet"):
        fail(f"{tag} {case}: {exchanges.get('gather_rows', 0)} row gathers in a step, levels "
             f"{first} to {levels} whole")
    del model, state
    model = build_model(name, cfg, dtype=torch.float32, device=dev, seed=0).eval()
    kernels.reset_launch_counts()
    answer = Predictor(model, BATCH, rows, cfg.width, dtype=np.uint8,
                       mesh=mesh)(np.ascontiguousarray(imgs[:, :rows]))
    torch.cuda.synchronize()
    pred_counts = kernels.launch_counts()
    add(pred_counts)
    if pred_counts != expected(kernels, PER_FORWARD[name], 1):
        fail(f"{tag} {case} Predictor rank {rank}: launches {pred_counts}")
    predictor = held_answer(comm, answer, predictor_ref(out_dir, name, rows),
                            f"{tag} {case} Predictor")
    del model
    return {
        "height": rows, "rows_per_rank": local,
        "whole_levels": list(range(first, levels + 1)),
        "f32": {"loss": float(losses["loss"]), "launches": f32_counts, "free_bytes": free},
        "all_reduces_per_step": exchanges,
        "bf16": {"steps": n_steps, "losses": step_losses, "step_ms": step_ms,
                 "step_ms_p50": float(np.median(step_ms)), "launches": counts,
                 "params_and_moments_equal_across_ranks": True},
        "predictor": {**predictor, "launches": pred_counts},
    }, calls


def count_exchanges(comm, fn) -> tuple:
    """``(counts, fn())``: every all-reduce of ``comm`` in ``fn()`` counted
    by what made it, read from the call stack: the halo exchanges of
    ``parallel/halo.py`` (forward and backward), its row gathers, and the
    others (the group sums of the SE means and the losses, the BN and B4
    statistics, the gradient all-reduce). One step's worth, and an untimed
    one: the stack walk is not free."""
    import traceback

    counts: dict = {}
    real = comm.all_reduce_

    def counted(tensor, op="sum"):
        frames = traceback.extract_stack(limit=12)
        in_halo = [f.name for f in frames if f.filename.endswith(os.path.join("parallel", "halo.py"))]
        kind = ("halo_" + ("backward" if "backward" in in_halo else "forward") if
                ("forward" in in_halo or "backward" in in_halo) else
                "gather_rows" if "gather_rows" in in_halo else "other")
        counts[kind] = counts.get(kind, 0) + 1
        return real(tensor, op)

    comm.all_reduce_ = counted
    try:
        return counts, fn()
    finally:
        del comm.all_reduce_


def spatial_rank(comm, out_dir: str) -> dict:
    """The ``spatial`` phase on one rank: the mesh of :func:`spatial_spec`
    over the ``parallel`` phase's ranks. Per model of ``SPATIAL_MODELS``
    (MTAN, basic and CSNet at 128x256, global batch 8, each rank its block)
    the checks of :func:`spatial_case`: the f32 step (rank 0 saves its
    gradients for :func:`parallel_phase` to hold to the one-process step),
    the bf16 steps with every rank's parameters and Adam moments bit for
    bit, launches counted per rank, the collectives by kind,
    ``Predictor(8, mesh=)`` against the one-process answer; B3 timed on the
    row blocks basic's and CSNet's steps gave it. Then one MTAN epoch of the
    training CLI over the mesh (:func:`rank_cli`), B4's staged call on the
    rank's blocks, and each case of ``SPATIAL_UNEVEN`` (the batches' first
    rows: coarser levels that do not split run whole) through
    :func:`spatial_case`, with B3 or B4 timed on its blocks. Returns the
    rank's record, its main-path launches under ``launches``."""
    from vision_mtl_tpu_torch import kernels
    from vision_mtl_tpu_torch.cfg import fetch_data_cfg
    from vision_mtl_tpu_torch.kernels import fused_gate_train, small_conv
    from vision_mtl_tpu_torch.parallel.mesh import create_mesh
    from vision_mtl_tpu_torch.train.step import make_train_step

    t0 = time.perf_counter()
    cfg = fetch_data_cfg("cityscapes")
    spec = spatial_spec(comm.world)
    mesh = create_mesh(spec, comm)
    dev = mesh.device
    step = make_train_step(device=dev, mesh=mesh)
    out = {"mesh": spec, "coords": mesh.coords(), "block": {
        "rows": str(mesh.batch_rows(BATCH)), "image_rows": str(mesh.image_rows(cfg.height))}}
    launches = {name: 0 for name in kernels.KERNELS}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    (batch,) = train_batches(cfg, 1, BATCH, seed=PARALLEL_BATCH_SEED)
    imgs = train_batches(cfg, 1, BATCH, seed=PARALLEL_PREDICT_SEED)[0]["img"].numpy()
    for name in SPATIAL_MODELS:
        t_case = time.perf_counter()
        out[name], calls = spatial_case(mesh, step, "spatial", name, name, cfg.height,
                                        PER_SPATIAL_TRAIN_STEP[name], out_dir, batch, imgs, add)
        if calls:  # B3 on this rank's row blocks, forward and dx
            comm.barrier()
            out[name]["conv3x3_small_row_blocks"] = time_recorded(
                calls, small_conv.conv3x3_small, small_conv.conv3x3_small_plain)
        out[name]["case_s"] = time.perf_counter() - t_case
    # the training CLI over the same mesh: whole batches decoded, blocks kept
    out["cli"] = rank_cli(comm, out_dir, spec, "spatial_logs", "spatial")
    out["cli"].pop("state")
    add(out["cli"]["launches"])
    gate_rows, gate_totals = rank_gate_times(fused_gate_train, comm, dev,
                                             rows=BATCH // mesh.size("data"),
                                             split_h=mesh.size("spatial"))
    out["gate_train_staged"] = {"rows": gate_rows, **gate_totals}

    # heights whose coarser levels do not split over the spatial ranks
    for case, (name, rows) in SPATIAL_UNEVEN.items():
        t_case = time.perf_counter()
        out[case], calls = spatial_case(mesh, step, "spatial", case, name, rows,
                                        PER_SPATIAL_TRAIN_STEP[name], out_dir, batch, imgs, add)
        comm.barrier()
        if calls:  # B3 on this height's row blocks, forward and dx
            out[case]["conv3x3_small_row_blocks"] = time_recorded(
                calls, small_conv.conv3x3_small, small_conv.conv3x3_small_plain)
        if name == "mtan":  # B4's staged call at this height's blocks
            out[case]["gate_train_staged"] = rank_gate_times(
                fused_gate_train, comm, dev, rows=BATCH // mesh.size("data"),
                split_h=mesh.size("spatial"), height=rows)[1]
        out[case]["case_s"] = time.perf_counter() - t_case
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t0
    return out


def whole_level_gate_times(fused_gate, fused_gate_train, rows: int, level: int) -> dict:
    """B1 and B4 at the gates of MTAN's ``level`` on its whole map at
    ``rows`` image rows (batch 8, bf16 as the main path), the shapes of its
    calls where that level runs whole over the spatial axis (B4's fused
    call: no rank else holds other images): :func:`check_gate` and
    :func:`check_gate_train` at those shapes, device times against their
    plain versions', per forward or train step (two tasks a gate)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    shapes = [(name, cin, c2, h * rows // 128, w) for name, cin, c2, h, w in GATE_SHAPES
              if GATE_LEVELS[name] == level]
    bf16 = (torch.bfloat16,)
    eval_rows, eval_totals = check_gate(dev, fused_gate, shapes, dtypes=bf16)
    train_rows, train_totals = check_gate_train(dev, fused_gate_train, shapes, dtypes=bf16)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "err")
    return {"level": level, "shapes": [list(sh) for sh in shapes],
            "eval": {k: eval_totals[k] for k in keys}, "eval_rows": eval_rows,
            "train": {k: train_totals[k] for k in keys}, "train_rows": train_rows}


def spatial4_rank(comm, out_dir: str) -> dict:
    """The ``spatial4`` phase on one rank of four (gloo ranks sharing one
    card, or NCCL with a card each): MTAN at full width over ``spatial:4``,
    each rank the whole global batch 8 and a quarter of its rows, at the
    heights of ``SPATIAL4_CASES`` through :func:`spatial_case`. At 112 rows
    (28 a rank) level 3 does not split and runs whole on every rank: its
    four gates (enc3 and dec0, two tasks each) take B4's fused call on the
    whole 14x32 map and the other twelve B4's staged call over the spatial
    group; ``Predictor(8, mesh=)`` runs all 16 B1 calls, level 3's on the
    whole map. At 128 rows (32 a rank) every level splits and all 16 gates
    take the staged call. Then B1 and B4 at level 3's whole map against
    their plain versions (:func:`whole_level_gate_times`, on rank 0 while
    the others wait). Returns the rank's record, its main-path launches
    under ``launches``."""
    from vision_mtl_tpu_torch import kernels
    from vision_mtl_tpu_torch.cfg import fetch_data_cfg
    from vision_mtl_tpu_torch.kernels import fused_gate, fused_gate_train
    from vision_mtl_tpu_torch.parallel.halo import first_whole_level
    from vision_mtl_tpu_torch.parallel.mesh import create_mesh
    from vision_mtl_tpu_torch.train.step import make_train_step

    t0 = time.perf_counter()
    cfg = fetch_data_cfg("cityscapes")
    mesh = create_mesh("spatial:4", comm)
    step = make_train_step(device=mesh.device, mesh=mesh)
    out = {"mesh": "spatial:4", "coords": mesh.coords()}
    launches = {name: 0 for name in kernels.KERNELS}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    (batch,) = train_batches(cfg, 1, BATCH, seed=PARALLEL_BATCH_SEED)
    imgs = train_batches(cfg, 1, BATCH, seed=PARALLEL_PREDICT_SEED)[0]["img"].numpy()
    for case, (name, rows) in SPATIAL4_CASES.items():
        t_case = time.perf_counter()
        per = spatial_gate_step(rows // 4)
        out[case], _ = spatial_case(mesh, step, "spatial4", case, name, rows, per, out_dir,
                                    batch, imgs, add)
        out[case]["gates_per_step"] = per
        first = first_whole_level(rows // 4)
        if first <= max(GATE_LEVELS.values()):
            comm.barrier()
            if comm.rank == 0:
                out[case]["gates_on_the_whole_level"] = whole_level_gate_times(
                    fused_gate, fused_gate_train, rows, first)
            comm.barrier()
        out[case]["case_s"] = time.perf_counter() - t_case
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t0
    return out


def rank_cli(comm, out_dir: str, mesh_shape: str, logs: str, tag: str,
             per_step: dict = PER_RANK_TRAIN_STEP, whole=None) -> dict:
    """The training CLI in process on this rank: one MTAN epoch on the
    ``cli`` tree over ``--mesh_shape mesh_shape``, run dirs under
    ``out_dir/logs``. Launches counted exactly (what the loaders' lengths
    predict, ``per_step`` a train step's), every rank's weights and Adam
    moments the same bits after the epoch (``whole(state)``: the tensors to
    hold equal, :func:`train_tensors` by default), one run dir with one
    checkpoint and ``preds.npz``. The record's ``state`` is the trained
    state (not JSON: the caller pops it)."""
    from vision_mtl_tpu_torch import kernels, training
    from vision_mtl_tpu_torch.cfg import cfg as pipeline_cfg

    rank = comm.rank
    pipeline_cfg.log_root_dir = os.path.join(out_dir, logs)
    argv = ["--dataset_name", "cityscapes", "--data_dir", CLI_DATA, "--batch_size", str(BATCH),
            "--num_workers", "4", "--lr", str(LR), "--save_epoch_freq", "1",
            "--model_name", "mtan", "--num_epochs", "1", "--mesh_shape", mesh_shape]
    seen: dict = {}
    real_run_pipe = training.run_pipe

    def run_pipe(args, state, datamodule, **kw):
        state, metrics = real_run_pipe(args, state, datamodule, **kw)
        seen.update(state=state, datamodule=datamodule)
        return state, metrics

    training.run_pipe = run_pipe
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        run_dir = training.main(argv)
    finally:
        training.run_pipe = real_run_pipe
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_counts = kernels.launch_counts()
    dm = seen["datamodule"]
    n_train, n_val, n_pred = (len(dm.train_dataloader()), len(dm.val_dataloader()),
                              len(dm.predict_dataloader()))
    want = expected(kernels, per_step, n_train, confusion_matrix=n_val + n_pred)
    want["fused_attention_gate"] += PER_FORWARD["mtan"]["fused_attention_gate"] * (n_val + n_pred)
    if cli_counts != want:
        fail(f"{tag} cli rank {rank}: launches {cli_counts}, want {want}")
    if not same_on_every_rank(comm, (whole or train_tensors)(seen["state"])):
        fail(f"{tag} cli: the ranks' weights or Adam moments differ after the epoch")
    if comm.broadcast_object(run_dir) != run_dir:
        fail(f"{tag} cli: rank {rank} trained into {run_dir}, rank 0 elsewhere")
    if rank == 0:
        versions = glob.glob(os.path.join(out_dir, logs, "training-mtan", "version_*"))
        entries = sorted(os.listdir(run_dir))
        if versions != [run_dir] or [e for e in entries if e.startswith(("model_", "session_"))] \
                != ["model_0", "session_0"] or "preds.npz" not in entries:
            fail(f"{tag} cli: run dirs {versions}, entries {entries}")
    return {"argv": argv, "wall_s": cli_s, "run_dir": run_dir, "launches": cli_counts,
            "loader_lengths": {"train": n_train, "val": n_val, "predict": n_pred},
            "weights_equal_across_ranks": True, "state": seen["state"]}


def model_spec(world: int) -> str:
    """The mesh of the ``model`` phase: two ranks (sharing one card) split
    the large conv kernels' output channels; four (a card each) split the
    batch over ``data`` too."""
    return "model:2" if world == 2 else f"data:{world // 2},model:2"


def whole_tensors(state) -> list:
    """Parameters and Adam moments of a train state placed on the model
    axis, each sharded leaf gathered whole (collective over the model
    group), in parameter order."""
    from vision_mtl_tpu_torch.parallel.mesh import model_slices

    slices = model_slices(state.model)
    named = list(state.model.named_parameters())
    out = [slices[k].gather(p) if k in slices else p for k, p in named]
    for k, p in named:
        for field in ("exp_avg", "exp_avg_sq"):
            if p in state.optimizer.state:
                v = state.optimizer.state[p][field]
                out.append(slices[k].gather(v) if k in slices else v)
    return out


def split_tensors(state) -> tuple:
    """(replicated, sharded): the parameters and Adam moments of a state on
    the model axis, by whether their leaf is sharded."""
    from vision_mtl_tpu_torch.parallel.mesh import model_slices

    slices = model_slices(state.model)
    rep, shard = [], []
    for k, p in state.model.named_parameters():
        moments = [state.optimizer.state[p][f] for f in ("exp_avg", "exp_avg_sq")
                   if p in state.optimizer.state]
        (shard if k in slices else rep).extend([p, *moments])
    return rep, shard


def state_bytes(state) -> int:
    """Bytes of a state's parameters and Adam moments held on this rank."""
    return sum(t.numel() * t.element_size() for t in train_tensors(state))


def count_model_collectives(comm, fn) -> tuple:
    """``(counts, fn())``: every all-reduce of ``comm`` (the model group) in
    ``fn()`` counted by what made it, read from the call stack's qualified
    names: the copy-in's backward (the input gradient summed over the
    group), the gather-out of a sharded layer's output channels, the gather
    of a whole weight (``blocks.whole_param``: the gate's ``w1`` and ``w2``
    in ``GateChain`` and ``TaskGateChain``), and the others (where the group
    is every rank: the replicated gradients' mean). One step's worth."""
    counts: dict = {}
    real = comm.all_reduce_

    def counted(tensor, op="sum"):
        names = []
        frame = sys._getframe(1)
        while frame is not None and len(names) < 16:
            names.append(frame.f_code.co_qualname)
            frame = frame.f_back
        if "_CopyIn.backward" in names:
            kind = "copy_in"
        elif "_GatherOut.forward" in names:
            gate = any(n.endswith("GateChain.forward") for n in names)
            kind = ("gate_weight" if gate else "weight") if "whole_param" in names \
                else "gather_out"
        else:
            kind = "other"
        counts[kind] = counts.get(kind, 0) + 1
        return real(tensor, op)

    comm.all_reduce_ = counted
    try:
        return counts, fn()
    finally:
        del comm.all_reduce_


def model_gate_times(fused_gate, fused_gate_train, mesh, dev) -> dict:
    """Both gates at MTAN's 8 gate shapes on this rank's block of batch 8
    (bf16, as the main path), each ``w1`` that the layout shards (``dec0``'s
    640x128 at the default ``min_size``) gathered over the model group
    inside the call, as ``GateChain`` does: B1 (row 1m) with folded
    weights, B4 (row 4m) staged over the replica group when it has several
    ranks, else the fused call. Each against its plain version on the same
    inputs, CUDA-event ms of one forward's or one step's calls (two tasks a
    level; the gathers included), the bound of the gates' own work."""
    from vision_mtl_tpu_torch.parallel.mesh import MIN_SHARD_SIZE
    from vision_mtl_tpu_torch.parallel.multihost import gather_out

    model_comm, replicas = mesh.model_comm, mesh.replica_comm
    per = BATCH // mesh.size("data")
    gen = torch.Generator(device=dev).manual_seed(20 + mesh.rank)
    totals = {g: {"ms": 0.0, "plain_ms": 0.0, "err": 0.0, "gathered_levels": []}
              for g in ("eval", "train")}
    by_flops = by_bytes = 0.0
    for level, cin, c2, h, w in GATE_SHAPES:
        def uniform(*shape, bound=1.0):
            return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * bound

        x = torch.randn(per, h, w, cin, generator=gen, device=dev).to(torch.bfloat16)
        shared = torch.randn(per, h, w, c2, generator=gen, device=dev).to(torch.bfloat16)
        w1 = uniform(cin, HIDDEN, bound=cin**-0.5)
        rest = (uniform(HIDDEN, bound=cin**-0.5), uniform(HIDDEN) * 0.5 + 1.0,
                uniform(HIDDEN, bound=0.3), uniform(HIDDEN, c2, bound=HIDDEN**-0.5),
                uniform(c2, bound=HIDDEN**-0.5), uniform(c2) * 0.5 + 1.0, uniform(c2, bound=0.3))
        sharded = cin * HIDDEN >= MIN_SHARD_SIZE and HIDDEN % model_comm.world == 0
        part = HIDDEN // model_comm.world
        w1_part = w1[:, model_comm.rank * part:(model_comm.rank + 1) * part].contiguous()

        def whole_w1():
            return gather_out(w1_part, model_comm) if sharded else w1

        s1, c1 = fused_gate.fold_bn(rest[0], rest[1], rest[2], torch.zeros(HIDDEN, device=dev),
                                    torch.ones(HIDDEN, device=dev), 1e-5)
        s2, c2v = fused_gate.fold_bn(rest[4], rest[5], rest[6], torch.zeros(c2, device=dev),
                                     torch.ones(c2, device=dev), 1e-5)
        w2f = rest[3] * s2
        calls = {
            "eval": (lambda: fused_gate.fused_attention_gate(x, shared, whole_w1() * s1, c1,
                                                             w2f, c2v),
                     lambda: fused_gate.fused_attention_gate_plain(x, shared, whole_w1() * s1,
                                                                   c1, w2f, c2v)),
            "train": (lambda: fused_gate_train.fused_attention_gate_train(
                          x, shared, whole_w1(), *rest, comm=replicas)[0],
                      lambda: fused_gate_train.fused_attention_gate_train_plain(
                          x, shared, whole_w1(), *rest, comm=replicas)[0]),
        }
        with torch.no_grad():
            for g, (kernel, plain) in calls.items():
                err, ok = output_ok(kernel(), plain())
                if not ok:
                    fail(f"model-axis {g} gate {level} rank {mesh.rank}: max |diff| {err} from "
                         "its plain version")
                mesh.comm.barrier()
                totals[g]["ms"] += 2 * time_ms(kernel, iters=RANK_TIMED_CALLS, warmup=1)
                mesh.comm.barrier()
                totals[g]["plain_ms"] += 2 * time_ms(plain, iters=RANK_PLAIN_CALLS, warmup=1)
                totals[g]["err"] = max(totals[g]["err"], err)
                if sharded:
                    totals[g]["gathered_levels"].append(level)
        n = per * h * w
        nbytes = 2 * n * (cin + 2 * c2) + 4 * (
            cin * HIDDEN + 3 * HIDDEN + HIDDEN * c2 + 3 * c2 + 2 * (HIDDEN + c2))
        by_flops += 2 * tf32_flops(n, cin, c2, True) / TF32_TC_FLOPS_PER_S
        by_bytes += 2 * nbytes / HBM_BYTES_PER_S
    for g in totals.values():
        g["bound_ms"] = max(by_flops, by_bytes) * 1e3
        g["bound_by"] = "operations" if by_flops >= by_bytes else "bytes"
    totals["train"]["staged"] = replicas is not None
    return totals


def model_task_gate_times(fused_gate, fused_gate_train, mesh, dev) -> dict:
    """B1 and B4 over the task axis (``fold_tasks``, T = 2) at MTAN's 8 gate
    shapes on this rank's block of batch 8 (bf16, as the main path), each
    task-stacked ``w1`` (T, Cin, 128) and ``w2`` (T, 128, C2) that JAX's
    rule shards at the default ``min_size`` gathered over the model group
    inside the call, as ``TaskGateChain`` does: B1 (row 1bm) with folded
    weights, B4 (row 4bm) staged over the replica group when it has several
    ranks, else the fused call. Each against its plain version on the same
    inputs, CUDA-event ms of one folded forward's or step's 8 calls (the
    gathers included), the bound of the gates' own work (both tasks)."""
    from vision_mtl_tpu_torch.parallel.mesh import MIN_SHARD_SIZE
    from vision_mtl_tpu_torch.parallel.multihost import gather_out

    model_comm, replicas = mesh.model_comm, mesh.replica_comm
    m = model_comm.world
    per, n_tasks = BATCH // mesh.size("data"), 2
    gen = torch.Generator(device=dev).manual_seed(30 + mesh.rank)
    totals = {g: {"ms": 0.0, "plain_ms": 0.0, "err": 0.0, "gathered": []}
              for g in ("eval", "train")}
    by_flops = by_bytes = 0.0
    for level, cin, c2, h, w in GATE_SHAPES:
        args = task_gate_args(gen, dev, n_tasks, cin, c2, h, w, torch.bfloat16, True)
        x, shared = args[0][:, :per].contiguous(), args[1][:per].contiguous()
        w1, b1, sc1, bi1, w2, b2, sc2, bi2 = args[2:]

        def part(v, dim):  # this rank's slice, or the whole leaf when it is replicated
            if v.numel() < MIN_SHARD_SIZE or v.shape[-1] % m:
                return v, False
            size = v.shape[dim] // m
            return v.narrow(dim, model_comm.rank * size, size).contiguous(), True

        (w1p, w1s), (w2p, w2s) = part(w1, 2), part(w2, 2)

        def whole():
            return (gather_out(w1p, model_comm) if w1s else w1p,
                    gather_out(w2p, model_comm) if w2s else w2p)

        zeros, ones = torch.zeros_like(b1), torch.ones_like(b1)
        s1, c1 = fused_gate.fold_bn(b1, sc1, bi1, zeros, ones, 1e-5)
        s2, c2v = fused_gate.fold_bn(b2, sc2, bi2, torch.zeros_like(b2), torch.ones_like(b2),
                                     1e-5)

        def eval_call(fn):
            a, b_ = whole()
            return fn(x, shared, a * s1[:, None, :], c1, b_ * s2[:, None, :], c2v)

        def train_call(fn):
            a, b_ = whole()
            return fn(x, shared, a, b1, sc1, bi1, b_, b2, sc2, bi2, comm=replicas)[0]

        calls = {
            "eval": (lambda: eval_call(fused_gate.fused_attention_gate_tasks),
                     lambda: eval_call(fused_gate.fused_attention_gate_tasks_plain)),
            "train": (lambda: train_call(fused_gate_train.fused_attention_gate_train_tasks),
                      lambda: train_call(
                          fused_gate_train.fused_attention_gate_train_tasks_plain)),
        }
        with torch.no_grad():
            for g, (kernel, plain) in calls.items():
                err, ok = output_ok(kernel(), plain())
                if not ok:
                    fail(f"model-axis task-axis {g} gate {level} rank {mesh.rank}: max |diff| "
                         f"{err} from its plain version")
                mesh.comm.barrier()
                totals[g]["ms"] += time_ms(kernel, iters=RANK_TIMED_CALLS, warmup=1)
                mesh.comm.barrier()
                totals[g]["plain_ms"] += time_ms(plain, iters=RANK_PLAIN_CALLS, warmup=1)
                totals[g]["err"] = max(totals[g]["err"], err)
                totals[g]["gathered"] += [f"{level}.{k}" for k, on in (("w1", w1s), ("w2", w2s))
                                          if on]
        n = per * h * w
        nbytes = n_tasks * (2 * n * (cin + c2) + 4 * (cin * HIDDEN + 3 * HIDDEN + HIDDEN * c2
                                                      + 3 * c2)) + 2 * n * c2
        by_flops += n_tasks * tf32_flops(n, cin, c2, True) / TF32_TC_FLOPS_PER_S
        by_bytes += nbytes / HBM_BYTES_PER_S
    for g in totals.values():
        g["bound_ms"] = max(by_flops, by_bytes) * 1e3
        g["bound_by"] = "operations" if by_flops >= by_bytes else "bytes"
    totals["train"]["staged"] = replicas is not None
    return totals


def model_rank(comm, out_dir: str) -> dict:
    """The ``model`` phase on one rank: the mesh of :func:`model_spec` over
    the ``parallel`` phase's ranks. Per model of ``MODEL_MODELS`` (MTAN,
    basic and CSNet at 128x256, then MTAN ``fold_tasks`` and basic
    ``fold_tail``; global batch 8, default ``min_size``): the state placed
    by ``shard_state``, its parameter-and-moment bytes on this rank against
    one process's; one f32 step after :func:`release_memory` (rank 0 saves
    the gradients, gathered whole, for :func:`parallel_phase` to hold to the
    one-process step); 1 + ``MODEL_BF16_STEPS`` bf16 steps, after which
    every replicated leaf and its moments hold the same bits on every rank
    and every sharded one on the data ranks of its slice, launches counted
    per rank, the first step's model-group collectives counted by kind.
    Then ``Predictor(8, mesh=)`` of the sharded f32 MTAN, CSNet and
    folded MTAN against the one-process answers; one MTAN epoch of the
    training CLI over the mesh, whose checkpoint holds the trained state
    gathered whole, bit for bit, and whose one-process f32 ``Predictor``
    answers as the same checkpoint sharded over the mesh does; both gates
    with ``dec0``'s ``w1`` gathered (rows 1m and 4m) and both task-axis
    gates with their sharded weights gathered (rows 1bm and 4bm). Returns
    the rank's record, its main-path launches under ``launches``."""
    from vision_mtl_tpu_torch import kernels
    from vision_mtl_tpu_torch.cfg import fetch_data_cfg
    from vision_mtl_tpu_torch.kernels import fused_gate, fused_gate_train
    from vision_mtl_tpu_torch.metrics import init_metrics
    from vision_mtl_tpu_torch.models.registry import build_model
    from vision_mtl_tpu_torch.parallel.mesh import (
        create_mesh,
        full_optimizer_state_dict,
        full_state_dict,
        model_slices,
        shard_model,
        shard_state,
    )
    from vision_mtl_tpu_torch.serving import Predictor
    from vision_mtl_tpu_torch.train.checkpoint import MODEL_FILE, SESSION_FILE, restore_model
    from vision_mtl_tpu_torch.train.state import create_train_state, param_count
    from vision_mtl_tpu_torch.train.step import make_train_step

    t0 = time.perf_counter()
    cfg = fetch_data_cfg("cityscapes")
    spec = model_spec(comm.world)
    mesh = create_mesh(spec, comm)
    dev, rank = mesh.device, comm.rank
    replicas = mesh.replica_comm
    step = make_train_step(device=dev, mesh=mesh)
    out = {"mesh": spec, "coords": mesh.coords(),
           "replica_ranks": replicas.world if replicas is not None else 1}
    launches = {name: 0 for name in kernels.KERNELS}
    b4 = "fused_attention_gate_train_ranks" if replicas is not None else \
        "fused_attention_gate_train"
    b4_tasks = "fused_attention_gate_train_ranks" if replicas is not None else \
        "fused_attention_gate_train_tasks"
    per_step = {"mtan": {b4: 16, BACKWARD: 16, "confusion_matrix": 1},
                "basic": PER_TRAIN_STEP["basic"], "csnet": PER_TRAIN_STEP["csnet"],
                "mtan_fold_tasks": {b4_tasks: 8, BACKWARD: 8, "confusion_matrix": 1},
                "basic_fold_tail": PER_TRAIN_STEP["basic_fold_tail"]}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    (batch,) = train_batches(cfg, 1, BATCH, seed=PARALLEL_BATCH_SEED)
    bf16_batches = [mesh.block(b) for b in train_batches(cfg, TRAIN_BATCHES, BATCH, seed=6)]
    for name in MODEL_MODELS:
        t_case = time.perf_counter()
        per = per_step[name]
        base, options = model_variant(name)
        model = build_model(base, cfg, dtype=torch.float32, device=dev, seed=0, **options)
        state = create_train_state(model, LR, device=dev)
        one_process_bytes = 3 * 4 * param_count(state)
        state = shard_state(state, mesh)
        slices = model_slices(model)
        free = release_memory(comm)
        kernels.reset_launch_counts()
        _, _, losses = step(state, mesh.block(batch), init_metrics(cfg.num_classes, dev))
        torch.cuda.synchronize()
        f32_counts = kernels.launch_counts()
        add(f32_counts)
        if f32_counts != expected(kernels, per, 1):
            fail(f"model-axis {name} f32 step rank {rank}: launches {f32_counts}")
        grads = {k: (slices[k].gather(p.grad) if k in slices else p.grad)
                 for k, p in model.named_parameters()}
        if not same_on_every_rank(comm, list(grads.values())):
            fail(f"model-axis {name} f32 step: the gathered gradients differ between the ranks")
        if rank == 0:
            torch.save({"grads": {k: g.double().cpu() for k, g in grads.items()},
                        "loss": float(losses["loss"])},
                       os.path.join(out_dir, f"model_axis_{name}_f32_grads.pt"))
        rank_bytes = state_bytes(state)
        del model, state, grads

        model = build_model(base, cfg, dtype=torch.bfloat16, device=dev, seed=0, **options)
        state = shard_state(create_train_state(model, LR, device=dev), mesh)
        n_steps = 1 + MODEL_BF16_STEPS
        events = [torch.cuda.Event(enable_timing=True) for _ in range(n_steps + 1)]
        kernels.reset_launch_counts()
        step_losses = []
        events[0].record()
        for i in range(n_steps):
            def bf16_step():
                return step(state, bf16_batches[i % TRAIN_BATCHES],
                            init_metrics(cfg.num_classes, dev))

            if i == 0:  # the untimed step: the model group's collectives by kind
                collectives, (state, _, ls) = count_model_collectives(mesh.model_comm,
                                                                      bf16_step)
            else:
                state, _, ls = bf16_step()
            events[i + 1].record()
            step_losses.append(ls["loss"])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        add(counts)
        if counts != expected(kernels, per, n_steps):
            fail(f"model-axis {name} bf16 steps rank {rank}: launches {counts}")
        step_losses = [float(v) for v in step_losses]
        if not all(np.isfinite(step_losses)):
            fail(f"model-axis {name} bf16 steps: losses {step_losses}")
        rep, shard = split_tensors(state)
        if not same_on_every_rank(comm, rep):
            fail(f"model-axis {name} bf16 steps: replicated parameters or Adam moments differ "
                 f"between the ranks after {n_steps} steps")
        if replicas is not None and not same_on_every_rank(replicas, shard):
            fail(f"model-axis {name} bf16 steps: a slice's parameters or Adam moments differ "
                 f"between its data ranks after {n_steps} steps")
        step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(1, n_steps)]
        out[name] = {
            "sharded_leaves": len(slices),
            "bytes": {"rank": rank_bytes, "one_process": one_process_bytes,
                      "share": rank_bytes / one_process_bytes},
            "f32": {"loss": float(losses["loss"]), "launches": f32_counts, "free_bytes": free},
            "model_group_collectives_per_step": collectives,
            "bf16": {"steps": n_steps, "losses": step_losses, "step_ms": step_ms,
                     "step_ms_p50": float(np.median(step_ms)), "launches": counts,
                     "replicated_equal_across_ranks": True,
                     "sharded_equal_across_data_ranks": replicas is not None},
            "case_s": time.perf_counter() - t_case,
        }
        del model, state

    # Predictor(8) of the sharded f32 models against one process's (fold_tasks:
    # its seeded weights are the unfolded ones, so the one-process answer is
    # the same)
    imgs = train_batches(cfg, 1, BATCH, seed=PARALLEL_PREDICT_SEED)[0]["img"].numpy()
    for key, (name, options, per) in {
            "predictor": ("mtan", {}, PER_FORWARD["mtan"]),
            "predictor_csnet": ("csnet", {}, PER_FORWARD["csnet"]),
            "predictor_fold_tasks": ("mtan", {"fold_tasks": True}, PER_FORWARD["mtan_folded"]),
    }.items():
        model = shard_model(build_model(name, cfg, dtype=torch.float32, device=dev, seed=0,
                                        **options).eval(), mesh)
        kernels.reset_launch_counts()
        answer = Predictor(model, BATCH, cfg.height, cfg.width, dtype=np.uint8, mesh=mesh)(imgs)
        torch.cuda.synchronize()
        pred_counts = kernels.launch_counts()
        add(pred_counts)
        if pred_counts != expected(kernels, per, 1):
            fail(f"model-axis {key} rank {rank}: launches {pred_counts}")
        out[key] = {**held_answer(comm, answer, predictor_ref(out_dir, name, cfg.height),
                                  f"model-axis {key}"), "launches": pred_counts}
        del model

    # the training CLI over the mesh: its checkpoint is the trained state
    # gathered whole, and serves in one process as over the mesh
    cli = rank_cli(comm, out_dir, spec, "model_logs", "model-axis", per_step["mtan"],
                   whole_tensors)
    trained = cli.pop("state")
    add(cli["launches"])
    saved_model = torch.load(os.path.join(cli["run_dir"], "model_0", MODEL_FILE))
    saved_session = torch.load(os.path.join(cli["run_dir"], "session_0", SESSION_FILE))
    in_memory = full_state_dict(trained.model)
    moments = full_optimizer_state_dict(trained.optimizer, trained.model)["state"]
    if sorted(saved_model) != sorted(in_memory) or not all(
            torch.equal(saved_model[k], v) for k, v in in_memory.items()):
        fail(f"model-axis cli rank {rank}: model_0 is not the trained model gathered whole")
    if not all(torch.equal(saved_session["optimizer"]["state"][i][f], moments[i][f])
               for i in moments for f in ("exp_avg", "exp_avg_sq")):
        fail(f"model-axis cli rank {rank}: session_0's Adam moments are not the trained "
             "ones gathered whole")
    del trained
    one = build_model("mtan", cfg, dtype=torch.float32, device=dev, seed=1)
    restore_model(one, cli["run_dir"], 0)
    want = Predictor(one.eval(), BATCH, cfg.height, cfg.width, dtype=np.uint8, device=dev)(imgs)
    sharded = build_model("mtan", cfg, dtype=torch.float32, device=dev, seed=1)
    restore_model(shard_model(sharded, mesh), cli["run_dir"], 0)
    kernels.reset_launch_counts()
    got = Predictor(sharded.eval(), BATCH, cfg.height, cfg.width, dtype=np.uint8, mesh=mesh)(imgs)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    cli["checkpoint"] = {"holds_the_trained_state_bit_for_bit": True,
                         "one_process_predictor": held_answer(comm, got, want,
                                                            "model-axis checkpoint Predictor")}
    out["cli"] = cli
    del one, sharded
    out["gates_dec0_w1_gathered"] = model_gate_times(fused_gate, fused_gate_train, mesh, dev)
    out["task_gates_weights_gathered"] = model_task_gate_times(fused_gate, fused_gate_train,
                                                               mesh, dev)
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t0
    return out


def parallel_rank(out_dir: str, phases=PARALLEL_PHASES) -> int:
    """One rank of the rank phases (started by :func:`parallel_phase` with
    torchrun's environment): joins the process group
    (``maybe_initialize_distributed``: gloo when the ranks share the one
    card, NCCL with a card each) and runs ``phases`` in order: ``parallel``
    (:func:`data_rank`), ``spatial`` (:func:`spatial_rank`), ``model``
    (:func:`model_rank`), ``spatial4`` (:func:`spatial4_rank`, four ranks);
    writes ``rank_{r}.json`` into ``out_dir`` and, on rank 0, the f32
    steps' gradients."""
    import torch.distributed as dist
    from vision_mtl_tpu_torch.parallel import multihost

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    multihost.maybe_initialize_distributed("cuda")
    comm = multihost.current()
    rec = {"rank": comm.rank, "world": comm.world, "device": str(comm.device),
           "backend": dist.get_backend(), "init_s": time.perf_counter() - t_start}
    if "parallel" in phases:
        rec.update(data_rank(comm, out_dir))
    if "spatial" in phases:
        rec["spatial"] = spatial_rank(comm, out_dir)
    if "model" in phases:
        rec["model_axis"] = model_rank(comm, out_dir)
    if "spatial4" in phases:
        rec["spatial4"] = spatial4_rank(comm, out_dir)
    rec["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"rank_{comm.rank}.json"), "w") as f:
        json.dump(rec, f)
    multihost.shutdown_distributed()
    return 0


def data_rank(comm, out_dir: str) -> dict:
    """The ``parallel`` phase on one rank: ``data:<ranks>``, MTAN at full
    width on this rank's rows of each global batch (an f32 step, bf16 steps,
    B4's staged call, ``Predictor(8, mesh=)``, the CLI). Returns the rank's
    record."""
    from vision_mtl_tpu_torch import kernels
    from vision_mtl_tpu_torch.cfg import fetch_data_cfg
    from vision_mtl_tpu_torch.kernels import fused_gate_train
    from vision_mtl_tpu_torch.metrics import init_metrics
    from vision_mtl_tpu_torch.models.registry import build_model
    from vision_mtl_tpu_torch.parallel.mesh import create_mesh
    from vision_mtl_tpu_torch.serving import Predictor
    from vision_mtl_tpu_torch.train.state import create_train_state
    from vision_mtl_tpu_torch.train.step import make_train_step

    mesh = create_mesh("data:-1", comm)
    dev, rank = mesh.device, comm.rank
    rec: dict = {}
    cfg = fetch_data_cfg("cityscapes")
    per = BATCH // comm.world

    def mine(batch: dict) -> dict:
        return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}

    # one f32 step on this rank's rows of the reference batch
    (batch,) = train_batches(cfg, 1, BATCH, seed=PARALLEL_BATCH_SEED)
    model = build_model("mtan", cfg, dtype=torch.float32, device=dev, seed=0)
    state = create_train_state(model, LR, device=dev)
    step = make_train_step(device=dev, mesh=mesh)
    free = release_memory(comm)
    kernels.reset_launch_counts()
    _, _, losses = step(state, mine(batch), init_metrics(cfg.num_classes, dev))
    torch.cuda.synchronize()
    f32_counts = kernels.launch_counts()
    if f32_counts != expected(kernels, PER_RANK_TRAIN_STEP, 1):
        fail(f"parallel f32 step rank {rank}: launches {f32_counts}")
    if not same_on_every_rank(comm, [p.grad for p in model.parameters()]):
        fail("parallel f32 step: the all-reduced gradients differ between the ranks")
    if rank == 0:
        torch.save({"grads": {k: p.grad.double().cpu() for k, p in model.named_parameters()},
                    "loss": float(losses["loss"])}, os.path.join(out_dir, "f32_grads.pt"))
    rec["f32"] = {"loss": float(losses["loss"]), "launches": f32_counts,
                  "grads_equal_across_ranks": True, "free_bytes": free}
    del model, state

    # bf16 steps: every rank's parameters and Adam moments stay the same bits
    batches = [mine(b) for b in train_batches(cfg, TRAIN_BATCHES, BATCH, seed=6)]
    model = build_model("mtan", cfg, dtype=torch.bfloat16, device=dev, seed=0)
    state = create_train_state(model, LR, device=dev)
    n_steps = 1 + PARALLEL_BF16_STEPS
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_steps + 1)]
    kernels.reset_launch_counts()
    losses = []
    events[0].record()
    for i in range(n_steps):
        state, _, step_losses = step(state, batches[i % TRAIN_BATCHES],
                                     init_metrics(cfg.num_classes, dev))
        events[i + 1].record()
        losses.append(step_losses["loss"])
    torch.cuda.synchronize()
    bf16_counts = kernels.launch_counts()
    if bf16_counts != expected(kernels, PER_RANK_TRAIN_STEP, n_steps):
        fail(f"parallel bf16 steps rank {rank}: launches {bf16_counts}")
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        fail(f"parallel bf16 steps: losses {losses}")
    if not same_on_every_rank(comm, train_tensors(state)):
        fail(f"parallel bf16 steps: parameters or Adam moments differ between the ranks after "
             f"{n_steps} steps")
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(1, n_steps)]
    rec["bf16"] = {"steps": n_steps, "losses": losses, "step_ms": step_ms,
                   "step_ms_p50": float(np.median(step_ms)), "launches": bf16_counts,
                   "params_and_moments_equal_across_ranks": True}
    del model, state, batches

    gate_rows, gate_totals = rank_gate_times(fused_gate_train, comm, dev)
    rec["gate_train_staged"] = {"rows": gate_rows, **gate_totals}

    # Predictor(8) over the ranks against the one-process Predictor(8)
    imgs = train_batches(cfg, 1, BATCH, seed=PARALLEL_PREDICT_SEED)[0]["img"].numpy()
    model = build_model("mtan", cfg, dtype=torch.float32, device=dev, seed=0).eval()
    kernels.reset_launch_counts()
    out = Predictor(model, BATCH, cfg.height, cfg.width, dtype=np.uint8, mesh=mesh)(imgs)
    torch.cuda.synchronize()
    pred_counts = kernels.launch_counts()
    if pred_counts != expected(kernels, PER_FORWARD["mtan"], 1):
        fail(f"parallel Predictor rank {rank}: launches {pred_counts}")
    rec["predictor"] = {**held_answer(comm, out, predictor_ref(out_dir, "mtan", cfg.height),
                                      "parallel Predictor"), "launches": pred_counts}
    del model

    # the training CLI, in process, over the ranks
    rec["cli"] = rank_cli(comm, out_dir, f"data:{comm.world}", "logs", "parallel")
    rec["cli"].pop("state")
    return rec


def parallel_phase(cfg, kernels, dev, build_model, f32_limits: dict,
                   one_process_p50: dict, phases: tuple = PARALLEL_PHASES) -> tuple:
    """The rank phases: the one-process references first (the f32 step of
    every model and height the phases train, on the global batch; the
    ``Predictor(8)`` answer of each model's seeded f32 weights at each
    height), then the rank processes (:func:`parallel_rank`) with
    torchrun's environment, which run ``phases`` in order: ``parallel``
    (the data axis), ``spatial``, ``model`` and ``spatial4``, over
    :func:`parallel_world` ranks, a phase of ``PHASE_WORLD`` over its own
    number (on one card a second launch after the first). Before each
    launch this process gives its cached device memory back
    (``torch.cuda.empty_cache``), so that the ranks' cuDNN finds the
    workspace of its first choice of algorithm as the one-process steps
    did. Each phase's f32 steps are held to the one-process step with the
    limits of the f32 check against the CPU (``f32_limits``: per-leaf and
    whole relative L2, ``ZERO_GRAD`` left out; ``f32_limits`` and
    ``one_process_p50`` by model), the ``model`` phase's with no data axis
    to ``MODEL_AXIS_F32_LIMITS``. Returns ``(lines, launches)``: each
    phase's JSON line and its ranks' main-path launches summed, keyed by
    the line's name (``parallel``, ``spatial``, ``model_axis``,
    ``spatial4``)."""
    from vision_mtl_tpu_torch.metrics import init_metrics
    from vision_mtl_tpu_torch.parallel.multihost import free_port
    from vision_mtl_tpu_torch.serving import Predictor
    from vision_mtl_tpu_torch.train.state import create_train_state
    from vision_mtl_tpu_torch.train.step import make_train_step

    t_start = time.perf_counter()
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    os.makedirs(PARALLEL_DIR)
    if not os.path.isdir(os.path.join(CLI_DATA, "train")):
        write_cityscapes_tree(CLI_DATA, cfg)
    (batch,) = train_batches(cfg, 1, BATCH, seed=PARALLEL_BATCH_SEED)
    # case -> (model, the batch's first rows) of every f32 step the phases hold
    cases = {**{name: (name, cfg.height) for name in SPATIAL_MODELS + MODEL_MODELS},
             **SPATIAL_UNEVEN, **{f"spatial4_{c}": v for c, v in SPATIAL4_CASES.items()}}
    steps: dict = {}
    for name, rows in dict.fromkeys(cases.values()):
        base, options = model_variant(name)
        model = build_model(base, cfg, dtype=torch.float32, device=dev, seed=0, **options)
        state = create_train_state(model, LR, device=dev)
        _, _, losses = make_train_step(device=dev)(state, first_rows(batch, rows),
                                                   init_metrics(cfg.num_classes, dev))
        steps[name, rows] = ({k: p.grad.double().cpu() for k, p in model.named_parameters()},
                             float(losses["loss"]))
        del model, state
    # the seeded weights as built, as each rank builds them
    imgs = train_batches(cfg, 1, BATCH, seed=PARALLEL_PREDICT_SEED)[0]["img"].numpy()
    for name, rows in dict.fromkeys(v for v in cases.values() if "_" not in v[0]):
        model = build_model(name, cfg, dtype=torch.float32, device=dev, seed=0).eval()
        ref_pred = Predictor(model, BATCH, rows, cfg.width, dtype=np.uint8, device=dev)(
            np.ascontiguousarray(imgs[:, :rows]))
        np.savez(os.path.join(PARALLEL_DIR, f"predictor_ref_{name}_{rows}.npz"), **ref_pred)
        del model
    ref_s = time.perf_counter() - t_start

    released: dict = {}

    def launch(world: int, group: list) -> list:
        torch.cuda.synchronize()
        released[world] = torch.cuda.memory_reserved()
        torch.cuda.empty_cache()  # the ranks' cuDNN picks as this process did
        port, procs = free_port(), []
        for r in range(world):
            env = {**os.environ, "RANK": str(r), "LOCAL_RANK": str(r),
                   "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
                   "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
            log = open(os.path.join(PARALLEL_DIR, f"rank_{r}_of_{world}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", PARALLEL_CODE, PARALLEL_DIR, *group], env=env,
                stdout=log, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__))), log))
        deadline = time.monotonic() + PARALLEL_TIMEOUT_S
        try:
            while any(p.poll() is None for p, _ in procs) and time.monotonic() < deadline:
                if any(p.poll() not in (None, 0) for p, _ in procs):
                    deadline = min(deadline, time.monotonic() + 30)  # the peer may be stuck
                time.sleep(0.2)
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
                log.close()
        codes = [p.returncode for p, _ in procs]
        if any(codes):
            tails = [open(os.path.join(PARALLEL_DIR, f"rank_{r}_of_{world}.log")).read()[-2500:]
                     for r in range(world)]
            fail(f"parallel: {group} ranks exited {codes}: {tails}")
        return [json.load(open(os.path.join(PARALLEL_DIR, f"rank_{r}.json")))
                for r in range(world)]

    world = parallel_world()
    worlds = {phase: PHASE_WORLD.get(phase, world) for phase in phases}
    recs_of: dict = {}
    for n in dict.fromkeys(worlds.values()):
        group = [phase for phase in phases if worlds[phase] == n]
        recs_of.update(dict.fromkeys(group, launch(n, group)))

    def held(tag: str, path: str, case: str, limits: dict = None) -> dict:
        got = torch.load(os.path.join(PARALLEL_DIR, path))
        want_grads, want_loss = refs_of(case)
        limits = limits or f32_limits[cases[case][0].partition("_")[0]]

        def tasked(grads):  # fold_tasks' leaves under ZERO_GRAD's per-task names
            return {k.replace("_folded.", "_task0."): v for k, v in grads.items()}

        whole, per_leaf = grad_distance(tasked(got["grads"]), tasked(want_grads))
        worst = sorted(per_leaf.items(), key=lambda kv: -kv[1])[:3]
        if not whole <= limits["rel_l2_limit"] or not worst[0][1] <= limits["leaf_limit"]:
            fail(f"{tag} f32 step: gradients off the one-process step by {whole} (worst "
                 f"leaves {worst}), limits {limits}")
        if abs(got["loss"] - want_loss) > 1e-4 * abs(want_loss):
            fail(f"{tag} f32 step: loss {got['loss']} over the ranks, {want_loss} in one process")
        return {"loss_ranks": got["loss"], "loss_one_process": want_loss, "grad_rel_l2": whole,
                "worst_leaves": worst, "limits": limits}

    def refs_of(case: str) -> tuple:
        return steps[cases[case]]

    def bf16_line(recs_: list, rec: dict) -> dict:
        return {"steps": rec["bf16"]["steps"], "losses": rec["bf16"]["losses"],
                "step_ms_p50_ranks": [r["bf16"]["step_ms_p50"] for r in recs_],
                "launches_per_rank": rec["bf16"]["launches"],
                "params_and_moments_equal_across_ranks": True}

    lines: dict = {}
    launches: dict = {}
    if "parallel" in phases:
        recs = recs_of["parallel"]
        f32_step = held("parallel", "f32_grads.pt", "mtan")
        launches["parallel"] = {name: sum(rec[path]["launches"][name] for rec in recs
                                          for path in ("f32", "bf16", "predictor", "cli"))
                                for name in kernels.KERNELS}
        gate = recs[0]["gate_train_staged"]
        lines["parallel"] = {
            "ranks": world, "backend": recs[0]["backend"],
            "arrangement": (f"{world} ranks, one a card" if world <= torch.cuda.device_count()
                            else f"{world} ranks sharing one card (not a scaling figure)"),
            "f32_step": {**f32_step, "launches_per_rank": recs[0]["f32"]["launches"]},
            "bf16_steps": {"steps": recs[0]["bf16"]["steps"],
                           "step_ms_p50_two_ranks": [r["bf16"]["step_ms_p50"] for r in recs],
                           "step_ms_p50_one_process": one_process_p50["mtan"],
                           "losses": recs[0]["bf16"]["losses"],
                           "params_and_moments_equal_across_ranks": True},
            "gate_train_staged_per_step": {k: gate[k] for k in ("ms", "plain_ms", "bound_ms",
                                                                  "bound_by", "err")},
            "gate_train_staged_rows": gate["rows"],
            "predictor": recs[0]["predictor"],
            "cli": {k: recs[0]["cli"][k]
                    for k in ("argv", "wall_s", "run_dir", "loader_lengths")},
            "rank_init_s": [r["init_s"] for r in recs],
            "rank_total_s": [r["total_s"] for r in recs],
            "references_s": ref_s, "parent_bytes_released_before_launch": released,
            "launches": launches["parallel"],
            "phase_s": time.perf_counter() - t_start,
        }
    if "spatial" in phases:
        recs = recs_of["spatial"]
        launches["spatial"] = {name: sum(rec["spatial"]["launches"][name] for rec in recs)
                               for name in kernels.KERNELS}
        sp = [rec["spatial"] for rec in recs]
        lines["spatial"] = {
            "mesh": sp[0]["mesh"], "ranks": len(recs), "backend": recs[0]["backend"],
            "blocks": [r["block"] for r in sp],
            **{name: {
                "f32_step": {**held(f"spatial {name}", f"spatial_{name}_f32_grads.pt", name),
                             "launches_per_rank": sp[0][name]["f32"]["launches"]},
                "all_reduces_per_step": sp[0][name]["all_reduces_per_step"],
                "bf16_steps": {**bf16_line([r[name] for r in sp], sp[0][name]),
                               "step_ms_p50_one_process": one_process_p50[name]},
                "predictor_per_rank": [r[name]["predictor"] for r in sp],
                **({"conv3x3_small_row_blocks_per_step": sp[0][name]["conv3x3_small_row_blocks"]}
                   if "conv3x3_small_row_blocks" in sp[0][name] else {}),
                "case_s_per_rank": [r[name]["case_s"] for r in sp],
            } for name in SPATIAL_MODELS},
            "gate_train_staged_per_step": {k: sp[0]["gate_train_staged"][k] for k in
                                           ("ms", "plain_ms", "bound_ms", "bound_by", "err")},
            "levels_that_do_not_split": {case: {
                **{k: sp[0][case][k] for k in ("height", "rows_per_rank", "whole_levels",
                                               "all_reduces_per_step")},
                "f32_step": {**held(f"spatial {case}", f"spatial_{case}_f32_grads.pt", case),
                             "launches_per_rank": sp[0][case]["f32"]["launches"]},
                "bf16_steps": bf16_line([r[case] for r in sp], sp[0][case]),
                "predictor_per_rank": [r[case]["predictor"] for r in sp],
                **{k: sp[0][case][k] for k in ("conv3x3_small_row_blocks", "gate_train_staged")
                   if k in sp[0][case]},
                "case_s_per_rank": [r[case]["case_s"] for r in sp],
            } for case in SPATIAL_UNEVEN},
            "cli": {k: sp[0]["cli"][k] for k in ("argv", "wall_s", "run_dir", "loader_lengths")},
            "launches": launches["spatial"],
            "rank_phase_s": [r["phase_s"] for r in sp],
        }
    if "model" in phases:
        recs = recs_of["model"]
        mx = [rec["model_axis"] for rec in recs]
        launches["model_axis"] = {name: sum(r["launches"][name] for r in mx)
                                  for name in kernels.KERNELS}
        for r in mx:
            for name in MODEL_MODELS:
                share = r[name]["bytes"]["share"]
                if not abs(share - MODEL_BYTE_SHARES[name]) <= 1e-3:
                    fail(f"model-axis {name}: a rank holds {share} of one process's parameter "
                         f"and moment bytes, not {MODEL_BYTE_SHARES[name]}")
        # with no data axis no statistic is combined: the tight limits
        limits = MODEL_AXIS_F32_LIMITS if mx[0]["replica_ranks"] == 1 else None
        lines["model_axis"] = {
            "mesh": mx[0]["mesh"], "ranks": len(recs), "backend": recs[0]["backend"],
            "replica_ranks": mx[0]["replica_ranks"],
            **{name: {
                "sharded_leaves": mx[0][name]["sharded_leaves"],
                "bytes_per_rank": [r[name]["bytes"] for r in mx],
                "bytes_share_expected": MODEL_BYTE_SHARES[name],
                "f32_step": {**held(f"model-axis {name}", f"model_axis_{name}_f32_grads.pt",
                                    name, limits),
                             "launches_per_rank": mx[0][name]["f32"]["launches"]},
                "model_group_collectives_per_step":
                    mx[0][name]["model_group_collectives_per_step"],
                "bf16_steps": {**bf16_line([r[name] for r in mx], mx[0][name]),
                               "step_ms_p50_one_process": one_process_p50.get(name),
                               "sharded_equal_across_data_ranks":
                                   mx[0][name]["bf16"]["sharded_equal_across_data_ranks"]},
                "case_s_per_rank": [r[name]["case_s"] for r in mx],
            } for name in MODEL_MODELS},
            **{k: mx[0][k] for k in ("predictor", "predictor_csnet", "predictor_fold_tasks")},
            "cli": {k: mx[0]["cli"][k] for k in ("argv", "wall_s", "run_dir", "loader_lengths",
                                                  "checkpoint")},
            "gates_dec0_w1_gathered": mx[0]["gates_dec0_w1_gathered"],
            "task_gates_weights_gathered": mx[0]["task_gates_weights_gathered"],
            "launches": launches["model_axis"],
            "rank_phase_s": [r["phase_s"] for r in mx],
        }
    if "spatial4" in phases:
        recs = recs_of["spatial4"]
        s4 = [rec["spatial4"] for rec in recs]
        launches["spatial4"] = {name: sum(r["launches"][name] for r in s4)
                                for name in kernels.KERNELS}
        lines["spatial4"] = {
            "mesh": s4[0]["mesh"], "ranks": len(recs), "backend": recs[0]["backend"],
            "arrangement": (f"{len(recs)} ranks, one a card"
                            if len(recs) <= torch.cuda.device_count()
                            else f"{len(recs)} ranks sharing one card (not a scaling figure)"),
            **{case: {
                **{k: s4[0][case][k] for k in ("height", "rows_per_rank", "whole_levels",
                                               "gates_per_step", "all_reduces_per_step")},
                "f32_step": {**held(f"spatial4 {case}", f"spatial4_{case}_f32_grads.pt",
                                    f"spatial4_{case}"),
                             "launches_per_rank": s4[0][case]["f32"]["launches"]},
                "bf16_steps": {**bf16_line([r[case] for r in s4], s4[0][case]),
                               "step_ms_p50_one_process": one_process_p50["mtan"]},
                "predictor_per_rank": [r[case]["predictor"] for r in s4],
                **{k: s4[0][case][k] for k in ("gates_on_the_whole_level",)
                   if k in s4[0][case]},
                "case_s_per_rank": [r[case]["case_s"] for r in s4],
            } for case in SPATIAL4_CASES},
            "launches": launches["spatial4"],
            "rank_phase_s": [r["phase_s"] for r in s4],
            "rank_init_s": [r["init_s"] for r in recs],
        }
    return lines, launches


def main(argv: list) -> int:
    kernels_only = argv == ["--kernels"]
    parallel_only = argv[:1] == ["--parallel"]
    rank_phases = tuple(argv[1:]) or PARALLEL_PHASES
    if argv and not (kernels_only or parallel_only) or \
            not set(rank_phases) <= set(PARALLEL_PHASES):
        print(f"chip_smoke: unknown arguments {argv}; takes none, --kernels or --parallel "
              f"[{' '.join(PARALLEL_PHASES)}]", file=sys.stderr)
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

    # the CUDA kernels (one nvcc per source) and the native decoders (g++)
    # build side by side, before anything is timed
    from vision_mtl_tpu_torch.data import native

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native_build = pool.submit(native.build)
        kernels.build_all()
        native_build.result()
    build_s = time.perf_counter() - t0

    cfg = fetch_data_cfg("cityscapes")
    if parallel_only:
        limits, p50 = {}, {}
        for name in ("mtan", "basic", "csnet"):
            f32 = check_train_step_against_cpu(name, cfg, build_model, dev)
            limits[name] = {k: f32[k] for k in ("rel_l2_limit", "leaf_limit")}
            p50[name] = train_model(name, cfg, build_model, dev, kernels)["step_ms_p50"]
        lines, _ = parallel_phase(cfg, kernels, dev, build_model, limits, p50, rank_phases)
        for name, line in lines.items():
            print(json.dumps({name: line}), flush=True)
        print(smi, flush=True)
        return 0
    gate_rows, gate = check_gate(dev, fused_gate)
    print(json.dumps({"gate_shapes": gate_rows}), flush=True)
    # seconds since the start at which each phase ended (the timing line)
    done_at = {"build": build_s}

    def done(phase: str) -> None:
        done_at[phase] = time.perf_counter() - t_start

    if kernels_only:
        model = build_model("mtan", cfg, dtype=torch.bfloat16, device=dev, seed=0)
        main_ids = predict_eval("mtan", model, cfg, dev, kernels).pop("confmat_inputs")
        mixes = check_confmat(confmat, cfg.num_classes, confmat_mixes(dev, cfg.num_classes, main_ids))
        print(json.dumps({"gate_per_forward": gate, "confmat_mixes": mixes}), flush=True)
        print(smi, flush=True)
        return 0
    gate_train_rows, gate_train = check_gate_train(dev, fused_gate_train, split=True)
    print(json.dumps({"gate_train_shapes": gate_train_rows}), flush=True)
    conv_rows, conv = check_small_conv(dev, small_conv, SMALL_CONV_SHAPES["basic"])
    print(json.dumps({"small_conv_shapes": conv_rows}), flush=True)
    print(json.dumps({"small_conv_per_train_step": conv}), flush=True)
    cs_conv_rows, cs_conv = check_small_conv(dev, small_conv, SMALL_CONV_SHAPES["csnet"])
    print(json.dumps({"small_conv_shapes_csnet": cs_conv_rows}), flush=True)
    print(json.dumps({"small_conv_per_train_step_csnet": cs_conv}), flush=True)
    # the same kernels at NYUv2's shapes: MTAN's gates at 256x256, batch 8;
    # basic's convs at 256x256, batch 4
    nyu_gate_rows, nyu_gate = check_gate(dev, fused_gate, GATE_SHAPES_NYU)
    print(json.dumps({"gate_shapes_nyuv2": nyu_gate_rows}), flush=True)
    nyu_gate_train_rows, nyu_gate_train = check_gate_train(dev, fused_gate_train, GATE_SHAPES_NYU)
    print(json.dumps({"gate_train_shapes_nyuv2": nyu_gate_train_rows}), flush=True)
    nyu_conv_rows, nyu_conv = check_small_conv(dev, small_conv, SMALL_CONV_SHAPES["basic_nyuv2"],
                                               batch=4)
    print(json.dumps({"small_conv_shapes_nyuv2": nyu_conv_rows}), flush=True)
    nyu_cs_conv_rows, nyu_cs_conv = check_small_conv(
        dev, small_conv, SMALL_CONV_SHAPES["csnet_nyuv2"], batch=4)
    print(json.dumps({"small_conv_shapes_csnet_nyuv2": nyu_cs_conv_rows}), flush=True)
    print(json.dumps({"nyuv2_kernels_per_call": {
        "gate_per_forward": nyu_gate, "gate_train_per_step": nyu_gate_train,
        "small_conv_per_basic_step": nyu_conv, "small_conv_per_csnet_step": nyu_cs_conv}}),
        flush=True)
    done("kernels")

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
    model = build_model("csnet", cfg, dtype=torch.bfloat16, device=dev, seed=0)
    csnet_params = sum(p.numel() for p in model.parameters())
    csnet_timing = time_predictor("csnet", model, cfg, dev, kernels)
    csnet_eval = predict_eval("csnet", model, cfg, dev, kernels)
    csnet_eval.pop("confmat_inputs")
    del model
    csnet_training = train_model("csnet", cfg, build_model, dev, kernels)
    done("models")
    cli_lines, cli_launches, cli_run_dirs = cli_phase(cfg, kernels, dev, {
        "mtan": mtan_training["img_per_s"], "basic": basic_training["img_per_s"],
        "csnet": csnet_training["img_per_s"],
    })
    done("cli")
    surface_line, surface_launches = surface_phase(cfg, kernels, dev, cli_run_dirs)
    print(json.dumps({"surface": surface_line}), flush=True)
    done("surface")
    nyu_line, nyu_launches, nyu_ids = nyuv2_phase(
        kernels, dev, build_model, {k: cli_run_dirs[k] for k in ("mtan", "basic")})
    done("nyuv2")
    interop_line, interop_launches = interop_phase(cfg, kernels, dev, build_model, fused_gate)
    done("interop")
    options_line, task_gates, options_launches = options_phase(
        cfg, kernels, dev, build_model, fused_gate, fused_gate_train)
    done("options")
    phases = cli_launches + [surface_launches] + nyu_launches + interop_launches + options_launches + [
        # every main-path run's launches
        serving["launches"], mtan_timing["launches"], mtan_eval["launches"],
        mtan_training["launches"], mtan_training["eval_step"]["launches"],
        basic_timing["launches"], basic_eval["launches"],
        basic_training["launches"], basic_training["eval_step"]["launches"],
        csnet_timing["launches"], csnet_eval["launches"],
        csnet_training["launches"], csnet_training["eval_step"]["launches"],
    ]
    timed_s = time.perf_counter() - t_start
    cmat_mixes = check_confmat(confmat, cfg.num_classes, confmat_mixes(dev, cfg.num_classes, main_ids))
    print(json.dumps({"confmat_mixes": cmat_mixes}), flush=True)
    for name, mix in cmat_mixes.items():
        if len(mix["kernels_per_call"]) != 1 or "confmat_kernel" not in mix["kernels_per_call"][0]:
            fail(f"confusion_matrix {name}: a call ran {mix['kernels_per_call']}, want one kernel")
    cmat = {**cmat_mixes["main_path"],
            "max_abs_err": max(m["max_abs_err"] for m in cmat_mixes.values())}
    nyu_classes = fetch_data_cfg("nyuv2").num_classes
    nyu_mixes = check_confmat(confmat, nyu_classes,
                              confmat_mixes(dev, nyu_classes, nyu_ids, shape=tuple(nyu_ids[0].shape)))
    print(json.dumps({"confmat_mixes_nyuv2": nyu_mixes}), flush=True)
    done("confmat")

    model_line = {
        "model": "mtan", "config": "cityscapes 128x256, 19 classes, bf16", "params": mtan_params,
        "reference_f32_vs_cpu": check_model_against_cpu("mtan", cfg, build_model, dev),
        "serving": serving, "predictor_8": mtan_timing, "predict_eval": mtan_eval,
        "gate_per_forward": {k: v for k, v in gate.items() if k != "err"},
        "gate_share_of_forward_events": gate["ms"] / mtan_timing["forward_events_ms"],
        "build_s": build_s,
    }
    print(json.dumps({"model": model_line}), flush=True)
    mtan_f32 = check_train_step_against_cpu("mtan", cfg, build_model, dev)
    train_line = {
        "model": "mtan", "config": "cityscapes 128x256, 19 classes, bf16, batch 8, Adam lr 1e-3",
        "reference_f32_step_vs_cpu": mtan_f32,
        **mtan_training,
        "gate_train_ms_per_step": gate_train["ms"],
        "gate_train_bound_ms_per_step": gate_train["bound_ms"],
        "gate_train_bound_f32_ms_per_step": gate_train["bound_f32_ms"],
        "gate_train_bound_design_ms_per_step": gate_train["bound_design_ms"],
        "gate_train_levels_slower_than_plain": gate_train["slower_than_plain"],
        "gate_train_backward_ms_per_step": gate_train["backward_ms"],
        "gate_train_backward_plain_ms_per_step": gate_train["backward_plain_ms"],
        "gate_train_backward_bound_ms_per_step": gate_train["backward_bound_ms"],
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
    basic_f32 = check_train_step_against_cpu("basic", cfg, build_model, dev)
    train_line = {
        "model": "basic", "config": "cityscapes 128x256, 19 classes, bf16, batch 8, Adam lr 1e-3",
        "reference_f32_step_vs_cpu": basic_f32,
        **basic_training,
        "small_conv_ms_per_step": conv["ms"], "small_conv_bound_ms_per_step": conv["bound_ms"],
        "small_conv_share_of_step_events": conv["ms"] / basic_training["step_ms_p50"],
    }
    print(json.dumps({"train": train_line}), flush=True)
    model_line = {
        "model": "csnet", "config": "cityscapes 128x256, 19 classes, bf16", "params": csnet_params,
        "reference_f32_vs_cpu": check_model_against_cpu("csnet", cfg, build_model, dev),
        "predictor_8": csnet_timing, "predict_eval": csnet_eval,
        "small_conv_fwd_share_of_forward_events":
            cs_conv["fwd_ms"] / csnet_timing["forward_events_ms"],
    }
    print(json.dumps({"model": model_line}), flush=True)
    csnet_f32 = check_train_step_against_cpu("csnet", cfg, build_model, dev)
    train_line = {
        "model": "csnet", "config": "cityscapes 128x256, 19 classes, bf16, batch 8, Adam lr 1e-3",
        "reference_f32_step_vs_cpu": csnet_f32,
        **csnet_training,
        "small_conv_ms_per_step": cs_conv["ms"],
        "small_conv_bound_ms_per_step": cs_conv["bound_ms"],
        "small_conv_share_of_step_events": cs_conv["ms"] / csnet_training["step_ms_p50"],
        "timed_paths_s": timed_s, "total_s": time.perf_counter() - t_start,
    }
    print(json.dumps({"train": train_line}), flush=True)
    done("f32_checks")
    for line in cli_lines:
        print(json.dumps({"cli": line}), flush=True)
    print(json.dumps({"nyuv2": nyu_line}), flush=True)
    print(json.dumps({"interop": interop_line}), flush=True)
    print(json.dumps({"options": options_line}), flush=True)
    # last: the rank processes use the card after every profiled phase
    lines, rank_launches = parallel_phase(
        cfg, kernels, dev, build_model,
        {name: {k: f32[k] for k in ("rel_l2_limit", "leaf_limit")}
         for name, f32 in (("mtan", mtan_f32), ("basic", basic_f32), ("csnet", csnet_f32))},
        {"mtan": mtan_training["step_ms_p50"], "basic": basic_training["step_ms_p50"],
         "csnet": csnet_training["step_ms_p50"]})
    for name, line in lines.items():
        print(json.dumps({name: line}), flush=True)
    done("rank_phases")
    phases += list(rank_launches.values())
    parallel_line = lines["parallel"]

    launches = {name: sum(p[name] for p in phases) for name in kernels.KERNELS}
    # B3's entry: one bf16 train step of the basic model and one of CSNet
    conv_both = {
        "max_abs_err": max(conv["err"], cs_conv["err"]),
        **{k: conv[k] + cs_conv[k] for k in ("ms", "plain_ms", "library_ms")},
    }
    conv_both["bound_ms"], conv_both["bound_by"] = bound(
        conv["bytes"] + cs_conv["bytes"], conv["flops"] + cs_conv["flops"], BF16_TC_FLOPS_PER_S
    )
    nyu_cmat = {**nyu_mixes["main_path"],
                "err": max(m["max_abs_err"] for m in nyu_mixes.values())}

    def at_nyuv2(totals: dict) -> dict:
        # each kernel's numbers at NYUv2's shapes: per MTAN forward or train
        # step at 256x256 and batch 8, per basic train step at batch 4, and
        # on the ids of basic's last NYUv2 predict step
        return {"ms": totals["ms"], "plain_ms": totals["plain_ms"],
                "bound_ms": totals["bound_ms"], "bound_by": totals["bound_by"],
                "library_ms": totals.get("library_ms"), "max_abs_err": totals["err"]}

    nyu_entries = {"fused_attention_gate": at_nyuv2(nyu_gate),
                   "fused_attention_gate_train": at_nyuv2(nyu_gate_train),
                   "confusion_matrix": at_nyuv2(nyu_cmat),
                   "conv3x3_small": at_nyuv2(nyu_conv)}
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
        # its backward, per MTAN train step: the 8 levels' bf16 calls, twice
        {
            "name": "fused_attention_gate_train_backward", "route": "cuda",
            "source": "vision_mtl_tpu_torch/csrc/gate_train_backward.cu",
            "replaces": "no TPU kernel (XLA differentiates fused_gate.py:240,279)",
            "launches": launches["fused_attention_gate_train_backward"],
            "ms": gate_train["backward_ms"], "plain_ms": gate_train["backward_plain_ms"],
            "bound_ms": gate_train["backward_bound_ms"], "bound_by": "operations",
            "library_ms": None,
        },
        # the task axis (fold_tasks): per MTAN forward and train step, the
        # 8 levels' bf16 calls at T = 2
        {
            "name": "fused_attention_gate_tasks", "route": "cuda",
            "source": "vision_mtl_tpu_torch/csrc/fused_gate.cu",
            "replaces": "vision_mtl_tpu/ops/pallas/fused_gate.py:103",
            "launches": launches["fused_attention_gate_tasks"],
            "max_abs_err": task_gates["fused_attention_gate_tasks"]["err"],
            **{k: task_gates["fused_attention_gate_tasks"][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by", "per_task_calls_ms")},
            "library_ms": None,
        },
        {
            "name": "fused_attention_gate_train_tasks", "route": "cuda",
            "source": "vision_mtl_tpu_torch/csrc/gate_train.cu",
            "replaces": "vision_mtl_tpu/ops/pallas/fused_gate.py:240,279",
            "launches": launches["fused_attention_gate_train_tasks"],
            "max_abs_err": task_gates["fused_attention_gate_train_tasks"]["err"],
            **{k: task_gates["fused_attention_gate_train_tasks"][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by", "per_task_calls_ms")},
            "library_ms": None,
        },
        # B4's staged call across ranks (data parallelism): per MTAN bf16
        # train step on one rank's half of batch 8, two ranks sharing one
        # card over gloo; its error: the two-halves check against the fused
        # call and the ranks' check against the plain split
        {
            "name": "fused_attention_gate_train_ranks", "route": "cuda",
            "source": "vision_mtl_tpu_torch/csrc/gate_train.cu",
            "replaces": "vision_mtl_tpu/ops/pallas/fused_gate.py:240,279",
            "launches": launches["fused_attention_gate_train_ranks"],
            "max_abs_err": max(gate_train["split_err"],
                               parallel_line["gate_train_staged_per_step"]["err"]),
            **{k: parallel_line["gate_train_staged_per_step"][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
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
            "launches": launches["conv3x3_small"], **conv_both,
        },
    ]}
    for k in kernel_line["kernels"]:
        if k["name"] in nyu_entries:
            k["nyuv2"] = nyu_entries[k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], k["nyuv2"]["max_abs_err"])
        if k["launches"] <= 0:
            fail(f"{k['name']} was never launched on the main path")
    # the whole run's seconds, the kernels' build included
    print(json.dumps({"timing": {"build_s": build_s, "total_s": time.perf_counter() - t_start,
                                 "phases_done_at_s": done_at}}), flush=True)
    print(json.dumps(kernel_line), flush=True)
    print(smi, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
