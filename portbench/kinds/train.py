"""Training traffic: the program's train step driven over a pool of
seeded batches, on one card.

Set-up builds one train state (the model with the seeded weights, its
Adam state) and one step (``make_train_step``). It drives that state
through the check's first steps on the pool's first batches, through the
step's own call and host-to-device feed, records what the comparison
reads, runs a few more steps to warm up, and hands the same state to the
window. The window runs the step on the pool's batches in turn for
``--seconds`` and ends in a device sync: ``train_img_per_s`` is every
image trained over the whole window. After the window the program's
state is freed and the reference follows the first steps from the same
weights on the same batches.

Mix keys: ``batch``, ``lr``, ``loss_weights`` (segm, depth),
``trace_steps`` (the traced sub-window's steps).
"""

from __future__ import annotations

import time
import typing as t

import torch

from portbench import compare, seeded
from portbench.harness import Outcome, Run, program_model
from portbench.readings import Readings
from portbench.reference.steps import train_steps
from portbench.trace import sub_window
from vision_mtl_tpu_torch import kernels
from vision_mtl_tpu_torch.metrics import init_metrics
from vision_mtl_tpu_torch.train.state import create_train_state
from vision_mtl_tpu_torch.train.step import make_train_step

#: distinct seeded batches the window cycles through
POOL_BATCHES = 8
#: the steps the comparison follows: every limit in ``workloads/*.json``
#: and every reading of ``control.py`` was taken at this depth
CHECK_STEPS = 3
#: steps after the check's, before the window opens
WARMUP_STEPS = 2


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_steps(r: Run, pool: t.Sequence[t.Dict[str, torch.Tensor]]) -> t.Tuple[
        t.Any, t.Any, t.Callable, t.Dict[str, t.Any]]:
    """The program's train state and step on the run's weights, driven
    through the check's first steps on the pool's first batches: returns
    ``(state, mstate, step, readings)``, the readings those the comparison
    reads."""
    cfg, mix, dev = r.config, r.traffic, r.device
    classes = cfg["num_classes"]
    start = seeded.weights(cfg, r.seed, dev)
    model = program_model(cfg, dev)
    model.load_state_dict(start)
    state = create_train_state(model, mix["lr"], device=dev)
    step = make_train_step(*mix["loss_weights"], device=dev)
    mstate = init_metrics(classes, dev)
    named = dict(model.named_parameters())
    losses, grads, confmat = [], None, None
    for i in range(CHECK_STEPS):
        state, mstate, ls = step(state, pool[i % len(pool)], mstate)
        losses.append(ls["loss"].detach().clone())
        if i == 0:
            grads = compare.program_grad_norms(named, state.optimizer)
            confmat = mstate.confmat.clone()
    change = {k: (p.detach() - start[k]).norm() for k, p in named.items()}
    readings = {"loss": [float(v) for v in losses],
                "grad_norm": {k: float(v) for k, v in grads.items()},
                "change_norm": {k: float(v) for k, v in change.items()},
                "confmat": confmat.cpu()}
    return state, mstate, step, readings


def run(r: Run) -> Outcome:
    cfg, mix, dev = r.config, r.traffic, r.device
    batch = mix["batch"]
    pool = seeded.train_pool(r.seed, POOL_BATCHES, batch, cfg["height"], cfg["width"],
                             cfg["num_classes"], dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the check's first steps, which also warm up every shape of the cell
    state, mstate, step, prog = first_steps(r, pool)
    n_check, n_pool = CHECK_STEPS, len(pool)
    k = n_check
    for _ in range(WARMUP_STEPS):
        state, mstate, _ = step(state, pool[k % n_pool], mstate)
        k += 1
    sync(dev)
    setup_s = time.perf_counter() - r.t0

    steps = 0
    t_open = time.perf_counter()
    while True:
        state, mstate, _ = step(state, pool[k % n_pool], mstate)
        k += 1
        steps += 1
        if time.perf_counter() - t_open >= r.seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t_open
    rate = steps * batch / window_s

    readings = None
    if r.trace:
        before = kernels.launch_counts()
        with sub_window() as box:
            for _ in range(mix["trace_steps"]):
                state, mstate, _ = step(state, pool[k % n_pool], mstate)
                k += 1
            sync(dev)
        after = kernels.launch_counts()
        readings = Readings(kind="train", config=cfg, traffic=mix, chips=r.chips, rate=rate,
                            trace=box["trace"], steps=mix["trace_steps"],
                            launches={n: after[n] - before[n] for n in after})
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del state, mstate, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    compared = reference_gaps(r, cfg, mix, pool[:n_check], prog, dev)
    return Outcome(values={"train_img_per_s": rate, "setup_s": setup_s}, compared=compared,
                   attempted=steps, failed=0, memory_peak_bytes=peak, readings=readings)


def reference_gaps(r: Run, cfg, mix, batches, prog, dev: torch.device) -> t.Dict[str, float]:
    """The reference's first steps from the run's weights on the run's
    batches, held against ``prog``'s readings."""
    model = seeded.reference_model(cfg, r.seed, dev)
    ref = train_steps(model, batches, mix["lr"], *mix["loss_weights"], cfg["num_classes"], dev)
    gaps, leaves = compare.train_gaps(prog, ref)
    r.notes.update(compared=gaps, worst_leaves=leaves, loss=prog["loss"],
                   reference_loss=ref["loss"])
    return gaps
