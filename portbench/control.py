"""The readings the limits of a cell's comparison are set from, read on
the card at the cell's own size, many seeds in one process: what the
numbers that decide ``correct`` read for the program itself (``program``,
the lower side), and when the timed path is the plain reference one
precision below the configuration's, float8 for its bfloat16
(``control``, ``reference.common.FP8``), or broken on purpose (the upper
side). The limits of ``workloads/<cell>.json`` lie between.

Training cells, for each seed: the program's first steps as a run takes
them (``kinds.train.first_steps``); the float8 reference's; the
reference on the first half of each batch, its mean taken over that half
(``half_batch``); and steps that leave the state unchanged
(``state_unchanged``: the reference at learning rate 0, read as a run
reads a state whose optimizer holds no moment). Each is held against the
reference proper by ``compare.train_gaps``. Serving cells: the program's
answers sampled from a 3 s window at the cell's rate, the float8
reference's answers on a seeded sample of the run's frames, and the
reference's own answers with one image's classes shifted by one
(``answer_altered``), held against the reference by
``compare.serve_gaps``.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--no-program]

Prints one JSON line per seed and reading. The benchmark's own runs do not
run it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import compare, harness, reference, seeded  # noqa: E402
from portbench.kinds import serve, train  # noqa: E402
from portbench.reference.common import F32, FP8  # noqa: E402
from portbench.reference.steps import serve_outputs, train_steps  # noqa: E402


def train_readings(run: harness.Run, program: bool = True) -> dict:
    cfg, mix, dev = run.config, run.traffic, run.device
    pool = seeded.train_pool(run.seed, train.CHECK_STEPS, mix["batch"], cfg["height"],
                             cfg["width"], cfg["num_classes"], dev)
    prog = None
    if program:
        prog = train.first_steps(run, pool)[-1]
        torch.cuda.empty_cache()
    args = (mix["lr"], *mix["loss_weights"], cfg["num_classes"], dev)
    ref = train_steps(seeded.reference_model(cfg, run.seed, dev), pool, *args)
    torch.cuda.empty_cache()
    out = {}
    if prog is not None:
        out["program"] = compare.train_gaps(prog, ref)
    ctrl = train_steps(seeded.reference_model(cfg, run.seed, dev, FP8), pool, *args)
    out["control"] = compare.train_gaps(ctrl, ref)
    torch.cuda.empty_cache()
    half = [{k: v[: mix["batch"] // 2] for k, v in b.items()} for b in pool]
    out["half_batch"] = compare.train_gaps(
        train_steps(seeded.reference_model(cfg, run.seed, dev), half, *args), ref)
    torch.cuda.empty_cache()
    # a step that returns its state unchanged: the weights never move and
    # the optimizer holds no moment, from which a run reads a zero gradient
    still = train_steps(seeded.reference_model(cfg, run.seed, dev), pool, 0.0, *args[1:])
    still["grad_norm"] = {k: 0.0 for k in still["grad_norm"]}
    out["state_unchanged"] = compare.train_gaps(still, ref)
    torch.cuda.empty_cache()
    return out


def serve_readings(run: harness.Run, program: bool = True, seconds: float = 3.0) -> dict:
    cfg, mix, dev = run.config, run.traffic, run.device
    out = {}
    if program:
        server, frames, weights = serve.build_server(run)
        load = serve.OpenLoop(server, frames, serve.arrivals(mix["rate"], seconds, run.seed),
                              seconds, run.seed, serve.SAMPLE)
        load.start(seconds)
        never = load.drain()
        server.close()
        del server
        torch.cuda.empty_cache()
        out["program"] = (serve.reference_gaps(run, cfg, load.kept, frames, weights, dev),
                          {"failed": load.failed + never})
    frames = seeded.frames(run.seed, serve.FRAMES, cfg["height"], cfg["width"], dev)
    weights = serve.served_weights(run, frames)
    idx = torch.randperm(len(frames), generator=torch.Generator().manual_seed(run.seed))
    sample = frames[idx[: serve.SAMPLE]]
    outputs = []
    for precision in (F32, FP8):
        with torch.device(dev):
            model = reference.build(cfg, precision)
        model.load_state_dict(weights)
        outputs.append(serve_outputs(model, sample, dev))
    (logits, depth), (c_logits, c_depth) = outputs
    altered = logits.argmax(-1)
    altered[0] = (altered[0] + 1) % cfg["num_classes"]
    out["control"] = (compare.serve_gaps(c_logits.argmax(-1), c_depth, logits, depth), {})
    out["answer_altered"] = (compare.serve_gaps(altered, depth, logits, depth), {})
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--no-program", action="store_true", help="the control and faults alone")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_benchmark(ROOT)
    for seed in args.seeds:
        run = harness.make_run(bench, args.workload, seed, 0.0, False, torch.device("cuda", 0),
                               T0)
        kind = run.traffic["kind"]
        readings = (train_readings if kind == "train" else serve_readings)(
            run, program=not args.no_program)
        for name, (gaps, leaves) in readings.items():
            checked = harness.checks(gaps, run.limits)
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": name,
                              "gaps": gaps, "worst_leaves": leaves,
                              "correct_under_limits": harness.is_correct(checked, 0)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
