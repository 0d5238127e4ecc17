"""Measures the program's data-parallel train step over NCCL ranks, one card
each: the rate, set-up, memory and device time of a run that a four-card
training cell would time. It has no comparison with the reference, so no
cell runs it and it decides no ``correct``; the benchmark's own runs do not
run it.

It starts ``--ranks`` processes of itself with torchrun's environment
(``tcp://localhost`` and a free port). Each rank builds the program's
train state on the seed's weights under the mesh ``data:<ranks>`` and
trains on its rows of a pool of seeded global batches: the same check,
warm-up and pool as ``kinds/train.py``. Rank 0 fixes the window's number
of steps from the warm-up's pace, so that every rank runs as many; the
window ends in a device sync and a barrier. With ``--trace 1`` rank 0
profiles a short sub-window after it. Rank 0 prints one JSON line.

    python3 portbench/mesh_probe.py --config mtan-cityscapes --traffic train-b32 \\
        --ranks 4 --seed 5 --seconds 20 --trace 1
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True, help="a train mix: its batch is a rank's")
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", help="cpu: gloo ranks, for a rehearsal")
    p.add_argument("--height", type=int, default=0, help="a smaller height, for a rehearsal")
    p.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def launch(args) -> int:
    from vision_mtl_tpu_torch.parallel.multihost import free_port

    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(args.ranks), LOCAL_WORLD_SIZE=str(args.ranks))
    if args.device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs = []
    for r in range(args.ranks):
        argv = [sys.executable, __file__, *sys.argv[1:], "--rank", str(r)]
        procs.append(subprocess.Popen(argv, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                                      stdout=subprocess.DEVNULL if r else None))
    deadline = time.monotonic() + 600.0
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            codes.append(None)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return 0 if codes == [0] * args.ranks else 1


def rank_main(args) -> int:
    import torch

    from portbench import harness, seeded, trace
    from portbench.kinds import train
    from vision_mtl_tpu_torch.metrics import init_metrics
    from vision_mtl_tpu_torch.parallel import multihost
    from vision_mtl_tpu_torch.parallel.mesh import create_mesh
    from vision_mtl_tpu_torch.train.state import create_train_state
    from vision_mtl_tpu_torch.train.step import make_train_step

    cfg = harness.load_json("configs", args.config)
    mix = harness.load_json("traffic", args.traffic)
    if args.height:
        cfg = dict(cfg, height=args.height, width=2 * args.height)
    multihost.maybe_initialize_distributed(args.device)
    comm = multihost.current()
    mesh = create_mesh(f"data:{comm.world}", comm)
    dev = mesh.device
    cuda = dev.type == "cuda"
    per, world = mix["batch"], comm.world
    rows = mesh.batch_rows(per * world)
    pool = [{k: seeded._pin(v[rows].contiguous()) for k, v in b.items()}
            for b in seeded.train_pool(args.seed, train.POOL_BATCHES, per * world, cfg["height"],
                                       cfg["width"], cfg["num_classes"], dev)]
    model = harness.program_model(cfg, dev)
    model.load_state_dict(seeded.weights(cfg, args.seed, dev))
    state = create_train_state(model, mix["lr"], device=dev)
    step = make_train_step(*mix["loss_weights"], device=dev, mesh=mesh)
    mstate = init_metrics(cfg["num_classes"], dev)
    k = 0
    for _ in range(train.CHECK_STEPS + train.WARMUP_STEPS - 1):
        state, mstate, _ = step(state, pool[k % len(pool)], mstate)
        k += 1
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    sync()
    t = time.perf_counter()
    state, mstate, ls = step(state, pool[k % len(pool)], mstate)
    k += 1
    sync()
    pace = time.perf_counter() - t
    steps = comm.broadcast_object(max(1, math.ceil(args.seconds / pace)))
    comm.barrier()
    setup_s = time.perf_counter() - T0

    t_open = time.perf_counter()
    for _ in range(steps):
        state, mstate, ls = step(state, pool[k % len(pool)], mstate)
        k += 1
    sync()
    comm.barrier()
    window_s = time.perf_counter() - t_open
    out = {"ranks": world, "seed": args.seed, "steps": steps, "window_s": window_s,
           "img_per_s": steps * per * world / window_s, "setup_s": setup_s,
           "loss": float(ls["loss"])}
    if args.trace:
        n = mix["trace_steps"]
        if comm.rank == 0:
            with trace.sub_window() as box:
                for _ in range(n):
                    state, mstate, _ = step(state, pool[k % len(pool)], mstate)
                    k += 1
                sync()
        else:
            for _ in range(n):
                state, mstate, _ = step(state, pool[k % len(pool)], mstate)
                k += 1
            sync()
        comm.barrier()
        if comm.rank == 0:
            tr = box["trace"]
            nccl_us, _ = tr.time_us(("nccl",))
            out.update(trace_steps=n, busy_s=tr.busy_us() / 1e6, trace_window_s=tr.window_us / 1e6,
                       idle_share=1.0 - tr.busy_us() / tr.window_us,
                       nccl_ms_per_step=nccl_us / 1e3 / n, device_ops=tr.categories(),
                       idle_gaps=tr.idle_gaps())
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    peaks = comm.host_all_reduce([peak], "max")
    out["memory_peak_bytes_max_rank"] = peaks[0]
    out["setup_s_max_rank"] = comm.host_all_reduce([int(setup_s * 1e3)], "max")[0] / 1e3
    if cuda:
        out["kind"] = torch.cuda.get_device_name(dev)
        out["power_limit_w"] = harness.power_limit_w()
    found = harness.forbidden_modules()
    if found:
        print(f"mesh_probe: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    del state, mstate, step, model
    multihost.shutdown_distributed()
    if comm.rank == 0:
        print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    args = parse()
    return rank_main(args) if args.rank >= 0 else launch(args)


if __name__ == "__main__":
    sys.exit(main())
