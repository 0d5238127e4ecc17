"""Finds, once, the highest arrival rate the served cell sustains: the
cell's server under the open loop at each of ``--rates`` in turn, in one
process, on one card. A rate is sustained when the requests answered keep
up with those sent and the latency of the window's last third is no
higher than twice its first third's (no growing backlog). Prints one JSON
line a rate. The benchmark's own runs do not run it.

    python3 portbench/sweep.py --workload mtan-cityscapes.serve-over --rates 400 800 1200
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args()
    import torch

    from portbench import harness
    from portbench.kinds import serve

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_benchmark(ROOT)
    run = harness.make_run(bench, args.workload, args.seed, args.seconds, False,
                           torch.device("cuda", 0), T0)
    server, frames, _ = serve.build_server(run)
    for rate in args.rates:
        due = serve.arrivals(rate, args.seconds, args.seed)
        load = serve.OpenLoop(server, frames, due, args.seconds, args.seed, 0)
        server.reset_stats()
        load.start()
        never = load.drain()
        lat = load.latencies + [float("inf")] * never
        third = max(1, len(lat) // 3)
        first, last = serve.percentile(lat[:third], 95), serve.percentile(lat[-third:], 95)
        stats = server.stats()
        print(json.dumps({"rate": rate, "requests": len(lat), "failed": load.failed + never,
                          "p50_ms": serve.percentile(lat, 50), "p95_ms": serve.percentile(lat, 95),
                          "p95_first_third_ms": first, "p95_last_third_ms": last,
                          "sustained": never == 0 and last <= 2 * first,
                          "mean_batch": stats["batched_images"] / max(1, stats["batches"]),
                          "batch_fill": stats["mean_batch_occupancy"],
                          "sender_late_p95_ms": serve.percentile(load.late, 95) * 1e3}),
              flush=True)
    server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
