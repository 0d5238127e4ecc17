"""Runs one cell of the port's benchmark once and prints its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``vision_mtl_tpu_torch``)
and ``BENCHMARK.json``. Needs as many CUDA cards as the cell asks for; on
any other machine it exits with code 2 and prints no result. The last line
of standard output is the result (JSON); the last lines of standard error
give each number compared with the plain reference beside its limit.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness

    bench = harness.load_benchmark(ROOT)
    entry = harness.cell_entry(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    run = harness.make_run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                           device, T0)
    traffic_kind = harness.kind_module(run.traffic["kind"])
    outcome = traffic_kind.run(run)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": entry["chips"],
            "memory_peak_bytes": outcome.memory_peak_bytes,
            "power_limit_w": harness.power_limit_w()}
    line = harness.result(bench, run, outcome, info)
    for k, v in run.notes.items():
        print(f"portbench: {k}: {v}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"portbench: {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
