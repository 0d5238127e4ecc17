"""The batching worker's wall milliseconds a batch in dispatching it
(stack, pad, pin, copy and the forward's launch): ``dispatch_s / batches``
of ``BatchingServer.stats()`` over the run's untraced window. The worker
shares its interpreter with the fetch thread and with the benchmark's own
sender, so the reading holds its waits for the interpreter lock as well as
its own work; ``dispatch_cpu_s`` of the same counters is the worker's CPU
time alone (``python3 portbench/spans.py`` prints both a batch)."""

UNIT, LAYER, MOVES = "ms", "predictor", "serve_img_per_s"


def read(r):
    s = r.serve_window
    if r.kind != "serve" or "dispatch_s" not in s or s.get("batches", 0) <= 0:
        return None
    return 1e3 * s["dispatch_s"] / s["batches"]
