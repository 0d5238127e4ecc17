"""Kernel B1, MTAN's eval-mode attention gate (``kernels/fused_gate.py``,
``csrc/fused_gate.cu``): its mean least time a launch over its mean device
time a launch, in the traced sub-window. Each served batch launches it once
per gate and task at the configuration's ``gate_shapes`` over the batch's
bucket of slots; the batches and slots dispatched in the sub-window come
from ``BatchingServer.stats()``, checked against the program's launch
counter (one batch may be half dispatched at an edge), and the device time
from the trace's B1 kernels. Means, because a batch in flight at either
edge of the sub-window has its launches on one side and its kernels on the
other. Bound by bytes at bf16 activations (``portbench.costs.gate``)."""

from portbench import costs

UNIT, LAYER, MOVES = "%", "B1 eval gate", "serve_img_per_s"
COUNTER = "fused_attention_gate"
PATTERNS = ("gate_kernel<",)


def read(r):
    shapes = r.config.get("gate_shapes")
    if r.kind != "serve" or not shapes:
        return None
    tasks, s = r.config["tasks"], r.serve_traced
    batches = s.get("batches", 0)
    per_batch = len(shapes) * tasks
    if batches <= 0 or abs(r.launches.get(COUNTER, 0) - per_batch * batches) > per_batch:
        return None
    slots = s["batched_images"] + s["padded_slots"]
    act = costs.DTYPE_BYTES[r.config["compute_dtype"]]
    least = 0.0
    for _, cin, c2, h, w in shapes:
        flops, nbytes = costs.gate(slots * h * w, cin, c2, r.config["gate_hidden"], act,
                                   train=False)
        weights = costs.gate(0, cin, c2, r.config["gate_hidden"], act, train=False)[1]
        least += costs.least_s(flops, nbytes + (batches - 1) * weights)[0] * tasks
    spent_us, seen = r.trace.time_us(PATTERNS)
    if not seen:
        return None
    return 100.0 * (least / (per_batch * batches)) / (spent_us / 1e6 / seen)
