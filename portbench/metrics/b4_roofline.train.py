"""Kernel B4, MTAN's train-mode attention gate (``kernels/fused_gate_train.py``,
``csrc/gate_train.cu``): the least time of the sub-window's launches over
their device time. Each step launches it once per gate and task at the
configuration's ``gate_shapes``; the sub-window's launches are checked
against the program's launch counter. Bound by bytes at bf16 activations
(``portbench.costs.gate``)."""

from portbench import costs

UNIT, LAYER, MOVES = "%", "B4 train gate", "train_img_per_s"
COUNTER = "fused_attention_gate_train"
PATTERNS = ("gate_train_kernel<", "fold_kernel(")


def read(r):
    shapes = r.config.get("gate_shapes")
    if r.kind != "train" or not shapes:
        return None
    tasks, batch = r.config["tasks"], r.traffic["batch"]
    if r.launches.get(COUNTER, 0) != len(shapes) * tasks * r.steps:
        return None
    act = costs.DTYPE_BYTES[r.config["compute_dtype"]]
    least = sum(costs.least_s(*costs.gate(batch * h * w, cin, c2, r.config["gate_hidden"],
                                          act, train=True))[0]
                for _, cin, c2, h, w in shapes) * tasks * r.steps
    spent_us, seen = r.trace.time_us(PATTERNS)
    if not seen:
        return None
    return 100.0 * least / (spent_us / 1e6)
