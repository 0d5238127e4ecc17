"""Kernel B3, the small 3x3 convolution (``kernels/small_conv.py``,
``csrc/small_conv.cu``): the least time of the sub-window's launches over
their device time. Each step launches it at the configuration's
``small_conv_shapes`` (the forward's convs and the backward's dx); the
launches are checked against the program's counter. Bound by bytes at
bf16 activations (``portbench.costs.conv3x3``)."""

from portbench import costs

UNIT, LAYER, MOVES = "%", "B3 small conv", "train_img_per_s"
COUNTER = "conv3x3_small"
PATTERNS = ("conv3x3_small_kernel", "conv3x3_small_tc_kernel")


def read(r):
    shapes = r.config.get("small_conv_shapes")
    if r.kind != "train" or not shapes:
        return None
    per_step = sum(n for *_, n in shapes)
    if r.launches.get(COUNTER, 0) != per_step * r.steps:
        return None
    act, batch = costs.DTYPE_BYTES[r.config["compute_dtype"]], r.traffic["batch"]
    least = sum(costs.least_s(*costs.conv3x3(batch, h, w, c, o, bias, act))[0] * n
                for _, c, o, h, w, bias, n in shapes) * r.steps
    spent_us, seen = r.trace.time_us(PATTERNS)
    if not seen:
        return None
    return 100.0 * least / (spent_us / 1e6)
