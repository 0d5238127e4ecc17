"""The share of the traced sub-window in which no device operation ran:
1 minus the union of the operations' intervals over the sub-window."""

UNIT, LAYER, MOVES = "%", "device", "train_img_per_s"


def read(r):
    if r.kind != "train" or not r.trace.device:
        return None
    return 100.0 * (1.0 - r.trace.busy_us() / r.trace.window_us)
