"""The share of the traced sub-window in which no device operation ran
while the host was inside the program's ``train.step`` span: idle that the
host's own work on the step caused (``portbench/spans.py``). The final
sync's drain is not in it. In the benchmark's train loop the host runs
nothing between steps, so this is ``idle_share.train`` less the drain; it
parts from it where the loop does host work of its own between steps."""

from portbench import spans

UNIT, LAYER, MOVES = "%", "device", "train_img_per_s"


def read(r):
    if r.kind != "train":
        return None
    hits = spans.named(r, "train.step", r.steps)
    return None if hits is None else spans.paced_idle(r, hits)
