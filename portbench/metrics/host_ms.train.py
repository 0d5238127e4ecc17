"""The host's wall milliseconds inside a train step: the mean host
duration of the program's ``train.step`` span (``train/step.make_train_step``)
over the traced sub-window's steps (``portbench/spans.py``). It holds the
step's Python and launches and the host's waits on CUDA's launch queue, so
it is the host's cost of enqueuing a step only where the host sets the pace
(``paced_idle.train`` near ``idle_share.train`` and large). Where the card
sets the pace, the queue holds the host back and this reads about the
sub-window's period a step less its final drain."""

from portbench import spans

UNIT, LAYER, MOVES = "ms", "train step", "train_img_per_s"


def read(r):
    if r.kind != "train":
        return None
    hits = spans.named(r, "train.step", r.steps)
    if hits is None:
        return None
    return sum(spans.host_us(s) for s in hits) / len(hits) / 1e3
