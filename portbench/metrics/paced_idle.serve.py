"""The share of the traced sub-window in which no device operation ran
while the batching worker was inside the program's ``serve.dispatch`` span
(``BatchingServer._flush``: stack, pad, pin, copy and the forward's
launch): idle that the worker's own host work caused. Waits for requests
and for the in-flight bound are not in it. Every batch dispatched in the
sub-window has to have its span (``portbench/spans.py``)."""

from portbench import spans

UNIT, LAYER, MOVES = "%", "device", "serve_img_per_s"


def read(r):
    if r.kind != "serve":
        return None
    hits = spans.named(r, "serve.dispatch")
    if hits is None or not spans.whole_batches(hits):
        return None
    return spans.paced_idle(r, hits)
