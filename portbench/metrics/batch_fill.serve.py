"""The share of the batches' slots that carried a request over the
window: ``batched_images / (batched_images + padded_slots)`` of
``BatchingServer.stats()``."""

UNIT, LAYER, MOVES = "%", "batching", "serve_img_per_s"


def read(r):
    s = r.serve_window
    slots = s.get("batched_images", 0) + s.get("padded_slots", 0)
    if r.kind != "serve" or slots <= 0:
        return None
    return 100.0 * s["batched_images"] / slots
