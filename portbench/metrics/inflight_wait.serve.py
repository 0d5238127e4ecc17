"""The share of the run's untraced window the batching worker spent
blocked by ``max_in_flight`` (the fetch thread's back-pressure):
``inflight_wait_s / seconds`` of ``BatchingServer.stats()``."""

UNIT, LAYER, MOVES = "%", "batching", "serve_img_per_s"


def read(r):
    s = r.serve_window
    if r.kind != "serve" or "inflight_wait_s" not in s or s.get("seconds", 0) <= 0:
        return None
    return 100.0 * s["inflight_wait_s"] / s["seconds"]
