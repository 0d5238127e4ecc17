"""The comparison fails what it must: a run whose timed path is broken
underneath, and the control (the reference at float8 in the program's
place), come out not correct under the cells' limits. On the CPU at a
size a test can hold; the harness's look for a card is skipped."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import control, harness
from portbench.kinds import serve, train
from portbench.tests import tiny

BENCH = harness.load_benchmark(tiny.ROOT)
#: every cell by its traffic's kind
KINDS = {w["name"]: harness.load_json("traffic", w["traffic"])["kind"]
         for w in BENCH["workloads"]}
TRAIN_CELLS = [c for c, kind in KINDS.items() if kind == "train"]
SERVE_CELLS = [c for c, kind in KINDS.items() if kind == "serve"]


def _train_outcome(cell, monkeypatch, wrap):
    real = train.make_train_step

    def broken(*args, **kwargs):
        return wrap(real(*args, **kwargs))

    monkeypatch.setattr(train, "make_train_step", broken)
    r = tiny.run(cell)
    return tiny.result(r, train.run(r))


def _unchanged(step):
    def run(state, batch, mstate):
        saved = {k: p.detach().clone() for k, p in state.model.named_parameters()}
        opt = state.optimizer
        opt_state = {p: {k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
                     for p, s in opt.state.items()}
        out = step(state, batch, mstate)
        with torch.no_grad():
            for k, p in state.model.named_parameters():
                p.copy_(saved[k])
        opt.state.clear()
        opt.state.update(opt_state)
        return out
    return run


def _half_batch(step):
    def run(state, batch, mstate):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return step(state, half, mstate)
    return run


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["state_unchanged", "half_batch"])
def test_broken_train_step_is_not_correct(cell, fault, monkeypatch):
    line = _train_outcome(cell, monkeypatch, fault)
    assert line["correct"] is False, line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_altered_answer_is_not_correct(cell, monkeypatch):
    """Each batch's first answer has its classes shifted by one where the
    predictor fetches it."""
    r = tiny.run(cell)
    classes = r.config["num_classes"]
    real_init = serve.BatchingServer.__init__

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        for pred in self._predictors.values():
            original = pred.fetch

            def altered(out, n, original=original):
                host = original(out, n)
                host["segm"] = host["segm"].copy()
                host["segm"][0] = (host["segm"][0].astype(np.int64) + 1) % classes
                return host

            pred.fetch = altered

    monkeypatch.setattr(serve.BatchingServer, "__init__", init)
    line = tiny.result(r, serve.run(r))
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", TRAIN_CELLS + SERVE_CELLS)
def test_float8_control_is_not_correct(cell):
    r = tiny.run(cell)
    readings = (control.train_readings if KINDS[cell] == "train"
                else control.serve_readings)(r, program=False)
    gaps, _ = readings["control"]
    assert not harness.is_correct(harness.checks(gaps, r.limits), 0), gaps
