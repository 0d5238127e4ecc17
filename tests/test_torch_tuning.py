"""The port's loss-weight search against the JAX package's on the CPU: the
median pruner's decisions, the sweep's suggested weights, pruned trials
and best weights (with optuna's stand-in installed and without optuna),
the number of concurrent trials, and one real tiny sweep through the
training CLI and ``eval_harness --from_registry``."""

import argparse
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import tests._optuna_stub as optuna_stub
import vision_mtl_tpu.tuning as jax_tuning
from vision_mtl_tpu.cfg import fetch_data_cfg as jax_fetch_data_cfg
from vision_mtl_tpu_torch import eval_harness, training, tuning
from vision_mtl_tpu_torch.cfg import cfg, fetch_data_cfg
from vision_mtl_tpu_torch.data import synthetic

TINY = dict(height=16, width=24, num_classes=5, num_train=12, num_val=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# each case: MedianPruner's kwargs, a sequence of ("complete", history) and
# ("report", ordinal, value) calls, and which reports prune
PRUNER_CASES = {
    "startup_grace": ({}, [("report", 0, 0.0), ("complete", [0.5]), ("report", 0, 0.0)],
                      [False, False]),
    "below_median": ({}, [("complete", [0.5, 0.6]), ("complete", [0.7, 0.8]),
                          ("report", 0, 0.6), ("report", 0, 0.1), ("report", 1, 0.65),
                          ("report", 2, 0.0)],
                     [False, True, True, False]),
    "warmup": ({"n_warmup_steps": 2}, [("complete", [0.9, 0.9, 0.9]), ("complete", [0.9] * 3),
                                       ("report", 0, 0.1), ("report", 1, 0.1),
                                       ("report", 2, 0.1)],
               [False, False, True]),
    "one_startup": ({"n_startup_trials": 1}, [("complete", [0.3]), ("report", 0, 0.2),
                                              ("complete", [0.1, 0.2]), ("report", 0, 0.2),
                                              ("report", 1, 0.19)],
                    [True, False, True]),
}


def _pruner_decisions(mod, kwargs, calls):
    pruner, out = mod.MedianPruner(**kwargs), []
    for call in calls:
        if call[0] == "complete":
            pruner.complete(call[1])
            continue
        try:
            pruner.report(call[1], call[2])
            out.append(None)
        except mod.TrialPruned as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("case", sorted(PRUNER_CASES))
def test_median_pruner_matches_jax(case):
    kwargs, calls, prunes = PRUNER_CASES[case]
    got = _pruner_decisions(tuning, kwargs, calls)
    assert got == _pruner_decisions(jax_tuning, kwargs, calls)
    assert [msg is not None for msg in got] == prunes


def _fake_trials(log):
    """One deterministic trial function for both packages: accuracy rises
    by 0.01 an epoch from a base set by the weights; every epoch reports."""

    def trial(args, weights, tag, epoch_callback):
        base = weights["loss_segm_weight"] - 0.5 * weights["loss_depth_weight"]
        accs = []
        for epoch in range(args.num_epochs):
            accs.append(base + 0.01 * epoch)
            try:
                epoch_callback(epoch, {"accuracy": accs[-1]})
            except Exception:
                log.append((tag, dict(weights), "pruned", epoch))
                raise
        log.append((tag, dict(weights), "complete", args.num_epochs))
        return float(np.mean(accs))

    def jax_run_trial(args, data_cfg, weights, mesh, tag, epoch_callback=None):
        return trial(args, weights, tag, epoch_callback)

    def port_run_trial(args, data_cfg, weights, tag, epoch_callback=None, mesh=None):
        return trial(args, weights, tag, epoch_callback)

    return jax_run_trial, port_run_trial


@pytest.mark.parametrize("with_optuna", [False, True])
def test_run_study_matches_jax(with_optuna, monkeypatch, capsys):
    """The same suggested weights, trials pruned at the same epochs and the
    same best weights, with optuna (its stand-in) and without."""
    monkeypatch.setitem(sys.modules, "optuna", optuna_stub if with_optuna else None)
    args = argparse.Namespace(n_trials=8, n_jobs=1, num_epochs=10, seed=11, device="cpu",
                              loss_segm_weight=1.0, loss_depth_weight=1.0)
    jax_log, port_log = [], []
    jax_trial, _ = _fake_trials(jax_log)
    _, port_trial = _fake_trials(port_log)
    monkeypatch.setattr(jax_tuning, "_run_trial", jax_trial)
    monkeypatch.setattr(tuning, "_run_trial", port_trial)
    want = jax_tuning.run_study(args, jax_fetch_data_cfg("synthetic"))
    want_out = capsys.readouterr().out
    got = tuning.run_study(args, fetch_data_cfg("synthetic"))
    assert got == want and port_log == jax_log
    assert capsys.readouterr().out == want_out
    assert len(port_log) == 8 and args.num_epochs == 10
    pruned = [entry for entry in port_log if entry[2] == "pruned"]
    assert pruned and all(n == 3 for _, _, state, n in port_log if state == "complete")


def test_effective_n_jobs(capsys):
    """Trials run one at a time on the card, ``n_jobs`` at once on the
    CPU."""
    assert tuning._effective_n_jobs(argparse.Namespace(n_jobs=2, device="cuda")) == 1
    assert capsys.readouterr().out == (
        "n_jobs=2 ignored on cuda: trials share one device queue; running serially\n")
    assert tuning._effective_n_jobs(argparse.Namespace(n_jobs=1, device="cuda")) == 1
    assert tuning._effective_n_jobs(argparse.Namespace(n_jobs=3, device="cpu")) == 3
    assert tuning._effective_n_jobs(argparse.Namespace(n_jobs=0, device="cpu")) == 1
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("with_optuna", [False, True])
def test_trials_run_on_threads_on_the_cpu(with_optuna, monkeypatch):
    """Two trials on the CPU with ``n_jobs=2`` overlap in time: a barrier of
    two releases only when both are inside ``_run_trial`` at once."""
    monkeypatch.setitem(sys.modules, "optuna", optuna_stub if with_optuna else None)
    barrier = threading.Barrier(2, timeout=30)

    def trial(args, data_cfg, weights, tag, epoch_callback=None, mesh=None):
        barrier.wait()
        return weights["loss_segm_weight"]

    monkeypatch.setattr(tuning, "_run_trial", trial)
    args = argparse.Namespace(n_trials=2, n_jobs=2, num_epochs=1, seed=11, device="cpu",
                              loss_segm_weight=1.0, loss_depth_weight=1.0)
    assert set(tuning.run_study(args, fetch_data_cfg("synthetic"))) == set(tuning.PARAM_KEYS)


def test_sweep_registers_and_evaluates(monkeypatch, tmp_path, capsys):
    """``training.main --do_optimize`` at a tiny synthetic size: two trials
    of three epochs in run dirs of their own, the tuned run trained with
    the best trial's weights and registered as ``mtan_tuned``; then
    ``eval_harness --from_registry`` evaluates it."""
    for k, v in TINY.items():
        monkeypatch.setattr(synthetic.synthetic_data_cfg, k, v)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "optuna", None)
    monkeypatch.setattr(cfg, "log_root_dir", tmp_path)
    run_dir = training.main(["--device", "cpu", "--dataset_name", "synthetic", "--model_name",
                             "mtan", "--batch_size", "4", "--num_epochs", "1", "--do_optimize",
                             "--n_trials", "2"])
    out = capsys.readouterr().out
    trials = [ln for ln in out.splitlines() if ln.startswith("trial ")]
    assert len(trials) == 2 and "Best trial:" in out
    assert run_dir == str(tmp_path / "training-mtan" / "version_2")
    for trial_dir in ("version_0", "version_1"):
        assert "model_2" in os.listdir(tmp_path / "training-mtan" / trial_dir)
    assert f"Registered run 'mtan_tuned' in {tmp_path / 'run_registry.json'}" in out
    registry = json.loads((tmp_path / "run_registry.json").read_text())
    assert registry == {"mtan_tuned": {"synthetic": {"model_name": "mtan", "run_dir": run_dir}}}
    run_args = open(os.path.join(run_dir, "train_args.yaml")).read()
    best = json.loads(out.split("Best trial: ")[1].split(" ", 1)[1].splitlines()[0]
                      .replace("'", '"'))
    assert f"loss_segm_weight: {best['loss_segm_weight']!r}" in run_args
    assert "best_trial" in run_args

    eval_harness.main(["--from_registry", "--dataset_name", "synthetic", "--device", "cpu",
                       "--batch_size", "4"])
    out = capsys.readouterr().out
    assert f"Evaluating mtan_tuned (mtan) from {run_dir}" in out
    assert out.splitlines()[-6].split() == ["mtan_tuned"]
