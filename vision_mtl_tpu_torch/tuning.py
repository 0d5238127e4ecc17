"""Search over the two loss weights (counterpart of
``vision_mtl_tpu/tuning.py``): maximise the mean validation accuracy over
``loss_segm_weight`` and ``loss_depth_weight`` in [0, 1] with 3-epoch
trials and median pruning. Each trial reports its validation accuracy
after every validation epoch through ``run_pipe``'s ``epoch_callback``, and
a trial below the median is stopped. With optuna installed the study is
optuna's (a seeded ``TPESampler`` and its ``MedianPruner``); without it, a
seeded uniform sweep with :class:`MedianPruner` does the same.

Trials run on threads (``--n_jobs``) on the CPU; on the card they run one
after another, since one card is one queue. Under several ranks (a
``mesh``) the trials run one after another in lockstep on every rank: each
rank draws the same seeded suggestions, trains its rows, and prunes on the
ranks' reduced validation metrics, so all ranks prune together.
"""

from __future__ import annotations

import argparse
import copy
import threading
import typing as t

import numpy as np
import torch

from vision_mtl_tpu_torch.cfg import DataConfig
from vision_mtl_tpu_torch.device import resolve_device
from vision_mtl_tpu_torch.parallel.multihost import process_info
from vision_mtl_tpu_torch.pipeline import create_main_components, create_tools
from vision_mtl_tpu_torch.train.loop import run_pipe
from vision_mtl_tpu_torch.utils.args import torch_device, update_args

PARAM_KEYS = ("loss_segm_weight", "loss_depth_weight")


class TrialPruned(Exception):
    """Raised by a pruning epoch_callback to stop a trial early."""


class MedianPruner:
    """Median pruning of the sweep without optuna, with optuna's semantics:
    a trial is pruned at its k-th validation report when its accuracy is
    below the median of the completed trials' k-th reports, once
    ``n_startup_trials`` trials have completed and ``n_warmup_steps``
    reports have passed. Positions are report ordinals, not epochs, so that
    with ``--val_epoch_freq N`` the completed histories and the live
    reports line up. Thread-safe."""

    def __init__(self, n_startup_trials: int = 2, n_warmup_steps: int = 0):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps
        self._completed: t.List[t.List[float]] = []
        self._lock = threading.Lock()

    def report(self, ordinal: int, value: float) -> None:
        """Record the ``ordinal``-th intermediate value of a trial; raises
        TrialPruned when the trial should stop."""
        with self._lock:
            if len(self._completed) < self.n_startup_trials or ordinal < self.n_warmup_steps:
                return
            prior = [h[ordinal] for h in self._completed if len(h) > ordinal]
        if prior and value < float(np.median(prior)):
            raise TrialPruned(
                f"report {ordinal}: {value:.4f} < median {float(np.median(prior)):.4f}"
            )

    def complete(self, history: t.Sequence[float]) -> None:
        with self._lock:
            self._completed.append(list(history))


def _effective_n_jobs(args: argparse.Namespace) -> int:
    """The number of trials run at once: ``--n_jobs`` on the CPU; one on the
    card, whose trials share one queue (concurrent trials would only mix
    their step times and memory)."""
    n_jobs = getattr(args, "n_jobs", 1) or 1
    world = process_info()[1]
    if world > 1 and n_jobs != 1:
        # every rank must run the same collectives in the same order, and
        # thread-parallel trials would also cross the loggers' rendezvous
        print(f"n_jobs={n_jobs} ignored under {world} ranks: trials must run in lockstep; "
              "running serially")
        return 1
    device = torch.device(torch_device(getattr(args, "device", "cuda")))
    if device.type != "cpu" and n_jobs != 1:
        print(f"n_jobs={n_jobs} ignored on {device.type}: "
              "trials share one device queue; running serially")
        return 1
    return n_jobs


def _run_trial(
    args: argparse.Namespace,
    data_cfg: DataConfig,
    loss_weights: t.Mapping[str, float],
    tag: str,
    epoch_callback: t.Optional[t.Callable[[int, t.Dict[str, float]], None]] = None,
    mesh: t.Any = None,
) -> float:
    """One training trial in a run dir of its own; returns its mean
    validation accuracy. ``epoch_callback`` goes to ``run_pipe``; a pruning
    callback's exception propagates after the experiment and the logger are
    closed."""
    args = copy.deepcopy(args)
    args = update_args(args, dict(loss_weights))
    device = mesh.device if mesh is not None else resolve_device(torch_device(args.device))
    components = create_main_components(args, data_cfg, device)
    tools = create_tools(args, rendezvous_tag=tag)
    exp, logger = tools["exp"], tools["logger"]
    if exp:
        exp.add_tags([tag])
    try:
        _, fit_metrics = run_pipe(
            args,
            components["state"],
            components["datamodule"],
            num_epochs=args.num_epochs,
            num_classes=data_cfg.num_classes,
            exp=exp,
            logger=logger,
            epoch_callback=epoch_callback,
            device=device,
            mesh=mesh,
        )
    finally:
        if exp:
            exp.end()
        logger.close()
    vals = fit_metrics["val"].get("val/accuracy", [0.0])
    return float(np.mean(vals))


def run_study(
    args: argparse.Namespace, data_cfg: DataConfig, trial_epochs: int = 3, mesh: t.Any = None
) -> t.Dict[str, float]:
    """Returns the best ``{loss_segm_weight, loss_depth_weight}``; under a
    ``mesh``, every rank's trials run in lockstep with the others'."""
    args = copy.deepcopy(args)
    args.num_epochs = trial_epochs

    # only the import falls back: an ImportError inside a trial propagates
    try:
        import optuna
    except ImportError:
        optuna = None

    if optuna is not None:
        study = optuna.create_study(
            direction="maximize",
            pruner=optuna.pruners.MedianPruner(),
            sampler=optuna.samplers.TPESampler(seed=getattr(args, "seed", 11)),
        )

        def objective(trial: t.Any) -> float:
            weights = {k: trial.suggest_float(k, 0.0, 1.0) for k in PARAM_KEYS}

            def cb(epoch: int, val_metrics: t.Dict[str, float]) -> None:
                trial.report(float(val_metrics.get("accuracy", 0.0)), epoch)
                if trial.should_prune():
                    raise optuna.TrialPruned()

            return _run_trial(args, data_cfg, weights, f"trial_{trial.number}",
                              epoch_callback=cb, mesh=mesh)

        study.optimize(objective, n_trials=args.n_trials, n_jobs=_effective_n_jobs(args))
        print("Best trial:", study.best_trial.value, study.best_trial.params)
        return dict(study.best_trial.params)

    rng = np.random.default_rng(getattr(args, "seed", 11))
    all_weights = [
        {k: float(rng.uniform(0.0, 1.0)) for k in PARAM_KEYS} for _ in range(args.n_trials)
    ]
    n_jobs = _effective_n_jobs(args)
    pruner = MedianPruner()

    def trial(i: int) -> t.Tuple[float, t.Dict[str, float]]:
        history: t.List[float] = []

        def cb(epoch: int, val_metrics: t.Dict[str, float]) -> None:
            acc = float(val_metrics.get("accuracy", 0.0))
            history.append(acc)
            # by ordinal, not epoch: see MedianPruner
            pruner.report(len(history) - 1, acc)

        try:
            score = _run_trial(args, data_cfg, all_weights[i], f"trial_{i}", epoch_callback=cb,
                               mesh=mesh)
        except TrialPruned as e:
            # as in optuna, only complete trials can be best
            print(f"trial {i}: {all_weights[i]} pruned ({e})")
            return float("-inf"), all_weights[i]
        pruner.complete(history)
        print(f"trial {i}: {all_weights[i]} -> {score:.4f}")
        return score, all_weights[i]

    if n_jobs > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=n_jobs) as pool:
            results = list(pool.map(trial, range(args.n_trials)))
    else:
        results = [trial(i) for i in range(args.n_trials)]
    best_score, best_weights = max(results, key=lambda r: r[0])
    print(f"Best trial: {best_score:.4f} {best_weights}")
    return best_weights
