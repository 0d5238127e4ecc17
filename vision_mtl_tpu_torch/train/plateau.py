"""ReduceLROnPlateau with torch's semantics, stepped on the host between
epochs (counterpart of ``vision_mtl_tpu/train/plateau.py``).

The loop steps it on the summed validation loss with patience 2 and factor
0.9, as the reference does. The learning rate lives in the optimizer
(``train/state.set_lr``)."""

from __future__ import annotations

import dataclasses
import typing as t


@dataclasses.dataclass
class ReduceLROnPlateau:
    patience: int = 2
    factor: float = 0.9
    threshold: float = 1e-4  # torch's default, relative mode
    min_lr: float = 0.0

    best: float = float("inf")
    num_bad_epochs: int = 0

    def step(self, metric: float, lr: float) -> float:
        """Feed the monitored value; returns the (possibly reduced) lr."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            lr = max(lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return lr

    def state_dict(self) -> t.Dict[str, t.Any]:
        return {
            "patience": self.patience,
            "factor": self.factor,
            "threshold": self.threshold,
            "min_lr": self.min_lr,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
        }

    def load_state_dict(self, d: t.Dict[str, t.Any]) -> None:
        for k, v in d.items():
            setattr(self, k, v)
