"""What a traced run hands to the per-layer metric readers
(``metrics/<name>.py``, each a ``read(readings) -> float | None``)."""

from __future__ import annotations

import dataclasses
import typing as t

from portbench.trace import Trace


@dataclasses.dataclass
class Readings:
    kind: str  # the traffic's kind: "train", "serve"
    config: t.Dict[str, t.Any]
    traffic: t.Dict[str, t.Any]
    chips: int
    #: images a second of the run's measured window (outside the sub-window)
    rate: float
    trace: Trace
    #: the program's kernel launches in the sub-window, by kernel
    #: (``vision_mtl_tpu_torch.kernels.launch_counts`` differences)
    launches: t.Dict[str, int]
    #: train steps run in the sub-window
    steps: int = 0
    #: ``BatchingServer.stats()`` counts over the window, and their
    #: differences over the sub-window
    serve_window: t.Dict[str, float] = dataclasses.field(default_factory=dict)
    serve_traced: t.Dict[str, float] = dataclasses.field(default_factory=dict)
