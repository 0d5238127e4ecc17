"""Preemption-safe training (counterpart of
``vision_mtl_tpu/train/preempt.py``).

A preemptible machine gets a SIGTERM and a short grace period before it
goes. ``PreemptionGuard`` turns the signal into a request that
``run_pipe`` honours at the next step boundary (or between validation
steps): it writes a mid-epoch checkpoint (``preempt_model/`` and
``preempt_session/``: the weights, the optimizer, the plateau scheduler,
the epoch's metric accumulators and the position ``(epoch,
batch_in_epoch)``) and exits 143. ``--resume_dir`` then continues where
training stopped: the loader replays the epoch's seeded order and skips
the batches already trained without decoding them, so the resumed run
ends with the uninterrupted run's weights.

Fault injection: ``VMTL_PREEMPT_AT_STEP=<k>`` (or ``inject_at_step=k``)
fires the guard once the global step reaches ``k``.

Several ranks decide together, as the JAX package's preemption sync point
does across hosts: a rank's SIGTERM or injected step sets its own flag, and
every poll takes the MAX of the flags over the ranks (one small host
all-reduce), so every rank sees the request at the same poll, saves with
the others and exits 143.
"""

from __future__ import annotations

import os
import signal
import typing as t

from vision_mtl_tpu_torch.parallel.multihost import Comm, current


class PreemptionGuard:
    """A polled preemption request. Construct it on the main thread (where
    Python runs signal handlers) before training starts, then call
    :meth:`requested` at every step boundary."""

    def __init__(
        self,
        signals: t.Sequence[int] = (signal.SIGTERM,),
        inject_at_step: t.Optional[int] = None,
        comm: t.Optional[Comm] = None,
    ):
        self._flag = False
        # the run's ranks, polled together; None or one rank: local only
        self._comm = comm if comm is not None else current()
        if inject_at_step is None:
            env = os.environ.get("VMTL_PREEMPT_AT_STEP")
            inject_at_step = int(env) if env else None
        self._inject_at = inject_at_step
        for s in signals:
            try:
                signal.signal(s, self._handle)
            except ValueError:
                # not the main thread: injection still works, signals cannot
                pass

    def _handle(self, signum: int, frame: t.Any) -> None:
        self._flag = True

    def requested(self, global_step: int) -> bool:
        """True once a signal arrived or the injected step is reached, on
        this rank or, under several ranks, on any (collective: every rank
        polls at the same points)."""
        local = self._flag or (self._inject_at is not None and global_step >= self._inject_at)
        if self._comm is None or self._comm.world <= 1:
            return local
        return bool(self._comm.host_all_reduce([int(local)], "max")[0])
