"""Several processes over ``torch.distributed`` (counterpart of
``vision_mtl_tpu/parallel/multihost.py``): one rank per process, each
decoding only its rows of every global batch (the mesh's ``data`` axis),
or the whole batch, of which it keeps its block (the ``spatial`` axis:
``parallel/mesh.local_batches``, JAX's full-batch mode).

A launcher (``torchrun``, or ``--device cpu:N`` through
:func:`launch_local_ranks`) sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``; :func:`maybe_initialize_distributed`
joins the process group before any other work, and the run's
:class:`Comm` gives the collectives the steps need:

  * :func:`all_reduce_sum`, whose backward sums too: a global sum that every
    rank holds (the losses' sums, the BatchNorm gradient's two per-channel
    sums);
  * :func:`all_gather_exact`: the ranks' tensors stacked in rank order, built
    from a sum all-reduce of a zero-filled ``(world, ...)`` buffer in which
    each rank wrote its own row. ``x + 0`` is exact, so every rank ends with
    the same bits. gloo reduces CUDA tensors, and is documented for
    ``all_reduce`` and ``broadcast`` alone on them, so the steps use nothing
    else on the device;
  * host-side agreement over CPU integers (:func:`all_processes_agree`, the
    preemption poll) and object broadcasts (the logger's run dir);
  * :meth:`Comm.split`: the group of some of the ranks (the mesh's
    spatial groups, where ``parallel/halo.py`` exchanges rows).

Every rank computes the global loss, so every rank back-propagates ``1 /
world`` of it and the parameter gradients are summed across the ranks
(``train/step.py``): the backward of each sum all-reduce then hands every
rank the adjoint of its own rows, and the summed gradients are the
one-process gradient of the global batch.

The batch statistics of the train-mode BatchNorms and of the attention gate
(kernel B4) are global while :func:`global_batch` is active: the train and
eval steps enter it with the mesh's :class:`Comm`. A run of one process
calls no collective.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import itertools
import os
import socket
import subprocess
import sys
import threading
import time
import typing as t
import zlib

import numpy as np
import torch
import torch.distributed as dist

#: the launcher's environment: torchrun's names
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


class Comm:
    """This process's place in a group of ranks and the group's collectives.

    ``group`` reduces device tensors (None: the default process group, NCCL
    when every rank on the host has a card of its own, gloo otherwise);
    ``host_group`` reduces CPU tensors and broadcasts objects (a gloo group
    beside NCCL; None, the default group, when that is gloo). The
    primitives :meth:`all_reduce_`, :meth:`host_all_reduce`,
    :meth:`broadcast_object`, :meth:`barrier` and :meth:`split` are all that
    the rest of the port calls; an in-process group (:class:`ThreadComm`)
    overrides them."""

    def __init__(
        self,
        rank: int,
        world: int,
        device: t.Union[str, torch.device] = "cpu",
        host_group: t.Any = None,
        group: t.Any = None,
    ):
        self.rank, self.world = rank, world
        self.device = torch.device(device)
        self.host_group = host_group
        self.group = group
        self._calls: t.Dict[str, t.Iterator[int]] = {}

    def next_call(self, kind: str) -> int:
        """This rank's count of its earlier calls of ``kind`` (0, 1, ...):
        ranks that make the same calls in the same order agree on it."""
        return next(self._calls.setdefault(kind, itertools.count()))

    def all_reduce_(self, tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``tensor`` in place on its device; returns it."""
        dist.all_reduce(tensor, op=getattr(dist.ReduceOp, _OPS[op]), group=self.group)
        return tensor

    def host_all_reduce(self, values: t.Sequence[int], op: str) -> t.List[int]:
        """Reduce a list of Python ints over the ranks."""
        buf = torch.tensor(list(values), dtype=torch.int64)
        dist.all_reduce(buf, op=getattr(dist.ReduceOp, _OPS[op]), group=self.host_group)
        return buf.tolist()

    def broadcast_object(self, obj: t.Any, src: int = 0) -> t.Any:
        """``obj`` of rank ``src`` on every rank (picklable)."""
        box = [obj]
        if self.host_group is not None:
            src = dist.get_global_rank(self.host_group, src)
        dist.broadcast_object_list(box, src=src, group=self.host_group)
        return box[0]

    def barrier(self) -> None:
        dist.barrier(group=self.host_group)

    def split(self, groups: t.Sequence[t.Sequence[int]]) -> "Comm":
        """This rank's :class:`Comm` among ``groups``, a partition of the
        ranks into lists (a rank's place in its list is its rank there).
        Collective: every rank calls it with the same ``groups``, since
        ``torch.distributed.new_group`` must see every group on every rank
        in the same order; beside an NCCL group each gets a gloo one for the
        host."""
        mine: t.Optional[Comm] = None
        for ranks in groups:
            ranks = [int(r) for r in ranks]
            group = dist.new_group(ranks)
            host = dist.new_group(ranks, backend="gloo") if self.host_group is not None else group
            if self.rank in ranks:
                mine = Comm(ranks.index(self.rank), len(ranks), self.device,
                            host_group=host, group=group)
        if mine is None:
            raise ValueError(f"rank {self.rank} is in none of the groups {groups}")
        return mine


class ThreadGroup:
    """``world`` threads of one process acting as ranks: each
    :meth:`exchange` hands every thread the values of all, in rank order."""

    def __init__(self, world: int, timeout: float = 600.0):
        self.world = world
        self.timeout = timeout
        self._slots: t.List[t.Any] = [None] * world
        self._barrier = threading.Barrier(world, timeout=timeout)
        self._subgroups: t.Dict[t.Tuple[int, ...], "ThreadGroup"] = {}
        self._lock = threading.Lock()

    def subgroup(self, ranks: t.Sequence[int]) -> "ThreadGroup":
        """The group of the threads ``ranks``, the same object for every
        thread that asks."""
        key = tuple(int(r) for r in ranks)
        with self._lock:
            if key not in self._subgroups:
                self._subgroups[key] = ThreadGroup(len(key), self.timeout)
            return self._subgroups[key]

    def exchange(self, rank: int, value: t.Any) -> t.List[t.Any]:
        self._slots[rank] = value
        self._barrier.wait()
        out = list(self._slots)
        self._barrier.wait()  # nobody overwrites a slot before all have read
        return out


class ThreadComm(Comm):
    """A rank of a :class:`ThreadGroup`: the collectives of ``world`` ranks
    in one process, one thread each, on tensors of one device. Sums are
    taken in rank order. For tests and for checks on one card; a run's ranks
    are processes."""

    def __init__(self, threads: ThreadGroup, rank: int, device: t.Union[str, torch.device] = "cpu"):
        super().__init__(rank, threads.world, device)
        self.threads = threads

    def all_reduce_(self, tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
        parts = self.threads.exchange(self.rank, tensor.clone())
        out = parts[0].clone()
        for p in parts[1:]:
            if op == "sum":
                out += p
            else:
                out = torch.minimum(out, p) if op == "min" else torch.maximum(out, p)
        return tensor.copy_(out)

    def host_all_reduce(self, values: t.Sequence[int], op: str) -> t.List[int]:
        parts = self.threads.exchange(self.rank, list(values))
        fn = {"sum": sum, "min": min, "max": max}[op]
        return [fn(col) for col in zip(*parts)]

    def broadcast_object(self, obj: t.Any, src: int = 0) -> t.Any:
        return self.threads.exchange(self.rank, obj)[src]

    def barrier(self) -> None:
        self.threads.exchange(self.rank, None)

    def split(self, groups: t.Sequence[t.Sequence[int]]) -> "ThreadComm":
        (ranks,) = [list(g) for g in groups if self.rank in g]
        return ThreadComm(self.threads.subgroup(ranks), ranks.index(self.rank), self.device)


_COMM: t.Optional[Comm] = None
#: set when this module initialised the process group (and so tears it down)
_OWNS_GROUP = False


def current() -> t.Optional[Comm]:
    """The run's :class:`Comm`, or None in a run of one process."""
    return _COMM


def process_info() -> t.Tuple[int, int]:
    """(rank, world size); (0, 1) in a run of one process."""
    return (_COMM.rank, _COMM.world) if _COMM is not None else (0, 1)


def rank_device(device: t.Union[str, torch.device], local_rank: int) -> torch.device:
    """A rank's device: ``cuda:(LOCAL_RANK % device_count)`` for the card,
    the CPU for the CPU. Raises for a card that is not there."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; pass "
            "device='cpu' (--device cpu) to run the ranks on the CPU"
        )
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def pick_backend(device: torch.device, local_world: int) -> str:
    """NCCL when every rank on the host has a card of its own, gloo on the
    CPU and when ranks share a card (NCCL refuses two ranks on one
    device)."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def maybe_initialize_distributed(
    device: t.Union[str, torch.device] = "cuda", timeout_s: float = 600.0
) -> bool:
    """Join the process group when a launcher started this process; a no-op
    without any launch marker. Returns True when it initialised the group.

    A partial launch environment raises, and so does a failed init: going
    on as one process would let every process train alone, each its own
    run. A default group that the caller initialised already (for example
    from a store) is adopted, launcher or not. Sets the rank's card as the
    current one."""
    global _COMM, _OWNS_GROUP
    if dist.is_initialized():
        _adopt(device)
        return False
    env = os.environ
    present = [v for v in LAUNCH_VARS if env.get(v)]
    if not present:
        return False
    missing = [v for v in LAUNCH_VARS if not env.get(v)]
    if missing:
        raise RuntimeError(
            "multi-process launch detected ("
            + ", ".join(f"{v}={env[v]!r}" for v in present)
            + f") but {', '.join(missing)} not set; a launcher (torchrun) sets all of "
            + ", ".join(LAUNCH_VARS)
        )
    try:
        rank, world, local_rank = (int(env[v]) for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    except ValueError as e:
        raise RuntimeError(
            f"multi-process launch detected but RANK={env['RANK']!r} / WORLD_SIZE="
            f"{env['WORLD_SIZE']!r} / LOCAL_RANK={env['LOCAL_RANK']!r} are not integers; "
            "fix the launcher environment."
        ) from e
    dev = rank_device(device, local_rank)
    backend = pick_backend(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(
            backend,
            init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        host_group = dist.new_group(backend="gloo") if backend != "gloo" else None
    except Exception as e:
        raise RuntimeError(
            f"torch.distributed.init_process_group({backend!r}) failed under a multi-process "
            f"launcher (rank {rank} of {world} at {env['MASTER_ADDR']}:{env['MASTER_PORT']}). "
            f"Original error: {type(e).__name__}: {e}"
        ) from e
    _COMM = Comm(rank, world, dev, host_group=host_group)
    _OWNS_GROUP = True
    return True


def _adopt(device: t.Union[str, torch.device]) -> None:
    """Take an initialised default group as the run's (gloo or NCCL; a
    gloo side group for the host when it is NCCL)."""
    global _COMM
    if _COMM is not None:
        return
    local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    host_group = dist.new_group(backend="gloo") if dist.get_backend() != "gloo" else None
    _COMM = Comm(dist.get_rank(), dist.get_world_size(), dev, host_group=host_group)


def shutdown_distributed() -> None:
    """Leave the process group together: a barrier, then
    ``destroy_process_group``. A no-op unless
    :func:`maybe_initialize_distributed` initialised it. Best effort."""
    global _COMM, _OWNS_GROUP
    if not _OWNS_GROUP:
        return
    try:
        if _COMM is not None:
            _COMM.barrier()
        dist.destroy_process_group()
    except Exception as e:  # teardown is best effort
        print(f"torch.distributed shutdown: {type(e).__name__}: {e}")
    finally:
        _COMM, _OWNS_GROUP = None, False


def all_processes_agree(flag: bool, what: str, comm: t.Optional[Comm] = None) -> bool:
    """True iff ``flag`` is True on every rank: a MIN all-reduce. Guards a
    collective behind per-rank state that may differ (a rank whose
    benchmark batch failed to load), since a collective reached by some
    ranks only hangs the others.

    Collective itself: every rank calls it the same number of times with the
    same ``what``. Each call is keyed by ``what`` and a per-process call
    counter, as the JAX package keys its KV tags, and a rank whose key
    differs raises. One process: ``flag``."""
    comm = comm or _COMM
    if comm is None or comm.world <= 1:
        return flag
    seq = comm.next_call("agree")
    key = zlib.crc32(f"vmtl_agree:{what}:{seq}".encode())
    agreed, key_min, neg_key_min = comm.host_all_reduce([int(bool(flag)), key, -key], "min")
    if key_min != -neg_key_min:
        raise RuntimeError(
            f"all_processes_agree({what!r}) call {seq}: the ranks called it out of step "
            "(every rank must make the same calls in the same order)"
        )
    return agreed == 1


def process_index_range(
    dataset_len: int,
    process_index: t.Optional[int] = None,
    process_count: t.Optional[int] = None,
) -> range:
    """This rank's contiguous slice of the dataset's indices. Every rank
    gets ``dataset_len // process_count`` of them and the remainder is
    dropped: a rank with one batch more would call a collective the others
    never join."""
    pi, pc = process_info()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    per = dataset_len // pc
    return range(pi * per, pi * per + per)


def global_batch_from_local(
    local_batch: t.Mapping[str, np.ndarray], device: t.Union[str, torch.device]
) -> t.Dict[str, torch.Tensor]:
    """This rank's block of the global batch as tensors on its device. The
    global batch exists only as the ranks' blocks: the steps' collectives
    (:func:`global_batch`) make each statistic global."""
    dev = torch.device(device)
    return {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in local_batch.items()}


# ---- the collectives of the steps -------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, comm: Comm) -> torch.Tensor:
        ctx.comm = comm
        return comm.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> t.Tuple[torch.Tensor, None]:
        return ctx.comm.all_reduce_(grad.contiguous().clone()), None


def all_reduce_sum(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank; differentiable, its
    backward a sum all-reduce of the gradient."""
    return _AllReduceSum.apply(x, comm)


def all_gather_exact(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """``(world, *x.shape)``: every rank's ``x`` in rank order, the same bits
    on every rank (a sum all-reduce of a zero-filled buffer holding this
    rank's row). Not differentiable."""
    buf = torch.zeros((comm.world, *x.shape), dtype=x.dtype, device=x.device)
    buf[comm.rank] = x.detach()
    return comm.all_reduce_(buf)


_BATCH_COMM: "contextvars.ContextVar[t.Optional[Comm]]" = contextvars.ContextVar(
    "vmtl_batch_comm", default=None
)


@contextlib.contextmanager
def global_batch(comm: t.Optional[Comm]) -> t.Iterator[None]:
    """Within the block, train-mode batch statistics and the losses are
    taken over the ranks' rows together (a ``comm`` of one rank, or None,
    changes nothing)."""
    token = _BATCH_COMM.set(comm if comm is not None and comm.world > 1 else None)
    try:
        yield
    finally:
        _BATCH_COMM.reset(token)


def batch_comm() -> t.Optional[Comm]:
    """The :class:`Comm` of the enclosing :func:`global_batch`, or None."""
    return _BATCH_COMM.get()


def combine_moments(parts: torch.Tensor) -> torch.Tensor:
    """Chan's combination of per-rank ``(rows, mean, M2)`` partials,
    ``parts`` (world, 3, ...), in rank order in the parts' dtype: returns
    (3, ...) ``(rows, mean, M2)`` of the union. One rank's partial comes
    back as it is."""
    n, mean, m2 = parts[0].unbind(0)
    for r in range(1, parts.shape[0]):
        nb, mb, m2b = parts[r].unbind(0)
        nab = n + nb
        d = mb - mean
        mean = mean + d * (nb / nab)
        m2 = m2 + m2b + d * d * (n * nb / nab)
        n = nab
    return torch.stack([n, mean, m2])


# ---- local ranks: --device cpu:N --------------------------------------------


def free_port() -> int:
    """A TCP port free on this host's loopback now (for a launcher's
    ``MASTER_PORT``)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local_ranks(
    module: str, argv: t.Sequence[str], world: int, grace_s: float = 60.0
) -> t.Dict[str, t.Any]:
    """Run ``python -m module *argv`` as ``world`` gloo ranks on the CPU of
    this host, one torch thread each, with torchrun's environment; waits
    for all. A rank that fails fails the run: the others get ``grace_s``
    seconds to end (they may be blocked in a collective), then are killed,
    and SystemExit carries the first failure's exit code. Returns
    ``{"returncodes": [...]}`` when every rank exited 0."""
    env = dict(os.environ)
    env.update({
        "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
        "OMP_NUM_THREADS": "1",
    })
    procs = []
    for r in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv],
            env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        ))
    failed_at: t.Optional[float] = None
    try:
        while any(p.poll() is None for p in procs):
            codes = [p.returncode for p in procs]
            if failed_at is None and any(c not in (None, 0) for c in codes):
                failed_at = time.monotonic()
            if failed_at is not None and time.monotonic() - failed_at > grace_s:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        print(f"ranks exited with {codes}")
        failures = [c for c in codes if c > 0]
        raise SystemExit(failures[0] if failures else 1)
    return {"returncodes": codes}
