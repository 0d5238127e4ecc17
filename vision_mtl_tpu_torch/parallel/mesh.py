"""The mesh of ranks (counterpart of ``vision_mtl_tpu/parallel/mesh.py``).

The JAX package names three mesh axes: ``data`` (the batch), ``spatial``
(image rows, with GSPMD's halo exchanges around every conv) and ``model``
(conv kernels' output channels). The port runs the ``data`` axis: one rank
per process, each with the whole model and its rows of every global batch,
the statistics and gradients made global by collectives
(``parallel/multihost.py``). ``spatial`` or ``model`` of a size above 1 is
refused naming ROADMAP.md A10b.

Spec strings are JAX's: ``"data:-1"`` (every rank), ``"data:2"``, with
the world size in place of the device count.

``shard_state``, ``put_replicated`` and ``replicate_gather`` have no
counterpart. Under the data axis every rank holds the whole state: each
builds it from the same seed (or restores the same checkpoint), and the
train step's one gradient all-reduce keeps the copies bit for bit equal, so
there is nothing to place or gather. A rank never receives weights it did
not load.
"""

from __future__ import annotations

import dataclasses
import typing as t

import numpy as np
import torch

from vision_mtl_tpu_torch.parallel.multihost import Comm, current, global_batch_from_local

#: the full vocabulary of mesh axes the framework understands
MESH_AXES = ("data", "spatial", "model")
#: the axes the port runs
PORTED_AXES = ("data",)


def parse_mesh_shape(spec: str, num_devices: t.Optional[int] = None) -> t.Dict[str, int]:
    """Parse "axis:size,axis:size" with at most one -1 wildcard, against
    ``num_devices`` ranks (the world size by default)."""
    if num_devices is None:
        comm = current()
        num_devices = comm.world if comm is not None else 1
    axes: t.Dict[str, int] = {}
    for part in spec.split(","):
        name, _, size = part.strip().partition(":")
        if name not in MESH_AXES:
            raise ValueError(
                f"Unknown mesh axis {name!r} in {spec!r}; "
                f"valid axes: {', '.join(MESH_AXES)}"
            )
        if name in axes:
            raise ValueError(f"Duplicate mesh axis {name!r} in {spec!r}")
        axes[name] = int(size) if size else -1
    wild = [k for k, v in axes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError(f"At most one -1 in mesh spec, got {spec!r}")
    fixed = int(np.prod([v for v in axes.values() if v != -1]))
    if wild:
        if num_devices % fixed:
            raise ValueError(f"Mesh spec {spec!r} does not divide {num_devices} devices")
        axes[wild[0]] = num_devices // fixed
    total = int(np.prod(list(axes.values())))
    if total != num_devices:
        raise ValueError(f"Mesh spec {spec!r} uses {total} devices, have {num_devices}")
    return axes


def refuse_unported_axes(axes: t.Mapping[str, int], spec: str) -> None:
    """SystemExit for an axis other than ``data`` of a size above 1."""
    unported = {k: v for k, v in axes.items() if k not in PORTED_AXES and v > 1}
    if unported:
        raise SystemExit(
            f"--mesh_shape {spec!r}: the {' and '.join(sorted(unported))} axis is not ported "
            "to vision_mtl_tpu_torch yet (its halo exchanges and sharded kernels), see "
            "ROADMAP.md A10b; the port runs the data axis"
        )


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a run laid out on the mesh's axes: ``shape`` maps each
    axis to its size (JAX's ``mesh.shape``), ``comm`` is this rank's place
    in the group and its collectives."""

    shape: t.Dict[str, int]
    comm: Comm

    @property
    def world(self) -> int:
        return self.comm.world

    @property
    def rank(self) -> int:
        return self.comm.rank

    @property
    def device(self) -> torch.device:
        return self.comm.device


def create_mesh(spec: str = "data:-1", comm: t.Optional[Comm] = None) -> Mesh:
    """The mesh of ``spec`` over the ranks of ``comm`` (the run's by
    default); refuses an unported axis (ROADMAP.md A10b)."""
    comm = comm or current()
    if comm is None:
        raise ValueError("create_mesh needs a process group (parallel.multihost)")
    axes = parse_mesh_shape(spec, comm.world)
    refuse_unported_axes(axes, spec)
    return Mesh(axes, comm)


def process_spanning_axes(mesh: t.Optional[Mesh]) -> t.Tuple[str, ...]:
    """Mesh axes whose shards live on more than one process: every axis of
    a size above 1, since each rank is a process with one device; ``()``
    with one rank."""
    if mesh is None or mesh.world <= 1:
        return ()
    return tuple(k for k, v in mesh.shape.items() if v > 1)


def put_batch(
    batch: t.Mapping[str, np.ndarray],
    mesh: t.Optional[Mesh],
    device: t.Union[str, torch.device, None] = None,
) -> t.Dict[str, torch.Tensor]:
    """A host batch on the device: under a mesh, this rank's rows (the
    loader decoded only those) to its device; without one, to ``device``."""
    return global_batch_from_local(batch, mesh.device if mesh is not None else device)
