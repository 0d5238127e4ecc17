"""The mesh of ranks (counterpart of ``vision_mtl_tpu/parallel/mesh.py``).

The JAX package names three mesh axes: ``data`` (the batch), ``spatial``
(image rows, with GSPMD's halo exchanges around every conv) and ``model``
(conv kernels' output channels). The port runs ``data`` and ``spatial``:
one rank per process, each with the whole model, holding its block of
every global batch, the statistics and gradients made global by
collectives (``parallel/multihost.py``). ``model`` of a size above 1 is
refused naming ROADMAP.md A10c.

The layout is JAX's: the ranks are laid out as ``devices.reshape(sizes)``
in the spec's axis order, so rank r has the mesh coordinates
``np.unravel_index(r, sizes)``; dim 0 of a batch leaf is split over
``data`` and, for a leaf of three dims or more, dim 1 (H) over ``spatial``
(``_leaf_spec`` there). Rank r holds batch rows ``[d B/D, (d+1) B/D)`` and
image rows ``[s H/S, (s+1) H/S)``. The ranks that share a data index form
the rank's spatial group (:attr:`Mesh.spatial_comm`): the halo exchanges of
``parallel/halo.py`` run in it. Every H that a model's levels see must
split evenly: :func:`check_rows` refuses the others (GSPMD would pad them).

Spec strings are JAX's: ``"data:-1"`` (every rank), ``"data:2,spatial:2"``,
with the world size in place of the device count.

``shard_state``, ``put_replicated`` and ``replicate_gather`` have no
counterpart. Under ``data`` and ``spatial`` every rank holds the whole
state: each builds it from the same seed (or restores the same
checkpoint), and the train step's one gradient all-reduce keeps the copies
bit for bit equal, so there is nothing to place. Outputs come back whole on
every rank through :meth:`Mesh.gather`, as JAX's replicated outputs do.
"""

from __future__ import annotations

import dataclasses
import typing as t

import numpy as np
import torch

from vision_mtl_tpu_torch.parallel.multihost import (
    Comm,
    all_gather_exact,
    current,
    global_batch_from_local,
)

#: the full vocabulary of mesh axes the framework understands
MESH_AXES = ("data", "spatial", "model")
#: the axes the port runs
PORTED_AXES = ("data", "spatial")


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
    """SystemExit for an axis other than ``data`` and ``spatial`` of a size
    above 1 (``model``)."""
    unported = {k: v for k, v in axes.items() if k not in PORTED_AXES and v > 1}
    if unported:
        raise SystemExit(
            f"--mesh_shape {spec!r}: the {' and '.join(sorted(unported))} axis is not ported "
            "to vision_mtl_tpu_torch yet (conv kernels sharded by output channel, sharded Adam "
            "moments, all-gathered activations), see ROADMAP.md A10c; the port runs the data "
            "and spatial axes"
        )


def check_rows(height: int, spatial: int, row_stride: int, what: str = "the model") -> None:
    """SystemExit unless ``height`` divides by ``spatial * row_stride``:
    the coarsest level of ``what`` (``row_stride`` times smaller than the
    image) must leave every rank of the ``spatial`` axis the same whole
    number of rows. A no-op for ``spatial`` 1."""
    if spatial > 1 and height % (spatial * row_stride):
        raise SystemExit(
            f"image height {height} does not split over the spatial axis of {spatial}: "
            f"{what} downsamples rows by {row_stride}, so the height must divide by "
            f"spatial x {row_stride} = {spatial * row_stride} (ROADMAP.md A10b)"
        )


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a run laid out on the mesh's axes: ``shape`` maps each
    axis to its size (JAX's ``mesh.shape``), ``comm`` is this rank's place
    in the group and its collectives."""

    shape: t.Dict[str, int]
    comm: Comm
    _groups: t.Dict[str, t.Optional[Comm]] = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    @property
    def world(self) -> int:
        return self.comm.world

    @property
    def rank(self) -> int:
        return self.comm.rank

    @property
    def device(self) -> torch.device:
        return self.comm.device

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coords(self, rank: t.Optional[int] = None) -> t.Dict[str, int]:
        """The mesh coordinates of ``rank`` (this rank by default)."""
        rank = self.rank if rank is None else rank
        index = np.unravel_index(rank, tuple(self.shape.values()))
        return {axis: int(i) for axis, i in zip(self.shape, index)}

    def batch_rows(self, batch_size: int, rank: t.Optional[int] = None) -> slice:
        """The rows of a global batch of ``batch_size`` that ``rank`` (this
        rank by default) holds."""
        d = self.coords(rank).get("data", 0)
        per = batch_size // self.size("data")
        return slice(d * per, (d + 1) * per)

    def image_rows(self, height: int, rank: t.Optional[int] = None) -> slice:
        """The image rows of a global height ``height`` that ``rank`` (this
        rank by default) holds."""
        s = self.coords(rank).get("spatial", 0)
        per = height // self.size("spatial")
        return slice(s * per, (s + 1) * per)

    @property
    def spatial_comm(self) -> t.Optional[Comm]:
        """The ranks that share this rank's data index, in spatial order
        (the halo exchanges' group); None without a ``spatial`` axis.
        Collective the first time under a process group: :func:`create_mesh`
        asks for it on every rank."""
        size = self.size("spatial")
        if size <= 1:
            return None
        if "spatial" not in self._groups:
            if size == self.world:
                self._groups["spatial"] = self.comm
            else:  # one group per line of the mesh along the spatial axis
                ranks = np.arange(self.world).reshape(tuple(self.shape.values()))
                lines = np.moveaxis(ranks, list(self.shape).index("spatial"), -1)
                self._groups["spatial"] = self.comm.split(lines.reshape(-1, size).tolist())
        return self._groups["spatial"]

    def block(self, batch: t.Mapping[str, t.Any]) -> t.Dict[str, t.Any]:
        """This rank's block of a whole global batch (numpy arrays or
        tensors): rows on ``data``, and H on ``spatial`` for leaves of
        three dims or more (JAX's ``_leaf_spec``)."""
        out = {}
        for k, v in batch.items():
            part = v[self.batch_rows(v.shape[0])] if v.ndim >= 1 else v
            if v.ndim >= 3 and self.size("spatial") > 1:
                part = part[:, self.image_rows(v.shape[1])]
            out[k] = part
        return out

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block of it (:meth:`block`'s
        inverse), the same bits on every rank: an exact all-gather over the
        mesh, then each block put in its place (a leaf that ``spatial``
        does not split is taken from spatial index 0). Collective; not
        differentiable."""
        if self.world <= 1:
            return x
        parts = all_gather_exact(x, self.comm)  # (world, *block)
        split_h = x.dim() >= 3 and self.size("spatial") > 1
        b = x.shape[0] * self.size("data")
        shape = ((b, x.shape[1] * self.size("spatial"), *x.shape[2:]) if split_h
                 else (b, *x.shape[1:]))
        out = x.new_empty(shape)
        for r in range(self.world):
            c = self.coords(r)
            if not split_h and c.get("spatial", 0):
                continue
            rows = self.batch_rows(b, r)
            if split_h:
                out[rows, self.image_rows(shape[1], r)] = parts[r]
            else:
                out[rows] = parts[r]
        return out


def create_mesh(spec: str = "data:-1", comm: t.Optional[Comm] = None) -> Mesh:
    """The mesh of ``spec`` over the ranks of ``comm`` (the run's by
    default); refuses an unported axis (ROADMAP.md A10c). Collective: the
    spatial groups are made here, on every rank."""
    comm = comm or current()
    if comm is None:
        raise ValueError("create_mesh needs a process group (parallel.multihost)")
    axes = parse_mesh_shape(spec, comm.world)
    refuse_unported_axes(axes, spec)
    mesh = Mesh(axes, comm)
    mesh.spatial_comm  # noqa: B018  (the groups, made on every rank together)
    return mesh


def process_spanning_axes(mesh: t.Optional[Mesh]) -> t.Tuple[str, ...]:
    """Mesh axes whose shards live on more than one process: every axis of
    a size above 1, since each rank is a process with one device; ``()``
    with one rank."""
    if mesh is None or mesh.world <= 1:
        return ()
    return tuple(k for k, v in mesh.shape.items() if v > 1)


def local_batches(batches: t.Iterable[t.Mapping[str, t.Any]], mesh: t.Optional[Mesh]
                  ) -> t.Iterable[t.Mapping[str, t.Any]]:
    """The batches a loader yields, as this rank takes them: under a
    ``spatial`` axis the loaders decode whole global batches
    (``DataLoader.shard_rows`` False, set by
    ``data.datamodule.configure_host_sharded_loading``) and each rank keeps
    its block (:meth:`Mesh.block`, JAX's ``put_batch(full_local=True)``);
    otherwise they are already the rank's rows."""
    if mesh is None or mesh.size("spatial") <= 1:
        return batches
    if getattr(batches, "shard_rows", False):
        raise ValueError(
            "a row-sliced loader under the mesh's spatial axis: its ranks need whole batches "
            "(data.datamodule.configure_host_sharded_loading, DataLoader(shard_rows=False))"
        )
    return (mesh.block(b) for b in batches)


def put_batch(
    batch: t.Mapping[str, np.ndarray],
    mesh: t.Optional[Mesh],
    device: t.Union[str, torch.device, None] = None,
) -> t.Dict[str, torch.Tensor]:
    """A host batch on the device: under a mesh, this rank's block (what
    :func:`local_batches` yields) to its device; without one, to ``device``."""
    return global_batch_from_local(batch, mesh.device if mesh is not None else device)
