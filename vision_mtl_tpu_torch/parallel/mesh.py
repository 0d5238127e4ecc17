"""The mesh of ranks (counterpart of ``vision_mtl_tpu/parallel/mesh.py``).

The JAX package names three mesh axes, and the port runs all three, one
rank per process: ``data`` (the batch), ``spatial`` (image rows, with
GSPMD's halo exchanges around every conv) and ``model`` (conv kernels'
output channels). Each rank holds its block of every global batch, the
statistics and gradients made global by collectives
(``parallel/multihost.py``).

The layout is JAX's: the ranks are laid out as ``devices.reshape(sizes)``
in the spec's axis order, so rank r has the mesh coordinates
``np.unravel_index(r, sizes)``; dim 0 of a batch leaf is split over
``data`` and, for a leaf of three dims or more, dim 1 (H) over ``spatial``
(``_leaf_spec`` there). Rank r holds batch rows ``[d B/D, (d+1) B/D)`` and
image rows ``[s H/S, (s+1) H/S)``; the ranks that differ only in their
``model`` index hold the same block. The ranks that share a data (and
model) index form the rank's spatial group (:attr:`Mesh.spatial_comm`):
the halo exchanges of ``parallel/halo.py`` run in it. The image's H must
divide by the ``spatial`` axis (:func:`check_rows`, as JAX's ``put_batch``
requires); a model's coarser levels whose rows do not split (where GSPMD
pads) run whole on every rank of the spatial group, their batch-wide sums
over the rank's data group (:attr:`Mesh.data_comm`, the ranks that share
its spatial and model index).

The ``model`` axis shards parameters (:func:`param_shardings`, JAX's rule:
a leaf of two dims or more, of ``min_size`` values or more, whose last JAX
dim, the output channels, divides the axis). :func:`shard_state` swaps each
such parameter for this rank's slice (:class:`Slice`) and gives Adam the
slices, so its moments take the same layout. The ranks that share the data
and spatial index form the rank's model group (:attr:`Mesh.model_comm`): a
sharded conv computes its slice of the output channels and the slices are
gathered over the group (``multihost.copy_in`` / ``gather_out``), so all
that follows runs the same on every rank of the group. The ranks that share
the model index form its replica group (:attr:`Mesh.replica_comm`): the
batch-wide sums (BatchNorm and gate statistics, the losses, the metrics,
the sharded leaves' gradients) run over it. :func:`full_state_dict` and
:func:`load_full_state_dict` (and their optimizer counterparts) are JAX's
``replicate_gather`` and ``put_replicated`` for checkpoints: each sharded
leaf whole, and cut again. Outputs come back whole on every rank through
:meth:`Mesh.gather`, as JAX's replicated outputs do.

Spec strings are JAX's: ``"data:-1"`` (every rank), ``"data:2,model:2"``,
with the world size in place of the device count.
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
#: JAX's ``param_shardings`` default: smaller leaves stay replicated
MIN_SHARD_SIZE = 2**16


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


def check_rows(height: int, spatial: int) -> None:
    """SystemExit unless ``height`` divides by ``spatial``: JAX's rule, whose
    ``put_batch`` shards a batch's H (dim 1) over the ``spatial`` axis and
    whose ``device_put`` refuses a dim that the axis does not divide. Any
    level of a model below the image may leave a remainder (it then runs
    whole, ``parallel/halo.py``). A no-op for ``spatial`` 1."""
    if spatial > 1 and height % spatial:
        raise SystemExit(
            f"image height {height} does not divide over the spatial axis of {spatial}: "
            "the batch's dim 1 (H) is sharded over spatial, so its global size must be "
            f"divisible by {spatial} (JAX's put_batch / device_put rule)"
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

    def _group(self, key: str, axes: t.Tuple[str, ...]) -> t.Optional[Comm]:
        """The ranks that differ from this one only along ``axes``, ordered
        by their coordinates there (row-major in the mesh's axis order);
        None when that is one rank. Collective the first time under a
        process group: :func:`create_mesh` asks for every group on every
        rank."""
        axes = tuple(a for a in self.shape if a in axes)
        size = int(np.prod([self.size(a) for a in axes])) if axes else 1
        if size <= 1:
            return None
        if key not in self._groups:
            if size == self.world:
                self._groups[key] = self.comm
            else:  # one group per line (or plane) of the mesh along the axes
                names = list(self.shape)
                ranks = np.arange(self.world).reshape(tuple(self.shape.values()))
                lines = np.moveaxis(ranks, [names.index(a) for a in axes],
                                    list(range(-len(axes), 0)))
                self._groups[key] = self.comm.split(lines.reshape(-1, size).tolist())
        return self._groups[key]

    @property
    def spatial_comm(self) -> t.Optional[Comm]:
        """The ranks that share this rank's data and model index, in spatial
        order (the halo exchanges' group); None without a ``spatial``
        axis."""
        return self._group("spatial", ("spatial",))

    @property
    def data_comm(self) -> t.Optional[Comm]:
        """The ranks that share this rank's spatial and model index, in data
        order: the ranks that hold other images, the group of the
        batch-wide sums at a level that runs whole (``parallel/halo.py``);
        None without a ``data`` axis."""
        return self._group("data", ("data",))

    @property
    def model_comm(self) -> t.Optional[Comm]:
        """The ranks that share this rank's data and spatial index, in model
        order: this rank's model group, over which a sharded leaf's slices
        and a sharded layer's output channels are gathered; None without a
        ``model`` axis."""
        return self._group("model", ("model",))

    @property
    def replica_comm(self) -> t.Optional[Comm]:
        """The ranks that share this rank's model index (its data x spatial
        ranks, the whole world without a ``model`` axis): the group of every
        batch-wide sum, and of the sharded leaves' gradient sum; None for
        one rank."""
        return self._group("replica", ("data", "spatial"))

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
            if c.get("model", 0) or (not split_h and c.get("spatial", 0)):
                continue
            rows = self.batch_rows(b, r)
            if split_h:
                out[rows, self.image_rows(shape[1], r)] = parts[r]
            else:
                out[rows] = parts[r]
        return out


def create_mesh(spec: str = "data:-1", comm: t.Optional[Comm] = None) -> Mesh:
    """The mesh of ``spec`` over the ranks of ``comm`` (the run's by
    default). Collective: the spatial, model and replica groups are made
    here, on every rank."""
    comm = comm or current()
    if comm is None:
        raise ValueError("create_mesh needs a process group (parallel.multihost)")
    mesh = Mesh(parse_mesh_shape(spec, comm.world), comm)
    # the groups, made on every rank together and in the same order
    mesh.spatial_comm, mesh.model_comm, mesh.replica_comm  # noqa: B018
    if mesh.spatial_comm is not None:
        mesh.data_comm  # noqa: B018
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
    ``spatial`` or ``model`` axis the loaders decode whole global batches
    (``DataLoader.shard_rows`` False, set by
    ``data.datamodule.configure_host_sharded_loading``) and each rank keeps
    its block (:meth:`Mesh.block`, JAX's ``put_batch(full_local=True)``);
    otherwise they are already the rank's rows."""
    if mesh is None or not set(process_spanning_axes(mesh)) - {"data"}:
        return batches
    if getattr(batches, "shard_rows", False):
        raise ValueError(
            "a row-sliced loader under the mesh's spatial or model axis: its ranks need whole "
            "batches (data.datamodule.configure_host_sharded_loading, "
            "DataLoader(shard_rows=False))"
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


# ---- the model axis: parameters sharded by output channel -----------------------


@dataclasses.dataclass(frozen=True)
class Slice:
    """This rank's part of a parameter sharded over the mesh's ``model``
    axis: part ``index`` of ``count`` equal ones along torch dim ``dim`` of
    the whole leaf, of ``shape``; ``comm`` is the model group. A module
    whose parameter ``name`` is such a part holds it in its ``slices``
    dict under ``name``."""

    dim: int
    index: int
    count: int
    shape: t.Tuple[int, ...]
    comm: Comm = dataclasses.field(compare=False, repr=False)

    def of(self, whole: torch.Tensor, dim: t.Optional[int] = None) -> torch.Tensor:
        """This rank's part of ``whole``: a tensor of the leaf's shape, or
        along ``dim`` one whose dim ``dim`` the slices split alike (a
        depthwise conv's input channels)."""
        dim = self.dim if dim is None else dim
        size = whole.shape[dim] // self.count
        return whole.narrow(dim, self.index * size, size)

    def gather(self, part: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's part: an exact all-gather over
        the model group, not differentiable. Collective."""
        return torch.cat(all_gather_exact(part.detach(), self.comm).unbind(0), dim=self.dim)


def model_slices(model: torch.nn.Module) -> t.Dict[str, Slice]:
    """Each sharded parameter of ``model`` by its state key: ``{}`` for a
    model that :func:`shard_model` has not sharded."""
    out = {}
    for prefix, module in model.named_modules():
        for name, sl in module.__dict__.get("slices", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = sl
    return out


def param_shardings(model: torch.nn.Module, mesh: Mesh,
                    min_size: int = MIN_SHARD_SIZE) -> t.Dict[str, t.Optional[int]]:
    """JAX's tensor-parallel layout of ``model``'s parameters: the torch dim
    that the mesh's ``model`` axis splits, by state key, or None for a
    replicated leaf. The rule is decided on each leaf's JAX-layout shape
    (``weights.py``'s name and layout map), so the same leaves are sharded
    as in the JAX package: two dims or more, ``min_size`` values or more,
    the last (output-channel) dim a multiple of the axis. A conv kernel is
    split on torch dim 0 (O of OIHW), a transposed conv's on dim 1 (its
    (in, out, kh, kw)), a matrix such as the gate's ``w1`` (cin, hidden) on
    its last; a task-stacked leaf (``fold_tasks``) one dim further on."""
    from vision_mtl_tpu_torch.weights import jax_shape, leaf_layouts, torch_dim_of_jax_last

    size = mesh.size("model")
    params = dict(model.named_parameters())
    have = model_slices(model)
    out: t.Dict[str, t.Optional[int]] = {}
    for key, layout in leaf_layouts(model):
        if key not in params:  # a buffer
            continue
        shape = have[key].shape if key in have else tuple(params[key].shape)
        jshape = jax_shape(layout, shape)
        sharded = (size > 1 and len(jshape) >= 2 and int(np.prod(jshape)) >= min_size
                   and jshape[-1] % size == 0)
        out[key] = torch_dim_of_jax_last(layout, len(shape)) if sharded else None
    return out


def shard_model(model: torch.nn.Module, mesh: Mesh,
                min_size: int = MIN_SHARD_SIZE) -> torch.nn.Module:
    """Swap each parameter that :func:`param_shardings` shards for this
    rank's slice of it, in place (a no-op without a ``model`` axis, and for
    a leaf already sliced); returns ``model``. Every rank of the model group
    must hold the same whole leaves (built from one seed, or restored from
    one checkpoint)."""
    comm = mesh.model_comm
    if comm is None:
        return model
    have = model_slices(model)
    for key, dim in param_shardings(model, mesh, min_size).items():
        if dim is None or key in have:
            continue
        path, _, name = key.rpartition(".")
        module = model.get_submodule(path)
        whole = getattr(module, name)
        sl = Slice(dim, comm.rank, comm.world, tuple(whole.shape), comm)
        part = torch.nn.Parameter(sl.of(whole.detach()).clone(),
                                  requires_grad=whole.requires_grad)
        setattr(module, name, part)
        if "slices" not in module.__dict__:
            module.slices = {}
        module.slices[name] = sl
    return model


def shard_state(state: t.Any, mesh: Mesh, min_size: int = MIN_SHARD_SIZE) -> t.Any:
    """Place a train state onto ``mesh`` (JAX's ``shard_state``): the model's
    parameters and their Adam moments get the tensor-parallel layout of
    :func:`param_shardings` (:func:`shard_model`); everything else
    (BatchNorm statistics, the step, the optimizer's hyperparameters and
    step counts) stays as it is on every rank. The optimizer is rebuilt
    over the slices, of the same class with the same hyperparameters, and
    the moments it held are cut. A no-op without a ``model`` axis."""
    if mesh is None or mesh.model_comm is None:
        return state
    model, optimizer = state.model, state.optimizer
    before = list(model.parameters())
    shard_model(model, mesh, min_size)
    slices = model_slices(model)
    named = list(model.named_parameters())
    if all(p is q for p, (_, q) in zip(before, named)):
        return state
    group = {k: v for k, v in optimizer.param_groups[0].items() if k != "params"}
    fresh = type(optimizer)([p for _, p in named], **group)
    for old, (key, new) in zip(before, named):
        moments = optimizer.state.get(old)
        if moments:
            sl = slices[key] if new is not old else None
            fresh.state[new] = _map_moments(moments, lambda v: sl.of(v).clone()) if sl else moments
    state.optimizer = fresh
    return state


def _map_moments(moments: t.Mapping[str, t.Any], fn: t.Callable) -> t.Dict[str, t.Any]:
    """One parameter's optimizer state with ``fn`` applied to each tensor of
    the parameter's shape (Adam's moments; its step count, a scalar, as it
    is)."""
    return {k: fn(v) if torch.is_tensor(v) and v.dim() else v for k, v in moments.items()}


def full_state_dict(model: torch.nn.Module) -> t.Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded leaf gathered whole (the
    layout of a one-process model), on the CPU. Collective over every model
    group when the model is sharded."""
    slices = model_slices(model)
    return {k: (slices[k].gather(v) if k in slices else v).detach().cpu()
            for k, v in model.state_dict().items()}


def load_full_state_dict(model: torch.nn.Module, state: t.Mapping[str, torch.Tensor]) -> None:
    """``model.load_state_dict`` of a one-process (whole-leaf) state, each
    sharded leaf cut to this rank's slice first. Strict both ways."""
    slices = model_slices(model)
    model.load_state_dict({k: (slices[k].of(v) if k in slices else v) for k, v in state.items()})


def full_optimizer_state_dict(optimizer: torch.optim.Optimizer,
                              model: torch.nn.Module) -> t.Dict[str, t.Any]:
    """``optimizer.state_dict()`` (an optimizer over ``model.parameters()``,
    in order) with each sharded leaf's moments gathered whole, on the CPU.
    Collective over every model group when the model is sharded."""
    sd = optimizer.state_dict()
    slices = model_slices(model)
    by_index = [slices.get(k) for k, _ in model.named_parameters()]
    state = {}
    for i, moments in sd["state"].items():
        if by_index[i] is not None:
            moments = _map_moments(moments, by_index[i].gather)
        state[i] = {k: v.detach().cpu() if torch.is_tensor(v) else v for k, v in moments.items()}
    return {**sd, "state": state}


def load_full_optimizer_state_dict(optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                                   sd: t.Mapping[str, t.Any]) -> None:
    """``optimizer.load_state_dict`` of a one-process (whole-leaf) state,
    each sharded leaf's moments cut to this rank's slice first."""
    slices = model_slices(model)
    by_index = [slices.get(k) for k, _ in model.named_parameters()]
    state = {i: _map_moments(moments, by_index[i].of) if by_index[i] is not None else moments
             for i, moments in sd["state"].items()}
    optimizer.load_state_dict({**sd, "state": state})
