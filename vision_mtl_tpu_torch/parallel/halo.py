"""Image rows split over the ranks of the mesh's ``spatial`` axis: the halo
exchange and the other collectives of ops that are not local in H (in the
JAX package, what GSPMD inserts around a conv of a batch sharded on H).

Inside :func:`spatial_rows` every NHWC tensor of the forward holds this
rank's rows ``[s h, (s+1) h)`` of the global map, ``h`` the same on every
rank of the group, and the ops that read across rows call:

  * :func:`halo_rows` (the convolutions, ``models/blocks.conv_nhwc`` and
    ``ops/fold.folded_conv``; the bilinear resize): ``x`` with ``lo`` rows
    of the ranks above and ``hi`` of the ranks below, zeros past the
    image's edge. A halo may be deeper than a rank's own rows (a 5x5 conv
    at stride 32 on 1 row a rank): each rank offers its first ``min(hi,
    h)`` and last ``min(lo, h)`` rows, which hold every row another rank's
    halo can reach. Its backward sends each halo row's gradient back to
    the rank that owns it, where it is added;
  * :func:`gather_rows` (CSNet's centred zero-pad of a map to the skip's
    size, which moves rows across ranks): the whole map on every rank;
  * ``multihost.all_reduce_sum`` over the group (the squeeze-excite mean).

Each is one sum all-reduce over the group (``Comm.all_reduce_``) of a
zero-filled buffer in which every rank wrote its part, forward and
backward: ``x + 0`` is exact, and gloo documents only ``all_reduce`` and
``broadcast`` for CUDA tensors. A failed exchange raises; no rank ever
falls back to computing the whole image.

Levels whose rows do not split. The image's height need only divide by
the group's size (``parallel/mesh.check_rows``, JAX's rule). A model's
levels halve the rows one after another; the first level whose rows do
not split evenly (the rank's rows at the level above are odd) and every
coarser one run *whole*: each rank of the spatial group holds the whole
map of that level, the same bits on every rank (:func:`level_whole`,
:func:`at_level`). A model's forward names the level it works at
(:func:`image_levels` at its input, :func:`at_level` for each level);
where it goes down into the first whole level the rank gathers the map
(:func:`from_finer`; a 2x2 max pool of a row block of odd rows does it
itself, ``models/blocks.max_pool_2x``), and where it comes back up to a
level that splits the rank keeps its rows of the map made from the whole
one (:func:`from_coarser`). Skip connections keep their own level's
layout. At a whole level no halo is exchanged (:func:`rows_comm` is None)
and the batch-wide sums of a train step (BatchNorm and gate statistics,
their row counts) run over the mesh's data group only, the ranks that
hold other images: summed over the spatial group every row would count
once per rank. The gather's backward gives each rank the group's summed
gradient of its rows and the narrow's backward pads with zeros, so each
rank's gradient at a whole level, parameters included, is its own rows'
share, as at a split level, and the step's gradient sum stays right.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import typing as t

import torch
import torch.nn.functional as F

from vision_mtl_tpu_torch.parallel.multihost import (
    Comm,
    all_reduce_sum,
    batch_comm,
    global_batch,
)


@dataclasses.dataclass(frozen=True)
class Rows:
    """The row layout of the enclosing :func:`spatial_rows`: ``comm`` the
    spatial group, ``data`` the ranks that hold other images (the batch
    sums' group at a whole level), ``first_whole`` the first level that runs
    whole (None until a model's forward sets it), ``level`` the level the
    forward works at, ``whole`` whether it runs whole, and ``batch`` the
    split levels' batch group, kept while a whole level runs."""

    comm: Comm
    data: t.Optional[Comm] = None
    first_whole: t.Optional[int] = None
    level: int = 0
    whole: bool = False
    batch: t.Optional[Comm] = None


_ROWS: "contextvars.ContextVar[t.Optional[Rows]]" = contextvars.ContextVar(
    "vmtl_rows", default=None
)


@contextlib.contextmanager
def restore_rows(state: t.Optional[Rows]) -> t.Iterator[None]:
    """Within the block the row layout is ``state`` (:func:`rows_state`),
    None for maps that are not split."""
    token = _ROWS.set(state)
    try:
        yield
    finally:
        _ROWS.reset(token)


def spatial_rows(comm: t.Optional[Comm], data: t.Optional[Comm] = None
                 ) -> t.ContextManager[None]:
    """Within the block the forward's maps hold this rank's rows of the
    image, ``comm`` being the rank's spatial group (None, or one rank,
    changes nothing) and ``data`` the ranks that hold other images (None
    for one)."""
    return restore_rows(Rows(comm, data) if comm is not None and comm.world > 1 else None)


def rows_state() -> t.Optional[Rows]:
    """The row layout of the enclosing :func:`spatial_rows`, or None."""
    return _ROWS.get()


def rows_comm() -> t.Optional[Comm]:
    """The spatial group of the enclosing :func:`spatial_rows` where the
    maps are row blocks; None outside it and at a whole level."""
    s = _ROWS.get()
    return s.comm if s is not None and not s.whole else None


def first_whole_level(rows: int) -> int:
    """The first level that runs whole for an image of ``rows`` rows a
    rank, each level halving the rows: one more than the times 2 divides
    ``rows``."""
    level = 1
    while rows > 0 and rows % 2 == 0:
        rows //= 2
        level += 1
    return level


@contextlib.contextmanager
def image_levels(x: torch.Tensor) -> t.Iterator[None]:
    """Around a model's forward on ``x``, this rank's rows of the image
    (level 0): sets the first level that runs whole. Changes nothing
    outside :func:`spatial_rows` or inside a forward that set it."""
    s = _ROWS.get()
    if s is None or s.first_whole is not None:
        yield
        return
    with restore_rows(dataclasses.replace(s, first_whole=first_whole_level(x.shape[1]))):
        yield


def level_whole(level: int) -> bool:
    """Whether the forward's maps of ``level`` are whole on every rank."""
    s = _ROWS.get()
    return s is not None and s.first_whole is not None and level >= s.first_whole


@contextlib.contextmanager
def at_level(level: int) -> t.Iterator[None]:
    """Within the block the forward works at ``level``: a whole level has no
    halo and takes its batch-wide sums over the data group (where a train
    step takes them at all); a split one as :func:`spatial_rows` set it up."""
    s = _ROWS.get()
    if s is None:
        yield
        return
    whole = level_whole(level)
    if whole == s.whole:
        with restore_rows(dataclasses.replace(s, level=level)):
            yield
    elif whole:
        batch = batch_comm()
        with restore_rows(dataclasses.replace(s, level=level, whole=True, batch=batch)), \
                global_batch(s.data if batch is not None else None):
            yield
    else:
        with restore_rows(dataclasses.replace(s, level=level, whole=False, batch=None)), \
                global_batch(s.batch):
            yield


def coarser_level() -> t.ContextManager[None]:
    """:func:`at_level` of the level above the forward's (coarser)."""
    s = _ROWS.get()
    return at_level(s.level + 1) if s is not None else contextlib.nullcontext()


def from_finer(x: torch.Tensor) -> torch.Tensor:
    """``x``, a map of the level below the forward's (finer), as the input of
    an op that takes it down to this level: the whole map, gathered over
    the group, when this is the first level that runs whole; else ``x``."""
    s = _ROWS.get()
    if s is None or not s.whole or level_whole(s.level - 1):
        return x
    return gather_rows(x, s.comm)


def from_coarser(x: torch.Tensor, rows: t.Optional[int],
                 fn: t.Callable[[torch.Tensor, t.Optional[int]], torch.Tensor]
                 ) -> torch.Tensor:
    """``fn(x, rows)``: a map of the forward's level, of ``rows`` rows a rank
    (None: as ``fn`` makes it), from ``x``, a map of the level above
    (coarser). Where that level runs whole and this one splits, ``fn`` runs
    at the coarser level on the whole map for ``rows`` times the group's
    rows, and this rank keeps its rows of the result (zero-padded first,
    centred, up to the group's rows where ``fn`` gave fewer); the narrow's
    backward pads with zeros."""
    s = _ROWS.get()
    if s is None or s.whole or not level_whole(s.level + 1):
        return fn(x, rows)
    n = s.comm.world
    with at_level(s.level + 1):
        y = fn(x, None if rows is None else rows * n)
    if rows is None:
        if y.shape[1] % n:
            raise ValueError(f"a whole map of {y.shape[1]} rows does not split over {n} ranks")
        rows = y.shape[1] // n
    dy = rows * n - y.shape[1]
    if dy:
        y = F.pad(y, (0, 0) * (y.dim() - 2) + (dy // 2, dy - dy // 2))
    return y[:, s.comm.rank * rows:(s.comm.rank + 1) * rows]


def _halo_index(h: int, lo: int, hi: int, comm: Comm) -> t.Tuple[int, int, t.List[int]]:
    """(lo_e, hi_e, index): each rank offers its last ``lo_e`` and first
    ``hi_e`` rows, ``offer[r] = cat(x_r[h - lo_e:], x_r[:hi_e])``; row j of
    this rank's ``lo + hi`` halo rows is row ``index[j]`` of the ranks'
    offers stacked, ``(world * (lo_e + hi_e))`` rows, or ``-1`` past the
    image's edge."""
    lo_e, hi_e = min(lo, h), min(hi, h)
    per = lo_e + hi_e
    s, n = comm.rank, comm.world
    index = []
    for j in range(lo):  # rows above: global s h - lo + j
        g = s * h - lo + j
        index.append(-1 if g < 0 else (g // h) * per + g % h - (h - lo_e))
    for j in range(hi):  # rows below: global (s + 1) h + j
        g = (s + 1) * h + j
        index.append(-1 if g >= n * h else (g // h) * per + lo_e + g % h)
    return lo_e, hi_e, index


def _gather_offers(offers: torch.Tensor, index: t.List[int]) -> torch.Tensor:
    """Rows ``index`` of ``offers`` (B, R, ...) along dim 1, zeros for -1."""
    zero = offers.new_zeros((offers.shape[0], 1, *offers.shape[2:]))
    padded = torch.cat([offers, zero], dim=1)
    idx = torch.tensor([i if i >= 0 else offers.shape[1] for i in index], device=offers.device)
    return padded.index_select(1, idx)


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi, comm):
        b, h = x.shape[:2]
        lo_e, hi_e, index = _halo_index(h, lo, hi, comm)
        ctx.meta = (h, lo, hi, lo_e, hi_e, index, comm)
        per = lo_e + hi_e
        buf = x.new_zeros((comm.world, b, per, *x.shape[2:]))
        buf[comm.rank] = torch.cat([x[:, h - lo_e:], x[:, :hi_e]], dim=1)
        comm.all_reduce_(buf)
        offers = buf.transpose(0, 1).reshape(b, comm.world * per, *x.shape[2:])
        halo = _gather_offers(offers, index)
        return torch.cat([halo[:, :lo], x, halo[:, lo:]], dim=1)

    @staticmethod
    def backward(ctx, g):
        h, lo, hi, lo_e, hi_e, index, comm = ctx.meta
        b = g.shape[0]
        per = lo_e + hi_e
        dx = g[:, lo:lo + h].clone()
        halo = torch.cat([g[:, :lo], g[:, lo + h:]], dim=1)
        keep = [j for j, i in enumerate(index) if i >= 0]
        back = g.new_zeros((b, comm.world * per, *g.shape[2:]))
        if keep:
            back.index_add_(1, torch.tensor([index[j] for j in keep], device=g.device),
                            halo[:, keep])
        buf = back.reshape(b, comm.world, per, *g.shape[2:]).transpose(0, 1).contiguous()
        comm.all_reduce_(buf)
        mine = buf[comm.rank]  # the gradients of the rows this rank offered
        dx[:, h - lo_e:] += mine[:, :lo_e]
        dx[:, :hi_e] += mine[:, lo_e:]
        return dx, None, None, None


def halo_rows(x: torch.Tensor, lo: int, hi: int, comm: Comm) -> torch.Tensor:
    """``x`` (B, h, ...) of this rank of ``comm`` with the ``lo`` rows
    above it and the ``hi`` rows below it in the global map: (B, lo + h +
    hi, ...), zeros past the image's edge. Differentiable: the halo rows'
    gradient goes back to the ranks that own them. ``lo`` and ``hi`` may
    exceed ``h``. Collective over ``comm``."""
    if lo == 0 and hi == 0:
        return x
    return _HaloRows.apply(x, lo, hi, comm)


def gather_rows(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The whole map (B, world h, ...) from every rank's rows (B, h, ...),
    on every rank; differentiable (each rank's rows get the sum of every
    rank's gradient for them). Collective over ``comm``."""
    h = x.shape[1]
    placed = torch.nn.functional.pad(
        x, (0, 0) * (x.dim() - 2) + (comm.rank * h, (comm.world - 1 - comm.rank) * h))
    return all_reduce_sum(placed, comm)
