"""Image rows split over the ranks of the mesh's ``spatial`` axis: the halo
exchange and the other collectives of ops that are not local in H (in the
JAX package, what GSPMD inserts around a conv of a batch sharded on H).

Inside :func:`spatial_rows` every NHWC tensor of the forward holds this
rank's rows ``[s h, (s+1) h)`` of the global map, ``h`` the same on every
rank of the group (``parallel/mesh.check_rows``), and the ops that read
across rows call:

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
"""

from __future__ import annotations

import contextlib
import contextvars
import typing as t

import torch

from vision_mtl_tpu_torch.parallel.multihost import Comm, all_reduce_sum

_ROWS: "contextvars.ContextVar[t.Optional[Comm]]" = contextvars.ContextVar(
    "vmtl_rows_comm", default=None
)


@contextlib.contextmanager
def spatial_rows(comm: t.Optional[Comm]) -> t.Iterator[None]:
    """Within the block the forward's maps hold this rank's rows of the
    image, ``comm`` being the rank's spatial group (None, or one rank,
    changes nothing)."""
    token = _ROWS.set(comm if comm is not None and comm.world > 1 else None)
    try:
        yield
    finally:
        _ROWS.reset(token)


def rows_comm() -> t.Optional[Comm]:
    """The spatial group of the enclosing :func:`spatial_rows`, or None."""
    return _ROWS.get()


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
