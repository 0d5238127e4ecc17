"""The numbers by which a run's outputs are held against the plain
reference's. Each is a gap that is 0 when the two agree; the cell's
``workloads/<cell>.json`` gives each its limit.

Training (the first steps of the object the window then drives):

* ``loss_gap``: the largest of each step's |program loss - reference
  loss| / |reference loss|.
* ``loss_gap_first``: the first step's alone.
* ``grad_gap``: the worst leaf's |program gradient norm - reference
  gradient norm| at the first step, over the larger of the reference
  leaf's norm and the median leaf's. The program's gradient is read from
  its Adam state after one step (``exp_avg / (1 - beta1)``).
* ``update_gap``: the same of each leaf's norm of change over the steps.
* ``grad_gap_median``, ``update_gap_median``: the median leaf's gap of
  each.
* ``confmat_gap``: the first step's confusion matrix, sum |program -
  reference| over twice the reference's pixel count.

Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone (a bias in front of a
batch-statistic BatchNorm): they are left out of ``grad_gap`` and
``update_gap`` by that rule.

Serving (a sample of the answers served in the window):

* ``segm_logit_gap``: the widest gap, over every pixel of the sample, by
  which the reference's logit of the served class lies below the
  reference's best logit.
* ``depth_gap``: the largest |served depth - reference depth|.
"""

from __future__ import annotations

import statistics
import typing as t

import torch

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's is not held to the update
STILL = 1e-3
BETA1 = 0.9


def train_gaps(prog: t.Mapping[str, t.Any], ref: t.Mapping[str, t.Any]) -> t.Tuple[
        t.Dict[str, float], t.Dict[str, str]]:
    """The training numbers, and the three worst leaves of ``grad_gap``
    and ``update_gap``."""
    loss_gaps = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    gref = ref["grad_norm"]
    med = statistics.median(gref.values())
    moved = [k for k, v in gref.items() if v >= STILL * med]

    def gaps(got: t.Mapping[str, float], want: t.Mapping[str, float]) -> t.List[t.Tuple[float, str]]:
        floor = statistics.median(want[k] for k in moved)
        return sorted((abs(got[k] - want[k]) / max(want[k], floor), k) for k in moved)

    grad = gaps(prog["grad_norm"], gref)
    update = gaps(prog["change_norm"], ref["change_norm"])
    cm_p = prog["confmat"].double()
    cm_r = ref["confmat"].double()
    confmat_gap = float((cm_p - cm_r).abs().sum() / (2 * cm_r.sum()))
    return ({"loss_gap": max(loss_gaps), "loss_gap_first": loss_gaps[0], "grad_gap": grad[-1][0], "update_gap": update[-1][0],
             "grad_gap_median": grad[len(grad) // 2][0],
             "update_gap_median": update[len(update) // 2][0], "confmat_gap": confmat_gap},
            {"grad_gap": grad[-3:], "update_gap": update[-3:]})


def program_grad_norms(named: t.Mapping[str, torch.nn.Parameter],
                       optimizer: torch.optim.Optimizer) -> t.Dict[str, torch.Tensor]:
    """Each leaf's first-step gradient norm as Adam got it, on the device:
    after one step its first moment is ``(1 - beta1) g`` (zero for a leaf
    the optimizer has not stepped)."""
    zero = torch.zeros(())
    return {k: optimizer.state[p]["exp_avg"].norm() / (1.0 - BETA1)
            if "exp_avg" in optimizer.state[p] else zero for k, p in named.items()}


def serve_gaps(served_segm: torch.Tensor, served_depth: torch.Tensor, ref_logits: torch.Tensor,
               ref_depth: torch.Tensor) -> t.Dict[str, float]:
    """``served_segm`` (N, H, W) class ids and ``served_depth`` (N, H, W)
    against the reference's logits (N, H, W, C) and depth (N, H, W)."""
    picked = ref_logits.gather(-1, served_segm.long().unsqueeze(-1)).squeeze(-1)
    logit_gap = float((ref_logits.amax(-1) - picked).max())
    depth_gap = float((served_depth.float() - ref_depth.float()).abs().max())
    return {"segm_logit_gap": logit_gap, "depth_gap": depth_gap}
