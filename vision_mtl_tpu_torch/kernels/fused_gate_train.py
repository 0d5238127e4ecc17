"""MTAN's train-mode attention gate: CUDA kernel, plain version, gradient.

Counterpart of ``fused_attention_gate_train`` in
``vision_mtl_tpu/ops/pallas/fused_gate.py``. In train mode both BatchNorms
of the gate chain

    attn = sigmoid(BN2(conv1x1_2(relu(BN1(conv1x1_1(x))))));  out = shared * attn

normalise with the batch's own statistics, so the chain needs two global
reductions before it can write its output. The CUDA kernel
(``csrc/gate_train.cu``) runs three passes: the first keeps ``x @ w1`` in
scratch memory for the other two, the (N, C2) intermediate is recomputed.
It returns ``(out, mean1, var1, mean2, var2)``: the raw biased batch
statistics, which the caller folds into its running statistics.
:func:`fused_attention_gate_train_plain` computes the same function with
PyTorch ops and is what runs for CPU tensors.

MTAN's task-folded levels (``fold_tasks``) run the T tasks' gates as one
call: :func:`fused_attention_gate_train_tasks` takes x, the weights and the
statistics with a leading task axis and one ``shared`` map for every task;
each task's results are bit for bit those of its own call. The kernel
has one entry, the task-axis one: :func:`fused_attention_gate_train`
calls it with T = 1. The plain version,
:func:`fused_attention_gate_train_tasks_plain`, is the one-task plain
version task by task. ``tasks`` counts the task-axis wrapper's calls,
``launches`` the one-task wrapper's.

Ranks. Under data parallelism (``parallel/multihost.py``) the statistics
are those of every rank's rows together, as a JAX BatchNorm over a batch
sharded on the mesh's ``data`` axis takes them. Given a ``comm`` of
several ranks, the wrapper launches the kernel in stages
(``vmtl_fused_attention_gate_train_tasks_stage``): after each statistics
pass it gathers the ranks' f64 (rows, mean, M2) exactly, combines them in
rank order (Chan's formula, ``multihost.combine_moments``) and hands them
to the kernel's fold stage, which folds them with the fused call's own
code. The backward all-reduces the two per-channel sums of each BN's
gradient. The plain version takes the same split. Without a ``comm`` (one
process) the fused call runs as before.

The kernel takes its products on the tensor cores as 3xTF32, as the eval
gate's does (``fused_gate.tf32_matmul``).
:func:`fused_attention_gate_train_tf32` emulates that arithmetic with
PyTorch ops (and, with ``split=False``, a single TF32 product, which is not
accurate enough); it is for tests and never on the main path.

:func:`fused_attention_gate_train` is differentiable, and its backward is a
kernel too (``csrc/gate_train_backward.cu``; the JAX package differentiates
this chain with XLA and has no backward kernel). For CUDA tensors one call
of it computes all ten gradients of every task, in three passes over row
tiles with the BatchNorm gradient's sums between them; ``backward`` counts
its calls. With a ``comm`` of several ranks it runs in stages and the
wrapper all-reduces each BatchNorm's two per-channel sums between them, as
the plain backward does. :func:`_gate_backward`, the plain backward in
PyTorch ops, recomputes h and a from the saved inputs and statistics; it is
what runs for CPU tensors and the tests' reference, and
:func:`fused_attention_gate_train_backward_tf32` emulates the kernel's
3xTF32 products with it, for tests only. Between forward and backward the
Function holds only its inputs and the four statistics; the kernel's
(N, hidden) and (N, C2) scratch lives only during the backward call.
"""

from __future__ import annotations

import ctypes
import typing as t

import torch

from vision_mtl_tpu_torch.kernels._build import EntryPoint, LaunchCounter, load
from vision_mtl_tpu_torch.kernels.fused_gate import check_gate_args, tf32_matmul
from vision_mtl_tpu_torch.parallel.multihost import Comm, all_gather_exact, combine_moments
from vision_mtl_tpu_torch.utils.profiling import span

SOURCE = "gate_train"

launches = LaunchCounter()
#: the task-axis call (``vmtl_fused_attention_gate_train_tasks``)
tasks = EntryPoint(SOURCE)
#: the staged call across ranks (``vmtl_fused_attention_gate_train_tasks_stage``),
#: one-task or task-axis: it counts those calls, the two above the fused ones
ranks = EntryPoint(SOURCE)
#: the gradient (``csrc/gate_train_backward.cu``): one count per backward
#: call on CUDA tensors, one-task or task-axis, fused or staged
backward = EntryPoint("gate_train_backward")

_SIGNATURE = (
    [ctypes.c_void_p] * 13
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_float, ctypes.c_int]
    + [ctypes.c_void_p]
)
_STAGE_SIGNATURE = _SIGNATURE + [ctypes.c_int, ctypes.c_void_p]
_SCRATCH_SIGNATURE = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
_BACKWARD_SIGNATURE = (
    [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_void_p]
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
_BACKWARD_STAGE_SIGNATURE = _BACKWARD_SIGNATURE + [ctypes.c_int, ctypes.c_void_p, ctypes.c_double]


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    # f32 math for f32 and bf16 activations; f64 stays f64 (gradcheck)
    return torch.promote_types(x.dtype, torch.float32)


def _batch_stats(
    z: torch.Tensor, comm: t.Optional[Comm] = None
) -> t.Tuple[torch.Tensor, torch.Tensor]:
    """Mean and biased variance over rows, accumulated in f64; with a
    ``comm``, over every rank's rows (each rank's f64 (rows, mean, M2)
    combined in rank order)."""
    zd = z.double()
    mean = zd.mean(0)
    if comm is None:
        var = (zd - mean).square().mean(0)
        return mean.to(z.dtype), var.to(z.dtype)
    local = torch.stack([torch.full_like(mean, zd.shape[0]), mean, (zd - mean).square().sum(0)])
    n, mean, m2 = combine_stats(local, comm).unbind(0)
    return mean.to(z.dtype), (m2 / n).clamp(min=0.0).to(z.dtype)


def combine_stats(local: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The wrapper's combine: this rank's f64 ``(..., 3, C)`` (rows, mean,
    M2) gathered over the ranks and combined in rank order, same shape.
    Every rank gets the same bits."""
    parts = all_gather_exact(local, comm).movedim(-2, 1)  # (world, 3, ..., C)
    return combine_moments(parts).movedim(0, -2).contiguous()


def fused_attention_gate_train_plain(
    x: torch.Tensor,
    shared: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    scale1: torch.Tensor,
    bias1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    scale2: torch.Tensor,
    bias2: torch.Tensor,
    eps: float = 1e-5,
    comm: t.Optional[Comm] = None,
) -> t.Tuple[torch.Tensor, ...]:
    """The kernel's function in PyTorch ops: f32 math (f64 for f64 inputs),
    statistics accumulated in f64, output in shared's dtype. Returns
    ``(out, mean1, var1, mean2, var2)``. With a ``comm`` the statistics are
    every rank's rows' together, the kernel's staged call's function."""
    cd = _compute_dtype(x)
    cin, c2ch = x.shape[-1], shared.shape[-1]
    h = x.reshape(-1, cin).to(cd) @ w1.to(cd) + b1.to(cd)
    mean1, var1 = _batch_stats(h, comm)
    inv1 = scale1.to(cd) / torch.sqrt(var1 + eps)
    h = torch.relu((h - mean1) * inv1 + bias1.to(cd))
    a = h @ w2.to(cd) + b2.to(cd)
    mean2, var2 = _batch_stats(a, comm)
    inv2 = scale2.to(cd) / torch.sqrt(var2 + eps)
    attn = torch.sigmoid((a - mean2) * inv2 + bias2.to(cd))
    out = (shared.reshape(-1, c2ch).to(cd) * attn).to(shared.dtype).reshape(shared.shape)
    return out, mean1, var1, mean2, var2


def fused_attention_gate_train_tasks_plain(
    x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2, eps=1e-5, comm=None
) -> t.Tuple[torch.Tensor, ...]:
    """The task-axis kernel's function: :func:`fused_attention_gate_train_plain`
    for each task's x and weights on the one ``shared``, each result
    stacked on a leading task axis."""
    per_task = [
        fused_attention_gate_train_plain(
            x[i], shared, w1[i], b1[i], scale1[i], bias1[i], w2[i], b2[i], scale2[i],
            bias2[i], eps, comm,
        )
        for i in range(x.shape[0])
    ]
    return tuple(torch.stack(parts) for parts in zip(*per_task))


def fused_attention_gate_train_tf32(
    x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2, eps=1e-5, split=True
):
    """The kernel's function with both products taken from TF32 operands as
    the kernel takes them: 3xTF32 (``a_lo b_hi + a_hi b_lo + a_hi b_hi``),
    or one TF32 product ``a_hi b_hi`` when ``split`` is False. f32 or bf16
    inputs, f32 math, statistics in f64. For tests: the CUDA kernel's
    arithmetic, emulated on the CPU."""

    cin, c2ch = x.shape[-1], shared.shape[-1]
    h = tf32_matmul(x.reshape(-1, cin), w1, split) + b1
    mean1, var1 = _batch_stats(h)
    h = torch.relu((h - mean1) * (scale1 / torch.sqrt(var1 + eps)) + bias1)
    a = tf32_matmul(h, w2, split) + b2
    mean2, var2 = _batch_stats(a)
    attn = torch.sigmoid((a - mean2) * (scale2 / torch.sqrt(var2 + eps)) + bias2)
    out = (shared.reshape(-1, c2ch).float() * attn).to(shared.dtype).reshape(shared.shape)
    return out, mean1, var1, mean2, var2


def _launch(x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2, eps, comm=None):
    """The CUDA kernel's forward, the task-axis kernel with T = 1; raises
    unless every tensor fits it."""
    _check(x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2)
    weights = (w1, b1, scale1, bias1, w2, b2, scale2, bias2)
    results = _launch_on_tasks(
        "fused_attention_gate_train", launches, x[None], shared, *(v[None] for v in weights),
        eps=eps, comm=comm,
    )
    return tuple(r[0] for r in results)


def _launch_tasks(x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2, eps, comm=None):
    """The task-axis CUDA kernel's forward; raises unless every tensor fits
    it."""
    _check(x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2)
    return _launch_on_tasks(
        "fused_attention_gate_train_tasks", tasks.launches, x, shared, w1, b1, scale1, bias1,
        w2, b2, scale2, bias2, eps=eps, comm=comm,
    )


def _launch_on_tasks(kernel: str, counter: LaunchCounter, x, shared, *weights, eps,
                     comm: t.Optional[Comm] = None):
    """One call of the kernel on checked tensors with a leading task axis
    (``weights``: w1, b1, scale1, bias1, w2, b2, scale2, bias2); ``counter``
    counts a fused call. Without a ``comm``: the fused entry
    ``vmtl_fused_attention_gate_train_tasks``. With one: the staged entry,
    the ranks' statistics combined between the passes (:func:`combine_stats`
    on the ``comm``; a ``comm`` of one rank gives the fused call's bits),
    counted by ``ranks``."""
    n_tasks, b, h, w, cin = x.shape
    hidden, c2ch = weights[4].shape[1:]  # w2 (T, hidden, C2)
    n = b * h * w
    out = torch.empty((n_tasks, *shared.shape), dtype=shared.dtype, device=x.device)
    stats = torch.empty((n_tasks, 2 * (hidden + c2ch)), dtype=torch.float32, device=x.device)
    nbytes = load(
        SOURCE, "vmtl_fused_attention_gate_train_tasks_scratch_bytes", _SCRATCH_SIGNATURE,
        restype=ctypes.c_longlong,
    )(n, cin, hidden, c2ch, n_tasks)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        args = (
            x.data_ptr(), shared.data_ptr(), *(v.data_ptr() for v in weights), out.data_ptr(),
            stats.data_ptr(), scratch.data_ptr(), n_tasks, n, cin, hidden, c2ch, eps,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
        )
        if comm is None:
            rc = load(SOURCE, "vmtl_fused_attention_gate_train_tasks", _SIGNATURE)(*args)
        else:
            stage = load(SOURCE, "vmtl_fused_attention_gate_train_tasks_stage", _STAGE_SIGNATURE)
            rc = 0
            for k, ch in ((0, hidden), (2, c2ch)):
                local = torch.empty((n_tasks, 3, ch), dtype=torch.float64, device=x.device)
                rc = rc or stage(*args, k, local.data_ptr())
                if rc:
                    break
                combined = combine_stats(local, comm)
                rc = stage(*args, k + 1, combined.data_ptr())
            rc = rc or stage(*args, 4, None)
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed, CUDA error {rc}")
    (counter if comm is None else ranks.launches).add()
    mean1, var1, mean2, var2 = stats.split([hidden, hidden, c2ch, c2ch], dim=1)
    return out, mean1, var1, mean2, var2


def _bn_backward(dy_hat: torch.Tensor, z_hat: torch.Tensor, rstd: torch.Tensor,
                 comm: t.Optional[Comm] = None) -> torch.Tensor:
    """Gradient through a batch-statistic normalisation z_hat = (z - mean) *
    rstd over the rows (dim -2), given the gradient with respect to z_hat;
    with a ``comm``, the statistics were every rank's rows' (as many on each)
    and the two per-channel sums are all-reduced."""
    if comm is None:
        return rstd * (dy_hat - dy_hat.mean(-2, keepdim=True)
                       - z_hat * (dy_hat * z_hat).mean(-2, keepdim=True))
    sums = torch.stack([dy_hat.sum(-2), (dy_hat * z_hat).sum(-2)])
    mean_dy, mean_dy_z = (comm.all_reduce_(sums) / (dy_hat.shape[-2] * comm.world)).unsqueeze(-2)
    return rstd * (dy_hat - mean_dy - z_hat * mean_dy_z)


def _gate_backward(eps, dout, x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2,
                   m1, v1, m2, v2, comm=None, matmul=torch.matmul) -> t.Tuple[torch.Tensor, ...]:
    """The one-task gate's gradient in its ten tensors, in the compute dtype,
    x's and shared's as rows: recomputes h and a from the inputs and the
    saved statistics and applies the BatchNorm gradient with batch
    statistics (every rank's, with a ``comm``). ``matmul`` takes its six
    products."""
    cd = _compute_dtype(x)
    cin, c2ch = x.shape[-1], shared.shape[-1]
    xf = x.reshape(-1, cin).to(cd)
    sf = shared.reshape(-1, c2ch).to(cd)
    dout = dout.reshape(-1, c2ch).to(cd)
    w1, w2, scale1, scale2 = w1.to(cd), w2.to(cd), scale1.to(cd), scale2.to(cd)
    # recompute the forward
    rstd1 = torch.rsqrt(v1.to(cd) + eps)
    h_hat = (matmul(xf, w1) + b1.to(cd) - m1.to(cd)) * rstd1
    z1 = h_hat * scale1 + bias1.to(cd)
    r = torch.relu(z1)
    rstd2 = torch.rsqrt(v2.to(cd) + eps)
    a_hat = (matmul(r, w2) + b2.to(cd) - m2.to(cd)) * rstd2
    attn = torch.sigmoid(a_hat * scale2 + bias2.to(cd))
    # and back
    dz2 = dout * sf * attn * (1.0 - attn)
    da = _bn_backward(dz2 * scale2, a_hat, rstd2, comm)
    dr = matmul(da, w2.T) * (z1 > 0)
    dh = _bn_backward(dr * scale1, h_hat, rstd1, comm)
    return (
        matmul(dh, w1.T), dout * attn, matmul(xf.T, dh), dh.sum(0), (dr * h_hat).sum(0),
        dr.sum(0), matmul(r.T, da), da.sum(0), (dz2 * a_hat).sum(0), dz2.sum(0),
    )


def _gate_backward_tasks(eps, dout, x, shared, *saved, comm=None, matmul=torch.matmul):
    """:func:`_gate_backward` of T tasks (x, dout, the weights and the
    statistics with a leading task axis), task by task: the ten gradients
    stacked on the task axis (dx in x's dtype), dshared the tasks' summed in
    task order."""
    dshared, by_task = 0.0, []
    for i in range(x.shape[0]):
        dx, ds, *dw = _gate_backward(
            eps, dout[i], x[i], shared, *(v[i] for v in saved), comm=comm, matmul=matmul
        )
        dshared = dshared + ds
        by_task.append((dx.to(x.dtype), *dw))
    dx, *dw = (torch.stack(parts) for parts in zip(*by_task))
    return (dx, dshared, *dw)


def fused_attention_gate_train_backward_tf32(eps, dout, x, shared, w1, b1, scale1, bias1, w2,
                                             b2, scale2, bias2, m1, v1, m2, v2, split=True):
    """The backward kernel's gradient with its six products taken from TF32
    operands as the kernel takes them (:func:`tf32_matmul`: 3xTF32, the
    bf16 operand of x w1 and x^T dh exact in TF32; one TF32 product with
    ``split`` False), the rest :func:`_gate_backward`'s f32 arithmetic.
    For tests: the CUDA kernel's arithmetic, emulated on the CPU."""
    return _gate_backward(eps, dout, x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2,
                          m1, v1, m2, v2, matmul=lambda a, b: tf32_matmul(a, b, split))


def _launch_backward(eps, dout, x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2,
                     m1, v1, m2, v2, comm: t.Optional[Comm] = None) -> t.Tuple[torch.Tensor, ...]:
    """The backward kernel on the forward's checked tensors with a leading
    task axis (``shared`` without one) and the four saved statistics (T, C):
    the ten gradients in the inputs' shapes and dtypes, dshared every task's.
    Without a ``comm``: the fused entry ``vmtl_gate_train_backward``. With
    one: the staged entry, each BatchNorm's two per-channel sums all-reduced
    over the ``comm`` between the passes (a ``comm`` of one rank gives the
    fused call's bits)."""
    n_tasks, cin = x.shape[0], x.shape[-1]
    hidden, c2ch = w2.shape[1:]
    n = x.shape[1:-1].numel()
    inputs = (dout.to(shared.dtype).contiguous(), x, shared, w1, b1, scale1, bias1, w2, b2,
              scale2, bias2, *(s.contiguous() for s in (m1, v1, m2, v2)))
    grads = (torch.empty_like(x), torch.empty_like(shared),
             *(torch.empty_like(w) for w in (w1, b1, scale1, bias1, w2, b2, scale2, bias2)))
    nbytes = load(
        backward.SOURCE, "vmtl_gate_train_backward_scratch_bytes", _SCRATCH_SIGNATURE,
        restype=ctypes.c_longlong,
    )(n, cin, hidden, c2ch, n_tasks)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        args = (
            (ctypes.c_void_p * len(inputs))(*(v.data_ptr() for v in inputs)),
            (ctypes.c_void_p * len(grads))(*(v.data_ptr() for v in grads)),
            scratch.data_ptr(), n_tasks, n, cin, hidden, c2ch, eps,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
        )
        if comm is None:
            rc = load(backward.SOURCE, "vmtl_gate_train_backward", _BACKWARD_SIGNATURE)(*args)
        else:
            stage = load(backward.SOURCE, "vmtl_gate_train_backward_stage",
                         _BACKWARD_STAGE_SIGNATURE)
            n_total = float(n * comm.world)
            rc = 0
            for k, ch in ((0, c2ch), (2, hidden)):
                local = torch.empty((n_tasks, 2, ch), dtype=torch.float64, device=x.device)
                rc = rc or stage(*args, k, local.data_ptr(), n_total)
                if rc:
                    break
                comm.all_reduce_(local)
                rc = stage(*args, k + 1, local.data_ptr(), n_total)
            rc = rc or stage(*args, 4, None, n_total)
    if rc != 0:
        raise RuntimeError(f"fused_attention_gate_train backward: kernel launch failed, CUDA "
                           f"error {rc}")
    backward.launches.add()
    return grads


class _FusedGateTrain(torch.autograd.Function):
    """The gate of one task (x of 4 dims) or of T tasks (x of 5, the task
    axis leading x, the weights and the statistics; shared is every
    task's)."""

    @staticmethod
    def forward(ctx, x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2, eps, comm):
        comm = comm if comm is not None and comm.world > 1 else None
        args = (x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2, eps, comm)
        on_tasks = x.dim() == 5
        if x.device.type == "cpu":
            plain = fused_attention_gate_train_tasks_plain if on_tasks else (
                fused_attention_gate_train_plain)
            out, *stats = plain(*args)
        else:
            out, *stats = (_launch_tasks if on_tasks else _launch)(*args)
        ctx.eps, ctx.comm = eps, comm
        ctx.save_for_backward(x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2, *stats)
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def backward(ctx, dout, *_):
        with span("gate.backward", device_time=True):
            return _FusedGateTrain._backward(ctx, dout)

    @staticmethod
    def _backward(ctx, dout):
        saved = ctx.saved_tensors
        x, shared = saved[:2]
        if x.device.type != "cpu":  # every task in one call of the kernel
            if x.dim() == 4:
                grads = _launch_backward(ctx.eps, dout[None], x[None], shared,
                                         *(v[None] for v in saved[2:]), comm=ctx.comm)
            else:
                grads = _launch_backward(ctx.eps, dout, *saved, comm=ctx.comm)
        elif x.dim() == 4:
            grads = _gate_backward(ctx.eps, dout, *saved, comm=ctx.comm)
        else:
            grads = _gate_backward_tasks(ctx.eps, dout, x, shared, *saved[2:], comm=ctx.comm)
        return (*(g.reshape(i.shape).to(i.dtype) for g, i in zip(grads, saved)), None, None)


def fused_attention_gate_train(
    x: torch.Tensor,
    shared: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    scale1: torch.Tensor,
    bias1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    scale2: torch.Tensor,
    bias2: torch.Tensor,
    eps: float = 1e-5,
    comm: t.Optional[Comm] = None,
) -> t.Tuple[torch.Tensor, ...]:
    """Train-mode gate with batch-statistic BNs, NHWC; differentiable in all
    ten tensors. With a ``comm`` of several ranks the statistics are those
    of every rank's rows together (each rank holding as many).

    Args:
      x: (B, H, W, Cin) gate input; shared: (B, H, W, C2) features to
        modulate, same dtype as x (f32 or bf16 for the kernel).
      w1: (Cin, hidden), b1: (hidden,) — first conv1x1; scale1, bias1:
        (hidden,) — BN1's gamma and beta.
      w2: (hidden, C2), b2: (C2,) — second conv1x1; scale2, bias2: (C2,) —
        BN2's gamma and beta.

    Returns ``(out, mean1, var1, mean2, var2)``: out in shared's dtype and
    the raw biased batch statistics, f32 and not differentiable.

    CPU tensors take :func:`fused_attention_gate_train_plain`. CUDA tensors
    launch the kernel (f32 weights, all contiguous, hidden and C2 multiples
    of 4 up to 128 and 512) or raise; there is no fallback.
    """
    return _FusedGateTrain.apply(
        x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2, eps, comm
    )


def fused_attention_gate_train_tasks(
    x: torch.Tensor,
    shared: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    scale1: torch.Tensor,
    bias1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    scale2: torch.Tensor,
    bias2: torch.Tensor,
    eps: float = 1e-5,
    comm: t.Optional[Comm] = None,
) -> t.Tuple[torch.Tensor, ...]:
    """The train-mode gates of T tasks on one shared map, each with its own
    batch statistics (every rank's rows', with a ``comm``); differentiable
    in all ten tensors.

    Args:
      x: (T, B, H, W, Cin); shared: (B, H, W, C2), every task's, same dtype.
      w1: (T, Cin, hidden); b1, scale1, bias1: (T, hidden); w2: (T, hidden,
        C2); b2, scale2, bias2: (T, C2).

    Returns ``(out, mean1, var1, mean2, var2)``: out (T, B, H, W, C2) in
    shared's dtype, the statistics (T, hidden) and (T, C2), raw, biased, f32
    and not differentiable. CPU tensors take
    :func:`fused_attention_gate_train_tasks_plain`; CUDA tensors make one
    call of the kernel for all tasks, or raise.
    """
    return _FusedGateTrain.apply(
        x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2, eps, comm
    )


def _check(x, shared, w1, b1, scale1, bias1, w2, b2, scale2, bias2) -> None:
    check_gate_args(
        "fused_attention_gate_train" + ("_tasks" if x.dim() == 5 else ""), x, shared, w1, w2,
        {"b1": b1, "scale1": scale1, "bias1": bias1},
        {"b2": b2, "scale2": scale2, "bias2": bias2},
        n_tasks=x.shape[0] if x.dim() == 5 else None,
    )
    if x.shape[-4:-1].numel() == 0:
        raise ValueError("fused_attention_gate_train: batch statistics need at least one row")
