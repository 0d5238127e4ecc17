"""MTAN's inference-mode attention gate: CUDA kernel and its plain version.

Counterpart of ``vision_mtl_tpu/ops/pallas/fused_gate.py`` (``fold_bn``,
``fused_attention_gate``). In eval mode the gate chain

    attn = sigmoid(BN2(conv1x1_2(relu(BN1(conv1x1_1(x))))));  out = shared * attn

is two per-pixel products with affine BNs, folded by :func:`fold_bn` into
``(w, c)`` pairs. The CUDA kernel (``csrc/fused_gate.cu``) keeps the
``(N, hidden)`` intermediate in shared memory; :func:`fused_attention_gate_plain`
computes the same function with PyTorch ops and is what runs for CPU tensors.

MTAN's task-folded levels (``fold_tasks``) run the T tasks' gates as one
launch: :func:`fused_attention_gate_tasks` takes x and the weights with a
leading task axis and one ``shared`` map for every task; each task's result
is bit for bit that of its own launch. The kernel has one entry, the
task-axis one: :func:`fused_attention_gate` launches it with T = 1. The
plain version, :func:`fused_attention_gate_tasks_plain`, is the one-task
plain version task by task. ``tasks`` counts the task-axis wrapper's
launches, ``launches`` the one-task wrapper's.

Both are the two kernels of one PyTorch operator,
``torch.ops.vmtl.fused_attention_gate``, registered when this module is
imported: the dispatcher runs the plain version for CPU tensors and the
CUDA launch for CUDA tensors, and its fake version gives the output's
shape, dtype and strides to tracers, so ``torch.export`` keeps the
operator itself in an exported graph. The operator is for inference: a
backward through it raises. Its callers run under ``torch.inference_mode``
(``Predictor``, the eval and predict steps, ``serving.load_exported``),
where the dispatcher skips the autograd layer.

The kernel takes its products on the tensor cores as 3xTF32: each f32
operand ``a`` is split into ``a_hi``, its TF32 rounding, and ``a_lo``, the
TF32 rounding of ``a - a_hi``, and ``a @ b`` is taken as
``a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi`` (:func:`tf32_matmul`).
:func:`fused_attention_gate_tf32` emulates that arithmetic with PyTorch ops
(and, with ``split=False``, a single TF32 product, which is not accurate
enough); it is for tests and never on the main path.
"""

from __future__ import annotations

import ctypes
import typing as t

import torch

from vision_mtl_tpu_torch.kernels._build import EntryPoint, LaunchCounter, load

SOURCE = "fused_gate"
MAX_HIDDEN = 128
MAX_C2 = 512
MAX_TASKS = 65535

launches = LaunchCounter()
#: the task-axis launch (``vmtl_fused_attention_gate_tasks``)
tasks = EntryPoint(SOURCE)

_SIGNATURE = (
    [ctypes.c_void_p] * 7
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p]
)


def fold_bn(
    conv_bias: t.Optional[torch.Tensor],
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    eps: float = 1e-5,
) -> t.Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scale, const) with BN(conv(x)) == conv_nobias(x)*scale+const."""
    inv = bn_scale / torch.sqrt(bn_var + eps)
    b = conv_bias if conv_bias is not None else 0.0
    return inv, (b - bn_mean) * inv + bn_bias


def fused_attention_gate_plain(
    x: torch.Tensor,
    shared: torch.Tensor,
    w1: torch.Tensor,
    c1: torch.Tensor,
    w2: torch.Tensor,
    c2: torch.Tensor,
) -> torch.Tensor:
    """The kernel's function in PyTorch ops: f32 math, output in shared's
    dtype."""
    cin, c2ch = x.shape[-1], shared.shape[-1]
    h = torch.relu(x.reshape(-1, cin).float() @ w1.float() + c1.float())
    attn = torch.sigmoid(h @ w2.float() + c2.float())
    out = shared.reshape(-1, c2ch).float() * attn
    return out.to(shared.dtype).reshape(shared.shape)


def fused_attention_gate_tasks_plain(
    x: torch.Tensor,
    shared: torch.Tensor,
    w1: torch.Tensor,
    c1: torch.Tensor,
    w2: torch.Tensor,
    c2: torch.Tensor,
) -> torch.Tensor:
    """The task-axis kernel's function: :func:`fused_attention_gate_plain`
    for each task's x and weights on the one ``shared``, stacked."""
    return torch.stack([
        fused_attention_gate_plain(x[i], shared, w1[i], c1[i], w2[i], c2[i])
        for i in range(x.shape[0])
    ])


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 ``v`` rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``: add half of the dropped
    13 bits' range to the bit pattern and mask them off."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, split: bool = True) -> torch.Tensor:
    """``a @ b`` from TF32 operands as the gate kernels take it on the tensor
    cores: 3xTF32 (``a_lo b_hi + a_hi b_lo + a_hi b_hi``), or one TF32
    product ``a_hi b_hi`` when ``split`` is False."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    if not split:
        return a_hi @ b_hi
    a_lo, b_lo = tf32_round(a.float() - a_hi), tf32_round(b.float() - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def fused_attention_gate_tf32(x, shared, w1, c1, w2, c2, split=True):
    """The kernel's function with both products taken from TF32 operands as
    the kernel takes them (:func:`tf32_matmul`); f32 or bf16 inputs, f32
    math, output in shared's dtype. For tests: the CUDA kernel's arithmetic,
    emulated on the CPU."""
    cin, c2ch = x.shape[-1], shared.shape[-1]
    h = torch.relu(tf32_matmul(x.reshape(-1, cin), w1, split) + c1)
    attn = torch.sigmoid(tf32_matmul(h, w2, split) + c2)
    out = shared.reshape(-1, c2ch).float() * attn
    return out.to(shared.dtype).reshape(shared.shape)


def fused_attention_gate(
    x: torch.Tensor,
    shared: torch.Tensor,
    w1: torch.Tensor,
    c1: torch.Tensor,
    w2: torch.Tensor,
    c2: torch.Tensor,
) -> torch.Tensor:
    """out = shared * sigmoid(relu(x@w1 + c1) @ w2 + c2), NHWC, through the
    operator ``torch.ops.vmtl.fused_attention_gate``.

    Args:
      x: (B, H, W, Cin) gate input (folded-BN scales pre-multiplied into w1).
      shared: (B, H, W, C2) features to modulate, same dtype as x.
      w1: (Cin, hidden); c1: (hidden,) — first conv1x1 + folded BN1.
      w2: (hidden, C2); c2: (C2,) — second conv1x1 + folded BN2.

    CPU tensors take :func:`fused_attention_gate_plain`. CUDA tensors launch
    the kernel (f32 or bf16 activations, f32 weights, all contiguous, w1
    and w2 16-byte aligned) or raise; there is no fallback, and tensors on
    any other device raise too.
    """
    return torch.ops.vmtl.fused_attention_gate(x, shared, w1, c1, w2, c2)


def fused_attention_gate_tasks(
    x: torch.Tensor,
    shared: torch.Tensor,
    w1: torch.Tensor,
    c1: torch.Tensor,
    w2: torch.Tensor,
    c2: torch.Tensor,
) -> torch.Tensor:
    """The gates of T tasks on one shared map, through the operator
    ``torch.ops.vmtl.fused_attention_gate_tasks``: out[t] = shared *
    sigmoid(relu(x[t] @ w1[t] + c1[t]) @ w2[t] + c2[t]).

    Args:
      x: (T, B, H, W, Cin); shared: (B, H, W, C2), every task's, same dtype.
      w1: (T, Cin, hidden); c1: (T, hidden); w2: (T, hidden, C2); c2: (T, C2).

    Returns (T, B, H, W, C2) in shared's dtype. CPU tensors take
    :func:`fused_attention_gate_tasks_plain`; CUDA tensors launch the kernel
    once for all tasks, or raise, as :func:`fused_attention_gate` does.
    """
    return torch.ops.vmtl.fused_attention_gate_tasks(x, shared, w1, c1, w2, c2)


def _launch(x, shared, w1, c1, w2, c2) -> torch.Tensor:
    """The operator's CUDA kernel: checks the tensors, launches the task-axis
    kernel with T = 1, counts."""
    _check(x, shared, w1, c1, w2, c2)
    return _launch_on_tasks(
        "fused_attention_gate", launches, x[None], shared, w1[None], c1[None], w2[None],
        c2[None],
    )[0]


def _launch_tasks(x, shared, w1, c1, w2, c2) -> torch.Tensor:
    """The task-axis operator's CUDA kernel: checks, launches, counts."""
    _check_tasks(x, shared, w1, c1, w2, c2)
    return _launch_on_tasks("fused_attention_gate_tasks", tasks.launches, x, shared, w1, c1, w2, c2)


def _launch_on_tasks(kernel: str, counter: LaunchCounter, x, shared, w1, c1, w2, c2):
    """One launch of ``vmtl_fused_attention_gate_tasks`` on checked tensors
    with a leading task axis; ``counter`` counts it."""
    n_tasks, b, h, w, cin = x.shape
    hidden, c2ch = w2.shape[1:]
    n = b * h * w
    out = torch.empty((n_tasks, *shared.shape), dtype=shared.dtype, device=shared.device)
    if n == 0:
        return out
    fn = load(SOURCE, "vmtl_fused_attention_gate_tasks", _SIGNATURE)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), shared.data_ptr(), w1.data_ptr(), c1.data_ptr(),
            w2.data_ptr(), c2.data_ptr(), out.data_ptr(),
            n_tasks, n, cin, hidden, c2ch, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed, CUDA error {rc}")
    counter.add()
    return out


def _fake(x, shared, w1, c1, w2, c2) -> torch.Tensor:
    """The operator's output from metadata alone; off the CPU the tensors
    must fit the kernel, as the CUDA launch checks."""
    if x.device.type != "cpu":
        _check(x, shared, w1, c1, w2, c2)
    return torch.empty_like(shared, memory_format=torch.contiguous_format)


def _fake_tasks(x, shared, w1, c1, w2, c2) -> torch.Tensor:
    if x.device.type != "cpu":
        _check_tasks(x, shared, w1, c1, w2, c2)
    return shared.new_empty((x.shape[0], *shared.shape))


# the plain version is looked up at each call (tests replace it)
_lib = torch.library.Library("vmtl", "FRAGMENT")
_lib.define(
    "fused_attention_gate(Tensor x, Tensor shared, Tensor w1, Tensor c1, Tensor w2, "
    "Tensor c2) -> Tensor"
)
_lib.impl("fused_attention_gate", lambda *a: fused_attention_gate_plain(*a), "CPU")
_lib.impl("fused_attention_gate", _launch, "CUDA")
torch.library.register_fake("vmtl::fused_attention_gate", _fake, lib=_lib)
_lib.define(
    "fused_attention_gate_tasks(Tensor x, Tensor shared, Tensor w1, Tensor c1, Tensor w2, "
    "Tensor c2) -> Tensor"
)
_lib.impl(
    "fused_attention_gate_tasks", lambda *a: fused_attention_gate_tasks_plain(*a), "CPU"
)
_lib.impl("fused_attention_gate_tasks", _launch_tasks, "CUDA")
torch.library.register_fake("vmtl::fused_attention_gate_tasks", _fake_tasks, lib=_lib)


def _no_backward(ctx, grad):
    raise RuntimeError(
        "vmtl::fused_attention_gate has no backward: it is MTAN's eval-mode gate; "
        "a train-mode forward takes kernels/fused_gate_train.py"
    )


# inference only: a backward through the operators raises instead of leaving
# the gate's inputs without a gradient
torch.library.register_autograd("vmtl::fused_attention_gate", _no_backward, lib=_lib)
torch.library.register_autograd("vmtl::fused_attention_gate_tasks", _no_backward, lib=_lib)


def _check(x, shared, w1, c1, w2, c2) -> None:
    check_gate_args("fused_attention_gate", x, shared, w1, w2, {"c1": c1}, {"c2": c2})


def _check_tasks(x, shared, w1, c1, w2, c2) -> None:
    check_gate_args(
        "fused_attention_gate_tasks", x, shared, w1, w2, {"c1": c1}, {"c2": c2},
        n_tasks=x.shape[0] if x.dim() == 5 else -1,
    )


def check_gate_args(
    kernel: str,
    x: torch.Tensor,
    shared: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    vectors1: t.Dict[str, torch.Tensor],
    vectors2: t.Dict[str, torch.Tensor],
    n_tasks: t.Optional[int] = None,
) -> None:
    """Raises unless the tensors fit a gate kernel: all CUDA on one device
    and contiguous; x and shared NHWC with the same B, H, W, both float32 or
    both bfloat16; float32 weights w1 (Cin, hidden), w2 (hidden, C2), the
    named (hidden,) ``vectors1`` and (C2,) ``vectors2``; hidden and C2
    multiples of 4 up to MAX_HIDDEN and MAX_C2. With ``n_tasks`` (the task
    axis), x is (T, B, H, W, Cin) and every weight has the leading T, 1 <= T
    <= MAX_TASKS; shared stays (B, H, W, C2)."""
    weights = {"w1": w1, "w2": w2, **vectors1, **vectors2}
    for name, v in {"x": x, "shared": shared, **weights}.items():
        if v.device != x.device or v.device.type != "cuda":
            raise ValueError(
                f"{kernel}: {name} is on {v.device}; the kernel takes CUDA "
                f"tensors on one device (x is on {x.device})"
            )
        if not v.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16) or shared.dtype != x.dtype:
        raise TypeError(
            f"{kernel}: x and shared must both be float32 or both bfloat16, got "
            f"{x.dtype} and {shared.dtype}"
        )
    for name, v in weights.items():
        if v.dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} must be float32")
    lead = () if n_tasks is None else (n_tasks,)
    if n_tasks is not None and not 1 <= n_tasks <= MAX_TASKS:
        raise ValueError(
            f"{kernel}: x {tuple(x.shape)} must be (T, B, H, W, Cin) with 1 <= T <= {MAX_TASKS}"
        )
    if x.dim() != 4 + len(lead) or shared.dim() != 4 or x.shape[len(lead):-1] != shared.shape[:3]:
        raise ValueError(
            f"{kernel}: x {tuple(x.shape)} and shared {tuple(shared.shape)} must "
            f"be NHWC with the same B, H, W{' (x with a leading task axis)' if lead else ''}"
        )
    cin, c2ch = x.shape[-1], shared.shape[-1]
    hidden = w1.shape[-1] if w1.dim() == 2 + len(lead) else -1
    shapes = {"w1": lead + (cin, hidden), "w2": lead + (hidden, c2ch)}
    shapes.update({name: lead + (hidden,) for name in vectors1})
    shapes.update({name: lead + (c2ch,) for name in vectors2})
    for name, shape in shapes.items():
        if tuple(weights[name].shape) != shape:
            raise ValueError(
                f"{kernel}: {name} {tuple(weights[name].shape)} does not fit "
                f"Cin={cin}, hidden={hidden}, C2={c2ch}"
            )
    if hidden % 4 or not 0 < hidden <= MAX_HIDDEN or c2ch % 4 or not 0 < c2ch <= MAX_C2:
        raise ValueError(
            f"{kernel}: the kernel takes hidden and C2 that are multiples of 4, "
            f"hidden <= {MAX_HIDDEN} and C2 <= {MAX_C2}; got hidden={hidden}, "
            f"C2={c2ch}"
        )
