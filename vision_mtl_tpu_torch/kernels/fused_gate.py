"""MTAN's inference-mode attention gate: CUDA kernel and its plain version.

Counterpart of ``vision_mtl_tpu/ops/pallas/fused_gate.py`` (``fold_bn``,
``fused_attention_gate``). In eval mode the gate chain

    attn = sigmoid(BN2(conv1x1_2(relu(BN1(conv1x1_1(x))))));  out = shared * attn

is two per-pixel products with affine BNs, folded by :func:`fold_bn` into
``(w, c)`` pairs. The CUDA kernel (``csrc/fused_gate.cu``) keeps the
``(N, hidden)`` intermediate in shared memory; :func:`fused_attention_gate_plain`
computes the same function with PyTorch ops and is what runs for CPU tensors.

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

from vision_mtl_tpu_torch.kernels._build import LaunchCounter, load

SOURCE = "fused_gate"
MAX_HIDDEN = 128
MAX_C2 = 512

launches = LaunchCounter()

_SIGNATURE = (
    [ctypes.c_void_p] * 7
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
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
    """out = shared * sigmoid(relu(x@w1 + c1) @ w2 + c2), NHWC.

    Args:
      x: (B, H, W, Cin) gate input (folded-BN scales pre-multiplied into w1).
      shared: (B, H, W, C2) features to modulate, same dtype as x.
      w1: (Cin, hidden); c1: (hidden,) — first conv1x1 + folded BN1.
      w2: (hidden, C2); c2: (C2,) — second conv1x1 + folded BN2.

    CPU tensors take :func:`fused_attention_gate_plain`. CUDA tensors launch
    the kernel (f32 or bf16 activations, f32 weights, all contiguous, w1
    and w2 16-byte aligned) or raise; there is no fallback.
    """
    if x.device.type == "cpu":
        return fused_attention_gate_plain(x, shared, w1, c1, w2, c2)
    _check(x, shared, w1, c1, w2, c2)
    b, h, w, cin = x.shape
    hidden, c2ch = w2.shape
    n = b * h * w
    out = torch.empty_like(shared)
    if n == 0:
        return out
    fn = load(SOURCE, "vmtl_fused_attention_gate", _SIGNATURE)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), shared.data_ptr(), w1.data_ptr(), c1.data_ptr(),
            w2.data_ptr(), c2.data_ptr(), out.data_ptr(),
            n, cin, hidden, c2ch, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_attention_gate: kernel launch failed, CUDA error {rc}")
    launches.add()
    return out


def _check(x, shared, w1, c1, w2, c2) -> None:
    check_gate_args("fused_attention_gate", x, shared, w1, w2, {"c1": c1}, {"c2": c2})


def check_gate_args(
    kernel: str,
    x: torch.Tensor,
    shared: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    vectors1: t.Dict[str, torch.Tensor],
    vectors2: t.Dict[str, torch.Tensor],
) -> None:
    """Raises unless the tensors fit a gate kernel: all CUDA on one device
    and contiguous; x and shared NHWC with the same B, H, W, both float32 or
    both bfloat16; float32 weights w1 (Cin, hidden), w2 (hidden, C2), the
    named (hidden,) ``vectors1`` and (C2,) ``vectors2``; hidden and C2
    multiples of 4 up to MAX_HIDDEN and MAX_C2."""
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
    if x.dim() != 4 or shared.dim() != 4 or x.shape[:3] != shared.shape[:3]:
        raise ValueError(
            f"{kernel}: x {tuple(x.shape)} and shared {tuple(shared.shape)} must "
            "be NHWC with the same B, H, W"
        )
    cin, c2ch = x.shape[-1], shared.shape[-1]
    hidden = w1.shape[-1] if w1.dim() == 2 else -1
    shapes = {"w1": (cin, hidden), "w2": (hidden, c2ch)}
    shapes.update({name: (hidden,) for name in vectors1})
    shapes.update({name: (c2ch,) for name in vectors2})
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
