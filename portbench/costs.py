"""The yardstick's table of peaks and the operations and bytes of the
program's hand-written kernels, counted from their shapes.

Peaks: one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet, dense rates
at the full 700 W power limit. A run records the card's power limit beside
every share of a peak.

A kernel's least time is the larger of its bytes over the memory bandwidth
and its operations over the peak rate. Bytes count each input read once and
each returned output written once, at the dtypes the configuration states;
operations count the algorithm's products once, whatever precision trick
(such as 3xTF32) an implementation uses, against the bf16 tensor-core rate.
"""

from __future__ import annotations

import typing as t

BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def least_s(flops: float, nbytes: float) -> t.Tuple[float, str]:
    """The least time of ``flops`` operations moving ``nbytes``, and which
    of the two bounds it ("bytes" or "operations")."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def gate(rows: int, cin: int, c2: int, hidden: int, act_bytes: int,
         train: bool) -> t.Tuple[float, float]:
    """(operations, bytes) of one attention-gate launch over ``rows``
    pixels: ``shared * sigmoid(BN(relu(BN(x w1 + b1)) w2 + b2))``. Reads x
    (rows, cin) and shared (rows, c2), writes the output (rows, c2), in the
    activations' dtype; the f32 weights and per-channel vectors once. The
    train gate also writes the four f32 statistics vectors."""
    flops = 2.0 * rows * (cin * hidden + hidden * c2)
    # b, scale and shift of each BN'd product; mean and variance of each
    vectors = (3 + (2 if train else 0)) * (hidden + c2)
    nbytes = act_bytes * rows * (cin + 2 * c2) + 4 * (cin * hidden + hidden * c2 + vectors)
    return flops, float(nbytes)


def conv3x3(batch: int, h: int, w: int, cin: int, cout: int, bias: bool,
            act_bytes: int) -> t.Tuple[float, float]:
    """(operations, bytes) of one 3x3 stride-1 convolution launch: reads
    the input (batch, h, w, cin) and writes (batch, h, w, cout) in the
    activations' dtype, the f32 kernel (and bias) once."""
    flops = 2.0 * batch * h * w * cin * cout * 9
    nbytes = act_bytes * batch * h * w * (cin + cout) + 4 * (9 * cin * cout + (cout if bias else 0))
    return flops, float(nbytes)
