"""The CUDA kernels against their plain versions at ragged and edge shapes.

These need a CUDA card (and nvcc to build the kernels) and skip without one;
run them on the card with ``python -m pytest --noconftest
tests/test_torch_cuda.py`` (the suite's conftest imports JAX, which the
card's machine need not have).
``chip_smoke.py`` covers the full-width shapes of the main path.
"""

import pytest
import torch

from vision_mtl_tpu_torch.kernels import confmat, fused_gate, fused_gate_train, small_conv
from vision_mtl_tpu_torch.ops.small_conv import conv3x3_small


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gate_args(dev, dtype, b, h, w, cin, hidden, c2, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (
        torch.randn(b, h, w, cin, generator=g, device=dev).to(dtype),
        torch.randn(b, h, w, c2, generator=g, device=dev).to(dtype),
        torch.randn(cin, hidden, generator=g, device=dev) * 0.3,
        torch.randn(hidden, generator=g, device=dev),
        torch.randn(hidden, c2, generator=g, device=dev) * 0.3,
        torch.randn(c2, generator=g, device=dev),
    )


# ragged N against the 32-row tile, Cin below / across the 32-wide chunk,
# the smallest and largest hidden and C2 the kernel takes
@pytest.mark.parametrize(
    "shape",
    [
        (1, 5, 7, 3, 8, 4),
        (2, 9, 13, 33, 128, 12),
        (1, 31, 1, 640, 128, 256),
        (3, 3, 11, 64, 4, 512),
        (1, 1, 1, 1, 128, 32),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_kernel_matches_plain(cuda, shape, dtype):
    args = _gate_args(cuda, dtype, *shape)
    before = fused_gate.launches.value
    got = fused_gate.fused_attention_gate(*args)
    want = fused_gate.fused_attention_gate_plain(*args)
    torch.cuda.synchronize()
    assert fused_gate.launches.value == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-4
    else:  # one bf16 rounding step of the f32 result
        assert bool((diff <= want.float().abs() * 2**-7 + 1e-6).all())


def test_gate_kernel_rejects_what_it_does_not_take(cuda):
    args = list(_gate_args(cuda, torch.float32, 1, 4, 4, 3, 8, 4))
    with pytest.raises(TypeError):
        fused_gate.fused_attention_gate(args[0].half(), args[1].half(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        fused_gate.fused_attention_gate(args[0].transpose(1, 2), *args[1:])
    bad = _gate_args(cuda, torch.float32, 1, 4, 4, 3, 6, 4)  # hidden 6
    with pytest.raises(ValueError, match="multiples of 4"):
        fused_gate.fused_attention_gate(*bad)
    with pytest.raises(ValueError, match="CUDA"):
        fused_gate.fused_attention_gate(args[0], args[1].cpu(), *args[2:])


@pytest.mark.parametrize("n,c,masked", [(1, 3, False), (4097, 19, True), (100_003, 110, True)])
def test_confmat_kernel_matches_plain(cuda, n, c, masked):
    g = torch.Generator(device=cuda).manual_seed(n)
    t = torch.randint(-3, c + 3, (n,), generator=g, device=cuda, dtype=torch.int32)
    p = torch.randint(-3, c + 3, (n,), generator=g, device=cuda, dtype=torch.int32)
    mask = torch.rand(n, generator=g, device=cuda) < 0.6 if masked else None
    got = confmat.confusion_matrix(t, p, c, mask)
    want = confmat.confusion_matrix_plain(t, p, c, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_confmat_counts_past_f32_integer_range(cuda):
    """One cell with 2^24 + 3 samples: the integer count comes out as the
    f32 nearest to it, 2^24 + 4 (an f32 running sum of ones stops at 2^24)."""
    n = (1 << 24) + 3
    t = torch.zeros(n, dtype=torch.int32, device=cuda)
    got = confmat.confusion_matrix(t, t, 2)
    torch.cuda.synchronize()
    assert float(got[0, 0]) == float((1 << 24) + 4)
    assert float(got[1, 1]) == 0.0


def _train_gate_args(dev, dtype, b, h, w, cin, hidden, c2, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (
        torch.randn(b, h, w, cin, generator=g, device=dev).to(dtype),
        torch.randn(b, h, w, c2, generator=g, device=dev).to(dtype),
        torch.randn(cin, hidden, generator=g, device=dev) * 0.3,
        torch.randn(hidden, generator=g, device=dev),
        torch.rand(hidden, generator=g, device=dev) + 0.5,
        torch.randn(hidden, generator=g, device=dev) * 0.3,
        torch.randn(hidden, c2, generator=g, device=dev) * 0.3,
        torch.randn(c2, generator=g, device=dev),
        torch.rand(c2, generator=g, device=dev) + 0.5,
        torch.randn(c2, generator=g, device=dev) * 0.3,
    )


def _assert_train_gate_close(got, want):
    out, *stats = got
    ref, *ref_stats = want
    diff = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        assert float(diff.max()) <= 1e-4
    else:  # one bf16 rounding step of the f32 result
        assert bool((diff <= ref.float().abs() * 2**-7 + 1e-6).all())
    for s, r in zip(stats, ref_stats):  # the plain version sums in f64
        assert s.dtype == torch.float32
        assert bool(((s - r).abs() <= 1e-5 * r.abs() + 1e-6).all())


# ragged N against the 32-row tile and, at N = 9514, against the statistics
# passes' 264 blocks (several tiles a block); Cin below / across the 32-wide
# chunk; hidden 8 and 128, C2 4 and 512
@pytest.mark.parametrize(
    "shape",
    [
        (1, 5, 7, 3, 8, 4),
        (2, 9, 13, 33, 128, 12),
        (1, 31, 1, 640, 128, 256),
        (3, 3, 11, 64, 8, 512),
        (2, 67, 71, 20, 16, 12),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_gate_kernel_matches_plain(cuda, shape, dtype):
    args = _train_gate_args(cuda, dtype, *shape)
    before = fused_gate_train.launches.value
    got = fused_gate_train.fused_attention_gate_train(*args)
    again = fused_gate_train.fused_attention_gate_train(*args)
    want = fused_gate_train.fused_attention_gate_train_plain(*args)
    torch.cuda.synchronize()
    assert fused_gate_train.launches.value == before + 2
    assert got[0].dtype == dtype and got[0].shape == want[0].shape
    _assert_train_gate_close(got, want)
    for a, b in zip(got, again):  # the sums run in a fixed order
        assert torch.equal(a, b)


def test_train_gate_variance_of_an_offset_channel(cuda):
    """A channel whose mean is 1000 times its spread, over 262,144 rows:
    E[h^2] - E[h]^2 in f32 would lose the variance; the kernel's stays within
    1e-4 of an f64 reference computed from the same inputs."""
    args = list(_train_gate_args(cuda, torch.float32, 8, 128, 256, 3, 8, 4))
    args[3][0] = 1000.0  # b1 of channel 0
    args[7][1] = -500.0  # b2 of channel 1
    _, mean1, var1, mean2, var2 = fused_gate_train.fused_attention_gate_train(*args)
    ref = fused_gate_train.fused_attention_gate_train_plain(*(a.double() for a in args))
    for got, want in zip((mean1, var1, mean2, var2), ref[1:]):
        assert bool(((got.double() - want).abs() <= 1e-4 * want.abs() + 1e-6).all())


def test_train_gate_backward_matches_cpu(cuda):
    """The Function's gradients on the card (kernel forward) against the CPU
    (plain forward), all ten inputs."""
    args = _train_gate_args(cuda, torch.float32, 2, 17, 9, 40, 16, 24)
    cot = torch.randn(2, 17, 9, 24, device=cuda)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [a.detach().to(dev).requires_grad_() for a in args]
        out = fused_gate_train.fused_attention_gate_train(*leaves)[0]
        (out * cot.to(dev)).sum().backward()
        grads.append([leaf.grad.cpu() for leaf in leaves])
    top = max(float(g.abs().max()) for g in grads[1])
    for i, (got, want) in enumerate(zip(*grads)):
        if i in (3, 7):  # b1, b2: 0 up to rounding, as a batch-statistic BN follows
            assert max(float(got.abs().max()), float(want.abs().max())) <= 1e-4 * top
        else:
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-6


def test_train_gate_kernel_rejects_what_it_does_not_take(cuda):
    args = list(_train_gate_args(cuda, torch.float32, 1, 4, 4, 3, 8, 4))
    with pytest.raises(TypeError):
        fused_gate_train.fused_attention_gate_train(args[0].half(), args[1].half(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        fused_gate_train.fused_attention_gate_train(args[0].transpose(1, 2), *args[1:])
    bad = _train_gate_args(cuda, torch.float32, 1, 4, 4, 3, 6, 4)  # hidden 6
    with pytest.raises(ValueError, match="multiples of 4"):
        fused_gate_train.fused_attention_gate_train(*bad)
    with pytest.raises(ValueError, match="CUDA"):
        fused_gate_train.fused_attention_gate_train(args[0], args[1].cpu(), *args[2:])


def _assert_conv_close(got, want):
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:  # sums of up to 891 products in another order
        assert float(diff.max()) <= 1e-4 * max(1.0, float(want.abs().max()))
    else:  # one bf16 rounding step of the f32 result
        assert bool((diff <= want.float().abs() * 2**-7 + 1e-6).all())


# ragged H and W against the 4 x 32 tile, C across the 8-channel chunk, O
# below, at and across the 8-channel warp slice, the largest C and O taken
@pytest.mark.parametrize(
    "shape",
    [(1, 1, 1, 1, 1), (2, 5, 33, 9, 8), (1, 13, 70, 33, 20), (3, 9, 31, 20, 33),
     (1, 6, 65, 99, 99), (2, 4, 32, 67, 67)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_small_conv_kernel_matches_plain(cuda, shape, dtype, bias):
    b, h, w, c, o = shape
    g = torch.Generator(device=cuda).manual_seed(h * w + c)
    x = torch.randn(b, h, w, c, generator=g, device=cuda).to(dtype)
    k = (torch.rand(3, 3, c, o, generator=g, device=cuda) * 2 - 1) / (9 * c) ** 0.5
    bv = torch.randn(o, generator=g, device=cuda) if bias else None
    before = small_conv.launches.value
    got = small_conv.conv3x3_small(x, k, bv)
    again = small_conv.conv3x3_small(x, k, bv)
    want = small_conv.conv3x3_small_plain(x, k, bv)
    torch.cuda.synchronize()
    assert small_conv.launches.value == before + 2
    assert got.dtype == dtype and got.shape == (b, h, w, o)
    _assert_conv_close(got, want)
    assert torch.equal(got, again)  # a fixed summation order


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_conv_backward_matches_cpu(cuda, dtype):
    """dx (the kernel on the flipped weights), dw and db on the card against
    the CPU's plain path, at a ragged 67 -> 33 shape."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 7, 37, 67, generator=g).to(dtype)
    k = (torch.rand(3, 3, 67, 33, generator=g) * 2 - 1) / (9 * 67) ** 0.5
    bv = torch.randn(33, generator=g)
    cot = torch.randn(2, 7, 37, 33, generator=g).to(dtype)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [a.to(dev).requires_grad_() for a in (x, k, bv)]
        before = small_conv.launches.value
        conv3x3_small(*leaves).backward(cot.to(dev))
        if dev.type == "cuda":
            assert small_conv.launches.value == before + 2  # forward and dx
        grads.append([leaf.grad.cpu() for leaf in leaves])
    (dx, dw, db), (dx_cpu, dw_cpu, db_cpu) = grads
    _assert_conv_close(dx, dx_cpu)
    tol = 1e-4 if dtype == torch.float32 else 2e-2  # dw: bf16 output of another sum order
    assert float((dw - dw_cpu).abs().max()) <= tol * float(dw_cpu.abs().max())
    assert float((db - db_cpu).abs().max()) <= 1e-4 * float(db_cpu.abs().max())


def test_small_conv_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn(1, 4, 4, 8, device=cuda)
    k = torch.randn(3, 3, 8, 8, device=cuda)
    with pytest.raises(TypeError):
        small_conv.conv3x3_small(x.half(), k)
    with pytest.raises(ValueError, match="contiguous"):
        small_conv.conv3x3_small(x.transpose(1, 2), k)
    with pytest.raises(ValueError, match="channels"):
        small_conv.conv3x3_small(torch.randn(1, 4, 4, 100, device=cuda),
                                 torch.randn(3, 3, 100, 8, device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        small_conv.conv3x3_small(x, k.cpu())
