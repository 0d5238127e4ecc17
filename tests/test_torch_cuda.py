"""The CUDA kernels against their plain versions at ragged and edge shapes.

These need a CUDA card (and nvcc to build the kernels) and skip without one;
run them on the card with ``python -m pytest tests/test_torch_cuda.py``.
``chip_smoke.py`` covers the full-width shapes of the main path.
"""

import pytest
import torch

from vision_mtl_tpu_torch.kernels import confmat, fused_gate


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
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
