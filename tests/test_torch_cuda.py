"""The CUDA kernels against their plain versions at ragged and edge shapes.

These need a CUDA card (and nvcc to build the kernels) and skip without one;
run them on the card with ``python -m pytest --noconftest
tests/test_torch_cuda.py`` (the suite's conftest imports JAX, which the
card's machine need not have).
``chip_smoke.py`` covers the full-width shapes of the main path.
"""

import numpy as np
import pytest
import torch

from vision_mtl_tpu_torch.cfg import fetch_data_cfg
from vision_mtl_tpu_torch.kernels import confmat, fused_gate, fused_gate_train, small_conv
from vision_mtl_tpu_torch.models.registry import build_model
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


# ragged N around the 64- and 128-row tiles (1, 63-65, 127-129) and the
# small-N switch (64-row tiles up to N = 8,320, 128 above), Cin below and
# across the 32- and 64-deep stages (3 and 1: bf16 rows not 16-byte
# aligned, so staged element by element; 640), the smallest and largest
# hidden and C2 the kernel takes. Blocks pair up at small N and for C2
# above 128 (dec0's widths among them): C2 of 4 (the pair's second slice
# empty), 12 (bf16 rows of 24 bytes: the output written element by
# element), 256 at large N, and 512 (two pairs); a single Cin stage (the
# pair's second block adds nothing)
@pytest.mark.parametrize(
    "shape",
    [
        (1, 5, 7, 3, 8, 4),
        (2, 9, 13, 33, 128, 12),
        (1, 31, 1, 640, 128, 256),
        (3, 3, 11, 64, 4, 512),
        (1, 1, 1, 1, 128, 32),
        (1, 1, 63, 64, 128, 64),
        (1, 1, 64, 3, 128, 32),
        (1, 1, 65, 192, 128, 32),
        (1, 1, 127, 3, 128, 32),
        (1, 1, 128, 640, 128, 256),
        (1, 1, 129, 256, 128, 256),
        (1, 1, 8320, 192, 128, 32),
        (1, 1, 8321, 192, 128, 32),
        (8, 16, 32, 640, 128, 256),
        (1, 129, 129, 3, 128, 32),
        (1, 1, 8321, 64, 128, 256),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_kernel_matches_plain(cuda, shape, dtype):
    args = _gate_args(cuda, dtype, *shape)
    before = fused_gate.launches.value
    got = fused_gate.fused_attention_gate(*args)
    again = fused_gate.fused_attention_gate(*args)
    want = fused_gate.fused_attention_gate_plain(*args)
    torch.cuda.synchronize()
    assert fused_gate.launches.value == before + 2
    assert got.dtype == dtype and got.shape == want.shape
    _assert_gate_close(got, want)
    assert torch.equal(got, again)  # no atomics: the same bits


# x and shared as views 1-3 elements past a 16-byte boundary: staged and
# written element by element, in place
@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_kernel_unaligned_views(cuda, offset, dtype):
    b, h, w, cin, hidden, c2 = 1, 3, 100, 64, 128, 64
    args = list(_gate_args(cuda, dtype, b, h, w, cin, hidden, c2))
    for i, ch in ((0, cin), (1, c2)):
        buf = torch.empty(b * h * w * ch + offset, dtype=dtype, device=cuda)
        view = buf[offset:].view(b, h, w, ch)
        view.copy_(args[i])
        args[i] = view
    got = fused_gate.fused_attention_gate(*args)
    want = fused_gate.fused_attention_gate_plain(*args)
    torch.cuda.synchronize()
    _assert_gate_close(got, want)


def _assert_gate_close(got, want):
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
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


def _confmat_inputs(dev, n, c, masked, labels, offsets=(0, 0, 0), seed=0):
    """targets, preds and mask of n samples, each a view ``offsets`` elements
    into a larger buffer. labels: "random" ids in [-3, C + 3) (some outside
    [0, C)); "diagonal": preds = targets, runs of one class along rows of
    256; "one_class": every sample in cell (C - 1, C - 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if labels == "random":
        t = torch.randint(-3, c + 3, (n,), generator=g, device=dev, dtype=torch.int32)
        p = torch.randint(-3, c + 3, (n,), generator=g, device=dev, dtype=torch.int32)
    elif labels == "diagonal":
        t = (torch.arange(n, device=dev, dtype=torch.int32) // 256) % c
        p = t.clone()
    else:
        t = torch.full((n,), c - 1, device=dev, dtype=torch.int32)
        p = t.clone()
    mask = torch.rand(n, generator=g, device=dev) < 0.6 if masked else None

    def at_offset(v, k):
        buf = torch.empty(n + k, dtype=v.dtype, device=dev)
        buf[k:] = v
        return buf[k:]

    t, p = at_offset(t, offsets[0]), at_offset(p, offsets[1])
    return t, p, None if mask is None else at_offset(mask, offsets[2])


# n of 1, not a multiple of 4 and of 16, C up to the shared-memory limit of
# 110; spatially coherent labels (every lane of a warp on one cell) and one
# class; ids, and mask bytes, at element offsets: equal (aligned 16-byte
# loads from a later index) and unequal (every sample taken alone)
@pytest.mark.parametrize(
    "n,c,masked,labels,offsets",
    [
        (1, 3, False, "random", (0, 0, 0)),
        (4097, 19, True, "random", (0, 0, 0)),
        (100_003, 110, True, "random", (0, 0, 0)),
        (262_144, 19, True, "one_class", (0, 0, 0)),
        (262_144, 19, False, "diagonal", (0, 0, 0)),
        (4_097, 19, True, "diagonal", (1, 1, 1)),
        (65_537, 19, True, "random", (3, 3, 7)),
        (100_003, 110, False, "one_class", (5, 5, 0)),
        (30, 19, True, "random", (1, 1, 1)),
        (10_001, 19, True, "random", (0, 1, 0)),
        (10_001, 19, True, "diagonal", (2, 2, 3)),
    ],
)
def test_confmat_kernel_matches_plain(cuda, n, c, masked, labels, offsets):
    t, p, mask = _confmat_inputs(cuda, n, c, masked, labels, offsets, seed=n)
    before = confmat.launches.value
    got = confmat.confusion_matrix(t, p, c, mask)
    want = confmat.confusion_matrix_plain(t, p, c, mask)
    torch.cuda.synchronize()
    assert confmat.launches.value == before + 1
    assert torch.equal(got, want)


def test_confmat_back_to_back_calls_start_from_zero(cuda):
    """20 calls in a row on one stream, each on other labels and some with
    another C: every one exact, so each launch left its accumulator and done
    counter at zero for the next."""
    calls = []
    for i in range(20):
        c = 19 if i % 3 else 7
        labels = ("random", "diagonal", "one_class")[i % 3]
        args = _confmat_inputs(cuda, 50_000 + 37 * i, c, i % 2 == 0, labels, seed=i)
        calls.append((confmat.confusion_matrix(*args[:2], c, args[2]), args, c))
    torch.cuda.synchronize()
    for got, (t, p, mask), c in calls:
        assert torch.equal(got, confmat.confusion_matrix_plain(t, p, c, mask))


def test_confmat_calls_on_two_streams(cuda):
    """Calls queued on two streams at once, each stream several times: each
    stream keeps its own accumulator, and every result is exact."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    inputs = [_confmat_inputs(cuda, 262_144, 19, True, labels, seed=i)
              for i, labels in enumerate(("one_class", "diagonal"))]
    torch.cuda.synchronize()
    results = [[], []]
    for _ in range(5):
        for k, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                t, p, mask = inputs[k]
                results[k].append(confmat.confusion_matrix(t, p, 19, mask))
    torch.cuda.synchronize()
    for k, (t, p, mask) in enumerate(inputs):
        want = confmat.confusion_matrix_plain(t, p, 19, mask)
        assert all(torch.equal(got, want) for got in results[k])


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


# against the redesigned kernel's row tiles (32 rows up to N = 8,320, else
# 128) and its column splits: N one past a tile, N below one tile, N at the
# small-N split of the hidden channels (fewer tiles than SMs) with C2 in
# two and four 128-wide slices (dec0's widths among them), the last N of
# the 32-row tile and N just past it, N past the split
@pytest.mark.parametrize(
    "shape",
    [
        (1, 1, 129, 64, 128, 32),
        (1, 5, 20, 3, 128, 64),
        (2, 16, 32, 256, 128, 256),
        (8, 16, 32, 640, 128, 256),
        (1, 64, 64, 128, 128, 512),
        (1, 1, 8320, 256, 128, 64),
        (1, 1, 8321, 64, 128, 32),
        (1, 33, 517, 192, 128, 32),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_gate_kernel_tiles_and_splits(cuda, shape, dtype):
    b, h, w, cin, hidden, c2 = shape
    g = torch.Generator(device=cuda).manual_seed(h * w + cin)

    def uniform(*size, bound=1.0):
        return (torch.rand(*size, generator=g, device=cuda) * 2 - 1) * bound

    args = (
        torch.randn(b, h, w, cin, generator=g, device=cuda).to(dtype),
        torch.randn(b, h, w, c2, generator=g, device=cuda).to(dtype),
        uniform(cin, hidden, bound=cin**-0.5), uniform(hidden, bound=cin**-0.5),
        uniform(hidden) * 0.5 + 1.0, uniform(hidden, bound=0.3),
        uniform(hidden, c2, bound=hidden**-0.5), uniform(c2, bound=hidden**-0.5),
        uniform(c2) * 0.5 + 1.0, uniform(c2, bound=0.3),
    )
    got = fused_gate_train.fused_attention_gate_train(*args)
    again = fused_gate_train.fused_attention_gate_train(*args)
    want = fused_gate_train.fused_attention_gate_train_plain(*args)
    torch.cuda.synchronize()
    _assert_train_gate_close(got, want)
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)


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


def _tasks_of(n_tasks, per_task_args):
    """The task-axis arguments of ``n_tasks`` tasks: task t's x and
    weights from ``per_task_args(t)``, shared from task 0's."""
    per_task = [per_task_args(t) for t in range(n_tasks)]
    stacked = [torch.stack(parts).contiguous() for parts in zip(*per_task)]
    stacked[1] = per_task[0][1]
    return stacked, per_task


# the task axis at T = 1, 2, 3: ragged N around the 64- and 128-row tiles
# and at the small-N switch (8,320: blocks pair up in clusters; 8,321: not),
# C2 of 256 (two slices, paired) and 12 (bf16 rows written element by
# element), Cin 3 (staged element by element) and 640
@pytest.mark.parametrize(
    "shape",
    [
        (1, 5, 7, 3, 8, 4),
        (2, 9, 13, 33, 128, 12),
        (1, 1, 65, 640, 128, 256),
        (1, 1, 8320, 192, 128, 32),
        (1, 1, 8321, 64, 128, 256),
        (1, 129, 129, 3, 128, 32),
    ],
)
@pytest.mark.parametrize("n_tasks", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_kernel_task_axis(cuda, shape, n_tasks, dtype):
    """One task-axis launch of B1 against its plain version, and each task
    bit for bit against a launch of that task alone."""
    stacked, per_task = _tasks_of(n_tasks, lambda t: _gate_args(cuda, dtype, *shape, seed=t))
    before = fused_gate.tasks.launches.value
    got = fused_gate.fused_attention_gate_tasks(*stacked)
    torch.cuda.synchronize()
    assert fused_gate.tasks.launches.value == before + 1
    want = fused_gate.fused_attention_gate_tasks_plain(*stacked)
    assert got.shape == (n_tasks, *stacked[1].shape) and got.dtype == dtype
    _assert_gate_close(got, want)
    for t, task_args in enumerate(per_task):
        alone = fused_gate.fused_attention_gate(task_args[0], stacked[1], *task_args[2:])
        assert torch.equal(got[t], alone)


@pytest.mark.parametrize(
    "shape",
    [
        (1, 5, 7, 3, 8, 4),
        (2, 9, 13, 33, 128, 12),
        (1, 1, 8320, 256, 128, 64),
        (1, 1, 8321, 64, 128, 32),
        (8, 16, 32, 640, 128, 256),
        (2, 67, 71, 20, 16, 12),
    ],
)
@pytest.mark.parametrize("n_tasks", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_gate_kernel_task_axis(cuda, shape, n_tasks, dtype):
    """One task-axis call of B4 against its plain version, and each task's
    output and statistics bit for bit against a call of that task alone."""
    stacked, per_task = _tasks_of(
        n_tasks, lambda t: _train_gate_args(cuda, dtype, *shape, seed=t))
    before = fused_gate_train.tasks.launches.value
    got = fused_gate_train.fused_attention_gate_train_tasks(*stacked)
    torch.cuda.synchronize()
    assert fused_gate_train.tasks.launches.value == before + 1
    want = fused_gate_train.fused_attention_gate_train_tasks_plain(*stacked)
    assert got[0].shape == (n_tasks, *stacked[1].shape)
    _assert_train_gate_close(got, want)
    for t, task_args in enumerate(per_task):
        alone = fused_gate_train.fused_attention_gate_train(
            task_args[0], stacked[1], *task_args[2:])
        for a, b in zip(got, alone):
            assert torch.equal(a[t], b)


def test_train_gate_task_axis_backward_matches_cpu(cuda):
    """The task-axis Function's gradients on the card (kernel forward)
    against the CPU (plain forward), all ten inputs, shared's summed over
    the tasks."""
    stacked, _ = _tasks_of(
        2, lambda t: _train_gate_args(cuda, torch.float32, 2, 17, 9, 40, 16, 24, seed=t))
    cot = torch.randn(2, 2, 17, 9, 24, device=cuda)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [a.detach().to(dev).requires_grad_() for a in stacked]
        out = fused_gate_train.fused_attention_gate_train_tasks(*leaves)[0]
        (out * cot.to(dev)).sum().backward()
        grads.append([leaf.grad.cpu() for leaf in leaves])
    top = max(float(g.abs().max()) for g in grads[1])
    for i, (got, want) in enumerate(zip(*grads)):
        if i in (3, 7):  # b1, b2: 0 up to rounding, as a batch-statistic BN follows
            assert max(float(got.abs().max()), float(want.abs().max())) <= 1e-4 * top
        else:
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-6


def _staged(args, world):
    """B4's staged call over ``world`` ranks, threads of this process (the
    rows cut in ``world`` parts); per rank its output and statistics.
    Forward only: a backward would run on autograd's one thread for the
    card, where two ranks' collectives would wait on each other."""
    import threading

    from vision_mtl_tpu_torch.parallel.multihost import ThreadComm, ThreadGroup

    group, out = ThreadGroup(world, timeout=60.0), [None] * world

    def rank(r):
        parts = [a.chunk(world)[r] for a in args[:2]]
        with torch.no_grad():
            out[r] = fused_gate_train.fused_attention_gate_train(
                *parts, *args[2:], comm=ThreadComm(group, r, parts[0].device))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(world)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    assert all(o is not None for o in out)
    return out


@pytest.mark.parametrize(
    "shape",
    [
        (2, 5, 7, 3, 8, 4),
        (2, 9, 13, 33, 128, 12),
        (4, 16, 32, 640, 128, 256),
        (2, 1, 8321, 64, 128, 32),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_gate_staged_across_ranks(cuda, shape, dtype):
    """The staged call of B4 (the statistics combined across ranks between
    its passes): with one rank bit for bit the fused call; with two, the
    rows cut in halves, against the plain version on all the rows, the same
    statistics on both ranks; its launches counted by ``ranks``, not by the
    fused call's counter. (Its backward is PyTorch ops, the plain split's:
    the CPU tests and chip_smoke.py's two rank processes run it.)"""
    from vision_mtl_tpu_torch.parallel.multihost import ThreadComm, ThreadGroup

    args = _train_gate_args(cuda, dtype, *shape)
    fused = fused_gate_train.fused_attention_gate_train(*args)
    # the wrapper takes one rank as one process (the fused call): the staged
    # launch with one rank is asked for below the wrapper
    one = fused_gate_train._launch(*args, 1e-5, comm=ThreadComm(ThreadGroup(1), 0, cuda))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, fused))
    before = fused_gate_train.ranks.launches.value, fused_gate_train.launches.value
    halves = _staged(args, 2)
    assert fused_gate_train.ranks.launches.value == before[0] + 2
    assert fused_gate_train.launches.value == before[1]
    want = fused_gate_train.fused_attention_gate_train_plain(*args)
    _assert_train_gate_close((torch.cat([halves[0][0], halves[1][0]]), *halves[0][1:]), want)
    assert all(torch.equal(a, b) for a, b in zip(halves[0][1:], halves[1][1:]))


def _assert_conv_close(got, want):
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:  # sums of up to 891 products in another order
        assert float(diff.max()) <= 1e-4 * max(1.0, float(want.abs().max()))
    else:  # one bf16 rounding step of the f32 result
        assert bool((diff <= want.float().abs() * 2**-7 + 1e-6).all())


# ragged H and W against the f32 kernel's 4 x 32 tile, C across its
# 8-channel chunk, O below, at and across its 8-channel warp slice, the
# largest C and O taken; bf16 through the tensor-core kernel
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


# bf16 (the tensor-core kernel) against its 4 x 64 tile and its channel
# padding: H, W off the tile, C and O across the 16-wide contraction and the
# 8-wide output tiles up to 99 (where the output channels split across
# blocks), batch 1 and 3, with and without bias
@pytest.mark.parametrize("hw", [(13, 11), (1, 1), (3, 40), (130, 257)])
@pytest.mark.parametrize(
    "c,o,b,bias",
    [(1, 99, 1, True), (8, 67, 3, False), (16, 33, 1, False), (17, 20, 3, True),
     (20, 17, 1, True), (33, 16, 3, False), (67, 8, 1, True), (99, 1, 3, False),
     (67, 67, 1, False), (99, 99, 3, True)],
)
def test_small_conv_bf16_tiles(cuda, hw, c, o, b, bias):
    h, w = hw
    g = torch.Generator(device=cuda).manual_seed(h * w + 7 * c + o)
    x = torch.randn(b, h, w, c, generator=g, device=cuda).to(torch.bfloat16)
    k = (torch.rand(3, 3, c, o, generator=g, device=cuda) * 2 - 1) / (9 * c) ** 0.5
    bv = torch.randn(o, generator=g, device=cuda) if bias else None
    got = small_conv.conv3x3_small(x, k, bv)
    again = small_conv.conv3x3_small(x, k, bv)
    want = small_conv.conv3x3_small_plain(x, k, bv)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, w, o)
    _assert_conv_close(got, want)
    assert torch.equal(got, again)


# bf16 x starting 1-7 elements past a 16-byte boundary (a view into a larger
# buffer): the kernel reads its chunks from the boundary below, with no copy
@pytest.mark.parametrize("offset", range(8))
def test_small_conv_bf16_unaligned_input(cuda, offset):
    b, h, w, c, o = 2, 9, 70, 67, 33
    g = torch.Generator(device=cuda).manual_seed(offset)
    buf = torch.randn(b * h * w * c + 8, generator=g, device=cuda).to(torch.bfloat16)
    x = buf[offset:offset + b * h * w * c].view(b, h, w, c)
    k = (torch.rand(3, 3, c, o, generator=g, device=cuda) * 2 - 1) / (9 * c) ** 0.5
    aligned = small_conv.conv3x3_small(x.clone(), k)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = small_conv.conv3x3_small(x, k)
    torch.cuda.synchronize()
    # only the output was allocated (the caching allocator rounds to 512 B)
    assert torch.cuda.max_memory_allocated() - base <= -(-got.numel() * 2 // 512) * 512
    _assert_conv_close(got, small_conv.conv3x3_small_plain(x, k))
    assert torch.equal(got, aligned)  # the same bits as from an aligned copy


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


# CSNet's heads (16 -> 1 and 16 -> 19, with bias) and their dx (1 -> 16,
# 19 -> 16, no bias): one input or output channel in an 8-wide output tile
# and a 16-deep contraction, at a ragged size
@pytest.mark.parametrize("c,o,bias", [(16, 1, True), (1, 16, False), (16, 19, True),
                                      (19, 16, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_conv_csnet_head_shapes(cuda, c, o, bias, dtype):
    g = torch.Generator(device=cuda).manual_seed(c * 100 + o)
    x = torch.randn(2, 37, 70, c, generator=g, device=cuda).to(dtype)
    k = (torch.rand(3, 3, c, o, generator=g, device=cuda) * 2 - 1) / (9 * c) ** 0.5
    bv = torch.randn(o, generator=g, device=cuda) if bias else None
    got = small_conv.conv3x3_small(x, k, bv)
    again = small_conv.conv3x3_small(x, k, bv)
    want = small_conv.conv3x3_small_plain(x, k, bv)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (2, 37, 70, o)
    _assert_conv_close(got, want)
    assert torch.equal(got, again)


def test_csnet_bf16_forward_matches_cpu(cuda):
    """The registry's CSNet in bf16 on the card (12 B3 launches) against the
    same seeded weights in f32 on the CPU, within 5% of each output's scale
    (the bf16 tolerance of the CPU model tests)."""
    cfg = fetch_data_cfg("synthetic")
    img = torch.from_numpy(
        np.random.default_rng(0).uniform(size=(2, cfg.height, cfg.width, 3)).astype(np.float32)
    )
    ref = build_model("csnet", cfg, dtype=torch.float32, device="cpu")
    model = build_model("csnet", cfg, dtype=torch.bfloat16, device=cuda)
    before = small_conv.launches.value
    with torch.inference_mode():
        want = ref(img)
        got = model(img.to(cuda))
    assert small_conv.launches.value == before + 12
    for k, w in want.items():
        assert got[k].dtype == torch.bfloat16 and got[k].shape == w.shape, k
        scale = float(w.abs().max())
        assert float((got[k].float().cpu() - w).abs().max()) <= 0.05 * scale, k


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


def test_prefetch_to_device_copies_before_use(cuda):
    """20 compact-wire batches through the pinned side-stream copy: each is
    read at once on the consumer's stream (the copy must be waited for),
    then again after the stream has been held back ~1 ms while the copies
    of the next batches run and a step's fresh buffers are written (the
    batch's memory must not go to another copy before that second read).
    Both reads equal the host batch."""
    from vision_mtl_tpu_torch.data.loader import prefetch_to_device

    rng = np.random.default_rng(0)
    host = [
        {"img": rng.integers(0, 256, (8, 128, 256, 3), dtype=np.uint8),
         "mask": rng.integers(0, 19, (8, 128, 256), dtype=np.uint8),
         "depth": rng.integers(0, 65536, (8, 128, 256, 1)).astype(np.uint16)}
        for _ in range(20)
    ]
    first, second = [], []
    for batch in prefetch_to_device(iter(host), cuda, size=2):
        assert all(v.device.type == "cuda" for v in batch.values())
        first.append({k: v.clone() for k, v in batch.items()})
        torch.cuda._sleep(2_000_000)
        torch.full_like(batch["img"], 255).add_(1)  # a step's buffers: freed memory overwritten
        second.append({k: v.to(torch.int32).sum(dim=0) for k, v in batch.items()})
        del batch
    torch.cuda.synchronize()
    assert len(first) == 20
    for h, a, b in zip(host, first, second):
        for k, v in h.items():
            np.testing.assert_array_equal(a[k].cpu().numpy(), v, err_msg=k)
            np.testing.assert_array_equal(b[k].cpu().numpy(), v.astype(np.int32).sum(axis=0),
                                          err_msg=k)


@pytest.mark.parametrize(
    "kernel", ["fused_attention_gate", "fused_attention_gate_tasks", "conv3x3_small"])
def test_operators_pass_opcheck_on_cuda(cuda, kernel):
    """``torch.library.opcheck`` with CUDA tensors: the fake version gives
    the kernel's output shape, dtype and strides, and the operator traces;
    each real call launches the kernel."""
    g = torch.Generator(device=cuda).manual_seed(0)
    if kernel == "fused_attention_gate":
        op, module = torch.ops.vmtl.fused_attention_gate.default, fused_gate
        cases = [_gate_args(cuda, dtype, 2, 5, 7, 64, 128, 32) for dtype in
                 (torch.float32, torch.bfloat16)]
    elif kernel == "fused_attention_gate_tasks":
        op, module = torch.ops.vmtl.fused_attention_gate_tasks.default, fused_gate.tasks
        cases = []
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(_tasks_of(2, lambda t: _gate_args(
                cuda, dtype, 2, 5, 7, 64, 128, 32, seed=t))[0])
    else:
        op, module = torch.ops.vmtl.conv3x3_small.default, small_conv
        k = torch.randn(3, 3, 33, 20, generator=g, device=cuda)
        cases = [
            (torch.randn(2, 9, 13, 33, generator=g, device=cuda), k,
             torch.randn(20, generator=g, device=cuda)),
            (torch.randn(2, 9, 13, 20, generator=g, device=cuda).bfloat16(),
             k.flip(0, 1).transpose(2, 3), None),
        ]
    before = module.launches.value
    for args in cases:
        torch.library.opcheck(op, args)
    torch.cuda.synchronize()
    assert module.launches.value > before


def test_exported_program_launches_the_kernels(cuda, tmp_path, monkeypatch):
    """A small bf16 MTAN and basic exported on the card and loaded back:
    the loaded program launches B1 at each gate and B3 at each small conv,
    and answers as ``Predictor`` does (ids exactly, depth within one bf16
    step). A tensor the kernel does not take raises inside the operator and
    never reaches the plain version."""
    from vision_mtl_tpu_torch.models.basic import BasicMTLModel
    from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet
    from vision_mtl_tpu_torch.serving import Predictor, export_model, load_exported

    tasks = {"depth": 1, "segm": 19}
    cases = [
        (MTANMiniUnet(tasks, encoder_first_channel=16, encoder_num_channels=4).to(cuda),
         fused_gate, 16, (64, 128)),
        (BasicMTLModel(19, decoder_first_channel=540).to(cuda), small_conv, 4, (64, 128)),
    ]
    imgs = np.random.default_rng(1).integers(0, 256, size=(4, 64, 128, 3), dtype=np.uint8)
    for model, module, per_forward, hw in cases:
        path = str(tmp_path / "program.pt2")
        export_model(model, 4, *hw, path, dtype=np.uint8, device=cuda)
        fn = load_exported(path)
        before = module.launches.value
        got = fn(imgs)
        torch.cuda.synchronize()
        assert module.launches.value == before + per_forward
        want = Predictor(model, 4, *hw, dtype=np.uint8, device=cuda)(imgs)
        np.testing.assert_array_equal(got["segm"], want["segm"])
        assert np.all(np.abs(got["depth"] - want["depth"]) <= np.abs(want["depth"]) * 2**-7 + 1e-6)

    def plain(*args):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(fused_gate, "fused_attention_gate_plain", plain)
    bad = _gate_args(cuda, torch.float32, 1, 4, 4, 3, 6, 4)  # hidden 6
    before = fused_gate.launches.value
    with pytest.raises(ValueError, match="multiples of 4"):
        torch.ops.vmtl.fused_attention_gate(*bad)
    assert fused_gate.launches.value == before


def test_predictor_snapshot_on_cuda(cuda):
    """A ``Predictor`` of a bf16 MTAN at Cityscapes' width answers bit for
    bit the same after two train steps on its module, which stays in train
    mode; a new ``Predictor`` on the trained module answers otherwise."""
    from vision_mtl_tpu_torch.metrics import init_metrics
    from vision_mtl_tpu_torch.serving import Predictor
    from vision_mtl_tpu_torch.train.state import create_train_state
    from vision_mtl_tpu_torch.train.step import make_train_step

    cfg = fetch_data_cfg("cityscapes")
    hw = (64, 128)
    model = build_model("mtan", cfg, dtype=torch.bfloat16, device=cuda, seed=0)
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, size=(2, *hw, 3), dtype=np.uint8)
    pred = Predictor(model, 2, *hw, dtype=np.uint8, device=cuda)
    before = pred(imgs)
    state = create_train_state(model, 1e-2, device=cuda)
    step = make_train_step(device=cuda)
    mstate = init_metrics(cfg.num_classes, cuda)
    for _ in range(2):
        batch = {"img": torch.from_numpy(rng.integers(0, 256, size=(2, *hw, 3), dtype=np.uint8)),
                 "mask": torch.from_numpy(rng.integers(0, cfg.num_classes, size=(2, *hw))),
                 "depth": torch.from_numpy(rng.uniform(size=(2, *hw, 1)).astype(np.float32))}
        state, mstate, _ = step(state, batch, mstate)
    after = pred(imgs)
    assert model.training
    for k in ("segm", "depth"):
        np.testing.assert_array_equal(after[k], before[k])
    fresh = Predictor(model.eval(), 2, *hw, dtype=np.uint8, device=cuda)(imgs)
    assert not np.array_equal(fresh["depth"], before["depth"])


def test_get_segm_preds_on_cuda(cuda):
    """``get_segm_preds`` on CUDA tensors at MTAN's output shape against the
    same call on the CPU: probabilities to 1e-6, ids exact."""
    from vision_mtl_tpu_torch.utils.inference import get_segm_preds

    g = torch.Generator().manual_seed(0)
    logits = torch.randn(8, 128, 256, 19, generator=g).bfloat16()
    valid = torch.rand(8, 128, 256, generator=g) > 0.2
    probs, preds = get_segm_preds(valid.to(cuda), logits.to(cuda))
    want_probs, want_preds = get_segm_preds(valid, logits)
    assert probs.device.type == "cuda" and preds.dtype == torch.int32
    assert (probs.cpu() - want_probs).abs().max().item() <= 1e-6
    assert torch.equal(preds.cpu(), want_preds)
