"""The gate kernels' 3xTF32 arithmetic, emulated on the CPU.

The CUDA kernels of ``fused_attention_gate_train`` and
``fused_attention_gate`` take their products on the tensor cores as 3xTF32.
``fused_attention_gate_train_tf32`` and ``fused_attention_gate_tf32``
emulate that arithmetic with PyTorch ops (TF32 rounding by masking mantissa
bits). At MTAN's dec0 and dec3 widths the emulations stay within
``chip_smoke.py``'s limits for the kernels against their plain versions
(output max |diff| <= 1e-4; the train gate's statistics within 1e-5
relative + 1e-6), and a single TF32 product falls outside them: the split is
what the limits need. The train gate's backward kernel takes its six
products the same way (``fused_attention_gate_train_backward_tf32``): at
MTAN's eight gate shapes its ten gradients stay at f32's limit of the f64
gradient, and a single TF32 product does not.
"""

import numpy as np
import pytest
import torch

from vision_mtl_tpu_torch.kernels import fused_gate, fused_gate_train

HIDDEN = 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _args(cin, c2, n, seed):
    rng = np.random.default_rng(seed)

    def uniform(*shape, bound=1.0):
        return torch.from_numpy(rng.uniform(-bound, bound, size=shape).astype(np.float32))

    return (
        torch.from_numpy(rng.standard_normal((1, n // 16, 16, cin)).astype(np.float32)),
        torch.from_numpy(rng.standard_normal((1, n // 16, 16, c2)).astype(np.float32)),
        uniform(cin, HIDDEN, bound=cin**-0.5), uniform(HIDDEN, bound=cin**-0.5),
        uniform(HIDDEN) * 0.5 + 1.0, uniform(HIDDEN, bound=0.3),
        uniform(HIDDEN, c2, bound=HIDDEN**-0.5), uniform(c2, bound=HIDDEN**-0.5),
        uniform(c2) * 0.5 + 1.0, uniform(c2, bound=0.3),
    )


def _within_smoke_limits(got, want) -> bool:
    out_ok = float((got[0] - want[0]).abs().max()) <= 1e-4
    stats_ok = all(bool(((g - w).abs() <= 1e-5 * w.abs() + 1e-6).all())
                   for g, w in zip(got[1:], want[1:]))
    return out_ok and stats_ok


def test_tf32_round_is_round_to_nearest_ties_away():
    one = 1.0
    v = torch.tensor([one + 2**-12, one + 2**-11, one + 3 * 2**-12, -(one + 2**-11), 3.0,
                      one + 2**-10 + 2**-11])
    want = torch.tensor([one, one + 2**-10, one + 2**-10, -(one + 2**-10), 3.0,
                         one + 2 * 2**-10])
    assert torch.equal(fused_gate.tf32_round(v), want)


@pytest.mark.parametrize("level,cin,c2", [("dec0", 640, 256), ("dec3", 192, 32)])
def test_three_tf32_products_meet_the_f32_limits_and_one_does_not(level, cin, c2):
    args = _args(cin, c2, n=512, seed=cin)
    want = fused_gate_train.fused_attention_gate_train_plain(*args)
    split = fused_gate_train.fused_attention_gate_train_tf32(*args)
    single = fused_gate_train.fused_attention_gate_train_tf32(*args, split=False)
    assert _within_smoke_limits(split, want), level
    assert not _within_smoke_limits(single, want), level
    # the bf16 path: x and shared in bf16, exact in TF32
    args16 = (args[0].bfloat16(), args[1].bfloat16(), *args[2:])
    want16 = fused_gate_train.fused_attention_gate_train_plain(*args16)
    got16 = fused_gate_train.fused_attention_gate_train_tf32(*args16)
    diff = (got16[0].float() - want16[0].float()).abs()
    assert bool((diff <= want16[0].float().abs() * 2**-7 + 1e-6).all())


@pytest.mark.parametrize("level,cin,c2", [("dec0", 640, 256), ("dec3", 192, 32)])
def test_eval_gate_three_tf32_products_meet_the_f32_limit_and_one_does_not(level, cin, c2):
    """The eval gate at ``chip_smoke.py``'s inputs (folded weights as its
    ``check_gate`` draws them), n = 512."""
    n = 512
    rng = np.random.default_rng(cin + 1)

    def array(values):
        return torch.from_numpy(values.astype(np.float32))

    args = (
        array(rng.standard_normal((1, n // 16, 16, cin))),
        array(rng.standard_normal((1, n // 16, 16, c2))),
        array(rng.uniform(-1, 1, size=(cin, HIDDEN))) / cin**0.5,
        array(rng.standard_normal(HIDDEN)) * 0.1,
        array(rng.uniform(-1, 1, size=(HIDDEN, c2))) / HIDDEN**0.5,
        array(rng.standard_normal(c2)) * 0.1,
    )
    want = fused_gate.fused_attention_gate_plain(*args)
    split = fused_gate.fused_attention_gate_tf32(*args)
    single = fused_gate.fused_attention_gate_tf32(*args, split=False)
    assert float((split - want).abs().max()) <= 1e-4, level
    assert float((single - want).abs().max()) > 1e-4, level
    # the bf16 path: x and shared in bf16, x exact in TF32
    args16 = (args[0].bfloat16(), args[1].bfloat16(), *args[2:])
    want16 = fused_gate.fused_attention_gate_plain(*args16).float()
    diff = (fused_gate.fused_attention_gate_tf32(*args16).float() - want16).abs()
    assert bool((diff <= want16.abs() * 2**-7 + 1e-6).all())


GATE_WIDTHS = [("enc0", 3, 32), ("enc1", 64, 64), ("enc2", 128, 128), ("enc3", 256, 256),
               ("dec0", 640, 256), ("dec1", 384, 128), ("dec2", 256, 64), ("dec3", 192, 32)]


def _worst_relative(got, want):
    """The largest |got - want| over the largest |want|, worst of the
    gradients; b1 and b2 (0 up to rounding, a batch-statistic BN follows
    them) left out."""
    return max(float((g.double().reshape(w.shape) - w).abs().max()) / float(w.abs().max())
               for i, (g, w) in enumerate(zip(got, want)) if i not in (3, 7))


@pytest.mark.parametrize("level,cin,c2", GATE_WIDTHS)
def test_backward_three_tf32_products_meet_f32s_limit_and_one_does_not(level, cin, c2):
    """The backward kernel's arithmetic at an MTAN gate's widths, n = 512,
    against the f64 gradient on the same statistics: within 1e-5 of each
    gradient's largest element (the plain backward in f32 reads under 8e-7
    at these shapes), which a single TF32 product misses by far (4e-2 and
    more: the BatchNorms' gradients subtract nearly equal sums)."""
    args = _args(cin, c2, n=512, seed=cin)
    out, *stats = fused_gate_train.fused_attention_gate_train_plain(*args)
    dout = torch.from_numpy(
        np.random.default_rng(cin + 7).standard_normal(out.shape).astype(np.float32))
    want = fused_gate_train._gate_backward(
        1e-5, dout.double(), *(a.double() for a in args), *(s.double() for s in stats))
    split = fused_gate_train.fused_attention_gate_train_backward_tf32(1e-5, dout, *args, *stats)
    single = fused_gate_train.fused_attention_gate_train_backward_tf32(
        1e-5, dout, *args, *stats, split=False)
    assert _worst_relative(split, want) <= 1e-5, level
    assert _worst_relative(single, want) > 1e-3, level
    top = max(float(w.abs().max()) for w in want)
    assert all(float(split[i].abs().max()) <= 1e-4 * top for i in (3, 7)), level
    # the bf16 path: x, shared and dout in bf16, x exact in TF32
    args16 = (args[0].bfloat16(), args[1].bfloat16(), *args[2:])
    dout16 = dout.bfloat16()
    want16 = fused_gate_train._gate_backward(
        1e-5, dout16.double(), *(a.double() for a in args16), *(s.double() for s in stats))
    got16 = fused_gate_train.fused_attention_gate_train_backward_tf32(
        1e-5, dout16, *args16, *stats)
    assert _worst_relative(got16, want16) <= 1e-5, level
