"""The port's ``conv3x3_small`` (kernel B3's plain version on the CPU, and its
autograd Function) against the JAX package's Pallas kernel in interpret mode
and its XLA path: values, and dx, dw, db through ``jax.grad``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vision_mtl_tpu.ops.pallas import small_conv as jax_small_conv
from vision_mtl_tpu_torch.kernels import small_conv as kernel_b3
from vision_mtl_tpu_torch.ops.small_conv import conv3x3_small


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(rng, b, h, w, c, o, bias=True):
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    k = rng.uniform(-1, 1, size=(3, 3, c, o)).astype(np.float32) / np.sqrt(9 * c)
    bv = rng.uniform(-0.5, 0.5, size=(o,)).astype(np.float32) if bias else None
    return x, k, bv


def _t(a):
    return None if a is None else torch.from_numpy(a)


# (C, O): O > C, O < C, and the dx shape of the merged head (20 -> 33)
SHAPES = [(5, 7), (7, 3), (20, 33)]


@pytest.mark.parametrize("c,o", SHAPES)
@pytest.mark.parametrize("bias", [True, False])
def test_forward_matches_pallas_and_xla(rng, c, o, bias):
    """f32, H a multiple of 16 (the Pallas kernel's tile): within 1e-5 of
    both JAX implementations (sums of up to 297 f32 products of magnitude
    ~0.1, taken in other orders)."""
    x, k, bv = _inputs(rng, 2, 16, 12, c, o, bias)
    jb = jnp.zeros((o,), jnp.float32) if bv is None else jnp.asarray(bv)
    pallas = jax_small_conv._conv3x3_pallas(jnp.asarray(x), jnp.asarray(k), jb, interpret=True)
    xla = jax_small_conv.conv3x3_small(jnp.asarray(x), jnp.asarray(k), jb)
    got = conv3x3_small(_t(x), _t(k), _t(bv))
    assert got.shape == (2, 16, 12, o) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hw", [(13, 11), (1, 1), (3, 40)])
def test_ragged_shapes_match_xla(rng, hw):
    """Heights the Pallas kernel's tiling refuses: the function has no such
    limit, held against the XLA path."""
    x, k, bv = _inputs(rng, 1, *hw, 6, 9)
    want = jax_small_conv.conv3x3_small(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bv))
    got = conv3x3_small(_t(x), _t(k), _t(bv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("c,o", SHAPES)
def test_gradients_match_jax(rng, c, o):
    """dx, dw and db of sum(out * cot) against ``jax.grad`` through the JAX
    custom VJP, f32, within 1e-5 relative to each gradient's scale."""
    x, k, bv = _inputs(rng, 2, 16, 12, c, o)
    cot = rng.normal(size=(2, 16, 12, o)).astype(np.float32)

    def jloss(x, k, b):
        return jnp.sum(jax_small_conv.conv3x3_small(x, k, b) * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bv))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, k, bv)]
    (conv3x3_small(*leaves) * torch.from_numpy(cot)).sum().backward()
    for name, leaf, w in zip(("dx", "dw", "db"), leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            leaf.grad.numpy(), w, atol=1e-5 * float(np.abs(w).max()), err_msg=name
        )


def test_dx_is_the_kernel_on_flipped_weights(rng):
    """The port's dx equals the Pallas kernel applied to the output gradient
    with the flipped, transposed weights and no bias (what ``_bwd`` does on a
    TPU)."""
    x, k, bv = _inputs(rng, 2, 16, 8, 9, 4)
    g = rng.normal(size=(2, 16, 8, 4)).astype(np.float32)
    k_t = np.ascontiguousarray(np.transpose(k[::-1, ::-1], (0, 1, 3, 2)))
    want = jax_small_conv._conv3x3_pallas(
        jnp.asarray(g), jnp.asarray(k_t), jnp.zeros((9,), jnp.float32), interpret=True
    )
    xt = torch.from_numpy(x).requires_grad_()
    conv3x3_small(xt, _t(k), _t(bv)).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_bf16_keeps_the_f32_bias_of_the_pallas_kernel(rng):
    """In bf16 the Pallas kernel adds the f32 bias to the f32 sum and rounds
    once; the XLA path rounds the sum, then adds a bf16 bias and rounds
    again. The port follows the Pallas kernel: within one bf16 rounding step
    of it everywhere (the sums run in other orders), and nearer to it than
    the XLA path is."""
    x, k, bv = _inputs(rng, 2, 16, 16, 33, 20)
    bv = bv * 8.0  # a bias large enough for the second rounding to show
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    pallas = np.asarray(
        jax_small_conv._conv3x3_pallas(xb, jnp.asarray(k), jnp.asarray(bv), interpret=True)
    ).astype(np.float32)
    xla = np.asarray(
        jax_small_conv.conv3x3_small(xb, jnp.asarray(k), jnp.asarray(bv))
    ).astype(np.float32)
    got = conv3x3_small(torch.from_numpy(x).to(torch.bfloat16), _t(k), _t(bv))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.all(np.abs(got - pallas) <= np.abs(pallas) * 2**-7 + 1e-6)
    assert np.mean(got != pallas) < np.mean(xla != pallas)


def test_gradcheck_f64():
    """The Function's backward against finite differences, in f64."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 5, 4, 3, generator=g, dtype=torch.float64, requires_grad=True)
    k = torch.randn(3, 3, 3, 2, generator=g, dtype=torch.float64, requires_grad=True)
    b = torch.randn(2, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(conv3x3_small, (x, k, b))


def test_fits():
    assert kernel_b3.fits(99, 99) and kernel_b3.fits(1, 20)
    assert not kernel_b3.fits(100, 33) and not kernel_b3.fits(33, 100)
