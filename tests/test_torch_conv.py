"""The port's stem grad-W (scalable_agent_tpu_torch/ops/conv_cuda.py) held
against the JAX package's Pallas kernel (ops/conv_pallas.py) in interpret
mode, on the geometries of tests/test_conv_pallas.py.

On the CPU the port's wrapper runs its plain version; chip_smoke.py holds
the CUDA kernel to that plain version on the card.

Tolerances: float32 sums of at most 3*12*16 = 576 rows in another order;
rtol/atol 2e-5 is what tests/test_conv_pallas.py holds the Pallas kernel
to against XLA's own derivative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu.ops import conv_pallas
from scalable_agent_tpu_torch.ops import conv_cuda

TOL = dict(rtol=2e-5, atol=2e-5)

# (h, w, k, s), as tests/test_conv_pallas.py's GEOMETRIES: the stem aspect
# at reduced size, odd extents (asymmetric SAME padding on both axes), a
# smaller stem, stride == kernel, and the 1x1 case.
GEOMETRIES = (
    (24, 32, 8, 4),
    (17, 23, 8, 4),
    (9, 11, 4, 2),
    (8, 8, 2, 2),
    (5, 5, 1, 1),
)


def _case(seed, n, h, w, c, f, s):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    g = rng.standard_normal((n, -(-h // s), -(-w // s), f)).astype(np.float32)
    return x, g


def _lax_conv(x, w, s):
    return jax.lax.conv_general_dilated(
        x, w, (s, s), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))


@pytest.mark.parametrize("h,w,k,s", GEOMETRIES)
def test_gradw_matches_pallas(h, w, k, s):
    x, g = _case(k * 100 + s, 3, h, w, 3, 8, s)
    want = conv_pallas.conv_gradw(jnp.asarray(x), jnp.asarray(g), k, s,
                                  interpret=True)
    got = conv_cuda.conv_gradw(torch.tensor(x), torch.tensor(g), k, s)
    assert got.dtype == torch.float32 and got.shape == (k, k, 3, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gradw_takes_strided_views():
    """The stem's backward passes NCHW tensors permuted to NHWC views; the
    result must not depend on the memory layout."""
    x, g = _case(1, 2, 24, 32, 3, 8, 4)
    dense = conv_cuda.conv_gradw(torch.tensor(x), torch.tensor(g), 8, 4)
    x_view = torch.tensor(x).permute(0, 3, 1, 2).contiguous().permute(
        0, 2, 3, 1)
    g_view = torch.tensor(g).permute(0, 3, 1, 2).contiguous().permute(
        0, 2, 3, 1)
    assert not x_view.is_contiguous()
    strided = conv_cuda.conv_gradw(x_view, g_view, 8, 4)
    np.testing.assert_array_equal(strided.numpy(), dense.numpy())


def test_k_not_multiple_of_stride_takes_library_gradient():
    """K % S != 0: like conv_pallas.py, the library's own weight gradient
    (here torch's), held to the Pallas module's fallback (XLA's)."""
    x, g = _case(11, 3, 10, 13, 3, 8, 2)
    want = conv_pallas.conv_gradw(jnp.asarray(x), jnp.asarray(g), 3, 2,
                                  interpret=True)
    got = conv_cuda.conv_gradw(torch.tensor(x), torch.tensor(g), 3, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("h,w", [(16, 16), (17, 23)])
def test_stem_conv_value_and_grads_match_pallas(h, w):
    """stem_conv's forward and autograd gradients (input and weight)
    against the Pallas stem_conv's custom VJP, through layout changes
    NHWC/HWIO <-> NCHW/OIHW."""
    x, _ = _case(19, 2, h, w, 3, 8, 4)
    rng = np.random.default_rng(5)
    k_hwio = (rng.standard_normal((8, 8, 3, 8)) * 0.05).astype(np.float32)

    def loss_j(xx, ww):
        return jnp.sum(conv_pallas.stem_conv(xx, ww, 4, True, "float32")
                       ** 2)

    val_j, (dx_j, dw_j) = jax.value_and_grad(loss_j, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(k_hwio))
    xt = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_(True)
    wt = torch.tensor(k_hwio).permute(3, 2, 0, 1).requires_grad_(True)
    val = torch.sum(conv_cuda.stem_conv(xt, wt, 4) ** 2)
    dx, dw = torch.autograd.grad(val, [xt, wt])
    np.testing.assert_allclose(float(val.detach()), float(val_j), rtol=1e-5)
    np.testing.assert_allclose(dx.permute(0, 2, 3, 1).numpy(),
                               np.asarray(dx_j), **TOL)
    np.testing.assert_allclose(dw.permute(2, 3, 1, 0).numpy(),
                               np.asarray(dw_j), **TOL)


@pytest.mark.parametrize("h,w,k,s", [(9, 12, 3, 2), (18, 24, 4, 2),
                                     (72, 96, 8, 4), (7, 10, 3, 2)])
def test_conv2d_same_pads_like_xla(h, w, k, s):
    """XLA's SAME padding (lo gets the smaller half) — asymmetric on the
    torso's 9x12 map for conv_2 — against lax's SAME conv."""
    x, _ = _case(23, 2, h, w, 4, 5, s)
    rng = np.random.default_rng(k)
    w_hwio = rng.standard_normal((k, k, 4, 5)).astype(np.float32)
    want = _lax_conv(jnp.asarray(x), jnp.asarray(w_hwio), s)
    got = conv_cuda.conv2d_same(torch.tensor(x).permute(0, 3, 1, 2),
                                torch.tensor(w_hwio).permute(3, 2, 0, 1), s)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-4)
