"""The port's stem grad-W (scalable_agent_tpu_torch/ops/conv_cuda.py) held
against the JAX package's Pallas kernel (ops/conv_pallas.py) in interpret
mode, on the geometries of tests/test_conv_pallas.py.

On the CPU the port's wrapper runs its plain version; chip_smoke.py holds
the CUDA kernel to that plain version on the card.  The wrapper's pure
Python -- the layout read from the strides and the plan that cuts the
images into bands and hands them to blocks -- is tested here.

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
from scalable_agent_tpu_torch.ops import _build, conv_cuda

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


def _layouts(x, g):
    """The two layouts the stem's backward can hand over, for x and g
    together: contiguous NHWC, and an NHWC view of contiguous NCHW (the
    channels-last frame seen as NCHW, permuted back)."""
    planar = lambda t: t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    return {"hwc": (x, g), "chw": (planar(x), planar(g))}


@pytest.mark.parametrize("layout", ["hwc", "chw"])
def test_stem_geometry_matches_pallas(layout):
    """The main path's geometry (72x96x3 frames, 8x8/4 into 32 features)
    at N=2, in both input layouts.  Each dW entry sums 864 products of
    standard normals in another order than XLA's, and |dW| reaches ~60, so
    the absolute tolerance is taken relative to max |dW| (as chip_smoke.py
    takes GRADW_TOL): 2e-6 of it, ~20x float32 epsilon."""
    x, g = _case(31, 2, 72, 96, 3, 32, 4)
    want = conv_pallas.conv_gradw(jnp.asarray(x), jnp.asarray(g), 8, 4,
                                  interpret=True)
    xt, gt = _layouts(torch.tensor(x), torch.tensor(g))[layout]
    assert conv_cuda.tensor_layout(xt) == layout
    assert conv_cuda.tensor_layout(gt) == layout
    got = conv_cuda.conv_gradw(xt, gt, 8, 4)
    assert got.shape == (8, 8, 3, 32)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                               atol=2e-6 * np.abs(want).max())


def test_tensor_layout_reads_the_strides():
    x = torch.zeros(2, 9, 11, 3)
    assert conv_cuda.tensor_layout(x) == "hwc"
    assert conv_cuda.tensor_layout(
        torch.zeros(2, 3, 9, 11).permute(0, 2, 3, 1)) == "chw"
    # The torso's own frame: NHWC memory seen as NCHW, permuted back.
    assert conv_cuda.tensor_layout(x.permute(0, 3, 1, 2).permute(
        0, 2, 3, 1)) == "hwc"
    for other in (torch.zeros(2, 9, 22, 3)[:, :, ::2],
                  torch.zeros(2, 11, 9, 3).transpose(1, 2),
                  torch.zeros(2, 9, 11, 6)[..., :3],
                  torch.zeros(4, 9, 11, 3)[::2]):
        with pytest.raises(ValueError, match="contiguous NHWC"):
            conv_cuda.tensor_layout(other)


@pytest.mark.parametrize("which", ["x", "g"])
def test_other_strides_raise_on_the_kernel_route(monkeypatch, which):
    """A tensor in neither layout is refused before anything launches (no
    silent copy of a 268 MB frame batch)."""
    monkeypatch.setattr(_build, "on_cpu", lambda *_: False)
    x, g = (torch.tensor(a) for a in _case(3, 2, 16, 16, 3, 32, 4))
    if which == "x":
        x = torch.zeros(2, 16, 32, 3)[:, :, ::2]
    else:
        g = torch.zeros(2, 4, 4, 64)[..., ::2]
    with pytest.raises(ValueError, match="contiguous NHWC"):
        conv_cuda.conv_gradw(x, g, 8, 4)


def test_other_geometries_raise_on_the_kernel_route(monkeypatch):
    monkeypatch.setattr(_build, "on_cpu", lambda *_: False)
    x, g = (torch.tensor(a) for a in _case(4, 2, 16, 16, 1, 32, 4))
    with pytest.raises(ValueError, match="built for the stems'"):
        conv_cuda.conv_gradw(x, g, 8, 4)


# -- the ResNet stem: 3x3, stride 1, 3 channels into 16 features -------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w", [(3, 16, 16), (2, 17, 23), (1, 72, 96)])
def test_resnet_stem_gradw_plain_matches_pallas(n, h, w, dtype):
    """conv_gradw at (K, S, C, F) = (3, 1, 3, 16) -- on the CPU its plain
    version, the ResNet kernel's -- against the Pallas kernel in interpret
    mode, float32 and with bf16 x and g (matmul_dtype="bfloat16": exact
    products summed in float32).  Each dW entry sums n*h*w products of
    standard normals in another order, so the tolerance is taken relative
    to max |dW|: 2e-6 of it."""
    x, g = _case(h * w + n, n, h, w, 3, 16, 1)
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(conv_pallas.conv_gradw(
        jnp.asarray(x, jdtype), jnp.asarray(g, jdtype), 3, 1,
        interpret=True, matmul_dtype=dtype))
    tdtype = getattr(torch, dtype)
    got = conv_cuda.conv_gradw(torch.tensor(x).to(tdtype),
                               torch.tensor(g).to(tdtype), 3, 1)
    assert got.dtype == torch.float32 and got.shape == (3, 3, 3, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                               atol=2e-6 * np.abs(want).max())


RESNET_PLAN_CASES = [
    # (N, frame H, W, item size, SMs): the main path at float32 and bf16,
    # an uneven split, an odd frame, one image, few SMs.
    (3232, 72, 96, 4, 132),
    (3232, 72, 96, 2, 132),
    (3233, 72, 96, 4, 132),
    (64, 17, 23, 2, 132),
    (1, 72, 96, 4, 132),
    (5, 16, 16, 4, 7),
]


@pytest.mark.parametrize("n,h,w,item,sms", RESNET_PLAN_CASES)
def test_resnet_gradw_plan_fits_and_splits_in_order(n, h, w, item, sms):
    plan = conv_cuda.resnet_gradw_plan(n, h, w, item, sms)
    rows = conv_cuda.RESNET_ROWS
    assert plan.bands == -(-h // rows) and plan.units == n * plan.bands
    assert plan.blocks == min(plan.units, sms)
    units = [list(conv_cuda.block_units(plan, b))
             for b in range(plan.blocks)]
    assert all(units) and max(map(len, units)) - min(map(len, units)) <= 1
    assert [u for block in units for u in block] == list(range(plan.units))
    # Rows hold the band with its pads, 16-byte aligned, on the banks the
    # kernel's reads need (a warp reads 8 rows: x rows 16 bytes apart mod
    # 128; g rows 64 bytes apart at float32, 32 at bf16).
    per16 = 16 // item
    assert plan.xrs >= per16 + 3 * (w + 1) and plan.grs >= 16 * w
    assert (plan.xrs * item) % 128 == 16
    assert (plan.grs * item) % 128 == (64 if item == 4 else 32)
    assert plan.x_elems == (rows + 2) * plan.xrs
    assert plan.stage_elems == plan.x_elems + rows * plan.grs
    assert (plan.stage_elems * item) % 16 == 0
    assert 2 * plan.stage_elems * item <= plan.smem_bytes
    assert plan.smem_bytes >= 4 * conv_cuda.RESNET_WARPS * 27 * 16
    assert plan.smem_bytes <= conv_cuda.SMEM_LIMIT


def test_resnet_gradw_plan_of_the_main_path():
    """72x96 frames: 9 bands of 8 rows per image, 29,088 units over 132
    blocks; a float32 stage of 10 x rows and 8 g rows, two in 125 KB."""
    plan = conv_cuda.resnet_gradw_plan(3232, 72, 96, 4, 132)
    assert (plan.bands, plan.units, plan.blocks) == (9, 29088, 132)
    assert (plan.xrs, plan.grs) == (324, 1552)
    assert plan.smem_bytes == 2 * 4 * (10 * 324 + 8 * 1552)


def test_resnet_gradw_plan_refuses_a_frame_too_wide():
    with pytest.raises(ValueError, match="does not fit"):
        conv_cuda.resnet_gradw_plan(8, 16, 400, 4, 132)


class _Recorder:
    """A stand-in kernel library recording each launch's entry point and
    arguments; every launch succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("sat_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("dtype,suffix", [(torch.float32, ""),
                                          (torch.bfloat16, "_bf16")])
@pytest.mark.parametrize("layout", ["hwc", "chw"])
def test_resnet_geometry_takes_its_kernel_on_the_card(monkeypatch, dtype,
                                                      suffix, layout):
    """On the kernel route (x and g on the card, here a stand-in library)
    (3, 1, 3, 16) launches the ResNet stem kernel of the operand type with
    its plan and counts it there, and never the plain version."""
    library = _Recorder()
    monkeypatch.setattr(_build, "on_cpu", lambda *_: False)
    monkeypatch.setattr(_build, "library", lambda: library)
    monkeypatch.setattr(conv_cuda, "_sm_count", lambda index: 132)
    monkeypatch.setattr(conv_cuda.torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 7})())
    monkeypatch.setattr(conv_cuda, "conv_gradw_plain", lambda *a: pytest.fail(
        "the kernel route ran the plain version"))
    x, g = (torch.tensor(a).to(dtype) for a in _case(6, 2, 17, 23, 3, 16, 1))
    x, g = _layouts(x, g)[layout]
    before = dict(conv_cuda.LAUNCHES)
    conv_cuda.conv_gradw(x, g, 3, 1)
    (name, args), = library.calls
    assert name == "sat_resnet_stem_gradw" + suffix
    plan = conv_cuda.resnet_gradw_plan(2, 17, 23, x.element_size(), 132)
    assert args[4:] == (17, 23, plan.bands, plan.xrs, plan.grs,
                        plan.x_elems, plan.stage_elems, plan.smem_bytes,
                        int(layout == "chw"), int(layout == "chw"),
                        plan.units, plan.blocks, 7)
    grown = {k: v - before[k] for k, v in conv_cuda.LAUNCHES.items()
             if v != before[k]}
    assert grown == {"resnet_stem_gradw" + suffix: 1}


PLAN_CASES = [
    # (N, frame H, W, x CHW, g CHW, SMs): the main path, image counts that
    # split unevenly or not at all, odd frames, both layouts, tiny frames.
    (3232, 72, 96, False, False, 132),
    (3233, 72, 96, True, True, 132),
    (1, 72, 96, False, True, 132),
    (64, 17, 23, True, False, 132),
    (16 * 17, 16, 16, False, False, 132),
    (5, 72, 96, False, False, 7),
]


@pytest.mark.parametrize("n,h,w,x_chw,g_chw,sms", PLAN_CASES)
def test_gradw_plan_takes_every_image_band_once_in_order(n, h, w, x_chw,
                                                         g_chw, sms):
    out_h, _ = conv_cuda.same_pads(h, 8, 4)
    out_w, _ = conv_cuda.same_pads(w, 8, 4)
    plan = conv_cuda.gradw_plan(n, out_h, out_w, x_chw, g_chw, sms)
    assert plan.units == n * plan.bands
    assert plan.blocks == min(plan.units, sms)
    # Equal bands that cover the output rows.
    assert plan.bands * plan.band_rows >= out_h
    assert (plan.bands - 1) * plan.band_rows < out_h
    units = [list(conv_cuda.block_units(plan, b))
             for b in range(plan.blocks)]
    assert all(units), "a block with no work"
    assert max(map(len, units)) - min(map(len, units)) <= 1
    assert [u for block in units for u in block] == list(range(plan.units))
    images = [u // plan.bands for block in units for u in block]
    assert images == sorted(images)
    assert sorted(set(images)) == list(range(n))
    # Two stages fit the budget; the final sum of the other five row
    # groups' [192, 32] tiles fits the allocation; alignment and bank
    # padding of the stage.
    assert 8 * plan.stage_floats <= conv_cuda.SMEM_BUDGET
    assert plan.smem_bytes >= 4 * 5 * 192 * 32
    assert plan.smem_bytes <= 227 * 1024
    assert plan.xrs % 32 == 8 and plan.gps % 2 == 1
    assert plan.x_floats % 4 == 0 and plan.stage_floats % 4 == 0


def test_gradw_plan_of_the_main_path():
    """72x96 frames: two bands of 9 output rows (each 40 input rows with
    the halo), 6464 units over 132 blocks of 48 or 49."""
    plan = conv_cuda.gradw_plan(3232, 18, 24, False, False, 132)
    assert (plan.band_rows, plan.bands, plan.units, plan.blocks) == (
        9, 2, 6464, 132)
    assert plan.xrs == 328  # 100 padded columns x 3 channels, to 8 mod 32
