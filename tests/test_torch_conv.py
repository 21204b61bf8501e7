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
    """A geometry no ported path reaches (two-channel frames through the
    shallow stem, in either operand type) raises on the kernel route."""
    monkeypatch.setattr(_build, "on_cpu", lambda *_: False)
    for dtype in (torch.float32, torch.bfloat16):
        x, g = (torch.tensor(a).to(dtype)
                for a in _case(4, 2, 16, 16, 2, 32, 4))
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


def _bank_wavefronts(addresses):
    """Shared-memory wavefronts of one warp-wide access: the most distinct
    4-byte words that fall on one of the 32 banks (byte addresses)."""
    banks = {}
    for word in {a // 4 for a in addresses}:
        banks.setdefault(word % 32, set()).add(word)
    return max(map(len, banks.values()))


@pytest.mark.parametrize("n,h,w,item,sms", RESNET_PLAN_CASES)
def test_resnet_gradw_plan_fits_and_splits_in_order(n, h, w, item, sms):
    rows = conv_cuda.RESNET_ROWS
    # float32 stages one layout whatever the tensors'; bf16 each its own.
    layouts = [(False, False)] if item == 4 else [
        (False, False), (True, True), (True, False), (False, True)]
    for x_chw, g_chw in layouts:
        plan = conv_cuda.resnet_gradw_plan(n, h, w, item, sms, x_chw, g_chw)
        per_sm = 1 if item == 4 else conv_cuda.RESNET_BLOCKS_PER_SM
        assert plan.bands == -(-h // rows) and plan.units == n * plan.bands
        assert plan.blocks == min(plan.units, per_sm * sms)
        units = [list(conv_cuda.block_units(plan, b))
                 for b in range(plan.blocks)]
        assert all(units) and max(map(len, units)) - min(map(len, units)) <= 1
        assert [u for block in units for u in block] == list(
            range(plan.units))
        # Every row of a stage 16-byte aligned; the stages and the warps'
        # final sums fit.
        for stride in (plan.xrs, plan.grs, plan.x_elems, plan.stage_elems,
                       plan.xplane):
            assert (stride * item) % 16 == 0
        assert plan.stages * plan.stage_elems * item <= plan.smem_bytes
        assert plan.smem_bytes >= 4 * conv_cuda.RESNET_WARPS * 27 * 16
        assert plan.smem_bytes <= conv_cuda.SMEM_LIMIT
        if item == 4:
            # The FFMA body's reads: a warp reads 8 rows, x rows 16 bytes
            # apart mod 128, g rows 64 bytes apart.
            assert plan.stages == 2
            assert plan.xrs >= 4 + 3 * (w + 1) and plan.grs >= 16 * w
            assert plan.x_elems == (rows + 2) * plan.xrs
            assert plan.stage_elems == plan.x_elems + rows * plan.grs
            assert (plan.xrs * item) % 128 == 16
            assert (plan.grs * item) % 128 == 64
            continue
        # bf16: a ring of at least 3 stages, the SM's blocks' within the
        # budget; output rows
        # padded with zeros to 16 pixels (the wp - w pad pixels and the x
        # columns past the right pad are never written); the data of an x
        # row (padded column 1) 16-byte aligned.
        assert plan.stages == conv_cuda.RESNET_STAGES >= 3
        assert (per_sm * plan.stages * plan.stage_elems * item
                <= conv_cuda.SMEM_BUDGET)
        assert plan.wp % 16 == 0 and w <= plan.wp < w + 16
        xo, px = conv_cuda._resnet_xo(x_chw, 3), (1 if x_chw else 3)
        assert ((xo + px) * item) % 16 == 0
        assert plan.xrs >= xo + px * (plan.wp + 2)
        if x_chw:
            assert plan.xplane >= (rows + 2) * plan.xrs
            assert plan.x_elems == 3 * plan.xplane
        else:
            assert plan.x_elems == (rows + 2) * plan.xrs
        g_plane = 16 * plan.grs if g_chw else rows * plan.grs
        assert plan.grs >= (rows * plan.wp if g_chw else 16 * plan.wp)
        assert plan.stage_elems == plan.x_elems + g_plane
        # The 8 rows of each 8x8 ldmatrix of g fall on distinct banks, and
        # the patch loads take at most 2 wavefronts (1 for planar x).
        for mat in range(4):
            rows_at = [2 * _a_row(plan, g_chw, 8 * mat + r)
                       for r in range(8)]
            assert len({(a // 16) % 8 for a in rows_at}) == 8
        worst = max(_bank_wavefronts([2 * (base + a) for a in lane_elems])
                    for base in range(0, 64, 8)
                    for lane_elems in _b_loads(plan, x_chw))
        assert worst == (1 if x_chw else 2)


def test_resnet_gradw_plan_of_the_main_path():
    """72x96 frames: 9 bands of 8 rows per image, 29,088 units; float32:
    over 132 blocks, a stage of 10 x rows and 8 g rows, two in 125 KB;
    bf16: over 264 blocks (two an SM), a stage of NHWC x and g 31 KB,
    three in 93 KB."""
    plan = conv_cuda.resnet_gradw_plan(3232, 72, 96, 4, 132)
    assert (plan.bands, plan.units, plan.blocks) == (9, 29088, 132)
    assert (plan.xrs, plan.grs) == (324, 1552)
    assert plan.smem_bytes == 2 * 4 * (10 * 324 + 8 * 1552)
    plan = conv_cuda.resnet_gradw_plan(3232, 72, 96, 2, 132)
    assert (plan.bands, plan.units, plan.blocks) == (9, 29088, 264)
    assert (plan.wp, plan.xrs, plan.grs, plan.stages) == (96, 360, 1536, 3)
    assert plan.smem_bytes == 3 * 2 * (10 * 360 + 8 * 1536)


def test_resnet_gradw_plan_refuses_a_frame_too_wide():
    with pytest.raises(ValueError, match="does not fit"):
        conv_cuda.resnet_gradw_plan(8, 16, 400, 4, 132)
    with pytest.raises(ValueError, match="does not fit"):
        conv_cuda.resnet_gradw_plan(8, 16, 1600, 2, 132)


# -- the bf16 body's addressing, mirrored from conv_resnet.cu res_mma_body --
#
# A staged band is built as the kernel's copies build it (the same runs of
# raw memory, the same zeroing, the same ring of stages), and each lane's
# ldmatrix and 16-bit loads read it at the kernel's offsets; the fragments
# are then laid out as mma.sync m16n8k16 defines them.  Change these with
# the kernel.


def _b_offsets(plan, x_chw, lane, channels=3):
    """A lane's off_a, off_b, off_c (C = 4's tile 4) and elements per
    padded column."""
    gid, t = lane >> 2, lane & 3
    c = channels
    px = 1 if x_chw else c
    cs = plan.xplane if x_chw else 1
    xo = conv_cuda._resnet_xo(x_chw, c)
    off_a = (gid // c) * plan.xrs + (gid % c) * cs + xo + 2 * t * px
    if c == 3:
        off_b = 2 * (plan.xrs + cs) + xo + (2 * t + min(gid, 2)) * px
    else:
        off_b = 2 * plan.xrs + (gid % 4) * cs + xo + (2 * t + gid // 4) * px
    off_c = 2 * plan.xrs + (gid % 4) * cs + xo + (2 * t + 2) * px
    return off_a, off_b, off_c, px


def _b_loads(plan, x_chw, channels=3):
    """The 16-bit loads of one chunk's patches (per half: v0..v3, w0, w1
    and at C = 4 y0, y1: 12 or 16), each the 32 lanes' elements relative
    to the chunk's first pixel in the warp's staged x row."""
    loads = []
    runs = ((0, 4), (1, 2)) + (((2, 2),) if channels == 4 else ())
    for h in range(2):
        for which, count in runs:
            for d in range(count):
                loads.append([])
                for lane in range(32):
                    *offs, px = _b_offsets(plan, x_chw, lane, channels)
                    loads[-1].append(offs[which] + (8 * h + d) * px)
    return loads


def _a_row(plan, g_chw, lane):
    """The row lane ``lane`` addresses in a chunk's ldmatrix.x4 of g."""
    mat, r8 = lane >> 3, lane & 7
    if g_chw:
        return (r8 + 8 * (mat & 1)) * plan.grs + 8 * (mat >> 1)
    return (r8 + 8 * (mat >> 1)) * 16 + 8 * ((mat & 1) ^ (r8 >> 2))


def _column_tap(j, i, channels=3):
    """res_column_tap: dW row (kh*3 + kw)*C + c of column i of tile j."""
    c = channels
    if j < 3:
        return ((i // c) * 3 + j) * c + i % c
    if c == 3:
        return (6 + i) * 3 + 2 if i < 3 else -1
    if j == 3:
        return (6 + i // 4) * 4 + i % 4
    return 8 * 4 + i if i < 4 else -1


def _runs(buf, dst, dpl, drow, mem, src, spl, srow, planes, rows, length):
    for p in range(planes):
        for r in range(rows):
            d, s_ = dst + p * dpl + r * drow, src + p * spl + r * srow
            buf[d:d + length] = mem[s_:s_ + length]


def _zero_runs(buf, dst, dpl, drow, planes, r0, r1):
    for p in range(planes):
        buf[dst + p * dpl + r0 * drow:dst + p * dpl + r1 * drow] = 0


def _stage(buf, plan, x_chw, g_chw, xm, gm, n, band, h, w, channels=3):
    """res_mma_stage: image n's band into the stage ``buf``."""
    c = channels
    oh0 = band * 8
    rows = min(8, h - oh0)
    xr, ih0 = rows + 2, oh0 - 1
    lo, hi = max(0, -ih0), min(xr, h - ih0)
    plane = h * w
    xo = conv_cuda._resnet_xo(x_chw, c)
    if x_chw:
        _zero_runs(buf, 0, plan.xplane, plan.xrs, c, 0, lo)
        _zero_runs(buf, 0, plan.xplane, plan.xrs, c, hi, xr)
        _runs(buf, lo * plan.xrs + xo + 1, plan.xplane, plan.xrs, xm,
              n * c * plane + (ih0 + lo) * w, plane, w, c, hi - lo, w)
    else:
        _zero_runs(buf, 0, 0, plan.xrs, 1, 0, lo)
        _zero_runs(buf, 0, 0, plan.xrs, 1, hi, xr)
        _runs(buf, lo * plan.xrs + xo + c, 0, plan.xrs, xm,
              (n * plane + (ih0 + lo) * w) * c, 0, w * c, 1, hi - lo, w * c)
    gs = plan.x_elems
    src = n * 16 * plane + oh0 * w
    if g_chw and plan.wp == w:
        _runs(buf, gs, plan.grs, 0, gm, src, plane, 0, 16, 1, rows * w)
    elif g_chw:
        _runs(buf, gs, plan.grs, plan.wp, gm, src, plane, w, 16, rows, w)
    else:
        src = (n * plane + oh0 * w) * 16
        for r in range(rows):
            for k in range(2 * w):
                p = k >> 1
                half = (k & 1) ^ ((p >> 2) & 1)
                d = gs + (r * plan.wp + p) * 16 + 8 * half
                buf[d:d + 8] = gm[src + r * w * 16 + 8 * k:][:8]


def _ldmatrix_x4(buf, rows_at, trans):
    """Thread T's 4 registers (2 values each) of ldmatrix.x4 whose lane l
    addresses row l % 8 of matrix l // 8."""
    regs = np.empty((32, 4, 2))
    for i in range(4):
        m = np.stack([buf[a:a + 8] for a in rows_at[8 * i:8 * i + 8]])
        for lane in range(32):
            gid, t = lane >> 2, lane & 3
            regs[lane, i] = (m[2 * t:2 * t + 2, gid] if trans
                             else m[gid, 2 * t:2 * t + 2])
    return regs


def _fragments(buf, plan, x_chw, g_chw, warp, cb, channels=3):
    """The matrices a warp's 4 (5 at C = 4) mma.sync multiply for chunk cb
    of its row: A [16 features, 16 pixels] and B [16 pixels, 32 (40)
    columns], and every element the lanes read (to hold them inside their
    regions)."""
    tiles = 4 if channels == 3 else 5
    x_row = warp * plan.xrs + cb * 16 * (1 if x_chw else channels)
    g_chunk = plan.x_elems + warp * plan.wp * (1 if g_chw else 16) + (
        cb * 16 * (1 if g_chw else 16))
    rows_at = [g_chunk + _a_row(plan, g_chw, lane) for lane in range(32)]
    regs = _ldmatrix_x4(buf, rows_at, trans=not g_chw)
    a_mat = np.empty((16, 16))
    b_mat = np.empty((16, 8 * tiles))
    loads = np.array(_b_loads(plan, x_chw, channels)) + x_row  # [12|16, 32]
    values = buf[loads]
    per = len(loads) // 2
    for lane in range(32):
        gid, t = lane >> 2, lane & 3
        for i in range(4):
            a_mat[gid + 8 * (i & 1), 2 * t + 8 * (i >> 1):][:2] = regs[lane, i]
        for h in range(2):
            v = values[per * h:per * h + per, lane]
            pairs = ((v[0], v[1]), (v[1], v[2]), (v[2], v[3]), (v[4], v[5]))
            if tiles == 5:
                pairs += ((v[6], v[7]),)
            for j, pair in enumerate(pairs):
                b_mat[2 * t + 8 * h:2 * t + 8 * h + 2, 8 * j + gid] = pair
    return a_mat, b_mat, rows_at, loads


def _emulate_resnet_bf16(x, g, x_chw, g_chw, sm_count, check=None):
    """csrc/conv_resnet.cu's bf16 body on numpy [N, H, W, C] x and [N, H,
    W, 16] g: every block's ring, staging and mma fragments, summed in the
    kernel's order (chunks into a band's float32 accumulator, bands into
    the running sums, warps, then blocks); dW [3, 3, C, 16].
    ``check(n, oh0, warp, cb, a_mat, b_mat)`` sees every chunk's
    matrices."""
    n_img, h, w, c = x.shape
    tiles = 4 if c == 3 else 5
    plan = conv_cuda.resnet_gradw_plan(n_img, h, w, 2, sm_count, x_chw,
                                       g_chw, c)
    xm = np.ascontiguousarray(x.transpose(0, 3, 1, 2) if x_chw else x).ravel()
    gm = np.ascontiguousarray(g.transpose(0, 3, 1, 2) if g_chw else g).ravel()
    partials = []
    for block in range(plan.blocks):
        ring = np.zeros((plan.stages, plan.stage_elems))
        acc = np.zeros((8, 16, 8 * tiles), np.float32)
        for i, u in enumerate(conv_cuda.block_units(plan, block)):
            n, band = divmod(u, plan.bands)
            buf = ring[i % plan.stages]
            _stage(buf, plan, x_chw, g_chw, xm, gm, n, band, h, w, c)
            for warp in range(min(8, h - band * 8)):
                part = np.zeros((16, 8 * tiles), np.float32)
                for cb in range(plan.wp // 16):
                    a_mat, b_mat, rows_at, loads = _fragments(
                        buf, plan, x_chw, g_chw, warp, cb, c)
                    assert plan.x_elems <= min(rows_at)
                    assert max(rows_at) + 8 <= plan.stage_elems
                    assert 0 <= loads.min() and loads.max() < plan.x_elems
                    if check:
                        check(n, band * 8, warp, cb, a_mat, b_mat)
                    part += (a_mat @ b_mat).astype(np.float32)
                acc[warp] += part
        dw = np.zeros((9 * c, 16), np.float32)
        for warp in range(8):
            for col in range(8 * tiles):
                tap = _column_tap(col // 8, col % 8, c)
                if tap >= 0:
                    dw[tap] += acc[warp, :, col]
        partials.append(dw)
    return np.sum(partials, axis=0, dtype=np.float32).reshape(3, 3, c, 16)


RESNET_BF16_CASES = [(1, 72, 96), (3, 17, 23)]
LAYOUT_PAIRS = [(False, False), (True, True), (True, False), (False, True)]


@pytest.mark.parametrize("x_chw,g_chw", LAYOUT_PAIRS)
@pytest.mark.parametrize("n,h,w", RESNET_BF16_CASES)
def test_resnet_bf16_fragments_hold_the_right_taps_and_pixels(n, h, w, x_chw,
                                                               g_chw):
    """Index level: with every x and g element replaced by its own number
    (1, 2, ...; the pads 0), each chunk's A holds g[n, oh, 16cb + k, f] at
    (f, k) and its B holds x[n, oh + kh - 1, 16cb + k + kw - 1, c] at (k,
    column of tap (kh, kw, c)), zero outside the image and past the row's
    W pixels; the 5 unused columns hold staged (finite) values."""
    x_id = 1.0 + np.arange(n * h * w * 3, dtype=np.float64).reshape(
        n, h, w, 3)
    g_id = 1.0 + np.arange(n * h * w * 16, dtype=np.float64).reshape(
        n, h, w, 16)
    xp = np.pad(x_id, ((0, 0), (1, 1), (1, 1), (0, 0)))
    seen = []

    def check(img, oh0, warp, cb, a_mat, b_mat):
        oh = oh0 + warp
        ow = 16 * cb + np.arange(16)
        inside = ow < w
        want_a = np.where(inside[None, :],
                          g_id[img, oh, np.minimum(ow, w - 1), :].T, 0.0)
        np.testing.assert_array_equal(a_mat, want_a)
        for col in range(32):
            tap = _column_tap(col // 8, col % 8)
            if tap < 0:
                assert np.isfinite(b_mat[:, col]).all()
                continue
            kh, kw, c = tap // 9, (tap // 3) % 3, tap % 3
            pc = ow + kw
            want = np.where(pc < w + 2,
                            xp[img, oh + kh, np.minimum(pc, w + 1), c], 0.0)
            np.testing.assert_array_equal(b_mat[:, col], want)
        seen.append((img, oh, cb))

    _emulate_resnet_bf16(x_id, g_id, x_chw, g_chw, sm_count=2, check=check)
    wp = -(-w // 16) * 16
    assert sorted(seen) == [(i, oh, cb) for i in range(n) for oh in range(h)
                            for cb in range(wp // 16)]


@pytest.mark.parametrize("x_chw,g_chw", LAYOUT_PAIRS)
@pytest.mark.parametrize("n,h,w", RESNET_BF16_CASES)
def test_resnet_bf16_fragment_sums_match_plain_and_pallas(n, h, w, x_chw,
                                                          g_chw):
    """The products those fragments pair, summed in the kernel's order,
    against conv_gradw_plain's im2col contraction and the Pallas kernel
    (interpret mode, matmul_dtype="bfloat16") on bf16-exact x and g, at
    the tolerance of test_resnet_stem_gradw_plain_matches_pallas."""
    x, g = _case(h * w + 7 * n, n, h, w, 3, 16, 1)
    x = torch.tensor(x).bfloat16()
    g = torch.tensor(g).bfloat16()
    got = _emulate_resnet_bf16(x.float().numpy().astype(np.float64),
                               g.float().numpy().astype(np.float64),
                               x_chw, g_chw, sm_count=2)
    plain = conv_cuda.conv_gradw_plain(x, g, 3, 1).numpy()
    want = np.asarray(conv_pallas.conv_gradw(
        jnp.asarray(x.float().numpy(), jnp.bfloat16),
        jnp.asarray(g.float().numpy(), jnp.bfloat16), 3, 1, interpret=True,
        matmul_dtype="bfloat16"))
    for reference in (plain, want):
        np.testing.assert_allclose(got, reference, rtol=2e-5,
                                   atol=2e-6 * np.abs(reference).max())


class _Recorder:
    """A stand-in kernel library recording each launch's entry point and
    arguments; every launch succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("sat_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


def _kernel_route(monkeypatch):
    """The kernel route with a stand-in library and 132 SMs; the plain
    version fails the test if it runs."""
    library = _Recorder()
    monkeypatch.setattr(_build, "on_cpu", lambda *_: False)
    monkeypatch.setattr(_build, "library", lambda: library)
    monkeypatch.setattr(conv_cuda, "_sm_count", lambda index: 132)
    monkeypatch.setattr(conv_cuda.torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 7})())
    monkeypatch.setattr(conv_cuda, "conv_gradw_plain", lambda *a: pytest.fail(
        "the kernel route ran the plain version"))
    return library


@pytest.mark.parametrize("dtype,suffix", [(torch.float32, ""),
                                          (torch.bfloat16, "_bf16")])
@pytest.mark.parametrize("layout", ["hwc", "chw"])
def test_resnet_geometry_takes_its_kernel_on_the_card(monkeypatch, dtype,
                                                      suffix, layout):
    """On the kernel route (x and g on the card, here a stand-in library)
    (3, 1, 3, 16) launches the ResNet stem kernel of the operand type with
    its plan and counts it there, and never the plain version."""
    library = _kernel_route(monkeypatch)
    x, g = (torch.tensor(a).to(dtype) for a in _case(6, 2, 17, 23, 3, 16, 1))
    x, g = _layouts(x, g)[layout]
    before = dict(conv_cuda.LAUNCHES)
    conv_cuda.conv_gradw(x, g, 3, 1)
    (name, args), = library.calls
    assert name == "sat_resnet_stem_gradw" + suffix
    chw = layout == "chw"
    plan = conv_cuda.resnet_gradw_plan(2, 17, 23, x.element_size(), 132,
                                       chw, chw)
    assert args[4:] == (17, 23, plan.bands, plan.xrs, plan.grs,
                        plan.x_elems, plan.stage_elems, plan.stages,
                        plan.xplane, plan.wp, plan.smem_bytes, int(chw),
                        int(chw), plan.units, plan.blocks, 7)
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


# -- the shallow stem on Atari's grayscale stack of 4: (8, 4, 4, 32) ----------


@pytest.fixture(scope="module")
def atari_gradw_case():
    """Frames of 84x84 (21x21 outputs, pads (2, 2)) and 17x23 (asymmetric
    pads) with 4 channels, and the Pallas kernel's dW on them in interpret
    mode, float32 and at matmul_dtype="bfloat16": computed once."""
    cases = {}
    for n, h, w in ((2, 84, 84), (3, 17, 23)):
        x, g = _case(h * w, n, h, w, 4, 32, 4)
        want = {dtype: np.asarray(conv_pallas.conv_gradw(
            jnp.asarray(x, dtype), jnp.asarray(g, dtype), 8, 4,
            interpret=True, matmul_dtype=name))
            for name, dtype in (("float32", jnp.float32),
                                ("bfloat16", jnp.bfloat16))}
        cases[(h, w)] = (x, g, want)
    return cases


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(84, 84), (17, 23)])
def test_c4_gradw_plain_matches_pallas(atari_gradw_case, hw, dtype):
    """conv_gradw at (K, S, C, F) = (8, 4, 4, 32) -- on the CPU its plain
    version -- against the Pallas kernel, float32 and with bf16 x and g
    (exact products, float32 sums), in both layouts the stem's backward
    hands over: rtol 1e-5, and an absolute tolerance of 2e-6 of max |dW|
    (each entry sums up to 882 products of standard normals in another
    order, as test_stem_geometry_matches_pallas)."""
    x, g, want = atari_gradw_case[hw]
    want = want[jnp.bfloat16 if dtype == "bfloat16" else jnp.float32]
    tdtype = getattr(torch, dtype)
    for xt, gt in _layouts(torch.tensor(x).to(tdtype),
                           torch.tensor(g).to(tdtype)).values():
        got = conv_cuda.conv_gradw(xt, gt, 8, 4)
        assert got.dtype == torch.float32 and got.shape == (8, 8, 4, 32)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("dtype,suffix", [(torch.float32, ""),
                                          (torch.bfloat16, "_bf16")])
@pytest.mark.parametrize("layout", ["hwc", "chw"])
def test_c4_geometry_takes_its_kernel_on_the_card(monkeypatch, dtype,
                                                  suffix, layout):
    """On the kernel route (x and g on the card, here a stand-in library)
    (8, 4, 4, 32) launches the C = 4 kernel of the operand type (float32:
    the band kernel; bf16: the mma.sync kernel) with its plan and counts
    it there, and never the plain version."""
    library = _kernel_route(monkeypatch)
    x, g = (torch.tensor(a).to(dtype) for a in _case(8, 2, 84, 84, 4, 32, 4))
    x, g = _layouts(x, g)[layout]
    before = dict(conv_cuda.LAUNCHES)
    conv_cuda.conv_gradw(x, g, 8, 4)
    (name, args), = library.calls
    assert name == "sat_conv_gradw_c4" + suffix
    chw = layout == "chw"
    if dtype == torch.float32:
        plan = conv_cuda.gradw_plan(2, 21, 21, chw, chw, 132, 4)
        assert args[4:] == (84, 84, 21, 21, 2, 2, plan.band_rows,
                            plan.bands, plan.xrs, plan.x_floats, plan.gps,
                            plan.stage_floats, plan.smem_bytes, int(chw),
                            int(chw), plan.units, plan.blocks, 7)
    else:
        plan = conv_cuda.gradw_mma_plan(2, 84, 84, 4, chw, chw, 132)
        assert args[4:] == (2, 84, 84, 21, 21, 2, 2, plan.band_rows,
                            plan.bands, plan.images, plan.xo, plan.xrs,
                            plan.xplane, plan.ximg, plan.x_elems, plan.gps,
                            plan.g_elems, plan.pix, plan.stage_elems,
                            plan.stages, plan.smem_bytes, int(chw), int(chw),
                            plan.units, plan.blocks, 7)
    grown = {k: v - before[k] for k, v in conv_cuda.LAUNCHES.items()
             if v != before[k]}
    assert grown == {"stem_gradw_c4" + suffix: 1}


@pytest.mark.parametrize("n,h,w,x_chw,g_chw,sms", [
    (3232, 84, 84, False, False, 132),
    (3233, 84, 84, True, True, 132),
    (1, 84, 84, False, True, 132),
    (64, 17, 23, True, False, 132),
    (5, 84, 84, False, False, 7),
])
def test_c4_gradw_plan_takes_every_image_band_once_in_order(n, h, w, x_chw,
                                                            g_chw, sms):
    """At C = 4: equal bands covering the output rows, every (image, band)
    unit once and in order, two stages within the budget, and room for the
    final sum of the other two row groups' [256, 32] tiles."""
    out_h, _ = conv_cuda.same_pads(h, 8, 4)
    out_w, _ = conv_cuda.same_pads(w, 8, 4)
    plan = conv_cuda.gradw_plan(n, out_h, out_w, x_chw, g_chw, sms, 4)
    assert plan.units == n * plan.bands
    assert plan.bands * plan.band_rows >= out_h
    assert (plan.bands - 1) * plan.band_rows < out_h
    units = [list(conv_cuda.block_units(plan, b))
             for b in range(plan.blocks)]
    assert [u for block in units for u in block] == list(range(plan.units))
    assert 8 * plan.stage_floats <= conv_cuda.SMEM_BUDGET
    assert conv_cuda.GRADW_GROUPS[4] == 3
    assert plan.smem_bytes >= 4 * 2 * 256 * 32
    assert plan.smem_bytes <= 227 * 1024
    assert plan.xrs % 32 == 8 and plan.gps % 2 == 1
    assert plan.x_floats % 4 == 0 and plan.stage_floats % 4 == 0


def test_c4_gradw_plan_of_the_atari_path():
    """84x84x4 frames (21x21 outputs): two bands of 11 and 10 output rows
    (44 and 40 input rows with the halo), 88 padded columns x 4 channels
    to a row stride of 360 floats."""
    plan = conv_cuda.gradw_plan(3232, 21, 21, False, False, 132, 4)
    assert (plan.band_rows, plan.bands, plan.units, plan.blocks) == (
        11, 2, 6464, 132)
    assert plan.xrs == 360


# -- the shallow stem's bf16 kernel, mirrored from csrc/conv_mma.cu ----------
#
# conv_gradw_mma_kernel: a unit (a band of one image, or whole small images)
# is staged as the kernel's copies stage it (the same raw runs, the g
# chunks' swizzle, the zeroed rows and tail, the table of patch origins,
# the same ring of stages), and each lane's ldmatrix and 16-bit loads read
# it at the kernel's offsets; the fragments are then laid out as mma.sync
# m16n8k16 defines them.  Change these with the kernel.


def _mma_tap(plan, channels, x_chw, tile, n):
    """mma_tap: dW row and staged-x offset of column n of n8 tile
    ``tile``."""
    if x_chw:
        kh, c, kw = tile // channels, tile % channels, n
        off = c * plan.xplane + kh * plan.xrs + kw
    else:
        tau = 8 * tile + n
        kh, kw = tau // (8 * channels), (tau // channels) % 8
        c = tau % channels
        off = kh * plan.xrs + kw * channels + c
    return (kh * 8 + kw) * channels + c, off


def _mma_pixel(g_chw, k):
    """mma_pixel: the pixel of a step that row k of the fragments is."""
    return k if g_chw else 8 * (k >> 3) + ((k >> 1) & 3) + 4 * (k & 1)


def _mma_geometry(h, w):
    out_h, (pad_h, _) = conv_cuda.same_pads(h, 8, 4)
    out_w, (pad_w, _) = conv_cuda.same_pads(w, 8, 4)
    return out_h, out_w, pad_h, pad_w


def _mma_unit(plan, u, n_img, out_h, out_w):
    """The images, band rows and pixels of unit u."""
    group, band = divmod(u, plan.bands)
    n0 = group * plan.images
    imgs = min(plan.images, n_img - n0)
    oh0 = band * plan.band_rows
    rows = min(plan.band_rows, out_h - oh0)
    return n0, imgs, oh0, rows, imgs * rows * out_w


def _mma_stage(buf, table, plan, channels, x_chw, g_chw, xm, gm, u, n_img,
               h, w):
    """mma_stage: unit u into the stage ``buf`` and its table."""
    out_h, out_w, pad_h, pad_w = _mma_geometry(h, w)
    n0, imgs, oh0, rows, pu = _mma_unit(plan, u, n_img, out_h, out_w)
    xr = (rows - 1) * 4 + 8
    ih0 = oh0 * 4 - pad_h
    lo, hi = max(0, -ih0), min(xr, h - ih0)
    px = 1 if x_chw else channels
    planes = imgs * channels if x_chw else imgs
    dpl = plan.xplane if x_chw else plan.ximg
    spl = h * w if x_chw else h * w * channels
    _zero_runs(buf, 0, dpl, plan.xrs, planes, 0, lo)
    _zero_runs(buf, 0, dpl, plan.xrs, planes, hi, xr)
    _runs(buf, lo * plan.xrs + plan.xo + pad_w * px, dpl, plan.xrs, xm,
          n0 * h * w * channels + (ih0 + lo) * w * px, spl, w * px, planes,
          hi - lo, w * px)
    gs, pimg, p16 = plan.x_elems, rows * out_w, -(-pu // 16) * 16
    ohw = out_h * out_w
    if g_chw:
        _runs(buf, gs, plan.gps, pimg, gm, n0 * 32 * ohw + oh0 * out_w, ohw,
              32 * ohw, 32, imgs, pimg)
        for f in range(32):
            buf[gs + f * plan.gps + pu:gs + f * plan.gps + p16] = 0
    else:
        src = (n0 * ohw + oh0 * out_w) * 32
        p = np.arange(pu)[:, None]
        f = np.arange(32)[None, :]
        dst = gs + p * 32 + 8 * ((f >> 3) ^ ((p >> 1) & 3)) + (f & 7)
        buf[dst] = gm[src + p * 32 + f]
        buf[gs + pu * 32:gs + p16 * 32] = 0
    assert plan.x_elems + plan.g_elems + 2 * plan.pix <= plan.stage_elems
    table[:] = plan.xo
    p = np.arange(pu)
    i, r = np.divmod(p, pimg)
    oh, ow = np.divmod(r, out_w)
    table[:pu] = plan.xo + i * plan.ximg + oh * 4 * plan.xrs + ow * 4 * px
    return n0, oh0, pu


def _mma_fragments(buf, table, plan, channels, x_chw, g_chw, k0):
    """One step's A [32 features, 16 k] and B [16 k, 64*C taps] as the 8
    warps' lanes load them (B's columns in dW row order), and every
    element the lanes read."""
    gs = plan.x_elems
    lanes = np.arange(32)
    gid, t = lanes >> 2, lanes & 3
    mat, r8 = lanes >> 3, lanes & 7
    a_mat = np.empty((32, 16))
    rows_seen = []
    for mt in range(2):
        if g_chw:
            rows_at = (gs + k0 + (16 * mt + r8 + 8 * (mat & 1)) * plan.gps
                       + 8 * (mat >> 1))
        else:
            p = np.array([_mma_pixel(False, k) for k in r8 + 8 * (mat >> 1)])
            rows_at = (gs + k0 * 32 + p * 32
                       + 8 * (((mat & 1) + 2 * mt) ^ ((p >> 1) & 3)))
        rows_seen += list(rows_at)
        regs = _ldmatrix_x4(buf, list(rows_at), trans=not g_chw)
        for lane in range(32):
            for i in range(4):
                a_mat[16 * mt + gid[lane] + 8 * (i & 1),
                      2 * t[lane] + 8 * (i >> 1):][:2] = regs[lane, i]
    kj = [2 * t + (j & 1) + 8 * (j >> 1) for j in range(4)]
    origins = [table[k0 + np.array([_mma_pixel(g_chw, k) for k in kk])]
               for kk in kj]
    b_mat = np.empty((16, 64 * channels))
    loads = []
    for tile in range(8 * channels):
        for lane in range(32):
            tap, off = _mma_tap(plan, channels, x_chw, tile, gid[lane])
            for j in range(4):
                loads.append(origins[j][lane] + off)
                b_mat[kj[j][lane], tap] = buf[origins[j][lane] + off]
    return a_mat, b_mat, np.array(rows_seen), np.array(loads)


def _emulate_mma_bf16(x, g, x_chw, g_chw, sm_count, budget=None,
                      check=None):
    """csrc/conv_mma.cu's conv_gradw_mma_kernel on numpy [N, H, W, C] x
    and [N, OH, OW, 32] g: every block's ring, staging and fragments,
    summed in the kernel's order (each pixel group's steps in order into
    its float32 sums, the pixel groups in order, then the blocks); dW [8,
    8, C, 32].  ``check(n0,
    oh0, pu, k0, a_mat, b_mat)`` sees every step's matrices."""
    n_img, h, w, channels = x.shape
    out_h, out_w, _, _ = _mma_geometry(h, w)
    plan = conv_cuda.gradw_mma_plan(
        n_img, h, w, channels, x_chw, g_chw, sm_count,
        **({} if budget is None else {"budget": budget}))
    groups = conv_cuda.MMA_WARPS // conv_cuda.MMA_TAP_WARPS[channels]
    xm = np.ascontiguousarray(x.transpose(0, 3, 1, 2) if x_chw else x).ravel()
    gm = np.ascontiguousarray(g.transpose(0, 3, 1, 2) if g_chw else g).ravel()
    partials = []
    for block in range(plan.blocks):
        ring = np.zeros((plan.stages, plan.stage_elems))
        tables = np.zeros((plan.stages, plan.pix), np.int64)
        acc = np.zeros((groups, 32, 64 * channels), np.float32)
        for i, u in enumerate(conv_cuda.block_units(plan, block)):
            buf, table = ring[i % plan.stages], tables[i % plan.stages]
            n0, oh0, pu = _mma_stage(buf, table, plan, channels, x_chw,
                                     g_chw, xm, gm, u, n_img, h, w)
            for st in range(-(-pu // 16)):
                a_mat, b_mat, rows_at, loads = _mma_fragments(
                    buf, table, plan, channels, x_chw, g_chw, 16 * st)
                assert plan.x_elems <= rows_at.min()
                assert rows_at.max() + 8 <= plan.x_elems + plan.g_elems
                assert 0 <= loads.min() and loads.max() < plan.x_elems
                if check:
                    check(n0, oh0, pu, 16 * st, a_mat, b_mat)
                acc[st % groups] += (a_mat @ b_mat).astype(np.float32)
        partials.append(np.sum(acc, axis=0, dtype=np.float32))
    dw = np.sum(partials, axis=0, dtype=np.float32)
    return dw.T.reshape(8, 8, channels, 32)


MMA_LAYOUTS = [(False, False), (True, True)]
MMA_CASES = [
    # (N, frame H, W, C, split): odd frames (asymmetric pads) of several
    # whole images a unit, 16x16 frames (4x4 outputs), the one-channel
    # path's 72x96x1, and bands of one image (split: a budget just short
    # of a whole image's stages, _mma_budget).
    (3, 17, 23, 1, False), (2, 17, 23, 3, False), (2, 17, 23, 4, False),
    (3, 16, 16, 3, False), (1, 72, 96, 1, False),
    (2, 24, 32, 3, True), (1, 36, 36, 4, True),
]


def _mma_budget(h, w, c, x_chw, g_chw, split):
    """None, or a budget that leaves MMA_MIN_STAGES stages of a whole
    image just out of reach (two bands)."""
    if not split:
        return None
    whole = conv_cuda.gradw_mma_plan(1, h, w, c, x_chw, g_chw, 2)
    return 2 * conv_cuda.MMA_MIN_STAGES * whole.stage_elems - 2


@pytest.mark.parametrize("x_chw,g_chw", MMA_LAYOUTS + [(True, False),
                                                        (False, True)])
@pytest.mark.parametrize("n,h,w,c,split", MMA_CASES)
def test_mma_bf16_fragments_hold_the_right_taps_and_pixels(n, h, w, c,
                                                           split, x_chw,
                                                           g_chw):
    """Index level: with every x and g element replaced by its own number
    (1, 2, ...; the pads 0), each step's A holds g[n, oh, ow, f] at (f, k)
    for the unit's pixel k stands for (zero past the unit's last pixel),
    and its B holds x[n, 4*oh + kh - pad_h, 4*ow + kw - pad_w, c] at (k,
    tap (kh, kw, c)), zero in the SAME pads; every unit's pixels are
    taken once."""
    out_h, out_w, pad_h, pad_w = _mma_geometry(h, w)
    x_id = 1.0 + np.arange(n * h * w * c, dtype=np.float64).reshape(
        n, h, w, c)
    g_id = 1.0 + np.arange(n * out_h * out_w * 32, dtype=np.float64
                           ).reshape(n, out_h, out_w, 32)
    hp, wp = (out_h - 1) * 4 + 8, (out_w - 1) * 4 + 8
    xp = np.zeros((n, hp, wp, c))
    xp[:, pad_h:pad_h + h, pad_w:pad_w + w] = x_id
    budget = _mma_budget(h, w, c, x_chw, g_chw, split)
    plan = conv_cuda.gradw_mma_plan(n, h, w, c, x_chw, g_chw, 2,
                                    **({} if budget is None
                                       else {"budget": budget}))
    if split:
        assert plan.bands > 1 and plan.images == 1
    taps = [(kh, kw, cc) for kh in range(8) for kw in range(8)
            for cc in range(c)]
    kh, kw, cc = (np.array(v) for v in zip(*taps))
    seen = []

    def check(n0, oh0, pu, k0, a_mat, b_mat):
        rows = min(plan.band_rows, out_h - oh0)
        for k in range(16):
            p = k0 + _mma_pixel(g_chw, k)
            if p >= pu:
                assert not a_mat[:, k].any()
                assert np.isfinite(b_mat[k]).all()
                continue
            i, r = divmod(p, rows * out_w)
            oh, ow = oh0 + r // out_w, r % out_w
            np.testing.assert_array_equal(a_mat[:, k], g_id[n0 + i, oh, ow])
            np.testing.assert_array_equal(
                b_mat[k], xp[n0 + i, 4 * oh + kh, 4 * ow + kw, cc])
            seen.append((n0 + i, oh, ow))

    _emulate_mma_bf16(x_id, g_id, x_chw, g_chw, sm_count=2, budget=budget,
                      check=check)
    assert sorted(seen) == [(i, oh, ow) for i in range(n)
                            for oh in range(out_h) for ow in range(out_w)]


@pytest.fixture(scope="module")
def mma_sum_cases():
    """bf16-exact x and g for MMA_CASES, and the Pallas kernel's dW on
    them (interpret mode, matmul_dtype="bfloat16"): computed once."""
    cases = {}
    for n, h, w, c, _ in MMA_CASES:
        x, g = _case(h * w + 11 * c, n, h, w, c, 32, 4)
        x = torch.tensor(x).bfloat16()
        g = torch.tensor(g).bfloat16()
        want = np.asarray(conv_pallas.conv_gradw(
            jnp.asarray(x.float().numpy(), jnp.bfloat16),
            jnp.asarray(g.float().numpy(), jnp.bfloat16), 8, 4,
            interpret=True, matmul_dtype="bfloat16"))
        cases[(n, h, w, c)] = (x, g, want)
    return cases


@pytest.mark.parametrize("x_chw,g_chw", MMA_LAYOUTS)
@pytest.mark.parametrize("n,h,w,c,split", MMA_CASES)
def test_mma_bf16_fragment_sums_match_plain_and_pallas(mma_sum_cases, n, h,
                                                       w, c, split, x_chw,
                                                       g_chw):
    """The products those fragments pair, summed in the kernel's order,
    against conv_gradw_plain and the Pallas kernel on bf16-exact x and g,
    at the tolerance of test_c4_gradw_plain_matches_pallas."""
    x, g, want = mma_sum_cases[(n, h, w, c)]
    got = _emulate_mma_bf16(x.float().numpy().astype(np.float64),
                            g.float().numpy().astype(np.float64), x_chw,
                            g_chw, sm_count=2,
                            budget=_mma_budget(h, w, c, x_chw, g_chw, split))
    plain = conv_cuda.conv_gradw_plain(x, g, 8, 4).numpy()
    for reference in (plain, want):
        np.testing.assert_allclose(got, reference, rtol=1e-5,
                                   atol=2e-6 * np.abs(reference).max())


MMA_PLAN_FRAMES = [
    # (frame H, W, C): every frame a ported path hands the bf16 kernel.
    (72, 96, 3), (72, 128, 3), (16, 16, 3), (84, 84, 4), (72, 96, 1)]


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("n", [3232, 3233, 1])
@pytest.mark.parametrize("h,w,c", MMA_PLAN_FRAMES)
def test_gradw_mma_plan_fits_and_splits_in_order(h, w, c, n, sms):
    """Every (image group, band) unit once and in order, over blocks
    (MMA_BLOCKS_PER_SM an SM) that differ by at most one unit; equal bands
    covering the output rows; several whole images a unit only where a
    band is the whole image; the staged rows' data 16-byte aligned
    (cp.async) in both layouts; a block's ring of at least MMA_MIN_STAGES
    stages within its share of SMEM_BUDGET, and the pixel groups' final
    sums within the block's shared memory."""
    out_h, out_w, _, pad_w = _mma_geometry(h, w)
    for x_chw, g_chw in LAYOUT_PAIRS:
        plan = conv_cuda.gradw_mma_plan(n, h, w, c, x_chw, g_chw, sms)
        assert plan.bands * plan.band_rows >= out_h
        assert (plan.bands - 1) * plan.band_rows < out_h
        assert plan.images == 1 or plan.bands == 1
        assert plan.images * plan.band_rows * out_w <= max(
            conv_cuda.MMA_UNIT_PIXELS, plan.band_rows * out_w)
        assert plan.units == -(-n // plan.images) * plan.bands
        per_sm = conv_cuda.MMA_BLOCKS_PER_SM
        assert plan.blocks == min(plan.units, per_sm * sms)
        units = [list(conv_cuda.block_units(plan, b))
                 for b in range(plan.blocks)]
        assert all(units) and max(map(len, units)) - min(map(len, units)) <= 1
        assert [u for block in units for u in block] == list(
            range(plan.units))
        px = 1 if x_chw else c
        assert ((plan.xo + pad_w * px) * 2) % 16 == 0
        for size in (plan.xrs, plan.xplane, plan.ximg, plan.x_elems,
                     plan.gps, plan.g_elems, plan.stage_elems):
            assert (size * 2) % 16 == 0
        x_rows = (plan.band_rows - 1) * 4 + 8
        assert plan.xrs >= plan.xo + (4 * out_w + 4) * px
        if x_chw:
            assert plan.xplane >= x_rows * plan.xrs
            assert plan.ximg == c * plan.xplane
        else:
            assert plan.ximg >= x_rows * plan.xrs
        assert plan.pix % 16 == 0
        assert plan.pix >= plan.images * plan.band_rows * out_w
        if g_chw:
            # Feature planes 16 bytes (mod 128) apart: the 8 rows of one
            # ldmatrix on distinct banks.
            assert plan.gps >= plan.pix and (plan.gps * 2) % 128 == 16
        assert plan.stage_elems >= (plan.images * plan.ximg + plan.g_elems
                                    + 2 * plan.pix)
        assert (conv_cuda.MMA_MIN_STAGES <= plan.stages
                <= conv_cuda.MMA_STAGES)
        groups = conv_cuda.MMA_WARPS // conv_cuda.MMA_TAP_WARPS[c]
        assert plan.smem_bytes == max(plan.stages * plan.stage_elems * 2,
                                      4 * groups * 64 * c * 32)
        assert per_sm * plan.smem_bytes <= conv_cuda.SMEM_BUDGET


def test_gradw_mma_plan_of_the_main_path():
    """72x96x3 frames at N=3232, NHWC: three bands of 6 output rows (28
    input rows with the halo, 144 pixels), 9696 units over 264 blocks
    (two an SM); a staged row of 100 padded columns from element 2 (the
    data, column 2, at element 8), 304 elements; three stages of 26.2
    KB."""
    plan = conv_cuda.gradw_mma_plan(3232, 72, 96, 3, False, False, 132)
    assert (plan.band_rows, plan.bands, plan.images, plan.units,
            plan.blocks) == (6, 3, 1, 9696, 264)
    assert (plan.xo, plan.xrs, plan.ximg, plan.pix) == (2, 304, 28 * 304,
                                                        144)
    assert plan.g_elems == 144 * 32
    assert (plan.stage_elems, plan.stages) == (28 * 304 + 144 * 32 + 288, 3)
    # 16x16 frames: 8 whole images a unit (128 pixels), 404 units.
    plan = conv_cuda.gradw_mma_plan(3232, 16, 16, 3, False, False, 132)
    assert (plan.bands, plan.images, plan.pix, plan.units) == (1, 8, 128,
                                                               404)


def test_gradw_mma_plan_refuses_a_frame_too_wide():
    with pytest.raises(ValueError, match="does not fit"):
        conv_cuda.gradw_mma_plan(8, 16, 4000, 3, False, False, 132)


# -- the one-channel stem (8, 4, 1, 32) and the ResNet stem on Atari's
# -- stack of 4 (3, 1, 4, 16) -------------------------------------------------


@pytest.fixture(scope="module")
def new_geometry_cases():
    """The Pallas kernel's dW, in interpret mode at float32 and at
    matmul_dtype="bfloat16", on an odd frame (17x23) and the path's frame
    of each new geometry: one-channel 72x96 frames through the shallow
    stem, Atari's 84x84x4 through the ResNet stem.  Computed once."""
    cases = {}
    for (k, s, c, f), frames in (((8, 4, 1, 32), ((2, 72, 96), (3, 17, 23))),
                                 ((3, 1, 4, 16), ((1, 84, 84), (2, 17, 23)))):
        for n, h, w in frames:
            x, g = _case(h * w + c, n, h, w, c, f, s)
            want = {name: np.asarray(conv_pallas.conv_gradw(
                jnp.asarray(x, dtype), jnp.asarray(g, dtype), k, s,
                interpret=True, matmul_dtype=name))
                for name, dtype in (("float32", jnp.float32),
                                    ("bfloat16", jnp.bfloat16))}
            cases[(k, c, h, w)] = (x, g, want)
    return cases


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,c,h,w", [(8, 1, 72, 96), (8, 1, 17, 23),
                                     (3, 4, 84, 84), (3, 4, 17, 23)])
def test_new_geometries_plain_matches_pallas(new_geometry_cases, k, c, h, w,
                                             dtype):
    """conv_gradw at (8, 4, 1, 32) and (3, 1, 4, 16) -- on the CPU its
    plain version -- against the Pallas kernel, float32 and with bf16 x
    and g (exact products, float32 sums), in both layouts the stem's
    backward hands over: rtol 1e-5 and an absolute tolerance of 2e-6 of
    max |dW|, as test_c4_gradw_plain_matches_pallas."""
    x, g, want = new_geometry_cases[(k, c, h, w)]
    want = want[dtype]
    tdtype = getattr(torch, dtype)
    s = 4 if k == 8 else 1
    for layout, (xt, gt) in _layouts(torch.tensor(x).to(tdtype),
                                     torch.tensor(g).to(tdtype)).items():
        if c > 1:
            assert conv_cuda.tensor_layout(xt) == layout
        assert conv_cuda.tensor_layout(gt) == layout
        got = conv_cuda.conv_gradw(xt, gt, k, s)
        assert got.dtype == torch.float32
        assert got.shape == (k, k, c, g.shape[-1])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("layout", ["hwc", "chw"])
@pytest.mark.parametrize("c,h,w,entry", [
    (3, 72, 96, "sat_conv_gradw_bf16"), (3, 16, 16, "sat_conv_gradw_bf16"),
    (4, 84, 84, "sat_conv_gradw_c4_bf16"),
    (1, 72, 96, "sat_conv_gradw_c1_bf16")])
def test_bf16_stem_takes_the_mma_kernel_on_the_card(monkeypatch, c, h, w,
                                                    entry, layout):
    """On the kernel route bf16 x and g through the shallow stem launch
    the mma.sync kernel of their channel count with gradw_mma_plan's
    arguments, counted under the bf16 counter, never the plain version."""
    library = _kernel_route(monkeypatch)
    x, g = (torch.tensor(a).bfloat16() for a in _case(9, 2, h, w, c, 32, 4))
    x, g = _layouts(x, g)[layout]
    chw = layout == "chw"
    x_chw = chw and c > 1  # one channel: both layouts are one memory
    before = dict(conv_cuda.LAUNCHES)
    conv_cuda.conv_gradw(x, g, 8, 4)
    (name, args), = library.calls
    assert name == entry
    out_h, out_w, pad_h, pad_w = _mma_geometry(h, w)
    plan = conv_cuda.gradw_mma_plan(2, h, w, c, x_chw, chw, 132)
    assert args[4:] == (2, h, w, out_h, out_w, pad_h, pad_w, plan.band_rows,
                        plan.bands, plan.images, plan.xo, plan.xrs,
                        plan.xplane, plan.ximg, plan.x_elems, plan.gps,
                        plan.g_elems, plan.pix, plan.stage_elems, plan.stages,
                        plan.smem_bytes, int(x_chw), int(chw), plan.units,
                        plan.blocks, 7)
    grown = {k: v - before[k] for k, v in conv_cuda.LAUNCHES.items()
             if v != before[k]}
    assert grown == {entry[len("sat_"):].replace("conv_gradw",
                                                 "stem_gradw"): 1}


@pytest.mark.parametrize("layout", ["hwc", "chw"])
def test_c1_geometry_takes_its_band_kernel_on_the_card(monkeypatch, layout):
    """float32 one-channel frames launch the band kernel built for C = 1
    (GRADW_GROUPS[1] row groups) with its plan, counted as
    ``stem_gradw_c1``."""
    library = _kernel_route(monkeypatch)
    x, g = (torch.tensor(a) for a in _case(8, 2, 72, 96, 1, 32, 4))
    x, g = _layouts(x, g)[layout]
    before = dict(conv_cuda.LAUNCHES)
    conv_cuda.conv_gradw(x, g, 8, 4)
    (name, args), = library.calls
    assert name == "sat_conv_gradw_c1"
    chw = layout == "chw"
    plan = conv_cuda.gradw_plan(2, 18, 24, False, chw, 132, 1)
    assert args[4:] == (72, 96, 18, 24, 2, 2, plan.band_rows, plan.bands,
                        plan.xrs, plan.x_floats, plan.gps,
                        plan.stage_floats, plan.smem_bytes, 0, int(chw),
                        plan.units, plan.blocks, 7)
    grown = {k: v - before[k] for k, v in conv_cuda.LAUNCHES.items()
             if v != before[k]}
    assert grown == {"stem_gradw_c1": 1}


@pytest.mark.parametrize("dtype,suffix", [(torch.float32, ""),
                                          (torch.bfloat16, "_bf16")])
@pytest.mark.parametrize("layout", ["hwc", "chw"])
def test_resnet_c4_geometry_takes_its_kernel_on_the_card(monkeypatch, dtype,
                                                         suffix, layout):
    """(3, 1, 4, 16) launches the ResNet stem kernel built for C = 4 of
    the operand type with its plan (``resnet_gradw_plan(...,
    channels=4)``), counted as ``resnet_stem_gradw_c4[_bf16]``."""
    library = _kernel_route(monkeypatch)
    x, g = (torch.tensor(a).to(dtype)
            for a in _case(6, 2, 84, 84, 4, 16, 1))
    x, g = _layouts(x, g)[layout]
    before = dict(conv_cuda.LAUNCHES)
    conv_cuda.conv_gradw(x, g, 3, 1)
    (name, args), = library.calls
    assert name == "sat_resnet_stem_gradw_c4" + suffix
    chw = layout == "chw"
    plan = conv_cuda.resnet_gradw_plan(2, 84, 84, x.element_size(), 132,
                                       chw, chw, 4)
    assert args[4:] == (84, 84, plan.bands, plan.xrs, plan.grs,
                        plan.x_elems, plan.stage_elems, plan.stages,
                        plan.xplane, plan.wp, plan.smem_bytes, int(chw),
                        int(chw), plan.units, plan.blocks, 7)
    grown = {k: v - before[k] for k, v in conv_cuda.LAUNCHES.items()
             if v != before[k]}
    assert grown == {"resnet_stem_gradw_c4" + suffix: 1}


@pytest.mark.parametrize("n,h,w,x_chw,g_chw,sms", [
    (3232, 72, 96, False, False, 132), (3233, 72, 96, False, True, 132),
    (1, 72, 96, False, False, 132), (64, 17, 23, False, True, 132),
    (5, 72, 96, False, False, 7)])
def test_c1_gradw_plan_takes_every_image_band_once_in_order(n, h, w, x_chw,
                                                            g_chw, sms):
    """At C = 1 (six row groups of 64 threads, 4 x 8 accumulators a
    thread): equal bands covering the output rows, every (image, band)
    unit once and in order, two stages within the budget, room for the
    final sum of the other five row groups' [64, 32] tiles, and the bank
    padding of the staged rows."""
    out_h, _ = conv_cuda.same_pads(h, 8, 4)
    out_w, _ = conv_cuda.same_pads(w, 8, 4)
    plan = conv_cuda.gradw_plan(n, out_h, out_w, x_chw, g_chw, sms, 1)
    assert conv_cuda.GRADW_GROUPS[1] == 6
    assert plan.bands * plan.band_rows >= out_h
    assert (plan.bands - 1) * plan.band_rows < out_h
    units = [list(conv_cuda.block_units(plan, b))
             for b in range(plan.blocks)]
    assert [u for block in units for u in block] == list(range(plan.units))
    assert 8 * plan.stage_floats <= conv_cuda.SMEM_BUDGET
    assert plan.smem_bytes >= 4 * 5 * 64 * 32
    assert plan.smem_bytes <= conv_cuda.SMEM_LIMIT
    assert plan.xrs % 32 == 8 and plan.gps % 2 == 1
    assert plan.x_floats % 4 == 0 and plan.stage_floats % 4 == 0


def test_c1_gradw_plan_of_the_gym_path():
    """72x96x1 frames (18x24 outputs): one band of all 18 output rows (76
    input rows), 100 padded columns to a row stride of 104 floats."""
    plan = conv_cuda.gradw_plan(3232, 18, 24, False, False, 132, 1)
    assert (plan.band_rows, plan.bands, plan.units, plan.blocks) == (
        18, 1, 3232, 132)
    assert plan.xrs == 104


@pytest.mark.parametrize("n,h,w,item,sms", [
    (3232, 84, 84, 4, 132), (3232, 84, 84, 2, 132), (3233, 84, 84, 2, 132),
    (64, 17, 23, 2, 132), (1, 84, 84, 4, 132), (5, 16, 16, 2, 7)])
def test_resnet_c4_gradw_plan_fits_and_splits_in_order(n, h, w, item, sms):
    """The ResNet stem's plan at C = 4: every unit once and in order,
    16-byte aligned rows, the stages and the warps' final sums [36, 16]
    within the block; bf16: NHWC x rows 32 (mod 64) and planar rows 8 and
    planes 16 (mod 64) apart, so each of the 16 patch loads of a chunk
    takes one shared-memory wavefront, and at least two stages."""
    rows = conv_cuda.RESNET_ROWS
    layouts = [(False, False)] if item == 4 else LAYOUT_PAIRS
    for x_chw, g_chw in layouts:
        plan = conv_cuda.resnet_gradw_plan(n, h, w, item, sms, x_chw, g_chw,
                                           4)
        assert plan.bands == -(-h // rows) and plan.units == n * plan.bands
        units = [list(conv_cuda.block_units(plan, b))
                 for b in range(plan.blocks)]
        assert [u for block in units for u in block] == list(
            range(plan.units))
        for stride in (plan.xrs, plan.grs, plan.x_elems, plan.stage_elems,
                       plan.xplane):
            assert (stride * item) % 16 == 0
        assert plan.stages * plan.stage_elems * item <= plan.smem_bytes
        assert plan.smem_bytes >= 4 * conv_cuda.RESNET_WARPS * 36 * 16
        assert plan.smem_bytes <= conv_cuda.SMEM_LIMIT
        if item == 4:
            assert plan.xrs >= 4 + 4 * (w + 1) and plan.grs >= 16 * w
            assert (plan.xrs * item) % 128 == 16
            continue
        assert plan.stages >= 2
        xo, px = conv_cuda._resnet_xo(x_chw, 4), (1 if x_chw else 4)
        assert ((xo + px) * item) % 16 == 0
        assert plan.xrs >= xo + px * (plan.wp + 2)
        assert plan.x_elems == (4 * plan.xplane if x_chw
                                else (rows + 2) * plan.xrs)
        worst = max(_bank_wavefronts([2 * (base + a) for a in lane_elems])
                    for base in range(0, 64, 8)
                    for lane_elems in _b_loads(plan, x_chw, 4))
        assert worst == 1


RESNET_C4_CASES = [(1, 20, 36), (2, 17, 23)]


@pytest.mark.parametrize("x_chw,g_chw", LAYOUT_PAIRS)
@pytest.mark.parametrize("n,h,w", RESNET_C4_CASES)
def test_resnet_c4_bf16_fragments_hold_the_right_taps_and_pixels(n, h, w,
                                                                  x_chw,
                                                                  g_chw):
    """As test_resnet_bf16_fragments_hold_the_right_taps_and_pixels at
    C = 4: five n8 tiles, tiles 0-2 kw = j with (kh, c) = (i / 4, i % 4),
    tile 3 kh = 2 at (kw, c) = (i / 4, i % 4), tile 4 kh = kw = 2 at
    c = i < 4; the 4 unused columns hold staged (finite) values."""
    x_id = 1.0 + np.arange(n * h * w * 4, dtype=np.float64).reshape(
        n, h, w, 4)
    g_id = 1.0 + np.arange(n * h * w * 16, dtype=np.float64).reshape(
        n, h, w, 16)
    xp = np.pad(x_id, ((0, 0), (1, 1), (1, 1), (0, 0)))
    seen = []

    def check(img, oh0, warp, cb, a_mat, b_mat):
        oh = oh0 + warp
        ow = 16 * cb + np.arange(16)
        inside = ow < w
        want_a = np.where(inside[None, :],
                          g_id[img, oh, np.minimum(ow, w - 1), :].T, 0.0)
        np.testing.assert_array_equal(a_mat, want_a)
        for col in range(40):
            tap = _column_tap(col // 8, col % 8, 4)
            if tap < 0:
                assert np.isfinite(b_mat[:, col]).all()
                continue
            kh, kw, c = tap // 12, (tap // 4) % 3, tap % 4
            pc = ow + kw
            want = np.where(pc < w + 2,
                            xp[img, oh + kh, np.minimum(pc, w + 1), c], 0.0)
            np.testing.assert_array_equal(b_mat[:, col], want)
        seen.append((img, oh, cb))

    _emulate_resnet_bf16(x_id, g_id, x_chw, g_chw, sm_count=2, check=check)
    wp = -(-w // 16) * 16
    assert sorted(seen) == [(i, oh, cb) for i in range(n) for oh in range(h)
                            for cb in range(wp // 16)]
    assert sorted(_column_tap(j, i, 4) for j in range(5) for i in range(8)
                  if _column_tap(j, i, 4) >= 0) == list(range(36))


@pytest.mark.parametrize("x_chw,g_chw", [(False, False), (True, True)])
def test_resnet_c4_bf16_fragment_sums_match_plain_and_pallas(
        new_geometry_cases, x_chw, g_chw):
    """Those fragments' products summed in the kernel's order against
    conv_gradw_plain and the Pallas kernel at matmul_dtype="bfloat16", on
    bf16-exact 17x23x4 frames."""
    x, g, want = new_geometry_cases[(3, 4, 17, 23)]
    want = want["bfloat16"]
    xb, gb = torch.tensor(x).bfloat16(), torch.tensor(g).bfloat16()
    got = _emulate_resnet_bf16(xb.float().numpy().astype(np.float64),
                               gb.float().numpy().astype(np.float64), x_chw,
                               g_chw, sm_count=2)
    plain = conv_cuda.conv_gradw_plain(xb, gb, 3, 1).numpy()
    for reference in (plain, want):
        np.testing.assert_allclose(got, reference, rtol=2e-5,
                                   atol=2e-6 * np.abs(reference).max())
