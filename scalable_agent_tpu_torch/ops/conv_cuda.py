"""Stem-conv weight gradients: hand-written Hopper kernels and their plain
PyTorch version.

The counterpart of ``scalable_agent_tpu/ops/conv_pallas.py``.
``conv_gradw`` keeps the JAX package's public layout (NHWC ``x`` and
``g``, HWIO ``dW``) so the tests compare like with like; ``stem_conv`` is
the torso-facing op in PyTorch's layout (NCHW input, OIHW weight).

Kernels (``csrc/conv.cu``), both replacing ``conv_pallas.py::
_gradw_kernel`` (via ``conv_gradw``), one for each stem geometry the
torsos have; ``conv_gradw`` dispatches on (K, S, C, F):

- ``STEM`` (8x8, stride 4, 3 channels into 32 features; the shallow
  torso's ``conv_0``): ``conv_gradw_band_kernel``, launch counters
  ``LAUNCHES["stem_gradw"]`` and, for its bf16-operand variant,
  ``LAUNCHES["stem_gradw_bf16"]``.  ``STEM_C4`` (the same stem on
  Atari's grayscale stack of 4 frames) is the same kernel built for
  C = 4 (``sat_conv_gradw_c4``, counters ``stem_gradw_c4`` and
  ``stem_gradw_c4_bf16``), with ``GRADW_GROUPS[4]`` row groups.  The float32 kernel is bound by float32
  FMA (17 GFLOP at the main path's shape).  Each block stages bands of
  whole images -- input rows with their halo and the band's cotangent rows
  -- in shared memory with double-buffered ``cp.async`` copies, forms every
  patch value there by space-to-depth addressing, and accumulates 12x8
  register tiles in six row groups (``gradw_plan`` sizes the bands and
  assigns the image bands to blocks).
- ``RESNET_STEM`` (3x3, stride 1, 3 channels into 16 features; the ResNet
  torso's ``downscale_0``): ``resnet_stem_gradw_kernel``, launch counters
  ``LAUNCHES["resnet_stem_gradw"]`` and ``LAUNCHES["resnet_stem_gradw_bf16"]``.
  Its work is bound by the bytes of the full-resolution 16-channel
  cotangent.  Each block stages bands of 8 output rows (x with its halo,
  g) in shared memory.  The float32 body (FFMA) stages them double-buffered
  in one layout and walks each row with a sliding 3x3x3 window, a thread
  holding the 27 patch rows for 4 features.  The bf16 body (tensor cores)
  stages each tensor raw, in its own layout, by ``cp.async`` in a ring of
  up to ``RESNET_STAGES`` bands, and contracts 16 pixels of a row at a time
  with ``mma.sync`` m16n8k16: the 16 features by the 27 taps (padded to
  32), g's fragment by ``ldmatrix``, the patches' by 16-bit loads.
  ``resnet_gradw_plan`` sizes the staged rows and the ring.

Both take x and g as float32 or as bfloat16 (the torso under
``compute_dtype=bfloat16``, ``matmul_dtype="bfloat16"`` in the JAX
package), the bf16 variants reading half the bytes and summing the exact
products in float32; ``dW`` is float32 from both.  Both take ``x`` and
``g`` each either as contiguous NHWC or as an NHWC view of contiguous NCHW
memory (``tensor_layout``); anything else raises, and so does any other
geometry (one-channel frames and the ResNet stem at C = 4 among them:
ROADMAP.md, queue 2).  Both sum their per-block partials in a fixed order: two calls
give bitwise-equal dW.  The source's comments have the designs and PERF.md
their times.

As in ``conv_pallas.py``, a kernel/stride pair with ``K % S != 0`` takes
the library's weight gradient instead (``torch.nn.grad.conv2d_weight``).
Otherwise the wrapper takes the plain version only for CPU tensors; for a
CUDA tensor it launches its kernel or raises.
"""

import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from scalable_agent_tpu_torch.ops import _build

LAUNCHES = {"stem_gradw": 0, "stem_gradw_bf16": 0,
            "stem_gradw_c4": 0, "stem_gradw_c4_bf16": 0,
            "resnet_stem_gradw": 0, "resnet_stem_gradw_bf16": 0}
# (K, S, C, F) that csrc/conv.cu's kernels are built for: the shallow
# torso's stem on RGB frames and on Atari's grayscale stack of 4, and the
# ResNet torso's.
STEM = (8, 4, 3, 32)
STEM_C4 = (8, 4, 4, 32)
RESNET_STEM = (3, 1, 3, 16)
# Per geometry and operand dtype: the C entry point and launch counter.
_VARIANTS = {
    STEM: {torch.float32: ("sat_conv_gradw", "stem_gradw"),
           torch.bfloat16: ("sat_conv_gradw_bf16", "stem_gradw_bf16")},
    STEM_C4: {torch.float32: ("sat_conv_gradw_c4", "stem_gradw_c4"),
              torch.bfloat16: ("sat_conv_gradw_c4_bf16",
                               "stem_gradw_c4_bf16")},
    RESNET_STEM: {
        torch.float32: ("sat_resnet_stem_gradw", "resnet_stem_gradw"),
        torch.bfloat16: ("sat_resnet_stem_gradw_bf16",
                         "resnet_stem_gradw_bf16")},
}
_DTYPES = (torch.float32, torch.bfloat16)

# The stages of the blocks on one SM must fit this (an H100 SM has 228
# KB), and so must the shallow stem's final sum of the other row groups'
# [K*K*C, F] tiles.
SMEM_BUDGET = 200 * 1024
# The shallow stem kernel's row groups at each channel count
# (csrc/conv.cu Band<C, TileChannels<C>::kCT>::kGroups).
GRADW_GROUPS = {3: 6, 4: 3}


def same_pads(size: int, k: int, s: int) -> Tuple[int, Tuple[int, int]]:
    """XLA SAME padding: out = ceil(size/s); lo gets the smaller half."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return out, (total // 2, total - total // 2)


def conv2d_same(x, w, stride: int):
    """NCHW conv with XLA's SAME padding: symmetric pads go to ``conv2d``
    itself, an asymmetric pair is applied with ``F.pad`` first."""
    _, (top, bottom) = same_pads(x.shape[2], w.shape[2], stride)
    _, (left, right) = same_pads(x.shape[3], w.shape[3], stride)
    if top == bottom and left == right:
        return F.conv2d(x, w, None, stride, (top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, None, stride)


def _library_gradw(x, g, k, s):
    """The library weight gradient, HWIO, float32 (the ``K % S != 0``
    route)."""
    _, (top, bottom) = same_pads(x.shape[1], k, s)
    _, (left, right) = same_pads(x.shape[2], k, s)
    xp = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    dw = torch.nn.grad.conv2d_weight(
        xp, (g.shape[-1], x.shape[-1], k, k), g.permute(0, 3, 1, 2), s)
    return dw.permute(2, 3, 1, 0).float().contiguous()


def conv_gradw_plain(x, g, kernel_size: int, stride: int):
    """The plain version: pad, gather the K*K taps, one contraction summed
    in float32.  bf16 x and g are the products' operands exactly (their
    float32 values), as ``conv_pallas.conv_gradw`` rounds its operands at
    ``matmul_dtype="bfloat16"``."""
    x, g = x.float(), g.float()
    k, s = int(kernel_size), int(stride)
    n, height, width, c = x.shape
    _, out_h, out_w, f = g.shape
    _, (top, bottom) = same_pads(height, k, s)
    _, (left, right) = same_pads(width, k, s)
    xp = F.pad(x, (0, 0, left, right, top, bottom))
    taps = [xp[:, kh:kh + (out_h - 1) * s + 1:s,
               kw:kw + (out_w - 1) * s + 1:s, :]
            for kh in range(k) for kw in range(k)]
    # [N, OH, OW, K*K, C] -> rows (n, oh, ow) x columns (kh, kw, c).
    patches = torch.stack(taps, dim=3).reshape(n * out_h * out_w, k * k * c)
    dw = patches.T @ g.reshape(n * out_h * out_w, f)
    return dw.reshape(k, k, c, f)


def tensor_layout(t) -> str:
    """How an [N, H, W, C] tensor lies in memory: ``"hwc"`` when it is
    contiguous NHWC, ``"chw"`` when it is an NHWC view of contiguous NCHW
    memory.  Both keep each image one contiguous span; other strides
    raise."""
    if t.is_contiguous():
        return "hwc"
    if t.permute(0, 3, 1, 2).is_contiguous():
        return "chw"
    raise ValueError(
        f"the grad-W kernel takes contiguous NHWC or an NHWC view of "
        f"contiguous NCHW, got shape {tuple(t.shape)} strides {t.stride()}")


class GradWPlan(NamedTuple):
    """Launch geometry of the grad-W kernel; sizes in float32 elements."""

    band_rows: int     # output rows per band
    bands: int         # bands per image
    xrs: int           # row stride of a staged input band
    x_floats: int      # staged input band
    gps: int           # plane stride of a staged NCHW cotangent band
    stage_floats: int  # one stage: input band + cotangent band
    smem_bytes: int    # dynamic shared memory per block
    units: int         # (image, band) pairs
    blocks: int


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _stage(rows: int, out_w: int, x_chw: bool, g_chw: bool,
           channels: int = 3):
    """(xrs, x_floats, gps, stage_floats) of a band of ``rows`` output rows.
    Row strides are 8 (mod 32) floats, so the 8 patch chunks a warp reads
    fall on distinct banks; the NCHW cotangent's plane stride is odd."""
    k, s, _, f = STEM
    padded_w = (out_w - 1) * s + k
    width = padded_w if x_chw else padded_w * channels
    xrs = width + (8 - width) % 32
    x_floats = _round4(((rows - 1) * s + k) * xrs
                       * (channels if x_chw else 1))
    gps = rows * out_w | 1
    g_floats = _round4(f * gps if g_chw else rows * out_w * f)
    return xrs, x_floats, gps, x_floats + g_floats


def gradw_plan(n: int, out_h: int, out_w: int, x_chw: bool, g_chw: bool,
               sm_count: int, channels: int = 3) -> GradWPlan:
    """Bands: the fewest whose two stages fit ``SMEM_BUDGET``, of equal
    height.  Blocks: one per SM (at most one per unit); block b owns the
    units ``block_units(plan, b)``, in order.  ``channels`` is the
    frames' C (3, or Atari's 4: ``GRADW_GROUPS``)."""
    fits = [r for r in range(1, out_h + 1)
            if 8 * _stage(r, out_w, x_chw, g_chw, channels)[3]
            <= SMEM_BUDGET]
    if not fits:
        raise ValueError(f"a {out_w}-wide output row does not fit the "
                         f"grad-W kernel's shared memory")
    bands = -(-out_h // fits[-1])
    rows = -(-out_h // bands)
    xrs, x_floats, gps, stage = _stage(rows, out_w, x_chw, g_chw, channels)
    units = n * bands
    k, _, _, f = STEM
    reduce_floats = (GRADW_GROUPS[channels] - 1) * k * k * channels * f
    return GradWPlan(rows, bands, xrs, x_floats, gps, stage,
                     4 * max(2 * stage, reduce_floats), units,
                     min(units, sm_count))


def block_units(plan, block: int) -> range:
    """The (image, band) units block ``block`` contracts, in order (unit
    u is image u // bands, band u % bands): csrc/conv.cu's split."""
    return range(block * plan.units // plan.blocks,
                 (block + 1) * plan.units // plan.blocks)


# The ResNet stem kernel's output rows per band and its block's size
# (csrc/conv.cu kResRows, kResWarps); a block's dynamic shared memory
# must fit the H100's 227 KB.
RESNET_ROWS = 8
RESNET_WARPS = 8
SMEM_LIMIT = 227 * 1024
# The bf16 body (csrc/conv.cu res_mma_body): pixels of one mma.sync step,
# to which a staged output row is padded (kResPix); the element of padded
# column 0 in a staged x row, NHWC and planar (kResXoHwc, kResXoChw: the
# data, column 1, then starts 16-byte aligned); its blocks per SM and its
# ring's stages, as many as fit the SM's SMEM_BUDGET up to RESNET_STAGES
# (the kernel takes at most kResMaxStages = 8).  On an H100 two blocks of
# 3 stages read 0.30 ms at the main path's N=3232 where one block of 2, 3,
# 4 or 6 read 0.40-0.42 (PERF.md, section 6).
RESNET_PIXELS = 16
RESNET_XO = {False: 5, True: 7}
RESNET_BLOCKS_PER_SM = 2
RESNET_STAGES = 3


class ResnetGradWPlan(NamedTuple):
    """Launch geometry of the ResNet stem's grad-W kernel; sizes in
    elements of the operand type."""

    bands: int         # bands of RESNET_ROWS output rows per image
    xrs: int           # row stride of a staged input band
    grs: int           # row stride of a staged cotangent band (bf16
                       # planar g: one feature's plane)
    x_elems: int       # staged input band (RESNET_ROWS + 2 rows)
    stage_elems: int   # one stage: input band + cotangent band
    stages: int        # stages of the ring (float32: 2)
    xplane: int        # bf16 planar x: one channel's plane, else 0
    wp: int            # bf16: pixels of a staged output row, else width
    smem_bytes: int    # dynamic shared memory per block
    units: int         # (image, band) pairs
    blocks: int


def _at_least(n: int, residue: int, modulus: int) -> int:
    """The smallest m >= n with m % modulus == residue."""
    return n + (residue - n) % modulus


def resnet_gradw_plan(n: int, height: int, width: int, itemsize: int,
                      sm_count: int, x_chw: bool = False,
                      g_chw: bool = False) -> ResnetGradWPlan:
    """Blocks: one per SM for float32, RESNET_BLOCKS_PER_SM for bf16 (at
    most one per unit); block b owns the units ``block_units(plan, b)``,
    in order.

    float32 (the FFMA body; one layout whatever the tensors'): staged rows
    padded so that the 8 rows a warp reads fall on distinct banks: input
    rows 16 bytes apart (mod 128), cotangent rows 64 bytes apart for its
    16-byte reads (a quarter warp is two rows); an input row's data starts
    16-byte aligned after the 3-element left pad; two stages.

    bf16 (the mma.sync body; each tensor staged in its own layout, ``x_chw``
    and ``g_chw``): output rows padded to ``wp`` pixels, a multiple of
    RESNET_PIXELS.  Strides in elements, chosen for the shared-memory banks
    of the kernel's reads: NHWC x rows 40 (mod 64) apart (its 12 operand
    loads take 1.33 wavefronts on average); planar x rows 8 and planes 24
    (mod 64) apart (one wavefront each); NHWC g rows 32 bytes a pixel,
    whose halves the kernel swaps at pixels with bit 2 set; planar g
    planes 16 bytes (mod 128) apart, so the 8 rows of one ldmatrix fall on
    distinct banks.  Every row starts 16-byte aligned.  As many stages as
    fit the SM's SMEM_BUDGET, up to RESNET_STAGES."""
    k, _, c, f = RESNET_STEM
    bands = -(-height // RESNET_ROWS)
    units = n * bands
    x_rows = RESNET_ROWS + k - 1
    if itemsize == 4:
        xrs = _at_least(4 + c * (width + 1), 4, 32)
        grs = _at_least(f * width, 16, 32)
        x_elems = x_rows * xrs
        stage, stages, xplane, wp = x_elems + RESNET_ROWS * grs, 2, 0, width
        per_sm = 1
    else:
        wp = -(-width // RESNET_PIXELS) * RESNET_PIXELS
        xo = RESNET_XO[x_chw]
        if x_chw:
            xrs = _at_least(xo + wp + 2, 8, 64)
            xplane = _at_least(x_rows * xrs, 24, 64)
            x_elems = c * xplane
        else:
            xrs = _at_least(xo + c * (wp + 2), 40, 64)
            xplane, x_elems = 0, x_rows * xrs
        if g_chw:
            grs = _at_least(RESNET_ROWS * wp, 8, 64)
            stage = x_elems + f * grs
        else:
            grs = f * wp
            stage = x_elems + RESNET_ROWS * grs
        per_sm = RESNET_BLOCKS_PER_SM
        stages = min(RESNET_STAGES,
                     SMEM_BUDGET // (per_sm * stage * itemsize))
    smem = max(stages * stage * itemsize, 4 * RESNET_WARPS * k * k * c * f)
    if stages < 2 or smem > SMEM_LIMIT:
        raise ValueError(f"a {width}-wide frame does not fit the ResNet "
                         f"stem grad-W kernel's shared memory")
    return ResnetGradWPlan(bands, xrs, grs, x_elems, stage, stages, xplane,
                           wp, smem, units, min(units, per_sm * sm_count))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv_gradw(x, g, kernel_size: int, stride: int):
    """Weight gradient of the SAME-padded ``kernel_size``/``stride`` conv:
    x [N,H,W,C], g [N,OH,OW,F], both float32 or both bfloat16 (the
    products' operand type) -> dW [K,K,C,F] float32.  On the CPU any
    strides; on the card each of x and g contiguous NHWC or an NHWC view of
    contiguous NCHW (as the stem's backward hands them over)."""
    k, s = int(kernel_size), int(stride)
    n, height, width, c = x.shape
    if g.shape[0] != n or x.dtype not in _DTYPES or g.dtype != x.dtype:
        raise ValueError(f"need x [N,H,W,C] and g [N,OH,OW,F] both float32 "
                         f"or both bfloat16, got {x.dtype} {tuple(x.shape)} "
                         f"and {g.dtype} {tuple(g.shape)}")
    out_h, (top, _) = same_pads(height, k, s)
    out_w, (left, _) = same_pads(width, k, s)
    if tuple(g.shape[1:3]) != (out_h, out_w):
        raise ValueError(f"g spatial shape {tuple(g.shape[1:3])} is not the "
                         f"SAME output {(out_h, out_w)}")
    if k % s:
        return _library_gradw(x, g, k, s)
    if _build.on_cpu("grad-W", x, g):
        return conv_gradw_plain(x, g, k, s)
    f = g.shape[-1]
    geometry = (k, s, c, f)
    if geometry not in _VARIANTS:
        raise ValueError(f"the grad-W kernels are built for the stems' "
                         f"(K, S, C, F) = {STEM}, {STEM_C4} and "
                         f"{RESNET_STEM}, got {geometry}")
    x_chw = tensor_layout(x) == "chw"
    g_chw = tensor_layout(g) == "chw"
    dw = torch.empty((k, k, c, f), dtype=torch.float32, device=x.device)
    sm_count = _sm_count(x.device.index)
    stream = torch.cuda.current_stream().cuda_stream
    entry, counter = _VARIANTS[geometry][x.dtype]
    fn = getattr(_build.library(), entry)
    if geometry != RESNET_STEM:
        plan = gradw_plan(n, out_h, out_w, x_chw, g_chw, sm_count, c)
        partial = torch.empty((plan.blocks, k * k * c * f),
                              dtype=torch.float32, device=x.device)
        code = fn(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                  dw.data_ptr(), height, width, out_h, out_w, top, left,
                  plan.band_rows, plan.bands, plan.xrs, plan.x_floats,
                  plan.gps, plan.stage_floats, plan.smem_bytes, int(x_chw),
                  int(g_chw), plan.units, plan.blocks, stream)
    else:
        plan = resnet_gradw_plan(n, height, width, x.element_size(),
                                 sm_count, x_chw, g_chw)
        partial = torch.empty((plan.blocks, k * k * c * f),
                              dtype=torch.float32, device=x.device)
        code = fn(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                  dw.data_ptr(), height, width, plan.bands, plan.xrs,
                  plan.grs, plan.x_elems, plan.stage_elems, plan.stages,
                  plan.xplane, plan.wp, plan.smem_bytes, int(x_chw),
                  int(g_chw), plan.units, plan.blocks, stream)
    _build.check(code, f"grad-W kernel {entry}")
    _build.count_launch(LAUNCHES, counter)
    return dw


class _StemConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return conv2d_same(x, w, stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        s = ctx.stride
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # Input gradient: the library's transposed conv.  In the torso
            # the stem's input is the gradient-free frame, so this is
            # never reached there.
            with torch.enable_grad():
                xx = x.detach().requires_grad_(True)
                dx, = torch.autograd.grad(conv2d_same(xx, w, s), xx, g)
        if ctx.needs_input_grad[1]:
            # dW is summed in float32 and rounded to the weight's dtype, as
            # conv_pallas.py's VJP rounds it.
            dw = conv_gradw(x.permute(0, 2, 3, 1), g.permute(0, 2, 3, 1),
                            w.shape[2], s).permute(3, 2, 0, 1).to(w.dtype)
        return dx, dw, None


def stem_conv(x, w, stride: int = 4):
    """SAME-padded conv, x NCHW, w OIHW (square kernel and stride), whose
    weight gradient is the grad-W kernel above.  Numerically the forward
    IS ``conv2d`` with XLA's SAME padding; only d/dW is computed by hand.
    x and w share a dtype, float32 or bfloat16, and so does dW."""
    return _StemConv.apply(x, w, stride)
