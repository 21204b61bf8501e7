"""Stem-conv weight gradient: a hand-written Hopper kernel and its plain
PyTorch version.

The counterpart of ``scalable_agent_tpu/ops/conv_pallas.py``.
``conv_gradw`` keeps the JAX package's public layout (NHWC ``x`` and
``g``, HWIO ``dW``) so the tests compare like with like; ``stem_conv`` is
the torso-facing op in PyTorch's layout (NCHW input, OIHW weight).

Kernel (``csrc/conv.cu``), launch counter ``LAUNCHES["stem_gradw"]``:
replaces ``conv_pallas.py::_gradw_kernel`` (via ``conv_gradw``).  Each
block contracts its own range of the N*OH*OW rows with the im2col gather
done in shared memory, a second pass sums the per-block partials in a
fixed order; see the source's header comment and PERF.md for its bound.

As in ``conv_pallas.py``, a kernel/stride pair with ``K % S != 0`` takes
the library's weight gradient instead (``torch.nn.grad.conv2d_weight``).
Otherwise the wrapper takes the plain version only for CPU tensors; for a
CUDA tensor it launches its kernel or raises.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

from scalable_agent_tpu_torch.ops import _build

LAUNCHES = {"stem_gradw": 0}

# Blocks the grad-W kernel spreads the rows over: about four per SM of an
# H100 (132 SMs), enough to fill the card while the partial sums stay a
# few MB.
_TARGET_BLOCKS = 528


def same_pads(size: int, k: int, s: int) -> Tuple[int, Tuple[int, int]]:
    """XLA SAME padding: out = ceil(size/s); lo gets the smaller half."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return out, (total // 2, total - total // 2)


def conv2d_same(x, w, stride: int, bias=None):
    """NCHW conv with XLA's SAME padding: symmetric pads go to ``conv2d``
    itself, an asymmetric pair is applied with ``F.pad`` first."""
    _, (top, bottom) = same_pads(x.shape[2], w.shape[2], stride)
    _, (left, right) = same_pads(x.shape[3], w.shape[3], stride)
    if top == bottom and left == right:
        return F.conv2d(x, w, bias, stride, (top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, bias, stride)


def _library_gradw(x, g, k, s):
    """The library weight gradient, HWIO (the ``K % S != 0`` route)."""
    _, (top, bottom) = same_pads(x.shape[1], k, s)
    _, (left, right) = same_pads(x.shape[2], k, s)
    xp = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    dw = torch.nn.grad.conv2d_weight(
        xp, (g.shape[-1], x.shape[-1], k, k), g.permute(0, 3, 1, 2), s)
    return dw.permute(2, 3, 1, 0).contiguous()


def conv_gradw_plain(x, g, kernel_size: int, stride: int):
    """The plain version: pad, gather the K*K taps, one contraction."""
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


def conv_gradw(x, g, kernel_size: int, stride: int):
    """Weight gradient of the SAME-padded ``kernel_size``/``stride`` conv:
    x [N,H,W,C], g [N,OH,OW,F] float32 (any strides, e.g. a permuted
    NCHW tensor) -> dW [K,K,C,F] float32."""
    k, s = int(kernel_size), int(stride)
    n, height, width, c = x.shape
    if g.shape[0] != n or x.dtype != torch.float32 or (
            g.dtype != torch.float32):
        raise ValueError(f"need float32 x [N,H,W,C] and g [N,OH,OW,F], got "
                         f"{x.dtype} {tuple(x.shape)} and {g.dtype} "
                         f"{tuple(g.shape)}")
    out_h, _ = same_pads(height, k, s)
    out_w, _ = same_pads(width, k, s)
    if tuple(g.shape[1:3]) != (out_h, out_w):
        raise ValueError(f"g spatial shape {tuple(g.shape[1:3])} is not the "
                         f"SAME output {(out_h, out_w)}")
    if k % s:
        return _library_gradw(x, g, k, s)
    kinds = {x.device.type, g.device.type}
    if kinds == {"cpu"}:
        return conv_gradw_plain(x, g, k, s)
    if kinds != {"cuda"} or x.device != g.device:
        raise ValueError(f"x and g must lie on one CUDA device or both on "
                         f"the CPU, got {x.device} and {g.device}")
    f = g.shape[-1]
    rows = k * k * c
    lib = _build.library()
    threads = lib.sat_conv_gradw_threads()
    tile = lib.sat_conv_gradw_tile_rows()
    if f % 4 or f // 4 > threads:
        raise ValueError(f"the grad-W kernel needs F a multiple of 4 up to "
                         f"{4 * threads}, got {f}")
    per_thread = -(-rows // (threads // (f // 4)))
    if per_thread > lib.sat_conv_gradw_max_rows_per_thread():
        raise ValueError(f"K*K*C={rows} rows at F={f} exceed the grad-W "
                         f"kernel's register tile")
    if tile * (rows + f) * 4 > 227 * 1024:
        raise ValueError(f"K*K*C={rows} at F={f} does not fit the grad-W "
                         f"kernel's shared-memory tile")
    num_rows = n * out_h * out_w
    rows_per_block = -(-num_rows // _TARGET_BLOCKS)
    rows_per_block = -(-rows_per_block // tile) * tile
    num_blocks = -(-num_rows // rows_per_block)
    partial = torch.empty((num_blocks, rows * f), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((k, k, c, f), dtype=torch.float32, device=x.device)
    _, (top, _) = same_pads(height, k, s)
    _, (left, _) = same_pads(width, k, s)
    code = lib.sat_conv_gradw(
        x.data_ptr(), *x.stride(), g.data_ptr(), *g.stride(),
        partial.data_ptr(), dw.data_ptr(), n, height, width, c, out_h, out_w,
        f, k, s, top, left, rows_per_block, num_blocks,
        torch.cuda.current_stream().cuda_stream)
    _build.check(code, "stem grad-W kernel")
    LAUNCHES["stem_gradw"] += 1
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
            dw = conv_gradw(x.permute(0, 2, 3, 1), g.permute(0, 2, 3, 1),
                            w.shape[2], s).permute(3, 2, 0, 1)
        return dx, dw, None


def stem_conv(x, w, stride: int = 4):
    """SAME-padded conv, x NCHW, w OIHW (square kernel and stride), whose
    weight gradient is the grad-W kernel above.  Numerically the forward
    IS ``conv2d`` with XLA's SAME padding; only d/dW is computed by hand."""
    return _StemConv.apply(x, w, stride)
