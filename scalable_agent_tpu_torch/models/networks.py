"""The visual torsos of the IMPALA agent.

The counterparts of ``scalable_agent_tpu/models/networks.py``:

- ``ShallowConvTorso`` (reference: experiment.py:178-189): (32, 8x8, /4),
  (64, 4x4, /2), (128, 3x3, /2) convs, each SAME-padded the XLA way and
  ReLU'd, then flatten -> Linear(256) -> ReLU.
- ``ResNetTorso``, the deep IMPALA ResNet (reference: experiment.py:
  156-176): three sections of [conv 3x3 -> SAME max-pool 3x3 / 2 -> two
  residual blocks] with (16, 32, 32) channels, a ReLU, then flatten ->
  Linear(256) -> ReLU.

The stem conv's weight gradient (``conv_0``, ``downscale_0``) is the
hand-written kernel (``ops/conv_cuda.stem_conv``); every other conv is the
library's (``conv2d_same``), as XLA computes them outside any Pallas
kernel in the JAX package.

Layouts follow PyTorch (NCHW activations, OIHW conv weights, [out, in]
linear weights); ``convert.py`` maps the flax tree onto them, module names
included (``downscale_1``, ``residual_1_0.conv_0``, ``fc``).  The last
activations are flattened in NHWC order, as the JAX torsos flatten, so
``fc`` takes the flax kernel's rows unchanged.

``dtype`` is flax's module dtype, by explicit casts (not autocast, whose
op lists differ between the CPU and CUDA): the frame is normalised in
``dtype``; each conv and ``fc`` casts its input, kernel and bias to
``dtype``, computes in it (float32 accumulation, then one rounding) and
adds the bias after, as flax does; pools, ReLUs and the residual sums run
in ``dtype``; the output is ``dtype``.  Parameters stay float32.  The
stem's grad-W kernel takes its operands at ``dtype``.
"""

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scalable_agent_tpu_torch.ops.conv_cuda import (
    conv2d_same,
    same_pads,
    stem_conv,
)

# (out_channels, kernel, stride) of the shallow torso's three convs.
CONV_STACK = ((32, 8, 4), (64, 4, 2), (128, 3, 2))
# (channels, residual blocks) of the ResNet torso's three sections.
RESNET_STACK = ((16, 2), (32, 2), (32, 2))
TORSO_SIZE = 256


def lecun_normal_(tensor: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None):
    """flax's ``lecun_normal``: a normal truncated to +-2 std, rescaled so
    the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def init_lstm_(wi: torch.Tensor, wh: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> None:
    """flax ``OptimizedLSTMCell``'s initializers, gate by gate, into
    concatenated ``wi [D, 4H]`` and ``wh [H, 4H]`` (gates i, f, g, o):
    lecun_normal input kernels, orthogonal recurrent kernels."""
    in_features, hidden = wi.shape[0], wh.shape[0]
    with torch.no_grad():
        for gate in range(4):
            cols = slice(gate * hidden, (gate + 1) * hidden)
            block = torch.empty(in_features, hidden)
            wi[:, cols] = lecun_normal_(block, in_features, generator)
            block = torch.empty(hidden, hidden)
            wh[:, cols] = nn.init.orthogonal_(block, generator=generator)


def dense(in_features: int, out_features: int,
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """``nn.Linear`` with flax Dense's initializers (lecun_normal kernel,
    zero bias) instead of torch's defaults."""
    layer = torch.nn.utils.skip_init(nn.Linear, in_features, out_features)
    lecun_normal_(layer.weight, in_features, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


def dense_apply(layer: nn.Linear, x: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, kernel and bias cast to ``dtype``;
    the product, then the bias, in ``dtype``."""
    return x.to(dtype) @ layer.weight.to(dtype).t() + layer.bias.to(dtype)


def _conv(in_channels: int, out_channels: int, kernel: int,
          generator: Optional[torch.Generator]) -> nn.Conv2d:
    layer = torch.nn.utils.skip_init(nn.Conv2d, in_channels, out_channels,
                                     kernel)
    lecun_normal_(layer.weight, in_channels * kernel * kernel, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


class ShallowConvTorso(nn.Module):
    """Input uint8 frames [N, H, W, C]; output [N, 256] of ``dtype``."""

    def __init__(self, frame_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        height, width, channels = frame_shape
        layers = []
        for out_channels, kernel, stride in CONV_STACK:
            layers.append(_conv(channels, out_channels, kernel, generator))
            height, _ = same_pads(height, kernel, stride)
            width, _ = same_pads(width, kernel, stride)
            channels = out_channels
        self.conv_0, self.conv_1, self.conv_2 = layers
        self.fc = dense(height * width * channels, TORSO_SIZE, generator)

    def forward(self, frame: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype
        # [0, 1] in dtype, NHWC in memory, seen as NCHW (channels-last).
        x = (frame.to(dtype) / 255.0).permute(0, 3, 1, 2)
        for i, (conv, (_, _, stride)) in enumerate(zip(
                (self.conv_0, self.conv_1, self.conv_2), CONV_STACK)):
            op = stem_conv if i == 0 else conv2d_same
            x = torch.relu(_conv_apply(conv, x, dtype, op, stride))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return torch.relu(dense_apply(self.fc, x, dtype))


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax ``max_pool(x, (3, 3), strides=(2, 2), padding="SAME")`` on NCHW
    ``x``: XLA's SAME pads (the low side the smaller half: (0, 1) at an even
    size, (1, 1) at an odd one) filled with -inf, then a 3x3 / 2 pool with
    no padding of its own (``max_pool2d``'s symmetric padding would shift
    every window at an even size)."""
    _, (top, bottom) = same_pads(x.shape[2], 3, 2)
    _, (left, right) = same_pads(x.shape[3], 3, 2)
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


class _ResidualBlock(nn.Module):
    """relu -> conv_0 -> relu -> conv_1, plus the block's input (taken
    before the first relu), all 3x3 SAME at ``dtype``."""

    def __init__(self, channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_0 = _conv(channels, channels, 3, generator)
        self.conv_1 = _conv(channels, channels, 3, generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = x
        for conv in (self.conv_0, self.conv_1):
            y = _conv_apply(conv, torch.relu(y), dtype, conv2d_same, 1)
        return y + x


def _conv_apply(conv: nn.Conv2d, x, dtype, op, stride):
    """flax ``Conv(dtype=dtype)``: kernel and bias cast to ``dtype``, the
    conv, then the bias."""
    return (op(x, conv.weight.to(dtype), stride)
            + conv.bias.to(dtype)[:, None, None])


class ResNetTorso(nn.Module):
    """Input uint8 frames [N, H, W, C]; output [N, 256] of ``dtype``."""

    def __init__(self, frame_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        channels = frame_shape[2]
        for i, (out_channels, blocks) in enumerate(RESNET_STACK):
            self.add_module(f"downscale_{i}",
                            _conv(channels, out_channels, 3, generator))
            for j in range(blocks):
                self.add_module(f"residual_{i}_{j}",
                                _ResidualBlock(out_channels, generator))
            channels = out_channels
        self.fc = dense(conv_shapes("resnet", frame_shape)[1], TORSO_SIZE,
                        generator)

    def forward(self, frame: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype
        # [0, 1] in dtype, NHWC in memory, seen as NCHW (channels-last).
        x = (frame.to(dtype) / 255.0).permute(0, 3, 1, 2)
        for i, (_, blocks) in enumerate(RESNET_STACK):
            x = _conv_apply(getattr(self, f"downscale_{i}"), x, dtype,
                            stem_conv if i == 0 else conv2d_same, 1)
            x = max_pool_same(x)
            for j in range(blocks):
                x = getattr(self, f"residual_{i}_{j}")(x, dtype)
        x = torch.relu(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return torch.relu(dense_apply(self.fc, x, dtype))


TORSOS = {"shallow": ShallowConvTorso, "resnet": ResNetTorso}


class ConvShape(NamedTuple):
    """One conv of a torso at a frame shape: its input and output sizes
    (NHWC) and its kernel."""

    in_height: int
    in_width: int
    in_channels: int
    out_height: int
    out_width: int
    out_channels: int
    kernel: int


def conv_shapes(torso_type: str, frame_shape: Sequence[int]
                ) -> Tuple[List[ConvShape], int]:
    """Every conv of the ``torso_type`` torso on ``frame_shape`` frames, in
    the order the forward runs them (the stem first), and the flattened
    size ``fc`` takes."""
    height, width, channels = frame_shape
    convs = []

    def add(out_channels, kernel, stride):
        nonlocal height, width, channels
        out_h, _ = same_pads(height, kernel, stride)
        out_w, _ = same_pads(width, kernel, stride)
        convs.append(ConvShape(height, width, channels, out_h, out_w,
                               out_channels, kernel))
        height, width, channels = out_h, out_w, out_channels

    if torso_type == "shallow":
        for out_channels, kernel, stride in CONV_STACK:
            add(out_channels, kernel, stride)
    elif torso_type == "resnet":
        for out_channels, blocks in RESNET_STACK:
            add(out_channels, 3, 1)
            height, _ = same_pads(height, 3, 2)   # the max-pool
            width, _ = same_pads(width, 3, 2)
            for _ in range(2 * blocks):
                add(out_channels, 3, 1)
    else:
        raise ValueError(f"unknown torso_type {torso_type!r} "
                         f"(choices: {sorted(TORSOS)})")
    return convs, height * width * channels
