"""The visual torso of the IMPALA agent.

The counterpart of ``scalable_agent_tpu/models/networks.py::
ShallowConvTorso`` (reference: experiment.py:178-189): (32, 8x8, /4),
(64, 4x4, /2), (128, 3x3, /2) convs, each SAME-padded the XLA way and
ReLU'd, then flatten -> Linear(256) -> ReLU.  The stem conv's weight
gradient is the hand-written kernel (``ops/conv_cuda.stem_conv``).

Layouts follow PyTorch (NCHW activations, OIHW conv weights, [out, in]
linear weights); ``convert.py`` maps the flax tree onto them.  The conv
stack's output is flattened in NHWC order, as the JAX torso flattens, so
``fc`` takes the flax kernel's rows unchanged.  The ResNet torso is not
ported yet (ROADMAP.md, queue 1).

``dtype`` is flax's module dtype, by explicit casts (not autocast, whose
op lists differ between the CPU and CUDA): the frame is normalised in
``dtype``; each conv and ``fc`` casts its input, kernel and bias to
``dtype``, computes in it (float32 accumulation, then one rounding) and
adds the bias after, as flax does; the output is ``dtype``.  Parameters
stay float32.  The stem's grad-W kernel takes its operands at ``dtype``.
"""

import math
from typing import Optional, Sequence

import torch
from torch import nn

from scalable_agent_tpu_torch.ops.conv_cuda import (
    conv2d_same,
    same_pads,
    stem_conv,
)

# (out_channels, kernel, stride) of the three convs.
CONV_STACK = ((32, 8, 4), (64, 4, 2), (128, 3, 2))
TORSO_SIZE = 256


def lecun_normal_(tensor: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None):
    """flax's ``lecun_normal``: a normal truncated to +-2 std, rescaled so
    the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


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
            x = torch.relu(op(x, conv.weight.to(dtype), stride)
                           + conv.bias.to(dtype)[:, None, None])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return torch.relu(dense_apply(self.fc, x, dtype))
