"""UPerNet decode head, PPM + FPN (counterpart of
`sigma_tpu/models/decoders/upernet.py`), channel-last, BatchNorm
(models/norm.py) after every convolution.

Every op is one whose backward is deterministic on the card: the
adaptive pool is means over slices, as the JAX package's is, and the
resizes are products with interpolation matrices (models/common.py),
never `F.adaptive_avg_pool2d` or `F.interpolate`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sigma_tpu_torch.models.common import (
    Conv2d,
    Dropout,
    conv2d_nhwc,
    resize_bilinear,
)
from sigma_tpu_torch.models.norm import BatchNorm


def _bins(n: int, out: int):
    """torch AdaptiveAvgPool's bins of n samples into `out`."""
    return [((i * n) // out, -(-((i + 1) * n) // out)) for i in range(out)]


def adaptive_avg_pool(x, out_size: int):
    """torch AdaptiveAvgPool2d semantics on NHWC: the mean of each bin,
    taken over its rows, then over its columns."""
    _, h, w, _ = x.shape
    rows = torch.stack([x[:, a:b].mean(dim=1) for a, b in _bins(h, out_size)],
                       dim=1)
    return torch.stack([rows[:, :, a:b].mean(dim=2)
                        for a, b in _bins(w, out_size)], dim=2)


class ConvBNReLU(nn.Module):
    """conv (flax "SAME" padding, dilation) -> BatchNorm -> ReLU."""

    def __init__(self, in_ch, features, kernel=3, dilation=1, use_bias=True,
                 dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(in_ch, features, kernel,
                           padding=dilation * (kernel - 1) // 2,
                           dilation=dilation, bias=use_bias, dtype=dtype)
        self.bn = BatchNorm(features)

    def forward(self, x):
        return F.relu(self.bn(conv2d_nhwc(self.conv, x)))


class PPM(nn.Module):
    """Pooling pyramid: per scale, adaptive pool -> 1x1 ConvBNReLU ->
    resize back."""

    def __init__(self, in_ch, pool_scales, channels, dtype=torch.float32):
        super().__init__()
        self.pool_scales = tuple(pool_scales)
        for k in range(len(self.pool_scales)):
            setattr(self, f"scale_{k}",
                    ConvBNReLU(in_ch, channels, kernel=1, dtype=dtype))

    def forward(self, x):
        _, h, w, _ = x.shape
        return [resize_bilinear(
            getattr(self, f"scale_{k}")(adaptive_avg_pool(x, s)), h, w)
            for k, s in enumerate(self.pool_scales)]


class UPerHead(nn.Module):
    def __init__(self, in_channels, num_classes, channels=512,
                 pool_scales=(1, 2, 3, 6), dropout_ratio=0.1,
                 dtype=torch.float32):
        super().__init__()
        n = len(in_channels)
        self.psp = PPM(in_channels[-1], pool_scales, channels, dtype)
        self.bottleneck = ConvBNReLU(
            in_channels[-1] + len(pool_scales) * channels, channels,
            dtype=dtype)
        for i in range(n - 1):
            setattr(self, f"lateral_{i}", ConvBNReLU(
                in_channels[i], channels, kernel=1, dtype=dtype))
            setattr(self, f"fpn_{i}", ConvBNReLU(channels, channels,
                                                 dtype=dtype))
        self.fpn_bottleneck = ConvBNReLU(n * channels, channels, dtype=dtype)
        self.dropout = Dropout(dropout_ratio)
        self.conv_seg = Conv2d(channels, num_classes, 1, dtype=dtype)

    def forward(self, inputs):
        n = len(inputs)
        x = inputs[-1]
        psp = self.bottleneck(torch.cat([x] + self.psp(x), dim=-1))
        laterals = [getattr(self, f"lateral_{i}")(inputs[i])
                    for i in range(n - 1)] + [psp]
        for i in range(n - 1, 0, -1):
            h, w = laterals[i - 1].shape[1:3]
            laterals[i - 1] = laterals[i - 1] + resize_bilinear(
                laterals[i], h, w)
        outs = [getattr(self, f"fpn_{i}")(laterals[i])
                for i in range(n - 1)] + [laterals[-1]]
        h, w = outs[0].shape[1:3]
        outs = [outs[0]] + [resize_bilinear(f, h, w) for f in outs[1:]]
        out = self.dropout(self.fpn_bottleneck(torch.cat(outs, dim=-1)))
        return conv2d_nhwc(self.conv_seg, out)
