"""DeepLabV3+ decode head: ASPP (rates 12 / 24 / 36 and the image pool)
and the low-level fuse (counterpart of
`sigma_tpu/models/decoders/deeplabv3plus.py`), channel-last, BatchNorm
(models/norm.py) after every convolution. Its resizes align corners, as
the reference's do here and nowhere else."""

from __future__ import annotations

import torch
from torch import nn

from sigma_tpu_torch.models.common import Conv2d, Dropout, conv2d_nhwc
from sigma_tpu_torch.models.decoders.upernet import ConvBNReLU


def _align_corners_weights(n_in: int, n_out: int, device):
    """(n_in, n_out) matrix of corner-aligned linear interpolation: output
    j samples position j (n_in - 1) / (n_out - 1) between its two
    neighbours; one input sample is repeated."""
    if n_in == 1:
        return torch.ones(1, n_out, device=device)
    pos = torch.linspace(0.0, n_in - 1.0, n_out, device=device)
    lo = pos.floor().long().clamp(0, n_in - 2)
    frac = pos - lo
    cols = torch.arange(n_out, device=device)
    wts = torch.zeros(n_in, n_out, device=device)
    wts[lo, cols] = 1.0 - frac
    wts[lo + 1, cols] = frac
    return wts


def resize_bilinear_align_corners(x, h: int, w: int):
    """NHWC bilinear resize with align_corners=True, as products with
    interpolation matrices (so its backward is a product too, with no
    scatter); axes of unchanged size are skipped."""
    _, ih, iw, _ = x.shape
    if ih != h:
        x = torch.einsum("bhwc,hH->bHwc", x,
                         _align_corners_weights(ih, h, x.device).to(x.dtype))
    if iw != w:
        x = torch.einsum("bhwc,wW->bhWc", x,
                         _align_corners_weights(iw, w, x.device).to(x.dtype))
    return x


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 branch, three dilated 3x3
    branches, the image pool, a 1x1 projection, dropout 0.5."""

    def __init__(self, in_ch, atrous_rates=(12, 24, 36), out_channels=256,
                 dtype=torch.float32):
        super().__init__()
        self.b0 = ConvBNReLU(in_ch, out_channels, kernel=1, use_bias=False,
                             dtype=dtype)
        for k, rate in enumerate(atrous_rates):
            setattr(self, f"b{k + 1}", ConvBNReLU(
                in_ch, out_channels, kernel=3, dilation=rate, use_bias=False,
                dtype=dtype))
        self.branches = len(atrous_rates) + 1
        setattr(self, f"b{self.branches}", ConvBNReLU(
            in_ch, out_channels, kernel=1, use_bias=False, dtype=dtype))
        self.project = ConvBNReLU((self.branches + 1) * out_channels,
                                  out_channels, kernel=1, use_bias=False,
                                  dtype=dtype)
        self.dropout = Dropout(0.5)

    def forward(self, x):
        h, w = x.shape[1:3]
        feats = [getattr(self, f"b{k}")(x) for k in range(self.branches)]
        pool = getattr(self, f"b{self.branches}")(
            x.mean(dim=(1, 2), keepdim=True))
        feats.append(resize_bilinear_align_corners(pool, h, w))
        return self.dropout(self.project(torch.cat(feats, dim=-1)))


class DeepLabV3Plus(nn.Module):
    def __init__(self, in_channels, num_classes, low_channels=48,
                 dtype=torch.float32):
        super().__init__()
        self.low_level = ConvBNReLU(in_channels[0], low_channels,
                                    dtype=dtype)
        self.aspp = ASPP(in_channels[-1], dtype=dtype)
        self.block_conv = ConvBNReLU(256 + low_channels, 256, dtype=dtype)
        self.dropout = Dropout(0.1)
        self.classifier = Conv2d(256, num_classes, 1, dtype=dtype)

    def forward(self, inputs):
        c1 = self.low_level(inputs[0])
        c4 = self.aspp(inputs[-1])
        c4 = resize_bilinear_align_corners(c4, *c1.shape[1:3])
        x = self.dropout(self.block_conv(torch.cat([c4, c1], dim=-1)))
        return conv2d_nhwc(self.classifier, x)
