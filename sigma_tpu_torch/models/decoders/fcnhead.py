"""FCN head: 3x3 ConvBNReLU at in/4 channels, then the 1x1 classifier
(counterpart of `sigma_tpu/models/decoders/fcnhead.py`), channel-last.
The FCN decoder on the 1/32 feature, or the aux head of UPerNet and
DeepLabV3+ on the 1/16 one (models/builder.py)."""

from __future__ import annotations

import torch
from torch import nn

from sigma_tpu_torch.models.common import Conv2d, conv2d_nhwc
from sigma_tpu_torch.models.decoders.upernet import ConvBNReLU


class FCNHead(nn.Module):
    def __init__(self, in_ch, num_classes, channels=None, kernel_size=3,
                 dilation=1, dtype=torch.float32):
        super().__init__()
        channels = channels or in_ch // 4
        self.conv = ConvBNReLU(in_ch, channels, kernel=kernel_size,
                               dilation=dilation, dtype=dtype)
        self.classifier = Conv2d(channels, num_classes, 1, dtype=dtype)

    def forward(self, x):
        return conv2d_nhwc(self.classifier, self.conv(x))
