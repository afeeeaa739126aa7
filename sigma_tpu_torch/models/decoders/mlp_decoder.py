"""SegFormer-style all-MLP decode head (counterpart of
`sigma_tpu/models/decoders/mlp_decoder.py`), channel-last: a linear
embedding per level, every level resized to the stride-4 grid, the
levels concatenated in the reference's order [c4, c3, c2, c1], a
bias-free fuse linear, BatchNorm (models/norm.py), ReLU, dropout, the
classifier."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sigma_tpu_torch.models.common import Dropout, Linear, resize_bilinear
from sigma_tpu_torch.models.norm import BatchNorm


class MLPDecoder(nn.Module):
    def __init__(self, in_channels, num_classes, embed_dim=512,
                 dropout_ratio=0.1, dtype=torch.float32):
        super().__init__()
        self.levels = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"linear_c{i + 1}", Linear(c, embed_dim,
                                                     dtype=dtype))
        self.linear_fuse = Linear(self.levels * embed_dim, embed_dim,
                                  bias=False, dtype=dtype)
        self.bn = BatchNorm(embed_dim)
        self.dropout = Dropout(dropout_ratio)
        self.linear_pred = Linear(embed_dim, num_classes, dtype=dtype)

    def forward(self, inputs):
        h, w = inputs[0].shape[1:3]
        embeds = []
        for i, x in enumerate(inputs):
            e = getattr(self, f"linear_c{i + 1}")(x)
            if e.shape[1:3] != (h, w):
                e = resize_bilinear(e, h, w)
            embeds.append(e)
        x = self.linear_fuse(torch.cat(embeds[::-1], dim=-1))
        x = self.dropout(F.relu(self.bn(x)))
        return self.linear_pred(x)
