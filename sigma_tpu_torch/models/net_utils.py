"""CMX-style fusion modules (FRM / FFM) of the MiT and Swin dual
encoders (counterpart of `sigma_tpu/models/net_utils.py`), channel-last
(B, H, W, C) throughout.

  ChannelWeights / SpatialWeights / FeatureRectifyModule   (FRM)
  CrossAttention (linear cross attention) / CrossPath
  ChannelEmbed / FeatureFusionModule                       (FFM)

`dtype` is the compute dtype of the linears and convolutions
(models/common.py). ChannelEmbed's BatchNorms are `models/norm.py`'s
(flax's arithmetic, global-batch statistics under data parallel).
`reference_init` gives the MiT and Swin encoders the JAX package's
initializers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sigma_tpu_torch.models.common import (
    Conv2d,
    LayerNorm,
    Linear,
    Mlp,
    conv2d_nhwc,
)
from sigma_tpu_torch.models.norm import BatchNorm


def pointwise(conv: Conv2d, x):
    """A 1x1 Conv2d applied to an NHWC tensor: a product over the last
    axis, computed in the conv's dtype."""
    dt = conv.compute_dtype
    return F.linear(x.to(dt), conv.weight.flatten(1).to(dt),
                    None if conv.bias is None else conv.bias.to(dt))


def reference_init(module: nn.Module, gen: torch.Generator) -> None:
    """The JAX package's initializers of the MiT / Swin encoders and
    their fusion modules (CMX's `_init_weights`), drawn from `gen`:
    Linear weights trunc_normal(0.02) and zero biases; convolutions
    normal(0, sqrt(2 / fan_out)), fan_out = kh * kw * out / groups, and
    zero biases; Swin's patch convolution and bias tables
    trunc_normal(0.02). The layers of a `models/common.py::Mlp` (Swin's
    MLP) keep torch's defaults, as the JAX Mlp's torch-style init."""
    def trunc(t):
        nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=gen)

    keep = {id(m) for mlp in module.modules() if isinstance(mlp, Mlp)
            for m in mlp.modules()}
    with torch.no_grad():
        for m in module.modules():
            if id(m) in keep:
                continue
            if isinstance(m, nn.Linear) or getattr(m, "trunc_init", False):
                trunc(m.weight)
            elif isinstance(m, nn.Conv2d):
                kh, kw = m.kernel_size
                fan_out = kh * kw * m.out_channels // m.groups
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                 generator=gen)
            else:
                table = getattr(m, "relative_position_bias_table", None)
                if table is not None:
                    trunc(table)
                continue
            if m.bias is not None:
                m.bias.zero_()


class ChannelWeights(nn.Module):
    def __init__(self, dim, reduction=1, dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.fc1 = Linear(4 * dim, 4 * dim // reduction, dtype=dtype)
        self.fc2 = Linear(4 * dim // reduction, 2 * dim, dtype=dtype)

    def forward(self, x1, x2):
        b = x1.shape[0]
        x = torch.cat([x1, x2], dim=-1)  # (B, H, W, 2C)
        # amax: its gradient splits ties evenly, as jnp.max's does
        y = torch.cat([x.mean(dim=(1, 2)), x.amax(dim=(1, 2))], dim=-1)
        y = self.fc2(F.relu(self.fc1(y)))
        y = torch.sigmoid(y).reshape(b, 2, 1, 1, self.dim)
        return y[:, 0], y[:, 1]  # (B, 1, 1, C) each


class SpatialWeights(nn.Module):
    def __init__(self, dim, reduction=1, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(2 * dim, dim // reduction, 1, dtype=dtype)
        self.conv2 = Conv2d(dim // reduction, 2, 1, dtype=dtype)

    def forward(self, x1, x2):
        x = torch.cat([x1, x2], dim=-1)
        y = torch.sigmoid(pointwise(self.conv2,
                                    F.relu(pointwise(self.conv1, x))))
        return y[..., 0:1], y[..., 1:2]  # (B, H, W, 1) each


class FeatureRectifyModule(nn.Module):
    """FRM: each modality takes the other's channel- and spatial-gated
    features as a residual."""

    def __init__(self, dim, reduction=1, lambda_c=0.5, lambda_s=0.5,
                 dtype=torch.float32):
        super().__init__()
        self.lambda_c, self.lambda_s = lambda_c, lambda_s
        self.channel_weights = ChannelWeights(dim, reduction, dtype=dtype)
        self.spatial_weights = SpatialWeights(dim, reduction, dtype=dtype)

    def forward(self, x1, x2):
        cw0, cw1 = self.channel_weights(x1, x2)
        sw0, sw1 = self.spatial_weights(x1, x2)
        out1 = x1 + self.lambda_c * cw1 * x2 + self.lambda_s * sw1 * x2
        out2 = x2 + self.lambda_c * cw0 * x1 + self.lambda_s * sw0 * x1
        return out1, out2


class CrossAttention(nn.Module):
    """Linear cross attention: per modality a (C/h x C/h) context k^T v,
    softmaxed over its first axis (-2), queried by the OTHER modality.
    Inputs (B, L, C)."""

    def __init__(self, dim, num_heads=8, qkv_bias=False, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.kv1 = Linear(dim, 2 * dim, bias=qkv_bias, dtype=dtype)
        self.kv2 = Linear(dim, 2 * dim, bias=qkv_bias, dtype=dtype)

    def forward(self, x1, x2):
        b, n, c = x1.shape
        h = self.num_heads
        scale = (c // h) ** -0.5

        def heads(t):
            return t.reshape(b, n, h, c // h).transpose(1, 2)

        def ctx(kv):
            k, v = heads(kv[..., :c]), heads(kv[..., c:])
            return torch.softmax(k.transpose(-2, -1) @ v * scale, dim=-2)

        c1, c2 = ctx(self.kv1(x1)), ctx(self.kv2(x2))
        y1, y2 = heads(x1) @ c2, heads(x2) @ c1
        return (y1.transpose(1, 2).reshape(b, n, c),
                y2.transpose(1, 2).reshape(b, n, c))


class CrossPath(nn.Module):
    def __init__(self, dim, reduction=1, num_heads=8, dtype=torch.float32):
        super().__init__()
        half = dim // reduction
        self.half = half
        self.channel_proj1 = Linear(dim, 2 * half, dtype=dtype)
        self.channel_proj2 = Linear(dim, 2 * half, dtype=dtype)
        self.cross_attn = CrossAttention(half, num_heads, dtype=dtype)
        self.end_proj1 = Linear(2 * half, dim, dtype=dtype)
        self.end_proj2 = Linear(2 * half, dim, dtype=dtype)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, x1, x2):
        half = self.half
        p1 = F.relu(self.channel_proj1(x1))
        p2 = F.relu(self.channel_proj2(x2))
        v1, v2 = self.cross_attn(p1[..., half:], p2[..., half:])
        out1 = self.end_proj1(torch.cat([p1[..., :half], v1], -1))
        out2 = self.end_proj2(torch.cat([p2[..., :half], v2], -1))
        return self.norm1(x1 + out1), self.norm2(x2 + out2)


class ChannelEmbed(nn.Module):
    """1x1 residual projection + (1x1, 3x3 depthwise, ReLU, 1x1,
    BatchNorm), summed and normalised by a second BatchNorm."""

    def __init__(self, in_channels, out_channels, reduction=1,
                 dtype=torch.float32):
        super().__init__()
        mid = out_channels // reduction
        self.residual = Conv2d(in_channels, out_channels, 1, bias=False,
                               dtype=dtype)
        self.embed1 = Conv2d(in_channels, mid, 1, dtype=dtype)
        self.embed_dw = Conv2d(mid, mid, 3, padding=1, groups=mid,
                               dtype=dtype)
        self.embed2 = Conv2d(mid, out_channels, 1, dtype=dtype)
        self.embed_bn = BatchNorm(out_channels)
        self.norm = BatchNorm(out_channels)

    def forward(self, x):
        residual = pointwise(self.residual, x)
        y = conv2d_nhwc(self.embed_dw, pointwise(self.embed1, x))
        y = self.embed_bn(pointwise(self.embed2, F.relu(y)))
        return self.norm(residual + y)


class FeatureFusionModule(nn.Module):
    """FFM: the cross linear-attention exchange, then the channel
    embedding of the two modalities concatenated."""

    def __init__(self, dim, reduction=1, num_heads=8, dtype=torch.float32):
        super().__init__()
        self.cross = CrossPath(dim, reduction, num_heads, dtype=dtype)
        self.channel_emb = ChannelEmbed(2 * dim, dim, reduction, dtype=dtype)

    def forward(self, x1, x2):
        b, h, w, c = x1.shape
        s1, s2 = self.cross(x1.reshape(b, h * w, c), x2.reshape(b, h * w, c))
        return self.channel_emb(torch.cat([s1, s2], -1).reshape(b, h, w,
                                                                2 * c))
