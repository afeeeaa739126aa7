"""VMamba (VSSM) trunk and its blocks (counterpart of
`sigma_tpu/models/vssm.py`), channel-last (B, H, W, C).

  PatchEmbed, PatchMerging2D (v1), VSSBlock, VSSMBackbone and
  VSSMClassifier (per-block modules; the JAX package stacks stages of
  12+ blocks under nn.scan, and utils/convert.py unstacks them),
  ChannelAttention(+Block) and CVSSDecoderBlock.
Training rematerializes each VSSBlock of a stage where `should_remat`
says so (`remat=True` by default in the segmentation trunk, False in the
classifier, as in the JAX package). `dtype` is the compute dtype of the
linears and convolutions (models/common.py): with bf16 the trunk's
residual stream is fp32 in stage 0 (PatchEmbed ends in a LayerNorm) and
bf16 from the first PatchMerging2D on, as JAX's promotion makes it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sigma_tpu_torch.models.common import (
    Conv2d,
    DropPath,
    LayerNorm,
    Linear,
    Mlp,
    conv2d_nhwc,
    maybe_remat,
    should_remat,
)
from sigma_tpu_torch.models.ss2d import SS2D


class _ToChannelLast(nn.Module):
    def forward(self, x):
        return x.permute(0, 2, 3, 1)


class PatchEmbed(nn.Sequential):
    """conv(patch x patch, stride patch) + LayerNorm; the reference's
    Sequential(conv, permute, norm), hence the keys `0.*` and `2.*`.
    Input NHWC, output NHWC."""

    def __init__(self, in_ch, embed_dim, patch_size=4, dtype=torch.float32):
        super().__init__(
            Conv2d(in_ch, embed_dim, patch_size, stride=patch_size,
                   dtype=dtype),
            _ToChannelLast(),
            LayerNorm(embed_dim),
        )

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2))


class PatchMerging2D(nn.Module):
    """v1 downsample: 2x2 space-to-channel + LN(4C) + Linear 4C->out."""

    def __init__(self, dim, out_dim, dtype=torch.float32):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, out_dim, bias=False, dtype=dtype)

    def forward(self, x):
        _, h, w, _ = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class VSSBlock(nn.Module):
    """x + DropPath(SS2D(LN(x))), optional FFN branch (off in Sigma)."""

    def __init__(self, hidden_dim, drop_path=0.0, d_state=16, ssm_ratio=2.0,
                 mlp_ratio=0.0, dtype=torch.float32):
        super().__init__()
        self.norm = LayerNorm(hidden_dim)
        self.op = SS2D(hidden_dim, d_state=d_state, ssm_ratio=ssm_ratio,
                       dtype=dtype)
        self.drop_path = DropPath(drop_path)
        self.mlp = None
        if mlp_ratio > 0:
            self.norm2 = LayerNorm(hidden_dim)
            self.mlp = Mlp(hidden_dim, int(hidden_dim * mlp_ratio),
                           hidden_dim, dtype=dtype)
            # a mask of its own, as the JAX block's second DropPath draws
            self.drop_path2 = DropPath(drop_path)

    def forward(self, x):
        # the sum takes JAX's promotion: fp32 + bf16 is fp32
        x = x + self.drop_path(self.op(self.norm(x)))
        if self.mlp is not None:
            x = x + self.drop_path2(self.mlp(self.norm2(x)))
        return x


class Stage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


def _vss_stages(depths, dims, d_state, ssm_ratio, mlp_ratio,
                drop_path_rate, dtype):
    dpr = np.linspace(0.0, drop_path_rate, sum(depths))
    stages, k = [], 0
    for i, depth in enumerate(depths):
        blocks = [
            VSSBlock(dims[i], float(dpr[k + j]), d_state, ssm_ratio,
                     mlp_ratio, dtype=dtype)
            for j in range(depth)
        ]
        k += depth
        down = (PatchMerging2D(dims[i], dims[i + 1], dtype=dtype)
                if i < len(depths) - 1 else None)
        stages.append(Stage(blocks, down))
    return nn.ModuleList(stages)


class VSSMBackbone(nn.Module):
    """Segmentation VSSM trunk: patch embed + 4 stages of VSSBlocks with v1
    patch-merging downsamples; per-stage `outnorm` LayerNorms; returns the
    4 pre-downsample pyramid features (NHWC)."""

    def __init__(self, depths=(2, 2, 9, 2), dims=(96, 192, 384, 768),
                 d_state=16, ssm_ratio=2.0, mlp_ratio=0.0,
                 drop_path_rate=0.2, remat=True, dtype=torch.float32):
        super().__init__()
        self.remat = remat
        self.patch_embed = PatchEmbed(3, dims[0], dtype=dtype)
        self.layers = _vss_stages(depths, dims, d_state, ssm_ratio,
                                  mlp_ratio, drop_path_rate, dtype)
        for i, dim in enumerate(dims):
            self.add_module(f"outnorm{i}", LayerNorm(dim))

    def forward(self, x):
        x = self.patch_embed(x)
        outs = []
        for i, stage in enumerate(self.layers):
            remat = should_remat(self.remat, x.shape[1] * x.shape[2])
            for blk in stage.blocks:
                x = maybe_remat(blk, remat, x)
            outs.append(getattr(self, f"outnorm{i}")(x))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs


class _ClassifierHead(nn.Module):
    """The reference's `classifier` (norm, permute, pool, flatten, head)."""

    def __init__(self, dim, num_classes, dtype=torch.float32):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.head = Linear(dim, num_classes, dtype=dtype)

    def forward(self, x):
        return self.head(self.norm(x).mean(dim=(1, 2)))


class VSSMClassifier(nn.Module):
    """The VMamba image classifier (the reference's `VSSM`): patch embed,
    4 stages of VSSBlocks with v1 downsamples, then LayerNorm, a global
    mean and a linear head. NHWC images in, (B, num_classes) logits
    out. `remat`: True rematerializes every block in training."""

    def __init__(self, num_classes=1000, depths=(2, 2, 9, 2),
                 dims=(96, 192, 384, 768), d_state=16, ssm_ratio=2.0,
                 mlp_ratio=0.0, drop_path_rate=0.2, remat=False,
                 dtype=torch.float32):
        super().__init__()
        self.remat = remat
        self.patch_embed = PatchEmbed(3, dims[0], dtype=dtype)
        self.layers = _vss_stages(depths, dims, d_state, ssm_ratio,
                                  mlp_ratio, drop_path_rate, dtype)
        self.classifier = _ClassifierHead(dims[-1], num_classes, dtype=dtype)

    def forward(self, x):
        x = self.patch_embed(x)
        for stage in self.layers:
            for blk in stage.blocks:
                x = maybe_remat(blk, self.remat, x)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return self.classifier(x)


class ChannelAttention(nn.Module):
    """avg+max-pool SE over channels, shared 1x1 convs (vmamba.py:1725-1741).
    NCHW, as it sits inside the CAB's conv Sequential."""

    def __init__(self, num_feat, squeeze_factor=16, dtype=torch.float32):
        super().__init__()
        sq = max(1, num_feat // squeeze_factor)
        self.fc = nn.Sequential(
            Conv2d(num_feat, sq, 1, bias=False, dtype=dtype), nn.SiLU(),
            Conv2d(sq, num_feat, 1, bias=False, dtype=dtype),
        )

    def forward(self, x):
        avg = x.mean(dim=(2, 3), keepdim=True)
        mx = x.amax(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc(avg) + self.fc(mx))


class ChannelAttentionBlock(nn.Module):
    """CAB: conv3x3 compress + GELU + conv3x3 + ChannelAttention
    (vmamba.py:1744-1757). NHWC in and out."""

    def __init__(self, num_feat, compress_ratio=3, squeeze_factor=30,
                 dtype=torch.float32):
        super().__init__()
        mid = max(1, num_feat // compress_ratio)
        self.cab = nn.Sequential(
            Conv2d(num_feat, mid, 3, padding=1, dtype=dtype), nn.GELU(),
            Conv2d(mid, num_feat, 3, padding=1, dtype=dtype),
            ChannelAttention(num_feat, squeeze_factor, dtype=dtype),
        )

    def forward(self, x):
        return conv2d_nhwc(self.cab, x)


class CVSSDecoderBlock(nn.Module):
    """Channel-aware VSS decoder block (vmamba.py:1760-1811):
    x*scale1 + DropPath(SS2D(LN1(x))), then CAB(LN2(x)) + x*scale2."""

    def __init__(self, hidden_dim, drop_path=0.0, d_state=4, ssm_ratio=2.0,
                 dtype=torch.float32):
        super().__init__()
        self.scale1 = nn.Parameter(torch.ones(hidden_dim))
        self.scale2 = nn.Parameter(torch.ones(hidden_dim))
        self.norm1 = LayerNorm(hidden_dim)
        self.op = SS2D(hidden_dim, d_state=d_state, ssm_ratio=ssm_ratio,
                       dtype=dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(hidden_dim)
        self.conv_blk = ChannelAttentionBlock(hidden_dim, dtype=dtype)

    def forward(self, x):
        x = x * self.scale1 + self.drop_path(self.op(self.norm1(x)))
        return self.conv_blk(self.norm2(x)) + x * self.scale2
