"""Dual SegFormer (MiT) RGB-X encoder with FRM / FFM fusion (counterpart
of `sigma_tpu/models/mit_encoder.py`), channel-last (B, H, W, C).

Two separate MiT trunks (`trunk` for RGB, `extra_trunk` for modal X);
each stage output of both passes a FeatureRectifyModule, and a
FeatureFusionModule gives the fused pyramid feature. A trunk's
state_dict keys are a released single-trunk SegFormer file's
(`patch_embed{i}.proj`, `block{i}.{j}.attn.{q,kv,proj,sr,norm}`,
`block{i}.{j}.mlp.dwconv.dwconv`, `norm{i}`), so such a file loads into
either trunk by prefix (`utils/convert.py::load_mit_dualpath`).
Its LayerNorms use eps 1e-6 and its GELU is exact, as in JAX; attention
is matmuls and a softmax, as in JAX. `dtype` is the compute dtype
(models/common.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sigma_tpu_torch.models.common import (
    Conv2d,
    DropPath,
    Dropout,
    LayerNorm,
    Linear,
    conv2d_nhwc,
)
from sigma_tpu_torch.models.net_utils import (
    FeatureFusionModule,
    FeatureRectifyModule,
    reference_init,
)

MIT_LN_EPS = 1e-6


class OverlapPatchEmbed(nn.Module):
    """Strided overlapping conv patch embed + LayerNorm."""

    def __init__(self, in_ch, embed_dim, patch_size=7, stride=4,
                 dtype=torch.float32):
        super().__init__()
        self.proj = Conv2d(in_ch, embed_dim, patch_size, stride=stride,
                           padding=patch_size // 2, dtype=dtype)
        self.norm = LayerNorm(embed_dim, eps=MIT_LN_EPS)

    def forward(self, x):
        return self.norm(conv2d_nhwc(self.proj, x))


class DWConv(nn.Module):
    """The reference's wrapper of the 3x3 depthwise conv (its key
    `dwconv.dwconv`)."""

    def __init__(self, dim, dtype=torch.float32):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, groups=dim, dtype=dtype)

    def forward(self, x):
        return conv2d_nhwc(self.dwconv, x)


class MixFFN(nn.Module):
    """fc1, 3x3 depthwise conv, exact GELU, fc2."""

    def __init__(self, dim, hidden, out, dropout=0.0, dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.dwconv = DWConv(hidden, dtype=dtype)
        self.fc2 = Linear(hidden, out, dtype=dtype)
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)

    def forward(self, x):
        x = self.drop1(F.gelu(self.dwconv(self.fc1(x))))
        return self.drop2(self.fc2(x))


class SRAttention(nn.Module):
    """Spatial-reduction attention: keys and values from the map reduced
    by a strided conv (`sr`) + LayerNorm (`norm`) when sr_ratio > 1."""

    def __init__(self, dim, num_heads, sr_ratio=1, qkv_bias=True,
                 attn_drop=0.0, proj_drop=0.0, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.q = Linear(dim, dim, bias=qkv_bias, dtype=dtype)
        self.kv = Linear(dim, 2 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.sr = self.norm = None
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, stride=sr_ratio, dtype=dtype)
            self.norm = LayerNorm(dim, eps=MIT_LN_EPS)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x):
        b, h, w, c = x.shape
        nh = self.num_heads
        hd = c // nh
        q = self.q(x).reshape(b, h * w, nh, hd).transpose(1, 2)
        kv_in = x if self.sr is None else self.norm(conv2d_nhwc(self.sr, x))
        kv = self.kv(kv_in).reshape(b, -1, 2, nh, hd).permute(2, 0, 3, 1, 4)
        attn = torch.softmax(q @ kv[0].transpose(-2, -1) * hd ** -0.5, dim=-1)
        y = self.attn_drop(attn) @ kv[1]
        y = self.proj(y.transpose(1, 2).reshape(b, h, w, c))
        return self.proj_drop(y)


class MiTBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, sr_ratio=1,
                 drop_path=0.0, dropout=0.0, dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=MIT_LN_EPS)
        self.attn = SRAttention(dim, num_heads, sr_ratio, proj_drop=dropout,
                                dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=MIT_LN_EPS)
        self.mlp = MixFFN(dim, int(dim * mlp_ratio), dim, dropout,
                          dtype=dtype)
        self.drop_path = DropPath(drop_path)
        # a mask of its own, as the JAX block's second DropPath draws
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x):
        x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path2(self.mlp(self.norm2(x)))


class MiTTrunk(nn.Module):
    """One MiT pyramid trunk; returns the 4 stage outputs (NHWC)."""

    def __init__(self, embed_dims, depths, num_heads, sr_ratios=(8, 4, 2, 1),
                 mlp_ratios=(4, 4, 4, 4), drop_path_rate=0.1,
                 dtype=torch.float32):
        super().__init__()
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        cur, in_ch = 0, 3
        for i in range(4):
            n = i + 1
            setattr(self, f"patch_embed{n}", OverlapPatchEmbed(
                in_ch, embed_dims[i], patch_size=7 if i == 0 else 3,
                stride=4 if i == 0 else 2, dtype=dtype))
            setattr(self, f"block{n}", nn.ModuleList(
                MiTBlock(embed_dims[i], num_heads[i], mlp_ratios[i],
                         sr_ratios[i], drop_path=float(dpr[cur + j]),
                         dtype=dtype)
                for j in range(depths[i])))
            setattr(self, f"norm{n}", LayerNorm(embed_dims[i],
                                                eps=MIT_LN_EPS))
            cur += depths[i]
            in_ch = embed_dims[i]

    def forward(self, x):
        outs = []
        for n in range(1, 5):
            x = getattr(self, f"patch_embed{n}")(x)
            for blk in getattr(self, f"block{n}"):
                x = blk(x)
            x = getattr(self, f"norm{n}")(x)
            outs.append(x)
        return outs

    def init_weights(self, gen: torch.Generator) -> None:
        reference_init(self, gen)


class DualMiTEncoder(nn.Module):
    """Two MiT trunks + per-stage FRM / FFM fusion."""

    def __init__(self, embed_dims=(64, 128, 320, 512), depths=(3, 4, 6, 3),
                 num_heads=(1, 2, 5, 8), sr_ratios=(8, 4, 2, 1),
                 drop_path_rate=0.1, dtype=torch.float32):
        super().__init__()
        kw = dict(embed_dims=embed_dims, depths=depths, num_heads=num_heads,
                  sr_ratios=sr_ratios, drop_path_rate=drop_path_rate,
                  dtype=dtype)
        self.trunk = MiTTrunk(**kw)
        self.extra_trunk = MiTTrunk(**kw)
        self.frm = nn.ModuleList(FeatureRectifyModule(d, dtype=dtype)
                                 for d in embed_dims)
        self.ffm = nn.ModuleList(
            FeatureFusionModule(d, num_heads=h, dtype=dtype)
            for d, h in zip(embed_dims, num_heads))

    def forward(self, x_rgb, x_e):
        fused = []
        for r, e, frm, ffm in zip(self.trunk(x_rgb), self.extra_trunk(x_e),
                                  self.frm, self.ffm):
            fused.append(ffm(*frm(r, e)))
        return fused

    def init_weights(self, gen: torch.Generator) -> None:
        reference_init(self, gen)


# variants (dual_segformer.py:476-521 of the reference)
MIT_VARIANTS = {
    "mit_b0": dict(embed_dims=(32, 64, 160, 256), depths=(2, 2, 2, 2)),
    "mit_b1": dict(embed_dims=(64, 128, 320, 512), depths=(2, 2, 2, 2)),
    "mit_b2": dict(embed_dims=(64, 128, 320, 512), depths=(3, 4, 6, 3)),
    "mit_b3": dict(embed_dims=(64, 128, 320, 512), depths=(3, 4, 18, 3)),
    "mit_b4": dict(embed_dims=(64, 128, 320, 512), depths=(3, 8, 27, 3)),
    "mit_b5": dict(embed_dims=(64, 128, 320, 512), depths=(3, 6, 40, 3)),
}
