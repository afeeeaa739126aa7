"""Dual Swin-Transformer RGB-X encoder with FRM / FFM fusion (counterpart
of `sigma_tpu/models/swin_encoder.py`), channel-last (B, H, W, C).

Two Swin trunks run interleaved: per stage both modalities run their
blocks, a FeatureRectifyModule rectifies both (the rectified features
also feed the next stage's downsample), and the per-stage norms + a
FeatureFusionModule give the fused output. Shifted-window attention with
a relative position bias, cyclic shifts by torch.roll and an additive
-100 mask; a map whose smaller side is at most the window keeps the full
window (zero-padded) and drops the shift, as in JAX.

State-dict keys: a trunk's are a released single-trunk Swin file's
(`patch_embed.{proj,norm}`, `layers.{i}.blocks.{j}.attn.{qkv,proj,
relative_position_bias_table}`, `layers.{i}.downsample.{norm,
reduction}`), the modal-X path's the same under `patch_embed_d` /
`layers_d` (utils/convert.py::load_swin_dualpath).

Two choices keep the train step deterministic on the card and the same
under data parallel:
  * the bias gather `table[idx]` is a product with a fixed one-hot
    matrix ((ws^2)^2 x (2 ws - 1)^2, one per window size and device), so
    that its gradient is a matrix product, not a scatter-add of atomics;
  * attention dropout draws its mask on probabilities laid out with the
    sample on axis 0 (models/common.py::Dropout), one mask per (seed,
    step, module, global sample).
"""

from __future__ import annotations

import functools

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
    Mlp,
    conv2d_nhwc,
)
from sigma_tpu_torch.models.net_utils import (
    FeatureFusionModule,
    FeatureRectifyModule,
    reference_init,
)
from sigma_tpu_torch.models.vssm import PatchMerging2D, Stage


def window_partition(x, ws: int):
    """(B, H, W, C) -> (B*nW, ws*ws, C); H, W divisible by ws."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).transpose(2, 3)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows, ws: int, b: int, h: int, w: int):
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1).transpose(2, 3)
    return x.reshape(b, h, w, -1)


def _relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws): the bias-table row of each (query, key) pair."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + (ws - 1)
    return rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]


def _shift_attn_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """Additive mask (nW, ws*ws, ws*ws) of shifted windows on an hp x wp
    grid: -100 between pixels of different regions, else 0."""
    img = np.zeros((hp, wp), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3) \
        .reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bias_gather(ws: int, device: torch.device) -> torch.Tensor:
    """The one-hot matrix (ws^4, (2 ws - 1)^2) whose product with the
    bias table is `table[_relative_position_index(ws)]`."""
    idx = torch.from_numpy(_relative_position_index(ws).reshape(-1))
    # made outside inference mode: a training forward saves it
    with torch.inference_mode(False):
        return F.one_hot(idx, (2 * ws - 1) ** 2).float().to(device)


@functools.lru_cache(maxsize=None)
def _mask(hp: int, wp: int, ws: int, shift: int,
          device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(_shift_attn_mask(hp, wp, ws, shift)).to(
            device)


class WindowAttention(nn.Module):
    """Multi-head self attention within windows, with a relative position
    bias table ((2 ws - 1)^2, heads)."""

    def __init__(self, dim, num_heads, window_size, qkv_bias=True,
                 attn_drop=0.0, proj_drop=0.0, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = Linear(dim, dim, dtype=dtype)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x, mask=None, batch: int = 1):
        """x: (batch * nW, N, C) windows of `batch` samples; mask: (nW,
        N, N) or None."""
        bnw, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(bnw, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * (c // h) ** -0.5) @ k.transpose(-2, -1)
        gather = _bias_gather(self.window_size, x.device)
        bias = (gather @ self.relative_position_bias_table).reshape(n, n, h)
        attn = attn + bias.permute(2, 0, 1)  # promotes as JAX: bf16 + f32
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bnw // nw, nw, h, n, n)
                    + mask[None, :, None]).reshape(bnw, h, n, n)
        attn = torch.softmax(attn, dim=-1)
        attn = self.attn_drop(attn.reshape(batch, -1, n, n)).reshape(
            bnw, h, n, n)
        y = (attn @ v.to(attn.dtype)).transpose(1, 2).reshape(bnw, n, c)
        return self.proj_drop(self.proj(y))


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size=7, shift_size=0,
                 mlp_ratio=4.0, drop_path=0.0, drop=0.0, attn_drop=0.0,
                 dtype=torch.float32):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size,
                                    attn_drop=attn_drop, proj_drop=drop,
                                    dtype=dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop, dtype=dtype)
        self.drop_path = DropPath(drop_path)
        # a mask of its own, as the JAX block's second DropPath draws
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x):
        b, h, w, _ = x.shape
        ws = self.window_size
        # a small map keeps the full window (padded) and drops the shift
        shift = self.shift_size if min(h, w) > ws else 0
        shortcut = x
        x = self.norm1(x)
        pad_b, pad_r = -h % ws, -w % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = _mask(hp, wp, ws, shift, x.device)
        x = self.attn(window_partition(x, ws), mask, b)
        x = window_reverse(x, ws, b, hp, wp)
        if shift:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + self.drop_path(x[:, :h, :w])
        return x + self.drop_path2(self.mlp(self.norm2(x)))


class SwinPatchMerging(PatchMerging2D):
    """2x2 space-to-channel + LayerNorm(4C) + Linear 4C -> 2C (odd sizes
    padded): VMamba's v1 PatchMerging2D at twice the width."""

    def __init__(self, dim, dtype=torch.float32):
        super().__init__(dim, 2 * dim, dtype=dtype)


class SwinPatchEmbed(nn.Module):
    """Patch conv + LayerNorm (JAX's `patch_embed` and `patch_norm`); the
    input is zero-padded to a multiple of the patch."""

    def __init__(self, embed_dim, patch_size=4, dtype=torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size,
                           dtype=dtype)
        self.proj.trunc_init = True  # net_utils.reference_init
        self.norm = LayerNorm(embed_dim)

    def forward(self, x):
        p = self.patch_size
        h, w = x.shape[1:3]
        if h % p or w % p:
            x = F.pad(x, (0, 0, 0, -w % p, 0, -h % p))
        return self.norm(conv2d_nhwc(self.proj, x))


def _stages(embed_dim, depths, num_heads, window_size, mlp_ratio,
            drop_path_rate, attn_drop_rate, dtype):
    dpr = np.linspace(0, drop_path_rate, sum(depths))
    stages, cur, dim = [], 0, embed_dim
    for i, depth in enumerate(depths):
        blocks = [
            SwinBlock(dim, num_heads[i], window_size,
                      shift_size=0 if j % 2 == 0 else window_size // 2,
                      mlp_ratio=mlp_ratio, drop_path=float(dpr[cur + j]),
                      attn_drop=attn_drop_rate, dtype=dtype)
            for j in range(depth)
        ]
        cur += depth
        down = (SwinPatchMerging(dim, dtype=dtype)
                if i < len(depths) - 1 else None)
        stages.append(Stage(blocks, down))
        dim *= 2
    return nn.ModuleList(stages)


class SwinTrunk(nn.Module):
    """One Swin pyramid trunk; returns the pre-downsample stage features."""

    def __init__(self, embed_dim=96, depths=(2, 2, 18, 2),
                 num_heads=(3, 6, 12, 24), window_size=7, mlp_ratio=4.0,
                 drop_path_rate=0.1, attn_drop_rate=0.3, patch_size=4,
                 dtype=torch.float32):
        super().__init__()
        self.patch_embed = SwinPatchEmbed(embed_dim, patch_size, dtype=dtype)
        self.layers = _stages(embed_dim, depths, num_heads, window_size,
                              mlp_ratio, drop_path_rate, attn_drop_rate,
                              dtype)

    def forward(self, x):
        x = self.patch_embed(x)
        outs = []
        for stage in self.layers:
            for blk in stage.blocks:
                x = blk(x)
            outs.append(x)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs

    def init_weights(self, gen: torch.Generator) -> None:
        reference_init(self, gen)


class DualSwinEncoder(nn.Module):
    """Two interleaved Swin trunks with per-stage FRM + FFM."""

    def __init__(self, embed_dim=96, depths=(2, 2, 18, 2),
                 num_heads=(3, 6, 12, 24), window_size=7, mlp_ratio=4.0,
                 drop_path_rate=0.1, attn_drop_rate=0.3, patch_size=4,
                 dtype=torch.float32):
        super().__init__()
        kw = (embed_dim, depths, num_heads, window_size, mlp_ratio,
              drop_path_rate, attn_drop_rate, dtype)
        self.patch_embed = SwinPatchEmbed(embed_dim, patch_size, dtype=dtype)
        self.patch_embed_d = SwinPatchEmbed(embed_dim, patch_size,
                                            dtype=dtype)
        self.layers = _stages(*kw)
        self.layers_d = _stages(*kw)
        dims = [embed_dim * 2 ** i for i in range(len(depths))]
        self.frm = nn.ModuleList(FeatureRectifyModule(d, dtype=dtype)
                                 for d in dims)
        for i, d in enumerate(dims):
            self.add_module(f"norm{i}", LayerNorm(d))
            self.add_module(f"norm_d{i}", LayerNorm(d))
        self.ffm = nn.ModuleList(
            FeatureFusionModule(d, num_heads=h, dtype=dtype)
            for d, h in zip(dims, num_heads))

    def forward(self, x_rgb, x_e):
        x, xd = self.patch_embed(x_rgb), self.patch_embed_d(x_e)
        outs = []
        for i, (stage, stage_d) in enumerate(zip(self.layers,
                                                 self.layers_d)):
            for blk, blk_d in zip(stage.blocks, stage_d.blocks):
                x, xd = blk(x), blk_d(xd)
            # rectified: feeds both the output and the next stage
            x, xd = self.frm[i](x, xd)
            outs.append(self.ffm[i](getattr(self, f"norm{i}")(x),
                                    getattr(self, f"norm_d{i}")(xd)))
            if stage.downsample is not None:
                x, xd = stage.downsample(x), stage_d.downsample(xd)
        return outs

    def init_weights(self, gen: torch.Generator) -> None:
        reference_init(self, gen)


SWIN_VARIANTS = {
    "swin_s": dict(
        embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24),
        window_size=7,
    ),
    "swin_b": dict(
        embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
        window_size=12,
    ),
}
