"""Mamba (CVSS) UNet-style decoder (counterpart of
`sigma_tpu/models/decoders/mamba_decoder.py`), channel-last.

Skip features arrive as the NHWC pyramid [1/4 .. 1/32]; odd-size skips are
met by resizing the upsampled path to the skip's shape before the add.
The head is the JAX package's fused FinalUpsampleX4: it carries the
LayerNorm statistics through the bilinear upsample and folds the LN affine
into the 1x1 classifier, so the full-resolution work is num_classes + 3
maps instead of C channels; the math is exact. `dtype` is the compute
dtype of the linears and blocks (models/common.py); the head returns its
logits in it, as the JAX head does.

Deep supervision (`deep_supervision`, the JAX decoder's aux heads): a
LayerNorm `norm_ds_i` taps the output of `layers_up_0..2` and a
bias-free 1x1 classifier `output_ds_i` turns it into logits at the input
resolution. JAX resizes the tap x16 / x8 / x4 and then classifies; the
port classifies at the tap's resolution and resizes the class maps,
which is the same linear map (the classifier acts per pixel, the resize
per channel) on num_classes channels instead of C.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sigma_tpu_torch.models.common import (
    LayerNorm,
    Linear,
    maybe_remat,
    resize_bilinear,
    should_remat,
)
from sigma_tpu_torch.models.vssm import CVSSDecoderBlock


class PatchExpand(nn.Module):
    """Linear C->2C then 2x2 pixel shuffle: (B,H,W,C) -> (B,2H,2W,C/2)."""

    def __init__(self, dim, dtype=torch.float32):
        super().__init__()
        self.expand = Linear(dim, 2 * dim, bias=False, dtype=dtype)
        self.norm = LayerNorm(dim // 2)

    def forward(self, x):
        x = self.expand(x)
        b, h, w, c = x.shape
        x = x.reshape(b, h, w, 2, 2, c // 4).permute(0, 1, 3, 2, 4, 5)
        return self.norm(x.reshape(b, 2 * h, 2 * w, c // 4))


class UpsampleExpand(nn.Module):
    """Linear C->C/2 then bilinear 2x: (B,H,W,C) -> (B,2H,2W,C/2)."""

    def __init__(self, dim, dtype=torch.float32):
        super().__init__()
        self.linear = Linear(dim, dim // 2, bias=False, dtype=dtype)
        self.norm = LayerNorm(dim // 2)

    def forward(self, x):
        _, h, w, _ = x.shape
        return self.norm(resize_bilinear(self.linear(x), 2 * h, 2 * w))


def _cshift(m, dr, dc):
    """Edge-clamped shift on axes 1 (rows) and 2 (cols)."""
    if dr == -1:
        m = torch.cat([m[:, :1], m[:, :-1]], dim=1)
    elif dr == 1:
        m = torch.cat([m[:, 1:], m[:, -1:]], dim=1)
    if dc == -1:
        m = torch.cat([m[:, :, :1], m[:, :, :-1]], dim=2)
    elif dc == 1:
        m = torch.cat([m[:, :, 1:], m[:, :, -1:]], dim=2)
    return m


def _up2_second_moment(z):
    """Per-pixel channel mean of (up2x2(z))**2, exactly, without building
    the upsampled tensor: (B, H, W, C) -> (B, 2H, 2W). Each output phase
    is a fixed combination of 13 channel-mean product maps of clamped-
    shifted copies of z (the upsample's edge clamping included)."""

    def mean(a, b):
        return (a.float() * b.float()).mean(dim=-1)

    m0 = mean(z, z)
    zs = {
        (dr, dc): _cshift(z, dr, dc)
        for dr in (-1, 0, 1) for dc in (-1, 0, 1) if (dr, dc) != (0, 0)
    }
    mv = {sa: mean(z, zs[(sa, 0)]) for sa in (-1, 1)}
    mh = {sb: mean(z, zs[(0, sb)]) for sb in (-1, 1)}
    md = {k: mean(z, zs[k]) for k in ((-1, -1), (-1, 1), (1, -1), (1, 1))}
    ma = {(sa, sb): mean(zs[(sa, 0)], zs[(0, sb)])
          for sa in (-1, 1) for sb in (-1, 1)}
    rows = []
    for sa in (-1, 1):  # output row phase a=0 -> taps (i, i-1)
        row = []
        for sb in (-1, 1):
            row.append(
                0.31640625 * m0                        # .5625^2
                + 0.03515625 * _cshift(m0, sa, 0)      # .1875^2
                + 0.03515625 * _cshift(m0, 0, sb)
                + 0.00390625 * _cshift(m0, sa, sb)     # .0625^2
                + 0.2109375 * (mv[sa] + mh[sb])        # 2*.5625*.1875
                + 0.0703125 * (md[(sa, sb)] + ma[(sa, sb)])
                + 0.0234375 * (_cshift(mh[sb], sa, 0)
                               + _cshift(mv[sa], 0, sb))  # 2*.1875*.0625
            )
        rows.append(row)
    top = torch.stack(rows[0], dim=3)  # (B, H, W, b-phase)
    bot = torch.stack(rows[1], dim=3)
    ph = torch.stack([top, bot], dim=2)  # (B, H, a, W, b)
    b, hh, _, ww, _ = ph.shape
    return ph.reshape(b, 2 * hh, 2 * ww)


class FinalUpsampleX4(nn.Module):
    """Two (linear + bilinear 2x) stages at constant C, then LN, fused with
    the 1x1 classifier `w_out` into logits: the channel mean and the
    projection commute with the upsample, LN's affine folds into the
    projection (W' = diag(gamma) W_out), and E[y^2] comes from
    `_up2_second_moment` at half resolution."""

    def __init__(self, dim, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.linear1 = Linear(dim, dim, bias=False, dtype=dtype)
        self.linear2 = Linear(dim, dim, bias=False, dtype=dtype)
        self.norm = LayerNorm(dim)

    def forward(self, x, w_out):
        _, h, w, _ = x.shape
        z = self.linear2(resize_bilinear(self.linear1(x), 2 * h, 2 * w))
        gamma, beta = self.norm.weight, self.norm.bias
        wp = gamma[:, None] * w_out                       # (C, nc) fp32
        wbar = wp.sum(dim=0)                              # (nc,)
        bp = beta @ w_out                                 # (nc,)
        s = resize_bilinear((z @ wp.to(self.compute_dtype)).float(),
                            4 * h, 4 * w)
        mu_z = z.float().mean(dim=-1)                     # (B, 2h, 2w)
        mu = resize_bilinear(mu_z[..., None], 4 * h, 4 * w)[..., 0]
        var = _up2_second_moment(z) - mu * mu
        rs = torch.rsqrt(var + self.norm.eps)
        return (rs[..., None] * (s - mu[..., None] * wbar)
                + bp).to(self.compute_dtype)


class MambaUp(nn.Module):
    """Stack of CVSSDecoderBlocks + optional UpsampleExpand; training
    rematerializes the blocks where `should_remat` says so."""

    def __init__(self, dim, depth, drop_path, d_state=4, ssm_ratio=2.0,
                 upsample=True, remat=True, dtype=torch.float32):
        super().__init__()
        self.remat = remat
        self.blocks = nn.ModuleList(
            CVSSDecoderBlock(dim, float(drop_path[i]), d_state, ssm_ratio,
                             dtype=dtype)
            for i in range(depth)
        )
        self.upsample = UpsampleExpand(dim, dtype) if upsample else None

    def forward(self, x):
        remat = should_remat(self.remat, x.shape[1] * x.shape[2])
        for blk in self.blocks:
            x = maybe_remat(blk, remat, x)
        return x if self.upsample is None else self.upsample(x)


class MambaDecoder(nn.Module):
    """4-level UNet-style decoder over the fused pyramid: NHWC features at
    strides [4, 8, 16, 32] with channels [C, 2C, 4C, 8C] -> logits at
    stride 1 (4x the stride-4 map)."""

    def __init__(self, num_classes, embed_dim=96, depths=(4, 4, 4, 4),
                 d_state=4, ssm_ratio=2.0, drop_path_rate=0.1,
                 deep_supervision=False, remat=True, dtype=torch.float32):
        super().__init__()
        n = len(depths)
        dpr = np.linspace(0.0, drop_path_rate, sum(depths))
        layers = [PatchExpand(embed_dim * 2 ** (n - 1), dtype)]
        for i in range(1, n):
            lvl = n - 1 - i
            layers.append(MambaUp(
                embed_dim * 2 ** lvl, depths[lvl],
                dpr[sum(depths[:lvl]):sum(depths[:lvl + 1])], d_state,
                ssm_ratio, upsample=i < n - 1, remat=remat, dtype=dtype,
            ))
        self.layers_up = nn.ModuleList(layers)
        self.norm_up = LayerNorm(embed_dim)
        self.up = FinalUpsampleX4(embed_dim, dtype)
        self.output = nn.Conv2d(embed_dim, num_classes, 1, bias=False)
        self.deep_supervision = deep_supervision
        self.compute_dtype = dtype
        if deep_supervision:  # taps after layers_up_0 .. n-2
            for i in range(n - 1):
                dim = embed_dim * 2 ** (n - 2 - i)
                setattr(self, f"norm_ds_{i}", LayerNorm(dim))
                setattr(self, f"output_ds_{i}",
                        nn.Conv2d(dim, num_classes, 1, bias=False))

    def forward(self, inputs, aux: bool = False):
        """Logits at 4x the stride-4 map; with `aux` and deep supervision,
        (logits, [the deep-supervision heads' logits]) at 16x, 8x and 4x
        their taps' resolutions."""
        n = len(self.layers_up)
        taps = aux and self.deep_supervision
        ds = []
        y = self.layers_up[0](inputs[n - 1])
        for i in range(1, n):
            if taps:
                ds.append(self._ds_head(i - 1, y))
            skip = inputs[n - 1 - i]
            h, w = skip.shape[1:3]
            if y.shape[1:3] != (h, w):  # odd sizes (PST900)
                y = resize_bilinear(y, h, w)
            y = self.layers_up[i](y + skip)
        w_out = self.output.weight[:, :, 0, 0].t()  # (C, nc)
        logits = self.up(self.norm_up(y), w_out)
        return (logits, ds) if taps else logits

    def _ds_head(self, i, y):
        """Deep-supervision head i on its tap y: LayerNorm, the 1x1
        classifier in the compute dtype, then the x2^(4-i) bilinear
        resize of the class maps in fp32."""
        dt = self.compute_dtype
        w = getattr(self, f"output_ds_{i}").weight[:, :, 0, 0]
        z = F.linear(getattr(self, f"norm_ds_{i}")(y).to(dt), w.to(dt))
        scale = 2 ** (4 - i)
        _, h, wd, _ = z.shape
        return resize_bilinear(z.float(), h * scale, wd * scale).to(dt)
