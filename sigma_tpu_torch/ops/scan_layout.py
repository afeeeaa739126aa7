"""2-D and multimodal scan-order layout transforms, channel-last: the
counterpart of `sigma_tpu/ops/scan_layout.py` (plain reshape / transpose /
flip; autograd differentiates them, and the adjoint of the expansion is
the merge, which is what the reference's CrossScan / CrossMerge write by
hand).

Images are (B, H, W, C); scan sequences (B, K, L, C). Direction order:
  k=0: row-major H*W      k=1: column-major W*H (transpose)
  k=2: reversed k=0       k=3: reversed k=1
"""

from __future__ import annotations

import torch


def cross_scan(x):
    """(B, H, W, C) -> (B, 4, H*W, C) four scan directions."""
    b, h, w, c = x.shape
    hw = x.reshape(b, h * w, c)
    wh = x.transpose(1, 2).reshape(b, h * w, c)
    fwd = torch.stack([hw, wh], dim=1)  # (B, 2, L, C)
    return torch.cat([fwd, fwd.flip(2)], dim=1)


def cross_merge(ys, h, w):
    """(B, 4, H*W, C) -> (B, H, W, C) inverse-layout sum of 4 directions."""
    b, k, l, c = ys.shape
    if k != 4 or l != h * w:
        raise ValueError(f"bad shape {tuple(ys.shape)} for h={h}, w={w}")
    fwd = ys[:, 0:2] + ys[:, 2:4].flip(2)
    y_hw = fwd[:, 0]
    y_wh = fwd[:, 1].reshape(b, w, h, c).transpose(1, 2).reshape(b, l, c)
    return (y_hw + y_wh).reshape(b, h, w, c)


def cross_scan_multimodal(x_rgb, x_e):
    """(B, H, W, C) x2 -> (B, 2, 2*H*W, C) concat scan + its reverse."""
    b, h, w, c = x_rgb.shape
    seq = torch.cat([x_rgb.reshape(b, h * w, c), x_e.reshape(b, h * w, c)],
                    dim=1)
    return torch.stack([seq, seq.flip(1)], dim=1)


def cross_merge_multimodal(ys):
    """(B, 2, 2L, C) -> ((B, L, C), (B, L, C)) per-modality merged outputs."""
    b, k, l2, c = ys.shape
    if k != 2:
        raise ValueError(f"expected K=2, got {tuple(ys.shape)}")
    l = l2 // 2
    y = ys[:, 0] + ys[:, 1].flip(1)
    return y[:, :l], y[:, l:]


__all__ = [
    "cross_merge",
    "cross_merge_multimodal",
    "cross_scan",
    "cross_scan_multimodal",
]
