"""cv2's `INTER_LINEAR` and `INTER_NEAREST` resize of uint8 images, in
integer torch ops, on the CPU or the card with the same bits.

`resize_u8(img, dsize=None, fx=None, interpolation="linear")` takes the
two call forms of `cv2.resize`, which map pixels differently:

  * `dsize=(w, h)`: the training form (`cv2.resize(img, (int(w*s),
    int(h*s)))`), the scale dsize / ssize;
  * `fx=s` (cv2's `fx=fy=s`): the evaluation form, dsize
    `cvRound(ssize * s)` (round half to even) and the mapping by `s`
    itself.

`img` is an (H, W) or (H, W, C) uint8 tensor; the result has its rank,
dtype and device. The tables (source offsets, weights) are computed on
the host in float64 / float32 as cv2 computes them; the per-pixel work is
integer arithmetic:

  * nearest: `src[min(floor(d * (1 / s)), n - 1)]`;
  * linear: half-pixel centres, each weight `rint(f * 2048)` /
    `rint((1 - f) * 2048)` from the float32 fraction, a left or right
    edge clamped to one source pixel at weight 2048 (rows: both rows
    clamped, the weights kept); the horizontal pass sums in integers, the
    vertical one is `(((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16)
    + 2) >> 2`;
  * linear at exactly 2x down in both axes: cv2's `INTER_AREA` fast path,
    `(sum of the 2x2 block + 2) >> 2`, and at an odd edge the mean of the
    pixels inside the image rounded half to even.
"""

from __future__ import annotations

import numpy as np
import torch

_COEF = 2048  # INTER_RESIZE_COEF_SCALE


def _dsize(shape, dsize, fx):
    """(dst w, dst h, inverse scale x, inverse scale y), as cv2 sets them
    for each call form."""
    h, w = shape
    if dsize is not None:
        dw, dh = int(dsize[0]), int(dsize[1])
        return dw, dh, dw / w, dh / h
    return round(w * fx), round(h * fx), float(fx), float(fx)


def _linear_table(n_in, n_out, inv_scale, clamp):
    """Source offsets and weights of one axis, as cv2's resize computes
    them for `INTER_LINEAR` (float32 fraction, weights over 2048)."""
    d = np.arange(n_out, dtype=np.float64)
    f = ((d + 0.5) * (1.0 / inv_scale) - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp:  # columns: an edge reads one pixel at weight 2048
        edge = (s < 0) | (s >= n_in - 1)
        f[edge] = 0
        s = np.clip(s, 0, n_in - 1)
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF)).astype(np.int32)
    w1 = np.rint(f * np.float32(_COEF)).astype(np.int32)
    return (np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), w0, w1)


def _nearest(img, dw, dh, inv_x, inv_y):
    h, w = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(dw) * (1.0 / inv_x)), w - 1)
    ys = np.minimum(np.floor(np.arange(dh) * (1.0 / inv_y)), h - 1)
    dev = img.device
    out = img.index_select(0, torch.as_tensor(ys.astype(np.int64), device=dev))
    return out.index_select(1, torch.as_tensor(xs.astype(np.int64),
                                               device=dev))


def _linear(img, dw, dh, inv_x, inv_y):
    h, w = img.shape[:2]
    dev = img.device

    def t(a):
        return torch.as_tensor(a, device=dev)

    x0, x1, a0, a1 = (t(a) for a in _linear_table(w, dw, inv_x, True))
    y0, y1, b0, b1 = (t(a) for a in _linear_table(h, dh, inv_y, False))
    src = img.to(torch.int32)
    cols = (src.index_select(1, x0) * a0[:, None]
            + src.index_select(1, x1) * a1[:, None])  # (h, dw, C), < 2^20
    cols >>= 4
    top = cols.index_select(0, y0) * b0[:, None, None]
    top >>= 16
    bot = cols.index_select(0, y1) * b1[:, None, None]
    bot >>= 16
    top += bot
    top += 2
    top >>= 2
    return top.to(torch.uint8)


def _area2(img, dw, dh):
    """cv2's INTER_AREA fast path at scale 2 (`resizeAreaFast`)."""
    h, w, c = img.shape
    ph, pw = 2 * dh - h, 2 * dw - w  # 0 or 1: an odd edge
    src = torch.nn.functional.pad(img.to(torch.int32), (0, 0, 0, pw, 0, ph))
    s = src.reshape(dh, 2, dw, 2, c).sum(dim=(1, 3))
    out = (s + 2) >> 2
    if ph or pw:
        ones = torch.nn.functional.pad(
            torch.ones((h, w), dtype=torch.int32, device=img.device),
            (0, pw, 0, ph))
        n = ones.reshape(dh, 2, dw, 2).sum(dim=(1, 3))[..., None]
        q = s // n
        r2 = 2 * (s - q * n)
        even = q + ((r2 > n) | ((r2 == n) & (q % 2 == 1))).to(torch.int32)
        out = torch.where(n == 4, out, even)
    return out.to(torch.uint8)


def resize_u8(img: torch.Tensor, dsize=None, fx=None,
              interpolation: str = "linear") -> torch.Tensor:
    """`cv2.resize(img, dsize)` or `cv2.resize(img, None, fx=fx, fy=fx)`
    on a uint8 (H, W) or (H, W, C) tensor; `interpolation` is "linear" or
    "nearest"."""
    if img.dtype != torch.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize_u8 takes an (H, W) or (H, W, C) uint8 "
                         f"tensor, not {tuple(img.shape)} {img.dtype}")
    if (dsize is None) == (fx is None):
        raise ValueError("resize_u8 takes dsize or fx, not both")
    if interpolation not in ("linear", "nearest"):
        raise ValueError(f"interpolation {interpolation!r}: linear or "
                         "nearest")
    h, w = img.shape[:2]
    dw, dh, inv_x, inv_y = _dsize((h, w), dsize, fx)
    if dw <= 0 or dh <= 0:
        raise ValueError(f"resize_u8 to {dw}x{dh}: empty")
    if (dw, dh) == (w, h):
        return img.clone()
    if interpolation == "nearest":
        return _nearest(img, dw, dh, inv_x, inv_y)
    img3 = img if img.ndim == 3 else img[..., None]
    eps = np.finfo(np.float64).eps  # cv2's `is_area_fast` at scale 2
    if abs(1.0 / inv_x - 2) < eps and abs(1.0 / inv_y - 2) < eps:
        out = _area2(img3, dw, dh)
    else:
        out = _linear(img3, dw, dh, inv_x, inv_y)
    return out if img.ndim == 3 else out[..., 0]
