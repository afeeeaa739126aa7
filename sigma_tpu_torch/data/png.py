"""PNG reader and writer on the stdlib's `zlib` and numpy: the port reads
and writes its dataset and prediction PNGs without cv2.

`read_png(path, gray=False)` gives what `cv2.imread` gives on the same
file, with the port's channel order:

  * colour (`gray=False`): (H, W, 3) uint8 RGB (cv2's `IMREAD_COLOR`
    array with BGR turned to RGB); a gray file's channel is replicated,
    a palette is expanded, alpha and `tRNS` are dropped;
  * gray (`gray=True`): (H, W) uint8, cv2's `IMREAD_GRAYSCALE`. A colour
    file goes through libpng's own conversion (`png_set_rgb_to_gray`
    with 0.299 / 0.587, which cv2's decoder asks for): the fixed-point
    weights 9797, 19234 and 3737 over 2^15 (their sum: a pixel whose
    three channels are equal keeps its value), truncated at 8 bits and
    rounded at 16. That is not `cvtColor`'s rounding.
  * 16-bit samples keep their high byte (libpng's `png_set_strip_16`),
    after the gray conversion.

Colour types 0, 2, 3, 4 and 6 are read at bit depth 8, and 0, 2, 4 and 6
at 16. Interlaced (Adam7) files, bit depths below 8 and damaged files
raise `ValueError` naming the file; `gAMA`, `sRGB` and other ancillary
chunks are ignored.

The five row filters are undone with numpy. None, Sub and Up rows need
only row operations (a cumulative sum, an add modulo 256). Average and
Paeth predict from the left, upper and upper-left bytes, so they are
undone along anti-diagonals (row + column constant): the image is skewed
so that one diagonal is one column, and H + W vector steps decode every
row at once, each row with its own filter through one table lookup.

`write_png(path, img)` writes (H, W) gray or (H, W, 3) RGB uint8 with
filter 0 on every row and zlib level 6.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# libpng's png_set_rgb_to_gray(png_ptr, 1, 0.299, 0.587) coefficients:
# red and green as fixed point over 2^15, blue the rest
_RC, _GC = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_BC = 32768 - _RC - _GC
_lut = None


def _predict_lut():
    """pred - c for Sub, Up, Average and Paeth, indexed by
    (filter - 1, b - c + 255, a - c + 255), a/b/c the left / up /
    up-left bytes: each predictor is a function of (a - c, b - c)."""
    global _lut
    if _lut is None:
        d = np.arange(-255, 256, dtype=np.int32)
        bc, ac = d[:, None], d[None, :]
        pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(ac + bc)
        paeth = np.where((pa <= pb) & (pa <= pc), ac,
                         np.where(pb <= pc, bc, 0))
        avg = (ac + bc) >> 1  # floor((a + b) / 2) - c
        _lut = np.stack([np.broadcast_to(ac, paeth.shape),
                         np.broadcast_to(bc, paeth.shape),
                         avg, paeth]).astype(np.int32).reshape(-1)
    return _lut


def _unfilter_rows(ft, rows, bpp):
    """None / Sub / Up rows, one numpy step each."""
    h, stride = rows.shape
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        f = ft[r]
        if f == 0:
            out[r] = rows[r]
        elif f == 1:
            np.cumsum(rows[r].reshape(-1, bpp), axis=0, dtype=np.uint8,
                      out=out[r].reshape(-1, bpp))
        else:
            np.add(rows[r], prev, out=out[r])
        prev = out[r]
    return out


def _unfilter_diagonal(ft, rows, bpp):
    """Any mix of the five filters, one numpy step per anti-diagonal."""
    h, stride = rows.shape
    w = stride // bpp
    rows = rows.reshape(h, w, bpp)
    ft = ft.astype(np.int32)
    # a None row is re-coded as Sub (its bytes minus the left ones), so
    # that every row predicts through the table
    none = ft == 0
    if none.any():
        v = rows[none].astype(np.int32)
        v[:, 1:] -= v[:, :-1].copy()
        rows = rows.copy()
        rows[none] = v & 255
        ft[none] = 1
    # T[i + x + 2, i + 1] = pixel (i, x): one anti-diagonal is one
    # contiguous column block; row 0 and the cells left of each row stay
    # 0 (the bytes outside the image)
    skew = np.zeros((h + w + 1, h + 1, bpp), np.int32)
    body = skew[2:, 1:]
    view = np.lib.stride_tricks.as_strided(
        body, shape=(h, w, bpp),
        strides=(body.strides[0] + body.strides[1], body.strides[0],
                 body.strides[2]))
    view[...] = rows
    lut = _predict_lut()
    base = np.repeat(((ft - 1) * 511 * 511 + 255 * 511 + 255)[:, None],
                     bpp, axis=1)
    idx = np.empty((h, bpp), np.int32)
    for c in range(2, h + w + 1):
        lo, hi = max(0, c - 1 - w), min(h, c - 1)  # image rows [lo, hi)
        cur = skew[c, lo + 1:hi + 1]
        ul = skew[c - 2, lo:hi]
        k = idx[:hi - lo]
        np.subtract(skew[c - 1, lo:hi], ul, out=k)  # b - c
        k *= 511
        k += skew[c - 1, lo + 1:hi + 1]  # + a
        k -= ul
        k += base[lo:hi]
        pred = lut.take(k)
        pred += ul
        cur += pred
        cur &= 255
    return view.astype(np.uint8).reshape(h, stride)


def _unfilter(data, h, stride, bpp, path):
    raw = np.frombuffer(data, np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: PNG image data holds {raw.size} bytes, "
                         f"expected {h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    ft, rows = raw[:, 0], raw[:, 1:]
    if ft.max(initial=0) > 4:
        raise ValueError(f"{path}: PNG row filter {int(ft.max())} unknown")
    if np.any(ft >= 3):
        return _unfilter_diagonal(ft, rows, bpp)
    return _unfilter_rows(ft, rows, bpp)


def _chunks(buf, path):
    if buf[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        if pos + 12 + n > len(buf):
            break
        body = buf[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", buf[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: PNG chunk {kind!r} is damaged")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: PNG file ends before IEND")


def read_png(path, gray: bool = False) -> np.ndarray:
    """(H, W, 3) RGB or, with `gray`, (H, W) uint8 from a PNG file, as
    `cv2.imread` with `IMREAD_COLOR` (BGR turned to RGB) or
    `IMREAD_GRAYSCALE` gives it."""
    with open(path, "rb") as f:
        buf = f.read()
    header, palette, idat = None, None, []
    for kind, body in _chunks(buf, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG file has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not read")
    if ctype not in _CHANNELS or depth not in (8, 16) or (
            ctype == 3 and depth != 8):
        raise ValueError(f"{path}: PNG colour type {ctype} at bit depth "
                         f"{depth} is not read")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    try:
        data = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: PNG image data: {e}") from e
    px = _unfilter(data, h, w * bpp, bpp, path).reshape(h, w, ch, depth // 8)
    if depth == 16:  # big-endian samples
        px = px[..., 0].astype(np.int64) << 8 | px[..., 1]
    else:
        px = px[..., 0]
    if ctype == 3:
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: PNG palette index out of range")
        px = palette[px[..., 0]]
    elif ctype in (4, 6):
        px = px[..., :-1]  # alpha dropped
    if px.shape[-1] == 1:
        g = px[..., 0]
        out = g if gray else np.repeat(g[..., None], 3, axis=-1)
    elif gray:
        r, g, b = (px[..., i].astype(np.int64 if depth == 16 else np.int32)
                   for i in range(3))
        mix = r * _RC
        mix += g * _GC
        mix += b * _BC
        if depth == 16:
            mix += 1 << 14
        out = mix >> 15
    else:
        out = px
    if depth == 16:
        out = out >> 8
    return np.ascontiguousarray(out, dtype=np.uint8)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path, img) -> None:
    """Write (H, W) gray or (H, W, 3) RGB uint8 as an 8-bit PNG, filter 0
    on every row."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"{path}: write_png takes (H, W) or (H, W, 3) "
                         f"uint8, not {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + img[0].size), np.uint8)
    rows[:, 1:] = img.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if img.ndim == 2 else 2,
                         0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
