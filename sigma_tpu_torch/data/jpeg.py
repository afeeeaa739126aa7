"""JPEG reader of the port: `cv2.imread`'s arrays without cv2.

`read_jpeg(path, gray)` returns what the JAX package's reader gives
(`sigma_tpu/data/dataset.py`): `cv2.imread(path, IMREAD_COLOR)` in RGB
order, or `IMREAD_GRAYSCALE`, bit for bit, for what libjpeg-turbo decodes
with its default parameters:

  * baseline and extended sequential Huffman JPEG (SOF0 / SOF1) and
    progressive Huffman JPEG (SOF2), 8-bit samples, 1 or 3 components,
    any sampling factors;
  * the colour space guessed as libjpeg's `default_decompress_parms`
    guesses it: a JFIF marker means YCbCr, an Adobe marker's transform 0
    RGB and 1 YCbCr, else component ids 'R', 'G', 'B' mean RGB, else
    YCbCr;
  * a gray read of a colour file is libjpeg's JCS_GRAYSCALE output (the Y
    plane, or Y computed from an RGB file), a colour read of a gray file
    replicates it;
  * the EXIF orientation of the first APP1 segment applied, as
    `cv2.imread` applies it to both reads.

The entropy decode, the ISLOW IDCT, the upsampling and the colour
conversion are `csrc/jpeg_decode.cpp` (host C++, plain C interface),
built with g++ at first use into `build/sigma_tpu_torch/` (listed in
.gitignore) and loaded with ctypes, which releases the GIL for the call,
so the loader's threads decode in parallel. A missing compiler raises.
Arithmetic-coded, lossless, 12-bit and 4-component files raise a
ValueError naming the file (ROADMAP C8), and so does a damaged one, and a
progressive one whose scans stop before its first 10 coefficients are
complete (libjpeg would smooth its blocks).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

from sigma_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "jpeg_decode.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_BUILD_LOCK = threading.Lock()

# SOF markers the port does not decode, and what they are
_UNSUPPORTED_SOF = {
    0xC3: "lossless", 0xC5: "differential sequential",
    0xC6: "differential progressive", 0xC7: "differential lossless",
    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded differential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless",
}


def _unsupported(path, what):
    return ValueError(f"{path}: {what} JPEG is not decoded by the port "
                      "(ROADMAP C8)")


@functools.cache
def _library() -> ctypes.CDLL:
    """The decoder's shared library, compiled at first use (named by a
    hash of the source and the flags, so an edit rebuilds)."""
    with _BUILD_LOCK:
        src = SOURCE.read_bytes()
        digest = hashlib.sha256(
            src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
        lib = BUILD_DIR / f"lib{SOURCE.stem}_{digest}.so"
        if not lib.exists():
            cxx = shutil.which("g++") or shutil.which("c++")
            if cxx is None:
                raise RuntimeError(
                    f"no C++ compiler (g++, c++) on PATH: {SOURCE.name} "
                    "cannot be built")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{cxx} failed on {SOURCE}:\n"
                                   f"{proc.stdout}")
            os.replace(tmp, lib)
        dll = ctypes.CDLL(str(lib))
    fn = dll.sigma_jpeg_decode
    fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_char_p]
    fn.restype = ctypes.c_int
    return dll


def _exif_orientation(seg: bytes) -> int:
    """The orientation tag of an APP1 payload, read as OpenCV's ExifReader
    reads it: the TIFF header 6 bytes in, IFD0's entries in order, the
    first 0x0112 entry's first 16-bit value; 1 where there is none or
    parsing fails before it."""
    tiff = seg[6:]
    try:
        order = {b"II": "<", b"MM": ">"}[tiff[:2]]
        if struct.unpack(order + "H", tiff[2:4])[0] != 42:
            return 1
        ifd = struct.unpack(order + "I", tiff[4:8])[0]
        (count,) = struct.unpack(order + "H", tiff[ifd:ifd + 2])
        for i in range(count):
            off = ifd + 2 + 12 * i
            (tag,) = struct.unpack(order + "H", tiff[off:off + 2])
            if tag == 0x0112:
                return struct.unpack(order + "H", tiff[off + 8:off + 10])[0]
    except (KeyError, struct.error):
        pass
    return 1


def _header(path, data: bytes):
    """(height, width, RGB colour space, EXIF orientation) from the
    markers before the first scan."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file (no SOI marker)")
    pos, n = 2, len(data)
    sof = None
    jfif = adobe = False
    transform = orientation = None
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos + 3 > n:
            raise ValueError(f"{path}: damaged JPEG: no scan (ROADMAP C8)")
        m = data[pos]
        pos += 1
        if m in (0x00, 0x01) or 0xD0 <= m <= 0xD7:
            continue
        if m == 0xD9:
            raise ValueError(f"{path}: damaged JPEG: no scan (ROADMAP C8)")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        if length < 2 or len(seg) != length - 2:
            raise ValueError(f"{path}: damaged JPEG: marker 0x{m:02x} "
                             "runs past the end (ROADMAP C8)")
        pos += length
        if m in _UNSUPPORTED_SOF:
            raise _unsupported(path, _UNSUPPORTED_SOF[m])
        if m == 0xCC:
            raise _unsupported(path, "arithmetic-coded")
        if m in (0xC0, 0xC1, 0xC2):
            if len(seg) < 6:
                raise ValueError(f"{path}: damaged JPEG: short frame "
                                 "header (ROADMAP C8)")
            prec, h, w, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise _unsupported(path, f"{prec}-bit")
            if nc == 4:
                raise _unsupported(path, "4-component (CMYK / YCCK)")
            if nc not in (1, 3) or h == 0 or w == 0:
                raise ValueError(f"{path}: damaged JPEG: {nc} components, "
                                 f"{w}x{h} (ROADMAP C8)")
            ids = tuple(seg[6 + 3 * i] for i in range(nc)
                        if 6 + 3 * i < len(seg))
            sof = (h, w, nc, ids)
        elif m == 0xE0 and len(seg) >= 14 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
            adobe, transform = True, seg[11]
        elif m == 0xE1 and orientation is None:
            orientation = _exif_orientation(seg)
        elif m == 0xDA:
            break
    if sof is None:
        raise ValueError(f"{path}: damaged JPEG: no frame header before "
                         "the scan (ROADMAP C8)")
    h, w, nc, ids = sof
    if nc == 1 or jfif:
        rgb = False
    elif adobe:
        rgb = transform == 0
    else:
        rgb = ids == (82, 71, 66)
    return h, w, rgb, orientation or 1


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ApplyExifOrientation (values 2-8; anything else leaves
    the image as it is)."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if orientation in (2, 6):
        img = img[:, ::-1]
    elif orientation in (3, 7):
        img = img[::-1, ::-1]
    elif orientation in (4, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def read_jpeg(path, gray: bool = False) -> np.ndarray:
    """(H, W, 3) RGB or (H, W) uint8, as `cv2.imread` gives it."""
    with open(path, "rb") as f:
        data = f.read()
    h, w, rgb, orientation = _header(path, data)
    out = np.empty((h, w) if gray else (h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    code = _library().sigma_jpeg_decode(
        data, len(data), int(gray), int(rgb), out.ctypes.data, h, w, err)
    if code != 0:
        raise ValueError(f"{path}: damaged JPEG: {err.value.decode()} "
                         "(ROADMAP C8)")
    return _orient(out, orientation)
