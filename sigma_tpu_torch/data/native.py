"""The native augmentation tail of the port: `csrc/augment.cpp` (a copy of
the JAX package's `sigma_tpu/data/native/augment.cpp`) loaded with
ctypes, the counterpart of `sigma_tpu/data/native/__init__.py`.

`fused_image_aug` / `fused_label_aug` run the post-resize tail of the
train augmentation (mirror -> normalize -> crop -> center-pad) as one
C++ pass per output pixel, OpenMP across rows; ctypes releases the GIL
for the call, so the loader's threads run in parallel. `TrainPre` takes
it with `use_native=True` (its default) whenever `device_norm` is off.

The library is compiled with g++ at first use into
`build/sigma_tpu_torch/` (listed in .gitignore) with the JAX package's
flags, `-O3 -march=native -fopenmp -shared -fPIC`, and without
`-fopenmp` where the compiler has no OpenMP; it is named by a hash of the
source and the flags, so an edit rebuilds. `-march=native` ties the
library to the host's CPU: a build directory is not to be carried to
another machine. Unlike the JAX package, which returns to numpy when no
compiler is found, a failed build raises, naming the compiler and the
source; `TrainPre(use_native=False)` is the explicit numpy path. The JAX
package's SIGMA_TPU_DISABLE_NATIVE and SIGMA_TPU_NATIVE_CACHE are not
read.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from sigma_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "augment.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
_BUILD_LOCK = threading.Lock()


def _target(flags) -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{SOURCE.stem}_{digest}.so"


@functools.cache
def _library() -> ctypes.CDLL:
    """The shared library, built at first use (with OpenMP where the
    compiler has it)."""
    variants = (CXX_FLAGS, tuple(f for f in CXX_FLAGS if f != "-fopenmp"))
    with _BUILD_LOCK:
        lib = next((t for t in map(_target, variants) if t.exists()), None)
        if lib is None:
            cxx = shutil.which("g++") or shutil.which("c++")
            if cxx is None:
                raise RuntimeError(
                    f"no C++ compiler (g++, c++) on PATH: {SOURCE.name} "
                    "cannot be built")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            for flags in variants:
                lib = _target(flags)
                tmp = lib.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(
                    [cxx, *flags, "-o", str(tmp), str(SOURCE)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                if proc.returncode == 0:
                    os.replace(tmp, lib)
                    break
                tmp.unlink(missing_ok=True)
            else:
                raise RuntimeError(f"{cxx} failed on {SOURCE}:\n"
                                   f"{proc.stdout}")
        dll = ctypes.CDLL(str(lib))
    i64 = ctypes.c_int64
    dll.fused_image_aug.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64, i64, i64, i64, i64,
        i64, i64, i64, i64, i64, i64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
    ]
    dll.fused_image_aug.restype = None
    dll.fused_label_aug.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64, i64, i64, i64,
        i64, i64, i64, i64, i64, i64, ctypes.c_int32, ctypes.c_int,
    ]
    dll.fused_label_aug.restype = None
    return dll


def fused_image_aug(src_u8, out_hw, crop, pad, copy_hw, mean, std,
                    pad_value: float, mirror: bool):
    """src_u8 (H, W, C) uint8 -> (out_h, out_w, C) float32: the copied
    region (crop (y, x) of the source, `copy_hw` in size, mirrored first
    if asked) at `pad` (top, left) of the output, normalized
    ((x / 255 - mean) / std), `pad_value` elsewhere."""
    lib = _library()
    src = np.ascontiguousarray(src_u8, np.uint8)
    h, w, ch = src.shape
    out = np.empty((out_hw[0], out_hw[1], ch), np.float32)
    mean = np.ascontiguousarray(np.broadcast_to(mean, (ch,)), np.float32)
    std = np.ascontiguousarray(np.broadcast_to(std, (ch,)), np.float32)
    lib.fused_image_aug(
        src.ctypes.data, out.ctypes.data, h, w, ch, out_hw[0], out_hw[1],
        crop[0], crop[1], pad[0], pad[1], copy_hw[0], copy_hw[1],
        mean.ctypes.data, std.ctypes.data, ctypes.c_float(pad_value),
        int(mirror),
    )
    return out


def fused_label_aug(src_u8, out_hw, crop, pad, copy_hw, pad_value: int,
                    mirror: bool):
    """src_u8 (H, W) uint8 -> (out_h, out_w) int32, as `fused_image_aug`
    without the normalization (`pad_value`, 255 = ignore, elsewhere)."""
    lib = _library()
    src = np.ascontiguousarray(src_u8, np.uint8)
    h, w = src.shape
    out = np.empty((out_hw[0], out_hw[1]), np.int32)
    lib.fused_label_aug(
        src.ctypes.data, out.ctypes.data, h, w, out_hw[0], out_hw[1],
        crop[0], crop[1], pad[0], pad[1], copy_hw[0], copy_hw[1],
        np.int32(pad_value), int(mirror),
    )
    return out
