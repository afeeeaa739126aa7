"""Build and load the Hopper scan kernels (`csrc/*.cu`).

At first use, nvcc compiles each source into a shared library with a plain
C interface (`-gencode arch=compute_90a,code=sm_90a`), one nvcc process per
source, all started together. The libraries are written under
`build/sigma_tpu_torch/` at the root of the checkout (listed in
.gitignore) and named by a hash of their source and flags, so a changed
source rebuilds and an unchanged one is reused. Each is loaded with ctypes.
A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCES = {
    "fwd": _PKG / "csrc" / "scan_g_fwd.cu",
    "bwd": _PKG / "csrc" / "scan_g_bwd.cu",
}
BUILD_DIR = _PKG.parent / "build" / "sigma_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fwd": {
        # u, dt, A, B, C, bias, D, y_accum, y, hck, nck, batch, G, L, dg,
        # N, softplus, reverse, bf16, stream
        "sigma_scan_fwd": [_P] * 10 + [_I] * 9 + [_P],
        # u0, u1, wdt, wb, wc, A, bias, D, ya0, ya1, y0, y1, hck, nck,
        # batch, G, L, dg, N, n_u, softplus, reverse, swap_c, bf16, stream
        "sigma_scan_proj_fwd": [_P] * 13 + [_I] * 11 + [_P],
    },
    "bwd": {
        # u, dt, A, B, C, bias, D, hck, dy, du, dd, dA, dbias, dD, dBp,
        # dCp, batch, G, L, dg, N, nck, softplus, reverse, stream
        "sigma_scan_bwd": [_P] * 16 + [_I] * 8 + [_P],
        # u0, u1, wdt, wb, wc, A, bias, D, hck, dy0, dy1, du0, du1, dd, dA,
        # dbias, dD, dBp, dCp, batch, G, L, dg, N, nck, n_u, softplus,
        # reverse, swap_c, stream
        "sigma_scan_proj_bwd": [_P] * 19 + [_I] * 10 + [_P],
        # u0, u1, du0, du1, dd, dB, dC, wdt, wb, wc, dW, batch, G, L, dg,
        # N, n_u, nsplit, stream
        "sigma_proj_grad": [_P] * 11 + [_I] * 7 + [_P],
    },
}
_ERROR_STRING = {"fwd": "sigma_scan_error_string",
                 "bwd": "sigma_scan_bwd_error_string"}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the Hopper "
            "scan kernels cannot be built"
        )
    return found


def _target(source: Path) -> Path:
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


@functools.cache
def build() -> dict[str, tuple[Path, float, str]]:
    """Compile the sources that are not built yet, in parallel. Returns
    {name: (library path, seconds its nvcc took — 0.0 when it was already
    built, nvcc's output)}."""
    out, procs = {}, {}
    for name, source in SOURCES.items():
        lib = _target(source)
        if lib.exists():
            log = lib.with_suffix(".log")
            out[name] = (lib, 0.0, log.read_text() if log.exists() else "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        procs[name] = (lib, tmp, cmd, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, cmd, t0, proc) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
        out[name] = (lib, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name` ("fwd" or "bwd"), built at first
    call."""
    path, _, _ = build()[name]
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    err = getattr(lib, _ERROR_STRING[name])
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str, name: str = "fwd") -> None:
    """Raise if a launch from library `name` returned a non-zero code."""
    if code != 0:
        msg = getattr(library(name), _ERROR_STRING[name])(code).decode()
        raise RuntimeError(f"{what} launch failed ({code}): {msg}")
