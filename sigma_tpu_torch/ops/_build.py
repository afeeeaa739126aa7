"""Build and load the Hopper kernels (`csrc/*.cu`): the grouped scan
kernels, the channel-first scan kernels, the image-layout SS2D scan
kernels and the fused SS2D epilogue.

At first use, nvcc compiles each source into a shared library with a plain
C interface (`-gencode arch=compute_90a,code=sm_90a`), one nvcc process per
source, all started together. The libraries are written under
`build/sigma_tpu_torch/` at the root of the checkout (listed in
.gitignore) and named by a hash of their source, the shared headers
(`csrc/*.cuh`) and the flags, so a changed source rebuilds and an
unchanged one is reused. Each is loaded with ctypes.
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
    "mlg": _PKG / "csrc" / "merge_ln_gate.cu",
    "cf": _PKG / "csrc" / "scan_cf.cu",
    "img": _PKG / "csrc" / "scan_img.cu",
}
BUILD_DIR = _PKG.parent / "build" / "sigma_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "fwd": {
        # u, dt, A, B, C, bias, D, y_accum, y, hloc, sd, n_chunk, hck, nck,
        # batch, G, L, dg, N, softplus, reverse, bf16, stream
        "sigma_scan_fwd": [_P] * 11 + [_I] + [_P] + [_I] * 9 + [_P],
        # u0, u1, wdt, wbc, A, bias, D, ya0, ya1, y0, y1, P, hloc, sd,
        # n_chunk, hck, nck, batch, G, L, dg, N, n_u, softplus, reverse,
        # swap_c, bf16, stream
        "sigma_scan_proj_fwd": [_P] * 14 + [_I] + [_P] + [_I] * 11 + [_P],
    },
    "bwd": {
        # u, dt, A, B, C, bias, D, hck, dy, du, dd, dA, dbias, dD, dBp,
        # dCp, lam, sd, n_chunk, batch, G, L, dg, N, nck, softplus,
        # reverse, bf16, stream
        "sigma_scan_bwd": [_P] * 18 + [_I] * 10 + [_P],
        # u0, u1, wdt, wbc, A, bias, D, hck, dy0, dy1, du0, du1, P, dd,
        # dA, dbias, dD, dBp, dCp, lam, sd, n_chunk, batch, G, L, dg, N,
        # nck, n_u, softplus, reverse, swap_c, bf16, stream
        "sigma_scan_proj_bwd": [_P] * 21 + [_I] * 12 + [_P],
        # u0, u1, du0, du1, dd, dbc, wdt, wbc, dW, batch, G, L, dg, N,
        # n_u, n_l, bf16, stream
        "sigma_proj_grad": [_P] * 9 + [_I] * 8 + [_P],
    },
    "mlg": {
        # yhw, ywh, z, gamma, beta, out, B, H, W, C, ld_hw, ld_wh, ld_z,
        # bf16, eps, stream
        "sigma_mlg_fwd": [_P] * 6 + [_I] * 8 + [_F, _P],
        # yhw, ywh, z, gamma, beta, dout, dyhw, dywh, dz, dgp, dbp, B, H, W,
        # C, ld_hw, ld_wh, ld_z, n_blocks, bf16, eps, stream
        "sigma_mlg_bwd": [_P] * 11 + [_I] * 9 + [_F, _P],
    },
    "cf": {
        # u, d, A, B, C, y, hloc, sd, n_chunk, hck, rows, G, dg, L, N, nck,
        # stream
        "sigma_scan_cf_fwd": [_P] * 8 + [_I] + [_P] + [_I] * 6 + [_P],
        # u, d, A, B, C, hck, dy, du, dd, dA, dBp, dCp, lam, sd, n_chunk,
        # rows, G, dg, L, N, nck, stream
        "sigma_scan_cf_bwd": [_P] * 14 + [_I] * 7 + [_P],
    },
    "img": {
        # x, wdt, wbc, A, bias, D, y4, P, hloc, sd, n_chunk, hck, nck,
        # batch, H, W, dg, N, softplus, bf16, stream
        "sigma_scan_img_fwd": [_P] * 10 + [_I] + [_P] + [_I] * 8 + [_P],
        # x, wdt, wbc, A, bias, D, hck, dy, du4, P, dd, dA, dbias, dD, dBp,
        # dCp, lam, sd, n_chunk, nck, batch, H, W, dg, N, softplus, stream
        "sigma_scan_img_bwd": [_P] * 18 + [_I] * 8 + [_P],
    },
}
_ERROR_STRING = {"fwd": "sigma_scan_error_string",
                 "bwd": "sigma_scan_bwd_error_string",
                 "mlg": "sigma_mlg_error_string",
                 "cf": "sigma_scan_cf_error_string",
                 "img": "sigma_scan_img_error_string"}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the Hopper "
            "kernels cannot be built"
        )
    return found


def _target(source: Path) -> Path:
    # the shared headers (csrc/*.cuh) count as part of every source
    headers = b"".join(h.read_bytes()
                       for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(
        source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
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
    """The loaded kernel library `name` (a key of SOURCES), built at first
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
