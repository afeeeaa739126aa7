"""Channel-first selective scan on Hopper, with its gradient: the
counterpart of `sigma_tpu/ops/pallas_scan.py` + `pallas_scan_bwd.py`
(`selective_scan_pallas`, reached by `selective_scan(backend="pallas")`).

Layout of the reference's CUDA extension: u, delta (batch, G*dg, L);
A (G*dg, N); B, C (batch, G, N, L); D, delta_bias (G*dg,).

Kernels (`csrc/scan_cf.cu`), on the core (u, delta_eff, A, B, C) -> y:
    K8 scan_cf_fwd  the chunk-parallel forward K1, K2 and K10 run
                    (`csrc/chunk_fwd.cuh`: 128-token chunks, a carry pass,
                    the emission; three launches, counted once); with a
                    gradient it also writes h as the scan enters every
                    32-token segment (`hck`, K3's layout)
    K9 scan_cf_bwd  the chunk-parallel backward K3, K4 and K11 run
                    (`csrc/chunk_bwd.cuh`: each chunk's adjoint, a carry
                    pass, the emission from `hck`; three launches, counted
                    once): du, dd, and dA / dB / dC as per-chunk and
                    per-32-channel-block partials summed here
`LAUNCHES` counts each wrapper's launches. As in JAX, the bias, the
softplus and the D skip stay outside the kernels as torch ops, so autograd
gives dD and dbias; inputs are cast to fp32 and y takes u's dtype.

Dispatch goes by the device of `u`: a CPU tensor takes the plain version
(`selective_scan_chunked`, differentiated by autograd); a CUDA tensor
launches the kernels or raises — there is no fallback.

Not ported (TPU tiling): the padding of dg to 8 and of L to the chunk
(pallas_scan.py:181-197) and the `d_block` / `l_chunk` knobs; the kernels
mask their own ragged edges.
"""

from __future__ import annotations

import torch

from sigma_tpu_torch.ops import _build
from sigma_tpu_torch.ops.scan_g import (
    _chunk_scratch,
    _expect,
    _n_ck,
    _needs_grad,
    _on_cuda,
    _stream,
)
from sigma_tpu_torch.ops.selective_scan import (
    _effective_delta,
    selective_scan_chunked,
)

# launches of each kernel; reset with reset_launches()
LAUNCHES = {"scan_cf_fwd": 0, "scan_cf_bwd": 0}

# channels per block of K9 (kBwdChan in csrc/chunk_bwd.cuh): its dB / dC
# partials have ceil(dg / 32)
CF_BWD_CHANNELS = 32
# the largest d_state the kernels take (the reference kernel's bound)
CF_MAX_STATE = 256


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _core_shapes(u, delta, A, B, C):
    """(batch, G, dg, L, N) of the core's fp32 CUDA operands; raises on
    what the kernels do not take."""
    if not _on_cuda(u, delta, A, B, C):
        raise ValueError(f"the channel-first scan kernels take CUDA "
                         f"tensors, not {u.device}")
    batch, dim, L = u.shape
    G, N = B.shape[1], A.shape[1]
    if dim % G:
        raise ValueError(f"dim={dim} not divisible by groups={G}")
    if N > CF_MAX_STATE:
        raise ValueError(f"d_state {N}: the channel-first scan kernels take "
                         f"at most {CF_MAX_STATE}")
    for name, t in (("u", u), ("delta", delta), ("A", A), ("B", B),
                    ("C", C)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the channel-first scan kernels take "
                            f"fp32, not {t.dtype}")
    _expect(delta, u.shape, "delta")
    _expect(A, (dim, N), "A")
    _expect(B, (batch, G, N, L), "B")
    _expect(C, (batch, G, N, L), "C")
    return batch, G, dim // G, L, N


def launch_scan_cf_fwd(u, delta, A, B, C, with_hck=False):
    """K8 on fp32 CUDA tensors: u, delta (batch, G*dg, L) with delta the
    effective delta; A (G*dg, N); B, C (batch, G, N, L). Returns y like u
    (no D skip), and with `with_hck` also the state as the scan enters
    every CK_TOKENS-token segment, (batch*G, ceil(L / CK_TOKENS), N,
    dg)."""
    batch, G, dg, L, N = _core_shapes(u, delta, A, B, C)
    u, delta, A, B, C = (t.contiguous() for t in (u, delta, A, B, C))
    y = torch.empty_like(u)
    hck = None
    if with_hck:
        hck = torch.empty((batch * G, _n_ck(L), N, dg), dtype=torch.float32,
                          device=u.device)
    hloc, sd = _chunk_scratch(batch, G, L, N, dg, u)
    lib = _build.library("cf")
    with torch.cuda.device(u.device):
        code = lib.sigma_scan_cf_fwd(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), hloc.data_ptr(), sd.data_ptr(),
            hloc.shape[2], None if hck is None else hck.data_ptr(),
            batch * G, G, dg, L, N, _n_ck(L), _stream(u),
        )
        LAUNCHES["scan_cf_fwd"] += 1
    _build.check(code, "scan_cf_fwd", "cf")
    return (y, hck) if with_hck else y


def launch_scan_cf_bwd(u, delta, A, B, C, hck, dy):
    """K9 on fp32 CUDA tensors, operands as for K8, `hck` as K8 wrote it,
    dy like y. Returns (du, dd, dA, dB, dC) of the core. dA is summed here
    over K9's per-chunk partials and the batch, dB / dC over its
    32-channel-block partials (torch's reductions, a fixed order). Its
    three launches (chunk adjoints, carries, emission) count as one."""
    batch, G, dg, L, N = _core_shapes(u, delta, A, B, C)
    _expect(dy, u.shape, "dy")
    _expect(hck, (batch * G, _n_ck(L), N, dg), "hck")
    u, delta, A, B, C, hck, dy = (
        t.contiguous() for t in (u, delta, A, B, C, hck, dy.float()))
    du, dd = torch.empty_like(u), torch.empty_like(u)
    f = dict(dtype=torch.float32, device=u.device)
    lam, sd = _chunk_scratch(batch, G, L, N, dg, u)
    dA = torch.empty_like(lam)
    blocks = -(-dg // CF_BWD_CHANNELS)
    dBp = torch.empty((blocks, batch, G, N, L), **f)
    dCp = torch.empty((blocks, batch, G, N, L), **f)
    lib = _build.library("cf")
    with torch.cuda.device(u.device):
        code = lib.sigma_scan_cf_bwd(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), hck.data_ptr(), dy.data_ptr(), du.data_ptr(),
            dd.data_ptr(), dA.data_ptr(), dBp.data_ptr(), dCp.data_ptr(),
            lam.data_ptr(), sd.data_ptr(), lam.shape[2], batch * G, G, dg, L,
            N, _n_ck(L), _stream(u),
        )
        LAUNCHES["scan_cf_bwd"] += 1
    _build.check(code, "scan_cf_bwd", "cf")
    # (batch, G, n_chunk, N, dg) -> A's (G*dg, N)
    dA = dA.sum((0, 2)).transpose(1, 2).reshape(G * dg, N)
    return du, dd, dA, dBp.sum(0), dCp.sum(0)


class _ScanCF(torch.autograd.Function):
    """K8 (+ hck) forward, K9 backward: the counterpart of the custom VJP
    `_scan_core` (pallas_scan.py:130-154) on (u, delta_eff, A, B, C)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C):
        u, delta, A, B, C = (t.contiguous() for t in (u, delta, A, B, C))
        y, hck = launch_scan_cf_fwd(u, delta, A, B, C, with_hck=True)
        ctx.save_for_backward(u, delta, A, B, C, hck)
        return y

    @staticmethod
    def backward(ctx, dy):
        u, delta, A, B, C, hck = ctx.saved_tensors
        return launch_scan_cf_bwd(u, delta, A, B, C, hck, dy)


def selective_scan_cf(u, delta, A, B, C, D=None, delta_bias=None,
                      delta_softplus=False):
    """Channel-first selective scan (counterpart of `selective_scan_pallas`,
    same signature and semantics; fp32 math, differentiable, y in u's
    dtype). CPU tensors take `selective_scan_chunked`."""
    if not _on_cuda(u, delta, A, B, C, D, delta_bias):
        return selective_scan_chunked(u, delta, A, B, C, D, delta_bias,
                                      delta_softplus)
    dim = u.shape[1]
    uf = u.float()
    d_eff = _effective_delta(delta, delta_bias, delta_softplus, (1, dim, 1))
    core = (uf, d_eff, A.float(), B.float(), C.float())
    if _needs_grad(*core):
        y = _ScanCF.apply(*core)
    else:
        y = launch_scan_cf_fwd(*core)
    if D is not None:
        y = y + D.float()[None, :, None] * uf
    return y.to(u.dtype)


__all__ = [
    "CF_BWD_CHANNELS",
    "CF_MAX_STATE",
    "LAUNCHES",
    "launch_scan_cf_bwd",
    "launch_scan_cf_fwd",
    "reset_launches",
    "selective_scan_cf",
]
