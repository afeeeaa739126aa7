"""The fused SS2D epilogue of `sigma_tpu/ops/pallas_merge_ln_gate.py`, on
Hopper, with its gradient:

    out[b,h,w,:] = LN(y_hw[b,h,w,:] + y_wh[b,w,h,:]) * silu(z[b,h,w,:])

y_hw, z (B, H, W, C); y_wh (B, W, H, C), the transposed layout; gamma,
beta (C,). Inputs fp32 or bf16, math fp32, `out` always fp32 (as the JAX
kernel's out_shape). LayerNorm takes two-pass statistics: the mean, then
the mean of squared deviations.

`merge_ln_gate` dispatches by device: CPU tensors run the plain versions
(`merge_ln_gate_plain` forward, `merge_ln_gate_bwd_plain` the explicit
backward formula of the TPU kernel); CUDA tensors launch the kernels of
`csrc/merge_ln_gate.cu` or raise — there is no fallback:
    K6 merge_ln_gate_fwd   the forward
    K7 merge_ln_gate_bwd   dy_hw, dy_wh (written through the transpose), dz,
                           and per-block dgamma / dbeta partials summed here
A call that needs a gradient runs as `_MergeLnGate`, the counterpart of the
custom VJP: it saves only its inputs and recomputes the statistics in the
backward. `LAUNCHES` counts each wrapper's launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sigma_tpu_torch.ops import _build

# launches of each kernel; reset with reset_launches()
LAUNCHES = {"merge_ln_gate_fwd": 0, "merge_ln_gate_bwd": 0}
# rows per block of K6/K7 (kWarps in csrc/merge_ln_gate.cu)
ROWS_PER_BLOCK = 8
# K7's blocks per SM at most: each walks its rows with a grid stride and
# writes one row of the dgamma / dbeta partials
BWD_BLOCKS_PER_SM = 8


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain versions
def _xhat(y_hw, y_wh, eps):
    """(xhat, rsqrt(var + eps)) of the merged rows, fp32."""
    s = y_hw.float() + y_wh.float().transpose(1, 2)
    mu = s.mean(-1, keepdim=True)
    xc = s - mu
    rs = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return xc * rs, rs


def merge_ln_gate_plain(y_hw, y_wh, z, gamma, beta, eps):
    """The unfused epilogue (`merge_ln_gate_ref`), fp32 out."""
    xhat, _ = _xhat(y_hw, y_wh, eps)
    return (xhat * gamma.float() + beta.float()) * F.silu(z.float())


def merge_ln_gate_bwd_plain(y_hw, y_wh, z, gamma, beta, eps, dout):
    """The TPU backward kernel's formula (`_bwd_kernel`) from the saved
    inputs. Returns (dy_hw, dy_wh, dz) in the input dtypes and
    (dgamma, dbeta), fp32 sums over every row."""
    xhat, rs = _xhat(y_hw, y_wh, eps)
    g = gamma.float()
    zf = z.float()
    sig = torch.sigmoid(zf)
    d = dout.float()
    norm = xhat * g + beta.float()
    dnorm = d * (zf * sig)
    dz = (d * norm) * (sig * (1.0 + zf * (1.0 - sig)))
    dxhat = dnorm * g
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    ds = rs * (dxhat - m1 - xhat * m2)
    c = ds.shape[-1]
    return (ds.to(y_hw.dtype), ds.transpose(1, 2).contiguous().to(y_wh.dtype),
            dz.to(z.dtype), (dnorm * xhat).reshape(-1, c).sum(0),
            dnorm.reshape(-1, c).sum(0))


# ------------------------------------------------------------ kernel launches
def _check(y_hw, y_wh, z, gamma, beta):
    """(B, H, W, C) of a well-shaped call; raises otherwise."""
    if y_hw.dim() != 4:
        raise ValueError(f"y_hw: shape {tuple(y_hw.shape)}, expected "
                         "(B, H, W, C)")
    b, h, w, c = y_hw.shape
    for t, shape, name in ((y_wh, (b, w, h, c), "y_wh"),
                           (z, (b, h, w, c), "z"), (gamma, (c,), "gamma"),
                           (beta, (c,), "beta")):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
    return b, h, w, c


def _on_cuda(*tensors):
    """True for CUDA inputs (launch a kernel), False for CPU inputs (plain
    version); mixed devices and other devices raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"merge_ln_gate inputs on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"merge_ln_gate runs on cuda or cpu, not {dev}")
    return dev.type == "cuda"


def _require_cuda(*tensors):
    if not _on_cuda(*tensors):
        raise ValueError("the epilogue kernels take CUDA tensors")


def _io(*tensors):
    """The kernels' io dtype flag (1: bf16) of tensors of one dtype."""
    io = tensors[0].dtype
    if io not in (torch.float32, torch.bfloat16) or any(
            t.dtype != io for t in tensors):
        raise TypeError("the epilogue kernels take y_hw, y_wh and z all fp32 "
                        f"or all bf16, not {[t.dtype for t in tensors]}")
    return int(io == torch.bfloat16)


def _rows(t):
    """`t` (4-D) as rows of its last axis at one row stride: (tensor,
    stride in elements). Copied only when its rows are not evenly strided
    (a column slice, such as z out of in_proj's output, is not copied)."""
    n0, n1, n2, c = t.shape
    s = t.stride(2)
    if (t.stride(3) == 1 and s >= c and (n1 == 1 or t.stride(1) == s * n2)
            and (n0 == 1 or t.stride(0) == s * n2 * n1)):
        return t, s
    return t.contiguous(), c


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_merge_ln_gate_fwd(y_hw, y_wh, z, gamma, beta, eps):
    """K6 on CUDA tensors. Returns out (B, H, W, C) fp32."""
    b, h, w, c = _check(y_hw, y_wh, z, gamma, beta)
    _require_cuda(y_hw, y_wh, z, gamma, beta)
    bf16 = _io(y_hw, y_wh, z)
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=y_hw.device)
    (yh, ld_h), (yw, ld_w), (zz, ld_z) = (_rows(t) for t in (y_hw, y_wh, z))
    g, be = (t.float().contiguous() for t in (gamma, beta))
    lib = _build.library("mlg")
    with torch.cuda.device(y_hw.device):
        code = lib.sigma_mlg_fwd(
            yh.data_ptr(), yw.data_ptr(), zz.data_ptr(), g.data_ptr(),
            be.data_ptr(), out.data_ptr(), b, h, w, c, ld_h, ld_w, ld_z, bf16,
            float(eps), _stream(y_hw))
        LAUNCHES["merge_ln_gate_fwd"] += 1
    _build.check(code, "merge_ln_gate_fwd", "mlg")
    return out


def bwd_blocks(rows, device):
    """K7's grid: one block per ROWS_PER_BLOCK rows, at most
    BWD_BLOCKS_PER_SM per SM of `device` (rows beyond walk the grid)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-rows // ROWS_PER_BLOCK), BWD_BLOCKS_PER_SM * sms))


def launch_merge_ln_gate_bwd(y_hw, y_wh, z, gamma, beta, eps, dout):
    """K7 on CUDA tensors. Returns (dy_hw, dy_wh, dz) in the io dtype and
    (dgamma, dbeta) fp32, the kernel's per-block partials summed here."""
    b, h, w, c = _check(y_hw, y_wh, z, gamma, beta)
    _require_cuda(y_hw, y_wh, z, gamma, beta, dout)
    bf16 = _io(y_hw, y_wh, z)
    if tuple(dout.shape) != (b, h, w, c):
        raise ValueError(f"dout: shape {tuple(dout.shape)}, expected "
                         f"{(b, h, w, c)}")
    dyh, dyw, dz = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                    for t in (y_hw, y_wh, z))
    nblk = bwd_blocks(b * h * w, y_hw.device)
    dgp, dbp = (torch.empty((nblk, c), dtype=torch.float32,
                            device=y_hw.device) for _ in range(2))
    (yh, ld_h), (yw, ld_w), (zz, ld_z) = (_rows(t) for t in (y_hw, y_wh, z))
    g, be = (t.float().contiguous() for t in (gamma, beta))
    d = dout.float().contiguous()
    lib = _build.library("mlg")
    with torch.cuda.device(y_hw.device):
        code = lib.sigma_mlg_bwd(
            yh.data_ptr(), yw.data_ptr(), zz.data_ptr(), g.data_ptr(),
            be.data_ptr(), d.data_ptr(), dyh.data_ptr(), dyw.data_ptr(),
            dz.data_ptr(), dgp.data_ptr(), dbp.data_ptr(), b, h, w, c, ld_h,
            ld_w, ld_z, nblk, bf16, float(eps), _stream(y_hw))
        LAUNCHES["merge_ln_gate_bwd"] += 1
    _build.check(code, "merge_ln_gate_bwd", "mlg")
    return dyh, dyw, dz, dgp.sum(0), dbp.sum(0)


# ------------------------------------------------------------ autograd
class _MergeLnGate(torch.autograd.Function):
    """K6 forward, K7 backward on CUDA tensors; the plain forward and the
    plain backward formula on CPU tensors (`_vjp_fwd` / `_vjp_bwd`)."""

    @staticmethod
    def forward(ctx, y_hw, y_wh, z, gamma, beta, eps):
        ctx.save_for_backward(y_hw, y_wh, z, gamma, beta)
        ctx.eps = eps
        fwd = launch_merge_ln_gate_fwd if y_hw.is_cuda else merge_ln_gate_plain
        return fwd(y_hw, y_wh, z, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dout):
        y_hw, y_wh, z, gamma, beta = ctx.saved_tensors
        bwd = (launch_merge_ln_gate_bwd if y_hw.is_cuda
               else merge_ln_gate_bwd_plain)
        dyh, dyw, dz, dg, db = bwd(y_hw, y_wh, z, gamma, beta, ctx.eps, dout)
        return dyh, dyw, dz, dg.to(gamma.dtype), db.to(beta.dtype), None


# ------------------------------------------------------------ entry point
def merge_ln_gate(y_hw, y_wh, z, gamma, beta, eps=1e-5):
    """out = LN(y_hw + transpose(y_wh)) * silu(z), fused; (B, H, W, C)
    fp32. On the card y_hw, y_wh and z share one dtype, fp32 or bf16."""
    _check(y_hw, y_wh, z, gamma, beta)
    cuda = _on_cuda(y_hw, y_wh, z, gamma, beta)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (y_hw, y_wh, z, gamma, beta)):
        return _MergeLnGate.apply(y_hw, y_wh, z, gamma, beta, float(eps))
    fwd = launch_merge_ln_gate_fwd if cuda else merge_ln_gate_plain
    return fwd(y_hw, y_wh, z, gamma, beta, float(eps))


__all__ = [
    "LAUNCHES",
    "launch_merge_ln_gate_bwd",
    "launch_merge_ln_gate_fwd",
    "merge_ln_gate",
    "merge_ln_gate_bwd_plain",
    "merge_ln_gate_plain",
    "reset_launches",
]
