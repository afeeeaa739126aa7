"""Entry points of `sigma_tpu/ops/pallas_scan_g.py`, on Hopper, with their
gradients.

Same arguments and channel-last layouts as the JAX entry points:

    selective_scan_g(u, delta, A, B, C, ...)            streamed
        u, delta (B, G, L, dg); A (G, N, dg); B, C (B, G, L, N);
        D, delta_bias (G, dg)
    selective_scan_g_proj(u, w_dt, w_b, w_c, A, ...)    fused projection
        u (B, G, L, dg); w_dt (G, dg, dg); w_b, w_c (G, dg, N)
    selective_scan_g_proj_ml(us, ...)                   two layouts, G = 2
        us: two (B, L, dg) operands; returns two (B, L, dg) outputs

Each has a plain PyTorch version beside it (`*_plain`, built on
`ops/selective_scan.py`), whose gradient is autograd's. Dispatch goes by
the device of `u`: a CPU tensor takes the plain version (differentiated by
autograd); a CUDA tensor launches the kernels or raises — there is no
fallback.

Kernels (`csrc/scan_g_fwd.cu`, `csrc/scan_g_bwd.cu`):
    K1 scan_fwd       streamed forward
    K2 scan_proj_fwd  forward with dt/B/C projected in-kernel
    K3 scan_bwd       streamed backward
    K4 scan_proj_bwd  backward with dt/B/C re-projected in-kernel
    K5 proj_grad      weight gradients and the du chain term of K4
`LAUNCHES` counts each wrapper's launches (K5's wrapper launches its two
products as one count).

A CUDA call that needs a gradient runs as a torch.autograd.Function (the
counterparts of the custom VJPs `_scan_core_g`, `_scan_core_gp`,
`_scan_core_gpa`, `_scan_core_gp_ml`, `_scan_core_gp_mla`): its forward
kernel also writes the state checkpoints `hck` (h every CK_TOKENS tokens)
and its backward runs K3, or K4 then K5. Without a gradient (eval) no
`hck` is written. The backward kernels are fp32: bf16 io with a gradient
raises (ROADMAP C2). y_accum's cotangent is dy itself.

Not ported (TPU layout mechanics with no meaning on Hopper): batch fold,
dg tiling planners, N padding to 8, the VMEM planners, `_LOG2E`
prescaling and the TPU's hck spacing planner (`_ck_tokens`, `_CK_RATIO`).
"""

from __future__ import annotations

import torch

from sigma_tpu_torch.ops import _build
from sigma_tpu_torch.ops.selective_scan import selective_scan_cl

# launches of each kernel; reset with reset_launches()
LAUNCHES = {"scan_fwd": 0, "scan_proj_fwd": 0, "scan_bwd": 0,
            "scan_proj_bwd": 0, "proj_grad": 0}

# The fused-projection kernel takes a call when 6*G*dg^2 <= 12 MiB; wider
# calls run their projections as torch.matmul and the streamed kernel.
# This split is inherited from the TPU planner's weight budget
# (pallas_scan_g.py:1557), where it was a VMEM limit; on the card it is to
# be re-decided by measurement. At sigma_tiny it routes every stage-3
# (d_inner 1536) scan to the streamed kernel and all others to K2.
PROJ_BUDGET_BYTES = 12 * 1024 * 1024

# state checkpoint spacing of the forward kernels (kSeg in csrc/*.cu); every
# kernel entry takes n_ck = ceil(L / CK_TOKENS) and refuses another value
CK_TOKENS = 32
# channels per block of K3/K4: their dB/dC partials have ceil(dg / 32)
BWD_CHANNELS = 32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def uses_fused_projection(G: int, dg: int) -> bool:
    return 6 * G * dg * dg <= PROJ_BUDGET_BYTES


def _pair_swap(x):
    """Swap chains (2k, 2k+1) on axis 1: CroMB's cross-modal C exchange."""
    b, g = x.shape[:2]
    return x.reshape(b, g // 2, 2, *x.shape[2:]).flip(2).reshape(x.shape)


# ------------------------------------------------------------ plain versions
def selective_scan_g_plain(u, delta, A, B, C, D=None, delta_bias=None,
                           delta_softplus=False, reverse=False,
                           remat_chunks=False):
    """`remat_chunks` recomputes each chunk in autograd's backward pass
    (same values, bounded memory at full-size shapes)."""
    batch, G, L, dg = u.shape
    N = A.shape[1]
    if reverse:
        u, delta, B, C = (t.flip(2) for t in (u, delta, B, C))
    y = selective_scan_cl(
        u.reshape(batch * G, L, dg), delta.reshape(batch * G, L, dg), A,
        B.reshape(batch * G, L, N), C.reshape(batch * G, L, N),
        D=None if D is None else D.reshape(G, dg),
        delta_bias=None if delta_bias is None else delta_bias.reshape(G, dg),
        delta_softplus=delta_softplus, remat_chunks=remat_chunks,
    ).reshape(batch, G, L, dg)
    return y.flip(2) if reverse else y


def selective_scan_g_proj_plain(u, w_dt, w_b, w_c, A, D=None,
                                delta_bias=None, delta_softplus=False,
                                reverse=False, swap_groups_c=False,
                                y_accum=None, remat_chunks=False):
    uf = u.float()
    dts = uf @ w_dt.float()
    bs = uf @ w_b.float()
    cs = uf @ w_c.float()
    if swap_groups_c:
        cs = _pair_swap(cs)
    y = selective_scan_g_plain(uf, dts, A, bs, cs, D, delta_bias,
                               delta_softplus, reverse, remat_chunks)
    if y_accum is not None:
        y = y + y_accum.float()
    return y.to(u.dtype)


def selective_scan_g_proj_ml_plain(us, w_dt, w_b, w_c, A, D=None,
                                   delta_bias=None, delta_softplus=False,
                                   reverse=False, swap_groups_c=False,
                                   y_accum=None, remat_chunks=False):
    ya = None if y_accum is None else torch.stack(tuple(y_accum), 1)
    y = selective_scan_g_proj_plain(
        torch.stack(tuple(us), 1), w_dt, w_b, w_c, A, D, delta_bias,
        delta_softplus, reverse, swap_groups_c, ya, remat_chunks,
    )
    return y[:, 0], y[:, 1]


def proj_grad_plain(us, dd, dB, dC, w_dt, w_b, w_c):
    """K5's products: per chain, [dW_dt | dW_B | dW_C] = u^T [dd | dB | dC]
    and du_chain = [dd | dB | dC] [W_dt | W_B | W_C]^T, dC already routed
    to the chain whose projection made the C. `us` as for K4. Returns
    (du_chain like `us`, dW_dt, dW_B, dW_C)."""
    u = us[0] if len(us) == 1 else torch.stack(tuple(us), 1)
    z = torch.cat([dd, dB, dC], -1)
    w = torch.cat([w_dt, w_b, w_c], -1)
    dW = torch.einsum("bgld,bglk->gdk", u, z)
    du = torch.einsum("bglk,gdk->bgld", z, w)
    dg, N = w_dt.shape[-1], w_b.shape[-1]
    dus = (du,) if len(us) == 1 else (du[:, 0], du[:, 1])
    return dus, dW[..., :dg], dW[..., dg:dg + N], dW[..., dg + N:]


# ------------------------------------------------------------ kernel launches
def _io_dtype(t):
    return torch.bfloat16 if t.dtype == torch.bfloat16 else torch.float32


def _on_cuda(*tensors):
    """True for CUDA inputs (launch a kernel), False for CPU inputs (plain
    version); mixed devices and other devices raise."""
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"scan inputs on {t.device} and {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"scan kernels run on cuda or cpu, not {dev}")
    return True


def _needs_grad(*tensors):
    """True when autograd records this call; its io must then be fp32."""
    if not torch.is_grad_enabled() or not any(
            t is not None and t.requires_grad for t in tensors):
        return False
    for t in tensors:
        if t is not None and t.dtype == torch.bfloat16:
            raise NotImplementedError(
                "the backward scan kernels are fp32; a bf16 scan with a "
                "gradient waits for the bf16 backward (ROADMAP C2)")
    return True


def _param(t, shape, like):
    """An fp32 contiguous parameter of `shape` on `like`'s device; zeros
    when absent."""
    if t is None:
        return torch.zeros(shape, dtype=torch.float32, device=like.device)
    return t.to(torch.float32).reshape(shape).contiguous()


def _expect(t, shape, name):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _n_ck(L):
    return -(-L // CK_TOKENS)


def _hck(batch, G, L, N, dg, like):
    return torch.empty((batch, G, _n_ck(L), N, dg), dtype=torch.float32,
                       device=like.device)


def launch_scan_fwd(u, delta, A, B, C, D=None, delta_bias=None,
                    delta_softplus=False, reverse=False, y_accum=None,
                    with_hck=False):
    """K1 on CUDA tensors of one io type (fp32 or bf16). Returns y like u,
    and with `with_hck` also the (B, G, ceil(L / CK_TOKENS), N, dg)
    checkpoints."""
    batch, G, L, dg = u.shape
    N = A.shape[1]
    io = u.dtype
    if io not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scan io dtype {io}")
    _expect(delta, u.shape, "delta")
    _expect(A, (G, N, dg), "A")
    _expect(B, (batch, G, L, N), "B")
    _expect(C, (batch, G, L, N), "C")
    streams = [t.to(io).contiguous() for t in (u, delta, B, C)]
    ya = None
    if y_accum is not None:
        _expect(y_accum, u.shape, "y_accum")
        ya = y_accum.to(io).contiguous()
    a32 = _param(A, (G, N, dg), u)
    bias = _param(delta_bias, (G, dg), u)
    dk = _param(D, (G, dg), u)
    y = torch.empty_like(streams[0])
    hck = _hck(batch, G, L, N, dg, u) if with_hck else None
    lib = _build.library("fwd")
    with torch.cuda.device(u.device):
        code = lib.sigma_scan_fwd(
            streams[0].data_ptr(), streams[1].data_ptr(), a32.data_ptr(),
            streams[2].data_ptr(), streams[3].data_ptr(), bias.data_ptr(),
            dk.data_ptr(), _ptr(ya), y.data_ptr(), _ptr(hck), _n_ck(L),
            batch, G, L, dg, N, int(bool(delta_softplus)), int(bool(reverse)),
            int(io == torch.bfloat16), _stream(u),
        )
        LAUNCHES["scan_fwd"] += 1
    _build.check(code, "scan_fwd")
    return (y, hck) if with_hck else y


def _layouts(us):
    """(batch, G, L, dg) of one (B, G, L, dg) operand or two (B, L, dg)
    layout operands (G = 2)."""
    n_u = len(us)
    if n_u == 2:
        batch, L, dg = us[0].shape
        _expect(us[1], us[0].shape, "us[1]")
        return batch, 2, L, dg
    if n_u == 1:
        return us[0].shape
    raise ValueError(f"{n_u} layout operands; the kernels take 1 or 2")


def launch_scan_proj_fwd(us, w_dt, w_b, w_c, A, D=None, delta_bias=None,
                         delta_softplus=False, reverse=False,
                         swap_groups_c=False, y_accum=None, with_hck=False):
    """K2 on CUDA tensors. `us`: one (B, G, L, dg) operand, or two
    (B, L, dg) layout operands (G = 2). Returns a list like `us`, and with
    `with_hck` also the state checkpoints."""
    n_u = len(us)
    io = us[0].dtype
    if io not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scan io dtype {io}")
    batch, G, L, dg = _layouts(us)
    N = A.shape[1]
    if swap_groups_c and G % 2:
        raise ValueError("swap_groups_c needs chain pairs (even G)")
    _expect(w_dt, (G, dg, dg), "w_dt")
    _expect(w_b, (G, dg, N), "w_b")
    _expect(w_c, (G, dg, N), "w_c")
    _expect(A, (G, N, dg), "A")
    us = [u.to(io).contiguous() for u in us]
    ws = [w.to(io).contiguous() for w in (w_dt, w_b, w_c)]
    yas = [None] * n_u
    if y_accum is not None:
        for ya in y_accum:
            _expect(ya, us[0].shape, "y_accum")
        yas = [ya.to(io).contiguous() for ya in y_accum]
    a32 = _param(A, (G, N, dg), us[0])
    bias = _param(delta_bias, (G, dg), us[0])
    dk = _param(D, (G, dg), us[0])
    ys = [torch.empty_like(u) for u in us]
    hck = _hck(batch, G, L, N, dg, us[0]) if with_hck else None
    pad = [None] * (2 - n_u)  # the second layout pointers are null at n_u 1
    lib = _build.library("fwd")
    with torch.cuda.device(us[0].device):
        code = lib.sigma_scan_proj_fwd(
            *[_ptr(u) for u in us], *pad,
            ws[0].data_ptr(), ws[1].data_ptr(), ws[2].data_ptr(),
            a32.data_ptr(), bias.data_ptr(), dk.data_ptr(),
            *[_ptr(ya) for ya in yas], *pad,
            *[_ptr(y) for y in ys], *pad, _ptr(hck), _n_ck(L),
            batch, G, L, dg, N, n_u, int(bool(delta_softplus)),
            int(bool(reverse)), int(bool(swap_groups_c)),
            int(io == torch.bfloat16), _stream(us[0]),
        )
        LAUNCHES["scan_proj_fwd"] += 1
    _build.check(code, "scan_proj_fwd")
    return (ys, hck) if with_hck else ys


def _f32(t):
    if t.dtype != torch.float32:
        raise TypeError(f"the backward scan kernels take fp32, not {t.dtype}")
    return t.contiguous()


def _bwd_outputs(batch, G, L, dg, N, like):
    """dd, dA, dbias, dD and the per-block dB / dC partials of K3 / K4."""
    nblk = -(-dg // BWD_CHANNELS)
    f = dict(dtype=torch.float32, device=like.device)
    return (torch.empty((batch, G, L, dg), **f),
            torch.empty((batch, G, N, dg), **f),
            torch.empty((batch, G, dg), **f), torch.empty((batch, G, dg), **f),
            torch.empty((batch, nblk, G, L, N), **f),
            torch.empty((batch, nblk, G, L, N), **f))


def launch_scan_bwd(u, delta, A, B, C, D, delta_bias, hck, dy,
                    delta_softplus=False, reverse=False):
    """K3: the streamed backward from K1's checkpoints, fp32 CUDA tensors.
    Returns (du, dd, dA, dB, dC, dbias, dD); the per-block and per-batch
    partials are summed here."""
    batch, G, L, dg = u.shape
    N = A.shape[1]
    _expect(dy, u.shape, "dy")
    _expect(hck, (batch, G, _n_ck(L), N, dg), "hck")
    u, delta, B, C, dy = (_f32(t) for t in (u, delta, B, C, dy))
    a32 = _param(A, (G, N, dg), u)
    bias = _param(delta_bias, (G, dg), u)
    dk = _param(D, (G, dg), u)
    du = torch.empty_like(u)
    dd, dA, dbias, dD, dBp, dCp = _bwd_outputs(batch, G, L, dg, N, u)
    lib = _build.library("bwd")
    with torch.cuda.device(u.device):
        code = lib.sigma_scan_bwd(
            u.data_ptr(), delta.data_ptr(), a32.data_ptr(), B.data_ptr(),
            C.data_ptr(), bias.data_ptr(), dk.data_ptr(), hck.data_ptr(),
            dy.data_ptr(), du.data_ptr(), dd.data_ptr(), dA.data_ptr(),
            dbias.data_ptr(), dD.data_ptr(), dBp.data_ptr(), dCp.data_ptr(),
            batch, G, L, dg, N, hck.shape[2], int(bool(delta_softplus)),
            int(bool(reverse)), _stream(u),
        )
        LAUNCHES["scan_bwd"] += 1
    _build.check(code, "scan_bwd", "bwd")
    return (du, dd, dA.sum(0), dBp.sum(1), dCp.sum(1), dbias.sum(0),
            dD.sum(0))


def launch_scan_proj_bwd(us, w_dt, w_b, w_c, A, D, delta_bias, hck, dys,
                         delta_softplus=False, reverse=False,
                         swap_groups_c=False):
    """K4: the fused-projection backward, fp32 CUDA tensors, `us` / `dys`
    as for K2. Returns (du like `us` — the direct term only, K5 adds the
    chain term —, dd, dB, dC, dA, dbias, dD): dd / dB / dC are the
    cotangents of the projected streams, dC routed to the chain whose
    projection made the C (the partner under `swap_groups_c`)."""
    n_u = len(us)
    batch, G, L, dg = _layouts(us)
    N = A.shape[1]
    for dy in dys:
        _expect(dy, us[0].shape, "dy")
    _expect(hck, (batch, G, _n_ck(L), N, dg), "hck")
    us = [_f32(u) for u in us]
    dys = [_f32(dy) for dy in dys]
    ws = [_f32(w) for w in (w_dt, w_b, w_c)]
    a32 = _param(A, (G, N, dg), us[0])
    bias = _param(delta_bias, (G, dg), us[0])
    dk = _param(D, (G, dg), us[0])
    dus = [torch.empty_like(u) for u in us]
    dd, dA, dbias, dD, dBp, dCp = _bwd_outputs(batch, G, L, dg, N, us[0])
    pad = [None] * (2 - n_u)
    lib = _build.library("bwd")
    with torch.cuda.device(us[0].device):
        code = lib.sigma_scan_proj_bwd(
            *[_ptr(u) for u in us], *pad,
            ws[0].data_ptr(), ws[1].data_ptr(), ws[2].data_ptr(),
            a32.data_ptr(), bias.data_ptr(), dk.data_ptr(), hck.data_ptr(),
            *[_ptr(dy) for dy in dys], *pad, *[_ptr(du) for du in dus], *pad,
            dd.data_ptr(), dA.data_ptr(), dbias.data_ptr(), dD.data_ptr(),
            dBp.data_ptr(), dCp.data_ptr(),
            batch, G, L, dg, N, hck.shape[2], n_u, int(bool(delta_softplus)),
            int(bool(reverse)), int(bool(swap_groups_c)), _stream(us[0]),
        )
        LAUNCHES["scan_proj_bwd"] += 1
    _build.check(code, "scan_proj_bwd", "bwd")
    return (dus, dd, dBp.sum(1), dCp.sum(1), dA.sum(0), dbias.sum(0),
            dD.sum(0))


def launch_proj_grad(us, dus, dd, dB, dC, w_dt, w_b, w_c):
    """K5 on fp32 CUDA tensors: adds the chain term [dd | dB | dC] W^T into
    `dus` in place and returns (dW_dt, dW_B, dW_C), K4's cotangents
    contracted with u over every token (split over tokens into partials
    that are summed here)."""
    n_u = len(us)
    batch, G, L, dg = _layouts(us)
    N = w_b.shape[-1]
    kz = dg + 2 * N
    tiles = G * -(-dg // 64) * -(-kz // 64)
    nsplit = max(1, min(-(-2 * 132 // tiles), -(-batch * L // 512)))
    dW = torch.empty((nsplit, G, dg, kz), dtype=torch.float32,
                     device=us[0].device)
    us = [_f32(u) for u in us]
    dd, dB, dC = (_f32(t) for t in (dd, dB, dC))
    ws = [_f32(w) for w in (w_dt, w_b, w_c)]
    for du in dus:
        if not du.is_contiguous() or du.dtype != torch.float32:
            raise ValueError("du must be contiguous fp32 (updated in place)")
    pad = [None] * (2 - n_u)
    lib = _build.library("bwd")
    with torch.cuda.device(us[0].device):
        code = lib.sigma_proj_grad(
            *[_ptr(u) for u in us], *pad, *[_ptr(du) for du in dus], *pad,
            dd.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            ws[0].data_ptr(), ws[1].data_ptr(), ws[2].data_ptr(),
            dW.data_ptr(), batch, G, L, dg, N, n_u, nsplit, _stream(us[0]),
        )
        LAUNCHES["proj_grad"] += 1
    _build.check(code, "proj_grad", "bwd")
    dW = dW.sum(0)
    return dW[..., :dg], dW[..., dg:dg + N], dW[..., dg + N:]


# ------------------------------------------------------------ autograd
def _grad_like(g, t):
    return None if t is None else g.reshape(t.shape).to(t.dtype)


class _ScanG(torch.autograd.Function):
    """K1 (+ hck) forward, K3 backward (`_scan_core_g`); `y_accum` is added
    in-kernel and its cotangent is dy."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, delta_bias, softplus, reverse,
                y_accum):
        y, hck = launch_scan_fwd(u, delta, A, B, C, D, delta_bias, softplus,
                                 reverse, y_accum, with_hck=True)
        ctx.save_for_backward(u, delta, A, B, C, D, delta_bias, hck)
        ctx.flags = (softplus, reverse, y_accum is not None)
        return y

    @staticmethod
    def backward(ctx, dy):
        u, delta, A, B, C, D, bias, hck = ctx.saved_tensors
        softplus, reverse, has_ya = ctx.flags
        du, dd, dA, dB, dC, dbias, dD = launch_scan_bwd(
            u, delta, A, B, C, D, bias, hck, dy, softplus, reverse)
        return (du, dd, dA.reshape(A.shape), dB, dC, _grad_like(dD, D),
                _grad_like(dbias, bias), None, None, dy if has_ya else None)


class _ScanGProj(torch.autograd.Function):
    """K2 (+ hck) forward, K4 + K5 backward (`_scan_core_gp`/`_gpa` with
    one operand, `_scan_core_gp_ml`/`_mla` with two layout operands)."""

    @staticmethod
    def forward(ctx, u0, u1, w_dt, w_b, w_c, A, D, delta_bias, ya0, ya1,
                softplus, reverse, swap):
        us = (u0,) if u1 is None else (u0, u1)
        yas = None
        if ya0 is not None:
            yas = (ya0,) if u1 is None else (ya0, ya1)
        ys, hck = launch_scan_proj_fwd(us, w_dt, w_b, w_c, A, D, delta_bias,
                                       softplus, reverse, swap, yas,
                                       with_hck=True)
        ctx.save_for_backward(u0, u1, w_dt, w_b, w_c, A, D, delta_bias, hck)
        ctx.flags = (softplus, reverse, swap, ya0 is not None)
        return tuple(ys)

    @staticmethod
    def backward(ctx, *dys):
        u0, u1, w_dt, w_b, w_c, A, D, bias, hck = ctx.saved_tensors
        softplus, reverse, swap, has_ya = ctx.flags
        us = (u0,) if u1 is None else (u0, u1)
        dus, dd, dB, dC, dA, dbias, dD = launch_scan_proj_bwd(
            us, w_dt, w_b, w_c, A, D, bias, hck, dys, softplus, reverse, swap)
        dw_dt, dw_b, dw_c = launch_proj_grad(us, dus, dd, dB, dC, w_dt, w_b,
                                             w_c)
        dya = dys if has_ya else (None, None)
        return (dus[0], dus[1] if u1 is not None else None, dw_dt, dw_b,
                dw_c, dA.reshape(A.shape), _grad_like(dD, D),
                _grad_like(dbias, bias), dya[0],
                dya[1] if u1 is not None else None, None, None, None)


def _streamed(u, dts, A, bs, cs, D, delta_bias, softplus, reverse,
              y_accum=None):
    """K1 on CUDA tensors, through the autograd Function when a gradient is
    needed."""
    if _needs_grad(u, dts, A, bs, cs, D, delta_bias, y_accum):
        return _ScanG.apply(u, dts, A, bs, cs, D, delta_bias,
                            bool(softplus), bool(reverse), y_accum)
    return launch_scan_fwd(u, dts, A, bs, cs, D, delta_bias, softplus,
                           reverse, y_accum)


def _fused(us, w_dt, w_b, w_c, A, D, delta_bias, softplus, reverse, swap,
           y_accum):
    """K2 on CUDA tensors, through the autograd Function when a gradient is
    needed. Returns a list like `us`."""
    yas = (None, None) if y_accum is None else tuple(y_accum) + (None,)
    if _needs_grad(*us, w_dt, w_b, w_c, A, D, delta_bias, *yas[:len(us)]):
        u1 = us[1] if len(us) == 2 else None
        ya1 = yas[1] if len(us) == 2 else None
        return list(_ScanGProj.apply(
            us[0], u1, w_dt, w_b, w_c, A, D, delta_bias, yas[0], ya1,
            bool(softplus), bool(reverse), bool(swap)))
    return launch_scan_proj_fwd(us, w_dt, w_b, w_c, A, D, delta_bias,
                                softplus, reverse, swap, y_accum)


# ------------------------------------------------------------ entry points
def selective_scan_g(u, delta, A, B, C, D=None, delta_bias=None,
                     delta_softplus=False, reverse=False):
    """Grouped channel-last scan; `reverse` walks last-to-first in place,
    so selective_scan_g(.., reverse=True) == flip(selective_scan_g(flip(.)))
    with no flipped copies. fp32 math, dtype-preserving."""
    if not _on_cuda(u, delta, A, B, C, D, delta_bias):
        return selective_scan_g_plain(u, delta, A, B, C, D, delta_bias,
                                      delta_softplus, reverse)
    io = _io_dtype(u)
    y = _streamed(u.to(io), delta, A, B, C, D, delta_bias, delta_softplus,
                  reverse)
    return y.to(u.dtype)


def selective_scan_g_proj(u, w_dt, w_b, w_c, A, D=None, delta_bias=None,
                          delta_softplus=False, reverse=False,
                          swap_groups_c=False, y_accum=None):
    """Fused-projection scan: dt = u @ w_dt, B = u @ w_b, C = u @ w_c per
    group. `swap_groups_c`: chain pair (2k, 2k+1) consumes its partner's C
    (CroMB). `y_accum` is added into y (CrossMerge's direction-pair sum)."""
    if not _on_cuda(u, w_dt, w_b, w_c, A, D, delta_bias, y_accum):
        return selective_scan_g_proj_plain(
            u, w_dt, w_b, w_c, A, D, delta_bias, delta_softplus, reverse,
            swap_groups_c, y_accum,
        )
    io = _io_dtype(u)
    ui = u.to(io)
    G, dg = u.shape[1], u.shape[3]
    if uses_fused_projection(G, dg):
        (y,) = _fused(
            (ui,), w_dt, w_b, w_c, A, D, delta_bias, delta_softplus,
            reverse, swap_groups_c, None if y_accum is None else (y_accum,),
        )
    else:
        # projections outside the kernel, as the JAX package leaves them
        # to XLA (pallas_scan_g.py:1616-1629); autograd differentiates them
        dts = torch.matmul(ui, w_dt.to(io))
        bs = torch.matmul(ui, w_b.to(io))
        cs = torch.matmul(ui, w_c.to(io))
        if swap_groups_c:
            cs = _pair_swap(cs)
        y = _streamed(ui, dts, A, bs, cs, D, delta_bias, delta_softplus,
                      reverse, y_accum)
    return y.to(u.dtype)


def selective_scan_g_proj_ml(us, w_dt, w_b, w_c, A, D=None, delta_bias=None,
                             delta_softplus=False, reverse=False,
                             swap_groups_c=False, y_accum=None):
    """`selective_scan_g_proj` with G = 2 whose chains arrive as two
    separate (B, L, dg) layout operands and leave as two outputs (SS2D's
    row-major and transposed sequences; CroMB's two modalities)."""
    u0, u1 = us
    yas = (None, None) if y_accum is None else tuple(y_accum)
    if not _on_cuda(u0, u1, w_dt, w_b, w_c, A, D, delta_bias, *yas):
        return selective_scan_g_proj_ml_plain(
            us, w_dt, w_b, w_c, A, D, delta_bias, delta_softplus, reverse,
            swap_groups_c, y_accum,
        )
    io = _io_dtype(u0)
    if uses_fused_projection(2, u0.shape[-1]):
        y0, y1 = _fused(
            (u0.to(io), u1.to(io)), w_dt, w_b, w_c, A, D, delta_bias,
            delta_softplus, reverse, swap_groups_c, y_accum,
        )
        return y0.to(u0.dtype), y1.to(u0.dtype)
    ya = None if y_accum is None else torch.stack(yas, 1)
    y = selective_scan_g_proj(
        torch.stack((u0, u1), 1), w_dt, w_b, w_c, A, D, delta_bias,
        delta_softplus, reverse, swap_groups_c, ya,
    )
    return y[:, 0], y[:, 1]


__all__ = [
    "CK_TOKENS",
    "LAUNCHES",
    "launch_proj_grad",
    "launch_scan_bwd",
    "launch_scan_fwd",
    "launch_scan_proj_bwd",
    "launch_scan_proj_fwd",
    "proj_grad_plain",
    "reset_launches",
    "selective_scan_g",
    "selective_scan_g_plain",
    "selective_scan_g_proj",
    "selective_scan_g_proj_ml",
    "selective_scan_g_proj_ml_plain",
    "selective_scan_g_proj_plain",
    "uses_fused_projection",
]
