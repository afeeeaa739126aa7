"""Image-layout SS2D scan on Hopper, with its gradient: the counterpart of
`sigma_tpu/ops/pallas_scan_g.py::selective_scan_ss2d_proj` (:1823-2436).

One call runs the four SS2D directions of one (B, H, W, dg) image —
forward and reverse over the row-major (hw) and the column-major (wh)
layout — with dt/B/C projected in-kernel, and returns their CrossMerge
sum in image order. Weights are indexed [direction, layout]:

    x (B, H, W, dg); w_dt (2, 2, dg, dg); w_b, w_c (2, 2, dg, N);
    A (2, 2, N, dg) negative; D, delta_bias (2, 2, dg) optional

Kernels (`csrc/scan_img.cu`):
    K10 scan_img_fwd  all four chains in one call: their projections on the
                      tensor cores into a scratch stream, then the chunk-
                      parallel scan K1 and K2 run (`csrc/chunk_fwd.cuh`),
                      y as one plane per chain (summed here); with a
                      gradient it also writes the state checkpoints `hck`
    K11 scan_img_bwd  K10's projections again, then the chunk-parallel
                      backward K3 and K4 run (`csrc/chunk_bwd.cuh`) over
                      the four chains from `hck`
and the weight gradients and du's chain term run on K5
(`launch_proj_grad`, `csrc/scan_g_bwd.cu`), once per direction with the
two layouts' cotangents in image order and us = (x, x). `LAUNCHES` counts
K10 / K11 once per call (four launches each); K5's launches count in
`scan_g.LAUNCHES`.

Dispatch goes by the device of `x`: a CPU tensor takes the plain version
(`selective_scan_ss2d_proj_plain`, differentiated by autograd); a CUDA
tensor launches the kernels or raises — there is no fallback. The
backward is fp32: a bf16 call with a gradient runs in fp32 from the entry
on (`_entry_io`) and returns bf16 y and gradients; the checkpoints are
fp32 (ROADMAP C2). K11's bf16 io is still to be ported (ROADMAP queue B).

Decided difference (ROADMAP C7): JAX returns None where its planner
(`_plan_img`) finds no VMEM tiling and its caller falls back to the
stacked-layout path. The port has no planner and returns y at every
geometry: the value that fallback computes. `fold_batch` (TPU chain
grouping) is accepted and changes nothing.
"""

from __future__ import annotations

import torch

from sigma_tpu_torch.ops import _build, scan_g

# launches of each kernel; reset with reset_launches()
LAUNCHES = {"scan_img_fwd": 0, "scan_img_bwd": 0}

# checkpoint spacing in tokens (kTok in csrc/scan_img.cu)
IMG_CK_TOKENS = 32
# channels per block of K11: its dB / dC partials have ceil(dg / 32)
IMG_BWD_CHANNELS = scan_g.BWD_CHANNELS
# the widest d_state K10 / K11 take
IMG_MAX_STATE = 256


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _opt(t, d):
    return None if t is None else t[d]


# ------------------------------------------------------------ plain version
def selective_scan_ss2d_proj_plain(x, w_dt, w_b, w_c, A, D=None,
                                   delta_bias=None, delta_softplus=False,
                                   remat_chunks=False):
    """The stacked-layout composition (the JAX test's `_img_ref`): the
    row-major and transposed sequences as two layout operands, one
    direction-paired fused-projection scan per direction (reversed for
    direction 1), the wh output un-transposed and the four summed. fp32
    math; y has x's dtype. `remat_chunks` as in `ops/selective_scan.py`."""
    b, H, W, dg = x.shape
    L = H * W
    xf = x.float()
    us = (xf.reshape(b, L, dg), xf.transpose(1, 2).reshape(b, L, dg))
    y = None
    for d in range(2):
        y = scan_g.selective_scan_g_proj_ml_plain(
            us, w_dt[d], w_b[d], w_c[d], A[d], _opt(D, d),
            _opt(delta_bias, d), delta_softplus, reverse=d == 1, y_accum=y,
            remat_chunks=remat_chunks)
    y_hw, y_wh = y
    out = y_hw.reshape(b, H, W, dg) + y_wh.reshape(b, W, H, dg).transpose(
        1, 2)
    return out.to(x.dtype)


def scan_checkpoints_img_plain(x, w_dt, w_b, A, delta_bias=None,
                               delta_softplus=False):
    """The state checkpoints K10 writes, in K11's layout (2, 2, B,
    ceil(H W / 32), N, dg), from the plain token-by-token walk
    (`scan_g.scan_checkpoints_plain`): per direction, the row-major and the
    transposed sequence as two chains, reversed for direction 1. fp32
    math (fp64 for fp64 inputs)."""
    b, H, W, dg = x.shape
    ft = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ft)
    u = torch.stack([xf.reshape(b, H * W, dg),
                     xf.transpose(1, 2).reshape(b, H * W, dg)], 1)
    out = []
    for d in range(2):
        dts = torch.einsum("bgld,gde->bgle", u, w_dt[d].to(ft))
        bs = torch.einsum("bgld,gdn->bgln", u, w_b[d].to(ft))
        hck = scan_g.scan_checkpoints_plain(
            u, dts, A[d], bs, _opt(delta_bias, d), delta_softplus,
            reverse=d == 1)
        out.append(hck.transpose(0, 1))  # (layout, B, n_ck, N, dg)
    return torch.stack(out)


# ------------------------------------------------------------ kernel launches
def _n_ck(L):
    return -(-L // IMG_CK_TOKENS)


def _check(x, w_dt, w_b, w_c, A, D, delta_bias):
    """(batch, H, W, dg, N) of one call; raises on what K10 / K11 do not
    take."""
    batch, H, W, dg = x.shape
    N = A.shape[-2]
    if N > IMG_MAX_STATE:
        raise ValueError(f"d_state {N}: the image scan kernels take at most "
                         f"{IMG_MAX_STATE}")
    scan_g._expect(w_dt, (2, 2, dg, dg), "w_dt")
    scan_g._expect(w_b, (2, 2, dg, N), "w_b")
    scan_g._expect(w_c, (2, 2, dg, N), "w_c")
    scan_g._expect(A, (2, 2, N, dg), "A")
    for name, t in (("D", D), ("delta_bias", delta_bias)):
        if t is not None:
            scan_g._expect(t, (2, 2, dg), name)
    if not scan_g._on_cuda(x, w_dt, w_b, w_c, A, D, delta_bias):
        raise ValueError(f"the image scan kernels take CUDA tensors, not "
                         f"{x.device}")
    return batch, H, W, dg, N


def launch_scan_img_fwd(x, w_dt, w_b, w_c, A, D=None, delta_bias=None,
                        delta_softplus=False, with_hck=False):
    """K10 on CUDA tensors of one io type (fp32 or bf16). Returns y
    (B, H, W, dg) like x — the four chains' planes summed — and with
    `with_hck` also the (2, 2, B, ceil(H W / 32), N, dg) checkpoints."""
    batch, H, W, dg, N = _check(x, w_dt, w_b, w_c, A, D, delta_bias)
    io = x.dtype
    if io not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scan io dtype {io}")
    x = x.contiguous()
    wdt = w_dt.to(io).contiguous()
    wbc = torch.cat([w_b, w_c], -1).to(io).contiguous()
    a32 = scan_g._param(A, (2, 2, N, dg), x)
    bias = scan_g._param(delta_bias, (2, 2, dg), x)
    dk = scan_g._param(D, (2, 2, dg), x)
    L = H * W
    y4 = torch.empty((2, 2, batch, H, W, dg), dtype=io, device=x.device)
    hck = (torch.empty((2, 2, batch, _n_ck(L), N, dg), dtype=torch.float32,
                       device=x.device) if with_hck else None)
    # scratch: each chain's projected [dt | B | C] in its token order and
    # the chunk scan's
    proj = torch.empty((batch, 4, L, dg + 2 * N), dtype=torch.float32,
                       device=x.device)
    hloc, sd = scan_g._chunk_scratch(batch, 4, L, N, dg, x)
    lib = _build.library("img")
    with torch.cuda.device(x.device):
        code = lib.sigma_scan_img_fwd(
            x.data_ptr(), wdt.data_ptr(), wbc.data_ptr(), a32.data_ptr(),
            bias.data_ptr(), dk.data_ptr(), y4.data_ptr(), proj.data_ptr(),
            hloc.data_ptr(), sd.data_ptr(), hloc.shape[2], scan_g._ptr(hck),
            _n_ck(L), batch, H, W, dg, N, int(bool(delta_softplus)),
            int(io == torch.bfloat16), scan_g._stream(x),
        )
        LAUNCHES["scan_img_fwd"] += 1
    _build.check(code, "scan_img_fwd", "img")
    y = y4.sum((0, 1), dtype=torch.float32).to(io)
    return (y, hck) if with_hck else y


def launch_scan_img_bwd(x, w_dt, w_b, w_c, A, D, delta_bias, hck, dy,
                        delta_softplus=False):
    """K11: the chunk-parallel backward from K10's checkpoints, fp32 CUDA
    tensors. Returns (du planes (2, 2, B, H*W, dg) — the direct term per
    (direction, layout), K5 adds the chain term —, dd (2, B, 2, H*W, dg),
    dB, dC (2, B, 2, H*W, N), dA (2, 2, N, dg), dbias, dD (2, 2, dg)): dd /
    dB / dC are the cotangents of the projected streams, in image order per
    (direction, batch, layout); the channel-block, chunk and batch partials
    are summed here, a fixed order."""
    batch, H, W, dg, N = _check(x, w_dt, w_b, w_c, A, D, delta_bias)
    L = H * W
    scan_g._expect(dy, x.shape, "dy")
    scan_g._expect(hck, (2, 2, batch, _n_ck(L), N, dg), "hck")
    x, dy, hck, wdt = (scan_g._f32(t) for t in (x, dy, hck, w_dt))
    wbc = torch.cat([scan_g._f32(w_b), scan_g._f32(w_c)], -1).contiguous()
    a32 = scan_g._param(A, (2, 2, N, dg), x)
    bias = scan_g._param(delta_bias, (2, 2, dg), x)
    dk = scan_g._param(D, (2, 2, dg), x)
    nblk = -(-dg // IMG_BWD_CHANNELS)
    f = dict(dtype=torch.float32, device=x.device)
    du4 = torch.empty((2, 2, batch, L, dg), **f)
    dd = torch.empty((2, batch, 2, L, dg), **f)
    dBp = torch.empty((2, batch, nblk, 2, L, N), **f)
    dCp = torch.empty((2, batch, nblk, 2, L, N), **f)
    # scratch: K10's projections, the chunks' adjoints and sums of d; the
    # per-chunk partials of dA / dbias / dD share their shapes
    proj = torch.empty((batch, 4, L, dg + 2 * N), **f)
    lam, sd = scan_g._chunk_scratch(batch, 4, L, N, dg, x)
    dA, dbias, dD = (torch.empty_like(t) for t in (lam, sd, sd))
    lib = _build.library("img")
    with torch.cuda.device(x.device):
        code = lib.sigma_scan_img_bwd(
            x.data_ptr(), wdt.data_ptr(), wbc.data_ptr(), a32.data_ptr(),
            bias.data_ptr(), dk.data_ptr(), hck.data_ptr(), dy.data_ptr(),
            du4.data_ptr(), proj.data_ptr(), dd.data_ptr(), dA.data_ptr(),
            dbias.data_ptr(), dD.data_ptr(), dBp.data_ptr(), dCp.data_ptr(),
            lam.data_ptr(), sd.data_ptr(), lam.shape[2], _n_ck(L), batch, H,
            W, dg, N, int(bool(delta_softplus)), scan_g._stream(x),
        )
        LAUNCHES["scan_img_bwd"] += 1
    _build.check(code, "scan_img_bwd", "img")
    return (du4, dd, dBp.sum(2), dCp.sum(2),
            dA.sum((0, 2)).reshape(2, 2, N, dg),
            dbias.sum((0, 2)).reshape(2, 2, dg),
            dD.sum((0, 2)).reshape(2, 2, dg))


def _chain_grads(x, du4, dd, dB, dC, w_dt, w_b, w_c):
    """K5 once per direction: adds the chain term into `du4`'s planes in
    place and returns the stacked (dW_dt, dW_B, dW_C), each (2, 2, ...)."""
    batch, H, W, dg = x.shape
    xs = scan_g._f32(x).reshape(batch, H * W, dg)
    grads = [scan_g.launch_proj_grad(
        (xs, xs), (du4[d, 0], du4[d, 1]), dd[d], dB[d], dC[d], w_dt[d],
        w_b[d], w_c[d]) for d in range(2)]
    return tuple(torch.stack(g) for g in zip(*grads))


# ------------------------------------------------------------ autograd
class _ScanImg(torch.autograd.Function):
    """K10 (+ hck) forward, K11 + K5 backward (`_scan_core_img`)."""

    @staticmethod
    def forward(ctx, x, w_dt, w_b, w_c, A, D, delta_bias, softplus):
        y, hck = launch_scan_img_fwd(x, w_dt, w_b, w_c, A, D, delta_bias,
                                     softplus, with_hck=True)
        ctx.save_for_backward(x, w_dt, w_b, w_c, A, D, delta_bias, hck)
        ctx.softplus = softplus
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w_dt, w_b, w_c, A, D, bias, hck = ctx.saved_tensors
        du4, dd, dB, dC, dA, dbias, dD = launch_scan_img_bwd(
            x, w_dt, w_b, w_c, A, D, bias, hck, dy, ctx.softplus)
        dw_dt, dw_b, dw_c = _chain_grads(x, du4, dd, dB, dC, w_dt, w_b, w_c)
        dx = du4.sum((0, 1)).reshape(x.shape)
        return (dx, dw_dt, dw_b, dw_c, dA.reshape(A.shape),
                scan_g._grad_like(dD, D), scan_g._grad_like(dbias, bias),
                None)


# ------------------------------------------------------------ entry point
def _entry_io(x, *tensors):
    """The io type of a CUDA call: bf16 for bf16 x, else fp32. A bf16 call
    that needs a gradient runs in fp32 from the entry on, because K11 is
    fp32; the casts are part of autograd's graph, so the gradients come
    back in their inputs' dtypes."""
    io = scan_g._io_dtype(x)
    if io == torch.bfloat16 and scan_g._needs_grad(x, *tensors):
        return torch.float32
    return io


def selective_scan_ss2d_proj(x, w_dt, w_b, w_c, A, D=None, delta_bias=None,
                             delta_softplus=False, fold_batch=True):
    """The four-direction SS2D scan of image x with in-kernel projections;
    returns the CrossMerge sum y (B, H, W, dg) with x's dtype, fp32 math.
    Arguments as in the module docstring; `fold_batch` changes nothing."""
    del fold_batch  # TPU chain grouping; the result does not depend on it
    if not scan_g._on_cuda(x, w_dt, w_b, w_c, A, D, delta_bias):
        return selective_scan_ss2d_proj_plain(x, w_dt, w_b, w_c, A, D,
                                              delta_bias, delta_softplus)
    io = _entry_io(x, w_dt, w_b, w_c, A, D, delta_bias)
    xi = x.to(io)
    if scan_g._needs_grad(xi, w_dt, w_b, w_c, A, D, delta_bias):
        y = _ScanImg.apply(xi, *scan_g._cast(io, w_dt, w_b, w_c), A, D,
                           delta_bias, bool(delta_softplus))
    else:
        y = launch_scan_img_fwd(xi, w_dt, w_b, w_c, A, D, delta_bias,
                                delta_softplus)
    return y.to(x.dtype)


__all__ = [
    "IMG_CK_TOKENS",
    "IMG_MAX_STATE",
    "LAUNCHES",
    "launch_scan_img_bwd",
    "launch_scan_img_fwd",
    "reset_launches",
    "scan_checkpoints_img_plain",
    "selective_scan_ss2d_proj",
    "selective_scan_ss2d_proj_plain",
]
