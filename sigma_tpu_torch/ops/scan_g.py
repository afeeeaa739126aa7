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

Kernels (`csrc/scan_g_fwd.cu`, `csrc/scan_g_bwd.cu`, `csrc/tc_gemm.cuh`,
`csrc/chunk.cuh`, `csrc/chunk_fwd.cuh`):
    K1 scan_fwd       streamed forward, chunk-parallel
    K2 scan_proj_fwd  forward that projects its own dt/B/C (tensor cores,
                      into a scratch stream), then K1's chunk-parallel scan
    K3 scan_bwd       streamed backward, chunk-parallel
    K4 scan_proj_bwd  backward that re-projects dt/B/C as K2 does (tensor
                      cores, into a scratch stream), then K3's body
    K5 proj_grad      weight gradients and the du chain term of K4
                      (tensor cores, TF32)
`LAUNCHES` counts each wrapper's calls: K2's and K4's four launches, K1's
and K3's three and K5's two count once per call; `LAUNCHES_BF16` counts
those of them whose io (u's dtype) was bf16.

K1-K4 hold the state in registers, at most 16 states (K1_MAX_STATE). A
call with a wider state runs on CUDA tensors as slices of at most 16
states (`split_state`): the fused-projection entry points then take the
streamed route (`uses_fused_projection` is false), as for calls over the
weight budget. The raw launches keep the kernels' bound.

`selective_scan_ss2d_proj` (the image-layout SS2D scan, K10 / K11) lives in
`ops/scan_img.py` and is exported here too, as JAX exports it from
`pallas_scan_g`.

A CUDA call that needs a gradient runs as a torch.autograd.Function (the
counterparts of the custom VJPs `_scan_core_g`, `_scan_core_gp`,
`_scan_core_gpa`, `_scan_core_gp_ml`, `_scan_core_gp_mla`): its forward
kernel also writes the state checkpoints `hck` (h every CK_TOKENS tokens)
and its backward runs K3, or K4 then K5. Without a gradient (eval) no
`hck` is written. Every kernel takes fp32 or bf16 io, as JAX's do: a bf16
call keeps its bf16 streams through the forward and the backward kernels,
fp32 inside them. The stream cotangents come back in the io type (du, dd,
dB, dC; K4's du is one fp32 sum of its term and K5's, rounded once), dA,
dbias, dD and the weight gradients fp32 (autograd rounds a weight's to
the dtype it entered in, as JAX's custom VJP does). `hck` is fp32
(ROADMAP C2). y_accum's cotangent is dy itself.

Not ported (TPU layout mechanics with no meaning on Hopper): batch fold,
dg tiling planners, N padding to 8, the VMEM planners, `_LOG2E`
prescaling and the TPU's hck spacing planner (`_ck_tokens`, `_CK_RATIO`).
"""

from __future__ import annotations

import torch

from sigma_tpu_torch.ops import _build
from sigma_tpu_torch.ops.selective_scan import selective_scan_cl_plain

# launches of each kernel, and of those with bf16 io; reset with
# reset_launches()
LAUNCHES = {"scan_fwd": 0, "scan_proj_fwd": 0, "scan_bwd": 0,
            "scan_proj_bwd": 0, "proj_grad": 0}
LAUNCHES_BF16 = dict.fromkeys(LAUNCHES, 0)

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
# tokens per chunk of the chunk-parallel scans (kChunk in csrc/chunk.cuh)
PROJ_CHUNK = 128
# channels per block of K3/K4: their dB/dC partials have ceil(dg / 32)
BWD_CHANNELS = 32
# the widest d_state K1-K4 take (kErrStateWidth in csrc/scan_g_*.cu); the
# entry points run a wider state as slices of at most this many
K1_MAX_STATE = 16


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = LAUNCHES_BF16[k] = 0


def _count(kernel, io):
    """One launch of `kernel` with io dtype `io`."""
    LAUNCHES[kernel] += 1
    if io == torch.bfloat16:
        LAUNCHES_BF16[kernel] += 1


def uses_fused_projection(G: int, dg: int, N: int = K1_MAX_STATE) -> bool:
    """K2 / K4 take the call: the weights fit the budget and the state fits
    the kernels' registers."""
    return 6 * G * dg * dg <= PROJ_BUDGET_BYTES and N <= K1_MAX_STATE


def split_state(scan, u, delta, A, B, C, D=None, delta_bias=None,
                delta_softplus=False, reverse=False, y_accum=None):
    """A grouped scan over d_state slices of at most K1_MAX_STATE. The
    states of the recurrence are independent, so y is the sum of the
    slices' y: the first slice adds D u and `y_accum`, each later one adds
    onto the last through its y_accum, and autograd composes the slices'
    backward. `scan(u, delta, A, B, C, D, delta_bias, delta_softplus,
    reverse, y_accum)` is one scan in `selective_scan_g`'s layout
    (A (G, n, dg), B / C (B, G, L, n))."""
    y = y_accum
    for n0 in range(0, A.shape[1], K1_MAX_STATE):
        s = slice(n0, n0 + K1_MAX_STATE)
        y = scan(u, delta, A[:, s], B[..., s], C[..., s],
                 D if n0 == 0 else None, delta_bias, delta_softplus, reverse,
                 y)
    return y


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
    y = selective_scan_cl_plain(
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


def scan_checkpoints_plain(u, dts, A, bs, delta_bias=None,
                           delta_softplus=False, reverse=False):
    """The state checkpoints the forward kernels write, from a plain
    token-by-token walk: (B, G, ceil(L / CK_TOKENS), N, dg), entry j the
    state h (B, G, N, dg) as the walk enters 32-token segment j — before
    token 32 j forward, before its last token (or L - 1) reversed. u, dts
    (B, G, L, dg) (dts the raw delta), A (G, N, dg), bs (B, G, L, N),
    delta_bias (G, dg). fp32 math (fp64 for fp64 inputs). A reference for
    the chunk-parallel kernels' `hck` that shares no code with them."""
    batch, G, L, dg = u.shape
    N = A.shape[1]
    ft = torch.promote_types(u.dtype, torch.float32)
    u, d, A, bs = u.to(ft), dts.to(ft), A.to(ft), bs.to(ft)
    if delta_bias is not None:
        d = d + delta_bias.to(ft).reshape(G, dg)[None, :, None, :]
    if delta_softplus:
        d = torch.nn.functional.softplus(d)
    du = d * u
    h = torch.zeros((batch, G, N, dg), dtype=ft, device=u.device)
    hck = torch.zeros((batch, G, _n_ck(L), N, dg), dtype=ft, device=u.device)
    order = range(L - 1, -1, -1) if reverse else range(L)
    block = 256  # tokens whose decays and inputs are formed at once
    for i0 in range(0, L, block):
        ps = list(order[i0:i0 + block])
        idx = torch.tensor(ps, device=u.device)
        a = torch.exp(d[:, :, idx, None, :] * A[None, :, None])
        b = du[:, :, idx, None, :] * bs[:, :, idx, :, None]
        for k, p in enumerate(ps):
            if (p == L - 1 or (p + 1) % CK_TOKENS == 0) if reverse \
                    else p % CK_TOKENS == 0:
                hck[:, :, p // CK_TOKENS] = h
            h = torch.addcmul(b[:, :, k], a[:, :, k], h)
    return hck


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
    """True when autograd records this call."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _cast(io, *tensors):
    return [None if t is None else t.to(io) for t in tensors]


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


def _chunk_scratch(batch, G, L, N, dg, like):
    """The chunk scans' scratch (K1, K2, K8, K10; K11's adjoints): the
    chunk states, then the carries, and the chunks' sums of d."""
    n_chunk = -(-L // PROJ_CHUNK)
    f32 = dict(dtype=torch.float32, device=like.device)
    return (torch.empty((batch, G, n_chunk, N, dg), **f32),
            torch.empty((batch, G, n_chunk, dg), **f32))


def launch_scan_fwd(u, delta, A, B, C, D=None, delta_bias=None,
                    delta_softplus=False, reverse=False, y_accum=None,
                    with_hck=False):
    """K1 on CUDA tensors of one io type (fp32 or bf16). Returns y like u,
    and with `with_hck` also the (B, G, ceil(L / CK_TOKENS), N, dg)
    checkpoints. Its three launches (chunk states, carries, emission)
    count as one."""
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
    hloc, sd = _chunk_scratch(batch, G, L, N, dg, u)
    lib = _build.library("fwd")
    with torch.cuda.device(u.device):
        code = lib.sigma_scan_fwd(
            streams[0].data_ptr(), streams[1].data_ptr(), a32.data_ptr(),
            streams[2].data_ptr(), streams[3].data_ptr(), bias.data_ptr(),
            dk.data_ptr(), _ptr(ya), y.data_ptr(), hloc.data_ptr(),
            sd.data_ptr(), hloc.shape[2], _ptr(hck), _n_ck(L),
            batch, G, L, dg, N, int(bool(delta_softplus)), int(bool(reverse)),
            int(io == torch.bfloat16), _stream(u),
        )
        _count("scan_fwd", io)
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
    `with_hck` also the state checkpoints. Its four launches (projection,
    chunk states, carries, emission) count as one."""
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
    wdt = w_dt.to(io).contiguous()
    wbc = torch.cat([w_b, w_c], -1).to(io).contiguous()
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
    # scratch: the projected [dt | B | C] stream and the chunk scan's
    proj = torch.empty((batch, G, L, dg + 2 * N), dtype=torch.float32,
                       device=us[0].device)
    hloc, sd = _chunk_scratch(batch, G, L, N, dg, us[0])
    n_chunk = hloc.shape[2]
    pad = [None] * (2 - n_u)  # the second layout pointers are null at n_u 1
    lib = _build.library("fwd")
    with torch.cuda.device(us[0].device):
        code = lib.sigma_scan_proj_fwd(
            *[_ptr(u) for u in us], *pad, wdt.data_ptr(), wbc.data_ptr(),
            a32.data_ptr(), bias.data_ptr(), dk.data_ptr(),
            *[_ptr(ya) for ya in yas], *pad,
            *[_ptr(y) for y in ys], *pad, proj.data_ptr(), hloc.data_ptr(),
            sd.data_ptr(), n_chunk, _ptr(hck), _n_ck(L),
            batch, G, L, dg, N, n_u, int(bool(delta_softplus)),
            int(bool(reverse)), int(bool(swap_groups_c)),
            int(io == torch.bfloat16), _stream(us[0]),
        )
        _count("scan_proj_fwd", io)
    _build.check(code, "scan_proj_fwd")
    return (ys, hck) if with_hck else ys


def _f32(t):
    if t.dtype != torch.float32:
        raise TypeError(f"the backward scan kernels take fp32, not {t.dtype}")
    return t.contiguous()


def _bwd_io(*tensors):
    """The io type of a backward launch: the dtype its streams share, fp32
    or bf16; anything else raises."""
    io = tensors[0].dtype
    if io not in (torch.float32, torch.bfloat16) or any(
            t.dtype != io for t in tensors):
        raise TypeError("the backward scan kernels take streams of one io "
                        "dtype, fp32 or bf16, not "
                        f"{[t.dtype for t in tensors]}")
    return io


def _bwd_outputs(batch, G, L, dg, N, like, dd_dtype=torch.float32):
    """K3 / K4's outputs and scratch: dd (in `dd_dtype`), the per-chunk dA
    / dbias / dD partials, the per-channel-block dB / dC partials, the
    chunks' adjoints and sums of d (fp32)."""
    nblk = -(-dg // BWD_CHANNELS)
    n_chunk = -(-L // PROJ_CHUNK)
    f = dict(dtype=torch.float32, device=like.device)
    return dict(
        dd=torch.empty((batch, G, L, dg), dtype=dd_dtype, device=like.device),
        dA=torch.empty((batch, G, n_chunk, N, dg), **f),
        dbias=torch.empty((batch, G, n_chunk, dg), **f),
        dD=torch.empty((batch, G, n_chunk, dg), **f),
        dBp=torch.empty((batch, nblk, G, L, N), **f),
        dCp=torch.empty((batch, nblk, G, L, N), **f),
        lam=torch.empty((batch, G, n_chunk, N, dg), **f),
        sd=torch.empty((batch, G, n_chunk, dg), **f))


def _bwd_pointers(o):
    """The pointers of `_bwd_outputs` in the kernels' order, then
    n_chunk."""
    keys = ("dd", "dA", "dbias", "dD", "dBp", "dCp", "lam", "sd")
    return [o[k].data_ptr() for k in keys] + [o["sd"].shape[2]]


def _bwd_sums(o):
    """dA, dbias, dD summed over batch and chunks, dB / dC over channel
    blocks: torch's reductions, a fixed order."""
    return (o["dA"].sum((0, 2)), o["dbias"].sum((0, 2)), o["dD"].sum((0, 2)),
            o["dBp"].sum(1), o["dCp"].sum(1))


def launch_scan_bwd(u, delta, A, B, C, D, delta_bias, hck, dy,
                    delta_softplus=False, reverse=False):
    """K3: the streamed backward from K1's checkpoints, CUDA tensors; u,
    delta, B, C and dy of one io type (fp32 or bf16). Returns (du, dd, dA,
    dB, dC, dbias, dD): the stream cotangents du, dd, dB, dC in the io
    type, dA, dbias, dD fp32; the per-chunk, per-block and per-batch
    partials are summed here in fp32, then rounded. Its three launches
    (chunk adjoints, carries, emission) count as one."""
    batch, G, L, dg = u.shape
    N = A.shape[1]
    _expect(dy, u.shape, "dy")
    _expect(hck, (batch, G, _n_ck(L), N, dg), "hck")
    io = _bwd_io(u, delta, B, C, dy)
    u, delta, B, C, dy = (t.contiguous() for t in (u, delta, B, C, dy))
    hck = _f32(hck)
    a32 = _param(A, (G, N, dg), u)
    bias = _param(delta_bias, (G, dg), u)
    dk = _param(D, (G, dg), u)
    du = torch.empty_like(u)
    o = _bwd_outputs(batch, G, L, dg, N, u, dd_dtype=io)
    lib = _build.library("bwd")
    with torch.cuda.device(u.device):
        code = lib.sigma_scan_bwd(
            u.data_ptr(), delta.data_ptr(), a32.data_ptr(), B.data_ptr(),
            C.data_ptr(), bias.data_ptr(), dk.data_ptr(), hck.data_ptr(),
            dy.data_ptr(), du.data_ptr(), *_bwd_pointers(o),
            batch, G, L, dg, N, hck.shape[2], int(bool(delta_softplus)),
            int(bool(reverse)), int(io == torch.bfloat16), _stream(u),
        )
        _count("scan_bwd", io)
    _build.check(code, "scan_bwd", "bwd")
    dA, dbias, dD, dB, dC = _bwd_sums(o)
    return du, o["dd"], dA, dB.to(io), dC.to(io), dbias, dD


def launch_scan_proj_bwd(us, w_dt, w_b, w_c, A, D, delta_bias, hck, dys,
                         delta_softplus=False, reverse=False,
                         swap_groups_c=False):
    """K4: the fused-projection backward, CUDA tensors, `us` / `dys` as for
    K2, of one io type (fp32 or bf16); the weights are taken in it, as K2
    takes them. Returns (du like `us` in fp32 — the direct term only: K5
    adds the chain term, and the caller rounds the sum to the io type —,
    dd, dB, dC, dA, dbias, dD, all fp32): dd / dB / dC are the cotangents
    of the projected streams, dC routed to the chain whose projection made
    the C (the partner under `swap_groups_c`). Its four launches (the
    projections into a scratch stream, as K2 makes them, then K3's three)
    count as one."""
    n_u = len(us)
    batch, G, L, dg = _layouts(us)
    N = A.shape[1]
    for dy in dys:
        _expect(dy, us[0].shape, "dy")
    _expect(hck, (batch, G, _n_ck(L), N, dg), "hck")
    io = _bwd_io(*us, *dys)
    us = [u.contiguous() for u in us]
    dys = [dy.contiguous() for dy in dys]
    hck = _f32(hck)
    _expect(w_dt, (G, dg, dg), "w_dt")
    _expect(w_b, (G, dg, N), "w_b")
    _expect(w_c, (G, dg, N), "w_c")
    wdt = w_dt.to(io).contiguous()
    wbc = torch.cat([w_b, w_c], -1).to(io).contiguous()
    a32 = _param(A, (G, N, dg), us[0])
    bias = _param(delta_bias, (G, dg), us[0])
    dk = _param(D, (G, dg), us[0])
    dus = [torch.empty_like(u, dtype=torch.float32) for u in us]
    o = _bwd_outputs(batch, G, L, dg, N, us[0])
    # scratch: the projected [dt | B | C] stream
    proj = torch.empty((batch, G, L, dg + 2 * N), dtype=torch.float32,
                       device=us[0].device)
    pad = [None] * (2 - n_u)
    lib = _build.library("bwd")
    with torch.cuda.device(us[0].device):
        code = lib.sigma_scan_proj_bwd(
            *[_ptr(u) for u in us], *pad, wdt.data_ptr(), wbc.data_ptr(),
            a32.data_ptr(), bias.data_ptr(), dk.data_ptr(), hck.data_ptr(),
            *[_ptr(dy) for dy in dys], *pad, *[_ptr(du) for du in dus], *pad,
            proj.data_ptr(), *_bwd_pointers(o),
            batch, G, L, dg, N, hck.shape[2], n_u, int(bool(delta_softplus)),
            int(bool(reverse)), int(bool(swap_groups_c)),
            int(io == torch.bfloat16), _stream(us[0]),
        )
        _count("scan_proj_bwd", io)
    _build.check(code, "scan_proj_bwd", "bwd")
    dA, dbias, dD, dB, dC = _bwd_sums(o)
    return dus, o["dd"], dB, dC, dA, dbias, dD


def _proj_grad_splits(batch, G, L, dg, N):
    """Token splits per batch element of K5's weight gradient: enough
    64 x 64 tiles to fill the card about four blocks per SM (132 SMs),
    each split at least 256 tokens."""
    tiles_d = -(-dg // 64)
    tiles = G * batch * tiles_d * (tiles_d + -(-2 * N // 64))
    return max(1, min(-(-4 * 132 // tiles), -(-L // 256)))


def launch_proj_grad(us, dus, dd, dB, dC, w_dt, w_b, w_c):
    """K5 on CUDA tensors: adds the chain term [dd | dB | dC] W^T into the
    fp32 `dus` in place and returns (dW_dt, dW_B, dW_C) in fp32, K4's
    cotangents contracted with u over every token (split over tokens into
    partials that are summed here, in a fixed order). `us` fp32 or bf16
    (read as they are, the product's A operand); dd, dB, dC fp32 (K4's);
    the weights in fp32 (a bf16 weight is exact in it)."""
    n_u = len(us)
    batch, G, L, dg = _layouts(us)
    N = w_b.shape[-1]
    kz = dg + 2 * N
    n_l = _proj_grad_splits(batch, G, L, dg, N)
    dW = torch.empty((n_l * batch, G, dg, kz), dtype=torch.float32,
                     device=us[0].device)
    io = _bwd_io(*us)
    us = [u.contiguous() for u in us]
    dd = _f32(dd)
    dbc = torch.cat([_f32(dB), _f32(dC)], -1)
    wdt = w_dt.float().contiguous()
    wbc = torch.cat([w_b, w_c], -1).float().contiguous()
    for du in dus:
        if not du.is_contiguous() or du.dtype != torch.float32:
            raise ValueError("du must be contiguous fp32 (updated in place)")
    pad = [None] * (2 - n_u)
    lib = _build.library("bwd")
    with torch.cuda.device(us[0].device):
        code = lib.sigma_proj_grad(
            *[_ptr(u) for u in us], *pad, *[_ptr(du) for du in dus], *pad,
            dd.data_ptr(), dbc.data_ptr(), wdt.data_ptr(), wbc.data_ptr(),
            dW.data_ptr(), batch, G, L, dg, N, n_u, n_l,
            int(io == torch.bfloat16), _stream(us[0]),
        )
        _count("proj_grad", io)
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
        # du: K4's and K5's terms summed in fp32, rounded to u's dtype once
        dus = [du.to(u.dtype) for du, u in zip(dus, us)]
        dya = dys if has_ya else (None, None)
        return (dus[0], dus[1] if u1 is not None else None,
                _grad_like(dw_dt, w_dt), _grad_like(dw_b, w_b),
                _grad_like(dw_c, w_c), dA.reshape(A.shape), _grad_like(dD, D),
                _grad_like(dbias, bias), dya[0],
                dya[1] if u1 is not None else None, None, None, None)


def _streamed(u, dts, A, bs, cs, D, delta_bias, softplus, reverse,
              y_accum=None):
    """K1 on CUDA tensors, through the autograd Function when a gradient is
    needed; a state wider than K1's as slices of it."""
    if A.shape[1] > K1_MAX_STATE:
        return split_state(_streamed, u, dts, A, bs, cs, D, delta_bias,
                           softplus, reverse, y_accum)
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
    y = _streamed(*_cast(io, u, delta), A, *_cast(io, B, C), D, delta_bias,
                  delta_softplus, reverse)
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
    ui, w_dt, w_b, w_c, y_accum = _cast(io, u, w_dt, w_b, w_c, y_accum)
    G, dg = u.shape[1], u.shape[3]
    if uses_fused_projection(G, dg, A.shape[1]):
        (y,) = _fused(
            (ui,), w_dt, w_b, w_c, A, D, delta_bias, delta_softplus,
            reverse, swap_groups_c, None if y_accum is None else (y_accum,),
        )
    else:
        # projections outside the kernel, as the JAX package leaves them
        # to XLA (pallas_scan_g.py:1616-1629); autograd differentiates them
        dts = torch.matmul(ui, w_dt)
        bs = torch.matmul(ui, w_b)
        cs = torch.matmul(ui, w_c)
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
    if uses_fused_projection(2, u0.shape[-1], A.shape[1]):
        y0, y1 = _fused(
            _cast(io, u0, u1), *_cast(io, w_dt, w_b, w_c), A, D, delta_bias,
            delta_softplus, reverse, swap_groups_c,
            None if y_accum is None else _cast(io, *yas),
        )
        return y0.to(u0.dtype), y1.to(u0.dtype)
    ya = None if y_accum is None else torch.stack(yas, 1)
    y = selective_scan_g_proj(
        torch.stack((u0, u1), 1), w_dt, w_b, w_c, A, D, delta_bias,
        delta_softplus, reverse, swap_groups_c, ya,
    )
    return y[:, 0], y[:, 1]


def __getattr__(name):
    # the image-layout entry point, imported at first use: ops/scan_img.py
    # imports this module
    if name == "selective_scan_ss2d_proj":
        from sigma_tpu_torch.ops.scan_img import selective_scan_ss2d_proj

        return selective_scan_ss2d_proj
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CK_TOKENS",
    "K1_MAX_STATE",
    "LAUNCHES",
    "LAUNCHES_BF16",
    "PROJ_CHUNK",
    "launch_proj_grad",
    "launch_scan_bwd",
    "launch_scan_fwd",
    "launch_scan_proj_bwd",
    "launch_scan_proj_fwd",
    "proj_grad_plain",
    "reset_launches",
    "scan_checkpoints_plain",
    "selective_scan_g",
    "selective_scan_g_plain",
    "selective_scan_g_proj",
    "selective_scan_g_proj_ml",
    "selective_scan_g_proj_ml_plain",
    "selective_scan_g_proj_plain",
    "selective_scan_ss2d_proj",
    "split_state",
    "uses_fused_projection",
]
