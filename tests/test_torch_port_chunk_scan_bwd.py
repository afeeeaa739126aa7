"""The algebra of the chunk-parallel scan backward K3 / K4
(`csrc/scan_g_bwd.cu`), on the CPU.

The kernels run on the card only. Their decomposition is modelled here in
plain torch, step for step: the sequence is cut into chunks of PROJ_CHUNK
tokens in physical order, each walked in the walk's order (reversed in
place for `reverse`, the last chunk ragged, tokens past L identities);
every lane of 32 holds PROJ_CHUNK / 32 consecutive walk positions. Pass 1
folds each lane's adjoint map x -> a_t (C_t dy_t + x) and composes the
lanes against the walk by a doubling scan: the chunk's adjoint leaving it
from a zero adjoint at its exit, and its sum of d. The carry pass walks the
chunks against the walk, carry' = exp(A sum d) carry + local. Pass 3
recomputes h inside every 32-token segment from its checkpoint (a doubling
scan over the segment's 8 lanes), re-sweeps the adjoint from the chunk's
true exit adjoint, and forms du (the direct term), dd, and per-chunk dA /
dbias / dD and per-32-channel dB / dC partials, summed afterwards. K4's
weight gradients and du chain term are K5's products (`proj_grad_plain`).
The fused-projection cases model K2 + K4 + K5 as they run at fp32 io: the
streams projected in 3xTF32 (`project_3xtf32`), the checkpoints from K2's
one-pass scan (`chain_scan_model`), K5's products in 1xTF32 (`tf32`).

All seven gradients are held to JAX's (`jax.vjp` of `selective_scan_g`,
`selective_scan_g_proj`, `selective_scan_g_proj_ml`, their Pallas
backward in interpret mode, as tests/test_pallas_scan_g.py runs it) at the
fp32 tier, rtol 6e-4 / atol 2e-3 against max(|ref|, 1), as chip_smoke.py
holds K3 / K4; the carries are held to a sequential adjoint walk in fp64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.ops import pallas_scan_g as jscan
from sigma_tpu_torch.ops.scan_g import (
    BWD_CHANNELS,
    CK_TOKENS,
    PROJ_CHUNK,
    _pair_swap,
    proj_grad_plain,
)
from test_torch_port_chunk_scan import (
    LANES,
    _walk,
    chain_scan_model,
    project_3xtf32,
    sequential_states,
)
from test_torch_port_tf32 import tf32

torch.set_num_threads(2)
RTOL, ATOL = 6e-4, 2e-3
ITEMS = PROJ_CHUNK // LANES
SEG_LANES = CK_TOKENS // ITEMS


def _lane_scan(fa, fb, width, down):
    """Inclusive scans of x -> a x + b over groups of `width` lanes (axis
    -3) by doubling, the group's first lane first, or (down) over all
    lanes with lane 31 first: each lane's own map is applied last."""
    lanes = fa.shape[-3]
    lane = torch.arange(lanes).reshape(-1, 1, 1)
    off = 1
    while off < width:
        src = lane + off if down else lane - off
        ok = (src < lanes) if down else (lane % width >= off)
        src = src.clamp(0, lanes - 1).flatten()
        qa, qb = fa[..., src, :, :], fb[..., src, :, :]
        fb = torch.where(ok, fa * qb + fb, fb)
        fa = torch.where(ok, fa * qa, fa)
        off *= 2
    return fa, fb


def _unwalk(x, L, reverse):
    """(batch, G, n_chunk, PROJ_CHUNK, ...) in walk order back to physical
    (batch, G, L, ...)."""
    if reverse:
        x = x.flip(3)
    return x.reshape(*x.shape[:2], -1, *x.shape[4:])[:, :, :L]


def chunk_bwd_model(u, dts, bs, cs, A, D, bias, softplus, reverse, dy, hck):
    """K3's backward in plain torch. u, dts, dy (batch, G, L, dg); bs, cs
    (batch, G, L, N), C already routed to its chain; A (G, N, dg); D, bias
    (G, dg); hck (batch, G, ceil(L / 32), N, dg). Returns ({du (the direct
    term), dd, dA, dB, dC, dbias, dD}, the exit adjoint of every chunk
    (batch, G, n_chunk, dg, N))."""
    batch, G, L, dg = u.shape
    N = A.shape[1]
    n_chunk = -(-L // PROJ_CHUNK)
    pre = dts + bias[None, :, None, :]
    d = torch.nn.functional.softplus(pre) if softplus else pre
    dw, uw, yw = (_walk(t, n_chunk, reverse) for t in (d, u, dy))
    bw, cw = _walk(bs, n_chunk, reverse), _walk(cs, n_chunk, reverse)
    At = A.transpose(1, 2)[None, :, None, None]           # (1, G, 1, 1, dg, N)
    lanes = (batch, G, n_chunk, LANES, ITEMS, dg, N)
    a = torch.exp(dw[..., None] * At).reshape(lanes)
    b = ((dw * uw)[..., None] * bw[..., None, :]).reshape(lanes)
    c = (yw[..., None] * cw[..., None, :]).reshape(lanes)

    # pass 1: each lane's adjoint map, the lanes composed against the walk
    ga = torch.ones_like(a[:, :, :, :, 0])
    gb = torch.zeros_like(a[:, :, :, :, 0])
    for j in reversed(range(ITEMS)):
        gb = a[:, :, :, :, j] * (gb + c[:, :, :, :, j])
        ga = ga * a[:, :, :, :, j]
    ga, gb = _lane_scan(ga, gb, LANES, down=True)
    local = gb[:, :, :, 0]                                 # (b, G, c, dg, N)
    sd = dw.sum(3)                                         # (b, G, c, dg)
    # the carries, against the walk: the adjoint entering each chunk's exit
    carry = torch.zeros_like(local[:, :, 0])
    lam = [None] * n_chunk
    for ci in (range(n_chunk) if reverse else range(n_chunk - 1, -1, -1)):
        lam[ci] = carry
        decay = torch.exp(A.transpose(1, 2)[None] * sd[:, :, ci, :, None])
        carry = decay * carry + local[:, :, ci]
    lam = torch.stack(lam, 2)

    # pass 3: h from each segment's checkpoint through its earlier lanes
    fa = torch.ones_like(ga)
    fb = torch.zeros_like(gb)
    for j in range(ITEMS):
        fb = a[:, :, :, :, j] * fb + b[:, :, :, :, j]
        fa = fa * a[:, :, :, :, j]
    fa, fb = _lane_scan(fa, fb, SEG_LANES, down=False)
    first = torch.arange(LANES) % SEG_LANES == 0
    xa = torch.where(first[:, None, None], 1.0, fa.roll(1, -3))
    xb = torch.where(first[:, None, None], 0.0, fb.roll(1, -3))
    n_ck = hck.shape[2]
    hk = torch.zeros(batch, G, n_chunk, PROJ_CHUNK // CK_TOKENS, dg, N,
                     dtype=u.dtype)
    for ci in range(n_chunk):
        for s in range(PROJ_CHUNK // CK_TOKENS):
            k = s * CK_TOKENS
            j = (ci * PROJ_CHUNK + PROJ_CHUNK - 1 - k if reverse
                 else ci * PROJ_CHUNK + k) // CK_TOKENS
            if j < n_ck:
                hk[:, :, ci, s] = hck[:, :, j].transpose(-1, -2)
    h = xa * hk.repeat_interleave(SEG_LANES, 3) + xb
    hp, hs = [], []
    for j in range(ITEMS):
        hp.append(h)
        h = a[:, :, :, :, j] * h + b[:, :, :, :, j]
        hs.append(h)
    # the adjoint from each chunk's exit through the later lanes
    last = torch.arange(LANES) == LANES - 1
    za = torch.where(last[:, None, None], 1.0, ga.roll(-1, -3))
    zb = torch.where(last[:, None, None], 0.0, gb.roll(-1, -3))
    dh = za * lam[:, :, :, None] + zb
    dhs = [None] * ITEMS
    for j in reversed(range(ITEMS)):
        dh = dh + c[:, :, :, :, j]
        dhs[j] = dh
        dh = a[:, :, :, :, j] * dh
    dh, hp, hs = (torch.stack(t, 4).reshape(
        batch, G, n_chunk, PROJ_CHUNK, dg, N) for t in (dhs, hp, hs))
    a = a.reshape(dh.shape)
    dah = dh * a * hp
    sb = (dh * bw[..., None, :]).sum(-1)
    sa = (dah * At).sum(-1)
    valid = _walk(torch.ones(batch, G, L, 1, dtype=u.dtype), n_chunk,
                  reverse)
    dd = (sa + uw * sb) * valid
    if softplus:
        dd = dd * -torch.expm1(-dw)        # sigmoid(pre), as the kernel
    du = dw * sb + D[None, :, None, None] * yw
    # per-chunk partials, per-32-channel partials, then their sums
    dA = (dah * dw[..., None]).sum(3).sum((0, 2)).transpose(-1, -2)
    nblk = -(-dg // BWD_CHANNELS)
    pad = nblk * BWD_CHANNELS - dg

    def channel_blocks(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        return x.reshape(*x.shape[:4], nblk, BWD_CHANNELS, N).sum(5).sum(4)

    dB = channel_blocks(dh * (dw * uw)[..., None])
    dC = channel_blocks(hs * yw[..., None])
    grads = dict(
        du=_unwalk(du, L, reverse), dd=_unwalk(dd, L, reverse), dA=dA,
        dB=_unwalk(dB, L, reverse), dC=_unwalk(dC, L, reverse),
        dbias=dd.sum(3).sum((0, 2)), dD=(yw * uw).sum(3).sum((0, 2)))
    return grads, lam


def sequential_exit_adjoints(u, dts, cs, A, bias, softplus, reverse, dy):
    """The adjoint entering every chunk's exit from a plain walk of the
    adjoint, token by token against the walk: (batch, G, n_chunk, dg,
    N)."""
    batch, G, L, dg = u.shape
    n_chunk = -(-L // PROJ_CHUNK)
    d = dts + bias[None, :, None, :]
    if softplus:
        d = torch.nn.functional.softplus(d)
    x = torch.zeros(batch, G, dg, A.shape[1], dtype=u.dtype)
    lam = [None] * n_chunk
    for ci in (range(n_chunk) if reverse else range(n_chunk - 1, -1, -1)):
        lam[ci] = x
        toks = range(ci * PROJ_CHUNK, min(L, (ci + 1) * PROJ_CHUNK))
        for t in (toks if reverse else reversed(toks)):
            a = torch.exp(d[:, :, t, :, None] * A.transpose(1, 2)[None])
            x = a * (x + dy[:, :, t, :, None] * cs[:, :, t, None, :])
    return torch.stack(lam, 2)


def _arrays(batch, G, L, dg, N, softplus, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    # without softplus, d = dt + bias stays positive: a decay per step
    bias = f(G, dg) * 0.1 + (-1.0 if softplus else 0.3)
    return dict(
        u=f(batch, G, L, dg), w_dt=f(G, dg, dg) * np.float32(0.1 / dg ** 0.5),
        w_b=f(G, dg, N) / np.float32(dg ** 0.5),
        w_c=f(G, dg, N) / np.float32(dg ** 0.5),
        A=-np.exp(f(G, N, dg) * 0.5), D=f(G, dg), bias=bias,
        dy=f(batch, G, L, dg))


def _close(got, want, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=RTOL,
                               atol=ATOL, err_msg=name)


def _jax_grads(fn, args, dy):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    return [np.asarray(g) for g in vjp(dy)]


def _model(x, kind, swap, softplus, reverse):
    """The model's gradients for the inputs `x` of one entry point, in
    JAX's order for that entry point."""
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    u = t["u"]
    if kind == "streamed":
        dts, bs, cs = t["dt"], t["B"], t["C"]
        hck = sequential_states(u, dts, bs, t["A"], t["bias"], softplus,
                                reverse)
    else:
        # K2's and K4's 3xTF32 projection, K2's checkpoints
        dts, bs, cs = (project_3xtf32(u, t[k])
                       for k in ("w_dt", "w_b", "w_c"))
        if swap:
            cs = _pair_swap(cs)
        _, hck = chain_scan_model(u, dts, bs, cs, t["A"], t["D"], t["bias"],
                                  softplus, reverse)
    g, _ = chunk_bwd_model(u, dts, bs, cs, t["A"], t["D"], t["bias"],
                           softplus, reverse, t["dy"], hck)
    if kind == "streamed":
        return [g["du"], g["dd"], g["dA"], g["dB"], g["dC"], g["dD"],
                g["dbias"]]
    dC = _pair_swap(g["dC"]) if swap else g["dC"]
    # K5: 1xTF32 products
    (du_chain,), dw_dt, dw_b, dw_c = proj_grad_plain(
        (tf32(u),), tf32(g["dd"]), tf32(g["dB"]), tf32(dC),
        *(tf32(t[k]) for k in ("w_dt", "w_b", "w_c")))
    du = g["du"] + du_chain
    if kind == "ml":
        du = [du[:, 0], du[:, 1]]
    else:
        du = [du]
    return [*du, dw_dt, dw_b, dw_c, g["dA"], g["dD"], g["dbias"]]


# (kind, batch, L, dg, N, reverse, swap, softplus): L 100 lies inside one
# chunk, L 300 is two whole chunks and a ragged third (not a multiple of
# 32); dg 40 spans two channel blocks
CASES = [
    ("streamed", 2, 100, 16, 4, False, False, True),
    ("streamed", 1, 300, 40, 16, True, False, False),
    ("proj", 1, 300, 16, 16, True, True, True),
    ("proj", 2, 100, 40, 4, False, False, False),
    ("ml", 1, 300, 8, 4, False, True, True),
    ("ml", 2, 100, 16, 16, True, False, True),
]


@pytest.mark.parametrize("kind,batch,L,dg,N,reverse,swap,softplus", CASES)
def test_chunk_backward_model_matches_jax(kind, batch, L, dg, N, reverse,
                                          swap, softplus):
    G = 2
    a = _arrays(batch, G, L, dg, N, softplus, seed=L + 7 * N + dg)
    # block_t 8: the smallest trace of JAX's kernels in interpret mode
    opts = dict(delta_softplus=softplus, reverse=reverse, interpret=True,
                block_t=8)
    dy = jnp.asarray(a["dy"])
    ws = (a["w_dt"], a["w_b"], a["w_c"], a["A"], a["D"], a["bias"])
    if kind == "streamed":
        u = a["u"]
        a["dt"], a["B"], a["C"] = (u @ a[k] for k in ("w_dt", "w_b", "w_c"))
        want = _jax_grads(
            lambda u, dt, A, B, C, D, bias: jscan.selective_scan_g(
                u, dt, A, B, C, D=D, delta_bias=bias, **opts),
            (u, a["dt"], a["A"], a["B"], a["C"], a["D"], a["bias"]), dy)
    elif kind == "proj":
        want = _jax_grads(
            lambda u, wdt, wb, wc, A, D, bias: jscan.selective_scan_g_proj(
                u, wdt, wb, wc, A, D=D, delta_bias=bias, swap_groups_c=swap,
                **opts),
            (a["u"], *ws), dy)
    else:
        want = _jax_grads(
            lambda u0, u1, wdt, wb, wc, A, D, bias: tuple(
                jscan.selective_scan_g_proj_ml(
                    (u0, u1), wdt, wb, wc, A, D=D, delta_bias=bias,
                    swap_groups_c=swap, **opts)),
            (a["u"][:, 0], a["u"][:, 1], *ws), (dy[:, 0], dy[:, 1]))
    got = _model(a, kind, swap, softplus, reverse)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), w, f"{kind} gradient {i}")


@pytest.mark.parametrize("reverse", [False, True])
def test_chunk_carries_match_a_sequential_adjoint_walk_in_fp64(reverse):
    """Many chunks, the last ragged, fp64: the carries equal a plain
    token-by-token adjoint walk's, and all seven gradients autograd's of
    the plain sequential scan, to rounding: the decomposition is exact."""
    batch, G, L, dg, N = 1, 2, 5 * PROJ_CHUNK + 45, 4, 4
    a = _arrays(batch, G, L, dg, N, True, seed=11)
    t = {k: torch.from_numpy(v).double() for k, v in a.items()}
    dts, bs, cs = (t["u"] @ t[k] for k in ("w_dt", "w_b", "w_c"))
    hck = sequential_states(t["u"], dts, bs, t["A"], t["bias"], True,
                            reverse)
    got, lam = chunk_bwd_model(t["u"], dts, bs, cs, t["A"], t["D"],
                               t["bias"], True, reverse, t["dy"], hck)
    want = sequential_exit_adjoints(t["u"], dts, cs, t["A"], t["bias"], True,
                                    reverse, t["dy"])
    assert float((lam - want).abs().max()) < 1e-12 * max(
        1.0, float(want.abs().max()))
    leaves = [x.clone().requires_grad_(True) for x in (
        t["u"], dts, t["A"], bs, cs, t["D"], t["bias"])]
    y = sequential_scan(*leaves, reverse)
    ref = torch.autograd.grad((y * t["dy"]).sum(), leaves)
    for name, r in zip(("du", "dd", "dA", "dB", "dC", "dD", "dbias"), ref):
        err = float((got[name] - r).abs().max())
        assert err < 1e-10 * max(1.0, float(r.abs().max())), (name, err)


def sequential_scan(u, dts, A, bs, cs, D, bias, reverse):
    """y of a plain token-by-token walk with softplus, in u's dtype (autograd
    differentiates it)."""
    d = torch.nn.functional.softplus(dts + bias[None, :, None, :])
    h = torch.zeros(*u.shape[:2], A.shape[1], u.shape[3], dtype=u.dtype)
    ys = [None] * u.shape[2]
    for t in (reversed(range(u.shape[2])) if reverse else range(u.shape[2])):
        h = torch.exp(d[:, :, t, None] * A[None]) * h + (
            d[:, :, t] * u[:, :, t])[:, :, None] * bs[:, :, t, :, None]
        ys[t] = (cs[:, :, t, :, None] * h).sum(2)
    return torch.stack(ys, 2) + D[None, :, None] * u
