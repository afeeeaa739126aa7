"""The algebra of the chunk-parallel scans of K1 / K8 / K10
(`csrc/chunk_fwd.cuh`) and of K2's one-pass scan (`csrc/chain_fwd.cuh`),
on the CPU.

The kernels run on the card only. Their decompositions are modelled here
in plain torch, step for step: the sequence is cut into chunks of
PROJ_CHUNK tokens in the walk's order (reversed in place for `reverse`,
the last chunk ragged); every lane of 32 folds PROJ_CHUNK / 32 consecutive
tokens into one pair of the map h -> a h + b and a doubling scan composes
the 32 lanes.

`chunk_scan_model` (K1, K8, K10): each chunk is scanned from a zero state;
the carry into each chunk follows from the chunks' end states and
exp(A * sum d); each chunk is then re-emitted from its true carry, y and
the checkpoint `hck` at every 32-token segment entry.

`chain_scan_model` (K2): each chunk is scanned once, one exp per (token,
channel, state); from each lane's exclusive prefix it keeps y from a zero
carry and the carry's weight in y (C times the decays since the chunk's
entry); the carries follow in a fixed order, in groups of CHAIN_GROUP
walk chunks: each chunk applies the maps (prod a, the zero-carry end
state) of its group's earlier chunks, composed first to last, to the state
entering the group, and the group's last chunk hands on the state
entering the next; y and `hck` follow from the carry in. K2's projection is modelled in 3xTF32
(`project_3xtf32`, `test_torch_port_tf32.tf32`'s rounding), as its
warpgroup MMAs run it at fp32 io.

The K2 model, fed by the 3xTF32 projection, is held against JAX's
`selective_scan_g_proj` / `selective_scan_g_proj_ml` (their Pallas kernels
in interpret mode, as tests/test_pallas_scan_g.py runs them), and its
`hck` against the states of a plain sequential walk. Tolerance: fp32 rtol
6e-4 / atol 2e-3 against max(|ref|, 1), as chip_smoke.py holds K2; both
models' checkpoints equal the walk's in fp64.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.ops.pallas_scan_g import selective_scan_g_proj as jax_g_proj
from sigma_tpu.ops.pallas_scan_g import (
    selective_scan_g_proj_ml as jax_g_proj_ml,
)
from sigma_tpu_torch.ops.scan_g import (
    CHAIN_GROUP,
    CK_TOKENS,
    PROJ_CHUNK,
    _pair_swap,
)
from test_torch_port_tf32 import tf32

torch.set_num_threads(2)
RTOL, ATOL = 6e-4, 2e-3
LANES = 32


def _walk(x, n_chunk, reverse):
    """(batch, G, L, ...) padded with zeros to whole chunks, as (batch, G,
    n_chunk, PROJ_CHUNK, ...) in walk order within each chunk."""
    pad = n_chunk * PROJ_CHUNK - x.shape[2]
    x = torch.nn.functional.pad(
        x.movedim(2, -1), (0, pad)).movedim(-1, 2)
    x = x.reshape(*x.shape[:2], n_chunk, PROJ_CHUNK, *x.shape[3:])
    return x.flip(3) if reverse else x


def _lane_scan(fa, fb):
    """Inclusive scan over the lane axis (-3) of h -> a h + b, lane 0
    first, by doubling (the kernel's shuffle scan)."""
    off = 1
    while off < LANES:
        qa = torch.nn.functional.pad(fa, (0, 0, 0, 0, off, 0),
                                     value=1.0)[..., :LANES, :, :]
        qb = torch.nn.functional.pad(fb, (0, 0, 0, 0, off, 0))[..., :LANES,
                                                                :, :]
        fb = fa * qb + fb
        fa = fa * qa
        off *= 2
    return fa, fb


def chunk_scan_model(u, dts, bs, cs, A, D, bias, softplus, reverse,
                     y_accum=None):
    """K2's chunked scan in plain torch. u, dts (batch, G, L, dg); bs, cs
    (batch, G, L, N), C already routed to its chain; A (G, N, dg); D, bias
    (G, dg). Returns (y, hck), hck (batch, G, ceil(L / 32), N, dg)."""
    batch, G, L, dg = u.shape
    N = A.shape[1]
    items = PROJ_CHUNK // LANES
    n_chunk = -(-L // PROJ_CHUNK)
    d = dts + bias[None, :, None, :]
    if softplus:
        d = torch.nn.functional.softplus(d)
    # walk order; a token past L walks as an identity (d = 0, u = 0)
    dw, uw = _walk(d, n_chunk, reverse), _walk(u, n_chunk, reverse)
    bw, cw = _walk(bs, n_chunk, reverse), _walk(cs, n_chunk, reverse)
    At = A.transpose(1, 2)[None, :, None, None]             # (1, G, 1, 1, dg, N)
    a = torch.exp(dw[..., None] * At)                          # (b, G, c, T, dg, N)
    b = (dw * uw)[..., None] * bw[..., None, :]
    a = a.reshape(batch, G, n_chunk, LANES, items, dg, N)
    b = b.reshape(batch, G, n_chunk, LANES, items, dg, N)
    # each lane folds its items; the lanes compose by a doubling scan
    fa = torch.ones_like(a[:, :, :, :, 0])
    fb = torch.zeros_like(b[:, :, :, :, 0])
    for j in range(items):
        fb = a[:, :, :, :, j] * fb + b[:, :, :, :, j]
        fa = fa * a[:, :, :, :, j]
    fa, fb = _lane_scan(fa, fb)
    hloc = fb[:, :, :, -1]                                    # (b, G, c, dg, N)
    sd = dw.sum(3)                                            # (b, G, c, dg)
    # the carries, chunk by chunk in the walk's order
    carry = torch.zeros_like(hloc[:, :, 0])
    carries = [None] * n_chunk
    order = range(n_chunk - 1, -1, -1) if reverse else range(n_chunk)
    for c in order:
        carries[c] = carry
        decay = torch.exp(A.transpose(1, 2)[None] * sd[:, :, c, :, None])
        carry = decay * carry + hloc[:, :, c]
    carry_in = torch.stack(carries, 2)[:, :, :, None]        # (b, G, c, 1, dg, N)
    # re-emission: each lane starts from the carry and its exclusive prefix
    xa = torch.cat([torch.ones_like(fa[:, :, :, :1]), fa[:, :, :, :-1]], 3)
    xb = torch.cat([torch.zeros_like(fb[:, :, :, :1]), fb[:, :, :, :-1]], 3)
    h = xa * carry_in + xb                                    # (b, G, c, lanes, dg, N)
    h_entry = h
    cl = cw.reshape(batch, G, n_chunk, LANES, items, 1, N)
    ys = []
    for j in range(items):
        h = a[:, :, :, :, j] * h + b[:, :, :, :, j]
        ys.append((cl[:, :, :, :, j] * h).sum(-1))
    yw = torch.stack(ys, 4).reshape(batch, G, n_chunk, PROJ_CHUNK, dg)
    if reverse:
        yw = yw.flip(3)
    y = yw.reshape(batch, G, -1, dg)[:, :, :L] + D[None, :, None, :] * u
    if y_accum is not None:
        y = y + y_accum
    return y, _checkpoints(h_entry, L, reverse)


def project_3xtf32(u, w):
    """u (batch, G, L, dg) @ w (G, dg, k) in 3xTF32, as K2's and K4's
    warpgroup MMAs run it at fp32 io: u and w split into TF32 heads and the
    TF32 rounding of their remainders, u_lo w_hi + u_hi w_lo + u_hi w_hi
    (fp32 sums)."""
    uh, wh = tf32(u), tf32(w)
    ul, wl = tf32(u - uh), tf32(w - wh)
    return ul @ wh + uh @ wl + uh @ wh


def chain_scan_model(u, dts, bs, cs, A, D, bias, softplus, reverse,
                     y_accum=None):
    """K2's one-pass scan in plain torch; arguments and result as
    `chunk_scan_model`'s."""
    batch, G, L, dg = u.shape
    N = A.shape[1]
    items = PROJ_CHUNK // LANES
    n_chunk = -(-L // PROJ_CHUNK)
    d = dts + bias[None, :, None, :]
    if softplus:
        d = torch.nn.functional.softplus(d)
    dw, uw = _walk(d, n_chunk, reverse), _walk(u, n_chunk, reverse)
    bw, cw = _walk(bs, n_chunk, reverse), _walk(cs, n_chunk, reverse)
    At = A.transpose(1, 2)[None, :, None, None]             # (1, G, 1, 1, dg, N)
    lanes = (batch, G, n_chunk, LANES, items, dg, N)
    # the decays and inputs, once per (token, channel, state)
    a = torch.exp(dw[..., None] * At).reshape(lanes)
    b = ((dw * uw)[..., None] * bw[..., None, :]).reshape(lanes)
    c = cw.reshape(batch, G, n_chunk, LANES, items, 1, N)
    fa = torch.ones_like(a[:, :, :, :, 0])
    fb = torch.zeros_like(b[:, :, :, :, 0])
    for j in range(items):
        fb = a[:, :, :, :, j] * fb + b[:, :, :, :, j]
        fa = fa * a[:, :, :, :, j]
    fa, fb = _lane_scan(fa, fb)
    # each lane's exclusive prefix; from it, y from a zero carry and the
    # carry's weight in y (K)
    xa = torch.cat([torch.ones_like(fa[:, :, :, :1]), fa[:, :, :, :-1]], 3)
    xb = torch.cat([torch.zeros_like(fb[:, :, :, :1]), fb[:, :, :, :-1]], 3)
    h, pr, yz, K = xb, xa, [], []
    for j in range(items):
        h = a[:, :, :, :, j] * h + b[:, :, :, :, j]
        pr = pr * a[:, :, :, :, j]
        yz.append((c[:, :, :, :, j] * h).sum(-1))
        K.append(c[:, :, :, :, j] * pr)
    # the carries in groups of CHAIN_GROUP walk chunks: each chunk applies
    # the maps of its group's earlier chunks, composed first to last, to
    # the state entering the group; the group's last chunk carries on
    order = range(n_chunk - 1, -1, -1) if reverse else range(n_chunk)
    order = list(order)
    hg = torch.zeros_like(fb[:, :, 0, 0])
    hin = [None] * n_chunk
    for g0 in range(0, n_chunk, CHAIN_GROUP):
        ma, mb = torch.ones_like(hg), torch.zeros_like(hg)
        for ci in order[g0:g0 + CHAIN_GROUP]:
            hin[ci] = ma * hg + mb
            mb = fa[:, :, ci, -1] * mb + fb[:, :, ci, -1]
            ma = ma * fa[:, :, ci, -1]
        hg = fa[:, :, ci, -1] * hin[ci] + fb[:, :, ci, -1]
    hin = torch.stack(hin, 2)[:, :, :, None]                 # (b, G, c, 1, dg, N)
    ys = [yz[j] + (K[j] * hin).sum(-1) for j in range(items)]
    yw = torch.stack(ys, 4).reshape(batch, G, n_chunk, PROJ_CHUNK, dg)
    if reverse:
        yw = yw.flip(3)
    y = yw.reshape(batch, G, -1, dg)[:, :, :L] + D[None, :, None, :] * u
    if y_accum is not None:
        y = y + y_accum
    return y, _checkpoints(xa * hin + xb, L, reverse)


def _checkpoints(h_entry, L, reverse):
    """hck (batch, G, ceil(L / 32), N, dg) from the state entering every
    lane's run (batch, G, n_chunk, LANES, dg, N): the lanes whose run
    starts a 32-token segment."""
    batch, G, n_chunk = h_entry.shape[:3]
    items = PROJ_CHUNK // LANES
    n_ck = -(-L // CK_TOKENS)
    hck = torch.zeros(batch, G, n_ck, *h_entry.shape[-1:-3:-1],
                      dtype=h_entry.dtype)
    for c in range(n_chunk):
        for k in range(0, PROJ_CHUNK, CK_TOKENS):
            p = (c * PROJ_CHUNK + PROJ_CHUNK - 1 - k if reverse
                 else c * PROJ_CHUNK + k)
            if p // CK_TOKENS < n_ck:
                hck[:, :, p // CK_TOKENS] = h_entry[:, :, c, k // items] \
                    .transpose(-1, -2)
    return hck


def sequential_states(u, dts, bs, A, bias, softplus, reverse):
    """hck from a plain token-by-token walk: h as the walk enters each
    32-token segment (token 32 j forward; its last token, or L - 1,
    reversed)."""
    batch, G, L, dg = u.shape
    N = A.shape[1]
    d = dts + bias[None, :, None, :]
    if softplus:
        d = torch.nn.functional.softplus(d)
    h = torch.zeros(batch, G, N, dg, dtype=u.dtype)
    hck = torch.zeros(batch, G, -(-L // CK_TOKENS), N, dg, dtype=u.dtype)
    for p in (range(L - 1, -1, -1) if reverse else range(L)):
        if (p == L - 1 or (p + 1) % CK_TOKENS == 0) if reverse \
                else p % CK_TOKENS == 0:
            hck[:, :, p // CK_TOKENS] = h
        a = torch.exp(d[:, :, p, None, :] * A[None])
        h = a * h + (d[:, :, p] * u[:, :, p])[:, :, None, :] \
            * bs[:, :, p, :, None]
    return hck


def _inputs(batch, G, L, dg, N, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(
        u=f(batch, G, L, dg), w_dt=f(G, dg, dg) * np.float32(0.3 / dg ** 0.5),
        w_b=f(G, dg, N) / np.float32(dg ** 0.5),
        w_c=f(G, dg, N) / np.float32(dg ** 0.5),
        A=-np.exp(f(G, N, dg) * 0.5), D=f(G, dg), bias=f(G, dg) * 0.1 - 1.0,
        ya=f(batch, G, L, dg) * 0.5)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=RTOL,
                               atol=ATOL)


# (n_u, batch, L, dg, N, reverse, swap, y_accum): L 300 is two whole
# chunks and a ragged third, not a multiple of 32; L 77 is one ragged
# chunk; L 256 ends on a chunk
CASES = [
    (1, 2, 300, 16, 4, False, False, False),
    (1, 2, 300, 16, 16, True, False, True),
    (1, 1, 77, 8, 4, True, False, False),
    (2, 2, 300, 16, 16, False, True, False),
    (2, 1, 300, 8, 4, True, True, True),
    (2, 1, 256, 8, 16, True, False, True),
]


@pytest.mark.parametrize("n_u,batch,L,dg,N,reverse,swap,ya", CASES)
def test_chunk_model_matches_jax_and_the_sequential_walk(n_u, batch, L, dg,
                                                         N, reverse, swap,
                                                         ya):
    G = 2
    x = _inputs(batch, G, L, dg, N, seed=L + 7 * N + int(reverse))
    opts = dict(D=x["D"], delta_bias=x["bias"], delta_softplus=True,
                reverse=reverse, swap_groups_c=swap, interpret=True)
    ws = (x["w_dt"], x["w_b"], x["w_c"], x["A"])
    if n_u == 2:
        us = (x["u"][:, 0], x["u"][:, 1])
        yas = (x["ya"][:, 0], x["ya"][:, 1]) if ya else None
        want = np.stack([np.asarray(v) for v in jax_g_proj_ml(
            tuple(map(jnp.asarray, us)), *map(jnp.asarray, ws),
            y_accum=None if yas is None else tuple(map(jnp.asarray, yas)),
            **opts)], 1)
    else:
        want = np.asarray(jax_g_proj(
            jnp.asarray(x["u"]), *map(jnp.asarray, ws),
            y_accum=jnp.asarray(x["ya"]) if ya else None, **opts))

    t = {k: torch.from_numpy(v) for k, v in x.items()}
    dts, bs, cs = (project_3xtf32(t["u"], t[k])
                   for k in ("w_dt", "w_b", "w_c"))
    if swap:
        cs = _pair_swap(cs)
    y, hck = chain_scan_model(t["u"], dts, bs, cs, t["A"], t["D"], t["bias"],
                              True, reverse, t["ya"] if ya else None)
    _close(y.numpy(), want)
    _close(hck.numpy(), sequential_states(t["u"], dts, bs, t["A"], t["bias"],
                                          True, reverse).numpy())


def test_chunk_carries_match_a_sequential_walk_in_fp64():
    """Long sequence, many chunks (the chain model's carries over three
    groups, the last partial), fp64: both models' hck equal the plain
    walk's to rounding, and their y each other's, so both decompositions
    are exact."""
    batch, G, dg, N = 1, 2, 4, 4
    L = (2 * CHAIN_GROUP + 3) * PROJ_CHUNK + 45
    x = _inputs(batch, G, L, dg, N, seed=3)
    t = {k: torch.from_numpy(v).double() for k, v in x.items()}
    dts, bs, cs = (t["u"] @ t[k] for k in ("w_dt", "w_b", "w_c"))
    for reverse in (False, True):
        want = sequential_states(t["u"], dts, bs, t["A"], t["bias"], True,
                                 reverse)
        ys = []
        for model in (chunk_scan_model, chain_scan_model):
            y, hck = model(t["u"], dts, bs, cs, t["A"], t["D"], t["bias"],
                           True, reverse)
            ys.append(y)
            assert math.isclose(
                float((hck - want).abs().max()), 0.0, abs_tol=1e-12)
        assert float((ys[0] - ys[1]).abs().max()) < 1e-12
