"""The chunk-parallel forward scan that K1, K2 and K10 share
(`csrc/chunk_fwd.cuh`), on the CPU, with the operands each kernel reads.

The kernels run on the card only. `chunk_scan_model`
(tests/test_torch_port_chunk_scan.py) models their chunk body step for
step; here it is fed as K1 feeds it (dt, B and C streamed, in the grouped
and the per-row layout) and as K10 feeds it (the four chains of an image,
each chain's tokens read and its y written through the wh pixel map, the
states in tiles of 16 with the tiles' y summed in order). The models are
held to JAX's `selective_scan_g`, `pallas_scan_seq.selective_scan_seq_cl`
and `selective_scan_ss2d_proj` (their Pallas kernels in interpret mode, as
the JAX package's own tests run them) at the fp32 tier, rtol 6e-4 / atol
2e-3 against max(|ref|, 1), and their checkpoints, in fp64, to sequential
walks. The package's plain checkpoint walk (`scan_g.scan_checkpoints_plain`,
the card's reference for the kernels' `hck`) is held to the test's walk and
to the plain scan's y.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.ops.pallas_scan_g import selective_scan_g as jax_g
from sigma_tpu.ops.pallas_scan_g import selective_scan_ss2d_proj as jax_img
from sigma_tpu.ops.pallas_scan_seq import selective_scan_seq_cl as jax_seq
from sigma_tpu_torch.ops import scan_g, scan_img
from sigma_tpu_torch.ops.scan_g import CK_TOKENS
from test_torch_port_chunk_scan import chunk_scan_model, sequential_states

torch.set_num_threads(2)
RTOL, ATOL = 6e-4, 2e-3
STATE_TILE = 16  # kStateTile of K10's TILED chunk body


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                               atol=atol)


def _streams(batch, G, L, dg, N, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(u=f(batch, G, L, dg), dt=f(batch, G, L, dg) * 0.5,
                A=-np.exp(f(G, N, dg) * 0.5), B=f(batch, G, L, N),
                C=f(batch, G, L, N), D=f(G, dg), bias=f(G, dg) * 0.1 - 1.0,
                ya=f(batch, G, L, dg) * 0.5)


def _torch(x, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) for k, v in x.items()}


# (L, N, reverse, y_accum): L 77 one ragged chunk, L 300 two whole chunks
# and a ragged third
STREAM_CASES = [(77, 4, False, False), (77, 16, True, True),
                (300, 4, True, True), (300, 16, False, False)]


@pytest.mark.parametrize("L,N,reverse,ya", STREAM_CASES)
def test_streamed_chunk_model_matches_jax(L, N, reverse, ya):
    """K1's operands: the chunk body fed dt, B, C as streams equals JAX's
    streamed grouped scan (+ y_accum); its checkpoints equal the
    sequential walk's in fp64."""
    x = _streams(2, 2, L, 8, N, seed=L + N)
    want = np.asarray(jax_g(
        *(jnp.asarray(x[k]) for k in ("u", "dt", "A", "B", "C")),
        D=jnp.asarray(x["D"]), delta_bias=jnp.asarray(x["bias"]),
        delta_softplus=True, reverse=reverse, interpret=True))
    if ya:
        want = want + x["ya"]
    t = _torch(x)
    y, _ = chunk_scan_model(t["u"], t["dt"], t["B"], t["C"], t["A"], t["D"],
                            t["bias"], True, reverse,
                            t["ya"] if ya else None)
    _close(y.numpy(), want)
    t = _torch(x, torch.float64)
    _, hck = chunk_scan_model(t["u"], t["dt"], t["B"], t["C"], t["A"],
                              t["D"], t["bias"], True, reverse)
    seq = sequential_states(t["u"], t["dt"], t["B"], t["A"], t["bias"], True,
                            reverse)
    assert float((hck - seq).abs().max()) < 1e-12


def test_per_row_chunk_model_matches_jax():
    """The per-row layout (rows (batch*G, L, dg), row r scanning with
    A[r % G]) is the grouped operand viewed without a copy: the chunk body
    on it equals JAX's per-row Pallas scan."""
    batch, G, L, dg, N = 2, 2, 300, 8, 16
    x = _streams(batch, G, L, dg, N, seed=11)
    rows = lambda k, w: x[k].reshape(batch * G, L, w)  # noqa: E731
    want = np.asarray(jax_seq(
        jnp.asarray(rows("u", dg)), jnp.asarray(rows("dt", dg)),
        jnp.asarray(x["A"]), jnp.asarray(rows("B", N)),
        jnp.asarray(rows("C", N)), D=jnp.asarray(x["D"]),
        delta_bias=jnp.asarray(x["bias"]), delta_softplus=True,
        interpret=True))
    t = _torch(x)
    y, _ = chunk_scan_model(t["u"], t["dt"], t["B"], t["C"], t["A"], t["D"],
                            t["bias"], True, False)
    _close(y.reshape(batch * G, L, dg).numpy(), want)


# ------------------------------------------------------------ image chains
def _pixels(H, W):
    """Token t of each layout's sequence -> its pixel: hw row-major, wh
    column-major (pixel (t % H, t // H)), as csrc/scan_img.cu maps it."""
    t = torch.arange(H * W)
    return t, (t % H) * W + t // H


def tiled_chunk_model(u, dts, bs, cs, A, D, bias, softplus, reverse):
    """K10's TILED chunk body: the states in tiles of STATE_TILE, each tile
    scanned alone, y summed over the tiles in order, then D u; the
    checkpoints of the tiles side by side."""
    N = A.shape[1]
    y, hcks = None, []
    for s0 in range(0, N, STATE_TILE):
        s = slice(s0, s0 + STATE_TILE)
        yt, ht = chunk_scan_model(u, dts, bs[..., s], cs[..., s], A[:, s],
                                  torch.zeros_like(D), bias, softplus,
                                  reverse)
        y = yt if y is None else y + yt
        hcks.append(ht)
    return y + D[None, :, None, :] * u, torch.cat(hcks, 3)


def image_chunk_model(x, w_dt, w_b, w_c, A, D, bias, softplus):
    """K10 in plain torch: per direction, the two layouts' chains read x
    through the pixel map, their projections, the tiled chunk body
    (reversed for direction 1); each chain's y written back through the map
    and the four planes summed in (direction, layout) order. Returns (y
    (B, H, W, dg), hck (2, 2, B, ceil(H W / 32), N, dg))."""
    b, H, W, dg = x.shape
    pix = _pixels(H, W)
    xs = x.reshape(b, H * W, dg)
    y = torch.zeros_like(xs)
    hck = []
    for d in range(2):
        u = torch.stack([xs[:, p] for p in pix], 1)          # (b, 2, L, dg)
        dts, bs, cs = (torch.einsum("bgld,gdk->bglk", u, w[d])
                       for w in (w_dt, w_b, w_c))
        yc, hc = tiled_chunk_model(u, dts, bs, cs, A[d], D[d], bias[d],
                                   softplus, d == 1)
        for layout, p in enumerate(pix):
            y[:, p] = y[:, p] + yc[:, layout]
        hck.append(hc.transpose(0, 1))
    return y.reshape(b, H, W, dg), torch.stack(hck)


def image_sequential_states(x, w_dt, w_b, A, bias, softplus):
    """The checkpoints of each chain from a token-by-token walk over the
    image itself, row by row (hw) or column by column (wh), last to first
    for direction 1: (2, 2, B, ceil(H W / 32), N, dg)."""
    b, H, W, dg = x.shape
    L, N = H * W, A.shape[-2]
    out = torch.zeros(2, 2, b, -(-L // CK_TOKENS), N, dg, dtype=x.dtype)
    for d in range(2):
        for layout in range(2):
            walk = ([(i, j) for i in range(H) for j in range(W)] if layout == 0
                    else [(i, j) for j in range(W) for i in range(H)])
            order = range(L - 1, -1, -1) if d else range(L)
            h = torch.zeros(b, N, dg, dtype=x.dtype)
            for p in order:
                if (p == L - 1 or (p + 1) % CK_TOKENS == 0) if d \
                        else p % CK_TOKENS == 0:
                    out[d, layout, :, p // CK_TOKENS] = h
                xt = x[:, walk[p][0], walk[p][1]]                # (b, dg)
                dt = xt @ w_dt[d, layout] + bias[d, layout]
                if softplus:
                    dt = torch.nn.functional.softplus(dt)
                a = torch.exp(dt[:, None, :] * A[d, layout][None])
                h = a * h + (dt * xt)[:, None, :] \
                    * (xt @ w_b[d, layout])[:, :, None]
    return out


def _image_inputs(b, H, W, dg, N, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(b, H, W, dg),
                w_dt=f(2, 2, dg, dg) * np.float32(0.3 / dg ** 0.5),
                w_b=f(2, 2, dg, N) / np.float32(dg ** 0.5),
                w_c=f(2, 2, dg, N) / np.float32(dg ** 0.5),
                A=-np.exp(f(2, 2, N, dg)), D=f(2, 2, dg),
                delta_bias=f(2, 2, dg) * 0.1)


# (H, W, N): 64 tokens, below one chunk; 192 tokens, a chunk and a ragged
# half; N 20 is two state tiles, the second ragged (JAX plans its image
# kernel for both geometries)
IMAGE_CASES = [(8, 8, 4), (12, 16, 20)]


@pytest.mark.parametrize("H,W,N", IMAGE_CASES)
def test_image_chunk_model_matches_jax(H, W, N):
    """K10's operands: the four chains read through the pixel map, the
    tiled chunk body, y through the map, equal JAX's image scan; the
    checkpoints, in K11's layout, equal a walk over the image in fp64."""
    x = _image_inputs(1, H, W, 16, N, seed=H * W + N)
    names = ("x", "w_dt", "w_b", "w_c", "A", "D", "delta_bias")
    want = jax_img(*(jnp.asarray(x[k]) for k in names),
                   delta_softplus=True, interpret=True)
    assert want is not None  # JAX planned its image kernel
    t = _torch(x)
    y, _ = image_chunk_model(*(t[k] for k in names), True)
    _close(y.numpy(), np.asarray(want))
    t = _torch(x, torch.float64)
    _, hck = image_chunk_model(*(t[k] for k in names), True)
    seq = image_sequential_states(t["x"], t["w_dt"], t["w_b"], t["A"],
                                  t["delta_bias"], True)
    assert hck.shape == seq.shape
    assert float((hck - seq).abs().max()) < 1e-12
    # and the package's plain walk in K11's layout
    plain = scan_img.scan_checkpoints_img_plain(
        t["x"], t["w_dt"], t["w_b"], t["A"], t["delta_bias"], True)
    assert float((plain - seq).abs().max()) < 1e-12


# ------------------------------------------------------------ plain walk
def _y_from_checkpoints(hck, u, d, A, B, C, D, reverse):
    """y re-walked from the checkpoints alone: every 32-token segment from
    its entry state, all segments at once (d the effective delta; the
    tokens padded past L have d = 0, so they walk as identities)."""
    batch, G, L, dg = u.shape
    n_ck = hck.shape[2]
    pad = n_ck * CK_TOKENS - L
    seg = [torch.nn.functional.pad(v.movedim(2, -1), (0, pad)).movedim(-1, 2)
           .reshape(batch, G, n_ck, CK_TOKENS, -1) for v in (u, d, B, C)]
    us, ds, bs, cs = seg
    h = hck.clone()                                       # (b, G, n_ck, N, dg)
    y = torch.zeros(batch, G, n_ck, CK_TOKENS, dg, dtype=u.dtype)
    for k in range(CK_TOKENS - 1, -1, -1) if reverse else range(CK_TOKENS):
        a = torch.exp(ds[:, :, :, k, None, :] * A[None, :, None])
        b = (ds[:, :, :, k] * us[:, :, :, k])[:, :, :, None, :] \
            * bs[:, :, :, k, :, None]
        h = a * h + b
        y[:, :, :, k] = (cs[:, :, :, k, :, None] * h).sum(3)
    y = y.reshape(batch, G, -1, dg)[:, :, :L]
    return y + D[None, :, None, :] * u


@pytest.mark.parametrize("L", [1, 77, 300])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_checkpoint_walk(L, reverse):
    """`scan_g.scan_checkpoints_plain` equals the test's sequential walk in
    fp64, and y re-walked segment by segment from its checkpoints equals
    the plain scan's y (fp32 tier, fp32)."""
    x = _streams(2, 3, L, 6, 5, seed=L + int(reverse))
    t = _torch(x, torch.float64)
    got = scan_g.scan_checkpoints_plain(t["u"], t["dt"], t["A"], t["B"],
                                        t["bias"], True, reverse)
    want = sequential_states(t["u"], t["dt"], t["B"], t["A"], t["bias"], True,
                             reverse)
    assert got.dtype == torch.float64
    assert float((got - want).abs().max()) < 1e-12
    t = _torch(x)
    hck = scan_g.scan_checkpoints_plain(t["u"], t["dt"], t["A"], t["B"],
                                        t["bias"], True, reverse)
    assert hck.dtype == torch.float32 and hck.shape == (
        2, 3, -(-L // CK_TOKENS), 5, 6)
    d = torch.nn.functional.softplus(t["dt"] + t["bias"][None, :, None, :])
    y = _y_from_checkpoints(hck, t["u"], d, t["A"], t["B"], t["C"], t["D"],
                            reverse)
    want_y = scan_g.selective_scan_g_plain(
        t["u"], t["dt"], t["A"], t["B"], t["C"], t["D"], t["bias"], True,
        reverse)
    _close(y.numpy(), want_y.numpy())
