"""The algebra of K11, the image-layout SS2D backward (`csrc/scan_img.cu`
on the chunk backward of `csrc/chunk_bwd.cuh` that K3 and K4 share), on
the CPU.

K11 runs on the card only. Its decomposition is modelled here in plain
torch, step for step, on the models of the shared bodies:

- K10's projections of the four chains, each chain's x read through the
  pixel map (token t of the wh layout is pixel (t % H, t // H)), and K10's
  checkpoints (`image_chunk_model`, tests/test_torch_port_chunk_scan_fwd.py);
- per direction, the two layouts' chains through `chunk_bwd_model`
  (tests/test_torch_port_chunk_scan_bwd.py): 128-token chunks, the last
  ragged, walked last to first in place for direction 1, h recomputed in
  every 32-token segment from the checkpoints, the carries, the re-sweep
  and its per-chunk / per-32-channel partials; d_state in tiles of 16 (the
  TILED body), the tiles' du / dd terms summed in order;
- the outputs written back through the pixel map: the direct du term as
  one plane per chain, dd / dB / dC in image order per (direction, layout);
- K5's chain term and weight gradients (`proj_grad_plain`, us = (x, x)).

All seven gradients are held to `jax.vjp` of
`sigma_tpu.ops.pallas_scan_g.selective_scan_ss2d_proj` (its Pallas image
backward in interpret mode, as tests/test_torch_port_scan_img.py runs it)
at the fp32 tier, rtol 6e-4 / atol 2e-3 against max(|ref|, 1), as
chip_smoke.py holds K11, at geometries JAX's planner tiles (`_plan_img`,
ROADMAP C7) with L not a multiple of 128; and in fp64 to autograd of a
sequential walk over the image, to rounding. With bf16 io the model reads
x, dy and the weights rounded to bf16, as K11 reads them (widened in
registers, fp32 inside), and returns x's and the weights' gradients
rounded to bf16 once: all seven against `jax.vjp` of JAX's bf16 image
scan (its bf16 io kernel, interpret mode) at the bf16 tier, 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.ops.pallas_scan_g import _plan_img
from sigma_tpu.ops.pallas_scan_g import selective_scan_ss2d_proj as jax_img
from sigma_tpu_torch.ops.scan_g import proj_grad_plain
from test_torch_port_chunk_scan_bwd import chunk_bwd_model
from test_torch_port_chunk_scan_fwd import (
    STATE_TILE,
    _image_inputs,
    _pixels,
    image_chunk_model,
)

torch.set_num_threads(2)
RTOL, ATOL = 6e-4, 2e-3
NAMES = ("x", "w_dt", "w_b", "w_c", "A", "D", "delta_bias")


def tiled_bwd_model(u, dts, bs, cs, A, D, bias, softplus, reverse, dy, hck):
    """The TILED chunk backward: each tile of STATE_TILE states through
    the chunk model (D = 0), du / dd / dbias summed over the tiles in
    order, dA / dB / dC side by side, then D dy; dD does not depend on the
    states."""
    N = A.shape[1]
    out = {}
    for s0 in range(0, N, STATE_TILE):
        s = slice(s0, s0 + STATE_TILE)
        g, _ = chunk_bwd_model(u, dts, bs[..., s], cs[..., s], A[:, s],
                               torch.zeros_like(D), bias, softplus, reverse,
                               dy, hck[:, :, :, s])
        for k in ("du", "dd", "dbias"):
            out[k] = g[k] if k not in out else out[k] + g[k]
        out.setdefault("dD", g["dD"])
        for k, axis in (("dA", 1), ("dB", -1), ("dC", -1)):
            out[k] = g[k] if k not in out else torch.cat([out[k], g[k]], axis)
    out["du"] = out["du"] + D[None, :, None, :] * dy
    return out


def image_bwd_model(x, w_dt, w_b, w_c, A, D, bias, softplus, dy, hck):
    """K11 + K5 in plain torch. x, dy (B, H, W, dg); weights, A, D, bias
    [direction, layout]; hck (2, 2, B, ceil(H W / 32), N, dg) as K10
    writes it. Returns the seven gradients by name."""
    b, H, W, dg = x.shape
    L, N = H * W, A.shape[-2]
    pix = _pixels(H, W)
    xs, dys = x.reshape(b, L, dg), dy.reshape(b, L, dg)
    z = dict(dtype=x.dtype)
    du4 = torch.zeros(2, 2, b, L, dg, **z)
    dd = torch.zeros(2, b, 2, L, dg, **z)
    dB = torch.zeros(2, b, 2, L, N, **z)
    dC = torch.zeros(2, b, 2, L, N, **z)
    grads = {k: torch.zeros(2, 2, *s, **z) for k, s in
             (("A", (N, dg)), ("D", (dg,)), ("delta_bias", (dg,)))}
    for d in range(2):
        # K10's streams, each chain in its token order
        u = torch.stack([xs[:, p] for p in pix], 1)          # (b, 2, L, dg)
        gy = torch.stack([dys[:, p] for p in pix], 1)
        dts, bs, cs = (torch.einsum("bgld,gdk->bglk", u, w[d])
                       for w in (w_dt, w_b, w_c))
        g = tiled_bwd_model(u, dts, bs, cs, A[d], D[d], bias[d], softplus,
                            d == 1, gy, hck[d].transpose(0, 1))
        for layout, p in enumerate(pix):
            du4[d, layout][:, p] = g["du"][:, layout]
            dd[d, :, layout][:, p] = g["dd"][:, layout]
            dB[d, :, layout][:, p] = g["dB"][:, layout]
            dC[d, :, layout][:, p] = g["dC"][:, layout]
        grads["A"][d], grads["D"][d] = g["dA"], g["dD"]
        grads["delta_bias"][d] = g["dbias"]
    # K5, once per direction: the chain term and the weight gradients
    dx = du4.sum((0, 1))
    dws = []
    for d in range(2):
        chain, *dw = proj_grad_plain((xs, xs), dd[d], dB[d], dC[d], w_dt[d],
                                     w_b[d], w_c[d])
        dx = dx + chain[0] + chain[1]
        dws.append(dw)
    grads["x"] = dx.reshape(x.shape)
    for k, ws in zip(("w_dt", "w_b", "w_c"), zip(*dws)):
        grads[k] = torch.stack(ws)
    return grads


def _model_grads(x, softplus, dtype):
    t = {k: torch.from_numpy(v).to(dtype) for k, v in x.items()}
    args = [t[k] for k in NAMES]
    _, hck = image_chunk_model(*args, softplus)
    return image_bwd_model(*args, softplus, t["dy"], hck)


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=RTOL,
                               atol=ATOL, err_msg=name)


def _inputs(b, H, W, dg, N, seed):
    x = _image_inputs(b, H, W, dg, N, seed)
    x["dy"] = np.random.default_rng(seed + 1).standard_normal(
        (b, H, W, dg)).astype(np.float32)
    return x


# (b, H, W, dg, N): L 192 is a chunk and a ragged half (JAX's token blocks
# of 96), L 160 a chunk and a ragged quarter; N 4 and 16 one state tile, N
# 20 a full tile and a ragged one; dg 40 two channel blocks
CASES = [(1, 12, 16, 16, 4), (1, 4, 40, 40, 16), (1, 12, 16, 8, 20)]


@pytest.mark.parametrize("b,H,W,dg,N", CASES)
def test_image_backward_model_matches_jax(b, H, W, dg, N):
    assert _plan_img(b, H, W, dg, N, 4) is not None  # JAX's image kernel
    x = _inputs(b, H, W, dg, N, seed=H * W + N)
    _, vjp = jax.vjp(
        lambda *a: jax_img(*a, delta_softplus=True, interpret=True),
        *(jnp.asarray(x[k]) for k in NAMES))
    want = dict(zip(NAMES, vjp(jnp.asarray(x["dy"]))))
    got = _model_grads(x, True, torch.float32)
    for k in NAMES:
        assert got[k].shape == want[k].shape, k
        _close(got[k].numpy(), want[k], k)


BF16_TOL = 5e-2
IO = ("x", "w_dt", "w_b", "w_c")  # the operands K11 takes in the io type


def test_image_backward_model_bf16_io_matches_jax():
    """bf16 io: the model on bf16-rounded x, dy and weights, its x and
    weight gradients rounded to bf16, against jax.vjp of JAX's image scan
    on the same bf16 operands (A, D and the dt bias fp32), all seven
    gradients at 5e-2 of max(|ref|, 1); L 192 is a chunk and a ragged
    half."""
    b, H, W, dg, N = CASES[0]
    assert _plan_img(b, H, W, dg, N, 2) is not None  # JAX's bf16 kernel
    x = _inputs(b, H, W, dg, N, seed=H * W + N + 1)
    io = {k: jnp.asarray(x[k], jnp.bfloat16) for k in IO + ("dy",)}
    _, vjp = jax.vjp(
        lambda *a: jax_img(*a, delta_softplus=True, interpret=True),
        *(io.get(k, jnp.asarray(x[k])) for k in NAMES))
    want = dict(zip(NAMES, vjp(io["dy"])))
    rounded = {k: np.array(v.astype(jnp.float32)) for k, v in io.items()}
    got = _model_grads({**x, **rounded}, True, torch.float32)
    for k in NAMES:
        g = got[k].bfloat16() if k in IO else got[k]
        assert want[k].dtype == (jnp.bfloat16 if k in IO else jnp.float32)
        g, w = g.float().numpy(), np.asarray(want[k], np.float32)
        scale = max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(g / scale, w / scale, rtol=BF16_TOL,
                                   atol=BF16_TOL, err_msg=k)


def sequential_image_scan(x, w_dt, w_b, w_c, A, D, bias, softplus):
    """y of a plain token-by-token walk of the four chains over the image
    (row by row or column by column, last to first for direction 1), in
    x's dtype (autograd differentiates it)."""
    b, H, W, dg = x.shape
    L = H * W
    xs = x.reshape(b, L, dg)
    y = torch.zeros_like(xs)
    for d in range(2):
        for layout, p in enumerate(_pixels(H, W)):
            u = xs[:, p]
            dt = u @ w_dt[d, layout] + bias[d, layout]
            if softplus:
                dt = torch.nn.functional.softplus(dt)
            bm, cm = u @ w_b[d, layout], u @ w_c[d, layout]
            h = torch.zeros(b, A.shape[-2], dg, dtype=x.dtype)
            ys = [None] * L
            for t in (range(L - 1, -1, -1) if d else range(L)):
                h = torch.exp(dt[:, t, None, :] * A[d, layout]) * h + (
                    dt[:, t] * u[:, t])[:, None, :] * bm[:, t, :, None]
                ys[t] = (cm[:, t, :, None] * h).sum(1)
            y = y.index_add(1, p, torch.stack(ys, 1) + D[d, layout] * u)
    return y.reshape(x.shape)


@pytest.mark.parametrize("softplus", [False, True])
def test_image_backward_model_is_exact_in_fp64(softplus):
    """Three chunks, the last ragged, three state tiles, both directions:
    in fp64 the model's gradients equal autograd's of a sequential walk to
    rounding: the decomposition is exact."""
    b, H, W, dg, N = 2, 14, 25, 6, 40
    x = _inputs(b, H, W, dg, N, seed=5)
    if not softplus:  # d = dt + bias stays positive: a decay per step
        for k in ("x", "w_dt", "delta_bias"):
            x[k] = np.abs(x[k])
    got = _model_grads(x, softplus, torch.float64)
    leaves = {k: torch.from_numpy(x[k]).double().requires_grad_(True)
              for k in NAMES}
    y = sequential_image_scan(*leaves.values(), softplus)
    ref = torch.autograd.grad(
        (y * torch.from_numpy(x["dy"]).double()).sum(),
        list(leaves.values()))
    for k, r in zip(NAMES, ref):
        err = float((got[k] - r).abs().max())
        assert err < 1e-10 * max(1.0, float(r.abs().max())), (k, err)
