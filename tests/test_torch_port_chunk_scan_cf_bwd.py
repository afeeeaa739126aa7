"""The algebra of K9, the channel-first scan backward (`csrc/scan_cf.cu` on
the chunk backward of `csrc/chunk_bwd.cuh` that K3, K4 and K11 share), on
the CPU.

K9 runs on the card only. Its source reads the reference's channel-first
layout — u, delta, dy (batch, G*dg, L) and B, C (batch, G, N, L), each
channel's (state's) tokens contiguous — as the body's rows; A in its (G*dg,
N) layout; the effective delta (no bias, no softplus) and no D, which the
caller differentiates. It reads every 32-token checkpoint K8 wrote (rows,
ceil(L / 32), N, dg), and leaves dA as per-chunk partials and dB / dC as
per-32-channel-block partials, which the wrapper sums in a fixed order.

That decomposition is modelled here in plain torch on `chunk_bwd_model`
(tests/test_torch_port_chunk_scan_bwd.py: 128-token chunks, the last
ragged, each chunk's adjoint from zero, the carries, h per 32-token
segment from the checkpoints, the re-sweep and its partials; states in
tiles of 16 above 16, as the TILED body), fed K8's checkpoints from its
forward model (`cf_chunk_model`, tests/test_torch_port_chunk_scan_cf.py),
and held two ways: the five core gradients to `jax.vjp` of
`sigma_tpu.ops.pallas_scan.selective_scan_pallas` (its Pallas backward in
interpret mode) at the fp32 tier, rtol 6e-4 / atol 2e-3 against
max(|ref|, 1), as chip_smoke.py holds K9; and in fp64 to autograd of a
sequential walk, to rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.ops.pallas_scan import selective_scan_pallas
from sigma_tpu_torch.ops.scan_cf import CF_BWD_CHANNELS
from sigma_tpu_torch.ops.scan_g import BWD_CHANNELS
from test_torch_port_chunk_scan_cf import _inputs, cf_chunk_model
from test_torch_port_chunk_scan_img_bwd import tiled_bwd_model

torch.set_num_threads(2)
RTOL, ATOL = 6e-4, 2e-3
NAMES = ("u", "delta", "A", "B", "C")


def cf_bwd_model(u, delta, A, B, C, dy):
    """K9 in plain torch, given K8's checkpoints from its forward model: the
    channel-first operands as the body's rows, the (tiled) chunk backward
    with zero bias and D and no softplus, dA from its per-chunk partials
    summed over chunks and batch into A's (G*dg, N), dB / dC from the
    32-channel-block partials. Returns (du, ddelta, dA, dB, dC)."""
    batch, dim, L = u.shape
    G, N = B.shape[1], A.shape[1]
    dg = dim // G

    def rows(t, width):  # (batch, G*width, L) -> (batch, G, L, width)
        return t.reshape(batch, G, width, L).transpose(2, 3)

    def back(t, width):  # the inverse of rows
        return t.transpose(2, 3).reshape(batch, G * width, L)

    _, hck = cf_chunk_model(u, delta, A, B, C)
    a_t = A.reshape(G, dg, N).transpose(1, 2)
    zero = torch.zeros(G, dg, dtype=u.dtype)
    g = tiled_bwd_model(rows(u, dg), rows(delta, dg), B.transpose(2, 3),
                        C.transpose(2, 3), a_t, zero, zero, False, False,
                        rows(dy, dg), hck.reshape(batch, G, -1, N, dg))
    return (back(g["du"], dg), back(g["dd"], dg),
            g["dA"].transpose(1, 2).reshape(dim, N),
            g["dB"].transpose(2, 3), g["dC"].transpose(2, 3))


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=RTOL,
                               atol=ATOL, err_msg=name)


# (batch, G, dg, L, N): L 300 and 170 are not multiples of 128 or 32 (a
# ragged last chunk and segment); dg 40 and 36 are two channel blocks, the
# second ragged; N 20 two state tiles, the second ragged (the TILED walk)
CASES = [(2, 1, 40, 300, 4), (2, 2, 36, 170, 16), (2, 4, 40, 77, 20)]


@pytest.mark.parametrize("batch,G,dg,L,N", CASES)
def test_channel_first_backward_model_matches_jax(batch, G, dg, L, N):
    # the model sums dB / dC over blocks of K9's channel count
    assert BWD_CHANNELS == CF_BWD_CHANNELS == 32
    x = _inputs(batch, G, dg, L, N, seed=L + N + G)
    dy = np.random.default_rng(L).standard_normal(
        (batch, G * dg, L)).astype(np.float32)
    _, vjp = jax.vjp(selective_scan_pallas,
                     *(jnp.asarray(x[k]) for k in NAMES))
    want = vjp(jnp.asarray(dy))
    got = cf_bwd_model(*(torch.from_numpy(x[k]) for k in NAMES),
                       torch.from_numpy(dy))
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        _close(g.numpy(), w, f"d{name}")


def sequential_cf_scan(u, delta, A, B, C):
    """y of a plain token-by-token walk in the channel-first layout, in u's
    dtype (autograd differentiates it)."""
    batch, dim, L = u.shape
    G, N = B.shape[1], A.shape[1]
    dg = dim // G
    h = torch.zeros(batch, G, dg, N, dtype=u.dtype)
    a_g = A.reshape(G, dg, N)
    ys = []
    for t in range(L):
        d = delta[:, :, t].reshape(batch, G, dg, 1)
        h = torch.exp(d * a_g) * h + (
            d * u[:, :, t].reshape(batch, G, dg, 1)) * B[:, :, None, :, t]
        ys.append((h * C[:, :, None, :, t]).sum(-1).reshape(batch, dim))
    return torch.stack(ys, -1)


def test_channel_first_backward_model_is_exact_in_fp64():
    """Three chunks, the last ragged, two channel blocks, three state tiles,
    fp64: the model's five gradients equal autograd's of a sequential walk
    to rounding: the decomposition is exact."""
    batch, G, dg, L, N = 2, 2, 35, 300, 40
    x = {k: torch.from_numpy(v).double() for k, v in
         _inputs(batch, G, dg, L, N, seed=9).items()}
    dy = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (batch, G * dg, L)))
    got = cf_bwd_model(*(x[k] for k in NAMES), dy)
    leaves = [x[k].clone().requires_grad_(True) for k in NAMES]
    ref = torch.autograd.grad((sequential_cf_scan(*leaves) * dy).sum(),
                              leaves)
    for name, g, r in zip(NAMES, got, ref):
        err = float((g - r).abs().max())
        assert err < 1e-10 * max(1.0, float(r.abs().max())), (name, err)
