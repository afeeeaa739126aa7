"""K8, the channel-first scan forward (`csrc/scan_cf.cu` on the chunk scan
of `csrc/chunk_fwd.cuh` that K1, K2 and K10 share), on the CPU.

K8 runs on the card only. Its source reads the reference's channel-first
layout — u, delta (batch, G*dg, L) and B, C (batch, G, N, L), each
channel's (state's) tokens contiguous — as the body's per-token rows: the
(rows, dg, L) tile a block stages is the transpose of the body's walk
slots, A is read in its (G*dg, N) layout (the transpose of the body's (G,
N, dg)), and bias, D and softplus stay outside the kernel (the body takes
the effective delta). It keeps every 32-token checkpoint of the body, for
K9, in the layout the backward body reads (rows, ceil(L / 32), N, dg).

That operand map is modelled here in plain torch on `chunk_scan_model`
(tests/test_torch_port_chunk_scan.py, 128-token chunks from a zero state,
the carries, the re-emission; states in tiles of 16 above 16, as the TILED
body) and held to JAX's channel-first Pallas forward
(`sigma_tpu/ops/pallas_scan.py::_fwd_call`, interpret mode, its padding
as `selective_scan_pallas_fwd` pads) at ragged L and d_state 16 and 40: y
and, of the checkpoints, every 8th against JAX's carries into its
256-token chunks, fp32 rtol 6e-4 / atol 2e-3 against max(|ref|, 1), as
chip_smoke.py holds K8; and in fp64 every checkpoint to a sequential
walk's states, to rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.ops.pallas_scan import _fwd_call, _tile_sizes
from sigma_tpu_torch.ops.scan_g import CK_TOKENS
from test_torch_port_chunk_scan import sequential_states
from test_torch_port_chunk_scan_fwd import tiled_chunk_model

torch.set_num_threads(2)
RTOL, ATOL = 6e-4, 2e-3
JAX_CHUNK = 256  # the l_chunk JAX's channel-first kernels default to
EVERY = JAX_CHUNK // CK_TOKENS  # checkpoints per JAX chunk carry


def _inputs(batch, G, dg, L, N, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(u=f(batch, G * dg, L),
                delta=np.log1p(np.exp(f(batch, G * dg, L) * 0.5 - 1.0)),
                A=-np.exp(f(G * dg, N) * 0.5), B=f(batch, G, N, L),
                C=f(batch, G, N, L))


def cf_chunk_model(u, delta, A, B, C):
    """K8 in plain torch: the channel-first operands as the body's rows,
    the (tiled) chunk body with no bias, D or softplus, y back to (batch,
    G*dg, L) and every checkpoint as (batch*G, ceil(L / 32), N, dg)."""
    batch, dim, L = u.shape
    G, N = B.shape[1], A.shape[1]
    dg = dim // G

    def rows(t, width):  # (batch, G*width, L) -> (batch, G, L, width)
        return t.reshape(batch, G, width, L).transpose(2, 3)

    a_t = A.reshape(G, dg, N).transpose(1, 2)
    zero = torch.zeros(G, dg, dtype=u.dtype)
    y, hck = tiled_chunk_model(rows(u, dg), rows(delta, dg),
                               B.transpose(2, 3), C.transpose(2, 3), a_t,
                               zero, zero, False, False)
    return (y.transpose(2, 3).reshape(batch, dim, L),
            hck.reshape(batch * G, -1, N, dg))


def _jax_forward(x, G):
    """y and the carries of JAX's channel-first Pallas forward, padded as
    `selective_scan_pallas_fwd` pads (dg to 8, L to the 256-token chunk)
    and cut back."""
    batch, dim, L = x["u"].shape
    N = x["A"].shape[1]
    dg = dim // G
    dpad = (-dg) % 8
    db, lc = _tile_sizes(dg + dpad, L, 64, JAX_CHUNK)
    lpad = (-L) % lc

    def rows(t, width, pad_rows):
        t = t.reshape(batch * G, width, L)
        return jnp.pad(t, ((0, 0), (0, pad_rows), (0, lpad)))

    a = jnp.pad(jnp.asarray(x["A"]).reshape(G, dg, N),
                ((0, 0), (0, dpad), (0, 0))).reshape(G * (dg + dpad), N)
    y, hck = _fwd_call(rows(x["u"], dg, dpad), rows(x["delta"], dg, dpad),
                       a, rows(x["B"], N, 0), rows(x["C"], N, 0), G, db, lc,
                       True)
    y = np.asarray(y)[:, :dg, :L].reshape(batch, dim, L)
    return y, np.asarray(hck)[:, :, :dg]


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=RTOL,
                               atol=ATOL, err_msg=name)


# (batch, G, dg, L, N): L 600 is two 256-token chunks and a ragged third
# (five 128-token chunks, the last ragged; 19 checkpoints, the last
# segment cut by L), dg 12 is padded by JAX; L 300 a chunk and a ragged
# one, N 40 three state tiles
CASES = [(2, 2, 8, 600, 16), (1, 2, 12, 300, 40)]


@pytest.mark.parametrize("batch,G,dg,L,N", CASES)
def test_channel_first_chunk_model_matches_jax(batch, G, dg, L, N):
    x = _inputs(batch, G, dg, L, N, seed=L + N)
    want_y, want_hck = _jax_forward(x, G)
    y, hck = cf_chunk_model(*(torch.from_numpy(x[k]) for k in
                              ("u", "delta", "A", "B", "C")))
    assert hck.shape == (batch * G, -(-L // CK_TOKENS), N, dg)
    carries = hck[:, ::EVERY].transpose(-1, -2)
    assert carries.shape == want_hck.shape
    _close(y.numpy(), want_y, "y")
    _close(carries.numpy(), want_hck, "hck")


def test_channel_first_carries_match_a_sequential_walk_in_fp64():
    """Many chunks, the last ragged, two state tiles, fp64: every
    checkpoint equals the state of a token-by-token walk as it enters the
    32-token segment."""
    batch, G, dg, L, N = 1, 3, 5, 4 * JAX_CHUNK + 77, 20
    x = {k: torch.from_numpy(v).double() for k, v in
         _inputs(batch, G, dg, L, N, seed=3).items()}
    _, hck = cf_chunk_model(x["u"], x["delta"], x["A"], x["B"], x["C"])
    u = x["u"].reshape(batch, G, dg, L).transpose(2, 3)
    d = x["delta"].reshape(batch, G, dg, L).transpose(2, 3)
    seq = sequential_states(u, d, x["B"].transpose(2, 3),
                            x["A"].reshape(G, dg, N).transpose(1, 2),
                            torch.zeros(G, dg, dtype=torch.float64), False,
                            False)
    want = seq.reshape(batch * G, -1, N, dg)
    assert hck.shape == want.shape
    assert float((hck - want).abs().max()) < 1e-12 * max(
        1.0, float(want.abs().max()))
