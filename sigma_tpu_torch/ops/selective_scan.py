"""Selective scan (Mamba S6 recurrence) in plain PyTorch.

Counterpart of `sigma_tpu/ops/selective_scan.py`. Per (batch b, channel d):

    delta_t = softplus(delta_t + delta_bias_d)          (if delta_softplus)
    h_t     = exp(delta_t * A_d) * h_{t-1} + delta_t * B_t * u_t
    y_t     = <C_t, h_t> + D_d * u_t

with h in R^N, h_0 = 0, all accumulation in float32.

This module is the CPU path of the port and the oracle that the Hopper
scan kernels (`ops/scan_g.py`) are held against on the card, forward and,
through autograd, backward:
  * `selective_scan_ref` — sequential, one step per token (tests only);
  * `selective_scan_chunked` — the chunked two-level scan of
    `selective_scan_xla`: a doubling (Hillis-Steele) scan inside fixed-size
    chunks, the float32 carry passed from chunk to chunk;
  * `selective_scan_cl` — the channel-last grouped layout the models use.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


# chunk length of the chunked scan; it changes only float32 association
CHUNK = 64


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) in the overflow-free form jax.nn.softplus uses
    (logaddexp(x, 0)); F.softplus switches to the identity above 20."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _effective_delta(delta, delta_bias, delta_softplus, bias_shape):
    delta = delta.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float().reshape(bias_shape)
    if delta_softplus:
        delta = softplus(delta)
    return delta


def selective_scan_ref(u, delta, A, B, C, D=None, delta_bias=None,
                       delta_softplus=False):
    """Sequential reference (mirror of the reference's pure-PyTorch
    `selective_scan_ref`). Slow; for tests only.

    u, delta: (batch, dim, L); A: (dim, N) negative; B, C: (batch, G, N, L)
    with G groups dividing dim; D, delta_bias: (dim,). Returns y like u.
    """
    batch, dim, L = u.shape
    G, N = B.shape[1], A.shape[1]
    dg = dim // G
    uf = u.float()
    d = _effective_delta(delta, delta_bias, delta_softplus, (1, dim, 1))
    u_g = uf.reshape(batch, G, dg, L)
    d_g = d.reshape(batch, G, dg, L)
    A_g = A.float().reshape(G, dg, N)
    Bf, Cf = B.float(), C.float()
    h = torch.zeros(batch, G, dg, N, dtype=torch.float32, device=u.device)
    ys = []
    for t in range(L):
        a = torch.exp(d_g[..., t, None] * A_g)
        h = a * h + (d_g[..., t] * u_g[..., t])[..., None] * Bf[:, :, None, :, t]
        ys.append(torch.einsum("bgdn,bgn->bgd", h, Cf[..., t]))
    y = torch.stack(ys, dim=-1).reshape(batch, dim, L)
    if D is not None:
        y = y + D.float()[None, :, None] * uf
    return y.to(u.dtype)


def _doubling_scan(a, b, dim):
    """Inclusive scan of h_t = a_t * h_{t-1} + b_t along `dim` (h_{-1} = 0):
    log2(len) rounds of the associative combine (a1*a0, a1*b0 + b1)."""
    n = a.shape[dim]
    k = 1
    while k < n:
        a_lo, b_lo = a.narrow(dim, 0, n - k), b.narrow(dim, 0, n - k)
        a_hi, b_hi = a.narrow(dim, k, n - k), b.narrow(dim, k, n - k)
        b = torch.cat([b.narrow(dim, 0, k), a_hi * b_lo + b_hi], dim)
        a = torch.cat([a.narrow(dim, 0, k), a_hi * a_lo], dim)
        k *= 2
    return a, b


def _scan_chunk(h, d_c, u_c, A_t, B_c, C_c):
    """One chunk of `_scan_grouped`: (y chunk, carry out)."""
    a = torch.exp(d_c[..., None] * A_t[None, :, None])  # (b, G, c, dg, N)
    bx = (d_c * u_c)[..., None] * B_c[:, :, :, None, :]
    a_s, b_s = _doubling_scan(a, bx, 2)
    h_all = b_s + a_s * h[:, :, None]
    return torch.einsum("bgcdn,bgcn->bgcd", h_all, C_c), h_all[:, :, -1]


def _scan_grouped(u, d_eff, A_t, B, C, chunk, remat_chunks=False):
    """Chunked scan in the grouped channel-last layout, float32.

    u, d_eff: (batch, G, L, dg); A_t: (G, dg, N); B, C: (batch, G, L, N).
    Returns y (batch, G, L, dg) without the D skip. `remat_chunks` keeps
    only each chunk's inputs for autograd and recomputes the chunk in the
    backward pass (same values; bounds the memory of a differentiated
    full-size call to about one chunk's intermediates).
    """
    batch, G, L, dg = u.shape
    N = A_t.shape[-1]
    h = torch.zeros(batch, G, dg, N, dtype=torch.float32, device=u.device)
    ys = []
    for t0 in range(0, L, chunk):
        c = min(chunk, L - t0)
        args = (h, d_eff[:, :, t0:t0 + c], u[:, :, t0:t0 + c], A_t,
                B[:, :, t0:t0 + c], C[:, :, t0:t0 + c])
        if remat_chunks:
            y_c, h = checkpoint(_scan_chunk, *args, use_reentrant=False)
        else:
            y_c, h = _scan_chunk(*args)
        ys.append(y_c)
    return torch.cat(ys, dim=2)


def selective_scan_chunked(u, delta, A, B, C, D=None, delta_bias=None,
                           delta_softplus=False, chunk: int = CHUNK):
    """Chunked two-level selective scan (counterpart of
    `selective_scan_xla`). Same signature and semantics as
    `selective_scan_ref`; `chunk` changes only float32 association."""
    batch, dim, L = u.shape
    G, N = B.shape[1], A.shape[1]
    if dim % G:
        raise ValueError(f"dim={dim} not divisible by groups={G}")
    dg = dim // G
    uf = u.float()
    d = _effective_delta(delta, delta_bias, delta_softplus, (1, dim, 1))
    y = _scan_grouped(
        uf.reshape(batch, G, dg, L).transpose(2, 3),
        d.reshape(batch, G, dg, L).transpose(2, 3),
        A.float().reshape(G, dg, N),
        B.float().transpose(2, 3),
        C.float().transpose(2, 3),
        chunk,
    )
    y = y.transpose(2, 3).reshape(batch, dim, L)
    if D is not None:
        y = y + D.float()[None, :, None] * uf
    return y.to(u.dtype)


def selective_scan_cl(u, delta, A, B, C, D=None, delta_bias=None,
                      delta_softplus=False, remat_chunks=False):
    """Channel-last grouped selective scan (the model-native layout).

    u, delta: (batch*G, L, dg), rows batch-major; A: (G, N, dg) negative;
    B, C: (batch*G, L, N); D, delta_bias: (G, dg). Returns y like u.
    `remat_chunks`: see `_scan_grouped`.
    """
    bg, L, dg = u.shape
    G, N, _ = A.shape
    batch = bg // G
    uf = u.float().reshape(batch, G, L, dg)
    d = _effective_delta(
        delta.reshape(batch, G, L, dg), delta_bias, delta_softplus,
        (1, G, 1, dg),
    )
    y = _scan_grouped(
        uf, d, A.float().transpose(1, 2),
        B.float().reshape(batch, G, L, N), C.float().reshape(batch, G, L, N),
        CHUNK, remat_chunks,
    )
    if D is not None:
        y = y + D.float().reshape(1, G, 1, dg) * uf
    return y.reshape(bg, L, dg).to(u.dtype)


__all__ = [
    "selective_scan_chunked",
    "selective_scan_cl",
    "selective_scan_ref",
    "softplus",
]
