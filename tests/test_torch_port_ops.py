"""Scan ops of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through the JAX entry points
of `sigma_tpu/ops/pallas_scan_g.py` (Pallas interpret mode on the CPU, as
`tests/test_pallas_scan_g.py` runs them) and through the port's entry
points in `sigma_tpu_torch/ops/scan_g.py`, which take their plain PyTorch
versions for CPU tensors. Tolerance: fp32 rtol 6e-4 / atol 2e-3, the
reference kernel-test envelope.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.ops import pallas_scan_g as jscan
from sigma_tpu.ops.selective_scan import selective_scan_ref as jax_scan_ref
from sigma_tpu_torch.ops import _build, scan_g
from sigma_tpu_torch.ops.selective_scan import (
    selective_scan_chunked,
    selective_scan_cl,
    selective_scan_ref,
)
from _port_load import few_torch_threads  # noqa: F401 (a fixture)

RTOL, ATOL = 6e-4, 2e-3


def _rng(seed):
    return np.random.default_rng(seed)


def _streams(batch, G, L, dg, N, seed=0):
    r = _rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(
        u=f(batch, G, L, dg), delta=f(batch, G, L, dg) * 0.1,
        A=-np.exp(f(G, N, dg)), B=f(batch, G, L, N), C=f(batch, G, L, N),
        D=f(G, dg), delta_bias=f(G, dg) * 0.1,
    )


def _proj(G, dg, N, seed=1):
    r = _rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(
        w_dt=f(G, dg, dg) * (0.3 / dg ** 0.5), w_b=f(G, dg, N) / dg ** 0.5,
        w_c=f(G, dg, N) / dg ** 0.5, A=-np.exp(f(G, N, dg)), D=f(G, dg),
        delta_bias=f(G, dg) * 0.1,
    )


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _close(got, want, **kw):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32),
        rtol=RTOL, atol=ATOL, **kw,
    )


def test_sequential_and_chunked_scans_match_jax_ref():
    batch, dim, L, G, N = 2, 12, 40, 3, 4
    r = _rng(3)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    args = dict(u=f(batch, dim, L), delta=f(batch, dim, L) * 0.1,
                A=-np.exp(f(dim, N)), B=f(batch, G, N, L), C=f(batch, G, N, L),
                D=f(dim), delta_bias=f(dim) * 0.1)
    want = jax_scan_ref(**_j(args), delta_softplus=True)
    _close(selective_scan_ref(**_t(args), delta_softplus=True), want)
    for chunk in (7, 16, 64):
        _close(selective_scan_chunked(**_t(args), delta_softplus=True,
                                      chunk=chunk), want)


@pytest.mark.parametrize("reverse", [False, True])
def test_selective_scan_g_matches_jax(reverse):
    s = _streams(2, 2, 88, 24, 4, seed=5)
    want = jscan.selective_scan_g(
        **_j(s), delta_softplus=True, block_t=32, reverse=reverse,
    )
    got = scan_g.selective_scan_g(**_t(s), delta_softplus=True,
                                  reverse=reverse)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)


def test_selective_scan_g_proj_reverse_accum_matches_jax():
    batch, G, L, dg, N = 2, 1, 64, 16, 4
    p = _proj(G, dg, N, seed=2)
    r = _rng(4)
    u = r.standard_normal((batch, G, L, dg)).astype(np.float32)
    ya = r.standard_normal((batch, G, L, dg)).astype(np.float32)
    want = jscan.selective_scan_g_proj(
        jnp.asarray(u), **_j(p), delta_softplus=True, block_t=32,
        reverse=True, y_accum=jnp.asarray(ya),
    )
    got = scan_g.selective_scan_g_proj(
        torch.from_numpy(u), **_t(p), delta_softplus=True, reverse=True,
        y_accum=torch.from_numpy(ya),
    )
    _close(got, want)


def test_selective_scan_g_proj_ml_swap_reverse_accum_matches_jax():
    batch, L, dg, N = 2, 48, 16, 4
    p = _proj(2, dg, N, seed=6)
    r = _rng(7)
    us = [r.standard_normal((batch, L, dg)).astype(np.float32) for _ in "ab"]
    ya = [r.standard_normal((batch, L, dg)).astype(np.float32) for _ in "ab"]
    want = jscan.selective_scan_g_proj_ml(
        tuple(jnp.asarray(x) for x in us), **_j(p), delta_softplus=True,
        block_t=16, reverse=True, swap_groups_c=True,
        y_accum=tuple(jnp.asarray(x) for x in ya),
    )
    got = scan_g.selective_scan_g_proj_ml(
        tuple(torch.from_numpy(x) for x in us), **_t(p), delta_softplus=True,
        reverse=True, swap_groups_c=True,
        y_accum=tuple(torch.from_numpy(x) for x in ya),
    )
    for g, w in zip(got, want):
        _close(g, w)


def test_proj_equals_streamed_on_projected_inputs():
    """The two kernels' plain versions agree: the fused-projection entry
    point equals the streamed one fed u @ W (with the C pair swap)."""
    batch, G, L, dg, N = 1, 2, 30, 8, 4
    p = _t(_proj(G, dg, N, seed=8))
    u = torch.from_numpy(
        _rng(9).standard_normal((batch, G, L, dg)).astype(np.float32))
    got = scan_g.selective_scan_g_proj(
        u, p["w_dt"], p["w_b"], p["w_c"], p["A"], p["D"], p["delta_bias"],
        True, False, True,
    )
    cs = (u @ p["w_c"]).flip(1)
    want = scan_g.selective_scan_g(
        u, u @ p["w_dt"], p["A"], u @ p["w_b"], cs, p["D"], p["delta_bias"],
        True,
    )
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_channel_last_matches_grouped_entry():
    s = _t(_streams(3, 2, 20, 8, 4, seed=10))
    b, G, L, dg = s["u"].shape
    y_cl = selective_scan_cl(
        s["u"].reshape(b * G, L, dg), s["delta"].reshape(b * G, L, dg),
        s["A"], s["B"].reshape(b * G, L, 4), s["C"].reshape(b * G, L, 4),
        s["D"], s["delta_bias"], True,
    )
    y_g = scan_g.selective_scan_g(**s, delta_softplus=True)
    torch.testing.assert_close(y_cl.reshape(b, G, L, dg), y_g)


def test_bf16_io_keeps_dtype():
    s = _t(_streams(1, 2, 32, 8, 4, seed=11))
    want = scan_g.selective_scan_g(**s, delta_softplus=True)
    for k in ("u", "delta", "B", "C"):
        s[k] = s[k].bfloat16()
    got = scan_g.selective_scan_g(**s, delta_softplus=True)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize(
    "G,dg,fused",
    [
        (2, 192, True), (2, 384, True), (2, 768, True),  # SS2D/CroMB 0-2
        (1, 768, True),                                   # ConMB stage 2
        (2, 1536, False), (1, 1536, False),               # stage 3
    ],
)
def test_kernel_routing_at_sigma_tiny(G, dg, fused):
    """The inherited 6*G*dg^2 <= 12 MiB split routes every sigma_tiny
    stage-3 scan to the streamed kernel and every other scan to the
    fused-projection kernel (pallas_scan_g.py:1557)."""
    assert scan_g.uses_fused_projection(G, dg) is fused


def test_plain_path_is_differentiable_on_cpu():
    s = _t(_streams(1, 1, 12, 4, 4, seed=12))
    s["u"].requires_grad_(True)
    scan_g.selective_scan_g(**s, delta_softplus=True).sum().backward()
    assert torch.isfinite(s["u"].grad).all()


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails makes the build raise; nothing falls back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build.__wrapped__()
