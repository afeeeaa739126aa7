"""bf16 scans with a gradient (ROADMAP B1), on the CPU.

The JAX package takes bf16 streams under `jax.grad` and returns bf16
gradients (`tests/test_pallas_scan_g.py::test_bf16_io`). The port's scan
entry points do the same: on the card the grouped entry points run their
forward and backward kernels on the bf16 operands (fp32 inside them; the
checkpoints stay fp32, ROADMAP C2) and return the stream cotangents in
bf16, while the image-layout scan runs its fp32 kernels from the entry on
and autograd casts the gradients back; on the CPU the plain versions run. Here the same seeded numpy inputs go
through JAX's `test_bf16_io` case and the port's `selective_scan_g`, and
through the four entry points against autograd of their plain versions in
fp32. Tolerance 5e-2 against max(|ref|, 1), the bf16 tier. The card's
side is `tests/test_torch_port_cuda.py::test_bf16_grads_at_the_entry_points`
and chip_smoke.py's backward phase.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.ops.pallas_scan_g import selective_scan_g as jax_scan_g
from sigma_tpu_torch.ops import scan_g

torch.set_num_threads(2)
TOL = 5e-2


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=TOL, atol=TOL)


def _streams(batch, G, L, dg, N, seed):
    """test_bf16_io's shapes and scales (u, d, A, B, C, D, bias)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(batch, G, L, dg), f(batch, G, L, dg) * 0.1,
            -np.exp(f(G, N, dg)), f(batch, G, L, N), f(batch, G, L, N),
            f(G, dg), f(G, dg) * 0.1)


def test_bf16_grad_matches_jax_test_bf16_io():
    """JAX's bf16 case (batch 2, G 2, L 64, dg 24, N 4): y and du of
    sum(y^2) with bf16 u, delta, B, C, in the port and in JAX (its Pallas
    kernel in interpret mode); both return bf16."""
    u, d, A, Bm, Cm, D, bias = _streams(2, 2, 64, 24, 4, seed=7)
    bf = jnp.bfloat16

    def jax_loss(u_):
        return (jax_scan_g(
            u_, jnp.asarray(d, bf), jnp.asarray(A), jnp.asarray(Bm, bf),
            jnp.asarray(Cm, bf), D=jnp.asarray(D), delta_bias=jnp.asarray(bias),
            delta_softplus=True, block_t=32).astype(jnp.float32) ** 2).sum()

    want = jax.grad(jax_loss)(jnp.asarray(u, bf))
    assert want.dtype == bf

    t = [torch.from_numpy(x) for x in (u, d, A, Bm, Cm, D, bias)]
    ut = t[0].bfloat16().requires_grad_(True)
    y = scan_g.selective_scan_g(ut, t[1].bfloat16(), t[2], t[3].bfloat16(),
                                t[4].bfloat16(), D=t[5], delta_bias=t[6],
                                delta_softplus=True)
    assert y.dtype == torch.bfloat16
    (got,) = torch.autograd.grad((y.float() ** 2).sum(), ut)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32))


def _proj(batch, G, L, dg, N, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    return dict(w_dt=f(G, dg, dg) * (0.3 / dg ** 0.5),
                w_b=f(G, dg, N) / dg ** 0.5, w_c=f(G, dg, N) / dg ** 0.5,
                A=-torch.exp(f(G, N, dg)), D=f(G, dg),
                delta_bias=f(G, dg) * 0.1), f(batch, G, L, dg)


def _entry(name):
    """(fn(u, weights) -> y, the bf16 tensors) of one entry point; fn takes
    the u and the weights in one dtype, the rest fp32."""
    if name == "selective_scan_ss2d_proj":
        w, _ = _proj(2, 4, 1, 16, 4, seed=11)
        w = {k: v.reshape(2, 2, *v.shape[1:]) for k, v in w.items()}
        x = torch.randn(2, 5, 6, 16, generator=torch.Generator()
                        .manual_seed(11))
        return (lambda u, ws: scan_g.selective_scan_ss2d_proj(
            u, *ws, w["A"], w["D"], w["delta_bias"], delta_softplus=True),
            x, [w["w_dt"], w["w_b"], w["w_c"]])
    w, u = _proj(2, 2, 40, 16, 4, seed=12)
    opts = dict(D=w["D"], delta_bias=w["delta_bias"], delta_softplus=True,
                reverse=True)
    ws = [w["w_dt"], w["w_b"], w["w_c"]]
    if name == "selective_scan_g":
        return (lambda u, ws: scan_g.selective_scan_g(
            u, u @ ws[0], w["A"], u @ ws[1], u @ ws[2], **opts), u, ws)
    if name == "selective_scan_g_proj":
        return (lambda u, ws: scan_g.selective_scan_g_proj(
            u, *ws, w["A"], swap_groups_c=True, **opts), u, ws)
    return (lambda u, ws: torch.stack(scan_g.selective_scan_g_proj_ml(
        (u[:, 0], u[:, 1]), *ws, w["A"], **opts), 1), u, ws)


@pytest.mark.parametrize("name", ["selective_scan_g", "selective_scan_g_proj",
                                  "selective_scan_g_proj_ml",
                                  "selective_scan_ss2d_proj"])
def test_bf16_grads_at_the_entry_points(name):
    """bf16 u and weights with a gradient: y and every gradient come back
    bf16, within 5e-2 of autograd of the same function in fp32."""
    fn, u, ws = _entry(name)
    dy = torch.randn(u.shape, generator=torch.Generator().manual_seed(1))
    grads = {}
    for dtype in (torch.bfloat16, torch.float32):
        leaves = [t.to(dtype).requires_grad_(True) for t in [u, *ws]]
        y = fn(leaves[0], leaves[1:])
        assert y.dtype == dtype
        grads[dtype] = torch.autograd.grad(y.float(), leaves, dy)
    for got, want in zip(grads[torch.bfloat16], grads[torch.float32]):
        assert got.dtype == torch.bfloat16
        _close(got.float().numpy(), want.numpy())
