"""Scan gradients of the PyTorch port against the JAX package, on the CPU.

The port's scan entry points, on CPU tensors, take their plain PyTorch
versions and autograd differentiates them; the JAX entry points of
`sigma_tpu/ops/pallas_scan_g.py` run their custom VJPs (the Pallas backward
kernel, `_bwd_kernel`) in interpret mode with a small block_t, as
`tests/test_torch_port_ops.py` runs the forward. The same seeded numpy
inputs and the same random output cotangent go through both, and every
cotangent is compared: u (per layout), delta or W_dt, B or W_B, C or W_C,
A, D, dt bias, and y_accum. Tolerance: fp32 rtol 6e-4 / atol 2e-3, the
reference kernel-test envelope.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.ops import pallas_scan_g as jscan
from sigma_tpu_torch.ops import scan_g
from _port_load import few_torch_threads  # noqa: F401 (a fixture)

RTOL, ATOL = 6e-4, 2e-3


def _f(r, *shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, name):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32),
        rtol=RTOL, atol=ATOL, err_msg=name)


def _port_grads(fn, arrays, cots):
    """Autograd of sum_i <fn(**arrays)_i, cots_i> w.r.t. every array."""
    ts = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in arrays.items()}
    outs = fn(**ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    grads = torch.autograd.grad(loss, list(ts.values()))
    return [o.detach().numpy() for o in outs], {
        k: g.numpy() for k, g in zip(ts, grads)}


def _jax_grads(fn, arrays, cots):
    names = list(arrays)

    def loss(*xs):
        outs = fn(**dict(zip(names, xs)))
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, outs), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(names))), has_aux=True)(
            *(jnp.asarray(arrays[k]) for k in names))
    return [np.asarray(o) for o in outs], dict(zip(names, grads))


def _compare(port_fn, jax_fn, arrays, n_out, seed):
    r = np.random.default_rng(seed)
    shape = next(iter(arrays.values())).shape
    cots = [_f(r, *shape) for _ in range(n_out)]
    got_y, got = _port_grads(port_fn, arrays, cots)
    want_y, want = _jax_grads(jax_fn, arrays, cots)
    for g, w in zip(got_y, want_y):
        _close(g, w, "y")
    assert set(got) == set(want) == set(arrays)
    for k in arrays:
        _close(got[k], want[k], k)


@pytest.mark.parametrize("reverse", [False, True])
def test_streamed_scan_gradients_match_jax(reverse):
    batch, G, L, dg, N = 2, 2, 40, 16, 4
    r = np.random.default_rng(1)
    arrays = dict(
        u=_f(r, batch, G, L, dg), delta=_f(r, batch, G, L, dg, scale=0.1),
        A=-np.exp(_f(r, G, N, dg)), B=_f(r, batch, G, L, N),
        C=_f(r, batch, G, L, N), D=_f(r, G, dg),
        delta_bias=_f(r, G, dg, scale=0.1))
    kw = dict(delta_softplus=True, reverse=reverse)
    _compare(lambda **a: scan_g.selective_scan_g(**a, **kw),
             lambda **a: jscan.selective_scan_g(**a, block_t=16, **kw),
             arrays, 1, seed=2)


def _proj_weights(r, G, dg, N):
    return dict(
        w_dt=_f(r, G, dg, dg, scale=0.3 / dg ** 0.5),
        w_b=_f(r, G, dg, N, scale=dg ** -0.5),
        w_c=_f(r, G, dg, N, scale=dg ** -0.5), A=-np.exp(_f(r, G, N, dg)),
        D=_f(r, G, dg), delta_bias=_f(r, G, dg, scale=0.1))


@pytest.mark.parametrize("G,reverse,swap,accum", [
    (1, False, False, False),
    (1, True, False, True),     # the second direction group of a ConMB
    (2, True, True, True),      # a chain pair with CroMB's C swap
])
def test_fused_projection_scan_gradients_match_jax(G, reverse, swap, accum):
    batch, L, dg, N = 2, 48, 16, 4
    r = np.random.default_rng(3 + G)
    arrays = dict(u=_f(r, batch, G, L, dg), **_proj_weights(r, G, dg, N))
    if accum:
        arrays["y_accum"] = _f(r, batch, G, L, dg)
    kw = dict(delta_softplus=True, reverse=reverse, swap_groups_c=swap)
    _compare(lambda **a: scan_g.selective_scan_g_proj(**a, **kw),
             lambda **a: jscan.selective_scan_g_proj(**a, block_t=16, **kw),
             arrays, 1, seed=4)


@pytest.mark.parametrize("reverse,swap,accum", [
    (False, False, False),      # SS2D's first direction group
    (True, True, True),         # reversed, C swapped, y folded in
])
def test_two_layout_scan_gradients_match_jax(reverse, swap, accum):
    batch, L, dg, N = 2, 40, 16, 4
    r = np.random.default_rng(5)
    arrays = dict(u0=_f(r, batch, L, dg), u1=_f(r, batch, L, dg),
                  **_proj_weights(r, 2, dg, N))
    if accum:
        arrays.update(ya0=_f(r, batch, L, dg), ya1=_f(r, batch, L, dg))
    kw = dict(delta_softplus=True, reverse=reverse, swap_groups_c=swap)

    def split(a):
        us = (a.pop("u0"), a.pop("u1"))
        yas = (a.pop("ya0"), a.pop("ya1")) if "ya0" in a else None
        return us, yas, a

    def port(**a):
        us, yas, rest = split(a)
        return scan_g.selective_scan_g_proj_ml(us, **rest, y_accum=yas, **kw)

    def jax_fn(**a):
        us, yas, rest = split(a)
        return tuple(jscan.selective_scan_g_proj_ml(
            us, **rest, y_accum=yas, block_t=16, **kw))

    _compare(port, jax_fn, arrays, 2, seed=6)


def test_remat_chunks_leaves_gradients_unchanged():
    """The plain version's chunk recompute (chip_smoke's full-size
    reference) gives autograd the same gradients."""
    r = np.random.default_rng(7)
    batch, G, L, dg, N = 1, 2, 150, 8, 4
    arrays = dict(u=_f(r, batch, G, L, dg), **_proj_weights(r, G, dg, N))
    cots = [_f(r, batch, G, L, dg)]
    kw = dict(delta_softplus=True, reverse=True, swap_groups_c=True)
    _, want = _port_grads(
        lambda **a: scan_g.selective_scan_g_proj_plain(**a, **kw),
        arrays, cots)
    _, got = _port_grads(
        lambda **a: scan_g.selective_scan_g_proj_plain(
            **a, remat_chunks=True, **kw), arrays, cots)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


def test_proj_grad_plain_is_the_chain_rule_of_the_projections():
    """K5's plain version equals autograd through u @ W for the streams'
    cotangents (dC routed to the chain whose projection made it)."""
    r = np.random.default_rng(8)
    batch, G, L, dg, N = 2, 2, 20, 8, 4
    w = {k: torch.from_numpy(v) for k, v in _proj_weights(r, G, dg, N).items()}
    u = torch.from_numpy(_f(r, batch, G, L, dg)).requires_grad_(True)
    ws = [w[k].clone().requires_grad_(True) for k in ("w_dt", "w_b", "w_c")]
    z = [torch.from_numpy(_f(r, batch, G, L, n)) for n in (dg, N, N)]
    outs = [u @ wi for wi in ws]
    loss = sum((o * zi).sum() for o, zi in zip(outs, z))
    want = torch.autograd.grad(loss, [u, *ws])
    (du,), *dws = scan_g.proj_grad_plain((u.detach(),), *z,
                                         *[x.detach() for x in ws])
    torch.testing.assert_close(du, want[0])
    for g, wnt in zip(dws, want[1:]):
        torch.testing.assert_close(g, wnt)
