"""The port's ops-level scan API (`sigma_tpu_torch.ops`) against the JAX
package's (`sigma_tpu.ops`), on the CPU.

The same numpy inputs (made from a seed) go through the JAX entry points
with backend="pallas" (the Pallas kernels of `pallas_scan.py`,
`pallas_scan_bwd.py` and `pallas_scan_seq.py` in interpret mode, as
`tests/test_pallas_scan.py` runs them) and through the port's, which take
their plain PyTorch versions for CPU tensors. Tolerance: fp32 rtol 6e-4 /
atol 2e-3, gradients against max(|ref|, 1) as chip_smoke.py holds them.
Shapes stay small: interpret mode is slow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu.ops as jops
import sigma_tpu_torch.ops as tops
from sigma_tpu.ops.pallas_scan_seq import (
    selective_scan_seq_cl as jax_selective_scan_seq_cl,
)
from sigma_tpu_torch.ops.scan_cf import selective_scan_cf
from sigma_tpu_torch.ops.scan_seq import selective_scan_seq_cl

RTOL, ATOL = 6e-4, 2e-3
NAMES = ("u", "delta", "A", "B", "C", "D", "delta_bias")


def _cf_inputs(batch, dim, L, N, G, seed):
    """The channel-first operands of `tests/test_pallas_scan.py::_mk`."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(batch, dim, L), (0.5 * rng.random((batch, dim, L))).astype(
        np.float32), (-0.5 * rng.random((dim, N))).astype(np.float32),
        f(batch, G, N, L), f(batch, G, N, L), f(dim),
        (0.1 * rng.random(dim)).astype(np.float32))


def _cl_inputs(batch, G, dg, L, N, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bg = batch * G
    return (f(bg, L, dg), f(bg, L, dg) * 0.1, -np.exp(f(G, N, dg)),
            f(bg, L, N), f(bg, L, N), f(G, dg), f(G, dg) * 0.1)


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=name)


def _close_scaled(got, want, name):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    _close(np.asarray(got, np.float32) / scale, want / scale, name)


def _jax_grads(fn, args, cot):
    loss = lambda *a: jnp.sum(fn(*a) * cot)  # noqa: E731
    y = fn(*args)
    return y, jax.grad(loss, argnums=tuple(range(len(args))))(*args)


def _torch_grads(fn, args, cot):
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    y = fn(*leaves)
    (y * torch.from_numpy(cot)).sum().backward()
    return y.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("batch,dim,L,N,G", [
    (1, 12, 96, 8, 4),   # grouped, dg = 3
    (2, 16, 257, 4, 2),  # odd L
])
def test_selective_scan_forward_matches_jax(batch, dim, L, N, G):
    args = _cf_inputs(batch, dim, L, N, G, seed=batch * 100 + L)
    want = jops.selective_scan(*args, delta_softplus=True, backend="pallas")
    t = [torch.from_numpy(a) for a in args]
    got = tops.selective_scan(*t, delta_softplus=True)
    assert got.dtype == torch.float32 and got.shape == (batch, dim, L)
    _close(got, want)
    _close(selective_scan_cf(*t, delta_softplus=True), want)


def test_selective_scan_gradients_match_jax():
    """All seven gradients at test_pallas_scan.py's gradient shape."""
    args = _cf_inputs(2, 8, 130, 8, 1, seed=7)
    cot = np.random.default_rng(8).standard_normal((2, 8, 130)).astype(
        np.float32)
    want_y, want = _jax_grads(
        lambda *a: jops.selective_scan(*a, delta_softplus=True,
                                       backend="pallas"), args, cot)
    got_y, got = _torch_grads(
        lambda *a: tops.selective_scan(*a, delta_softplus=True), args, cot)
    _close(got_y, want_y)
    for name, g, w in zip(NAMES, got, want):
        _close_scaled(g, w, name)


def test_selective_scan_cl_matches_jax():
    """Forward and all seven gradients of the per-row channel-last entry
    point, (batch 2, G 2, dg 16, L 70, N 4)."""
    args = _cl_inputs(2, 2, 16, 70, 4, seed=11)
    cot = np.random.default_rng(12).standard_normal((4, 70, 16)).astype(
        np.float32)
    want_y, want = _jax_grads(
        lambda *a: jops.selective_scan_cl(*a, delta_softplus=True,
                                          backend="pallas"), args, cot)
    got_y, got = _torch_grads(
        lambda *a: tops.selective_scan_cl(*a, delta_softplus=True), args,
        cot)
    assert got_y.shape == (4, 70, 16)
    _close(got_y, want_y)
    for name, g, w in zip(NAMES, got, want):
        _close_scaled(g, w, name)


def test_selective_scan_seq_cl_matches_jax():
    args = _cl_inputs(2, 2, 16, 70, 4, seed=13)
    want = jax_selective_scan_seq_cl(*args, delta_softplus=True)
    got = selective_scan_seq_cl(*[torch.from_numpy(a) for a in args],
                                delta_softplus=True)
    assert got.dtype == torch.float32
    _close(got, want)


def test_cross_scan_and_merge_match_jax():
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    xe = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    ys = rng.standard_normal((2, 4, 15, 4)).astype(np.float32)
    ym = rng.standard_normal((2, 2, 30, 4)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_array_equal(tops.cross_scan(t(x)),
                                  jops.cross_scan(x))
    _close(tops.cross_merge(t(ys), 3, 5), jops.cross_merge(ys, 3, 5))
    np.testing.assert_array_equal(tops.cross_scan_multimodal(t(x), t(xe)),
                                  jops.cross_scan_multimodal(x, xe))
    for g, w in zip(tops.cross_merge_multimodal(t(ym)),
                    jops.cross_merge_multimodal(ym)):
        _close(g, w)
    # the merge is the scan's adjoint: <cross_scan(x), ys> = <x, merge(ys)>
    lhs = (tops.cross_scan(t(x)) * t(ys)).sum()
    rhs = (t(x) * tops.cross_merge(t(ys), 3, 5)).sum()
    torch.testing.assert_close(lhs, rhs)


@pytest.mark.parametrize("fn,shape", [
    (lambda m, y: m.cross_merge(y, 3, 5), (2, 3, 15, 4)),   # K != 4
    (lambda m, y: m.cross_merge(y, 3, 5), (2, 4, 16, 4)),   # L != h*w
    (lambda m, y: m.cross_merge_multimodal(y), (2, 4, 30, 4)),  # K != 2
])
def test_layout_shape_errors_match_jax(fn, shape):
    y = np.zeros(shape, np.float32)
    with pytest.raises(ValueError):
        fn(jops, y)
    with pytest.raises(ValueError, match="bad shape|expected K=2"):
        fn(tops, torch.from_numpy(y))


def test_ops_exports_match_jax():
    want = (set(jops.__all__) - {"selective_scan_xla"}) | {
        "selective_scan_chunked"}
    assert set(tops.__all__) == want
    assert all(callable(getattr(tops, name)) for name in tops.__all__)


def test_backend_keyword():
    """"auto" and "plain" take the plain version for CPU tensors (the same
    numbers); "kernel" takes CUDA tensors only; an unknown name raises."""
    cf = [torch.from_numpy(a) for a in _cf_inputs(1, 4, 20, 4, 2, seed=15)]
    cl = [torch.from_numpy(a) for a in _cl_inputs(1, 2, 4, 20, 4, seed=16)]
    for fn, args in ((tops.selective_scan, cf), (tops.selective_scan_cl, cl)):
        auto = fn(*args, delta_softplus=True)
        torch.testing.assert_close(
            fn(*args, delta_softplus=True, backend="plain"), auto)
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            fn(*args, backend="kernel")
        with pytest.raises(ValueError, match="backend 'pallas'"):
            fn(*args, backend="pallas")
        bf16 = fn(args[0].bfloat16(), *args[1:], delta_softplus=True)
        assert bf16.dtype == torch.bfloat16
        torch.testing.assert_close(bf16.float(), auto, rtol=5e-2, atol=5e-2)
