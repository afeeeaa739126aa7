"""The port's image-layout SS2D scan (`selective_scan_ss2d_proj`) against
the JAX package's, on the CPU, and the state split that lets the port's
scan entry points take d_state above 16.

The same numpy inputs (made from a seed) go through
`sigma_tpu.ops.pallas_scan_g.selective_scan_ss2d_proj` (its Pallas kernels
in interpret mode, as `tests/test_pallas_scan_g.py` runs them) and through
the port's, which takes its plain PyTorch version for CPU tensors. Where
JAX's planner finds no tiling it returns None and its caller takes the
stacked-layout path (`_img_ref` of the JAX test); the port returns y at
every geometry (ROADMAP C7), held against that stacked composition.
Tolerance: fp32 rtol 6e-4 / atol 2e-3 against max(|ref|, 1), as
chip_smoke.py holds the kernels. Each JAX result is computed once, value
and gradients together; shapes stay small, interpret mode is slow.
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.ops.pallas_scan_g import _plan_img
from sigma_tpu.ops.pallas_scan_g import selective_scan_g_proj as jax_g_proj
from sigma_tpu.ops.pallas_scan_g import (
    selective_scan_ss2d_proj as jax_ss2d_proj,
)
from sigma_tpu_torch.ops import scan_g, scan_img
from sigma_tpu_torch.ops.scan_g import selective_scan_ss2d_proj

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 6e-4, 2e-3
NAMES = ("x", "w_dt", "w_b", "w_c", "A", "D", "delta_bias")


def _inputs(b, H, W, dg, N, seed, with_d, with_bias):
    """x, weights [direction, layout], A, D, delta_bias (None when left
    out) and a cotangent, as `test_image_kernel_matches_stacked_path`
    scales them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    args = [f(b, H, W, dg), f(2, 2, dg, dg) * np.float32(0.3 / dg ** 0.5),
            f(2, 2, dg, N) / np.float32(dg ** 0.5),
            f(2, 2, dg, N) / np.float32(dg ** 0.5),
            -np.exp(f(2, 2, N, dg)), f(2, 2, dg), f(2, 2, dg) * 0.1]
    if not with_d:
        args[5] = None
    if not with_bias:
        args[6] = None
    return args, f(b, H, W, dg)


def _jax_stacked(x, wdt, wb, wc, A, D, bias, softplus):
    """The stacked-layout composition JAX's caller falls back to: the two
    layouts, one direction-paired fused-projection scan per direction,
    the wh output un-transposed, the four summed (`_img_ref`)."""
    b, h, w, dg = x.shape
    u2 = jnp.stack([x.reshape(b, h * w, dg),
                    jnp.swapaxes(x, 1, 2).reshape(b, h * w, dg)], axis=1)
    y = None
    for d in range(2):
        yd = jax_g_proj(u2, wdt[d], wb[d], wc[d], A[d],
                        D=None if D is None else D[d],
                        delta_bias=None if bias is None else bias[d],
                        delta_softplus=softplus, reverse=d == 1,
                        interpret=True)
        y = yd if y is None else y + yd
    return y[:, 0].reshape(b, h, w, dg) + jnp.swapaxes(
        y[:, 1].reshape(b, w, h, dg), 1, 2)


CASES = {
    # name: (b, H, W, dg, N, D given, delta_bias given, softplus)
    # _plan_img (2, 4, 8, 64, 8): 64-token blocks, two per sequence
    "planned": (2, 8, 16, 16, 8, True, True, True),
    "planned_bare": (2, 8, 16, 16, 8, False, False, False),
    # T = 120 is not a multiple of 32: JAX returns None
    "no_plan": (2, 6, 10, 16, 8, True, True, True),
}


@functools.lru_cache(maxsize=None)
def _jax_result(name):
    """(inputs, cotangent, JAX y, JAX gradients of sum(y * cot)); the
    image kernel where JAX plans one, the stacked path where it does not."""
    b, H, W, dg, N, with_d, with_bias, softplus = CASES[name]
    args, cot = _inputs(b, H, W, dg, N, seed=len(name), with_d=with_d,
                        with_bias=with_bias)
    live = [i for i, a in enumerate(args) if a is not None]
    planned = _plan_img(b, H, W, dg, N, 4) is not None
    got = jax_ss2d_proj(*args, delta_softplus=softplus, interpret=True)
    assert (got is None) != planned

    def fn(*live_args):
        full = list(args)
        for i, a in zip(live, live_args):
            full[i] = a
        if planned:
            return jax_ss2d_proj(*full, delta_softplus=softplus,
                                 interpret=True)
        return _jax_stacked(*full, softplus)

    y, vjp = jax.vjp(fn, *(jnp.asarray(args[i]) for i in live))
    grads = dict(zip((NAMES[i] for i in live), vjp(jnp.asarray(cot))))
    return args, cot, softplus, np.asarray(y), {
        k: np.asarray(v) for k, v in grads.items()}


def _close_scaled(got, want, name):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float32) / scale,
                               want / scale, rtol=RTOL, atol=ATOL,
                               err_msg=name)


def _port_result(args, cot, softplus, **kw):
    leaves = {k: None if a is None else torch.from_numpy(a.copy())
              .requires_grad_(True) for k, a in zip(NAMES, args)}
    y = selective_scan_ss2d_proj(*leaves.values(), delta_softplus=softplus,
                                 **kw)
    (y * torch.from_numpy(cot)).sum().backward()
    return y.detach(), {k: v.grad for k, v in leaves.items()
                        if v is not None}


@pytest.mark.parametrize("name", list(CASES))
def test_image_scan_matches_jax(name):
    """y and all seven gradient groups (those given) against JAX: the
    image kernel in interpret mode where `_plan_img` plans (two token
    blocks), the stacked composition where JAX returns None (C7)."""
    args, cot, softplus, want_y, want = _jax_result(name)
    if CASES[name][5]:
        assert set(want) == set(NAMES)
    got_y, got = _port_result(args, cot, softplus)
    assert got_y.shape == want_y.shape and got_y.dtype == torch.float32
    _close_scaled(got_y, want_y, "y")
    assert set(got) == set(want)
    for k in want:
        _close_scaled(got[k], want[k], "d" + k)


def test_fold_batch_changes_nothing():
    args, cot, softplus, want_y, _ = _jax_result("planned")
    got_y, _ = _port_result(args, cot, softplus, fold_batch=False)
    _close_scaled(got_y, want_y, "y")


def test_image_scan_equals_ss2d_project_scan():
    """With the direction weights of a port sigma_test SS2D, composed as
    `project_scan` composes them, the image scan equals SS2D's two-call
    scan of its (hw, wh) layouts with the wh output un-transposed
    (`models/ss2d.py`: project_scan and the CrossMerge in forward)."""
    import torch.nn.functional as F

    from sigma_tpu_torch.models.builder import EncoderDecoder, init_parameters
    from sigma_tpu_torch.models.common import conv2d_nhwc
    from sigma_tpu_torch.models.ss2d import SS2D, project_scan

    model = init_parameters(EncoderDecoder(9, "sigma_test"), seed=3)
    m = next(mod for mod in model.modules() if isinstance(mod, SS2D))
    d_model = m.in_proj.in_features
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 6, 10, d_model)).astype(np.float32))
    with torch.no_grad():
        xx = m.in_proj(x)[..., :m.d_inner]
        xx = F.silu(conv2d_nhwc(m.conv2d, xx))
        b, h, w, d = xx.shape
        y_hw, y_wh = project_scan(
            m, (xx.reshape(b, h * w, d), xx.transpose(1, 2).reshape(
                b, h * w, d)), m.d_state, m.dt_rank)
        want = y_hw.reshape(b, h, w, d) + y_wh.reshape(b, w, h, d) \
            .transpose(1, 2)
        n, r = m.d_state, m.dt_rank
        xw = m.x_proj_weight
        w_dt = torch.einsum("krd,ker->kde", xw[:, :r], m.dt_projs_weight)
        w_b = xw[:, r:r + n].transpose(1, 2)
        w_c = xw[:, r + n:].transpose(1, 2)
        A = -torch.exp(m.A_logs).reshape(4, d, n).transpose(1, 2)
        got = selective_scan_ss2d_proj(
            xx, w_dt.reshape(2, 2, d, d), w_b.reshape(2, 2, d, n),
            w_c.reshape(2, 2, d, n), A.reshape(2, 2, n, d),
            D=m.Ds.reshape(2, 2, d),
            delta_bias=m.dt_projs_bias.reshape(2, 2, d),
            delta_softplus=True)
    assert got.shape == (b, h, w, d)
    _close_scaled(got, want, "y")


def test_launch_wrappers_check_inputs_before_building():
    """The kernel wrappers raise on what K10 / K11 do not take before they
    build or launch anything: a d_state above 256, misshaped weights or
    parameters, CPU tensors."""
    args, _ = _inputs(1, 2, 3, 4, 257, seed=1, with_d=True, with_bias=True)
    t = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="at most 256"):
        scan_img.launch_scan_img_fwd(*t)
    args, _ = _inputs(1, 2, 3, 4, 4, seed=2, with_d=True, with_bias=True)
    t = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="w_dt"):
        scan_img.launch_scan_img_fwd(t[0], t[1][0], *t[2:])
    with pytest.raises(ValueError, match="delta_bias"):
        scan_img.launch_scan_img_fwd(*t[:6], t[6][0])
    with pytest.raises(ValueError, match="take CUDA tensors"):
        scan_img.launch_scan_img_fwd(*t)
    hck = torch.zeros(2, 2, 1, 1, 4, 4)
    with pytest.raises(ValueError, match="take CUDA tensors"):
        scan_img.launch_scan_img_bwd(*t, hck, t[0])


# ------------------------------------------------------------ state split
def _plain_slice(u, delta, A, B, C, D, delta_bias, softplus, reverse,
                 y_accum):
    y = scan_g.selective_scan_g_plain(u, delta, A, B, C, D, delta_bias,
                                      softplus, reverse)
    return y if y_accum is None else y + y_accum


@pytest.mark.parametrize("reverse", [False, True])
def test_state_split_matches_the_whole_state(reverse):
    """`split_state` driven by the plain scan at d_state 40 (slices of 16,
    16 and 8; the first takes D and y_accum) equals the plain scan at 40:
    y and the gradients of every input."""
    batch, G, L, dg, N = 2, 3, 37, 5, 40
    rng = np.random.default_rng(7 + reverse)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    inputs = dict(u=f(batch, G, L, dg), delta=f(batch, G, L, dg) * 0.5,
                  A=-torch.exp(f(G, N, dg)), B=f(batch, G, L, N),
                  C=f(batch, G, L, N), D=f(G, dg),
                  delta_bias=f(G, dg) * 0.1, y_accum=f(batch, G, L, dg))
    cot = f(batch, G, L, dg)

    def run(split):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in inputs.items()}
        args = list(leaves.values())
        if split:
            y = scan_g.split_state(_plain_slice, *args[:7], True, reverse,
                                   args[7])
        else:
            y = _plain_slice(*args[:7], True, reverse, args[7])
        (y * cot).sum().backward()
        return y.detach(), {k: v.grad for k, v in leaves.items()}

    got_y, got = run(True)
    want_y, want = run(False)
    _close_scaled(got_y, want_y, "y")
    for k in want:
        _close_scaled(got[k], want[k], "d" + k)


@pytest.mark.parametrize("G,dg,N,fused", [
    (2, 192, 16, True), (2, 192, 17, False), (1, 768, 40, False),
    (2, 1536, 4, False),
])
def test_wide_states_take_the_streamed_route(G, dg, N, fused):
    """K2 / K4 hold at most 16 states: a wider call takes the streamed
    route (torch.matmul projections, K1 / K3 on slices of 16)."""
    assert scan_g.uses_fused_projection(G, dg, N) is fused


def test_image_module_stays_jax_free():
    """The new module and the re-export import nothing of JAX, and the
    entry point runs on CPU tensors (the plain version) without it."""
    code = (
        "import sys, torch\n"
        "import sigma_tpu_torch.ops.scan_img\n"
        "from sigma_tpu_torch.ops.scan_g import selective_scan_ss2d_proj\n"
        "x = torch.randn(1, 3, 4, 8)\n"
        "w = lambda *s: torch.randn(*s) * 0.1\n"
        "y = selective_scan_ss2d_proj(x, w(2, 2, 8, 8), w(2, 2, 8, 4),\n"
        "    w(2, 2, 8, 4), -torch.rand(2, 2, 4, 8), delta_softplus=True)\n"
        "assert y.shape == x.shape and bool(torch.isfinite(y).all())\n"
        "roots = ('jax', 'jaxlib', 'flax', 'sigma_tpu', 'configs')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in roots)\n"
        "assert not bad, bad[:10]\n"
        "print('JAX_FREE')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_FREE" in proc.stdout
