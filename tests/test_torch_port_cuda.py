"""The Hopper scan kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and nvcc, and skip without them. They import
no JAX, so they run on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

`chip_smoke.py` checks the kernels at the main path's shapes; these tests
take the edges it does not reach: channel and token counts that do not
fill a tile or a checkpoint segment, every d_state width the kernels are
built for, chain pairs beside n_u = 1, the shared-memory tile halving of
the fused kernels (forward and backward), the routing of the entry points,
and the errors a wrapper raises. The backward kernels (K3-K5) are held to
autograd of the plain versions, every cotangent of each entry point.
Tolerances are chip_smoke's: fp32 rtol 6e-4 / atol 2e-3 and bf16 5e-2,
against max(|ref|, 1).
"""

import numpy as np
import pytest
import torch

from sigma_tpu_torch.ops import scan_g

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (6e-4, 2e-3), torch.bfloat16: (5e-2, 5e-2)}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine with "
                    "`python -m pytest --noconftest "
                    "tests/test_torch_port_cuda.py`")
    # fp32 means fp32: the plain versions' matmuls and convs must not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, want, dtype):
    rtol, atol = TOL[dtype]
    scale = max(want.float().abs().max().item(), 1.0)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float() / scale, want.float() / scale,
                               rtol=rtol, atol=atol)


def _arrays(seed, **shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _streamed(batch, G, L, dg, N, dtype, dev, seed):
    a = _arrays(seed, u=(batch, G, L, dg), dt=(batch, G, L, dg),
                A=(G, N, dg), B=(batch, G, L, N), C=(batch, G, L, N),
                D=(G, dg), bias=(G, dg), ya=(batch, G, L, dg))
    t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
    t["A"] = -torch.exp(t["A"])
    t["dt"] = t["dt"] * 0.5
    for k in ("u", "dt", "B", "C", "ya"):
        t[k] = t[k].to(dtype)
    return t


def _projected(G, dg, N, dtype, dev, seed):
    a = _arrays(seed, w_dt=(G, dg, dg), w_b=(G, dg, N), w_c=(G, dg, N),
                A=(G, N, dg), D=(G, dg), bias=(G, dg))
    t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
    t["w_dt"] = (t["w_dt"] * 0.3 / dg ** 0.5).to(dtype)
    t["w_b"] = (t["w_b"] / dg ** 0.5).to(dtype)
    t["w_c"] = (t["w_c"] / dg ** 0.5).to(dtype)
    t["A"] = -torch.exp(t["A"])
    return t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1, 5, 16])
@pytest.mark.parametrize("reverse", [False, True])
def test_streamed_kernel_matches_plain(dev, dtype, N, reverse):
    """K1 at 50 channels (a partial 64-channel block) and 77 tokens (a
    partial 64-token tile); the reversed call carries y_accum, as the
    main path's second direction group does."""
    t = _streamed(2, 3, 77, 50, N, dtype, dev, seed=N)
    ya = t["ya"] if reverse else None
    kw = dict(D=t["D"], delta_bias=t["bias"], delta_softplus=True,
              reverse=reverse)
    with torch.inference_mode():
        got = scan_g.launch_scan_fwd(t["u"], t["dt"], t["A"], t["B"],
                                     t["C"], y_accum=ya, **kw)
        want = scan_g.selective_scan_g_plain(
            t["u"].float(), t["dt"].float(), t["A"], t["B"].float(),
            t["C"].float(), **kw)
        if ya is not None:
            want = want + ya.float()
    assert got.dtype == dtype and got.shape == t["u"].shape
    _close(got, want.to(dtype), dtype)


PROJ_CASES = [
    # (n_u, G, batch, L, dg, N, swap)
    (1, 1, 2, 45, 40, 4, False),     # partial channel block and token tile
    (1, 4, 1, 33, 24, 16, True),     # two chain pairs in one operand
    (2, 2, 2, 100, 72, 8, True),     # two layout operands, C swapped
    (2, 2, 1, 20, 1100, 16, True),   # both u tiles only fit at 16 tokens
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n_u,G,batch,L,dg,N,swap", PROJ_CASES)
def test_fused_projection_kernel_matches_plain(dev, dtype, reverse, n_u, G,
                                               batch, L, dg, N, swap):
    p = _projected(G, dg, N, dtype, dev, seed=dg)
    a = _arrays(dg + 1, u=(batch, G, L, dg), ya=(batch, G, L, dg))
    u = torch.from_numpy(a["u"]).to(dev).to(dtype)
    ya = torch.from_numpy(a["ya"]).to(dev).to(dtype) if reverse else None
    kw = dict(D=p["D"], delta_bias=p["bias"], delta_softplus=True,
              reverse=reverse, swap_groups_c=swap)
    ws = (p["w_dt"], p["w_b"], p["w_c"], p["A"])
    with torch.inference_mode():
        if n_u == 2:
            got = torch.stack(scan_g.launch_scan_proj_fwd(
                (u[:, 0], u[:, 1]), *ws,
                y_accum=None if ya is None else (ya[:, 0], ya[:, 1]),
                **kw), 1)
        else:
            (got,) = scan_g.launch_scan_proj_fwd(
                (u,), *ws, y_accum=None if ya is None else (ya,), **kw)
        want = scan_g.selective_scan_g_proj_plain(u, *ws, y_accum=ya, **kw)
    assert got.dtype == dtype and got.shape == u.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dg,kernel", [(64, "scan_proj_fwd"),
                                       (1536, "scan_fwd")])
def test_entry_point_routes_and_counts(dev, dg, kernel):
    """selective_scan_g_proj_ml takes K2 under the 12 MiB weight budget and
    torch.matmul + K1 above it, counting one launch of that kernel."""
    p = _projected(2, dg, 4, torch.float32, dev, seed=3)
    a = _arrays(4, u0=(1, 24, dg), u1=(1, 24, dg))
    us = tuple(torch.from_numpy(v).to(dev) for v in a.values())
    args = (p["w_dt"], p["w_b"], p["w_c"], p["A"])
    kw = dict(D=p["D"], delta_bias=p["bias"], delta_softplus=True,
              swap_groups_c=True)
    scan_g.reset_launches()
    with torch.inference_mode():
        got = scan_g.selective_scan_g_proj_ml(us, *args, **kw)
    counts = dict(scan_g.LAUNCHES)
    assert counts == {k: int(k == kernel) for k in counts}
    want = scan_g.selective_scan_g_proj_ml_plain(us, *args, **kw)
    for g, w in zip(got, want):
        _close(g, w, torch.float32)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    t = _streamed(1, 1, 8, 16, 4, torch.float32, dev, seed=0)
    args = (t["u"], t["dt"], t["A"], t["B"], t["C"])
    u = t["u"].clone().bfloat16().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP C2"):
        scan_g.selective_scan_g(u, *args[1:])
    with pytest.raises(ValueError, match="scan inputs on"):
        scan_g.selective_scan_g(t["u"].cpu(), *args[1:])
    wide = _streamed(1, 1, 8, 16, 17, torch.float32, dev, seed=0)
    with pytest.raises(RuntimeError, match="d_state above 16"):
        scan_g.launch_scan_fwd(wide["u"], wide["dt"], wide["A"], wide["B"],
                               wide["C"])


def test_sigma_test_model_on_the_card_matches_the_cpu(dev):
    """A seeded sigma_test EncoderDecoder: the card (fused-projection
    kernel at every scan) against the CPU plain path, at 64x80."""
    import copy

    from sigma_tpu_torch.models.builder import EncoderDecoder, init_parameters

    cpu = init_parameters(EncoderDecoder(9, "sigma_test"), seed=5).eval()
    gpu = copy.deepcopy(cpu).to(dev)
    a = _arrays(6, rgb=(1, 64, 80, 3), x=(1, 64, 80, 3))
    rgb, x = (torch.from_numpy(v) for v in a.values())
    scan_g.reset_launches()
    with torch.inference_mode():
        got = gpu(rgb.to(dev), x.to(dev)).cpu()
        want = cpu(rgb, x)
    assert scan_g.LAUNCHES["scan_proj_fwd"] > 0
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    assert agree >= 0.995, agree
    _close(got, want, torch.float32)


# ------------------------------------------------------------ backward
def _grads(fn, inputs):
    """Outputs of fn(**inputs) and the gradients of a fixed random linear
    functional of them w.r.t. every input that requires one."""
    outs = fn(**inputs)
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    gen = torch.Generator(device=outs[0].device).manual_seed(11)
    loss = sum((o * torch.randn(o.shape, generator=gen, device=o.device))
               .sum() for o in outs)
    leaves = {k: v for k, v in inputs.items()
              if isinstance(v, torch.Tensor) and v.requires_grad}
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return outs, dict(zip(leaves, grads))


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


@pytest.mark.parametrize("N", [1, 4, 16])
@pytest.mark.parametrize("reverse", [False, True])
def test_streamed_backward_matches_autograd_of_plain(dev, N, reverse):
    """K1 + K3 through selective_scan_g: 50 channels (a partial 32-channel
    block), 77 tokens (a partial 32-token checkpoint segment), three
    chains; all seven cotangents against autograd of the plain version."""
    t = _streamed(2, 3, 77, 50, N, torch.float32, dev, seed=20 + N)
    inputs = dict(u=t["u"], delta=t["dt"], A=t["A"], B=t["B"], C=t["C"],
                  D=t["D"], delta_bias=t["bias"])
    inputs = {k: _leaf(v) for k, v in inputs.items()}
    kw = dict(delta_softplus=True, reverse=reverse)
    scan_g.reset_launches()
    got_y, got = _grads(lambda **a: scan_g.selective_scan_g(**a, **kw),
                        inputs)
    assert scan_g.LAUNCHES["scan_fwd"] == 1
    assert scan_g.LAUNCHES["scan_bwd"] == 1
    want_y, want = _grads(
        lambda **a: scan_g.selective_scan_g_plain(**a, **kw), inputs)
    _close(got_y[0], want_y[0], torch.float32)
    for k in want:
        _close(got[k], want[k], torch.float32)


BWD_PROJ_CASES = [
    # (n_u, G, batch, L, dg, N, swap)
    (1, 1, 2, 45, 40, 4, False),     # partial channel block and segment
    (1, 4, 1, 33, 24, 16, True),     # two chain pairs in one operand
    (2, 2, 2, 100, 72, 8, True),     # two layout operands, C swapped
    (2, 2, 1, 20, 768, 16, True),    # both u tiles fit only at 16 tokens
    (2, 2, 1, 70, 64, 1, False),     # d_state 1
]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n_u,G,batch,L,dg,N,swap", BWD_PROJ_CASES)
def test_fused_backward_matches_autograd_of_plain(dev, reverse, n_u, G,
                                                  batch, L, dg, N, swap):
    """K2 + K4 + K5 through the fused-projection entry points, y_accum
    on the reversed call: every cotangent (u per layout, W_dt, W_B, W_C,
    A, D, dt bias, y_accum) against autograd of the plain version."""
    p = _projected(G, dg, N, torch.float32, dev, seed=dg + N)
    a = _arrays(dg + 2, u=(batch, G, L, dg), ya=(batch, G, L, dg))
    u = torch.from_numpy(a["u"]).to(dev)
    ya = torch.from_numpy(a["ya"]).to(dev) if reverse else None
    inputs = dict(w_dt=p["w_dt"], w_b=p["w_b"], w_c=p["w_c"], A=p["A"],
                  D=p["D"], delta_bias=p["bias"])
    if n_u == 2:
        inputs.update(u0=u[:, 0], u1=u[:, 1])
        if ya is not None:
            inputs.update(ya0=ya[:, 0], ya1=ya[:, 1])
    else:
        inputs.update(u=u)
        if ya is not None:
            inputs.update(y_accum=ya)
    inputs = {k: _leaf(v) for k, v in inputs.items()}
    kw = dict(delta_softplus=True, reverse=reverse, swap_groups_c=swap)

    def kernel(**a):
        if n_u == 2:
            yas = (a.pop("ya0"), a.pop("ya1")) if "ya0" in a else None
            return scan_g.selective_scan_g_proj_ml(
                (a.pop("u0"), a.pop("u1")), **a, y_accum=yas, **kw)
        return scan_g.selective_scan_g_proj(**a, **kw)

    def plain(**a):
        if n_u == 2:
            yas = (a.pop("ya0"), a.pop("ya1")) if "ya0" in a else None
            return scan_g.selective_scan_g_proj_ml_plain(
                (a.pop("u0"), a.pop("u1")), **a, y_accum=yas, **kw)
        return scan_g.selective_scan_g_proj_plain(**a, **kw)

    scan_g.reset_launches()
    got_y, got = _grads(kernel, inputs)
    counts = dict(scan_g.LAUNCHES)
    assert counts == dict(scan_fwd=0, scan_proj_fwd=1, scan_bwd=0,
                          scan_proj_bwd=1, proj_grad=1), counts
    want_y, want = _grads(plain, inputs)
    for g_, w_ in zip(got_y, want_y):
        _close(g_, w_, torch.float32)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], torch.float32)


def test_proj_grad_matches_plain(dev):
    """K5 alone: weight gradients and the du chain term, two layouts, a
    token count that leaves partial 64-row tiles and split partials."""
    batch, L, dg, N = 2, 333, 72, 8
    a = _arrays(30, u=(batch, 2, L, dg), dd=(batch, 2, L, dg),
                dB=(batch, 2, L, N), dC=(batch, 2, L, N), du=(batch, 2, L, dg))
    t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
    p = _projected(2, dg, N, torch.float32, dev, seed=31)
    us = (t["u"][:, 0].contiguous(), t["u"][:, 1].contiguous())
    dus = [t["du"][:, 0].contiguous(), t["du"][:, 1].contiguous()]
    want_du, *want_w = scan_g.proj_grad_plain(
        us, t["dd"], t["dB"], t["dC"], p["w_dt"], p["w_b"], p["w_c"])
    start = [d.clone() for d in dus]
    got_w = scan_g.launch_proj_grad(us, dus, t["dd"], t["dB"], t["dC"],
                                    p["w_dt"], p["w_b"], p["w_c"])
    for g_, s_, w_ in zip(dus, start, want_du):
        _close(g_ - s_, w_, torch.float32)
    for g_, w_ in zip(got_w, want_w):
        _close(g_, w_, torch.float32)


def test_eval_forward_writes_no_checkpoints(dev):
    """Without a gradient the forward kernels take no hck buffer: the
    launch allocates only y."""
    p = _projected(2, 64, 4, torch.float32, dev, seed=5)
    a = _arrays(6, u0=(1, 96, 64), u1=(1, 96, 64))
    us = tuple(torch.from_numpy(v).to(dev) for v in a.values())
    args = (p["w_dt"], p["w_b"], p["w_c"], p["A"])
    torch.cuda.synchronize()
    with torch.inference_mode():
        before = torch.cuda.memory_allocated(dev)
        ys = scan_g.selective_scan_g_proj_ml(us, *args, D=p["D"],
                                             delta_bias=p["bias"])
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated(dev) - before
    assert grown <= sum(y.numel() * 4 for y in ys) + 2048, grown


def test_sigma_test_train_step_on_the_card_matches_the_cpu(dev):
    """Two train steps of a seeded sigma_test (every drop path 0, remat
    on) at 64x80 on the card and on the CPU from the same weights and
    uint8 batch: losses and post-step parameters agree. SGD with momentum keeps
    the update linear in the gradient (Adam's g / sqrt(v) would turn
    rounding noise in a near-zero gradient into a full lr-sized step)."""
    import copy

    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.engine.optim import build_optimizer
    from sigma_tpu_torch.engine.train import (
        create_train_state,
        make_train_step,
    )
    from sigma_tpu_torch.models.builder import EncoderDecoder, init_parameters
    from sigma_tpu_torch.models.common import DropPath
    from sigma_tpu_torch.utils.lr_schedule import warmup_poly_lr

    cfg = get_config("mfnet", optimizer="SGDM")
    cpu = init_parameters(EncoderDecoder(9, "sigma_test"), seed=8)
    for m in cpu.modules():  # the CPU and CUDA generators draw differently
        if isinstance(m, DropPath):
            m.rate = 0.0
    gpu = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(9)
    batch = dict(
        data=rng.integers(0, 256, (2, 64, 80, 3), dtype=np.uint8),
        modal_x=rng.integers(0, 256, (2, 64, 80, 3), dtype=np.uint8),
        label=rng.integers(0, 9, (2, 64, 80)).astype(np.uint8),
        margins=np.array([[4, 3, 0, 5], [0, 0, 2, 2]], np.int32))
    sched = warmup_poly_lr(1e-2, 0.9, 100, 1)
    losses = {}
    for name, m in (("cpu", cpu), ("gpu", gpu)):
        opt = build_optimizer(cfg, m)
        state = create_train_state(m, opt)
        step = make_train_step(m, opt, sched)
        losses[name] = [float(step(state, batch)) for _ in range(2)]
    np.testing.assert_allclose(losses["gpu"], losses["cpu"], rtol=1e-4)
    for (k, a), b in zip(cpu.state_dict().items(),
                         gpu.state_dict().values()):
        diff = (b.cpu() - a).abs().max().item()
        assert diff < 1e-5, (k, diff)
