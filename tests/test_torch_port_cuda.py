"""The Hopper kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and nvcc, and skip without them. They import
no JAX, so they run on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

`chip_smoke.py` checks the kernels at the main path's shapes; these tests
take the edges it does not reach: channel and token counts that do not
fill a tile, a chunk or a checkpoint segment, sequences below one chunk,
ragged and over several chunks in both directions, every d_state width the
kernels are built for, chain pairs beside n_u = 1, wide channel counts,
the routing of the entry points, and the errors a wrapper raises. The
checkpoints of K1, K2 and K10 are held to a plain token-by-token walk
(`scan_g.scan_checkpoints_plain`), and K1, K2, K3, K4, K5 and K10 rerun
bit for bit. The backward kernels (K3-K5) are held to autograd of the
plain versions, every cotangent of each entry point, in fp32 and with bf16
io (one token, ragged chunks, both directions, the C swap, n_u 1 and 2;
the kernels launched on bf16 operands, K3-K5 rerun bit for bit), and bf16
with a gradient returns bf16 gradients at every scan entry point. The
fused SS2D epilogue (K6, K7) is held to its plain versions at row widths
that take the vector and the scalar layout, at a strided z, with its
dgamma / dbeta rerun bit for bit. The ops-level entry points take the
channel-first kernels (K8, K9) at one token, ragged chunks and channel
blocks, odd dg, d_state 1-40 and above their bound, with K8 (y and its
32-token checkpoints, against the plain walk) and K9 rerun bit for bit, and
the per-row route onto K1 + K3. K1-K4, K10 and K11 give their recorded
bits (`chip_smoke.body_bits`). The grouped and per-row entry
points take d_state 17 and 40 as slices of 16 on K1 + K3. The image-layout
SS2D scan (K10, K11 + K5) is held to its plain version at a one-pixel
image, odd and small images, dg not a multiple of 32, d_state 1-256 and
above its bound, in bf16 (K11 too: bf16 io with every gradient, on bf16
operands), with its counts and K11 reruns bit for bit (one state tile and
three). The MiT and Swin segmentation models and the VSSM
classifier take one step on the card against the CPU at the CPU tests'
widths.
Tolerances are chip_smoke's: fp32 rtol 6e-4 / atol 2e-3 and bf16 5e-2,
against max(|ref|, 1).
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sigma_tpu_torch.ops import merge_ln_gate as mlg
from sigma_tpu_torch.ops import scan_cf, scan_g, scan_img
from sigma_tpu_torch.ops.selective_scan import (
    selective_scan,
    selective_scan_chunked,
    selective_scan_cl,
    selective_scan_cl_plain,
)

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
    """K1 at 50 channels (a partial 32-channel tile) and 77 tokens (one
    ragged chunk); the reversed call carries y_accum, as the main path's
    second direction group does."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L", [1, 77, 128, 129, 300, 1000])
def test_streamed_kernel_over_chunks(dev, dtype, reverse, L):
    """K1 (chunk-parallel) below one chunk, on one, one past it, ragged and
    over several, both directions, with y_accum, at 40 channels (a partial
    channel tile), against the plain scan."""
    t = _streamed(2, 2, L, 40, 16, dtype, dev, seed=L)
    kw = dict(D=t["D"], delta_bias=t["bias"], delta_softplus=True,
              reverse=reverse)
    with torch.inference_mode():
        got = scan_g.launch_scan_fwd(t["u"], t["dt"], t["A"], t["B"],
                                     t["C"], y_accum=t["ya"], **kw)
        want = scan_g.selective_scan_g_plain(
            t["u"].float(), t["dt"].float(), t["A"], t["B"].float(),
            t["C"].float(), **kw) + t["ya"].float()
    assert got.dtype == dtype and got.shape == t["u"].shape
    _close(got, want.to(dtype), dtype)


@pytest.mark.parametrize("L", [77, 300, 1000])
@pytest.mark.parametrize("reverse", [False, True])
def test_streamed_checkpoints_and_reruns(dev, L, reverse):
    """K1 with checkpoints: its hck equals the plain walk's states; a rerun
    gives the same bits (y and hck); y without checkpoints (eval) has the
    same bits as y with them."""
    t = _streamed(2, 3, L, 40, 16, torch.float32, dev, seed=L + 5)
    args = (t["u"], t["dt"], t["A"], t["B"], t["C"])
    kw = dict(D=t["D"], delta_bias=t["bias"], delta_softplus=True,
              reverse=reverse, y_accum=t["ya"])
    with torch.inference_mode():
        y1, h1 = scan_g.launch_scan_fwd(*args, with_hck=True, **kw)
        y2, h2 = scan_g.launch_scan_fwd(*args, with_hck=True, **kw)
        y0 = scan_g.launch_scan_fwd(*args, **kw)
        want = scan_g.scan_checkpoints_plain(
            t["u"], t["dt"], t["A"], t["B"], t["bias"], True, reverse)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    assert torch.equal(y0, y1)
    _close(h1, want, torch.float32)


PROJ_CASES = [
    # (n_u, G, batch, L, dg, N, swap)
    (1, 1, 2, 45, 40, 4, False),     # partial channel tile, one short chunk
    (1, 4, 1, 33, 24, 16, True),     # two chain pairs in one operand
    (2, 2, 2, 100, 72, 8, True),     # two layout operands, C swapped
    (2, 2, 1, 20, 1100, 16, True),   # wide dg: 35 projection k-tiles
    (1, 2, 1, 129, 45, 5, True),     # a chunk and one token; odd dg and N
    (2, 2, 1, 300, 64, 16, False),   # three chunks, the last ragged
    (1, 1, 1, 1, 8, 4, False),       # one token
    (2, 2, 1, 2200, 24, 16, False),  # K2's carries over two groups
    (1, 2, 1, 4200, 40, 4, True),    # three groups, the last partial
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
    hck = torch.zeros((1, 1, 1, 4, 16), device=dev)
    with pytest.raises(TypeError, match="one io dtype"):
        scan_g.launch_scan_bwd(t["u"].bfloat16(), *args[1:], None, None, hck,
                               t["u"])
    with pytest.raises(ValueError, match="scan inputs on"):
        scan_g.selective_scan_g(t["u"].cpu(), *args[1:])
    wide = _streamed(1, 1, 8, 16, 17, torch.float32, dev, seed=0)
    with pytest.raises(RuntimeError, match="d_state above 16"):
        scan_g.launch_scan_fwd(wide["u"], wide["dt"], wide["A"], wide["B"],
                               wide["C"])
    # the entry point takes d_state 17 as slices of 16 and 1 on K1
    args = (wide["u"], wide["dt"], wide["A"], wide["B"], wide["C"])
    scan_g.reset_launches()
    with torch.inference_mode():
        got = scan_g.selective_scan_g(*args, delta_softplus=True)
    assert scan_g.LAUNCHES["scan_fwd"] == 2
    _close(got, scan_g.selective_scan_g_plain(*args, delta_softplus=True),
           torch.float32)


@pytest.mark.parametrize("fused", [False, True])
def test_sigma_test_model_on_the_card_matches_the_cpu(dev, fused):
    """A seeded sigma_test EncoderDecoder: the card (fused-projection
    kernel at every scan, K6 at every SS2D with the fused epilogue)
    against the CPU plain path, at 64x80."""
    import copy

    from sigma_tpu_torch.models.builder import EncoderDecoder, init_parameters
    from sigma_tpu_torch.models.ss2d import set_fused_epilogue

    cpu = init_parameters(EncoderDecoder(9, "sigma_test"), seed=5).eval()
    set_fused_epilogue(cpu, fused)
    gpu = copy.deepcopy(cpu).to(dev)
    a = _arrays(6, rgb=(1, 64, 80, 3), x=(1, 64, 80, 3))
    rgb, x = (torch.from_numpy(v) for v in a.values())
    scan_g.reset_launches()
    mlg.reset_launches()
    with torch.inference_mode():
        got = gpu(rgb.to(dev), x.to(dev)).cpu()
        want = cpu(rgb, x)
    assert scan_g.LAUNCHES["scan_proj_fwd"] > 0
    # sigma_test: 5 trunk SS2Ds and 12 in the decoder
    assert mlg.LAUNCHES == dict(merge_ln_gate_fwd=17 if fused else 0,
                                merge_ln_gate_bwd=0)
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


@pytest.mark.parametrize("L", [77, 300, 1000])
@pytest.mark.parametrize("N", [1, 4, 16])
@pytest.mark.parametrize("reverse", [False, True])
def test_streamed_backward_matches_autograd_of_plain(dev, N, reverse, L):
    """K1 + K3 through selective_scan_g: 50 channels (a partial 32-channel
    block), 77 tokens (below one 128-token chunk, a partial 32-token
    checkpoint segment), 300 (two chunks and a ragged third) or 1000 (eight
    chunks, the last ragged), three chains; all seven cotangents against
    autograd of the plain version."""
    t = _streamed(2, 3, L, 50, N, torch.float32, dev, seed=20 + N + L)
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
    (2, 2, 1, 20, 768, 16, True),    # 24 channel blocks
    (2, 2, 1, 70, 64, 1, False),     # d_state 1
    (2, 2, 1, 300, 72, 16, True),    # two chunks and a ragged third
    (1, 2, 2, 1000, 40, 4, True),    # eight chunks, one operand, swapped
    (1, 1, 1, 256, 32, 8, False),    # ends on a chunk
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


def _bwd_inputs(n_u, G, batch, L, dg, N, swap, dev, seed,
                dtype=torch.float32):
    """The inputs of one K3 call (streamed) and of one K4 call after their
    forward kernels' checkpoints, reversed, u, dy and the weights in
    `dtype`."""
    p = _projected(G, dg, N, dtype, dev, seed=seed)
    a = _arrays(seed + 1, u=(batch, G, L, dg), dy=(batch, G, L, dg))
    u, dy = (torch.from_numpy(a[k]).to(dev).to(dtype) for k in ("u", "dy"))
    ws = (p["w_dt"], p["w_b"], p["w_c"])
    kw = dict(D=p["D"], delta_bias=p["bias"], delta_softplus=True,
              reverse=True)
    with torch.inference_mode():
        dts, bs, cs = (u @ w for w in ws)
        if swap:
            cs = scan_g._pair_swap(cs)
        _, hck1 = scan_g.launch_scan_fwd(u, dts, p["A"], bs, cs,
                                         with_hck=True, **kw)
        if n_u == 2:
            us, dys = (u[:, 0].contiguous(), u[:, 1].contiguous()), (
                dy[:, 0].contiguous(), dy[:, 1].contiguous())
        else:
            us, dys = (u,), (dy,)
        _, hck2 = scan_g.launch_scan_proj_fwd(us, *ws, p["A"],
                                              swap_groups_c=swap,
                                              with_hck=True, **kw)

    def k3():
        return scan_g.launch_scan_bwd(u, dts, p["A"], bs, cs, p["D"],
                                      p["bias"], hck1, dy, True, True)

    def k4():
        dus, *rest = scan_g.launch_scan_proj_bwd(
            us, *ws, p["A"], p["D"], p["bias"], hck2, dys, True, True, swap)
        return (*dus, *rest)

    def k5():  # on a fresh K4's cotangents; returns (dW..., du...)
        out = k4()
        dus, (dd, dB, dC) = list(out[:n_u]), out[n_u:n_u + 3]
        return (*scan_g.launch_proj_grad(us, dus, dd, dB, dC, *ws), *dus)

    return k3, k4, k5


@pytest.mark.parametrize("n_u,G,batch,L,dg,N,swap", [
    (1, 2, 2, 1000, 72, 16, True),
    (2, 2, 1, 300, 40, 4, False),
])
def test_scan_backward_reruns_bit_for_bit(dev, n_u, G, batch, L, dg, N,
                                          swap):
    """K3 and K4 sum every partial (chunks, channel blocks, batch) in a
    fixed order and use no atomics: two runs on the same inputs give the
    same bits for all seven outputs."""
    k3, k4, _ = _bwd_inputs(n_u, G, batch, L, dg, N, swap, dev,
                            seed=L + dg)
    for run in (k3, k4):
        with torch.inference_mode():
            first, again = run(), run()
        assert len(first) == len(again) >= 7
        for a_, b_ in zip(first, again):
            assert torch.equal(a_, b_)


BF16_BWD_CASES = [
    # (route, n_u, G, batch, L, dg, N, swap)
    ("streamed", 1, 3, 2, 1, 50, 4, False),    # one token
    ("streamed", 1, 2, 2, 300, 50, 16, True),  # ragged chunks, C swapped
    ("fused", 1, 1, 2, 1, 40, 4, False),       # one token, one operand
    ("fused", 1, 2, 2, 300, 40, 16, True),     # ragged chunks, swapped
    ("fused", 2, 2, 1, 300, 72, 16, True),     # two layout operands
    ("fused", 2, 2, 2, 77, 64, 8, False),      # below one chunk
]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("route,n_u,G,batch,L,dg,N,swap", BF16_BWD_CASES)
def test_bf16_backward_kernels_match_plain(dev, reverse, route, n_u, G,
                                           batch, L, dg, N, swap):
    """bf16 io with a gradient through the grouped entry points: K1 + K3
    (streamed, dt / B / C projected outside in bf16) or K2 + K4 + K5 run on
    the bf16 operands (every launch counted as bf16), and every cotangent
    comes back in its input's dtype within 5e-2 of autograd of the plain
    version on the same values in fp32; y_accum on the reversed call."""
    p = _projected(G, dg, N, torch.bfloat16, dev, seed=dg + N + 7)
    a = _arrays(dg + 9, u=(batch, G, L, dg), ya=(batch, G, L, dg))
    u, ya = (torch.from_numpy(a[k]).to(dev).bfloat16() for k in ("u", "ya"))
    inputs = dict(u=u, w_dt=p["w_dt"], w_b=p["w_b"], w_c=p["w_c"],
                  A=p["A"], D=p["D"], delta_bias=p["bias"])
    if reverse:
        inputs["y_accum"] = ya
    kw = dict(delta_softplus=True, reverse=reverse)

    def run(plain, **t):
        ya_ = t.pop("y_accum", None)
        u_, ws = t.pop("u"), (t.pop("w_dt"), t.pop("w_b"), t.pop("w_c"))
        if route == "streamed":
            dts, bs, cs = (u_ @ w for w in ws)
            if swap:
                cs = scan_g._pair_swap(cs)
            fn = scan_g.selective_scan_g_plain if plain \
                else scan_g.selective_scan_g
            y = fn(u_, dts, t.pop("A"), bs, cs, **t, **kw)
            return y if ya_ is None else y + ya_
        if n_u == 2 and not plain:
            yas = None if ya_ is None else (ya_[:, 0], ya_[:, 1])
            return torch.stack(scan_g.selective_scan_g_proj_ml(
                (u_[:, 0], u_[:, 1]), *ws, t.pop("A"), **t, y_accum=yas,
                swap_groups_c=swap, **kw), 1)
        fn = scan_g.selective_scan_g_proj_plain if plain \
            else scan_g.selective_scan_g_proj
        return fn(u_, *ws, t.pop("A"), **t, y_accum=ya_,
                  swap_groups_c=swap, **kw)

    scan_g.reset_launches()
    got_y, got = _grads(lambda **t: run(False, **t),
                        {k: _leaf(v) for k, v in inputs.items()})
    ran = (("scan_fwd", "scan_bwd") if route == "streamed" else
           ("scan_proj_fwd", "scan_proj_bwd", "proj_grad"))
    want_counts = {k: int(k in ran) for k in scan_g.LAUNCHES}
    assert scan_g.LAUNCHES == want_counts, scan_g.LAUNCHES
    assert scan_g.LAUNCHES_BF16 == want_counts, scan_g.LAUNCHES_BF16
    want_y, want = _grads(lambda **t: run(True, **t),
                          {k: _leaf(v.float()) for k, v in inputs.items()})
    assert got_y[0].dtype == torch.bfloat16
    _close(got_y[0], want_y[0], torch.bfloat16)
    for k in want:
        assert got[k].dtype == inputs[k].dtype, (k, got[k].dtype)
        _close(got[k], want[k], torch.bfloat16)


@pytest.mark.parametrize("n_u,G,batch,L,dg,N,swap", [
    (1, 2, 2, 1000, 72, 16, True),
    (2, 2, 1, 300, 40, 4, False),
])
def test_bf16_backward_reruns_bit_for_bit(dev, n_u, G, batch, L, dg, N,
                                          swap):
    """K3, K4 and K5 on bf16 operands: two runs on the same inputs give
    the same bits (K3 / K4: all seven outputs, bf16 where final; K5: dW
    and du)."""
    runs = _bwd_inputs(n_u, G, batch, L, dg, N, swap, dev, seed=L + dg + 1,
                       dtype=torch.bfloat16)
    scan_g.reset_launches()
    for run in runs:
        with torch.inference_mode():
            first, again = run(), run()
        assert len(first) == len(again) >= 3
        for a_, b_ in zip(first, again):
            assert torch.equal(a_, b_)
    assert scan_g.LAUNCHES_BF16 == scan_g.LAUNCHES
    assert scan_g.LAUNCHES["proj_grad"] == 2


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


@pytest.mark.parametrize("L", [77, 300, 1000, 4200])
def test_fused_projection_checkpoints_and_reruns(dev, L):
    """K2 (one pass, the carries in groups of 16 chunks: L 4200 spans
    three) with checkpoints, reversed with y_accum and the C swap: its hck
    equals the states of the plain walk over the same projections; a rerun
    gives the same bits; y without checkpoints (eval) has the same bits as
    y with them."""
    G, dg, N = 2, 40, 16
    p = _projected(G, dg, N, torch.float32, dev, seed=L)
    a = _arrays(L + 1, u=(2, G, L, dg), ya=(2, G, L, dg))
    u, ya = (torch.from_numpy(a[k]).to(dev) for k in ("u", "ya"))
    ws = (p["w_dt"], p["w_b"], p["w_c"], p["A"])
    kw = dict(D=p["D"], delta_bias=p["bias"], delta_softplus=True,
              reverse=True, swap_groups_c=True, y_accum=(ya,))
    with torch.inference_mode():
        (y1,), h1 = scan_g.launch_scan_proj_fwd((u,), *ws, with_hck=True,
                                                **kw)
        (y2,), h2 = scan_g.launch_scan_proj_fwd((u,), *ws, with_hck=True,
                                                **kw)
        (y0,) = scan_g.launch_scan_proj_fwd((u,), *ws, **kw)
        dts, bs = (u @ w for w in ws[:2])
        want = scan_g.scan_checkpoints_plain(u, dts, p["A"], bs, p["bias"],
                                             True, True)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    assert torch.equal(y0, y1)
    _close(h1, want, torch.float32)


def test_proj_grad_reruns_bit_for_bit(dev):
    """K5's weight gradient is split over tokens into partials summed in a
    fixed order: two runs from the same du give the same bits."""
    batch, L, dg, N = 2, 2000, 96, 16
    a = _arrays(40, u=(batch, 1, L, dg), dd=(batch, 1, L, dg),
                dB=(batch, 1, L, N), dC=(batch, 1, L, N), du=(batch, 1, L, dg))
    t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
    p = _projected(1, dg, N, torch.float32, dev, seed=41)
    runs = []
    for _ in range(2):
        du = t["du"].clone()
        runs.append((du, *scan_g.launch_proj_grad(
            (t["u"],), (du,), t["dd"], t["dB"], t["dC"], p["w_dt"],
            p["w_b"], p["w_c"])))
    for a_, b_ in zip(*runs):
        assert torch.equal(a_, b_)


def _bf16_entry(name, dev):
    """(fn(u, weights) -> y, u, the projection weights) of one scan entry
    point at a small shape, fp32; fn takes u and the weights in one
    dtype."""
    if name == "selective_scan_ss2d_proj":
        t = _image(2, 6, 9, 48, 16, dev, seed=140)
        rest = dict(A=t["A"], D=t["D"], delta_bias=t["delta_bias"],
                    delta_softplus=True)
        return (lambda u, ws: scan_g.selective_scan_ss2d_proj(u, *ws, **rest),
                t["x"], [t["w_dt"], t["w_b"], t["w_c"]])
    p = _projected(2, 48, 16, torch.float32, dev, seed=141)
    u = torch.from_numpy(_arrays(142, u=(2, 2, 70, 48))["u"]).to(dev)
    ws = [p["w_dt"], p["w_b"], p["w_c"]]
    kw = dict(D=p["D"], delta_bias=p["bias"], delta_softplus=True,
              reverse=True)
    if name == "selective_scan_g":
        return (lambda u, ws: scan_g.selective_scan_g(
            u, u @ ws[0], p["A"], u @ ws[1], u @ ws[2], **kw), u, ws)
    if name == "selective_scan_g_proj":
        return (lambda u, ws: scan_g.selective_scan_g_proj(
            u, *ws, p["A"], swap_groups_c=True, **kw), u, ws)
    return (lambda u, ws: torch.stack(scan_g.selective_scan_g_proj_ml(
        (u[:, 0], u[:, 1]), *ws, p["A"], **kw), 1), u, ws)


@pytest.mark.parametrize("name", ["selective_scan_g", "selective_scan_g_proj",
                                  "selective_scan_g_proj_ml",
                                  "selective_scan_ss2d_proj"])
def test_bf16_grads_at_the_entry_points(dev, name):
    """bf16 u and weights with a gradient (ROADMAP B1), as JAX's
    test_bf16_io: every entry point runs its kernels on the bf16 operands
    (the image scan: K10, K11 and both K5); y and every gradient come back
    bf16, within 5e-2 of autograd of the same function on the same values
    in fp32 (the entry point's kernels, held to the plain versions by the
    tests above)."""
    fn, u, ws = _bf16_entry(name, dev)
    dy = torch.randn(u.shape, device=dev)
    grads = {}
    for dtype in (torch.bfloat16, torch.float32):
        leaves = [t.bfloat16().to(dtype).requires_grad_(True)
                  for t in (u, *ws)]
        scan_g.reset_launches()
        scan_img.reset_launches()
        y = fn(leaves[0], leaves[1:])
        assert y.dtype == dtype
        grads[dtype] = torch.autograd.grad(y.float(), leaves, dy)
        counts = {**scan_g.LAUNCHES, **scan_img.LAUNCHES}
        bf16 = {**scan_g.LAUNCHES_BF16, **scan_img.LAUNCHES_BF16}
        assert sum(counts.values()) > 0
        if dtype == torch.float32:
            assert sum(bf16.values()) == 0, bf16
        else:
            assert bf16 == counts, bf16
    for got, want in zip(grads[torch.bfloat16], grads[torch.float32]):
        assert got.dtype == torch.bfloat16
        _close(got, want, torch.bfloat16)


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


@pytest.mark.parametrize("fused", [False, True])
def test_sigma_test_train_step_on_the_card_matches_the_cpu(dev, fused):
    """Two train steps of a seeded sigma_test (every drop path 0, remat
    on) at 64x80 on the card and on the CPU from the same weights and
    uint8 batch, the SS2D epilogue unfused or fused (K6 + K7 on the card):
    losses and post-step parameters agree. SGD with momentum keeps
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
    from sigma_tpu_torch.models.ss2d import set_fused_epilogue
    from sigma_tpu_torch.utils.lr_schedule import warmup_poly_lr

    cfg = get_config("mfnet", optimizer="SGDM")
    cpu = init_parameters(EncoderDecoder(9, "sigma_test"), seed=8)
    set_fused_epilogue(cpu, fused)
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
    mlg.reset_launches()
    for name, m in (("cpu", cpu), ("gpu", gpu)):
        opt = build_optimizer(cfg, m)
        state = create_train_state(m, opt)
        step = make_train_step(m, opt, sched)
        losses[name] = [float(step(state, batch)) for _ in range(2)]
    # 17 SS2Ds, each forward twice under remat, backward once, per step
    assert mlg.LAUNCHES == (dict(merge_ln_gate_fwd=68, merge_ln_gate_bwd=34)
                            if fused else dict(merge_ln_gate_fwd=0,
                                               merge_ln_gate_bwd=0))
    np.testing.assert_allclose(losses["gpu"], losses["cpu"], rtol=1e-4)
    for (k, a), b in zip(cpu.state_dict().items(),
                         gpu.state_dict().values()):
        diff = (b.cpu() - a).abs().max().item()
        assert diff < 1e-5, (k, diff)


# the test Swin variant of tests/test_torch_port_backbones.py (widths
# 16-128), registered inside the test
SWIN_CHECK = dict(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8),
                  window_size=4)


@pytest.mark.parametrize("backbone,decoder", [
    ("swin_check", "MambaDecoder"), ("mit_b0", "MLPDecoder"),
    ("classifier", None)])
def test_new_backbones_step_on_the_card_matches_the_cpu(dev, backbone,
                                                        decoder,
                                                        monkeypatch):
    """One lr-0 train step at the CPU tests' widths (Swin + MambaDecoder,
    mit_b0 + MLPDecoder at width 32, batch 6 at 64x80; the classifier at
    depths 1, batch 2 at 32x32: a forward and a backward) on the card
    against the CPU from the same weights and batch, dropout and drop
    path 0: the loss, every gradient and running statistic."""
    import copy

    import torch.nn.functional as F

    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.engine.optim import build_optimizer
    from sigma_tpu_torch.engine.train import (
        create_train_state,
        make_train_step,
    )
    from sigma_tpu_torch.models.builder import EncoderDecoder, init_parameters
    from sigma_tpu_torch.models.common import DropPath, Dropout
    from sigma_tpu_torch.models.swin_encoder import SWIN_VARIANTS
    from sigma_tpu_torch.models.vssm import VSSMClassifier

    monkeypatch.setitem(SWIN_VARIANTS, "swin_check", SWIN_CHECK)
    if decoder is None:
        cpu = VSSMClassifier(10, depths=(1, 1, 1, 1), dims=(16, 32, 64, 128),
                             d_state=8)
    else:
        cpu = EncoderDecoder(9, backbone, decoder, decoder_embed_dim=32)
    cpu = init_parameters(cpu, seed=12)
    for m in cpu.modules():  # the CPU and CUDA generators draw differently
        if isinstance(m, (DropPath, Dropout)):
            m.rate = 0.0
    gpu = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(13)
    batch = dict(
        data=rng.integers(0, 256, (6, 64, 80, 3), dtype=np.uint8),
        modal_x=rng.integers(0, 256, (6, 64, 80, 3), dtype=np.uint8),
        label=rng.integers(0, 9, (6, 64, 80)).astype(np.uint8),
        margins=np.zeros((6, 4), np.int32))
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    losses = {}
    for name, m in (("cpu", cpu), ("gpu", gpu)):
        if decoder is None:
            m.train()
            where = next(m.parameters()).device
            loss = F.cross_entropy(m(x.to(where)),
                                   torch.tensor([1, 7], device=where))
            loss.backward()
        else:
            opt = build_optimizer(get_config("mfnet"), m)
            loss = make_train_step(m, opt, lambda k: 0.0)(
                create_train_state(m, opt), batch)
        losses[name] = loss.detach().cpu()
    _close(losses["gpu"], losses["cpu"], torch.float32)
    grads = dict(gpu.named_parameters())
    for k, p in cpu.named_parameters():
        _close(grads[k].grad.cpu(), p.grad, torch.float32)
    bufs = dict(gpu.named_buffers())
    for k, b in cpu.named_buffers():
        _close(bufs[k].cpu(), b, torch.float32)


# ------------------------------------------------------------ epilogue
def _epilogue(b, h, w, c, dtype, dev, seed):
    """Inputs of merge_ln_gate, and a cotangent of its output."""
    a = _arrays(seed, y_hw=(b, h, w, c), y_wh=(b, w, h, c), z=(b, h, w, c),
                gamma=(c,), beta=(c,), dout=(b, h, w, c))
    t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
    t["gamma"] = 1.0 + 0.1 * t["gamma"]
    t["beta"] = 0.1 * t["beta"]
    for k in ("y_hw", "y_wh", "z"):
        t[k] = t[k].to(dtype)
    return [t[k] for k in ("y_hw", "y_wh", "z", "gamma", "beta")], t["dout"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", [(15, 20), (8, 128)])
@pytest.mark.parametrize("c", [64, 96, 192, 1536])
def test_epilogue_kernels_match_plain(dev, dtype, h, w, c):
    """K6 and K7 launched alone against the plain forward and the plain
    backward formula: out, dy_hw, dy_wh, dz, dgamma, dbeta."""
    args, dout = _epilogue(2, h, w, c, dtype, dev, seed=c + h)
    mlg.reset_launches()
    out = mlg.launch_merge_ln_gate_fwd(*args, 1e-5)
    got = mlg.launch_merge_ln_gate_bwd(*args, 1e-5, dout)
    assert mlg.LAUNCHES == dict(merge_ln_gate_fwd=1, merge_ln_gate_bwd=1)
    assert out.dtype == torch.float32
    _close(out, mlg.merge_ln_gate_plain(*args, 1e-5), dtype)
    want = mlg.merge_ln_gate_bwd_plain(*args, 1e-5, dout)
    for g_, w_, x in zip(got, want, args[:3] + [None, None]):
        if x is not None:
            assert g_.dtype == x.dtype and g_.shape == x.shape
        _close(g_, w_, dtype)


@pytest.mark.parametrize("c", [50, 96])
def test_epilogue_entry_point_grads_and_counts(dev, c):
    """merge_ln_gate through autograd on CUDA tensors, z a column slice:
    one K6 and one K7 launch, all five gradients against autograd of the
    plain forward. C = 50 takes the scalar layout, 96 the vector one."""
    args, dout = _epilogue(2, 9, 13, c, torch.float32, dev, seed=c)
    leaves = [_leaf(x) for x in args]
    # z as SS2D splits it out of in_proj's output: rows at stride 2C
    leaves[2] = _leaf(torch.cat([args[2], args[2]], -1))[..., c:]
    assert leaves[2].stride(2) == 2 * c
    mlg.reset_launches()
    out = mlg.merge_ln_gate(*leaves, 1e-5)
    got = torch.autograd.grad(out, leaves, dout)
    assert mlg.LAUNCHES == dict(merge_ln_gate_fwd=1, merge_ln_gate_bwd=1)
    want_out = mlg.merge_ln_gate_plain(*leaves, 1e-5)
    want = torch.autograd.grad(want_out, leaves, dout)
    _close(out, want_out, torch.float32)
    for g_, w_ in zip(got, want):
        _close(g_, w_, torch.float32)


def test_epilogue_backward_reruns_bit_for_bit(dev):
    """dgamma / dbeta are per-block partials summed in a fixed order: a
    rerun gives the same bits (rows enough for many blocks per SM)."""
    args, dout = _epilogue(4, 60, 80, 384, torch.float32, dev, seed=3)
    first = mlg.launch_merge_ln_gate_bwd(*args, 1e-5, dout)
    again = mlg.launch_merge_ln_gate_bwd(*args, 1e-5, dout)
    for a_, b_ in zip(first, again):
        assert torch.equal(a_, b_)


def test_epilogue_wrappers_raise(dev):
    args, dout = _epilogue(1, 4, 6, 32, torch.float32, dev, seed=4)
    y_hw, y_wh, z, g, b = args
    with pytest.raises(ValueError, match="y_wh: shape"):
        mlg.merge_ln_gate(y_hw, y_hw, z, g, b)
    with pytest.raises(ValueError, match="y_wh: shape"):
        mlg.launch_merge_ln_gate_fwd(y_hw, y_hw, z, g, b, 1e-5)
    with pytest.raises(ValueError, match="dout: shape"):
        mlg.launch_merge_ln_gate_bwd(*args, 1e-5, dout[:, :2])
    with pytest.raises(ValueError, match="inputs on"):
        mlg.merge_ln_gate(y_hw.cpu(), y_wh, z, g, b)
    with pytest.raises(ValueError, match="inputs on"):
        mlg.launch_merge_ln_gate_bwd(*args, 1e-5, dout.cpu())
    with pytest.raises(ValueError, match="CUDA tensors"):
        mlg.launch_merge_ln_gate_fwd(*[x.cpu() for x in args], 1e-5)
    with pytest.raises(TypeError, match="all fp32"):
        mlg.launch_merge_ln_gate_fwd(y_hw.bfloat16(), y_wh, z, g, b, 1e-5)
    wide, _ = _epilogue(1, 2, 3, 2052, torch.float32, dev, seed=5)
    with pytest.raises(RuntimeError, match="at most 2048 channels"):
        mlg.launch_merge_ln_gate_fwd(*wide, 1e-5)


# ------------------------------------------------------------ ops-level scans
def _channel_first(batch, G, dg, L, N, dev, seed):
    dim = G * dg
    a = _arrays(seed, u=(batch, dim, L), delta=(batch, dim, L), A=(dim, N),
                B=(batch, G, N, L), C=(batch, G, N, L), D=(dim,),
                delta_bias=(dim,))
    t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
    t["A"] = -torch.exp(t["A"])
    t["delta"] = t["delta"] * 0.5
    return t


CF_CASES = [
    # (batch, G, dg, L, N)
    (2, 1, 8, 1, 4),       # one token
    (1, 2, 5, 300, 1),     # odd dg, L not a multiple of the 128-token chunk
    (2, 3, 9, 513, 16),    # five chunks, the last of one token
    (1, 2, 33, 256, 40),   # whole chunks, a ragged channel block, N > 16
    (1, 2, 33, 257, 17),   # L % 4 != 0 (loads by element), two state tiles
    (2, 2, 33, 1, 40),     # one token, a ragged block, three state tiles
    (1, 1, 70, 1000, 8),   # three channel blocks, segments cut by L
]


@pytest.mark.parametrize("batch,G,dg,L,N", CF_CASES)
def test_channel_first_kernels_match_plain(dev, batch, G, dg, L, N):
    """K8 + K9 through selective_scan(backend="kernel"): y and all seven
    gradients against autograd of the plain version, one launch each."""
    inputs = {k: _leaf(v) for k, v in
              _channel_first(batch, G, dg, L, N, dev, seed=30 + L).items()}
    scan_cf.reset_launches()
    got_y, got = _grads(lambda **a: selective_scan(
        **a, delta_softplus=True, backend="kernel"), inputs)
    assert scan_cf.LAUNCHES == dict(scan_cf_fwd=1, scan_cf_bwd=1)
    want_y, want = _grads(lambda **a: selective_scan_chunked(
        **a, delta_softplus=True), inputs)
    _close(got_y[0], want_y[0], torch.float32)
    for k in want:
        _close(got[k], want[k], torch.float32)


def test_channel_first_bf16_io_and_bounds(dev):
    t = _channel_first(1, 2, 16, 100, 8, dev, seed=40)
    for k in ("u", "delta", "B", "C"):
        t[k] = t[k].bfloat16()
    with torch.inference_mode():
        got = selective_scan(**t, delta_softplus=True, backend="kernel")
        want = selective_scan_chunked(**t, delta_softplus=True)
    assert got.dtype == torch.bfloat16
    _close(got, want, torch.bfloat16)
    wide = _channel_first(1, 1, 4, 10, 257, dev, seed=41)
    with pytest.raises(ValueError, match="at most 256"):
        selective_scan(**wide, backend="kernel")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        selective_scan(**{k: v.cpu() for k, v in wide.items()},
                       backend="kernel")
    with pytest.raises(ValueError, match="take CUDA tensors"):
        scan_cf.launch_scan_cf_fwd(*(wide[k].cpu() for k in "u delta A B C"
                                     .split()))


@pytest.mark.parametrize("batch,G,dg,L,N", [(2, 3, 9, 513, 16),
                                            (1, 2, 33, 600, 40)])
def test_channel_first_checkpoints_and_reruns(dev, batch, G, dg, L, N):
    """K8 (chunk-parallel, on the shared forward body) with checkpoints:
    every 32-token checkpoint equals the plain token-by-token walk's state
    (one token past four chunks; three state tiles, a ragged channel
    block); a rerun gives the same bits (y and hck), and y without
    checkpoints the same bits as with them."""
    t = _channel_first(batch, G, dg, L, N, dev, seed=44 + N)
    core = (t["u"], t["delta"].abs(), t["A"], t["B"], t["C"])
    with torch.inference_mode():
        y1, h1 = scan_cf.launch_scan_cf_fwd(*core, with_hck=True)
        y2, h2 = scan_cf.launch_scan_cf_fwd(*core, with_hck=True)
        y0 = scan_cf.launch_scan_cf_fwd(*core)

        def rows(x, width):
            return x.reshape(batch, G, width, L).transpose(2, 3)

        walk = scan_g.scan_checkpoints_plain(
            rows(core[0], dg), rows(core[1], dg),
            core[2].reshape(G, dg, N).transpose(1, 2), core[3].transpose(2, 3))
    want = walk.reshape(h1.shape)
    assert h1.shape == (batch * G, -(-L // scan_g.CK_TOKENS), N, dg)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    assert torch.equal(y0, y1)
    _close(h1, want, torch.float32)


@pytest.mark.parametrize("N", [16, 40])
def test_channel_first_backward_reruns_bit_for_bit(dev, N):
    """dA is summed over per-chunk partials and dB / dC over 32-channel
    block partials in a fixed order (72 channels: three blocks, one
    ragged; five chunks; one state tile and three): a rerun of K9 gives the
    same bits, all five outputs."""
    t = _channel_first(2, 2, 72, 600, N, dev, seed=42)
    core = (t["u"], t["delta"].abs(), t["A"], t["B"], t["C"])
    _, hck = scan_cf.launch_scan_cf_fwd(*core, with_hck=True)
    dy = torch.randn(t["u"].shape, device=dev)
    first = scan_cf.launch_scan_cf_bwd(*core, hck, dy)
    again = scan_cf.launch_scan_cf_bwd(*core, hck, dy)
    assert len(first) == 5
    for a_, b_ in zip(first, again):
        assert torch.equal(a_, b_)


# small fixed inputs of `chip_smoke.body_bits`: one with every kernel, one
# with odd sizes, one with d_state 40 (K10 / K11 only: three state tiles)
BITS_CASES = [("small0", dict(B=1, H=9, W=37, dg=40, N=16)),
              ("small1", dict(B=2, H=5, W=7, dg=33, N=4)),
              ("small2", dict(B=1, H=12, W=20, dg=24, N=40))]


def test_body_sources_keep_their_recorded_bits(dev):
    """K9 joined the chunk backward body of K3, K4 and K11 (a
    channel-first source, A read through the source, null bias / D): on
    fixed inputs, K1, K3, K10 and K11 give the bits recorded on the card
    from the tree before that change, K2 and K4 those of their Hopper
    design (`chip_smoke.BODY_BITS`)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = json.loads(smoke.BODY_BITS.read_text())
    got = smoke.body_bits(dev, BITS_CASES)
    assert len(got) == 6 + 6 + 2
    assert {k: v for k, v in got.items() if want.get(k) != v} == {}


def _per_row(batch, G, dg, L, N, dev, seed):
    bg = batch * G
    a = _arrays(seed, u=(bg, L, dg), delta=(bg, L, dg), A=(G, N, dg),
                B=(bg, L, N), C=(bg, L, N), D=(G, dg), delta_bias=(G, dg))
    t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
    t["A"] = -torch.exp(t["A"])
    t["delta"] = t["delta"] * 0.5
    return t


@pytest.mark.parametrize("N", [1, 16])
def test_per_row_scan_runs_on_k1_k3(dev, N):
    """selective_scan_cl(backend="kernel") on (batch*G, L, dg) rows takes
    K1 + K3 (one launch each): y and all seven gradients against autograd
    of the plain version."""
    inputs = {k: _leaf(v) for k, v in
              _per_row(2, 3, 50, 77, N, dev, seed=50 + N).items()}
    scan_g.reset_launches()
    got_y, got = _grads(lambda **a: selective_scan_cl(
        **a, delta_softplus=True, backend="kernel"), inputs)
    launched = {k: n for k, n in scan_g.LAUNCHES.items() if n}
    assert launched == dict(scan_fwd=1, scan_bwd=1)
    want_y, want = _grads(lambda **a: selective_scan_cl_plain(
        **a, delta_softplus=True), inputs)
    _close(got_y[0], want_y[0], torch.float32)
    for k in want:
        _close(got[k], want[k], torch.float32)


def test_per_row_scan_bounds(dev):
    """A bf16 call with a gradient runs in fp32 (cast first, as JAX does);
    d_state 17 runs as slices of 16 and 1 on K1 and matches the plain
    version."""
    t = _per_row(1, 2, 16, 40, 4, dev, seed=60)
    u = t["u"].bfloat16().requires_grad_(True)
    y = selective_scan_cl(u, *(t[k] for k in ("delta", "A", "B", "C")),
                          backend="kernel")
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert u.grad is not None and torch.isfinite(u.grad.float()).all()
    wide = _per_row(1, 2, 16, 40, 17, dev, seed=61)
    scan_g.reset_launches()
    with torch.inference_mode():
        got = selective_scan_cl(**wide, delta_softplus=True,
                                backend="kernel")
    assert scan_g.LAUNCHES["scan_fwd"] == 2
    _close(got, selective_scan_cl_plain(**wide, delta_softplus=True),
           torch.float32)


@pytest.mark.parametrize("N", [17, 40])
def test_wide_states_run_as_slices_of_16(dev, N):
    """The grouped scan, the fused-projection entry (which takes the
    streamed route above 16 states) and the per-row scan at d_state 17 and
    40: y and every gradient against autograd of the plain versions, one
    K1 and one K3 per slice of at most 16 states."""
    slices = -(-N // 16)
    t = _streamed(2, 2, 45, 24, N, torch.float32, dev, seed=70 + N)
    inputs = {k: _leaf(v) for k, v in dict(
        u=t["u"], delta=t["dt"], A=t["A"], B=t["B"], C=t["C"], D=t["D"],
        delta_bias=t["bias"]).items()}
    scan_g.reset_launches()
    got_y, got = _grads(lambda **a: scan_g.selective_scan_g(
        **a, delta_softplus=True, reverse=True), inputs)
    launched = {k: n for k, n in scan_g.LAUNCHES.items() if n}
    assert launched == dict(scan_fwd=slices, scan_bwd=slices), launched
    want_y, want = _grads(lambda **a: scan_g.selective_scan_g_plain(
        **a, delta_softplus=True, reverse=True), inputs)
    _close(got_y[0], want_y[0], torch.float32)
    for k in want:
        _close(got[k], want[k], torch.float32)

    p = _projected(2, 24, N, torch.float32, dev, seed=80 + N)
    inputs = {k: _leaf(v) for k, v in dict(
        u0=t["u"][:, 0], u1=t["u"][:, 1], ya0=t["ya"][:, 0],
        ya1=t["ya"][:, 1], w_dt=p["w_dt"], w_b=p["w_b"], w_c=p["w_c"],
        A=p["A"], D=p["D"], delta_bias=p["bias"]).items()}

    def ml(fn):
        def run(u0, u1, ya0, ya1, **a):
            return fn((u0, u1), **a, y_accum=(ya0, ya1), delta_softplus=True,
                      reverse=True, swap_groups_c=True)
        return run

    scan_g.reset_launches()
    got_y, got = _grads(ml(scan_g.selective_scan_g_proj_ml), inputs)
    launched = {k: n for k, n in scan_g.LAUNCHES.items() if n}
    assert launched == dict(scan_fwd=slices, scan_bwd=slices), launched
    want_y, want = _grads(ml(scan_g.selective_scan_g_proj_ml_plain), inputs)
    for g_, w_ in zip(got_y, want_y):
        _close(g_, w_, torch.float32)
    for k in want:
        _close(got[k], want[k], torch.float32)

    rows = {k: _leaf(v) for k, v in
            _per_row(2, 2, 24, 45, N, dev, seed=90 + N).items()}
    got_y, got = _grads(lambda **a: selective_scan_cl(
        **a, delta_softplus=True, backend="kernel"), rows)
    want_y, want = _grads(lambda **a: selective_scan_cl_plain(
        **a, delta_softplus=True), rows)
    _close(got_y[0], want_y[0], torch.float32)
    for k in want:
        _close(got[k], want[k], torch.float32)


# ------------------------------------------------------------ image scan
def _image(b, H, W, dg, N, dev, seed, softplus=True):
    """Inputs of selective_scan_ss2d_proj. Without the softplus, x and W_dt
    are non-negative, so every delta is (a negative one grows the state
    without bound, in the plain version too)."""
    a = _arrays(seed, x=(b, H, W, dg), w_dt=(2, 2, dg, dg),
                w_b=(2, 2, dg, N), w_c=(2, 2, dg, N), A=(2, 2, N, dg),
                D=(2, 2, dg), delta_bias=(2, 2, dg))
    t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
    if not softplus:
        t["x"], t["w_dt"] = t["x"].abs(), t["w_dt"].abs()
        t["delta_bias"] = t["delta_bias"].abs()
    t["w_dt"] = t["w_dt"] * 0.3 / dg ** 0.5
    t["w_b"] = t["w_b"] / dg ** 0.5
    t["w_c"] = t["w_c"] / dg ** 0.5
    t["A"] = -torch.exp(t["A"])
    t["delta_bias"] = t["delta_bias"] * 0.1
    return t


IMG_CASES = [
    # (b, H, W, dg, N)
    (1, 1, 1, 8, 4),       # one pixel: one partial segment per chain
    (2, 7, 9, 40, 16),     # odd image, dg not a multiple of 32
    (1, 15, 20, 64, 1),    # stage-3 geometry of 480x640, d_state 1
    (2, 5, 6, 24, 40),     # d_state in three state tiles
    (1, 3, 11, 36, 256),   # the widest state: sixteen state tiles
]


@pytest.mark.parametrize("b,H,W,dg,N", IMG_CASES)
@pytest.mark.parametrize("softplus", [False, True])
def test_image_kernels_match_plain(dev, b, H, W, dg, N, softplus):
    """K10 + K11 + K5 through selective_scan_ss2d_proj: y and all seven
    gradients against autograd of the plain version; one K10, one K11 and
    a K5 per direction. Without a gradient, one K10 and nothing else."""
    inputs = {k: _leaf(v) for k, v in
              _image(b, H, W, dg, N, dev, seed=100 + N,
                     softplus=softplus).items()}
    scan_g.reset_launches()
    scan_img.reset_launches()
    got_y, got = _grads(lambda **a: scan_g.selective_scan_ss2d_proj(
        **a, delta_softplus=softplus), inputs)
    assert scan_img.LAUNCHES == dict(scan_img_fwd=1, scan_img_bwd=1)
    launched = {k: n for k, n in scan_g.LAUNCHES.items() if n}
    assert launched == dict(proj_grad=2), launched
    want_y, want = _grads(lambda **a: scan_img.selective_scan_ss2d_proj_plain(
        **a, delta_softplus=softplus), inputs)
    _close(got_y[0], want_y[0], torch.float32)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], torch.float32)
    scan_img.reset_launches()
    with torch.inference_mode():
        y = scan_g.selective_scan_ss2d_proj(
            **{k: v.detach() for k, v in inputs.items()},
            delta_softplus=softplus)
    assert scan_img.LAUNCHES == dict(scan_img_fwd=1, scan_img_bwd=0)
    _close(y, want_y[0], torch.float32)


def test_image_kernel_bf16_and_bounds(dev):
    """bf16 io forward at 5e-2; a bf16 call with a gradient returns bf16
    gradients at 5e-2; d_state 257 raises; D and delta_bias may be left
    out."""
    t = _image(2, 9, 12, 48, 16, dev, seed=120)
    for k in ("x", "w_dt", "w_b", "w_c"):
        t[k] = t[k].bfloat16()
    with torch.inference_mode():
        got = scan_g.selective_scan_ss2d_proj(**t, delta_softplus=True)
    want = scan_img.selective_scan_ss2d_proj_plain(**t, delta_softplus=True)
    assert got.dtype == torch.bfloat16
    _close(got, want, torch.bfloat16)
    bare = {k: v for k, v in t.items() if k not in ("D", "delta_bias")}
    with torch.inference_mode():
        got = scan_g.selective_scan_ss2d_proj(**bare, delta_softplus=True)
    _close(got, scan_img.selective_scan_ss2d_proj_plain(
        **bare, delta_softplus=True), torch.bfloat16)
    x = t["x"].clone().requires_grad_(True)
    dy = torch.randn(x.shape, device=dev)
    (dx,) = torch.autograd.grad(scan_g.selective_scan_ss2d_proj(
        x, *(t[k] for k in ("w_dt", "w_b", "w_c", "A")),
        delta_softplus=True), x, dy)
    xf = t["x"].float().requires_grad_(True)
    (want,) = torch.autograd.grad(scan_img.selective_scan_ss2d_proj_plain(
        xf, *(t[k].float() for k in ("w_dt", "w_b", "w_c", "A")),
        delta_softplus=True), xf, dy)
    assert dx.dtype == torch.bfloat16
    _close(dx, want, torch.bfloat16)
    wide = _image(1, 2, 3, 8, 257, dev, seed=121)
    with pytest.raises(ValueError, match="at most 256"):
        scan_g.selective_scan_ss2d_proj(**wide)


@pytest.mark.parametrize("b,H,W,dg,N", [(1, 1, 1, 8, 4), (2, 7, 9, 40, 16),
                                        (2, 5, 6, 24, 40)])
def test_image_backward_bf16_io(dev, b, H, W, dg, N):
    """A bf16 call with a gradient keeps bf16 io through the backward: one
    K10 and one K11 on bf16 operands and both K5 on bf16 x (no fp32 copy
    of x is made), all seven gradients in their inputs' dtypes against
    autograd of the plain version at 5e-2 (one pixel, an odd image with dg
    not a multiple of 32, three state tiles); K11 at bf16 io reruns bit for
    bit."""
    t = _image(b, H, W, dg, N, dev, seed=150 + N, softplus=True)
    for k in ("x", "w_dt", "w_b", "w_c"):
        t[k] = t[k].bfloat16()
    inputs = {k: _leaf(v) for k, v in t.items()}
    scan_g.reset_launches()
    scan_img.reset_launches()
    got_y, got = _grads(lambda **a: scan_g.selective_scan_ss2d_proj(
        **a, delta_softplus=True), inputs)
    assert scan_img.LAUNCHES_BF16 == dict(scan_img_fwd=1, scan_img_bwd=1)
    launched = {k: n for k, n in scan_g.LAUNCHES_BF16.items() if n}
    assert launched == dict(proj_grad=2), launched
    want_y, want = _grads(lambda **a: scan_img.selective_scan_ss2d_proj_plain(
        **a, delta_softplus=True), inputs)
    assert got_y[0].dtype == torch.bfloat16
    _close(got_y[0], want_y[0], torch.bfloat16)
    for k in want:
        assert got[k].dtype == inputs[k].dtype, k
        _close(got[k], want[k], torch.bfloat16)
    args = [t[k] for k in ("x", "w_dt", "w_b", "w_c", "A", "D",
                           "delta_bias")]
    _, hck = scan_img.launch_scan_img_fwd(*args, delta_softplus=True,
                                          with_hck=True)
    dy = torch.randn(t["x"].shape, device=dev).bfloat16()
    first = scan_img.launch_scan_img_bwd(*args, hck, dy, True)
    again = scan_img.launch_scan_img_bwd(*args, hck, dy, True)
    for a_, b_ in zip(first, again):
        assert torch.equal(a_, b_)


@pytest.mark.parametrize("b,H,W,dg,N", [(2, 7, 9, 40, 16), (1, 12, 25, 64, 4),
                                        (1, 5, 6, 24, 20)])
def test_image_forward_checkpoints_and_reruns(dev, b, H, W, dg, N):
    """K10 (chunk-parallel) with checkpoints: its hck, in K11's layout,
    equals the plain walk's states (below one chunk, over several with the
    last ragged, two state tiles); a rerun gives the same bits (y and hck);
    y without checkpoints has the same bits."""
    t = _image(b, H, W, dg, N, dev, seed=140 + N)
    args = [t[k] for k in ("x", "w_dt", "w_b", "w_c", "A", "D",
                           "delta_bias")]
    with torch.inference_mode():
        y1, h1 = scan_img.launch_scan_img_fwd(*args, delta_softplus=True,
                                              with_hck=True)
        y2, h2 = scan_img.launch_scan_img_fwd(*args, delta_softplus=True,
                                              with_hck=True)
        y0 = scan_img.launch_scan_img_fwd(*args, delta_softplus=True)
        want = scan_img.scan_checkpoints_img_plain(
            t["x"], t["w_dt"], t["w_b"], t["A"], t["delta_bias"], True)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    assert torch.equal(y0, y1)
    _close(h1, want, torch.float32)


def _image_backward_reruns(dev, N, seed):
    t = _image(2, 10, 14, 80, N, dev, seed=seed)
    args = [t[k] for k in ("x", "w_dt", "w_b", "w_c", "A", "D",
                           "delta_bias")]
    _, hck = scan_img.launch_scan_img_fwd(*args, delta_softplus=True,
                                          with_hck=True)
    dy = torch.randn(t["x"].shape, device=dev)
    first = scan_img.launch_scan_img_bwd(*args, hck, dy, True)
    again = scan_img.launch_scan_img_bwd(*args, hck, dy, True)
    for a_, b_ in zip(first, again):
        assert torch.equal(a_, b_)


def test_image_backward_reruns_bit_for_bit(dev):
    """dB / dC are channel-block partials and dA / dbias / dD per-chunk
    values summed in a fixed order (80 channels: three blocks; 140 tokens:
    two chunks): a rerun of K11 gives the same bits."""
    _image_backward_reruns(dev, 16, seed=130)


def test_image_backward_reruns_bit_for_bit_over_state_tiles(dev):
    """The same at d_state 40: three state tiles, each token's du / dd
    terms summed over the tiles in a fixed order."""
    _image_backward_reruns(dev, 40, seed=131)
