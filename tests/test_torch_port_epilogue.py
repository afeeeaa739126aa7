"""The fused SS2D epilogue of the PyTorch port against the JAX package, on
the CPU.

  * `merge_ln_gate_plain` / `merge_ln_gate_bwd_plain`, and the port's entry
    point through autograd (its CPU route: the plain forward and the
    explicit backward formula), against JAX `merge_ln_gate` in Pallas
    interpret mode and its `jax.vjp`, all five outputs, at the shapes and
    tolerances of tests/test_merge_ln_gate.py: out fp32 1e-5, gradients
    1e-4; bf16 5e-2 and 7e-2;
  * the explicit backward against autograd of the plain forward (fp32,
    rtol 1e-4 / atol 1e-5: the same math in another order);
  * the port's SS2D with the switch on against the JAX SS2D (whose CPU
    route is the same math unfused) at the reference envelope, rtol 6e-4 /
    atol 2e-3, and against itself with the switch off, gradients included;
  * the sigma_mini EncoderDecoder with the switch on against JAX at the
    golden portable tier (tests/test_golden_logits.py);
  * the switch: SIGMA_FUSED_EPILOGUE, off by default, read at import, and
    the same state_dict keys either way.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.models import ss2d as jss2d
from sigma_tpu.models.builder import EncoderDecoder as JaxEncoderDecoder
from sigma_tpu.ops.pallas_merge_ln_gate import merge_ln_gate as jax_mlg
from sigma_tpu.utils.convert import convert_sigma_full
from sigma_tpu_torch.models import ss2d as tss2d
from sigma_tpu_torch.models.builder import EncoderDecoder, init_parameters
from sigma_tpu_torch.ops.merge_ln_gate import (
    merge_ln_gate,
    merge_ln_gate_bwd_plain,
    merge_ln_gate_plain,
)
from sigma_tpu_torch.utils.convert import state_dict_from_jax
from _port_load import FAST_XLA

ROOT = Path(__file__).resolve().parents[1]
EPS = 1e-5
NAMES = ("dy_hw", "dy_wh", "dz", "dgamma", "dbeta")
# tests/test_merge_ln_gate.py's shapes and tolerances: (out, gradients)
CASES = [
    (24, 32, 64, "float32"),
    (24, 32, 64, "bfloat16"),
    (15, 20, 96, "float32"),    # odd sizes (PST900-style)
    (8, 128, 192, "bfloat16"),  # stage-1-like row width
]
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (5e-2, 7e-2)}
# torch's CPU threads in this test process: the suite runs several
# processes on the host's cores (as tests/test_torch_port_train.py does)
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


def _arrays(b, h, w, c, seed):
    rng = np.random.default_rng(seed)
    rnd = rng.standard_normal
    return dict(
        y_hw=rnd((b, h, w, c)).astype(np.float32),
        y_wh=rnd((b, w, h, c)).astype(np.float32),
        z=rnd((b, h, w, c)).astype(np.float32),
        gamma=(1.0 + 0.1 * rnd(c)).astype(np.float32),
        beta=(0.1 * rnd(c)).astype(np.float32),
        dout=rnd((b, h, w, c)).astype(np.float32))


def _torch_inputs(a, dtype):
    """y_hw, y_wh, z in `dtype` (bf16 rounds as jnp's cast does), gamma and
    beta fp32."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    for k in ("y_hw", "y_wh", "z"):
        t[k] = t[k].to(dtype)
    return t


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("h,w,c,dtype", CASES)
def test_plain_versions_match_the_jax_kernel(h, w, c, dtype):
    a = _arrays(2, h, w, c, seed=c + h)
    jdt = getattr(jnp, dtype)
    jin = [jnp.asarray(a[k]).astype(jdt) for k in ("y_hw", "y_wh", "z")]
    jin += [jnp.asarray(a["gamma"]), jnp.asarray(a["beta"])]
    want, vjp = jax.vjp(lambda *x: jax_mlg(*x, EPS, True), *jin)
    want_grads = vjp(jnp.asarray(a["dout"]))
    tol, gtol = TOL[dtype]

    t = _torch_inputs(a, getattr(torch, dtype))
    args = [t[k] for k in ("y_hw", "y_wh", "z", "gamma", "beta")]
    out = merge_ln_gate_plain(*args, EPS)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=tol,
                               atol=tol)
    grads = merge_ln_gate_bwd_plain(*args, EPS, t["dout"])
    for got, x in zip(grads[:3], args[:3]):
        assert got.dtype == x.dtype and got.shape == x.shape
    # the entry point's autograd (the CPU route of the autograd Function)
    leaves = [x.clone().requires_grad_(True) for x in args]
    out2 = merge_ln_gate(*leaves, EPS)
    auto = torch.autograd.grad(out2, leaves, t["dout"])
    np.testing.assert_allclose(_np(out2), np.asarray(want), rtol=tol,
                               atol=tol)
    for name, g1, g2, w_ in zip(NAMES, grads, auto, want_grads):
        want_np = np.asarray(w_, np.float32)
        for g in (g1, g2):
            np.testing.assert_allclose(_np(g), want_np, rtol=gtol, atol=gtol,
                                       err_msg=name)


@pytest.mark.parametrize("h,w,c", [(24, 32, 64), (15, 20, 96), (3, 5, 7)])
def test_explicit_backward_matches_autograd_of_plain(h, w, c):
    a = _arrays(2, h, w, c, seed=7 * c)
    t = _torch_inputs(a, torch.float32)
    leaves = [t[k].clone().requires_grad_(True)
              for k in ("y_hw", "y_wh", "z", "gamma", "beta")]
    out = merge_ln_gate_plain(*leaves, EPS)
    want = torch.autograd.grad(out, leaves, t["dout"])
    got = merge_ln_gate_bwd_plain(*[x.detach() for x in leaves], EPS,
                                  t["dout"])
    for name, g, w_ in zip(NAMES, got, want):
        torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-5, msg=name)


def test_entry_point_rejects_what_it_does_not_take():
    a = _arrays(1, 4, 6, 8, seed=1)
    t = _torch_inputs(a, torch.float32)
    args = [t[k] for k in ("y_hw", "y_wh", "z", "gamma", "beta")]
    with pytest.raises(ValueError, match="y_wh: shape"):
        merge_ln_gate(args[0], args[0], *args[2:])
    with pytest.raises(ValueError, match="gamma: shape"):
        merge_ln_gate(*args[:3], args[3][:4], args[4])
    with pytest.raises(ValueError, match="inputs on"):
        merge_ln_gate(*args[:4], args[4].to("meta"))


def _load_module(module, params):
    """Port module <- JAX module params (wrapped to reuse the key map)."""
    sd = state_dict_from_jax({"m": {"op": jax.tree.map(np.asarray, params)}})
    module.load_state_dict({k[len("m.op."):]: v for k, v in sd.items()})
    return module.eval()


def _count_calls(monkeypatch, module, name):
    """Wrap module.name to count its calls; returns the count list."""
    calls, fn = [0], getattr(module, name)

    def counted(*a, **k):
        calls[0] += 1
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_fused_ss2d_matches_jax_and_the_unfused_port(monkeypatch):
    calls = _count_calls(monkeypatch, tss2d, "merge_ln_gate")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 12, 32)).astype(np.float32)
    jm = jss2d.SS2D(d_model=32, d_state=16)
    params = jax.jit(jm.init, compiler_options=FAST_XLA)(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    # a LayerNorm affine other than (1, 0), so gamma and beta are seen
    norm = dict(params["out_norm"])
    norm["scale"] = jnp.asarray(1.0 + 0.1 * rng.standard_normal(64),
                                jnp.float32)
    norm["bias"] = jnp.asarray(0.1 * rng.standard_normal(64), jnp.float32)
    params = {**params, "out_norm": norm}
    want = jax.jit(jm.apply, compiler_options=FAST_XLA)(
        {"params": params}, jnp.asarray(x))

    tm = _load_module(tss2d.SS2D(32, d_state=16), params)
    tss2d.set_fused_epilogue(tm, True)
    assert tm.fused_epilogue
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tm(xt)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=6e-4,
                               atol=2e-3)
    leaves = [xt, *tm.parameters()]
    g_on = torch.autograd.grad(got.square().sum(), leaves)
    tss2d.set_fused_epilogue(tm, False)
    ref = tm(xt)
    assert calls == [1]  # the fused forward only
    g_off = torch.autograd.grad(ref.square().sum(), leaves)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    for a_, b_ in zip(g_on, g_off):
        torch.testing.assert_close(a_, b_, rtol=1e-4, atol=1e-5)


def test_encoder_decoder_sigma_mini_fused_golden_tier():
    """Seeded port weights, each SS2D's out_norm affine perturbed, moved
    into a JAX tree that jax.eval_shape laid out (no init is compiled);
    the JAX side computed in this process."""
    rng = np.random.default_rng(123)
    rgb, mx = (rng.standard_normal((1, 64, 80, 3)).astype(np.float32)
               for _ in range(2))
    tm = init_parameters(EncoderDecoder(9, "sigma_mini"), seed=42)
    gen = torch.Generator().manual_seed(43)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, tss2d.SS2D):
                c = m.out_norm.weight.shape[0]
                m.out_norm.weight.add_(0.1 * torch.randn(c, generator=gen))
                m.out_norm.bias.copy_(0.1 * torch.randn(c, generator=gen))
    jm = JaxEncoderDecoder(num_classes=9, backbone="sigma_mini", remat=False)
    xz = jnp.zeros(rgb.shape, jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), xz, xz)["params"]
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params, _, missing = convert_sigma_full(zeros, sd)
    assert missing == []
    want = np.asarray(jax.jit(jm.apply, compiler_options=FAST_XLA)(
        {"params": params}, jnp.asarray(rgb), jnp.asarray(mx)))

    tss2d.set_fused_epilogue(tm, True)
    n = sum(isinstance(m, tss2d.SS2D) and m.fused_epilogue
            for m in tm.modules())
    assert n == 5 + 12  # trunk blocks + decoder blocks of sigma_mini
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(rgb), torch.from_numpy(mx)).numpy()
    assert got.shape == want.shape == (1, 64, 80, 9)
    diff = np.abs(got - want)
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    assert diff.max() < 3e-2, diff.max()
    assert diff.mean() < 3e-3, diff.mean()
    assert agree >= 0.995, agree


@pytest.mark.parametrize("value,on", [(None, False), ("0", False),
                                      ("1", True)])
def test_switch_is_the_env_var_read_at_import(value, on):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("SIGMA_FUSED_EPILOGUE", None)
    if value is not None:
        env["SIGMA_FUSED_EPILOGUE"] = value
    code = ("from sigma_tpu_torch.models import ss2d\n"
            "m = ss2d.SS2D(8, d_state=4)\n"
            "print(ss2d.FUSED_EPILOGUE, m.fused_epilogue)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == [str(on), str(on)]


def test_state_dict_keys_do_not_depend_on_the_switch():
    m = EncoderDecoder(9, "sigma_test")
    off = list(m.state_dict())
    tss2d.set_fused_epilogue(m, True)
    assert list(m.state_dict()) == off
    assert all(m.fused_epilogue for m in m.modules()
               if isinstance(m, tss2d.SS2D))
