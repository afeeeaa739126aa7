"""Model modules of the PyTorch port against the JAX package, on the CPU.

Each JAX module is initialised by flax, its params go through the port's
`state_dict_from_jax` (the whole EncoderDecoder: the port's seeded weights
through the JAX package's `convert_sigma_full`), and the same seeded numpy
inputs run through both.
JAX takes its portable CPU scan path; the port takes the plain PyTorch
versions of its scan entry points (CPU tensors). Tolerances:
  * scan modules: fp32 rtol 6e-4 / atol 2e-3 (reference envelope);
  * the whole EncoderDecoder: the golden portable tier, max|diff| < 3e-2,
    mean|diff| < 3e-3, argmax agreement >= 99.5%, with the JAX side
    computed in this process (tests/test_golden_logits.py explains why
    the strict tier is no cross-context invariant).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.models import ss2d as jss2d
from sigma_tpu.models.builder import EncoderDecoder as JaxEncoderDecoder
from sigma_tpu.utils.convert import convert_sigma_full
from sigma_tpu_torch.models import ss2d as tss2d
from sigma_tpu_torch.models.builder import EncoderDecoder, init_parameters
from sigma_tpu_torch.models.common import resize_bilinear
from sigma_tpu_torch.utils.convert import state_dict_from_jax
from _port_load import (  # noqa: F401 (few_torch_threads: a fixture)
    FAST_XLA,
    JAX_SCAN_CHUNK,
    few_torch_threads,
)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _load_module(module, params):
    """Port module <- JAX module params (wrapped to reuse the key map)."""
    sd = state_dict_from_jax({"m": {"op": _np_tree(params)}})
    module.load_state_dict({k[len("m.op."):]: v for k, v in sd.items()})
    return module.eval()


def _inputs(n, shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _close(got, want):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), rtol=6e-4, atol=2e-3)


def test_ss2d_matches_jax():
    (x,) = _inputs(1, (2, 8, 12, 32), seed=0)
    jm = jss2d.SS2D(d_model=32, d_state=16)
    params = jax.jit(jm.init, compiler_options=FAST_XLA)(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jax.jit(jm.apply, compiler_options=FAST_XLA)(
        {"params": params}, jnp.asarray(x))
    tm = _load_module(tss2d.SS2D(32, d_state=16), params)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("name", ["CrossMambaFusionSS2D", "ConMBSS2D"])
def test_fusion_scan_modules_match_jax(name):
    xr, xe = _inputs(2, (2, 6, 10, 32), seed=1)
    jm = getattr(jss2d, name)(d_model=32, d_state=4)
    params = jax.jit(jm.init, compiler_options=FAST_XLA)(
        jax.random.PRNGKey(1), jnp.asarray(xr), jnp.asarray(xe))["params"]
    want = jax.jit(jm.apply, compiler_options=FAST_XLA)(
        {"params": params}, jnp.asarray(xr), jnp.asarray(xe))
    tm = _load_module(getattr(tss2d, name)(32, d_state=4), params)
    with torch.inference_mode():
        got = tm(torch.from_numpy(xr), torch.from_numpy(xe))
    if name == "ConMBSS2D":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        _close(g, w)


def test_encoder_decoder_sigma_mini_golden_tier():
    """The port's seeded weights moved by the JAX package's converter into
    a JAX tree that jax.eval_shape laid out (no init is compiled; remat
    off, which a forward does not see): the JAX forward against the
    port's. `test_torch_port_bridge.py` holds the converters' round trip
    on the same tree."""
    rgb, mx = _inputs(2, (1, 64, 80, 3), seed=123)
    jm = JaxEncoderDecoder(num_classes=9, backbone="sigma_mini", remat=False,
                           scan_chunk=JAX_SCAN_CHUNK)
    xz = jnp.zeros(rgb.shape, jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(42), xz, xz)["params"]
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    tm = init_parameters(EncoderDecoder(9, "sigma_mini"), seed=42)
    params, _, missing = convert_sigma_full(
        zeros, {k: v.numpy() for k, v in tm.state_dict().items()})
    assert missing == []
    want = np.asarray(jax.jit(jm.apply, compiler_options=FAST_XLA)(
        {"params": params}, jnp.asarray(rgb), jnp.asarray(mx)))
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(rgb), torch.from_numpy(mx)).numpy()
    assert got.shape == want.shape == (1, 64, 80, 9)
    diff = np.abs(got - want)
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    assert diff.max() < 3e-2, diff.max()
    assert diff.mean() < 3e-3, diff.mean()
    assert agree >= 0.995, agree


def test_seeded_init_is_deterministic_and_finite():
    a = init_parameters(EncoderDecoder(9, "sigma_test"), seed=3)
    b = init_parameters(EncoderDecoder(9, "sigma_test"), seed=3)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
        assert torch.isfinite(v).all(), k
    rgb, mx = (torch.from_numpy(t) for t in _inputs(2, (1, 32, 48, 3), 4))
    with torch.inference_mode():
        y = a.eval()(rgb, mx)
    assert y.shape == (1, 32, 48, 9) and torch.isfinite(y).all()


@pytest.mark.parametrize(
    "hw,out", [((5, 7), (10, 14)), ((5, 7), (9, 16)), ((4, 6), (4, 5))])
def test_resize_bilinear_matches_jax(hw, out):
    """Exact 2x, a general enlargement, and the decoder's odd-size shrink
    (6 -> 5 at sigma_mini 64x80), which jax antialiases."""
    from sigma_tpu.models.common import resize_bilinear as jax_resize

    (x,) = _inputs(1, (2, *hw, 3), seed=5)
    want = jax_resize(jnp.asarray(x), *out)
    got = resize_bilinear(torch.from_numpy(x), *out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_unported_parts_raise():
    """The MiT and Swin backbones wait for ROADMAP item A7c."""
    for backbone in ("mit_b2", "swin_s"):
        with pytest.raises(NotImplementedError, match="ROADMAP.*A7c"):
            EncoderDecoder(9, backbone)
