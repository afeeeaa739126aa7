"""The whole port model against the JAX package's at the PST900 geometry,
fp32 and bf16, on the CPU.

PST900's 720x1280 frames give a stride-32 map 22.5 rows high: the last
PatchMerging2D pads an odd map, and the decoder's resize of its upsampled
path to the odd stride-16 skip shrinks (jax.image.resize antialiases
there, `resize_linear`; ROADMAP C3). A 80x64 input has the same odd
geometry at sigma_test size: maps 20x16, 10x8, 5x4, then 3x2, and the
decoder resizes 6x4 to 5x4.

  * `test_pst900_geometry_matches_jax`, fp32 and bf16: the port's logits
    against JAX's from the same weights, JAX computed in this process
    (tests/test_golden_logits.py explains why). fp32 at the portable tier:
    max|diff| < 3e-2, mean|diff| < 3e-3, argmax agreement >= 99.5%. JAX's
    own bf16 logits miss that tier against its fp32 ones here (mean
    3.2e-3, agreement 99.39% on the CPU), so in bf16 each of the tier's
    three statistics of the port against JAX is held to twice JAX's own
    bf16-vs-fp32 value (the disagreement for the agreement);
  * `test_bf16_logits_gap_within_jax_own_bf16_gap`: the port-vs-JAX bf16
    gap at most twice JAX's own bf16-vs-fp32 gap on the same weights and
    inputs, and within 5e-2 of max(|ref|, 1); argmax agreement printed.
JAX's model is `build_model` with `bf16` off and on; the port's
`build_model` likewise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from configs import get_config as jax_get_config
from sigma_tpu.models.builder import build_model as jax_build_model
from sigma_tpu.utils.convert import convert_sigma_full
from sigma_tpu_torch.configs import get_config
from sigma_tpu_torch.models.builder import build_model
from sigma_tpu_torch.utils.convert import state_dict_from_jax
from _port_load import FAST_XLA, JAX_SCAN_CHUNK

TORCH_THREADS = 2
H, W = 80, 64  # stride-32 height 2.5, as PST900's 720 gives 22.5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


def _jax_cfg(bf16):
    cfg = jax_get_config("mfnet", backbone="sigma_test", bf16=bf16)
    object.__setattr__(cfg, "remat", False)
    object.__setattr__(cfg, "scan_chunk", JAX_SCAN_CHUNK)
    return cfg


@pytest.fixture(scope="module")
def logits():
    """{("jax" | "port", "fp32" | "bf16"): logits (float32 numpy)} of one
    seeded sigma_test and one seeded 80x64 RGB-X pair; the port's seeded
    weights carried into JAX by the JAX package's converter."""
    rng = np.random.default_rng(33)
    rgb, mx = (rng.standard_normal((1, H, W, 3)).astype(np.float32)
               for _ in range(2))
    out = {}
    port_sd = params = None
    for name, bf16 in (("fp32", False), ("bf16", True)):
        cfg = get_config("mfnet", backbone="sigma_test", bf16=bf16)
        port = build_model(cfg, device="cpu", seed=7)
        if port_sd is None:
            port_sd = port.state_dict()
        port.load_state_dict(port_sd)
        with torch.inference_mode():
            got = port(torch.from_numpy(rgb), torch.from_numpy(mx))
        assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
        out[("port", name)] = got.float().numpy()
        jm = jax_build_model(_jax_cfg(bf16))
        if params is None:  # fp32 parameters in both: one tree serves
            shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                    jnp.asarray(rgb),
                                    jnp.asarray(mx))["params"]
            zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                 shapes)
            params, _, missing = convert_sigma_full(
                zeros, {k: v.numpy() for k, v in port_sd.items()})
            assert missing == []
            # the weights went over whole: back through the port's bridge
            assert state_dict_from_jax(params, port).keys() == \
                port_sd.keys()
        want = jax.jit(jm.apply, compiler_options=FAST_XLA)(
            {"params": params}, jnp.asarray(rgb), jnp.asarray(mx))
        assert want.dtype == (jnp.bfloat16 if bf16 else jnp.float32)
        out[("jax", name)] = np.asarray(want, np.float32)
    return out


def _tier(got, want):
    """The portable tier's statistics: (max|diff|, mean|diff|, argmax
    disagreement)."""
    diff = np.abs(got - want)
    return (float(diff.max()), float(diff.mean()),
            float((got.argmax(-1) != want.argmax(-1)).mean()))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_pst900_geometry_matches_jax(logits, dtype):
    got, want = logits[("port", dtype)], logits[("jax", dtype)]
    assert got.shape == want.shape == (1, H, W, 9)
    stats = _tier(got, want)
    print(f"{dtype} logits at {H}x{W}, port vs JAX: max %.4e mean %.4e "
          f"argmax disagreement %.5f" % stats)
    if dtype == "fp32":
        assert stats[0] < 3e-2 and stats[1] < 3e-3 and stats[2] <= 0.005, \
            stats
        return
    own = _tier(want, logits[("jax", "fp32")])
    print(f"JAX bf16 vs fp32: max %.4e mean %.4e argmax disagreement "
          f"%.5f" % own)
    assert all(p <= 2 * o for p, o in zip(stats, own)), (stats, own)


def test_bf16_logits_gap_within_jax_own_bf16_gap(logits):
    got, want = logits[("port", "bf16")], logits[("jax", "bf16")]
    port_gap = float(np.abs(got - want).max())
    jax_gap = float(np.abs(want - logits[("jax", "fp32")]).max())
    scale = max(float(np.abs(want).max()), 1.0)
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    print(f"bf16 logits: port vs JAX max {port_gap:.4e}, JAX bf16 vs fp32 "
          f"max {jax_gap:.4e}, scale {scale:.3f}, argmax agreement "
          f"{agree:.5f}")
    assert port_gap <= 2 * jax_gap
    assert port_gap <= 5e-2 * scale
