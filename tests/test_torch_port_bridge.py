"""Weight bridge between the JAX package and the PyTorch port (sigma_mini).

  * JAX params -> `state_dict_from_jax` -> `convert_sigma_full` gives back
    the same tree bit for bit, with nothing missing;
  * the port's state_dict keys are exactly the keys the converter reads;
  * `.npz` (flattened flax paths) and enveloped `.pth` checkpoints load to
    the same state_dict.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.models.builder import EncoderDecoder as JaxEncoderDecoder
from sigma_tpu.utils.convert import convert_sigma_full
from sigma_tpu_torch.models.builder import EncoderDecoder
from sigma_tpu_torch.utils.convert import load_checkpoint, state_dict_from_jax
from _port_load import few_torch_threads  # noqa: F401 (a fixture)


@pytest.fixture(scope="module")
def jax_params():
    """The JAX sigma_mini's param tree as jax.eval_shape lays it out (no
    init is compiled), every leaf filled with its own seeded values, so
    that a leaf carried to another's place shows."""
    jm = JaxEncoderDecoder(num_classes=9, backbone="sigma_mini")
    x = jnp.zeros((1, 64, 80, 3), jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(7), x, x)["params"]
    rng = np.random.default_rng(7)
    return jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), shapes)


@pytest.fixture(scope="module")
def port_sd(jax_params):
    model = EncoderDecoder(9, "sigma_mini")
    sd = state_dict_from_jax(jax_params, model)
    model.load_state_dict(sd)
    return {k: v.numpy() for k, v in model.state_dict().items()}


def test_roundtrip_through_convert_sigma_full_is_bit_exact(jax_params,
                                                           port_sd):
    zeros = jax.tree.map(np.zeros_like, jax_params)
    back, loaded, missing = convert_sigma_full(zeros, port_sd)
    assert missing == []
    leaves = jax.tree_util.tree_leaves_with_path(jax_params)
    back_leaves = jax.tree_util.tree_leaves(back)
    assert len(leaves) == len(back_leaves)
    for (path, a), b in zip(leaves, back_leaves):
        b = np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_port_keys_equal_the_keys_the_converter_reads(jax_params, port_sd):
    _, loaded, _ = convert_sigma_full(jax_params, port_sd)
    assert len(loaded) == len(set(loaded))
    assert set(loaded) == set(port_sd)


def test_npz_and_enveloped_pth_load_alike(jax_params, port_sd, tmp_path):
    flat = {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_leaves_with_path(jax_params)
    }
    np.savez(tmp_path / "params.npz", **flat)
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v)
                               for k, v in port_sd.items()}},
               tmp_path / "model.pth")
    for name in ("params.npz", "model.pth"):
        sd = load_checkpoint(str(tmp_path / name))
        assert set(sd) == set(port_sd), name
        for k, v in sd.items():
            assert np.array_equal(v.numpy(), port_sd[k]), (name, k)


def test_unused_jax_leaf_and_unfilled_key_raise(jax_params):
    model = EncoderDecoder(9, "sigma_mini")
    extra = dict(jax_params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        state_dict_from_jax(extra, model)
    partial = dict(jax_params)
    partial.pop("decode_head")
    with pytest.raises(KeyError, match="decode_head"):
        state_dict_from_jax(partial, model)
