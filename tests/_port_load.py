"""Keeping the port's CPU tests light on a host whose cores the whole suite
shares (its other workers run the JAX package's long compiles meanwhile).

  * FAST_XLA: compile options for the tests' JAX references
    (`jax.jit(..., compiler_options=FAST_XLA)`, or
    `.lower(...).compile(compiler_options=FAST_XLA)`): XLA's lowest CPU
    backend optimisation level, the same program in about half the
    compile CPU time;
  * JAX_SCAN_CHUNK: the JAX references' scan chunk;
  * few_torch_threads: an autouse module fixture (imported into a test
    module) that caps torch at TORCH_THREADS CPU threads there;
  * jax_tree_from_port: a JAX params (or batch_stats) tree that
    jax.eval_shape laid out, filled with a port module's seeded tensors,
    so that no JAX init is compiled; fill_seeded: such a tree filled
    from a numpy seed;
  * NoDropout / NoDropPath: identities to monkeypatch in for flax's
    Dropout and the JAX package's DropPath (the parity tests run dropout
    at rate 0 on both sides); keep_grads: an optax transformation that
    reads a JAX train step's gradients out; float_batch: a seeded float
    train batch;
  * DS_DEPTHS, cut_decoder, cut_jax_decoder: MambaDecoder cut to one
    block a level in a whole-step test, the port's model and JAX's
    EncoderDecoder alike (JAX's has no option for the depths, and at
    sigma_test's (4, 4, 4, 4) a JAX train step compiles in three times
    as long).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sigma_tpu.models.builder as jbuilder
from sigma_tpu.models.decoders import mamba_decoder as jmd
from sigma_tpu_torch.models.decoders.mamba_decoder import MambaDecoder
from sigma_tpu_torch.utils import convert

TORCH_THREADS = 2
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
# the chunk of the JAX references' portable CPU scan (`scan_chunk` of
# their EncoderDecoder and MambaDecoder; `selective_scan_xla`): the same
# recurrence, associative within 8-token chunks and sequential across
# them, traced and compiled in about 70% of the time of the default 128
JAX_SCAN_CHUNK = 8


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


def jax_tree_from_port(shapes, module, wrap=(), strip="", stats=False):
    """The JAX tree laid out as `shapes` (jax.eval_shape of the JAX
    module's init: its "params", or with `stats` its "batch_stats")
    holding `module`'s tensors: the inverse of `state_dict_from_jax`'s key
    map and transposes, read off by pushing each leaf's flat indices
    through them. The JAX tree sits under the keys `wrap` in the
    converter's view (the context its rules expect), and `strip` is the
    prefix that view adds to the module's own keys."""
    sd = {strip + k: v.numpy() for k, v in module.state_dict().items()}

    def leaf(path, a):
        parts = list(wrap) + [p.key for p in path]
        if stats:
            key = convert._torch_key("/".join(parts[:-1])) + "." + \
                convert._STATS[parts[-1]]
            return sd[key].reshape(a.shape).copy()
        name = "/".join(parts)
        idx = np.arange(int(np.prod(a.shape))).reshape(a.shape)
        perm = np.asarray(convert._transform(name, parts[-1], a.ndim)(idx))
        out = np.empty(idx.size, np.float32)
        out[perm.ravel()] = sd[convert._torch_key(name)].ravel()
        return out.reshape(a.shape)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def fill_seeded(tree, seed):
    """Seeded values on an eval_shape tree: kernels ~ N / sqrt(fan_in),
    scales 1 + 0.1 N, biases and running means 0.1 N, running
    variances in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            return (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.random(a.shape)).astype(np.float32)
        if name in ("A_logs", "A_log_1", "A_log_2"):
            return np.log(np.broadcast_to(np.arange(1, a.shape[-1] + 1),
                                          a.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


class NoDropout(fnn.Module):
    """Identity in place of flax's Dropout inside a test."""

    rate: float = 0.0
    broadcast_dims: tuple = ()
    deterministic: bool | None = None

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


class NoDropPath(fnn.Module):
    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, deterministic: bool = True):
        return x


def keep_grads():
    """An optax transformation whose state is the last gradient and whose
    update is zero: it reads the JAX step's gradients out exactly."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def float_batch(seed, b=2, h=32, w=32):
    """A float train batch of 9 classes, its first three rows ignored."""
    rng = np.random.default_rng(seed)
    label = rng.integers(0, 9, (b, h, w)).astype(np.int32)
    label[:, :3] = 255
    return dict(data=rng.standard_normal((b, h, w, 3)).astype(np.float32),
                modal_x=rng.standard_normal((b, h, w, 3)).astype(np.float32),
                label=label)


DS_DEPTHS = (1, 1, 1, 1)


def cut_decoder(model):
    """`model` with a MambaDecoder of DS_DEPTHS blocks (deep supervision
    as it was, no remat); any other decoder as it is."""
    head = model.decode_head
    if isinstance(head, MambaDecoder):
        model.decode_head = MambaDecoder(
            head.output.out_channels, embed_dim=head.output.in_channels,
            depths=DS_DEPTHS, deep_supervision=head.deep_supervision,
            remat=False, dtype=head.compute_dtype)
    return model


def cut_jax_decoder(monkeypatch):
    """JAX's EncoderDecoder makes its MambaDecoder with DS_DEPTHS
    blocks."""
    monkeypatch.setattr(jbuilder, "MambaDecoder", functools.partial(
        jmd.MambaDecoder, depths=DS_DEPTHS))
