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
    so that no JAX init is compiled.
"""

import jax
import numpy as np
import pytest
import torch

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
