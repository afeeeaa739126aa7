"""Keeping the port's CPU tests light on a host whose cores the whole suite
shares (its other workers run the JAX package's long compiles meanwhile).

  * FAST_XLA: compile options for the tests' JAX references
    (`jax.jit(..., compiler_options=FAST_XLA)`, or
    `.lower(...).compile(compiler_options=FAST_XLA)`): XLA's lowest CPU
    backend optimisation level, the same program in about half the
    compile CPU time;
  * few_torch_threads: an autouse module fixture (imported into a test
    module) that caps torch at TORCH_THREADS CPU threads there.
"""

import pytest
import torch

TORCH_THREADS = 2
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)
