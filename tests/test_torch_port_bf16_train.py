"""The bf16 train step of the PyTorch port against the JAX package's, on
the CPU.

Two steps of `make_train_step` on sigma_test in bf16 compute (seeded port
weights carried into JAX, drop path 0, AdamW, a warmup of one update)
against JAX `make_train_step` with a bf16 model, from the same uint8
batches. The losses agree within 5e-2, and so does the gradient, read
through AdamW's first moment (which after update k holds sum_j 0.1 *
0.9^(k-j) * g_j on both sides), leaf by leaf: within 5e-2 of the leaf's
norm. bf16 rounds at other places in the two frameworks, and where a
leaf's gradient is mostly cancellation, JAX's own bf16 gradient strays
further than that from its fp32 one; such a leaf is held instead to twice
that stray, measured against the port's fp32 step (which agrees with
JAX's fp32 step leaf by leaf within 1e-4: `test_torch_port_train.py`).
The port's parameters, gradients and moments stay fp32. `torch` runs on
two threads, as in the other train tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import sigma_tpu.models.vssm as jvssm
from configs import get_config as jax_get_config
from sigma_tpu.engine.optim import build_optimizer as jax_build_optimizer
from sigma_tpu.engine.train import TrainState as JaxTrainState
from sigma_tpu.engine.train import make_train_step as jax_make_step
from sigma_tpu.models.builder import EncoderDecoder as JaxEncoderDecoder
from sigma_tpu.utils.convert import convert_sigma_full
from sigma_tpu.utils.lr_schedule import warmup_poly_lr as jax_warmup_poly
from sigma_tpu_torch.configs import get_config
from sigma_tpu_torch.engine.optim import build_optimizer
from sigma_tpu_torch.engine.train import create_train_state, make_train_step
from sigma_tpu_torch.models.builder import EncoderDecoder, init_parameters
from sigma_tpu_torch.models.common import DropPath
from sigma_tpu_torch.utils.convert import state_dict_from_jax
from sigma_tpu_torch.utils.lr_schedule import warmup_poly_lr
from _port_load import FAST_XLA, JAX_SCAN_CHUNK

TORCH_THREADS = 2
BF16_TOL = 5e-2
BATCHES = (10, 11)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


class _NoDropPath(fnn.Module):
    """Identity in place of the JAX DropPath, so both sides run drop path
    0 (the decoder's rate is not a constructor option there)."""

    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, deterministic: bool = True):
        return x


def _uint8_batch(seed, b=2, h=32, w=32):
    rng = np.random.default_rng(seed)
    label = rng.integers(0, 9, (b, h, w)).astype(np.uint8)
    label[:, :2] = 255
    return dict(
        data=rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
        modal_x=rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
        label=label,
        margins=np.array([[3, 1, 0, 2], [0, 0, 4, 1]][:b], np.int32))


def _port_run(sd, dtype):
    """Two port steps in `dtype` compute from state_dict `sd`: (losses,
    [AdamW's first moment by name after each update], the model)."""
    cfg = get_config("mfnet", backbone="sigma_test",
                     bf16=dtype == torch.bfloat16)
    model = EncoderDecoder(9, "sigma_test", remat=False, dtype=dtype)
    model.load_state_dict(sd)
    for m in model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    opt = build_optimizer(cfg, model)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, warmup_poly_lr(1e-3, 0.9, 100, 1),
                           cfg.norm_mean, cfg.norm_std)
    losses, mus = [], []
    for seed in BATCHES:
        loss = step(state, _uint8_batch(seed))
        assert loss.dtype == torch.float32
        losses.append(float(loss))
        mus.append({k: opt.state[p]["exp_avg"].clone()
                    for k, p in model.named_parameters()})
    return losses, mus, model


def test_bf16_train_steps_match_jax():
    port = init_parameters(EncoderDecoder(9, "sigma_test", remat=False),
                           seed=3)
    sd = port.state_dict()
    jm = JaxEncoderDecoder(num_classes=9, backbone="sigma_test",
                           drop_path_rate=0.0, remat=False,
                           scan_chunk=JAX_SCAN_CHUNK,
                           dtype=jnp.bfloat16)
    x = jnp.zeros((2, 32, 32, 3), jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(3), x, x)["params"]
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    params, _, missing = convert_sigma_full(
        zeros, {k: v.numpy() for k, v in sd.items()})
    assert missing == []

    cfg = get_config("mfnet", backbone="sigma_test")
    tx = jax_build_optimizer(jax_get_config("mfnet", backbone="sigma_test"),
                             jax_warmup_poly(1e-3, 0.9, 100, 1), params)
    jparams = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                          opt_state=tx.init(jparams))
    want_losses, want_mu = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvssm, "DropPath", _NoDropPath)
        jstep = jax_make_step(jm, tx, donate=False, norm_mean=cfg.norm_mean,
                              norm_std=cfg.norm_std)
        jstep = jstep.lower(state, _uint8_batch(BATCHES[0]),
                            jax.random.PRNGKey(1)).compile(
            compiler_options=FAST_XLA)
        for seed in BATCHES:
            state, loss = jstep(state, _uint8_batch(seed),
                                jax.random.PRNGKey(1))
            want_losses.append(float(loss))
            want_mu.append(jax.tree.map(np.asarray, state.opt_state[0].mu))

    got_losses, got_mu, model = _port_run(sd, torch.bfloat16)
    _, fp32_mu, _ = _port_run(sd, torch.float32)
    for p in model.parameters():
        assert p.dtype == p.grad.dtype == torch.float32
    print(f"bf16 losses: port {got_losses}, JAX {want_losses}")
    np.testing.assert_allclose(got_losses, want_losses, rtol=BF16_TOL)
    for k in range(len(BATCHES)):
        want_k = state_dict_from_jax(want_mu[k], model)
        bad, wide = [], []
        for name, mu in got_mu[k].items():
            assert mu.dtype == torch.float32, name
            norm = float(want_k[name].norm())
            gap = float((mu - want_k[name]).norm())
            stray = float((want_k[name] - fp32_mu[k][name]).norm())
            bound = max(BF16_TOL * norm, 2 * stray)
            if bound > BF16_TOL * norm:
                scale = max(norm, 1e-30)
                wide.append((name, gap / scale, stray / scale))
            if gap > bound:
                bad.append((name, gap, norm, stray))
        print(f"update {k}: leaves held to twice JAX's own bf16 stray "
              f"(gap / norm, stray / norm): {wide}")
        assert not bad, (k, bad[:5])
