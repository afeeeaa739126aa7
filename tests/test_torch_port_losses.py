"""The port's loss zoo (`sigma_tpu_torch/utils/losses.py`) against the JAX
package's (`sigma_tpu/utils/losses.py`), on the CPU.

Seeded logits (2, 12, 16, 9) with some labels at 255 (berHu: a seeded
regression target with some pixels at 0, its ignore value): each loss's
value at rtol 1e-5 / atol 1e-6 and its gradient with respect to the
logits against `jax.grad` at rtol 1e-4 / atol 1e-6; with class weights
where the loss takes them; bf16 logits computed in fp32. OHEM's kept mask
equals JAX's (read from the labels JAX's OHEM hands its cross-entropy) on
logits whose true-class probabilities are distinct, with min_kept below
and above the count of pixels under the threshold. `cross_entropy`
equals the train step's `segmentation_loss`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.utils import losses as jlosses
from sigma_tpu_torch.models.builder import segmentation_loss
from sigma_tpu_torch.utils import losses
from _port_load import FAST_XLA

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
SHAPE, C = (2, 12, 16), 9
WEIGHT = np.linspace(0.5, 1.5, C).astype(np.float32)


def _data(seed, scale=2.0):
    rng = np.random.default_rng(seed)
    logits = (scale * rng.standard_normal((*SHAPE, C))).astype(np.float32)
    labels = rng.integers(0, C, SHAPE).astype(np.int32)
    labels[rng.random(SHAPE) < 0.2] = 255
    return logits, labels


# name: (port fn, JAX fn, keyword arguments)
CASES = {
    "cross_entropy": ("cross_entropy", {}),
    "cross_entropy_weighted": ("cross_entropy", {"weight": WEIGHT}),
    "focal_loss_2d": ("focal_loss_2d", {"gamma": 0.5}),
    "focal_loss_2d_weighted": ("focal_loss_2d", {"weight": WEIGHT}),
    "balance_loss": ("balance_loss", {}),
    "balance_loss_weighted": ("balance_loss", {"weight": WEIGHT}),
    "ohem_cross_entropy": ("ohem_cross_entropy",
                           {"thresh": 0.3, "min_kept": 100}),
    "ohem_cross_entropy_weighted": ("ohem_cross_entropy",
                                    {"thresh": 0.7, "min_kept": 50,
                                     "weight": WEIGHT}),
    "rce_loss": ("rce_loss", {"num_classes": C, "beta": 0.5}),
}


def _value_and_grad(fn, x):
    """JAX's value and gradient of fn at x, jitted at FAST_XLA (a tenth of
    the eager ops' compile time)."""
    x = jnp.asarray(x)
    return jax.jit(jax.value_and_grad(fn)).lower(x).compile(
        compiler_options=FAST_XLA)(x)


def _both(name, kw, logits, labels):
    """(port value, port gradient, JAX value, JAX gradient) of loss `name`
    at `logits`."""
    t = torch.from_numpy(logits).requires_grad_(True)
    got = getattr(losses, name)(t, torch.from_numpy(labels).long(), **kw)
    (g,) = torch.autograd.grad(got, t)
    jfn = getattr(jlosses, name)
    want, jg = _value_and_grad(lambda x: jfn(x, jnp.asarray(labels), **kw),
                               logits)
    return got.detach().numpy(), g.numpy(), np.asarray(want), np.asarray(jg)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradient_match_jax(case):
    name, kw = CASES[case]
    logits, labels = _data(seed=len(case))
    got, g, want, jg = _both(name, kw, logits, labels)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g, jg, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_berhu_and_sigmoid_focal_match_jax():
    rng = np.random.default_rng(3)
    pred = rng.standard_normal(SHAPE).astype(np.float32)
    target = np.abs(rng.standard_normal(SHAPE)).astype(np.float32)
    target[rng.random(SHAPE) < 0.2] = 0.0
    binary = rng.integers(0, 2, SHAPE).astype(np.int32)
    binary[rng.random(SHAPE) < 0.2] = 255
    for fn, args, kw in (
            ("berhu_loss", (target,), {"delta": 0.3}),
            ("sigmoid_focal_loss", (binary, 255), {"gamma": 1.5,
                                                   "alpha": 0.4})):
        t = torch.from_numpy(pred).requires_grad_(True)
        got = getattr(losses, fn)(t, torch.from_numpy(args[0]), *args[1:],
                                  **kw)
        (g,) = torch.autograd.grad(got, t)
        want, jg = _value_and_grad(lambda x: getattr(jlosses, fn)(
            x, jnp.asarray(args[0]), *args[1:], **kw), pred)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                                   atol=ATOL, err_msg=fn)
        np.testing.assert_allclose(g.numpy(), jg, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=fn)


def test_bf16_logits_compute_in_fp32():
    logits, labels = _data(seed=5)
    t = torch.from_numpy(logits).bfloat16()
    lab = torch.from_numpy(labels).long()
    for name in ("cross_entropy", "focal_loss_2d", "balance_loss"):
        got = getattr(losses, name)(t, lab)
        assert got.dtype == torch.float32
        want = getattr(jlosses, name)(jnp.asarray(t.float().numpy(),
                                                  jnp.bfloat16),
                                      jnp.asarray(labels))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("min_kept", [10, 250])
def test_ohem_kept_mask_matches_jax(monkeypatch, min_kept):
    """min_kept 10: fewer than the pixels under the threshold (the
    threshold rules); 250: more (the min_kept-th smallest probability
    rules). Probabilities are distinct (seeded continuous logits)."""
    logits, labels = _data(seed=11, scale=1.0)
    thresh = 0.1
    seen = {}
    real_ce = jlosses.cross_entropy

    def spy(lg, lb, ignore_index, weight):
        seen["labels"] = np.asarray(lb)
        return real_ce(lg, lb, ignore_index, weight)

    monkeypatch.setattr(jlosses, "cross_entropy", spy)
    jlosses.ohem_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               thresh=thresh, min_kept=min_kept)
    want = seen["labels"] != 255
    kept = losses.ohem_kept(torch.from_numpy(logits),
                            torch.from_numpy(labels).long(), thresh=thresh,
                            min_kept=min_kept).numpy()
    p = torch.softmax(torch.from_numpy(logits), -1).numpy()
    valid = labels != 255
    true_p = np.take_along_axis(p, np.where(valid, labels, 0)[..., None],
                                -1)[..., 0][valid]
    assert len(np.unique(true_p)) == true_p.size
    hard = int((true_p <= thresh).sum())
    assert (min_kept < hard) == (min_kept == 10)
    np.testing.assert_array_equal(kept, want)
    assert kept.sum() == max(hard, min(min_kept, int(valid.sum())))


def test_cross_entropy_is_the_train_loss():
    logits, labels = _data(seed=7)
    t, lab = torch.from_numpy(logits), torch.from_numpy(labels).long()
    assert torch.equal(losses.cross_entropy(t, lab),
                       segmentation_loss(t, lab))
    lab[:] = 255  # no valid pixel: 0, not NaN
    assert float(losses.cross_entropy(t, lab)) == 0.0
