"""The BatchNorm decoders, deep supervision and the aux losses of the
PyTorch port against the JAX package, on the CPU.

JAX params are laid out by `jax.eval_shape` (no init is compiled) and
filled from a numpy seed (the heads) or with the port's seeded init (the
whole step), BatchNorm's `batch_stats` too; they move into the port
through `state_dict_from_jax(..., batch_stats=...)`.

  * `models/norm.py`: flax's BatchNorm arithmetic (biased running
    variance; one value per channel gives var 0 and does not raise);
    `adaptive_avg_pool` and the align-corners resize against torch;
  * each head (UPerHead, FCNHead, MLPDecoder, DeepLabV3Plus, MambaDecoder
    with its deep-supervision heads) on fixed seeded features at the JAX
    package's own sizes (tests/test_losses_and_decoders.py): in train
    mode the output, the new batch statistics and the gradients of the
    inputs and of every parameter at the fp32 kernel tier (rtol 6e-4,
    atol 2e-3 of max(|ref|, 1)); in eval mode the output at that tier; in
    bf16 compute the output at 5e-2, in JAX's dtype;
  * dropout's bits cannot match JAX's: the parity tests run it at rate 0
    on both sides (flax's Dropout swapped for the identity inside the
    test), and the port's own dropout is held to its keep rate and to one
    mask per (seed, step, module, sample), through remat and data
    parallel splits;
  * the train step as a whole, sigma_test with UPernet + the FCN aux head
    and with MambaDecoder + deep supervision (its depths cut to one block
    a level on both sides, DS_DEPTHS): the loss of JAX's
    `make_train_step` (its `loss_fn`: the aux terms at unit weight or at
    `aux_rate`) and its gradients (one `jax.value_and_grad`, read out by
    an optax transformation that keeps them) against the port's step,
    leaf by leaf within 1e-4 of each leaf's norm (plus 1e-7 of the whole
    gradient's), and the new running statistics at the fp32 tier; UPernet
    at batch 6, since a BatchNorm over two values a channel makes fp32
    gradients ill-conditioned;
  * the train CLI with `--decoder UPernet` and with deep supervision,
    then `-c`, then the eval CLI with `-e` (epochs and one file);
  * no port module reaches SyncBatchNorm, adaptive pools or interpolate.
"""

import functools
import logging

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sigma_tpu.models.builder as jbuilder
import sigma_tpu.models.vssm as jvssm
from sigma_tpu.engine.train import TrainState as JaxTrainState
from sigma_tpu.engine.train import make_train_step as jax_make_step
from sigma_tpu.models.builder import EncoderDecoder as JaxEncoderDecoder
from sigma_tpu.models.decoders import deeplabv3plus as jdl
from sigma_tpu.models.decoders import fcnhead as jfcn
from sigma_tpu.models.decoders import mamba_decoder as jmd
from sigma_tpu.models.decoders import mlp_decoder as jmlp
from sigma_tpu.models.decoders import upernet as jup
from sigma_tpu_torch.configs import get_config
from sigma_tpu_torch.data.png import write_png
from sigma_tpu_torch.engine.optim import build_optimizer
from sigma_tpu_torch.engine.train import create_train_state, make_train_step
from sigma_tpu_torch.models.builder import EncoderDecoder, init_parameters
from sigma_tpu_torch.models.common import (
    DropPath,
    Dropout,
    maybe_remat,
    set_drop_path_seeds,
)
from sigma_tpu_torch.models.decoders.deeplabv3plus import (
    DeepLabV3Plus,
    resize_bilinear_align_corners,
)
from sigma_tpu_torch.models.decoders.fcnhead import FCNHead
from sigma_tpu_torch.models.decoders.mamba_decoder import MambaDecoder
from sigma_tpu_torch.models.decoders.mlp_decoder import MLPDecoder
from sigma_tpu_torch.models.decoders.upernet import UPerHead, adaptive_avg_pool
from sigma_tpu_torch.models.norm import BatchNorm
from sigma_tpu_torch.utils.convert import state_dict_from_jax
from _port_load import (  # noqa: F401 (few_torch_threads: a fixture)
    FAST_XLA,
    JAX_SCAN_CHUNK,
    few_torch_threads,
    jax_tree_from_port,
)

FP32 = (6e-4, 2e-3)  # rtol, atol of max(|ref|, 1)
BF16 = 5e-2
GRAD_RTOL = 1e-4  # the whole step's gradients, leaf by leaf


def _close(got, want, tol=FP32, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1] * scale,
                               err_msg=what)


def _fill(tree, seed):
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


class _NoDropout(fnn.Module):
    """Identity in place of flax's Dropout inside a test: the parity
    tests run dropout at rate 0 on both sides."""

    rate: float = 0.0
    broadcast_dims: tuple = ()
    deterministic: bool | None = None

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


class _NoDropPath(fnn.Module):
    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, deterministic: bool = True):
        return x


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    monkeypatch.setattr(jvssm, "DropPath", _NoDropPath)


def _no_port_dropout(model):
    for m in model.modules():
        if isinstance(m, (Dropout, DropPath)):
            m.rate = 0.0
    return model


def _feats(batch=1, seed=1):
    """The JAX package's decoder-test pyramid (channels 8 / 16 / 32 / 64
    at strides 4 / 8 / 16 / 32 of a 64x64 input)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, s, s, c)).astype(np.float32)
            for s, c in ((16, 8), (8, 16), (4, 32), (2, 64))]


def _load(module, params, stats=None):
    """Port head <- JAX head variables (keyed as a decode_head)."""
    sd = state_dict_from_jax({"decode_head": params},
                             batch_stats=stats and {"decode_head": stats})
    module.load_state_dict({k[len("decode_head."):]: v
                            for k, v in sd.items()})
    return module


# ------------------------------------------------------------ BatchNorm
def test_batchnorm_is_flax_arithmetic():
    """Batch statistics, the biased running variance, eval mode, bf16 in
    -> fp32 out, against flax's BatchNorm with the same scale and bias."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 3, 5, 6)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(6)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(6)).astype(np.float32)
    stats = {"mean": (0.1 * rng.standard_normal(6)).astype(np.float32),
             "var": (0.5 + rng.random(6)).astype(np.float32)}
    bn = BatchNorm(6)
    _load(bn, {"scale": scale, "bias": bias}, stats)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": stats}
    want, new = jbn.apply(variables, x, mutable=["batch_stats"])
    got = bn.train()(torch.from_numpy(x))
    _close(got, want)
    _close(bn.running_mean, new["batch_stats"]["mean"])
    _close(bn.running_var, new["batch_stats"]["var"])
    biased = x.reshape(-1, 6).astype(np.float64).var(0)
    np.testing.assert_allclose(
        (bn.running_var.numpy() - 0.9 * stats["var"]) / 0.1, biased,
        rtol=1e-4)
    unbiased = x.reshape(-1, 6).astype(np.float64).var(0, ddof=1)
    assert not np.allclose(biased, unbiased, rtol=1e-2)
    jeval = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                          epsilon=1e-5)
    _close(bn.eval()(torch.from_numpy(x)),
           jeval.apply({"params": variables["params"],
                        "batch_stats": new["batch_stats"]}, x))
    x16 = torch.from_numpy(x).bfloat16()
    y16 = bn.train()(x16)
    want16 = jbn.apply(variables, jnp.asarray(x, jnp.bfloat16),
                       mutable=["batch_stats"])[0]
    assert y16.dtype == torch.float32 and want16.dtype == jnp.float32
    _close(y16, want16)


def test_batchnorm_one_value_per_channel_gives_var_zero():
    """UPerHead's 1x1 pool at batch 1: var 0, as in JAX, where
    F.batch_norm raises."""
    x = torch.randn(1, 1, 1, 4, generator=torch.Generator().manual_seed(0))
    bn = BatchNorm(4).train()
    mean, var = bn.batch_stats(x)
    assert torch.equal(var, torch.zeros(4)) and torch.equal(mean, x[0, 0, 0])
    y = bn(x.requires_grad_(True))
    y.sum().backward()
    assert torch.equal(y.detach(), torch.zeros(1, 1, 1, 4))
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9)
    with pytest.raises(ValueError, match="more than 1 value"):
        torch.nn.functional.batch_norm(
            x.detach().permute(0, 3, 1, 2), None, None, training=True)


def test_adaptive_pool_and_align_corners_resize_match_torch():
    x = np.random.default_rng(1).standard_normal((2, 7, 9, 3)).astype(
        np.float32)
    nchw = torch.from_numpy(x.transpose(0, 3, 1, 2))
    for s in (1, 2, 3, 6):
        want = torch.nn.AdaptiveAvgPool2d(s)(nchw).permute(0, 2, 3, 1)
        _close(adaptive_avg_pool(torch.from_numpy(x), s), want.numpy(),
               (1e-5, 1e-6))
    for out in ((9, 11), (7, 9), (1, 4), (14, 3)):
        want = torch.nn.functional.interpolate(
            nchw, size=out, mode="bilinear", align_corners=True)
        _close(resize_bilinear_align_corners(torch.from_numpy(x), *out),
               want.permute(0, 2, 3, 1).numpy(), (1e-5, 1e-5))
    one = torch.from_numpy(x[:, :1, :1])
    assert torch.equal(resize_bilinear_align_corners(one, 3, 2),
                       one.expand(2, 3, 2, 3))


# ------------------------------------------------------------ heads
def _heads():
    """name: (JAX head, port head, feature indices it reads)."""
    return {
        "UPerHead": (lambda dt: jup.UPerHead(num_classes=5, dtype=dt),
                     lambda dt: UPerHead((8, 16, 32, 64), 5, dtype=dt),
                     (0, 1, 2, 3)),
        "FCNHead": (lambda dt: jfcn.FCNHead(num_classes=5, dtype=dt),
                    lambda dt: FCNHead(32, 5, dtype=dt), (2,)),
        "MLPDecoder": (lambda dt: jmlp.MLPDecoder(num_classes=5, dtype=dt),
                       lambda dt: MLPDecoder((8, 16, 32, 64), 5, dtype=dt),
                       (0, 1, 2, 3)),
        "DeepLabV3Plus": (
            lambda dt: jdl.DeepLabV3Plus(num_classes=5, dtype=dt),
            lambda dt: DeepLabV3Plus((8, 16, 32, 64), 5, dtype=dt),
            (0, 1, 2, 3)),
        "MambaDecoder+DS": (
            lambda dt: jmd.MambaDecoder(
                num_classes=5, embed_dim=8, depths=(1, 1, 1, 1),
                drop_path_rate=0.0, deep_supervision=True, remat=False,
                scan_chunk=JAX_SCAN_CHUNK, dtype=dt),
            lambda dt: MambaDecoder(
                5, embed_dim=8, depths=(1, 1, 1, 1), drop_path_rate=0.0,
                deep_supervision=True, remat=False, dtype=dt),
            (0, 1, 2, 3)),
    }


def _outputs(out):
    """A head's output as a list of arrays (DS: logits, then the heads')."""
    if isinstance(out, tuple):
        return [out[0], *out[1]]
    return [out]


@pytest.mark.parametrize("name", ["UPerHead", "FCNHead", "MLPDecoder",
                                  "DeepLabV3Plus", "MambaDecoder+DS"])
def test_head_matches_jax(name, no_jax_dropout):
    """Train mode (batch statistics, the new running statistics, the
    gradients of the inputs and of every parameter), eval mode, and bf16
    compute, at batch 1: UPerHead's 1x1 pool and ASPP's image pool then
    hold one value per channel."""
    make_j, make_t, use = _heads()[name]
    feats = [_feats()[i] for i in use]
    arg = feats if len(use) > 1 else feats[0]
    jhead = make_j(jnp.float32)
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0), arg)
    params = _fill(shapes["params"], seed=2)
    stats = _fill(shapes["batch_stats"], 3) if "batch_stats" in shapes \
        else None
    rng = np.random.default_rng(4)

    def run(p, x, train):
        variables = {"params": p}
        if stats is not None:
            variables["batch_stats"] = stats
        out = jhead.apply(variables, x, deterministic=not train,
                          mutable=["batch_stats"] if train else [])
        return out

    out0, _ = jax.eval_shape(lambda p, x: run(p, x, True), params, arg)
    cots = [rng.standard_normal(o.shape).astype(np.float32)
            for o in _outputs(out0)]

    def loss(p, x):
        out, new = run(p, x, True)
        outs = _outputs(out)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), (outs, new)

    (_, (want, new)), (gp, gx) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True),
        compiler_options=FAST_XLA)(params, arg)

    thead = _no_port_dropout(_load(make_t(torch.float32), params, stats))
    xs = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    targ = xs if len(use) > 1 else xs[0]
    kw = {"aux": True} if name == "MambaDecoder+DS" else {}
    got = _outputs(thead.train()(targ, **kw))
    assert len(got) == len(want) == len(cots)
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cots)).backward()
    for g, w in zip(got, want):
        _close(g, w, what=f"{name} train output")
    if stats is not None:
        want_sd = state_dict_from_jax({"decode_head": params},
                                      batch_stats={"decode_head":
                                                   new["batch_stats"]})
        for k, b in thead.named_buffers():
            _close(b, want_sd["decode_head." + k].numpy(), what=k)
    for t, g in zip(xs, gx if len(use) > 1 else [gx]):
        grad = torch.zeros_like(t) if t.grad is None else t.grad  # unread
        _close(grad, g, what=f"{name} input gradient")
    want_g = state_dict_from_jax({"decode_head": jax.tree.map(np.asarray,
                                                              gp)})
    for k, p in thead.named_parameters():
        _close(p.grad, want_g["decode_head." + k].numpy(), what=k)

    with torch.no_grad():
        thead.eval()
        _load(thead, params, stats)
        got = _outputs(thead(targ, **kw))
    if stats is not None:  # else eval mode computes what train mode did
        want = _outputs(jax.jit(lambda p, x: run(p, x, False)[0],
                                compiler_options=FAST_XLA)(params, arg))
    for g, w in zip(got, want):
        _close(g, w, what=f"{name} eval output")

    j16 = make_j(jnp.bfloat16)
    t16 = _no_port_dropout(_load(make_t(torch.bfloat16), params, stats))
    variables = {"params": params}
    if stats is not None:
        variables["batch_stats"] = stats
    want16 = jax.jit(lambda v, x: j16.apply(
        v, x, deterministic=False, mutable=["batch_stats"])[0],
        compiler_options=FAST_XLA)(variables, arg)
    with torch.no_grad():
        got16 = t16.train()(xs if len(use) > 1 else xs[0], **kw)
    for i, (g, w, w32) in enumerate(zip(_outputs(got16), _outputs(want16),
                                        want)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (g.dtype,
                                                             w.dtype)
        if name == "MambaDecoder+DS" and i == 0:
            # the main head, not this slice's: with these seeded weights
            # JAX's own bf16 logits stray 0.55 from its fp32 ones, so it is
            # held as tests/test_torch_port_bf16_model.py holds it
            gap = float(jnp.abs(w.astype(jnp.float32) - w32).max())
            err = float(np.abs(g.float().numpy() - np.asarray(w, np.float32))
                        .max())
            assert err <= 2 * gap, (err, gap)
            continue
        _close(g, w, (BF16, BF16), what=f"{name} bf16 output {i}")


# ------------------------------------------------------------ dropout
def test_dropout_keep_rate_and_one_mask_per_seed_step_and_sample():
    """The keep rate, the 1/keep scale, eval identity; one mask per
    (seed, step, module, global sample): redrawn under remat, and the
    same for a sample whichever rank's shard holds it."""
    drop = Dropout(0.25)
    x = torch.ones(4, 16, 16, 32)
    set_drop_path_seeds(drop, 7, 3, rows=(0, 4, 4))
    y = drop.train()(x)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01, kept
    assert torch.equal(torch.unique(y), torch.tensor([0.0, 1 / 0.75]))
    assert torch.equal(drop(x), y)  # the same seed draws the same mask
    assert torch.equal(drop.eval()(x), x)
    drop.train()
    halves = []
    for r in range(2):
        set_drop_path_seeds(drop, 7, 3, rows=(2 * r, 2, 4))
        halves.append(drop(x[2 * r:2 * r + 2]))
    assert torch.equal(torch.cat(halves), y)
    set_drop_path_seeds(drop, 7, 4, rows=(0, 4, 4))
    assert not torch.equal(drop(x), y)  # the next step draws anew
    set_drop_path_seeds(drop, 7, 3, rows=(0, 4, 4))
    w = torch.ones(4, 16, 16, 32, requires_grad=True)
    maybe_remat(drop, True, w).sum().backward()
    assert torch.equal(w.grad, y)  # the recompute drew the forward's mask


# ------------------------------------------------------------ train step
class _KeepGrads:
    """An optax transformation whose state is the last gradient and whose
    update is zero: it reads the JAX step's gradients out exactly."""

    @staticmethod
    def make():
        return optax.GradientTransformation(
            lambda p: jax.tree.map(jnp.zeros_like, p),
            lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _float_batch(seed, b=2, h=32, w=32):
    rng = np.random.default_rng(seed)
    label = rng.integers(0, 9, (b, h, w)).astype(np.int32)
    label[:, :3] = 255
    return dict(data=rng.standard_normal((b, h, w, 3)).astype(np.float32),
                modal_x=rng.standard_normal((b, h, w, 3)).astype(np.float32),
                label=label)


# MambaDecoder's depths in the whole-step test with deep supervision: the
# JAX builder has no option for them, and at sigma_test's (4, 4, 4, 4)
# the JAX step takes three times as long to compile
DS_DEPTHS = (1, 1, 1, 1)


def _cut_decoder(model):
    """`model` with a MambaDecoder of DS_DEPTHS blocks (deep supervision
    as it was); any other decoder as it is."""
    head = model.decode_head
    if isinstance(head, MambaDecoder):
        model.decode_head = MambaDecoder(
            head.output.out_channels, embed_dim=head.output.in_channels,
            depths=DS_DEPTHS, deep_supervision=head.deep_supervision,
            remat=False)
    return model


@pytest.fixture(scope="module", params=["UPernet", "MambaDecoder+DS"])
def jax_step(request):
    """One JAX `make_train_step` of sigma_test (drop path and dropout 0,
    no remat) from the port's seeded weights (BatchNorm's scale, bias and
    running statistics drawn apart, so that the step's update of each
    shows), moved into a tree that jax.eval_shape laid out: (decoder,
    deep_supervision, params, batch_stats, batch, loss, gradients, new
    batch_stats)."""
    # batch 6 for UPernet: its 1x1 pool's BatchNorm sees one value per
    # channel and sample, and with 2 of them fp32 rounding alone moves
    # the trunk's gradients by 4% of their norm (the port in fp32 against
    # the port in fp64), with 6 by 5e-6
    decoder, ds, b = ("UPernet", False, 6) if request.param == "UPernet" \
        else ("MambaDecoder", True, 2)
    # and JAX's default scan chunk for UPernet: the shorter chunk's other
    # rounding, through the backward of its BatchNorms, moves the trunk's
    # gradients by 2e-3 of their norm (at batch 6 to 48)
    jm = JaxEncoderDecoder(num_classes=9, backbone="sigma_test",
                           decoder=decoder, deep_supervision=ds,
                           drop_path_rate=0.0, remat=False,
                           scan_chunk=JAX_SCAN_CHUNK if ds else 128)
    mp = pytest.MonkeyPatch()
    if ds:  # one block a level (_cut_decoder)
        mp.setattr(jbuilder, "MambaDecoder", functools.partial(
            jmd.MambaDecoder, depths=DS_DEPTHS))
    batch = _float_batch(20, b=b)
    x = jnp.zeros((b, 32, 32, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), x, x, return_aux=True))
    port = init_parameters(_cut_decoder(EncoderDecoder(
        9, "sigma_test", decoder, deep_supervision=ds)), seed=21)
    gen = torch.Generator().manual_seed(22)
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.shape[0]
                m.weight.add_(0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
    params = jax_tree_from_port(shapes["params"], port)
    stats = jax_tree_from_port(shapes["batch_stats"], port, stats=True) \
        if "batch_stats" in shapes else None
    tx = _KeepGrads.make()
    jparams = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                          opt_state=tx.init(jparams), batch_stats=stats)
    try:
        mp.setattr(fnn, "Dropout", _NoDropout)
        mp.setattr(jvssm, "DropPath", _NoDropPath)
        step = jax_make_step(jm, tx, donate=False).lower(
            state, batch, jax.random.PRNGKey(1)).compile(
            compiler_options=FAST_XLA)
        new, loss = step(state, batch, jax.random.PRNGKey(1))
    finally:
        mp.undo()
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (decoder, ds, params, stats, batch, float(loss),
            np_tree(new.opt_state), np_tree(new.batch_stats))


def test_train_step_with_aux_losses_matches_jax(jax_step):
    """The port's step from the same weights, batch statistics and batch:
    the loss with its aux terms, every gradient leaf within GRAD_RTOL of
    its norm, the new running statistics at the fp32 tier."""
    decoder, ds, params, stats, batch, want_loss, want_g, want_bs = jax_step
    model = _cut_decoder(EncoderDecoder(9, "sigma_test", decoder,
                                        deep_supervision=ds, remat=False))
    model.load_state_dict(state_dict_from_jax(params, model,
                                              batch_stats=stats))
    _no_port_dropout(model)
    opt = build_optimizer(get_config("mfnet"), model)
    step = make_train_step(model, opt, lambda k: 0.0)
    loss = float(step(create_train_state(model, opt), batch))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    want = state_dict_from_jax(want_g)
    # a floor of 1e-7 of the whole gradient's norm: a conv bias ahead of
    # a BatchNorm has a zero gradient in exact arithmetic (the norm
    # removes the mean), and both sides hold rounding noise of 1e-8 there
    floor = 1e-7 * float(torch.cat([g.flatten() for g in want.values()])
                         .norm())
    bad = [(k, float((p.grad - want[k]).norm()), float(want[k].norm()))
           for k, p in model.named_parameters()
           if (p.grad - want[k]).norm() > GRAD_RTOL * want[k].norm() + floor]
    assert not bad, (len(bad), bad[:5])
    if decoder == "UPernet":
        assert any(k.startswith("aux_head.") for k, _ in
                   model.named_parameters())
        want_sd = state_dict_from_jax(params, model, batch_stats=want_bs)
        for k, b in model.named_buffers():
            _close(b, want_sd[k].numpy(), what=k)
    else:
        assert want_bs is None and not list(model.buffers())
        assert any(".output_ds_" in k for k in want)


def test_loss_weights_aux_heads_as_jax(monkeypatch):
    """The port's step sums CE(main) + each DS head's CE, or + aux_rate x
    CE(aux): a model returning known logits shows the weights."""
    from sigma_tpu_torch.models import builder

    terms = []

    class _Fixed(torch.nn.Module):
        aux_rate = 0.4

        def __init__(self, aux):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(()))
            self.aux = aux

        def forward(self, rgb, mx, return_aux=False):
            lo = self.w * torch.zeros(*rgb.shape[:3], 9)
            return lo, self.aux(lo)

    real = builder.segmentation_loss

    def counted(logits, labels, **kw):
        out = real(logits, labels, **kw)
        terms.append(float(out))
        return out

    monkeypatch.setattr("sigma_tpu_torch.engine.train.segmentation_loss",
                        counted)
    batch = _float_batch(5, b=1, h=4, w=4)
    for aux, want in ((lambda lo: [lo, lo, lo], 4.0),
                      (lambda lo: lo, 1.4), (lambda lo: None, 1.0)):
        m = _Fixed(aux)
        opt = torch.optim.SGD(m.parameters(), lr=0.0)
        terms.clear()
        total = float(make_train_step(m, opt, lambda k: 0.0)(
            create_train_state(m, opt), batch))
        np.testing.assert_allclose(total, want * np.log(9), rtol=1e-6)
        assert len(terms) == {4.0: 4, 1.4: 2, 1.0: 1}[want]


# ------------------------------------------------------------ CLIs
@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    """MFNet layout: 4 train, 2 val images of 40x56 (PNG, the port's
    writer)."""
    root = tmp_path_factory.mktemp("mfnet_decoders")
    for sub in ("RGB", "Label", "Modal"):
        (root / sub).mkdir()
    rng = np.random.default_rng(0)
    names = [f"d{i:02d}" for i in range(6)]
    for n in names:
        write_png(root / "RGB" / f"{n}.png",
                  rng.integers(0, 255, (40, 56, 3), dtype=np.uint8))
        write_png(root / "Label" / f"{n}.png",
                  rng.integers(0, 9, (40, 56)).astype(np.uint8))
        write_png(root / "Modal" / f"{n}.png",
                  rng.integers(0, 255, (40, 56), dtype=np.uint8))
    (root / "train2.txt").write_text("\n".join(names[:4]) + "\n")
    (root / "test.txt").write_text("\n".join(names[4:]) + "\n")
    return root


def _cli_lines(fn):
    """fn() with the port's logger recorded: the messages it logged."""
    from sigma_tpu_torch.engine.logger import get_logger

    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = get_logger()
    logger.addHandler(handler)
    try:
        fn()
    finally:
        logger.removeHandler(handler)
    return lines


def _cli_args(tree, log, flags):
    common = ["-n", "mfnet", "--dataset-path", str(tree), "--device",
              "cpu", "--backbone", "sigma_test",
              "--override", "eval_crop_size=(32,32)", *flags]
    train = [*common, "--batch-size", "2", "--log-dir", str(log),
             "--override", "image_height=32", "--override", "image_width=32",
             "--override", "num_workers=1", "--override", "num_train_imgs=2",
             "--override", "checkpoint_start_epoch=1", "--no-eval",
             "--steps", "1"]
    return common, train


def test_upernet_train_cli_resume_then_eval_cli(tiny_tree, tmp_path):
    """`--decoder UPernet`: its running statistics saved, restored by -c
    and read by the eval CLI's -e, from the epochs and from one file (the
    full-model ingest of utils/convert.py)."""
    from sigma_tpu_torch import eval as eval_cli
    from sigma_tpu_torch import train as train_cli

    common, train = _cli_args(tiny_tree, tmp_path, ["--decoder", "UPernet"])
    model_pt = tmp_path / "checkpoint" / "epoch-2" / "model.pt"

    def run():
        assert train_cli.main(train) == 0
        assert train_cli.main([*train, "-c"]) == 0
        assert eval_cli.main([*common, "--log-dir", str(tmp_path),
                              "-e", "1-"]) == 0
        assert eval_cli.main([*common, "-e", str(model_pt)]) == 0

    lines = _cli_lines(run)
    ckpt = tmp_path / "checkpoint"
    sd1 = torch.load(ckpt / "epoch-1" / "model.pt", weights_only=True)
    sd2 = torch.load(model_pt, weights_only=True)
    assert "resumed from epoch 1 (step 1)" in lines
    stats = [k for k in sd1 if k.endswith("running_var")]
    assert any(k.startswith("aux_head.") for k in stats)
    assert len(stats) == 13  # 12 ConvBNReLUs of UPerHead, 1 aux head
    # epoch 2's step moved the statistics that -c restored
    assert all(not torch.equal(sd1[k], sd2[k]) for k in stats)
    scores = [line.rsplit(": mIoU ", 1) for line in lines
              if ": mIoU " in line]
    assert [k for k, _ in scores] == ["epoch-1", "epoch-2", str(model_pt)]
    assert scores[2][1] == scores[1][1]  # its running statistics too
    assert any("sigma full ingest" in line and " 0 fresh-init" in line
               for line in lines)


def test_deep_supervision_on_both_clis(tiny_tree, tmp_path):
    """`--override deep_supervision=True`: the train CLI saves the DS
    heads, which the eval CLI loads (and leaves unused)."""
    from sigma_tpu_torch import eval as eval_cli
    from sigma_tpu_torch import train as train_cli

    common, train = _cli_args(tiny_tree, tmp_path,
                              ["--override", "deep_supervision=True"])

    def run():
        assert train_cli.main(train) == 0
        assert eval_cli.main([*common, "--log-dir", str(tmp_path)]) == 0

    lines = _cli_lines(run)
    sd = torch.load(tmp_path / "checkpoint" / "epoch-1" / "model.pt",
                    weights_only=True)
    assert any(".output_ds_2." in k for k in sd)
    assert any(line.startswith("epoch-1: mIoU ") for line in lines)


def test_no_nondeterministic_or_cuda_only_ops_in_the_port():
    """The decoders' pools and resizes are sums and products (their
    backward deterministic on the card), and BatchNorm is the port's own
    (flax's arithmetic, gloo-capable): no module of the port reaches
    torch's SyncBatchNorm, adaptive average pools or interpolate."""
    import ast
    from pathlib import Path

    import sigma_tpu_torch

    banned = {"SyncBatchNorm", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
              "AdaptiveAvgPool1d", "AdaptiveAvgPool2d", "interpolate",
              "upsample_bilinear"}
    root = Path(sigma_tpu_torch.__file__).parent
    found = [(p.relative_to(root).as_posix(), node.lineno, node.attr)
             for p in sorted(root.rglob("*.py"))
             for node in ast.walk(ast.parse(p.read_text()))
             if isinstance(node, ast.Attribute) and node.attr in banned]
    assert not found, found
