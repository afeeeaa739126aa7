"""The MiT and Swin dual encoders with their FRM / FFM fusion, and the
VSSM classifier, of the PyTorch port against the JAX package, on the CPU.

JAX params are laid out by `jax.eval_shape` (no init is compiled) and
filled from a numpy seed (`fill_seeded`) or with the port's seeded init
(the train steps); they move into the port through `state_dict_from_jax`
(BatchNorm's `batch_stats` too).

  * FRM, FFM and CrossAttention, DualMiTEncoder (embed 8-64, depths 1)
    and DualSwinEncoder (embed 8, depths (1, 2, 1, 1), window 4, at
    36x44: the pads, a shifted block and a shift dropped on a small map
    all run): in train mode the output, the new BatchNorm statistics and
    the gradients of the inputs and of every parameter at the fp32 kernel
    tier (rtol 6e-4, atol 2e-3 of max(|ref|, 1)); each encoder's forward
    in bf16 compute at 5e-2, in JAX's dtype;
  * the train step of a Swin variant at widths 16-128 with MambaDecoder
    (its depths cut to one block a level on both sides, DS_DEPTHS) and of
    mit_b0
    with MLPDecoder (width 32), batch 4 at 64x64 (every BatchNorm sees at
    least 16 values a channel): the loss and every gradient leaf of JAX's
    `make_train_step` within 1e-4 of the leaf's norm plus 1e-7 of the
    whole gradient's, the new running statistics at the fp32 tier;
    dropout and drop path at rate 0 on both sides;
  * VSSMClassifier at depths (1, 1, 1, 1), dims 16-128, d_state 8, 32x32
    (JAX's stages under nn.scan, which the converter unstacks): logits,
    and ingest of a released-style VMamba file with its head;
  * the single Swin trunk's forward, the window helpers, the encoders'
    init families (the JAX package's initializers);
  * the dual-path loaders on synthetic single-trunk files (the same
    loaded / fresh counts and tensors as JAX's `convert_mit_trunk` /
    `convert_swin_dual`), the decay and frozen masks leaf by leaf, Swin's
    attention dropout (one mask per seed, step, module and global
    sample), the errors, and both CLIs with the new backbones.
"""

import logging

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu.models.swin_encoder as jswin
import sigma_tpu.models.vssm as jvssm
from sigma_tpu.engine.optim import decay_mask as jax_decay_mask
from sigma_tpu.engine.optim import frozen_ssm_mask as jax_frozen_mask
from sigma_tpu.engine.train import TrainState as JaxTrainState
from sigma_tpu.engine.train import make_train_step as jax_make_step
from sigma_tpu.models import mit_encoder as jmit
from sigma_tpu.models import net_utils as jnet
from sigma_tpu.models.builder import EncoderDecoder as JaxEncoderDecoder
from sigma_tpu.models.vssm import VSSMClassifier as JaxVSSMClassifier
from sigma_tpu.utils import convert as jconvert
from sigma_tpu_torch.configs import get_config
from sigma_tpu_torch.data.png import write_png
from sigma_tpu_torch.engine.optim import (
    build_optimizer,
    decay_mask,
    frozen_ssm_mask,
)
from sigma_tpu_torch.engine.train import create_train_state, make_train_step
from sigma_tpu_torch.models import mit_encoder as tmit
from sigma_tpu_torch.models import net_utils as tnet
from sigma_tpu_torch.models import swin_encoder as tswin
from sigma_tpu_torch.models.builder import EncoderDecoder, init_parameters
from sigma_tpu_torch.models.common import (
    DropPath,
    Dropout,
    Mlp,
    set_drop_path_seeds,
)
from sigma_tpu_torch.models.norm import BatchNorm
from sigma_tpu_torch.models.vssm import VSSMClassifier
from sigma_tpu_torch.utils import convert
from sigma_tpu_torch.utils.convert import state_dict_from_jax
from _port_load import (  # noqa: F401 (few_torch_threads: a fixture)
    FAST_XLA,
    JAX_SCAN_CHUNK,
    NoDropout,
    NoDropPath,
    cut_decoder,
    cut_jax_decoder,
    few_torch_threads,
    fill_seeded,
    float_batch,
    jax_tree_from_port,
    keep_grads,
)

FP32 = (6e-4, 2e-3)  # rtol, atol of max(|ref|, 1)
BF16 = 5e-2
GRAD_RTOL = 1e-4  # the whole step's gradients, leaf by leaf
# the test Swin variant (sigma_test's widths), added to both packages'
# registries inside a test
SWIN_TEST = dict(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8),
                 window_size=4)
MIT_SMALL = dict(embed_dims=(8, 16, 32, 64), depths=(1, 1, 1, 1),
                 num_heads=(1, 2, 4, 8), drop_path_rate=0.0)
SWIN_SMALL = dict(embed_dim=8, depths=(1, 2, 1, 1), num_heads=(1, 2, 4, 8),
                  window_size=4, attn_drop_rate=0.0, drop_path_rate=0.0)


def _close(got, want, tol=FP32, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1] * scale,
                               err_msg=what)


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.fixture
def swin_test_variant(monkeypatch):
    for registry in (jswin.SWIN_VARIANTS, tswin.SWIN_VARIANTS):
        monkeypatch.setitem(registry, "swin_test", SWIN_TEST)


def _no_port_dropout(model):
    for m in model.modules():
        if isinstance(m, (Dropout, DropPath)):
            m.rate = 0.0
    return model


# ------------------------------------------------------------ modules
def _modules():
    """name: (JAX module of dtype, port module of dtype, its place in an
    EncoderDecoder's JAX tree, input shapes, train keyword)."""
    return {
        "FRM": (lambda dt: jnet.FeatureRectifyModule(16, dtype=dt),
                lambda dt: tnet.FeatureRectifyModule(16, dtype=dt),
                ("backbone", "frm_0"), [(2, 4, 6, 16)] * 2, {}),
        "FFM": (lambda dt: jnet.FeatureFusionModule(16, num_heads=4,
                                                    dtype=dt),
                lambda dt: tnet.FeatureFusionModule(16, num_heads=4,
                                                    dtype=dt),
                ("backbone", "ffm_0"), [(2, 4, 6, 16)] * 2,
                {"deterministic": False}),
        "CrossAttention": (
            lambda dt: jnet.CrossAttention(16, num_heads=4, dtype=dt),
            lambda dt: tnet.CrossAttention(16, num_heads=4, dtype=dt),
            ("backbone", "ffm_0", "cross", "cross_attn"), [(2, 24, 16)] * 2,
            {}),
        "DualMiTEncoder": (
            lambda dt: jmit.DualMiTEncoder(**MIT_SMALL, dtype=dt),
            lambda dt: tmit.DualMiTEncoder(**MIT_SMALL, dtype=dt),
            ("backbone",), [(2, 64, 64, 3)] * 2, {"deterministic": False}),
        "DualSwinEncoder": (
            lambda dt: jswin.DualSwinEncoder(**SWIN_SMALL, dtype=dt),
            lambda dt: tswin.DualSwinEncoder(**SWIN_SMALL, dtype=dt),
            ("backbone",), [(2, 36, 44, 3)] * 2, {"deterministic": False}),
    }


def _wrap(tree, place):
    for key in reversed(place):
        tree = {key: tree}
    return tree


def _prefix(place):
    """The port's key prefix of a module at `place` in the JAX tree."""
    return convert._torch_key("/".join(place) + "/x")[:-1]


def _load(module, place, params, stats=None):
    """Port module <- JAX variables, through the converter's key map at
    the module's place in an EncoderDecoder (strict: every key)."""
    sd = state_dict_from_jax(_wrap(params, place),
                             batch_stats=stats and _wrap(stats, place))
    prefix = _prefix(place)
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    return module


def _variables(jm, shapes, seed):
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *[
        jnp.zeros(s, jnp.float32) for s in shapes])
    params = fill_seeded(v["params"], seed)
    stats = fill_seeded(v["batch_stats"], seed + 1) if "batch_stats" in v \
        else None
    return params, stats


def _apply(jm, params, stats, xs, kw):
    variables = {"params": params}
    if stats is not None:
        variables["batch_stats"] = stats
    return jm.apply(variables, *xs, **kw, mutable=["batch_stats"])


@pytest.mark.parametrize("name", ["FRM", "FFM", "CrossAttention",
                                  "DualMiTEncoder", "DualSwinEncoder"])
def test_module_matches_jax(name):
    """Train mode, fp32: the outputs, the new BatchNorm statistics and the
    gradients of the inputs and of every parameter."""
    make_j, make_t, place, shapes, kw = _modules()[name]
    jm = make_j(jnp.float32)
    params, stats = _variables(jm, shapes, seed=2)
    xs = _inputs(shapes, seed=3)
    outs0, _ = jax.eval_shape(lambda p, *x: _apply(jm, p, stats, x, kw),
                              params, *xs)
    rng = np.random.default_rng(4)
    cots = [rng.standard_normal(o.shape).astype(np.float32)
            for o in jax.tree.leaves(outs0)]

    def loss(p, *x):
        outs, new = _apply(jm, p, stats, x, kw)
        outs = jax.tree.leaves(outs)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), (outs, new)

    (_, (want, new)), grads = jax.jit(
        jax.value_and_grad(loss, argnums=tuple(range(len(xs) + 1)),
                           has_aux=True),
        compiler_options=FAST_XLA)(params, *xs)

    tm = _load(make_t(torch.float32), place, params, stats).train()
    txs = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    outs = tm(*txs)
    got = list(outs) if isinstance(outs, (tuple, list)) else [outs]
    assert len(got) == len(want)
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cots)).backward()
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, what=f"{name} output {i}")
    if stats is not None:
        want_sd = state_dict_from_jax(
            _wrap(params, place),
            batch_stats=_wrap(new["batch_stats"], place))
        bufs = dict(tm.named_buffers())
        assert bufs
        for k, b in bufs.items():
            _close(b, want_sd[_prefix(place) + k].numpy(), what=k)
    for t, g in zip(txs, grads[1:]):
        _close(t.grad, g, what=f"{name} input gradient")
    want_g = state_dict_from_jax(_wrap(jax.tree.map(np.asarray, grads[0]),
                                       place))
    for k, p in tm.named_parameters():
        _close(p.grad, want_g[_prefix(place) + k].numpy(), what=k)


@pytest.mark.parametrize("name", ["DualMiTEncoder", "DualSwinEncoder"])
def test_encoder_bf16_forward_matches_jax(name):
    """bf16 compute (fp32 parameters), train mode: JAX's dtypes, 5e-2."""
    make_j, make_t, place, shapes, kw = _modules()[name]
    jm = make_j(jnp.bfloat16)
    params, stats = _variables(jm, shapes, seed=5)
    xs = _inputs(shapes, seed=6)
    want, _ = jax.jit(lambda p, *x: _apply(jm, p, stats, x, kw),
                      compiler_options=FAST_XLA)(params, *xs)
    tm = _load(make_t(torch.bfloat16), place, params, stats).train()
    with torch.no_grad():
        got = tm(*[torch.from_numpy(x) for x in xs])
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (g.dtype,
                                                             w.dtype)
        _close(g, w, (BF16, BF16), what=f"{name} bf16 output {i}")


def test_swin_window_helpers_match_jax():
    """The relative-position index, the shift masks at the MFNet grids'
    padded stages (126x161 and 21x21 at window 7), the window partition
    and its inverse, and the one-hot bias gather against `table[idx]`."""
    np.testing.assert_array_equal(tswin._relative_position_index(7),
                                  jswin._relative_position_index(7))
    for hp, wp, ws, shift in ((8, 8, 4, 2), (126, 161, 7, 3), (21, 21, 7, 3)):
        np.testing.assert_array_equal(
            tswin._shift_attn_mask(hp, wp, ws, shift),
            jswin._shift_attn_mask(hp, wp, ws, shift))
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 5)).astype(
        np.float32)
    w = tswin.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jswin.window_partition(jnp.asarray(x), 4)))
    assert torch.equal(tswin.window_reverse(w, 4, 2, 8, 12),
                       torch.from_numpy(x))
    table = torch.randn(49, 3, generator=torch.Generator().manual_seed(1))
    idx = torch.from_numpy(tswin._relative_position_index(4).reshape(-1))
    gather = tswin._bias_gather(4, torch.device("cpu"))
    assert gather.shape == (256, 49)
    assert torch.equal(gather @ table, table[idx])


def test_swin_trunk_forward_matches_jax():
    """The single Swin trunk (the released files' layout) at 36x44."""
    jm, tm = jswin.SwinTrunk(**SWIN_SMALL), tswin.SwinTrunk(**SWIN_SMALL)
    (x,) = _inputs([(2, 36, 44, 3)], seed=7)
    params = fill_seeded(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                        jnp.asarray(x))["params"], seed=8)
    want = jax.jit(jm.apply, compiler_options=FAST_XLA)({"params": params},
                                                        jnp.asarray(x))
    _load(tm, ("backbone",), params)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [
        (2, 9, 11, 8), (2, 5, 6, 16), (2, 3, 3, 32), (2, 2, 2, 64)]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, what=f"SwinTrunk output {i}")


@pytest.mark.parametrize("backbone", ["mit_b0", "swin_test"])
def test_init_parameters_gives_the_jax_initializers(backbone,
                                                    swin_test_variant):
    """The encoders' init families, as the JAX package draws them:
    linears trunc_normal(0.02) with zero biases, convolutions normal(0,
    sqrt(2 / fan_out)) with zero biases, Swin's patch conv and bias
    tables trunc_normal(0.02), Swin's MLP torch's U(+-1/sqrt(fan_in))."""
    model = init_parameters(EncoderDecoder(9, backbone, "MLPDecoder"), 0)
    mlp = {id(m) for b in model.backbone.modules()
           if isinstance(b, Mlp) for m in b.modules()}
    seen = set()
    for m in model.backbone.modules():
        w = getattr(m, "weight", None)
        w = None if w is None else w.detach()
        if isinstance(m, torch.nn.Linear) and id(m) in mlp:
            bound = m.in_features ** -0.5
            assert 0 < w.abs().max() <= bound and m.bias.abs().max() > 0
            seen.add("mlp")
        elif isinstance(m, torch.nn.Linear) or (
                isinstance(m, torch.nn.Conv2d) and m.in_channels == 3
                and backbone == "swin_test"):
            assert w.abs().max() <= 0.04 and abs(w.std() - 0.0176) < 0.003
            seen.add("trunc")
        elif isinstance(m, torch.nn.Conv2d) and w.numel() >= 4096:
            kh, kw = m.kernel_size
            std = (2 / (kh * kw * m.out_channels // m.groups)) ** 0.5
            assert abs(float(w.std()) / std - 1) < 0.1, (m, std)
            seen.add("conv")
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)) and \
                m.bias is not None and id(m) not in mlp:
            assert not m.bias.any()
        table = getattr(m, "relative_position_bias_table", None)
        if table is not None:
            assert 0 < table.detach().abs().max() <= 0.04
            seen.add("table")
    assert seen == ({"mlp", "trunc", "conv", "table"} if backbone ==
                    "swin_test" else {"trunc", "conv"})


# ------------------------------------------------------------ dropout
def test_swin_attention_dropout_one_mask_per_seed_step_and_sample():
    """The attention probabilities' mask is drawn with the sample on axis
    0: a split batch (a data-parallel rank's shard) draws each sample's
    mask as the whole batch does; the next step draws anew."""
    attn = tswin.WindowAttention(8, 2, 4, attn_drop=0.5).train()
    init_parameters(attn, seed=0)
    nw = 6
    x = torch.randn(4 * nw, 16, 8, generator=torch.Generator().manual_seed(2))
    mask = torch.from_numpy(tswin._shift_attn_mask(8, 12, 4, 2))
    set_drop_path_seeds(attn, 7, 3, rows=(0, 4, 4))
    y = attn(x, mask, 4)
    assert torch.equal(attn(x, mask, 4), y)
    halves = []
    for r in range(2):
        set_drop_path_seeds(attn, 7, 3, rows=(2 * r, 2, 4))
        halves.append(attn(x[2 * r * nw:(2 * r + 2) * nw], mask, 2))
    torch.testing.assert_close(torch.cat(halves), y, rtol=1e-6, atol=1e-6)
    set_drop_path_seeds(attn, 7, 4, rows=(0, 4, 4))
    assert (attn(x, mask, 4) - y).abs().max() > 0.1


# ------------------------------------------------------------ train step
STEP_CASES = {"swin_test+MambaDecoder": ("swin_test", "MambaDecoder"),
              "mit_b0+MLPDecoder": ("mit_b0", "MLPDecoder")}


@pytest.fixture(scope="module", params=sorted(STEP_CASES))
def jax_step(request):
    """One JAX `make_train_step` (drop path and dropout 0, no remat) from
    the port's seeded weights (BatchNorm's scale, bias and running
    statistics drawn apart, so that the step's update of each shows),
    moved into a tree that jax.eval_shape laid out: (backbone, decoder,
    params, batch_stats, batch, loss, gradients, new batch_stats)."""
    backbone, decoder = STEP_CASES[request.param]
    mp = pytest.MonkeyPatch()
    for registry in (jswin.SWIN_VARIANTS, tswin.SWIN_VARIANTS):
        mp.setitem(registry, "swin_test", SWIN_TEST)
    cut_jax_decoder(mp)
    mp.setattr(fnn, "Dropout", NoDropout)  # Swin's attention dropout
    mp.setattr(jvssm, "DropPath", NoDropPath)  # MambaDecoder's drop path
    try:
        jm = JaxEncoderDecoder(num_classes=9, backbone=backbone,
                               decoder=decoder, decoder_embed_dim=32,
                               drop_path_rate=0.0, remat=False,
                               scan_chunk=JAX_SCAN_CHUNK)
        b = 4
        batch = float_batch(30, b=b, h=64, w=64)
        x = jnp.zeros((b, 64, 64, 3), jnp.float32)
        shapes = jax.eval_shape(
            lambda: jm.init(jax.random.PRNGKey(0), x, x, return_aux=True))
        port = init_parameters(cut_decoder(EncoderDecoder(
            9, backbone, decoder, decoder_embed_dim=32)), seed=31)
        gen = torch.Generator().manual_seed(32)
        with torch.no_grad():
            for m in port.modules():
                if isinstance(m, BatchNorm):
                    n = m.weight.shape[0]
                    m.weight.add_(0.1 * torch.randn(n, generator=gen))
                    m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                    m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                    m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
        params = jax_tree_from_port(shapes["params"], port)
        stats = jax_tree_from_port(shapes["batch_stats"], port, stats=True)
        tx = keep_grads()
        jparams = jax.tree.map(jnp.asarray, params)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                              opt_state=tx.init(jparams), batch_stats=stats)
        step = jax_make_step(jm, tx, donate=False).lower(
            state, batch, jax.random.PRNGKey(1)).compile(
            compiler_options=FAST_XLA)
        new, loss = step(state, batch, jax.random.PRNGKey(1))
    finally:
        mp.undo()
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (backbone, decoder, params, stats, batch, float(loss),
            np_tree(new.opt_state), np_tree(new.batch_stats))


def test_train_step_matches_jax(jax_step, swin_test_variant):
    """The port's step from the same weights, batch statistics and batch:
    the loss, every gradient leaf within GRAD_RTOL of its norm, the new
    running statistics at the fp32 tier."""
    backbone, decoder, params, stats, batch, want_loss, want_g, want_bs = \
        jax_step
    model = cut_decoder(EncoderDecoder(9, backbone, decoder,
                                        decoder_embed_dim=32, remat=False))
    model.load_state_dict(state_dict_from_jax(params, model,
                                              batch_stats=stats))
    _no_port_dropout(model)
    opt = build_optimizer(get_config("mfnet"), model)
    step = make_train_step(model, opt, lambda k: 0.0)
    loss = float(step(create_train_state(model, opt), batch))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    want = state_dict_from_jax(want_g)
    # a floor of 1e-7 of the whole gradient's norm: a conv bias ahead of
    # a BatchNorm has a zero gradient in exact arithmetic
    floor = 1e-7 * float(torch.cat([g.flatten() for g in want.values()])
                         .norm())
    bad = [(k, float((p.grad - want[k]).norm()), float(want[k].norm()))
           for k, p in model.named_parameters()
           if (p.grad - want[k]).norm() > GRAD_RTOL * want[k].norm() + floor]
    assert not bad, (len(bad), bad[:5])
    want_sd = state_dict_from_jax(params, model, batch_stats=want_bs)
    bufs = dict(model.named_buffers())
    assert any(k.startswith("backbone.ffm.3.") for k in bufs)
    for k, b in bufs.items():
        _close(b, want_sd[k].numpy(), what=k)


# ------------------------------------------------------------ classifier
CLS = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), d_state=8,
           drop_path_rate=0.0)


def _released_names(sd, head_prefix):
    """A classifier's state dict under a released VMamba file's names
    (`patch_embed.proj`, `ln_1`, `self_attention`), its head under
    `head_prefix` ("classifier." or the published "")."""
    out = {}
    for k, v in sd.items():
        k = k.replace("patch_embed.0.", "patch_embed.proj.").replace(
            "patch_embed.2.", "patch_embed.norm.").replace(
            ".op.", ".self_attention.")
        if ".blocks." in k and ".norm." in k and "self_attention" not in k:
            k = k.replace(".norm.", ".ln_1.")
        if k.startswith("classifier."):
            k = head_prefix + k[len("classifier."):]
        out[k] = v.clone()
    return out


@pytest.fixture(scope="module")
def classifier_pair():
    """(JAX classifier, its seeded params, the port's with them): JAX
    stacks every stage under nn.scan (scan_min_depth 1)."""
    jm = JaxVSSMClassifier(num_classes=10, **CLS, scan_min_depth=1,
                           scan_chunk=JAX_SCAN_CHUNK)
    x = jnp.zeros((2, 32, 32, 3), jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"]
    assert "layers_0_scan" in shapes and "classifier_head" in shapes
    params = fill_seeded(shapes, seed=40)
    tm = VSSMClassifier(10, **CLS)
    tm.load_state_dict(state_dict_from_jax(params, tm))
    return jm, params, tm.eval()


def test_classifier_logits_match_jax(classifier_pair):
    jm, params, tm = classifier_pair
    (x,) = _inputs([(2, 32, 32, 3)], seed=41)
    want = jax.jit(jm.apply, compiler_options=FAST_XLA)({"params": params},
                                                        jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 10)
    _close(got, want)


@pytest.mark.parametrize("head_prefix", ["classifier.", ""])
def test_classifier_ingests_a_released_vmamba_file_with_its_head(
        classifier_pair, head_prefix):
    """Every tensor of a released-style file lands, the head from
    `classifier.*` or the published `norm.*` / `head.*`, as JAX's
    convert_vmamba_trunk fills the same classifier tree; the
    segmentation model's trunk ingest drops the head."""
    jm, params, tm = classifier_pair
    released = _released_names(tm.state_dict(), head_prefix)
    fresh = init_parameters(VSSMClassifier(10, **CLS), seed=42)
    loaded, missing, unexpected = convert.load_vmamba_into_model(
        fresh, released)
    assert missing == [] and unexpected == []
    for k, v in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    unscanned = JaxVSSMClassifier(num_classes=10, **CLS)
    zeros = jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32),
        jax.eval_shape(unscanned.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 32, 32, 3)))["params"])
    _, jloaded, jmissing = jconvert.convert_vmamba_trunk(
        zeros, {k: v.numpy() for k, v in released.items()})
    assert sorted(jloaded) == sorted(loaded) and jmissing == []
    head = {k: v for k, v in released.items() if "head." in k}
    seg = EncoderDecoder(9, "sigma_test")
    assert convert.load_vmamba_into_model(seg, head)[2] == sorted(head)


# ------------------------------------------------------------ loaders
def test_mit_dualpath_loader_matches_jax():
    """A released single-trunk mit_b0 file (two tensors left out, the
    head kept) into both trunks: JAX's loaded / fresh counts and
    tensors."""
    trunk = init_parameters(tmit.MiTTrunk(
        **tmit.MIT_VARIANTS["mit_b0"], num_heads=(1, 2, 5, 8)), seed=50)
    sd = {k: v.clone() for k, v in trunk.state_dict().items()
          if k not in ("norm4.weight", "block1.0.attn.sr.bias")}
    sd["head.weight"] = torch.zeros(1000, 256)
    model = EncoderDecoder(9, "mit_b0", "MLPDecoder", decoder_embed_dim=32)
    loaded, missing = convert.load_mit_dualpath(model, sd)
    assert sorted(missing) == sorted(
        f"{t}.{k}" for t in ("trunk", "extra_trunk")
        for k in ("norm4.weight", "block1.0.attn.sr.bias"))
    jm = JaxEncoderDecoder(num_classes=9, backbone="mit_b0",
                           decoder="MLPDecoder", decoder_embed_dim=32)
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, x)["params"]
    np_sd = {k: v.numpy() for k, v in sd.items()}
    jloaded, jmissing, filled = [], 0, {}
    for name in ("trunk", "extra_trunk"):
        zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                             shapes["backbone"][name])
        filled[name], got, fresh = jconvert.convert_mit_trunk(zeros, np_sd)
        jloaded += got
        jmissing += len(fresh)
    assert sorted(jloaded) == sorted(loaded) and jmissing == len(missing)
    want = state_dict_from_jax({"backbone": filled})
    mine = model.state_dict()
    for k, v in want.items():
        if k.split(".", 2)[2] in sd:
            assert torch.equal(mine[k], v), k


def test_swin_dualpath_loader_matches_jax():
    """A released single-trunk Swin file (with its bias-table indices,
    final norm and head) into both modality paths: JAX's loaded count,
    fresh count over the parameters (FRM, FFM and the out-norms) and
    tensors."""
    kw = dict(embed_dim=8, depths=(1, 2, 1, 1), num_heads=(1, 2, 4, 8),
              window_size=4)
    trunk = init_parameters(tswin.SwinTrunk(**kw), seed=51)
    sd = {k: v.clone() for k, v in trunk.state_dict().items()}
    sd["layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(16, 16)
    sd["norm.weight"] = torch.ones(64)
    sd["head.weight"] = torch.zeros(1000, 64)
    enc = tswin.DualSwinEncoder(**kw)
    loaded, missing = convert.convert_swin_dual(enc, sd)
    params = dict(enc.named_parameters())
    missing_params = [k for k in missing if k in params]
    assert all(k.startswith(("frm.", "ffm.", "norm")) for k in missing)
    jenc = jswin.DualSwinEncoder(**kw)
    x = jnp.zeros((1, 32, 32, 3))
    zeros = jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32),
        jax.eval_shape(jenc.init, jax.random.PRNGKey(0), x, x)["params"])
    new, jloaded, jmissing = jconvert.convert_swin_dual(
        zeros, {k: v.numpy() for k, v in sd.items()})
    assert sorted(jloaded) == sorted(loaded)
    assert len(jmissing) == len(missing_params)
    want = state_dict_from_jax({"backbone": new})
    mine = enc.state_dict()
    for k, v in want.items():
        key = k[len("backbone."):]
        if key not in missing:
            assert torch.equal(mine[key], v), key


# ------------------------------------------------------------ masks
def _mask_sd(mask_tree, params, stats, model):
    """A JAX mask tree as {port parameter name: bool}, through the
    bridge."""
    filled = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32),
                          mask_tree, params)
    sd = state_dict_from_jax(filled, model, batch_stats=stats)
    out = {}
    for k, _ in model.named_parameters():
        assert sd[k].min() == sd[k].max(), k
        out[k] = bool(sd[k].max())
    return out


@pytest.mark.parametrize("backbone,decoder", [("mit_b0", "MLPDecoder"),
                                              ("swin_test", "MambaDecoder"),
                                              ("classifier", None)])
def test_masks_equal_jax_leaf_for_leaf(backbone, decoder, swin_test_variant):
    """decay_mask / frozen_ssm_mask of the port against JAX's on the same
    tree: Swin's 2-D relative_position_bias_table does not decay."""
    x = jnp.zeros((1, 64, 64, 3))
    if backbone == "classifier":
        jm = JaxVSSMClassifier(num_classes=10, **CLS)
        model = VSSMClassifier(10, **CLS)
        init = lambda: jm.init(jax.random.PRNGKey(0), x)  # noqa: E731
    else:
        jm = JaxEncoderDecoder(num_classes=9, backbone=backbone,
                               decoder=decoder, decoder_embed_dim=32)
        model = EncoderDecoder(9, backbone, decoder, decoder_embed_dim=32)
        init = lambda: jm.init(jax.random.PRNGKey(0), x, x)  # noqa: E731
    params, stats = (
        jax.tree.map(lambda a: np.zeros(a.shape, np.float32), tree)
        for tree in (lambda v: (v["params"], v.get("batch_stats")))(
            jax.eval_shape(init)))
    for port_fn, jax_fn in ((decay_mask, jax_decay_mask),
                            (frozen_ssm_mask, jax_frozen_mask)):
        want = _mask_sd(jax_fn(params), params, stats, model)
        got = port_fn(model)
        assert set(got) == set(want)
        diff = sorted(k for k in got if got[k] != want[k])
        assert not diff, diff
    tables = [k for k in decay_mask(model) if "bias_table" in k]
    assert (backbone == "swin_test") == bool(tables)
    assert not any(decay_mask(model)[k] for k in tables)


# ------------------------------------------------------------ errors, CLIs
@pytest.mark.parametrize("backbone", ["mit_b0", "swin_s"])
def test_pretrained_with_mit_or_swin_raises(backbone, tmp_path):
    """JAX's trainer sends --pretrained to the VMamba ingest only; the
    port's says which loader takes a MiT or Swin file."""
    from sigma_tpu_torch import train as train_cli

    with pytest.raises(ValueError, match="load_mit_dualpath.*"
                                         "load_swin_dualpath"):
        train_cli.main(["-n", "mfnet", "--dataset-path", str(tmp_path),
                        "--device", "cpu", "--backbone", backbone,
                        "--pretrained", str(tmp_path / "trunk.pth")])


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    """MFNet layout: 2 train, 2 val images of 40x56 (PNG, the port's
    writer)."""
    root = tmp_path_factory.mktemp("mfnet_backbones")
    for sub in ("RGB", "Label", "Modal"):
        (root / sub).mkdir()
    rng = np.random.default_rng(0)
    names = [f"b{i:02d}" for i in range(4)]
    for n in names:
        write_png(root / "RGB" / f"{n}.png",
                  rng.integers(0, 255, (40, 56, 3), dtype=np.uint8))
        write_png(root / "Label" / f"{n}.png",
                  rng.integers(0, 9, (40, 56)).astype(np.uint8))
        write_png(root / "Modal" / f"{n}.png",
                  rng.integers(0, 255, (40, 56), dtype=np.uint8))
    (root / "train2.txt").write_text("\n".join(names[:2]) + "\n")
    (root / "test.txt").write_text("\n".join(names[2:]) + "\n")
    return root


@pytest.mark.parametrize("backbone,decoder", [("mit_b0", "MLPDecoder"),
                                              ("swin_test", "MambaDecoder")])
def test_clis_run_the_new_backbones(backbone, decoder, tiny_tree, tmp_path,
                                    swin_test_variant):
    """`--override backbone=...` on the train CLI (one step, a
    checkpoint) and the eval CLI (`-e last`)."""
    from sigma_tpu_torch import eval as eval_cli
    from sigma_tpu_torch import train as train_cli
    from sigma_tpu_torch.engine.logger import get_logger

    common = ["-n", "mfnet", "--dataset-path", str(tiny_tree), "--device",
              "cpu", "--decoder", decoder, "--override",
              f"backbone={backbone}", "--override", "decoder_embed_dim=32",
              "--override", "eval_crop_size=(32,32)", "--log-dir",
              str(tmp_path)]
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    get_logger().addHandler(handler)
    try:
        assert train_cli.main([
            *common, "--batch-size", "2", "--steps", "1", "--no-eval",
            "--override", "image_height=32", "--override", "image_width=32",
            "--override", "num_workers=1", "--override",
            "num_train_imgs=2", "--override", "checkpoint_start_epoch=1"]
        ) == 0
        assert eval_cli.main(common) == 0
    finally:
        get_logger().removeHandler(handler)
    sd = torch.load(tmp_path / "checkpoint" / "epoch-1" / "model.pt",
                    weights_only=True)
    assert any(k.startswith("backbone.ffm.3.") for k in sd)
    assert any(line.startswith("epoch-1: mIoU ") for line in lines), lines
