"""Train path of the PyTorch port against the JAX package, on the CPU.

  * `segmentation_loss`, including a batch whose pixels are all ignored;
  * `warmup_poly_lr` step by step, and optax's count convention in the
    train step (the update with 0-based index k uses schedule(k));
  * the decay and frozen-SSM masks leaf for leaf through the weight
    bridge's key map, and AdamW / SGDM updates against optax;
  * two steps of `make_train_step` on a sigma_test model (MambaDecoder
    cut to one block a level on both sides) against JAX
    `make_train_step` from the same weights and uint8 batch, at the golden
    portable tier (tests/test_golden_logits.py): max|diff| < 3e-2 and
    mean|diff| < 3e-3 on the post-update parameters, with the SS2D
    epilogue unfused and fused;
  * remat and DropPath: a rematerialized step draws the same masks;
  * `python -m sigma_tpu_torch.train` end to end (its main, in this
    process) on a synthetic tree, its epoch checkpoint read by `python -m
    sigma_tpu_torch.eval -e last`, with the SS2D epilogue unfused and fused
    (the switch SIGMA_FUSED_EPILOGUE sets).
"""

import json
import logging

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

import sigma_tpu.models.vssm as jvssm
from configs import get_config as jax_get_config
from sigma_tpu.engine.optim import build_optimizer as jax_build_optimizer
from sigma_tpu.engine.optim import decay_mask as jax_decay_mask
from sigma_tpu.engine.optim import frozen_ssm_mask as jax_frozen_mask
from sigma_tpu.engine.train import TrainState as JaxTrainState
from sigma_tpu.engine.train import make_train_step as jax_make_step
from sigma_tpu.models.builder import EncoderDecoder as JaxEncoderDecoder
from sigma_tpu.models.builder import segmentation_loss as jax_loss
from sigma_tpu.utils.convert import convert_sigma_full
from sigma_tpu.utils.lr_schedule import warmup_poly_lr as jax_warmup_poly
from sigma_tpu_torch.configs import get_config
from sigma_tpu_torch.engine.optim import (
    build_optimizer,
    decay_mask,
    frozen_ssm_mask,
)
from sigma_tpu_torch.engine.train import create_train_state, make_train_step
from sigma_tpu_torch.models.builder import (
    EncoderDecoder,
    init_parameters,
    segmentation_loss,
)
from sigma_tpu_torch.models.common import DropPath, set_drop_path_seeds
from sigma_tpu_torch.models.ss2d import set_fused_epilogue
from sigma_tpu_torch.ops import merge_ln_gate as mlg
from sigma_tpu_torch.models.vssm import VSSBlock
from sigma_tpu_torch.utils.convert import state_dict_from_jax
from sigma_tpu_torch.utils.lr_schedule import warmup_poly_lr
from _port_load import FAST_XLA, JAX_SCAN_CHUNK, cut_decoder, cut_jax_decoder

# torch's CPU threads per test process: the suite runs several processes
# on the host's cores, and torch's default (one thread per core) in each
# oversubscribes them
TORCH_THREADS = 2
# gradients, port against JAX, leaf by leaf: |g - g_ref| <= GRAD_RTOL |g_ref|
# (2.4e-6 is the worst leaf measured on the CPU, fp32)
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


def _uint8_batch(seed, b=2, h=32, w=32):
    rng = np.random.default_rng(seed)
    label = rng.integers(0, 9, (b, h, w)).astype(np.uint8)
    label[:, :2] = 255
    return dict(
        data=rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
        modal_x=rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
        label=label,
        margins=np.array([[3, 1, 0, 2], [0, 0, 4, 1]][:b], np.int32))


# ------------------------------------------------------------ loss
def test_segmentation_loss_matches_jax_and_all_ignored_is_zero():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 6, 7, 9)).astype(np.float32) * 3
    labels = rng.integers(0, 9, (2, 6, 7)).astype(np.int32)
    labels[0, :3] = 255
    got = segmentation_loss(torch.from_numpy(logits),
                            torch.from_numpy(labels))
    want = jax_loss(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    ignored = np.full_like(labels, 255)
    t = torch.from_numpy(logits).requires_grad_(True)
    zero = segmentation_loss(t, torch.from_numpy(ignored))
    zero.backward()
    assert float(zero) == 0.0 == float(
        jax_loss(jnp.asarray(logits), jnp.asarray(ignored)))
    assert torch.isfinite(t.grad).all() and not t.grad.any()


# ------------------------------------------------------------ schedule
def test_warmup_poly_lr_matches_jax_at_every_step():
    port = warmup_poly_lr(6e-5, 0.9, 50, 10)
    ref = jax_warmup_poly(6e-5, 0.9, 50, 10)
    steps = list(range(0, 55))
    got = np.array([port(k) for k in steps])
    want = np.array([float(ref(k)) for k in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert got[0] == 0.0 and got[10] == pytest.approx(6e-5 * 0.8 ** 0.9)


class _PixelLinear(torch.nn.Module):
    """(rgb, modal_x) -> per-pixel logits, and no aux head: a model small
    enough to test the step's bookkeeping."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(6, 9)

    def forward(self, rgb, mx, return_aux=False):
        logits = self.proj(torch.cat([rgb, mx], -1))
        return (logits, None) if return_aux else logits


def test_update_k_uses_schedule_k():
    """optax's count convention: the first update (k = 0) uses schedule(0),
    which is 0 in warmup, so it leaves the weights unchanged; a LambdaLR
    stepped after each update would use schedule(1) there."""
    cfg = get_config("mfnet", weight_decay=0.01)
    model = _PixelLinear()
    opt = build_optimizer(cfg, model)
    state = create_train_state(model, opt)
    sched = warmup_poly_lr(1e-2, 0.9, 100, 4)
    step = make_train_step(model, opt, sched)
    batch = _uint8_batch(1, h=8, w=8)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    seen = []
    for k in range(3):
        step(state, batch)
        seen.append(opt.param_groups[0]["lr"])
        if k == 0:
            for name, v in model.state_dict().items():
                assert torch.equal(v, before[name]), name
    assert seen == [sched(0), sched(1), sched(2)] and seen[0] == 0.0
    assert state.step == 3
    assert not torch.equal(model.proj.weight, before["proj.weight"])


# ------------------------------------------------------------ optimizer
@pytest.fixture(scope="module")
def jax_test_model():
    """A JAX sigma_test (no remat: the comparison is of the math, and a
    remat step takes XLA minutes more to compile on the CPU) holding the
    port's seeded weights, moved across by the JAX package's converter
    into a tree that jax.eval_shape laid out (no init is compiled)."""
    jm = JaxEncoderDecoder(num_classes=9, backbone="sigma_test",
                           drop_path_rate=0.0, remat=False,
                           scan_chunk=JAX_SCAN_CHUNK)
    x = jnp.zeros((2, 32, 32, 3), jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(3), x, x)["params"]
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    port = init_parameters(EncoderDecoder(9, "sigma_test"), seed=3)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, _, missing = convert_sigma_full(zeros, sd)
    assert missing == []
    return jm, jax.tree.map(np.asarray, params)


def _mask_sd(mask_tree, params, model):
    """A JAX mask tree as {port key: bool}, through the bridge."""
    filled = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32),
                          mask_tree, params)
    sd = state_dict_from_jax(filled, model)
    out = {}
    for k, v in sd.items():
        assert v.min() == v.max(), k
        out[k] = bool(v.max())
    return out


def test_masks_equal_jax_leaf_for_leaf(jax_test_model):
    _, params = jax_test_model
    model = EncoderDecoder(9, "sigma_test")
    for port_fn, jax_fn in ((decay_mask, jax_decay_mask),
                            (frozen_ssm_mask, jax_frozen_mask)):
        want = _mask_sd(jax_fn(params), params, model)
        got = port_fn(model)
        assert set(got) == set(want)
        diff = sorted(k for k in got if got[k] != want[k])
        assert not diff, diff
    assert any(decay_mask(model).values())
    assert any(frozen_ssm_mask(model).values())


@pytest.mark.parametrize("optimizer", ["AdamW", "SGDM"])
def test_optimizer_updates_match_optax(optimizer):
    """Two updates of a Linear (kernel decays, bias does not) with grads
    from a seed: the port's optimizer at lr schedule(k) against optax's."""
    cfg = get_config("mfnet", optimizer=optimizer, weight_decay=0.05)
    rng = np.random.default_rng(4)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    grads = [(rng.standard_normal((4, 3)).astype(np.float32),
              rng.standard_normal(4).astype(np.float32)) for _ in range(2)]
    sched = warmup_poly_lr(0.1, 0.9, 10, 0)

    lin = torch.nn.Linear(3, 4)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))
    opt = build_optimizer(cfg, lin)
    for k, (gw, gb) in enumerate(grads):
        for group in opt.param_groups:
            group["lr"] = sched(k)
        lin.weight.grad = torch.from_numpy(gw)
        lin.bias.grad = torch.from_numpy(gb)
        opt.step()

    params = {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)}
    tx = jax_build_optimizer(jax_get_config("mfnet", optimizer=optimizer,
                                            weight_decay=0.05),
                             jax_warmup_poly(0.1, 0.9, 10, 0), params)
    opt_state = tx.init(params)
    for gw, gb in grads:
        upd, opt_state = tx.update(
            {"kernel": jnp.asarray(gw.T), "bias": jnp.asarray(gb)},
            opt_state, params)
        params = optax.apply_updates(params, upd)
    np.testing.assert_allclose(lin.weight.detach().numpy(),
                               np.asarray(params["kernel"]).T, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lin.bias.detach().numpy(),
                               np.asarray(params["bias"]), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------ train step
class _NoDropPath(fnn.Module):
    """Identity in place of the JAX DropPath (the decoder's rate is 0.1
    and not a constructor option there), so both sides run drop path 0."""

    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, deterministic: bool = True):
        return x


def _first_moments(opt, model):
    """{param name: AdamW's exp_avg} (zeros for a tensor with no state)."""
    return {k: opt.state[p]["exp_avg"].clone() if p in opt.state
            else torch.zeros_like(p) for k, p in model.named_parameters()}


_TRAIN_BATCHES = (10, 11)


def _first_blocks(params):
    """JAX sigma_test params with MambaDecoder cut to its first block a
    level (`_port_load.DS_DEPTHS`)."""
    head = {k: {b: v for b, v in level.items()
                if not (b.startswith("blocks_") and b != "blocks_0")}
            if k.startswith("layers_up_") else level
            for k, level in params["decode_head"].items()}
    return {**params, "decode_head": head}


@pytest.fixture(scope="module")
def jax_train_run(jax_test_model):
    """Two JAX `make_train_step` updates of the sigma_test model, its
    MambaDecoder cut to one block a level (`cut_decoder` on the port's
    side: the JAX step then compiles in about two thirds of the time), drop
    path 0, warmup of one update, so lr(0) = 0 and lr(1) != 0, compiled
    once for every variant of the port's step: (the params it starts from,
    losses, AdamW's first moment after each update, the final params)."""
    jm, full = jax_test_model
    params = _first_blocks(full)
    cfg = get_config("mfnet", backbone="sigma_test")
    jcfg = jax_get_config("mfnet", backbone="sigma_test")
    sched_j = jax_warmup_poly(1e-3, 0.9, 100, 1)
    tx = jax_build_optimizer(jcfg, sched_j, params)
    jparams = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                          opt_state=tx.init(jparams))
    losses, mus = [], []
    with pytest.MonkeyPatch.context() as mp:
        cut_jax_decoder(mp)
        mp.setattr(jvssm, "DropPath", _NoDropPath)
        jstep = jax_make_step(jm, tx, donate=False, norm_mean=cfg.norm_mean,
                              norm_std=cfg.norm_std).lower(
            state, _uint8_batch(0), jax.random.PRNGKey(1)).compile(
            compiler_options=FAST_XLA)
        for seed in _TRAIN_BATCHES:
            state, loss = jstep(state, _uint8_batch(seed),
                                jax.random.PRNGKey(1))
            losses.append(float(loss))
            mus.append(jax.tree.map(np.asarray, state.opt_state[0].mu))
    return params, losses, mus, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("fused_epilogue", [False, True],
                         ids=["unfused", "fused_epilogue"])
def test_train_steps_match_jax(jax_train_run, fused_epilogue, monkeypatch):
    """The golden-tier check of losses and weights cannot see the
    gradient: update 0 runs at lr 0, and AdamW's update 1 is about lr per
    element for any gradient. So the gradients are compared as well,
    through AdamW's first moment, which after update k holds
    sum_j 0.1 * 0.9^(k-j) * g_j on both sides: leaf by leaf, within
    GRAD_RTOL of the leaf's norm. With `fused_epilogue` every SS2D takes
    the fused epilogue (its CPU route: the plain forward and the explicit
    backward formula); the JAX step's CPU route is unfused."""
    backwards = [0]
    bwd_plain = mlg.merge_ln_gate_bwd_plain

    def counted_bwd(*a):
        backwards[0] += 1
        return bwd_plain(*a)

    monkeypatch.setattr(mlg, "merge_ln_gate_bwd_plain", counted_bwd)
    params, want_losses, want_mu, want_params = jax_train_run
    cfg = get_config("mfnet", backbone="sigma_test")

    model = cut_decoder(EncoderDecoder(9, "sigma_test", remat=False))
    model.load_state_dict(state_dict_from_jax(params, model))
    set_fused_epilogue(model, fused_epilogue)
    for m in model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    opt = build_optimizer(cfg, model)
    tstate = create_train_state(model, opt)
    step = make_train_step(model, opt, warmup_poly_lr(1e-3, 0.9, 100, 1),
                           cfg.norm_mean, cfg.norm_std)
    got_losses, got_mu = [], []
    for seed in _TRAIN_BATCHES:
        got_losses.append(float(step(tstate, _uint8_batch(seed))))
        got_mu.append(_first_moments(opt, model))
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-3)
    # the explicit backward ran for each of the 8 SS2Ds (sigma_test's 5
    # trunk blocks, the cut decoder's 3), twice
    assert backwards == [16 if fused_epilogue else 0]

    for k, (got_k, want_tree) in enumerate(zip(got_mu, want_mu)):
        want_k = state_dict_from_jax(want_tree, model)
        bad = [(name, float((g - want_k[name]).norm()),
                float(want_k[name].norm())) for name, g in got_k.items()
               if (g - want_k[name]).norm() > GRAD_RTOL * want_k[name].norm()]
        assert not bad, (k, bad[:5])

    want = state_dict_from_jax(want_params, model)
    got = model.state_dict()
    diff = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
    assert diff.max() < 3e-2, diff.max()
    assert diff.mean() < 3e-3, diff.mean()
    moved = torch.cat([(got[k] - torch.from_numpy(np.asarray(v)).flatten()
                        .reshape(got[k].shape)).abs().flatten()
                       for k, v in state_dict_from_jax(params).items()])
    assert moved.max() > 1e-4  # the second update did move the weights


def test_remat_redraws_the_same_drop_path_masks():
    """DropPath active (sigma_test's 0.1 trunk and decoder rates): a step
    with every block rematerialized gives the loss and weights of a step
    without remat, so the recomputed forwards drew the same masks."""
    cfg = get_config("mfnet")
    batch = _uint8_batch(12)
    out = []
    for remat in (True, False):
        m = init_parameters(EncoderDecoder(9, "sigma_test", remat=remat), 3)
        opt = build_optimizer(cfg, m)
        state = create_train_state(m, opt)
        step = make_train_step(m, opt, warmup_poly_lr(1e-3, 0.9, 100, 0),
                               dropout_seed=5)
        losses = [float(step(state, batch)) for _ in range(2)]
        out.append((losses, m.state_dict()))
    (l_r, sd_r), (l_n, sd_n) = out
    assert l_r == l_n
    for k in sd_r:
        assert torch.equal(sd_r[k], sd_n[k]), k


class _Ones(torch.nn.Module):
    def forward(self, x):
        return torch.ones_like(x)


def test_vss_block_branches_draw_their_own_masks():
    """With the FFN branch on, VSSBlock's SS2D and MLP branches drop
    paths with masks of their own, as the JAX block's two DropPaths do:
    each branch adds 1 / keep or 0 per sample, and some sample gets one
    branch without the other."""
    block = VSSBlock(16, drop_path=0.5, d_state=4, mlp_ratio=2.0)
    block.op, block.mlp = _Ones(), _Ones()
    set_drop_path_seeds(block, 1, 0, rows=(0, 64, 64))
    y = block.train()(torch.zeros(64, 2, 2, 16))[:, 0, 0, 0]
    assert set(y.tolist()) == {0.0, 2.0, 4.0}


def test_train_step_refuses_a_mesh():
    """Data parallel, the step takes a torch.distributed process group
    (`group`, tests/test_torch_port_ddp.py), not a JAX mesh."""
    model = _PixelLinear()
    opt = build_optimizer(get_config("mfnet"), model)
    with pytest.raises(TypeError, match="mesh"):
        make_train_step(model, opt, lambda k: 0.0, mesh=object())


# ------------------------------------------------------------ CLI
@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    """Synthetic MFNet layout on disk: 4 train, 2 val images, 40x56."""
    root = tmp_path_factory.mktemp("mfnet_train")
    for sub in ("RGB", "Label", "Modal"):
        (root / sub).mkdir()
    rng = np.random.default_rng(0)
    names = [f"t{i:02d}" for i in range(6)]
    for n in names:
        cv2.imwrite(str(root / "RGB" / f"{n}.png"),
                    rng.integers(0, 255, (40, 56, 3), dtype=np.uint8))
        cv2.imwrite(str(root / "Label" / f"{n}.png"),
                    rng.integers(0, 9, (40, 56)).astype(np.uint8))
        cv2.imwrite(str(root / "Modal" / f"{n}.png"),
                    rng.integers(0, 255, (40, 56), dtype=np.uint8))
    (root / "train2.txt").write_text("\n".join(names[:4]) + "\n")
    (root / "test.txt").write_text("\n".join(names[4:]) + "\n")
    return root


@pytest.mark.parametrize("fused", [False, True],
                         ids=["unfused", "fused_epilogue"])
def test_train_cli_then_eval_cli(tiny_tree, tmp_path, fused, monkeypatch,
                                 capsys):
    """Both CLIs' mains in this process, with the SS2D epilogue switch off
    and on: `ss2d.FUSED_EPILOGUE`, which SIGMA_FUSED_EPILOGUE sets at
    import, as in the JAX package (test_torch_port_epilogue.py holds the
    env var). With the switch on, the train CLI also takes `--profile`,
    its window moved to start before the second step, so that the end of
    the run stops it: a Chrome trace of the train step's ops and the log
    line."""
    from sigma_tpu_torch import eval as eval_cli
    from sigma_tpu_torch import train as train_cli
    from sigma_tpu_torch.engine.logger import get_logger
    from sigma_tpu_torch.models import ss2d

    monkeypatch.setattr(ss2d, "FUSED_EPILOGUE", fused)
    monkeypatch.setattr(train_cli.ProfileWindow, "START", 1)
    prof = tmp_path / "prof"
    profile = ["--profile", str(prof)] if fused else []
    common = ["-n", "mfnet", "--dataset-path", str(tiny_tree), "--device",
              "cpu", "--backbone", "sigma_test",
              "--override", "eval_crop_size=(32,32)"]
    log = tmp_path / "log"
    epilogue = f"SS2D epilogue: {'fused' if fused else 'unfused'} " \
        "(SIGMA_FUSED_EPILOGUE)"
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = get_logger()  # configured before the handler joins it
    logger.addHandler(handler)
    try:
        assert train_cli.main([*common, *profile, "--steps", "2",
                               "--batch-size", "2", "--log-dir", str(log),
                               "--override", "image_height=32",
                               "--override", "image_width=32",
                               "--override", "num_workers=1"]) == 0
        train_log, lines[:] = list(lines), []
        assert eval_cli.main([*common, "--log-dir", str(log),
                              "-e", "last"]) == 0
    finally:
        logger.removeHandler(handler)
    assert "training finished (2 steps)" in train_log
    assert any(" mIoU " in line for line in train_log)  # train-time eval
    assert epilogue in train_log and epilogue in lines
    assert (log / "checkpoint" / "epoch-1" / "model.pt").exists()
    assert "mean IoU" in capsys.readouterr().out
    assert any(line.startswith("epoch-1: mIoU ") for line in lines)
    written = f"profiler trace written to {prof}"
    assert (written in train_log) == fused
    if fused:
        events = json.loads((prof / "trace_rank0.json").read_text())[
            "traceEvents"]
        names = {e.get("name") for e in events}
        assert "aten::mm" in names and "aten::convolution" in names


@pytest.mark.parametrize("flag,item", [
    (["--backbone", "mit_b0", "--pretrained", "x"], "Sigma backbone"),
    (["--distributed"], "torchrun's environment")])
def test_train_cli_refuses_what_is_not_ported(flag, item):
    """`--pretrained` loads a VMamba trunk, so it takes a Sigma backbone
    only (MiT and Swin have their own loaders); `--distributed` runs only
    under torchrun (tests/test_torch_port_ddp.py)."""
    from sigma_tpu_torch.train import main

    error = ValueError if "--pretrained" in flag else RuntimeError
    with pytest.raises(error, match=item):
        main(["-n", "mfnet", "--device", "cpu", *flag])


def _trace_steps(path):
    """The `step<n>` spans of a Chrome trace file."""
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(int(e["name"][4:]) for e in events
                  if e.get("name", "").startswith("step")
                  and e["name"][4:].isdigit())


@pytest.mark.parametrize("steps", [35, 25])
def test_profile_window_spans_steps_20_to_29(tmp_path, steps):
    """The trainer's `--profile` window, driven as its epoch loop drives
    it: started before step 20, stopped before step 30 (35 steps) or at
    the end of the epoch (25), the trace written as trace_rank0.json and
    the JAX trainer's log line."""
    from sigma_tpu_torch.train import ProfileWindow

    lines = []
    logger = logging.getLogger("profile-window-test")
    logger.setLevel(logging.INFO)
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger.addHandler(handler)
    window = ProfileWindow(str(tmp_path / "prof"), torch.device("cpu"),
                           logger)
    x = torch.ones(4, 4)
    for n in range(steps):
        window.before_step(n)
        with torch.profiler.record_function(f"step{n}"):
            x = x @ x / 4
    window.end()
    logger.removeHandler(handler)
    assert _trace_steps(tmp_path / "prof" / "trace_rank0.json") == list(
        range(20, min(steps, 30)))
    assert lines == [f"profiler trace written to {tmp_path / 'prof'}"]
