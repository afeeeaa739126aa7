"""bf16 compute in the PyTorch port against the JAX package, on the CPU.

The JAX package computes in bf16 per layer when `cfg.bf16` is set: each
Dense / Conv casts its input and kernel to bf16, every LayerNorm promotes
to fp32, the scans take bf16 io with fp32 state, the head returns bf16
logits and the loss runs in fp32. The port holds the same policy on its
layers (`sigma_tpu_torch/models/common.py`). Here the same seeded numpy
inputs and the JAX modules' weights (carried by `state_dict_from_jax`) go
through both, sigma_test widths:

  * every module with a compute dtype, JAX with `dtype=bfloat16`: the
    outputs' dtypes equal JAX's and their values lie within the bf16 tier,
    5e-2 of max(|ref|, 1);
  * the layers' policy itself (fp32 parameters and gradients, LayerNorm's
    promotion, DropPath's dtype);
  * the train CLI with `--bf16` and the eval CLI with `--override
    bf16=True`.
The whole model is in `test_torch_port_bf16_model.py`, the train step in
`test_torch_port_bf16_train.py` (each file compiles its own JAX model,
and the suite runs files on separate workers). JAX takes its portable CPU
path, the port the plain versions of its scan entry points (CPU tensors).
"""

import logging

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu.models.vssm as jvssm
from sigma_tpu.models import common as jcommon
from sigma_tpu.models import fusion as jfusion
from sigma_tpu.models import sigma_encoder as jencoder
from sigma_tpu.models import ss2d as jss2d
from sigma_tpu.models.decoders import mamba_decoder as jdecoder
from sigma_tpu_torch.models import common as tcommon
from sigma_tpu_torch.models import fusion as tfusion
from sigma_tpu_torch.models import sigma_encoder as tencoder
from sigma_tpu_torch.models import ss2d as tss2d
from sigma_tpu_torch.models import vssm as tvssm
from sigma_tpu_torch.models.decoders import mamba_decoder as tdecoder
from sigma_tpu_torch.utils.convert import state_dict_from_jax
from _port_load import FAST_XLA

TORCH_THREADS = 2
BF16_TOL = 5e-2
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


def _inputs(n, shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _port_dtype(x):
    return {"bfloat16": BF16, "float32": torch.float32}[str(x.dtype)]


def _close_bf16(got, want):
    """got (torch) against want (JAX): the same dtype, values within 5e-2
    of max(|want|, 1)."""
    assert got.dtype == _port_dtype(want), (got.dtype, want.dtype)
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    scale = max(float(np.abs(w).max()), 1.0)
    np.testing.assert_allclose(g / scale, w / scale, rtol=BF16_TOL,
                               atol=BF16_TOL)


def _load(module, params, wrap, strip):
    """Port module <- JAX module params, through the converter's key map:
    the params are nested under `wrap` (the context its rules expect) and
    `strip` is cut from the port keys."""
    tree = jax.tree.map(np.asarray, params)
    for key in reversed(wrap):
        tree = {key: tree}
    sd = state_dict_from_jax(tree)
    module.load_state_dict({k[len(strip):]: v for k, v in sd.items()})
    return module.eval()


# ------------------------------------------------------------ modules
def _jax_run(jm, xs, **kw):
    xs = [jnp.asarray(x) for x in xs]
    params = jax.jit(jm.init, compiler_options=FAST_XLA)(
        jax.random.PRNGKey(0), *xs, **kw)["params"]
    return params, jax.jit(lambda p, *a: jm.apply({"params": p}, *a, **kw),
                           compiler_options=FAST_XLA)(params, *xs)


# name: (JAX module, port module, input shapes, JAX -> port key map)
MODULES = {
    "Mlp": (lambda: jcommon.Mlp(24, 16, dtype=jnp.bfloat16),
            lambda: tcommon.Mlp(16, 24, 16, dtype=BF16),
            [(2, 5, 6, 16)], (["m"], "m.")),
    "PatchEmbed": (lambda: jvssm.PatchEmbed(16, dtype=jnp.bfloat16),
                   lambda: tvssm.PatchEmbed(3, 16, dtype=BF16),
                   [(2, 16, 20, 3)], (["patch_embed"], "patch_embed.")),
    "PatchMerging2D": (
        lambda: jvssm.PatchMerging2D(32, dtype=jnp.bfloat16),
        lambda: tvssm.PatchMerging2D(16, 32, dtype=BF16),
        [(2, 5, 8, 16)], (["m"], "m.")),
    "ChannelAttentionBlock": (
        lambda: jvssm.ChannelAttentionBlock(32, dtype=jnp.bfloat16),
        lambda: tvssm.ChannelAttentionBlock(32, dtype=BF16),
        [(2, 4, 5, 32)], (["conv_blk"], "conv_blk.")),
    "SS2D": (lambda: jss2d.SS2D(d_model=16, d_state=16,
                                dtype=jnp.bfloat16),
             lambda: tss2d.SS2D(16, d_state=16, dtype=BF16),
             [(2, 4, 6, 16)], (["m", "op"], "m.op.")),
    "ConMBSS2D": (lambda: jss2d.ConMBSS2D(d_model=16, d_state=4,
                                          dtype=jnp.bfloat16),
                  lambda: tss2d.ConMBSS2D(16, d_state=4, dtype=BF16),
                  [(2, 4, 6, 16)] * 2, (["m", "op"], "m.op.")),
    "CrossMambaFusionSS2D": (
        lambda: jss2d.CrossMambaFusionSS2D(d_model=16, d_state=4,
                                           dtype=jnp.bfloat16),
        lambda: tss2d.CrossMambaFusionSS2D(16, d_state=4, dtype=BF16),
        [(2, 4, 6, 16)] * 2, (["m", "op"], "m.op.")),
    "VSSBlock": (lambda: jvssm.VSSBlock(16, d_state=16, dtype=jnp.bfloat16),
                 lambda: tvssm.VSSBlock(16, d_state=16, dtype=BF16),
                 [(2, 4, 6, 16)], (["m"], "m.")),
    "CVSSDecoderBlock": (
        lambda: jvssm.CVSSDecoderBlock(32, d_state=4, dtype=jnp.bfloat16),
        lambda: tvssm.CVSSDecoderBlock(32, d_state=4, dtype=BF16),
        [(2, 4, 6, 32)], (["m"], "m.")),
    "CrossMambaFusionBlock": (
        lambda: jfusion.CrossMambaFusionBlock(16, dtype=jnp.bfloat16),
        lambda: tfusion.CrossMambaFusionBlock(16, dtype=BF16),
        [(2, 4, 6, 16)] * 2, (["m"], "m.")),
    "ConcatMambaFusionBlock": (
        lambda: jfusion.ConcatMambaFusionBlock(16, dtype=jnp.bfloat16),
        lambda: tfusion.ConcatMambaFusionBlock(16, dtype=BF16),
        [(2, 4, 6, 16)] * 2, (["m"], "m.")),
    "SigmaEncoder": (
        lambda: jencoder.SigmaEncoder(**jencoder.SIGMA_VARIANTS["sigma_test"],
                                      remat=False, dtype=jnp.bfloat16),
        lambda: tencoder.SigmaEncoder(**tencoder.SIGMA_VARIANTS["sigma_test"],
                                      remat=False, dtype=BF16),
        [(1, 32, 48, 3)] * 2, (["m"], "m.")),
    "PatchExpand": (lambda: jdecoder.PatchExpand(32, dtype=jnp.bfloat16),
                    lambda: tdecoder.PatchExpand(32, dtype=BF16),
                    [(2, 3, 4, 32)], (["m"], "m.")),
    "UpsampleExpand": (
        lambda: jdecoder.UpsampleExpand(32, dtype=jnp.bfloat16),
        lambda: tdecoder.UpsampleExpand(32, dtype=BF16),
        [(2, 3, 4, 32)], (["m"], "m.")),
    "MambaUp": (lambda: jdecoder.MambaUp(32, 2, (0.0, 0.0), remat=False,
                                         dtype=jnp.bfloat16),
                lambda: tdecoder.MambaUp(32, 2, (0.0, 0.0), remat=False,
                                         dtype=BF16),
                [(2, 4, 5, 32)], (["m"], "m.")),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax_in_bf16(name):
    """Each module with dtype=bfloat16 on fp32 inputs (the residual
    modules also on bf16 ones, as the trunk feeds them from stage 1 on):
    the outputs' dtypes are JAX's, the values within the bf16 tier."""
    make_jax, make_port, shapes, (wrap, strip) = MODULES[name]
    xs = _inputs(len(shapes), shapes[0], seed=len(name))
    jm = make_jax()
    params, want = _jax_run(jm, xs)
    tm = _load(make_port(), params, wrap, strip)
    in_dtypes = [torch.float32]
    if name in ("VSSBlock", "CVSSDecoderBlock", "CrossMambaFusionBlock",
                "ConcatMambaFusionBlock"):
        in_dtypes.append(BF16)
    for dt in in_dtypes:
        if dt == BF16:
            xb = [np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in xs]
            want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a),
                           compiler_options=FAST_XLA)(
                params, *[jnp.asarray(x) for x in xb])
        with torch.inference_mode():
            got = tm(*[torch.from_numpy(np.asarray(x, np.float32)).to(dt)
                       for x in xs])
        got = got if isinstance(got, (tuple, list)) else (got,)
        want_t = want if isinstance(want, (tuple, list)) else (want,)
        assert len(got) == len(want_t)
        for g, w in zip(got, want_t):
            _close_bf16(g, w)


def test_channel_attention_nchw_and_final_upsample_in_bf16():
    """The two modules whose port layout differs from JAX's call: the port's
    ChannelAttention is NCHW (it sits in the CAB's conv Sequential), and
    FinalUpsampleX4 takes the classifier kernel; its logits come back in
    bf16, as JAX's head returns them."""
    (x,) = _inputs(1, (2, 4, 5, 32), seed=3)
    jm = jvssm.ChannelAttention(32, 8, dtype=jnp.bfloat16)
    params, want = _jax_run(jm, [x])
    tm = _load(tvssm.ChannelAttention(32, 8, dtype=BF16), params,
               ["conv_blk", "attn"], "conv_blk.cab.3.")
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close_bf16(got, want)

    (x,) = _inputs(1, (2, 3, 4, 16), seed=4)
    w_out = _inputs(1, (16, 9), seed=5)[0] * 0.25
    jm = jdecoder.FinalUpsampleX4(16, dtype=jnp.bfloat16)
    params, want = _jax_run(jm, [x], w_out=jnp.asarray(w_out))
    assert want.dtype == jnp.bfloat16
    tm = _load(tdecoder.FinalUpsampleX4(16, dtype=BF16), params, ["m"], "m.")
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), torch.from_numpy(w_out))
    _close_bf16(got, want)


def test_layer_policy_follows_flax():
    """Linear / Conv2d compute in their dtype with fp32 parameters and
    fp32 gradients; LayerNorm promotes bf16 to fp32; DropPath keeps its
    input's dtype and draws the same masks in bf16 as in fp32."""
    lin = tcommon.Linear(8, 4, dtype=BF16)
    conv = tcommon.depthwise_conv3x3(4, dtype=BF16)
    ln = tcommon.LayerNorm(4)
    x = torch.randn(2, 3, 5, 8, requires_grad=True)
    y = tcommon.conv2d_nhwc(conv, lin(x))
    assert y.dtype == BF16 and lin.weight.dtype == torch.float32
    z = ln(y)
    assert z.dtype == torch.float32
    z.sum().backward()
    assert lin.weight.grad.dtype == conv.weight.grad.dtype == torch.float32
    assert x.grad.dtype == torch.float32
    dp = tcommon.DropPath(0.5).train()
    masks = []
    for dt in (torch.float32, BF16):
        dp.seed = 7
        out = dp(torch.ones(16, 2, 2, 3, dtype=dt))
        assert out.dtype == dt
        masks.append(out.float())
    assert torch.equal(*masks)


# ------------------------------------------------------------ CLIs
@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    """Synthetic MFNet layout on disk: 4 train, 2 val images, 40x56."""
    root = tmp_path_factory.mktemp("mfnet_bf16")
    for sub in ("RGB", "Label", "Modal"):
        (root / sub).mkdir()
    rng = np.random.default_rng(1)
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


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_bf16_train_cli_then_eval_cli(tiny_tree, tmp_path, capsys):
    """`python -m sigma_tpu_torch.train --bf16` trains 2 steps and saves
    fp32 weights; `python -m sigma_tpu_torch.eval --override bf16=True`
    (parsed as the JAX CLI parses it, ast.literal_eval) serves them in
    bf16. Both log the compute dtype. Both run in this process."""
    from sigma_tpu_torch import eval as eval_cli
    from sigma_tpu_torch import train as train_cli
    from sigma_tpu_torch.engine.logger import get_logger

    common = ["-n", "mfnet", "--dataset-path", str(tiny_tree), "--device",
              "cpu", "--backbone", "sigma_test",
              "--override", "eval_crop_size=(32,32)"]
    log = tmp_path / "log"
    records = _Records()
    logger = get_logger()  # configured before the handler joins it
    logger.addHandler(records)
    try:
        assert train_cli.main([
            *common, "--bf16", "--steps", "2", "--batch-size", "2",
            "--log-dir", str(log), "--no-eval",
            "--override", "image_height=32", "--override", "image_width=32",
            "--override", "num_workers=1"]) == 0
        assert "compute dtype: bf16 (parameters fp32)" in records.lines
        assert "training finished (2 steps)" in records.lines
        sd = torch.load(log / "checkpoint" / "epoch-1" / "model.pt",
                        weights_only=True)
        assert all(v.dtype == torch.float32 for v in sd.values())
        del records.lines[:]
        assert eval_cli.main([*common, "--log-dir", str(log), "-e", "last",
                              "--override", "bf16=True"]) == 0
        assert "compute dtype: bf16 (parameters fp32)" in records.lines
        assert any(line.startswith("epoch-1: mIoU ")
                   for line in records.lines)
    finally:
        logger.removeHandler(records)
    assert "mean IoU" in capsys.readouterr().out
