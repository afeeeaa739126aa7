"""Checkpoints and weight ingest of the PyTorch port against the JAX
package, on the CPU, with no JAX compile (JAX only through `eval_shape`,
its directory functions and its converters):

  * the eval CLI's `-e` grammar against JAX's `eval.parse_epochs` on the
    same directory tree;
  * `prune_checkpoints` against JAX's on identical directories, the
    restore fallback (missing or dangling pointer, nothing to restore),
    `val_scores.json` read both ways, the async save's pointer, and an
    orbax epoch directory refused;
  * `--pretrained` ingest of a released-scheme VMamba trunk (`.pth` with
    the `module.` prefix and a `model` envelope holding a pickled object,
    torch-keyed `.npz`) against JAX's `load_vmamba_into_params`, bit for
    bit with the same counts, and the eval CLI's file dispatch against
    JAX's `load_checkpoint_into_params`;
  * `python -m sigma_tpu_torch.train` in this process: 2 epochs of 2
    steps equal, bit for bit, to `--steps 2` then `-c` (weights, optimizer
    state, step), best-k retention and the best mIoU kept across the
    resume, the kept epochs scored by `python -m sigma_tpu_torch.eval`
    with `-e last` / `-e 1-`; `--pretrained` into the train CLI's model.
"""

import argparse
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import eval as jax_eval_cli
import sigma_tpu.engine.checkpoint as jax_ckpt
from sigma_tpu.models.builder import EncoderDecoder as JaxEncoderDecoder
from sigma_tpu.utils.convert import (
    _strip as jax_strip,
    convert_vmamba_trunk,
    load_checkpoint_into_params,
    load_torch_state_dict as jax_load_torch_state_dict,
    load_vmamba_into_params,
)
from sigma_tpu_torch import eval as eval_cli
from sigma_tpu_torch import train as train_cli
from sigma_tpu_torch.data.png import write_png
from sigma_tpu_torch.engine import checkpoint as ckpt
from sigma_tpu_torch.engine.logger import get_logger
from sigma_tpu_torch.engine.train import TrainState
from sigma_tpu_torch.models.builder import EncoderDecoder
from sigma_tpu_torch.utils.convert import (
    load_checkpoint_into_model,
    load_vmamba_into_model,
    state_dict_from_jax,
)

# torch's CPU threads per test process, as in test_torch_port_train.py
TORCH_THREADS = 2
DEPTHS, DIMS, D_STATE = (1, 1, 2, 1), (16, 32, 64, 128), 16


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ directories
def _tree(root, epochs, pointer=None, stray=()):
    """epoch-N directories (each with a file in it), an epoch-last
    pointer and stray entries, as both trainers leave them."""
    os.makedirs(root, exist_ok=True)
    for n in epochs:
        os.makedirs(os.path.join(root, f"epoch-{n}"))
        open(os.path.join(root, f"epoch-{n}", "x"), "w").close()
    for name in stray:
        os.makedirs(os.path.join(root, name))
    if pointer is not None:
        with open(os.path.join(root, "epoch-last"), "w") as f:
            f.write(str(pointer))
    return str(root)


@pytest.mark.parametrize("spec", [
    "last", "3", "2-4", "2-", "0-", "9-", "model.pth", "params.npz"])
def test_parse_epochs_matches_jax(tmp_path, spec):
    """With gaps (no epoch 3, 5, 6), a stray epoch-last, a temporary
    directory and a name that is not an epoch."""
    root = _tree(tmp_path / "ck", (1, 2, 4, 7), pointer=4,
                 stray=("epoch-3.tmp", "epoch-x", "other"))
    assert eval_cli.parse_epochs(spec, root) == \
        jax_eval_cli.parse_epochs(spec, root)


def test_parse_epochs_takes_pt_and_a_missing_directory(tmp_path):
    assert eval_cli.parse_epochs("model.pt", str(tmp_path)) == ["model.pt"]
    for spec in ("2-", "last", "5"):
        assert eval_cli.parse_epochs(spec, str(tmp_path / "none")) == \
            jax_eval_cli.parse_epochs(spec, str(tmp_path / "none"))


@pytest.mark.parametrize("keep,pointer", [
    (3, None),           # an int: the best-only policy
    ([2, 7], None),      # best-k
    ([2], 4),            # the pointer's target is kept
    (1, 9),              # a dangling pointer keeps nothing extra
])
def test_prune_matches_jax(tmp_path, keep, pointer):
    stray = ("epoch-5.tmp", "epoch-last.tmp", "notes")
    port = _tree(tmp_path / "port", (1, 2, 3, 4, 7), pointer, stray)
    ref = _tree(tmp_path / "jax", (1, 2, 3, 4, 7), pointer, stray)
    ckpt.prune_checkpoints(port, keep)
    jax_ckpt.prune_checkpoints(ref, keep)
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    assert "epoch-5.tmp" in os.listdir(port)  # a temporary dir is no epoch


def _tiny_state(seed=0):
    torch.manual_seed(seed)
    model = nn.Sequential(nn.Linear(3, 4), nn.LayerNorm(4))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    model(torch.randn(2, 3)).square().sum().backward()
    opt.step()
    return TrainState(model=model, optimizer=opt, step=1)


def _same_state(a, b):
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert a.step == b.step


def test_save_then_restore_is_exact(tmp_path):
    state = _tiny_state()
    path = ckpt.save_checkpoint(str(tmp_path), state, 3)
    assert path == str(tmp_path / "epoch-3")
    assert sorted(os.listdir(path)) == ["meta.json", "model.pt",
                                        "optimizer.pt"]
    assert (tmp_path / "epoch-last").read_text() == "3"
    assert jax_ckpt._pointer_epoch(str(tmp_path)) == 3
    other = _tiny_state(seed=1)
    other.step = 0
    restored, epoch = ckpt.restore_checkpoint(str(tmp_path), other)
    assert epoch == 3 and restored is other
    _same_state(restored, state)
    raw, epoch = ckpt.restore_checkpoint(str(tmp_path), None, 3)
    assert epoch == 3 and raw["step"] == 1 and raw["epoch"] == 3
    assert set(raw["model"]) == set(state.model.state_dict())
    # an existing epoch-N is replaced
    state.step = 5
    ckpt.save_checkpoint(str(tmp_path), state, 3)
    assert ckpt.restore_checkpoint(str(tmp_path))[0]["step"] == 5
    assert sorted(os.listdir(tmp_path)) == ["epoch-3", "epoch-last"]


@pytest.mark.parametrize("case", ["missing", "dangling", "nothing"])
def test_restore_fallback(tmp_path, case):
    root = str(tmp_path / "ck")
    if case == "nothing":
        with pytest.raises(FileNotFoundError, match="ck"):
            ckpt.restore_checkpoint(root)
        _tree(root, (), pointer=2, stray=("epoch-4.tmp",))
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            ckpt.restore_checkpoint(root)
        return
    state = _tiny_state()
    for epoch in (2, 5):
        state.step = epoch
        ckpt.save_checkpoint(root, state, epoch)
    os.makedirs(os.path.join(root, "epoch-9.tmp"))  # an unfinished write
    if case == "missing":
        os.remove(os.path.join(root, "epoch-last"))
    else:
        with open(os.path.join(root, "epoch-last"), "w") as f:
            f.write("7")
    raw, epoch = ckpt.restore_checkpoint(root)
    assert epoch == 5 and raw["step"] == 5


def test_val_scores_both_ways(tmp_path):
    scores = [(51.25, 5), (48.0, 10), (53.125, 15)]
    jax_ckpt.save_val_scores(str(tmp_path / "a"), scores)
    assert ckpt.load_val_scores(str(tmp_path / "a")) == scores
    ckpt.save_val_scores(str(tmp_path / "b"), scores)
    assert jax_ckpt.load_val_scores(str(tmp_path / "b")) == scores
    assert (tmp_path / "a" / "val_scores.json").read_text() == \
        (tmp_path / "b" / "val_scores.json").read_text()
    assert ckpt.load_val_scores(str(tmp_path / "none")) == []


def test_async_save_publishes_the_pointer_when_durable(tmp_path):
    root = str(tmp_path)
    state = _tiny_state()
    try:
        ckpt.save_checkpoint(root, state, 1, async_save=True)
        assert ckpt._ASYNC["pending"] is not None
        assert not os.path.exists(os.path.join(root, "epoch-last"))
        ckpt.prune_checkpoints(root, [7])  # the pending epoch survives
        ckpt.save_checkpoint(root, state, 2, async_save=True)
        # the first write was awaited, its pointer published; the second
        # is pending, and both survive a prune that keeps neither
        assert (tmp_path / "epoch-last").read_text() == "1"
        ckpt.prune_checkpoints(root, [7])
        ckpt._ASYNC["thread"].join()
        assert sorted(os.listdir(root)) == ["epoch-1", "epoch-2",
                                            "epoch-last"]
    finally:
        ckpt.finalize_checkpoints()
    assert ckpt._ASYNC["pending"] is None
    assert (tmp_path / "epoch-last").read_text() == "2"
    other = _tiny_state(seed=1)
    _same_state(ckpt.restore_checkpoint(root, other)[0], state)
    ckpt.finalize_checkpoints()  # nothing pending: a no-op


def test_orbax_epoch_directory_is_refused(tmp_path, tree):
    root = str(tmp_path / "checkpoint")
    jax_ckpt.save_checkpoint(
        root, {"params": {"w": np.zeros(3, np.float32)}}, 4)
    with pytest.raises(ValueError, match="orbax checkpoint of the JAX"):
        ckpt.restore_checkpoint(root)
    with pytest.raises(ValueError, match="orbax"):
        eval_cli.main([*_common(tree), "--log-dir", str(tmp_path)])


# ------------------------------------------------------------ ingest
@pytest.fixture(scope="module")
def jax_params():
    """The JAX sigma_test's params as jax.eval_shape lays them out (no
    init compiled), every leaf filled with seeded values."""
    jm = JaxEncoderDecoder(num_classes=9, backbone="sigma_test")
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, x)["params"]
    rng = np.random.default_rng(11)
    return jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), shapes)


def _port_model(params):
    model = EncoderDecoder(9, "sigma_test")
    model.load_state_dict(state_dict_from_jax(params, model))
    return model


def _released_trunk(seed=3, in_ch=3, ssm_ratio=2):
    """A VMamba ImageNet state_dict in the released key scheme at
    sigma_test widths: patch_embed.proj / .norm, ln_1, self_attention,
    downsample, and a classifier the trunk drops."""
    rng = np.random.default_rng(seed)
    sd = {}

    def add(k, *shape):
        sd[k] = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))

    add("patch_embed.proj.weight", DIMS[0], in_ch, 4, 4)
    add("patch_embed.proj.bias", DIMS[0])
    add("patch_embed.norm.weight", DIMS[0])
    add("patch_embed.norm.bias", DIMS[0])
    for i, depth in enumerate(DEPTHS):
        d = DIMS[i]
        di, r = ssm_ratio * d, -(-d // 16)
        for j in range(depth):
            b = f"layers.{i}.blocks.{j}"
            add(f"{b}.ln_1.weight", d)
            add(f"{b}.ln_1.bias", d)
            sa = f"{b}.self_attention"
            add(f"{sa}.in_proj.weight", 2 * di, d)
            add(f"{sa}.conv2d.weight", di, 1, 3, 3)
            add(f"{sa}.conv2d.bias", di)
            add(f"{sa}.x_proj_weight", 4, r + 2 * D_STATE, di)
            add(f"{sa}.dt_projs_weight", 4, di, r)
            add(f"{sa}.dt_projs_bias", 4, di)
            add(f"{sa}.A_logs", 4 * di, D_STATE)
            add(f"{sa}.Ds", 4 * di)
            add(f"{sa}.out_norm.weight", di)
            add(f"{sa}.out_norm.bias", di)
            add(f"{sa}.out_proj.weight", d, di)
        if i < len(DEPTHS) - 1:
            add(f"layers.{i}.downsample.norm.weight", 4 * d)
            add(f"layers.{i}.downsample.norm.bias", 4 * d)
            add(f"layers.{i}.downsample.reduction.weight", DIMS[i + 1],
                4 * d)
    add("classifier.norm.weight", DIMS[-1])
    add("classifier.head.weight", 1000, DIMS[-1])
    add("classifier.head.bias", 1000)
    return sd


def _save_released(sd, path):
    """`.pth`: the `module.` prefix inside a `model` envelope that also
    pickles an argparse namespace and an epoch; `.npz`: torch-named
    arrays."""
    if path.endswith(".npz"):
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    else:
        torch.save({"model": {f"module.{k}": v for k, v in sd.items()},
                    "optimizer": None, "epoch": 300,
                    "config": argparse.Namespace(arch="vssm", dims=DIMS)},
                   path)
    return path


def _assert_port_equals_jax(model, jax_tree):
    want = state_dict_from_jax(jax_tree, model)
    got = model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_trunk_ingest_matches_jax(jax_params, tmp_path, suffix):
    released = _released_trunk()
    path = _save_released(released, str(tmp_path / f"vssm{suffix}"))
    new = load_vmamba_into_params(jax_params, path)
    model = _port_model(jax_params)
    loaded, missing, unexpected = load_vmamba_into_model(model, path)
    _assert_port_equals_jax(model, new)
    # the counts JAX logs: loaded, missing (fresh init), unexpected
    sd = jax_load_torch_state_dict(path)
    _, j_loaded, j_missing = convert_vmamba_trunk(
        jax_params["backbone"]["vssm"], sd)
    j_unexpected = sorted(set(jax_strip(sd)) - set(j_loaded))
    assert sorted(loaded) == sorted(j_loaded)
    assert len(missing) == len(j_missing) == 8  # the four outnorms
    assert all(k.startswith("outnorm") for k in missing)
    assert unexpected == j_unexpected == [
        "classifier.head.bias", "classifier.head.weight",
        "classifier.norm.weight"]
    # what the file holds went in, what it lacks kept the seeded values
    got = model.state_dict()
    assert torch.equal(got["backbone.vssm.layers.2.blocks.1.op.A_logs"],
                       released["layers.2.blocks.1.self_attention.A_logs"])
    assert torch.equal(got["backbone.vssm.outnorm3.weight"],
                       torch.from_numpy(np.asarray(
                           jax_params["backbone"]["vssm"]["outnorm3"]
                           ["scale"])))


def test_trunk_shape_mismatch_raises_in_both(jax_params, tmp_path):
    released = _released_trunk()
    released["layers.1.blocks.0.self_attention.Ds"] = torch.zeros(7)
    path = _save_released(released, str(tmp_path / "bad.pth"))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_vmamba_into_params(jax_params, path)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_vmamba_into_model(_port_model(jax_params), path)


@pytest.mark.parametrize("kind", ["full_pth", "trunk_pth", "trunk_npz",
                                  "flax_npz"])
def test_eval_file_dispatch_matches_jax(jax_params, tmp_path, kind):
    """`-e FILE`: a full model (keys under backbone. / decode_head., the
    trunk in the released scheme, one decoder tensor missing and one
    stray key), a trunk-only `.pth`, a torch-keyed trunk `.npz`, and the
    port's own `.npz` of flax paths (which JAX does not read: held to
    state_dict_from_jax)."""
    rng = np.random.default_rng(5)
    other = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), jax_params)
    model = _port_model(jax_params)
    if kind == "flax_npz":
        path = str(tmp_path / "params.npz")
        np.savez(path, **{
            "/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(other)})
        load_checkpoint_into_model(model, path)
        _assert_port_equals_jax(model, other)
        return
    if kind == "full_pth":
        sd = state_dict_from_jax(other)
        sd = {k.replace(".op.", ".self_attention.")
              if k.startswith("backbone.vssm.") else k: v
              for k, v in sd.items()}
        del sd["decode_head.norm_up.weight"]
        sd["decode_head.extra.weight"] = torch.zeros(3)
        path = str(tmp_path / "sigma.pth")
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()},
                    "epoch": 7}, path)
    else:
        path = _save_released(_released_trunk(),
                              str(tmp_path / ("vssm.pth" if kind ==
                                              "trunk_pth" else "vssm.npz")))
    want = load_checkpoint_into_params(jax_params, path)
    loaded, missing, unexpected = load_checkpoint_into_model(model, path)
    _assert_port_equals_jax(model, want)
    if kind == "full_pth":
        assert missing == ["decode_head.norm_up.weight"]
        assert unexpected == ["decode_head.extra.weight"]


# ------------------------------------------------------------ the CLIs
@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Synthetic MFNet layout: 4 train and 2 val pairs, 40x56."""
    root = tmp_path_factory.mktemp("mfnet_ckpt")
    for sub in ("RGB", "Label", "Modal"):
        (root / sub).mkdir()
    rng = np.random.default_rng(2)
    names = [f"t{i:02d}" for i in range(6)]
    for n in names:
        write_png(str(root / "RGB" / f"{n}.png"),
                  rng.integers(0, 255, (40, 56, 3), dtype=np.uint8))
        write_png(str(root / "Label" / f"{n}.png"),
                  rng.integers(0, 9, (40, 56)).astype(np.uint8))
        write_png(str(root / "Modal" / f"{n}.png"),
                  rng.integers(0, 255, (40, 56), dtype=np.uint8))
    (root / "train2.txt").write_text("\n".join(names[:4]) + "\n")
    (root / "test.txt").write_text("\n".join(names[4:]) + "\n")
    return root


def _common(tree):
    return ["-n", "mfnet", "--dataset-path", str(tree), "--device", "cpu",
            "--backbone", "sigma_test", "--override", "eval_crop_size=(32,32)"]


def _train_args(tree, log, *extra):
    # num_train_imgs=3 at batch 2: 2 iterations an epoch; a checkpoint
    # (and an evaluation) every epoch
    return [*_common(tree), "--batch-size", "2", "--log-dir", str(log),
            "--epochs", "2", "--override", "image_height=32",
            "--override", "image_width=32", "--override", "num_workers=1",
            "--override", "num_train_imgs=3",
            "--override", "checkpoint_start_epoch=1",
            "--override", "checkpoint_step=1", *extra]


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture()
def log_lines():
    handler = _Records()
    logger = get_logger()  # configured before the handler joins it
    logger.addHandler(handler)
    yield handler.lines
    logger.removeHandler(handler)


def _epoch_files(ck, epoch):
    d = os.path.join(ck, f"epoch-{epoch}")
    model = torch.load(os.path.join(d, "model.pt"), weights_only=True)
    opt = torch.load(os.path.join(d, "optimizer.pt"), weights_only=True)
    with open(os.path.join(d, "meta.json")) as f:
        return model, opt, json.load(f)


def test_resume_equals_the_uninterrupted_run(tree, tmp_path, log_lines):
    """Run A: 2 epochs uninterrupted, async saves. Run B: `--steps 2`
    stops after epoch 1, `-c` finishes epoch 2. B's weights, optimizer
    state and step equal A's bit for bit; the val history, the best mIoU
    and the kept epochs survive the resume; the eval CLI scores the kept
    epochs as the train-time evaluation did."""
    log_a, log_b = tmp_path / "a", tmp_path / "b"
    assert train_cli.main(_train_args(
        tree, log_a, "--override", "async_checkpoint=True")) == 0
    assert "training finished (4 steps)" in log_lines
    assert train_cli.main(_train_args(tree, log_b, "--steps", "2")) == 0
    assert "training finished (2 steps)" in log_lines
    ck_a, ck_b = str(log_a / "checkpoint"), str(log_b / "checkpoint")
    assert (log_b / "checkpoint" / "epoch-last").read_text() == "1"
    del log_lines[:]
    assert train_cli.main(_train_args(tree, log_b, "-c")) == 0
    assert "resumed from epoch 1 (step 2)" in log_lines
    assert "training finished (2 steps)" in log_lines

    model_a, opt_a, meta_a = _epoch_files(ck_a, 2)
    model_b, opt_b, meta_b = _epoch_files(ck_b, 2)
    assert meta_a == meta_b == {"epoch": 2, "step": 4}
    assert model_a.keys() == model_b.keys()
    for k in model_a:
        assert torch.equal(model_a[k], model_b[k]), k
    assert opt_a["param_groups"] == opt_b["param_groups"]
    assert opt_a["state"].keys() == opt_b["state"].keys()
    for i, s in opt_a["state"].items():
        for k, v in s.items():
            assert torch.equal(v, opt_b["state"][i][k]), (i, k)

    scores = ckpt.load_val_scores(ck_a)
    assert [e for _, e in scores] == [1, 2]
    assert ckpt.load_val_scores(ck_b) == scores
    best = max(scores)
    assert f"best mIoU {best[0]:.2f} @ epoch {best[1]}" in log_lines
    # best-1 plus the pointer's target (epoch 2); with async saves the
    # last prune ran while epoch 2 was in flight and the pointer still
    # targeted epoch 1, which it therefore kept, as JAX's prune does
    for ck, kept in ((ck_a, {best[1], 1, 2}), (ck_b, {best[1], 2})):
        assert sorted(n for n in os.listdir(ck) if n.startswith("epoch-")) \
            == sorted([f"epoch-{e}" for e in kept] + ["epoch-last"])
    for log in (log_a, log_b):
        first = (log / "val_epoch_2.log").read_text().splitlines()
        assert first[0] == f"epoch 2 mIoU {scores[1][0]:.4f}"
        assert len(first) == 1 + 9 and first[1].startswith("class 0: ")
        assert os.readlink(log / "val_last.log") == \
            str(log / "val_epoch_2.log")

    del log_lines[:]
    for spec in ("last", "1-"):
        assert eval_cli.main([*_common(tree), "--log-dir", str(log_b),
                              "-e", spec]) == 0
    miou = {e: m for m, e in scores}
    kept = sorted({best[1], 2})
    assert [line for line in log_lines if ": mIoU " in line] == [
        f"epoch-{e}: mIoU {miou[e]:.2f}" for e in [2] + kept]


def test_train_cli_pretrained(tree, tmp_path, jax_params, log_lines,
                              monkeypatch):
    """`--pretrained` fills the train CLI's trunk before its first step
    (the released tensors, as JAX's ingest does), and the step runs."""
    from sigma_tpu_torch.engine import train as engine

    path = _save_released(_released_trunk(seed=8), str(tmp_path / "v.pth"))
    want = {k: v for k, v in state_dict_from_jax(
        load_vmamba_into_params(jax_params, path)).items()
        if k.startswith("backbone.vssm.") and "outnorm" not in k}
    seen = {}
    orig = engine.build_train

    def build_train(cfg, device="cuda"):
        state, step, schedule = orig(cfg, device)

        def watched_step(st, batch):
            if not seen:
                sd = st.model.state_dict()
                seen["equal"] = all(torch.equal(sd[k], v)
                                    for k, v in want.items())
            loss = step(st, batch)
            seen["loss"] = float(loss)
            return loss

        return state, watched_step, schedule

    monkeypatch.setattr(engine, "build_train", build_train)
    assert train_cli.main(_train_args(
        tree, tmp_path / "log", "--steps", "1", "--no-eval",
        "--pretrained", path)) == 0
    assert seen["equal"] and np.isfinite(seen["loss"])
    assert (f"vmamba ingest: {len(want)} tensors loaded, 8 missing (fresh "
            "init), 3 unexpected (dropped, e.g. classifier head)"
            in log_lines)
    assert f"loaded pretrained backbone: {path}" in log_lines
