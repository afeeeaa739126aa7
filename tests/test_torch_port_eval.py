"""Eval path of the PyTorch port against the JAX package, on the CPU.

  * the port's SlidingEvaluator against the JAX SlidingEvaluator, with one
    tiny shared linear "model" on both sides (the same numpy weights),
    over a window grid with flip and two scales, the whole-image branch
    with a 2-D modal-x, and the collapsed-window geometry;
  * `python -m sigma_tpu_torch.eval` end to end (its main, in this
    process) on a synthetic PNG MFNet tree, on the CPU;
  * importing every module of the port (the train CLI and chip_smoke.py
    included) and running its eval loads nothing of jax, jaxlib, flax,
    sigma_tpu or configs (a fresh interpreter);
  * build_model and SlidingEvaluator run on the card unless asked for the
    CPU: on a host without one they raise.
"""

import logging
import os
import subprocess
import sys
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.engine.evaluator import SlidingEvaluator as JaxEvaluator
from sigma_tpu_torch.engine.evaluator import SlidingEvaluator

ROOT = Path(__file__).resolve().parents[1]
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
C = 5

_r = np.random.default_rng(0)
W1 = (_r.standard_normal((3, C)) * 0.3).astype(np.float32)
W2 = (_r.standard_normal((3, C)) * 0.2).astype(np.float32)
V = (_r.standard_normal(C) * 0.5).astype(np.float32)
BIAS = (_r.standard_normal(C) * 0.1).astype(np.float32)


class JaxLinear:
    """Per-pixel linear map plus a row cumsum (still linear), so a window
    placed at the wrong offset changes the scores."""

    def apply(self, variables, rgb, mx):
        row = jnp.cumsum(rgb[..., :1], axis=1) * 0.01
        return rgb @ W1 + mx @ W2 + row * V + BIAS


def torch_linear(rgb, mx):
    row = torch.cumsum(rgb[..., :1], dim=1) * 0.01
    t = torch.from_numpy
    return rgb @ t(W1) + mx @ t(W2) + row * t(V) + t(BIAS)


def _jax_scores(ev, img, mx):
    acc = None
    for si, s in enumerate(ev.multi_scales):
        img_s = cv2.resize(img, None, fx=s, fy=s,
                           interpolation=cv2.INTER_LINEAR)
        interp = cv2.INTER_NEAREST if mx.ndim == 2 else cv2.INTER_LINEAR
        x_s = cv2.resize(mx, None, fx=s, fy=s, interpolation=interp)
        acc = ev.scale_process(None, img_s, x_s, img.shape[:2], acc, si == 0)
    return np.asarray(acc)


CASES = [
    # (img_hw, crop, scales, flip, modal_2d)
    ((100, 128), (40, 56), (1.0, 0.75), True, False),   # grid, flip, 2 scales
    ((48, 64), (48, 64), (1.0, 0.75), True, True),      # whole image, 2-D x
    ((50, 128), (40, 56), (1.0,), False, False),        # collapsed windows
]


@pytest.mark.parametrize("img_hw,crop,scales,flip,modal2d", CASES)
def test_evaluator_matches_jax(img_hw, crop, scales, flip, modal2d):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, img_hw + (3,), dtype=np.uint8)
    mx = rng.integers(0, 255, img_hw if modal2d else img_hw + (3,),
                      dtype=np.uint8)
    kw = dict(multi_scales=scales, is_flip=flip, eval_crop_size=crop,
              stride_rate=2 / 3, window_batch=3)
    jev = JaxEvaluator(JaxLinear(), C, MEAN, STD, **kw)
    tev = SlidingEvaluator(torch_linear, C, MEAN, STD, device="cpu", **kw)
    want = _jax_scores(jev, img, mx)
    got = tev.scores(img, mx).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    pred = tev.sliding_eval(img, mx)
    assert pred.shape == img_hw and pred.dtype == np.int32
    assert (pred == jev.sliding_eval(None, img, mx)).mean() > 0.999


def test_run_matches_jax():
    rng = np.random.default_rng(2)
    items = []
    for i in range(3):
        label = rng.integers(0, C, (60, 80)).astype(np.uint8)
        label[0] = 255
        items.append(dict(
            data=rng.integers(0, 255, (60, 80, 3), dtype=np.uint8),
            modal_x=rng.integers(0, 255, (60, 80, 3), dtype=np.uint8),
            label=label, fn=f"x{i}", n=3))
    kw = dict(eval_crop_size=(40, 56), window_batch=2)
    miou_j, det_j = JaxEvaluator(JaxLinear(), C, MEAN, STD, **kw).run(
        None, items, shard_across_processes=False)
    miou_t, det_t = SlidingEvaluator(torch_linear, C, MEAN, STD,
                                     device="cpu", **kw).run(items)
    assert miou_t == pytest.approx(miou_j, abs=1e-3)
    np.testing.assert_allclose(det_t["iou"], det_j["iou"], atol=1e-4)


@pytest.fixture(scope="module")
def mfnet_tree(tmp_path_factory):
    """Synthetic MFNet layout on disk (2 val images, 64x80) and a seeded
    sigma_mini state_dict of the port."""
    from configs import get_config
    from sigma_tpu_torch.models.builder import build_model

    root = tmp_path_factory.mktemp("mfnet_port")
    for sub in ("RGB", "Label", "Modal"):
        (root / sub).mkdir()
    rng = np.random.default_rng(0)
    names = ["a00", "a01"]
    for n in names:
        cv2.imwrite(str(root / "RGB" / f"{n}.png"),
                    rng.integers(0, 255, (64, 80, 3), dtype=np.uint8))
        cv2.imwrite(str(root / "Label" / f"{n}.png"),
                    rng.integers(0, 9, (64, 80)).astype(np.uint8))
        cv2.imwrite(str(root / "Modal" / f"{n}.png"),
                    rng.integers(0, 255, (64, 80), dtype=np.uint8))
    (root / "train2.txt").write_text("\n".join(names) + "\n")
    (root / "test.txt").write_text("\n".join(names) + "\n")
    cfg = get_config("mfnet")
    object.__setattr__(cfg, "backbone", "sigma_mini")
    ckpt = root / "sigma_mini.pt"
    torch.save(build_model(cfg, device="cpu", seed=1).state_dict(), ckpt)
    return root, ckpt


def _cli_args(root, ckpt, out=None):
    args = ["-n", "mfnet", "--dataset-path", str(root), "-e", str(ckpt),
            "--device", "cpu", "--backbone", "sigma_mini",
            "--override", "eval_crop_size=(64,80)"]
    return args + (["-p", str(out)] if out else [])


def _env():
    # two torch threads: the suite runs several test processes at once
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    return env


def test_eval_cli_end_to_end(mfnet_tree, tmp_path, capsys):
    """`python -m sigma_tpu_torch.eval`'s main in this process, torch at
    two threads (the suite runs several test processes at once)."""
    from sigma_tpu_torch.engine.logger import get_logger
    from sigma_tpu_torch.eval import main

    root, ckpt = mfnet_tree
    out = tmp_path / "pred"
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logger = get_logger()  # configured before the handler joins it
    logger.addHandler(handler)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        assert main(_cli_args(root, ckpt, out)) == 0
    finally:
        torch.set_num_threads(threads)
        logger.removeHandler(handler)
    assert "mean IoU" in capsys.readouterr().out
    assert any(line.startswith(f"{ckpt}: mIoU ") for line in records)
    for n in ("a00", "a01"):
        pred = cv2.imread(str(out / f"{n}.png"), cv2.IMREAD_GRAYSCALE)
        assert pred.shape == (64, 80) and pred.max() < 9
        assert (tmp_path / "pred_color" / f"{n}.png").exists()


def test_port_imports_and_eval_stay_jax_free(mfnet_tree):
    root, ckpt = mfnet_tree
    code = (
        "import importlib, pkgutil, sys\n"
        "import sigma_tpu_torch\n"
        "for m in pkgutil.walk_packages(sigma_tpu_torch.__path__,\n"
        "                               'sigma_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "import sigma_tpu_torch.train\n"
        "from sigma_tpu_torch.eval import main\n"
        f"rc = main({_cli_args(root, ckpt)!r})\n"
        "roots = ('jax', 'jaxlib', 'flax', 'sigma_tpu', 'configs')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in roots)\n"
        "assert rc == 0 and not bad, (rc, bad[:10])\n"
        "print('JAX_FREE')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_FREE" in proc.stdout


def test_cuda_device_without_card_fails():
    """No silent CPU fallback: asking for cuda where there is none is an
    error (checked on hosts without a card)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from sigma_tpu_torch.eval import main

    with pytest.raises(SystemExit) as e:
        main(["-n", "mfnet", "-e", "x.pt", "--device", "cuda"])
    assert e.value.code != 0


def test_build_model_and_evaluator_default_to_the_card():
    """The entry points run on the card unless the caller asks for the
    CPU: without a card, their default device raises instead of running
    anywhere else."""
    import inspect

    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.models.builder import build_model

    for fn in (build_model, SlidingEvaluator.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = get_config("mfnet", backbone="sigma_test")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlidingEvaluator(torch_linear, C, MEAN, STD)
