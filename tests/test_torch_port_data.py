"""The port's own copies of the config, data and metrics modules against the
JAX package's originals, on the CPU.

The port imports nothing of `sigma_tpu` or `configs` (checked here on the
source of every module of the port and of chip_smoke.py), so it keeps
copies: `sigma_tpu_torch/configs.py`, `sigma_tpu_torch/data/` and
`sigma_tpu_torch/utils/metrics.py`. On the same seeded synthetic tree and
the same seeds they give the same configs, items, batches and scores,
bit for bit. The native augmentation tail (`data/native.py`, its own
build of the JAX package's `augment.cpp`) gives the JAX package's native
arrays bit for bit, and its `TrainPre(use_native=True)` the JAX one's,
within 1e-5 of the numpy path (labels exact, the bound of
tests/test_native_aug.py); a failed build raises.
"""

import ast
import dataclasses
from pathlib import Path

import cv2
import numpy as np
import pytest

import configs as jax_configs
from sigma_tpu.data import RGBXDataset as JaxDataset
from sigma_tpu.data import TrainLoader as JaxLoader
from sigma_tpu.data import TrainPre as JaxTrainPre
from sigma_tpu.data import ValPre as JaxValPre
from sigma_tpu.data import native as jax_native
from sigma_tpu.utils import metrics as jax_metrics
from sigma_tpu_torch import configs
from sigma_tpu_torch.data import RGBXDataset, TrainLoader, TrainPre, ValPre
from sigma_tpu_torch.data import native
from sigma_tpu_torch.utils import metrics

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["mfnet", "pst900", "nyu", "sunrgbd"])
def test_config_copy_equals_the_original(name):
    port, ref = configs.get_config(name), jax_configs.get_config(name)
    assert [f.name for f in dataclasses.fields(port)] == [
        f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.data_setting() == ref.data_setting()
    assert port.niters_per_epoch == ref.niters_per_epoch


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Synthetic MFNet layout: 6 train, 2 val images of 40x56."""
    root = tmp_path_factory.mktemp("mfnet_data")
    for sub in ("RGB", "Label", "Modal"):
        (root / sub).mkdir()
    rng = np.random.default_rng(0)
    names = [f"d{i:02d}" for i in range(8)]
    for n in names:
        cv2.imwrite(str(root / "RGB" / f"{n}.png"),
                    rng.integers(0, 255, (40, 56, 3), dtype=np.uint8))
        label = rng.integers(0, 9, (40, 56)).astype(np.uint8)
        label[0] = 255
        cv2.imwrite(str(root / "Label" / f"{n}.png"), label)
        cv2.imwrite(str(root / "Modal" / f"{n}.png"),
                    rng.integers(0, 255, (40, 56), dtype=np.uint8))
    (root / "train2.txt").write_text("\n".join(names[:6]) + "\n")
    (root / "test.txt").write_text("\n".join(names[6:]) + "\n")
    return str(root)


def _cfgs(root):
    out = []
    for mod in (configs, jax_configs):
        cfg = mod.get_config("mfnet", dataset_path=root)
        object.__setattr__(cfg, "image_height", 32)
        object.__setattr__(cfg, "image_width", 48)
        out.append(cfg)
    return out


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("device_norm", [True, False])
def test_train_pre_and_dataset_equal_the_originals(tree, device_norm):
    cfg, jcfg = _cfgs(tree)
    port = RGBXDataset(cfg.data_setting(), "train",
                       TrainPre(cfg.norm_mean, cfg.norm_std, cfg,
                                use_native=False, device_norm=device_norm),
                       file_length=10, seed=4)
    ref = JaxDataset(jcfg.data_setting(), "train",
                     JaxTrainPre(jcfg.norm_mean, jcfg.norm_std, jcfg,
                                 use_native=False, device_norm=device_norm),
                     file_length=10, seed=4)
    port.set_epoch(2)
    ref.set_epoch(2)
    for i in range(len(ref)):
        _same(port.__getitem__(i, rng=np.random.default_rng(i)),
              ref.__getitem__(i, rng=np.random.default_rng(i)))
    val = RGBXDataset(cfg.data_setting(), "val", ValPre())
    jval = JaxDataset(jcfg.data_setting(), "val", JaxValPre())
    for i in range(len(jval)):
        _same(val[i], jval[i])


def test_train_loader_batches_equal_the_originals(tree):
    """One process, then the shards of processes 0 and 1 of 2 (each half
    of the global batch), against the JAX loader's."""
    cfg, jcfg = _cfgs(tree)
    for index, count in ((0, 1), (0, 2), (1, 2)):
        port = TrainLoader(
            RGBXDataset(cfg.data_setting(), "train",
                        TrainPre(cfg.norm_mean, cfg.norm_std, cfg,
                                 device_norm=True),
                        file_length=8, seed=1),
            global_batch_size=4, niters_per_epoch=2, num_workers=2, seed=1,
            process_index=index, process_count=count)
        ref = JaxLoader(
            JaxDataset(jcfg.data_setting(), "train",
                       JaxTrainPre(jcfg.norm_mean, jcfg.norm_std, jcfg,
                                   device_norm=True),
                       file_length=8, seed=1),
            global_batch_size=4, niters_per_epoch=2, num_workers=2, seed=1,
            process_index=index, process_count=count)
        port.set_epoch(3)
        ref.set_epoch(3)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            _same(a, b)
            assert a["data"].dtype == np.uint8
            assert a["margins"].shape == (4 // count, 4)


def test_metrics_copy_equals_the_original():
    rng = np.random.default_rng(5)
    pred = rng.integers(0, 9, (30, 40))
    gt = rng.integers(0, 9, (30, 40))
    gt[:3] = 255
    got = metrics.hist_info(9, pred, gt)
    want = jax_metrics.hist_info(9, pred, gt)
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    scores = metrics.compute_score(*got)
    ref = jax_metrics.compute_score(*want)
    np.testing.assert_array_equal(scores[0], ref[0])
    assert scores[1:] == ref[1:]


def _native_cases(seed):
    """Seeded uint8 sources and (out_hw, crop, pad, copy_hw, mirror)
    geometries: a crop inside the canvas, a centre-padded small source,
    mirrored and not."""
    rng = np.random.default_rng(seed)
    for h, w, ch, out_hw, mirror in ((48, 64, 3, (40, 56), False),
                                     (30, 20, 1, (32, 48), True),
                                     (57, 71, 3, (32, 32), True)):
        img = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
        copy = (min(out_hw[0], h), min(out_hw[1], w))
        crop = (int(rng.integers(0, h - copy[0] + 1)),
                int(rng.integers(0, w - copy[1] + 1)))
        pad = ((out_hw[0] - copy[0]) // 2, (out_hw[1] - copy[1]) // 2)
        yield img, (out_hw, crop, pad, copy), mirror


def test_native_tail_equals_the_jax_packages_native():
    """The same source built with the same flags on the same host: the
    port's fused_image_aug / fused_label_aug give the JAX package's
    arrays bit for bit."""
    assert jax_native.available()
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    for img, geo, mirror in _native_cases(3):
        m, s = mean[:img.shape[2]], std[:img.shape[2]]
        a = native.fused_image_aug(img, *geo, m, s, 0.5, mirror)
        b = jax_native.fused_image_aug(img, *geo, m, s, 0.5, mirror)
        assert a.dtype == np.float32 and np.array_equal(a, b)
        a = native.fused_label_aug(img[..., 0], *geo, 255, mirror)
        b = jax_native.fused_label_aug(img[..., 0], *geo, 255, mirror)
        assert a.dtype == np.int32 and np.array_equal(a, b)


def test_train_pre_native_equals_jax_and_the_numpy_path(tree):
    """TrainPre(use_native=True) on the tree's items, every train scale's
    draws: the JAX package's native TrainPre bit for bit, the port's numpy
    path within 1e-5 (labels exact)."""
    cfg, jcfg = _cfgs(tree)
    port = RGBXDataset(cfg.data_setting(), "train",
                       TrainPre(cfg.norm_mean, cfg.norm_std, cfg),
                       file_length=12, seed=6)
    numpy_path = RGBXDataset(cfg.data_setting(), "train",
                             TrainPre(cfg.norm_mean, cfg.norm_std, cfg,
                                      use_native=False),
                             file_length=12, seed=6)
    ref = JaxDataset(jcfg.data_setting(), "train",
                     JaxTrainPre(jcfg.norm_mean, jcfg.norm_std, jcfg,
                                 use_native=True),
                     file_length=12, seed=6)
    for i in range(len(ref)):
        a = port.__getitem__(i, rng=np.random.default_rng(i))
        _same(a, ref.__getitem__(i, rng=np.random.default_rng(i)))
        b = numpy_path.__getitem__(i, rng=np.random.default_rng(i))
        for k in ("data", "modal_x"):
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5)
        assert np.array_equal(a["label"], b["label"])


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No quiet fallback: no compiler, or a compiler that fails, raises,
    naming the compiler and the source."""
    broken = tmp_path / "augment.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=f"failed on {broken}"):
            native._library()
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            native._library()
    finally:
        native._library.cache_clear()
    assert not any((tmp_path / "build").glob("*.so"))


def _imports(path):
    """Top-level names of every module `path` imports, at any depth."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add((node.module or "").split(".")[0])
    return names


def test_port_sources_import_no_jax_package():
    """No module of the port (the loss zoo, the FLOP count and the native
    loader among them) and not chip_smoke.py imports jax, flax, the JAX
    package or its configs, at module level or inside a function."""
    banned = {"jax", "jaxlib", "flax", "sigma_tpu", "configs"}
    paths = sorted((ROOT / "sigma_tpu_torch").rglob("*.py"))
    assert ROOT / "sigma_tpu_torch" / "utils" / "losses.py" in paths
    bad = {str(p.relative_to(ROOT)): _imports(p) & banned
           for p in paths + [ROOT / "chip_smoke.py"]}
    assert not {k: v for k, v in bad.items() if v}
