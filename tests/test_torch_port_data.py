"""The port's own copies of the config, data and metrics modules against the
JAX package's originals, on the CPU.

The port imports nothing of `sigma_tpu` or `configs`, so it keeps copies:
`sigma_tpu_torch/configs.py`, `sigma_tpu_torch/data/` and
`sigma_tpu_torch/utils/metrics.py`. On the same seeded synthetic tree and
the same seeds they give the same configs, items, batches and scores,
bit for bit.
"""

import dataclasses

import cv2
import numpy as np
import pytest

import configs as jax_configs
from sigma_tpu.data import RGBXDataset as JaxDataset
from sigma_tpu.data import TrainLoader as JaxLoader
from sigma_tpu.data import TrainPre as JaxTrainPre
from sigma_tpu.data import ValPre as JaxValPre
from sigma_tpu.utils import metrics as jax_metrics
from sigma_tpu_torch import configs
from sigma_tpu_torch.data import RGBXDataset, TrainLoader, TrainPre, ValPre
from sigma_tpu_torch.utils import metrics


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
                                device_norm=device_norm),
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
