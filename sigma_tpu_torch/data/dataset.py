"""RGB-X dataset (map-style, numpy): the port's copy of
`sigma_tpu/data/dataset.py`.

Mirrors the reference's `dataloader/RGBXDataset.py`:
  * file-name lists from train/eval source txt files
  * PNG files read by `png.py` and JPEG files (the NYU and SUN-RGBD RGB
    folders) by `jpeg.py`: cv2's arrays, no cv2
  * RGB loaded as RGB; GT grayscale uint8 (optional `gt - 1` shift,
    RGBXDataset.py:104-106); modal-X grayscale replicated to 3 channels when
    `x_single_channel` (RGBXDataset.py:50-54)
  * epoch oversampling: when `file_length` is set, names are tiled and the
    remainder drawn by random permutation (RGBXDataset.py:84-94)
"""

from __future__ import annotations

import os

import numpy as np

from sigma_tpu_torch.data.jpeg import read_jpeg
from sigma_tpu_torch.data.png import read_png


def _read(path, gray):
    """(H, W, 3) RGB or (H, W) uint8, as `cv2.imread` gives it."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".png", ".jpg", ".jpeg"):
        raise ValueError(f"{path}: the port reads PNG and JPEG files")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if ext == ".png":
        return read_png(path, gray=gray)
    return read_jpeg(path, gray=gray)


class RGBXDataset:
    def __init__(self, setting, split_name, preprocess=None, file_length=None,
                 seed: int = 0):
        assert split_name in ("train", "val")
        self._split_name = split_name
        self._rgb_path = setting["rgb_root"]
        self._rgb_format = setting["rgb_format"]
        self._gt_path = setting["gt_root"]
        self._gt_format = setting["gt_format"]
        self._transform_gt = setting["transform_gt"]
        self._x_path = setting["x_root"]
        self._x_format = setting["x_format"]
        self._x_single_channel = setting["x_single_channel"]
        self.class_names = setting["class_names"]
        source = setting["train_source" if split_name == "train" else "eval_source"]
        with open(source) as f:
            self._file_names = [ln.strip() for ln in f if ln.strip()]
        self._file_length = file_length
        self.preprocess = preprocess
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._epoch_names = None

    def __len__(self):
        return self._file_length or len(self._file_names)

    def set_epoch(self, epoch: int):
        """Resample the oversampled name list for a new epoch."""
        if self._file_length is None:
            return
        n = len(self._file_names)
        # deterministic across interpreters/hosts (Python hash() is salted
        # per process, which would desync the shared epoch name list)
        rng = np.random.default_rng((self._seed, epoch))
        names = self._file_names * (self._file_length // n)
        extra = rng.permutation(n)[: self._file_length % n]
        names += [self._file_names[i] for i in extra]
        self._epoch_names = names

    def name_at(self, index: int) -> str:
        if self._file_length is not None:
            if self._epoch_names is None:
                self.set_epoch(0)
            return self._epoch_names[index]
        return self._file_names[index]

    def __getitem__(self, index, rng=None):
        item_name = self.name_at(index)
        rgb = self._open_rgb(
            os.path.join(self._rgb_path, item_name + self._rgb_format)
        )
        gt = self._open_gray(
            os.path.join(self._gt_path, item_name + self._gt_format)
        ).astype(np.uint8)
        if self._transform_gt:
            gt = gt - 1  # uint8 wraps 0 -> 255 = ignore, like the reference
        x_file = os.path.join(self._x_path, item_name + self._x_format)
        if self._x_single_channel:
            x = self._open_gray(x_file)
            x = np.stack([x, x, x], axis=-1)
        else:
            x = self._open_rgb(x_file)

        if self.preprocess is not None:
            rng = rng if rng is not None else self._rng
            out = self.preprocess(rng, rgb, gt, x)
            if isinstance(out, dict):  # device-norm path: extra fields
                out = dict(out)
                out.update(fn=str(item_name), n=len(self._file_names))
                return out
            rgb, gt, x = out
        return dict(
            data=rgb, label=gt, modal_x=x, fn=str(item_name),
            n=len(self._file_names),
        )

    @staticmethod
    def _open_rgb(path):
        return _read(path, gray=False)

    @staticmethod
    def _open_gray(path):
        return _read(path, gray=True)

    @classmethod
    def get_class_colors(cls, n: int = 41):
        """Bit-twiddled palette (RGBXDataset.py:108-129)."""
        cmap = np.zeros((n, 3), dtype=np.uint8)
        for i in range(n):
            r = g = b = 0
            cid = i
            for j in range(7):
                r ^= ((cid >> 0) & 1) << (7 - j)
                g ^= ((cid >> 1) & 1) << (7 - j)
                b ^= ((cid >> 2) & 1) << (7 - j)
                cid >>= 3
            cmap[i] = (r, g, b)
        return cmap.tolist()
