"""Config schema + per-dataset presets: the port's own copy of
`configs/base.py`, numpy only, with the same fields and defaults.

Field-for-field port of the reference easydict configs
(`configs/config_MFNet.py` etc. of the reference repo) with the JAX
package's extensions (bf16 flag, mesh shape, strict-parity optimizer
switch). `tests/test_torch_port_data.py` holds the two copies equal.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Config:
    # dataset
    dataset_name: str = "MFNet"
    dataset_path: str = "datasets/MFNet"
    rgb_folder: str = "RGB"
    rgb_format: str = ".png"
    gt_folder: str = "Label"
    gt_format: str = ".png"
    gt_transform: bool = False
    x_folder: str = "Modal"
    x_format: str = ".png"
    x_is_single_channel: bool = True
    train_source_name: str = "train2.txt"
    eval_source_name: str = "test.txt"
    num_train_imgs: int = 1176
    num_eval_imgs: int = 393
    num_classes: int = 9
    class_names: Sequence[str] = ()
    background: int = 255

    # image
    image_height: int = 480
    image_width: int = 640
    norm_mean: Sequence[float] = (0.485, 0.456, 0.406)
    norm_std: Sequence[float] = (0.229, 0.224, 0.225)

    # network
    backbone: str = "sigma_tiny"
    pretrained_model: Optional[str] = None  # VMamba ImageNet ckpt (.pth/.npz)
    decoder: str = "MambaDecoder"
    decoder_embed_dim: int = 512

    # train
    optimizer: str = "AdamW"
    lr: float = 6e-5
    lr_power: float = 0.9
    momentum: float = 0.9
    weight_decay: float = 0.01
    batch_size: int = 8
    nepochs: int = 500
    num_workers: int = 16
    train_scale_array: Optional[Sequence[float]] = (
        0.5, 0.75, 1, 1.25, 1.5, 1.75,
    )
    warm_up_epoch: int = 10
    fix_bias: bool = True
    bn_eps: float = 1e-3
    bn_momentum: float = 0.1
    seed: int = 3407

    # eval
    eval_stride_rate: float = 2 / 3
    eval_scale_array: Sequence[float] = (1,)
    eval_flip: bool = False
    eval_crop_size: Sequence[int] = (480, 640)

    # checkpoint policy
    checkpoint_start_epoch: int = 50
    checkpoint_step: int = 5
    # TPU-build extensions to the reference's best-only retention
    # (train.py:233-244): keep the k best-mIoU epochs, and optionally
    # overlap checkpoint IO with training (orbax async save)
    keep_best_k: int = 1
    async_checkpoint: bool = False

    # dirs
    log_dir: str = "log"
    checkpoint_dir: str = ""

    # --- TPU-build extensions ---
    bf16: bool = False  # bf16 matmul activations (scan stays fp32)
    # MambaDecoder deep-supervision aux heads; off upstream too
    # (reference builder.py:102, MambaDecoder.py:210-212)
    deep_supervision: bool = False
    # ship uint8 batches and normalize/zero-pad on device (4x less
    # host->device traffic; semantically identical)
    device_norm: bool = True
    scan_chunk: int = 128
    # Reproduce the reference trainer's optimizer-grouping quirk that leaves
    # raw SSM tensors (x_proj/dt_projs/A_logs/Ds/scale1/scale2) unstepped
    # (SURVEY.md §7(d), utils/init_func.py:33-58). Default False = train all.
    freeze_ssm_tensors: bool = False
    mesh_shape: Optional[Sequence[int]] = None  # data-parallel mesh

    @property
    def niters_per_epoch(self) -> int:
        return self.num_train_imgs // self.batch_size + 1

    @property
    def rgb_root_folder(self) -> str:
        return os.path.join(self.dataset_path, self.rgb_folder)

    @property
    def gt_root_folder(self) -> str:
        return os.path.join(self.dataset_path, self.gt_folder)

    @property
    def x_root_folder(self) -> str:
        return os.path.join(self.dataset_path, self.x_folder)

    @property
    def train_source(self) -> str:
        return os.path.join(self.dataset_path, self.train_source_name)

    @property
    def eval_source(self) -> str:
        return os.path.join(self.dataset_path, self.eval_source_name)

    def data_setting(self) -> dict:
        return dict(
            rgb_root=self.rgb_root_folder,
            rgb_format=self.rgb_format,
            gt_root=self.gt_root_folder,
            gt_format=self.gt_format,
            transform_gt=self.gt_transform,
            x_root=self.x_root_folder,
            x_format=self.x_format,
            x_single_channel=self.x_is_single_channel,
            class_names=list(self.class_names),
            train_source=self.train_source,
            eval_source=self.eval_source,
        )


_MFNET_CLASSES = [
    "unlabeled", "car", "person", "bike", "curve", "car stop", "guardrail",
    "color cone", "bump",
]
_PST900_CLASSES = [
    "Background", "Extinguisher", "Backpack", "Hand-Drill", "Survivor",
]
_NYU_CLASSES = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "blinds", "desk", "shelves",
    "curtain", "dresser", "pillow", "mirror", "floor mat", "clothes",
    "ceiling", "books", "refridgerator", "television", "paper", "towel",
    "shower curtain", "box", "whiteboard", "person", "night stand", "toilet",
    "sink", "lamp", "bathtub", "bag", "otherstructure", "otherfurniture",
    "otherprop",
]
_SUNRGBD_CLASSES = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "blinds", "desk", "shelves",
    "curtain", "dresser", "pillow", "mirror", "floor_mat", "clothes",
    "ceiling", "books", "fridge", "tv", "paper", "towel", "shower_curtain",
    "box", "whiteboard", "person", "night_stand", "toilet", "sink", "lamp",
    "bathtub", "bag",
]


def _mfnet(**kw) -> Config:
    return Config(
        dataset_name="MFNet",
        dataset_path=kw.pop("dataset_path", "datasets/MFNet"),
        num_train_imgs=1176,
        num_eval_imgs=393,
        num_classes=9,
        class_names=_MFNET_CLASSES,
        image_height=480,
        image_width=640,
        eval_crop_size=(480, 640),
        train_source_name="train2.txt",
        eval_source_name="test.txt",
        **kw,
    )


def _pst900(**kw) -> Config:
    return Config(
        dataset_name="PST900",
        dataset_path=kw.pop("dataset_path", "datasets/PST900"),
        rgb_folder="rgb_resize",
        gt_folder="labels_resize",
        x_folder="thermal_resize",
        num_train_imgs=597,
        num_eval_imgs=288,
        num_classes=5,
        class_names=_PST900_CLASSES,
        image_height=720,
        image_width=1280,
        eval_crop_size=(720, 1280),
        train_source_name="train.txt",
        eval_source_name="test.txt",
        **kw,
    )


def _nyu(**kw) -> Config:
    return Config(
        dataset_name="NYUDepthv2",
        dataset_path=kw.pop("dataset_path", "datasets/NYUDepthv2"),
        rgb_format=".jpg",
        gt_transform=True,
        x_folder="Depth",
        num_train_imgs=795,
        num_eval_imgs=654,
        num_classes=40,
        class_names=_NYU_CLASSES,
        image_height=480,
        image_width=640,
        eval_scale_array=(0.75, 1, 1.25),
        eval_flip=True,
        eval_crop_size=(480, 640),
        train_source_name="train2.txt",
        eval_source_name="test2.txt",
        **kw,
    )


def _sunrgbd(**kw) -> Config:
    return Config(
        dataset_name="SUNRGBD",
        dataset_path=kw.pop("dataset_path", "datasets/SUNRGBD"),
        rgb_format=".jpg",
        rgb_folder="RGB_resize",
        gt_folder="labels_resize",
        gt_transform=True,
        x_folder="Depth_resize",
        num_train_imgs=5285,
        num_eval_imgs=5050,
        num_classes=37,
        class_names=_SUNRGBD_CLASSES,
        image_height=480,
        image_width=640,
        eval_scale_array=(0.75, 1, 1.25),
        eval_flip=True,
        eval_crop_size=(480, 640),
        checkpoint_step=10,
        train_source_name="train2.txt",
        eval_source_name="test2.txt",
        **kw,
    )


_REGISTRY = {
    "mfnet": _mfnet,
    "pst900": _pst900,
    "pst": _pst900,
    "nyu": _nyu,
    "sunrgbd": _sunrgbd,
    "sun": _sunrgbd,
}


def get_config(name: str, **overrides) -> Config:
    key = name.lower().replace("-", "").replace("_", "")
    if key not in _REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(set(_REGISTRY))}")
    return _REGISTRY[key](**overrides)
