"""Host-side (numpy + integer torch ops on the CPU, and a C++ tail)
augmentation pipeline: the port's copy of `sigma_tpu/data/transforms.py`.

Mirrors the reference preprocessing exactly (the reference's
`dataloader/dataloader.py:8-54` and `utils/transforms.py`):

  TrainPre: random horizontal mirror -> random scale from
  `train_scale_array` (bilinear img / nearest gt) -> ImageNet-normalize BOTH
  rgb and modal-x -> random crop + center-pad to (H, W) with pad value 0 for
  images and 255 for labels.

Outputs stay HWC (channel-last) — the model is NHWC-native, unlike the
reference's CHW transpose (dataloader.py:47-48). The rescale is
`resize.resize_u8` on CPU tensors, cv2's `INTER_LINEAR` / `INTER_NEAREST`
bit for bit, so no cv2 is needed. With `device_norm` off, the tail after
the rescale (normalize + crop + center-pad) runs as the JAX package's
native fused pass (`data/native.py`) unless `use_native=False` asks for
the numpy path.
"""

from __future__ import annotations

import numpy as np
import torch

from sigma_tpu_torch.data import native
from sigma_tpu_torch.data.resize import resize_u8


def normalize(img, mean, std):
    """(img/255 - mean) / std  (utils/transforms.py:182-187)."""
    img = img.astype(np.float32) / 255.0
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _resize(img, sw, sh, nearest=False):
    """`cv2.resize(img, (sw, sh))`, bilinear or nearest, on the CPU."""
    return resize_u8(torch.from_numpy(np.ascontiguousarray(img)), (sw, sh),
                     interpolation="nearest" if nearest else "linear").numpy()


def random_mirror(rng, rgb, gt, modal_x):
    if rng.random() >= 0.5:
        rgb = rgb[:, ::-1]
        gt = gt[:, ::-1]
        modal_x = modal_x[:, ::-1]
    return np.ascontiguousarray(rgb), np.ascontiguousarray(gt), np.ascontiguousarray(modal_x)


def random_scale(rng, rgb, gt, modal_x, scales):
    scale = scales[int(rng.integers(len(scales)))]
    sh = int(rgb.shape[0] * scale)
    sw = int(rgb.shape[1] * scale)
    return (
        _resize(rgb, sw, sh),
        _resize(gt, sw, sh, nearest=True),
        _resize(modal_x, sw, sh),
        scale,
    )


def generate_random_crop_pos(rng, ori_size, crop_size):
    h, w = ori_size
    crop_h, crop_w = crop_size
    pos_h = int(rng.integers(0, h - crop_h + 2)) if h > crop_h else 0
    pos_w = int(rng.integers(0, w - crop_w + 2)) if w > crop_w else 0
    return pos_h, pos_w


def pad_image_to_shape(img, shape, value):
    """Center-pad to at least `shape`; returns (img, margin[t,b,l,r])."""
    pad_h = max(0, shape[0] - img.shape[0])
    pad_w = max(0, shape[1] - img.shape[1])
    margin = (pad_h // 2, pad_h - pad_h // 2, pad_w // 2, pad_w - pad_w // 2)
    if pad_h or pad_w:
        pad = [(margin[0], margin[1]), (margin[2], margin[3])]
        if img.ndim == 3:
            pad.append((0, 0))
        img = np.pad(img, pad, mode="constant", constant_values=value)
    return img, margin


def random_crop_pad_to_shape(img, crop_pos, crop_size, pad_value):
    start_h, start_w = crop_pos
    crop_h, crop_w = crop_size
    img_crop = img[start_h : start_h + crop_h, start_w : start_w + crop_w]
    return pad_image_to_shape(img_crop, crop_size, pad_value)


class TrainPre:
    """Train-time augmentation. The draws are the JAX package's, in the same
    order, so a given (seed, index) yields the same geometry. With
    `device_norm` off, the post-resize tail (normalize + crop + center-pad)
    runs as ONE fused C++ pass per output pixel (`data/native.py`,
    `use_native`, which raises if the library cannot be built); the numpy
    path below (`use_native=False`) is the semantic reference. Both consume
    the same draws."""

    def __init__(self, norm_mean, norm_std, config, use_native: bool = True,
                 device_norm: bool = False):
        self.norm_mean = np.asarray(norm_mean, np.float32)
        self.norm_std = np.asarray(norm_std, np.float32)
        self.config = config
        self.use_native = use_native
        # device_norm: emit uint8 canvases + pad margins and let the train
        # step normalize/zero-pad on device — 4x less host->device traffic
        self.device_norm = device_norm

    def _draws(self, rng):
        cfg = self.config
        mirror = bool(rng.random() >= 0.5)
        scale = None
        if cfg.train_scale_array is not None:
            scale = cfg.train_scale_array[
                int(rng.integers(len(cfg.train_scale_array)))
            ]
        return mirror, scale

    def __call__(self, rng, rgb, gt, modal_x):
        cfg = self.config
        crop_size = (cfg.image_height, cfg.image_width)
        mirror, scale = self._draws(rng)

        if mirror:
            rgb = np.ascontiguousarray(rgb[:, ::-1])
            gt = np.ascontiguousarray(gt[:, ::-1])
            modal_x = np.ascontiguousarray(modal_x[:, ::-1])
        if scale is not None:
            sh = int(rgb.shape[0] * scale)
            sw = int(rgb.shape[1] * scale)
            rgb = _resize(rgb, sw, sh)
            gt = _resize(gt, sw, sh, nearest=True)
            modal_x = _resize(modal_x, sw, sh)

        crop_pos = generate_random_crop_pos(rng, rgb.shape[:2], crop_size)
        # the copied region and where it lands in the centre-padded canvas
        h, w = rgb.shape[:2]
        ch, cw = crop_size
        copy_h = min(ch, h - crop_pos[0])
        copy_w = min(cw, w - crop_pos[1])
        pad_t = (ch - copy_h) // 2
        pad_l = (cw - copy_w) // 2

        if self.device_norm:
            def crop_pad_u8(img, pad_val):
                sl = img[crop_pos[0] : crop_pos[0] + copy_h,
                         crop_pos[1] : crop_pos[1] + copy_w]
                pads = [(pad_t, ch - copy_h - pad_t),
                        (pad_l, cw - copy_w - pad_l)]
                if img.ndim == 3:
                    pads.append((0, 0))
                return np.pad(sl, pads, constant_values=pad_val)

            return dict(
                data=crop_pad_u8(rgb.astype(np.uint8), 0),
                label=crop_pad_u8(gt.astype(np.uint8), 255),
                modal_x=crop_pad_u8(modal_x.astype(np.uint8), 0),
                margins=np.array(
                    [pad_t, ch - copy_h - pad_t, pad_l, cw - copy_w - pad_l],
                    np.int32,
                ),
            )

        if self.use_native:
            args = (crop_size, crop_pos, (pad_t, pad_l), (copy_h, copy_w))
            p_rgb = native.fused_image_aug(
                rgb, *args, self.norm_mean, self.norm_std, 0.0, False
            )
            p_x = native.fused_image_aug(
                modal_x, *args, self.norm_mean, self.norm_std, 0.0, False
            )
            p_gt = native.fused_label_aug(gt, *args, 255, False)
            return p_rgb, p_gt, p_x

        rgb = normalize(rgb, self.norm_mean, self.norm_std)
        modal_x = normalize(modal_x, self.norm_mean, self.norm_std)
        p_rgb, _ = random_crop_pad_to_shape(rgb, crop_pos, crop_size, 0)
        p_gt, _ = random_crop_pad_to_shape(gt, crop_pos, crop_size, 255)
        p_x, _ = random_crop_pad_to_shape(modal_x, crop_pos, crop_size, 0)
        return (
            p_rgb.astype(np.float32),
            p_gt.astype(np.int32),
            p_x.astype(np.float32),
        )


class ValPre:
    def __call__(self, rng, rgb, gt, modal_x):
        return rgb, gt, modal_x
