"""IoU table, palette colouring and prediction PNGs for the eval CLI
(counterpart of `sigma_tpu/utils/visualize.py`, whose formats it keeps)."""

from __future__ import annotations

import os

import numpy as np

from sigma_tpu_torch.data.png import write_png


def set_img_color(colors, background, img, pred):
    """Paint `img` (H, W, 3) in place with the palette colour of each class
    of `pred`, and white where `pred` is `background`; returns `img`."""
    for i in range(len(colors)):
        img[pred == i] = colors[i]
    if background in np.unique(pred):
        img[pred == background] = 255
    return img


def get_colored_pred(colors, background, pred):
    """The palette-coloured (H, W, 3) uint8 image of a label map."""
    im = np.zeros((*pred.shape, 3), np.uint8)
    return set_img_color(colors, background, im, pred)


def print_iou(iou, mean_pixel_acc, pixel_acc, class_names=None,
              show_no_back=False):
    """Per-class IoU table; returns the printed string. `show_no_back` adds
    the mean IoU without class 0 (the background)."""
    lines = []
    for i in range(iou.size):
        cls = (f"Class {i + 1}" if class_names is None
               else f"{i + 1} {class_names[i]}")
        lines.append(f"{cls:<24} IoU {iou[i] * 100:.3f}%")
    no_back = (f"mean IoU (no back) {np.nanmean(iou[1:]) * 100:.3f}% "
               if show_no_back else "")
    lines.append("-" * 60)
    lines.append(f"mean IoU {np.nanmean(iou) * 100:.3f}% {no_back}"
                 f"mean pixel acc {mean_pixel_acc * 100:.3f}% "
                 f"pixel acc {pixel_acc * 100:.3f}%")
    out = "\n".join(lines)
    print(out)
    return out


def save_prediction(save_dir: str, fn: str, pred, colors, background=255):
    """Raw label PNG + palette-colored PNG, written by `data/png.py`."""
    os.makedirs(save_dir, exist_ok=True)
    os.makedirs(save_dir + "_color", exist_ok=True)
    write_png(os.path.join(save_dir, fn + ".png"), pred.astype(np.uint8))
    write_png(os.path.join(save_dir + "_color", fn + ".png"),
              get_colored_pred(colors, background, pred))
