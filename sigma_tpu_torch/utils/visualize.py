"""IoU table and prediction PNGs for the eval CLI (counterpart of
`sigma_tpu/utils/visualize.py`, whose format it keeps)."""

from __future__ import annotations

import os

import numpy as np

from sigma_tpu_torch.data.png import write_png


def print_iou(iou, mean_pixel_acc, pixel_acc, class_names=None):
    """Per-class IoU table; returns the printed string."""
    lines = []
    for i in range(iou.size):
        cls = (f"Class {i + 1}" if class_names is None
               else f"{i + 1} {class_names[i]}")
        lines.append(f"{cls:<24} IoU {iou[i] * 100:.3f}%")
    lines.append("-" * 60)
    lines.append(f"mean IoU {np.nanmean(iou) * 100:.3f}% "
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
    colored = np.zeros((*pred.shape, 3), np.uint8)
    for i, c in enumerate(colors):
        colored[pred == i] = c
    colored[pred == background] = 255
    write_png(os.path.join(save_dir + "_color", fn + ".png"), colored)
