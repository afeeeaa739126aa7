"""Segmentation metrics (confusion-matrix mIoU family): the port's copy of
`sigma_tpu/utils/metrics.py`.

Mirrors the reference's `utils/metric.py:8-30`: pixels with gt outside
[0, n_classes) — including the 255 ignore label — are excluded from the
confusion matrix; scores are per-class IoU, mean IoU (nanmean), mean IoU
without background class 0, frequency-weighted IoU, mean per-class accuracy
and overall pixel accuracy.
"""

from __future__ import annotations

import numpy as np


def hist_info(n_cl: int, pred: np.ndarray, gt: np.ndarray):
    """Confusion matrix over valid pixels. Returns (hist, correct, labeled)."""
    assert pred.shape == gt.shape
    k = (gt >= 0) & (gt < n_cl)
    labeled = int(np.sum(k))
    correct = int(np.sum((pred[k] == gt[k])))
    hist = np.bincount(
        n_cl * gt[k].astype(np.int64) + pred[k].astype(np.int64),
        minlength=n_cl**2,
    ).reshape(n_cl, n_cl)
    return hist, labeled, correct


def compute_score(hist: np.ndarray, correct: int, labeled: int):
    """Returns (iou, mean_IoU, mean_IoU_no_back, fwIoU, mean_pixel_acc,
    pixel_acc) — all percentages except the per-class array."""
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.diag(hist) / (
            hist.sum(1) + hist.sum(0) - np.diag(hist)
        )
        mean_iou = float(np.nanmean(iou))
        mean_iou_no_back = float(np.nanmean(iou[1:]))
        freq = hist.sum(1) / hist.sum()
        freq_iou = float((freq[freq > 0] * iou[freq > 0]).sum())
        cls_acc = np.diag(hist) / hist.sum(1)
        mean_pixel_acc = float(np.nanmean(cls_acc))
    pixel_acc = correct / max(labeled, 1)
    return iou, mean_iou, mean_iou_no_back, freq_iou, mean_pixel_acc, pixel_acc
