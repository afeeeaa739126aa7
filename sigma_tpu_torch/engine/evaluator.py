"""Sliding-window multi-scale evaluator on one device (counterpart of
`sigma_tpu/engine/evaluator.py`), with the reference protocol's quirks
(reference engine/evaluator.py:433-559):

  * whole-image branch when EITHER dimension fits the crop (OR condition),
    with a center pad and a margin crop;
  * the window grid's stride index swap (x steps by the ROW stride, the
    window's x-extent is the crop height), kept verbatim because the
    published mIoU was measured under it, windows center-padded to the
    crop;
  * flip TTA sums LOGITS before exp; exp-scores accumulate per window,
    each scale's score is resized to the original shape, scales are
    summed, argmax at the end;
  * normalisation: ImageNet stats for 3-channel modal-x, (0, 1) for 2-D.

The uint8 image goes to the device once; the per-scale input resize
(`data/resize.py`: cv2's `INTER_LINEAR`, `INTER_NEAREST` for a 2-D
modal-x, bit for bit, in the `fx=fy=s` form; skipped at scale 1.0),
normalisation, padding, windows, flip, exp, accumulation and the resize
back run there, and only the argmax map returns. No cv2 is needed.

`image_batch` (default 1) groups same-shaped images, as the JAX
evaluator's `run` does: each group goes through the window passes
together (its windows share the model's batch), a short tail group is
padded by repeating its last image and the padded predictions are
dropped.

Data parallel (torch.distributed initialised): rank r evaluates images
r, r + world, ... and the int64 confusion matrix and the labeled and
correct counts are all-reduced, as the JAX evaluator's are across its
processes, so every rank returns the scores of the whole set. The model
is the bare module, not a DDP wrapper: a wrapper's forward is a
collective, which ranks with unequal image counts would not all enter.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sigma_tpu_torch.data.resize import resize_u8
from sigma_tpu_torch.engine.logger import get_logger
from sigma_tpu_torch.models.builder import require_device
from sigma_tpu_torch.models.common import resize_linear
from sigma_tpu_torch.parallel.dist import all_reduce_sum, rank, world
from sigma_tpu_torch.utils.metrics import compute_score, hist_info


def _pad_hwc(x, top, bottom, left, right):
    return F.pad(x, (0, 0, left, right, top, bottom))


class SlidingEvaluator:
    def __init__(self, model, num_classes: int, norm_mean, norm_std,
                 multi_scales: Sequence[float] = (1.0,),
                 is_flip: bool = False,
                 eval_crop_size: Sequence[int] = (480, 640),
                 stride_rate: float = 2 / 3, window_batch: int = 8,
                 image_batch: int = 1, device="cuda"):
        """`model(rgb, modal_x)`: NHWC float tensors -> NHWC logits, on
        `device` (the card unless the caller asks for the CPU).
        `image_batch`: same-shaped images `run` evaluates together."""
        self.model = model
        self.class_num = num_classes
        self.device = require_device(device)
        self.norm_mean = torch.as_tensor(np.asarray(norm_mean, np.float32),
                                         device=self.device)
        self.norm_std = torch.as_tensor(np.asarray(norm_std, np.float32),
                                        device=self.device)
        self.multi_scales = tuple(multi_scales)
        self.is_flip = is_flip
        self.eval_crop_size = tuple(eval_crop_size)
        self.stride_rate = stride_rate
        self.window_batch = max(1, int(window_batch))
        self.image_batch = max(1, int(image_batch))

    def _scale_geometry(self, rows, cols):
        """(pad_hw, margin, spans, wmargin) for one scaled image: the
        whole-image OR-branch, the stride/extent index swap, the
        negative-start window collapse it implies when crop_w > rows
        (numpy slice semantics, normalised), and the per-window center pad
        back to the crop."""
        ch, cw = self.eval_crop_size
        if cols <= cw or rows <= ch:
            ph, pw = max(rows, ch), max(cols, cw)
            pad_h, pad_w = ph - rows, pw - cols
            margin = (pad_h // 2, pad_h - pad_h // 2,
                      pad_w // 2, pad_w - pad_w // 2)
            return (ph, pw), margin, ((0, ph, 0, pw),), (0, 0, 0, 0)
        stride = (int(np.ceil(ch * self.stride_rate)),
                  int(np.ceil(cw * self.stride_rate)))
        r_grid = int(np.ceil((rows - ch) / stride[0])) + 1
        c_grid = int(np.ceil((cols - cw) / stride[1])) + 1
        spans = []
        for gy in range(r_grid):
            for gx in range(c_grid):
                # stride/extent index swap kept from the reference
                s_x = gx * stride[0]
                s_y = gy * stride[1]
                e_x = min(s_x + ch, cols)
                e_y = min(s_y + cw, rows)
                s_x = e_x - ch
                s_y = e_y - cw
                if s_y < 0:
                    s_y += rows
                if s_x < 0:
                    s_x += cols
                spans.append((s_y, e_y, s_x, e_x))
        wh, ww = spans[0][1] - spans[0][0], spans[0][3] - spans[0][2]
        pad_h, pad_w = max(0, ch - wh), max(0, cw - ww)
        wmargin = (pad_h // 2, pad_h - pad_h // 2,
                   pad_w // 2, pad_w - pad_w // 2)
        return (rows, cols), (0, 0, 0, 0), tuple(spans), wmargin

    def _normalize(self, img, modal_x):
        """uint8 (N, H, W, 3) and (N, H, W[, 3]) on the device -> float
        NHWC."""
        mean, std = self.norm_mean, self.norm_std
        rgb = (img.float() / 255.0 - mean) / std
        mx = modal_x.float() / 255.0
        if mx.ndim == 3:  # 2-D modal-x: (0, 1) scaling, channel-tripled
            mx = mx[..., None].expand(-1, -1, -1, 3)
        else:
            mx = (mx - mean) / std
        return rgb, mx

    def _window_scores(self, wr, wx):
        """exp(logits) of a batch of windows; flip TTA rides the batch."""
        n = wr.shape[0]
        if self.is_flip:
            logits = self.model(torch.cat([wr, wr.flip(2)]),
                                torch.cat([wx, wx.flip(2)]))
            logits = logits[:n] + logits[n:].flip(2)
        else:
            logits = self.model(wr, wx)
        return torch.exp(logits.float())

    def scale_process(self, img, modal_x, ori_shape):
        """One scale's (N, ori_h, ori_w, C) score maps on the device, for
        N same-shaped uint8 images (N, h, w, 3) / modal-x (N, h, w[, 3])
        already there; the N images' windows share each model call."""
        n, rows, cols = img.shape[:3]
        (ph, pw), margin, spans, wm = self._scale_geometry(rows, cols)
        rgb, mx = self._normalize(img, modal_x)
        # zero pad AFTER normalisation (the reference pads the normalised
        # image with 0)
        pad = (margin[0], ph - rows - margin[0],
               margin[2], pw - cols - margin[2])
        rgb, mx = _pad_hwc(rgb, *pad), _pad_hwc(mx, *pad)
        canvas = torch.zeros((n, ph, pw, self.class_num),
                             dtype=torch.float32, device=self.device)
        for c0 in range(0, len(spans), self.window_batch):
            chunk = spans[c0:c0 + self.window_batch]
            wr = torch.cat([rgb[:, a:b, c:d] for a, b, c, d in chunk])
            wx = torch.cat([mx[:, a:b, c:d] for a, b, c, d in chunk])
            if wm != (0, 0, 0, 0):  # windows center-padded to the crop
                wr, wx = _pad_hwc(wr, *wm), _pad_hwc(wx, *wm)
            scores = self._window_scores(wr, wx)
            sh, sw = scores.shape[1:3]
            scores = scores[:, wm[0]:sh - wm[1], wm[2]:sw - wm[3]]
            for (a, b, c, d), s in zip(chunk, scores.split(n)):
                canvas[:, a:b, c:d] += s
        score = canvas[:, margin[0]:ph - margin[1], margin[2]:pw - margin[3]]
        if tuple(score.shape[1:3]) != tuple(ori_shape):
            score = resize_linear(score, *ori_shape, antialias=False)
        return score

    @staticmethod
    def _resize_scale(img, modal_x, s):
        """cv2.resize(fx=fy=s) of one uint8 image and its modal-x on their
        device: bilinear, nearest for a 2-D modal-x (the JAX evaluator's
        `_resize_scale`)."""
        if s == 1.0:
            return img, modal_x
        mode = "nearest" if modal_x.ndim == 2 else "linear"
        return (resize_u8(img, fx=s),
                resize_u8(modal_x, fx=s, interpolation=mode))

    @torch.inference_mode()
    def batch_scores(self, imgs, modal_xs):
        """Sum over scales of the (N, H, W, C) score maps of N
        same-shaped images, on the device."""
        img = torch.from_numpy(np.stack(imgs)).to(self.device)
        mx = torch.from_numpy(np.stack(modal_xs)).to(self.device)
        acc = None
        for s in self.multi_scales:
            pairs = [self._resize_scale(a, b, s) for a, b in zip(img, mx)]
            sc = self.scale_process(torch.stack([p[0] for p in pairs]),
                                    torch.stack([p[1] for p in pairs]),
                                    img.shape[1:3])
            acc = sc if acc is None else acc + sc
        return acc

    def scores(self, img, modal_x):
        """Sum over scales of the (H, W, C) score map, on the device."""
        return self.batch_scores([img], [modal_x])[0]

    def sliding_eval_batch(self, imgs, modal_xs):
        """N same-shaped uint8 images + modal-x -> (N, H, W) int32."""
        acc = self.batch_scores(imgs, modal_xs)
        return acc.argmax(dim=3).int().cpu().numpy()

    def sliding_eval(self, img, modal_x):
        """uint8 HWC image + modal-x -> (H, W) int32 prediction."""
        return self.sliding_eval_batch([img], [modal_x])[0]

    def run(self, dataset, save_fn: Optional[Callable] = None,
            log_every: int = 50):
        """Evaluate all items (this rank's share of them); returns
        (mean_iou*100, detail dict) of the whole set."""
        logger = get_logger()
        hist = np.zeros((self.class_num, self.class_num), np.int64)
        correct = labeled = done = 0
        t0 = time.time()
        group: list = []

        def flush():
            nonlocal hist, correct, labeled, done
            k = len(group)
            padded = group + [group[-1]] * (self.image_batch - k)
            preds = self.sliding_eval_batch([it["data"] for it in padded],
                                            [it["modal_x"] for it in padded])
            for item, pred in zip(group, preds[:k]):
                h, lab, cor = hist_info(self.class_num, pred,
                                        item["label"].astype(np.int64))
                hist += h
                labeled += lab
                correct += cor
                if save_fn is not None:
                    save_fn(item["fn"], pred)
                done += 1
                if done % log_every == 0:
                    logger.info("eval %d (%.2fs/img)", done,
                                (time.time() - t0) / done)
            group.clear()

        def shape(item):
            return item["data"].shape, item["modal_x"].shape

        for i in range(rank(), len(dataset), world()):
            item = dataset[i]
            if group and shape(item) != shape(group[0]):
                flush()
            group.append(item)
            if len(group) == self.image_batch:
                flush()
        if group:
            flush()
        stats = torch.as_tensor(
            np.concatenate([hist.reshape(-1), [labeled, correct]]),
            dtype=torch.int64, device=self.device)
        stats = all_reduce_sum(stats).cpu().numpy()
        hist = stats[:-2].reshape(hist.shape)
        labeled, correct = int(stats[-2]), int(stats[-1])
        iou, mean_iou, miou_nb, fwiou, macc, pacc = compute_score(
            hist, correct, labeled)
        return mean_iou * 100.0, dict(
            iou=iou, mean_iou=mean_iou, mean_iou_no_back=miou_nb,
            freq_iou=fwiou, mean_pixel_acc=macc, pixel_acc=pacc,
        )
