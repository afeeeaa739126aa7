"""Segmentation loss library of the port (counterpart of
`sigma_tpu/utils/losses.py`): the reference loss zoo
(`utils/loss_opr.py`; the shipped trainer uses only cross-entropy,
train.py:75, but the full set is part of the public surface).

All functions take channel-last logits (B, H, W, C) and integer labels
(B, H, W), compute in fp32 whatever the logits' dtype, and are
differentiable by autograd. Reductions are means over valid (not ignored)
pixels, as torch's NLL / CE with `ignore_index`. The reference's quirks
are kept, as the JAX package keeps them: `focal_loss_2d` squares whatever
`gamma` is, and `balance_loss` takes the softmax of exp(logits).

OHEM keeps the JAX package's static-shape rule (`ProbOhemCrossEntropy2d`,
loss_opr.py:137-187): a pixel is kept when its true-class probability is
at most max(thresh, the min_kept-th smallest), ignored pixels counting as
probability 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sigma_tpu_torch.models.builder import segmentation_loss


def _valid_nll(logp, labels, ignore_index, weight=None):
    """Mean over valid pixels of -logp[label] (weighted: the weighted mean,
    torch's NLL rule); 0 when no pixel is valid."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    if weight is not None:
        w = torch.as_tensor(weight, dtype=logp.dtype,
                            device=logp.device)[safe]
        nll = nll * w
        denom = torch.where(valid, w, torch.zeros_like(w)).sum()
    else:
        denom = valid.sum()
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / denom.clamp_min(1)


def cross_entropy(logits, labels, ignore_index: int = 255, weight=None):
    """torch CrossEntropyLoss(ignore_index) (train.py:75); unweighted, it is
    the train step's `segmentation_loss`."""
    if weight is None:
        return segmentation_loss(logits, labels, ignore_index)
    logp = F.log_softmax(logits.float(), dim=-1)
    return _valid_nll(logp, labels, ignore_index, weight)


def focal_loss_2d(logits, labels, gamma: float = 0.0, weight=None,
                  ignore_index: int = 255):
    """FocalLoss2d (loss_opr.py:12-23): NLL of (1-p)^2 * log p. The
    reference squares regardless of `gamma`; so does this."""
    del gamma  # the reference's exponent is a literal 2
    logits = logits.float()
    p = F.softmax(logits, dim=-1)
    mod = (1.0 - p) ** 2 * F.log_softmax(logits, dim=-1)
    return _valid_nll(mod, labels, ignore_index, weight)


def balance_loss(logits, labels, ignore_index: int = 255, weight=None):
    """BalanceLoss (loss_opr.py:63-80): log-softmax scaled by
    (1 - softmax(exp(logits)))^2."""
    logits = logits.float()
    prob = F.softmax(torch.exp(logits), dim=-1)
    mod = F.log_softmax(logits, dim=-1) * (1.0 - prob) ** 2
    return _valid_nll(mod, labels, ignore_index, weight)


def berhu_loss(pred, target, delta: float = 0.2, ignore_index: int = 0):
    """berHuLoss (loss_opr.py:82-101): reverse-Huber regression loss with
    threshold delta * max|err| over valid pixels."""
    pred = pred.float()
    target = target.float()
    valid = (target != ignore_index).float()
    err = (pred - target).abs() * valid
    d = delta * err.max()
    f_mask = (target <= d).float() * valid
    s_mask = (1.0 - f_mask) * valid
    f_part = err * f_mask
    s_part = (err ** 2 + d ** 2) / (2 * d).clamp_min(1e-12) * s_mask
    return (f_part + s_part).mean()


def sigmoid_focal_loss(logits, labels, ignore_index: int,
                       gamma: float = 2.0, alpha: float = 0.25):
    """SigmoidFocalLoss (loss_opr.py:104-134); logits (B, H, W) binary."""
    b = logits.shape[0]
    sig = torch.sigmoid(logits.reshape(b, -1, 1).float())
    t = labels.reshape(b, -1).float()
    mask = (t != ignore_index).float()
    onehot = (mask * t)[..., None]
    max_val = (-sig).clamp_min(0)
    pos = (1 - sig) ** gamma * (sig - sig * onehot)
    neg = sig ** gamma * (
        max_val + torch.log(torch.exp(-max_val) + torch.exp(-sig - max_val)))
    loss = -(alpha * pos + (1 - alpha) * neg).sum(-1) * mask
    return loss.mean()


def ohem_kept(logits, labels, ignore_index: int = 255, thresh: float = 0.6,
              min_kept: int = 256):
    """OHEM's kept mask (B, H, W): valid pixels whose true-class
    probability is at most max(thresh, the min_kept-th smallest), ignored
    pixels counting as probability 1."""
    c = logits.shape[-1]
    flat_labels = labels.reshape(-1)
    valid = flat_labels != ignore_index
    safe = torch.where(valid, flat_labels,
                       torch.zeros_like(flat_labels)).long()
    prob = F.softmax(logits.float().reshape(-1, c), dim=-1)
    true_prob = prob.gather(-1, safe[:, None])[:, 0]
    true_prob = torch.where(valid, true_prob, torch.ones_like(true_prob))
    k = min(min_kept, flat_labels.shape[0])
    threshold = torch.tensor(thresh, device=logits.device)
    if k > 0:
        kth = torch.topk(true_prob, k, largest=False).values[-1]
        threshold = torch.maximum(threshold, kth)
    return (valid & (true_prob <= threshold)).reshape(labels.shape)


def ohem_cross_entropy(logits, labels, ignore_index: int = 255,
                       thresh: float = 0.6, min_kept: int = 256,
                       weight=None):
    """ProbOhemCrossEntropy2d (loss_opr.py:137-187), static-shape version:
    cross-entropy over the hard pixels (`ohem_kept`). The selection takes
    no gradient, as in the reference."""
    with torch.no_grad():
        kept = ohem_kept(logits, labels, ignore_index, thresh, min_kept)
    new_labels = torch.where(kept, labels,
                             torch.full_like(labels, ignore_index))
    return cross_entropy(logits, new_labels, ignore_index, weight)


def rce_loss(logits, labels, num_classes: int, ignore_index: int = 255,
             beta: float = 0.01):
    """RCELoss (loss_opr.py:26-61): CE plus beta * reverse term
    NLL(log(clamped onehot(target)), argmax(pred)) averaged with the valid
    mask."""
    logits = logits.float()
    loss1 = cross_entropy(logits, labels, ignore_index)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    onehot = F.one_hot(safe, num_classes).float().clamp(1e-9, 1.0 - 1e-9)
    log_onehot = torch.log(onehot)
    max_id = logits.argmax(-1)
    nll2 = -log_onehot.gather(-1, max_id[..., None])[..., 0]
    loss2 = (nll2 * valid.float()).mean()
    return loss1 + beta * loss2
