"""Train state and train step (counterpart of `sigma_tpu/engine/train.py`).

One call of the step computes the loss (CE, ignore 255, in fp32),
backpropagates through the model (the scans' backward runs in the Hopper
kernels on the card), and applies the optimizer with the lr of its
schedule at this step. A model built with `cfg.bf16` computes in bf16
(models/common.py): its parameters, their gradients and the optimizer's
state stay fp32, the batch is normalised in fp32 and the first layer
casts it, as in the JAX package.

Data parallel (the counterpart of JAX's step over its data mesh): in a
rank of `--distributed` training (parallel/dist.py), each rank steps on
its shard of the global batch through DistributedDataParallel; the loss
is the global batch's mean and the drop-path masks are those of one
process over the global batch (models/builder.py, models/common.py), so
the update is the one-process step's on the whole global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from sigma_tpu_torch.engine.optim import build_optimizer
from sigma_tpu_torch.models.builder import build_model, segmentation_loss
from sigma_tpu_torch.models.common import set_drop_path_seeds
from sigma_tpu_torch.parallel.dist import (
    all_reduce_sum,
    data_parallel,
    rank,
    world,
)
from sigma_tpu_torch.utils.lr_schedule import warmup_poly_lr

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0  # updates applied so far


def create_train_state(model: nn.Module,
                       optimizer: torch.optim.Optimizer) -> TrainState:
    return TrainState(model=model, optimizer=optimizer, step=0)


def prepare_batch(batch, device, mean, std):
    """(rgb, modal_x, labels) on `device`. A uint8 batch (the device-norm
    input path: 4x less host-to-device traffic) is normalised there and its
    pad margins (key "margins", (B, 4) = top/bottom/left/right) are zeroed
    after normalisation, as the host float pipeline pads the normalised
    image with 0 (train.py:72-92 of the JAX package)."""
    def to(x):
        return torch.as_tensor(x).to(device, non_blocking=True)

    data, mx, labels = to(batch["data"]), to(batch["modal_x"]), to(
        batch["label"])
    if data.dtype != torch.uint8:
        return data.float(), mx.float(), labels.long()
    mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
    std = torch.as_tensor(std, dtype=torch.float32, device=device)
    _, h, w, _ = data.shape
    m = to(batch["margins"]).long()  # (B, 4)
    rows = torch.arange(h, device=device)[None, :, None]
    cols = torch.arange(w, device=device)[None, None, :]
    mask = ((rows >= m[:, 0, None, None])
            & (rows < h - m[:, 1, None, None])
            & (cols >= m[:, 2, None, None])
            & (cols < w - m[:, 3, None, None]))[..., None]

    def norm(img):
        return (img.float() / 255.0 - mean) / std * mask

    return norm(data), norm(mx), labels.long()


def make_train_step(model: nn.Module, opt: torch.optim.Optimizer,
                    schedule: Callable[[int], float], norm_mean=None,
                    norm_std=None, dropout_seed: int = 0) -> Callable:
    """Returns train_step(state, batch) -> loss (a 0-d device tensor).

    The loss is the JAX step's: the main head's CE, plus each
    deep-supervision head's CE at unit weight, or plus `model.aux_rate`
    times the FCN aux head's CE (`model(rgb, modal_x, return_aux=True)`
    gives (logits, aux)). The model runs in train mode: BatchNorm
    normalises with the batch's statistics (the global batch's in a
    data-parallel rank) and moves its running statistics once a step.

    batch: {"data": (B,H,W,3), "modal_x": (B,H,W,3), "label": (B,H,W)}
    numpy or tensors, uint8 with "margins" or float. The update with
    0-based index k = state.step uses lr schedule(k) (optax's count
    convention). DropPath draws from generators seeded by
    (dropout_seed, k), the counterpart of fold_in(rng, step); the CLI
    passes cfg.seed + 1 as the JAX trainer does. The decoders' dropout
    draws the same way (models/common.py::Dropout).

    Made in a rank of data-parallel training (`dist.data_parallel()`),
    the step is that rank's: its batch is its shard of the global batch,
    in rank order, and the loss returned is the global batch's. `model`
    stays the bare module (its state_dict keys carry no DDP prefix); the
    DDP wrapper lives in the step.
    """
    mean = norm_mean if norm_mean is not None else IMAGENET_MEAN
    std = norm_std if norm_std is not None else IMAGENET_STD
    device = next(model.parameters()).device
    parallel = data_parallel()
    shard, shards = rank(), world()
    net = model
    if parallel:
        # BatchNorm's statistics are the global batch's on every rank
        # (models/norm.py), so its running buffers agree without DDP's
        # broadcast of rank 0's
        net = DistributedDataParallel(
            model,
            device_ids=[device.index] if device.type == "cuda" else None,
            broadcast_buffers=False)

    def train_step(state: TrainState, batch):
        lr = float(schedule(state.step))
        for group in opt.param_groups:
            group["lr"] = lr
        rgb, mx, labels = prepare_batch(batch, device, mean, std)
        b = rgb.shape[0]
        set_drop_path_seeds(model, dropout_seed, state.step,
                            rows=(shard * b, b, shards * b))
        net.train()
        opt.zero_grad(set_to_none=True)
        logits, aux = net(rgb, mx, return_aux=True)
        share = segmentation_loss(logits, labels, sharded=parallel)
        if isinstance(aux, list):  # deep-supervision heads, unit weight
            for a in aux:
                share = share + segmentation_loss(a, labels,
                                                  sharded=parallel)
        elif aux is not None:  # the FCN aux head, at the model's aux_rate
            share = share + model.aux_rate * segmentation_loss(
                aux, labels, sharded=parallel)
        # DDP averages the ranks' gradients: scaled by the world size,
        # their average is the gradient of the global mean (the shares' sum)
        (share * shards).backward()
        opt.step()
        state.step += 1
        return all_reduce_sum(share.detach().clone())

    return train_step


def build_train(cfg, device="cuda"):
    """The train step of a config as the train CLI runs it: the model
    seeded from cfg.seed on `device` (the card unless the caller asks for
    the CPU), in bf16 compute when cfg.bf16 is set, cfg's optimizer,
    warmup-poly lr over cfg's epochs, drop path seeded from cfg.seed + 1,
    data parallel in a rank of `--distributed` training. Returns
    (state, train_step, schedule)."""
    model = build_model(cfg, device=device, seed=cfg.seed)
    schedule = warmup_poly_lr(cfg.lr, cfg.lr_power,
                              cfg.nepochs * cfg.niters_per_epoch,
                              cfg.niters_per_epoch * cfg.warm_up_epoch)
    opt = build_optimizer(cfg, model)
    step = make_train_step(model, opt, schedule, cfg.norm_mean, cfg.norm_std,
                           dropout_seed=cfg.seed + 1)
    return create_train_state(model, opt), step, schedule
