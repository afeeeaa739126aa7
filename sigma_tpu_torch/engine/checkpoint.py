"""Epoch checkpoints with the JAX trainer's retention policy (counterpart of
`sigma_tpu/engine/checkpoint.py`, function by function), written with
torch.save in place of orbax.

Layout under `ckpt_dir`:

  epoch-N/model.pt       the model's state_dict (CPU tensors)
  epoch-N/optimizer.pt   the optimizer's state_dict (CPU tensors)
  epoch-N/meta.json      {"epoch": N, "step": updates applied so far}
  epoch-last             the newest durable epoch, a plain integer
  val_scores.json        [[mIoU, epoch], ...], the validation history

`epoch-last` and `val_scores.json` have the JAX trainer's formats, so
either package reads the other's. An epoch directory is written under a
temporary sibling (`epoch-N.tmp`, which no directory scan takes for an
epoch) and renamed into place, so that, as with orbax, the presence of
`epoch-N` means a complete write. The JAX trainer's orbax directories are
refused: reading them needs orbax, which the port does not use.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import threading
import time
from typing import Optional

import torch

from sigma_tpu_torch.engine.logger import get_logger
from sigma_tpu_torch.parallel.dist import barrier, is_main

MODEL_FILE = "model.pt"
OPTIMIZER_FILE = "optimizer.pt"
META_FILE = "meta.json"
# files orbax writes into a checkpoint directory
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt",
                  "checkpoint")


def _ckpt_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"epoch-{epoch}")


# async-save bookkeeping: one in-flight save at a time. The epoch-last
# pointer is advanced only once the background write is durable (at the
# next save, an explicit finalize, or interpreter exit), so a crash
# mid-write never leaves the pointer on a half-written checkpoint.
_ASYNC = {"thread": None, "pending": None, "error": None, "atexit": False}


def _write_pointer(ckpt_dir: str, epoch: int):
    tmp = os.path.join(ckpt_dir, "epoch-last.tmp")
    with open(tmp, "w") as f:
        f.write(str(epoch))
    os.replace(tmp, os.path.join(ckpt_dir, "epoch-last"))


def finalize_checkpoints():
    """Block until any in-flight async save is durable, then publish its
    epoch-last pointer. No-op when nothing is pending; re-raises an error
    of the background write."""
    if _ASYNC["pending"] is None:
        return
    ckpt_dir, path, epoch, t0 = _ASYNC["pending"]
    _ASYNC["thread"].join()
    _ASYNC["thread"] = _ASYNC["pending"] = None
    error, _ASYNC["error"] = _ASYNC["error"], None
    if error is not None:
        raise RuntimeError(f"async checkpoint {path} failed") from error
    _write_pointer(ckpt_dir, epoch)
    get_logger().info("async checkpoint %s durable (%.2fs since dispatch)",
                      path, time.time() - t0)


def _to_host(obj):
    """A copy of a (nested) state_dict with every tensor on the host: the
    snapshot a save writes while training goes on. Card tensors go into
    pinned memory without a sync each (PyTorch's host allocator keeps the
    blocks for the next save); the caller synchronises once."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cpu":
            return obj.detach().clone()
        out = torch.empty(obj.shape, dtype=obj.dtype, pin_memory=True)
        return out.copy_(obj.detach(), non_blocking=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write(path: str, snapshot: dict):
    """Write the snapshot under a temporary sibling of `path`, then rename
    it into place (an existing `path` is replaced)."""
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(snapshot["model"], os.path.join(tmp, MODEL_FILE))
    torch.save(snapshot["optimizer"], os.path.join(tmp, OPTIMIZER_FILE))
    with open(os.path.join(tmp, META_FILE), "w") as f:
        json.dump({"epoch": snapshot["epoch"], "step": snapshot["step"]}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def _write_in_background(path: str, snapshot: dict):
    try:
        _write(path, snapshot)
    except BaseException as e:  # handed to finalize_checkpoints
        _ASYNC["error"] = e


def save_checkpoint(ckpt_dir: str, state, epoch: int,
                    async_save: bool = False) -> str:
    """Write the model, the optimizer, `state.step` and `epoch` under
    ckpt_dir/epoch-N and point epoch-last at it.

    `async_save=True` returns once the tensors are copied to host memory;
    a background thread writes the files, and the pointer follows at the
    next save or `finalize_checkpoints()` (also run at interpreter exit).

    Data parallel, every rank calls it, as JAX's orbax save is
    collective: rank 0 writes (its replica is every rank's), and the
    others wait at a barrier until its write, or with `async_save` its
    snapshot, is done."""
    path = _ckpt_path(ckpt_dir, epoch)
    if is_main():
        _save(ckpt_dir, path, state, epoch, async_save)
    barrier()
    return path


def _save(ckpt_dir: str, path: str, state, epoch: int, async_save: bool):
    logger = get_logger()
    t0 = time.time()
    finalize_checkpoints()  # at most one in-flight async save
    os.makedirs(ckpt_dir, exist_ok=True)
    snapshot = dict(model=_to_host(state.model.state_dict()),
                    optimizer=_to_host(state.optimizer.state_dict()),
                    step=int(state.step), epoch=int(epoch))
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()  # the snapshot is complete
    if async_save:
        if not _ASYNC["atexit"]:
            atexit.register(finalize_checkpoints)
            _ASYNC["atexit"] = True
        thread = threading.Thread(target=_write_in_background,
                                  args=(path, snapshot),
                                  name=f"checkpoint-epoch-{epoch}")
        _ASYNC["thread"] = thread
        _ASYNC["pending"] = (ckpt_dir, path, epoch, t0)
        thread.start()
        logger.info("dispatched async checkpoint %s (%.2fs blocking)",
                    path, time.time() - t0)
        return
    _write(path, snapshot)
    _write_pointer(ckpt_dir, epoch)
    logger.info("saved checkpoint %s (%.2fs)", path, time.time() - t0)


def _pointer_epoch(ckpt_dir: str) -> Optional[int]:
    try:
        with open(os.path.join(ckpt_dir, "epoch-last")) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def _epoch_dirs(ckpt_dir: str):
    """Epoch numbers of all complete epoch-N checkpoint directories (a
    write renames its temporary directory into place, so presence of
    epoch-N implies a complete write)."""
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        if not name.startswith("epoch-") or name == "epoch-last":
            continue
        try:
            out.append(int(name.split("-", 1)[1]))
        except ValueError:
            continue
    return sorted(out)


def restore_checkpoint(ckpt_dir: str, state=None,
                       epoch: Optional[int] = None):
    """Restore (state, epoch). `epoch=None` reads the epoch-last pointer.

    If the pointer is missing or dangling (the process was killed after an
    async write landed but before its pointer was published, or the
    pointed-to epoch was pruned), fall back to the newest complete epoch-N
    directory. With a `state` (engine.train.TrainState) the model, the
    optimizer and `state.step` are loaded into it; with `state=None`
    {"model": state_dict, "step", "epoch"} is returned (no optimizer),
    which is what an evaluation needs."""
    if epoch is None:
        epoch = _pointer_epoch(ckpt_dir)
        if epoch is None or not os.path.isdir(_ckpt_path(ckpt_dir, epoch)):
            complete = _epoch_dirs(ckpt_dir)
            if not complete:
                raise FileNotFoundError(
                    f"no checkpoint found under {ckpt_dir!r} "
                    "(no epoch-last pointer and no epoch-N directories)")
            epoch = complete[-1]
    path = _ckpt_path(ckpt_dir, epoch)
    if not os.path.isfile(os.path.join(path, MODEL_FILE)):
        if os.path.isdir(path) and any(
                os.path.exists(os.path.join(path, m))
                for m in _ORBAX_MARKERS):
            raise ValueError(
                f"{path} is an orbax checkpoint of the JAX trainer; the "
                "port reads only the epoch directories it writes itself "
                f"({MODEL_FILE}, {OPTIMIZER_FILE}, {META_FILE})")
        raise FileNotFoundError(f"no checkpoint at {path}")
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    if state is None:
        model = torch.load(os.path.join(path, MODEL_FILE),
                           map_location="cpu", weights_only=True)
        return dict(model=model, step=meta["step"],
                    epoch=meta["epoch"]), epoch
    device = next(state.model.parameters()).device
    state.model.load_state_dict(torch.load(
        os.path.join(path, MODEL_FILE), map_location=device,
        weights_only=True))
    state.optimizer.load_state_dict(torch.load(
        os.path.join(path, OPTIMIZER_FILE), map_location="cpu",
        weights_only=True))
    state.step = int(meta["step"])
    return state, epoch


def save_val_scores(ckpt_dir: str, scores):
    """Persist the (mIoU, epoch) validation history next to the
    checkpoints, so that best-k retention survives `-c` (without it, a
    resumed run would prune the best checkpoints kept before it)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, "val_scores.json.tmp")
    with open(tmp, "w") as f:
        json.dump([[float(m), int(e)] for m, e in scores], f)
    os.replace(tmp, os.path.join(ckpt_dir, "val_scores.json"))


def load_val_scores(ckpt_dir: str):
    """The persisted (mIoU, epoch) history; [] when absent."""
    try:
        with open(os.path.join(ckpt_dir, "val_scores.json")) as f:
            return [(float(m), int(e)) for m, e in json.load(f)]
    except (OSError, ValueError):
        return []


def prune_checkpoints(ckpt_dir: str, keep_epochs):
    """Best-k retention: delete every epoch-N not in `keep_epochs` (an int
    for the reference's best-only policy, or an iterable of epochs for
    best-k). Never touches an in-flight async save, nor the epoch the
    epoch-last pointer targets: with async saves the pointer lags one save
    behind, so its target must stay restorable until the pointer moves."""
    logger = get_logger()
    if not os.path.isdir(ckpt_dir):
        return
    if isinstance(keep_epochs, int):
        keep_epochs = (keep_epochs,)
    keep = set(keep_epochs)
    if _ASYNC["pending"] is not None:
        keep.add(_ASYNC["pending"][2])
    pointed = _pointer_epoch(ckpt_dir)
    if pointed is not None:
        keep.add(pointed)
    for name in os.listdir(ckpt_dir):
        if not name.startswith("epoch-") or name == "epoch-last":
            continue
        try:
            n = int(name.split("-", 1)[1])
        except ValueError:
            continue
        if n not in keep:
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
            logger.info("pruned checkpoint epoch-%d (kept %s)", n,
                        sorted(keep))
