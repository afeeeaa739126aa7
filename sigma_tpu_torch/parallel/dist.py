"""Process-group helpers of data-parallel training (counterpart of
`sigma_tpu/parallel/mesh.py`): one process per card, started by torchrun,

  python -m torch.distributed.run --nproc_per_node=N \\
      -m sigma_tpu_torch.train -n mfnet --dataset-path PATH --distributed

`init_distributed` reads torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and joins the default process group:
NCCL between cards, gloo on the CPU. Every other helper acts on that
group, and is the one-process identity when no group is initialised, so
the code that calls them has no branch for it. `data_parallel()` is the
one switch: training, evaluation and saving all read it (through these
helpers), so they agree on the ranks by construction.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device_type: str = "cuda") -> torch.device:
    """Join the process group torchrun describes; returns this rank's
    device (`cuda:LOCAL_RANK`, made current, or the CPU)."""
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed needs torchrun's environment ({', '.join(missing)}"
            " not set): python -m torch.distributed.run --nproc_per_node=N "
            "-m sigma_tpu_torch.train ... --distributed")
    rank_, world_ = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed on cuda: no CUDA device")
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device_type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"no process group backend for {device_type!r}")
    dist.init_process_group(
        backend,
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}"),
        world_size=world_, rank=rank_)
    return device


def data_parallel() -> bool:
    """Whether this process is a rank of data-parallel training."""
    return dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if data_parallel() else 0


def world() -> int:
    return dist.get_world_size() if data_parallel() else 1


def is_main() -> bool:
    return rank() == 0


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """The sum of `tensor` over the ranks, in place (and returned)."""
    if data_parallel():
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
    return tensor


def barrier() -> None:
    if data_parallel():
        dist.barrier()


def shutdown() -> None:
    """Leave the process group (the end of a run)."""
    if data_parallel():
        dist.destroy_process_group()
