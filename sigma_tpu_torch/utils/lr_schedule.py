"""LR schedules (counterpart of `sigma_tpu/utils/lr_schedule.py`), plain
Python floats.

Mirrors the reference's `utils/lr_policy.py`: linear warmup then
polynomial decay (power 0.9), plus the plain poly / multi-stage / linear
variants. The count convention is optax's: the update with 0-based index
k uses `schedule(k)`, so the first warmup update has lr 0. A LambdaLR
stepped after each update would be one step late; the port's train step
sets the lr from `schedule(state.step)` before each update instead.
"""

from __future__ import annotations


def warmup_poly_lr(start_lr: float, lr_power: float, total_iters: int,
                   warmup_steps: int):
    """WarmUpPolyLR (lr_policy.py:29-41)."""

    def schedule(step):
        step = float(step)
        if step < warmup_steps:
            return start_lr * step / max(warmup_steps, 1)
        return start_lr * max(0.0, 1.0 - step / float(total_iters)) ** lr_power

    return schedule


def poly_lr(start_lr: float, lr_power: float, total_iters: int):
    def schedule(step):
        return start_lr * max(
            0.0, 1.0 - float(step) / float(total_iters)) ** lr_power

    return schedule


def multi_stage_lr(lr_stages):
    """MultiStageLR (lr_policy.py:44-53): piecewise-constant by step
    boundaries; `lr_stages` = [(until_step, lr), ...]."""

    def schedule(step):
        idx = sum(float(step) >= b for b, _ in lr_stages)
        return lr_stages[min(max(idx, 0), len(lr_stages) - 1)][1]

    return schedule


def linear_increase_lr(start_lr: float, end_lr: float, warm_iters: int):
    def schedule(step):
        return start_lr + float(step) * (end_lr - start_lr) / warm_iters

    return schedule
