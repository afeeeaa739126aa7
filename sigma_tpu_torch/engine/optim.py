"""Optimizer construction with reference-parity parameter grouping
(counterpart of `sigma_tpu/engine/optim.py`), keyed on the port's
state_dict names.

The reference groups params via `group_weight` (the reference's
`utils/init_func.py:33-58`): weight decay applies to Linear/Conv kernels
only; biases and norm parameters get no decay. Raw SSM tensors
(x_proj_weight, dt_projs_weight/bias, A_logs, Ds, decoder scale1/scale2)
land in neither group there, so the reference trainer never steps them.
Everything trains by default; `freeze_ssm_tensors=True` gives strict
reference parity. The masks equal the JAX package's `decay_mask` /
`frozen_ssm_mask` leaf for leaf through the weight bridge's key map
(tests/test_torch_port_train.py).

AdamW is torch.optim.AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled decay on
the decay group only); SGDM is torch.optim.SGD with momentum, its decay
added to the gradient as optax's add_decayed_weights does. Frozen tensors
belong to no group and get no update.
"""

from __future__ import annotations

import torch
from torch import nn

# raw SSM tensors, by the last component of their port key
_SSM_TENSORS = frozenset((
    "x_proj_weight", "dt_projs_weight", "dt_projs_bias", "A_logs", "Ds",
    "A_log_1", "A_log_2", "D_1", "D_2", "scale1", "scale2",
))
# CroMB's per-modality SSM Linears, by the module name before the leaf
_SSM_MODULES = frozenset(("x_proj_1", "x_proj_2", "dt_proj_1", "dt_proj_2"))


def decay_mask(model: nn.Module) -> dict[str, bool]:
    """{param name: True where weight decay applies}: >= 2-D weights of
    Linear/Conv layers and the stacked SSM projections; CroMB's x_proj_1/2
    (raw parameters in the JAX package) do not decay."""
    out = {}
    for name, p in model.named_parameters():
        *mods, leaf = name.split(".")
        out[name] = (p.ndim >= 2 and leaf.endswith("weight")
                     and mods[-1:] not in (["x_proj_1"], ["x_proj_2"]))
    return out


def frozen_ssm_mask(model: nn.Module) -> dict[str, bool]:
    """{param name: True for tensors the reference trainer leaves
    unstepped}."""
    out = {}
    for name, _ in model.named_parameters():
        *mods, leaf = name.split(".")
        out[name] = leaf in _SSM_TENSORS or (
            bool(mods) and mods[-1] in _SSM_MODULES)
    return out


def build_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    """AdamW (default) or SGD + momentum, matching the reference's
    train.py:89-98. The lr is set per step by the train step from its
    schedule; the groups start at lr 0."""
    decay = decay_mask(model)
    frozen = (frozen_ssm_mask(model)
              if getattr(cfg, "freeze_ssm_tensors", False) else {})
    groups = {True: [], False: []}
    for name, p in model.named_parameters():
        if not frozen.get(name, False):
            groups[decay[name]].append(p)
    params = [
        dict(params=groups[True], weight_decay=cfg.weight_decay),
        dict(params=groups[False], weight_decay=0.0),
    ]
    if cfg.optimizer == "AdamW":
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999),
                                 eps=1e-8)
    if cfg.optimizer in ("SGDM", "SGD"):
        return torch.optim.SGD(params, lr=0.0, momentum=cfg.momentum)
    raise ValueError(f"unsupported optimizer {cfg.optimizer!r}")
