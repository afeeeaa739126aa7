"""Cross-modal fusion blocks, CroMB and ConMB (counterpart of
`sigma_tpu/models/fusion.py`), on (B, H, W, C) pairs. `dtype` is the
compute dtype of their ops (models/common.py); the residual sums take
JAX's promotion (fp32 trunk features + a bf16 op output are fp32)."""

from __future__ import annotations

import torch
from torch import nn

from sigma_tpu_torch.models.common import DropPath
from sigma_tpu_torch.models.ss2d import ConMBSS2D, CrossMambaFusionSS2D


class CrossMambaFusionBlock(nn.Module):
    """CroMB: per-modality residual around the cross-scan op."""

    def __init__(self, hidden_dim, drop_path=0.0, d_state=4, ssm_ratio=2.0,
                 dtype=torch.float32):
        super().__init__()
        self.op = CrossMambaFusionSS2D(hidden_dim, d_state=d_state,
                                       ssm_ratio=ssm_ratio, dtype=dtype)
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x_rgb, x_e):
        cross_rgb, cross_e = self.op(x_rgb, x_e)
        return (x_rgb + self.drop_path1(cross_rgb),
                x_e + self.drop_path2(cross_e))


class ConcatMambaFusionBlock(nn.Module):
    """ConMB: x_rgb + x_e + DropPath(ConMB_SS2D(x_rgb, x_e))."""

    def __init__(self, hidden_dim, drop_path=0.0, d_state=4, ssm_ratio=2.0,
                 dtype=torch.float32):
        super().__init__()
        self.op = ConMBSS2D(hidden_dim, d_state=d_state, ssm_ratio=ssm_ratio,
                            dtype=dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x_rgb, x_e):
        return x_rgb + x_e + self.drop_path(self.op(x_rgb, x_e))
