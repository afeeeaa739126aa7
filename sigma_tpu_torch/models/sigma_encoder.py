"""Siamese VMamba RGB-X encoder (counterpart of
`sigma_tpu/models/sigma_encoder.py`): ONE weight-shared trunk pass over
both modalities stacked on the batch axis, then per-stage CroMB -> ConMB
fusion, each fusion block rematerialized in training where `should_remat`
says so, as in the JAX package. `dtype`: the compute dtype of every
module (models/common.py)."""

from __future__ import annotations

import torch
from torch import nn

from sigma_tpu_torch.models.common import maybe_remat, should_remat
from sigma_tpu_torch.models.fusion import (
    ConcatMambaFusionBlock,
    CrossMambaFusionBlock,
)
from sigma_tpu_torch.models.vssm import VSSMBackbone

# the variant registry of the JAX package (dual_vmamba.py:113-144, plus
# the miniature test variants)
SIGMA_VARIANTS = {
    "sigma_test": dict(
        depths=(1, 1, 2, 1), dims=(16, 32, 64, 128), drop_path_rate=0.1
    ),
    "sigma_mini": dict(
        depths=(1, 1, 2, 1), dims=(32, 64, 128, 256), drop_path_rate=0.1
    ),
    "sigma_tiny": dict(
        depths=(2, 2, 9, 2), dims=(96, 192, 384, 768), drop_path_rate=0.2
    ),
    "sigma_small": dict(
        depths=(2, 2, 27, 2), dims=(96, 192, 384, 768), drop_path_rate=0.3
    ),
    "sigma_base": dict(
        depths=(2, 2, 27, 2), dims=(128, 256, 512, 1024), drop_path_rate=0.6
    ),
}


class SigmaEncoder(nn.Module):
    def __init__(self, depths=(2, 2, 9, 2), dims=(96, 192, 384, 768),
                 d_state=16, fusion_d_state=4, ssm_ratio=2.0, mlp_ratio=0.0,
                 drop_path_rate=0.2, remat=True, dtype=torch.float32):
        super().__init__()
        self.remat = remat
        self.vssm = VSSMBackbone(depths=depths, dims=dims, d_state=d_state,
                                 ssm_ratio=ssm_ratio, mlp_ratio=mlp_ratio,
                                 drop_path_rate=drop_path_rate, remat=remat,
                                 dtype=dtype)
        self.cross_mamba = nn.ModuleList(
            CrossMambaFusionBlock(d, d_state=fusion_d_state,
                                  ssm_ratio=ssm_ratio, dtype=dtype)
            for d in dims
        )
        self.channel_attn_mamba = nn.ModuleList(
            ConcatMambaFusionBlock(d, d_state=fusion_d_state,
                                   ssm_ratio=ssm_ratio, dtype=dtype)
            for d in dims
        )

    def forward(self, x_rgb, x_e):
        b = x_rgb.shape[0]
        outs = self.vssm(torch.cat([x_rgb, x_e], dim=0))
        fused = []
        for o, cromb, conmb in zip(outs, self.cross_mamba,
                                   self.channel_attn_mamba):
            remat = should_remat(self.remat, o.shape[1] * o.shape[2])
            o_rgb, o_e = maybe_remat(cromb, remat, o[:b], o[b:])
            fused.append(maybe_remat(conmb, remat, o_rgb, o_e))
        return fused
