"""Top-level EncoderDecoder, `build_model` and `segmentation_loss`
(counterpart of `sigma_tpu/models/builder.py`), MambaDecoder path.

The module maps (rgb, modal_x), NHWC float, to logits NHWC at the input
resolution. The other backbones (MiT, Swin) and decoders (MLP, UPerNet,
DeepLabV3+, FCN) are not ported yet: asking for them raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sigma_tpu_torch.models.common import resize_bilinear, uniform_
from sigma_tpu_torch.models.decoders.mamba_decoder import MambaDecoder
from sigma_tpu_torch.models.sigma_encoder import SIGMA_VARIANTS, SigmaEncoder
from sigma_tpu_torch.parallel.dist import all_reduce_sum


class EncoderDecoder(nn.Module):
    """Sigma RGB-X segmentation network: Siamese VMamba encoder +
    MambaDecoder."""

    def __init__(self, num_classes, backbone="sigma_tiny",
                 decoder="MambaDecoder", deep_supervision=False, remat=True,
                 dtype=torch.float32):
        """`remat`: True, False or a token threshold
        (models/common.py::should_remat). `dtype`: the compute dtype,
        flax's (fp32, or bf16 with fp32 parameters, LayerNorms and scan
        state; models/common.py); the logits come back in it."""
        super().__init__()
        if backbone not in SIGMA_VARIANTS:
            raise NotImplementedError(
                f"backbone {backbone!r} is not ported; the port has "
                f"{sorted(SIGMA_VARIANTS)} (ROADMAP.md queue A item A7)")
        if decoder != "MambaDecoder":
            raise NotImplementedError(
                f"decoder {decoder!r} is not ported; the port has "
                "MambaDecoder (ROADMAP.md queue A item A7)")
        variant = SIGMA_VARIANTS[backbone]
        self.backbone = SigmaEncoder(**variant, remat=remat, dtype=dtype)
        self.decode_head = MambaDecoder(
            num_classes, embed_dim=variant["dims"][0],
            deep_supervision=deep_supervision, remat=remat, dtype=dtype,
        )

    def forward(self, rgb, modal_x):
        logits = self.decode_head(self.backbone(rgb, modal_x))
        h, w = rgb.shape[1:3]
        if logits.shape[1:3] != (h, w):
            logits = resize_bilinear(logits, h, w)
        return logits


def init_parameters(model: nn.Module, seed: int) -> nn.Module:
    """Seeded init from one explicit torch.Generator: PyTorch's Linear /
    Conv2d defaults (U(+-1/sqrt(fan_in)) for weight and bias), LayerNorm
    ones/zeros, then each module's SSM-specific init (`init_ssm`: S4D
    A_logs, D ones, dt-projection init)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                uniform_(m.weight, bound, gen)
                if m.bias is not None:
                    uniform_(m.bias, bound, gen)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for m in model.modules():
            if hasattr(m, "init_ssm"):
                m.init_ssm(gen)
    return model


def require_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device on a host without one
    raises instead of running anywhere else."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "asks for the CPU (device='cpu')")
    return device


def build_model(cfg, device="cuda", seed: int = 0) -> EncoderDecoder:
    """The network of a config (sigma_tpu_torch/configs.py), seeded, in
    eval mode on `device` (the card unless the caller asks for the CPU),
    computing in bf16 when `cfg.bf16` is set (fp32 parameters), as the
    JAX builder does."""
    device = require_device(device)
    model = EncoderDecoder(
        num_classes=cfg.num_classes, backbone=cfg.backbone,
        decoder=cfg.decoder,
        deep_supervision=getattr(cfg, "deep_supervision", False),
        remat=getattr(cfg, "remat", True),
        dtype=torch.bfloat16 if getattr(cfg, "bf16", False)
        else torch.float32,
    )
    return init_parameters(model, seed).to(device).eval()


def segmentation_loss(logits, labels, ignore_index: int = 255,
                      sharded: bool = False):
    """Mean CE over valid pixels (torch CrossEntropyLoss(ignore_index=255)),
    in fp32 whatever the logits' dtype. A batch with no valid pixel gives
    0, not NaN (the count is clamped to 1), as in the JAX package.

    `sharded` (data-parallel training: this rank's logits are its shard
    of the global batch): this rank's share of the mean over the valid
    pixels of the global batch, as JAX's loss over the sharded batch,
    i.e. its own sum over the all-reduced valid count. The ranks' shares
    sum to the global mean; a rank whose shard is all ignored has 0.

    logits: (B, H, W, C) float; labels: (B, H, W) int.
    """
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    count = valid.sum()
    if sharded:
        count = all_reduce_sum(count)
    return nll.sum() / count.clamp_min(1)
