"""Top-level EncoderDecoder, `build_model` and `segmentation_loss`
(counterpart of `sigma_tpu/models/builder.py`).

The module maps (rgb, modal_x), NHWC float, to logits NHWC at the input
resolution; with `return_aux` (the train step), to (logits, aux), aux the
deep-supervision heads' logits (a list), the FCN aux head's (one
tensor) or None, each resized to the input as well. The decoders are the
JAX package's: MambaDecoder (with deep supervision), MLPDecoder, UPernet
and deeplabv3+ (each with the FCN aux head on the 1/16 feature) and FCN.
The other backbones (MiT, Swin) are not ported yet: asking for them
raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sigma_tpu_torch.models.common import resize_bilinear, uniform_
from sigma_tpu_torch.models.decoders.deeplabv3plus import DeepLabV3Plus
from sigma_tpu_torch.models.decoders.fcnhead import FCNHead
from sigma_tpu_torch.models.decoders.mamba_decoder import MambaDecoder
from sigma_tpu_torch.models.decoders.mlp_decoder import MLPDecoder
from sigma_tpu_torch.models.decoders.upernet import UPerHead
from sigma_tpu_torch.models.norm import BatchNorm
from sigma_tpu_torch.models.sigma_encoder import SIGMA_VARIANTS, SigmaEncoder
from sigma_tpu_torch.parallel.dist import all_reduce_sum

DECODERS = ("MambaDecoder", "MLPDecoder", "UPernet", "deeplabv3+", "FCN",
            "fcn")


class EncoderDecoder(nn.Module):
    """Sigma RGB-X segmentation network: Siamese VMamba encoder + one of
    the JAX package's decoders."""

    def __init__(self, num_classes, backbone="sigma_tiny",
                 decoder="MambaDecoder", decoder_embed_dim=512,
                 deep_supervision=False, remat=True, aux_rate=0.4,
                 dtype=torch.float32):
        """`remat`: True, False or a token threshold
        (models/common.py::should_remat). `dtype`: the compute dtype,
        flax's (fp32, or bf16 with fp32 parameters, LayerNorms,
        BatchNorms and scan state; models/common.py); the logits come
        back in it. `decoder_embed_dim`: MLPDecoder's width. `aux_rate`:
        the FCN aux head's loss weight (engine/train.py)."""
        super().__init__()
        if backbone not in SIGMA_VARIANTS:
            raise NotImplementedError(
                f"backbone {backbone!r} is not ported; the port has "
                f"{sorted(SIGMA_VARIANTS)} (ROADMAP.md queue A item A7c)")
        if decoder not in DECODERS:
            raise ValueError(f"unknown decoder {decoder!r}; options: "
                             f"{list(DECODERS)}")
        variant = SIGMA_VARIANTS[backbone]
        dims = variant["dims"]
        self.aux_rate = aux_rate
        self.backbone = SigmaEncoder(**variant, remat=remat, dtype=dtype)
        self.aux_head = None
        if decoder == "MambaDecoder":
            self.decode_head = MambaDecoder(
                num_classes, embed_dim=dims[0],
                deep_supervision=deep_supervision, remat=remat, dtype=dtype)
        elif decoder == "MLPDecoder":
            self.decode_head = MLPDecoder(dims, num_classes,
                                          decoder_embed_dim, dtype=dtype)
        elif decoder == "UPernet":
            self.decode_head = UPerHead(dims, num_classes, 512, dtype=dtype)
        elif decoder == "deeplabv3+":
            self.decode_head = DeepLabV3Plus(dims, num_classes, dtype=dtype)
        else:
            self.decode_head = FCNHead(dims[-1], num_classes, dtype=dtype)
        if decoder in ("UPernet", "deeplabv3+"):
            self.aux_head = FCNHead(dims[2], num_classes, dtype=dtype)

    def forward(self, rgb, modal_x, return_aux: bool = False):
        feats = self.backbone(rgb, modal_x)
        aux = None
        if isinstance(self.decode_head, MambaDecoder):
            logits = self.decode_head(feats, aux=return_aux)
            if return_aux and self.decode_head.deep_supervision:
                logits, aux = logits
        elif isinstance(self.decode_head, FCNHead):
            logits = self.decode_head(feats[-1])
        else:
            logits = self.decode_head(feats)
            if return_aux and self.aux_head is not None:
                aux = self.aux_head(feats[2])
        h, w = rgb.shape[1:3]

        def full(x):
            return x if x.shape[1:3] == (h, w) else resize_bilinear(x, h, w)

        logits = full(logits)
        if not return_aux:
            return logits
        if isinstance(aux, list):
            aux = [full(a) for a in aux]
        elif aux is not None:
            aux = full(aux)
        return logits, aux


def init_parameters(model: nn.Module, seed: int) -> nn.Module:
    """Seeded init from one explicit torch.Generator: PyTorch's Linear /
    Conv2d defaults (U(+-1/sqrt(fan_in)) for weight and bias, as the JAX
    package's torch_linear_kernel_init gives every head), LayerNorm
    ones/zeros, BatchNorm flax's (ones / zeros, running 0 / 1), then each
    module's SSM-specific init (`init_ssm`: S4D A_logs, D ones,
    dt-projection init)."""
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
            elif isinstance(m, BatchNorm):
                m.reset_parameters()
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
        decoder_embed_dim=getattr(cfg, "decoder_embed_dim", 512),
        deep_supervision=getattr(cfg, "deep_supervision", False),
        remat=getattr(cfg, "remat", True),
        aux_rate=getattr(cfg, "aux_rate", 0.4),
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
