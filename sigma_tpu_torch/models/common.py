"""Shared layers and initializers (counterpart of `sigma_tpu/models/common.py`).

All tensors at module boundaries are channel-last (B, H, W, C), as in the
JAX package; convolutions permute to NCHW internally.

The compute dtype is flax's `dtype`, held by each layer: `Linear` and
`Conv2d` cast their input, weight and bias to it (the parameters stay
fp32, and autograd returns fp32 gradients to them); `LayerNorm` promotes
its input with its fp32 scale, as flax's LayerNorm with no dtype does, so
a bf16 input is normalised and returned in fp32. Everything else follows
torch's type promotion, which agrees with JAX's for tensors (bf16 + fp32
is fp32). No autocast: its defaults differ at LayerNorm and at the
residual adds.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

# torch nn.LayerNorm's default, which every live path of the reference uses
LN_EPS = 1e-5


def a_log_init(copies: int, d_inner: int, d_state: int) -> torch.Tensor:
    """S4D-real init of A_log: log(1..N), one row per (copy, channel)."""
    a = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32))
    return a[None].repeat(copies * d_inner, 1)


def dt_proj_bias_init(shape, generator: torch.Generator, dt_min=0.001,
                      dt_max=0.1, floor=1e-4) -> torch.Tensor:
    """Inverse-softplus of dt drawn log-uniformly in [dt_min, dt_max]."""
    r = torch.rand(shape, generator=generator)
    dt = torch.exp(r * (math.log(dt_max) - math.log(dt_min))
                   + math.log(dt_min)).clamp_min(floor)
    return dt + torch.log(-torch.expm1(-dt))


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=generator) * 2 * bound - bound)
    return t


class Linear(nn.Linear):
    """nn.Linear computed in `dtype` (flax Dense's `dtype`): input, weight
    and bias are cast to it; the parameters stay fp32."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class Conv2d(nn.Conv2d):
    """nn.Conv2d (NCHW) computed in `dtype` (flax Conv's `dtype`): input,
    weight and bias are cast to it; the parameters stay fp32."""

    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(
            x.to(dt), self.weight.to(dt),
            None if self.bias is None else self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with flax's promotion: the input is promoted with the
    fp32 scale, so bf16 in is fp32 out."""

    def __init__(self, dim: int, eps: float = LN_EPS):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return super().forward(
            x.to(torch.promote_types(x.dtype, self.weight.dtype)))


class DropPath(nn.Module):
    """Per-sample stochastic depth; the identity in eval mode or at rate 0.

    Training draws its masks from torch.Generators on the input's device
    made anew in each call from `seed` (set per step and per module by
    `set_drop_path_seeds`, the counterpart of flax's per-module fold of
    `fold_in(rng, step)`), one per modality: the trunk runs [rgb; x]
    stacked on the batch axis, so a call's rows are groups of `rows[1]`
    samples each. Each generator draws the masks of the whole global
    batch (`rows[2]` samples) and the call keeps its own (from `rows[0]`
    on), so a sample's mask is a function of (seed, step, module,
    modality, global sample index) alone: a data-parallel rank draws
    what one process draws over the global batch, and a forward
    recomputed under remat draws the same masks. With no seed set it
    draws from the global generator."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.seed = None
        self.rows = None  # (offset, local batch, global batch)

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        n = x.shape[0]
        # drawn in fp32 whatever x's dtype, so the masks do not depend on it
        if self.seed is None:
            mask = torch.empty(n, device=x.device).bernoulli_(keep)
        else:
            # rows unset (a seed set by hand): the call is one group
            offset, local, total = self.rows or (0, n, n)
            if n % local:
                raise ValueError(f"{n} rows are not groups of {local}")
            parts = []
            for modality in range(n // local):
                gen = torch.Generator(device=x.device)
                gen.manual_seed((self.seed * 1_000_033 + modality) % 2**62)
                draw = torch.empty(total, device=x.device).bernoulli_(
                    keep, generator=gen)
                parts.append(draw[offset:offset + local])
            mask = torch.cat(parts)
        mask = mask.to(x.dtype).reshape((n,) + (1,) * (x.ndim - 1))
        return x * mask / keep


class Dropout(nn.Module):
    """Element-wise dropout (flax nn.Dropout): each element kept with
    probability 1 - rate and scaled by 1 / (1 - rate); the identity in
    eval mode or at rate 0.

    Seeded as DropPath is (`set_drop_path_seeds`): a generator on the
    input's device made anew in each call from `seed` draws the mask of
    the whole global batch (`rows[2]` samples) and the call keeps its own
    rows, so a mask is a function of (seed, step, module, global sample
    index) alone. With no seed set it draws from the global generator."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.seed = None
        self.rows = None  # (offset, local batch, global batch)

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        if self.seed is None:
            mask = torch.empty(x.shape, device=x.device).bernoulli_(keep)
        else:
            n = x.shape[0]
            offset, _, total = self.rows or (0, n, n)
            gen = torch.Generator(device=x.device)
            gen.manual_seed(self.seed)
            mask = torch.empty((total,) + x.shape[1:], device=x.device
                               ).bernoulli_(keep, generator=gen)
            mask = mask[offset:offset + n]
        return x * mask.to(x.dtype) / keep


def set_drop_path_seeds(model: nn.Module, seed: int, step: int,
                        rows) -> None:
    """Seed every DropPath and Dropout of `model` for one train step:
    module i (in module order) draws from streams of its own, a fixed mix
    of (seed, step, i). `rows`: (offset, local batch, global batch) of
    this process's samples in the global batch ((0, b, b) in one
    process)."""
    base = (seed * 1_000_003 + step) % 2**62
    for i, m in enumerate(x for x in model.modules()
                          if isinstance(x, (DropPath, Dropout))):
        m.seed = (base * 65_537 + i) % 2**62
        m.rows = rows


def should_remat(remat, tokens: int) -> bool:
    """remat policy (vssm.py::should_remat of the JAX package): a bool
    passes through; an int is a token-count threshold (remat only the
    large-L blocks)."""
    if isinstance(remat, bool):
        return remat
    return tokens >= int(remat)


def maybe_remat(module: nn.Module, remat: bool, *args):
    """`module(*args)`, recomputed in the backward pass (activation
    checkpointing per block) when `remat` and autograd is recording a
    training forward."""
    if remat and module.training and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False)
    return module(*args)


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, dropout: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, dtype=dtype)
        self.fc2 = Linear(hidden_features, out_features, dtype=dtype)
        self.drop = nn.Dropout(dropout)

    def forward(self, x):
        x = self.drop(F.gelu(self.fc1(x)))
        return self.drop(self.fc2(x))


def conv2d_nhwc(conv: nn.Conv2d, x):
    """Apply an NCHW nn.Conv2d to an NHWC tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def depthwise_conv3x3(features: int, dtype=torch.float32) -> Conv2d:
    """3x3 depthwise conv with bias, stride 1, padding 1, computed in
    `dtype` (apply with conv2d_nhwc)."""
    return Conv2d(features, features, 3, padding=1, groups=features,
                  dtype=dtype)


def _up2x_axis(x, axis: int):
    """Exact 2x half-pixel bilinear along one axis: out[2i] = .25*in[i-1] +
    .75*in[i], out[2i+1] = .75*in[i] + .25*in[i+1] (edge-clamped)."""
    n = x.shape[axis]
    lo = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], axis)
    hi = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], axis)
    even = 0.75 * x + 0.25 * lo
    odd = 0.75 * x + 0.25 * hi
    out = torch.stack([even, odd], dim=axis + 1)
    shape = list(x.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _linear_weights(n_in: int, n_out: int, antialias: bool, device):
    """(n_in, n_out) resampling matrix of jax.image.resize's "linear"
    method (jax/_src/image/scale.py::compute_weight_mat): half-pixel
    centres, a triangle kernel widened by 1/scale when shrinking with
    antialias, weights normalised per output sample."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    wts = (1.0 - (sample[None] - src[:, None]).abs() / kernel_scale).clamp_min(0)
    total = wts.sum(dim=0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    wts = torch.where(total.abs() > 1000.0 * eps,
                      wts / torch.where(total != 0, total, 1.0),
                      torch.zeros_like(wts))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None], wts, torch.zeros_like(wts))


def resize_linear(x, h: int, w: int, antialias: bool):
    """NHWC resize equal to jax.image.resize(method="linear") with the
    given antialias flag: separable weight matrices, axes of unchanged
    size skipped."""
    _, ih, iw, _ = x.shape
    if ih != h:
        wh = _linear_weights(ih, h, antialias, x.device).to(x.dtype)
        x = torch.einsum("bhwc,hH->bHwc", x, wh)
    if iw != w:
        ww = _linear_weights(iw, w, antialias, x.device).to(x.dtype)
        x = torch.einsum("bhwc,wW->bhWc", x, ww)
    return x


def resize_bilinear(x, h: int, w: int):
    """NHWC bilinear resize, half-pixel centers (align_corners=False).

    The exact-2x case (UpsampleExpand / FinalUpsampleX4) is the closed-form
    lerp of the JAX package. The general path is jax.image.resize's, which
    antialiases when it shrinks (the decoder's odd-size resize can shrink;
    MFNet 480x640 never does): the port follows it exactly.
    """
    _, ih, iw, _ = x.shape
    if h == 2 * ih and w == 2 * iw:
        return _up2x_axis(_up2x_axis(x, 1), 2)
    return resize_linear(x, h, w, antialias=True)
