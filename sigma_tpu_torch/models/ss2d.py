"""SS2D and the multimodal selective-scan modules (counterpart of
`sigma_tpu/models/ss2d.py`), channel-last (B, H, W, C) at the boundaries.

  * `SS2D`                 — 4-direction 2-D selective scan block
  * `ConMBSS2D`            — concat-sequence scan with SE cross-gating
  * `CrossMambaFusionSS2D` — cross-modal scans with swapped C matrices

Every scan goes through the `ops/scan_g.py` entry points: the plain
PyTorch version on the CPU, the Hopper kernels on the card. As in the JAX
package:
  * the dt projection is composed into x_proj, W_dt = Wx[:, :R]·Wdt, so dt,
    B and C are three projections of the same input;
  * SS2D's two physical layouts (row-major hw, transposed wh) stay
    separate operands, and the reversed directions run in place, the
    reversed group folding the forward group's y in through y_accum;
  * CroMB applies one depthwise conv to both modalities (the reference
    does so, vmamba.py:1629-1630);
  * ConMB's SE gating squeezes the pre-conv projections.
Parameter names and shapes are the reference torch state_dict's.
`dtype` is the compute dtype of the linears and convolutions
(models/common.py): with bf16 the scans take bf16 io (the projection
weights cast to it, A, D and the dt bias fp32) and every LayerNorm
computes and returns fp32, as in the JAX package.

SS2D's epilogue (merge the two layouts, `out_norm`, silu gate) runs either
unfused, as PyTorch ops, or fused in one pass (`ops/merge_ln_gate.py`) when
its `fused_epilogue` is set. The default is the JAX package's switch,
`SIGMA_FUSED_EPILOGUE` (not "0": on), read once at import;
`set_fused_epilogue` sets it on every SS2D of a model. Both ways keep
`out_norm` a LayerNorm, so the state_dict is the same. ConMB and CroMB
keep their own unfused `out_norm*`, as in the JAX package.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from sigma_tpu_torch.models.common import (
    LayerNorm,
    Linear,
    a_log_init,
    conv2d_nhwc,
    depthwise_conv3x3,
    dt_proj_bias_init,
    uniform_,
)
from sigma_tpu_torch.ops.merge_ln_gate import merge_ln_gate
from sigma_tpu_torch.ops.scan_g import (
    selective_scan_g_proj,
    selective_scan_g_proj_ml,
)

# the fused SS2D epilogue by default (sigma_tpu/models/ss2d.py:58)
FUSED_EPILOGUE = os.environ.get("SIGMA_FUSED_EPILOGUE", "0") != "0"


def _dt_rank(d_model):
    """The reference's dt_rank="auto"."""
    return math.ceil(d_model / 16)


def _init_dir_params(m, generator):
    """x_proj U(+-1/sqrt(D)), dt_projs U(+-R^-0.5), softplus-inverse dt
    bias, S4D A_logs, D ones (vmamba.py:728-782)."""
    k, c, d = m.x_proj_weight.shape
    uniform_(m.x_proj_weight, d ** -0.5, generator)
    uniform_(m.dt_projs_weight, m.dt_projs_weight.shape[-1] ** -0.5,
             generator)
    m.dt_projs_bias.copy_(dt_proj_bias_init((k, d), generator))
    m.A_logs.copy_(a_log_init(k, d, m.A_logs.shape[-1]))
    m.Ds.fill_(1.0)


def _dir_params(m, k, d_inner, d_state, dt_rank):
    """K stacked directions' SSM parameters, reference shapes."""
    m.x_proj_weight = nn.Parameter(torch.zeros(k, dt_rank + 2 * d_state,
                                               d_inner))
    m.dt_projs_weight = nn.Parameter(torch.zeros(k, d_inner, dt_rank))
    m.dt_projs_bias = nn.Parameter(torch.zeros(k, d_inner))
    m.A_logs = nn.Parameter(a_log_init(k, d_inner, d_state))
    m.Ds = nn.Parameter(torch.ones(k * d_inner))


def project_scan(m, u_layouts, d_state, dt_rank):
    """Fused projection + direction-paired scan over the K directions held
    by `m` (x_proj_weight, dt_projs_weight, dt_projs_bias, A_logs, Ds).

    `u_layouts`: J (B, L, D) sequences, the physical layouts of the input
    (SS2D: J = 2, [row-major, transposed]; ConMB: J = 1). Direction
    k = g*J + j pairs group g in (forward, reverse) with layout j, the
    reference direction order (CrossScan, vmamba.py:80-98). Returns J
    (B, L, D) outputs summed over the direction groups.
    """
    j = len(u_layouts)
    _, _, d = u_layouts[0].shape
    xw = m.x_proj_weight  # (K, R+2N, D)
    k = xw.shape[0]
    g, n, r = k // j, d_state, dt_rank
    cdt = u_layouts[0].dtype
    # a batched matmul even at dt rank 1 (einsum would multiply there),
    # so the FLOP count sees the composition at every width, as JAX's does
    wdt = torch.matmul(xw[:, :r].transpose(1, 2),
                       m.dt_projs_weight.transpose(1, 2))
    wdt = wdt.reshape(g, j, d, d).to(cdt)
    wb = xw[:, r:r + n].transpose(1, 2).reshape(g, j, d, n).to(cdt)
    wc = xw[:, r + n:].transpose(1, 2).reshape(g, j, d, n).to(cdt)
    A = -torch.exp(m.A_logs.float()).reshape(k, d, n)
    A_cl = A.transpose(1, 2).reshape(g, j, n, d)
    Ds = m.Ds.reshape(g, j, d)
    bias = m.dt_projs_bias.reshape(g, j, d)
    if j == 2:
        ys = None
        for gi in range(g):
            ys = selective_scan_g_proj_ml(
                u_layouts, wdt[gi], wb[gi], wc[gi], A_cl[gi], D=Ds[gi],
                delta_bias=bias[gi], delta_softplus=True,
                reverse=(gi == 1), y_accum=ys,
            )
        return ys
    u1 = u_layouts[0][:, None]  # (B, 1, L, D)
    y = None
    for gi in range(g):
        y = selective_scan_g_proj(
            u1, wdt[gi], wb[gi], wc[gi], A_cl[gi], D=Ds[gi],
            delta_bias=bias[gi], delta_softplus=True, reverse=(gi == 1),
            y_accum=y,
        )
    return (y[:, 0],)


class SS2D(nn.Module):
    """2-D selective scan over 4 directions with gated output.
    Input/output: (B, H, W, d_model). `fused_epilogue` (default
    FUSED_EPILOGUE) takes the fused epilogue."""

    def __init__(self, d_model, d_state=16, ssm_ratio=2.0,
                 dtype=torch.float32):
        super().__init__()
        self.d_inner = d_inner = int(ssm_ratio * d_model)
        self.dt_rank = _dt_rank(d_model)
        self.d_state = d_state
        self.in_proj = Linear(d_model, 2 * d_inner, bias=False, dtype=dtype)
        self.conv2d = depthwise_conv3x3(d_inner, dtype=dtype)
        _dir_params(self, 4, d_inner, d_state, self.dt_rank)
        self.out_norm = LayerNorm(d_inner)
        self.out_proj = Linear(d_inner, d_model, bias=False, dtype=dtype)
        self.fused_epilogue = FUSED_EPILOGUE

    def init_ssm(self, generator):
        _init_dir_params(self, generator)

    def forward(self, x):
        xx, z = self.in_proj(x).split(self.d_inner, dim=-1)
        xx = F.silu(conv2d_nhwc(self.conv2d, xx))
        b, h, w, d = xx.shape
        hw = xx.reshape(b, h * w, d)
        wh = xx.transpose(1, 2).reshape(b, h * w, d)
        y_hw, y_wh = project_scan(self, (hw, wh), self.d_state, self.dt_rank)
        y_hw, y_wh = y_hw.reshape(b, h, w, d), y_wh.reshape(b, w, h, d)
        if self.fused_epilogue:
            # bf16 y_hw / y_wh / z in, fp32 out, as the unfused LN gives it
            norm = self.out_norm
            return self.out_proj(merge_ln_gate(y_hw, y_wh, z, norm.weight,
                                               norm.bias, norm.eps))
        # complete CrossMerge: un-transpose the wh layout and sum (in the
        # io dtype, as JAX sums them); LN promotes to fp32
        y = y_hw + y_wh.transpose(1, 2)
        return self.out_proj(self.out_norm(y) * F.silu(z))


def set_fused_epilogue(model: nn.Module, on: bool) -> nn.Module:
    """Set `fused_epilogue` on every SS2D of `model`; returns `model`."""
    for m in model.modules():
        if isinstance(m, SS2D):
            m.fused_epilogue = bool(on)
    return model


class ConMBSS2D(nn.Module):
    """Concat-sequence multimodal selective scan (ConMB op).
    Inputs x_rgb, x_e: (B, H, W, d_model); output (B, H, W, d_model)."""

    def __init__(self, d_model, d_state=4, ssm_ratio=2.0,
                 dtype=torch.float32):
        super().__init__()
        self.d_inner = d_inner = int(ssm_ratio * d_model)
        self.dt_rank = _dt_rank(d_model)
        self.d_state = d_state
        self.in_proj = Linear(d_model, d_inner, bias=False, dtype=dtype)
        self.in_proj_modalx = Linear(d_model, d_inner, bias=False,
                                     dtype=dtype)
        self.conv2d = depthwise_conv3x3(d_inner, dtype=dtype)
        self.conv2d_modalx = depthwise_conv3x3(d_inner, dtype=dtype)
        _dir_params(self, 2, d_inner, d_state, self.dt_rank)
        self.out_norm1 = LayerNorm(d_inner)
        self.out_norm2 = LayerNorm(d_inner)
        sq = max(1, d_inner // 16)
        self.fc1 = nn.Sequential(
            Linear(d_inner, sq, bias=False, dtype=dtype), nn.SiLU(),
            Linear(sq, d_inner, bias=False, dtype=dtype), nn.Sigmoid(),
        )
        self.fc2 = nn.Sequential(
            Linear(d_inner, sq, bias=False, dtype=dtype), nn.SiLU(),
            Linear(sq, d_inner, bias=False, dtype=dtype), nn.Sigmoid(),
        )
        self.out_proj = Linear(2 * d_inner, d_model, bias=False,
                               dtype=dtype)

    def init_ssm(self, generator):
        _init_dir_params(self, generator)

    def forward(self, x_rgb, x_e):
        x_rgb = self.in_proj(x_rgb)
        x_e = self.in_proj_modalx(x_e)
        # SE squeeze of the pre-conv projections (vmamba.py:1275-1277)
        rgb_sq = x_rgb.mean(dim=(1, 2))
        e_sq = x_e.mean(dim=(1, 2))
        xr = F.silu(conv2d_nhwc(self.conv2d, x_rgb))
        xe = F.silu(conv2d_nhwc(self.conv2d_modalx, x_e))
        b, h, w, d = xr.shape
        l = h * w
        seq = torch.cat([xr.reshape(b, l, d), xe.reshape(b, l, d)], dim=1)
        (ys,) = project_scan(self, (seq,), self.d_state, self.dt_rank)
        y_rgb = self.out_norm1(ys[:, :l].reshape(b, h, w, d))
        y_e = self.out_norm2(ys[:, l:].reshape(b, h, w, d))
        # cross SE gating (vmamba.py:1274-1281)
        rgb_excite = self.fc1(rgb_sq)[:, None, None, :]
        e_excite = self.fc2(e_sq)[:, None, None, :]
        return self.out_proj(
            torch.cat([y_rgb * e_excite, y_e * rgb_excite], dim=-1))


class _CrossMambaAttentionSSM(nn.Module):
    """The two modalities' SSM parameters (reference `CMA_ssm`)."""

    def __init__(self, d_inner, d_state, dt_rank):
        super().__init__()
        self.d_state, self.dt_rank = d_state, dt_rank
        for s in ("1", "2"):
            setattr(self, f"x_proj_{s}",
                    nn.Linear(d_inner, dt_rank + 2 * d_state, bias=False))
            setattr(self, f"dt_proj_{s}", nn.Linear(dt_rank, d_inner))
            setattr(self, f"A_log_{s}",
                    nn.Parameter(a_log_init(1, d_inner, d_state)))
            setattr(self, f"D_{s}", nn.Parameter(torch.ones(d_inner)))
            setattr(self, f"out_norm_{s}", LayerNorm(d_inner))

    def init_ssm(self, generator):
        for s in ("1", "2"):
            dt = getattr(self, f"dt_proj_{s}")
            dt.bias.copy_(dt_proj_bias_init(dt.bias.shape, generator))
            alog = getattr(self, f"A_log_{s}")
            alog.copy_(a_log_init(1, *alog.shape))
            getattr(self, f"D_{s}").fill_(1.0)

    def scan_weights(self, cdt):
        """Composed (2, D, D) W_dt, (2, D, N) W_B / W_C, (2, N, D) A, and
        the (2, D) D skip and dt bias, modality-stacked."""
        r, n = self.dt_rank, self.d_state
        wdt, wb, wc, A, D, bias = [], [], [], [], [], []
        for s in ("1", "2"):
            xp = getattr(self, f"x_proj_{s}").weight      # (R+2N, D)
            dt = getattr(self, f"dt_proj_{s}")
            wdt.append(xp[:r].t() @ dt.weight.t())
            wb.append(xp[r:r + n].t())
            wc.append(xp[r + n:].t())
            A.append(-torch.exp(getattr(self, f"A_log_{s}").float()).t())
            D.append(getattr(self, f"D_{s}"))
            bias.append(dt.bias)
        st = torch.stack
        return (st(wdt).to(cdt), st(wb).to(cdt), st(wc).to(cdt), st(A),
                st(D), st(bias))


class CrossMambaFusionSS2D(nn.Module):
    """Cross-modal Mamba attention (CroMB op): two 1-D scans over the
    flattened image where each modality consumes the other's C
    (vmamba.py:1528-1539), both in one kernel call (swap_groups_c).
    Inputs/outputs: pairs of (B, H, W, d_model)."""

    def __init__(self, d_model, d_state=4, ssm_ratio=2.0,
                 dtype=torch.float32):
        super().__init__()
        self.d_inner = d_inner = int(ssm_ratio * d_model)
        self.in_proj = Linear(d_model, d_inner, bias=False, dtype=dtype)
        self.in_proj_modalx = Linear(d_model, d_inner, bias=False,
                                     dtype=dtype)
        self.conv2d = depthwise_conv3x3(d_inner, dtype=dtype)
        self.CMA_ssm = _CrossMambaAttentionSSM(d_inner, d_state,
                                               _dt_rank(d_model))
        self.out_proj_rgb = Linear(d_inner, d_model, bias=False, dtype=dtype)
        self.out_proj_e = Linear(d_inner, d_model, bias=False, dtype=dtype)

    def forward(self, x_rgb, x_e):
        # one conv for both modalities, as the reference does
        xr = F.silu(conv2d_nhwc(self.conv2d, self.in_proj(x_rgb)))
        xe = F.silu(conv2d_nhwc(self.conv2d, self.in_proj_modalx(x_e)))
        b, h, w, d = xr.shape
        ssm = self.CMA_ssm
        wdt, wb, wc, A, D, bias = ssm.scan_weights(xr.dtype)
        y0, y1 = selective_scan_g_proj_ml(
            (xr.reshape(b, h * w, d), xe.reshape(b, h * w, d)), wdt, wb, wc,
            A, D=D, delta_bias=bias, delta_softplus=True, swap_groups_c=True,
        )
        y_rgb = ssm.out_norm_1(y0).reshape(b, h, w, d)
        y_e = ssm.out_norm_2(y1).reshape(b, h, w, d)
        return self.out_proj_rgb(y_rgb), self.out_proj_e(y_e)
