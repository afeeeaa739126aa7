"""Parameter counts and FLOP accounting of the port (counterpart of
`sigma_tpu/utils/flops.py`, whose conventions and closed forms it keeps).

Model FLOPs follow the reference's fvcore convention, as the JAX
package's `analytic_flops` does: matmuls and convolutions at 2 M K N,
plus the selective scan's closed form 9 B L D N (+ B D L with the D skip,
`vmamba.py:435-456`), which the scan entry points feed into a tally:

  * `ops/scan_g.py::selective_scan_g`: 9 B G L dg N (+ B G L dg with D);
  * `selective_scan_g_proj` / `selective_scan_g_proj_ml`: the same plus
    2 B G L dg (dg + 2N) for the projections, when the call takes the
    fused-projection kernel (`scan_g.uses_fused_projection`); otherwise
    its projections are `torch.matmul`s, counted as such, and its scan
    part counts as `selective_scan_g`;
  * `ops/selective_scan.py::selective_scan_cl`;
  * `ops/scan_img.py::selective_scan_ss2d_proj`: four chains over the
    image, with their projections;
and, which the JAX package leaves to its jaxpr walk, `selective_scan`
(channel-first) and `selective_scan_seq_cl` (per-row), so that their
count too is the same on either device. The composed dt projection is
counted at its widened dg -> dg, as the kernels run it. A scan entry
point is opaque to the count: no op it dispatches counts, whether it
launches a kernel (the card) or runs its plain version (the CPU), and a
call it makes to another entry point records nothing more. The route is
decided by the same rule on both devices, so a model counts the same on
the CPU and on the card. The per-call weight products of the models (the
dt projection composed into x_proj) are matmuls outside the entry points
and count as matmuls, as in the JAX package.

`analytic_flops_split(fn, *args)` returns (matmul / conv FLOPs, scan
tally FLOPs) of one call of `fn` under `torch.no_grad()` (so that
`torch.utils.checkpoint` recomputes nothing), the first counted as
`torch.utils.flop_counter.FlopCounterMode` counts (its formula registry,
2 M K N for a product, and its rule of decomposing an op it has no
formula for) but without its per-module tracking, whose hooks fail under
no_grad when a module takes a parameter as an input (MambaDecoder's
final expansion). JAX's `xla_flops` (XLA's
compiled cost analysis of every HLO op) has no counterpart in PyTorch, so
`model_stats` and the script report the analytic count, labelled so.

Run as a script (on the card unless `--device cpu`):
  python -m sigma_tpu_torch.utils.flops -n mfnet --backbone sigma_tiny
"""

from __future__ import annotations

import contextlib
import math
from collections.abc import Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def param_count(params) -> int:
    """Elements of an nn.Module's parameters, or of every tensor of a
    state dict."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, Mapping):
        return sum(param_count(v) for v in params.values())
    return params.numel() if isinstance(params, torch.Tensor) else 0


def selective_scan_flops(B: int, L: int, D: int, N: int,
                         with_D: bool = True, with_Z: bool = False) -> int:
    """Closed-form scan FLOPs (vmamba.py:435-456)."""
    flops = 9 * B * L * D * N
    if with_D:
        flops += B * D * L
    if with_Z:
        flops += B * D * L
    return flops


def scan_projection_flops(tokens: int, dg: int, N: int) -> int:
    """The dt / B / C projections a fused-projection scan kernel runs over
    `tokens` (batch x chains x L): dg -> dg + 2N (the dt projection
    composed, dg -> dg), 2 per multiply-add."""
    return 2 * tokens * dg * (dg + 2 * N)


def conmb_flops(HW: int, C: int, d_state: int = 4, ssm_ratio: float = 2.0,
                dt_rank=None) -> int:
    """Analytic ConMB (concat multimodal scan) FLOPs for one fusion block at
    an HW-token stage with C channels — the subject of the reference's
    scaling study (calculate_flops_ConMB.py)."""
    d_inner = int(ssm_ratio * C)
    r = dt_rank or math.ceil(C / 16)
    L = 2 * HW
    K = 2
    fl = 0
    fl += 2 * 2 * HW * C * d_inner  # two in_proj
    fl += 2 * HW * d_inner * 9 * 2  # two dwconv3x3
    fl += 2 * K * L * d_inner * (r + 2 * d_state)  # x_proj
    fl += 2 * K * L * r * d_inner  # dt_proj
    fl += selective_scan_flops(1, L, K * d_inner, d_state)
    fl += 2 * 2 * HW * d_inner * (d_inner // 16) * 2  # SE gates
    fl += 2 * HW * (2 * d_inner) * C  # out_proj
    return fl


def attention_fusion_flops(HW: int, C: int) -> int:
    """Concat self-attention fusion over L=2HW tokens (the ConSA baseline in
    the reference study): qkv + attention + proj."""
    L = 2 * HW
    fl = 2 * L * C * 3 * C  # qkv
    fl += 2 * L * L * C * 2  # QK^T and AV
    fl += 2 * L * C * C  # out proj
    return fl


# --- the count --------------------------------------------------------------
class _MatmulCounter(TorchDispatchMode):
    """The FLOPs of the ops that torch.utils.flop_counter has a formula for
    (matmuls, convolutions, attention), summed over one run."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        formula = flop_registry.get(func._overloadpacket)
        if formula is None and func is not torch.ops.prim.device.default:
            with self:  # counted through what it decomposes into
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


# --- the scan tally --------------------------------------------------------
# Active only inside analytic_flops_split: the closed forms recorded, the
# counter, how deep the entry points are nested, and the counter's FLOPs
# that ops inside them dispatched (taken out of the matmul count).
_tally: list | None = None
_counter = None
_depth = 0
_hidden = 0


def record_scan(flops: int):
    """Add a scan's closed form to the active tally (none inside another
    entry point: the outer one counts the call)."""
    if _tally is not None and _depth == 0:
        _tally.append(int(flops))


@contextlib.contextmanager
def scan_call(flops: int):
    """The body of a scan entry point: records its closed form `flops` and
    hides the ops it dispatches from the matmul count. Outside a count it
    does nothing."""
    global _depth, _hidden
    if _tally is None:
        yield
        return
    outer = _depth == 0
    record_scan(flops)
    before = _counter.total
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1
        if outer:
            _hidden += _counter.total - before


def analytic_flops_split(fn, *args):
    """(matmul / conv FLOPs, scan-tally FLOPs) of `fn(*args)`, run once
    under torch.no_grad(); see the module docstring."""
    global _tally, _counter, _depth, _hidden
    if _tally is not None:
        raise RuntimeError("analytic_flops_split does not nest")
    counter = _MatmulCounter()
    _tally, _counter, _depth, _hidden = [], counter, 0, 0
    try:
        with torch.no_grad(), counter:
            fn(*args)
        mm = counter.total - _hidden
        scans = sum(_tally)
    finally:
        _tally = _counter = None
    return float(mm), float(scans)


def analytic_flops(fn, *args) -> float:
    """Model FLOPs as executed: matmul / conv (2MKN) plus the scan
    entry points' tally."""
    return sum(analytic_flops_split(fn, *args))


def model_stats(model, input_hw=(480, 640), batch: int = 1) -> dict:
    """Parameters and the analytic forward FLOPs of a segmentation model at
    `batch` zero RGB-X pairs of `input_hw`, in eval mode, on the model's
    device: {"params", "flops", "flops_mm", "flops_scan"}."""
    h, w = input_hw
    device = next(model.parameters()).device
    rgb = torch.zeros((batch, h, w, 3), device=device)
    training = model.training
    model.eval()
    try:
        mm, scans = analytic_flops_split(model, rgb, rgb)
    finally:
        model.train(training)
    return {"params": param_count(model), "flops": mm + scans,
            "flops_mm": mm, "flops_scan": scans}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("-n", "--dataset", default="mfnet")
    p.add_argument("--backbone", default="sigma_tiny")
    p.add_argument("--decoder", default="MambaDecoder")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.models.builder import build_model

    cfg = get_config(args.dataset)
    object.__setattr__(cfg, "backbone", args.backbone)
    object.__setattr__(cfg, "decoder", args.decoder)
    h = args.height or cfg.image_height
    w = args.width or cfg.image_width

    model = build_model(cfg, device=args.device)
    stats = model_stats(model, (h, w), args.batch)
    print(
        f"{args.backbone}+{args.decoder} @ {h}x{w} batch {args.batch}: "
        f"params {stats['params'] / 1e6:.2f}M, analytic GFLOPs "
        f"{stats['flops'] / 1e9:.2f} (matmul/conv "
        f"{stats['flops_mm'] / 1e9:.2f} + scan tally "
        f"{stats['flops_scan'] / 1e9:.2f}; not XLA's cost analysis)"
    )


if __name__ == "__main__":
    main()
