#!/usr/bin/env python3
"""Chip smoke check of the PyTorch port (`sigma_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (written for an NVIDIA H100), nvcc, and the repo's
sources; it imports nothing of JAX. TF32 is off for matmuls and cuDNN, so
fp32 means fp32 on both sides of every comparison. Phases, each printing
its findings:

  1. build    — compile the Hopper scan kernels from sigma_tpu_torch/csrc
                with nvcc, one process per source, all started together
                (timed); print the card's name and power limit.
  2. kernel   — at every main-path scan shape of sigma_tiny at 480x640,
                batch 1, run K1 (streamed) / K2 (fused projection) against
                their plain PyTorch versions on the card, fp32 and bf16 io,
                with the S4D A and dt-bias inits; print errors and times.
  3. backward — at every distinct scan shape of sigma_tiny's train step at
                480x640, batch 2 (an SS2D scans batch 4), forward and
                reversed (the reversed call with y_accum, CroMB with its C
                swap), fp32: every gradient (du per layout, dW_dt, dW_B,
                dW_C, dA, dD, dt bias, y_accum) through the scan entry
                point the train step calls — K2 + K4 + K5, or at stage 3
                K1 + K3 after torch.matmul projections — held against
                autograd of the plain version on the same card, and the
                kernels launched checked. Prints errors, the ms of the
                entry point's backward against the plain version's, and
                of K3 / K4 / K5 each launched alone (K5 against its plain
                products).
  4. model    — sigma_tiny / MambaDecoder / 9 classes, seeded weights, four
                seeded 480x640 RGB-X pairs through the port's
                SlidingEvaluator.run under the MFNet preset; img/s and
                mIoU; K1 and K2 must have been launched on that path, and
                no backward kernel. Then the same model at 96x128: GPU
                logits against the CPU plain path.
  5. train    — the train CLI's step (engine.train.build_train: AdamW,
                warmup-poly lr, remat, drop path) for 3 steps at 480x640,
                batch 2, on seeded synthetic uint8 batches with pad
                margins (trace_step.synthetic_batch): finite
                losses, parameters changed, K1-K5 all launched; s/step and
                img/s of the last two steps. Then one step of sigma_test
                at 64x80 on the card and on the CPU from the same weights
                and batch (drop path 0, SGD with momentum): losses and
                post-step parameters against each other.

Ends with the card line, one JSON line of the kernels (launches from the
train phase; bound_ms from this run's shapes, see `_work`), then the
device line. Exits non-zero, with no result line, without a CUDA card or
when a phase fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

FP32_TOL = (6e-4, 2e-3)   # rtol, atol against max(|ref|, 1)
BF16_TOL = (5e-2, 5e-2)
ARGMAX_AGREEMENT = 0.995
# card vs CPU train step (sigma_test, SGD with momentum, lr 1e-2): losses
# and post-step weights; fp32 sums in another order on each side
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-5
SEED = 0
# H100 SXM data sheet: HBM rate and fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

KERNELS = {
    "scan_fwd": dict(
        route="cuda", source="sigma_tpu_torch/csrc/scan_g_fwd.cu",
        replaces="sigma_tpu/ops/pallas_scan_g.py:149 (_fwd_kernel via "
                 "_fwd_call :806, proj=False)"),
    "scan_proj_fwd": dict(
        route="cuda", source="sigma_tpu_torch/csrc/scan_g_fwd.cu",
        replaces="sigma_tpu/ops/pallas_scan_g.py:149 (_fwd_kernel via "
                 "_fwd_call :806 proj=True and _fwd_call_ml :894)"),
    "scan_bwd": dict(
        route="cuda", source="sigma_tpu_torch/csrc/scan_g_bwd.cu",
        replaces="sigma_tpu/ops/pallas_scan_g.py:305 (_bwd_kernel via "
                 "_bwd_call :989, streamed pallas_call :1111)"),
    "scan_proj_bwd": dict(
        route="cuda", source="sigma_tpu_torch/csrc/scan_g_bwd.cu",
        replaces="sigma_tpu/ops/pallas_scan_g.py:305 (_bwd_kernel via "
                 "_bwd_call :989 proj pallas_call :1060 and _bwd_call_ml "
                 ":1140, pallas_call :1225)"),
    "proj_grad": dict(
        route="cuda", source="sigma_tpu_torch/csrc/scan_g_bwd.cu",
        replaces="sigma_tpu/ops/pallas_scan_g.py:594 (_bwd_kernel's "
                 "weight-grad and du-chain dots :594-622, pallas_calls "
                 ":1060 and :1225)"),
}
FORWARD = ("scan_fwd", "scan_proj_fwd")


def main_path_scans(H=480, W=640, batch=1):
    """(kernel, tag, kwargs) for every distinct scan call of sigma_tiny's
    forward at HxW: stages 0-2 fused projection, stage 3 streamed."""
    dims = (96, 192, 384, 768)
    cases = []
    for s, dim in enumerate(dims):
        L, dg = (H // 4 >> s) * (W // 4 >> s), 2 * dim
        streamed = s == 3
        calls = [
            ("ss2d", dict(ml=True, B=2 * batch, L=L, dg=dg, N=16)),
            ("cromb", dict(ml=True, B=batch, L=L, dg=dg, N=4, swap=True)),
            ("conmb", dict(ml=False, B=batch, L=2 * L, dg=dg, N=4)),
        ]
        if s < 3:
            calls.append(("dec", dict(ml=True, B=batch, L=L, dg=dg, N=4)))
        for name, kw in calls:
            kernel = "scan_fwd" if streamed else "scan_proj_fwd"
            cases.append((kernel, f"{name}{s}", kw))
    return cases


def _inputs(kw, dtype, device, gen):
    """Realistic inputs: S4D A, inverse-softplus dt bias, D ones,
    x_proj/dt_proj-shaped weights composed as the models compose them."""
    import torch

    from sigma_tpu_torch.models.common import a_log_init, dt_proj_bias_init

    G = 2 if kw["ml"] else 1
    B, L, dg, N = kw["B"], kw["L"], kw["dg"], kw["N"]
    R = math.ceil(dg / 2 / 16)
    rnd = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    xproj = (torch.rand((G, R + 2 * N, dg), generator=gen) * 2 - 1) / dg ** .5
    dtw = (torch.rand((G, dg, R), generator=gen) * 2 - 1) / R ** .5
    w_dt = torch.einsum("grd,ger->gde", xproj[:, :R], dtw)
    w_b = xproj[:, R:R + N].transpose(1, 2)
    w_c = xproj[:, R + N:].transpose(1, 2)
    A = -torch.exp(a_log_init(G, dg, N)).reshape(G, dg, N).transpose(1, 2)
    bias = dt_proj_bias_init((G, dg), gen)
    D = torch.ones(G, dg)
    u = torch.nn.functional.silu(rnd(B, G, L, dg))
    ya = rnd(B, G, L, dg) * 0.5
    to = lambda t: t.to(device).contiguous()  # noqa: E731
    return dict(
        u=to(u.to(dtype)), ya=to(ya.to(dtype)), w_dt=to(w_dt.to(dtype)),
        w_b=to(w_b.to(dtype)), w_c=to(w_c.to(dtype)), A=to(A),
        D=to(D), bias=to(bias),
    )


def _run_case(kernel, kw, x, reverse, use_kernel):
    """One call of the kernel's wrapper (use_kernel) or of its plain
    version on the same inputs. The reversed call carries y_accum, as the
    second direction-group call of every SS2D/ConMB does."""
    import torch

    from sigma_tpu_torch.ops import scan_g

    ya = x["ya"] if reverse else None
    swap = kw.get("swap", False)
    common = dict(D=x["D"], delta_bias=x["bias"], delta_softplus=True,
                  reverse=reverse)
    if kernel == "scan_proj_fwd":
        if kw["ml"]:
            us = (x["u"][:, 0], x["u"][:, 1])
            yas = None if ya is None else (ya[:, 0], ya[:, 1])
            fn = (scan_g.launch_scan_proj_fwd if use_kernel
                  else scan_g.selective_scan_g_proj_ml_plain)
            out = fn(us, x["w_dt"], x["w_b"], x["w_c"], x["A"],
                     swap_groups_c=swap, y_accum=yas, **common)
            return torch.stack(tuple(out), 1)
        if use_kernel:
            (y,) = scan_g.launch_scan_proj_fwd(
                (x["u"],), x["w_dt"], x["w_b"], x["w_c"], x["A"],
                y_accum=None if ya is None else (ya,), **common)
            return y
        return scan_g.selective_scan_g_proj_plain(
            x["u"], x["w_dt"], x["w_b"], x["w_c"], x["A"], y_accum=ya,
            **common)
    # streamed: projections outside the kernel (and outside its time), as
    # the main path makes them with torch.matmul
    u = x["u"]
    if "dts" not in x:
        x["dts"], x["bs"], x["cs"] = (
            torch.matmul(u, x[k]) for k in ("w_dt", "w_b", "w_c"))
        if swap:
            x["cs"] = x["cs"].flip(1)
    dts, bs, cs = x["dts"], x["bs"], x["cs"]
    if use_kernel:
        return scan_g.launch_scan_fwd(u, dts, x["A"], bs, cs, y_accum=ya,
                                      **common)
    y = scan_g.selective_scan_g_plain(u.float(), dts.float(), x["A"],
                                      bs.float(), cs.float(), **common)
    if ya is not None:
        y = y + ya.float()
    return y.to(u.dtype)


def _work(kernel, kw, reverse=False):
    """(bytes, operations) of one call's function at shape `kw`, fp32:
    each input read once and each output written once; operations count
    an exp as one. Scan: 9 per (token, chain, channel, state) forward
    (the JAX package's flops count), 22 backward (5 to recompute h, 14 in
    the dh sweep, 3 in the dB / dC channel sums); projections 2 per
    multiply-add."""
    from sigma_tpu_torch.ops.scan_g import CK_TOKENS

    G = 2 if kw["ml"] else 1
    B, L, dg, N = kw["B"], kw["L"], kw["dg"], kw["N"]
    tok = B * G * L
    big, small = 4 * tok * dg, 4 * tok * N
    params = 4 * G * dg * (3 + N)                    # bias, D, (dD), A
    wts = 4 * G * dg * (dg + 2 * N)
    hck = 4 * B * G * -(-L // CK_TOKENS) * N * dg
    ya = big if reverse else 0
    proj = 2 * tok * dg * (dg + 2 * N)
    scan_fwd, scan_bwd = 9 * tok * dg * N, 22 * tok * dg * N
    return {
        "scan_fwd": (3 * big + 2 * small + params + ya, scan_fwd),
        "scan_proj_fwd": (2 * big + wts + params + ya, scan_fwd + proj),
        "scan_bwd": (5 * big + 4 * small + hck + 2 * params, scan_bwd),
        "scan_proj_bwd": (4 * big + 2 * small + hck + wts + 2 * params,
                          scan_bwd + proj),
        "proj_grad": (4 * big + 2 * small + 2 * wts, 2 * proj),
    }[kernel]


def _bound(kernel, kw, reverse=False):
    """(bound_ms, bound_by): the least time the card could take."""
    nbytes, ops = _work(kernel, kw, reverse)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _time_ms(fn, reps, warm=True):
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_phase():
    from sigma_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    for name in built:
        _build.library(name)
    total = time.perf_counter() - t0
    for name, (path, compile_s, log) in built.items():
        print(f"build: {name} {path.name} nvcc {compile_s:.2f}s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"build: ptxas {line.strip()}")
    print(f"build: total {total:.2f}s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    return smi


def kernel_phase(device, cases=None, reps=5):
    """Every main-path shape, both kernels, fp32 and bf16, kernel vs plain
    on the card. Returns per-kernel summaries; raises on disagreement."""
    import torch

    from sigma_tpu_torch.ops import scan_g

    gen = torch.Generator().manual_seed(SEED)
    summary = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, at="")
               for k in FORWARD}
    failures = []
    for kernel, tag, kw in cases or main_path_scans():
        for dtype, (rtol, atol) in ((torch.float32, FP32_TOL),
                                    (torch.bfloat16, BF16_TOL)):
            x = _inputs(kw, dtype, device, gen)
            for reverse in (False, True):
                with torch.inference_mode():
                    got = _run_case(kernel, kw, x, reverse, True).float()
                    want = _run_case(kernel, kw, x, reverse, False).float()
                torch.cuda.synchronize()
                scale = max(want.abs().max().item(), 1.0)
                err = (got - want).abs().max().item()
                ok = bool(torch.isfinite(got).all()) and torch.allclose(
                    got / scale, want / scale, rtol=rtol, atol=atol)
                line = (f"kernel: {kernel} {tag} {kw} "
                        f"{str(dtype)[6:]} rev={int(reverse)} "
                        f"max_abs_err={err:.3e} scale={scale:.3g} "
                        f"{'ok' if ok else 'FAIL'}")
                if not reverse:
                    with torch.inference_mode():
                        ms = _time_ms(
                            lambda: _run_case(kernel, kw, x, False, True),
                            reps)
                        plain = _time_ms(
                            lambda: _run_case(kernel, kw, x, False, False),
                            max(1, reps // 2))
                    line += f" ms={ms:.4f} plain_ms={plain:.4f}"
                    s = summary[kernel]
                    if dtype == torch.float32 and ms > s["ms"]:
                        s.update(ms=ms, plain_ms=plain,
                                 at=f"{tag} fp32 {kw}", kw=kw)
                if dtype == torch.float32:
                    s = summary[kernel]
                    s["max_abs_err"] = max(s["max_abs_err"], err)
                print(line, flush=True)
                if not ok:
                    failures.append(line)
    scan_g.reset_launches()
    if failures:
        raise AssertionError(f"{len(failures)} kernel comparisons failed")
    return summary


def _scaled_err(got, want):
    """(max |got - want|, ok) at FP32_TOL against max(|want|, 1)."""
    import torch

    scale = max(want.abs().max().item(), 1.0)
    err = (got - want).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got / scale, want / scale, rtol=FP32_TOL[0], atol=FP32_TOL[1])
    return err, ok


def _entry_grads(kw, x, dy, reverse, plain):
    """The gradients of sum(y * dy) through the main path's scan entry
    point at shape `kw`: selective_scan_g_proj_ml on two layout operands,
    selective_scan_g_proj on one (stage 3 routes both to torch.matmul
    projections and K1 / K3), the reversed call with y_accum. `plain`
    takes the plain version instead, each chunk recomputed in the backward
    pass (bounded memory at full size). Returns ({input: gradient}, run):
    run(True) repeats forward and backward, run(False) the forward."""
    import torch

    from sigma_tpu_torch.ops import scan_g

    names = ["u", "w_dt", "w_b", "w_c", "A", "D", "bias"] + (
        ["ya"] if reverse else [])
    leaves = {k: x[k].detach().clone().requires_grad_(True) for k in names}
    args = [leaves[k] for k in ("w_dt", "w_b", "w_c", "A")]
    opts = dict(D=leaves["D"], delta_bias=leaves["bias"],
                delta_softplus=True, reverse=reverse,
                swap_groups_c=kw.get("swap", False))

    def run(backward=True):
        u, ya = leaves["u"], leaves.get("ya")
        if plain:
            y = scan_g.selective_scan_g_proj_plain(
                u, *args, y_accum=ya, remat_chunks=True, **opts)
        elif kw["ml"]:
            y = torch.stack(scan_g.selective_scan_g_proj_ml(
                (u[:, 0], u[:, 1]), *args,
                y_accum=None if ya is None else (ya[:, 0], ya[:, 1]),
                **opts), 1)
        else:
            y = scan_g.selective_scan_g_proj(u, *args, y_accum=ya, **opts)
        if backward:
            return dict(zip(leaves, torch.autograd.grad(
                (y * dy).sum(), list(leaves.values()))))
        return y

    return run(), run


def _kernel_runs(kernel, kw, x, dy):
    """For timing only: {kernel: closure launching it alone} on the inputs
    of one forward main-path call (K3 after K1's checkpoints, or K4 after
    K2's and K5 on K4's cotangents), and {kernel: its plain version} where
    that is not the scan's autograd (K5)."""
    import torch

    from sigma_tpu_torch.ops import scan_g

    w = (x["w_dt"], x["w_b"], x["w_c"])
    common = dict(D=x["D"], delta_bias=x["bias"], delta_softplus=True)
    swap = kw.get("swap", False)
    if kernel == "scan_bwd":
        dts, bs, cs = (torch.matmul(x["u"], wi) for wi in w)
        if swap:
            cs = scan_g._pair_swap(cs)
        _, hck = scan_g.launch_scan_fwd(x["u"], dts, x["A"], bs, cs,
                                        with_hck=True, **common)
        return {"scan_bwd": lambda: scan_g.launch_scan_bwd(
            x["u"], dts, x["A"], bs, cs, x["D"], x["bias"], hck, dy,
            True)}, {}
    if kw["ml"]:
        us, dys = ((t[:, 0].contiguous(), t[:, 1].contiguous())
                   for t in (x["u"], dy))
    else:
        us, dys = (x["u"],), (dy,)
    _, hck = scan_g.launch_scan_proj_fwd(us, *w, x["A"], swap_groups_c=swap,
                                         with_hck=True, **common)

    def k4():
        return scan_g.launch_scan_proj_bwd(us, *w, x["A"], x["D"],
                                           x["bias"], hck, dys, True, False,
                                           swap)

    dus, dd, dB, dC = k4()[:4]
    return ({"scan_proj_bwd": k4,
             "proj_grad": lambda: scan_g.launch_proj_grad(
                 us, dus, dd, dB, dC, *w)},
            {"proj_grad": lambda: scan_g.proj_grad_plain(us, dd, dB, dC,
                                                          *w)})


# which kernel finishes each gradient of the fused path (K4 writes dA, dD
# and the dt-bias gradient; K5 adds du's chain term and makes the weight
# gradients); the streamed path's all come from K3 and autograd
_FUSED_OWNER = dict(A="scan_proj_bwd", D="scan_proj_bwd",
                    bias="scan_proj_bwd", u="proj_grad", w_dt="proj_grad",
                    w_b="proj_grad", w_c="proj_grad")


def backward_phase(device, reps=3):
    """Every distinct scan shape of the train step (batch 2), forward and
    reversed: every gradient through the scan entry point (the autograd
    Functions the train step runs, checked to launch K3 or K4 + K5)
    against autograd of the plain version, then each kernel alone timed
    against its plain version. Returns per-kernel summaries; raises on
    disagreement."""
    import torch

    from sigma_tpu_torch.ops import scan_g

    gen = torch.Generator().manual_seed(SEED + 2)
    summary = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, at="")
               for k in KERNELS if k not in FORWARD}
    failures = []
    for fwd_kernel, tag, kw in main_path_scans(batch=2):
        streamed = fwd_kernel == "scan_fwd"
        ran = (("scan_fwd", "scan_bwd") if streamed else
               ("scan_proj_fwd", "scan_proj_bwd", "proj_grad"))
        x = _inputs(kw, torch.float32, device, gen)
        dy = torch.randn(x["u"].shape, generator=gen).to(device)
        for reverse in (False, True):
            want, plain_run = _entry_grads(kw, x, dy, reverse, plain=True)
            scan_g.reset_launches()
            got, run = _entry_grads(kw, x, dy, reverse, plain=False)
            torch.cuda.synchronize()
            launches = {k: n for k, n in scan_g.LAUNCHES.items() if n}
            bad = [] if launches == dict.fromkeys(ran, 1) else [
                f"launches {launches}"]
            errs = {}
            for k, w in want.items():
                errs[k], ok = _scaled_err(got[k], w)
                if not ok:
                    bad.append(k)
                owner = "scan_bwd" if streamed else _FUSED_OWNER.get(k)
                if owner:
                    summary[owner]["max_abs_err"] = max(
                        summary[owner]["max_abs_err"], errs[k])
            line = (f"backward: {'+'.join(ran[1:])} {tag} {kw} "
                    f"rev={int(reverse)} "
                    + " ".join(f"d{k}={v:.2e}" for k, v in errs.items())
                    + f" {'ok' if not bad else 'FAIL ' + str(bad)}")
            if not reverse:
                def bwd_ms(fn):
                    return (_time_ms(lambda: fn(True), 1, warm=False)
                            - _time_ms(lambda: fn(False), 1, warm=False))

                entry, plain = bwd_ms(run), bwd_ms(plain_run)
                runs, plain_runs = _kernel_runs(ran[1], kw, x, dy)
                times = {k: _time_ms(fn, reps) for k, fn in runs.items()}
                plain_ms = {k: _time_ms(fn, reps)
                            for k, fn in plain_runs.items()}
                line += (f" entry_bwd_ms={entry:.4f}"
                         f" plain_bwd_ms={plain:.4f} " + " ".join(
                             f"{k}_ms={v:.4f}" for k, v in times.items())
                         + "".join(f" plain_{k}_ms={v:.4f}"
                                   for k, v in plain_ms.items()))
                for k, ms in times.items():
                    s = summary[k]
                    if ms > s["ms"]:
                        s.update(ms=ms, plain_ms=plain_ms.get(k, plain),
                                 at=f"{tag} {kw}", kw=kw)
                del runs, plain_runs
            print(line, flush=True)
            if bad:
                failures.append(line)
            del want, got, run, plain_run
            torch.cuda.empty_cache()
    scan_g.reset_launches()
    if failures:
        raise AssertionError(f"{len(failures)} backward comparisons failed")
    return summary


class _SyntheticMFNet:
    """In-memory stand-in for RGBXDataset's val split (same item keys):
    seeded uint8 480x640 RGB, thermal replicated to 3 channels, labels in
    [0, 9) with some 255 ignore pixels. The card's machine has no cv2 to
    decode PNGs."""

    def __init__(self, n, h, w, seed):
        import numpy as np

        rng = np.random.default_rng(seed)
        self.items = []
        for i in range(n):
            x = rng.integers(0, 256, (h, w), dtype=np.uint8)
            label = rng.integers(0, 9, (h, w)).astype(np.uint8)
            label[:8] = 255
            self.items.append(dict(
                data=rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                label=label, modal_x=np.stack([x, x, x], axis=-1),
                fn=f"synthetic{i:02d}", n=n,
            ))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def model_phase(device):
    """The port's serving path: build_model + SlidingEvaluator.run under
    the MFNet preset. Returns the launch counts of that run; raises if a
    kernel was not launched, an output is wrong, or the GPU logits
    disagree with the CPU plain path."""
    import copy

    import numpy as np
    import torch

    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.engine.evaluator import SlidingEvaluator
    from sigma_tpu_torch.models.builder import build_model
    from sigma_tpu_torch.ops import scan_g

    cfg = get_config("mfnet")
    t0 = time.perf_counter()
    model = build_model(cfg, device=device, seed=SEED)
    print(f"model: {cfg.backbone}/{cfg.decoder} {cfg.num_classes} classes "
          f"{sum(p.numel() for p in model.parameters())} params, "
          f"built in {time.perf_counter() - t0:.2f}s")
    data = _SyntheticMFNet(4, cfg.image_height, cfg.image_width, SEED)
    ev = SlidingEvaluator(
        model, cfg.num_classes, cfg.norm_mean, cfg.norm_std,
        multi_scales=cfg.eval_scale_array, is_flip=cfg.eval_flip,
        eval_crop_size=cfg.eval_crop_size, stride_rate=cfg.eval_stride_rate,
        device=device,
    )
    t0 = time.perf_counter()
    pred = ev.sliding_eval(data[0]["data"], data[0]["modal_x"])
    print(f"model: warm-up image {time.perf_counter() - t0:.3f}s")
    if pred.shape != (cfg.image_height, cfg.image_width) or not (
            (pred >= 0) & (pred < cfg.num_classes)).all():
        raise AssertionError(f"bad prediction {pred.shape} {pred.dtype}")

    torch.cuda.reset_peak_memory_stats(device)
    scan_g.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    miou, detail = ev.run(data)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(scan_g.LAUNCHES)
    print(f"model: MFNet {cfg.image_height}x{cfg.image_width} eval of "
          f"{len(data)} images in {seconds:.3f}s = "
          f"{len(data) / seconds:.4f} img/s, mIoU {miou:.4f} "
          f"(random weights), peak "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB, "
          f"launches {launches}")
    if not np.isfinite(miou) or not np.isfinite(detail["pixel_acc"]):
        raise AssertionError(f"non-finite metrics {miou} {detail}")
    missing = [k for k in FORWARD if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    backward = [k for k in launches if k not in FORWARD and launches[k]]
    if backward:
        raise AssertionError(f"backward kernels launched by eval: "
                             f"{backward}")

    # the same model at 96x128: GPU (kernels) against CPU (plain path)
    rng = np.random.default_rng(SEED + 1)
    rgb, mx = (torch.from_numpy(rng.standard_normal((1, 96, 128, 3))
                                .astype(np.float32)) for _ in range(2))
    cpu_model = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        got = model(rgb.to(device), mx.to(device)).cpu()
        want = cpu_model(rgb, mx)
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    err = (got - want).abs().max().item()
    print(f"model: 96x128 GPU vs CPU logits max_abs_err={err:.3e} "
          f"argmax agreement {agree:.5f} (need >= {ARGMAX_AGREEMENT})")
    if not torch.isfinite(got).all() or agree < ARGMAX_AGREEMENT:
        raise AssertionError("GPU logits disagree with the CPU plain path")
    return launches


def train_phase(device, steps=3):
    """The port's train step at the MFNet preset (sigma_tiny, 480x640),
    built as the train CLI and trace_step build it.
    Returns (launch counts of the steps, timing dict); raises if a loss is
    not finite, no weight moved, a kernel was not launched, or the card
    and the CPU disagree on a sigma_test step."""
    import copy

    import numpy as np
    import torch

    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.engine.optim import build_optimizer
    from sigma_tpu_torch.engine.train import (
        build_train,
        create_train_state,
        make_train_step,
    )
    from sigma_tpu_torch.models.builder import EncoderDecoder, init_parameters
    from sigma_tpu_torch.models.common import DropPath
    from sigma_tpu_torch.ops import scan_g
    from sigma_tpu_torch.trace_step import TRAIN_BATCH as batch
    from sigma_tpu_torch.trace_step import synthetic_batch
    from sigma_tpu_torch.utils.lr_schedule import poly_lr

    cfg = get_config("mfnet")
    h, w = cfg.image_height, cfg.image_width
    state, step, schedule = build_train(cfg, device)
    model = state.model
    rng = np.random.default_rng(SEED + 3)
    batches = [synthetic_batch(rng, batch, h, w) for _ in range(steps)]
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats(device)
    scan_g.reset_launches()
    seconds, losses = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(state, b)))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = dict(scan_g.LAUNCHES)
    moved = sum(int((p.detach() != before[k]).sum())
                for k, p in model.named_parameters())
    total = sum(p.numel() for p in model.parameters())
    s_step = sum(seconds[1:]) / len(seconds[1:])
    print(f"train: sigma_tiny MFNet {h}x{w} batch {batch}, {steps} steps: "
          f"losses {losses}, seconds {[round(t, 4) for t in seconds]}, "
          f"lr {[schedule(k) for k in range(steps)]}")
    print(f"train: last {steps - 1} steps {s_step:.4f} s/step = "
          f"{batch / s_step:.4f} img/s, peak "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB, "
          f"{moved} of {total} weights moved, launches {launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train loss {losses}")
    if moved == 0:
        raise AssertionError("the train steps moved no weight")
    missing = [k for k in KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the train step: "
                             f"{missing}")

    # one sigma_test step on the card and on the CPU, same weights/batch
    cfg_t = get_config("mfnet", optimizer="SGDM")
    cpu = init_parameters(EncoderDecoder(9, "sigma_test"), seed=SEED + 4)
    for m in cpu.modules():  # the CPU and CUDA generators draw differently
        if isinstance(m, DropPath):
            m.rate = 0.0
    gpu = copy.deepcopy(cpu).to(device)
    small = synthetic_batch(np.random.default_rng(SEED + 5), 2, 64, 80)
    out = {}
    for name, m in (("cpu", cpu), ("gpu", gpu)):
        o = build_optimizer(cfg_t, m)
        st = create_train_state(m, o)
        loss = make_train_step(m, o, poly_lr(1e-2, 0.9, 100))(st, small)
        out[name] = float(loss)
    err = max((b.cpu() - a).abs().max().item() for a, b in
              zip(cpu.state_dict().values(), gpu.state_dict().values()))
    rel = abs(out["gpu"] - out["cpu"]) / abs(out["cpu"])
    print(f"train: sigma_test 64x80 one SGDM step card vs CPU: loss "
          f"{out['gpu']:.6f} vs {out['cpu']:.6f} (rel {rel:.2e}, need <= "
          f"{TRAIN_LOSS_RTOL}), post-step weights max |diff| {err:.3e} "
          f"(need <= {TRAIN_PARAM_ATOL})")
    if rel > TRAIN_LOSS_RTOL or err > TRAIN_PARAM_ATOL:
        raise AssertionError("the card's train step disagrees with the CPU")
    return launches, dict(s_step=s_step, img_s=batch / s_step)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is run on the CPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import sigma_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    # fp32 means fp32 on the card: cuDNN's float32 convolutions (the 3x3
    # depthwise and CAB convs) default to TF32, and so may matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    t_start = time.perf_counter()
    card = build_phase()
    summary = kernel_phase(device)
    summary.update(backward_phase(device))
    model_phase(device)
    launches, _ = train_phase(device)
    kernels = []
    for name in KERNELS:
        s = summary[name]
        bound_ms, bound_by = _bound(name, s["kw"])
        kernels.append(dict(
            name=name, **KERNELS[name], launches=launches[name],
            max_abs_err=s["max_abs_err"], ms=s["ms"],
            plain_ms=s["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None))
        print(f"summary: {name} ms/plain_ms/bound_ms at its slowest "
              f"main-path call, {s['at']}; max_abs_err over all fp32 "
              f"calls (a backward kernel: over the gradients it "
              f"finishes); launches in the train phase")
    print("summary: library_ms null: no single PyTorch call computes a "
          "selective scan or its gradient, nor K5's pair of products")
    print(f"summary: command time {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
