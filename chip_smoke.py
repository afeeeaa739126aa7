#!/usr/bin/env python3
"""Chip smoke check of the PyTorch port (`sigma_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (written for an NVIDIA H100), nvcc, and the repo's
sources; it imports nothing of JAX. TF32 is off for matmuls and cuDNN, so
fp32 means fp32 on both sides of every comparison. Phases, each printing
its findings:

  1. build    — compile the Hopper kernels from sigma_tpu_torch/csrc (the
                grouped scan's two sources, the fused SS2D epilogue, the
                channel-first scan and the image-layout scan) with nvcc,
                one process per source, all started together (timed);
                print the card's name and power limit.
  2. kernel   — at every main-path scan shape of sigma_tiny at 480x640,
                batch 1, run K1 (streamed) / K2 (fused projection), both
                chunk-parallel, against their plain PyTorch versions on the
                card, fp32 and bf16 io, with the S4D A and dt-bias inits;
                print errors and times. At each shape, fp32, reversed with
                y_accum and checkpoints: a rerun gives the same bits (y and
                hck), y without checkpoints (eval) the same bits as with
                them, and the checkpoints hold the states of the plain
                token-by-token walk (`scan_g.scan_checkpoints_plain`).
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
                products and against cuBLAS: torch.matmul on the
                concatenated operands), and K3 or K4 and K5 each run twice
                on the same inputs (the same bits: all seven outputs of
                K3 / K4, K5's dW and du). Then bf16 with a gradient
                (ROADMAP B1) at stage 1: the four scan entry points return
                bf16 y and gradients within 5e-2 of autograd of the plain
                versions.
  4. epilogue — at every SS2D epilogue shape of sigma_tiny at 480x640 (eval
                batch 1 and train batch 2), fp32 and bf16: K6 against the
                plain forward, K7 against the plain backward formula; fp32
                also through the entry point's autograd (one K6 and one K7
                launch) against autograd of the plain forward, all five
                gradients, and a K7 rerun that must give the same dgamma /
                dbeta bits. z is a column slice, as SS2D splits it. Prints
                errors and the ms of K6 / K7, of their plain versions and
                of the unfused chain of PyTorch calls the switch replaces.
  5. ops      — the ops-level scan entry points (sigma_tpu_torch.ops) at
                every trunk SS2D scan of sigma_tiny at 480x640, batch 2
                (RGB and X stacked), four directions, d_state 16, S4D A
                and dt-bias inits: `selective_scan` in the reference's
                channel-first layout (K8 forward, K9 backward) and
                `selective_scan_cl` in the per-row layout (K1 / K3), fp32
                and bf16 io forward at all four stages, all seven
                gradients at stages 0 and 3, against the plain versions
                (autograd, each chunk recomputed). Every call must launch
                its kernels once and nothing else; the counters are zeroed
                before these calls and read after them. Then K8, K9, K1
                and K3 are timed launched alone against the plain
                versions and their bounds, K8 beside K1 and K9 beside K3
                on the same scan; K8 (y, hck) and K9 rerun bit for bit
                and every 32-token checkpoint of K8 holds the plain
                token-by-token walk's state
                (`scan_g.scan_checkpoints_plain`).
  6. image    — the image-layout SS2D scan `selective_scan_ss2d_proj` (K10
                forward, K11 + K5 backward) at sigma_tiny's four trunk SS2D
                shapes at 480x640, batch 2 (RGB and X stacked), d_state
                16, S4D A and dt-bias inits: fp32 and bf16 forward at every
                stage and all seven gradients at stages 0 and 3 against
                the plain version (the stacked composition, autograd, each
                chunk recomputed), one K10 per forward and K11 + two K5 per
                backward and nothing else; K10 (y, hck) and K11 rerun bit
                for bit, and K10's checkpoints hold the plain walk's states
                (K11's layout).
                Then the grouped and per-row scan entry points at d_state
                17 and 40 (slices of 16 on K1 / K3) against their plain
                versions. Timed (CUDA events): K10, K11 and K5 launched
                alone, the plain version, and the same function through
                the route the port's SS2D takes today (the wh transpose
                copy, two selective_scan_g_proj_ml calls, the
                un-transpose), forward and forward + backward, the image
                route's forward + backward beside the two-call route's on
                one line per stage.
  7. model    — sigma_tiny / MambaDecoder / 9 classes, seeded weights, four
                seeded 480x640 RGB-X pairs through the port's
                SlidingEvaluator.run under the MFNet preset, with the fused
                SS2D epilogue off, on, on, off (one model): img/s and mIoU
                of each run; K1 and K2 must have been launched, K6 once
                per SS2D forward with the switch on and never with it off,
                no backward kernel. Logits of one 480x640 pair with the
                switch on against off. Then the same model at 96x128, both
                ways: GPU logits against the CPU plain path.
  8. train    — the train CLI's step (engine.train.build_train: AdamW,
                warmup-poly lr, remat, drop path) for 3 steps at 480x640,
                batch 2, on seeded synthetic uint8 batches with pad
                margins (trace_step.synthetic_batch), with the switch off,
                on, on, off (the same seeded weights each time): finite
                losses, parameters changed, K1-K5 all launched, K6 / K7 as
                many times as the remat plan implies with the switch on
                and never with it off; s/step and img/s of the last two
                steps. Then one step of sigma_test at 64x80 on the card and
                on the CPU from the same weights and batch (drop path 0,
                SGD with momentum), both ways: losses and post-step
                parameters against each other.
  9. bits     — K1-K4, K10 and K11 at the four trunk stages give the bits
                recorded before K9 joined their backward body
                (`BODY_BITS`); last, so that its calls precede no timed
                phase.

Ends with the card line, one JSON line of the kernels (launches from the
train phase's last run with the switch on, K8 / K9's from the ops phase,
K10 / K11's from the image phase;
bound_ms from this run's shapes, see `_work`), then the device line. Exits non-zero, with no result line,
without a CUDA card or when a phase fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from collections import defaultdict
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
# H100 SXM data sheet: HBM rate, fp32 rate outside the tensor cores, dense
# TF32 rate of the tensor cores
HBM_BYTES_PER_S = 3.35e12
# the residual the channel-first scan's backward needs: the forward's state
# every 256 tokens, as the JAX reference keeps it (`_work` counts it for K9)
CF_CARRY_TOKENS = 256
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12

KERNELS = {
    "scan_fwd": dict(
        route="cuda", source="sigma_tpu_torch/csrc/scan_g_fwd.cu",
        replaces="sigma_tpu/ops/pallas_scan_g.py:149 (_fwd_kernel via "
                 "_fwd_call :806, proj=False); in the per-row layout also "
                 "sigma_tpu/ops/pallas_scan_seq.py:40 (_fwd_kernel via "
                 "_fwd_call :157, pallas_call :165)"),
    "scan_proj_fwd": dict(
        route="cuda", source="sigma_tpu_torch/csrc/scan_g_fwd.cu",
        replaces="sigma_tpu/ops/pallas_scan_g.py:149 (_fwd_kernel via "
                 "_fwd_call :806 proj=True and _fwd_call_ml :894)"),
    "scan_bwd": dict(
        route="cuda", source="sigma_tpu_torch/csrc/scan_g_bwd.cu",
        replaces="sigma_tpu/ops/pallas_scan_g.py:305 (_bwd_kernel via "
                 "_bwd_call :989, streamed pallas_call :1111); in the "
                 "per-row layout also sigma_tpu/ops/pallas_scan_seq.py:71 "
                 "(_bwd_kernel via _scan_core_cl_bwd :212, pallas_call "
                 ":224)"),
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
    "merge_ln_gate_fwd": dict(
        route="cuda", source="sigma_tpu_torch/csrc/merge_ln_gate.cu",
        replaces="sigma_tpu/ops/pallas_merge_ln_gate.py:54 (_fwd_kernel via "
                 "_fwd, pallas_call :153)"),
    "merge_ln_gate_bwd": dict(
        route="cuda", source="sigma_tpu_torch/csrc/merge_ln_gate.cu",
        replaces="sigma_tpu/ops/pallas_merge_ln_gate.py:66 (_bwd_kernel via "
                 "_vjp_bwd, pallas_call :183)"),
    "scan_cf_fwd": dict(
        route="cuda", source="sigma_tpu_torch/csrc/scan_cf.cu",
        replaces="sigma_tpu/ops/pallas_scan.py:41 (_fwd_kernel via "
                 "_fwd_call :85, pallas_call :94)"),
    "scan_cf_bwd": dict(
        route="cuda", source="sigma_tpu_torch/csrc/scan_cf.cu",
        replaces="sigma_tpu/ops/pallas_scan_bwd.py:49 (_bwd_kernel via "
                 "selective_scan_pallas_bwd :132, pallas_call :176)"),
    "scan_img_fwd": dict(
        route="cuda", source="sigma_tpu_torch/csrc/scan_img.cu",
        replaces="sigma_tpu/ops/pallas_scan_g.py:1856 (_fwd_kernel_img via "
                 "_fwd_call_img :2217, pallas_call :2249)"),
    "scan_img_bwd": dict(
        route="cuda", source="sigma_tpu_torch/csrc/scan_img.cu",
        replaces="sigma_tpu/ops/pallas_scan_g.py:1942 (_bwd_kernel_img via "
                 "_bwd_call_img :2270, pallas_call :2323)"),
}
FORWARD = ("scan_fwd", "scan_proj_fwd")
SCAN_BACKWARD = ("scan_bwd", "scan_proj_bwd", "proj_grad")
EPILOGUE = ("merge_ln_gate_fwd", "merge_ln_gate_bwd")
OPS = ("scan_cf_fwd", "scan_cf_bwd")
IMAGE = ("scan_img_fwd", "scan_img_bwd")


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


def _streams(kw, x):
    """The streamed kernel's dt, B, C: projections outside the kernel (and
    outside its time), as the main path makes them with torch.matmul, C
    swapped between the chain pair under CroMB; made once per input."""
    import torch

    if "dts" not in x:
        x["dts"], x["bs"], x["cs"] = (
            torch.matmul(x["u"], x[k]) for k in ("w_dt", "w_b", "w_c"))
        if kw.get("swap", False):
            x["cs"] = x["cs"].flip(1)
    return x["dts"], x["bs"], x["cs"]


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
    u = x["u"]
    dts, bs, cs = _streams(kw, x)
    if use_kernel:
        return scan_g.launch_scan_fwd(u, dts, x["A"], bs, cs, y_accum=ya,
                                      **common)
    y = scan_g.selective_scan_g_plain(u.float(), dts.float(), x["A"],
                                      bs.float(), cs.float(), **common)
    if ya is not None:
        y = y + ya.float()
    return y.to(u.dtype)


def _work(kernel, kw, reverse=False, cf_ck=CF_CARRY_TOKENS):
    """(bytes, operations) of one call's function at shape `kw`, fp32:
    each input read once and each output written once; operations count
    an exp or a division as one. Scan: 9 per (token, chain, channel,
    state) forward (the JAX package's flops count), 22 backward (5 to
    recompute h, 14 in the dh sweep, 3 in the dB / dC channel sums);
    projections 2 per multiply-add. Epilogue, per element: K6 reads y_hw,
    y_wh, z and writes out (16 bytes) for 14 operations; K7 reads the three
    and dout and writes three gradients (28 bytes) for 32 operations; both
    read gamma and beta, K7 writes their gradients. K8 / K9 count as K1 /
    K3 on the scan core (no bias, D or their gradients; A read, dA
    written), K9 reading the function's residual, the state every
    `cf_ck` tokens (by default the reference's 256; `CK_TOKENS` counts
    the 32-token checkpoints this K9 reads, more than the function needs).
    `kw` may name
    the streamed kernels' G (the per-row layout's). K10 / K11 count the
    image's four chains: K10 reads x once and writes y once, with its
    projections (the JAX package's count); K11 reads x, dy and the
    checkpoints and writes du once, dd / dB / dC per chain and dA /
    dbias / dD, with the scan backward and the re-projections (K10's and
    K11's projections count at the TF32 rate, `_tf32_ops`)."""
    from sigma_tpu_torch.ops.scan_g import CK_TOKENS
    from sigma_tpu_torch.ops.scan_img import IMG_CK_TOKENS

    if kernel in IMAGE:
        B, dg, N = kw["B"], kw["dg"], kw["N"]
        L = kw["H"] * kw["W"]
        img, chains = 4 * B * L * dg, 4 * 4 * B * L
        wts = 4 * 4 * dg * (dg + 2 * N)
        params = 4 * 4 * dg * (N + 2)
        proj = 2 * 4 * B * L * dg * (dg + 2 * N)
        if kernel == "scan_img_fwd":
            return 2 * img + wts + params, 9 * 4 * B * L * dg * N + proj
        hck = 4 * 4 * B * -(-L // IMG_CK_TOKENS) * N * dg
        return (3 * img + chains * dg + 2 * chains * N + hck + wts
                + 2 * params, 22 * 4 * B * L * dg * N + proj)

    if kernel in EPILOGUE:
        n, c = kw["B"] * kw["H"] * kw["W"] * kw["C"], kw["C"]
        return {"merge_ln_gate_fwd": (16 * n + 8 * c, 14 * n),
                "merge_ln_gate_bwd": (28 * n + 16 * c, 32 * n)}[kernel]
    if kernel in OPS:
        rows, dg, L, N = kw["batch"] * kw["G"], kw["dg"], kw["L"], kw["N"]
        big, small = 4 * rows * dg * L, 4 * rows * N * L
        a, work = 4 * kw["G"] * dg * N, rows * dg * L * N
        if kernel == "scan_cf_fwd":
            return 3 * big + 2 * small + a, 9 * work
        hck = 4 * rows * -(-L // cf_ck) * dg * N
        return 5 * big + 4 * small + hck + 2 * a, 22 * work

    G = kw.get("G", 2 if kw["ml"] else 1)
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


def _tf32_ops(kernel, kw):
    """The operations of `_work` that run on the tensor cores (TF32): K2's,
    K4's, K10's and K11's projections and K5's two products; the rest run
    on the fp32 cores."""
    if kernel in IMAGE:
        return 2 * 4 * kw["B"] * kw["H"] * kw["W"] * kw["dg"] * (
            kw["dg"] + 2 * kw["N"])
    if kernel not in ("scan_proj_fwd", "scan_proj_bwd", "proj_grad"):
        return 0
    G = kw.get("G", 2 if kw["ml"] else 1)
    proj = 2 * kw["B"] * G * kw["L"] * kw["dg"] * (kw["dg"] + 2 * kw["N"])
    return 2 * proj if kernel == "proj_grad" else proj


def _bound(kernel, kw, reverse=False, cf_ck=CF_CARRY_TOKENS):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the HBM rate and the operations over the peak rate
    of the units that run them (TF32 tensor cores, fp32 cores)."""
    nbytes, ops = _work(kernel, kw, reverse, cf_ck)
    tc = _tf32_ops(kernel, kw)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max((ops - tc) / FP32_OPS_PER_S, tc / TF32_OPS_PER_S)
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


def _device_ms(fn, reps):
    """Device time per call of `fn`: the summed durations of the kernels
    it launches (torch.profiler), over `reps` calls after a warm-up. Unlike
    `_time_ms`, it leaves out the host's time between launches, which
    bounds a call of a few tens of microseconds. Returns
    ({kernel name: ms per call}, total ms per call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    by_name = {k: v / reps for k, v in by_name.items()}
    return by_name, sum(by_name.values())


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
            if dtype == torch.float32:
                line = _checkpoint_checks(kernel, kw, x)
                print(f"kernel: {kernel} {tag} {line}", flush=True)
                if "FAIL" in line:
                    failures.append(line)
            del x
    scan_g.reset_launches()
    if failures:
        raise AssertionError(f"{len(failures)} kernel comparisons failed")
    return summary


def _checkpoint_checks(kernel, kw, x):
    """K1 or K2 reversed with y_accum and checkpoints, as the train step's
    second direction group runs it, twice: the same bits (the carries run
    in a fixed order); y as eval computes it (no checkpoints) has the same
    bits; the checkpoints hold the states of the plain token-by-token walk
    over the same dt and B (K2: projected by torch.matmul, fp32) at the
    fp32 tier. Returns the line to print (FAIL in it on a failure)."""
    import torch

    from sigma_tpu_torch.ops import scan_g

    opts = dict(D=x["D"], delta_bias=x["bias"], delta_softplus=True,
                reverse=True)
    with torch.inference_mode():
        if kernel == "scan_proj_fwd":
            ml = kw["ml"]
            us = (x["u"][:, 0], x["u"][:, 1]) if ml else (x["u"],)
            yas = (x["ya"][:, 0], x["ya"][:, 1]) if ml else (x["ya"],)
            args = (x["w_dt"], x["w_b"], x["w_c"], x["A"])
            dts, bs = (torch.matmul(x["u"], w) for w in args[:2])

            def run(with_hck):  # ([y per layout], hck or None)
                out = scan_g.launch_scan_proj_fwd(
                    us, *args, swap_groups_c=kw.get("swap", False),
                    y_accum=yas, with_hck=with_hck, **opts)
                return (list(out[0]), out[1]) if with_hck else (out, None)
        else:
            dts, bs, cs = _streams(kw, x)

            def run(with_hck):
                out = scan_g.launch_scan_fwd(x["u"], dts, x["A"], bs, cs,
                                             y_accum=x["ya"],
                                             with_hck=with_hck, **opts)
                return ([out[0]], out[1]) if with_hck else ([out], None)

        (y1, h1), (y2, h2), (y0, _) = run(True), run(True), run(False)
        rerun = torch.equal(h1, h2) and all(map(torch.equal, y1, y2))
        same = all(map(torch.equal, y0, y1))
        want = scan_g.scan_checkpoints_plain(x["u"], dts, x["A"], bs,
                                             x["bias"], True, True)
    err, ok = _scaled_err(h1, want)
    del y1, y2, y0, h1, h2, want, dts, bs
    return (f"rev=1 with checkpoints: rerun bit for bit "
            f"{'ok' if rerun else 'FAIL'}; y as eval computes it, same bits "
            f"{'ok' if same else 'FAIL'}; hck against the plain walk "
            f"max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")


def _scaled_err(got, want, tol=FP32_TOL):
    """(max |got - want|, ok) at `tol` (rtol, atol) against
    max(|want|, 1), in fp32."""
    import torch

    got, want = got.float(), want.float()
    scale = max(want.abs().max().item(), 1.0)
    err = (got - want).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got / scale, want / scale, rtol=tol[0], atol=tol[1])
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


def _proj_grad_library(us, dd, dB, dC, w):
    """K5's function as cuBLAS products: per chain dW = u^T [dd | dB | dC]
    and du_chain = [dd | dB | dC] [W_dt | W_B | W_C]^T, torch.matmul on the
    concatenated operands (made here, outside the timed closure)."""
    import torch

    u = us[0] if len(us) == 1 else torch.stack(tuple(us), 1)
    G, dg = u.shape[1], u.shape[-1]
    z = torch.cat([dd, dB, dC], -1)
    ut = u.transpose(0, 1).reshape(G, -1, dg).transpose(1, 2)
    zt = z.transpose(0, 1).reshape(G, -1, z.shape[-1])
    wt = torch.cat(w, -1).transpose(1, 2)
    return lambda: (torch.matmul(ut, zt), torch.matmul(z, wt))


def _same_bits(first, again):
    """True when two runs' outputs (tensors or lists of them) are equal
    bit for bit."""
    import torch

    def flat(out):
        return [t for o in out
                for t in (o if isinstance(o, (list, tuple)) else (o,))]

    return all(torch.equal(a, b) for a, b in zip(flat(first), flat(again)))


def _kernel_runs(kernel, kw, x, dy):
    """For timing: {kernel: closure launching it alone} on the inputs of
    one forward main-path call (K3 after K1's checkpoints, or K4 after
    K2's and K5 on K4's cotangents), {kernel: its plain version} where
    that is not the scan's autograd (K5), {kernel: the PyTorch library
    calls that compute its function} (K5's cuBLAS products), and
    {kernel: whether two runs gave the same bits} (K3 or K4: all seven
    outputs; K5: dW and du)."""
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

        def k3():
            return scan_g.launch_scan_bwd(x["u"], dts, x["A"], bs, cs,
                                          x["D"], x["bias"], hck, dy, True)

        return {"scan_bwd": k3}, {}, {}, {"scan_bwd": _same_bits(k3(), k3())}
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

    out = k4()
    reruns = {"scan_proj_bwd": _same_bits(out, k4())}
    dus, dd, dB, dC = out[:4]
    # K5 twice from the same du: the same bits (split partials summed in
    # a fixed order, each du element owned by one block)
    first, again = ([d.clone() for d in dus] for _ in range(2))
    w1 = scan_g.launch_proj_grad(us, first, dd, dB, dC, *w)
    w2 = scan_g.launch_proj_grad(us, again, dd, dB, dC, *w)
    reruns["proj_grad"] = _same_bits([*w1, *first], [*w2, *again])
    del first, again, w1, w2, out
    return ({"scan_proj_bwd": k4,
             "proj_grad": lambda: scan_g.launch_proj_grad(
                 us, dus, dd, dB, dC, *w)},
            {"proj_grad": lambda: scan_g.proj_grad_plain(us, dd, dB, dC,
                                                          *w)},
            {"proj_grad": _proj_grad_library(us, dd, dB, dC, w)}, reruns)


# which kernel finishes each gradient of the fused path (K4 writes dA, dD
# and the dt-bias gradient; K5 adds du's chain term and makes the weight
# gradients); the streamed path's all come from K3 and autograd
_FUSED_OWNER = dict(A="scan_proj_bwd", D="scan_proj_bwd",
                    bias="scan_proj_bwd", u="proj_grad", w_dt="proj_grad",
                    w_b="proj_grad", w_c="proj_grad")


def _bf16_grad_checks(device):
    """bf16 with a gradient (ROADMAP B1) at one main-path shape: the train
    step's stage-1 SS2D scan (4 sequences of 4,800 tokens, dg 384, d_state
    16) through `selective_scan_g`, `selective_scan_g_proj` and
    `selective_scan_g_proj_ml`, and trunk stage 1's image (batch 2, 60x80)
    through `selective_scan_ss2d_proj`, with u / x and the projection
    weights in bf16: y and every gradient must come back bf16, within 5e-2
    of autograd of the plain version in fp32 on the same (bf16-rounded)
    values. Returns the failed lines."""
    import torch

    from sigma_tpu_torch.ops import scan_g, scan_img

    kw = dict(ml=True, B=4, L=4800, dg=384, N=16)
    x = _inputs(kw, torch.float32, device,
                torch.Generator().manual_seed(SEED + 50))
    opts = dict(D=x["D"], delta_bias=x["bias"], delta_softplus=True,
                reverse=True)
    A = x["A"]
    img = _img_inputs(dict(B=2, H=60, W=80, dg=384, N=16), torch.float32,
                      device, SEED + 51)

    def streamed(u, ws, plain):
        fn = scan_g.selective_scan_g_plain if plain else scan_g.selective_scan_g
        extra = dict(remat_chunks=True) if plain else {}
        return fn(u, u @ ws[0], A, u @ ws[1], u @ ws[2], **opts, **extra)

    def proj(u, ws, plain):
        if plain:
            return scan_g.selective_scan_g_proj_plain(
                u, *ws, A, swap_groups_c=True, remat_chunks=True, **opts)
        return scan_g.selective_scan_g_proj(u, *ws, A, swap_groups_c=True,
                                            **opts)

    def proj_ml(u, ws, plain):
        if plain:
            return scan_g.selective_scan_g_proj_plain(u, *ws, A,
                                                      remat_chunks=True,
                                                      **opts)
        return torch.stack(scan_g.selective_scan_g_proj_ml(
            (u[:, 0], u[:, 1]), *ws, A, **opts), 1)

    def image(u, ws, plain):
        rest = dict(A=img["A"], D=img["D"], delta_bias=img["delta_bias"],
                    delta_softplus=True)
        if plain:
            return scan_img.selective_scan_ss2d_proj_plain(
                u, *ws, remat_chunks=True, **rest)
        return scan_g.selective_scan_ss2d_proj(u, *ws, **rest)

    failures = []
    wx = [x["w_dt"], x["w_b"], x["w_c"]]
    wi = [img["w_dt"], img["w_b"], img["w_c"]]
    for name, fn, u, ws in (
            ("selective_scan_g", streamed, x["u"], wx),
            ("selective_scan_g_proj", proj, x["u"], wx),
            ("selective_scan_g_proj_ml", proj_ml, x["u"], wx),
            ("selective_scan_ss2d_proj", image, img["x"], wi)):
        dy = torch.randn(u.shape, device=device, generator=torch.Generator(
            device=device).manual_seed(SEED + 52))
        grads = {}
        for dtype in (torch.bfloat16, torch.float32):
            leaves = [t.to(torch.bfloat16).to(dtype).requires_grad_(True)
                      for t in (u, *ws)]
            _reset_launches()
            y = fn(leaves[0], leaves[1:], plain=dtype == torch.float32)
            grads[dtype] = (y.dtype, torch.autograd.grad(y.float(), leaves,
                                                         dy))
            if dtype == torch.bfloat16:
                torch.cuda.synchronize()
                ran = {k: n for k, n in _launches().items() if n}
            del y, leaves
        (ydt, got), (_, want) = grads[torch.bfloat16], grads[torch.float32]
        errs, bad = [], []
        for k, g, w in zip(("du", "dW_dt", "dW_B", "dW_C"), got, want):
            err, ok = _scaled_err(g, w, BF16_TOL)
            errs.append(f"{k}={err:.2e}")
            if not ok or g.dtype != torch.bfloat16:
                bad.append(f"{k} {g.dtype}")
        if ydt != torch.bfloat16:
            bad.append(f"y {ydt}")
        line = (f"backward: bf16 with a gradient {name} " + " ".join(errs)
                + f" launched {ran} " + ("ok" if not bad else f"FAIL {bad}"))
        print(line, flush=True)
        if bad:
            failures.append(line)
        del grads, got, want, dy
        torch.cuda.empty_cache()
    _reset_launches()
    return failures


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
    summary = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                       library_ms=None, at="") for k in SCAN_BACKWARD}
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
                runs, plain_runs, lib_runs, reruns = _kernel_runs(
                    ran[1], kw, x, dy)
                bad += [f"{k} rerun changed bits"
                        for k, same in reruns.items() if not same]
                times = {k: _time_ms(fn, reps) for k, fn in runs.items()}
                plain_ms = {k: _time_ms(fn, reps)
                            for k, fn in plain_runs.items()}
                lib_ms = {k: _time_ms(fn, reps) for k, fn in lib_runs.items()}
                line += (" reruns bit for bit " + " ".join(
                            f"{k} {'ok' if same else 'FAIL'}"
                            for k, same in reruns.items())
                         + f" entry_bwd_ms={entry:.4f}"
                         f" plain_bwd_ms={plain:.4f} " + " ".join(
                             f"{k}_ms={v:.4f}" for k, v in times.items())
                         + "".join(f" plain_{k}_ms={v:.4f}"
                                   for k, v in plain_ms.items())
                         + "".join(f" library_{k}_ms={v:.4f}"
                                   for k, v in lib_ms.items()))
                for k, ms in times.items():
                    s = summary[k]
                    if ms > s["ms"]:
                        s.update(ms=ms, plain_ms=plain_ms.get(k, plain),
                                 library_ms=lib_ms.get(k),
                                 at=f"{tag} {kw}", kw=kw)
                del runs, plain_runs, lib_runs
            print(line, flush=True)
            if bad:
                failures.append(line)
            del want, got, run, plain_run
            torch.cuda.empty_cache()
    scan_g.reset_launches()
    failures += _bf16_grad_checks(device)
    if failures:
        raise AssertionError(f"{len(failures)} backward comparisons failed")
    return summary


def epilogue_shapes(H=480, W=640):
    """{(B, h, w, C): tags} of every SS2D epilogue of sigma_tiny at HxW:
    a trunk SS2D sees both modalities (batch 2 in eval, 4 in a batch-2
    train step), a decoder SS2D one (1 / 2), at stages 0-2."""
    shapes = {}
    for s, dim in enumerate((96, 192, 384, 768)):
        h, w, c = H // 4 >> s, W // 4 >> s, 2 * dim
        for mode, batch in (("eval", 1), ("train", 2)):
            shapes.setdefault((2 * batch, h, w, c), []).append(
                f"trunk{s}-{mode}")
            if s < 3:
                shapes.setdefault((batch, h, w, c), []).append(
                    f"dec{s}-{mode}")
    return shapes


def _epilogue_inputs(kw, dtype, device, gen):
    """y_hw, y_wh, z, gamma, beta and a cotangent dout at shape `kw`; z is
    the second half of a (B, H, W, 2C) tensor, as SS2D splits it out of
    in_proj's output."""
    import torch

    b, h, w, c = kw["B"], kw["H"], kw["W"], kw["C"]
    rnd = lambda *s: torch.randn(s, generator=gen).to(device)  # noqa: E731
    y_hw, y_wh = rnd(b, h, w, c).to(dtype), rnd(b, w, h, c).to(dtype)
    z = rnd(b, h, w, 2 * c).to(dtype)[..., c:]
    gamma, beta = 1.0 + 0.1 * rnd(c), 0.1 * rnd(c)
    return [y_hw, y_wh, z, gamma, beta], rnd(b, h, w, c)


def _unfused(y_hw, y_wh, z, gamma, beta, eps):
    """What the switch replaces: SS2D's unfused epilogue, PyTorch calls."""
    import torch.nn.functional as F

    y = y_hw + y_wh.transpose(1, 2)
    return F.layer_norm(y, (y.shape[-1],), gamma, beta, eps) * F.silu(z)


def epilogue_phase(device, reps=10):
    """Every SS2D epilogue shape, fp32 and bf16: K6 / K7 against the plain
    forward and backward; fp32 also the entry point's autograd (K6 + K7,
    launches counted) against autograd of the plain forward and a K7 rerun
    for identical dgamma / dbeta bits; the device ms of K6 / K7, of the
    plain versions and of the unfused chain. Returns per-kernel summaries;
    raises on disagreement."""
    import torch

    from sigma_tpu_torch.models.common import LN_EPS as eps
    from sigma_tpu_torch.ops import merge_ln_gate as mlg

    gen = torch.Generator().manual_seed(SEED + 6)
    summary = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, unfused_ms=0.0,
                       at="") for k in EPILOGUE}
    names = ("dy_hw", "dy_wh", "dz", "dgamma", "dbeta")
    failures = []
    for (b, h, w, c), tags in epilogue_shapes().items():
        kw = dict(B=b, H=h, W=w, C=c)
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            args, dout = _epilogue_inputs(kw, dtype, device, gen)
            errs, bad = {}, []
            out = mlg.launch_merge_ln_gate_fwd(*args, eps)
            errs["out"], ok = _scaled_err(
                out, mlg.merge_ln_gate_plain(*args, eps), tol)
            bad += [] if ok and out.dtype == torch.float32 else ["out"]
            got = mlg.launch_merge_ln_gate_bwd(*args, eps, dout)
            want = mlg.merge_ln_gate_bwd_plain(*args, eps, dout)
            for k, g_, w_ in zip(names, got, want):
                errs[k], ok = _scaled_err(g_, w_, tol)
                bad += [] if ok and g_.dtype == w_.dtype else [k]
            line = (f"epilogue: {'/'.join(tags)} {kw} {str(dtype)[6:]} "
                    + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
            if dtype == torch.float32:
                # the entry point's autograd: one K6, one K7
                leaves = [x.detach().clone().requires_grad_(True)
                          for x in args]
                zfull = torch.cat([args[2], args[2]], -1).requires_grad_(True)
                leaves[2] = zfull[..., c:]
                mlg.reset_launches()
                o = mlg.merge_ln_gate(*leaves, eps)
                g_entry = torch.autograd.grad(o, leaves, dout)
                torch.cuda.synchronize()
                if dict(mlg.LAUNCHES) != dict.fromkeys(EPILOGUE, 1):
                    bad.append(f"launches {mlg.LAUNCHES}")
                g_auto = torch.autograd.grad(
                    mlg.merge_ln_gate_plain(*leaves, eps), leaves, dout)
                for k, g_, w_ in zip(names, g_entry, g_auto):
                    e, ok = _scaled_err(g_, w_)
                    errs[k] = max(errs[k], e)
                    bad += [] if ok else [f"autograd {k}"]
                again = mlg.launch_merge_ln_gate_bwd(*args, eps, dout)
                if not all(torch.equal(got[i], again[i]) for i in (3, 4)):
                    bad.append("rerun dgamma/dbeta bits")
                s6, s7 = (summary[k] for k in EPILOGUE)
                s6["max_abs_err"] = max(s6["max_abs_err"], errs["out"])
                s7["max_abs_err"] = max(s7["max_abs_err"],
                                        *(errs[k] for k in names))

                def unfused_run(backward):
                    y = _unfused(*leaves, eps)
                    if backward:
                        torch.autograd.grad(y, leaves, dout)

                runs = {
                    "k6": lambda: mlg.launch_merge_ln_gate_fwd(*args, eps),
                    "plain": lambda: mlg.merge_ln_gate_plain(*args, eps),
                    "unfused": lambda: _unfused(*args, eps),
                    "k7": lambda: mlg.launch_merge_ln_gate_bwd(*args, eps,
                                                               dout),
                    "plain_bwd": lambda: mlg.merge_ln_gate_bwd_plain(
                        *args, eps, dout)}
                # device time: the host's time between launches bounds a
                # call of a few tens of microseconds on the stream
                with torch.no_grad():
                    dev = {k: _device_ms(f, reps) for k, f in runs.items()}
                dev["unfused_bwd"] = (
                    None, _device_ms(lambda: unfused_run(True), reps)[1]
                    - _device_ms(lambda: unfused_run(False), reps)[1])
                # a kernel's own time; its plain version and the unfused
                # chain: all the kernels they launch
                d6 = sum(v for k, v in dev["k6"][0].items()
                         if "merge_ln_gate_fwd_kernel" in k)
                d7 = sum(v for k, v in dev["k7"][0].items()
                         if "merge_ln_gate_bwd_kernel" in k)
                dt = {k: v[1] for k, v in dev.items()}
                line += (" device_ms: k6=%.4f plain=%.4f unfused=%.4f "
                         "k7=%.4f (wrapper %.4f) plain_bwd=%.4f "
                         "unfused_bwd=%.4f" % (
                             d6, dt["plain"], dt["unfused"], d7, dt["k7"],
                             dt["plain_bwd"], dt["unfused_bwd"]))
                for s_, t, p_, u in (
                        (s6, d6, dt["plain"], dt["unfused"]),
                        (s7, d7, dt["plain_bwd"], dt["unfused_bwd"])):
                    if t > s_["ms"]:
                        s_.update(ms=t, plain_ms=p_, unfused_ms=u,
                                  at=f"{'/'.join(tags)} fp32 {kw}", kw=kw)
                del leaves, zfull, o, g_entry, g_auto, again, runs
            line += f" {'ok' if not bad else 'FAIL ' + str(bad)}"
            print(line, flush=True)
            if bad:
                failures.append(line)
            del args, dout, out, got, want
    torch.cuda.empty_cache()
    mlg.reset_launches()
    if failures:
        raise AssertionError(f"{len(failures)} epilogue comparisons failed")
    return summary


def ops_scans(H=480, W=640, batch=2):
    """(tag, kw) of the reference-layout scans of sigma_tiny's trunk SS2Ds
    at HxW: batch 2 (RGB and X stacked on the batch axis), the four
    directions as G = 4 groups of d_inner channels, d_state 16."""
    return [(f"trunk{s}", dict(batch=batch, G=4, dg=2 * dim, N=16,
                               L=(H // 4 >> s) * (W // 4 >> s)))
            for s, dim in enumerate((96, 192, 384, 768))]


def _ops_inputs(kw, device, seed):
    """Channel-first operands of `selective_scan` at `kw`: u = silu(randn),
    raw dt 0.5 randn, S4D A, inverse-softplus dt bias, D ones (the streams
    drawn on the card)."""
    import torch

    from sigma_tpu_torch.models.common import a_log_init, dt_proj_bias_init

    batch, G, dg, L, N = (kw[k] for k in ("batch", "G", "dg", "L", "N"))
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device=device)  # noqa: E731
    bias = dt_proj_bias_init((G * dg,), torch.Generator().manual_seed(seed))
    return dict(u=torch.nn.functional.silu(rnd(batch, G * dg, L)),
                delta=0.5 * rnd(batch, G * dg, L),
                A=-torch.exp(a_log_init(G, dg, N)).to(device),
                B=rnd(batch, G, N, L), C=rnd(batch, G, N, L),
                D=torch.ones(G * dg, device=device), delta_bias=bias.to(device))


def _per_row(x, kw):
    """The same scan in selective_scan_cl's per-row layout: rows
    (batch*G, L, dg), A (G, N, dg), B / C (batch*G, L, N), D / delta_bias
    (G, dg)."""
    batch, G, dg, L, N = (kw[k] for k in ("batch", "G", "dg", "L", "N"))

    def rows(t, width):
        return t.reshape(batch, G, width, L).transpose(2, 3).reshape(
            batch * G, L, width).contiguous()

    return dict(u=rows(x["u"], dg), delta=rows(x["delta"], dg),
                A=x["A"].reshape(G, dg, N).transpose(1, 2).contiguous(),
                B=rows(x["B"], N), C=rows(x["C"], N),
                D=x["D"].reshape(G, dg), delta_bias=x["delta_bias"].reshape(
                    G, dg))


def _rows(t, batch, G, width):
    """(batch, G*width, L) channel-first -> (batch, G, L, width)."""
    return t.reshape(batch, G, width, -1).transpose(2, 3)


def _ops_grads(fn, x, dy):
    """y = fn(**x) and the gradients of sum(y * dy) w.r.t. all seven
    inputs."""
    import torch

    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in x.items()}
    y = fn(**leaves)
    grads = torch.autograd.grad((y * dy).sum(), list(leaves.values()))
    return y.detach(), dict(zip(leaves, grads))


OPS_GRAD_STAGES = (0, 3)


def ops_phase(device, reps=3):
    """The ops-level scan entry points at every trunk SS2D scan of
    sigma_tiny at 480x640, batch 2, in both layouts: `selective_scan`
    (channel-first, K8 / K9) and `selective_scan_cl` (per-row, K1 / K3),
    fp32 and bf16 io forward at every stage and all seven gradients (fp32)
    at stages 0 and 3, against the plain versions (autograd, each chunk
    recomputed). Counters are zeroed before and read after these calls;
    each must launch its kernels once (one call per wrapper) and nothing
    else. Then K8, K9 and K1 / K3 on the per-row scan are timed launched
    alone; K8 and K9 rerun bit for bit and K8's checkpoints hold the plain
    walk's states. Returns
    (summary of K8 / K9, summary of K1 / K3 on the per-row calls, the
    counts); raises on disagreement."""
    import torch

    from sigma_tpu_torch import ops
    from sigma_tpu_torch.ops import scan_cf, scan_g
    from sigma_tpu_torch.ops.selective_scan import (
        selective_scan_chunked,
        selective_scan_cl_plain,
        softplus,
    )

    # the entry points, their plain versions and the kernels they launch
    # (forward, backward): channel-first K8 / K9, per-row K1 / K3
    routes = {"cf": (ops.selective_scan, selective_scan_chunked,
                     ("scan_cf_fwd", "scan_cf_bwd")),
              "row": (ops.selective_scan_cl, selective_scan_cl_plain,
                      ("scan_fwd", "scan_bwd"))}
    summary = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, at="")
               for k in OPS}
    per_row = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, at="")
               for k in ("scan_fwd", "scan_bwd")}
    sums = {"cf": summary, "row": per_row}
    failures = []
    cases = ops_scans()
    want_counts = defaultdict(int)
    _reset_launches()
    for s, (tag, kw) in enumerate(cases):
        x = _ops_inputs(kw, device, SEED + 10 + s)
        for layout, inputs in (("cf", x), ("row", _per_row(x, kw))):
            entry, plain, (kf, kb) = routes[layout]
            entry_name = entry.__name__
            for dtype, tol in ((torch.float32, FP32_TOL),
                               (torch.bfloat16, BF16_TOL)):
                xi = {k: v.to(dtype) if k in ("u", "delta", "B", "C") else v
                      for k, v in inputs.items()}
                before = _launches()
                with torch.inference_mode():
                    got = entry(**xi, delta_softplus=True)
                    torch.cuda.synchronize()
                    ran = {k: n - before[k] for k, n in _launches().items()
                           if n != before[k]}
                    want = plain(**xi, delta_softplus=True)
                want_counts[kf] += 1
                err, ok = _scaled_err(got, want, tol)
                ok = ok and got.dtype == dtype and ran == {kf: 1}
                line = (f"ops: {entry_name} {tag} {kw} {str(dtype)[6:]} "
                        f"max_abs_err={err:.3e} launched {ran} "
                        f"{'ok' if ok else 'FAIL'}")
                if dtype == torch.float32:
                    m = sums[layout][kf]
                    m["max_abs_err"] = max(m["max_abs_err"], err)
                print(line, flush=True)
                if not ok:
                    failures.append(line)
                del got, want, xi
            if s in OPS_GRAD_STAGES:
                dy = torch.randn(inputs["u"].shape, device=device,
                                 generator=torch.Generator(
                                     device=device).manual_seed(SEED + s))
                before = _launches()
                got_y, got = _ops_grads(
                    lambda **a: entry(**a, delta_softplus=True), inputs, dy)
                torch.cuda.synchronize()
                ran = {k: n - before[k] for k, n in _launches().items()
                       if n != before[k]}
                want_counts[kf] += 1
                want_counts[kb] += 1
                want_y, want = _ops_grads(
                    lambda **a: plain(**a, delta_softplus=True,
                                      remat_chunks=True), inputs, dy)
                errs, bad = {}, []
                for k in ["y"] + list(want):
                    errs[k], ok = _scaled_err(got_y if k == "y" else got[k],
                                              want_y if k == "y" else want[k])
                    bad += [] if ok else [k]
                if ran != {kf: 1, kb: 1}:
                    bad.append(f"launched {ran}")
                m = sums[layout][kb]
                m["max_abs_err"] = max(m["max_abs_err"], *(
                    v for k, v in errs.items() if k not in ("y", "D")))
                line = (f"ops: {entry_name} gradients {tag} {kw} fp32 "
                        + " ".join(f"{'d' * (k != 'y')}{k}={v:.2e}"
                                   for k, v in errs.items())
                        + f" {'ok' if not bad else 'FAIL ' + str(bad)}")
                print(line, flush=True)
                if bad:
                    failures.append(line)
                del got_y, got, want_y, want, dy
            torch.cuda.empty_cache()
        del x
    counts = _launches()
    print(f"ops: launches of the entry-point calls {counts}")
    wrong = {k: n for k, n in counts.items() if n != want_counts[k]}
    if wrong:
        failures.append(f"launch counts {wrong}, the calls imply "
                        f"{dict(want_counts)}")

    # each kernel launched alone on one call's inputs (not counted above)
    for s, (tag, kw) in enumerate(cases):
        batch, G, dg, L, N = (kw[k] for k in ("batch", "G", "dg", "L", "N"))
        x = _ops_inputs(kw, device, SEED + 10 + s)
        xr = _per_row(x, kw)
        d_eff = softplus(x["delta"] + x["delta_bias"][None, :, None])
        core = (x["u"], d_eff, x["A"], x["B"], x["C"])
        grouped = {k: xr[k].reshape(batch, G, L, -1)
                   for k in ("u", "delta", "B", "C")}
        streamed = (grouped["u"], grouped["delta"], xr["A"], grouped["B"],
                    grouped["C"], xr["D"], xr["delta_bias"], True)
        dy = torch.randn(x["u"].shape, device=device)
        dyg = torch.randn(grouped["u"].shape, device=device)
        with torch.no_grad():
            y8, hck = scan_cf.launch_scan_cf_fwd(*core, with_hck=True)
            y8b, hck8b = scan_cf.launch_scan_cf_fwd(*core, with_hck=True)
            _, hck1 = scan_g.launch_scan_fwd(*streamed, with_hck=True)
            # K8's checkpoints, every one, against the plain token-by-token
            # walk (the same (rows, n_ck, N, dg) layout)
            walk = scan_g.scan_checkpoints_plain(
                _rows(x["u"], batch, G, dg), _rows(d_eff, batch, G, dg),
                xr["A"], grouped["B"])
            rerun9 = _same_bits(scan_cf.launch_scan_cf_bwd(*core, hck, dy),
                                scan_cf.launch_scan_cf_bwd(*core, hck, dy))
        hck_err, hck_ok = _scaled_err(hck, walk.reshape(hck.shape))
        rerun8 = torch.equal(y8, y8b) and torch.equal(hck, hck8b)
        for ok, what in ((rerun8, "K8 (y, hck) rerun changed bits"),
                         (rerun9, "K9 rerun changed bits"),
                         (hck_ok, f"K8 hck against the plain walk "
                                  f"{hck_err:.3e}")):
            if not ok:
                failures.append(f"ops: {tag} {what}")
        del y8, y8b, hck8b, walk
        with torch.no_grad():
            ms = {
                "scan_cf_fwd": _time_ms(
                    lambda: scan_cf.launch_scan_cf_fwd(*core), reps),
                "scan_cf_bwd": _time_ms(
                    lambda: scan_cf.launch_scan_cf_bwd(*core, hck, dy), reps),
                "scan_fwd": _time_ms(
                    lambda: scan_g.launch_scan_fwd(*streamed), reps),
                "scan_bwd": _time_ms(
                    lambda: scan_g.launch_scan_bwd(
                        *streamed[:7], hck1, dyg, True), reps)}
            plain_ms = {
                "scan_cf_fwd": _time_ms(lambda: selective_scan_chunked(
                    **x, delta_softplus=True), 1),
                "scan_fwd": _time_ms(lambda: selective_scan_cl_plain(
                    **xr, delta_softplus=True), 1)}
        for layout, kb, xi in (("cf", "scan_cf_bwd", x),
                               ("row", "scan_bwd", xr)):
            plain = routes[layout][1]

            def run(backward, plain=plain, xi=xi):
                leaves = {k: v.detach().clone().requires_grad_(True)
                          for k, v in xi.items()}
                y = plain(**leaves, delta_softplus=True, remat_chunks=True)
                if backward:
                    torch.autograd.grad(y.sum(), list(leaves.values()))

            plain_ms[kb] = (_time_ms(lambda: run(True), 1)
                            - _time_ms(lambda: run(False), 1))
        row_kw = dict(ml=False, G=G, B=batch, L=L, dg=dg, N=N)
        bounds = {k: _bound(k, kw) for k in OPS}
        bounds.update({k: _bound(k, row_kw) for k in ("scan_fwd", "scan_bwd")})
        ck_bound = _bound("scan_cf_bwd", kw, cf_ck=scan_g.CK_TOKENS)[0]
        print(f"ops: {tag} {kw} ms (plain, bound) K8 "
              + " ".join(f"{k}={ms[k]:.4f} ({plain_ms[k]:.4f}, "
                         f"{bounds[k][0]:.4f} {bounds[k][1]})"
                         for k in ms)
              + f"; same scan, channel-first K8 / per-row K1: "
                f"{ms['scan_cf_fwd']:.4f} / {ms['scan_fwd']:.4f} ms, K9 / "
                f"K3: {ms['scan_cf_bwd']:.4f} / {ms['scan_bwd']:.4f} ms; K9 "
                f"bound counting the 32-token checkpoints it reads "
                f"{ck_bound:.4f} ms (the function's 256-token carries: "
                f"{bounds['scan_cf_bwd'][0]:.4f}); K8 "
                f"hck against the plain walk max_abs_err={hck_err:.3e} "
                f"{'ok' if hck_ok else 'FAIL'}; K8 (y, hck) rerun bit for bit "
                f"{'ok' if rerun8 else 'FAIL'}; K9 rerun bit for bit "
                f"{'ok' if rerun9 else 'FAIL'}", flush=True)
        for k in ms:
            m = (summary if k in OPS else per_row)[k]
            if ms[k] > m["ms"]:
                m.update(ms=ms[k], plain_ms=plain_ms[k], at=f"{tag} {kw}",
                         kw=kw if k in OPS else row_kw, bound=bounds[k])
        del x, xr, core, streamed, hck, hck1, dy, dyg, grouped, d_eff
        torch.cuda.empty_cache()
    _reset_launches()
    if failures:
        raise AssertionError(f"{len(failures)} ops comparisons failed")
    return summary, per_row, counts


# sha256 of the outputs of the backward body's other sources (K3, K4,
# K11) and of the forwards that write their checkpoints (K1, K2, K10) on
# fixed inputs, recorded with `body_bits` on an NVIDIA H100 80GB HBM3 from
# the tree before K9 joined the body (`csrc/chunk_bwd.cuh`): joining it
# must not move their bits
BODY_BITS = ROOT / "tests" / "fixtures" / "chunk_bwd_bits.json"


def body_bits(device, cases):
    """{"<kernel> <tag>": sha256 of its outputs} for K1 / K3, K2 / K4 and
    K10 / K11 on seeded inputs at each (tag, kw) of `cases` (kw as
    `image_scans` gives it; the image's x drawn on the host, so the inputs
    do not depend on the card): K10 / K11 on the image, K2 / K4 on its two
    layouts (direction 0's weights), K1 / K3 on the two layouts with dt, B,
    C drawn (d_state <= 16 only), all with softplus."""
    import hashlib
    import zlib

    import torch

    from sigma_tpu_torch.ops import scan_g, scan_img

    def digest(*outs):
        h = hashlib.sha256()
        for t in outs:
            if isinstance(t, (list, tuple)):
                h.update(digest(*t).encode())
            else:
                h.update(t.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    bits = {}
    for tag, kw in cases:
        B, H, W, dg, N = (kw[k] for k in ("B", "H", "W", "dg", "N"))
        L = H * W
        seed = SEED + zlib.crc32(tag.encode())  # the case's own inputs
        x = _img_inputs(kw, torch.float32, device, seed)
        gen = torch.Generator().manual_seed(seed + 1)
        rnd = lambda *shape: torch.randn(  # noqa: E731
            shape, generator=gen).to(device)
        with torch.no_grad():
            dy = rnd(B, H, W, dg)
            y, hck = scan_img.launch_scan_img_fwd(**x, delta_softplus=True,
                                                  with_hck=True)
            bits[f"K10 {tag}"] = digest(y, hck)
            bits[f"K11 {tag}"] = digest(scan_img.launch_scan_img_bwd(
                **x, hck=hck, dy=dy, delta_softplus=True))
            del y, hck
            if N > 16:
                continue
            xi = x["x"]
            us = (xi.reshape(B, L, dg),
                  xi.transpose(1, 2).reshape(B, L, dg).contiguous())
            ws = [x[k][0] for k in ("w_dt", "w_b", "w_c", "A", "D",
                                    "delta_bias")]
            dys = (rnd(B, L, dg), rnd(B, L, dg))
            ys, hck = scan_g.launch_scan_proj_fwd(us, *ws,
                                                  delta_softplus=True,
                                                  with_hck=True)
            bits[f"K2 {tag}"] = digest(ys, hck)
            bits[f"K4 {tag}"] = digest(scan_g.launch_scan_proj_bwd(
                us, *ws, hck, dys, delta_softplus=True))
            u = torch.stack(us, 1)
            dt, Bm, Cm = 0.5 * rnd(B, 2, L, dg), rnd(B, 2, L, N), rnd(
                B, 2, L, N)
            streamed = (u, dt, ws[3], Bm, Cm, ws[4], ws[5])
            y, hck = scan_g.launch_scan_fwd(*streamed, delta_softplus=True,
                                            with_hck=True)
            bits[f"K1 {tag}"] = digest(y, hck)
            bits[f"K3 {tag}"] = digest(scan_g.launch_scan_bwd(
                *streamed, hck, torch.stack(dys, 1), delta_softplus=True))
        del x, us, dys, u, dt, Bm, Cm, y, hck
        torch.cuda.empty_cache()
    return bits


def body_bits_check(device):
    """K1-K4, K10 and K11 at the four trunk stages against the recorded
    bits (`BODY_BITS`). Returns the failures."""
    want = json.loads(BODY_BITS.read_text())
    got = body_bits(device, image_scans())
    wrong = sorted(k for k in got if got[k] != want.get(k))
    print(f"bits: K1 / K3, K2 / K4, K10 / K11 at trunk0-3 give the recorded "
          f"bits ({len(got)} outputs): "
          f"{'ok' if not wrong else 'FAIL ' + str(wrong)}", flush=True)
    return [f"bits: recorded bits differ: {wrong}"] if wrong else []


def image_scans(H=480, W=640, batch=2):
    """(tag, kw) of the image-layout scans of sigma_tiny's trunk SS2Ds at
    HxW: batch 2 (RGB and X stacked), the image at each stage, d_inner
    channels, d_state 16."""
    return [(f"trunk{s}", dict(B=batch, H=H // 4 >> s, W=W // 4 >> s,
                               dg=2 * dim, N=16))
            for s, dim in enumerate((96, 192, 384, 768))]


def _img_inputs(kw, dtype, device, seed):
    """x = silu(randn) and the four directions' weights composed as the
    models compose them ([direction, layout]), S4D A, inverse-softplus dt
    bias, D ones."""
    import torch

    from sigma_tpu_torch.models.common import a_log_init, dt_proj_bias_init

    B, H, W, dg, N = (kw[k] for k in ("B", "H", "W", "dg", "N"))
    gen = torch.Generator().manual_seed(seed)
    R = math.ceil(dg / 2 / 16)
    xproj = (torch.rand((4, R + 2 * N, dg), generator=gen) * 2 - 1) / dg ** .5
    dtw = (torch.rand((4, dg, R), generator=gen) * 2 - 1) / R ** .5
    A = -torch.exp(a_log_init(4, dg, N)).reshape(4, dg, N).transpose(1, 2)
    t = dict(
        x=torch.nn.functional.silu(torch.randn((B, H, W, dg), generator=gen)),
        w_dt=torch.einsum("grd,ger->gde", xproj[:, :R], dtw),
        w_b=xproj[:, R:R + N].transpose(1, 2),
        w_c=xproj[:, R + N:].transpose(1, 2), A=A,
        D=torch.ones(4, dg), delta_bias=dt_proj_bias_init((4, dg), gen))
    out = {}
    for k, v in t.items():
        v = v.reshape(2, 2, *v.shape[1:]) if k != "x" else v
        if k in ("x", "w_dt", "w_b", "w_c"):
            v = v.to(dtype)
        out[k] = v.to(device).contiguous()
    return out


def _two_call_route(x, w_dt, w_b, w_c, A, D, delta_bias):
    """The same function through the route the port's SS2D takes today
    (models/ss2d.py: the wh transpose copy, one selective_scan_g_proj_ml
    call per direction group, the un-transpose in the merge): K2 at stages
    0-2, torch.matmul projections and K1 at stage 3."""
    from sigma_tpu_torch.ops import scan_g

    b, H, W, dg = x.shape
    us = (x.reshape(b, H * W, dg), x.transpose(1, 2).reshape(b, H * W, dg))
    ys = None
    for d in range(2):
        ys = scan_g.selective_scan_g_proj_ml(
            us, w_dt[d], w_b[d], w_c[d], A[d], D=D[d],
            delta_bias=delta_bias[d], delta_softplus=True, reverse=d == 1,
            y_accum=ys)
    return ys[0].reshape(b, H, W, dg) + ys[1].reshape(b, W, H, dg) \
        .transpose(1, 2)


IMG_GRAD_STAGES = (0, 3)
WIDE_STATES = (17, 40)


def _wide_state_checks(device):
    """The grouped (`selective_scan_g`, reversed) and per-row
    (`selective_scan_cl`) entry points at d_state 17 and 40, trunk stage
    3's per-row scan shape (batch 2, G 4, L 300, dg 1536): y and every
    gradient against the plain versions, one K1 and one K3 per slice of at
    most 16 states. Returns the failed lines."""
    import torch

    from sigma_tpu_torch import ops
    from sigma_tpu_torch.ops import scan_g
    from sigma_tpu_torch.ops.selective_scan import selective_scan_cl_plain

    failures = []
    for N in WIDE_STATES:
        kw = dict(batch=2, G=4, dg=1536, N=N, L=300)
        rows = _per_row(_ops_inputs(kw, device, SEED + 20 + N), kw)
        grouped = {k: v.reshape(kw["batch"], kw["G"], kw["L"], -1)
                   if k in ("u", "delta", "B", "C") else v
                   for k, v in rows.items()}
        dy = torch.randn(rows["u"].shape, device=device,
                         generator=torch.Generator(device=device)
                         .manual_seed(SEED + N))
        slices = -(-N // 16)
        for name, entry, plain, inputs, opts in (
                ("selective_scan_g", scan_g.selective_scan_g,
                 scan_g.selective_scan_g_plain, grouped,
                 dict(delta_softplus=True, reverse=True)),
                ("selective_scan_cl", ops.selective_scan_cl,
                 selective_scan_cl_plain, rows, dict(delta_softplus=True))):
            _reset_launches()
            got_y, got = _ops_grads(lambda **a: entry(**a, **opts), inputs,
                                    dy.reshape(inputs["u"].shape))
            torch.cuda.synchronize()
            ran = {k: n for k, n in _launches().items() if n}
            want_y, want = _ops_grads(
                lambda **a: plain(**a, **opts, remat_chunks=True), inputs,
                dy.reshape(inputs["u"].shape))
            errs, bad = {}, []
            for k in ["y"] + list(want):
                errs[k], ok = _scaled_err(got_y if k == "y" else got[k],
                                          want_y if k == "y" else want[k])
                bad += [] if ok else [k]
            if ran != dict(scan_fwd=slices, scan_bwd=slices):
                bad.append(f"launched {ran}")
            line = (f"image: wide state {name} N={N} {kw} fp32 "
                    + " ".join(f"{'d' * (k != 'y')}{k}={v:.2e}"
                               for k, v in errs.items())
                    + f" launched {ran} "
                    + ("ok" if not bad else "FAIL " + str(bad)))
            print(line, flush=True)
            if bad:
                failures.append(line)
            del got_y, got, want_y, want
        del rows, grouped, dy
        torch.cuda.empty_cache()
    _reset_launches()
    return failures


def image_phase(device, reps=3):
    """`selective_scan_ss2d_proj` at every trunk SS2D of sigma_tiny at
    480x640, batch 2: fp32 and bf16 forward at every stage and all seven
    gradients (fp32) at stages 0 and 3 against the plain version, with the
    launches checked (counters zeroed before these calls and read after);
    the d_state 17 / 40 entry points; then K10 and K11 (each run twice: the
    same bits; K10's checkpoints against the plain walk) and K5 alone, the
    plain version and the two-call route the port's SS2D takes today,
    timed. Returns (per-kernel summaries, the counts); raises on
    disagreement."""
    import torch

    from sigma_tpu_torch.ops import scan_g, scan_img

    t_phase = time.perf_counter()
    summary = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, at="")
               for k in IMAGE}
    names = ("x", "w_dt", "w_b", "w_c", "A", "D", "delta_bias")
    failures = []
    want_counts = defaultdict(int)
    cases = image_scans()
    _reset_launches()
    for s, (tag, kw) in enumerate(cases):
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            x = _img_inputs(kw, dtype, device, SEED + 30 + s)
            before = _launches()
            with torch.inference_mode():
                got = scan_g.selective_scan_ss2d_proj(**x,
                                                      delta_softplus=True)
                torch.cuda.synchronize()
                ran = {k: n - before[k] for k, n in _launches().items()
                       if n != before[k]}
                want = scan_img.selective_scan_ss2d_proj_plain(
                    **x, delta_softplus=True)
            want_counts["scan_img_fwd"] += 1
            err, ok = _scaled_err(got, want, tol)
            ok = ok and got.dtype == dtype and got.shape == x["x"].shape \
                and ran == {"scan_img_fwd": 1}
            line = (f"image: selective_scan_ss2d_proj {tag} {kw} "
                    f"{str(dtype)[6:]} max_abs_err={err:.3e} launched {ran} "
                    f"{'ok' if ok else 'FAIL'}")
            if dtype == torch.float32:
                m = summary["scan_img_fwd"]
                m["max_abs_err"] = max(m["max_abs_err"], err)
            print(line, flush=True)
            if not ok:
                failures.append(line)
            del x, got, want
        if s in IMG_GRAD_STAGES:
            x = _img_inputs(kw, torch.float32, device, SEED + 30 + s)
            dy = torch.randn(x["x"].shape, device=device,
                             generator=torch.Generator(
                                 device=device).manual_seed(SEED + 40 + s))
            before = _launches()
            got_y, got = _ops_grads(lambda **a: scan_g.selective_scan_ss2d_proj(
                **a, delta_softplus=True), x, dy)
            torch.cuda.synchronize()
            ran = {k: n - before[k] for k, n in _launches().items()
                   if n != before[k]}
            want_counts["scan_img_fwd"] += 1
            want_counts["scan_img_bwd"] += 1
            want_counts["proj_grad"] += 2
            want_y, want = _ops_grads(
                lambda **a: scan_img.selective_scan_ss2d_proj_plain(
                    **a, delta_softplus=True, remat_chunks=True), x, dy)
            errs, bad = {}, []
            for k in ("y",) + names:
                errs[k], ok = _scaled_err(got_y if k == "y" else got[k],
                                          want_y if k == "y" else want[k])
                bad += [] if ok else [k]
            if ran != dict(scan_img_fwd=1, scan_img_bwd=1, proj_grad=2):
                bad.append(f"launched {ran}")
            m = summary["scan_img_bwd"]
            m["max_abs_err"] = max(m["max_abs_err"], *(
                v for k, v in errs.items() if k != "y"))
            line = (f"image: selective_scan_ss2d_proj gradients {tag} {kw} "
                    "fp32 " + " ".join(f"{'d' * (k != 'y')}{k}={v:.2e}"
                                       for k, v in errs.items())
                    + f" launched {ran} "
                    + ("ok" if not bad else "FAIL " + str(bad)))
            print(line, flush=True)
            if bad:
                failures.append(line)
            del x, dy, got_y, got, want_y, want
            torch.cuda.empty_cache()
    counts = _launches()
    print(f"image: launches of the entry-point calls "
          f"{ {k: n for k, n in counts.items() if n} }")
    wrong = {k: n for k, n in counts.items() if n != want_counts[k]}
    if wrong:
        failures.append(f"launch counts {wrong}, the calls imply "
                        f"{dict(want_counts)}")
    failures += _wide_state_checks(device)

    # each kernel alone on one call's inputs, beside the plain version and
    # the two-call route (not counted above)
    for s, (tag, kw) in enumerate(cases):
        x = _img_inputs(kw, torch.float32, device, SEED + 30 + s)
        args = [x[k] for k in names]
        dy = torch.randn(x["x"].shape, device=device)
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in x.items()}

        def fwd_bwd(fn, backward=True):
            y = fn(**leaves)
            if backward:
                torch.autograd.grad(y, list(leaves.values()), dy)

        with torch.no_grad():
            y1, hck = scan_img.launch_scan_img_fwd(
                *args, delta_softplus=True, with_hck=True)
            y2, hck2 = scan_img.launch_scan_img_fwd(
                *args, delta_softplus=True, with_hck=True)
            first = scan_img.launch_scan_img_bwd(*args, hck, dy, True)
            again = scan_img.launch_scan_img_bwd(*args, hck, dy, True)
            du4, dd, dB, dC = first[:4]
            want_hck = scan_img.scan_checkpoints_img_plain(
                x["x"], x["w_dt"], x["w_b"], x["A"], x["delta_bias"], True)
        # reruns of K10 and K11 give the same bits (no atomics); K10's
        # checkpoints hold the plain walk's states
        rerun10 = torch.equal(y1, y2) and torch.equal(hck, hck2)
        rerun = all(torch.equal(a, b) for a, b in zip(first, again))
        hck_err, hck_ok = _scaled_err(hck, want_hck)
        for ok, what in ((rerun10, "K10 rerun changed bits"),
                         (rerun, "K11 rerun changed bits"),
                         (hck_ok, f"K10 hck against the plain walk "
                                  f"{hck_err:.3e}")):
            if not ok:
                failures.append(f"image: {tag} {what}")
        del again, y1, y2, hck2, want_hck
        with torch.no_grad():
            ms = {
                "scan_img_fwd": _time_ms(lambda: scan_img.launch_scan_img_fwd(
                    *args, delta_softplus=True), reps),
                "scan_img_bwd": _time_ms(lambda: scan_img.launch_scan_img_bwd(
                    *args, hck, dy, True), reps),
                "proj_grad_x2": _time_ms(lambda: scan_img._chain_grads(
                    x["x"], du4, dd, dB, dC, x["w_dt"], x["w_b"], x["w_c"]),
                    reps),
                "two_call_fwd": _time_ms(lambda: _two_call_route(**x), reps),
                "plain_fwd": _time_ms(
                    lambda: scan_img.selective_scan_ss2d_proj_plain(
                        **x, delta_softplus=True), 1)}
            route_y = _two_call_route(**x)
            img_y = scan_g.selective_scan_ss2d_proj(**x, delta_softplus=True)
        err, ok = _scaled_err(img_y, route_y)
        if not ok:
            failures.append(f"image: {tag} two-call route disagrees "
                            f"{err:.3e}")
        ms["image_fwd_bwd"] = _time_ms(lambda: fwd_bwd(
            lambda **a: scan_g.selective_scan_ss2d_proj(
                **a, delta_softplus=True)), reps)
        ms["two_call_fwd_bwd"] = _time_ms(lambda: fwd_bwd(_two_call_route),
                                          reps)
        if s in IMG_GRAD_STAGES:
            def plain(**a):
                return scan_img.selective_scan_ss2d_proj_plain(
                    **a, delta_softplus=True, remat_chunks=True)

            ms["plain_bwd"] = (
                _time_ms(lambda: fwd_bwd(plain), 1, warm=False)
                - _time_ms(lambda: fwd_bwd(plain, False), 1, warm=False))
        bounds = {k: _bound(k, kw) for k in IMAGE}
        print(f"image: {tag} forward + backward ms: image route (K10 + K11 "
              f"+ 2 K5) {ms['image_fwd_bwd']:.4f}, two-call route "
              f"{ms['two_call_fwd_bwd']:.4f}; forward: K10 "
              f"{ms['scan_img_fwd']:.4f}, two-call route "
              f"{ms['two_call_fwd']:.4f}", flush=True)
        print(f"image: {tag} {kw} ms "
              + " ".join(f"{k}={v:.4f}" for k, v in ms.items())
              + " bound " + " ".join(f"{k}={b[0]:.4f} ({b[1]})"
                                     for k, b in bounds.items())
              + f"; two-call route agrees max_abs_err={err:.3e}; K10 hck "
                f"against the plain walk max_abs_err={hck_err:.3e} "
                f"{'ok' if hck_ok else 'FAIL'}; K10 (y, hck) rerun bit for "
                f"bit {'ok' if rerun10 else 'FAIL'}; K11 rerun bit for bit "
                f"{'ok' if rerun else 'FAIL'}", flush=True)
        for k, plain_key in (("scan_img_fwd", "plain_fwd"),
                             ("scan_img_bwd", "plain_bwd")):
            m = summary[k]
            if plain_key in ms and ms[k] > m["ms"]:
                m.update(ms=ms[k], plain_ms=ms[plain_key],
                         at=f"{tag} {kw}", kw=kw)
        del x, args, dy, leaves, hck, first, du4, dd, dB, dC, route_y, img_y
        torch.cuda.empty_cache()
    _reset_launches()
    print(f"image: phase {time.perf_counter() - t_phase:.1f}s")
    if failures:
        raise AssertionError(f"{len(failures)} image comparisons failed")
    return summary, counts


def _reset_launches():
    from sigma_tpu_torch.ops import merge_ln_gate, scan_cf, scan_g, scan_img

    scan_g.reset_launches()
    merge_ln_gate.reset_launches()
    scan_cf.reset_launches()
    scan_img.reset_launches()


def _launches():
    from sigma_tpu_torch.ops import merge_ln_gate, scan_cf, scan_g, scan_img

    return {**scan_g.LAUNCHES, **merge_ln_gate.LAUNCHES, **scan_cf.LAUNCHES,
            **scan_img.LAUNCHES}


def epilogue_plan(model, h, w):
    """(K6, K7) launches of one train step of `model` at h x w, as its
    remat plan implies: each SS2D's forward launches K6, once more when its
    block is rematerialized (the recompute in the backward pass), and its
    backward launches K7 once. One SS2D per VSSBlock / CVSSDecoderBlock."""
    from sigma_tpu_torch.models.common import should_remat

    hh, ww = -(-h // 4), -(-w // 4)
    vssm, dec = model.backbone.vssm, model.decode_head
    groups = [(stage.blocks, vssm.remat, s)
              for s, stage in enumerate(vssm.layers)]
    n = len(dec.layers_up)
    groups += [(up.blocks, up.remat, n - 1 - i)
               for i, up in enumerate(dec.layers_up) if i > 0]
    k6 = k7 = 0
    for blocks, remat, level in groups:
        tokens = -(-hh // 2 ** level) * -(-ww // 2 ** level)
        k6 += len(blocks) * (1 + int(should_remat(remat, tokens)))
        k7 += len(blocks)
    return k6, k7


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


def model_phase(device, order=(False, True, True, False)):
    """The port's serving path: build_model + SlidingEvaluator.run under
    the MFNet preset, once per entry of `order` (the fused SS2D epilogue
    off or on; one model, so the same weights). Returns {switch: [img/s of
    each run]}; raises if a kernel was not launched as the path implies,
    an output is wrong, the switch changes the logits, or the GPU logits
    disagree with the CPU plain path."""
    import copy

    import numpy as np
    import torch

    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.engine.evaluator import SlidingEvaluator
    from sigma_tpu_torch.models.builder import build_model
    from sigma_tpu_torch.models.ss2d import SS2D, set_fused_epilogue

    cfg = get_config("mfnet")
    t0 = time.perf_counter()
    model = build_model(cfg, device=device, seed=SEED)
    n_ss2d = sum(isinstance(m, SS2D) for m in model.modules())
    print(f"model: {cfg.backbone}/{cfg.decoder} {cfg.num_classes} classes "
          f"{sum(p.numel() for p in model.parameters())} params, {n_ss2d} "
          f"SS2Ds, built in {time.perf_counter() - t0:.2f}s")
    forwards = [0]
    model.register_forward_pre_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    data = _SyntheticMFNet(4, cfg.image_height, cfg.image_width, SEED)
    ev = SlidingEvaluator(
        model, cfg.num_classes, cfg.norm_mean, cfg.norm_std,
        multi_scales=cfg.eval_scale_array, is_flip=cfg.eval_flip,
        eval_crop_size=cfg.eval_crop_size, stride_rate=cfg.eval_stride_rate,
        device=device,
    )
    img_s = {False: [], True: []}
    for fused in order:
        set_fused_epilogue(model, fused)
        t0 = time.perf_counter()
        pred = ev.sliding_eval(data[0]["data"], data[0]["modal_x"])
        print(f"model: fused_epilogue={int(fused)} warm-up image "
              f"{time.perf_counter() - t0:.3f}s")
        if pred.shape != (cfg.image_height, cfg.image_width) or not (
                (pred >= 0) & (pred < cfg.num_classes)).all():
            raise AssertionError(f"bad prediction {pred.shape} {pred.dtype}")

        torch.cuda.reset_peak_memory_stats(device)
        _reset_launches()
        forwards[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        miou, detail = ev.run(data)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launches()
        img_s[fused].append(len(data) / seconds)
        print(f"model: fused_epilogue={int(fused)} MFNet "
              f"{cfg.image_height}x{cfg.image_width} eval of {len(data)} "
              f"images in {seconds:.3f}s = {len(data) / seconds:.4f} img/s, "
              f"mIoU {miou:.4f} (random weights), peak "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB, "
              f"{forwards[0]} forwards, launches {launches}")
        if not np.isfinite(miou) or not np.isfinite(detail["pixel_acc"]):
            raise AssertionError(f"non-finite metrics {miou} {detail}")
        missing = [k for k in FORWARD if launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the main path: "
                                 f"{missing}")
        backward = [k for k in SCAN_BACKWARD + EPILOGUE[1:] if launches[k]]
        if backward:
            raise AssertionError(f"backward kernels launched by eval: "
                                 f"{backward}")
        want_k6 = n_ss2d * forwards[0] if fused else 0
        if launches["merge_ln_gate_fwd"] != want_k6:
            raise AssertionError(f"K6 launched {launches['merge_ln_gate_fwd']}"
                                 f" times, the path implies {want_k6}")
    print(f"model: eval img/s unfused {img_s[False]} fused {img_s[True]}")

    # the switch at 480x640: the same weights and input, fused against not
    rng = np.random.default_rng(SEED + 7)
    rgb, mx = (torch.from_numpy(rng.standard_normal(
        (1, cfg.image_height, cfg.image_width, 3)).astype(np.float32))
        .to(device) for _ in range(2))
    logits = {}
    with torch.inference_mode():
        for fused in (False, True):
            set_fused_epilogue(model, fused)
            logits[fused] = model(rgb, mx)
    agree = (logits[True].argmax(-1) == logits[False].argmax(-1)).float() \
        .mean().item()
    err = (logits[True] - logits[False]).abs().max().item()
    print(f"model: {cfg.image_height}x{cfg.image_width} logits fused vs "
          f"unfused epilogue max_abs_err={err:.3e} argmax agreement "
          f"{agree:.5f} (need >= {ARGMAX_AGREEMENT})")
    if not torch.isfinite(logits[True]).all() or agree < ARGMAX_AGREEMENT:
        raise AssertionError("the fused epilogue changes the logits")
    del logits, rgb, mx

    # the same model at 96x128: GPU (kernels) against CPU (plain path)
    rng = np.random.default_rng(SEED + 1)
    rgb, mx = (torch.from_numpy(rng.standard_normal((1, 96, 128, 3))
                                .astype(np.float32)) for _ in range(2))
    cpu_model = copy.deepcopy(model).cpu()
    for fused in (False, True):
        set_fused_epilogue(model, fused)
        set_fused_epilogue(cpu_model, fused)
        with torch.inference_mode():
            got = model(rgb.to(device), mx.to(device)).cpu()
            want = cpu_model(rgb, mx)
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        err = (got - want).abs().max().item()
        print(f"model: fused_epilogue={int(fused)} 96x128 GPU vs CPU logits "
              f"max_abs_err={err:.3e} argmax agreement {agree:.5f} (need >= "
              f"{ARGMAX_AGREEMENT})")
        if not torch.isfinite(got).all() or agree < ARGMAX_AGREEMENT:
            raise AssertionError("GPU logits disagree with the CPU plain "
                                 "path")
    return img_s


def _train_run(cfg, device, batches, fused):
    """The train CLI's step (a fresh seeded model) over `batches`, with the
    fused SS2D epilogue `fused`. Returns (launch counts, timing dict);
    raises if a loss is not finite, no weight moved, or the kernels
    launched differ from what the path and its remat plan imply."""
    import numpy as np
    import torch

    from sigma_tpu_torch.engine.train import build_train
    from sigma_tpu_torch.models.ss2d import set_fused_epilogue
    from sigma_tpu_torch.trace_step import TRAIN_BATCH as batch

    h, w = cfg.image_height, cfg.image_width
    state, step, schedule = build_train(cfg, device)
    model = set_fused_epilogue(state.model, fused)
    k6, k7 = epilogue_plan(model, h, w)
    steps = len(batches)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats(device)
    _reset_launches()
    seconds, losses = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(state, b)))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = _launches()
    moved = sum(int((p.detach() != before[k]).sum())
                for k, p in model.named_parameters())
    total = sum(p.numel() for p in model.parameters())
    s_step = sum(seconds[1:]) / len(seconds[1:])
    tag = f"train: fused_epilogue={int(fused)}"
    print(f"{tag} sigma_tiny MFNet {h}x{w} batch {batch}, {steps} steps: "
          f"losses {losses}, seconds {[round(t, 4) for t in seconds]}, "
          f"lr {[schedule(k) for k in range(steps)]}")
    print(f"{tag} last {steps - 1} steps {s_step:.4f} s/step = "
          f"{batch / s_step:.4f} img/s, peak "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB, "
          f"{moved} of {total} weights moved, launches {launches}")
    del state, step, model, before
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train loss {losses}")
    if moved == 0:
        raise AssertionError("the train steps moved no weight")
    missing = [k for k in FORWARD + SCAN_BACKWARD if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the train step: "
                             f"{missing}")
    want = ((steps * k6, steps * k7) if fused else (0, 0))
    got = tuple(launches[k] for k in EPILOGUE)
    if got != want:
        raise AssertionError(f"K6/K7 launched {got} times, the remat plan "
                             f"implies {want}")
    return launches, dict(s_step=s_step, img_s=batch / s_step)


def train_phase(device, steps=3, order=(False, True, True, False)):
    """The port's train step at the MFNet preset (sigma_tiny, 480x640),
    built as the train CLI and trace_step build it, 3 steps once per entry
    of `order` (the fused SS2D epilogue off or on), then a sigma_test step
    on the card against the CPU, both ways. Returns (launch counts of the
    last run with the switch on, {switch: [timing dicts]}); raises on a
    failed check."""
    import copy

    import numpy as np
    import torch

    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.engine.optim import build_optimizer
    from sigma_tpu_torch.engine.train import (
        create_train_state,
        make_train_step,
    )
    from sigma_tpu_torch.models.builder import EncoderDecoder, init_parameters
    from sigma_tpu_torch.models.common import DropPath
    from sigma_tpu_torch.models.ss2d import set_fused_epilogue
    from sigma_tpu_torch.trace_step import TRAIN_BATCH as batch
    from sigma_tpu_torch.trace_step import synthetic_batch
    from sigma_tpu_torch.utils.lr_schedule import poly_lr

    cfg = get_config("mfnet")
    rng = np.random.default_rng(SEED + 3)
    batches = [synthetic_batch(rng, batch, cfg.image_height,
                               cfg.image_width) for _ in range(steps)]
    timing, main_launches = {False: [], True: []}, None
    for fused in order:
        launches, t = _train_run(cfg, device, batches, fused)
        timing[fused].append(t)
        if fused:
            main_launches = launches
    print("train: s/step unfused "
          f"{[round(t['s_step'], 4) for t in timing[False]]} fused "
          f"{[round(t['s_step'], 4) for t in timing[True]]}")

    # one sigma_test step on the card and on the CPU, same weights/batch
    cfg_t = get_config("mfnet", optimizer="SGDM")
    small = synthetic_batch(np.random.default_rng(SEED + 5), 2, 64, 80)
    for fused in (False, True):
        cpu = init_parameters(EncoderDecoder(9, "sigma_test"), seed=SEED + 4)
        set_fused_epilogue(cpu, fused)
        for m in cpu.modules():  # the CPU and CUDA generators draw differently
            if isinstance(m, DropPath):
                m.rate = 0.0
        gpu = copy.deepcopy(cpu).to(device)
        out = {}
        for name, m in (("cpu", cpu), ("gpu", gpu)):
            o = build_optimizer(cfg_t, m)
            st = create_train_state(m, o)
            loss = make_train_step(m, o, poly_lr(1e-2, 0.9, 100))(st, small)
            out[name] = float(loss)
        err = max((b.cpu() - a).abs().max().item() for a, b in
                  zip(cpu.state_dict().values(), gpu.state_dict().values()))
        rel = abs(out["gpu"] - out["cpu"]) / abs(out["cpu"])
        print(f"train: fused_epilogue={int(fused)} sigma_test 64x80 one SGDM "
              f"step card vs CPU: loss {out['gpu']:.6f} vs {out['cpu']:.6f} "
              f"(rel {rel:.2e}, need <= {TRAIN_LOSS_RTOL}), post-step "
              f"weights max |diff| {err:.3e} (need <= {TRAIN_PARAM_ATOL})")
        if rel > TRAIN_LOSS_RTOL or err > TRAIN_PARAM_ATOL:
            raise AssertionError("the card's train step disagrees with the "
                                 "CPU")
    return main_launches, timing


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
    summary.update(epilogue_phase(device))
    ops_summary, per_row, ops_launches = ops_phase(device)
    summary.update(ops_summary)
    img_summary, img_launches = image_phase(device)
    summary.update(img_summary)
    eval_img_s = model_phase(device)
    launches, train_timing = train_phase(device)
    # last, so that its large calls precede no timed phase
    if body_bits_check(device):
        raise AssertionError("K1-K4, K10 or K11 moved from their recorded "
                             "bits")
    kernels = []
    for name in KERNELS:
        s = summary[name]
        bound_ms, bound_by = _bound(name, s["kw"])
        ops_path = name in OPS
        counts = (ops_launches if ops_path else
                  img_launches if name in IMAGE else launches)
        kernels.append(dict(
            name=name, **KERNELS[name], launches=counts[name],
            max_abs_err=s["max_abs_err"], ms=s["ms"],
            plain_ms=s["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=s.get("library_ms")))
        print(f"summary: {name} ms/plain_ms/bound_ms at its slowest "
              f"main-path call, {s['at']}; max_abs_err over all fp32 "
              f"calls (a backward kernel: over the gradients it "
              f"finishes); launches in "
              + ("the ops phase's entry-point calls" if ops_path else
                 "the image phase's entry-point calls" if name in IMAGE
                 else "the train phase's last run with the fused epilogue"))
    for name, s in per_row.items():
        print(f"summary: {name} on the per-row scan of selective_scan_cl "
              f"(TPU rows 8-9) at its slowest ops-phase call, {s['at']}: "
              f"{s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, bound "
              f"{s['bound'][0]:.4f} ms ({s['bound'][1]}), max_abs_err "
              f"{s['max_abs_err']:.3e}, launches {ops_launches[name]} in "
              f"the ops phase's entry-point calls")
    for name in EPILOGUE:
        s = summary[name]
        print(f"summary: {name} {s['ms']:.4f} device ms against the "
              f"unfused chain of PyTorch calls it replaces "
              f"{s['unfused_ms']:.4f} ms "
              f"({'backward, autograd' if name.endswith('bwd') else 'forward'}"
              f") at {s['at']} (K6 / K7: ms, plain_ms and the unfused "
              f"chain are device time, torch.profiler)")
    for fused in (False, True):
        img = eval_img_s[fused]
        s_step = [t["s_step"] for t in train_timing[fused]]
        print(f"summary: fused_epilogue={int(fused)} eval img/s "
              f"{[round(x, 4) for x in img]} mean {sum(img) / len(img):.4f}; "
              f"train s/step {[round(x, 4) for x in s_step]} mean "
              f"{sum(s_step) / len(s_step):.4f}")
    print("summary: library_ms of proj_grad (K5): its two cuBLAS products, "
          "torch.matmul on the concatenated operands, at the same call; "
          "null for the others: no single PyTorch call computes a "
          "selective scan or its gradient (K1-K4, K8-K11), nor K6's merge "
          "+ LayerNorm + gate or its gradient (K7)")
    print(f"summary: command time {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
