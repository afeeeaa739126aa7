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
                batch 1, run K1 (streamed, chunk-parallel) / K2 (fused
                projection on wgmma, one pass with grouped carries)
                against their plain PyTorch versions on the
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
                K3 / K4, K5's dW and du). The same at every shape with
                bf16 io (u, y_accum and the weights bf16, as the bf16
                train step runs them): every gradient against autograd of
                the plain version in fp32 on the same values, 5e-2 of
                max(|ref|, 1), the kernels launched on bf16 operands
                (`scan_g.LAUNCHES_BF16`), K3 or K4 and K5 alone timed
                beside their fp32 runs, their bounds at 2-byte io, and
                rerun bit for bit (K5 also beside cuBLAS's bf16
                products). Then bf16 with a gradient
                (ROADMAP B1) at stage 1: the four scan entry points return
                bf16 y and gradients within 5e-2 of autograd of the plain
                versions. Then the split (`scan_split`): the device time
                of every launch of K2 and K4 at ConMB, SS2D and CroMB of
                stage 0 and SS2D of stages 1-2, fp32 and bf16, one line
                each.
  4. epilogue — at every SS2D epilogue shape of sigma_tiny at 480x640 (eval
                batch 1 and train batch 2), fp32 and bf16: K6 against the
                plain forward, K7 against the plain backward formula; fp32
                also through the entry point's autograd (one K6 and one K7
                launch) against autograd of the plain forward, all five
                gradients, and a K7 rerun that must give the same dgamma /
                dbeta bits. z is a column slice, as SS2D splits it. Prints
                errors and the ms of K6 / K7 (fp32 and bf16), of their
                plain versions and of the unfused chain of PyTorch calls
                the switch replaces.
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
                (`scan_g.scan_checkpoints_plain`). Last, the peak memory
                of one `selective_scan` forward + backward at trunk0 beside
                the 32-token checkpoints and 256-token carries (ROADMAP C9).
  6. image    — the image-layout SS2D scan `selective_scan_ss2d_proj` (K10
                forward, K11 + K5 backward) at sigma_tiny's four trunk SS2D
                shapes at 480x640, batch 2 (RGB and X stacked), d_state
                16, S4D A and dt-bias inits: fp32 and bf16 forward at every
                stage and all seven gradients at stages 0 and 3, fp32 and
                bf16 io (bf16 at 5e-2: K10, K11 and both K5 on bf16
                operands), against the plain version (the stacked
                composition, autograd, each chunk recomputed), one K10 per
                forward and K11 + two K5 per backward and nothing else;
                K10 (y, hck) and K11 rerun bit
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
                one line per stage; K10 and K11 with bf16 io beside fp32,
                with their bounds at 2-byte io.
  7. model    — sigma_tiny / MambaDecoder / 9 classes, seeded weights, four
                seeded 480x640 RGB-X pairs through the port's
                SlidingEvaluator.run under the MFNet preset, with the fused
                SS2D epilogue off, on, on, off (one model): img/s and mIoU
                of each run; K1 and K2 must have been launched, K6 once
                per SS2D forward with the switch on and never with it off,
                no backward kernel. Logits of one 480x640 pair with the
                switch on against off. Then the same model at 96x128, both
                ways: GPU logits against the CPU plain path. Then the same
                serving path in bf16 compute (cfg.bf16, the same weights
                and images), the epilogue off then on: img/s and peak
                memory beside the fp32 runs', every forward scan kernel on
                bf16 operands.
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
                parameters against each other. Then the 480x640 step in
                bf16 compute (cfg.bf16), the switch off then on: s/step
                and peak memory beside fp32, every forward and backward
                scan kernel (K2 + K4 + K5, K1 + K3 at stage 3) on bf16
                operands, the parameters fp32. Then the bf16 cross-check:
                sigma_test logits at 96x128 and one SGDM step at 64x80 in
                bf16 on the card against bf16 on the CPU, the gap at most
                twice the CPU's own bf16-vs-fp32 gap, both ways.
  9. decoders — the decoders besides the flagship's and MambaDecoder's
                deep supervision (UPernet + the FCN aux head, MLPDecoder,
                deeplabv3+ + the FCN aux head, FCN; global-batch
                BatchNorm) at sigma_tiny 480x640 fp32, built by
                build_train: the first step rerun bit for bit, 3 steps at
                batch 2 (finite losses, K1-K5 launched, s/step, peak
                memory), a 4-image evaluation in eval mode (img/s, peak
                memory); then each at sigma_test 64x80 batch 6, one step
                on the card against the CPU (loss, gradients, running
                statistics at the fp32 tier).
 10. backbones — the MiT and Swin dual encoders (FRM / FFM fusion) and
                the VSSM classifier, fp32: swin_s + MambaDecoder and
                mit_b2 + MLPDecoder at 480x640 built by build_train (the
                first step rerun bit for bit, 3 steps at batch 2: s/step
                and peak memory; a 4-image evaluation: img/s and peak
                memory; K2 + K4 + K5 in Swin's training and K2 alone in
                its eval, no scan kernel in MiT's); VSSMClassifier at
                VMamba-T widths, 224x224 batch 8, a forward + backward
                (ms, peak memory, K1-K5 launched) rerun bit for bit; then
                each at the CPU tests' widths, one step card vs CPU at
                the fp32 tier.
 11. surface  — the port's surface besides the models: every loss of
                `utils/losses.py` on seeded (2, 480, 640, 9) logits, the
                card against the CPU (value and gradient, fp32 tier, ms);
                the analytic FLOP count (`utils/flops.py`) of sigma_tiny
                at 480x640, batch 1 and 8, beside the JAX package's
                TPU-route count, and the card's count equal to the CPU's
                at 64x96, batch 1 and 2; TrainPre at 480x640 with
                device_norm off, the native tail against the numpy path
                (1e-5, labels exact), host ms with 1 and 8 threads.
 12. determinism — ROADMAP C10: one sigma_tiny 480x640 batch-2 fp32 train
                step rerun from the same state in a child process
                (CUBLAS_WORKSPACE_CONFIG set) under PyTorch's default,
                cudnn.deterministic, and use_deterministic_algorithms:
                the gradients whose bits moved by kind of layer, what
                raised or warned, s/step of each. The script, as the
                train CLI, runs with cudnn.deterministic.
 13. files    — the port on dataset files with no cv2 (`sys.modules["cv2"]
                = None`): first the JPEG decoder (`jpeg_part`: every
                committed fixture, colour and gray, against the digests of
                cv2.imread's arrays; host ms of a 480x640 decode, 8
                threads against one); a seeded MFNet tree (8 480x640
                pairs) and an NYU-geometry tree (4 pairs, 40 classes; RGB
                the 480x640 JPEG fixtures, the rest PNG) written by
                `data/png.py`, every PNG decoded back to its array (host
                ms per image), cv2's own 480x640 PNG (adaptive filters,
                `tests/fixtures`) decoded to cv2's array; `resize_u8` on
                the card equal to the CPU bit for bit at every train scale
                (training form) and 0.75 / 1.25 (eval form), bilinear and
                nearest (device ms); `sigma_tpu_torch.eval.main` on both
                trees at sigma_tiny (NYU: scales 0.75, 1, 1.25, flip, its
                RGB read from JPEG), `-p` PNGs read back, img/s
                and mIoU, K1 / K2 launched and no backward kernel;
                `image_batch` 2 against 1 (the same predictions); the NYU
                protocol at sigma_test, card against CPU (argmax
                agreement); `sigma_tpu_torch.train.main --steps 3` on the
                MFNet tree (finite losses, weights moved, K1-K5 launched,
                s/step); the train CLI's `--profile` (`profile_part`, 31
                steps: the trace of steps 20-29 names K2, K4 and K5, its
                size, s/step traced and not). Then checkpoints (`ckpt_part`, 2 iterations an
                epoch, a checkpoint and an evaluation every epoch): a
                train step run twice (the same bits); run A, 2
                epochs with async saves; run B, `--steps 2` then `-c`,
                equal to A bit for bit (cuDNN deterministic, ROADMAP
                C10); the epochs on disk after each
                run against the best-k policy; `eval.main -e last` / `-e
                1-` on A's checkpoints giving the train-time mIoU;
                `--pretrained` with a released-scheme sigma_tiny VMamba
                trunk (every mapped tensor in the model, a finite loss);
                the saves' blocking and background seconds, MiB, the
                restore's seconds and each run's s/step. Last, data
                parallel (`ddp_part`, sigma_tiny 480x640 fp32, global
                batch 2): the train CLI under torchrun with
                `--distributed` (1 process, NCCL: 2 steps, one evaluation,
                one checkpoint, K1-K5 launched); two gloo ranks this
                script starts on cuda:0 through `build_train` (K1-K5
                launched in each; losses, the last step's all-reduced
                gradient and the weights after 2 steps at lr 1e-3 with
                no warmup against this process's one-process run at the
                fp32 tier, drop path on; a 4-image evaluation split 2 / 2
                giving the
                one-process confusion matrix exactly); the same ranks with
                UPernet at batch 3 each (global-batch BatchNorm): the
                all-reduced gradient and both ranks' running statistics
                against one process at the fp32 tier; s/step of each and
                the gradient bytes all-reduced a step.
 14. bits     — K1-K4, K10 and K11 at the four trunk stages give the
                recorded bits (`BODY_BITS`: K1, K3, K10 and K11's from
                before K9 joined their backward body, K2 and K4's from
                their Hopper design); last, so that its calls precede no
                timed phase.

Ends with the summary (the bf16 io ms of K1-K7, K10 and K11 beside fp32
with their bounds at 2-byte io, the losses' ms, the FLOP counts, bf16 eval img/s, train s/step and peak memory beside
fp32), the card line, one JSON line of the kernels (fp32 numbers;
launches from the train phase's last fp32 run with the switch on, K8 /
K9's from the ops phase, K10 / K11's from the image phase; bound_ms from
this run's shapes, see `_work`; the larger of the bytes over the HBM rate
and the operations over their units' rates, the scan kernels' exps over
the card's MUFU rate among them, `_bound`), then the device line.
`python3 chip_smoke.py --scan-split [TREE [K2|K4]]` runs only the build
and the split, on the port of TREE. Exits non-zero, with no result line,
without a CUDA card or when a phase fails.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
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
# exps a clock on one SM (Hopper's MUFU units); the card's rate is this
# times its SMs and SM clock, read from the device (`_mufu_per_s`)
MUFU_PER_CLOCK_SM = 16

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


def _work(kernel, kw, reverse=False, cf_ck=CF_CARRY_TOKENS, io=4):
    """(bytes, operations) of one call's function at shape `kw`: each
    input read once and each output written once, the io streams (u, dt,
    B, C, y, y_accum, dy and, where the kernel keeps them in the io type,
    du, dd, dB, dC; K6 / K7's y_hw, y_wh, z and their gradients; the
    weights K2 / K4 take) at `io` bytes an element (4 fp32, 2 bf16), the
    rest (hck, A, D, bias, K4's fp32 du / dd / dB / dC, K5's cotangents
    and dW, K6's out, K7's dout) at 4; operations count an exp or a
    division as one. Scan: 9 per (token, chain, channel,
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
    K11's projections count at the TF32 rate, `_tf32_ops`); x, y, dy, du
    and the weights at `io` bytes, K11's dd / dB / dC at 4."""
    from sigma_tpu_torch.ops.scan_g import CK_TOKENS
    from sigma_tpu_torch.ops.scan_img import IMG_CK_TOKENS

    if kernel in IMAGE:
        B, dg, N = kw["B"], kw["dg"], kw["N"]
        L = kw["H"] * kw["W"]
        img, chains = io * B * L * dg, 4 * 4 * B * L
        wts = io * 4 * dg * (dg + 2 * N)
        params = 4 * 4 * dg * (N + 2)
        proj = 2 * 4 * B * L * dg * (dg + 2 * N)
        if kernel == "scan_img_fwd":
            return 2 * img + wts + params, 9 * 4 * B * L * dg * N + proj
        hck = 4 * 4 * B * -(-L // IMG_CK_TOKENS) * N * dg
        return (3 * img + chains * dg + 2 * chains * N + hck + wts
                + 2 * params, 22 * 4 * B * L * dg * N + proj)

    if kernel in EPILOGUE:
        n, c = kw["B"] * kw["H"] * kw["W"] * kw["C"], kw["C"]
        return {"merge_ln_gate_fwd": ((3 * io + 4) * n + 8 * c, 14 * n),
                "merge_ln_gate_bwd": ((6 * io + 4) * n + 16 * c,
                                      32 * n)}[kernel]
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
    big, small = io * tok * dg, io * tok * N          # io streams
    big4, small4 = 4 * tok * dg, 4 * tok * N          # fp32 ones
    params = 4 * G * dg * (3 + N)                    # bias, D, (dD), A
    wts = io * G * dg * (dg + 2 * N)
    wts4 = 4 * G * dg * (dg + 2 * N)
    hck = 4 * B * G * -(-L // CK_TOKENS) * N * dg
    ya = big if reverse else 0
    proj = 2 * tok * dg * (dg + 2 * N)
    scan_fwd, scan_bwd = 9 * tok * dg * N, 22 * tok * dg * N
    return {
        "scan_fwd": (3 * big + 2 * small + params + ya, scan_fwd),
        "scan_proj_fwd": (2 * big + wts + params + ya, scan_fwd + proj),
        "scan_bwd": (5 * big + 4 * small + hck + 2 * params, scan_bwd),
        "scan_proj_bwd": (2 * big + 2 * big4 + 2 * small4 + hck + wts
                          + 2 * params, scan_bwd + proj),
        "proj_grad": (big + 3 * big4 + 2 * small4 + 2 * wts4, 2 * proj),
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


def _exps(kernel, kw):
    """The exps of one call's function at shape `kw` (`_work`'s shapes):
    one per (token, chain, channel, state) for every scan kernel, forward
    or backward (the decay exp(d A), which a backward needs once too), and
    two per (token, chain, channel) where the kernel applies the softplus
    of dt (exp and log1p: K1-K4, K10, K11; K8 / K9 take d as it is); none
    for K5, K6, K7."""
    if kernel in EPILOGUE or kernel == "proj_grad":
        return 0
    dg, N = kw["dg"], kw["N"]
    if kernel in IMAGE:
        return 4 * kw["B"] * kw["H"] * kw["W"] * dg * (N + 2)
    if kernel in OPS:
        return kw["batch"] * kw["G"] * kw["L"] * dg * N
    G = kw.get("G", 2 if kw["ml"] else 1)
    return kw["B"] * G * kw["L"] * dg * (N + 2)


_MUFU_PER_S = []


def _mufu_per_s():
    """The card's exp rate: MUFU_PER_CLOCK_SM x its SMs x its maximum SM
    clock (nvidia-smi), read once."""
    import torch

    if not _MUFU_PER_S:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        _MUFU_PER_S.append(MUFU_PER_CLOCK_SM * sms * mhz * 1e6)
    return _MUFU_PER_S[0]


def _bound(kernel, kw, reverse=False, cf_ck=CF_CARRY_TOKENS, io=4,
           mufu=None):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the HBM rate and the operations over the peak rate
    of the units that run them (TF32 tensor cores, fp32 cores, and the
    exps, `_exps`, at `mufu` a second, by default the card's
    `_mufu_per_s`; `math.inf` leaves the exps' term out); `io` bytes an
    element of the io streams (`_work`)."""
    nbytes, ops = _work(kernel, kw, reverse, cf_ck, io)
    tc = _tf32_ops(kernel, kw)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max((ops - tc) / FP32_OPS_PER_S, tc / TF32_OPS_PER_S,
                _exps(kernel, kw) / (mufu or _mufu_per_s()))
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


def _short_kernel(name):
    """A kernel's name in a trace without its namespaces and arguments:
    the function and the template arguments that tell the passes apart."""
    import re

    name = re.sub(r"\(anonymous namespace\)::|\w+::|void ", "", name)
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            return name[:i]
    return name


# the K2 / K4 calls whose launches `scan_split` times: ConMB, SS2D and
# CroMB (C swapped) at stage 0, the trunk's SS2D at stages 1 and 2
SPLIT_TAGS = ("conmb0", "ss2d0", "cromb0", "ss2d1", "ss2d2")


def scan_split(device, reps=5, names=("K2", "K4")):
    """The device time of each launch of K2 (at the kernel phase's eval
    batch 1) and of K4 (at the train step's batch 2), fp32 and bf16 io, at
    `SPLIT_TAGS` (torch.profiler, `_device_ms`): one line per call, the
    call's CUDA-event ms (`_time_ms`, as the kernel and backward phases
    time it), the device total and each launch by kernel name (the
    wrapper's own copies and fills included). Returns {(K2|K4, tag,
    dtype): device total ms}."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 5)
    totals = {}
    for name, batch in (("K2", 1), ("K4", 2)):
        if name not in names:
            continue
        for _, tag, kw in main_path_scans(batch=batch):
            if tag not in SPLIT_TAGS:
                continue
            for dtype in (torch.float32, torch.bfloat16):
                x = _inputs(kw, dtype, device, gen)
                with torch.no_grad():
                    if name == "K2":
                        fn = lambda: _run_case(  # noqa: E731
                            "scan_proj_fwd", kw, x, False, True)
                    else:
                        dy = torch.randn(x["u"].shape, generator=gen).to(
                            device, dtype)
                        fn = _kernel_runs("scan_proj_bwd", kw, x, dy,
                                          compare=False)[0]["scan_proj_bwd"]
                    by_name, total = _device_ms(fn, reps)
                    event_ms = _time_ms(fn, reps)
                totals[(name, tag, str(dtype)[6:])] = total
                print(f"split: {name} {tag} {str(dtype)[6:]} events "
                      f"{event_ms:.4f} ms, device total {total:.4f} ms: "
                      + "; ".join(
                          f"{_short_kernel(k)[:64]} {v:.4f}"
                          for k, v in sorted(by_name.items(),
                                             key=lambda kv: -kv[1])),
                      flush=True)
                del x, fn
                torch.cuda.empty_cache()
    return totals


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
    bf16_ms = {}  # (kernel, tag): bf16 ms
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
                                 at=f"{tag} fp32 {kw}", kw=kw, tag=tag)
                    if dtype == torch.bfloat16:
                        bf16_ms[(kernel, tag)] = ms
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
    for kernel, s in summary.items():
        s["bf16_ms"] = bf16_ms[(kernel, s["tag"])]
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
    concatenated operands (made here, outside the timed closure), in u's
    dtype (bf16 io: cuBLAS's bf16 products)."""
    import torch

    u = us[0] if len(us) == 1 else torch.stack(tuple(us), 1)
    G, dg = u.shape[1], u.shape[-1]
    z = torch.cat([dd, dB, dC], -1).to(u.dtype)
    ut = u.transpose(0, 1).reshape(G, -1, dg).transpose(1, 2)
    zt = z.transpose(0, 1).reshape(G, -1, z.shape[-1])
    wt = torch.cat(w, -1).transpose(1, 2).to(u.dtype)
    return lambda: (torch.matmul(ut, zt), torch.matmul(z, wt))


def _same_bits(first, again):
    """True when two runs' outputs (tensors or lists of them) are equal
    bit for bit."""
    import torch

    def flat(out):
        return [t for o in out
                for t in (o if isinstance(o, (list, tuple)) else (o,))]

    return all(torch.equal(a, b) for a, b in zip(flat(first), flat(again)))


def _kernel_runs(kernel, kw, x, dy, compare=True):
    """For timing: {kernel: closure launching it alone} on the inputs of
    one forward main-path call (K3 after K1's checkpoints, or K4 after
    K2's and K5 on K4's cotangents), in the inputs' io type, {kernel: its
    plain version} where that is not the scan's autograd (K5), {kernel:
    the PyTorch library calls that compute its function} (K5's cuBLAS
    products; both empty unless `compare`), and {kernel: whether two runs
    gave the same bits} (K3 or K4: all seven outputs; K5: dW and du)."""
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
    runs = {"scan_proj_bwd": k4,
            "proj_grad": lambda: scan_g.launch_proj_grad(
                us, dus, dd, dB, dC, *w)}
    if not compare:
        return runs, {}, {}, reruns
    return (runs,
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


def _bf16_backward(tag, kw, x, dy, ran, reps):
    """bf16 io at one train-step shape, as the bf16 train step runs it: u,
    y_accum and the projection weights bf16. Every gradient through the
    entry point, forward and reversed, against autograd of the plain
    version in fp32 on the same (bf16-rounded) values, in the bf16 tier;
    every kernel launched on bf16 operands (`LAUNCHES_BF16`). Then K3, or
    K4 and K5, alone on bf16 operands: timed and run twice for the same
    bits; K5's function also as bf16 cuBLAS products (`_proj_grad_library`).
    Returns (failed lines, {kernel: ms}, {kernel: max_abs_err}, {kernel:
    library ms})."""
    import torch

    from sigma_tpu_torch.ops import scan_g

    lib_ms = {}
    io = ("u", "ya", "w_dt", "w_b", "w_c")
    xb = {k: v.to(torch.bfloat16) if k in io else v for k, v in x.items()}
    xr = {k: v.float() for k, v in xb.items()}  # the same values, fp32
    dyb = dy.to(torch.bfloat16)
    failures, errs_by = [], {}
    for reverse in (False, True):
        want, _ = _entry_grads(kw, xr, dyb.float(), reverse, plain=True)
        scan_g.reset_launches()
        got, _ = _entry_grads(kw, xb, dyb.float(), reverse, plain=False)
        torch.cuda.synchronize()
        launches = {k: n for k, n in scan_g.LAUNCHES.items() if n}
        bf16 = {k: n for k, n in scan_g.LAUNCHES_BF16.items() if n}
        bad = [] if launches == bf16 == dict.fromkeys(ran, 1) else [
            f"launches {launches} bf16 {bf16}"]
        errs = {}
        for k, w in want.items():
            errs[k], ok = _scaled_err(got[k], w, BF16_TOL)
            if not ok or got[k].dtype != xb[k].dtype:
                bad.append(f"{k} {got[k].dtype}")
            owner = ran[1] if len(ran) == 2 else _FUSED_OWNER.get(k)
            if owner:
                errs_by[owner] = max(errs_by.get(owner, 0.0), errs[k])
        line = (f"backward: bf16 {'+'.join(ran[1:])} {tag} {kw} "
                f"rev={int(reverse)} "
                + " ".join(f"d{k}={v:.2e}" for k, v in errs.items()))
        if not reverse:
            runs, _, lib_runs, reruns = _kernel_runs(ran[1], kw, xb, dyb)
            bad += [f"{k} rerun changed bits"
                    for k, same in reruns.items() if not same]
            times = {k: _time_ms(fn, reps) for k, fn in runs.items()}
            lib_ms.update({k: _time_ms(fn, reps)
                           for k, fn in lib_runs.items()})
            line += (" reruns bit for bit " + " ".join(
                        f"{k} {'ok' if same else 'FAIL'}"
                        for k, same in reruns.items()) + " " + " ".join(
                        f"{k}_ms={v:.4f} (bound {_bound(k, kw, io=2)[0]:.4f})"
                        for k, v in times.items()) + "".join(
                        f" library_{k}_ms={v:.4f} (bf16 cuBLAS)"
                        for k, v in lib_ms.items()))
            del runs, lib_runs
        line += f" {'ok' if not bad else 'FAIL ' + str(bad)}"
        print(line, flush=True)
        if bad:
            failures.append(line)
        del want, got
        torch.cuda.empty_cache()
    return failures, times, errs_by, lib_ms


def backward_phase(device, reps=3):
    """Every distinct scan shape of the train step (batch 2), forward and
    reversed: every gradient through the scan entry point (the autograd
    Functions the train step runs, checked to launch K3 or K4 + K5)
    against autograd of the plain version, then each kernel alone timed
    against its plain version; the same with bf16 io (`_bf16_backward`).
    Returns per-kernel summaries (bf16_ms and bf16_max_abs_err: bf16 io
    at the shape of the slowest fp32 call); raises on disagreement."""
    import torch

    from sigma_tpu_torch.ops import scan_g

    gen = torch.Generator().manual_seed(SEED + 2)
    summary = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                       library_ms=None, at="", bf16_max_abs_err=0.0)
               for k in SCAN_BACKWARD}
    bf16_ms = {}  # (kernel, tag): bf16 ms
    bf16_lib_ms = {}  # (kernel, tag): bf16 cuBLAS ms (K5)
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
                                 at=f"{tag} {kw}", kw=kw, tag=tag)
                del runs, plain_runs, lib_runs
            print(line, flush=True)
            if bad:
                failures.append(line)
            del want, got, run, plain_run
            torch.cuda.empty_cache()
        bad, times, errs, lib16 = _bf16_backward(tag, kw, x, dy, ran, reps)
        failures += bad
        for k, ms in times.items():
            bf16_ms[(k, tag)] = ms
        for k, ms in lib16.items():
            bf16_lib_ms[(k, tag)] = ms
        for k, e in errs.items():
            summary[k]["bf16_max_abs_err"] = max(
                summary[k]["bf16_max_abs_err"], e)
        del x, dy
    scan_g.reset_launches()
    for k, s in summary.items():
        s["bf16_ms"] = bf16_ms[(k, s["tag"])]
        s["bf16_library_ms"] = bf16_lib_ms.get((k, s["tag"]))
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
    bf16_ms = {}  # (kernel, shape): bf16 device ms
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
            else:
                with torch.no_grad():
                    for k, fn in (
                            ("merge_ln_gate_fwd",
                             lambda: mlg.launch_merge_ln_gate_fwd(*args, eps)),
                            ("merge_ln_gate_bwd",
                             lambda: mlg.launch_merge_ln_gate_bwd(
                                 *args, eps, dout))):
                        bf16_ms[(k, (b, h, w, c))] = t = sum(
                            v for n, v in _device_ms(fn, reps)[0].items()
                            if f"{k}_kernel" in n)
                        line += f" device_ms {k}={t:.4f}"
            line += f" {'ok' if not bad else 'FAIL ' + str(bad)}"
            print(line, flush=True)
            if bad:
                failures.append(line)
            del args, dout, out, got, want
    torch.cuda.empty_cache()
    mlg.reset_launches()
    for k, s_ in summary.items():
        s_["bf16_ms"] = bf16_ms[(k, tuple(s_["kw"].values()))]
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
    _cf_peak_memory(device, *cases[0])
    _reset_launches()
    if failures:
        raise AssertionError(f"{len(failures)} ops comparisons failed")
    return summary, per_row, counts


def _cf_peak_memory(device, tag, kw):
    """Peak device memory of one `selective_scan` forward + backward
    (K8 + K9) at `kw`, above the inputs and the output gradient it is
    given, beside the size of the residual K8 keeps for K9 (every 32-token
    checkpoint) and of the 256-token carries the JAX reference keeps."""
    import torch

    from sigma_tpu_torch import ops

    x = {k: v.detach().clone().requires_grad_(True)
         for k, v in _ops_inputs(kw, device, SEED + 30).items()}
    dy = torch.randn(x["u"].shape, device=device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    y = ops.selective_scan(**x, delta_softplus=True)
    torch.autograd.grad((y * dy).sum(), list(x.values()))
    del y
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) - base
    rows = kw["batch"] * kw["G"]
    state = rows * kw["N"] * kw["dg"] * 4  # fp32 bytes of one state
    ck32 = state * math.ceil(kw["L"] / 32)
    ck256 = state * math.ceil(kw["L"] / CF_CARRY_TOKENS)
    mib = 2.0 ** 20
    print(f"ops: C9 {tag} {kw} selective_scan forward + backward peak "
          f"{peak / mib:.2f} MiB above its inputs ({base / mib:.2f} MiB); "
          f"the 32-token checkpoints K8 keeps for K9 {ck32 / mib:.2f} MiB, "
          f"256-token carries {ck256 / mib:.2f} MiB: the peak with them "
          f"{(peak - ck32 + ck256) / mib:.2f} MiB", flush=True)
    del x, dy
    torch.cuda.empty_cache()


# sha256 of the outputs of the backward body's other sources (K3, K4,
# K11) and of the forwards that write their checkpoints (K1, K2, K10) on
# fixed inputs, recorded with `body_bits` on an NVIDIA H100 80GB HBM3: K1,
# K3, K10 and K11's from the tree before K9 joined the body
# (`csrc/chunk_bwd.cuh`), which must not move them; K2 and K4's from their
# Hopper design (`csrc/proj_wgmma.cuh`, `csrc/chain_fwd.cuh`)
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
    gradients (fp32, and bf16 io at 5e-2 with every kernel on bf16
    operands) at stages 0 and 3 against the plain version, with the
    launches checked (counters zeroed before these calls and read after);
    the d_state 17 / 40 entry points; then K10 and K11 (each run twice: the
    same bits; K10's checkpoints against the plain walk) and K5 alone, the
    plain version and the two-call route the port's SS2D takes today,
    timed, and K10 and K11 at bf16 io. Returns (per-kernel summaries, the counts); raises on
    disagreement."""
    import torch

    from sigma_tpu_torch.ops import scan_g, scan_img

    t_phase = time.perf_counter()
    summary = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, at="")
               for k in IMAGE}
    names = ("x", "w_dt", "w_b", "w_c", "A", "D", "delta_bias")
    failures = []
    want_counts = defaultdict(int)
    bf16_ms = {}  # (kernel, tag): bf16 io ms
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
        for dtype, tol in (((torch.float32, FP32_TOL),
                            (torch.bfloat16, BF16_TOL))
                           if s in IMG_GRAD_STAGES else ()):
            x = _img_inputs(kw, dtype, device, SEED + 30 + s)
            dy = torch.randn(x["x"].shape, device=device,
                             generator=torch.Generator(
                                 device=device).manual_seed(SEED + 40 + s))
            before = _launches()
            before16 = {**scan_img.LAUNCHES_BF16, **scan_g.LAUNCHES_BF16}
            got_y, got = _ops_grads(lambda **a: scan_g.selective_scan_ss2d_proj(
                **a, delta_softplus=True), x, dy)
            torch.cuda.synchronize()
            ran = {k: n - before[k] for k, n in _launches().items()
                   if n != before[k]}
            ran16 = {k: n - before16[k] for k, n in {
                **scan_img.LAUNCHES_BF16, **scan_g.LAUNCHES_BF16}.items()
                if n != before16[k]}
            want_counts["scan_img_fwd"] += 1
            want_counts["scan_img_bwd"] += 1
            want_counts["proj_grad"] += 2
            want_y, want = _ops_grads(
                lambda **a: scan_img.selective_scan_ss2d_proj_plain(
                    **a, delta_softplus=True, remat_chunks=True), x, dy)
            errs, bad = {}, []
            for k in ("y",) + names:
                g_, w_ = (got_y, want_y) if k == "y" else (got[k], want[k])
                errs[k], ok = _scaled_err(g_, w_, tol)
                bad += [] if ok and g_.dtype == w_.dtype else [k]
            if ran != dict(scan_img_fwd=1, scan_img_bwd=1, proj_grad=2):
                bad.append(f"launched {ran}")
            # bf16 io all through: K10, K11 and both K5 on bf16 operands
            want16 = (dict(scan_img_fwd=1, scan_img_bwd=1, proj_grad=2)
                      if dtype == torch.bfloat16 else {})
            if ran16 != want16:
                bad.append(f"launched on bf16 operands {ran16}")
            m = summary["scan_img_bwd"]
            key = ("max_abs_err" if dtype == torch.float32
                   else "bf16_max_abs_err")
            m[key] = max(m.get(key, 0.0), *(
                v for k, v in errs.items() if k != "y"))
            line = (f"image: selective_scan_ss2d_proj gradients {tag} {kw} "
                    f"{str(dtype)[6:]} "
                    + " ".join(f"{'d' * (k != 'y')}{k}={v:.2e}"
                               for k, v in errs.items())
                    + f" launched {ran}, on bf16 operands {ran16} "
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
        # bf16 io: K10 and K11 on the same call's bf16 inputs
        xb = _img_inputs(kw, torch.bfloat16, device, SEED + 30 + s)
        args16 = [xb[k] for k in names]
        dy16 = dy.to(torch.bfloat16)
        with torch.no_grad():
            _, hck16 = scan_img.launch_scan_img_fwd(
                *args16, delta_softplus=True, with_hck=True)
            ms16 = {
                "scan_img_fwd": _time_ms(lambda: scan_img.launch_scan_img_fwd(
                    *args16, delta_softplus=True), reps),
                "scan_img_bwd": _time_ms(lambda: scan_img.launch_scan_img_bwd(
                    *args16, hck16, dy16, True), reps)}
        bf16_ms.update({(k, tag): v for k, v in ms16.items()})
        del xb, args16, dy16, hck16
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
        bounds16 = {k: _bound(k, kw, io=2) for k in IMAGE}
        print(f"image: {tag} {kw} ms "
              + " ".join(f"{k}={v:.4f}" for k, v in ms.items())
              + " bound " + " ".join(f"{k}={b[0]:.4f} ({b[1]})"
                                     for k, b in bounds.items())
              + "; bf16 io ms " + " ".join(f"{k}={v:.4f}"
                                           for k, v in ms16.items())
              + " bound " + " ".join(f"{k}={b[0]:.4f} ({b[1]})"
                                     for k, b in bounds16.items())
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
                         at=f"{tag} {kw}", kw=kw, tag=tag)
        del x, args, dy, leaves, hck, first, du4, dd, dB, dC, route_y, img_y
        torch.cuda.empty_cache()
    for k, m in summary.items():
        m["bf16_ms"] = bf16_ms[(k, m["tag"])]
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
    [0, 9) with some 255 ignore pixels, so that the timed serving runs
    read no file (the files phase reads PNG trees)."""

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


def _serve(cfg, device, order, tag):
    """build_model(cfg) + SlidingEvaluator.run under the MFNet preset on
    four seeded images, once per entry of `order` (the fused SS2D epilogue
    off or on; one model, so the same weights). Returns (model, {switch:
    [img/s of each run]}, {switch: [peak GiB of each run]}); raises if a
    kernel was not launched as the path implies (with cfg.bf16: on bf16
    operands) or an output is wrong."""
    import numpy as np
    import torch

    from sigma_tpu_torch.engine.evaluator import SlidingEvaluator
    from sigma_tpu_torch.models.builder import build_model
    from sigma_tpu_torch.models.ss2d import SS2D, set_fused_epilogue
    from sigma_tpu_torch.ops import scan_g

    t0 = time.perf_counter()
    model = build_model(cfg, device=device, seed=SEED)
    n_ss2d = sum(isinstance(m, SS2D) for m in model.modules())
    print(f"{tag}: {cfg.backbone}/{cfg.decoder} {cfg.num_classes} classes "
          f"{sum(p.numel() for p in model.parameters())} params, {n_ss2d} "
          f"SS2Ds, {'bf16' if cfg.bf16 else 'fp32'} compute, built in "
          f"{time.perf_counter() - t0:.2f}s")
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
    img_s, peaks = {False: [], True: []}, {False: [], True: []}
    for fused in order:
        set_fused_epilogue(model, fused)
        t0 = time.perf_counter()
        pred = ev.sliding_eval(data[0]["data"], data[0]["modal_x"])
        print(f"{tag}: fused_epilogue={int(fused)} warm-up image "
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
        bf16 = dict(scan_g.LAUNCHES_BF16)
        img_s[fused].append(len(data) / seconds)
        peaks[fused].append(torch.cuda.max_memory_allocated(device) / 2**30)
        print(f"{tag}: fused_epilogue={int(fused)} MFNet "
              f"{cfg.image_height}x{cfg.image_width} eval of {len(data)} "
              f"images in {seconds:.3f}s = {len(data) / seconds:.4f} img/s, "
              f"mIoU {miou:.4f} (random weights), peak "
              f"{peaks[fused][-1]:.3f} GiB, "
              f"{forwards[0]} forwards, launches {launches}, bf16 io "
              f"{ {k: n for k, n in bf16.items() if n} }")
        if not np.isfinite(miou) or not np.isfinite(detail["pixel_acc"]):
            raise AssertionError(f"non-finite metrics {miou} {detail}")
        missing = [k for k in FORWARD if launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the main path: "
                                 f"{missing}")
        io_bad = [k for k in FORWARD
                  if bf16[k] != (launches[k] if cfg.bf16 else 0)]
        if io_bad:
            raise AssertionError(f"kernels launched in another io type than "
                                 f"the model's: {io_bad}")
        backward = [k for k in SCAN_BACKWARD + EPILOGUE[1:] if launches[k]]
        if backward:
            raise AssertionError(f"backward kernels launched by eval: "
                                 f"{backward}")
        want_k6 = n_ss2d * forwards[0] if fused else 0
        if launches["merge_ln_gate_fwd"] != want_k6:
            raise AssertionError(f"K6 launched {launches['merge_ln_gate_fwd']}"
                                 f" times, the path implies {want_k6}")
    return model, img_s, peaks


def model_phase(device, order=(False, True, True, False)):
    """The port's serving path: build_model + SlidingEvaluator.run under
    the MFNet preset, once per entry of `order` (`_serve`). Returns
    ({switch: [img/s of each run]}, {switch: [peak GiB]}); raises if a
    kernel was not launched as the path implies, an output is wrong, the
    switch changes the logits, or the GPU logits disagree with the CPU
    plain path."""
    import copy

    import numpy as np
    import torch

    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.models.ss2d import set_fused_epilogue

    cfg = get_config("mfnet")
    model, img_s, peaks = _serve(cfg, device, order, "model")
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
    return img_s, peaks


def bf16_model_phase(device, order=(False, True)):
    """bf16 serving: the model phase's path with cfg.bf16 (the same seeded
    weights, fp32 parameters) on the same four images, the fused epilogue
    off then on; every forward scan kernel launched on bf16 operands.
    Returns ({switch: [img/s]}, {switch: [peak GiB]})."""
    import torch

    from sigma_tpu_torch.configs import get_config

    model, img_s, peaks = _serve(get_config("mfnet", bf16=True), device,
                                 order, "bf16 model")
    del model
    torch.cuda.empty_cache()
    return img_s, peaks


def _train_run(cfg, device, batches, fused):
    """The train CLI's step (a fresh seeded model) over `batches`, with the
    fused SS2D epilogue `fused`. Returns (launch counts, timing dict with
    the peak memory); raises if a loss is not finite, no weight moved, or
    the kernels launched differ from what the path and its remat plan
    imply (with cfg.bf16: every scan kernel on bf16 operands, so no
    backward went through an fp32 copy)."""
    import numpy as np
    import torch

    from sigma_tpu_torch.engine.train import build_train
    from sigma_tpu_torch.models.ss2d import set_fused_epilogue
    from sigma_tpu_torch.ops import scan_g
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
    bf16 = dict(scan_g.LAUNCHES_BF16)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    moved = sum(int((p.detach() != before[k]).sum())
                for k, p in model.named_parameters())
    total = sum(p.numel() for p in model.parameters())
    fp32_params = all(p.dtype == torch.float32 for p in model.parameters())
    s_step = sum(seconds[1:]) / len(seconds[1:])
    tag = (f"{'bf16 ' if cfg.bf16 else ''}train: "
           f"fused_epilogue={int(fused)}")
    print(f"{tag} sigma_tiny MFNet {h}x{w} batch {batch}, {steps} steps, "
          f"{'bf16' if cfg.bf16 else 'fp32'} compute: "
          f"losses {losses}, seconds {[round(t, 4) for t in seconds]}, "
          f"lr {[schedule(k) for k in range(steps)]}")
    print(f"{tag} last {steps - 1} steps {s_step:.4f} s/step = "
          f"{batch / s_step:.4f} img/s, peak {peak:.3f} GiB, "
          f"{moved} of {total} weights moved, launches {launches}, bf16 io "
          f"{ {k: n for k, n in bf16.items() if n} }")
    del state, step, model, before
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train loss {losses}")
    if moved == 0 or not fp32_params:
        raise AssertionError("the train steps moved no weight, or left a "
                             "parameter in another dtype than fp32")
    missing = [k for k in FORWARD + SCAN_BACKWARD if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the train step: "
                             f"{missing}")
    io_bad = [k for k in FORWARD + SCAN_BACKWARD
              if bf16[k] != (launches[k] if cfg.bf16 else 0)]
    if io_bad:
        raise AssertionError(f"kernels launched in another io type than the "
                             f"model's: {io_bad} (bf16 {bf16}, all "
                             f"{launches})")
    want = ((steps * k6, steps * k7) if fused else (0, 0))
    got = tuple(launches[k] for k in EPILOGUE)
    if got != want:
        raise AssertionError(f"K6/K7 launched {got} times, the remat plan "
                             f"implies {want}")
    return launches, dict(s_step=s_step, img_s=batch / s_step, peak=peak)


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


def bf16_train_phase(device, steps=3, order=(False, True)):
    """The train phase's step with cfg.bf16 (the same seeded weights and
    batches): 3 steps once per entry of `order`; every forward and
    backward scan kernel on bf16 operands (`_train_run`). Returns {switch:
    [timing dicts]}."""
    import numpy as np

    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.trace_step import TRAIN_BATCH as batch
    from sigma_tpu_torch.trace_step import synthetic_batch

    cfg = get_config("mfnet", bf16=True)
    rng = np.random.default_rng(SEED + 3)
    batches = [synthetic_batch(rng, batch, cfg.image_height,
                               cfg.image_width) for _ in range(steps)]
    timing = {False: [], True: []}
    for fused in order:
        timing[fused].append(_train_run(cfg, device, batches, fused)[1])
    return timing


def bf16_cross_check(device):
    """bf16 on the card against bf16 on the CPU (the plain scan path), on
    sigma_test from one set of seeded weights, epilogue off and on: the
    logits of a 96x128 pair, and one SGDM step at 64x80 (loss and
    post-step weights). bf16 rounds at other places in the kernels than in
    the plain versions, so the bound is the scale of bf16 itself: the
    card-vs-CPU gap at most twice the CPU's own bf16-vs-fp32 gap on the
    same model and inputs. A gap is the norm of the difference over the
    whole quantity (all logits; all weights), so no single element where
    a sum cancels decides it; the largest element of each difference and
    its leaf, and the card's own bf16-vs-fp32 gap, are printed beside it.
    Raises otherwise."""
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
    from sigma_tpu_torch.trace_step import synthetic_batch
    from sigma_tpu_torch.utils.lr_schedule import poly_lr

    sd = init_parameters(EncoderDecoder(9, "sigma_test"),
                         seed=SEED + 8).state_dict()

    def model(dtype, dev, fused):
        m = EncoderDecoder(9, "sigma_test", dtype=dtype)
        m.load_state_dict(sd)
        for mod in m.modules():  # the CPU and CUDA generators differ
            if isinstance(mod, DropPath):
                mod.rate = 0.0
        return set_fused_epilogue(m, fused).to(dev)

    def gap(a, b):
        """(norm of a - b, its largest element, that element's leaf)."""
        if isinstance(a, float):
            return abs(a - b), abs(a - b), ""
        if isinstance(a, torch.Tensor):
            a, b = {"": a}, {"": b}
        d = {k: (a[k] - b[k]).flatten() for k in a}
        top = max(d, key=lambda k: d[k].abs().max().item())
        return (torch.cat(list(d.values())).norm().item(),
                d[top].abs().max().item(), top)

    rng = np.random.default_rng(SEED + 9)
    rgb, mx = (torch.from_numpy(rng.standard_normal((1, 96, 128, 3))
                                .astype(np.float32)) for _ in range(2))
    cfg = get_config("mfnet", optimizer="SGDM")
    small = synthetic_batch(np.random.default_rng(SEED + 10), 2, 64, 80)
    failures = []
    for fused in (False, True):
        runs = {"cpu fp32": (torch.float32, "cpu"),
                "cpu bf16": (torch.bfloat16, "cpu"),
                "card bf16": (torch.bfloat16, device),
                "card fp32": (torch.float32, device)}
        logits, losses, weights = {}, {}, {}
        for name, (dtype, dev) in runs.items():
            m = model(dtype, dev, fused).eval()
            with torch.inference_mode():
                logits[name] = m(rgb.to(dev), mx.to(dev)).float().cpu()
            opt = build_optimizer(cfg, m)
            st = create_train_state(m, opt)
            losses[name] = float(make_train_step(
                m, opt, poly_lr(1e-2, 0.9, 100))(st, small))
            weights[name] = {k: v.detach().float().cpu()
                             for k, v in m.state_dict().items()}
            del m, opt, st
        for what, vals in (("logits 96x128", logits),
                           ("one SGDM step 64x80, loss", losses),
                           ("one SGDM step 64x80, post-step weights",
                            weights)):
            card = gap(vals["card bf16"], vals["cpu bf16"])
            cpu = gap(vals["cpu bf16"], vals["cpu fp32"])
            own = gap(vals["card bf16"], vals["card fp32"])
            ok = card[0] <= 2 * cpu[0]
            line = (f"bf16 cross-check: fused_epilogue={int(fused)} "
                    f"sigma_test {what}: card vs CPU bf16 {card[0]:.4e} "
                    f"(largest {card[1]:.3e} {card[2]}), CPU bf16 vs fp32 "
                    f"{cpu[0]:.4e} "
                    f"(largest {cpu[1]:.3e} {cpu[2]}), need card <= 2 x CPU "
                    f"{'ok' if ok else 'FAIL'}; the card's own bf16 vs fp32 "
                    f"{own[0]:.4e} (largest {own[1]:.3e} {own[2]})")
            print(line, flush=True)
            if not ok:
                failures.append(line)
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"{len(failures)} bf16 cross-checks failed")


# a 480x640 RGB PNG written by cv2 with libpng's adaptive filters (its
# rows Average-filtered) and the sha256 of what `cv2.imread` gives for it,
# colour (turned to RGB) and gray, recorded on a host with cv2
# (`tests/test_torch_port_files.py` holds them)
CV2_PNG = ROOT / "tests" / "fixtures" / "cv2_adaptive_480x640.png"
CV2_PNG_SHA256 = {
    False: "caef272c480248ab110e0dbdc813036692109da595011b401d22bae637a33a45",
    True: "1e2b87ed106a13372671244f95091a5a9fcf7d0c3491b35fdfe853691f0ec679",
}
TRAIN_SCALES = (0.5, 0.75, 1, 1.25, 1.5, 1.75)
EVAL_SCALES = (0.75, 1.25)


# the decoders phase: (decoder, deep supervision) of sigma_tpu_torch's
# builder besides the flagship's plain MambaDecoder
DECODER_CASES = (("UPernet", False), ("MLPDecoder", False),
                 ("deeplabv3+", False), ("FCN", False),
                 ("MambaDecoder", True))
# the sigma_test card-vs-CPU step of the decoders phase: batch 6, since
# UPerHead's 1x1 pool and ASPP's image pool give BatchNorm one value per
# channel and sample, and with 2 samples fp32 rounding alone moves the
# gradients by percents (tests/test_torch_port_decoders.py)
DECODER_CHECK_BATCH = 6


def _state_bits(model, loss):
    """(loss, gradients, buffers) of `model` after a step, copied."""
    return (loss.detach().clone(),
            {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None},
            {k: b.detach().clone() for k, b in model.named_buffers()})


def decoders_phase(device, steps=3):
    """The decoders besides the flagship's and MambaDecoder's deep
    supervision, at full width: sigma_tiny, the MFNet preset (480x640, 9
    classes), fp32, seeded, built by `build_train` as the train CLI
    builds it (`--decoder`, `--override deep_supervision=True`). For each
    of DECODER_CASES: the first step run twice from the same weights,
    running statistics and AdamW state (loss, every gradient and buffer
    the same bits: the decoders add no nondeterministic op, ROADMAP C10);
    then `steps` train steps at batch 2 on the train phase's batches with
    the launch counts zeroed before and read after (finite losses, K2 +
    K4 + K5 and K1 + K3 launched), s/step of the last two and peak
    memory; then the model in eval mode (its running statistics)
    through SlidingEvaluator.run on four seeded images: img/s, peak
    memory, K1 / K2 and no backward kernel. Then each decoder at
    sigma_test, 64x80, batch DECODER_CHECK_BATCH, one step on the card
    against the same step on the CPU from the same weights and batch
    (drop path and dropout 0, lr 0): loss, every gradient and running
    statistic at the fp32 tier. Returns {name: metrics}; raises on a
    failed check."""
    import copy

    import numpy as np
    import torch

    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.engine.evaluator import SlidingEvaluator
    from sigma_tpu_torch.engine.optim import build_optimizer
    from sigma_tpu_torch.engine.train import (
        build_train,
        create_train_state,
        make_train_step,
    )
    from sigma_tpu_torch.models.builder import EncoderDecoder, init_parameters
    from sigma_tpu_torch.models.common import DropPath, Dropout
    from sigma_tpu_torch.trace_step import TRAIN_BATCH as batch_n
    from sigma_tpu_torch.trace_step import synthetic_batch

    t_phase = time.perf_counter()
    base = get_config("mfnet")
    h, w = base.image_height, base.image_width
    rng = np.random.default_rng(SEED + 3)
    batches = [synthetic_batch(rng, batch_n, h, w) for _ in range(steps)]
    data = _SyntheticMFNet(4, h, w, SEED)
    out = {}
    for decoder, ds in DECODER_CASES:
        name = decoder + (" + deep supervision" if ds else "")
        cfg = get_config("mfnet", decoder=decoder, deep_supervision=ds)
        t0 = time.perf_counter()
        state, step, _ = build_train(cfg, device)
        model, opt = state.model, state.optimizer
        build_s = time.perf_counter() - t0
        model_0 = {k: v.clone() for k, v in model.state_dict().items()}
        opt_0 = copy.deepcopy(opt.state_dict())

        def restart():
            model.load_state_dict(model_0)
            opt.load_state_dict(opt_0)
            state.step = 0

        runs = []
        for _ in range(2):
            restart()
            runs.append(_state_bits(model, step(state, batches[0])))
        rerun = all(torch.equal(a, b) for a, b in
                    [(runs[0][0], runs[1][0])]
                    + [(v, runs[1][i][k]) for i in (1, 2)
                       for k, v in runs[0][i].items()])
        n_bn = sum(k.endswith("running_var") for k in runs[0][2])
        del runs
        restart()
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
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        s_step = sum(seconds[1:]) / len(seconds[1:])

        model.eval()
        ev = SlidingEvaluator(
            model, cfg.num_classes, cfg.norm_mean, cfg.norm_std,
            multi_scales=cfg.eval_scale_array, is_flip=cfg.eval_flip,
            eval_crop_size=cfg.eval_crop_size,
            stride_rate=cfg.eval_stride_rate, device=device)
        ev.sliding_eval(data[0]["data"], data[0]["modal_x"])  # warm-up
        torch.cuda.reset_peak_memory_stats(device)
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        miou, detail = ev.run(data)
        torch.cuda.synchronize()
        img_s = len(data) / (time.perf_counter() - t0)
        eval_launches = _launches()
        eval_peak = torch.cuda.max_memory_allocated(device) / 2**30
        print(f"decoders: sigma_tiny/{name} MFNet {h}x{w} fp32, "
              f"{sum(p.numel() for p in model.parameters())} params, "
              f"{n_bn} BatchNorms, built in {build_s:.2f}s: first step "
              f"rerun {'bit for bit' if rerun else 'with OTHER bits'}; "
              f"{steps} steps at batch {batch_n}: losses {losses}, seconds "
              f"{[round(t, 4) for t in seconds]}, last {steps - 1} "
              f"{s_step:.4f} s/step, peak {peak:.3f} GiB, launches "
              f"{ {k: n for k, n in launches.items() if n} }; eval of "
              f"{len(data)} images {img_s:.4f} img/s, mIoU {miou:.4f} "
              f"(random weights), peak {eval_peak:.3f} GiB, launches "
              f"{ {k: n for k, n in eval_launches.items() if n} }",
              flush=True)
        del state, step, model, opt, model_0, ev
        torch.cuda.empty_cache()
        missing = [k for k in FORWARD + SCAN_BACKWARD if launches[k] == 0]
        backward = [k for k in SCAN_BACKWARD if eval_launches[k]]
        if not rerun or not np.all(np.isfinite(losses)) or missing or \
                not np.isfinite(miou) or backward or \
                any(eval_launches[k] == 0 for k in FORWARD):
            raise AssertionError(
                f"decoders {name}: rerun {rerun}, losses {losses}, kernels "
                f"not launched {missing}, mIoU {miou}, backward kernels in "
                f"eval {backward}")
        out[name] = dict(s_step=s_step, img_s=img_s, peak=peak,
                         eval_peak=eval_peak)

    # sigma_test: the card's step against the CPU's
    cfg_t = get_config("mfnet")
    small = synthetic_batch(np.random.default_rng(SEED + 6),
                            DECODER_CHECK_BATCH, 64, 80)
    for decoder, ds in DECODER_CASES:
        name = decoder + (" + deep supervision" if ds else "")
        cpu = init_parameters(EncoderDecoder(9, "sigma_test", decoder,
                                             deep_supervision=ds),
                              seed=SEED + 4)
        for m in cpu.modules():  # the CPU and CUDA generators differ
            if isinstance(m, (DropPath, Dropout)):
                m.rate = 0.0
        gpu = copy.deepcopy(cpu).to(device)
        got = {}
        for where, m in (("cpu", cpu), ("gpu", gpu)):
            o = build_optimizer(cfg_t, m)
            loss = make_train_step(m, o, lambda k: 0.0)(
                create_train_state(m, o), small)
            got[where] = _state_bits(m, loss)
        (l_c, g_c, b_c), (l_g, g_g, b_g) = got["cpu"], got["gpu"]
        l_err, l_ok = _scaled_err(l_g.cpu(), l_c)
        g_errs = [_scaled_err(g_g[k].cpu(), v) for k, v in g_c.items()]
        b_errs = [_scaled_err(b_g[k].cpu(), v) for k, v in b_c.items()] \
            or [(0.0, True)]
        ok = l_ok and all(o for _, o in g_errs + b_errs) and \
            g_g.keys() == g_c.keys()
        print(f"decoders: sigma_test/{name} 64x80 batch "
              f"{DECODER_CHECK_BATCH}, one step card vs CPU: loss "
              f"{float(l_g):.6f} vs {float(l_c):.6f}, max abs err loss "
              f"{l_err:.3e}, {len(g_errs)} gradients "
              f"{max(e for e, _ in g_errs):.3e}, {len(b_c)} running "
              f"statistics {max(e for e, _ in b_errs):.3e} (fp32 tier "
              f"{'ok' if ok else 'FAIL'})", flush=True)
        if not ok:
            raise AssertionError(f"decoders {name}: the card's sigma_test "
                                 f"step differs from the CPU's")
    print(f"decoders: phase {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return out


# the backbones phase: (backbone, decoder) at full width, built as the
# train CLI builds them (`--override backbone=... decoder=...`)
BACKBONE_CASES = (("swin_s", "MambaDecoder"), ("mit_b2", "MLPDecoder"))
# VSSMClassifier at VMamba-T widths, 224x224, batch 8
CLASSIFIER = dict(num_classes=1000, depths=(2, 2, 9, 2),
                  dims=(96, 192, 384, 768), d_state=16)
CLASSIFIER_BATCH = 8
# the card-vs-CPU checks at the CPU tests' widths
# (tests/test_torch_port_backbones.py): a Swin variant at 16-128
# (registered for the phase only), mit_b0 with MLPDecoder at width 32,
# the classifier at depths 1 and dims 16-128
SWIN_CHECK = dict(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8),
                  window_size=4)
BACKBONE_CHECKS = (("swin_check", "MambaDecoder", 512),
                   ("mit_b0", "MLPDecoder", 32))
CLASSIFIER_CHECK = dict(num_classes=10, depths=(1, 1, 1, 1),
                        dims=(16, 32, 64, 128), d_state=8)


def _no_dropout(model):
    from sigma_tpu_torch.models.common import DropPath, Dropout

    for m in model.modules():  # the CPU and CUDA generators differ
        if isinstance(m, (DropPath, Dropout)):
            m.rate = 0.0
    return model


def _classifier_step(model, x, labels):
    """Logits, loss and gradients of one forward + backward of `model`
    (CE over the labels)."""
    import torch.nn.functional as F

    model.zero_grad(set_to_none=True)
    logits = model(x)
    loss = F.cross_entropy(logits.float(), labels)
    loss.backward()
    return logits.detach(), loss.detach()


def backbones_phase(device, card, steps=3, reps=3):
    """The MiT and Swin dual encoders and the VSSM classifier, fp32,
    seeded. For each of BACKBONE_CASES at full width under the MFNet
    preset (480x640, 9 classes), built by `build_train` as the train CLI
    builds it: the first step run twice from the same state (loss, every
    gradient and every BatchNorm buffer the same bits: Swin's bias gather
    is a product, ROADMAP C10's convolutions deterministic); `steps`
    steps at batch 2 with the launch counts zeroed before and read after
    (s/step of the last two, peak memory); the model in eval mode through
    SlidingEvaluator.run on four seeded images (img/s, peak memory). Swin
    + MambaDecoder must launch K2 + K4 + K5 in training and K2 and no
    backward kernel in eval; MiT + MLPDecoder no scan kernel. Then
    VSSMClassifier at VMamba-T widths, 224x224, batch 8: a forward and a
    backward (ms, peak memory, launches: K2 at stages 0-2, K1 at stage
    3, K4 + K5 and K3), rerun bit for bit. Then each at the CPU tests'
    widths, one step on the card against the same step on the CPU from
    the same weights and batch (dropout and drop path 0, lr 0): loss,
    gradients, running statistics at the fp32 tier. Returns {name:
    metrics}; raises on a failed check."""
    import copy

    import numpy as np
    import torch

    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.engine.evaluator import SlidingEvaluator
    from sigma_tpu_torch.engine.optim import build_optimizer
    from sigma_tpu_torch.engine.train import (
        build_train,
        create_train_state,
        make_train_step,
    )
    from sigma_tpu_torch.models.builder import EncoderDecoder, init_parameters
    from sigma_tpu_torch.models.swin_encoder import SWIN_VARIANTS
    from sigma_tpu_torch.models.vssm import VSSMClassifier
    from sigma_tpu_torch.trace_step import TRAIN_BATCH as batch_n
    from sigma_tpu_torch.trace_step import synthetic_batch

    t_phase = time.perf_counter()
    base = get_config("mfnet")
    h, w = base.image_height, base.image_width
    rng = np.random.default_rng(SEED + 7)
    batches = [synthetic_batch(rng, batch_n, h, w) for _ in range(steps)]
    data = _SyntheticMFNet(4, h, w, SEED)
    out = {}
    for backbone, decoder in BACKBONE_CASES:
        name = f"{backbone}/{decoder}"
        cfg = get_config("mfnet", backbone=backbone, decoder=decoder)
        t0 = time.perf_counter()
        state, step, _ = build_train(cfg, device)
        model, opt = state.model, state.optimizer
        build_s = time.perf_counter() - t0
        model_0 = {k: v.clone() for k, v in model.state_dict().items()}
        opt_0 = copy.deepcopy(opt.state_dict())

        def restart():
            model.load_state_dict(model_0)
            opt.load_state_dict(opt_0)
            state.step = 0

        runs = []
        for _ in range(2):
            restart()
            runs.append(_state_bits(model, step(state, batches[0])))
        rerun = all(torch.equal(a, b) for a, b in
                    [(runs[0][0], runs[1][0])]
                    + [(v, runs[1][i][k]) for i in (1, 2)
                       for k, v in runs[0][i].items()])
        n_bn = sum(k.endswith("running_var") for k in runs[0][2])
        del runs
        restart()
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
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        s_step = sum(seconds[1:]) / len(seconds[1:])

        model.eval()
        ev = SlidingEvaluator(
            model, cfg.num_classes, cfg.norm_mean, cfg.norm_std,
            multi_scales=cfg.eval_scale_array, is_flip=cfg.eval_flip,
            eval_crop_size=cfg.eval_crop_size,
            stride_rate=cfg.eval_stride_rate, device=device)
        ev.sliding_eval(data[0]["data"], data[0]["modal_x"])  # warm-up
        torch.cuda.reset_peak_memory_stats(device)
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        miou, _ = ev.run(data)
        torch.cuda.synchronize()
        img_s = len(data) / (time.perf_counter() - t0)
        eval_launches = _launches()
        eval_peak = torch.cuda.max_memory_allocated(device) / 2**30
        print(f"backbones: {name} MFNet {h}x{w} fp32, "
              f"{sum(p.numel() for p in model.parameters())} params, "
              f"{n_bn} BatchNorms, built in {build_s:.2f}s: first step "
              f"rerun {'bit for bit' if rerun else 'with OTHER bits'}; "
              f"{steps} steps at batch {batch_n}: losses {losses}, seconds "
              f"{[round(t, 4) for t in seconds]}, last {steps - 1} "
              f"{s_step:.4f} s/step, peak {peak:.3f} GiB, launches "
              f"{ {k: n for k, n in launches.items() if n} }; eval of "
              f"{len(data)} images {img_s:.4f} img/s, mIoU {miou:.4f} "
              f"(random weights), peak {eval_peak:.3f} GiB, launches "
              f"{ {k: n for k, n in eval_launches.items() if n} }; {card}",
              flush=True)
        del state, step, model, opt, model_0, ev
        torch.cuda.empty_cache()
        if decoder == "MambaDecoder":
            want_train = ("scan_proj_fwd", "scan_proj_bwd", "proj_grad")
            bad = [k for k in want_train if launches[k] == 0] + \
                [k for k in SCAN_BACKWARD if eval_launches[k]]
            if eval_launches["scan_proj_fwd"] == 0:
                bad.append("scan_proj_fwd in eval")
        else:
            bad = [k for k in FORWARD + SCAN_BACKWARD
                   if launches[k] or eval_launches[k]]
        if not rerun or not np.all(np.isfinite(losses)) or bad or \
                not np.isfinite(miou):
            raise AssertionError(
                f"backbones {name}: rerun {rerun}, losses {losses}, launch "
                f"counts off {bad}, mIoU {miou}")
        out[name] = dict(s_step=s_step, img_s=img_s, peak=peak,
                         eval_peak=eval_peak)

    # the classifier at VMamba-T widths
    cls = init_parameters(VSSMClassifier(**CLASSIFIER), seed=SEED + 8)
    cls = _no_dropout(cls).to(device).train()
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    x = torch.randn(CLASSIFIER_BATCH, 224, 224, 3, device=device,
                    generator=gen)
    labels = torch.randint(0, CLASSIFIER["num_classes"], (CLASSIFIER_BATCH,),
                           device=device, generator=gen)
    runs = []
    for _ in range(2):
        logits, loss = _classifier_step(cls, x, labels)
        runs.append((logits, loss, {k: p.grad.clone()
                                    for k, p in cls.named_parameters()}))
    rerun = torch.equal(runs[0][0], runs[1][0]) and all(
        torch.equal(v, runs[1][2][k]) for k, v in runs[0][2].items())
    del runs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _reset_launches()
    t0 = time.perf_counter()
    for _ in range(reps):
        logits, loss = _classifier_step(cls, x, labels)
    torch.cuda.synchronize()
    cls_ms = (time.perf_counter() - t0) / reps * 1e3
    cls_launches = _launches()
    cls_peak = torch.cuda.max_memory_allocated(device) / 2**30
    n_cls = sum(p.numel() for p in cls.parameters())
    print(f"backbones: VSSMClassifier VMamba-T ({n_cls} params) 224x224 "
          f"batch {CLASSIFIER_BATCH} fp32: forward + backward "
          f"{cls_ms:.2f} ms (mean of {reps}), peak {cls_peak:.3f} GiB, "
          f"loss {float(loss):.4f}, launches per forward + backward "
          f"{ {k: n // reps for k, n in cls_launches.items() if n} }; rerun "
          f"{'bit for bit' if rerun else 'with OTHER bits'}; {card}",
          flush=True)
    missing = [k for k in FORWARD + SCAN_BACKWARD if cls_launches[k] == 0]
    if not rerun or missing or not torch.isfinite(logits).all() or \
            logits.shape != (CLASSIFIER_BATCH, CLASSIFIER["num_classes"]):
        raise AssertionError(f"backbones classifier: rerun {rerun}, kernels "
                             f"not launched {missing}, logits "
                             f"{tuple(logits.shape)}")
    out["VSSMClassifier"] = dict(ms=cls_ms, peak=cls_peak)
    del cls, x, logits
    torch.cuda.empty_cache()

    # the CPU tests' widths: the card's step against the CPU's
    cfg_t = get_config("mfnet")
    small = synthetic_batch(np.random.default_rng(SEED + 10),
                            DECODER_CHECK_BATCH, 64, 80)
    SWIN_VARIANTS["swin_check"] = SWIN_CHECK
    try:
        for backbone, decoder, width in BACKBONE_CHECKS:
            cpu = _no_dropout(init_parameters(EncoderDecoder(
                9, backbone, decoder, decoder_embed_dim=width),
                seed=SEED + 11))
            gpu = copy.deepcopy(cpu).to(device)
            got = {}
            for where, m in (("cpu", cpu), ("gpu", gpu)):
                o = build_optimizer(cfg_t, m)
                loss = make_train_step(m, o, lambda k: 0.0)(
                    create_train_state(m, o), small)
                got[where] = _state_bits(m, loss)
            _check_card_vs_cpu(f"{backbone}/{decoder}", "64x80 batch "
                               f"{DECODER_CHECK_BATCH}", got, card)
    finally:
        del SWIN_VARIANTS["swin_check"]
    cpu = _no_dropout(init_parameters(VSSMClassifier(**CLASSIFIER_CHECK),
                                      seed=SEED + 12)).train()
    gpu = copy.deepcopy(cpu).to(device)
    x = torch.from_numpy(np.random.default_rng(SEED + 13).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    labels = torch.tensor([1, 7])
    got = {}
    for where, m in (("cpu", cpu), ("gpu", gpu)):
        dev = next(m.parameters()).device
        logits, loss = _classifier_step(m, x.to(dev), labels.to(dev))
        got[where] = (loss, {k: p.grad for k, p in m.named_parameters()},
                      {"logits": logits})
    _check_card_vs_cpu("VSSMClassifier depths 1, dims 16-128",
                       "32x32 batch 2", got, card)
    print(f"backbones: phase {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return out


def _check_card_vs_cpu(name, at, got, card):
    """(loss, gradients, tensors) of one step on the CPU and the card at
    the fp32 tier; raises if they differ."""
    (l_c, g_c, b_c), (l_g, g_g, b_g) = got["cpu"], got["gpu"]
    l_err, l_ok = _scaled_err(l_g.cpu(), l_c)
    g_errs = [_scaled_err(g_g[k].cpu(), v) for k, v in g_c.items()]
    b_errs = [_scaled_err(b_g[k].cpu(), v) for k, v in b_c.items()] \
        or [(0.0, True)]
    ok = l_ok and all(o for _, o in g_errs + b_errs) and \
        g_g.keys() == g_c.keys()
    print(f"backbones: {name} {at}, one step card vs CPU: loss "
          f"{float(l_g):.6f} vs {float(l_c):.6f}, max abs err loss "
          f"{l_err:.3e}, {len(g_errs)} gradients "
          f"{max(e for e, _ in g_errs):.3e}, {len(b_c)} running statistics "
          f"or outputs {max(e for e, _ in b_errs):.3e} (fp32 tier "
          f"{'ok' if ok else 'FAIL'}); {card}", flush=True)
    if not ok:
        raise AssertionError(f"backbones {name}: the card's step differs "
                             f"from the CPU's")


def _write_tree(cfg, n, seed, labels):
    """A seeded dataset tree of `n` pairs at cfg's folders and image size,
    written by the port's PNG writer: RGB, a 1-channel modal-x, labels in
    [0, labels) (the first rows ignored: 255, or 0 where cfg shifts the
    labels by one), every name in the train and eval lists. Where cfg's
    RGB images are JPEG (NYU, SUN-RGBD) they are copies of the 480x640
    JPEG fixtures (`JPEG_SCENES`, in turn). Returns {path: the array
    written} of the PNGs."""
    import shutil

    import numpy as np

    from sigma_tpu_torch.data.png import write_png

    s = cfg.data_setting()
    rng = np.random.default_rng(seed)
    h, w = cfg.image_height, cfg.image_width
    names = [f"f{i:02d}" for i in range(n)]
    written = {}
    for root in (s["rgb_root"], s["x_root"], s["gt_root"]):
        os.makedirs(root, exist_ok=True)
    for i, name in enumerate(names):
        label = rng.integers(0, labels, (h, w)).astype(np.uint8)
        label[:4] = 0 if cfg.gt_transform else 255
        for root, fmt, img in (
                (s["rgb_root"], s["rgb_format"],
                 rng.integers(0, 256, (h, w, 3), dtype=np.uint8)),
                (s["x_root"], s["x_format"],
                 rng.integers(0, 256, (h, w), dtype=np.uint8)),
                (s["gt_root"], s["gt_format"], label)):
            path = os.path.join(root, name + fmt)
            if fmt in (".jpg", ".jpeg"):
                shutil.copyfile(JPEG_FIXTURES / JPEG_SCENES[i % 2], path)
                continue
            write_png(path, img)
            written[path] = img
    for source in (s["train_source"], s["eval_source"]):
        with open(source, "w") as f:
            f.write("\n".join(names) + "\n")
    return written


def _eval_cli(argv, tag):
    """`python -m sigma_tpu_torch.eval` in this process (its printed IoU
    table kept back): images, seconds and mIoU of each of its evaluator
    runs (one a checkpoint), the launches; raises unless K1 and K2 ran and
    no backward kernel did. Returns [(img/s, mIoU)] a run."""
    import contextlib
    import io

    import numpy as np
    import torch

    from sigma_tpu_torch import eval as eval_cli
    from sigma_tpu_torch.engine.evaluator import SlidingEvaluator

    runs, orig = [], SlidingEvaluator.run

    def timed(self, dataset, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(self, dataset, *args, **kwargs)
        torch.cuda.synchronize()
        runs.append((len(dataset), time.perf_counter() - t0, out[0]))
        return out

    SlidingEvaluator.run = timed
    _reset_launches()
    table = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(table):
            rc = eval_cli.main(argv)
    finally:
        SlidingEvaluator.run = orig
    wall = time.perf_counter() - t0
    launches = _launches()
    means = [line for line in table.getvalue().splitlines()
             if line.startswith("mean IoU")]
    for (n, seconds, miou), mean in zip(runs, means):
        print(f"files: {tag} eval CLI rc {rc}: {n} images in {seconds:.3f}s"
              f" = {n / seconds:.4f} img/s (the CLI {wall:.2f}s with the "
              f"model's build and load), mIoU {miou:.4f} (random weights; "
              f"{mean}), launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if rc != 0 or not runs or not np.all(np.isfinite([r[2] for r in runs])):
        raise AssertionError(f"{tag}: eval CLI rc {rc}, runs {runs}")
    missing = [k for k in FORWARD if launches[k] == 0]
    backward = [k for k in SCAN_BACKWARD + EPILOGUE[1:] + OPS[1:] + IMAGE[1:]
                if launches[k]]
    if missing or backward:
        raise AssertionError(f"{tag}: kernels not launched {missing}, "
                             f"backward kernels launched {backward}")
    return [(n / seconds, miou) for n, seconds, miou in runs]


def _check_saved(out_dir, names, shape, num_classes):
    """The eval CLI's `-p` PNGs, read back by the port's reader."""
    import os

    from sigma_tpu_torch.data.png import read_png

    for name in names:
        pred = read_png(os.path.join(out_dir, name + ".png"), gray=True)
        color = read_png(os.path.join(out_dir + "_color", name + ".png"))
        if pred.shape != shape or color.shape != shape + (3,) or \
                pred.max() >= num_classes:
            raise AssertionError(f"saved prediction {name}: {pred.shape} "
                                 f"{color.shape} max {pred.max()}")


def _released_vmamba(depths, dims, seed, d_state=16, ssm_ratio=2):
    """A VMamba ImageNet checkpoint's tensors in the released key scheme
    (patch_embed.proj / .norm, ln_1, self_attention, downsample, and a
    classifier the trunk drops), seeded: {name: CPU fp32 tensor}."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sd = {}

    def add(k, *shape):
        sd[k] = torch.from_numpy(
            (rng.standard_normal(shape) * 0.02).astype(np.float32))

    add("patch_embed.proj.weight", dims[0], 3, 4, 4)
    add("patch_embed.proj.bias", dims[0])
    add("patch_embed.norm.weight", dims[0])
    add("patch_embed.norm.bias", dims[0])
    for i, depth in enumerate(depths):
        d = dims[i]
        di, r = ssm_ratio * d, -(-d // 16)
        for j in range(depth):
            b = f"layers.{i}.blocks.{j}"
            add(f"{b}.ln_1.weight", d)
            add(f"{b}.ln_1.bias", d)
            sa = f"{b}.self_attention"
            add(f"{sa}.in_proj.weight", 2 * di, d)
            add(f"{sa}.conv2d.weight", di, 1, 3, 3)
            add(f"{sa}.conv2d.bias", di)
            add(f"{sa}.x_proj_weight", 4, r + 2 * d_state, di)
            add(f"{sa}.dt_projs_weight", 4, di, r)
            add(f"{sa}.dt_projs_bias", 4, di)
            add(f"{sa}.A_logs", 4 * di, d_state)
            add(f"{sa}.Ds", 4 * di)
            add(f"{sa}.out_norm.weight", di)
            add(f"{sa}.out_norm.bias", di)
            add(f"{sa}.out_proj.weight", d, di)
        if i < len(depths) - 1:
            add(f"layers.{i}.downsample.norm.weight", 4 * d)
            add(f"layers.{i}.downsample.norm.bias", 4 * d)
            add(f"layers.{i}.downsample.reduction.weight", dims[i + 1], 4 * d)
    add("classifier.norm.weight", dims[-1])
    add("classifier.norm.bias", dims[-1])
    add("classifier.head.weight", 1000, dims[-1])
    add("classifier.head.bias", 1000)
    return sd


# the released trunk names and the port's (the reference's remap)
_RELEASED_TO_PORT = ((".self_attention.", ".op."), (".ln_1.", ".norm."),
                     ("patch_embed.proj.", "patch_embed.0."),
                     ("patch_embed.norm.", "patch_embed.2."))


# the port's JPEG fixtures, written by cv2.imwrite, and the sha256 of what
# `cv2.imread` gives for each, colour (RGB order) and gray, recorded on a
# host with cv2 (`tests/fixtures/jpeg/make_fixtures.py`; held there by
# `tests/test_torch_port_jpeg.py`)
JPEG_FIXTURES = ROOT / "tests" / "fixtures" / "jpeg"
JPEG_SCENES = ("scene_420_q95_480x640_a.jpg", "scene_420_q95_480x640_b.jpg")
JPEG_PROGRESSIVE = "prog_scene_420_q95_480x640.jpg"


def jpeg_part():
    """The port's JPEG decoder (`data/jpeg.py`, host C++ built with g++ at
    first use) on every committed fixture, colour and gray, against the
    digests of cv2.imread's arrays (sequential and progressive files); the
    build's seconds, the host ms of a 480x640 4:2:0 decode, sequential and
    progressive, and 16 decodes on 8 threads against one thread
    (ctypes releases the GIL). Returns {metric: value}; raises on a digest
    that differs."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from sigma_tpu_torch.data import jpeg

    out = {}
    t0 = time.perf_counter()
    jpeg._library()
    out["jpeg_build_s"] = time.perf_counter() - t0
    digests = json.loads((JPEG_FIXTURES / "digests.json").read_text())
    bad = []
    for name, want in sorted(digests.items()):
        for gray in (False, True):
            got = jpeg.read_jpeg(JPEG_FIXTURES / name, gray=gray)
            sha = hashlib.sha256(got.tobytes()).hexdigest()
            if sha != want["gray" if gray else "color"] or \
                    list(got.shape[:2]) != want["shape"][:2]:
                bad.append((name, "gray" if gray else "color"))
    big = JPEG_FIXTURES / JPEG_SCENES[0]
    for key, path, gray in (("rgb", big, False), ("gray", big, True),
                            ("prog", JPEG_FIXTURES / JPEG_PROGRESSIVE,
                             False)):
        jpeg.read_jpeg(path, gray=gray)
        t0 = time.perf_counter()
        for _ in range(20):
            jpeg.read_jpeg(path, gray=gray)
        out[f"jpeg_ms_{key}"] = (time.perf_counter() - t0) / 20 * 1e3
    paths = [JPEG_FIXTURES / JPEG_SCENES[i % 2] for i in range(16)]
    t0 = time.perf_counter()
    for p in paths:
        jpeg.read_jpeg(p)
    one = time.perf_counter() - t0
    with ThreadPoolExecutor(8) as pool:
        t0 = time.perf_counter()
        list(pool.map(jpeg.read_jpeg, paths))
        eight = time.perf_counter() - t0
    out["jpeg_threads_speedup"] = one / eight
    print(f"files: jpeg: decoder built in {out['jpeg_build_s']:.2f}s; "
          f"{2 * len(digests)} decodes of {len(digests)} fixtures (colour "
          f"and gray) against cv2.imread's digests: "
          f"{'all equal' if not bad else f'DIFFER {bad}'}; {big.name} "
          f"{out['jpeg_ms_rgb']:.2f} host ms RGB, {out['jpeg_ms_gray']:.2f}"
          f" gray, progressive {JPEG_PROGRESSIVE} {out['jpeg_ms_prog']:.2f}"
          f" RGB; 16 decodes {one * 1e3:.1f} ms on one thread, "
          f"{eight * 1e3:.1f} ms on 8 ({out['jpeg_threads_speedup']:.2f}x)",
          flush=True)
    if bad:
        raise AssertionError(f"JPEG decodes differ from cv2's: {bad}")
    return out


# the data-parallel part: a 4-image evaluation and 2 train steps at
# sigma_tiny 480x640, global batch 2 (one sample a rank)
DDP_EVAL_IMAGES = 4
DDP_STEPS = 2


def _ddp_cfg(dataset_path):
    """MFNet at global batch 2, with lr 1e-3 from the first step (no
    warmup): MFNet's own schedule starts at lr 0 and then 1e-8, under
    which the weights of 2 steps barely move."""
    from sigma_tpu_torch.configs import get_config

    cfg = get_config("mfnet", dataset_path=dataset_path)
    for field, value in (("batch_size", 2), ("lr", 1e-3),
                         ("warm_up_epoch", 0)):
        object.__setattr__(cfg, field, value)
    return cfg


def _ddp_run(cfg, device):
    """What each rank of the data-parallel part runs, and the script's
    one-process run (no process group): the seeded model evaluated on the
    first DDP_EVAL_IMAGES val images (this rank's share; the confusion
    matrix recorded after the all-reduce), then DDP_STEPS train steps on
    this rank's shard of seeded global batches. Returns the record and the
    model, its parameters' `.grad` the last step's (all-reduced in a
    rank)."""
    import numpy as np
    import torch

    from sigma_tpu_torch.data import RGBXDataset, ValPre
    from sigma_tpu_torch.engine import evaluator as ev_mod
    from sigma_tpu_torch.engine.train import build_train
    from sigma_tpu_torch.parallel import dist
    from sigma_tpu_torch.trace_step import synthetic_batch

    state, step, _ = build_train(cfg, device)
    model = state.model.eval()
    val = RGBXDataset(cfg.data_setting(), "val", ValPre())

    class First:
        def __len__(self):
            return DDP_EVAL_IMAGES

        def __getitem__(self, i):
            return val[i]

    seen, orig = {}, ev_mod.compute_score

    def recording(hist, correct, labeled):
        seen["hist"] = hist.tolist()
        return orig(hist, correct, labeled)

    ev_mod.compute_score = recording
    try:
        miou, _ = ev_mod.SlidingEvaluator(
            model, cfg.num_classes, cfg.norm_mean, cfg.norm_std,
            multi_scales=cfg.eval_scale_array, is_flip=cfg.eval_flip,
            eval_crop_size=cfg.eval_crop_size,
            stride_rate=cfg.eval_stride_rate, device=device).run(First())
    finally:
        ev_mod.compute_score = orig
    shard, shards = dist.rank(), dist.world()
    n = cfg.batch_size // shards
    rec = dict(rank=shard, world=shards, miou=miou, hist=seen["hist"],
               losses=[], seconds=[])
    _reset_launches()
    for k in range(DDP_STEPS):
        batch = synthetic_batch(np.random.default_rng(SEED + 70 + k),
                                cfg.batch_size, cfg.image_height,
                                cfg.image_width)
        batch = {key: v[shard * n:(shard + 1) * n] for key, v in
                 batch.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec["losses"].append(float(step(state, batch)))
        torch.cuda.synchronize()
        rec["seconds"].append(time.perf_counter() - t0)
    rec["launches"] = _launches()
    rec["no_grad"] = [k for k, p in model.named_parameters()
                      if p.grad is None]
    return rec, model


# the BatchNorm run of the data-parallel part takes one step: after it,
# AdamW's first update moves each weight by about lr whatever its
# gradient's size, and a conv bias ahead of a BatchNorm has a zero
# gradient in exact arithmetic, so rounding noise sets the sign of its
# move, and two runs that sum in another order part by about 2 lr there
# (6.3e-2 of the second step's gradient norm at lr 1e-3 on the card)
DDP_BN_STEPS = 1
# and its global batch: 3 a rank, as tests/test_torch_port_ddp.py runs
# it. UPerHead's 1x1-pool BatchNorm sees one value per channel and
# sample, and with 2 samples fp32 rounding alone moves the gradient by
# percents (the port on the CPU in fp32 against fp64: 4% of its norm at
# sigma_test); at 1 a rank the card's two ranks gave 6.756e-04 of the
# one-process norm, at 3 a rank the CPU test gives 1.9e-06
DDP_BN_BATCH = 6


def _ddp_bn_run(cfg, device):
    """The data-parallel part's BatchNorm run: `cfg` with UPernet
    (BatchNorm in every ConvBNReLU, the FCN aux head), DDP_BN_STEPS train
    steps on this rank's shard of seeded global batches (one process: the
    whole batch). Returns (losses, {name: the last step's gradient},
    {name: running statistic}), on the host."""
    import dataclasses

    import numpy as np

    from sigma_tpu_torch.engine.train import build_train
    from sigma_tpu_torch.parallel import dist
    from sigma_tpu_torch.trace_step import synthetic_batch

    cfg = dataclasses.replace(cfg, decoder="UPernet",
                              batch_size=DDP_BN_BATCH)
    state, step, _ = build_train(cfg, device)
    shard, shards = dist.rank(), dist.world()
    n = cfg.batch_size // shards
    losses = []
    for k in range(DDP_BN_STEPS):
        batch = synthetic_batch(np.random.default_rng(SEED + 80 + k),
                                cfg.batch_size, cfg.image_height,
                                cfg.image_width)
        losses.append(float(step(state, {
            key: v[shard * n:(shard + 1) * n] for key, v in batch.items()})))
    model = state.model
    return (losses, {k: p.grad.detach().cpu() for k, p in
                     model.named_parameters() if p.grad is not None},
            {k: b.detach().cpu() for k, b in model.named_buffers()})


def _ddp_worker(argv):
    """A rank of the data-parallel part, run by this script in a process
    of its own (`--ddp-worker MODE OUT ...`): MODE `cli` runs the train
    CLI's main under torchrun with its steps timed and its launches
    counted; MODE `step` joins a gloo group of two ranks on cuda:0
    (RANK, WORLD_SIZE, MASTER_PORT from the script) and runs `_ddp_run`.
    Writes OUT (JSON; `step`: rank 0 also OUT.pt, its weights and the
    last step's gradients)."""
    import torch

    sys.path.insert(0, str(ROOT))
    sys.modules["cv2"] = None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    mode, out = argv[0], argv[1]
    if mode == "cli":
        from sigma_tpu_torch.engine import train as train_engine
        from sigma_tpu_torch.train import main as train_main

        rec = dict(losses=[], seconds=[])
        orig = train_engine.build_train

        def build_train(cfg, device="cuda"):
            state, step, schedule = orig(cfg, device)
            rec.update(backend=torch.distributed.get_backend(),
                       world=torch.distributed.get_world_size(),
                       device=str(device))

            def timed_step(st, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = step(st, batch)
                rec["losses"].append(float(loss))
                torch.cuda.synchronize()
                rec["seconds"].append(time.perf_counter() - t0)
                return loss

            return state, timed_step, schedule

        train_engine.build_train = build_train
        _reset_launches()
        rec["rc"] = train_main(argv[2:])
        rec["launches"] = _launches()
    else:
        import torch.distributed as tdist

        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        tdist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
            rank=rank, world_size=world)
        try:
            rec, model = _ddp_run(_ddp_cfg(argv[2]), torch.device("cuda", 0))
            rec["backend"] = tdist.get_backend()
            if rank == 0:
                torch.save({"weights": {k: v.cpu() for k, v in
                                        model.state_dict().items()},
                            "grads": {k: p.grad.cpu() for k, p in
                                      model.named_parameters()
                                      if p.grad is not None}},
                           out + ".pt")
            del model
            torch.cuda.empty_cache()
            losses, grads, stats = _ddp_bn_run(_ddp_cfg(argv[2]),
                                               torch.device("cuda", 0))
            rec["bn_losses"] = losses
            torch.save({"grads": grads, "stats": stats},
                       f"{out}.bn{rank}.pt")
        finally:
            tdist.destroy_process_group()
        out = f"{out}.rank{rank}"
    with open(out, "w") as f:
        json.dump(rec, f)
    return 0


def _determinism_worker(argv):
    """ROADMAP C10, in a process of its own (`--determinism-worker
    OUT.json`; started with CUBLAS_WORKSPACE_CONFIG=:4096:8, which
    `torch.use_deterministic_algorithms` needs for cuBLAS and which must
    be set before cuBLAS starts). One fp32 sigma_tiny train step at
    480x640, batch 2 (`build_train`, the train phase's seeded batch), run
    twice from the same weights and AdamW state under each setting:
    PyTorch's default, `cudnn.deterministic`, and
    `use_deterministic_algorithms(True)` with it (an op that has no
    deterministic path raises; its message is kept, then the step is
    taken with warn_only to name every such op). Per setting: whether the
    loss and every gradient rerun bit for bit, the parameters whose
    gradient bits moved grouped by the kind of layer that owns them (the
    backward's first nondeterministic op moves every gradient it feeds:
    the ones that kept their bits lie between it and the loss), and
    s/step over 3 more steps. Writes OUT.json."""
    import warnings

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.engine.train import build_train
    from sigma_tpu_torch.trace_step import TRAIN_BATCH, synthetic_batch

    device = torch.device("cuda", 0)
    cfg = get_config("mfnet")
    batch = synthetic_batch(np.random.default_rng(SEED + 3), TRAIN_BATCH,
                            cfg.image_height, cfg.image_width)
    state, step, _ = build_train(cfg, device)
    model, opt = state.model, state.optimizer
    model_0 = {k: v.clone() for k, v in model.state_dict().items()}
    opt_0 = opt.state_dict()

    def kind(name):
        m = model.get_submodule(name.rsplit(".", 1)[0])
        if isinstance(m, torch.nn.Conv2d):
            return ("depthwise conv" if m.groups > 1 and
                    m.groups == m.in_channels else f"conv {m.kernel_size}")
        return type(m).__name__

    def once():
        model.load_state_dict(model_0)
        opt.load_state_dict(opt_0)
        state.step = 0
        loss = step(state, batch)
        return loss.detach().clone(), {
            k: p.grad.detach().clone() for k, p in model.named_parameters()}

    out = []
    for name, cudnn_det, algos in (("default", False, False),
                                   ("cudnn.deterministic", True, False),
                                   ("use_deterministic_algorithms", True,
                                    True)):
        torch.backends.cudnn.deterministic = cudnn_det
        rec = dict(setting=name, raised=None, warned=[])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if algos:
                torch.use_deterministic_algorithms(True)
                try:
                    once()
                except RuntimeError as e:
                    rec["raised"] = str(e).splitlines()[0][:300]
                    torch.use_deterministic_algorithms(True, warn_only=True)
            (l1, g1), (l2, g2) = once(), once()
            seconds = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                float(step(state, batch))
                seconds.append(time.perf_counter() - t0)
        rec["warned"] = sorted({str(w.message).splitlines()[0][:200]
                                for w in caught
                                if "determinis" in str(w.message)})
        moved = [k for k in g1 if not torch.equal(g1[k], g2[k])]
        kinds = defaultdict(int)
        for k in moved:
            kinds[kind(k)] += 1
        kept = [k for k in g1 if k not in moved]
        rec.update(loss_same=bool(torch.equal(l1, l2)), grads=len(g1),
                   grads_moved=len(moved), moved_kinds=dict(kinds),
                   kept=kept[:16], seconds=seconds,
                   s_step=float(np.mean(seconds[1:])))
        out.append(rec)
        torch.use_deterministic_algorithms(False)
    with open(argv[0], "w") as f:
        json.dump(out, f)
    return 0


def determinism_part(device, tmp):
    """ROADMAP C10: `_determinism_worker` in a child process; prints what
    it found and returns its records."""
    path = os.path.join(tmp, "determinism.json")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    _spawn([([sys.executable, str(ROOT / "chip_smoke.py"),
              "--determinism-worker", path], env)], tmp, "determinism")
    with open(path) as f:
        recs = json.load(f)
    for r in recs:
        print(f"determinism: {r['setting']}: a sigma_tiny 480x640 batch-2 "
              f"fp32 train step rerun from the same state: loss "
              f"{'same' if r['loss_same'] else 'other'} bits, "
              f"{r['grads_moved']} of {r['grads']} gradients with other "
              f"bits {r['moved_kinds']} (the same bits: {r['kept']}); "
              f"s/step {[round(t, 4) for t in r['seconds']]} mean of the "
              f"last 2 {r['s_step']:.4f}; raised {r['raised']!r}; warned "
              f"{r['warned']}", flush=True)
    print(f"determinism: part {time.perf_counter() - t0:.1f}s", flush=True)
    return recs


def _spawn(cmds, tmp, tag, timeout=600):
    """Run the commands [(argv, env)] together; wait for all (each killed
    at `timeout`); raise with the end of their output if one fails."""
    procs = []
    try:
        for i, (argv, env) in enumerate(cmds):
            log = open(os.path.join(tmp, f"{tag}_{i}.log"), "w+")
            procs.append((subprocess.Popen(argv, env=env, stdout=log,
                                           stderr=subprocess.STDOUT,
                                           cwd=str(ROOT)), log))
        deadline = time.monotonic() + timeout
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = []
    for proc, log in procs:
        log.seek(0)
        text = log.read()
        log.close()
        if proc.returncode != 0:
            failed.append(f"exit {proc.returncode}:\n{text[-4000:]}")
    if failed:
        raise AssertionError(f"ddp {tag}: " + "\n".join(failed))


def ddp_part(device, cfg, tmp):
    """Data-parallel training at full width on the card (sigma_tiny
    480x640, MFNet preset, fp32, global batch 2). (a) The train CLI under
    `python -m torch.distributed.run --nproc_per_node=1 ... --distributed`
    on the MFNet PNG tree: NCCL, 2 steps, one evaluation and one
    checkpoint; K1-K5 launched. (b) Two ranks that this script starts,
    both on cuda:0 over gloo (the machine has one card), through
    `build_train` and so `make_train_step`: each launches K1-K5; at lr
    1e-3 with no warmup, their losses, the last step's all-reduced
    gradient (relative to the one-process gradient's norm and largest
    entry: the check that holds DDP's all-reduce) and the weights after 2
    steps against this process's one-process run on the whole global
    batches at the fp32 tier (the ranks sum in another order),
    drop path at sigma_tiny's rate; the
    4-image evaluation split 2 / 2, its all-reduced confusion matrix equal
    to the one-process one; then the same ranks with UPernet (global-batch
    BatchNorm, the FCN aux head; DDP_BN_BATCH split 3 / 3), DDP_BN_STEPS
    step: its
    all-reduced gradient within FP32_TOL's rtol of the
    one-process gradient's norm, both ranks' running statistics at the
    fp32 tier. s/step of each and the gradient bytes DDP all-reduces a
    step. Returns {metric: value}; raises on a failed check.
    Gloo between two processes on one card is not NCCL between cards: (b)
    checks the arithmetic, not the speed of data parallelism."""
    import socket

    import numpy as np
    import torch

    out = {}
    t_part = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="4")

    # (a) the CLI under torchrun, NCCL
    log = os.path.join(tmp, "ddp_cli")
    rec_a = os.path.join(tmp, "ddp_cli.json")
    _spawn([([sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node=1", str(ROOT / "chip_smoke.py"),
              "--ddp-worker", "cli", rec_a, "-n", "mfnet", "--dataset-path",
              cfg.dataset_path, "--steps", "2", "--batch-size", "2",
              "--log-dir", log, "--override", "num_train_imgs=3",
              "--distributed"], env)], tmp, "cli")
    with open(rec_a) as f:
        a = json.load(f)
    ck_dir = os.path.join(log, "checkpoint")
    on_disk = sorted(os.listdir(ck_dir))
    with open(os.path.join(ck_dir, "val_scores.json")) as f:
        scores = json.load(f)
    missing = [k for k in FORWARD + SCAN_BACKWARD if a["launches"][k] == 0]
    out["ddp_cli_s_step"] = a["seconds"][-1]
    print(f"files: ddp (a) train CLI under torchrun, 1 process, backend "
          f"{a['backend']} on {a['device']}: rc {a['rc']}, losses "
          f"{a['losses']}, seconds {[round(t, 4) for t in a['seconds']]}, "
          f"checkpoint dir {on_disk}, val_scores {scores}, launches "
          f"{ {k: v for k, v in a['launches'].items() if v} }", flush=True)
    if a["rc"] != 0 or a["backend"] != "nccl" or len(a["losses"]) != 2 or \
            not np.all(np.isfinite(a["losses"])) or missing or \
            on_disk != ["epoch-1", "epoch-last", "val_scores.json"] or \
            len(scores) != 1 or not np.isfinite(scores[0][0]):
        raise AssertionError(f"ddp (a): the CLI run failed a check "
                             f"(kernels not launched {missing})")

    # (b) two gloo ranks on cuda:0 against this process
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    rec_b = os.path.join(tmp, "ddp_step")
    _spawn([([sys.executable, str(ROOT / "chip_smoke.py"), "--ddp-worker",
              "step", rec_b, cfg.dataset_path],
             dict(env, RANK=str(r), WORLD_SIZE="2", MASTER_PORT=str(port)))
            for r in range(2)], tmp, "step")
    ranks = []
    for r in range(2):
        with open(f"{rec_b}.rank{r}") as f:
            ranks.append(json.load(f))
    one, model = _ddp_run(_ddp_cfg(cfg.dataset_path), device)
    want = {k: v.detach() for k, v in model.state_dict().items()}
    saved = torch.load(rec_b + ".pt", weights_only=True)
    got = saved["weights"]
    errs = [_scaled_err(got[k].to(device), v) for k, v in want.items()]
    w_err, w_ok = max(e for e, _ in errs), all(ok for _, ok in errs)
    # the all-reduced gradient of the last step against one process's,
    # relative to the whole gradient's norm and to its largest entry
    want_g = {k: p.grad for k, p in model.named_parameters()
              if p.grad is not None}
    got_g = saved["grads"]
    g_sq = d_sq = 0.0
    g_max = d_max = 0.0
    for k, g in want_g.items():
        d = got_g[k].to(device).double() - g.double()
        g_sq += float(g.double().pow(2).sum())
        d_sq += float(d.pow(2).sum())
        g_max = max(g_max, float(g.abs().max()))
        d_max = max(d_max, float(d.abs().max()))
    g_rel, g_rel_max = (d_sq / g_sq) ** 0.5, d_max / g_max
    g_ok = set(got_g) == set(want_g) and max(g_rel, g_rel_max) <= \
        FP32_TOL[0]
    l_err, l_ok = _scaled_err(torch.tensor(ranks[0]["losses"]),
                              torch.tensor(one["losses"]))
    grad_bytes = sum(p.numel() * p.element_size()
                     for p in model.parameters() if p.requires_grad)
    del model, want, got, saved, want_g, got_g
    torch.cuda.empty_cache()
    missing = {r["rank"]: [k for k in FORWARD + SCAN_BACKWARD
                           if r["launches"][k] == 0] for r in ranks}
    hist_ok = all(r["hist"] == one["hist"] for r in ranks)
    for r in ranks:
        print(f"files: ddp (b) rank {r['rank']} of {r['world']} ({r['backend']}"
              f", cuda:0): losses {r['losses']}, seconds "
              f"{[round(t, 4) for t in r['seconds']]}, mIoU {r['miou']:.4f}"
              f", parameters without a gradient {r['no_grad']}, launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }",
              flush=True)
    print(f"files: ddp (b) one process, global batch 2: losses "
          f"{one['losses']}, seconds {[round(t, 4) for t in one['seconds']]}"
          f", mIoU {one['miou']:.4f}; rank losses max abs err {l_err:.3e}, "
          f"step {DDP_STEPS}'s all-reduced gradient relative err "
          f"{g_rel:.3e} (norm) / {g_rel_max:.3e} (largest entry) "
          f"{'ok' if g_ok else 'FAIL'} (<= {FP32_TOL[0]}), weights after "
          f"{DDP_STEPS} steps (lr 1e-3) max abs err {w_err:.3e} (fp32 "
          f"tier {'ok' if w_ok and l_ok else 'FAIL'}); the {DDP_EVAL_IMAGES}"
          f"-image evaluation split 2 / 2: confusion matrix "
          f"{'equal' if hist_ok else 'DIFFERS'}; gradient all-reduced a "
          f"step {grad_bytes} bytes ({grad_bytes / 2**20:.2f} MiB, fp32)",
          flush=True)
    if not (w_ok and l_ok and g_ok and hist_ok) or any(missing.values()) or \
            any(r["no_grad"] for r in ranks) or ranks[0]["losses"] != \
            ranks[1]["losses"]:
        raise AssertionError(f"ddp (b): two ranks differ from one process "
                             f"or missed a kernel ({missing})")
    # (b) with UPernet: BatchNorm's statistics over the global batch
    losses, want_g, want_s = _ddp_bn_run(_ddp_cfg(cfg.dataset_path), device)
    bn = [torch.load(f"{rec_b}.bn{r}.pt", weights_only=True)
          for r in range(2)]
    d_sq = sum(float((bn[0]["grads"][k].double() - g.double()).pow(2).sum())
               for k, g in want_g.items())
    g_sq = sum(float(g.double().pow(2).sum()) for g in want_g.values())
    bn_rel = (d_sq / g_sq) ** 0.5
    s_errs = [_scaled_err(b["stats"][k], v) for b in bn
              for k, v in want_s.items()]
    bn_l_err, bn_l_ok = _scaled_err(torch.tensor(ranks[0]["bn_losses"]),
                                    torch.tensor(losses))
    bn_ok = (bn_rel <= FP32_TOL[0] and bn_l_ok
             and all(o for _, o in s_errs) and len(s_errs) == 2 * 26
             and set(bn[0]["grads"]) == set(want_g))
    print(f"files: ddp (b) UPernet, batch {DDP_BN_BATCH // 2} a rank "
          f"against one process at batch {DDP_BN_BATCH}, {DDP_BN_STEPS} "
          f"step (lr 1e-3): losses "
          f"{ranks[0]['bn_losses']} / {ranks[1]['bn_losses']} vs {losses}"
          f" (max abs err {bn_l_err:.3e}), the step's all-reduced "
          f"gradient relative err {bn_rel:.3e} (norm, <= {FP32_TOL[0]}), "
          f"{len(want_s)} running statistics on both ranks max abs err "
          f"{max(e for e, _ in s_errs):.3e} (fp32 tier) "
          f"{'ok' if bn_ok else 'FAIL'}", flush=True)
    if not bn_ok:
        raise AssertionError("ddp (b): UPernet under two ranks differs "
                             "from one process")
    out.update(ddp_gloo_s_step=max(r["seconds"][-1] for r in ranks),
               ddp_one_s_step=one["seconds"][-1], ddp_grad_bytes=grad_bytes,
               ddp_grad_rel_err=g_rel, ddp_bn_grad_rel_err=bn_rel)
    print(f"files: ddp part {time.perf_counter() - t_part:.1f}s", flush=True)
    return out


def _ckpt_train(argv, tag, check_first=None):
    """`sigma_tpu_torch.train.main(argv)` in this process, its steps
    (synchronised by reading the loss), checkpoint saves, file writes,
    restores and prunes timed or recorded. `check_first(model)` runs
    before the first step. Returns the record; raises on a non-zero exit
    or a loss that is not finite."""
    import threading

    import numpy as np

    from sigma_tpu_torch.engine import checkpoint as ck
    from sigma_tpu_torch.engine import train as train_engine
    from sigma_tpu_torch.train import main as train_main

    rec = dict(seconds=[], losses=[], save_s=[], write_s=[], bg_write_s=[],
               restore_s=[], prunes=[])
    orig = {k: getattr(ck, k) for k in ("save_checkpoint", "_write",
                                        "restore_checkpoint",
                                        "prune_checkpoints")}
    orig_build = train_engine.build_train

    def build_train(cfg, device="cuda"):
        state, step, schedule = orig_build(cfg, device)

        def timed_step(st, batch):
            if check_first is not None and not rec["seconds"]:
                check_first(st.model)
            t0 = time.perf_counter()
            loss = step(st, batch)
            rec["losses"].append(float(loss))
            rec["seconds"].append(time.perf_counter() - t0)
            return loss

        return state, timed_step, schedule

    def timed(name, key):
        def fn(*args, **kwargs):
            t0 = time.perf_counter()
            out = orig[name](*args, **kwargs)
            dt = time.perf_counter() - t0
            if name == "_write" and \
                    threading.current_thread() is not threading.main_thread():
                rec["bg_write_s"].append(dt)
            else:
                rec[key].append(dt)
            return out
        return fn

    def prune(ckpt_dir, keep):
        # what the policy must spare: best-k, the pointer's target and an
        # in-flight async save
        pending = ck._ASYNC["pending"]
        rec["prunes"].append((sorted(keep), ck._pointer_epoch(ckpt_dir),
                              pending[2] if pending else None))
        return orig["prune_checkpoints"](ckpt_dir, keep)

    ck.save_checkpoint = timed("save_checkpoint", "save_s")
    ck._write = timed("_write", "write_s")
    ck.restore_checkpoint = timed("restore_checkpoint", "restore_s")
    ck.prune_checkpoints = prune
    train_engine.build_train = build_train
    try:
        rc = train_main(argv)
    finally:
        for k, v in orig.items():
            setattr(ck, k, v)
        train_engine.build_train = orig_build
    rec["s_step"] = float(np.mean(rec["seconds"]))
    print(f"files: ckpt {tag}: rc {rc}, losses {rec['losses']}, seconds "
          f"{[round(t, 4) for t in rec['seconds']]} ({rec['s_step']:.4f} "
          f"s/step), save blocking s {[round(t, 4) for t in rec['save_s']]}"
          f", file writes s {[round(t, 4) for t in rec['write_s']]} "
          f"(background {[round(t, 4) for t in rec['bg_write_s']]}), "
          f"restore s {[round(t, 4) for t in rec['restore_s']]}",
          flush=True)
    if rc != 0 or not np.all(np.isfinite(rec["losses"])):
        raise AssertionError(f"ckpt {tag}: rc {rc}, losses {rec['losses']}")
    return rec


def _ckpt_kept(ckpt_dir, rec, tag):
    """The epoch-N directories on disk against the policy: the last
    prune's best-k, the pointer's target when it ran and its in-flight
    async save, and the pointer's target now (each run ends with a
    checkpoint epoch, so its last prune follows its last save)."""
    import os

    from sigma_tpu_torch.engine import checkpoint as ck

    keep, pointed, pending = rec["prunes"][-1]
    want = set(keep) | {ck._pointer_epoch(ckpt_dir)} | \
        {e for e in (pointed, pending) if e is not None}
    got = set(ck._epoch_dirs(ckpt_dir))
    print(f"files: ckpt {tag}: epochs on disk {sorted(got)}; best-k "
          f"{keep}, pointer then {pointed}, in flight {pending}, pointer "
          f"now {ck._pointer_epoch(ckpt_dir)}", flush=True)
    leftovers = [n for n in os.listdir(ckpt_dir) if n.endswith(".tmp")]
    if got != want or leftovers:
        raise AssertionError(f"ckpt {tag}: epochs on disk {sorted(got)}, "
                             f"the policy keeps {sorted(want)}; temporary "
                             f"entries {leftovers}")


def ckpt_part(device, cfg, tmp):
    """Epoch checkpoints, `-c`, best-k pruning, the eval CLI's `-e` grammar
    and `--pretrained` on the MFNet PNG tree (cv2 blocked), sigma_tiny
    480x640, batch 2, fp32, 2 iterations an epoch (`num_train_imgs=3`), a
    checkpoint and an evaluation every epoch. First, A's first step run
    twice from the same seeded state: the same bits or not. Run A: 2
    epochs with async saves, K1-K5 launched. Run B: `--steps 2` (epoch 1),
    then `-c` (epoch 2): its weights, AdamW state and step against A's,
    bit for bit (the step reruns bit for bit: the convolutions are
    deterministic, ROADMAP C10). The epochs on disk after each run
    against the retention policy.
    `eval.main -e last` and `-e 1-` on A's checkpoints: the mIoU the
    train-time evaluation logged for each epoch, K1 / K2 and no backward
    kernel. `--pretrained`: a released-scheme VMamba trunk at sigma_tiny
    widths in a `model` envelope with a pickled namespace; every mapped
    tensor in the card's model before the first step, a finite loss.
    Returns {metric: value}; raises on a failed check."""
    import argparse
    import dataclasses
    import json
    import os

    import numpy as np
    import torch

    from sigma_tpu_torch.data import RGBXDataset, TrainLoader, TrainPre
    from sigma_tpu_torch.engine import checkpoint as ck
    from sigma_tpu_torch.engine.train import build_train
    from sigma_tpu_torch.models.sigma_encoder import SIGMA_VARIANTS

    out = {}
    t_part = time.perf_counter()
    logs = {k: os.path.join(tmp, f"ckpt_{k}") for k in ("a", "b", "pre")}
    cks = {k: os.path.join(v, "checkpoint") for k, v in logs.items()}
    common = ["-n", "mfnet", "--dataset-path", cfg.dataset_path,
              "--batch-size", "2", "--epochs", "2",
              "--override", "num_train_imgs=3",
              "--override", "checkpoint_start_epoch=1",
              "--override", "checkpoint_step=1"]

    def flat(model_sd, opt_sd):
        out = dict(model_sd)
        for i, s in opt_sd["state"].items():
            out.update({f"optimizer.{i}.{k}": v for k, v in s.items()})
        return out

    # does a train step rerun bit for bit on the card? A's first step, on
    # A's first batch, from two fresh seeded states
    c = dataclasses.replace(cfg, batch_size=2, num_train_imgs=3, nepochs=2)
    loader = TrainLoader(
        RGBXDataset(c.data_setting(), "train",
                    TrainPre(c.norm_mean, c.norm_std, c,
                             device_norm=c.device_norm),
                    file_length=c.batch_size * c.niters_per_epoch,
                    seed=c.seed),
        global_batch_size=c.batch_size, niters_per_epoch=c.niters_per_epoch,
        num_workers=c.num_workers, seed=c.seed)
    loader.set_epoch(1)
    batch = next(iter(loader))
    after = []
    for _ in range(2):
        state, step, _ = build_train(c, device)
        step(state, batch)
        after.append({k: v.detach().clone() for k, v in flat(
            state.model.state_dict(), state.optimizer.state_dict()).items()})
        del state, step
    bitwise = all(torch.equal(v, after[1][k]) for k, v in after[0].items())
    print(f"files: ckpt: a train step on the card, run twice from the same "
          f"state and batch, gives {'the same' if bitwise else 'other'} "
          f"bits ({len(after[0])} tensors; cuDNN deterministic, ROADMAP "
          f"C10)", flush=True)
    del after
    if not bitwise:
        raise AssertionError("ckpt: a train step with deterministic "
                             "convolutions does not rerun bit for bit")
    torch.cuda.empty_cache()

    _reset_launches()
    rec_a = _ckpt_train(common + ["--log-dir", logs["a"], "--override",
                                  "async_checkpoint=True"],
                        "A (2 epochs, async saves)")
    launches = _launches()
    missing = [k for k in FORWARD + SCAN_BACKWARD if launches[k] == 0]
    if missing or len(rec_a["seconds"]) != 4:
        raise AssertionError(f"ckpt A: {len(rec_a['seconds'])} steps, "
                             f"kernels not launched {missing}")
    _ckpt_kept(cks["a"], rec_a, "A")
    rec_b1 = _ckpt_train(common + ["--log-dir", logs["b"], "--steps", "2"],
                         "B1 (--steps 2)")
    _ckpt_kept(cks["b"], rec_b1, "B1")
    rec_b2 = _ckpt_train(common + ["--log-dir", logs["b"], "-c"], "B2 (-c)")
    _ckpt_kept(cks["b"], rec_b2, "B2")
    if (len(rec_b1["seconds"]), len(rec_b2["seconds"]),
            len(rec_b2["restore_s"])) != (2, 2, 1):
        raise AssertionError("ckpt B: not 2 + 2 steps with one restore")

    saved, meta = {}, {}
    for run in ("a", "b"):
        d = os.path.join(cks[run], "epoch-2")
        saved[run] = flat(
            torch.load(os.path.join(d, "model.pt"), weights_only=True),
            torch.load(os.path.join(d, "optimizer.pt"), weights_only=True))
        with open(os.path.join(d, "meta.json")) as f:
            meta[run] = json.load(f)
    if saved["a"].keys() != saved["b"].keys() or meta["a"] != meta["b"] \
            or meta["a"]["step"] != 4:
        raise AssertionError(f"ckpt: B's epoch 2 holds other tensors or "
                             f"meta than A's ({meta})")
    same = all(torch.equal(v, saved["b"][k]) for k, v in saved["a"].items())
    errs = [_scaled_err(saved["b"][k], v) for k, v in saved["a"].items()]
    worst, tier = max(e for e, _ in errs), all(ok for _, ok in errs)
    print(f"files: ckpt: B (--steps 2, then -c) against A at epoch 2, "
          f"{len(saved['a'])} tensors (weights and AdamW moments), step "
          f"{meta['b']['step']}: {'equal bit for bit' if same else 'differ'}"
          f", max abs err {worst:.3e}, within the fp32 tier: {tier}; held "
          f"to bit for bit {'ok' if same else 'FAIL'}", flush=True)
    if not same:
        raise AssertionError("ckpt: the resumed run differs from A")
    d = os.path.join(cks["a"], "epoch-2")
    mib = sum(os.path.getsize(os.path.join(d, n))
              for n in os.listdir(d)) / 2**20
    del saved

    # the eval CLI on A's checkpoints: the train-time evaluation's mIoU
    scores = {e: m for m, e in ck.load_val_scores(cks["a"])}
    for spec, epochs in (("last", [ck._pointer_epoch(cks["a"])]),
                         ("1-", ck._epoch_dirs(cks["a"]))):
        runs = _eval_cli(["-n", "mfnet", "--dataset-path", cfg.dataset_path,
                          "--log-dir", logs["a"], "-e", spec, "--device",
                          "cuda"], f"ckpt -e {spec}")
        got = [m for _, m in runs]
        want = [scores[e] for e in epochs]
        print(f"files: ckpt -e {spec}: epochs {epochs} mIoU {got}, the "
              f"train-time evaluation logged {want}", flush=True)
        if got != want:
            raise AssertionError(f"-e {spec}: mIoU {got} != {want}")

    # --pretrained: a released VMamba trunk at sigma_tiny widths
    v = SIGMA_VARIANTS["sigma_tiny"]
    released = _released_vmamba(v["depths"], v["dims"], SEED + 50)
    path = os.path.join(tmp, "vssm_tiny.pth")
    torch.save({"model": {f"module.{k}": t for k, t in released.items()},
                "epoch": 300,
                "config": argparse.Namespace(arch="vssm_tiny",
                                             dims=list(v["dims"]))}, path)
    want = {}
    for k, t in released.items():
        if not k.startswith("classifier."):
            for a, b in _RELEASED_TO_PORT:
                k = k.replace(a, b)
            want["backbone.vssm." + k] = t

    def check_first(model):
        sd = model.state_dict()
        unmapped = [k for k in sd if k.startswith("backbone.vssm.")
                    and ".outnorm" not in k and k not in want]
        bad = [k for k, t in want.items()
               if k not in sd or not torch.equal(sd[k].cpu(), t)]
        print(f"files: ckpt --pretrained: {len(want) - len(bad)} of "
              f"{len(want)} mapped trunk tensors in the card's model equal "
              f"the file's; trunk tensors the file does not map "
              f"{len(unmapped)}", flush=True)
        if bad or unmapped:
            raise AssertionError(f"--pretrained: differ {bad[:5]}, not "
                                 f"mapped {unmapped[:5]}")

    rec_p = _ckpt_train(common + ["--log-dir", logs["pre"], "--steps", "1",
                                  "--no-eval", "--pretrained", path],
                        "pretrained (1 step)", check_first)
    if len(rec_p["seconds"]) != 1:
        raise AssertionError("--pretrained: not one step")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    out.update(
        ckpt_save_async_s=float(np.mean(rec_a["save_s"])),
        ckpt_save_sync_s=float(np.mean(rec_b1["save_s"] + rec_b2["save_s"])),
        ckpt_bg_write_s=float(np.mean(rec_a["bg_write_s"])),
        ckpt_mib=mib, ckpt_restore_s=rec_b2["restore_s"][0],
        ckpt_s_step=[r["s_step"] for r in (rec_a, rec_b1, rec_b2, rec_p)],
        ckpt_resume="bit for bit")
    print(f"files: ckpt part {time.perf_counter() - t_part:.1f}s: save "
          f"blocking {out['ckpt_save_async_s']:.4f}s async (the host copy) "
          f"/ {out['ckpt_save_sync_s']:.4f}s sync, background write "
          f"{out['ckpt_bg_write_s']:.4f}s, {mib:.2f} MiB an epoch, restore "
          f"{out['ckpt_restore_s']:.4f}s, s/step A / B1 / B2 / pretrained "
          f"{[round(x, 4) for x in out['ckpt_s_step']]}; {card}",
          flush=True)
    return out

# the JAX package's forward FLOP count of sigma_tiny + MambaDecoder at
# 480x640 (`sigma_tpu.utils.flops.analytic_flops_split`, its TPU route:
# `jax.default_backend` patched to "tpu" in the tracing process and the
# model traced shape-only with jax.make_jaxpr on a CPU host, no kernel
# run): {batch: (matmul / conv FLOPs, scan tally FLOPs)}. Counts of
# operations, not times.
JAX_TPU_ROUTE_FLOPS = {1: (193_643_979_456, 281_700_864_000),
                       8: (1_441_947_182_784, 2_253_606_912_000)}
SURFACE_COUNT_HW = (64, 96)  # the card-vs-CPU count's image


def _loss_cases(rng, shape=(2, 480, 640), classes=9):
    """(name, loss(logits tensor), the logits array) of every loss of
    `utils/losses.py`: seeded logits with a tenth of the labels ignored
    (255), class weights where a loss takes them; berHu a regression
    target with a tenth at its ignore value 0, the sigmoid focal loss
    binary labels."""
    import numpy as np
    import torch

    from sigma_tpu_torch.utils import losses

    logits = (2 * rng.standard_normal((*shape, classes))).astype(np.float32)
    labels = rng.integers(0, classes, shape)
    labels[rng.random(shape) < 0.1] = 255
    pred = rng.standard_normal(shape).astype(np.float32)
    target = np.abs(rng.standard_normal(shape)).astype(np.float32)
    target[rng.random(shape) < 0.1] = 0.0
    binary = rng.integers(0, 2, shape)
    binary[rng.random(shape) < 0.1] = 255
    weight = np.linspace(0.5, 1.5, classes).astype(np.float32)

    def on(x, like):
        return torch.as_tensor(x, device=like.device)

    return [
        ("cross_entropy", lambda t: losses.cross_entropy(
            t, on(labels, t)), logits),
        ("focal_loss_2d", lambda t: losses.focal_loss_2d(
            t, on(labels, t), weight=on(weight, t)), logits),
        ("balance_loss", lambda t: losses.balance_loss(
            t, on(labels, t)), logits),
        ("berhu_loss", lambda t: losses.berhu_loss(
            t, on(target, t)), pred),
        ("sigmoid_focal_loss", lambda t: losses.sigmoid_focal_loss(
            t, on(binary, t), 255), pred),
        ("ohem_cross_entropy", lambda t: losses.ohem_cross_entropy(
            t, on(labels, t), thresh=0.3, min_kept=100_000), logits),
        ("rce_loss", lambda t: losses.rce_loss(
            t, on(labels, t), classes), logits),
    ]


def surface_phase(device, reps=10):
    """The port's surface besides the models (ROADMAP A7e, A6): every loss
    of `utils/losses.py` on seeded (2, 480, 640, 9) logits on the card
    against the CPU, value and gradient at the fp32 tier, forward and
    forward + backward ms; the analytic FLOP count (`utils/flops.py`) of
    sigma_tiny + MambaDecoder at 480x640, batch 1 and 8, on the card,
    printed beside the JAX package's TPU-route count, and the same model
    counted on the card and on the CPU at 64x96, batch 1 and 2, equal
    (the route rule that decides what counts depends on the widths only;
    the CPU's plain scans would take minutes at 480x640); `TrainPre` with
    `device_norm` off at 480x640, the native tail against the numpy path
    (within 1e-5, labels exact), host ms a sample with 1 and 8 threads.
    Returns {metric: value}; raises on a failed check."""
    import concurrent.futures

    import numpy as np
    import torch

    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.data import TrainPre
    from sigma_tpu_torch.models.builder import build_model
    from sigma_tpu_torch.utils import flops

    t_phase = time.perf_counter()
    out, failures = {"loss_ms": {}}, []
    hw = (480, 640)
    for name, fn, x in _loss_cases(np.random.default_rng(SEED + 60),
                                   (2, *hw)):
        res = {}
        for where in ("cpu", device):
            t = torch.tensor(x, device=where, requires_grad=True)
            v = fn(t)
            (g,) = torch.autograd.grad(v, t)
            res[str(where)] = (v.detach().cpu(), g.cpu())
        (v0, g0), (v1, g1) = res["cpu"], res[str(device)]
        err_v, ok_v = _scaled_err(v1, v0)
        err_g, ok_g = _scaled_err(g1, g0)
        t = torch.tensor(x, device=device, requires_grad=True)
        with torch.no_grad():
            ms = _time_ms(lambda: fn(t), reps)
        ms_bwd = _time_ms(lambda: torch.autograd.grad(fn(t), t), reps)
        out["loss_ms"][name] = (ms, ms_bwd)
        line = (f"surface: loss {name} value {float(v1):.6f} (CPU "
                f"{float(v0):.6f}) err {err_v:.2e}, gradient err "
                f"{err_g:.2e}; {ms:.4f} ms forward, {ms_bwd:.4f} ms forward "
                f"+ backward {'ok' if ok_v and ok_g else 'FAIL'}")
        print(line, flush=True)
        if not (ok_v and ok_g):
            failures.append(line)

    cfg = get_config("mfnet")
    model = build_model(cfg, device=device, seed=SEED)
    counts = {}
    for batch in JAX_TPU_ROUTE_FLOPS:
        t0 = time.perf_counter()
        st = flops.model_stats(model, hw, batch)
        counts[batch] = (int(st["flops_mm"]), int(st["flops_scan"]))
        mm, sc = counts[batch]
        jmm, jsc = JAX_TPU_ROUTE_FLOPS[batch]
        print(f"surface: FLOPs sigma_tiny+MambaDecoder {hw[0]}x{hw[1]} batch "
              f"{batch} on the card: matmul/conv {mm:,} + scan tally "
              f"{sc:,} = {mm + sc:,} ({st['params']:,} params, counted in "
              f"{time.perf_counter() - t0:.2f}s); the JAX package's TPU "
              f"route {jmm:,} + {jsc:,} = {jmm + jsc:,}; port - JAX: "
              f"{mm - jmm:,} + {sc - jsc:,}", flush=True)
    out["flops"] = counts
    cpu_model = build_model(cfg, device="cpu", seed=SEED)
    for batch in (1, 2):
        got = flops.model_stats(model, SURFACE_COUNT_HW, batch)
        want = flops.model_stats(cpu_model, SURFACE_COUNT_HW, batch)
        same = (got["flops_mm"], got["flops_scan"]) == (
            want["flops_mm"], want["flops_scan"])
        line = (f"surface: FLOPs sigma_tiny {SURFACE_COUNT_HW[0]}x"
                f"{SURFACE_COUNT_HW[1]} batch {batch}: card "
                f"{int(got['flops_mm']):,} + {int(got['flops_scan']):,}, "
                f"CPU {int(want['flops_mm']):,} + "
                f"{int(want['flops_scan']):,} "
                f"{'equal' if same else 'DIFFER'}")
        print(line, flush=True)
        if not same:
            failures.append(line)
    del model, cpu_model
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 61)
    rgb = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    gt = rng.integers(0, 9, hw, dtype=np.uint8)
    mx = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    pres = {k: TrainPre(cfg.norm_mean, cfg.norm_std, cfg, use_native=k)
            for k in (True, False)}
    worst = 0.0
    for i in range(8):
        a = pres[True](np.random.default_rng(i), rgb, gt, mx)
        b = pres[False](np.random.default_rng(i), rgb, gt, mx)
        worst = max(worst, *(float(np.abs(p - q).max())
                             for p, q in zip(a[::2], b[::2])))
        if not (np.array_equal(a[1], b[1]) and worst <= 1e-5
                and all(p.shape == q.shape for p, q in zip(a, b))):
            failures.append(f"surface: TrainPre native against numpy, "
                            f"sample {i}: max |diff| {worst:.3e}")
    native_ms = {}
    for native in (True, False):
        for threads in (1, 8):
            n = 16
            with concurrent.futures.ThreadPoolExecutor(threads) as pool:
                t0 = time.perf_counter()
                list(pool.map(lambda i: pres[native](
                    np.random.default_rng(i), rgb, gt, mx), range(n)))
                native_ms[(native, threads)] = (
                    (time.perf_counter() - t0) / n * 1e3)
    out["native_ms"] = native_ms
    print(f"surface: TrainPre 480x640 (device_norm off, train scales) "
          f"native tail against numpy: max |diff| {worst:.3e}, labels "
          f"equal; host ms a sample (16 samples) native "
          f"{native_ms[(True, 1)]:.2f} with 1 thread, "
          f"{native_ms[(True, 8)]:.2f} with 8; numpy "
          f"{native_ms[(False, 1)]:.2f} / {native_ms[(False, 8)]:.2f}",
          flush=True)
    print(f"surface: phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    if failures:
        raise AssertionError(f"{len(failures)} surface checks failed")
    return out


# kernel symbols of K2, K4 and K5 (csrc/scan_g_fwd.cu, scan_g_bwd.cu: K2's
# one-pass scan, K4's projection tag and its body's source, K5)
PROFILED_KERNELS = {"K2": "chain_scan_kernel", "K4": "ProjBwd",
                    "K5": "weight_grad_kernel"}


def profile_part(cfg, tmp):
    """The train CLI's `--profile` on the files phase's MFNet tree: 31
    steps at batch 2 (no evaluation), the trace of steps 20-29 under
    DIR/trace_rank0.json naming K2, K4 and K5, the log line. Returns
    {metric: value}; raises on a failed check."""
    import logging

    import numpy as np

    from sigma_tpu_torch.engine.logger import get_logger

    t_part = time.perf_counter()
    prof = os.path.join(tmp, "profile")
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = get_logger()
    logger.addHandler(handler)
    try:
        rec = _ckpt_train(["-n", "mfnet", "--dataset-path", cfg.dataset_path,
                           "--steps", "31", "--batch-size", "2", "--no-eval",
                           "--profile", prof, "--log-dir",
                           os.path.join(tmp, "profile_log")], "--profile")
    finally:
        logger.removeHandler(handler)
    trace = os.path.join(prof, "trace_rank0.json")
    text = open(trace).read() if os.path.exists(trace) else ""
    named = {k: sym in text for k, sym in PROFILED_KERNELS.items()}
    mib = len(text.encode()) / 2 ** 20
    traced = float(np.mean(rec["seconds"][20:30]))
    others = float(np.mean(rec["seconds"][1:20] + rec["seconds"][30:]))
    print(f"files: --profile: trace {trace} {mib:.2f} MiB, kernels named "
          f"{named}, log line "
          f"{'printed' if f'profiler trace written to {prof}' in lines else 'MISSING'}"
          f"; s/step traced (steps 20-29) {traced:.4f}, untraced "
          f"{others:.4f}; part {time.perf_counter() - t_part:.1f}s",
          flush=True)
    if not all(named.values()) or len(rec["seconds"]) != 31 or \
            f"profiler trace written to {prof}" not in lines:
        raise AssertionError(f"--profile: kernels {named}, "
                             f"{len(rec['seconds'])} steps, log {lines[-3:]}")
    return dict(profile_mib=mib, profile_s_step=traced,
                profile_untraced_s_step=others)


def files_phase(device):
    """The port on dataset files, with no cv2 (`sys.modules["cv2"] =
    None`, so an import of it fails): a seeded MFNet tree (8 480x640
    pairs) and an NYU-geometry tree in PNG (4 pairs, 40 classes) written
    by `data/png.py`, each file decoded again and held to what was
    written (host ms per image), and cv2's own 480x640 PNG (adaptive
    filters) decoded to cv2's array; `resize_u8` on the card against the
    CPU, bit for bit, at every train scale in the training form and at
    0.75 / 1.25 in the eval form, bilinear and nearest, on an RGB image
    and a label map (device ms); the eval CLI on the MFNet tree and on the
    NYU tree with `--override rgb_format=.png` (scales 0.75, 1, 1.25 and
    flip) at sigma_tiny, `-p` PNGs read back, K1 / K2 launched and no
    backward kernel; the NYU protocol at sigma_test on the card against
    the CPU plain path (argmax agreement); `image_batch` 2 against 1 on
    the NYU tree (the same predictions); the train CLI for 3 steps on the
    MFNet tree (finite losses, weights moved, K1-K5 launched, s/step);
    then `ckpt_part` on the MFNet tree. Returns {metric: value}; raises
    on a failed check."""
    import copy
    import hashlib
    import os
    import tempfile

    import numpy as np
    import torch

    sys.modules["cv2"] = None
    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.data import RGBXDataset, TrainPre, ValPre
    from sigma_tpu_torch.data.png import read_png
    from sigma_tpu_torch.data.resize import resize_u8
    from sigma_tpu_torch.engine import train as train_engine
    from sigma_tpu_torch.engine.evaluator import SlidingEvaluator
    from sigma_tpu_torch.models.builder import build_model
    from sigma_tpu_torch.train import main as train_main

    out = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_files_") as tmp:
        out.update(jpeg_part())
        jpgs = {".jpg": " (RGB: the JPEG fixtures' 480x640 scenes)"}
        cfgs = {}
        for name, n, labels in (("mfnet", 8, 9), ("nyu", 4, 41)):
            cfg = get_config(name, dataset_path=os.path.join(tmp, name))
            t0 = time.perf_counter()
            written = _write_tree(cfg, n, SEED + 40, labels)
            write_s = time.perf_counter() - t0
            ms = defaultdict(list)
            for path, want in written.items():
                t0 = time.perf_counter()
                got = read_png(path, gray=want.ndim == 2)
                ms[os.path.basename(os.path.dirname(path))].append(
                    (time.perf_counter() - t0) * 1e3)
                if got.dtype != np.uint8 or not np.array_equal(got, want):
                    raise AssertionError(f"{path}: decoded != written")
            print(f"files: {name} tree {len(written)} PNGs written in "
                  f"{write_s:.2f}s{jpgs.get(cfg.rgb_format, '')}, each PNG "
                  f"decoded equal to its array; host "
                  f"ms per image (filter 0 rows) "
                  + ", ".join(f"{k} {np.mean(v):.2f}" for k, v in ms.items()),
                  flush=True)
            cfgs[name] = cfg
        for gray in (False, True):
            got = read_png(CV2_PNG, gray=gray)
            digest = hashlib.sha256(np.ascontiguousarray(got).tobytes())
            t0 = time.perf_counter()
            for _ in range(5):
                read_png(CV2_PNG, gray=gray)
            dt = (time.perf_counter() - t0) / 5 * 1e3
            ok = digest.hexdigest() == CV2_PNG_SHA256[gray]
            print(f"files: {CV2_PNG.name} (cv2-written, Average rows) "
                  f"{'gray' if gray else 'RGB'} {got.shape} decoded in "
                  f"{dt:.2f} ms on the host, cv2.imread's array "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{CV2_PNG}: decode != cv2.imread")
            out[f"decode_ms_{'gray' if gray else 'rgb'}"] = dt

        # one train sample on the host: 3 PNG decodes, TrainPre's mirror,
        # rescale (resize_u8 on the CPU) and crop, as the loader's threads
        cfg = cfgs["mfnet"]
        train_set = RGBXDataset(
            cfg.data_setting(), "train",
            TrainPre(cfg.norm_mean, cfg.norm_std, cfg, device_norm=True))
        t0 = time.perf_counter()
        for i in range(len(train_set)):
            train_set.__getitem__(i, rng=np.random.default_rng(i))
        out["sample_ms"] = (time.perf_counter() - t0) / len(train_set) * 1e3
        print(f"files: mfnet train sample (3 PNG decodes + TrainPre) "
              f"{out['sample_ms']:.2f} host ms, one thread", flush=True)

        # resize_u8: the card against the CPU, bit for bit
        s = cfgs["mfnet"].data_setting()
        rgb = read_png(os.path.join(s["rgb_root"], "f00.png"))
        label = read_png(os.path.join(s["gt_root"], "f00.png"), gray=True)
        h, w = label.shape
        worst = 0.0
        for img in (rgb, label):
            cpu = torch.from_numpy(img)
            dev = cpu.to(device)
            for mode in ("linear", "nearest"):
                calls = [(f"train {x}", dict(dsize=(int(w * x), int(h * x))))
                         for x in TRAIN_SCALES]
                calls += [(f"eval {x}", dict(fx=x)) for x in EVAL_SCALES]
                line = []
                for what, kw in calls:
                    got = resize_u8(dev, interpolation=mode, **kw)
                    if not torch.equal(got.cpu(),
                                       resize_u8(cpu, interpolation=mode,
                                                 **kw)):
                        raise AssertionError(f"resize_u8 {mode} {what} "
                                             f"{img.shape}: card != CPU")
                    ms = _time_ms(lambda: resize_u8(dev, interpolation=mode,
                                                    **kw), 5)
                    worst = max(worst, ms)
                    line.append(f"{what} {ms:.4f}")
                print(f"files: resize_u8 {mode} {img.shape} card == CPU bit "
                      f"for bit; device ms " + ", ".join(line), flush=True)
        out["resize_ms_max"] = worst

        # the eval CLI on both trees, sigma_tiny at full width
        ckpts = {}
        for name, cfg in cfgs.items():
            m = build_model(cfg, device=device, seed=SEED)
            ckpts[name] = os.path.join(tmp, f"{name}.pt")
            torch.save({k: v.cpu() for k, v in m.state_dict().items()},
                       ckpts[name])
            del m
        for name, cfg in cfgs.items():
            pred_dir = os.path.join(tmp, f"pred_{name}")
            argv = ["-n", name, "--dataset-path", cfg.dataset_path,
                    "-e", ckpts[name], "-p", pred_dir, "--device", "cuda"]
            (out[f"eval_img_s_{name}"], _), = _eval_cli(argv, name)
            with open(cfg.data_setting()["eval_source"]) as f:
                names = f.read().split()
            _check_saved(pred_dir, names, (cfg.image_height, cfg.image_width),
                         cfg.num_classes)

        # image_batch 2 against 1 on the NYU tree: the same predictions
        cfg = cfgs["nyu"]
        model = build_model(cfg, device="cpu", seed=SEED)
        model.load_state_dict(torch.load(ckpts["nyu"]))
        model.to(device).eval()
        val = RGBXDataset(cfg.data_setting(), "val", ValPre())
        preds = {}
        for ib in (1, 2):
            ev = SlidingEvaluator(
                model, cfg.num_classes, cfg.norm_mean, cfg.norm_std,
                multi_scales=cfg.eval_scale_array, is_flip=cfg.eval_flip,
                eval_crop_size=cfg.eval_crop_size,
                stride_rate=cfg.eval_stride_rate, image_batch=ib,
                device=device)
            got = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            miou, _ = ev.run(val, save_fn=lambda fn, p: got.__setitem__(fn, p))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            preds[ib] = got
            out[f"nyu_img_s_batch{ib}"] = len(val) / dt
            print(f"files: nyu image_batch {ib}: {len(val)} images in "
                  f"{dt:.3f}s = {len(val) / dt:.4f} img/s, mIoU {miou:.4f}",
                  flush=True)
        same = all(np.array_equal(preds[1][k], preds[2][k]) for k in preds[1])
        agree = np.mean([(preds[1][k] == preds[2][k]).mean()
                         for k in preds[1]])
        print(f"files: nyu image_batch 2 against 1: predictions "
              f"{'equal' if same else 'DIFFER'} (agreement {agree:.6f})",
              flush=True)
        if not same:
            raise AssertionError("image_batch 2 changes the predictions")
        del model, ev
        torch.cuda.empty_cache()

        # the NYU protocol at sigma_test: the card against the CPU
        cfg_t = get_config("nyu", backbone="sigma_test")
        cpu_model = build_model(cfg_t, device="cpu", seed=SEED)
        gpu_model = copy.deepcopy(cpu_model).to(device)
        item = val[0]
        small = [resize_u8(torch.from_numpy(a), (128, 96),
                           interpolation=mode).numpy()
                 for a, mode in ((item["data"], "linear"),
                                 (item["modal_x"], "linear"),
                                 (item["modal_x"][..., 0], "nearest"))]
        agree = []
        for mx in small[1:]:  # a 3-channel and a 2-D modal-x
            p = {}
            for where, m in (("cpu", cpu_model), (device, gpu_model)):
                p[str(where)] = SlidingEvaluator(
                    m, cfg_t.num_classes, cfg_t.norm_mean, cfg_t.norm_std,
                    multi_scales=cfg_t.eval_scale_array,
                    is_flip=cfg_t.eval_flip, eval_crop_size=(96, 128),
                    stride_rate=cfg_t.eval_stride_rate, device=where,
                ).sliding_eval(small[0], mx)
            agree.append(float((p["cpu"] == p[str(device)]).mean()))
        print(f"files: NYU protocol (0.75, 1, 1.25, flip) sigma_test 96x128 "
              f"card vs CPU argmax agreement {agree} (3-channel, 2-D "
              f"modal-x; need >= {ARGMAX_AGREEMENT})", flush=True)
        if min(agree) < ARGMAX_AGREEMENT:
            raise AssertionError("NYU-protocol predictions: card != CPU")
        del cpu_model, gpu_model

        # the train CLI, 3 steps on the MFNet tree
        rec = dict(losses=[], seconds=[])
        orig = train_engine.build_train

        def build_train(cfg, device="cuda"):
            state, step, schedule = orig(cfg, device)
            rec["model"] = state.model
            rec["before"] = {k: v.detach().clone()
                             for k, v in state.model.named_parameters()}

            def timed_step(st, batch):
                t0 = time.perf_counter()
                loss = step(st, batch)
                rec["losses"].append(float(loss))
                rec["seconds"].append(time.perf_counter() - t0)
                return loss

            return state, timed_step, schedule

        train_engine.build_train = build_train
        _reset_launches()
        try:
            rc = train_main(["-n", "mfnet", "--dataset-path",
                             cfgs["mfnet"].dataset_path, "--steps", "3",
                             "--batch-size", "2", "--no-eval",
                             "--log-dir", os.path.join(tmp, "log")])
        finally:
            train_engine.build_train = orig
        launches = _launches()
        moved = sum(int((p.detach() != rec["before"][k]).sum())
                    for k, p in rec["model"].named_parameters())
        s_step = float(np.mean(rec["seconds"][1:]))
        print(f"files: mfnet train CLI rc {rc}, batch 2 from PNG files: "
              f"losses {rec['losses']}, seconds "
              f"{[round(t, 4) for t in rec['seconds']]}, last two "
              f"{s_step:.4f} s/step (the loader's wait included), {moved} "
              f"weights moved, launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        missing = [k for k in FORWARD + SCAN_BACKWARD if launches[k] == 0]
        if rc != 0 or not np.all(np.isfinite(rec["losses"])) or \
                len(rec["losses"]) != 3 or moved == 0 or missing:
            raise AssertionError(f"train CLI from files: rc {rc}, losses "
                                 f"{rec['losses']}, moved {moved}, kernels "
                                 f"not launched {missing}")
        out["train_s_step"] = s_step
        del rec
        torch.cuda.empty_cache()
        out.update(profile_part(cfgs["mfnet"], tmp))
        out.update(ckpt_part(device, cfgs["mfnet"], tmp))
        out.update(ddp_part(device, cfgs["mfnet"], tmp))
    torch.cuda.empty_cache()
    print(f"files: phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    return out


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
    # and a bf16 product accumulates in fp32 and rounds once, as the
    # reference's does: cuBLAS may otherwise sum split-K partials in bf16
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    # deterministic convolutions, as the train CLI sets them (ROADMAP C10)
    torch.backends.cudnn.deterministic = True
    device = torch.device("cuda", 0)

    t_start = time.perf_counter()
    card = build_phase()
    summary = kernel_phase(device)
    summary.update(backward_phase(device))
    scan_split(device)
    summary.update(epilogue_phase(device))
    ops_summary, per_row, ops_launches = ops_phase(device)
    summary.update(ops_summary)
    img_summary, img_launches = image_phase(device)
    summary.update(img_summary)
    eval_img_s, eval_peak = model_phase(device)
    bf16_img_s, bf16_eval_peak = bf16_model_phase(device)
    launches, train_timing = train_phase(device)
    bf16_train_timing = bf16_train_phase(device)
    bf16_cross_check(device)
    decoders = decoders_phase(device)
    backbones = backbones_phase(device, card)
    surface = surface_phase(device)
    with tempfile.TemporaryDirectory() as tmp:
        determinism = determinism_part(device, tmp)
    files = files_phase(device)
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
        no_exp = _bound(name, s["kw"], mufu=math.inf)[0]
        print(f"summary: {name} bound_ms {bound_ms:.4f} ({bound_by}; "
              f"without the exps' term at {_mufu_per_s() / 1e12:.4f} T/s: "
              f"{no_exp:.4f})")
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
    for name in FORWARD + SCAN_BACKWARD + EPILOGUE + IMAGE:
        s = summary[name]
        b32 = _bound(name, s["kw"])[0]
        b16, by16 = _bound(name, s["kw"], io=2)
        err = (f", bf16 max_abs_err over its gradients "
               f"{s['bf16_max_abs_err']:.3e}"
               if name in SCAN_BACKWARD + ("scan_img_bwd",) else "")
        lib16 = (f", bf16 cuBLAS {s['bf16_library_ms']:.4f} ms"
                 if s.get("bf16_library_ms") else "")
        print(f"summary: {name} bf16 io at {s['at'].replace(' fp32', '')}: "
              f"{s['bf16_ms']:.4f} ms (fp32 {s['ms']:.4f}), bound "
              f"{b16:.4f} ms ({by16}, 2-byte io streams; fp32 {b32:.4f})"
              + err + lib16)
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    for fused in (False, True):
        img, img16 = eval_img_s[fused], bf16_img_s[fused]
        s_step = [t["s_step"] for t in train_timing[fused]]
        s16 = [t["s_step"] for t in bf16_train_timing[fused]]
        print(f"summary: fused_epilogue={int(fused)} eval img/s "
              f"{[round(x, 4) for x in img]} mean {mean(img):.4f}; "
              f"train s/step {[round(x, 4) for x in s_step]} mean "
              f"{mean(s_step):.4f}")
        print(f"summary: fused_epilogue={int(fused)} bf16 eval img/s "
              f"{[round(x, 4) for x in img16]} (fp32 mean {mean(img):.4f}), "
              f"peak GiB {[round(x, 3) for x in bf16_eval_peak[fused]]} "
              f"(fp32 {[round(x, 3) for x in eval_peak[fused]]}); bf16 "
              f"train s/step {[round(x, 4) for x in s16]} (fp32 mean "
              f"{mean(s_step):.4f}), peak GiB "
              f"{[round(t['peak'], 3) for t in bf16_train_timing[fused]]} "
              f"(fp32 {[round(t['peak'], 3) for t in train_timing[fused]]})")
    print("summary: library_ms of proj_grad (K5): its two cuBLAS products, "
          "torch.matmul on the concatenated operands, at the same call; "
          "null for the others: no single PyTorch call computes a "
          "selective scan or its gradient (K1-K4, K8-K11), nor K6's merge "
          "+ LayerNorm + gate or its gradient (K7)")
    print(f"summary: files (no cv2): PNG decode of cv2's 480x640 RGB file "
          f"{files['decode_ms_rgb']:.2f} host ms (gray "
          f"{files['decode_ms_gray']:.2f}); a train sample (3 decodes + "
          f"TrainPre) {files['sample_ms']:.2f} host ms; resize_u8 at most "
          f"{files['resize_ms_max']:.4f} device ms; eval CLI img/s MFNet "
          f"{files['eval_img_s_mfnet']:.4f}, NYU protocol "
          f"{files['eval_img_s_nyu']:.4f} (image_batch 1 / 2: "
          f"{files['nyu_img_s_batch1']:.4f} / "
          f"{files['nyu_img_s_batch2']:.4f}); train CLI from files "
          f"{files['train_s_step']:.4f} s/step at batch 2")
    print(f"summary: JPEG (files phase, no cv2): the fixtures equal "
          f"cv2.imread's digests; a 480x640 4:2:0 q95 decode "
          f"{files['jpeg_ms_rgb']:.2f} host ms RGB, "
          f"{files['jpeg_ms_gray']:.2f} gray, progressive "
          f"{files['jpeg_ms_prog']:.2f} RGB; 8 threads "
          f"{files['jpeg_threads_speedup']:.2f}x one; the NYU-protocol "
          f"eval CLI read its RGB from JPEG")
    print(f"summary: data parallel (files phase, sigma_tiny 480x640 fp32, "
          f"global batch 2): train CLI under torchrun (1 process, NCCL) "
          f"{files['ddp_cli_s_step']:.4f} s/step; 2 gloo ranks on one card "
          f"{files['ddp_gloo_s_step']:.4f} s/step against one process "
          f"{files['ddp_one_s_step']:.4f}, all-reduced gradient within "
          f"{files['ddp_grad_rel_err']:.3e} of its norm (UPernet, "
          f"global-batch BatchNorm: {files['ddp_bn_grad_rel_err']:.3e}); "
          f"{files['ddp_grad_bytes']} gradient bytes all-reduced a step")
    for name, d in decoders.items():
        print(f"summary: decoders: sigma_tiny/{name} MFNet 480x640 fp32 "
              f"train {d['s_step']:.4f} s/step at batch 2, peak "
              f"{d['peak']:.3f} GiB; eval {d['img_s']:.4f} img/s, peak "
              f"{d['eval_peak']:.3f} GiB")
    for name, d in backbones.items():
        if name == "VSSMClassifier":
            print(f"summary: backbones: VSSMClassifier VMamba-T 224x224 "
                  f"batch {CLASSIFIER_BATCH} fp32 forward + backward "
                  f"{d['ms']:.2f} ms, peak {d['peak']:.3f} GiB; {card}")
            continue
        print(f"summary: backbones: {name} MFNet 480x640 fp32 train "
              f"{d['s_step']:.4f} s/step at batch 2, peak {d['peak']:.3f} "
              f"GiB; eval {d['img_s']:.4f} img/s, peak "
              f"{d['eval_peak']:.3f} GiB; {card}")
    det = {r["setting"]: r for r in determinism}
    print(f"summary: determinism (ROADMAP C10, sigma_tiny fp32 batch 2): "
          f"default {det['default']['grads_moved']} of "
          f"{det['default']['grads']} gradients rerun with other bits, "
          f"{det['default']['s_step']:.4f} s/step; cudnn.deterministic "
          f"{det['cudnn.deterministic']['grads_moved']} moved, "
          f"{det['cudnn.deterministic']['s_step']:.4f} s/step; "
          f"use_deterministic_algorithms "
          f"{det['use_deterministic_algorithms']['grads_moved']} moved, "
          f"{det['use_deterministic_algorithms']['s_step']:.4f} s/step, "
          f"raised {det['use_deterministic_algorithms']['raised']!r}")
    for name, (ms, ms_bwd) in surface["loss_ms"].items():
        print(f"summary: loss {name} (2, 480, 640, 9) logits on the card: "
              f"{ms:.4f} ms forward, {ms_bwd:.4f} ms forward + backward")
    for batch, (mm, sc) in surface["flops"].items():
        jmm, jsc = JAX_TPU_ROUTE_FLOPS[batch]
        print(f"summary: FLOPs sigma_tiny+MambaDecoder 480x640 batch {batch}"
              f": port {mm:,} + {sc:,}, JAX TPU route {jmm:,} + {jsc:,}; "
              f"card == CPU at {SURFACE_COUNT_HW[0]}x{SURFACE_COUNT_HW[1]}")
    nm = surface["native_ms"]
    print(f"summary: TrainPre 480x640 host ms a sample, native / numpy: 1 "
          f"thread {nm[(True, 1)]:.2f} / {nm[(False, 1)]:.2f}, 8 threads "
          f"{nm[(True, 8)]:.2f} / {nm[(False, 8)]:.2f}; --profile trace "
          f"{files['profile_mib']:.2f} MiB, s/step traced "
          f"{files['profile_s_step']:.4f} / untraced "
          f"{files['profile_untraced_s_step']:.4f}")
    print(f"summary: checkpoints (files phase, sigma_tiny fp32 batch 2): "
          f"save blocking {files['ckpt_save_async_s']:.4f}s async / "
          f"{files['ckpt_save_sync_s']:.4f}s sync, background write "
          f"{files['ckpt_bg_write_s']:.4f}s, {files['ckpt_mib']:.2f} MiB, "
          f"restore {files['ckpt_restore_s']:.4f}s, s/step A / B1 / B2 / "
          f"pretrained {[round(x, 4) for x in files['ckpt_s_step']]}; "
          f"resume held to {files['ckpt_resume']}")
    print(f"summary: command time {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def split_main(argv):
    """`chip_smoke.py --scan-split [TREE [K2|K4 ...]]`: the build and
    `scan_split` (of the kernels named, by default both) on the port of
    TREE (a checkout, by default this one), e.g. a parent tree unpacked
    beside it for a before / after in one call."""
    import torch

    global ROOT
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if argv:
        ROOT = Path(argv[0]).resolve()
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"split: tree {ROOT}")
    build_phase()
    scan_split(torch.device("cuda", 0), names=tuple(argv[1:]) or ("K2", "K4"))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--scan-split"]:
        sys.exit(split_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--ddp-worker"]:
        sys.exit(_ddp_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--determinism-worker"]:
        sys.exit(_determinism_worker(sys.argv[2:]))
    sys.exit(main())
