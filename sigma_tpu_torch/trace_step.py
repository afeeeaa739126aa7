"""Device-time breakdown of one warm sigma_tiny step on the card.

  python -m sigma_tpu_torch.trace_step --what train   # 480x640, batch 2
  python -m sigma_tpu_torch.trace_step --what eval    # one MFNet image
  python -m sigma_tpu_torch.trace_step --what train --bf16   # bf16 compute

Builds the MFNet preset's train step as the train CLI does
(`engine.train.build_train`, seeded weights) or its evaluator, runs one
step to warm up, then traces one more with torch.profiler (CPU + CUDA
activities) and prints: the host wall time of the traced step, the device's busy time
(the union of its kernel and copy intervals) and idle share, the time of
each kernel group (the port's kernels by name, then the rest), and
the 15 kernels with the most device time. Synthetic seeded uint8 inputs
(`synthetic_batch`); needs a CUDA card (it raises without one). The SS2D
epilogue is fused when SIGMA_FUSED_EPILOGUE is set (models/ss2d.py).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

TRAIN_BATCH = 2

# kernel groups, first match wins (the scan kernels' C++ names; the chunk
# passes are shared, told apart by the operand source in the template: K3,
# K4, K9 and K11 by StreamBwdSrc, ProjBwdSrc, CfBwdSrc and ImgBwdSrc; K1,
# K2, K8 and K10 by StreamSrc, ProjSrc, CfSrc and ImgSrc)
GROUPS = (
    ("K4 scan_proj_bwd", ("bwd_proj_kernel", "ProjBwdSrc")),
    ("K3 scan_bwd", ("StreamBwdSrc",)),
    ("K11 scan_img_bwd", ("img_proj_bwd_kernel", "ImgBwdSrc")),
    ("K2 scan_proj_fwd", ("proj_gemm_kernel", "ProjSrc")),
    ("K1 scan_fwd", ("StreamSrc",)),
    ("K10 scan_img_fwd", ("img_proj_kernel", "ImgSrc")),
    ("K8 scan_cf_fwd", ("CfSrc",)),
    ("K9 scan_cf_bwd", ("CfBwdSrc",)),
    ("K5 proj_grad", ("weight_grad_kernel", "du_chain_kernel")),
    ("K6 merge_ln_gate_fwd", ("merge_ln_gate_fwd_kernel",)),
    ("K7 merge_ln_gate_bwd", ("merge_ln_gate_bwd_kernel",)),
    ("matmul (cuBLAS)", ("gemm", "Gemm", "cutlass", "sm90_xmma")),
    ("convolution (cuDNN)", ("conv", "Conv", "cudnn", "implicit")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("reduction", ("reduce", "Reduce")),
    ("copy / memset", ("Memcpy", "Memset", "copy", "Copy")),
    ("optimizer", ("multi_tensor", "adam", "Adam")),
)


def _group(name: str) -> str:
    for label, keys in GROUPS:
        if any(k in name for k in keys):
            return label
    return "elementwise and other"


def _union_us(intervals) -> float:
    busy, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def synthetic_batch(rng, b, h, w):
    """A seeded synthetic MFNet batch as TrainPre(device_norm=True) emits
    it: uint8 images, labels with some 255, pad margins (t, b, l, r) on the
    last image."""
    label = rng.integers(0, 9, (b, h, w)).astype(np.uint8)
    label[:, :8] = 255
    margins = np.zeros((b, 4), np.int32)
    margins[-1] = (h // 16, h // 20, w // 24, w // 32)
    return dict(data=rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
                modal_x=rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
                label=label, margins=margins)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--what", choices=("train", "eval"), default="train")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute, fp32 parameters (cfg.bf16)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("trace_step needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # and a bf16 product accumulates in fp32 and rounds once, as the
    # reference's does: cuBLAS may otherwise sum split-K partials in bf16
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.engine.evaluator import SlidingEvaluator
    from sigma_tpu_torch.engine.train import build_train
    from sigma_tpu_torch.models.builder import build_model
    from sigma_tpu_torch.models.ss2d import FUSED_EPILOGUE

    cfg = get_config("mfnet", bf16=args.bf16)
    h, w = cfg.image_height, cfg.image_width
    rng = np.random.default_rng(0)
    if args.what == "train":
        state, step, _ = build_train(cfg, "cuda")
        batch = synthetic_batch(rng, TRAIN_BATCH, h, w)

        def run():
            step(state, batch)
    else:
        model = build_model(cfg, device="cuda", seed=cfg.seed)
        ev = SlidingEvaluator(
            model, cfg.num_classes, cfg.norm_mean, cfg.norm_std,
            eval_crop_size=cfg.eval_crop_size,
            stride_rate=cfg.eval_stride_rate, device="cuda")
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        mx = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)

        def run():
            ev.sliding_eval(img, mx)

    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_group, by_name, counts = defaultdict(float), defaultdict(float), \
        defaultdict(int)
    intervals = []
    for e in prof.events():
        # a record_function range on the device's timeline (the optimizer's
        # "Optimizer.step#AdamW.step") spans the idle time between its
        # kernels: it is no kernel and counts as no busy time
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.is_user_annotation):
            continue
        s, t = e.time_range.start, e.time_range.end
        intervals.append((s, t))
        by_group[_group(e.name)] += (t - s) / 1e3
        by_name[e.name] += (t - s) / 1e3
        counts[e.name] += 1
    busy_ms = _union_us(intervals) / 1e3
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"trace: {args.what} sigma_tiny {h}x{w} batch "
          f"{TRAIN_BATCH if args.what == 'train' else 1}, "
          f"{'bf16' if args.bf16 else 'fp32'} compute, fused SS2D "
          f"epilogue {'on' if FUSED_EPILOGUE else 'off'}, on {smi}")
    print(f"trace: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.2f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.2f}%")
    for label, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"trace: group {label}: {ms:.3f} ms "
              f"({100 * ms / busy_ms:.2f}% of busy)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"trace: kernel {ms:.3f} ms x{counts[name]} {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
