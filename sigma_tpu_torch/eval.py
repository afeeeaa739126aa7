"""Evaluation entry point of the port (counterpart of `eval.py`).

  python -m sigma_tpu_torch.eval -n mfnet                  # -e last, on cuda
  python -m sigma_tpu_torch.eval -n mfnet -e 100           # epoch 100
  python -m sigma_tpu_torch.eval -n mfnet -e 80-100        # epoch range
  python -m sigma_tpu_torch.eval -n mfnet -e 80-           # every kept >= 80
  python -m sigma_tpu_torch.eval -n mfnet -e model.pth -p out/    # + PNGs
  python -m sigma_tpu_torch.eval -n mfnet -e params.npz --device cpu

`-e` takes `last` (the default: the epoch-last pointer, or the newest
epoch directory), `N`, `lo-hi`, `lo-` (every epoch directory from lo on)
of the train CLI's checkpoints under `cfg.checkpoint_dir` (default
`<log_dir>/checkpoint`, `--log-dir`), or one file: a `.pt`/`.pth` state
dict or an `.npz` (torch-named, or JAX params under `/`-joined flax
paths), a full model or a VMamba trunk (utils/convert.py; a `.pth` is
unpickled, so only trusted files). The model is built once and reloaded
for each checkpoint. `--override bf16=True` serves in bf16 compute (fp32
parameters), as the JAX evaluator takes it. The JAX trainer's orbax
epoch directories are refused. `--device` defaults to cuda; the CPU is
used only when asked for.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys

import torch


def parse_epochs(spec: str, ckpt_dir: str):
    """Resolve `-e` into a list of epoch ints (None: the last) or a single
    file path, as the JAX CLI's `parse_epochs` does (which also takes
    `.pt` here)."""
    if spec.endswith((".pt", ".pth", ".npz")):
        return [spec]
    if spec == "last":
        return [None]
    if "-" in spec:
        lo, _, hi = spec.partition("-")
        lo = int(lo)
        if hi:
            return list(range(lo, int(hi) + 1))
        # open range: everything >= lo that exists
        out = []
        if os.path.isdir(ckpt_dir):
            for name in os.listdir(ckpt_dir):
                if name.startswith("epoch-") and name != "epoch-last":
                    try:
                        n = int(name.split("-")[1])
                    except ValueError:
                        continue
                    if n >= lo:
                        out.append(n)
        return sorted(out)
    return [int(spec)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="sigma_tpu_torch evaluator")
    p.add_argument("-n", "--dataset", required=True)
    p.add_argument("--dataset-path", default=None)
    p.add_argument("-e", "--epochs", default="last",
                   help="last | N | lo-hi | lo- | a .pt/.pth/.npz file")
    p.add_argument("-p", "--save-path", default=None)
    p.add_argument("--backbone", default=None)
    p.add_argument("--decoder", default=None)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--override", action="append", default=[],
                   metavar="KEY=VAL",
                   help="config field override, repeatable; VAL is parsed "
                        "as a python literal")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: no CUDA device (pass --device cpu to run "
                "the plain path on the CPU)")
    # fp32 means fp32 on the card: cuDNN's float32 convolutions (the 3x3
    # depthwise and CAB convs) default to TF32, and so may matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # and a bf16 product accumulates in fp32 and rounds once, as the
    # reference's does: cuBLAS may otherwise sum split-K partials in bf16
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.data import RGBXDataset, ValPre
    from sigma_tpu_torch.engine.checkpoint import restore_checkpoint
    from sigma_tpu_torch.engine.evaluator import SlidingEvaluator
    from sigma_tpu_torch.engine.logger import get_logger
    from sigma_tpu_torch.models.builder import build_model
    from sigma_tpu_torch.models.ss2d import FUSED_EPILOGUE
    from sigma_tpu_torch.utils.convert import load_checkpoint_into_model
    from sigma_tpu_torch.utils.visualize import print_iou, save_prediction

    overrides = {}
    if args.dataset_path:
        overrides["dataset_path"] = args.dataset_path
    cfg = get_config(args.dataset, **overrides)
    for field, val in (("backbone", args.backbone),
                       ("decoder", args.decoder),
                       ("log_dir", args.log_dir)):
        if val is not None:
            object.__setattr__(cfg, field, val)
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass  # keep as string
        object.__setattr__(cfg, k, v)
    ckpt_dir = cfg.checkpoint_dir or os.path.join(cfg.log_dir, "checkpoint")

    logger = get_logger()
    logger.info("SS2D epilogue: %s (SIGMA_FUSED_EPILOGUE)",
                "fused" if FUSED_EPILOGUE else "unfused")
    logger.info("compute dtype: %s (parameters fp32)",
                "bf16" if getattr(cfg, "bf16", False) else "fp32")
    model = build_model(cfg, device=device)
    dataset = RGBXDataset(cfg.data_setting(), "val", ValPre())
    evaluator = SlidingEvaluator(
        model, cfg.num_classes, cfg.norm_mean, cfg.norm_std,
        multi_scales=cfg.eval_scale_array, is_flip=cfg.eval_flip,
        eval_crop_size=cfg.eval_crop_size, stride_rate=cfg.eval_stride_rate,
        device=device,
    )
    save_fn = None
    if args.save_path:
        colors = RGBXDataset.get_class_colors(max(41, cfg.num_classes))

        def save_fn(fn, pred):
            save_prediction(args.save_path, fn, pred, colors, cfg.background)

    for spec in parse_epochs(args.epochs, ckpt_dir):
        if isinstance(spec, str):  # one checkpoint file
            load_checkpoint_into_model(model, spec)
            label = spec
        else:
            raw, epoch = restore_checkpoint(ckpt_dir, None, spec)
            model.load_state_dict(raw["model"])
            label = f"epoch-{epoch}"
        miou, detail = evaluator.run(dataset, save_fn)
        print_iou(detail["iou"], detail["mean_pixel_acc"],
                  detail["pixel_acc"], list(cfg.class_names))
        logger.info("%s: mIoU %.2f", label, miou)
    return 0


if __name__ == "__main__":
    sys.exit(main())
