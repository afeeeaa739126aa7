"""Evaluation entry point of the port (counterpart of `eval.py`).

  python -m sigma_tpu_torch.eval -n mfnet -e model.pth            # on cuda
  python -m sigma_tpu_torch.eval -n mfnet -e params.npz --device cpu
  python -m sigma_tpu_torch.eval -n mfnet -e model.pth -p out/    # + PNGs

`-e` takes a reference-named `.pt`/`.pth` state_dict or an `.npz` of JAX
params flattened with `/`-joined flax paths. Orbax epoch directories of
the JAX trainer are not read yet. `--device` defaults to cuda; the CPU is
used only when asked for.
"""

from __future__ import annotations

import argparse
import ast
import sys

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="sigma_tpu_torch evaluator")
    p.add_argument("-n", "--dataset", required=True)
    p.add_argument("--dataset-path", default=None)
    p.add_argument("-e", "--epochs", required=True, metavar="CKPT",
                   help="a .pt/.pth state_dict or an .npz of JAX params")
    p.add_argument("-p", "--save-path", default=None)
    p.add_argument("--backbone", default=None)
    p.add_argument("--decoder", default=None)
    p.add_argument("--override", action="append", default=[],
                   metavar="KEY=VAL",
                   help="config field override, repeatable; VAL is parsed "
                        "as a python literal")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if not args.epochs.endswith((".pt", ".pth", ".npz")):
        p.error("-e: the port reads .pt/.pth/.npz files; orbax epoch "
                "directories are not supported yet")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: no CUDA device (pass --device cpu to run "
                "the plain path on the CPU)")
    # fp32 means fp32 on the card: cuDNN's float32 convolutions (the 3x3
    # depthwise and CAB convs) default to TF32, and so may matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.data import RGBXDataset, ValPre
    from sigma_tpu_torch.engine.evaluator import SlidingEvaluator
    from sigma_tpu_torch.engine.logger import get_logger
    from sigma_tpu_torch.models.builder import build_model
    from sigma_tpu_torch.models.ss2d import FUSED_EPILOGUE
    from sigma_tpu_torch.utils.convert import load_checkpoint
    from sigma_tpu_torch.utils.visualize import print_iou, save_prediction

    overrides = {}
    if args.dataset_path:
        overrides["dataset_path"] = args.dataset_path
    cfg = get_config(args.dataset, **overrides)
    for field, val in (("backbone", args.backbone),
                       ("decoder", args.decoder)):
        if val is not None:
            object.__setattr__(cfg, field, val)
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass  # keep as string
        object.__setattr__(cfg, k, v)

    logger = get_logger()
    logger.info("SS2D epilogue: %s (SIGMA_FUSED_EPILOGUE)",
                "fused" if FUSED_EPILOGUE else "unfused")
    model = build_model(cfg, device="cpu")
    model.load_state_dict(load_checkpoint(args.epochs))
    model.to(device)
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

    miou, detail = evaluator.run(dataset, save_fn)
    print_iou(detail["iou"], detail["mean_pixel_acc"], detail["pixel_acc"],
              list(cfg.class_names))
    logger.info("%s: mIoU %.2f", args.epochs, miou)
    return 0


if __name__ == "__main__":
    sys.exit(main())
