"""Training entry point of the port (counterpart of `train.py`).

  python -m sigma_tpu_torch.train -n mfnet --dataset-path PATH     # on cuda
  python -m sigma_tpu_torch.train -n mfnet --dataset-path PATH \\
      --device cpu --steps 2 --batch-size 2 --override image_height=32 ...

One device, fp32: config by dataset name, seeded model, AdamW (or SGDM)
with warmup-poly lr, the device-norm uint8 input path, per-iteration loss
logging. At the end it saves the model's state_dict as
`<checkpoint_dir>/model.pt` (default `<log_dir>/checkpoint/model.pt`),
which `python -m sigma_tpu_torch.eval -e` reads, and, unless `--no-eval`,
evaluates it on the val split with the port's SlidingEvaluator.
`--device` defaults to cuda; the CPU is used only when asked for.

Not ported, each raising with the ROADMAP item it waits for: `-c` resume,
epoch checkpoints with best-k retention and `--pretrained` (queue A item
10), `--distributed` (item 11), `--bf16` (C4), `--profile`.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="sigma_tpu_torch trainer")
    p.add_argument("-n", "--dataset", required=True,
                   help="mfnet | pst900 | nyu | sunrgbd")
    p.add_argument("--dataset-path", default=None)
    p.add_argument("-c", "--continue", dest="resume", action="store_true",
                   help="resume from the last checkpoint (not ported)")
    p.add_argument("--backbone", default=None,
                   help="sigma_tiny | sigma_small | sigma_base")
    p.add_argument("--decoder", default=None)
    p.add_argument("--pretrained", default=None,
                   help="VMamba ImageNet checkpoint (not ported)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps", type=int, default=None,
                   help="cap total train steps (smoke tests)")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--bf16", action="store_true", help="(not ported)")
    p.add_argument("--no-eval", action="store_true")
    p.add_argument("--log-dir", default=None)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="(not ported)")
    p.add_argument("--distributed", action="store_true",
                   help="(not ported)")
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--override", action="append", default=[],
                   metavar="KEY=VAL",
                   help="config field override, repeatable; VAL is parsed "
                        "as a python literal (smoke/simulation runs)")
    p.add_argument("--device", default="cuda")
    return p, p.parse_args(argv)


_WAITING = (
    ("resume", "-c resume from orbax epoch checkpoints",
     "ROADMAP.md queue A item 10"),
    ("pretrained", "--pretrained", "ROADMAP.md queue A item 10"),
    ("distributed", "--distributed", "ROADMAP.md queue A item 11"),
    ("bf16", "--bf16", "ROADMAP.md queue C4"),
    ("profile", "--profile", "the port's bench, ROADMAP.md queue A item 12"),
)


def main(argv=None) -> int:
    parser, args = parse_args(argv)
    for attr, flag, item in _WAITING:
        if getattr(args, attr):
            raise NotImplementedError(f"{flag} is not ported ({item})")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device (pass --device cpu to "
                     "train on the CPU with the plain scan path)")
    # fp32 means fp32 on the card: cuDNN's float32 convolutions default to
    # TF32, and so may matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.data import RGBXDataset, TrainLoader, TrainPre, ValPre
    from sigma_tpu_torch.engine.evaluator import SlidingEvaluator
    from sigma_tpu_torch.engine.logger import get_logger
    from sigma_tpu_torch.engine.train import build_train
    from sigma_tpu_torch.models.ss2d import FUSED_EPILOGUE

    overrides = {}
    if args.dataset_path:
        overrides["dataset_path"] = args.dataset_path
    cfg = get_config(args.dataset, **overrides)
    for field, val in [
        ("backbone", args.backbone),
        ("decoder", args.decoder),
        ("batch_size", args.batch_size),
        ("nepochs", args.epochs),
        ("lr", args.lr),
        ("log_dir", args.log_dir),
        ("num_workers", args.num_workers),
    ]:
        if val is not None:
            object.__setattr__(cfg, field, val)
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass  # keep as string
        object.__setattr__(cfg, k, v)
    if not cfg.checkpoint_dir:
        object.__setattr__(
            cfg, "checkpoint_dir", os.path.join(cfg.log_dir, "checkpoint"))

    logger = get_logger()
    logger.info("device: %s", torch.cuda.get_device_name(device)
                if device.type == "cuda" else device)
    logger.info("SS2D epilogue: %s (SIGMA_FUSED_EPILOGUE)",
                "fused" if FUSED_EPILOGUE else "unfused")

    dataset = RGBXDataset(
        cfg.data_setting(), "train",
        TrainPre(cfg.norm_mean, cfg.norm_std, cfg,
                 device_norm=cfg.device_norm),
        file_length=cfg.batch_size * cfg.niters_per_epoch,
        seed=cfg.seed,
    )
    loader = TrainLoader(
        dataset, global_batch_size=cfg.batch_size,
        niters_per_epoch=cfg.niters_per_epoch,
        num_workers=cfg.num_workers, seed=cfg.seed,
    )

    state, train_step, schedule = build_train(cfg, device)
    model = state.model

    for epoch in range(1, cfg.nepochs + 1):
        loader.set_epoch(epoch)
        t_epoch = time.time()
        losses = []  # device scalars; synced at log points
        t_win, steps_win = time.time(), 0
        for it, batch in enumerate(loader):
            loss = train_step(state, batch)
            losses.append(loss)
            steps_win += 1
            if (it + 1) % 10 == 0 or it == 0:
                loss_now = float(loss)  # sync
                dt_win = time.time() - t_win
                logger.info(
                    "epoch %d iter %d/%d loss %.4f lr %.3e "
                    "%.0f ms/step %.1f img/s",
                    epoch, it + 1, cfg.niters_per_epoch, loss_now,
                    schedule(state.step), dt_win / steps_win * 1e3,
                    steps_win * cfg.batch_size / dt_win,
                )
                t_win, steps_win = time.time(), 0
            if args.steps and state.step >= args.steps:
                break
        mean_loss = float(torch.stack(losses).mean()) if losses else 0.0
        logger.info("epoch %d done in %.1fs mean-loss %.4f", epoch,
                    time.time() - t_epoch, mean_loss)
        if args.steps and state.step >= args.steps:
            break

    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    ckpt = os.path.join(cfg.checkpoint_dir, "model.pt")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
    logger.info("training finished (%d steps); saved %s", state.step, ckpt)

    if not args.no_eval:
        evaluator = SlidingEvaluator(
            model.eval(), cfg.num_classes, cfg.norm_mean, cfg.norm_std,
            multi_scales=cfg.eval_scale_array, is_flip=cfg.eval_flip,
            eval_crop_size=cfg.eval_crop_size,
            stride_rate=cfg.eval_stride_rate, device=device,
        )
        miou, _ = evaluator.run(
            RGBXDataset(cfg.data_setting(), "val", ValPre()))
        logger.info("mIoU %.2f", miou)
    return 0


if __name__ == "__main__":
    sys.exit(main())
