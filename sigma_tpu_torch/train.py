"""Training entry point of the port (counterpart of `train.py`).

  python -m sigma_tpu_torch.train -n mfnet --dataset-path PATH     # on cuda
  python -m sigma_tpu_torch.train -n mfnet --dataset-path PATH -c  # resume
  python -m sigma_tpu_torch.train -n mfnet --dataset-path PATH \\
      --device cpu --steps 2 --batch-size 2 --override image_height=32 ...

One device, fp32 or, with `--bf16`, bf16 compute (fp32 parameters,
LayerNorms, scan state and loss, as the JAX trainer's `--bf16`): config by
dataset name, seeded model (`--backbone`: Sigma, MiT or Swin),
`--pretrained` VMamba trunk ingest (Sigma backbones only: with MiT or
Swin it raises, naming utils/convert.py's dual-path loaders), AdamW (or
SGDM) with warmup-poly lr, the device-norm uint8 input path,
per-iteration loss logging, and the JAX trainer's epoch loop: on a
checkpoint epoch (`checkpoint_start_epoch`, `checkpoint_step`, the last
epoch, or the end of `--steps`) the state is saved under
`<checkpoint_dir>/epoch-N` (default `<log_dir>/checkpoint`; async with
`async_checkpoint`; engine/checkpoint.py), then, unless `--no-eval`, the
val split is scored (`<log_dir>/val_epoch_N.log`, `val_last.log`,
`val_scores.json`) and all but the best `keep_best_k` epochs are pruned.
`-c` restores the model, the optimizer and the step from the last
checkpoint and goes on at the next epoch; `--steps` counts this run's
steps. `python -m sigma_tpu_torch.eval -e` reads the epoch checkpoints.
`--device` defaults to cuda; the CPU is used only when asked for.

`--distributed`: data parallel, one process per card under torchrun,

  python -m torch.distributed.run --nproc_per_node=N \\
      -m sigma_tpu_torch.train -n mfnet --dataset-path PATH --distributed

(NCCL; `--device cpu`: gloo). The global batch is `batch_size`; each rank
loads its `batch_size / N` shard and the step is the one-process step on
the whole global batch (engine/train.py). Every rank evaluates its share
of the val split and saves collectively (rank 0 writes); rank 0 alone
logs, writes tensorboard, `val_epoch_N.log` and `val_scores.json`, and
prunes.

`--profile DIR`: torch.profiler (CPU activity, and CUDA activity on the
card) over steps 20-29 of the run's first epoch, as the JAX trainer's
jax.profiler window (iters 20..30): started before step 20, stopped
before step 30 or at the end of the epoch, the device synchronised
first; the Chrome trace is written to DIR/trace_rank<R>.json (one file
per rank under `--distributed`, R = 0 on one process) and the log says
"profiler trace written to DIR".
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
import time

import torch

from sigma_tpu_torch.parallel import dist


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="sigma_tpu_torch trainer")
    p.add_argument("-n", "--dataset", required=True,
                   help="mfnet | pst900 | nyu | sunrgbd")
    p.add_argument("--dataset-path", default=None)
    p.add_argument("-c", "--continue", dest="resume", action="store_true",
                   help="resume from the last checkpoint")
    p.add_argument("--backbone", default=None,
                   help="sigma_tiny | sigma_small | sigma_base | mit_b0-b5 "
                        "| swin_s | swin_b")
    p.add_argument("--decoder", default=None)
    p.add_argument("--pretrained", default=None,
                   help="VMamba ImageNet checkpoint (.pth/.npz) for the "
                        "trunk")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps", type=int, default=None,
                   help="cap this run's train steps (smoke tests)")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute, fp32 parameters (cfg.bf16)")
    p.add_argument("--no-eval", action="store_true")
    p.add_argument("--log-dir", default=None)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of steps 20..30 of "
                        "the first epoch into DIR (Chrome trace JSON, one "
                        "file per rank)")
    p.add_argument("--distributed", action="store_true",
                   help="data parallel over torchrun's processes")
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--override", action="append", default=[],
                   metavar="KEY=VAL",
                   help="config field override, repeatable; VAL is parsed "
                        "as a python literal (smoke/simulation runs)")
    p.add_argument("--device", default="cuda")
    return p, p.parse_args(argv)


class ProfileWindow:
    """`--profile DIR`: torch.profiler over the steps [START, STOP) of the
    run's first epoch (the JAX trainer's window). Call `before_step(n)`
    with the run's step count before each step of that epoch and `end()`
    after it."""

    START, STOP = 20, 30

    def __init__(self, out_dir, device, logger):
        self.out_dir, self.device, self.logger = out_dir, device, logger
        self.prof = None

    def before_step(self, total_steps):
        if total_steps == self.START:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
        elif total_steps == self.STOP:
            self.end()

    def end(self):
        """Stop a running window and write its trace."""
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        self.prof.export_chrome_trace(
            os.path.join(self.out_dir, f"trace_rank{dist.rank()}.json"))
        self.prof = None
        self.logger.info("profiler trace written to %s", self.out_dir)


def main(argv=None) -> int:
    parser, args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device (pass --device cpu to "
                     "train on the CPU with the plain scan path)")
    if args.distributed:
        device = dist.init_distributed(device.type)
    try:
        return _train(args, device)
    finally:
        dist.shutdown()


def _train(args, device) -> int:
    # fp32 means fp32 on the card: cuDNN's float32 convolutions default to
    # TF32, and so may matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # and a bf16 product accumulates in fp32 and rounds once, as the
    # reference's does: cuBLAS may otherwise sum split-K partials in bf16
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    # and a step reruns bit for bit, so -c resumes the run it continues:
    # cuDNN's default backward algorithms for the convolutions are not
    # deterministic (ROADMAP C10)
    torch.backends.cudnn.deterministic = True

    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.data import RGBXDataset, TrainLoader, TrainPre, ValPre
    from sigma_tpu_torch.engine.checkpoint import (
        finalize_checkpoints,
        load_val_scores,
        prune_checkpoints,
        restore_checkpoint,
        save_checkpoint,
        save_val_scores,
    )
    from sigma_tpu_torch.engine.evaluator import SlidingEvaluator
    from sigma_tpu_torch.engine.logger import get_logger
    from sigma_tpu_torch.engine.train import build_train
    from sigma_tpu_torch.models.sigma_encoder import SIGMA_VARIANTS
    from sigma_tpu_torch.models.ss2d import FUSED_EPILOGUE
    from sigma_tpu_torch.utils.convert import load_vmamba_into_model

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
        ("pretrained_model", args.pretrained),
        ("log_dir", args.log_dir),
        ("num_workers", args.num_workers),
        ("bf16", args.bf16 or None),
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
    if cfg.pretrained_model and cfg.backbone not in SIGMA_VARIANTS:
        # as in the JAX trainer, --pretrained is the VMamba trunk's ingest
        raise ValueError(
            f"--pretrained loads a VMamba trunk into a Sigma backbone; "
            f"{cfg.backbone} takes a released single-trunk file through "
            f"sigma_tpu_torch.utils.convert.load_mit_dualpath (MiT) or "
            f"load_swin_dualpath (Swin)")

    logger = get_logger()
    logger.info("device: %s", torch.cuda.get_device_name(device)
                if device.type == "cuda" else device)
    if dist.data_parallel():
        logger.info("data parallel: %d processes, %d samples each",
                    dist.world(), cfg.batch_size // dist.world())
    logger.info("SS2D epilogue: %s (SIGMA_FUSED_EPILOGUE)",
                "fused" if FUSED_EPILOGUE else "unfused")
    logger.info("compute dtype: %s (parameters fp32)",
                "bf16" if cfg.bf16 else "fp32")

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
        num_workers=cfg.num_workers, process_index=dist.rank(),
        process_count=dist.world(), seed=cfg.seed,
    )

    state, train_step, schedule = build_train(cfg, device)
    model = state.model
    if cfg.pretrained_model:
        load_vmamba_into_model(model, cfg.pretrained_model)
        logger.info("loaded pretrained backbone: %s", cfg.pretrained_model)

    start_epoch = 1
    if args.resume:
        state, last_epoch = restore_checkpoint(cfg.checkpoint_dir, state)
        start_epoch = last_epoch + 1
        logger.info("resumed from epoch %d (step %d)", last_epoch,
                    state.step)

    tb = None
    if cfg.log_dir and dist.is_main():
        try:
            from tensorboardX import SummaryWriter
            tb = SummaryWriter(os.path.join(cfg.log_dir, "tb"))
        except Exception:
            pass

    evaluator = val_dataset = None
    best_miou, best_epoch = -1.0, -1
    # (mIoU, epoch) history for best-k retention; reloaded on -c so that
    # pruning never discards the best checkpoints kept before the resume
    val_scores = load_val_scores(cfg.checkpoint_dir) if args.resume else []
    for m, e in val_scores:
        if m > best_miou:
            best_miou, best_epoch = m, e
    if not args.no_eval:
        val_dataset = RGBXDataset(cfg.data_setting(), "val", ValPre())
        evaluator = SlidingEvaluator(
            model, cfg.num_classes, cfg.norm_mean, cfg.norm_std,
            multi_scales=cfg.eval_scale_array, is_flip=cfg.eval_flip,
            eval_crop_size=cfg.eval_crop_size,
            stride_rate=cfg.eval_stride_rate, device=device,
        )

    total_steps = 0  # this run's steps; state.step counts every update
    for epoch in range(start_epoch, cfg.nepochs + 1):
        loader.set_epoch(epoch)
        t_epoch = time.time()
        losses = []  # device scalars; synced at log points
        t_win, steps_win = time.time(), 0
        window = (ProfileWindow(args.profile, device, logger)
                  if args.profile and epoch == start_epoch else None)
        for it, batch in enumerate(loader):
            if window is not None:
                window.before_step(total_steps)
            loss = train_step(state, batch)
            losses.append(loss)
            total_steps += 1
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
            if args.steps and total_steps >= args.steps:
                break
        if window is not None:
            # the epoch (or the run) ended before the in-loop stop
            window.end()
        mean_loss = float(torch.stack(losses).mean()) if losses else 0.0
        logger.info("epoch %d done in %.1fs mean-loss %.4f", epoch,
                    time.time() - t_epoch, mean_loss)
        if tb is not None:
            tb.add_scalar("train_loss", mean_loss, epoch)

        stop = bool(args.steps and total_steps >= args.steps)
        should_ckpt = (
            epoch >= cfg.checkpoint_start_epoch
            and epoch % cfg.checkpoint_step == 0
        ) or epoch == cfg.nepochs or stop
        if should_ckpt:
            save_checkpoint(cfg.checkpoint_dir, state, epoch,
                            async_save=cfg.async_checkpoint)
            if evaluator is not None:
                model.eval()  # the train step sets train mode again
                # every rank scores its share; all get the set's mIoU
                miou, detail = evaluator.run(val_dataset)
                logger.info("epoch %d mIoU %.2f", epoch, miou)
                val_scores.append((miou, epoch))
                if miou > best_miou:
                    best_miou, best_epoch = miou, epoch
                logger.info("best mIoU %.2f @ epoch %d", best_miou,
                            best_epoch)
                if dist.is_main():
                    write_val_log(cfg.log_dir, epoch, miou, detail["iou"])
                    if tb is not None:
                        tb.add_scalar("val_miou", miou, epoch)
                    save_val_scores(cfg.checkpoint_dir, val_scores)
                    # best-k retention (k=1 is the reference's best-only
                    # policy)
                    k = max(1, cfg.keep_best_k)
                    prune_checkpoints(cfg.checkpoint_dir, [
                        e for _, e in sorted(val_scores, reverse=True)[:k]])
        if stop:
            break

    finalize_checkpoints()  # drain an in-flight async save
    logger.info("training finished (%d steps)", total_steps)
    return 0


def write_val_log(log_dir, epoch, miou, iou):
    """`<log_dir>/val_epoch_N.log` (the epoch's mIoU, then each class's
    IoU in percent) and the `val_last.log` link to it, as the JAX trainer
    writes them."""
    if not log_dir:
        return
    os.makedirs(log_dir, exist_ok=True)
    val_path = os.path.join(log_dir, f"val_epoch_{epoch}.log")
    with open(val_path, "w") as f:
        f.write(f"epoch {epoch} mIoU {miou:.4f}\n")
        for i, x in enumerate(iou):
            f.write(f"class {i}: {x * 100:.3f}\n")
    last = os.path.join(log_dir, "val_last.log")
    if os.path.islink(last) or os.path.exists(last):
        os.remove(last)
    os.symlink(os.path.abspath(val_path), last)


if __name__ == "__main__":
    sys.exit(main())
