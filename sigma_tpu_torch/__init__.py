"""sigma_tpu_torch — the PyTorch + CUDA port of `sigma_tpu` for one NVIDIA
H100 (Hopper, sm_90a).

Layout mirrors `sigma_tpu/` so each module's counterpart is easy to find:
  ops/        selective-scan oracles (plain torch) and the hand-written
              Hopper scan kernels behind the `pallas_scan_g` entry points,
              and the fused SS2D epilogue (`merge_ln_gate`), forward and
              backward (torch.autograd.Functions)
  csrc/       CUDA C++ sources of those kernels, built with nvcc at first use
  models/     nn.Module model zoo (VSSM trunk, fusion blocks, MambaDecoder,
              EncoderDecoder, segmentation_loss), channel-last (B, H, W, C)
              at module boundaries
  engine/     train step and optimizer, sliding-window evaluator, logger
  data/       dataset, augmentation and loader (copies of sigma_tpu/data)
  utils/      weight bridge, lr schedules, metrics, visualisation
  configs.py  the dataset presets (a copy of configs/base.py)
  train.py, eval.py   the CLIs; trace_step.py a device-time breakdown

The package imports torch and never jax, flax, `sigma_tpu` or `configs`.
Parameter names follow the reference torch `state_dict` key scheme that
`sigma_tpu/utils/convert.py::convert_sigma_full` reads.
"""
