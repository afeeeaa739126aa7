"""Data parallelism of the port (counterpart of `sigma_tpu/parallel/`):
one process per card over `torch.distributed` (`dist.py`)."""
