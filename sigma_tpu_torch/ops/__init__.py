"""Selective-scan ops: the plain PyTorch versions, the Hopper scan kernels
and the JAX package's public ops API (`sigma_tpu.ops`), with
`selective_scan_chunked` as the counterpart of `selective_scan_xla`."""

from sigma_tpu_torch.ops.scan_layout import (
    cross_merge,
    cross_merge_multimodal,
    cross_scan,
    cross_scan_multimodal,
)
from sigma_tpu_torch.ops.selective_scan import (
    selective_scan,
    selective_scan_chunked,
    selective_scan_cl,
    selective_scan_ref,
)

__all__ = [
    "selective_scan",
    "selective_scan_cl",
    "selective_scan_ref",
    "selective_scan_chunked",
    "cross_scan",
    "cross_merge",
    "cross_scan_multimodal",
    "cross_merge_multimodal",
]
