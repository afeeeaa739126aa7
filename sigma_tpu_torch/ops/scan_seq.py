"""Per-row channel-last selective scan on Hopper: the counterpart of
`sigma_tpu/ops/pallas_scan_seq.py::selective_scan_seq_cl`, reached by
`selective_scan_cl(backend="pallas")` and by the grouped scan when its
planner returns no plan (pallas_scan_g.py:1493-1512).

Rows (batch*G, L, dg) are (batch, G) flattened batch-major, and row r
scans with A[r % G]. That is the grouped operand (batch, G, L, dg) of
`ops/scan_g.py` viewed without a copy, so the rows run on K1 forward and
K3 backward (`_ScanG`), with the bias, the softplus and the D skip applied
in-kernel. The JAX package holds the two layouts equal too
(`tests/test_pallas_scan_g.py::test_matches_seq_rows_exactly`). The TPU
needed a second kernel pair only to lay the chains on its tiles.

Inputs are cast to fp32 first, as JAX does (pallas_scan_seq.py:299-311),
so a bf16 call with a gradient runs the fp32 backward; y takes u's dtype.
K1/K3 take d_state <= 16; a wider state runs as slices of at most 16
states (`scan_g.split_state`, ROADMAP C6). CPU tensors take the plain
version; a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

from sigma_tpu_torch.ops import scan_g
from sigma_tpu_torch.ops.selective_scan import selective_scan_cl_plain
from sigma_tpu_torch.utils import flops as _flops


def selective_scan_seq_cl(u, delta, A, B, C, D=None, delta_bias=None,
                          delta_softplus=False):
    """u, delta: (bg, L, dg), bg = batch*G; A: (G, N, dg) negative;
    B, C: (bg, L, N); D, delta_bias: (G, dg) optional. Returns y
    (bg, L, dg), fp32 compute, dtype-preserving."""
    bg, L, dg = u.shape
    with _flops.scan_call(_flops.selective_scan_flops(
            bg, L, dg, A.shape[1], D is not None)):
        return _seq_cl(u, delta, A, B, C, D, delta_bias, delta_softplus)


def _seq_cl(u, delta, A, B, C, D, delta_bias, delta_softplus):
    if not scan_g._on_cuda(u, delta, A, B, C, D, delta_bias):
        return selective_scan_cl_plain(u, delta, A, B, C, D, delta_bias,
                                       delta_softplus)
    bg, L, dg = u.shape
    G, N, _ = A.shape
    if bg % G:
        raise ValueError(f"{bg} rows are not batch-major (batch, {G}) rows")
    grouped = (bg // G, G, L)
    y = scan_g.selective_scan_g(
        u.float().reshape(*grouped, dg), delta.float().reshape(*grouped, dg),
        A.float(), B.float().reshape(*grouped, N),
        C.float().reshape(*grouped, N),
        None if D is None else D.float(),
        None if delta_bias is None else delta_bias.float(),
        delta_softplus,
    )
    return y.reshape(bg, L, dg).to(u.dtype)


__all__ = ["selective_scan_seq_cl"]
