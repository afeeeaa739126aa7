"""The number format of K5's tensor-core products (`csrc/tc_gemm.cuh`), on
the CPU.

K5 contracts u with the scan's cotangents over every token of a train
step, 76,800 at trunk stage 0 (batch 2, RGB and X stacked, 120 x 160
tokens) and at ConMB stage 0 (batch 2, 2 x 19,200 tokens). Its MMAs take
TF32 operands (10 mantissa bits, rounded to nearest, ties away: the
kernel's cvt.rna.tf32.f32) with fp32 accumulation. Emulated here in
torch, at that full contraction and a reduced width: one TF32 product
per pair (1xTF32), and the 3xTF32 split (a = a_hi + a_lo,
acc += a_lo b_hi + a_hi b_lo + a_hi b_hi), each against fp64, with plain
fp32 beside them. The gate is the fp32 gradient tier, rtol 6e-4 / atol
2e-3 against max(|ref|, 1), as chip_smoke.py holds K5's gradients.
Both meet it; K5 runs 1xTF32 (`kSplitK5` in csrc/scan_g_bwd.cu), at a
third of 3xTF32's MMAs, and K2's fp32 projection runs 3xTF32.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)
RTOL, ATOL = 6e-4, 2e-3
TOKENS = 76_800  # the longest contraction of sigma_tiny's train step


def tf32(x):
    """x rounded to TF32: 13 low mantissa bits dropped, to nearest with
    ties away from zero (on the magnitude of the sign-magnitude bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product_1x(a, b):
    return tf32(a).T @ tf32(b)


def product_3x(a, b):
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al.T @ bh + ah.T @ bl + ah.T @ bh


def product_fp32(a, b):
    return a.T @ b


@pytest.fixture(scope="module")
def operands():
    """u as the scan sees it (silu of a normal), cotangents normal: the
    weight gradient u^T [dd | dB | dC] at dg 32, N 4."""
    rng = np.random.default_rng(0)
    u = torch.nn.functional.silu(torch.from_numpy(
        rng.standard_normal((TOKENS, 32)).astype(np.float32)))
    z = torch.from_numpy(rng.standard_normal((TOKENS, 40)).astype(np.float32))
    return u, z, u.double().T @ z.double()


def _scaled_err(got, ref):
    return float((got.double() - ref).abs().max()) / max(
        float(ref.abs().max()), 1.0)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 3 * 2.0 ** -11)])
    assert tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0,
                                -(1.0 + 2.0 ** -9)]


@pytest.mark.parametrize("name,product", [("1xTF32", product_1x),
                                          ("3xTF32", product_3x)])
def test_tf32_products_meet_the_fp32_gradient_tier(operands, name, product):
    """Both meet the tier at 76,800 tokens: 1xTF32 at about 3e-4 of
    max(|ref|, 1) (seven times inside the 2e-3 atol), 3xTF32 at plain
    fp32's error."""
    u, z, ref = operands
    got = product(u, z)
    scale = max(float(ref.abs().max()), 1.0)
    np.testing.assert_allclose(got.double() / scale, ref / scale, rtol=RTOL,
                               atol=ATOL)


def test_3xtf32_is_fp32_class_and_1xtf32_is_not(operands):
    """3xTF32's error is plain fp32's (within 2x); 1xTF32's, which K5
    runs, is two orders of magnitude above it and still inside the tier
    (the test above)."""
    u, z, ref = operands
    fp32 = _scaled_err(product_fp32(u, z), ref)
    assert _scaled_err(product_3x(u, z), ref) <= 2 * fp32
    assert _scaled_err(product_1x(u, z), ref) >= 100 * fp32
