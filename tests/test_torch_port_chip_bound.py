"""`chip_smoke.py`'s roofline bound (`_work`, `_exps`, `_bound`) against
counts made by hand, on the CPU.

The bound is the larger of a call's bytes over the HBM rate and its
operations over the rate of the unit that runs them: the fp32 cores, the
TF32 tensor cores, and the exps over the MUFU rate (16 a clock per SM).
Held here at sigma_tiny's trunk stage 0 (the image-layout scan, x (2, 120,
160, 192), d_state 16, four chains) and at K2's SS2D call of stage 0 (two
layouts, batch 2, L 19,200), with an H100's 132 SMs at 1,980 MHz.
"""

import importlib.util
from pathlib import Path

import pytest

MUFU = 16 * 132 * 1980e6  # exps a second


@pytest.fixture(scope="module")
def smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_image_scan_bound_at_trunk0(smoke):
    kw = dict(smoke.image_scans())["trunk0"]
    assert kw == dict(B=2, H=120, W=160, dg=192, N=16)
    tokens = 2 * 120 * 160                      # 38,400 pixels
    chain_cells = 4 * tokens * 192              # 4 chains x channels
    # K10: x read and y written once (fp32), the four directions' weights
    # (192 x (192 + 32)), A / bias / D (192 x (16 + 2)) per direction
    nbytes = 2 * 4 * tokens * 192 + 4 * 4 * 192 * 224 + 4 * 4 * 192 * 18
    proj = 2 * 4 * tokens * 192 * 224           # on the TF32 cores
    ops = 9 * chain_cells * 16 + proj
    exps = chain_cells * (16 + 2)               # the decays + softplus
    assert smoke._work("scan_img_fwd", kw) == (nbytes, ops)
    assert smoke._exps("scan_img_fwd", kw) == exps
    t_bytes = nbytes / 3.35e12
    t_fp32 = (ops - proj) / 67e12
    t_exp = exps / MUFU
    assert t_exp > t_fp32 > t_bytes             # the exps bind
    got, by = smoke._bound("scan_img_fwd", kw, mufu=MUFU)
    assert by == "operations"
    assert got == pytest.approx(t_exp * 1e3, rel=1e-12)
    # without the exps' term: the fp32 cores, as the bound was counted
    old, _ = smoke._bound("scan_img_fwd", kw, mufu=float("inf"))
    assert old == pytest.approx(t_fp32 * 1e3, rel=1e-12)
    assert round(old, 4) == 0.0634 and round(got, 4) == 0.1269
    # K11: the same exps, 22 operations a state
    assert smoke._exps("scan_img_bwd", kw) == exps
    assert smoke._bound("scan_img_bwd", kw, mufu=MUFU)[0] == pytest.approx(
        (22 * chain_cells * 16) / 67e12 * 1e3, rel=1e-12)


def test_fused_scan_bound_at_ss2d0(smoke):
    kw = dict((tag, kw) for _, tag, kw in smoke.main_path_scans())["ss2d0"]
    assert kw == dict(ml=True, B=2, L=19200, dg=192, N=16)
    tok = 2 * 2 * 19200                         # batch x layouts x tokens
    # u read, y written, the weights, A / bias / D
    nbytes = 2 * 4 * tok * 192 + 4 * 2 * 192 * 224 + 4 * 2 * 192 * 19
    assert smoke._work("scan_proj_fwd", kw)[0] == nbytes
    assert smoke._exps("scan_proj_fwd", kw) == tok * 192 * 18
    got, by = smoke._bound("scan_proj_fwd", kw, mufu=MUFU)
    assert by == "operations"
    assert got == pytest.approx(tok * 192 * 18 / MUFU * 1e3, rel=1e-12)
    old, old_by = smoke._bound("scan_proj_fwd", kw, mufu=float("inf"))
    assert old_by == "bytes" and round(old, 4) == 0.0353
    # K5 runs no exp: its bound is unchanged
    assert smoke._exps("proj_grad", kw) == 0
