"""The port's FLOP accounting (`sigma_tpu_torch/utils/flops.py`) against
the JAX package's (`sigma_tpu/utils/flops.py`), on the CPU.

  * the closed forms (`selective_scan_flops`, `conmb_flops`,
    `attention_fusion_flops`) equal JAX's as integers, and `param_count`
    of the port's sigma_test EncoderDecoder equals JAX's over its params;
  * `analytic_flops_split` of the port's sigma_test EncoderDecoder
    (MambaDecoder cut to `_port_load.DS_DEPTHS` on both sides) against
    JAX's of the same model traced on its TPU route: `jax.default_backend`
    patched to return "tpu" inside the test, the trace caches cleared
    before and after. `make_jaxpr` is shape-only: no Pallas kernel lowers
    or runs. The scan tallies are equal. The matmul / conv terms differ by
    one term, named and computed here: JAX's jaxpr walk descends into each
    `pallas_call`'s kernel body and counts the dots of one grid step there
    (the in-kernel projections of one block) once per call; the port
    counts those projections only in the tally's closed form, as JAX's
    tally does too;
  * a scan entry point is opaque to the count: called under the counter
    it adds its closed form to the tally and nothing to the matmul count,
    though its plain version, called directly, dispatches counted
    products; the routes over the weight budget count their projections
    as matmuls; a nested entry point records nothing more;
  * the script prints the analytic count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu.models.builder as jbuilder
from sigma_tpu.utils import flops as jflops
from sigma_tpu_torch.models.builder import EncoderDecoder, init_parameters
from sigma_tpu_torch.ops import scan_g, scan_img
from sigma_tpu_torch.ops.selective_scan import (
    selective_scan,
    selective_scan_chunked,
    selective_scan_cl,
    selective_scan_cl_plain,
)
from sigma_tpu_torch.utils import flops
from _port_load import (  # noqa: F401 (few_torch_threads: a fixture)
    cut_decoder,
    cut_jax_decoder,
    few_torch_threads,
)


@pytest.mark.parametrize("B,L,D,N,with_D,with_Z", [
    (1, 1, 1, 1, True, False), (2, 9600, 384, 16, True, True),
    (8, 300, 3072, 4, False, False), (3, 77, 50, 40, False, True)])
def test_selective_scan_flops_equal_jax(B, L, D, N, with_D, with_Z):
    got = flops.selective_scan_flops(B, L, D, N, with_D, with_Z)
    assert got == jflops.selective_scan_flops(B, L, D, N, with_D, with_Z)
    assert isinstance(got, int)


@pytest.mark.parametrize("HW,C,d_state,ssm_ratio,dt_rank", [
    (19200, 96, 4, 2.0, None), (300, 768, 16, 2.0, None),
    (49, 33, 1, 1.5, 5)])
def test_fusion_closed_forms_equal_jax(HW, C, d_state, ssm_ratio, dt_rank):
    assert flops.conmb_flops(HW, C, d_state, ssm_ratio, dt_rank) == \
        jflops.conmb_flops(HW, C, d_state, ssm_ratio, dt_rank)
    assert flops.attention_fusion_flops(HW, C) == \
        jflops.attention_fusion_flops(HW, C)


def _kernel_body_dots(jaxpr):
    """The matmul FLOPs JAX's walk (`_jaxpr_mm_flops`) finds inside the
    kernel bodies of the pallas_calls of `jaxpr`: one grid step's dots,
    once per call."""
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            total += jflops._jaxpr_mm_flops(eqn.params["jaxpr"])
            continue
        for k in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
            sub = eqn.params.get(k)
            if sub is not None:
                total += _kernel_body_dots(getattr(sub, "jaxpr", sub))
                break
    return total


def test_model_count_matches_jax_tpu_route(monkeypatch):
    """sigma_test at 64x64, batch 1: the port's (mm, scans) against JAX's
    TPU-route analytic_flops_split (shape-only trace); param_count against
    JAX's over the same model's params."""
    cut_jax_decoder(monkeypatch)
    jmodel = jbuilder.EncoderDecoder(9, "sigma_test")
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, x))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jax.clear_caches()
    try:
        jflops._scan_tally = []
        jaxpr = jax.make_jaxpr(lambda v, a, b: jmodel.apply(v, a, b))(
            shapes, x, x)
        want_scans = sum(jflops._scan_tally)
        want_mm = jflops._jaxpr_mm_flops(jaxpr.jaxpr)
        body = _kernel_body_dots(jaxpr.jaxpr)
    finally:
        jflops._scan_tally = None
        monkeypatch.undo()
        jax.clear_caches()
    assert want_scans > 0 and body > 0

    model = cut_decoder(init_parameters(EncoderDecoder(9, "sigma_test"), 0))
    mm, scans = flops.analytic_flops_split(model.eval(), torch.zeros(
        1, 64, 64, 3), torch.zeros(1, 64, 64, 3))
    assert scans == want_scans
    assert mm == want_mm - body
    stats = flops.model_stats(model, (64, 64))
    assert (stats["flops_mm"], stats["flops_scan"]) == (mm, scans)
    assert stats["params"] == jflops.param_count(shapes["params"])
    assert flops.param_count(model.state_dict()) >= stats["params"]


def _scan_inputs(batch, G, L, dg, N, seed):
    rng = np.random.default_rng(seed)
    t = dict(u=rng.standard_normal((batch, G, L, dg)),
             w_dt=rng.standard_normal((G, dg, dg)) * 0.1 / dg ** 0.5,
             w_b=rng.standard_normal((G, dg, N)) / dg ** 0.5,
             w_c=rng.standard_normal((G, dg, N)) / dg ** 0.5,
             A=-np.exp(rng.standard_normal((G, N, dg))),
             D=rng.standard_normal((G, dg)),
             delta_bias=rng.standard_normal((G, dg)) * 0.1)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in t.items()}


def _counted(fn):
    return flops.analytic_flops_split(fn)


def test_scan_entry_points_are_opaque(monkeypatch):
    """Each entry point adds its closed form to the tally and nothing to
    the matmul count; its plain version, counted directly, dispatches
    products the entry point hides. Over the weight budget the
    projections are matmuls outside the scan, counted as such."""
    batch, G, L, dg, N = 2, 2, 40, 12, 4
    t = _scan_inputs(batch, G, L, dg, N, seed=1)
    tok = batch * G * L
    scan = 9 * tok * dg * N + tok * dg
    proj = 2 * tok * dg * (dg + 2 * N)
    p = dict(D=t["D"], delta_bias=t["delta_bias"], delta_softplus=True)
    ws = (t["w_dt"], t["w_b"], t["w_c"], t["A"])

    plain_mm, _ = _counted(lambda: scan_g.selective_scan_g_proj_plain(
        t["u"], *ws, **p))
    assert plain_mm >= proj  # its projections, at least, are products
    assert _counted(lambda: scan_g.selective_scan_g_proj(
        t["u"], *ws, **p)) == (0.0, scan + proj)
    us = (t["u"][:, 0], t["u"][:, 1])
    assert _counted(lambda: scan_g.selective_scan_g_proj_ml(
        us, *ws, **p)) == (0.0, scan + proj)
    dts, bs, cs = (t["u"] @ w for w in ws[:3])
    assert _counted(lambda: scan_g.selective_scan_g(
        t["u"], dts, t["A"], bs, cs, **p)) == (0.0, scan)

    # over the weight budget: the projections count as matmuls
    monkeypatch.setattr(scan_g, "PROJ_BUDGET_BYTES", 0)
    assert _counted(lambda: scan_g.selective_scan_g_proj(
        t["u"], *ws, **p)) == (float(proj), scan)
    assert _counted(lambda: scan_g.selective_scan_g_proj_ml(
        us, *ws, **p)) == (float(proj), scan)
    monkeypatch.undo()

    # the per-row and channel-first entry points
    rows = dict(u=t["u"].reshape(-1, L, dg), delta=dts.reshape(-1, L, dg),
                A=t["A"], B=bs.reshape(-1, L, N), C=cs.reshape(-1, L, N))
    assert _counted(lambda: selective_scan_cl(**rows, **p)) == (0.0, scan)
    assert _counted(lambda: selective_scan_cl_plain(**rows, **p))[1] == 0.0
    cf = dict(u=rows["u"].transpose(1, 2), delta=rows["delta"].transpose(
        1, 2), A=t["A"][0].t(), B=rows["B"].transpose(1, 2)[:, None],
        C=rows["C"].transpose(1, 2)[:, None])
    cf_p = dict(D=t["D"][0], delta_bias=t["delta_bias"][0],
                delta_softplus=True)
    assert _counted(lambda: selective_scan(**cf, **cf_p)) == (
        0.0, 9 * tok * dg * N + tok * dg)
    assert _counted(lambda: selective_scan_chunked(**cf, **cf_p))[1] == 0.0

    # the image scan: four chains with their projections
    b, H, W = 1, 5, 8
    x = t["u"][:b, 0, :H * W].reshape(b, H, W, dg)
    img = {k: v[:2].repeat(2, *[1] * (v.dim() - 1)).reshape(
        2, 2, *v.shape[1:]) for k, v in t.items() if k != "u"}
    chains = 4 * b * H * W
    plain_mm, _ = _counted(lambda: scan_img.selective_scan_ss2d_proj_plain(
        x, **img, delta_softplus=True))
    assert plain_mm > 0
    assert _counted(lambda: scan_img.selective_scan_ss2d_proj(
        x, **img, delta_softplus=True)) == (
        0.0, 9 * chains * dg * N + chains * dg
        + 2 * chains * dg * (dg + 2 * N))

    # around an entry point a product counts; a nested call records nothing
    lin = torch.nn.Linear(dg, 3)

    def nested():
        with flops.scan_call(7):
            scan_g.selective_scan_g(t["u"], dts, t["A"], bs, cs, **p)
        return lin(t["u"])

    assert _counted(nested) == (2.0 * tok * dg * 3, 7.0)


def test_flops_script_prints_the_analytic_count(capsys):
    flops.main(["-n", "mfnet", "--backbone", "sigma_test", "--height", "32",
                "--width", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "sigma_test+MambaDecoder @ 32x32 batch 1: params" in out
    assert "analytic GFLOPs" in out and "scan tally" in out
