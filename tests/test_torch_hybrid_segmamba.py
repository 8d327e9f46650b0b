"""The port's hybrid SegMamba slice vs the JAX package on the CPU.

  * MambaVisionMixer (d_state 8, no z, dt_proj's bias twice) with and
    without the zero-padded SpatialStateFusion, on a 4 x 6 map;
  * SS2D on a 4 x 6 map at N 8 (h != w catches a swapped column-major
    order);
  * TransformerMambaBlock over every axis value: the default; token_mlp +
    flip_order; simple_mlp for both FFNs; effkan; cab + spatial_fusion;
    window attention on 14 x 14 without the inner residuals; ss2d;
  * the five text fusions (hslca, tgdc, film, crossattn, dual) at T 4, the
    dual's returned text too, and each returning its input without text;
  * SSConvSSM, and MedMamba (VSSM) tiny under its registry name;
  * two whole models at feat (8, 16, 24, 32), hidden 40, depths 1, 32 x 32:
    the flagship with text, and ..._CrossAttn_Dual (the hybrid block, dual
    fusion and the deep-supervision tuple);
  * VARIANTS: for all 26 names the port's axes equal the fields of JAX's
    `build_segmamba(name)` module and its blocks' fields; each port model
    builds;
  * init_parameters against JAX's initialisers for the new raw parameters.

Weights: a seeded numpy tree shaped by `jax.eval_shape` of the JAX init,
loaded into the port by `state_dict_from_jax` with a strict load; the JAX
side runs through one jit per function compiled with FAST_COMPILE.
Tolerance 1e-5 of the output's largest magnitude in fp32.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accunet_tpu.models import build as j_build_model
from accunet_tpu.models import segmamba as JS
from accunet_tpu.nn import attention as JA
from accunet_tpu.nn import ss2d as JSS
from accunet_tpu.nn import ssm as JSSM
from accunet_tpu_torch.models import build, init_parameters
from accunet_tpu_torch.models import segmamba as TS
from accunet_tpu_torch.nn import attention as TA
from accunet_tpu_torch.nn import ss2d as TSS
from accunet_tpu_torch.nn import ssm as TSSM
from tests.test_torch_spatial_mamba import TOL, _both, _port, _rel
from tests.test_torch_unext import _one_torch_thread, _variables, _x, jax_run  # noqa: F401

SIZE = dict(depths=(1, 1, 1, 1), feat_size=(8, 16, 24, 32), hidden_size=40)
HW = 32
T = 4  # text tokens


def _text(b=2, seed=5):
    return _x((b, T, 768), seed)


@pytest.mark.parametrize("spatial_fusion", [False, True])
def test_mamba_vision_mixer_matches_jax(spatial_fusion):
    """(B, L, C) tokens of a 4 x 6 map, C 16 (dh 8, dt_rank 1), N 8."""
    kw = dict(spatial_hw=(4, 6))
    got, want = _both(JSSM.MambaVisionMixer(16, spatial_fusion=spatial_fusion),
                      TSSM.MambaVisionMixer(16, spatial_fusion=spatial_fusion),
                      _x((2, 24, 16)), **kw)
    assert _rel(got.numpy(), want) <= TOL


def test_ss2d_matches_jax():
    got, want = _both(JSS.SS2D(8, d_state=8), TSS.SS2D(8, d_state=8), _x((2, 4, 6, 8)))
    assert got.shape == (2, 4, 6, 8) and _rel(got.numpy(), want) <= TOL


def test_ss_conv_ssm_matches_jax():
    got, want = _both(JSS.SSConvSSM(16), TSS.SSConvSSM(16), _x((2, 4, 6, 16)))
    assert _rel(got.numpy(), want) <= TOL


TMB_CASES = {
    "default": ({}, 6),
    "token_mlp_flip": (dict(ffn2_type="token_mlp", flip_order=True), 6),
    "simple_mlp": (dict(ffn1_type="simple_mlp", ffn2_type="simple_mlp"), 6),
    "effkan": (dict(ffn2_type="effkan"), 6),
    "cab_spatial": (dict(ffn2_type="cab", spatial_fusion=True), 6),
    "window_no_inner": (dict(attn_type="window", inner_residuals=False), 14),
    "ss2d": (dict(mixer_type="ss2d"), 6),
}


@pytest.mark.parametrize("case", list(TMB_CASES))
def test_transformer_mamba_block_matches_jax(case):
    kw, hw = TMB_CASES[case]
    got, want = _both(JS.TransformerMambaBlock(8, **kw), TS.TransformerMambaBlock(8, **kw),
                      _x((2, hw, hw, 8)))
    assert _rel(got.numpy(), want) <= TOL


FUSIONS = {"hslca": (JA.HSLCAFusion, TA.HSLCAFusion), "tgdc": (JA.TGDCFusion, TA.TGDCFusion),
           "film": (JA.SkipFiLM, TA.SkipFiLM),
           "crossattn": (JA.CrossAttentionFusion, TA.CrossAttentionFusion),
           "dual": (JA.DualCrossAttentionFusion, TA.DualCrossAttentionFusion)}


@pytest.mark.parametrize("name", list(FUSIONS))
def test_text_fusion_matches_jax(name):
    """A (2, 4, 6, 12) map and (2, 4, 768) text; the dual's updated text too.
    Without text each returns its input."""
    jcls, tcls = FUSIONS[name]
    x, t = _x((2, 4, 6, 12)), _text()
    got, want = _both(jcls(12), tcls(12), x, t)
    if name == "dual":
        assert got[1].shape == (2, T, 768) and _rel(got[1].numpy(), want[1]) <= TOL
        got, want = got[0], want[0]
    assert got.shape == x.shape and _rel(got.numpy(), want) <= TOL
    out = tcls(12)(torch.from_numpy(x), None)
    assert (out[0] if name == "dual" else out) is not None
    np.testing.assert_array_equal((out[0] if name == "dual" else out).numpy(), x)


def test_medmamba_matches_jax():
    """VSSM under its registry name, depths 1, dims (8, 16, 32, 64), 32 x 32,
    eval mode."""
    kw = dict(n_channels=3, num_classes=5, depths=(1, 1, 1, 1), dims=(8, 16, 32, 64))
    x = _x((2, HW, HW, 3))
    jmod = j_build_model("MedMamba", **kw)
    v = _variables(jmod, x)
    want = jax_run(lambda vv, xx: jmod.apply(vv, xx), v, jnp.asarray(x))
    with torch.no_grad():
        got = _port(build("MedMamba", **kw), v)(torch.from_numpy(x))
    assert got.shape == (2, 5) and _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("name", ["Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA_SpatialMamba",
                                  "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_Dual"])
def test_text_model_matches_jax(name):
    """The whole model with text; the flagship gives one output, the Dual
    rung the (main, ds1, ds2, ds3) tuple."""
    x, t = _x((2, HW, HW, 3)), _text()
    jmod = JS.build_segmamba(name, in_chans=3, out_chans=2, **SIZE)
    v = _variables(jmod, x, t)
    want = jax_run(lambda vv, xx, tt: jmod.apply(vv, xx, tt), v, jnp.asarray(x), jnp.asarray(t))
    port = _port(TS.build_segmamba(name, in_chans=3, out_chans=2, **SIZE), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t))
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want) == (4 if "Dual" in name else 1)
    for p, q in zip(got, want):
        assert p.shape == (2, HW, HW, 2) and _rel(p.numpy(), q) <= TOL


TMB_AXES = ("attn_type", "ffn1_type", "ffn2_type", "mixer_type", "spatial_fusion",
            "flip_order", "inner_residuals")


@pytest.mark.parametrize("name", list(JS.VARIANTS))
def test_variant_axes_match_jax(name):
    """The port's VARIANTS entry against the fields of JAX's module (no
    trace), the blocks' axes against JAX's TransformerMambaBlock fields, and
    the port model builds at a tiny size."""
    jmod = JS.build_segmamba(name)
    for field, value in TS.VARIANTS[name].items():
        assert getattr(jmod, field) == value, field
    assert set(TS.VARIANTS) == set(JS.VARIANTS)
    port = build(name, in_chans=3, out_chans=2, **SIZE)
    blocks = [blk for stage in port.vit.stages for blk in stage]
    if jmod.block == "tmb":
        jblock = JS.TransformerMambaBlock(8, **dict(jmod.block_kwargs or {}))
        for blk in blocks:
            assert isinstance(blk, TS.TransformerMambaBlock)
            assert {a: getattr(blk, a) for a in TMB_AXES} == {a: getattr(jblock, a)
                                                              for a in TMB_AXES}
    fuse_hidden = any(s.endswith("_hidden") for s in port.fusion_sites)
    assert len(port.fusion_sites) == (0 if jmod.text_fusion is None else 4 + fuse_hidden)


def test_init_parameters_follow_jax_initialisers():
    """The deterministic initialisers of the new raw parameters equal
    JAX's; the random ones (lecun-normal of SS2D's (K, a, b) parameters,
    xavier-uniform, normal(0.02)) keep JAX's bound and spread."""
    from accunet_tpu.models import swin_unet as JSW
    from accunet_tpu_torch.models import swin_unet as TSW

    def tinit(mod):
        return init_parameters(mod, torch.Generator().manual_seed(0))

    x, t = _x((1, 7, 7, 32)), _text(1)
    tok = x.reshape(1, 49, 32)
    jmods = [(JSS.SS2D(32, d_state=8), (x,)),
             (JSSM.MambaVisionMixer(32, spatial_fusion=True), (tok,)),
             (JA.MDTAAttention(32, 4), (x,)), (JA.TGDCFusion(32), (x, t)),
             (JA.CrossAttentionFusion(32), (x, t)), (JSW.WindowAttention(32, 7, 4), (tok,))]

    def init_all(key):  # one compile for the six initialisations
        return [m.init(key, *map(jnp.asarray, xs))["params"] for m, xs in jmods]

    jss, jm, jd, jg, jc, jw = jax_run(init_all, jax.random.PRNGKey(0))
    tss, tm = tinit(TSS.SS2D(32, d_state=8)), tinit(TSSM.MambaVisionMixer(32, spatial_fusion=True))
    td, tg = tinit(TA.MDTAAttention(32, 4)), tinit(TA.TGDCFusion(32))
    tc, tw = tinit(TA.CrossAttentionFusion(32)), tinit(TSW.WindowAttention(32, 7, 4))
    same = [(tss.A_logs, jss["A_logs"]), (tss.Ds, jss["Ds"]),
            (tss.dt_projs_bias, jss["dt_projs_bias"]), (tm.A_log, jm["A_log"]), (tm.D, jm["D"]),
            (tm.spatial_fusion_mod.alpha, jm["spatial_fusion_mod"]["alpha"]),
            (td.temperature, jd["temperature"]), (tg.tgdc.gamma, jg["tgdc"]["gamma"]),
            (tc.attn.in_proj_bias, jc["attn"]["in_proj_bias"])]
    for got, want in same:
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6)
    spread = [(tss.x_proj_weight, jss["x_proj_weight"]),
              (tss.dt_projs_weight, jss["dt_projs_weight"]),
              (tc.attn.in_proj_weight, jc["attn"]["in_proj_weight"]),
              (tw.relative_position_bias_table, jw["relative_position_bias_table"])]
    for i, (got, want) in enumerate(spread):
        got = got.detach().numpy()
        assert got.shape == want.shape
        if i < 3:  # truncated at 2 sigma, or uniform: the same bound
            assert np.abs(got).max() <= np.abs(want).max() * 1.05
        assert 0.75 <= got.std() / want.std() <= 1.25
