"""The port's Spatial-Mamba slice vs the JAX package on the CPU.

  * `selective_scan_rh` (plain version) against JAX's with bias and softplus,
    N 16 and 1, L not a multiple of a chunk; its plain backward against
    `jax.vjp` of JAX's function and against torch autograd of the plain
    forward in float64;
  * StateFusion, StructureAwareSSM, SpatialMambaBlock (MLP and KAN FFN),
    KANLinear, FKANMLP and GSC;
  * Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA_SpatialMamba_no_text at
    feat (8, 16, 24, 32), hidden 40, depths (1, 1, 1, 1), 32x32, 3 channels
    in and out: its four outputs, and its axes against the fields of JAX's
    module;
  * ds_adapter and multiclass_dice_ce on a deep-supervision tuple: values
    and gradients on fixed logits;
  * the SpatialMamba classifier under both registry names (d_state 1 and 16);
  * init_parameters against JAX's initialisers;
  * the train CLI with the variant on the CPU (two classes, one epoch, then
    --resume auto), and the binary run that raises naming --n-classes.

Weights: a seeded numpy tree shaped by `jax.eval_shape` of the JAX init,
loaded into the port by `state_dict_from_jax` with a strict load; the JAX
side runs through one jit per function compiled with FAST_COMPILE. Tolerance
1e-5 of the output's largest magnitude in fp32 (the same formulas; scans and
sums associate differently); the float64 gradients to 1e-10.
"""

import math
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accunet_tpu.models import build as j_build_model
from accunet_tpu.models import segmamba as JS
from accunet_tpu.nn import kan as JK
from accunet_tpu.nn import ssm as JSSM
from accunet_tpu.ops.selective_scan import selective_scan_rh as j_scan_rh
from accunet_tpu.train import losses as JL
from accunet_tpu_torch.models import build, init_parameters
from accunet_tpu_torch.models import segmamba as TS
from accunet_tpu_torch.nn import kan as TK
from accunet_tpu_torch.nn import ssm as TSSM
from accunet_tpu_torch.ops.kernels import selective_scan as SS
from accunet_tpu_torch.ops.selective_scan import selective_scan_rh
from accunet_tpu_torch.port import state_dict_from_jax
from accunet_tpu_torch.train import losses as TL
from tests.test_torch_unext import _one_torch_thread, _variables, _x, jax_run  # noqa: F401

VARIANT = "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA_SpatialMamba_no_text"
SIZE = dict(depths=(1, 1, 1, 1), feat_size=(8, 16, 24, 32), hidden_size=40)
HW = 32
TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port(module, variables):
    module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return module.eval()


def _both(jmod, tmod, *inputs, **kw):
    """(port output, JAX output) of one module on the same numpy inputs and
    the same weights."""
    v = _variables(jmod, *inputs, **kw)
    want = jax_run(lambda vv, *xs: jmod.apply(vv, *xs, **kw), v, *map(jnp.asarray, inputs))
    with torch.no_grad():
        got = _port(tmod, v)(*map(torch.from_numpy, inputs), **kw)
    return got, want


def _scan_inputs(b, l, d, n, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((b, d, l)), 0.5 * rs.standard_normal((b, d, l)),
            -np.exp(0.3 * rs.standard_normal((d, n))), rs.standard_normal((b, n, l)),
            0.1 * rs.standard_normal(d))


@pytest.mark.parametrize("n", [16, 1])
def test_selective_scan_rh_matches_jax(n):
    """h (B, D, N, L) at L 300 (two chunks of 128 and a partial one)."""
    ops = [a.astype(np.float32) for a in _scan_inputs(2, 300, 5, n)]
    want = jax_run(lambda *a: j_scan_rh(*a, delta_softplus=True), *ops)
    got = selective_scan_rh(*map(torch.from_numpy, ops), delta_softplus=True)
    assert got.shape == (2, 5, n, 300)
    assert _rel(got.numpy(), want) <= TOL


def test_selective_scan_rh_backward_matches_jax_and_autograd():
    """The plain backward (du, ddelta, dA, dB, dbias) against jax.vjp of
    JAX's function (fp32, 1e-5) and against torch autograd of the plain
    forward (float64, 1e-10), with a cotangent of h in the kernel's (B, L,
    D, N) layout."""
    b, l, d, n = 2, 300, 5, 16
    ops = _scan_inputs(b, l, d, n)
    gh = np.random.RandomState(1).standard_normal((b, l, d, n))
    ops32, gh32 = [a.astype(np.float32) for a in ops], gh.astype(np.float32)

    def jvjp(u, delta, A, B, bias, g):
        _, pull = jax.vjp(lambda *a: j_scan_rh(*a, delta_softplus=True), u, delta, A, B, bias)
        return pull(g.transpose(0, 2, 3, 1))  # JAX's h is (B, D, N, L)

    want = jax_run(jvjp, *ops32, gh32)
    got = SS.selective_scan_rh_bwd_plain(*map(torch.from_numpy, ops32), True,
                                         torch.from_numpy(gh32))
    for name, p, q in zip(("du", "ddelta", "dA", "dB", "dbias"), got, want):
        assert _rel(p.numpy(), q) <= TOL, name
    t64 = [torch.from_numpy(a).requires_grad_(True) for a in ops]
    ref = torch.autograd.grad(SS.selective_scan_rh_fwd_plain(*t64, True), t64,
                              torch.from_numpy(gh))
    got64 = SS.selective_scan_rh_bwd_plain(*[t.detach() for t in t64], True,
                                           torch.from_numpy(gh))
    for p, q in zip(got64, ref):
        assert float((p - q).abs().max()) <= 1e-10 * max(float(q.abs().max()), 1.0)


def test_selective_scan_rh_fn_on_cpu_launches_nothing():
    ops = [torch.from_numpy(a.astype(np.float32)).requires_grad_(True)
           for a in _scan_inputs(1, 70, 3, 4)]
    counts = (SS.selective_scan_rh_fwd.launches, SS.selective_scan_rh_bwd.launches)
    h = selective_scan_rh(*ops, delta_softplus=True)
    h.square().sum().backward()
    assert (SS.selective_scan_rh_fwd.launches, SS.selective_scan_rh_bwd.launches) == counts
    assert all(t.grad is not None for t in ops)


MODULES = {
    "StateFusion": (lambda: JSSM.StateFusion(12), lambda: TSSM.StateFusion(12), (2, 9, 7, 12)),
    "StructureAwareSSM": (lambda: JSSM.StructureAwareSSM(8), lambda: TSSM.StructureAwareSSM(8),
                          (2, 8, 6, 8)),
    "SpatialMambaBlock": (lambda: JSSM.SpatialMambaBlock(8), lambda: TSSM.SpatialMambaBlock(8),
                          (2, 8, 8, 8)),
    "SpatialMambaBlock_kan": (lambda: JSSM.SpatialMambaBlock(8, mlp_type="kan"),
                              lambda: TSSM.SpatialMambaBlock(8, mlp_type="kan"), (2, 6, 6, 8)),
    "SpatialMambaBlock_n1": (lambda: JSSM.SpatialMambaBlock(8, d_state=1),
                             lambda: TSSM.SpatialMambaBlock(8, d_state=1), (1, 5, 7, 8)),
    "KANLinear": (lambda: JK.KANLinear(6, 10), lambda: TK.KANLinear(6, 10), (13, 6)),
    "FKANMLP": (lambda: JK.FKANMLP(8, 32), lambda: TK.FKANMLP(8, 32), (2, 20, 8)),
    "GSC": (lambda: JS.GSC(6), lambda: TS.GSC(6), (2, 8, 8, 6)),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_module_matches_jax(name):
    jmod, tmod, shape = MODULES[name]
    # KANLinear's grid spans (-1, 1): inputs inside and outside it
    got, want = _both(jmod(), tmod(), 1.5 * _x(shape))
    assert _rel(got.numpy(), want) <= TOL


@pytest.fixture(scope="module")
def variant_pair():
    """(JAX module, port model with the same weights, JAX outputs, input)."""
    x = _x((2, HW, HW, 3))
    jmod = JS.build_segmamba(VARIANT, in_chans=3, out_chans=3, **SIZE)
    v = _variables(jmod, x)
    want = jax_run(lambda vv, xx: jmod.apply(vv, xx), v, jnp.asarray(x))
    port = _port(TS.build_segmamba(VARIANT, in_chans=3, out_chans=3, **SIZE), v)
    return jmod, port, want, x


def test_variant_outputs_match_jax(variant_pair):
    _, port, want, x = variant_pair
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert isinstance(got, tuple) and len(got) == len(want) == 4
    for i, (p, q) in enumerate(zip(got, want)):
        assert p.shape == (2, HW, HW, 3) and p.dtype == torch.float32
        assert _rel(p.numpy(), q) <= TOL, f"output {i}"


def test_variant_axes_match_jax_module(variant_pair):
    """The port's VARIANTS entry spells out every axis, whatever the two
    packages' defaults: the built JAX module's fields hold the same values."""
    jmod, port, _, _ = variant_pair
    for field, value in TS.VARIANTS[VARIANT].items():
        assert getattr(jmod, field) == value, field
    assert port.ds_in_output and port.final_refine_kan_mlp is not None
    assert port.vit.gscs is not None and port.vit.mlps is None
    assert all(isinstance(blk, TSSM.SpatialMambaBlock) for st in port.vit.stages for blk in st)


@pytest.mark.parametrize("legacy", [False, True])
def test_deep_supervision_losses_match_jax(legacy):
    """multiclass_dice_ce on (main, ds1, ds2, ds3), aux heads at 16, 8 and 4
    of a 16x16 target (resized with align_corners=True), and the legacy
    ((ds...), main) form: the value and each head's gradient."""
    rs = np.random.RandomState(3)
    heads = [rs.standard_normal((2, s, s, 3)).astype(np.float32) for s in (16, 16, 8, 4)]
    target = rs.randint(0, 3, (2, 16, 16)).astype(np.float32)

    def pack(h):
        return ((tuple(h[1:]), h[0]) if legacy else tuple(h))

    want = jax_run(jax.value_and_grad(lambda h, t: JL.multiclass_dice_ce(pack(h), t)),
                   tuple(map(jnp.asarray, heads)), jnp.asarray(target))
    th = [torch.from_numpy(h).requires_grad_(True) for h in heads]
    loss = TL.multiclass_dice_ce(pack(th), torch.from_numpy(target))
    loss.backward()
    assert abs(loss.item() - float(want[0])) <= TOL * abs(float(want[0]))
    for t, g in zip(th, want[1]):
        assert _rel(t.grad.numpy(), g) <= TOL
    # ds_adapter on its own, with the binary base loss, on one-channel heads
    bheads = [h[..., :1] for h in heads]
    bt = (target > 0).astype(np.float32)[..., None]
    jv = jax_run(lambda h, t: JL.ds_adapter(pack(h), t), tuple(map(jnp.asarray, bheads)),
                 jnp.asarray(bt))
    tv = TL.ds_adapter(pack([torch.from_numpy(h) for h in bheads]), torch.from_numpy(bt))
    assert abs(float(tv) - float(jv)) <= TOL * abs(float(jv))


@pytest.mark.parametrize("name,d_state", [("SpatialMamba", 1), ("Backbone_SpatialMamba", 16)])
def test_spatial_mamba_classifier_matches_jax(name, d_state):
    """Tiny depths and widths, 32x32, eval mode: the logits, and for the
    backbone name each stage's output (return_features)."""
    kw = dict(n_channels=3, num_classes=5, depths=(1, 1, 1, 1), dims=(8, 16, 32, 64),
              d_state=d_state)
    features = name == "Backbone_SpatialMamba"
    x = _x((2, HW, HW, 3))
    jmod = j_build_model(name, **kw)
    v = _variables(jmod, x)
    want = jax_run(lambda vv, xx: jmod.apply(vv, xx, return_features=features), v,
                   jnp.asarray(x))
    with torch.no_grad():
        got = _port(build(name, **kw), v)(torch.from_numpy(x), return_features=features)
    if not features:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for p, q in zip(got, want):
        assert _rel(p.numpy(), q) <= TOL


def test_init_parameters_follow_jax_initialisers():
    """The deterministic initialisers equal JAX's values; the random ones
    (lecun-normal with flax's fan-in of a raw parameter, he-uniform,
    normal(0.1 / 5)) stay within JAX's bound and match its spread."""
    x = _x((1, 8, 8, 32))
    jssm = JSSM.StructureAwareSSM(32)
    jv = jax_run(lambda xx: jssm.init(jax.random.PRNGKey(0), xx), jnp.asarray(x))["params"]
    tssm = init_parameters(TSSM.StructureAwareSSM(32), torch.Generator().manual_seed(0))
    for name in ("A_logs", "Ds", "dt_projs_bias"):
        np.testing.assert_allclose(getattr(tssm, name).detach().numpy(), jv[name], rtol=1e-6)
    for name, jname in (("kernel_3", "kernel__3"), ("kernel_3_1", "kernel__3__1"),
                        ("kernel_3_2", "kernel__3__2"), ("alpha", "alpha")):
        np.testing.assert_array_equal(getattr(tssm.state_fusion, name).detach().numpy(),
                                      jv["state_fusion"][jname])
    jkan = JK.KANLinear(64, 256)
    jk = jax_run(lambda xx: jkan.init(jax.random.PRNGKey(1), xx),
                 jnp.zeros((2, 64), jnp.float32))["params"]
    tkan = init_parameters(TK.KANLinear(64, 256), torch.Generator().manual_seed(1))
    for name in ("alpha", "beta", "gamma"):
        np.testing.assert_array_equal(getattr(tkan.base_activation, name).detach().numpy(),
                                      jk["base_activation"][name])
    pairs = [(tssm.x_proj_weight, jv["x_proj_weight"]),
             (tssm.dt_projs_weight, jv["dt_projs_weight"]),
             (tkan.base_weight, jk["base_weight"]), (tkan.spline_scaler, jk["spline_scaler"]),
             (tkan.spline_weight, jk["spline_weight"])]
    for got, want in pairs:
        got = got.detach().numpy()
        assert got.shape == want.shape
        # each is symmetric about 0 with a spread set by the fan-in: the same
        # bound (truncation at 2 sigma, the uniform's limit) and std within 25%
        bound = np.abs(want).max()
        if want.size > 2000:
            assert np.abs(got).max() <= bound * 1.05
        assert 0.75 <= got.std() / want.std() <= 1.25


def _train_argv(tmp_path, n_classes):
    return ["--model", VARIANT, "--synthetic", "--img-size", str(HW), "--batch", "2",
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"), "--check-numerics",
            "--n-classes", str(n_classes),
            "--set", f"model.depths={SIZE['depths']}", f"model.feat_size={SIZE['feat_size']}",
            f"model.hidden_size={SIZE['hidden_size']}"]


def test_variant_train_cli_cpu(tmp_path):
    """The train CLI with the variant on the CPU: --n-classes 2 (heads of two
    channels, as JAX's CLI builds SegMamba models, for label ids 0..2;
    multiclass_dice_ce's deep-supervision branch), 32x32, batch 2, one epoch
    with a checkpoint, then --resume auto for a second."""
    from accunet_tpu_torch.cli import train as cli

    argv = _train_argv(tmp_path, 2)
    state, hist = cli.main(argv + ["--epochs", "1"])
    assert state.step == 4 and os.listdir(tmp_path / "ck") == ["epoch_0001.pth.tar"]
    state, hist2 = cli.main(argv + ["--epochs", "2", "--resume", "auto"])
    assert [h["epoch"] for h in hist + hist2] == [1, 2] and state.step == 8
    assert all(math.isfinite(h[s]["loss"]) for h in hist + hist2 for s in ("train", "val"))
    assert state.model.out.conv.weight.shape[0] == state.model.ds_head1.conv.weight.shape[0] == 2


def test_variant_binary_train_cli_raises(tmp_path):
    """A binary head: the deep-supervision tuple meets a binary loss, which
    raises and names --n-classes (JAX's train CLI fails there too)."""
    from accunet_tpu_torch.cli import train as cli

    with pytest.raises(ValueError, match="--n-classes"):
        cli.main(_train_argv(tmp_path, 1) + ["--epochs", "1"])
