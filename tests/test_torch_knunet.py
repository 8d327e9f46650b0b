"""The port's KNUnet (KMUNet) and the SiLU-base KANLinear vs the JAX package
on the CPU.

  * KANLinear(base_activation='silu') against JAX's (no base-activation
    parameter); the rational bases 'rkan' (JacobiRKAN) and 'pade'
    (PadeRKAN) against JAX's, with their parameters under base_activation;
  * the KAN_SCA bridge alone, on four maps of 8-64 channels;
  * VSSLayerUp at depth 3: the output, and the gradients of its inputs and
    parameters against jax.vjp; the two blocks whose outputs the reference
    discards get no gradient here and a zero one in JAX;
  * KMUNet under the registry name KNUnet, at its published widths (hidden
    64-512, d_state 16) with depths (1, 2, 1, 2), so that up1 and up3 run
    the recompute loop over two blocks, 64x64, eval mode;
  * a bf16 forward (dtype=torch.bfloat16) and init_parameters reaching
    every parameter; the train CLI for one tiny epoch.

Weights: a seeded numpy tree shaped by `jax.eval_shape` of the JAX init,
loaded into the port by `state_dict_from_jax` with a strict load; the JAX
side runs through one jit per function compiled with FAST_COMPILE. Tolerance
1e-5 of the largest magnitude in fp32, but the whole model's (WHOLE_TOL).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accunet_tpu.models import knunet as JKN
from accunet_tpu.nn import kan as JK
from accunet_tpu_torch.models import build, init_parameters
from accunet_tpu_torch.models import knunet as TKN
from accunet_tpu_torch.nn import kan as TK
from accunet_tpu_torch.nn.ss2d import SS2D
from accunet_tpu_torch.port import state_dict_from_jax
from tests.test_torch_spatial_mamba import TOL, _both, _port, _rel
from tests.test_torch_unext import FAST_COMPILE, _variables, _x, jax_run
from tests.test_torch_unext import _one_torch_thread  # noqa: F401

# The whole model in fp32: the port's and JAX's outputs part by a relative
# error that grows layer by layer through ~20 KANLinears, SS2Ds and
# LayerNorms in series (a per-module map of this test's model: 3e-7 after
# the patch embed, 2e-6 after the bridge, 1e-5 after up2, 2-3e-5 after up3
# and the final LayerNorm; flax's LayerNorm takes the variance as
# E[x^2] - E[x]^2 in fp32). At hidden (8, 16, 32, 64) the final LayerNorm
# spans 2 channels and JAX's own fp32 output sits 2.5e-3 from float64, so the
# test runs the published widths.
WHOLE_TOL = 1e-4
PADE_TOL = 1e-4
HIDDEN = (64, 128, 256, 512)
DEPTHS = (1, 2, 1, 2)


def test_kan_linear_silu_matches_jax():
    x = 1.5 * _x((10, 12))
    got, want = _both(JK.KANLinear(12, 7, base_activation="silu"),
                      TK.KANLinear(12, 7, base_activation="silu"), x)
    assert got.shape == (10, 7) and _rel(got.numpy(), want) <= TOL
    names = {n for n, _ in TK.KANLinear(12, 7, base_activation="silu").named_parameters()}
    assert names == {"base_weight", "spline_weight", "spline_scaler"}


def rational_base_params(tree, seed=3):
    """A rational base's parameters near their initial values: 1 + 0.1 z,
    zeta 0.1 z."""
    rs = np.random.RandomState(seed)
    return {k: np.float32(0.0 if k.startswith("zeta") else 1.0)
            + 0.1 * rs.standard_normal(a.shape).astype(np.float32) for k, a in tree.items()}


@pytest.mark.parametrize("base", ["rkan", "pade"])
def test_kan_linear_rational_bases_wait_for_item_7(base):
    """The rational bases, once Queue 1 item 7's wait ended: KANLinear(12,
    7) with each against JAX's. The base's parameters are drawn around their
    initial values (1 + 0.1 z; zeta 0.1 z), where PadeRKAN's denominator
    stays away from 0. PADE_TOL: PadeRKAN's degree-5 Jacobi terms cancel in
    fp32, where each side's base sits 5-8e-4 from its float64 value and the
    two 1.4e-5 apart here (tests/test_torch_unext_cmrf_rest.py holds the
    bases alone to float64)."""
    x = 1.5 * _x((10, 12))
    jmod = JK.KANLinear(12, 7, base_activation=base)
    v = _variables(jmod, x)
    v["params"]["base_activation"] = rational_base_params(v["params"]["base_activation"])
    want = jax_run(lambda vv, xx: jmod.apply(vv, xx), v, jnp.asarray(x))
    with torch.no_grad():
        got = _port(TK.KANLinear(12, 7, base_activation=base), v)(torch.from_numpy(x))
    assert got.shape == (10, 7) and _rel(got.numpy(), want) <= (TOL if base == "rkan"
                                                                 else PADE_TOL)
    names = {n for n, _ in TK.KANLinear(12, 7, base_activation=base).named_parameters()}
    want_names = {"alpha", "beta", "iota"} if base == "rkan" else {
        f"{p}_{side}" for p in ("alpha", "beta", "zeta", "w") for side in "pq"}
    assert names == {"base_weight", "spline_weight", "spline_scaler"} | {
        f"base_activation.{n}" for n in want_names}


def test_kan_sca_bridge_matches_jax():
    c_list = (8, 16, 32, 64)
    maps = [_x((2, 16 >> i, 16 >> i, c), seed=i) for i, c in enumerate(c_list)]
    jmod = JKN.KANSCABridge(list(c_list))
    v = _variables(jmod, maps)
    want = jax_run(lambda vv, ts: jmod.apply(vv, ts), v, [jnp.asarray(m) for m in maps])
    with torch.no_grad():
        got = _port(TKN.KANSCABridge(c_list), v)([torch.from_numpy(m) for m in maps])
    assert len(got) == 4
    for p, q in zip(got, want):
        assert _rel(p.numpy(), q) <= TOL


def test_vss_layer_up_gradients_match_jax():
    """dim 16 (8-wide SS2D, N 16), depth 3, x1 (2, 3, 4, 16) -> (2, 6, 8, 8):
    the output, the input gradients and every parameter gradient."""
    x1, x2, gy = _x((2, 3, 4, 16)), _x((2, 6, 8, 8), 1), _x((2, 6, 8, 8), 2)
    jmod = JKN.VSSLayerUp(16, 3)
    v = _variables(jmod, x1, x2)

    def vjp(vv, a, b, g):
        y, pull = jax.vjp(lambda p, a_, b_: jmod.apply(p, a_, b_), vv, a, b)
        return y, pull(g)

    # the depthwise conv's weight gradient (a batch-grouped conv) needs the
    # convolution-group-converter pass that FAST_COMPILE turns off
    args = (v, *map(jnp.asarray, (x1, x2, gy)))
    opts = {k: o for k, o in FAST_COMPILE.items() if k != "xla_disable_hlo_passes"}
    want, (gv, g1, g2) = jax.tree_util.tree_map(
        np.asarray, jax.jit(vjp).lower(*args).compile(compiler_options=opts)(*args))
    port = _port(TKN.VSSLayerUp(16, 3), v)
    t1, t2 = (torch.from_numpy(a).requires_grad_(True) for a in (x1, x2))
    y = port(t1, t2)
    y.backward(torch.from_numpy(gy))
    assert _rel(y.detach().numpy(), want) <= TOL
    assert _rel(t1.grad.numpy(), g1) <= TOL and _rel(t2.grad.numpy(), g2) <= TOL
    jgrads = state_dict_from_jax(gv)
    discarded = 0
    for name, p in port.named_parameters():
        if name.startswith(("blocks.0.", "blocks.1.")):
            assert p.grad is None, name
            assert not jgrads[name].any(), name
            discarded += 1
        else:
            assert _rel(p.grad.numpy(), jgrads[name].numpy()) <= TOL, name
    assert discarded == 2 * len(list(port.blocks[0].parameters()))


@pytest.fixture(scope="module")
def kmunet():
    """(numpy input, JAX variables, JAX eval output) of KMUNet at HIDDEN,
    DEPTHS, 64x64, 3 channels in, 2 classes."""
    x = _x((2, 64, 64, 3))
    jmod = JKN.KMUNet(3, 2, depths=DEPTHS, hidden_dims=HIDDEN)
    v = _variables(jmod, x)
    return x, v, jax_run(lambda vv, xx: jmod.apply(vv, xx), v, jnp.asarray(x))


def test_kmunet_matches_jax(kmunet):
    x, v, want = kmunet
    port = _port(build("KNUnet", n_channels=3, n_classes=2, depths=DEPTHS,
                       hidden_dims=HIDDEN, dtype=torch.float32), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 64, 64, 2) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= WHOLE_TOL


def test_kmunet_bf16_forward(kmunet):
    """dtype=torch.bfloat16 on the same fp32 parameters: every SS2D meets a
    bf16 map, and the output is float32 and follows JAX's fp32 output
    (correlation >= 0.99; bf16's rounding through ~20 layers in series puts
    its largest error at 0.10 of the largest magnitude here)."""
    x, v, want = kmunet
    port = _port(TKN.KMUNet(3, 2, depths=DEPTHS, hidden_dims=HIDDEN, dtype=torch.bfloat16), v)
    seen = []
    for mod in port.modules():
        if isinstance(mod, SS2D):
            mod.register_forward_pre_hook(lambda m, inp: seen.append(inp[0].dtype))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert seen == [torch.bfloat16] * 3  # the last block of up1, up2, up3
    assert got.dtype == torch.float32 and bool(got.isfinite().all())
    assert np.corrcoef(got.numpy().ravel(), want.ravel())[0, 1] >= 0.99


def test_init_parameters_reach_every_parameter():
    """NaN everywhere, then init_parameters: every parameter and buffer is
    finite again (each module type of KNUnet has its JAX initialiser); SS2D's
    A_logs are log(1..16) and the KANLinears' base weights within
    he-uniform's bound."""
    model = TKN.KMUNet(3, 1, depths=(1, 1, 1, 1), hidden_dims=(8, 16, 32, 64))
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))
    init_parameters(model, torch.Generator().manual_seed(0))
    assert all(bool(p.isfinite().all()) for p in model.parameters())
    ss2d = model.decoder.up1.blocks[0].self_attention
    np.testing.assert_allclose(ss2d.A_logs.detach().numpy(),
                               np.log(np.broadcast_to(np.arange(1, 17), ss2d.A_logs.shape)),
                               rtol=1e-6)
    kan = model.decoder.up1.upsample.expand.layer["fc1"]
    assert float(kan.base_weight.detach().abs().max()) <= (6.0 / kan.base_weight.shape[0]) ** 0.5


def test_train_cli_knunet_on_cpu(tmp_path):
    from accunet_tpu_torch.cli import train as cli

    argv = ["--model", "KNUnet", "--device", "cpu", "--synthetic", "--epochs", "1",
            "--batch", "2", "--img-size", "32", "--ckpt-dir", str(tmp_path / "ck"), "--set",
            "model.depths=(1,2,1,1)", "model.hidden_dims=(8,16,32,64)"]
    state, hist = cli.main(argv)
    assert hist[0]["epoch"] == 1 and np.isfinite(hist[0]["train"]["loss"])
    assert state.step == 4  # 8 synthetic images, batch 2
    # up3 (depth 2) runs its last block alone: the first one gets no gradient
    assert all(p.grad is None for p in state.model.decoder.up3.blocks[0].parameters())
