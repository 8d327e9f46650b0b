"""The port's TransUNet (and its fKAN / fJNB names) vs the JAX package on the
CPU.

  * ViTBlock with the dense MLP and with the fKAN MLP (the second LayerNorm
    and KAN((32, 64, 32))), float64: the output and the gradients of the
    tokens and of every parameter against jax.vjp;
  * PreActBottleneck (StdConv, GroupNorm(32), the strided projection with
    gn_proj), float64: the output and every gradient;
  * TransUNet(hidden=32, heads=2, mlp_dim=64, num_layers=1,
    decoder_channels=(16, 8, 8, 4)) at 64x64 with the R50 hybrid (its
    ResNetV2 at the published widths; the ragged 15x15 block-1 map padded to
    16x16) and with the plain ViT backbone, dense and fKAN: the eval forward
    with one class (the sigmoid head) and with three (n_classes logits), and
    the train-mode forward with every BN's running statistics; one input
    channel repeated to three;
  * TransUNet (hybrid, dense) and TransUNet_Vit_fKAN with
    dtype=torch.bfloat16 against JAX's dtype=jnp.bfloat16
    (tests/test_torch_unets.py `bf16_matches_jax`), and where the port
    computes in which type: the ResNetV2 body in fp32 (its GroupNorms return
    fp32, as flax's do), the patch embeddings, ViT blocks and decoder in
    bf16, the fp32 skips cast to bf16 before the concat;
  * the train CLI trains a tiny TransUNet_fJNB at 32x32 (its position
    embeddings sized from that image size) and the gradcam CLI loads the
    checkpoint strictly and writes the CAMs at the same size;
  * TransUnet_fKAN and TransUNet_fJNB build the same model; a port
    state_dict loads into the JAX tree through `import_torch_state(...,
    strict=True)`; init_parameters reaches every parameter (StdConv's
    kernel lecun-normal, the position embeddings zero).

Weights: a seeded numpy tree shaped by `jax.eval_shape` of the JAX init,
loaded into the port by `state_dict_from_jax` with a strict load; the JAX
side runs through one jit per function compiled with FAST_COMPILE. Tolerance
1e-5 of the largest magnitude in fp32; gradients in float64, as in
tests/test_torch_unets.py.
"""

import math
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accunet_tpu.models import build as jax_build
from accunet_tpu.models import transunet as JT
from accunet_tpu.port import import_torch_state
from accunet_tpu_torch.models import build, init_parameters
from accunet_tpu_torch.models import transunet as TT
from accunet_tpu_torch.port import state_dict_from_jax
from tests.test_torch_spatial_mamba import TOL, _port, _rel
from tests.test_torch_unets import _check_grads, bf16_matches_jax, port_grads, train_vjp
from tests.test_torch_unext import _one_torch_thread  # noqa: F401
from tests.test_torch_unext import _stats_match, _variables, _x, jax_forward, jax_run

HW = 64
TINY = dict(hidden=32, heads=2, mlp_dim=64, num_layers=1, decoder_channels=(16, 8, 8, 4))


@pytest.mark.parametrize("mlp_type", ["dense", "fkan"])
def test_vit_block_forward_and_grads_match_jax(mlp_type):
    """Float64 (each KANLinear rounds its input to fp32 on both sides): the
    fKAN MLP's scalar FJNB parameters sum ~2,000 terms of either sign, whose
    fp32 gradients part by 1.04e-5."""
    tok, gy = _x((2, 16, 32)), _x((2, 16, 32), 1)
    v = _variables(JT.ViTBlock(32, 2, 64, mlp_type), tok)
    want, _, (dp, dx) = train_vjp(lambda dt: JT.ViTBlock(32, 2, 64, mlp_type, dt), v, (tok,),
                                  gy, train=False)
    port = _port(TT.ViTBlock(32, 2, 64, mlp_type), v)
    got, grads = port_grads(port, (tok,), gy)
    assert _rel(got, want) <= TOL
    # the key's bias adds q.b to every score of a query: the softmax takes it
    # out, so its exact gradient is 0
    assert _check_grads(grads, dp, (dx,), r"attn_key\.bias") == 1
    # 2 LayerNorms, 4 projections; dense: fc1, fc2 (2 each); fkan: a third
    # LayerNorm and two KANLinears (3 tensors and the FJNB's 3 each)
    assert len(grads) == 1 + 2 * 2 + 4 * 2 + (4 if mlp_type == "dense" else 2 + 2 * 6)


def test_preact_bottleneck_grads_match_jax():
    """Float64 (flax's GroupNorm takes the one-pass variance): cin 32 ->
    cout 64, cmid 32, stride 2 on a 9x9 map, so the projection runs."""
    x, gy = _x((2, 9, 9, 32)), _x((2, 5, 5, 64), 1)
    v = _variables(JT.PreActBottleneck(32, 64, 32, 2), x)
    want, _, (dp, dx) = train_vjp(lambda dt: JT.PreActBottleneck(32, 64, 32, 2, dt), v, (x,),
                                  gy, train=False)
    port = _port(TT.PreActBottleneck(32, 64, 32, 2), v)
    got, grads = port_grads(port, (x,), gy)
    assert _rel(got, want) <= TOL
    assert _check_grads(grads, dp, (dx,)) == 0
    assert len(grads) == 1 + 4 + 4 * 2  # x; 4 StdConvs; 4 GroupNorms


CASES = [("TransUNet", 1), ("TransUNet", 3), ("TransUNet_Vit_fKAN", 1),
         ("TransUnet_fKAN", 3)]


def _jax_model(name, n_classes, n_channels=3):
    return jax_build(name, n_channels=n_channels, n_classes=n_classes, **TINY)


@pytest.mark.parametrize("name,n_classes", CASES)
def test_transunet_matches_jax(name, n_classes):
    x = _x((2, HW, HW, 3))
    jmod = _jax_model(name, n_classes)
    v = _variables(jmod, x)
    want, (want_train, updates) = jax_forward(jmod, v, x)
    port = _port(build(name, n_channels=3, n_classes=n_classes, img_size=HW,
                       dtype=torch.float32, **TINY), v)
    assert isinstance(port, TT.TransUNet)
    assert port.hybrid == (name != "TransUNet_Vit_fKAN")
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        assert got.shape == (2, HW, HW, n_classes)
        assert _rel(got.numpy(), want) <= TOL
        if n_classes == 1:
            assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
        got = port.train()(torch.from_numpy(x))
    assert _rel(got.numpy(), want_train) <= TOL
    # conv_more and two Conv2dReLUs a DecoderBlock
    assert _stats_match(port, updates) == 2 * (1 + 2 * 4)


@pytest.mark.parametrize("name", ["TransUNet", "TransUNet_Vit_fKAN"])
def test_transunet_bf16_forward_matches_jax(name):
    x = _x((2, HW, HW, 3))
    v = _variables(_jax_model(name, 3), x)
    port = _port(build(name, n_channels=3, n_classes=3, img_size=HW, dtype=torch.bfloat16,
                       **TINY), v)
    seen = {}

    def record(kind):  # (input, output, skip) types; ResNetV2's output is (x, features)
        return lambda m, inp, out: seen.setdefault(kind, []).append(
            (inp[0].dtype, (out[0] if isinstance(out, tuple) else out).dtype,
             inp[1].dtype if len(inp) > 1 and inp[1] is not None else None))

    for mod in port.modules():
        if isinstance(mod, (TT.ResNetV2, TT.PreActBottleneck, TT.ViTBlock, TT.DecoderBlock)):
            mod.register_forward_hook(record(type(mod).__name__))
    jmod16 = jax_build(name, n_channels=3, n_classes=3, dtype=jnp.bfloat16, **TINY)
    bf16_matches_jax(jmod16, port, v, x)
    bf16, f32 = torch.bfloat16, torch.float32
    assert seen["ViTBlock"] == [(bf16, bf16, None)]
    if name == "TransUNet":
        # the image enters the hybrid in bf16 (its root conv computes in
        # bf16) and leaves it in fp32; every bottleneck runs in fp32
        assert seen["ResNetV2"] == [(bf16, f32, None)]
        assert seen["PreActBottleneck"] == [(f32, f32, None)] * (3 + 4 + 9)
        # three blocks take an fp32 skip beside their bf16 input
        assert seen["DecoderBlock"] == [(bf16, bf16, f32)] * 3 + [(bf16, bf16, None)]
    else:
        assert "ResNetV2" not in seen
        assert seen["DecoderBlock"] == [(bf16, bf16, None)] * 4


def test_one_channel_is_repeated_to_three():
    x = _x((1, HW, HW, 1))
    v = _variables(_jax_model("TransUNet_Vit_fKAN", 1, 1), x)
    want = jax_run(lambda vv, xx: _jax_model("TransUNet_Vit_fKAN", 1, 1).apply(vv, xx), v,
                   jnp.asarray(x))
    port = _port(build("TransUNet_Vit_fKAN", n_channels=1, n_classes=1, img_size=HW, **TINY), v)
    assert port.patch_embeddings.in_channels == 3
    with torch.no_grad():
        assert _rel(port(torch.from_numpy(x)).numpy(), want) <= TOL


def test_fjnb_is_the_fkan_model():
    a = build("TransUnet_fKAN", n_channels=3, n_classes=1, img_size=HW, **TINY)
    b = build("TransUNet_fJNB", n_channels=3, n_classes=1, img_size=HW, **TINY)
    assert {k: v.shape for k, v in a.state_dict().items()} == \
        {k: v.shape for k, v in b.state_dict().items()}
    assert a.layer[0].mlp_type == b.layer[0].mlp_type == "fkan" and a.hybrid and b.hybrid


@pytest.mark.parametrize("name", ["TransUNet", "TransUNet_Vit_fKAN"])
def test_port_state_dict_loads_into_jax_strictly(name):
    x = _x((1, HW, HW, 3))
    jmod = _jax_model(name, 2)
    v = _variables(jmod, x)
    template = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port = _port(build(name, n_channels=3, n_classes=2, img_size=HW, **TINY), v)
    filled = import_torch_state(template, port.state_dict(), strict=True)
    got = dict(jax.tree_util.tree_leaves_with_path(filled))
    leaves = jax.tree_util.tree_leaves_with_path(v)
    assert len(got) == len(leaves)
    for path, want in leaves:
        np.testing.assert_array_equal(np.asarray(got[path]), want, err_msg=str(path))
    # StdConv's raw kernel goes HWIO -> OIHW; the position embeddings keep
    # their shape at the top of the tree
    sd = state_dict_from_jax(v)
    assert sd["hybrid_model.root_conv.weight" if "Vit" not in name
              else "patch_embeddings.weight"].shape[1] == 3
    assert sd["position_embeddings"].shape == (1, (HW // 16) ** 2, 32)


def test_init_parameters():
    model = build("TransUnet_fKAN", n_channels=3, n_classes=1, img_size=HW, **TINY)
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))
    init_parameters(model, torch.Generator().manual_seed(0))
    assert all(bool(p.isfinite().all()) for p in model.parameters())
    assert not model.position_embeddings.any()
    gn = model.hybrid_model.block3_unit9.gn3
    assert bool((gn.weight == 1).all()) and not gn.bias.any()
    w = model.hybrid_model.block3_unit1.conv2.weight.detach()  # (256, 256, 3, 3)
    assert abs(float(w.std()) * math.sqrt(256 * 9) - 1.0) < 0.02


def test_gradcam_cli_loads_a_train_cli_checkpoint_at_its_size(tmp_path):
    """Every CLI builds a TransUNet name at its image size (models.build's
    input_size), so a checkpoint the train CLI wrote at 32x32 loads strictly
    into the gradcam CLI's model at 32x32."""
    from accunet_tpu_torch.cli import gradcam
    from accunet_tpu_torch.cli import train

    sets = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()]
    state, _ = train.main(["--model", "TransUNet_fJNB", "--device", "cpu", "--synthetic",
                           "--epochs", "1", "--batch", "2", "--img-size", "32", "--ckpt-dir",
                           str(tmp_path / "ck"), "--set", *sets])
    assert state.model.position_embeddings.shape == (1, TT.hybrid_grid(32) ** 2, 32)
    rs = np.random.default_rng(0)
    for sub in ("images", "masks"):
        os.makedirs(tmp_path / "data" / sub)
    for i in range(3):
        np.save(tmp_path / "data" / "images" / f"s{i}.npy",
                rs.random((32, 32, 3), dtype=np.float32))
        np.save(tmp_path / "data" / "masks" / f"s{i}.npy",
                (rs.random((32, 32)) > 0.5).astype(np.float32))
    n = gradcam.main(["--model", "TransUNet_fJNB", "--test-dir", str(tmp_path / "data"),
                      "--img-size", "32", "--batch", "2", "--ckpt",
                      str(tmp_path / "ck" / "epoch_0001.pth.tar"), "--model-kwargs", repr(TINY),
                      "--out-dir", str(tmp_path / "cam"), "--device", "cpu"])
    assert n == 3
    cam = np.load(tmp_path / "cam" / "s2_cam.npz")["cam"]
    assert cam.shape == (32, 32) and np.isfinite(cam).all()
