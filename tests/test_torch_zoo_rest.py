"""The port's SegViT_fKAN and TinyUNet vs the JAX package on the CPU, and
the one build rule of the CLIs.

  * resize_bilinear (align_corners=False) at SegViT_fKAN's 4x downsample
    (two taps, no antialias) and 4x upsample, at 64x64's and 224x224's maps;
  * SegViT_fKAN(num_layers=1, hidden=32, heads=2, mlp_dim=64, feat_size=(8,
    16, 24, 32)) at 64x64, its ResNetV2 at the published widths: the eval
    forward (raw logits) with 3 input channels and 1 class and with 1 input
    channel (repeated to three for the hybrid, raw for encoder1) and 3
    classes; TinyUNet at 32x32, full width: the eval forward with 1 and 3
    classes and the train-mode forward with every BN's statistics;
  * each with dtype=torch.bfloat16 against JAX's dtype=jnp.bfloat16
    (tests/test_torch_swin_unet.py `bf16_forward_matches`): SegViT_fKAN's
    ViT and UNETR blocks, TinyUNet's CMRFs meet bf16;
  * `models.build_for` gives SegViT_fKAN and the SegMamba names in_chans /
    out_chans (SegViT_fKAN its dtype), the others n_channels / n_classes;
    the eval CLI evaluates a tiny SegViT_fKAN through it, no CLI keeps a
    rule of its own, and the train CLI takes one step of a tiny SegViT_fKAN;
  * a port state_dict loads into the JAX tree through
    `import_torch_state(..., strict=True)`; init_parameters reaches every
    parameter and zeroes SegViT_fKAN's position embeddings.

Weights: a seeded numpy tree shaped by `jax.eval_shape` of the JAX init,
loaded into the port by `state_dict_from_jax` with a strict load; the JAX
side runs through one jit per function compiled with FAST_COMPILE. Tolerance
1e-5 of the largest magnitude in fp32.
"""

import functools
import os
import pathlib
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accunet_tpu.models import seg_fvit as JV
from accunet_tpu.models import tiny_unet as JT
from accunet_tpu.nn import unetr as JN
from accunet_tpu.ops import resize as JR
from accunet_tpu.port import import_torch_state
from accunet_tpu_torch.models import build, build_for, init_parameters
from accunet_tpu_torch.models import seg_fvit as TV
from accunet_tpu_torch.models import tiny_unet as TT
from accunet_tpu_torch.models.transunet import ViTBlock
from accunet_tpu_torch.nn.cmrf_blocks import CMRF
from accunet_tpu_torch.nn.unetr import UnetResBlock, UnetrUpBlock
from accunet_tpu_torch.ops import resize as TR
from tests.test_torch_spatial_mamba import TOL, _port, _rel
from tests.test_torch_swin_unet import bf16_forward_matches
from tests.test_torch_unets import BF16_TOL
from tests.test_torch_unext import _one_torch_thread  # noqa: F401
from tests.test_torch_unext import _stats_match, _variables, _x, jax_forward, jax_run

VIT = dict(num_layers=1, hidden=32, heads=2, mlp_dim=64, feat_size=(8, 16, 24, 32))
VIT_HW, TINY_HW = 64, 32
FP32_SEGVIT_TOL = 5e-5  # see test_segvit_matches_jax


@pytest.mark.parametrize("hw,out", [((16, 16), (4, 4)), ((4, 4), (16, 16)),
                                    ((112, 112), (28, 28)), ((28, 28), (112, 112))])
def test_resize_bilinear_at_segvit_4x_matches_jax(hw, out):
    """enc4 goes down 4x (two taps each side of the centre, no antialias),
    enc2 up 4x; at 64x64 (16 <-> 4) and at 224x224 (112 <-> 28)."""
    x = _x((1, *hw, 5))
    want = jax_run(lambda a: JR.resize_bilinear(a, out, align_corners=False), jnp.asarray(x))
    got = TR.resize_bilinear(torch.from_numpy(x), out).numpy()
    assert _rel(got, want) <= TOL


def _segvit(in_chans, out_chans, dtype=jnp.float32):
    return JV.SegViTfKAN(in_chans, out_chans, dtype=dtype, **VIT)


@pytest.mark.parametrize("in_chans,out_chans", [(3, 1), (1, 3)])
def test_segvit_matches_jax(in_chans, out_chans):
    """Against JAX computing in float64: with these weights the random
    ResNetV2's GroupNorms amplify rounding (half a bf16 ulp on its root
    conv's output moves its features by 0.22 of their largest), so JAX's
    own fp32 forward lies 2.3-2.5e-5 of the largest logit from float64, and
    so does the port's. The port in float64 is held to 1e-5 (it lies within
    5e-8: each KANLinear rounds its input to fp32 on both sides), in fp32 to
    FP32_SEGVIT_TOL."""
    x = _x((2, VIT_HW, VIT_HW, in_chans))
    v = _variables(_segvit(in_chans, out_chans), x)
    with jax.enable_x64(True):
        jmod, f64 = _segvit(in_chans, out_chans, jnp.float64), functools.partial(
            jnp.asarray, dtype=jnp.float64)
        want = jax_run(lambda vv, xx: jmod.apply(vv, xx), jax.tree_util.tree_map(f64, v), f64(x))
    port = _port(build("SegViT_fKAN", VIT_HW, in_chans=in_chans, out_chans=out_chans,
                       dtype=torch.float32, **VIT), v)
    assert isinstance(port, TV.SegViTfKAN)
    assert port.hybrid_model.root_conv.in_channels == 3
    assert port.encoder1.layer.conv1.in_channels == in_chans
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        assert got.shape == (2, VIT_HW, VIT_HW, out_chans) and got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= FP32_SEGVIT_TOL
        port.double().dtype = torch.float64
        assert _rel(port(torch.from_numpy(x).double()).numpy(), want) <= TOL


@pytest.mark.parametrize("n_classes", [1, 3])
def test_tiny_unet_matches_jax(n_classes):
    """The eval forward (raw logits, n_classes channels) and the train-mode
    forward with all 8 CMRFs' BN statistics (9 ConvBNActs each)."""
    x = _x((2, TINY_HW, TINY_HW, 3))
    jmod = JT.TinyUNet(3, n_classes)
    v = _variables(jmod, x)
    want, (want_train, updates) = jax_forward(jmod, v, x)
    port = _port(build("TinyUNet", n_channels=3, n_classes=n_classes, dtype=torch.float32), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        assert got.shape == (2, TINY_HW, TINY_HW, n_classes)
        assert _rel(got.numpy(), want) <= TOL
        got = port.train()(torch.from_numpy(x))
    assert _rel(got.numpy(), want_train) <= TOL
    assert _stats_match(port, updates) == 2 * 8 * 9


def test_segvit_bf16_forward_matches_jax():
    """The ViT and UNETR blocks meet bf16 (the ResNetV2 body computes in fp32
    behind its GroupNorms, as in JAX). The whole model is held more loosely
    than the Swin models (correlation 0.998, slack 0.06; measured 0.9984 and
    0.05): the two sides' root convs round differently in bf16, and the
    random ResNetV2 amplifies that (the fp32 model alone moves 0.063 of its
    largest logit when only its input is rounded to bf16; JAX's bf16 output
    lies 0.07 from fp32, the port's 0.12). The UNETR blocks alone are held
    at BF16_TOL by the next test."""
    x = _x((2, VIT_HW, VIT_HW, 3))
    v = _variables(_segvit(3, 3), x)
    port = _port(build("SegViT_fKAN", VIT_HW, in_chans=3, out_chans=3, dtype=torch.bfloat16,
                       **VIT), v)
    assert bf16_forward_matches(_segvit(3, 3, jnp.bfloat16), port, v, x,
                                (ViTBlock, UnetResBlock, UnetrUpBlock), corr=0.998,
                                slack=0.06) <= 0.12


def test_unetr_up_block_bf16_matches_jax():
    """UnetrUpBlock (transposed conv, concat, UnetResBlock with its 1x1
    residual and instance norms) computing in bf16 on bf16 inputs, as JAX's
    with dtype=jnp.bfloat16: within BF16_TOL of the largest magnitude."""
    x, skip = _x((2, 4, 4, 16)), _x((2, 8, 8, 8), 1)
    v = _variables(JN.UnetrUpBlock(16, 8, 3), x, skip)
    jmod = JN.UnetrUpBlock(16, 8, 3, jnp.bfloat16)
    bf = functools.partial(jnp.asarray, dtype=jnp.bfloat16)
    want = np.asarray(jax_run(lambda vv, a, b: jmod.apply(vv, a, b), v, bf(x), bf(skip)),
                      np.float32)
    port = _port(UnetrUpBlock(16, 8), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x).bfloat16(), torch.from_numpy(skip).bfloat16())
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= BF16_TOL


def test_tiny_unet_bf16_forward_matches_jax():
    x = _x((2, TINY_HW, TINY_HW, 3))
    v = _variables(JT.TinyUNet(3, 3), x)
    port = _port(build("TinyUNet", n_channels=3, n_classes=3, dtype=torch.bfloat16), v)
    assert bf16_forward_matches(JT.TinyUNet(3, 3, dtype=jnp.bfloat16), port, v, x,
                                (CMRF, torch.nn.BatchNorm2d)) <= 0.03


def test_build_for_is_the_cli_build_rule():
    """in_chans / out_chans for SegViT_fKAN (with its dtype) and the SegMamba
    names (no dtype), n_channels / n_classes for the others."""
    m = build_for("SegViT_fKAN", 32, 1, 2, torch.bfloat16, **VIT)
    assert m.dtype == torch.bfloat16 and m.encoder1.layer.conv1.in_channels == 1
    assert m.out.conv.out_channels == 2 and m.position_embeddings.shape == (1, 4, 32)
    m = build_for("Segmamba", 32, 3, 2, torch.bfloat16, depths=(1, 1, 1, 1),
                  feat_size=(8, 16, 24, 32), hidden_size=40)
    assert all(p.dtype == torch.float32 for p in m.parameters())
    m = build_for("TinyUNet", 32, 4, 3, torch.bfloat16)
    assert m.dtype == torch.bfloat16 and m.final_conv.out_channels == 3
    assert m.encoder1_cmrf.pwconv1.conv.in_channels == 4


def test_no_cli_keeps_a_build_rule_of_its_own():
    cli = pathlib.Path(__file__).parents[1] / "accunet_tpu_torch" / "cli"
    for name in ("train", "eval", "gradcam", "profile"):
        src = (cli / f"{name}.py").read_text()
        assert "build_for(" in src and "in_chans=" not in src, name
        assert re.search(r"startswith\(\s*[\"']segmamba", src, re.I) is None, name


def _folder(root, n=3, hw=32):
    rs = np.random.default_rng(0)
    for sub in ("images", "masks"):
        os.makedirs(root / sub)
    for i in range(n):
        np.save(root / "images" / f"s{i}.npy", rs.random((4, hw, hw), dtype=np.float32))
        np.save(root / "masks" / f"s{i}.npy", (rs.random((hw, hw)) > 0.5).astype(np.float32))
    return root


def test_eval_cli_evaluates_segvit(tmp_path):
    from accunet_tpu_torch.cli import eval as cli

    res = cli.main(["--model", "SegViT_fKAN", "--test-dir", str(_folder(tmp_path / "data")),
                    "--img-size", "32", "--batch", "2", "--device", "cpu", "--model-kwargs",
                    repr(VIT), "--csv", str(tmp_path / "m.csv"), "--result",
                    str(tmp_path / "r"), "--dump-dir", str(tmp_path / "d")])
    assert res.n_images == 3 and 0.0 <= res.dice <= 1.0
    out = np.load(tmp_path / "d" / "s2.npz")["output"]
    assert out.shape == (32, 32, 1) and np.isfinite(out).all()


def test_train_cli_segvit_one_step_on_cpu(tmp_path):
    from accunet_tpu_torch.cli import train as cli

    sets = [f"model.{k}={v!r}".replace(" ", "") for k, v in VIT.items()]
    state, hist = cli.main(["--model", "SegViT_fKAN", "--device", "cpu", "--synthetic",
                            "--epochs", "1", "--batch", "8", "--img-size", "32", "--ckpt-dir",
                            str(tmp_path / "ck"), "--set", *sets])
    assert isinstance(state.model, TV.SegViTfKAN) and isinstance(state.optimizer,
                                                                 torch.optim.Adam)
    assert state.step == 1 and np.isfinite(hist[0]["train"]["loss"])


@pytest.mark.parametrize("name", ["SegViT_fKAN", "TinyUNet"])
def test_port_state_dict_loads_into_jax_strictly(name):
    hw = VIT_HW if name == "SegViT_fKAN" else TINY_HW
    x = _x((1, hw, hw, 3))
    jmod = _segvit(3, 2) if name == "SegViT_fKAN" else JT.TinyUNet(3, 2)
    v = _variables(jmod, x)
    template = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port = _port(build_for(name, hw, 3, 2, **(VIT if name == "SegViT_fKAN" else {})), v)
    filled = import_torch_state(template, port.state_dict(), strict=True)
    got = dict(jax.tree_util.tree_leaves_with_path(filled))
    leaves = jax.tree_util.tree_leaves_with_path(v)
    assert len(got) == len(leaves)
    for path, want in leaves:
        np.testing.assert_array_equal(np.asarray(got[path]), want, err_msg=str(path))


@pytest.mark.parametrize("name", ["SegViT_fKAN", "TinyUNet"])
def test_init_parameters_reach_every_parameter(name):
    model = build_for(name, 32, 3, 1, **(VIT if name == "SegViT_fKAN" else {}))
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))
    init_parameters(model, torch.Generator().manual_seed(0))
    assert all(bool(p.isfinite().all()) for p in model.parameters())
    if name == "SegViT_fKAN":
        assert not model.position_embeddings.any()
