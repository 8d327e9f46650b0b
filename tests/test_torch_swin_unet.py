"""The port's SwinUnet and SMESwinUnet (and their parts) vs the JAX package
on the CPU.

  * resize_bicubic at an exact 2x and at ragged sizes, up and down;
  * ExternalAttention; PatchMerging, PatchExpand and FinalPatchExpandX4;
  * a shifted SwinBlock (16x16 map, window 4, shift 2: the -100 mask) and an
    unshifted one whose map equals its window (8x8, window 8), float64: the
    output and the gradients of the tokens and of every parameter against
    jax.vjp;
  * boundary_support_image on images drawn as uint8 / 255 (their gray
    values are multiples of 1/765, so every Sobel magnitude lies well away
    from the 0.3 threshold): the same support image, bit for bit;
  * the ChannelTransformer with SMESwinUnet's patch sizes (one token a
    level) in train mode: the output and the Reconstructs' BN statistics;
  * swin_load_from against JAX's on one synthetic backbone checkpoint (an
    encoder entry, its layers_up copy, entries of another shape skipped)
    and one synthetic full-model dump;
  * SwinUnet and SMESwinUnet(img_size=64, embed_dim=12, window_size=4) at
    64x64: the eval forward with one class (the sigmoid head) and with three
    (n_classes + 1 logits), SMESwinUnet's train-mode forward with its BN
    statistics; dtype=torch.bfloat16 against JAX's dtype=jnp.bfloat16
    (`bf16_forward_matches`);
  * a port state_dict loads into the JAX tree through
    `import_torch_state(..., strict=True)`; init_parameters reaches every
    parameter; the train CLI takes one SGD step of a tiny SwinUnet.

Weights: a seeded numpy tree shaped by `jax.eval_shape` of the JAX init,
loaded into the port by `state_dict_from_jax` with a strict load; the JAX
side runs through one jit per function compiled with FAST_COMPILE. Tolerance
1e-5 of the largest magnitude in fp32; gradients in float64, as in
tests/test_torch_unets.py.
"""

import copy
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as fnn

from accunet_tpu.models import sme_swin_unet as JSME
from accunet_tpu.models import swin_unet as JS
from accunet_tpu.models import uctransnet as JU
from accunet_tpu.nn import attention as JA
from accunet_tpu.ops import resize as JR
from accunet_tpu.port import import_torch_state
from accunet_tpu.port.torch_state import swin_load_from as jax_swin_load_from
from accunet_tpu_torch.models import build, init_parameters
from accunet_tpu_torch.models import sme_swin_unet as TSME
from accunet_tpu_torch.models import swin_unet as TS
from accunet_tpu_torch.models import uctransnet as TU
from accunet_tpu_torch.nn import attention as TA
from accunet_tpu_torch.ops import resize as TR
from accunet_tpu_torch.port import state_dict_from_jax, swin_load_from, swin_rename
from tests.test_torch_spatial_mamba import TOL, _both, _port, _rel
from tests.test_torch_unets import BF16_TOL, _check_grads, port_grads, train_vjp
from tests.test_torch_unext import _one_torch_thread  # noqa: F401
from tests.test_torch_unext import _stats_match, _variables, _x, jax_forward, jax_run

HW = 64
TINY = dict(img_size=HW, embed_dim=12, window_size=4)
MODELS = {"SwinUnet": (JS.SwinUnet, TS.SwinUnet), "SMESwinUnet": (JSME.SMESwinUnet,
                                                                  TSME.SMESwinUnet)}


def bf16_forward_matches(jmod16, port, v, x, kinds, corr=0.999, slack=BF16_TOL):
    """port, built with dtype=torch.bfloat16 and holding the fp32 variables
    v, against jmod16 (the JAX model with dtype=jnp.bfloat16) on x. The
    port's output is float32 and correlated with JAX's (>= corr), and it
    lies no further from the fp32 forward (the port's, held to JAX's by the
    fp32 tests) than JAX's bf16 output does, plus `slack` (BF16_TOL of
    tests/test_torch_unets.py by default) of the largest magnitude: the two
    sides round in different places, and JAX's own bf16 Swin models sit
    0.05 (SwinUnet) and 0.19 (SMESwinUnet) of the largest logit from fp32 at
    these sizes, the port's 0.05 and 0.11. Every module of the types
    `kinds` meets a bf16 input, and only a bf16 one. Returns the port's
    distance from JAX's bf16 output."""
    want = np.asarray(jax_run(lambda vv, xx: jmod16.apply(vv, xx), v, jnp.asarray(x)),
                      np.float32)
    ref = copy.deepcopy(port)
    ref.dtype = torch.float32
    seen = {k.__name__: set() for k in kinds}
    for kind in kinds:
        for mod in port.modules():
            if isinstance(mod, kind):
                mod.register_forward_pre_hook(
                    lambda m, inp, k=kind.__name__: seen[k].add(inp[0].dtype))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        ref = ref(torch.from_numpy(x)).numpy()
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert got.dtype == torch.float32
    assert all(s == {torch.bfloat16} for s in seen.values()), seen
    got = got.numpy()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] >= corr
    assert _rel(got, ref) <= _rel(want, ref) + slack
    return _rel(got, want)


@pytest.mark.parametrize("hw,out,align", [
    ((5, 7), (10, 14), False),   # exact 2x (TinyUNet's decoder)
    ((6, 9), (11, 4), False),    # ragged, up and down
    ((6, 9), (13, 5), True),
])
def test_resize_bicubic_matches_jax(hw, out, align):
    x = _x((2, *hw, 3))
    want = jax_run(lambda a: JR.resize_bicubic(a, out, align_corners=align), jnp.asarray(x))
    got = TR.resize_bicubic(torch.from_numpy(x), out, align_corners=align).numpy()
    assert got.shape == want.shape == (2, *out, 3)
    assert _rel(got, want) <= TOL


def test_external_attention_matches_jax():
    got, want = _both(JA.ExternalAttention(12, 8), TA.ExternalAttention(12, 8), _x((2, 20, 12)))
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("hw,shift,ws", [(16, 2, 4), (8, 2, 8)])
def test_swin_block_forward_and_grads_match_jax(hw, shift, ws):
    """Float64. (16, 2, 4): 16 windows of 4x4 on the rolled map, 7 of them
    masked; (8, 2, 8): the map equals the window, so the block takes no
    shift and no mask, in both."""
    tok, gy = _x((2, hw * hw, 16)), _x((2, hw * hw, 16), 1)

    def make(dt=jnp.float32):
        return JS.SwinBlock(16, (hw, hw), 2, shift=shift, window_size=ws, dtype=dt)

    v = _variables(make(), tok)
    want, _, (dp, dx) = train_vjp(make, v, (tok,), gy, train=False)
    port = _port(TS.SwinBlock(16, (hw, hw), 2, shift, ws), v)
    assert (port.shift, port.attn_mask is None) == ((2, False) if hw > ws else (0, True))
    got, grads = port_grads(port, (tok,), gy)
    assert _rel(got, want) <= TOL
    assert _check_grads(grads, dp, (dx,)) == 0
    # tokens; 2 LayerNorms, qkv, proj, fc1, fc2 (2 each); the bias table
    assert len(grads) == 1 + 6 * 2 + 1


@pytest.mark.parametrize("cls,dim", [("PatchMerging", 8), ("PatchExpand", 16),
                                     ("FinalPatchExpandX4", 8)])
def test_patch_merging_and_expanding_match_jax(cls, dim):
    tok = _x((2, 6 * 10, dim))
    got, want = _both(getattr(JS, cls)(dim, (6, 10)), getattr(TS, cls)(dim, (6, 10)), tok)
    assert _rel(got.numpy(), want) <= TOL


def _uint8_images(b, hw, seed=0):
    """Blocky uint8 images / 255: flat 4x4 blocks (no gradient) with some
    noise, so the Sobel mask holds both values."""
    rs = np.random.RandomState(seed)
    img = np.repeat(np.repeat(rs.randint(0, 256, (b, hw // 4, hw // 4, 3)), 4, 1), 4, 2)
    return (np.clip(img + rs.randint(-20, 21, img.shape), 0, 255) / 255.0).astype(np.float32)


def test_boundary_support_image_matches_jax():
    x = _uint8_images(2, 32)
    want = jax_run(JSME.boundary_support_image, jnp.asarray(x))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(TSME.boundary_support_image(xt).numpy(), want)
    mask = TSME.boundary_mask(xt)
    assert mask.shape == (2, 32, 32, 1) and 0.1 < float(mask.mean()) < 0.9


class _SMEChannelTransformer(fnn.Module):
    """SMESwinUnet's mcct at img 64: levels of 32, 16, 8, 4 pixels and 48,
    12, 24, 48 channels, patches 32, 16, 8, 4, one output flattened."""

    dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, *en, train: bool = False):
        outs = JU.ChannelTransformer((48, 12, 24, 48), 32, patch_sizes=(32, 16, 8, 4),
                                     dtype=self.dtype, name="ct")(en, train)
        return jnp.concatenate([o.reshape(o.shape[0], -1) for o in outs], axis=1)


class _PortSMEChannelTransformer(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.ct = TU.ChannelTransformer((48, 12, 24, 48), 32, patch_sizes=(32, 16, 8, 4))

    def forward(self, *en):
        return torch.cat([t.flatten(1) for t in self.ct(en)], dim=1)


def test_channel_transformer_with_sme_patch_sizes_train_mode_matches_jax():
    """Against JAX computing in float64: with one token a level each
    Reconstruct's train-mode BN normalises two values a channel (one an
    image), whose fp32 one-pass variance in flax leaves JAX's own fp32
    output 2e-2 from float64 here."""
    en = [_x((2, 32 >> i, 32 >> i, c), seed=i) for i, c in enumerate((48, 12, 24, 48))]
    v = _variables(_SMEChannelTransformer(), *en, train=True)
    with jax.enable_x64(True):
        jmod, f64 = _SMEChannelTransformer(jnp.float64), functools.partial(jnp.asarray,
                                                                           dtype=jnp.float64)
        want, updates = jax_run(
            lambda vv, *xs: jmod.apply(vv, *xs, train=True, mutable=["batch_stats"]),
            jax.tree_util.tree_map(f64, v), *map(f64, en))
    port = _port(_PortSMEChannelTransformer(), v).train()
    assert port.ct.embeddings_1.position_embeddings.shape == (1, 1, 48)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, en))
    assert _rel(got.numpy(), want) <= TOL
    assert _stats_match(port, updates) == 8


def _swin_template(name="SwinUnet"):
    x = _x((1, HW, HW, 3))
    jmod = MODELS[name][0](3, 2, **TINY)
    return jmod, x, jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))


def _reference_backbone(port, rs):
    """A synthetic Swin backbone checkpoint ({'model': ...}) in the
    reference's names for `port`'s encoder: every encoder entry of the port
    under its reference name, random; a bias table of another window size
    (skipped), the classifier head (the model lacks it)."""
    sd = {}
    for k, v in port.state_dict().items():
        ref = swin_rename(k)
        if ref.startswith(("layers.", "patch_embed.", "norm.")):
            sd[ref] = rs.standard_normal(tuple(v.shape)).astype(np.float32)
    sd["layers.1.blocks.0.attn.relative_position_bias_table"] = \
        rs.standard_normal((13 ** 2, 6)).astype(np.float32)
    sd["head.weight"] = rs.standard_normal((1000, 96)).astype(np.float32)
    return {"model": sd}


def test_swin_load_from_matches_jax():
    """Both surgeries leave the port's state_dict equal to state_dict_from_jax
    of JAX's on the same checkpoint, from the same initial values."""
    jmod, _, template = _swin_template()
    rs = np.random.RandomState(3)
    init = _variables(jmod, _x((1, HW, HW, 3)), seed=5)
    port = _port(build("SwinUnet", n_channels=3, n_classes=2, **TINY), init)
    backbone = _reference_backbone(port, rs)
    # a whole-model dump in the reference's names: 17-character prefixes,
    # its head among the 'output' keys
    full = {"module.swin_unet." + swin_rename(k): rs.standard_normal(tuple(v.shape)).astype(
        np.float32) for k, v in port.state_dict().items() if not k.endswith("tracked")}
    assert len("module.swin_unet.") == 17 and "module.swin_unet.output.weight" in full
    for ckpt in (backbone, full):
        want = state_dict_from_jax(jax_swin_load_from(init, ckpt))
        port = _port(build("SwinUnet", n_channels=3, n_classes=2, **TINY), init)
        loaded = swin_load_from(port, ckpt)
        got = port.state_dict()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
        assert "output.weight" not in loaded
        assert ("layers_1_blocks.0.attn.relative_position_bias_table" in loaded) == (ckpt is full)
    # the backbone's stage-0 entry went to the encoder and to layers_up.3
    enc = backbone["model"]["layers.0.blocks.1.mlp.fc2.weight"]
    port = _port(build("SwinUnet", n_channels=3, n_classes=2, **TINY), init)
    swin_load_from(port, backbone)
    for key in ("layers_0_blocks.1.mlp_fc2.weight", "layers_up_3_blocks.1.mlp_fc2.weight"):
        np.testing.assert_array_equal(port.state_dict()[key].numpy(), enc)


def jax_forward64(make, v, x):
    """jax_forward (tests/test_torch_unext.py) of the JAX model make(dtype)
    computing in float64 (its outputs cast to fp32, as every model's are)."""
    with jax.enable_x64(True):
        f64 = functools.partial(jnp.asarray, dtype=jnp.float64)
        return jax_forward(make(jnp.float64), jax.tree_util.tree_map(f64, v), f64(x))


@pytest.mark.parametrize("name,n_classes", [(n, c) for n in MODELS for c in (1, 3)])
def test_swin_model_matches_jax(name, n_classes):
    """The eval forward; SMESwinUnet also in train mode, with its mcct's
    four BN statistics (SwinUnet has no train mode). SMESwinUnet is held to
    JAX computing in float64: its mcct sums 49k-term patch embeddings and
    normalises two values a channel in train mode (see the
    ChannelTransformer test), so the two fp32 sides part by 1.4e-5 in eval
    mode (3 classes) while each lies within 8.4e-6 of float64 (the port in
    float64 equals JAX's)."""
    jcls, tcls = MODELS[name]
    x = _x((2, HW, HW, 3))
    jmod = jcls(3, n_classes, **TINY)
    v = _variables(jmod, x)
    port = _port(build(name, n_channels=3, n_classes=n_classes, dtype=torch.float32, **TINY), v)
    assert type(port) is tcls
    out_ch = 1 if n_classes == 1 else n_classes + 1
    if name == "SwinUnet":
        want = jax_run(lambda vv, xx: jmod.apply(vv, xx), v, jnp.asarray(x))
    else:
        want, (want_train, updates) = jax_forward64(
            lambda dt: jcls(3, n_classes, dtype=dt, **TINY), v, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        assert got.shape == (2, HW, HW, out_ch) and got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= TOL
        if n_classes == 1:
            assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
        if name == "SMESwinUnet":
            got = port.train()(torch.from_numpy(x))
            assert _rel(got.numpy(), want_train) <= TOL
            assert _stats_match(port, updates) == 8


@pytest.mark.parametrize("name", list(MODELS))
def test_swin_model_bf16_forward_matches_jax(name):
    """Three classes (logits); every SwinBlock, LayerNorm and (SMESwinUnet)
    the mcct's BatchNorms and the external attentions meet bf16."""
    jcls, _ = MODELS[name]
    x = _x((2, HW, HW, 3))
    v = _variables(jcls(3, 3, **TINY), x)
    port = _port(build(name, n_channels=3, n_classes=3, dtype=torch.bfloat16, **TINY), v)
    kinds = (TS.SwinBlock, TS.PatchMerging, TS.PatchExpand, torch.nn.LayerNorm)
    if name == "SMESwinUnet":
        kinds += (TA.ExternalAttention, torch.nn.BatchNorm2d)
    assert bf16_forward_matches(jcls(3, 3, dtype=jnp.bfloat16, **TINY), port, v, x, kinds) \
        <= {"SwinUnet": 0.06, "SMESwinUnet": 0.15}[name]


def test_one_channel_is_repeated_to_three():
    x = _x((1, HW, HW, 1))
    jmod = JS.SwinUnet(1, 1, **TINY)
    v = _variables(jmod, x)
    want = jax_run(lambda vv, xx: jmod.apply(vv, xx), v, jnp.asarray(x))
    port = _port(build("SwinUnet", n_channels=1, n_classes=1, **TINY), v)
    assert port.patch_embed_proj.in_channels == 3
    with torch.no_grad():
        assert _rel(port(torch.from_numpy(x)).numpy(), want) <= TOL


@pytest.mark.parametrize("name", list(MODELS))
def test_port_state_dict_loads_into_jax_strictly(name):
    jmod, x, template = _swin_template(name)
    v = _variables(jmod, x)
    port = _port(build(name, n_channels=3, n_classes=2, **TINY), v)
    filled = import_torch_state(template, port.state_dict(), strict=True)
    got = dict(jax.tree_util.tree_leaves_with_path(filled))
    leaves = jax.tree_util.tree_leaves_with_path(v)
    assert len(got) == len(leaves)
    for path, want in leaves:
        np.testing.assert_array_equal(np.asarray(got[path]), want, err_msg=str(path))


@pytest.mark.parametrize("name", list(MODELS))
def test_init_parameters_reach_every_parameter(name):
    model = build(name, n_channels=3, n_classes=1, **TINY)
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))
    init_parameters(model, torch.Generator().manual_seed(0))
    assert all(bool(p.isfinite().all()) for p in model.parameters())
    table = model.layers_0_blocks[0].attn.relative_position_bias_table
    assert 0.01 < float(table.detach().std()) < 0.03


def test_train_cli_swin_unet_one_sgd_step_on_cpu(tmp_path):
    from accunet_tpu_torch.cli import train as cli

    sets = [f"model.{k}={v}" for k, v in TINY.items()]
    state, hist = cli.main(["--model", "SwinUnet", "--device", "cpu", "--synthetic", "--epochs",
                            "1", "--batch", "8", "--img-size", str(HW), "--ckpt-dir",
                            str(tmp_path / "ck"), "--set", *sets])
    assert isinstance(state.optimizer, torch.optim.SGD)
    assert state.step == 1 and np.isfinite(hist[0]["train"]["loss"])
    assert isinstance(state.model, TS.SwinUnet)
