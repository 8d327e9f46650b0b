"""The port's SegMamba baseline (`Segmamba`) vs the JAX package at a small
size, and its train CLI on the CPU.

One seeded numpy weight tree (shaped by `jax.eval_shape` of the JAX init,
so nothing is compiled for it) goes into the JAX model as it is and into the
port through `state_dict_from_jax` with a strict load. One jitted JAX forward
with `capture_intermediates` gives every module's output; the port's come
from forward hooks. Depths (1, 1, 1, 1), feat (8, 16, 24, 32), hidden 40,
32x32, 3 channels, batch 2.

Tolerance: max |port - JAX| / max |JAX| <= 1e-4 per module output, 1e-5
for encoder1, which comes before any scan (fp32, the same formulas; the
scans and reductions associate differently).
"""

import math
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accunet_tpu.models.segmamba import build_segmamba as j_build
from accunet_tpu_torch.models import build, init_parameters
from accunet_tpu_torch.models.segmamba import build_segmamba
from accunet_tpu_torch.nn.ssm import BiMamba
from accunet_tpu_torch.port import state_dict_from_jax

SIZE = dict(depths=(1, 1, 1, 1), feat_size=(8, 16, 24, 32), hidden_size=40)
HW = 32

# port module name -> (JAX module path, what it is)
MODULES = {
    "encoder1.layer": ("encoder1/layer", "UnetResBlock, 1x1 residual"),
    "vit.stages.0.0.mamba": ("vit/stages_0_0/mamba", "BiMamba, L 256"),
    "vit.stages.3.0.mamba": ("vit/stages_3_0/mamba", "BiMamba, L 4"),
    "vit.stages.1.0": ("vit/stages_1_0", "PlainMambaLayer"),
    "vit.mlps.2": ("vit/mlps_2", "MlpChannel"),
    "encoder5.layer": ("encoder5/layer", "UnetResBlock, 1x1 residual"),
    "decoder1.layer": ("decoder1/layer", "UnetResBlock, identity residual"),
    "decoder5": ("decoder5", "UnetrUpBlock"),
    "decoder2": ("decoder2", "UnetrUpBlock"),
    "out": ("out", "UnetOutBlock"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads would only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_tree(shapes, rs):
    """Weights for every leaf of the JAX tree: kernels ~ N(0, 1/fan_in),
    biases and norm shifts N(0, 0.1), norm scales and D 1 + N(0, 0.1),
    A_log log(1..16) + N(0, 0.1)."""
    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name in ("kernel", "kernel_t"):
            fan_in = math.prod(shape[:-1]) if name == "kernel" else 4 * shape[2]
            return rs.standard_normal(shape) / math.sqrt(fan_in)
        if name in ("A_log", "A_b_log"):
            return np.log(np.arange(1, shape[-1] + 1))[None] + 0.1 * rs.standard_normal(shape)
        if name in ("scale", "D", "D_b"):
            return 1 + 0.1 * rs.standard_normal(shape)
        return 0.1 * rs.standard_normal(shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), dtype=np.float32), shapes)


@pytest.fixture(scope="module")
def pair():
    """(JAX intermediates, JAX logits, port outputs by module, port logits)."""
    x = np.random.RandomState(0).standard_normal((2, HW, HW, 3)).astype(np.float32)
    jmodel = j_build("Segmamba", in_chans=3, out_chans=1, **SIZE)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": _random_tree(shapes["params"], np.random.RandomState(1))}
    want, state = jax.jit(lambda v, x_: jmodel.apply(
        v, x_, capture_intermediates=True, mutable=["intermediates"]))(variables, x)

    port = build_segmamba("Segmamba", in_chans=3, out_chans=1, **SIZE)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    got, hooks = {}, []
    for name in MODULES:
        hooks.append(port.get_submodule(name).register_forward_hook(
            lambda mod, inp, out, name=name: got.__setitem__(name, out.detach().numpy())))
    with torch.no_grad():
        logits = port.eval()(torch.from_numpy(x)).numpy()
    for h in hooks:
        h.remove()
    return state["intermediates"], np.asarray(want), got, logits


def _rel(got, want):
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", list(MODULES))
def test_segmamba_module_matches_jax(pair, name):
    inter, _, got, _ = pair
    node = inter
    for part in MODULES[name][0].split("/"):
        node = node[part]
    want = np.asarray(node["__call__"][0])
    assert _rel(got[name], want) <= (1e-5 if name == "encoder1.layer" else 1e-4)


def test_segmamba_logits_match_jax(pair):
    _, want, _, logits = pair
    assert logits.shape == (2, HW, HW, 1) and logits.dtype == np.float32
    assert _rel(logits, want) <= 1e-4


def test_segmamba_init_follows_jax_initialisers():
    """init_parameters: A_log = log(1..16) and D = 1 in every BiMamba,
    LayerNorm (1, 0), biases 0, and lecun-normal weights from the generator
    (the same draws for the same seed)."""
    make = lambda: build("Segmamba", in_chans=3, out_chans=1, **SIZE)  # noqa: E731
    m1 = init_parameters(make(), torch.Generator().manual_seed(3))
    m2 = init_parameters(make(), torch.Generator().manual_seed(3))
    for (n1, p1), (_, p2) in zip(m1.state_dict().items(), m2.state_dict().items()):
        assert torch.equal(p1, p2), n1
    mixers = [m for m in m1.modules() if isinstance(m, BiMamba)]
    assert len(mixers) == 4
    want_a = torch.log(torch.arange(1, 17, dtype=torch.float32))
    for m in mixers:
        for a_log in (m.A_log, m.A_b_log):
            assert torch.equal(a_log, want_a.expand_as(a_log))
        assert torch.equal(m.D, torch.ones_like(m.D)) and torch.equal(m.D_b, m.D)
        assert not m.conv1d.bias.any() and not m.dt_proj.bias.any()
    norm = m1.vit.stages[0][0].norm
    assert torch.equal(norm.weight, torch.ones_like(norm.weight)) and not norm.bias.any()
    w = m1.vit.stages[1][0].mamba.conv1d.weight.detach()  # (d_inner, 1, 4): fan_in 4
    cut = 2 * math.sqrt(1 / 4) / 0.87962566103423978  # 2 sigma of flax lecun_normal
    assert w.shape == (32, 1, 4) and 0 < float(w.abs().max()) <= cut


@pytest.mark.parametrize("kwargs", [dict(text_fusion="film"), dict(block="tmb"),
                                    dict(text_fusion="hslca"), dict(text_fusion="crossattn"),
                                    dict(final_refine="simple_mlp")])
def test_segmamba_unported_axes_raise(kwargs):
    """The axes that raised NotImplementedError before the hybrid family was
    ported now build; a value no JAX model has raises ValueError naming it."""
    build_segmamba("Segmamba", 3, 1, **SIZE, **kwargs)
    (axis, _), = kwargs.items()
    with pytest.raises(ValueError, match="no_such"):
        build_segmamba("Segmamba", 3, 1, **SIZE, **{axis: "no_such"})


def test_segmamba_train_cli_cpu(tmp_path):
    """The port's train CLI on the CPU: Segmamba at the small size, 32x32,
    batch 2, one epoch with a checkpoint, then --resume auto for a second."""
    from accunet_tpu_torch.cli import train as cli

    argv = ["--model", "Segmamba", "--synthetic", "--img-size", str(HW), "--batch", "2",
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"), "--check-numerics",
            "--set", f"model.depths={SIZE['depths']}", f"model.feat_size={SIZE['feat_size']}",
            f"model.hidden_size={SIZE['hidden_size']}"]
    state, hist = cli.main(argv + ["--epochs", "1"])
    assert state.step == 4 and os.listdir(tmp_path / "ck") == ["epoch_0001.pth.tar"]
    state, hist2 = cli.main(argv + ["--epochs", "2", "--resume", "auto"])
    assert [h["epoch"] for h in hist + hist2] == [1, 2] and state.step == 8
    assert all(np.isfinite(h[s]["loss"]) for h in hist + hist2 for s in ("train", "val"))
    assert isinstance(state.model.vit.stages[0][0].mamba, BiMamba)
