"""The port's UNet_base, UNet++ and MultiResUNet vs the JAX package on the
CPU.

  * UpBlock (its ConvTranspose2x2 and two ConvBatchNorms) and a
    Multiresblock feeding a Respath, in train mode: the output, every BN's
    running statistics (the Respath's BNs updated twice a step, in order)
    and the gradients of the inputs and of every parameter against jax.vjp;
  * each model (UNet_base(base_width=4), Unetpp at its fixed 64-1024 widths,
    MultiResUnet(nfilt=8)), 32x32: the eval forward with one class (the
    sigmoid head's probabilities) and with three (UNet and MultiResUNet give
    n_classes + 1 logits, UNet++ n_classes), and the train-mode forward with
    every BN's updated running statistics;
  * each model with dtype=torch.bfloat16 over its fp32 parameters against
    the JAX model built with dtype=jnp.bfloat16, three classes (logits):
    within BF16_TOL of the largest magnitude (see `bf16_matches_jax`);
  * the registry: the 'MultiResUnet1?_<nfilt>_<alpha>' names parse as JAX's
    `build` parses them; a port state_dict loads into the JAX tree through
    `import_torch_state(..., strict=True)`; init_parameters reaches every
    parameter; the train CLI runs one tiny UNet_base epoch.

Weights: a seeded numpy tree shaped by `jax.eval_shape` of the JAX init,
loaded into the port by `state_dict_from_jax` with a strict load; the JAX
side runs through one jit per function compiled with FAST_COMPILE. Tolerance
1e-5 of the largest magnitude in fp32. The blocks run in float64 on both
sides: through a chain of train-mode BNs fp32 gradients part from float64 by
more than that (1.3e-5 of a BN scale's gradient in the Respath), so each
gradient is held to 1e-5 of its own largest in float64 (see `_check_grads`).
"""

import functools
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as fnn

from accunet_tpu.models import build as jax_build
from accunet_tpu.models import multires_unet as JM
from accunet_tpu.models import unet as JU
from accunet_tpu.models import unetpp as JPP
from accunet_tpu.port import import_torch_state
from accunet_tpu_torch.models import build, init_parameters
from accunet_tpu_torch.models import multires_unet as TM
from accunet_tpu_torch.models import unet as TU
from accunet_tpu_torch.models import unetpp as TPP
from accunet_tpu_torch.port import state_dict_from_jax
from tests.test_torch_spatial_mamba import TOL, _port, _rel
from tests.test_torch_unext import _one_torch_thread  # noqa: F401
from tests.test_torch_unext import _stats_match, _variables, _x, jax_forward, jax_run

HW = 32
# bf16 against bf16: each side's logits part from its own fp32 ones by up to
# 0.016 of their largest magnitude at these sizes, and from each other by as
# much (largest seen 0.015), as the two round in different places; 0.03 is
# about eight bf16 roundings (2^-8) of the largest logit
BF16_TOL = 0.03


def train_vjp(make, v, inputs, gy, train=True):
    """In float64: the train-mode output, the updated batch_stats and the
    (params, *inputs) gradients under the cotangent gy of the JAX module
    make(dtype), from one jit (train=False: a module without a train mode)."""
    kw = {"train": True} if train else {}
    with jax.enable_x64(True):
        jmod = make(jnp.float64)

        def fwd_bwd(vv, xs, g):
            def f(p, *a):
                return jmod.apply({**vv, "params": p}, *a, mutable=["batch_stats"], **kw)

            y, pull, upd = jax.vjp(f, vv["params"], *xs, has_aux=True)
            return y, upd, pull(g)

        f64 = functools.partial(jnp.asarray, dtype=jnp.float64)
        return jax_run(fwd_bwd, jax.tree_util.tree_map(f64, v), tuple(map(f64, inputs)),
                       f64(gy))


def jax_train64(make, v, x):
    """The train-mode output and updated batch_stats of the JAX model
    make(dtype) computing in float64 (its output cast to fp32, as every
    model's is), from one jit. For models where flax's BatchNorm, which takes
    the one-pass variance E[x^2] - E[x]^2, leaves JAX's own fp32 train-mode
    output further than 1e-5 from float64."""
    with jax.enable_x64(True):
        jmod = make(jnp.float64)
        f64 = functools.partial(jnp.asarray, dtype=jnp.float64)
        return jax_run(lambda vv, xx: jmod.apply(vv, xx, train=True, mutable=["batch_stats"]),
                       jax.tree_util.tree_map(f64, v), f64(x))


def port_grads(port, inputs, gy):
    """In float64: the train-mode output and the gradients {'x0', 'x1', ..,
    param name} of the port module."""
    xs = [torch.from_numpy(a).double().requires_grad_(True) for a in inputs]
    y = port.double().train()(*xs)
    y.backward(torch.from_numpy(gy).double())
    grads = {f"x{i}": t.grad for i, t in enumerate(xs)}
    grads.update((n, p.grad) for n, p in port.named_parameters())
    return y.detach().numpy(), grads


def bf16_matches_jax(jmod16, port, v, x):
    """port, built with dtype=torch.bfloat16 and holding the fp32 variables
    v, against jmod16 (the JAX model with dtype=jnp.bfloat16) on x: the
    port's output is float32, within BF16_TOL of the largest magnitude of
    JAX's and correlated with it (>= 0.999), and every BatchNorm in the port
    meets a bf16 input."""
    want = np.asarray(jax_run(lambda vv, xx: jmod16.apply(vv, xx), v, jnp.asarray(x)),
                      np.float32)
    seen = []
    for mod in port.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.register_forward_pre_hook(lambda m, inp: seen.append(inp[0].dtype))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert got.dtype == torch.float32
    assert seen and set(seen) == {torch.bfloat16}
    got = got.numpy()
    assert _rel(got, want) <= BF16_TOL
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] >= 0.999


def _check_grads(got, want_params, want_inputs, null=None):
    """Each gradient within TOL of its own largest magnitude; a parameter
    whose name matches `null` (a bias or shift that a train-mode BN takes
    out again, so its exact gradient is 0) is held to TOL of the largest
    weight gradient instead, on both sides. (state_dict_from_jax rounds the
    JAX side's parameter gradients to fp32.)"""
    want = {**{f"x{i}": g for i, g in enumerate(want_inputs)},
            **{k: t.numpy() for k, t in state_dict_from_jax({"params": want_params}).items()}}
    assert set(got) == set(want)
    scale = max(np.abs(w).max() for k, w in want.items() if k.endswith("weight"))
    nulls = 0
    for name, g in got.items():
        if null is not None and re.search(null, name):
            nulls += 1
            assert max(float(g.abs().max()), np.abs(want[name]).max()) <= TOL * scale, name
        else:
            assert _rel(g.numpy(), want[name]) <= TOL, name
    return nulls


def test_up_block_train_mode_and_grads_match_jax():
    """UpBlock in train mode, float64: x (2, 4, 4, 6) up to (2, 8, 8, 6), the skip 5
    channels, two ConvBatchNorms to 7."""
    x, skip, gy = _x((2, 4, 4, 6)), _x((2, 8, 8, 5), 1), _x((2, 8, 8, 7), 2)
    v = _variables(JU.UpBlock(7), x, skip, train=True)
    (want, upd, (dp, dx, ds)) = train_vjp(lambda dt: JU.UpBlock(7, 2, dt), v, (x, skip), gy)
    port = _port(TU.UpBlock(6, 5, 7), v)
    got, grads = port_grads(port, (x, skip), gy)
    assert _rel(got, want) <= TOL
    assert _stats_match(port, upd) == 4
    assert _check_grads(grads, dp, (dx, ds), r"nConvs\.\d\.conv\.bias") == 2


class _MrbRespath(fnn.Module):
    """A Multiresblock (W = 8 * 1.67) feeding a Respath of length 2."""

    dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, x, train: bool = False):
        y = JM.Multiresblock(8, 1.67, self.dtype, name="block")(x, train)
        return JM.Respath(8, 2, self.dtype, name="path")(y, train)


class _PortMrbRespath(torch.nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.block = TM.Multiresblock(cin, 8, 1.67)
        self.path = TM.Respath(TM.mrb_width(8, 1.67), 8, 2)

    def forward(self, x):
        return self.path(self.block(x))


def test_multiresblock_respath_train_mode_and_grads_match_jax():
    """Train mode, float64: the output, all 16 BNs' statistics (each of the Respath's
    two bns updated twice) and every gradient; the block's width is
    int(13.36 * 0.167) + int(.. * 0.333) + int(.. * 0.5) = 2 + 4 + 6."""
    x, gy = _x((2, 8, 8, 5)), _x((2, 8, 8, 8), 1)
    assert TM._mrb_filters(8, 1.67) == JM._mrb_filters(8, 1.67) == (2, 4, 6)
    v = _variables(_MrbRespath(), x, train=True)
    (want, upd, (dp, dx)) = train_vjp(_MrbRespath, v, (x,), gy)
    port = _port(_PortMrbRespath(5), v)
    got, grads = port_grads(port, (x,), gy)
    assert _rel(got, want) <= TOL
    # block: 4 Conv2dBNs + 2 BNs; path: 2 x (2 Conv2dBNs + 1 BN)
    assert _stats_match(port, upd) == 2 * (6 + 6)
    # every conv bias (a BN follows), the shortcut BNs' and batch_norm1's
    # shifts (batch_norm2 or the bns' second use follows the sum)
    null = r"conv1\.bias|shortcuts?(\.\d)?\.batchnorm\.bias|batch_norm1\.bias"
    assert _check_grads(grads, dp, (dx,), null) == 4 + 2 + 4 + 2


MODELS = {
    "UNet_base": (JU.UNetBase, TU.UNetBase, dict(base_width=4), 1),
    "Unetpp": (JPP.UNetPlusPlus, TPP.UNetPlusPlus, {}, 0),
    "MultiResUnet": (JM.MultiResUnet, TM.MultiResUnet, dict(nfilt=8), 1),
}


@pytest.mark.parametrize("name,n_classes", [(n, c) for n in MODELS for c in (1, 3)])
def test_model_matches_jax(name, n_classes):
    """Eval output and, in train mode, the output and every BN's running
    statistics; the head's channels and the sigmoid's range."""
    jcls, tcls, kw, plus = MODELS[name]
    x = _x((2, HW, HW, 3))
    jmod = jcls(3, n_classes, **kw)
    v = _variables(jmod, x)
    want, (want_train, updates) = jax_forward(jmod, v, x)
    port = _port(build(name, n_channels=3, n_classes=n_classes, dtype=torch.float32, **kw), v)
    assert isinstance(port, tcls)
    out_ch = 1 if n_classes == 1 else n_classes + plus
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        assert got.shape == (2, HW, HW, out_ch) and got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= TOL
        if n_classes == 1:
            assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
        got = port.train()(torch.from_numpy(x))
    assert _rel(got.numpy(), want_train) <= TOL
    assert _stats_match(port, updates) == sum(
        2 for m in port.modules() if isinstance(m, torch.nn.BatchNorm2d))


@pytest.mark.parametrize("name", list(MODELS))
def test_model_bf16_forward_matches_jax(name):
    jcls, _, kw, _ = MODELS[name]
    x = _x((2, HW, HW, 3))
    v = _variables(jcls(3, 3, **kw), x)
    port = _port(build(name, n_channels=3, n_classes=3, dtype=torch.bfloat16, **kw), v)
    bf16_matches_jax(jcls(3, 3, dtype=jnp.bfloat16, **kw), port, v, x)


@pytest.mark.parametrize("name", ["MultiResUnet1_32_1.67", "MultiResUnet_16_1.0",
                                  "MultiResUnet1_8_2.5"])
def test_multires_names_parse_as_in_jax(name):
    jm = jax_build(name)
    port = build(name, n_channels=3, n_classes=1)
    want = TM.MultiResUnet(3, 1, nfilt=jm.nfilt, alpha=jm.alpha)
    assert {k: v.shape for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in want.state_dict().items()}
    with pytest.raises(KeyError, match="unknown model"):
        build("MultiResUnet2_32_1.67")


@pytest.mark.parametrize("name,kw", [("UNet_base", dict(base_width=4)), ("Unetpp", {}),
                                     ("MultiResUnet", dict(nfilt=8))])
def test_port_state_dict_loads_into_jax_strictly(name, kw):
    """The port's state_dict fills every leaf of the JAX tree by name
    (import_torch_state, strict), with the values it came from: a reference
    checkpoint JAX reads, the port reads."""
    jmod = jax_build(name, n_channels=3, n_classes=2, **kw)
    x = _x((1, HW, HW, 3))
    v = _variables(jmod, x)
    template = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port = _port(build(name, n_channels=3, n_classes=2, **kw), v)
    filled = import_torch_state(template, port.state_dict(), strict=True)
    leaves = jax.tree_util.tree_leaves_with_path(v)
    assert len(leaves) == len(jax.tree_util.tree_leaves(filled))
    for path, want in leaves:
        got = filled
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=str(path))


@pytest.mark.parametrize("name,kw", [("UNet_base", dict(base_width=4)), ("Unetpp", {}),
                                     ("MultiResUnet", dict(nfilt=8))])
def test_init_parameters_reach_every_parameter(name, kw):
    model = build(name, n_channels=3, n_classes=1, **kw)
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))
    init_parameters(model, torch.Generator().manual_seed(0))
    assert all(bool(p.isfinite().all()) for p in model.parameters())


def test_train_cli_unet_base_on_cpu(tmp_path):
    from accunet_tpu_torch.cli import train as cli

    argv = ["--model", "UNet_base", "--device", "cpu", "--synthetic", "--epochs", "1",
            "--batch", "2", "--img-size", "32", "--ckpt-dir", str(tmp_path / "ck"), "--set",
            "model.base_width=4"]
    state, hist = cli.main(argv)
    assert hist[0]["epoch"] == 1 and np.isfinite(hist[0]["train"]["loss"])
    assert state.step == 4 and isinstance(state.model, TU.UNetBase)
