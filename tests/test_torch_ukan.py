"""The port's U-KAN vs the JAX package on the CPU.

  * KANBlock (LayerNorm, three SiLU KANLinears each with its DWBnRelu) in
    train mode: the output, the BN running statistics, and the gradients of
    the input and of every parameter against jax.vjp; the depthwise convs'
    weight and bias gradients come from the plain wgrad (DepthwiseConv2dFn on
    a CPU tensor), once per DWBnRelu (the bias gradient, 0 but for rounding
    behind the train-mode BN, within 1e-5 of the weight gradient's scale on
    both sides);
  * UKAN under both registry names at embed dims (16, 24, 32), 64x64: the
    eval forward with one class (the sigmoid head's probabilities) and with
    two (logits), and the train-mode forward with every BN's updated running
    statistics (the model has no dropout);
  * init_parameters reaching every parameter; the train CLI for one tiny
    epoch.

Weights: a seeded numpy tree shaped by `jax.eval_shape` of the JAX init,
loaded into the port by `state_dict_from_jax` with a strict load; the JAX
side runs through one jit per function compiled with FAST_COMPILE. Tolerance
1e-5 of the largest magnitude in fp32 (each gradient: of its own largest).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accunet_tpu.models import u_kan as JU
from accunet_tpu_torch.models import build, init_parameters
from accunet_tpu_torch.models import u_kan as TU
from accunet_tpu_torch.ops.kernels import dwconv2d as DW
from accunet_tpu_torch.port import state_dict_from_jax
from tests.test_torch_spatial_mamba import TOL, _port, _rel
from tests.test_torch_unext import FAST_COMPILE, _one_torch_thread, _variables, _x  # noqa: F401
from tests.test_torch_unext import _stats_match, jax_forward

EMBED = (16, 24, 32)
HW = 64


def test_kan_block_train_mode_and_grads_match_jax(monkeypatch):
    b, h, w, c = 2, 6, 5, 16
    x, gy = _x((b, h, w, c)), _x((b, h, w, c), 1)
    jmod = JU.KANBlock(c)
    tok = x.reshape(b, h * w, c)
    v = _variables(jmod, tok, h, w, train=True)

    def fwd_bwd(vv, xx, gg):
        def f(p, t):
            y, upd = jmod.apply({**vv, "params": p}, t, h, w, train=True,
                                mutable=["batch_stats"])
            return y, upd

        y, pull, upd = jax.vjp(f, vv["params"], xx, has_aux=True)
        return y, upd, pull(gg)

    # the depthwise conv's weight gradient (a batch-grouped conv) needs the
    # convolution-group-converter pass that FAST_COMPILE turns off
    opts = {k: o for k, o in FAST_COMPILE.items() if k != "xla_disable_hlo_passes"}
    args = (v, jnp.asarray(tok), jnp.asarray(gy.reshape(b, h * w, c)))
    want, upd, (dp, dx) = jax.tree_util.tree_map(
        np.asarray, jax.jit(fwd_bwd).lower(*args).compile(compiler_options=opts)(*args))

    calls = []
    plain = DW.dwconv2d_wgrad_reference
    monkeypatch.setattr(DW, "dwconv2d_wgrad_reference",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    port = _port(TU.KANBlock(c), v).train()
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port(xt)
    y.backward(torch.from_numpy(gy))
    assert _rel(y.detach().numpy(), want.reshape(b, h, w, c)) <= TOL
    assert _stats_match(port, upd) == 6  # three BNs' mean and variance
    assert calls == [(b, h, w, c)] * 3
    dp = {k: t.numpy() for k, t in state_dict_from_jax({"params": dp}).items()}
    grads = {"x": (xt.grad, dx.reshape(b, h, w, c)),
             **{n: (p.grad, dp[n]) for n, p in port.named_parameters()}}
    assert len(grads) == 1 + 2 + 3 * (3 + 4)  # x; norm2; fc (3 tensors), dwconv, bn (2 each)
    for name, (g, want_g) in grads.items():
        if name.endswith("dwconv.bias"):
            # the conv's bias meets a train-mode BN, which takes the batch
            # mean out: its gradient is 0 but for rounding, on both sides
            scale = np.abs(grads[name[:-4] + "weight"][1]).max()
            assert max(float(g.abs().max()), np.abs(want_g).max()) <= TOL * scale, name
        else:
            assert _rel(g.numpy(), want_g) <= TOL, name


@pytest.mark.parametrize("name,n_classes", [("UKAN", 1), ("U-KAN", 2)])
def test_ukan_matches_jax(name, n_classes):
    """Eval output and, in train mode, the output and every BN's running
    statistics (the eval forward's one class: probabilities in [0, 1])."""
    x = _x((2, HW, HW, 3))
    jmod = JU.UKAN(3, n_classes, embed_dims=EMBED)
    v = _variables(jmod, x)
    want, (want_train, updates) = jax_forward(jmod, v, x)
    port = _port(build(name, n_channels=3, n_classes=n_classes, embed_dims=EMBED,
                       dtype=torch.float32), v)
    assert isinstance(port, TU.UKAN)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        assert got.shape == (2, HW, HW, n_classes) and _rel(got.numpy(), want) <= TOL
        if n_classes == 1:
            assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
        got = port.train()(torch.from_numpy(x))
    assert _rel(got.numpy(), want_train) <= TOL
    # 8 ConvLayers x 2 BNs and 4 KANBlocks x 3 DWBnRelus, mean and variance
    assert _stats_match(port, updates) == 2 * (16 + 12)


def test_init_parameters_reach_every_parameter():
    model = TU.UKAN(3, 1, embed_dims=EMBED)
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))
    init_parameters(model, torch.Generator().manual_seed(0))
    assert all(bool(p.isfinite().all()) for p in model.parameters())


def test_train_cli_ukan_on_cpu(tmp_path):
    from accunet_tpu_torch.cli import train as cli

    argv = ["--model", "U-KAN", "--device", "cpu", "--synthetic", "--epochs", "1",
            "--batch", "2", "--img-size", "32", "--ckpt-dir", str(tmp_path / "ck"), "--set",
            f"model.embed_dims={EMBED}"]
    state, hist = cli.main(argv)
    assert hist[0]["epoch"] == 1 and np.isfinite(hist[0]["train"]["loss"])
    assert state.step == 4 and isinstance(state.model, TU.UKAN)
