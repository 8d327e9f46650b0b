"""bf16 training of the port vs the JAX package, on the CPU.

The port trains in bf16 as JAX's `dtype=jnp.bfloat16` does: each layer
computes in bf16 with its fp32 parameters cast at use, the BatchNorms take
fp32 statistics, and the parameters' gradients come out fp32.

  * A HANCBlock, a ResPath level and a UNeXt ShiftedBlock in train mode on
    bf16 input (8-16 filters, 8-16 px): the forward against the JAX module
    built with dtype=bfloat16 (2e-2 of its largest value: bf16 keeps 8 bits,
    and the two sides round at different points), the running statistics
    (2e-3 of each statistic's largest value), and the input and parameter
    gradients. The bf16 gradients of a train-mode block are ill-conditioned:
    the train-mode BatchNorm backward subtracts two nearly equal terms, and a
    max-pool or LeakyReLU near a tie takes another branch after a rounding,
    so JAX's bf16 gradients sit 7-26% of the largest gradient away from the
    float64 gradient of the same block (measured at these shapes), and the
    two bf16 results cannot be held to each other elementwise. So each
    side's bf16 gradient is held to the float64 gradient of the same block
    and inputs (the port in float64, which tests/test_torch_train_engine.py
    holds to JAX's float64 train step): the port's error, over the largest
    float64 gradient (the input's, and the parameters' together), may be at
    most 1.5 times JAX's, or 2e-2.
  * The port's BatchNorm on bf16 input against flax's BatchNorm(dtype=
    bfloat16): the output (8e-3 of its largest value, two bf16 ulps) and the
    running statistics (1e-6: both take fp32 statistics of the same bf16
    values).
  * `DepthwiseConv2dFn` on bf16 input against JAX's `dwconv2d` VJP: y and dx
    (bf16, 1e-2 of the largest value), dw (the port's plain wgrad sums in
    fp32 and keeps fp32, as the TPU kernel and the CUDA kernel do; JAX's CPU
    per-tap einsum rounds dw to bf16: 1e-2 of the largest value) and db
    (rounded to bf16 on both sides).
  * `model.to(torch.bfloat16)` (bf16 parameters) and dtype=torch.bfloat16
    (fp32 parameters cast at use) give bitwise the same eval forward when
    the fp32 parameters hold bf16 values, for ACC_UNet and UNext_S.
  * The train CLI for one epoch under train.compute_dtype=bfloat16 (ACC_UNet
    n_filts 8, 32x32): finite losses, bf16 activations, fp32 parameters and
    Adam state; a SegMamba model under the same setting trains in fp32 and
    logs it.
"""

import copy
import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as fnn

from accunet_tpu.nn import acc_blocks as J
from accunet_tpu.nn import unext_blocks as JB
from accunet_tpu.ops.pallas.dwconv2d import dwconv2d as jax_dwconv2d
from accunet_tpu_torch.models import build, init_parameters
from accunet_tpu_torch.nn import acc_blocks as T
from accunet_tpu_torch.nn import unext_blocks as TB
from accunet_tpu_torch.ops.kernels.dwconv2d import DepthwiseConv2dFn
from accunet_tpu_torch.port import state_dict_from_jax
from tests.test_torch_port_model import _numpy_tree
from tests.test_torch_unext import jax_run

BF = jnp.bfloat16
Y_TOL = 2e-2  # bf16 forward vs JAX, of the largest value
STATS_TOL = 2e-3  # running statistics after the bf16 forward, of each one's largest value
GRAD_FLOOR = 2e-2  # bf16 gradient vs float64, of the largest float64 gradient


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads would only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf(shape, seed, scale=1.0):
    """Seeded normal float32 values that bf16 holds exactly."""
    a = (scale * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _rel(got, want, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64).reshape(np.shape(got))
    return float(np.abs(got - want).max()) / (scale or float(np.abs(want).max()))


# name -> (JAX module, port module, x shape, cotangent shape, token map (h, w) or None)
BLOCKS = {
    "hanc_block": (lambda dt: J.HANCBlock(8, 16, k=3, inv_fctr=3, dtype=dt),
                   lambda: T.HANCBlock(8, 16, k=3), (2, 16, 16, 8), (2, 16, 16, 16), None),
    "respath_level": (lambda dt: J.ResPath(16, 1, dtype=dt), lambda: T.ResPath(16, 1),
                      (2, 16, 16, 16), (2, 16, 16, 16), None),
    "shifted_block": (lambda dt: JB.ShiftedBlock(16, dtype=dt), lambda: TB.ShiftedBlock(16),
                      (2, 8, 8, 16), (2, 8, 8, 16), (8, 8)),
}


def _jax_bf16_step(jmod, v, x, gy, hw):
    """The JAX module's train-mode bf16 output, its VJP (params, x) and the
    updated batch_stats, from one fast-compiled jit. A token block takes
    (B, H*W, C) tokens and H, W."""
    b, c = x.shape[0], x.shape[-1]
    extra = hw or ()

    def f(params, xx):
        vv = {**v, "params": params}
        if hw:
            return jmod.apply(vv, xx, *extra), {}
        return jmod.apply(vv, xx, True, mutable=["batch_stats"])

    def step(params, xx, gg):
        y, vjp, upd = jax.vjp(f, params, xx, has_aux=True)
        return y, vjp(gg), upd

    tok = (lambda a: a.reshape(b, -1, a.shape[-1])) if hw else (lambda a: a)
    y, (dp, dx), upd = jax_run(step, v["params"], tok(jnp.asarray(x).astype(BF)),
                               tok(jnp.asarray(gy).astype(BF)))
    return y.reshape(*x.shape[:-1], -1), dp, dx.reshape(*x.shape[:-1], c), upd


def _port_step(tmod, x, gy, dtype):
    """The port block's train-mode output and gradients (x, then each
    parameter by name) in `dtype`: bf16 keeps the fp32 parameters."""
    m = copy.deepcopy(tmod).train()
    if dtype == torch.float64:
        m = m.double()
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    y = m(xt)
    y.backward(torch.from_numpy(gy).to(dtype))
    return m, y.detach(), xt.grad, {n: p.grad for n, p in m.named_parameters()}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_bf16_train_mode_block_matches_jax(name):
    jfac, tfac, xs, gs, hw = BLOCKS[name]
    x, gy = _bf(xs, 1), _bf(gs, 2)
    jmod = jfac(BF)
    jx = jnp.asarray(x).astype(BF)
    init_args = (jx.reshape(xs[0], -1, xs[-1]), *hw) if hw else (jx,)
    v = _numpy_tree(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *init_args)), 3)
    want_y, want_dp, want_dx, upd = _jax_bf16_step(jmod, v, x, gy, hw)
    port = tfac()
    port.load_state_dict(state_dict_from_jax(v), strict=True)

    m, y, dx, dp = _port_step(port, x, gy, torch.bfloat16)
    assert y.dtype == dx.dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in dp.values())
    assert _rel(y.float(), want_y) <= Y_TOL
    if upd:  # the running statistics after the forward
        want_sd = state_dict_from_jax({"batch_stats": upd["batch_stats"]})
        got_sd = m.state_dict()
        names = [n for n in want_sd if n.endswith(("running_mean", "running_var"))]
        assert names
        for n in names:
            assert _rel(got_sd[n], want_sd[n]) <= STATS_TOL, n

    _, _, dx64, dp64 = _port_step(port, x, gy, torch.float64)
    want_dp = state_dict_from_jax({"params": want_dp})
    scale = max(float(g.abs().max()) for g in dp64.values())
    errs = {"x": (_rel(dx.float(), dx64), _rel(want_dx, dx64)),
            "params": (max(_rel(dp[n], g, scale) for n, g in dp64.items()),
                       max(_rel(want_dp[n], g, scale) for n, g in dp64.items()))}
    for group, (port_err, jax_err) in errs.items():
        assert port_err <= max(1.5 * jax_err, GRAD_FLOOR), (group, port_err, jax_err)


def test_batchnorm_bf16_matches_flax():
    """Train mode on bf16 input: flax's BatchNorm(dtype=bfloat16) takes the
    statistics in fp32 (fast variance) and normalises in fp32; the port's
    BatchNorm the same through torch's mixed-type batch norm."""
    x = _bf((4, 6, 5, 12), 4, 2.0) + 1.5
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=BF)
    v = _numpy_tree(jax.eval_shape(lambda: jbn.init(jax.random.PRNGKey(0),
                                                    jnp.asarray(x).astype(BF))), 5)
    want, upd = jax_run(lambda vv, xx: jbn.apply(vv, xx, mutable=["batch_stats"]), v,
                        jnp.asarray(x).astype(BF))
    port = T.BatchNorm(12)
    port.load_state_dict({k[1:]: t for k, t in state_dict_from_jax(v).items()}, strict=True)
    got = port.train()(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and port.running_var.dtype == torch.float32
    assert _rel(got.detach().float(), want) <= 8e-3
    want_sd = state_dict_from_jax(upd)
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(port, name).numpy(), want_sd["." + name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_depthwise_conv_fn_bf16_matches_jax_vjp():
    c = 24
    x, gy = _bf((2, 9, 11, c), 6), _bf((2, 9, 11, c), 7)
    w, b = _bf((3, 3, c), 8, 0.3), _bf((c,), 9, 0.1)
    want_y, vjp = jax.vjp(lambda xx, ww, bb: jax_dwconv2d(xx, ww.astype(BF), bb.astype(BF)),
                          jnp.asarray(x).astype(BF), jnp.asarray(w), jnp.asarray(b))
    want_dx, want_dw, want_db = vjp(jnp.asarray(gy).astype(BF))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    wt = torch.from_numpy(w).permute(2, 0, 1).unsqueeze(1).contiguous().requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = DepthwiseConv2dFn.apply(xt, wt, bt)
    y.backward(torch.from_numpy(gy).to(torch.bfloat16))
    assert y.dtype == xt.grad.dtype == torch.bfloat16
    assert wt.grad.dtype == bt.grad.dtype == torch.float32
    assert _rel(y.detach().float(), want_y) <= 1e-2
    assert _rel(xt.grad.float(), want_dx) <= 1e-2
    assert _rel(wt.grad[:, 0].permute(1, 2, 0), want_dw) <= 1e-2
    assert _rel(bt.grad, want_db) <= 1e-2


@pytest.mark.parametrize("name,kw", [("ACC_UNet", {"n_filts": 8}), ("UNext_S", {})])
def test_bf16_parameters_and_bf16_compute_give_the_same_forward(name, kw):
    """Eval mode: the whole-model cast (bf16 parameters, dtype None) and the
    compute dtype (fp32 parameters holding the same bf16 values) run the
    same operations on the same values."""
    from accunet_tpu_torch.nn.acc_blocks import BatchNorm

    m = init_parameters(build(name, n_channels=3, n_classes=1, dtype=torch.bfloat16, **kw),
                        torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, BatchNorm):  # statistics off their init values
                mod.running_mean.normal_(0, 0.1, generator=g)
                mod.running_var.uniform_(1, 1.2, generator=g)
        for t in [*m.parameters(), *m.buffers()]:
            if t.is_floating_point():
                t.copy_(t.to(torch.bfloat16).float())
    cast = copy.deepcopy(m)
    cast.dtype = None
    cast = cast.to(torch.bfloat16).eval()
    x = torch.randn(2, 32, 32, 3, generator=g)
    with torch.no_grad():
        got, want = m.eval()(x), cast(x)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


def test_train_cli_bf16_cpu(tmp_path):
    from accunet_tpu_torch.cli import train as cli

    argv = ["--model", "ACC_UNet", "--synthetic", "--img-size", "32", "--batch", "2",
            "--epochs", "1", "--device", "cpu", "--check-numerics",
            "--set", "model.n_filts=8", "train.compute_dtype=bfloat16"]
    state, hist = cli.main(argv)
    assert state.step == 4 and hist[0]["val"]["batches"] == 2
    assert all(np.isfinite(hist[0][s]["loss"]) for s in ("train", "val"))
    model = state.model
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(t.dtype == torch.float32 for s in state.optimizer.state.values()
               for t in s.values() if t.is_floating_point())
    seen = []
    model.cnv31.register_forward_hook(lambda mod, i, o: seen.append(o.dtype))
    with torch.no_grad():
        out = model(torch.zeros(1, 32, 32, 1))
    assert seen == [torch.bfloat16] and out.dtype == torch.float32


def test_train_cli_segmamba_stays_fp32(caplog):
    from accunet_tpu_torch.cli import train as cli

    argv = ["--model", "Segmamba", "--synthetic", "--img-size", "32", "--batch", "2",
            "--epochs", "1", "--device", "cpu", "--set", "model.depths=(1,1,1,1)",
            "model.feat_size=(8,16,24,32)", "model.hidden_size=40",
            "train.compute_dtype=bfloat16"]
    with caplog.at_level(logging.INFO):
        state, hist = cli.main(argv)
    assert "Segmamba trains in float32" in caplog.text
    assert all(np.isfinite(hist[0][s]["loss"]) for s in ("train", "val"))
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
