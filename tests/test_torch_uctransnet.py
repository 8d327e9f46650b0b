"""The port's UCTransNet vs the JAX package on the CPU.

  * ChannelTransformer (img_size 32: 4 tokens a level, channels 8-64, one
    layer) in train mode, float64: the output, the Reconstructs' BN
    statistics and the gradients of the four inputs and of every parameter
    against jax.vjp; the instance norm of the scores alone;
  * UCTransNet(img_size=64, base_channel=8, num_layers=1) at 64x64: the eval
    forward with one class (the sigmoid head) and with three (n_classes + 1
    logits), and the train-mode forward with every BN's running statistics
    (against JAX in float64: see the test); with dtype=torch.bfloat16
    against JAX's dtype=jnp.bfloat16 (tests/test_torch_unets.py
    `bf16_matches_jax`), the channel transformer's blocks in bf16;
  * at its default img_size 224 a 256x256 input fails in both, as the JAX
    train CLI meets it at UCTransNet's 256 preset (ROADMAP Queue 3);
  * a port state_dict loads into the JAX tree through
    `import_torch_state(..., strict=True)`; init_parameters reaches every
    parameter and zeroes the position embeddings.

Weights: a seeded numpy tree shaped by `jax.eval_shape` of the JAX init,
loaded into the port by `state_dict_from_jax` with a strict load; the JAX
side runs through one jit per function compiled with FAST_COMPILE. Tolerance
1e-5 of the largest magnitude in fp32; gradients in float64, as in
tests/test_torch_unets.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as fnn

from accunet_tpu.models import uctransnet as JT
from accunet_tpu.port import import_torch_state
from accunet_tpu_torch.models import build, init_parameters
from accunet_tpu_torch.models import uctransnet as TT
from tests.test_torch_spatial_mamba import TOL, _port, _rel
from tests.test_torch_unets import (
    _check_grads,
    bf16_matches_jax,
    jax_train64,
    port_grads,
    train_vjp,
)
from tests.test_torch_unext import _one_torch_thread  # noqa: F401
from tests.test_torch_unext import _stats_match, _variables, _x, jax_run

HW = 64
KW = dict(img_size=HW, base_channel=8, num_layers=1)
CHANNELS = (8, 16, 32, 64)


def test_instance_norm_scores_match_jax():
    s = 3 + 2 * _x((2, 4, 6, 30))
    want = jax_run(JT._instance_norm_scores, jnp.asarray(s))
    got = TT._instance_norm_scores(torch.from_numpy(s)).numpy()
    assert _rel(got, want) <= TOL


class _FlatCT(fnn.Module):
    """ChannelTransformer(CHANNELS, img_size 32, one layer) with the four maps
    as separate arguments (each gets its gradient) and one flat output."""

    dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, *en, train: bool = False):
        outs = JT.ChannelTransformer(CHANNELS, 32, num_layers=1, dtype=self.dtype,
                                     name="ct")(en, train)
        return jnp.concatenate([o.reshape(o.shape[0], -1) for o in outs], axis=1)


class _PortCT(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.ct = TT.ChannelTransformer(CHANNELS, 32, num_layers=1)

    def forward(self, *en):
        return torch.cat([t.flatten(1) for t in self.ct(en)], dim=1)


def test_channel_transformer_train_mode_and_grads_match_jax():
    en = [_x((2, 32 >> i, 32 >> i, c), seed=i) for i, c in enumerate(CHANNELS)]
    gy = _x((2, sum(t[0].size for t in en)), seed=9)
    v = _variables(_FlatCT(), *en, train=True)
    want, upd, (dp, *dx) = train_vjp(_FlatCT, v, en, gy)
    port = _port(_PortCT(), v)
    got, grads = port_grads(port, en, gy)
    assert _rel(got, want) <= TOL
    assert _stats_match(port, upd) == 8  # four Reconstruct BNs
    # each Reconstruct's conv bias meets its train-mode BN, and so does the
    # final LayerNorm's shift before it (a constant per channel)
    null = r"reconstruct_\d\.conv\.bias|encoder_norm\d\.bias"
    assert _check_grads(grads, dp, dx, null) == 8


@pytest.mark.parametrize("n_classes", [1, 3])
def test_uctransnet_matches_jax(n_classes):
    """The eval forward in fp32 against JAX's fp32 one; the port's fp32
    train-mode forward and BN statistics against JAX's computed in float64:
    JAX's own fp32 train-mode output sits 6.8e-5 from float64 here (flax's
    BatchNorm takes the one-pass variance), the port's 7.2e-6."""
    x = _x((2, HW, HW, 3))
    jmod = JT.UCTransNet(3, n_classes, **KW)
    v = _variables(jmod, x)
    want = jax_run(lambda vv, xx: jmod.apply(vv, xx), v, jnp.asarray(x))
    want_train, updates = jax_train64(
        lambda dt: JT.UCTransNet(3, n_classes, dtype=dt, **KW), v, x)
    port = _port(build("UCTransNet", n_channels=3, n_classes=n_classes, dtype=torch.float32,
                       **KW), v)
    assert isinstance(port, TT.UCTransNet)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        assert got.shape == (2, HW, HW, 1 if n_classes == 1 else n_classes + 1)
        assert _rel(got.numpy(), want) <= TOL
        if n_classes == 1:
            assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
        got = port.train()(torch.from_numpy(x))
    assert _rel(got.numpy(), want_train) <= TOL
    # 9 encoder and 8 decoder ConvBatchNorms, 4 Reconstructs
    assert _stats_match(port, updates) == 2 * (9 + 8 + 4)


def test_uctransnet_bf16_forward_matches_jax():
    x = _x((2, HW, HW, 3))
    v = _variables(JT.UCTransNet(3, 3, **KW), x)
    port = _port(build("UCTransNet", n_channels=3, n_classes=3, dtype=torch.bfloat16, **KW), v)
    seen = []
    for mod in port.modules():
        if isinstance(mod, (TT.ChannelEmbeddings, TT.BlockViT, TT.AttentionOrg)):
            mod.register_forward_hook(
                lambda m, inp, out: seen.append(out[0].dtype if isinstance(out, list)
                                                else out.dtype))
    bf16_matches_jax(JT.UCTransNet(3, 3, dtype=jnp.bfloat16, **KW), port, v, x)
    assert len(seen) == 4 + 1 + 1 and set(seen) == {torch.bfloat16}


def test_default_img_size_fails_at_256_as_in_jax():
    """img_size defaults to 224 (196 position embeddings a level); a 256x256
    input patchifies to 256 tokens, in JAX and in the port."""
    x = np.zeros((1, 256, 256, 3), np.float32)
    jmod = JT.UCTransNet(3, 1, base_channel=8, num_layers=1)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port = build("UCTransNet", n_channels=3, n_classes=1, base_channel=8, num_layers=1)
    assert port.mtc.embeddings_1.position_embeddings.shape == (1, 196, 8)
    with torch.no_grad(), pytest.raises(RuntimeError, match="size of tensor"):
        port.eval()(torch.from_numpy(x))


def test_port_state_dict_loads_into_jax_strictly():
    x = _x((1, HW, HW, 3))
    jmod = JT.UCTransNet(3, 2, **KW)
    v = _variables(jmod, x)
    template = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port = _port(build("UCTransNet", n_channels=3, n_classes=2, **KW), v)
    filled = import_torch_state(template, port.state_dict(), strict=True)
    got = dict(jax.tree_util.tree_leaves_with_path(filled))
    leaves = jax.tree_util.tree_leaves_with_path(v)
    assert len(got) == len(leaves)
    for path, want in leaves:
        np.testing.assert_array_equal(np.asarray(got[path]), want, err_msg=str(path))


def test_init_parameters_reach_every_parameter():
    model = build("UCTransNet", n_channels=3, n_classes=1, **KW)
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))
    init_parameters(model, torch.Generator().manual_seed(0))
    assert all(bool(p.isfinite().all()) for p in model.parameters())
    pos = [p for n, p in model.named_parameters() if n.endswith("position_embeddings")]
    assert len(pos) == 4 and all(not p.any() for p in pos)
