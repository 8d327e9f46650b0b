"""The port's UNext_InceptionNext_MLFC (and _fKAN) vs the JAX package on the
CPU.

  * blocks: InceptionDWConv2d (dim 20, band 7, branch ratio 0.25 and the
    class default 0.125) and MetaNeXtBlock (dim 16, band 5) in eval mode and
    in a train-mode forward with the block's BN statistics;
  * the model at full width, b2 64x64: the eval forward of both names; the
    train-mode forward with all 42 BNs' running statistics, in float64; a
    bf16 forward;
  * the parameter count (2,918,367 for both names, as JAX's init gives), the
    build through the train CLI's rule at the 256 preset, and the shape
    error at 224, where the MLFC's levels do not nest, on both sides.

Weights: a seeded numpy tree shaped by `jax.eval_shape` of the JAX init,
loaded by `state_dict_from_jax` with a strict load. Tolerances: TOL (1e-5,
relative and absolute) in fp32. The train-mode forward and its running
statistics are held in float64, to TRAIN64_TOL of each statistic's largest
value: at b2 64x64 the token blocks' BNs normalise over few values a
channel (8 at dbn1), where fp32 rounding on either side departs from
float64 by more than 1e-5, as UNext_CMRF's does
(tests/test_torch_unext_cmrf_rest.py); JAX computes its bilinear
resizes' fractions in fp32 even for float64 maps
(accunet_tpu/ops/resize.py:23-34), which leaves up to 7e-9 between the
decoder's statistics. The
bf16 forward is held by `bf16_forward_matches` with its default bar: no
further from the fp32 logits than JAX's bf16 ones plus 3e-2 of the largest,
as the other families' bf16 tests hold theirs (the two sides round at other
points: the port's BNs and LayerNorms normalise in fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accunet_tpu.models import unext_inceptionnext as J
from accunet_tpu_torch.models import build, build_for
from accunet_tpu_torch.models import unext_inceptionnext as T
from tests.test_torch_swin_unet import bf16_forward_matches
from tests.test_torch_unext import TOL, _port, _stats_match, _variables, _x, jax_forward, jax_run
from tests.test_torch_unext import _one_torch_thread  # noqa: F401

NAMES = ("UNext_InceptionNext_MLFC", "UNext_InceptionNext_MLFC_fKAN")
N_PARAMS = 2918367
HW = 64
TRAIN64_TOL = 1e-6
N_BNS = 42  # the stem, 3 stages x (downsample + 2 blocks), the MLFC 25, dbn1-4 (+ SE BNs)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jmodel(name, dtype=jnp.float32):
    return J.UNextInceptionNextMLFC(3, 1, use_fkan=name.endswith("_fKAN"), dtype=dtype)


@pytest.fixture(scope="module")
def weights():
    """One numpy tree (shapes of JAX's init at 64x64, 3 channels, 1 class)
    and the b2 input."""
    x = _x((2, HW, HW, 3))
    return _variables(_jmodel(NAMES[0]), x), x


@pytest.mark.parametrize("dim,band,ratio", [(20, 7, 0.25), (20, 7, 0.125)])
def test_inception_dwconv_matches_jax(dim, band, ratio):
    x = _x((2, 9, 8, dim))
    jmod = J.InceptionDWConv2d(dim, 3, band, ratio)
    v = _variables(jmod, x)
    port = _port(T.InceptionDWConv2d(dim, 3, band, ratio), v)
    gc = int(dim * ratio)
    assert port.split == (dim - 3 * gc, gc, gc, gc)
    want = jax_run(lambda vv, xx: jmod.apply(vv, xx), v, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), want, **TOL)


def test_metanext_block_matches_jax():
    """MetaNeXtBlock(16, band 5): eval, and a train-mode forward with its
    BN's statistics (momentum 0.9 in flax)."""
    x = _x((2, 6, 7, 16))
    jmod = J.MetaNeXtBlock(16, 5)
    v = _variables(jmod, x)
    v["params"]["gamma"] = v["params"]["gamma"] + 0.5  # away from its 1.0 init
    port = _port(T.MetaNeXtBlock(16, 5), v)
    want, (want_t, upd) = jax_forward(jmod, v, x)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
        got_t = port.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_t, want_t, **TOL)
    assert _stats_match(port, upd) == 2


@pytest.mark.parametrize("name", NAMES)
def test_eval_forward_matches_jax(name, weights):
    v, x = weights
    jmod = _jmodel(name)
    want = jax_run(lambda vv, xx: jmod.apply(vv, xx), v, jnp.asarray(x))
    port = _port(build(name, n_channels=3, n_classes=1), v).eval()
    assert port.use_fkan == name.endswith("_fKAN")
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, HW, HW, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _flax_stats(upd):
    """flax's updated batch_stats as {port state_dict key: float64 array}."""
    from accunet_tpu_torch.port.jax_params import _torch_key

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(upd["batch_stats"])[0]:
        names = tuple(p.key for p in path)
        stat = {"mean": "running_mean", "var": "running_var"}[names[-1]]
        out[f"{_torch_key(names[:-1])}.{stat}"] = np.asarray(leaf, np.float64)
    return out


def test_train_forward_and_statistics_match_jax_float64(weights):
    v, x = weights
    with jax.enable_x64(True):
        f64 = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
        jmod = _jmodel(NAMES[0], jnp.float64)
        want, upd = jax_run(lambda vv, xx: jmod.apply(vv, xx, train=True,
                                                      mutable=["batch_stats"]),
                            jax.tree_util.tree_map(f64, v), f64(x))
    port = _port(T.UNextInceptionNextMLFC(3, 1), v).double().train()
    with torch.no_grad():
        got = port(torch.from_numpy(x).double())
    # both models return float32
    assert _rel(got.numpy(), want) <= TOL["rtol"]
    want_stats = _flax_stats(upd)
    n_bns = sum(isinstance(m, torch.nn.BatchNorm2d) for m in port.modules())
    assert n_bns == N_BNS and len(want_stats) == 2 * N_BNS
    got_sd = port.state_dict()
    for k, w in want_stats.items():
        assert _rel(got_sd[k].numpy(), w) <= TRAIN64_TOL, k


def test_bf16_forward_matches_jax(weights):
    v, x = weights
    port = _port(build(NAMES[0], n_channels=3, n_classes=1, dtype=torch.bfloat16), v).eval()
    bf16_forward_matches(_jmodel(NAMES[0], jnp.bfloat16), port, v, x,
                         (T.MetaNeXtBlock, T.InceptionDWConv2d))


@pytest.mark.parametrize("name", NAMES)
def test_parameter_count_and_cli_build_rule(name):
    """JAX's init has 2,918,367 parameters at any side; the train CLI's rule
    (the preset's 256, 3 channels, 1 class) builds the same model."""
    from accunet_tpu_torch.config import get_config

    jcount = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(jax.eval_shape(
        lambda: _jmodel(name).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"])))
    assert jcount == N_PARAMS
    cfg = get_config(name)
    assert cfg.data.img_size == 256
    model = build_for(name, cfg.data.img_size, 3, 1, torch.float32, **cfg.model.kwargs)
    assert isinstance(model, T.UNextInceptionNextMLFC)
    assert sum(p.numel() for p in model.parameters()) == N_PARAMS


def test_224_raises_a_shape_error_as_jax_does():
    """At 224 stage3's 7x7 map meets a 4x4 t4 in the MLFC: both sides raise
    a shape error (JAX at trace time, here in the forward)."""
    x = np.zeros((1, 224, 224, 3), np.float32)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(lambda: _jmodel(NAMES[0]).init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port = T.UNextInceptionNextMLFC(3, 1).eval()
    with torch.no_grad(), pytest.raises(RuntimeError, match="must match the size"):
        port(torch.from_numpy(x))
