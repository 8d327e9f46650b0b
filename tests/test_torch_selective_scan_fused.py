"""The fused selective scan's plain versions and its autograd function
(accunet_tpu_torch/ops/kernels/selective_scan.py) vs the JAX package, on the
same seeded numpy inputs (CPU; the CUDA kernels are held to these plain
versions on the card by tests/test_torch_segmamba_cuda.py and chip_smoke.py).

Tolerances: the forward 1e-5 (the same fp32 formula; the products and the
scan associate differently), as tests/test_torch_segmamba_scan.py; the
gradients 1e-4 absolute / 1e-3 relative (its GRAD_TOL); the plain backward
against torch autograd of the plain forward 1e-10 in float64 (the same
function, differentiated by hand and by autograd).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accunet_tpu.nn.ssm import BiMamba as JBiMamba
from accunet_tpu.ops import selective_scan as JS
from accunet_tpu_torch.nn.ssm import BiMamba
from accunet_tpu_torch.ops import selective_scan as TS
from accunet_tpu_torch.ops.kernels import selective_scan as K
from accunet_tpu_torch.port import state_dict_from_jax

GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
NAMES = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias")
# (D, z, delta_bias, delta_softplus, last state): BiMamba's call (all on),
# with and without the last state, everything off, and mixes of the flags
FLAGS = [(1, 1, 1, 1, 0), (1, 1, 1, 1, 1), (0, 0, 0, 0, 0), (1, 0, 1, 0, 1), (0, 1, 0, 1, 0),
         (1, 1, 0, 0, 1), (0, 0, 1, 1, 0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads would only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(bsz=2, d=6, n=16, l=40, seed=5):
    """BiMamba-like operands: decays A = -exp(U(-1, 1.5)) and delta > 0, so
    that exp(delta*A) < 1 with softplus on or off."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"u": f(bsz, d, l), "delta": 0.2 + 0.5 * np.abs(f(bsz, d, l)),
            "A": -np.exp(rs.uniform(-1.0, 1.5, (d, n))).astype(np.float32),
            "B": f(bsz, n, l), "C": f(bsz, n, l), "D": f(d), "z": f(bsz, d, l),
            "delta_bias": 0.1 * f(d)}


def _pick(xs, flags):
    """The operands with D, z and delta_bias dropped where the flags say."""
    has_d, has_z, has_bias = flags[:3]
    return [None if (k == "D" and not has_d) or (k == "z" and not has_z)
            or (k == "delta_bias" and not has_bias) else xs[k] for k in NAMES]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "D{}z{}bias{}sp{}last{}".format(*f))
def test_fused_forward_plain_matches_jax(flags):
    """selective_scan_fwd_plain (out and the last state) and the port's
    selective_scan through SelectiveScanFn vs JAX's selective_scan, b2 d6
    n16 l40, eagerly (one dispatch cache for every flag combination)."""
    ops = _pick(_inputs(), flags)
    softplus, last = bool(flags[3]), bool(flags[4])
    want = JS.selective_scan(*[None if x is None else jnp.asarray(x) for x in ops],
                             delta_softplus=softplus, return_last_state=True)
    t_ops = [None if x is None else torch.from_numpy(x) for x in ops]
    got = K.selective_scan_fwd_plain(*t_ops, delta_softplus=softplus)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=1e-5, rtol=1e-5)
    out = TS.selective_scan(*t_ops, delta_softplus=softplus, return_last_state=last)
    out = out if last else (out,)
    for g_, w_ in zip(out, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=1e-5, rtol=1e-5)


def test_fused_backward_plain_matches_jax_vjp():
    """All eight gradients of selective_scan_bwd_plain (BiMamba's flags,
    cotangents on out and on the last state) vs jax.vjp of JAX's
    selective_scan, b2 d6 n16 l40."""
    xs = _inputs()
    rs = np.random.RandomState(6)
    g = rs.standard_normal(xs["u"].shape).astype(np.float32)
    g_last = rs.standard_normal((2, 6, 16)).astype(np.float32)

    def fn(*ops):
        return JS.selective_scan(*ops, delta_softplus=True, return_last_state=True)

    want = jax.jit(lambda ops, cts: jax.vjp(fn, *ops)[1](cts))(
        [jnp.asarray(xs[k]) for k in NAMES], (jnp.asarray(g), jnp.asarray(g_last)))
    got = K.selective_scan_bwd_plain(*[torch.from_numpy(xs[k]) for k in NAMES], True,
                                     torch.from_numpy(g), torch.from_numpy(g_last))
    for name, g_, w_ in zip(NAMES, got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "D{}z{}bias{}sp{}last{}".format(*f))
def test_fused_backward_plain_is_the_vjp_float64(flags):
    """selective_scan_bwd_plain equals torch autograd through
    selective_scan_fwd_plain in float64, for each flag combination (the
    last state's cotangent where it is returned)."""
    ops = [None if x is None else torch.from_numpy(x).double().requires_grad_(True)
           for x in _pick(_inputs(2, 5, 4, 37, seed=7), flags)]
    softplus, last = bool(flags[3]), bool(flags[4])
    gen = torch.Generator().manual_seed(8)
    g = torch.randn(ops[0].shape, dtype=torch.float64, generator=gen)
    g_last = torch.randn(2, 5, 4, dtype=torch.float64, generator=gen) if last else None
    out, h_last = K.selective_scan_fwd_plain(*ops, delta_softplus=softplus)
    live = [x for x in ops if x is not None]
    want = torch.autograd.grad([out, h_last] if last else [out], live,
                               [g, g_last] if last else [g])
    got = K.selective_scan_bwd_plain(*[None if x is None else x.detach() for x in ops],
                                     softplus, g, g_last)
    assert [x is None for x in got] == [x is None for x in ops]
    for w_, g_ in zip(want, [x for x in got if x is not None]):
        torch.testing.assert_close(g_, w_, atol=1e-10, rtol=1e-10)


def test_selective_scan_fn_on_cpu_launches_nothing():
    """SelectiveScanFn on CPU tensors runs the plain versions: its gradients
    are selective_scan_bwd_plain's and the kernels' counters stay put."""
    xs = _inputs(1, 3, 4, 20, seed=9)
    ops = [torch.from_numpy(xs[k]).requires_grad_(True) for k in NAMES]
    before = (K.selective_scan_fwd.launches, K.selective_scan_bwd.launches)
    out, last = K.SelectiveScanFn.apply(*ops, True)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(10))
    got = torch.autograd.grad(out, ops, g)
    assert (K.selective_scan_fwd.launches, K.selective_scan_bwd.launches) == before
    want = K.selective_scan_bwd_plain(*[x.detach() for x in ops], True, g)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, atol=0, rtol=0)


def test_chunk_plan():
    """chunk_steps sizes the chunk from L: a short L leaves few lanes idle, a
    long one takes runs of 16 steps where N <= 16."""
    assert [K.chunk_steps(l) for l in (1, 40, 64, 65, 128, 129, 196, 4096, 4097, 12544)] == \
        [2, 2, 2, 4, 4, 8, 8, 8, 16, 16]
    assert K.chunk_steps(12544, 32) == 8
    assert [K.n_chunks(l) for l in (1, 64, 196, 256, 257, 3136, 12544)] == [1, 1, 1, 1, 2, 13, 25]


def test_bimamba_grads_match_jax():
    """BiMamba (d_model 8, L 24, b2) gradients of sum(out * w) with respect
    to x and every parameter vs jax.grad of JAX's BiMamba, the same weights
    from numpy (A_log = log(1..16) + noise, D = 1 + noise)."""
    rs = np.random.RandomState(11)
    x = rs.standard_normal((2, 24, 8)).astype(np.float32)
    w = rs.standard_normal((2, 24, 8)).astype(np.float32)
    jmod = JBiMamba(d_model=8)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def leaf(path, s):
        name = path[-1].key
        if name in ("A_log", "A_b_log"):
            v = np.log(np.arange(1, s.shape[-1] + 1))[None] + 0.1 * rs.standard_normal(s.shape)
        elif name in ("D", "D_b"):
            v = 1 + 0.1 * rs.standard_normal(s.shape)
        elif name == "kernel":
            v = rs.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        else:
            v = 0.1 * rs.standard_normal(s.shape)
        return np.asarray(v, dtype=np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    loss = lambda p, x_: jnp.sum(jmod.apply({"params": p}, x_) * w)  # noqa: E731
    jg_p, jg_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))

    port = BiMamba(8)
    port.load_state_dict(state_dict_from_jax({"params": params}), strict=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    (port(tx) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), **GRAD_TOL)
    want = state_dict_from_jax({"params": jg_p})
    assert set(want) == {n for n, _ in port.named_parameters()}
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name,
                                   **GRAD_TOL)
