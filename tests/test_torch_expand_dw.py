"""The hybrid HANCBlock front half (`expand_dw`) of the port vs the JAX
package, on CPU.

- `expand_dw_plain` against JAX's Pallas kernel `expand_dw_nhwc` in interpret
  mode at tests/test_expand_dw.py's shape, and against JAX's XLA formula of
  that file (:32-42) at ragged shapes; each also with a large BN1 shift, so
  that lrelu(t1) != 0 and a halo padded before the activation would show at
  all four borders. Tolerance 2e-5, as tests/test_expand_dw.py.
- The wrapper on a CPU tensor (biases folded into the shifts) against the
  plain version, float64 kept in float64.
- `HANCBlock(hybrid=True)` in eval mode against JAX's `HANCBlock(fuse='force')`
  (its hybrid branch, the kernel in interpret mode), weights from a
  `jax.eval_shape` template filled from numpy and BN statistics moved by one
  JAX train step. Tolerance 1e-4: the port folds the BNs and sums the taps
  in fp32 in another order.
- The gate, by counting calls of the plain version: train mode, E below
  `hybrid_e_min` and fused blocks never take it; ACCUNet at n_filts=32 takes
  it at cnv72 alone, and with hybrid_e_min=96 at every unfused block with
  E >= 96. A PendingSE input is applied first; the parameter tree does not
  change; the eval CLI runs ACC_UNet_W with 3 classes and the hybrid on.
The whole W model with the hybrid on is held to JAX in
tests/test_torch_port_model.py (test_acc_unet_hybrid_matches_jax)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accunet_tpu.nn import acc_blocks as J
from accunet_tpu.ops.pallas.expand_dw import expand_dw_nhwc
from accunet_tpu_torch.models import ACCUNet
from accunet_tpu_torch.nn import acc_blocks as T
from accunet_tpu_torch.ops.kernels import expand_dw as ED
from accunet_tpu_torch.port import state_dict_from_jax

TOL = dict(atol=2e-5, rtol=2e-5)


def _numpy_tree(template, seed):
    """A variables tree of `template`'s shapes filled from numpy: lecun-
    scaled kernels, BN scales and variances near 1, small biases, BN shifts
    and means (as tests/test_torch_port_model.py fills its trees)."""
    rs = np.random.RandomState(seed)

    def leaf(path, sd):
        name, shape = path[-1].key, sd.shape
        z = rs.standard_normal(shape).astype(np.float32)
        if name in ("kernel", "kernel_t"):
            z = z / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            z = 1.0 + 0.1 * np.abs(z)
        else:
            z = 0.1 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, template)


def _jax_variables(jmod, inputs, seed=2):
    """Random variables of jmod's shapes, then one train step to move the
    BN statistics."""
    xs = [jnp.asarray(a) for a in inputs]
    v = _numpy_tree(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(1), *xs, True)), seed)
    _, mut = jmod.apply(v, *xs, True, mutable=["batch_stats"])
    return {"params": v["params"], "batch_stats": mut["batch_stats"]}


def _operands(b, h, w, cin, e, seed, shift=0.1):
    """x, w1, b1, wd, bd, bn1, bn2 as numpy float32; `shift` scales BN1's
    shift (a large one makes the activated padding ring non-zero)."""
    rs = np.random.RandomState(seed)

    def rn(*shape, s=1.0):
        return (rs.standard_normal(shape) * s).astype(np.float32)

    return (rn(b, h, w, cin), rn(cin, e, s=0.3), rn(e, s=0.1), rn(3, 3, e, s=0.3), rn(e, s=0.1),
            (1 + rn(e, s=0.1), shift + rn(e, s=0.1)), (1 + rn(e, s=0.1), rn(e, s=0.1)))


def _xla_formula(x, w1, b1, wd, bd, bn1, bn2):
    """JAX's XLA formula of tests/test_expand_dw.py:32-42."""
    b, h, w, cin = x.shape
    e = w1.shape[1]
    y = (x.reshape(-1, cin) @ w1 + b1).reshape(b, h, w, e)
    y = jax.nn.leaky_relu(y * bn1[0] + bn1[1], 0.01)
    out = jax.lax.conv_general_dilated(
        y, wd.reshape(3, 3, 1, e), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=e) + bd
    return jax.nn.leaky_relu(out * bn2[0] + bn2[1], 0.01)


def _torch(ops, dtype=torch.float32):
    return [tuple(torch.from_numpy(t).to(dtype) for t in o) if isinstance(o, tuple)
            else torch.from_numpy(o).to(dtype) for o in ops]


def _jax(ops):
    return [tuple(map(jnp.asarray, o)) if isinstance(o, tuple) else jnp.asarray(o) for o in ops]


@pytest.mark.parametrize("shift", [0.1, 2.0])
def test_plain_matches_the_interpret_mode_kernel(shift):
    ops = _operands(2, 12, 16, 8, 128, seed=0, shift=shift)
    want = np.asarray(expand_dw_nhwc(*_jax(ops), interpret=True))
    got = ED.expand_dw_plain(*_torch(ops)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shift", [0.1, 2.0])
def test_plain_bf16_matches_the_interpret_mode_kernel(shift):
    """bf16: the plain version's rounding points (the kernel's: w1 and wd in
    bf16, the expand's product and u rounded to bf16, the taps summed in
    fp32, y = bf16(lrelu(acc*s2 + t2))) against JAX's interpret-mode kernel
    and against float64 from the same bf16 operands. JAX's kernel does BN1,
    the nine taps and BN2 as bf16 operations (the taps' sum rounded at every
    add), so it sits further from float64 than the port: within the port's
    bf16 bar of 1e-2 of the output's scale at BN1 shift 0.1 (measured 7.6e-3,
    the port 2.6e-3), outside it at shift 2.0 (1.24e-2, the port 3.4e-3).
    So: the port within 1e-2 of float64 at both shifts and of JAX's kernel
    at shift 0.1; at shift 2.0 at least as close to float64 as JAX's kernel,
    and within 2e-2 of JAX's kernel (measured 1.52e-2: the 1e-2 bar against
    JAX is not met there, for JAX's bf16 tap sum)."""
    ops = list(_operands(2, 8, 12, 16, 64, seed=3, shift=shift))
    ops[0] = np.asarray(jnp.asarray(ops[0]).astype(jnp.bfloat16).astype(jnp.float32))
    jops = _jax(ops)
    jops[0] = jops[0].astype(jnp.bfloat16)
    want = np.asarray(expand_dw_nhwc(*jops, interpret=True).astype(jnp.float32))
    got = ED.expand_dw(*_torch(ops, torch.bfloat16)[:1], *_torch(ops)[1:])
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    f64 = _torch(ops, torch.float64)
    f64[1], f64[3] = (t.to(torch.bfloat16).double() for t in (f64[1], f64[3]))
    exact = ED.expand_dw_plain(*f64).numpy()
    scale = np.abs(exact).max()
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-2 * scale)
    if shift < 1:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * scale)
    else:
        assert np.abs(got - exact).max() <= np.abs(want - exact).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * scale)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_expand_dw_plans_fit_shared_memory(itemsize):
    """The plan the wrapper picks for every cin up to 1024 fits the CTA's
    shared memory in fp32 and bf16; the staged plan fits at any cin, and
    cnv72's cin 128 keeps its halo resident."""
    from accunet_tpu_torch.ops.kernels import _build

    for cin in range(1, 1025):
        assert ED.smem_bytes(ED.pick_plan(cin, itemsize), cin, itemsize) <= _build.MAX_SMEM
        assert ED.smem_bytes(2, cin, itemsize) <= _build.MAX_SMEM
    assert ED.PLANS[ED.pick_plan(128, itemsize)] == "resident"


@pytest.mark.parametrize("shift", [0.1, 2.0])
@pytest.mark.parametrize("b,h,w,cin,e", [(1, 7, 9, 5, 72), (2, 1, 1, 3, 4), (1, 2, 13, 1, 9)])
def test_plain_matches_xla_at_a_ragged_shape(b, h, w, cin, e, shift):
    """(1, 7, 9), cin 5, E 72: no dimension a multiple of any tile; a 1x1
    map, where every tap but the centre reads padding; a 2-row map with one
    input channel. With the large shift lrelu(t1) ~ 2, so every border
    pixel would be off by lrelu(t1)*w_tap if the padding were applied
    before the activation."""
    ops = _operands(b, h, w, cin, e, seed=1, shift=shift)
    want = np.asarray(_xla_formula(*_jax(ops)))
    got = ED.expand_dw_plain(*_torch(ops)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if shift > 1:  # the ring matters: padding the pre-activation map differs
        x, w1, b1, wd, bd, bn1, bn2 = _torch(ops)
        u = torch.nn.functional.leaky_relu(
            torch.nn.functional.pad(x @ w1 + b1, (0, 0, 1, 1, 1, 1)) * bn1[0] + bn1[1], 0.01)
        wrong = sum(u[:, i:i + h, j:j + w] * wd[i, j] for i in range(3) for j in range(3))
        wrong = torch.nn.functional.leaky_relu((wrong + bd) * bn2[0] + bn2[1], 0.01)
        assert np.abs(wrong.numpy() - want).max() > 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_on_cpu_folds_the_biases(dtype):
    ops = _torch(_operands(2, 5, 6, 7, 20, seed=2, shift=1.0), dtype)
    before = ED.expand_dw.launches
    got = ED.expand_dw(*ops)
    assert ED.expand_dw.launches == before  # a CPU tensor launches nothing
    assert got.dtype == dtype
    want = ED.expand_dw_plain(*ops)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def test_hybrid_block_matches_jax():
    """n_filts 8, out 12, k 3, inv_fctr 16 (E = 128), x (2, 16, 16, 8): the
    block of tests/test_expand_dw.py:69-84."""
    x = np.random.RandomState(3).standard_normal((2, 16, 16, 8)).astype(np.float32)
    jmod = J.HANCBlock(8, 12, k=3, inv_fctr=16, fuse="force")
    variables = _jax_variables(jmod, [x])
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), False))
    port = T.HANCBlock(8, 12, 3, 16, hybrid=True, hybrid_e_min=0)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    port.eval()
    assert port.takes_hybrid()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.fixture
def plain_calls(monkeypatch):
    """The E of every call of expand_dw_plain, in order."""
    calls = []
    plain = ED.expand_dw_plain

    def counted(x, w1, *args):
        calls.append(w1.shape[1])
        return plain(x, w1, *args)

    monkeypatch.setattr(ED, "expand_dw_plain", counted)
    return calls


def test_gate_of_a_block(plain_calls):
    x = torch.randn(1, 8, 8, 8, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        T.HANCBlock(8, 8, 3, 16, hybrid=True, hybrid_e_min=0).train()(x)  # train mode
        T.HANCBlock(8, 8, 3, 16, hybrid=True, hybrid_e_min=129).eval()(x)  # E 128 < 129
        T.HANCBlock(8, 8, 3, 16, fused=True, hybrid=True, hybrid_e_min=0).eval()(x)  # fused
        T.HANCBlock(8, 8, 3, 16, hybrid=False, hybrid_e_min=0).eval()(x)  # off
        assert plain_calls == []
        T.HANCBlock(8, 8, 3, 16, hybrid=True, hybrid_e_min=128).eval()(x)
    assert plain_calls == [128]


def test_hybrid_block_applies_a_pending_se_first(plain_calls):
    """A chained producer's PendingSE is applied before the hybrid front
    half, as on the unfused path: the same result as the applied map."""
    g = torch.Generator().manual_seed(6)
    pending = T.PendingSE(torch.randn(1, 8, 8, 8, generator=g), torch.rand(1, 8, generator=g),
                          0.1 * torch.randn(8, generator=g))
    block = T.HANCBlock(8, 8, 3, 16, hybrid=True, hybrid_e_min=0).eval()
    with torch.no_grad():
        got, want = block(pending), block(pending.apply())
    assert plain_calls == [128, 128]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_hybrid_keeps_the_parameter_tree():
    """The switch adds no parameter or buffer: the same state_dict keys and
    shapes with the hybrid on and off, so checkpoints load either way."""
    def tree(**kw):
        return {k: tuple(v.shape) for k, v in ACCUNet(3, 3, 8, variant="w", **kw)
                .state_dict().items()}

    assert tree(hybrid_expand_dw=True, hybrid_e_min=96) == tree()


def test_eval_cli_multiclass_with_the_hybrid_on_cpu(tmp_path, plain_calls):
    """The eval CLI, ACC_UNet_W with 3 classes and the hybrid at every
    unfused block with E >= 96 (9 at n_filts=8), 3 images in 2 batches on
    the CPU: (n+1)-way argmax metrics in [0, 1], (32, 32, 4) dumps."""
    import csv
    import os

    from accunet_tpu_torch.cli import eval as cli

    rs = np.random.RandomState(7)
    for sub in ("images", "masks"):
        os.makedirs(tmp_path / "data" / sub)
    for i in range(3):
        np.save(tmp_path / "data" / "images" / f"img{i}.npy", rs.rand(4, 32, 32).astype(np.float32))
        np.save(tmp_path / "data" / "masks" / f"img{i}.npy",
                rs.randint(0, 4, (32, 32)).astype(np.float32))
    res = cli.main([
        "--model", "ACC_UNet_W", "--n-classes", "3", "--test-dir", str(tmp_path / "data"),
        "--img-size", "32", "--batch", "2", "--device", "cpu", "--csv", str(tmp_path / "m.csv"),
        "--result", str(tmp_path / "r.txt"), "--dump-dir", str(tmp_path / "dump"),
        "--model-kwargs", "{'n_filts': 8, 'hybrid_expand_dw': True, 'hybrid_e_min': 96}",
    ])
    assert res.n_images == 3 and len(plain_calls) == 2 * 9
    with open(tmp_path / "m.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 3
    assert all(0.0 <= float(r[k]) <= 1.0 for r in rows for k in ("dice", "iou", "accuracy"))
    for i in range(3):
        out = np.load(tmp_path / "dump" / f"img{i}.npz")["output"]
        assert out.shape == (32, 32, 4) and np.isfinite(out).all()


@pytest.mark.parametrize("e_min", [2048, 96])
def test_gate_in_the_model(plain_calls, e_min):
    """ACCUNet(n_filts=32, hybrid_expand_dw=True), one 32x32 b1 forward:
    cnv72 alone at the default hybrid_e_min; every unfused block with
    E >= 96 at 96 (cnv31 to cnv72; the stem cnv11 has E = 9)."""
    model = ACCUNet(3, 1, 32, hybrid_expand_dw=True, hybrid_e_min=e_min).eval()
    blocks = {n: m for n, m in model.named_modules() if isinstance(m, T.HANCBlock)}
    taking = [n for n, m in blocks.items() if m.takes_hybrid()]
    if e_min == 2048:
        assert taking == ["cnv72"]
    else:
        assert taking == ["cnv31", "cnv32", "cnv41", "cnv42", "cnv51", "cnv52",
                          "cnv61", "cnv62", "cnv71", "cnv72"]
        assert all(m.fused or m.conv2.weight.shape[0] < 96
                   for n, m in blocks.items() if n not in taking)
    with torch.no_grad():
        out = model(torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(5)))
    assert out.shape == (1, 32, 32, 1) and bool(out.isfinite().all())
    # forward order: encoder cnv31..cnv52, then the decoder cnv61..cnv72
    assert plain_calls == [blocks[n].conv2.weight.shape[0] for n in taking]
    assert ACCUNet(3, 1, 8).cnv72.hybrid is False  # off by default, as in JAX
