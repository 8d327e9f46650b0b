"""The port's parallel/ package over gloo on the CPU, against the JAX package
and against the port's own one-process step.

Two sessions of real processes (tests/torch_parallel_workers.py; each
`communicate` has its own timeout, so a hang fails instead of holding the
suite): world 2 and world 4. In each:

  * `sequence_parallel_scan` on the seq axis (2 or 4 ranks) on each rank's
    (2, 256/n, 16) shard, float32: h against JAX's serial associative scan
    within atol 1e-5 / rtol 1e-4 (tests/test_seq_parallel.py:25-46 holds
    JAX's own so), da and db against autograd through the plain serial scan
    with the same cotangent (SCAN_GRAD_TOL of the largest); and
    `shard_mapped_scan` on the whole sequence in float64, h and both
    gradients to F64_TOL.
  * world 2, seq=2: SS2D(d_model=12, d_state=4) on 8x8 and
    StructureAwareSSM(d_model=16, d_state=4) under `sequence_sharding`
    against JAX's single-device output with the same weights, within atol
    2e-5 / rtol 1e-4 (tests/test_seq_parallel.py:49-81), with every scan on
    the route (SS2D's four directions, the SSM's one).
  * ACC_UNet (n_filts 8, 32x32, global batch 4, float64), one train step on
    data=2 (world 2) and on data=2, model=2 with min_weight_size 2**10
    (world 4, as tests/test_spmd_models.py:38 shards), against the
    one-process step on the same 4 images: the loss, the gradients before
    the update, the Adam moments, every running statistic and the
    parameters after it, to STEP_TOL relative to each tensor's largest
    value, floored at GRAD_FLOOR of the largest of its kind (the same
    parameter or statistic name across the model): a gradient that is zero
    but for rounding, such as a bias before a train-mode BN (1e-14 here,
    1e-15 of the largest gradient), or the running mean of a BN that follows
    another (1e-16), has no relative error. Adam's
    first step is lr * sign(g) for all but the smallest g, so an element
    whose gradient is rounding noise may step either way: the parameters'
    comparison leaves out the elements whose one-process gradient is below
    FLOOR of the largest. The sharded
    parameters hold 1/model of their dim on each rank.
  * The masks' positive share differs between the two data slices (0.8 and
    0.2), so weighted_bce's class weights differ per slice: the mean of the
    per-slice losses departs from the global loss by far more than STEP_TOL.

In-process: MeshSpec.resolve against JAX's on a table of cases, errors
included; the divisibility fallback warns once and runs the fused path;
outside a context the route is never taken.
"""

import copy
import os
import socket
import subprocess
import sys
import types
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accunet_tpu.nn.ss2d import SS2D as JSS2D
from accunet_tpu.nn.ssm import StructureAwareSSM as JSSM
from accunet_tpu.parallel.mesh import MeshSpec as JMeshSpec
from accunet_tpu_torch.models import build, init_parameters
from accunet_tpu_torch.nn.ss2d import SS2D
from accunet_tpu_torch.ops.kernels.scan import linear_scan_plain
from accunet_tpu_torch.parallel import MeshSpec, seq_scan, sequence_sharding
from accunet_tpu_torch.port import state_dict_from_jax
from accunet_tpu_torch.train import losses as L
from accunet_tpu_torch.train.engine import make_train_fns, whole_state
from tests.test_torch_unext import _variables, _x, jax_run
from tests.test_torch_unext import _one_torch_thread  # noqa: F401
from tests.torch_parallel_workers import ACC_KW

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300  # seconds for each rank process
SCAN_GRAD_TOL = 1e-5
F64_TOL = 1e-12
STEP_TOL = 1e-8
FLOOR = 1e-9
GRAD_FLOOR = 1e-6
B, HW = 4, 32


def _rel(got, want, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor, 1e-300))


def _scan_inputs():
    rs = np.random.RandomState(0)
    a = rs.uniform(0.3, 0.99, (2, 256, 16)).astype(np.float32)
    b = rs.uniform(-0.5, 0.5, (2, 256, 16)).astype(np.float32)
    g = rs.standard_normal((2, 256, 16)).astype(np.float32)
    return a, b, g


def _acc_model():
    model = build("ACC_UNet", **ACC_KW)
    return init_parameters(model, torch.Generator().manual_seed(5)).double()


def _acc_batch():
    rs = np.random.RandomState(3)
    image = rs.rand(B, HW, HW, 3)
    # the first data slice mostly positive, the second mostly negative
    share = np.repeat([0.8, 0.2], B // 2)[:, None, None, None]
    mask = (rs.rand(B, HW, HW, 1) < share).astype(np.float64)
    return torch.from_numpy(image), torch.from_numpy(mask)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The sessions' inputs, written once; the JAX references beside them."""
    root = tmp_path_factory.mktemp("parallel")
    a, b, g = _scan_inputs()
    ss2d_x, ssm_x = _x((2, 8, 8, 12), 1), _x((1, 8, 8, 16), 2)
    refs = {}
    ins = {"a": torch.from_numpy(a), "b": torch.from_numpy(b), "g": torch.from_numpy(g),
           "ss2d_x": torch.from_numpy(ss2d_x), "ssm_x": torch.from_numpy(ssm_x)}
    for key, jmod, x in (("ss2d", JSS2D(d_model=12, d_state=4), ss2d_x),
                         ("ssm", JSSM(d_model=16, d_state=4), ssm_x)):
        v = _variables(jmod, x)
        ins[f"{key}_sd"] = state_dict_from_jax(v)
        refs[key] = jax_run(lambda vv, xx, m=jmod: m.apply(vv, xx), v, jnp.asarray(x))
    ins["acc_sd"] = _acc_model().state_dict()
    ins["image"], ins["mask"] = _acc_batch()
    torch.save(ins, root / "inputs.pt")
    return root, ins, refs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_session(session: str, world: int, root: Path) -> list[dict]:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_parallel_workers", session, str(r), str(world),
         str(port), str(root)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {session}:\n{out[-4000:]}"
    return [torch.load(root / f"out_{session}_{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def world2(inputs):
    return _run_session("world2", 2, inputs[0])


@pytest.fixture(scope="module")
def world4(inputs):
    return _run_session("world4", 4, inputs[0])


@pytest.fixture(scope="module")
def one_process_step(inputs):
    """The port's one-process step on the global batch (the reference of the
    mesh steps): loss, gradients before the update, whole state after it,
    and the mean of the per-slice losses of the same predictions."""
    _, ins, _ = inputs
    model = _acc_model()
    model.load_state_dict(ins["acc_sd"])
    with torch.no_grad():
        preds = copy.deepcopy(model).train()(ins["image"])
        half = B // 2
        per_slice = [L.weighted_dice_bce(preds[s], ins["mask"][s])
                     for s in (slice(0, half), slice(half, B))]
    fns = make_train_fns(model)
    grads, step = {}, fns.state.optimizer.step
    names = {id(p): n for n, p in model.named_parameters()}

    def recording_step(*args, **kw):
        grads.update({names[id(p)]: p.grad.clone() for p in model.parameters()
                      if p.grad is not None})
        return step(*args, **kw)

    fns.state.optimizer.step = recording_step
    _, stats = fns.train_step(fns.state, {"image": ins["image"], "mask": ins["mask"]})
    model_sd, opt_sd = whole_state(fns.state)
    return {"loss": stats["loss"], "grads": grads, "model_sd": model_sd,
            "opt_state": opt_sd["state"], "per_slice_mean": float(sum(per_slice)) / 2}


def _check_scan(outs, inputs):
    _, ins, _ = inputs
    a, b, g = (ins[k].numpy() for k in ("a", "b", "g"))

    def combine(x, y):
        return y[0] * x[0], y[0] * x[1] + y[1]

    want = jax_run(lambda x, y: jax.lax.associative_scan(combine, (x, y), axis=1)[1],
                   jnp.asarray(a), jnp.asarray(b))
    h = np.concatenate([o["scan"]["h"].numpy() for o in outs], axis=1)
    np.testing.assert_allclose(h, want, atol=1e-5, rtol=1e-4)
    for dtype, sfx, tol in ((torch.float32, "", SCAN_GRAD_TOL), (torch.float64, "64", F64_TOL)):
        ta, tb = (torch.from_numpy(t).to(dtype).requires_grad_() for t in (a, b))
        ref = linear_scan_plain(ta, tb)
        ref.backward(torch.from_numpy(g).to(dtype))
        if sfx:  # shard_mapped_scan: the whole h and gradients on every rank
            for o in outs:
                assert _rel(o["scan"]["h64"], ref.detach()) <= tol
                assert _rel(o["scan"]["da64"], ta.grad) <= tol
                assert _rel(o["scan"]["db64"], tb.grad) <= tol
        else:
            for key, want_g in (("da", ta.grad), ("db", tb.grad)):
                got = np.concatenate([o["scan"][key].numpy() for o in outs], axis=1)
                assert _rel(got, want_g) <= tol, key


def test_sequence_parallel_scan_two_ranks(world2, inputs):
    _check_scan(world2, inputs)


def test_sequence_parallel_scan_four_ranks(world4, inputs):
    _check_scan(world4, inputs)


@pytest.mark.parametrize("key,routed", [("ss2d", 4), ("ssm", 1)])
def test_ssm_under_sequence_sharding_matches_jax(world2, inputs, key, routed):
    want = inputs[2][key]
    for o in world2:
        assert o["ssm"][f"{key}_routed"] == routed
        np.testing.assert_allclose(o["ssm"][key].numpy(), want, atol=2e-5, rtol=1e-4)


def _check_step(outs, ref, tag):
    gmax = max(float(g.abs().max()) for g in ref["grads"].values())
    for o in outs:
        got = o[tag]
        assert _rel(got["loss"], ref["loss"]) <= STEP_TOL
        for name, want in ref["grads"].items():
            g = got["grads"][name]
            if name in got["shards"]:
                dim, local, full = got["shards"][name]
                assert g.shape == local and local[dim] * 2 == full[dim]
                want = want.narrow(dim, got["model_index"] * local[dim], local[dim])
            assert _rel(g, want, GRAD_FLOOR * gmax) <= STEP_TOL, name
        for i, st in ref["opt_state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                scale = gmax ** (2 if k == "exp_avg_sq" else 1)
                assert _rel(got["opt_state"][i][k], st[k], GRAD_FLOOR * scale) <= STEP_TOL, (i, k)
        kind_max = {}
        for name, want in ref["model_sd"].items():
            kind = name.rsplit(".", 1)[-1]
            kind_max[kind] = max(kind_max.get(kind, 0.0), float(want.abs().max()))
        for name, want in ref["model_sd"].items():
            have = got["model_sd"][name]
            if name in ref["grads"]:  # a parameter: leave out the noise-level gradients
                keep = ref["grads"][name].abs() >= FLOOR * gmax
                have, want = have[keep], want[keep]
            if want.numel():
                floor = GRAD_FLOOR * kind_max[name.rsplit(".", 1)[-1]]
                assert _rel(have, want, floor) <= STEP_TOL, name


def test_acc_unet_step_data2_matches_one_process(world2, one_process_step):
    _check_step(world2, one_process_step, "data2")
    assert all(not o["data2"]["shards"] for o in world2)


def test_acc_unet_step_data2_model2_matches_one_process(world4, one_process_step):
    _check_step(world4, one_process_step, "data2_model2")
    shards = world4[0]["data2_model2"]["shards"]
    assert shards and all(o["data2_model2"]["shards"] == shards for o in world4)
    assert {o["data2_model2"]["model_index"] for o in world4} == {0, 1}


def test_per_slice_loss_mean_is_not_the_global_loss(one_process_step):
    """The masks make weighted_bce's class weights differ per data slice, so
    a step that averaged per-rank losses would miss the global loss by far
    more than the steps' tolerance."""
    ref = float(one_process_step["loss"])
    assert abs(one_process_step["per_slice_mean"] - ref) > 1e3 * STEP_TOL * abs(ref)


@pytest.mark.parametrize("spec,n", [
    ({}, 8), ({"model": 2}, 8), ({"data": 2, "model": 2, "seq": 2}, 8), ({"seq": 4}, 4),
    ({"data": 1}, 1), ({"data": 3}, 8), ({"model": 3}, 8), ({"model": 16}, 8),
    ({"data": 2, "seq": 2}, 2)])
def test_mesh_spec_resolve_matches_jax(spec, n):
    def outcome(cls):
        try:
            return cls(**spec).resolve(n)
        except ValueError as e:
            return ("error", str(e))

    assert outcome(MeshSpec) == outcome(JMeshSpec)


def test_divisibility_fallback_warns_once_and_runs_fused(monkeypatch):
    """At 7x7 (L = 49) a seq axis of 2 cannot split the scans: one warning
    for SS2D's four directions, and the output is the fused path's."""
    monkeypatch.setattr(seq_scan, "_WARNED_FALLBACK", set())

    def no_route(*args, **kw):
        raise AssertionError("the sequence-parallel route ran")

    monkeypatch.setattr(seq_scan, "shard_mapped_scan", no_route)
    mod = init_parameters(SS2D(12, 4), torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x((2, 7, 7, 12), 4))
    with torch.no_grad():
        want = mod(x)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            with sequence_sharding(types.SimpleNamespace(shape={"seq": 2})):
                got = mod(x)
                got2 = mod(x)
    msgs = [str(w.message) for w in seen if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 1 and "L=49" in msgs[0] and "seq axis size 2" in msgs[0]
    assert torch.equal(got, want) and torch.equal(got2, want)
    assert seq_scan.active() is None
