"""The port's training engine and train CLI, on CPU.

One whole train step of ACC_UNet (n_filts=8, 32x32, batch 2, weighted
Dice+BCE, Adam) from the same weights and batch as the JAX package's
`make_train_fns(...).train_step`: the loss, every parameter's gradient
(JAX's Adam first moment after one step is 0.1 * grad), the parameters after
the Adam step and the BN running statistics.

The step is compared in float64 on both sides. In float32 the train-mode
step is ill-conditioned: the port's own float32 and float64 gradients differ
by 4-17% of the largest gradient (`python tools/train_step_conditioning.py`),
so a float32 comparison could not tell a fault from rounding. The losses
cast to float32 on both sides, as in the JAX package, and the JAX results
reach the test through `state_dict_from_jax`, which returns float32: both
roundings sit far inside the tolerances. Tolerances: loss 1e-5
relative; each gradient 1e-4 of its tensor's largest magnitude (plus 1e-10
of the model's largest gradient, for gradients that are zero in exact
arithmetic, such as a conv bias in front of a train-mode BN); BN statistics
1e-7; parameters after the step 1e-7 where the gradient is resolved
(|g| >= 1e-6 and >= 1e-3 of its tensor's largest). Adam's first update is
lr*g/(|g|+1e-8), whose error is lr*(1e-8/|g|)*(relative error of g): small
where g is resolved, up to 2*lr where g is rounding noise, so elsewhere the
two updates are only held to their common bound, |update| <= lr.

Also: checkpoint listing, pruning, round trip and resume semantics (the
cases of tests/test_resume_semantics.py and tests/test_engine.py), the
non-finite-loss abort, and the train CLI on the CPU and its refusal of cuda
without a card."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accunet_tpu.models.acc_unet import ACCUNet as JaxACCUNet
from accunet_tpu.port import import_torch_state
from accunet_tpu.train import engine as JE
from accunet_tpu_torch.models import ACCUNet, init_parameters
from accunet_tpu_torch.port import state_dict_from_jax
from accunet_tpu_torch.train import engine as TE

# The step's XLA program is large (~71k StableHLO ops), and XLA:CPU expands
# each float64 depthwise conv into a dense conv with a block-diagonal kernel
# (cnv72: 1088 x 1088 x 3 x 3), which alone runs ~90 s unoptimised. Keeping
# the grouped convs and skipping the slow codegen paths takes the compile and
# the run from ~150 s to ~45 s on one core (the comparisons below would catch
# a miscompile).
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
                "xla_cpu_use_fusion_emitters": False, "xla_cpu_use_xnnpack": False,
                "xla_cpu_parallel_codegen_split_count": 1,
                "xla_disable_hlo_passes": "convolution-group-converter"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs tiny tensors: torch's intra-op threads would only
    contend with the other test workers for the cores (under pytest-xdist a
    small train step ran ~100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Preset:
    """A flax module whose `init` returns the given variables, so that
    make_train_fns starts from the port's weights."""

    def __init__(self, module, variables):
        self.module, self.variables = module, variables

    def init(self, *args, **kwargs):
        return self.variables

    def apply(self, *args, **kwargs):
        return self.module.apply(*args, **kwargs)


@pytest.fixture(scope="module")
def one_step():
    rs = np.random.RandomState(0)
    x = rs.rand(2, 32, 32, 3)
    mask = (rs.rand(2, 32, 32, 1) > 0.5).astype(np.float64)
    port = init_parameters(ACCUNet(3, 1, 8), torch.Generator().manual_seed(0)).double()
    before = {n: p.detach().clone() for n, p in port.named_parameters()}

    with jax.enable_x64(True):
        jmod = JaxACCUNet(3, 1, 8, s2d_levels=0, dtype=jnp.float64)
        template = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   import_torch_state(template, port.state_dict(), strict=True))
        batch = {"image": jnp.asarray(x), "mask": jnp.asarray(mask)}
        fns = JE.make_train_fns(_Preset(jmod, v), batch, donate=False)
        step = fns.train_step.lower(fns.state, batch).compile(compiler_options=FAST_COMPILE)
        state, stats = step(fns.state, batch)
        want = {
            "stats": {k: float(s) for k, s in stats.items()},
            "grads": state_dict_from_jax({"params": jax.tree_util.tree_map(
                lambda m: np.asarray(m) / 0.1, state.opt_state[0].mu)}),
            "after": state_dict_from_jax({"params": state.params,
                                          "batch_stats": state.batch_stats}),
        }

    fns_t = TE.make_train_fns(port)
    _, got_stats = fns_t.train_step(fns_t.state, {"image": torch.from_numpy(x),
                                                  "mask": torch.from_numpy(mask)})
    got = {"stats": {k: float(s) for k, s in got_stats.items()},
           "grads": {n: p.grad for n, p in port.named_parameters()},
           "after": port.state_dict(), "before": before}
    return got, want


def _t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def test_train_step_loss_and_stats_match_jax(one_step):
    got, want = one_step
    assert got["stats"]["loss"] == pytest.approx(want["stats"]["loss"], rel=1e-5)
    for k in ("dice", "iou", "lr"):
        assert got["stats"][k] == pytest.approx(want["stats"][k], rel=1e-6), k


def test_train_step_gradients_match_jax(one_step):
    got, want = one_step
    assert set(got["grads"]) == set(want["grads"])
    floor = 1e-10 * max(float(g.abs().max()) for g in got["grads"].values())
    for name, g in got["grads"].items():
        w = _t64(want["grads"][name])
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()) + floor,
                                   msg=name)


def test_train_step_params_after_adam_match_jax(one_step):
    got, want = one_step
    lr = 1e-3 * (1 + 1e-6)  # the schedule's first lr (JAX rounds it to float32)
    resolved = 0
    for name, before in got["before"].items():
        after, w = got["after"][name], _t64(want["after"][name])
        g = _t64(want["grads"][name]).abs()
        sel = (g >= 1e-6) & (g >= 1e-3 * g.max())
        torch.testing.assert_close(after[sel], w[sel], rtol=1e-7, atol=1e-9, msg=name)
        rounding = 1e-7 * float(before.abs().max())
        assert float((after - before).abs().max()) <= lr + rounding, name
        assert float((w - before).abs().max()) <= lr + rounding, name
        resolved += int(sel.sum())
    assert resolved > 0.5 * sum(p.numel() for p in got["before"].values())


def test_train_step_bn_statistics_match_jax(one_step):
    got, want = one_step
    names = [n for n in want["after"] if n.endswith(("running_mean", "running_var"))]
    assert len(names) > 100
    for name in names:
        torch.testing.assert_close(got["after"][name], _t64(want["after"][name]), rtol=1e-7,
                                   atol=1e-7, msg=name)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_matches_optax(name):
    """Three steps from the same gradients, lr from the schedule at steps
    0-2 (two steps per epoch): the port's optimizer against the JAX
    engine's optax chain (engine.py:106-114)."""
    import optax

    from accunet_tpu.train.schedules import cosine_warm_restarts
    from accunet_tpu_torch.train.schedules import cosine_warm_restarts as port_schedule

    rs = np.random.RandomState(5)
    p0, grads = rs.standard_normal((4, 6)), [rs.standard_normal((4, 6)) for _ in range(3)]
    model = torch.nn.Linear(6, 4, bias=False).double()
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(p0))
    fns = TE.make_train_fns(model, optimizer_name=name, steps_per_epoch=2)
    sched = cosine_warm_restarts(1e-3, t_0=10, t_mult=1, eta_min=1e-5, steps_per_epoch=2)
    lr_of = port_schedule(1e-3, t_0=10, t_mult=1, eta_min=1e-5, steps_per_epoch=2)
    tx = optax.adam(sched) if name == "adam" else optax.chain(
        optax.add_decayed_weights(1e-4), optax.sgd(sched, momentum=0.9))
    with jax.enable_x64(True):
        p, opt = jnp.asarray(p0), tx.init(jnp.asarray(p0))
        for step, g in enumerate(grads):
            upd, opt = tx.update(jnp.asarray(g), opt, p)
            p = optax.apply_updates(p, upd)
            for group in fns.state.optimizer.param_groups:
                group["lr"] = lr_of(step)
            model.weight.grad = torch.from_numpy(g)
            fns.state.optimizer.step()
        want = np.asarray(p)
    np.testing.assert_allclose(model.weight.detach().numpy(), want, rtol=1e-6, atol=1e-9)


# ------------------------------------------------------------- checkpoints


def _touch(path):
    path.write_bytes(b"x")


def test_list_checkpoints_filters_interrupted_saves(tmp_path):
    for n in ("epoch_0002.pth.tar", "epoch_0003.pth.tar.tmp-123", "epoch_0001.pth.tar",
              "notes.txt"):
        _touch(tmp_path / n)
    got = TE.list_checkpoints(str(tmp_path))
    assert [os.path.basename(p) for p in got] == ["epoch_0001.pth.tar", "epoch_0002.pth.tar"]
    assert TE.list_checkpoints(str(tmp_path / "missing")) == []
    assert TE.list_checkpoints(None) == []


def test_prune_checkpoints_keeps_best_and_latest(tmp_path):
    for n in ("epoch_0001.pth.tar", "epoch_0002.pth.tar", "epoch_0005.pth.tar",
              "epoch_0006.pth.tar.tmp-9", "notes.txt"):
        _touch(tmp_path / n)
    TE.prune_checkpoints(str(tmp_path), {2, 5})
    assert sorted(os.listdir(tmp_path)) == ["epoch_0002.pth.tar", "epoch_0005.pth.tar",
                                            "notes.txt"]


def _small_fns():
    model = init_parameters(ACCUNet(3, 1, 8), torch.Generator().manual_seed(1))
    return TE.make_train_fns(model, learning_rate=3e-3)


def test_checkpoint_round_trip(tmp_path):
    fns = _small_fns()
    rs = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rs.rand(2, 16, 16, 3).astype(np.float32)),
             "mask": torch.from_numpy((rs.rand(2, 16, 16, 1) > 0.5).astype(np.float32))}
    state, _ = fns.train_step(fns.state, batch)
    path = TE.save_checkpoint(str(tmp_path), state, epoch=6, best_dice=0.5, best_epoch=4)
    assert os.path.basename(path) == "epoch_0006.pth.tar"
    assert os.listdir(tmp_path) == ["epoch_0006.pth.tar"]  # no temporary file left

    fresh = _small_fns()
    restored, meta = TE.restore_checkpoint(path, fresh.state)
    assert meta == {"epoch": 6, "best_dice": 0.5, "best_epoch": 4}
    assert restored.step == 1
    for (n, a), b in zip(state.model.state_dict().items(), restored.model.state_dict().values()):
        assert torch.equal(a, b), n
    # the Adam moments came back too: the next steps are the same
    s1, st1 = fns.train_step(state, batch)
    s2, st2 = fresh.train_step(restored, batch)
    assert float(st1["loss"]) == float(st2["loss"])
    for a, b in zip(s1.model.parameters(), s2.model.parameters()):
        assert torch.equal(a, b)


def test_fit_worse_resume_does_not_overwrite_best(tmp_path, monkeypatch):
    """Resumed with a high best_dice, worse epochs keep best_epoch/best_dice."""
    saves = []

    def fake_save(ckpt_dir, state, epoch, best_dice, best_epoch=None):
        saves.append((epoch, round(float(best_dice), 4), best_epoch))
        _touch(tmp_path / f"epoch_{epoch:04d}.pth.tar")

    monkeypatch.setattr(TE, "save_checkpoint", fake_save)
    dices = iter([0.3, 0.2])

    def run_epoch_stub(step_fn, state, loader, train, **kw):
        return state, {"loss": 0.5, "dice": 0.5 if train else next(dices)}

    monkeypatch.setattr(TE, "run_epoch", run_epoch_stub)
    fns = TE.TrainStepFns(lambda s, b: (s, {}), lambda s, b: {}, lambda s, b: None, None)
    _, history = TE.fit(fns, lambda: [1], lambda: [1], epochs=7, ckpt_dir=str(tmp_path),
                        start_epoch=5, best_dice=0.9, best_epoch=4)
    assert [h["epoch"] for h in history] == [6, 7]
    assert saves == [(6, 0.9, 4), (7, 0.9, 4)]


def test_check_numerics_aborts_on_nan():
    def bad_step(state, batch):
        return state, {"loss": torch.tensor(float("nan"))}

    with pytest.raises(FloatingPointError, match="non-finite loss nan at batch 0"):
        TE.run_epoch(bad_step, None, [{"x": 1}], train=True, check_numerics=True)
    _, agg = TE.run_epoch(bad_step, None, [{"x": 1}, {"x": 2}], train=True)
    assert agg["batches"] == 2


# --------------------------------------------------------------------- CLI


def test_train_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a CPU-only host")
    from accunet_tpu_torch.cli import train as cli

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--synthetic", "--device", "cuda"])


def test_train_cli_runs_on_cpu_and_resumes(tmp_path, caplog):
    """Epoch 1, then a relaunch with --resume auto and a budget of 2: the
    newest file is corrupt (and an interrupted save is lying around), so the
    run resumes from epoch 1, trains epoch 2 only, and retention leaves best
    + latest."""
    from accunet_tpu_torch.cli import train as cli

    ckpt = tmp_path / "ckpt"

    def run(epochs):
        return cli.main(["--device", "cpu", "--synthetic", "--epochs", str(epochs),
                         "--batch", "2", "--img-size", "32", "--ckpt-dir", str(ckpt),
                         "--resume", "auto", "--check-numerics", "--set", "model.n_filts=8"])

    state, hist = run(1)
    assert [h["epoch"] for h in hist] == [1]
    assert hist[0]["train"]["batches"] == 4  # 8 synthetic samples, batch 2
    assert np.isfinite(hist[0]["train"]["loss"]) and 0 <= hist[0]["val"]["dice"] <= 1
    assert state.step == 4
    assert sorted(os.listdir(ckpt)) == ["epoch_0001.pth.tar"]

    (ckpt / "epoch_0002.pth.tar").write_bytes(b"not a checkpoint")
    _touch(ckpt / "epoch_0003.pth.tar.tmp-77")
    state, hist = run(2)
    assert "epoch_0002.pth.tar unrestorable" in caplog.text
    assert [h["epoch"] for h in hist] == [2]
    assert state.step == 8
    names = sorted(os.listdir(ckpt))  # best (epoch 1 or 2) + latest; the tmp file is gone
    assert names[-1] == "epoch_0002.pth.tar"
    assert set(names) <= {"epoch_0001.pth.tar", "epoch_0002.pth.tar"}
