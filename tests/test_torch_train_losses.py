"""The port's losses, in-step metrics, LR schedule, training transforms and
prefetch loader vs the JAX package, on the same seeded numpy inputs (CPU).

Losses and metrics: tolerance 1e-6 (the same fp32 formulas; reductions may
sum in another order). The schedule: 1e-6 relative (the port computes in
float64, JAX in float32). Transforms and the loader: equal outputs."""

import threading
import time

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from accunet_tpu.data import loader as JD
from accunet_tpu.data import transforms as JT
from accunet_tpu.train import losses as JL
from accunet_tpu.train import metrics as JM
from accunet_tpu.train import schedules as JS
from accunet_tpu_torch.data import loader as TD
from accunet_tpu_torch.data import transforms as TT
from accunet_tpu_torch.train import losses as TL
from accunet_tpu_torch.train import metrics as TM
from accunet_tpu_torch.train import schedules as TS

TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs tiny tensors: torch's intra-op threads would only
    contend with the other test workers for the cores (under pytest-xdist a
    small train step ran ~100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(kind):
    rs = np.random.RandomState(7)
    if kind == "binary":
        # ACC-UNet's head gives sigmoid probabilities; the losses take them as logits
        pred = rs.rand(3, 16, 12, 1).astype(np.float32)
        return pred, (rs.rand(3, 16, 12, 1) > 0.6).astype(np.float32)
    if kind == "logits":
        return rs.standard_normal((3, 16, 12, 1)).astype(np.float32), \
            (rs.rand(3, 16, 12, 1) > 0.6).astype(np.float32)
    if kind == "labels255":  # a mask stored as 0/255
        return rs.standard_normal((2, 8, 8, 1)).astype(np.float32), \
            255.0 * (rs.rand(2, 8, 8, 1) > 0.5).astype(np.float32)
    # (n_classes + 1)-way head, integer labels with a trailing channel
    return rs.standard_normal((3, 16, 12, 4)).astype(np.float32), \
        rs.randint(0, 4, (3, 16, 12, 1)).astype(np.float32)


CASES = [
    ("weighted_bce", "binary"), ("weighted_bce", "labels255"), ("weighted_dice", "binary"),
    ("weighted_dice_bce", "binary"), ("weighted_dice_bce", "logits"),
    ("soft_dice_show", "logits"), ("binary_dice_bce", "logits"),
    ("binary_dice_show", "logits"), ("multiclass_dice_ce", "multi"),
    ("multiclass_dice_show", "multi"),
]


@pytest.mark.parametrize("name,kind", CASES)
def test_loss_matches_jax(name, kind):
    pred, target = _inputs(kind)
    want = float(getattr(JL, name)(jnp.asarray(pred), jnp.asarray(target)))
    got = float(getattr(TL, name)(torch.from_numpy(pred), torch.from_numpy(target)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["weighted_dice_bce", "binary_dice_bce", "multiclass_dice_ce"])
def test_loss_gradient_matches_jax(name):
    import jax

    pred, target = _inputs("multi" if name.startswith("multiclass") else "logits")
    want = np.asarray(jax.grad(lambda p: getattr(JL, name)(p, jnp.asarray(target)))(jnp.asarray(pred)))
    p = torch.from_numpy(pred).requires_grad_(True)
    getattr(TL, name)(p, torch.from_numpy(target)).backward()
    np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-6 * np.abs(want).max(), rtol=1e-6)


def test_losses_map_holds_the_ported_entries():
    assert set(TL.LOSSES) == {"weighted_dice_bce", "binary_dice_bce", "multiclass_dice_ce"}
    assert set(TL.LOSSES) <= set(JL.LOSSES)


@pytest.mark.parametrize("name,kind", [("batch_iou", "logits"), ("multiclass_batch_iou", "multi")])
def test_metric_matches_jax(name, kind):
    pred, target = _inputs(kind)
    want = float(getattr(JM, name)(jnp.asarray(pred), jnp.asarray(target)))
    got = float(getattr(TM, name)(torch.from_numpy(pred), torch.from_numpy(target)))
    np.testing.assert_allclose(got, want, **TOL)


def test_batch_iou_of_empty_masks_is_one():
    z = np.full((2, 4, 4, 1), -5.0, np.float32)  # predicts nothing
    t = np.zeros((2, 4, 4, 1), np.float32)
    assert float(TM.batch_iou(torch.from_numpy(z), torch.from_numpy(t))) == 1.0
    assert float(JM.batch_iou(jnp.asarray(z), jnp.asarray(t))) == 1.0


@pytest.mark.parametrize("t_mult,steps_per_epoch", [(1, 2), (2, 1)])
def test_cosine_warm_restarts_matches_jax(t_mult, steps_per_epoch):
    """25 steps: through the restart at epoch 10 (t_mult 1, two steps per
    epoch) and through the doubled cycles at epochs 3 and 9 (t_0 = 3)."""
    t_0 = 10 if t_mult == 1 else 3
    want_fn = JS.cosine_warm_restarts(1e-3, t_0=t_0, t_mult=t_mult, eta_min=1e-5,
                                      steps_per_epoch=steps_per_epoch)
    got_fn = TS.cosine_warm_restarts(1e-3, t_0=t_0, t_mult=t_mult, eta_min=1e-5,
                                     steps_per_epoch=steps_per_epoch)
    got = np.array([got_fn(s) for s in range(25)])
    want = np.array([float(want_fn(s)) for s in range(25)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == pytest.approx(1e-3)


def _sample(rs, c=3):
    image = rs.rand(20, 20, c).astype(np.float32)
    label = (rs.rand(20, 20) > 0.5).astype(np.float32)
    return {"image": image, "label": label}


@pytest.mark.parametrize("seed", range(6))
def test_random_generator_matches_jax(seed):
    """Same sample, same Generator seed: the same branch (rot/flip, rotate or
    neither), the same zoom, the same arrays."""
    s = _sample(np.random.RandomState(seed), c=3 if seed % 2 else 1)
    if seed % 2 == 0:
        s["image"] = s["image"][..., 0]
    want = JT.RandomGenerator((16, 16))(dict(s), np.random.default_rng((5, seed)))
    got = TT.RandomGenerator((16, 16))(dict(s), np.random.default_rng((5, seed)))
    for key in ("image", "label"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


class _Fake:
    def __init__(self):
        self.epoch = 0

    def __len__(self):
        return 5

    def set_epoch(self, e):
        self.epoch = e

    def __iter__(self):
        for i in range(5):
            yield {"i": i, "epoch": self.epoch}


def test_prefetch_loader_matches_jax_order_and_errors():
    got_pf, want_pf = TD.PrefetchLoader(_Fake()), JD.PrefetchLoader(_Fake())
    for pf in (got_pf, want_pf):
        pf.set_epoch(3)
    assert list(got_pf) == list(want_pf) == [{"i": i, "epoch": 3} for i in range(5)]
    assert len(got_pf) == 5
    assert [b["i"] for b in got_pf] == [0, 1, 2, 3, 4]  # a second pass re-iterates

    class Boom:
        def __len__(self):
            return 1

        def __iter__(self):
            yield {"i": 0}
            raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        list(TD.PrefetchLoader(Boom()))


def test_prefetch_loader_abandoned_consumer_releases_worker():
    class Endless:
        def __len__(self):
            return 10 ** 6

        def __iter__(self):
            i = 0
            while True:
                yield {"i": i}
                i += 1

    before = threading.active_count()
    it = iter(TD.PrefetchLoader(Endless(), depth=2))
    assert next(it)["i"] == 0
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "prefetch worker leaked"
