"""The port's Seg-Grad-CAM vs the JAX package's, on the CPU.

  * `seg_grad_cam` on ACC_UNet (n_filts 8, 32x32, one class, logits) at the
    output of cnv81, a fused block that hands its SE on to cnv82: the CAM
    against JAX's `seg_grad_cam` in one jit (1e-4 on the [0, 1] maps; the
    same fp32 formulas, measured 1.6e-6). The port's gradient passes back
    through cnv82, cnv91 and cnv92 in their fused eval form, on the CPU the
    VJPs of the kernels' plain versions (`HancBlockFn`, with the chained
    `pre` of cnv91 -> cnv92). The JAX side compiles with XLA's default
    options (~22 s on one core): at optimisation level 0 XLA:CPU returns NaN
    for this gradient.
  * `_score`'s multi-class branches (the per-sample argmax class and a given
    class) against JAX's on fixed logits: the value and its gradient.
  * The gradcam CLI on the CPU: a checkpoint that the train engine wrote,
    the default layer (JAX's rule: the last top-level module with
    parameters by name, up9), one .npz and one overlay .png per image.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accunet_tpu.eval import gradcam as JG
from accunet_tpu.models.acc_unet import ACCUNet as JaxACCUNet
from accunet_tpu_torch.eval import gradcam as TG
from accunet_tpu_torch.models import ACCUNet
from accunet_tpu_torch.port import state_dict_from_jax
from tests.test_torch_port_model import _numpy_tree


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads would only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_seg_grad_cam_matches_jax_at_a_fused_block():
    x = np.random.RandomState(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jmod = JaxACCUNet(3, 1, 8, final_sigmoid=False)
    v = _numpy_tree(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))), 2)
    want = np.asarray(jax.jit(lambda vv, xx: JG.seg_grad_cam(jmod, vv, xx, ("cnv81",),
                                                             train=False))(v, jnp.asarray(x)))
    model = ACCUNet(3, 1, 8, final_sigmoid=False)
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    model.eval()
    assert model.cnv81.fused and model.cnv81.defer_se and model.cnv92.fused
    got = TG.seg_grad_cam(model, torch.from_numpy(x), "cnv81")
    assert got.shape == (2, 32, 32) and got.dtype == torch.float32
    assert all(p.requires_grad for p in model.parameters())  # restored
    assert float(want.max()) > 0.9  # a CAM with a range, not 1e-8 noise
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("class_idx", [None, 2])
def test_score_multiclass_matches_jax(class_idx):
    """Per-sample argmax class (the two images pick different classes) or
    the given class."""
    logits = np.random.RandomState(3).standard_normal((2, 5, 4, 4)).astype(np.float32)
    logits[0, ..., 1] += 1.0
    logits[1, ..., 3] += 1.0
    want, want_g = jax.value_and_grad(lambda a: JG._score(a, class_idx))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    got = TG._score(t, class_idx)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-9)


def test_seg_grad_cam_refuses_an_unknown_layer():
    with pytest.raises(KeyError, match="no module 'cnv99'"):
        TG.seg_grad_cam(ACCUNet(3, 1, 8), torch.zeros(1, 16, 16, 3), "cnv99")


def test_gradcam_cli_cpu(tmp_path):
    from accunet_tpu_torch.cli import gradcam as cli
    from accunet_tpu_torch.models import init_parameters
    from accunet_tpu_torch.train.engine import make_train_fns, save_checkpoint

    rs = np.random.default_rng(0)
    for sub in ("images", "masks"):
        os.makedirs(tmp_path / "data" / sub)
    for i in range(3):
        np.save(tmp_path / "data" / "images" / f"s{i}.npy", rs.random((4, 32, 32), dtype=np.float32))
        np.save(tmp_path / "data" / "masks" / f"s{i}.npy",
                (rs.random((32, 32)) > 0.5).astype(np.float32))
    fns = make_train_fns(init_parameters(ACCUNet(1, 1, 8), torch.Generator().manual_seed(5)))
    ckpt = save_checkpoint(str(tmp_path / "ck"), fns.state, 1, 0.5)
    n = cli.main(["--model", "ACC_UNet", "--test-dir", str(tmp_path / "data"), "--img-size",
                  "32", "--batch", "2", "--ckpt", ckpt, "--model-kwargs", "{'n_filts': 8}",
                  "--out-dir", str(tmp_path / "cam"), "--device", "cpu"])
    assert n == 3
    assert sorted(os.listdir(tmp_path / "cam")) == [f"s{i}_cam.{e}" for i in range(3)
                                                     for e in ("npz", "png")]
    out = np.load(tmp_path / "cam" / "s1_cam.npz")
    assert out["cam"].shape == (32, 32) and out["image"].shape == (32, 32, 1)
    assert out["mask"].shape == (32, 32, 1)
    assert np.isfinite(out["cam"]).all() and 0 <= out["cam"].min() <= out["cam"].max() <= 1
    assert cli.default_layer(ACCUNet(3, 1, 8)) == "up9"
