"""SegMamba models through the port's eval CLI, and the reference's SegMamba
checkpoints (3-D convs on a depth-1 volume) into the port, on the CPU.

  * the eval CLI builds SegMamba names with in_chans / out_chans and scores
    a deep-supervision model on its main output (Segmamba,
    Segmamba_hybrid_gsc, Segmamba_hybrid_gsc_KAN_PE_ds); a TEXT_MODELS name
    meets the prompts of --test-dir's prompt file, and no text without one;
  * a reference-format .pth.tar written from a port Segmamba_hybrid_gsc,
    each 2-D kernel (conv and transposed conv) a depth-3 kernel with random
    off-centre taps or a depth-1 one, under DataParallel's 'module.'
    prefixes: `reference_state_dict` gives the source model's parameters
    exactly, so its output; JAX's `import_torch_state` reads the same file
    into the JAX model, whose output the port matches (1e-5 of the largest
    magnitude); the eval CLI's dumps and the gradcam CLI with --torch-ckpt;
  * the loader refuses another shape mismatch and a missing entry, naming
    the key, and ignores an entry the model lacks with a log line.
"""

import logging
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from accunet_tpu.models import segmamba as JS
from accunet_tpu.port import import_torch_state, load_torch_checkpoint
from accunet_tpu_torch.data.dataset import SegmentationDataset
from accunet_tpu_torch.models import build, init_parameters
from accunet_tpu_torch.models import segmamba as TS
from accunet_tpu_torch.port import load_reference_checkpoint, reference_state_dict
from tests.test_torch_spatial_mamba import SIZE, TOL, _rel
from tests.test_torch_unext import _one_torch_thread, _variables, jax_run  # noqa: F401

HW = 32
KWARGS = repr(SIZE)
GSC = "Segmamba_hybrid_gsc"


def _folder(root, n=3, prompts=False):
    rs = np.random.default_rng(0)
    for sub in ("images", "masks"):
        os.makedirs(root / sub)
    for i in range(n):
        np.save(root / "images" / f"s{i}.npy", rs.random((4, HW, HW), dtype=np.float32))
        np.save(root / "masks" / f"s{i}.npy", (rs.random((HW, HW)) > 0.5).astype(np.float32))
    if prompts:
        lines = ["Filename,Text"] + [f"s{i}.npy,lesion {i}" for i in range(n)]
        (root / "prompts.csv").write_text("\n".join(lines) + "\n")
    return root


def _eval(data, model, tmp_path, *extra):
    from accunet_tpu_torch.cli import eval as cli

    return cli.main(["--model", model, "--test-dir", str(data), "--img-size", str(HW),
                     "--batch", "2", "--device", "cpu", "--model-kwargs", KWARGS,
                     "--csv", str(tmp_path / "m.csv"), "--result", str(tmp_path / "r"), *extra])


@pytest.mark.parametrize("name", ["Segmamba", GSC, "Segmamba_hybrid_gsc_KAN_PE_ds"])
def test_eval_cli_evaluates_segmamba_names(tmp_path, name):
    res = _eval(_folder(tmp_path / "data"), name, tmp_path, "--dump-dir", str(tmp_path / "d"))
    assert res.n_images == 3 and 0.0 <= res.dice <= 1.0
    for i in range(3):
        out = np.load(tmp_path / "d" / f"s{i}.npz")["output"]
        assert out.shape == (HW, HW, 1) and np.isfinite(out).all()


@pytest.mark.filterwarnings("ignore:ClinicalTextEncoder")
def test_eval_cli_gives_a_text_model_the_prompts(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)  # the stub encoder, quickly
    seen = []
    forward = TS.SegMamba.forward

    def recording(self, x, text_tokens=None):
        seen.append(None if text_tokens is None else tuple(text_tokens.shape))
        return forward(self, x, text_tokens)

    monkeypatch.setattr(TS.SegMamba, "forward", recording)
    name = "Segmamba_hybrid_gsc_KAN_PE_ds_text"
    _eval(_folder(tmp_path / "text", prompts=True), name, tmp_path)
    assert seen == [(2, 16, 768)] * 2  # 3 images in 2 batches
    seen.clear()
    _eval(_folder(tmp_path / "image_only"), name, tmp_path)
    assert seen == [None] * 2


@pytest.fixture(scope="module")
def reference_file(tmp_path_factory):
    """(path, source port model, input channels, data folder): a reference-format
    .pth.tar of a seeded port Segmamba_hybrid_gsc whose 4-D kernels are
    written as 3-D ones (every third of depth 1, the others of depth 3 with
    random off-centre taps)."""
    root = tmp_path_factory.mktemp("ckpt")
    data = _folder(root / "data")
    n_ch = SegmentationDataset(str(data), HW)[0][0]["image"].shape[-1]
    src = init_parameters(build(GSC, in_chans=n_ch, out_chans=1, **SIZE),
                          torch.Generator().manual_seed(3)).eval()
    rs = np.random.RandomState(4)
    state, n3d = {}, 0
    for key, v in src.state_dict().items():
        if v.ndim == 4:
            v = v[:, :, None]
            if n3d % 3:
                off = torch.from_numpy(rs.standard_normal(v.shape).astype(np.float32))
                v = torch.cat([off, v, off.flip(0)], dim=2)
            n3d += 1
        state[f"module.{key}"] = v
    assert n3d > 10
    path = root / "best_model-Segmamba_hybrid_gsc.pth.tar"
    torch.save({"epoch": 7, "state_dict": state, "val_dice": 0.5}, str(path))
    return path, src, n_ch, data


def test_reference_checkpoint_gives_the_source_model(reference_file):
    path, src, n_ch, _ = reference_file
    port = init_parameters(build(GSC, in_chans=n_ch, out_chans=1, **SIZE),
                           torch.Generator().manual_seed(9)).eval()
    port.load_state_dict(reference_state_dict(str(path), port), strict=True)
    for key, v in src.state_dict().items():
        assert torch.equal(port.state_dict()[key], v), key
    x = torch.from_numpy(np.random.RandomState(5).rand(2, HW, HW, n_ch).astype(np.float32))
    with torch.no_grad():
        got = port(x)
        torch.testing.assert_close(got, src(x), rtol=0, atol=0)

    jmod = JS.build_segmamba(GSC, in_chans=n_ch, out_chans=1, **SIZE)
    v = import_torch_state(_variables(jmod, x.numpy()), load_torch_checkpoint(str(path)),
                           strict=True)
    want = jax_run(lambda vv, xx: jmod.apply(vv, xx), v, jnp.asarray(x.numpy()))
    assert _rel(got.numpy(), want) <= TOL


def test_eval_and_gradcam_clis_load_the_reference_file(reference_file, tmp_path):
    from accunet_tpu_torch.cli import gradcam

    path, src, _, data = reference_file
    res = _eval(data, GSC, tmp_path, "--torch-ckpt", str(path), "--dump-dir",
                str(tmp_path / "d"))
    assert res.n_images == 3
    dumps = [np.load(tmp_path / "d" / f"s{i}.npz") for i in range(3)]
    with torch.no_grad():
        want = src(torch.from_numpy(np.stack([d["input"] for d in dumps]))).numpy()
    assert _rel(np.stack([d["output"] for d in dumps]), want) <= TOL
    n = gradcam.main(["--model", GSC, "--test-dir", str(data), "--img-size", str(HW),
                      "--batch", "2", "--torch-ckpt", str(path), "--model-kwargs", KWARGS,
                      "--layer", "decoder1", "--out-dir", str(tmp_path / "cam"),
                      "--device", "cpu"])
    assert n == 3
    cam = np.load(tmp_path / "cam" / "s0_cam.npz")["cam"]
    assert cam.shape == (HW, HW) and np.isfinite(cam).all()


def test_reference_loader_refusals(reference_file, tmp_path, caplog):
    path, src, n_ch, _ = reference_file
    state = torch.load(str(path), weights_only=True)["state_dict"]
    key = next(k for k, v in state.items() if v.ndim == 5).removeprefix("module.")

    def write(sd):
        p = tmp_path / "x.pth.tar"
        torch.save({"state_dict": sd}, str(p))
        return str(p)

    model = build(GSC, in_chans=n_ch, out_chans=1, **SIZE)
    wrong = dict(state)
    wrong[f"module.{key}"] = wrong[f"module.{key}"][:, :, :, :1]  # kh cut to 1
    with pytest.raises(ValueError, match=key):
        load_reference_checkpoint(model, write(wrong))
    short = {k: v for k, v in state.items() if k != f"module.{key}"}
    with pytest.raises(KeyError, match=key):
        load_reference_checkpoint(model, write(short))
    extra = {**state, "module.vssblock.weight": torch.zeros(3)}
    with caplog.at_level(logging.INFO):
        load_reference_checkpoint(model, write(extra))
    assert "ignored 1 checkpoint entries" in caplog.text
