"""The port's harness extras vs the JAX package, on the CPU.

  * `save_prediction_images` writes the files JAX's writes for the same
    arrays: the same PNGs pixel for pixel, or without PIL the same
    val_batch.npz.
  * `fit` logs the same TensorBoard scalars as JAX's `fit` (a stub
    tensorboardX in sys.modules records them; both fits run the same stub
    steps) and warns once when tensorboardX does not import; `vis_dir`
    saves the first validation batch's images every `vis_frequency` epochs.
  * The native data ops (C++ through ctypes, built by g++) equal the port's
    numpy path: the nearest resize and the binarisation exactly, the
    bilinear resize exactly (1e-6 allowed: both blend in float64 in the same
    order), the standardisation to 1e-12 (float64 sums in another order);
    JAX's native bilinear resize (float32 coordinates and blends) to 1e-4 of
    the image's largest value (measured 3.1e-5),
    its standardisation (float32 output) to 1e-6 and its binarisation
    exactly; JAX's native nearest resize is not cv2's (the port's is). The
    dataset gives the same masks and images within 1e-6 with
    and without them, and a failed build logs the compiler's message once
    and falls back to numpy. Skipped where g++ is absent.
  * `trace_report` on a CPU torch.profiler trace of UNext_S train steps with
    the module ranges on, and on a small synthetic CUDA trace whose kernels
    reach their modules through their launches' correlation ids.
"""

import json
import logging
import os
import shutil
import sys
import types

import numpy as np
import pytest

import torch

from accunet_tpu.eval import visualize as JV
from accunet_tpu.train import engine as JE
from accunet_tpu_torch.data import dataset as TDS
from accunet_tpu_torch.data import native_loader as NL
from accunet_tpu_torch.eval import visualize as TV
from accunet_tpu_torch.train import engine as TE
from accunet_tpu_torch.utils import trace_report as TR


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(rs, k=1):
    images = rs.standard_normal((5, 12, 10, 3)).astype(np.float32)
    masks = (rs.random((5, 12, 10, 1)) > 0.5).astype(np.float32)
    preds = rs.random((5, 12, 10, k)).astype(np.float32)
    return images, masks, preds


@pytest.mark.parametrize("pil,k", [(True, 1), (True, 4), (False, 1)])
def test_save_prediction_images_matches_jax(tmp_path, monkeypatch, pil, k):
    if not pil:
        monkeypatch.setitem(sys.modules, "PIL", None)  # `from PIL import Image` raises
    images, masks, preds = _batch(np.random.default_rng(k), k)
    names = ["a/isic_001.npy", "isic_002.png", "c", "d", "e"]
    for side, mod in (("jax", JV), ("port", TV)):
        out = mod.save_prediction_images(str(tmp_path / side), 7, images, masks, preds, names)
        assert out == str(tmp_path / side / "epoch_0007")
    files = sorted(os.listdir(tmp_path / "jax" / "epoch_0007"))
    assert files == sorted(os.listdir(tmp_path / "port" / "epoch_0007"))
    assert len(files) == (12 if pil else 1)
    for f in files:
        a, b = (tmp_path / s / "epoch_0007" / f for s in ("jax", "port"))
        if pil:
            from PIL import Image

            np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
        else:
            za, zb = np.load(a), np.load(b)
            assert sorted(za) == sorted(zb) == ["images", "masks", "preds"]
            for key in za:
                np.testing.assert_array_equal(za[key], zb[key])


class _Writer:
    """A stub tensorboardX.SummaryWriter recording its calls."""

    def __init__(self, log):
        self.log = log

    def __call__(self, logdir):
        self.log.append(("open", os.path.basename(logdir)))
        return self

    def add_scalar(self, tag, value, step):
        self.log.append((tag, float(value), int(step)))

    def close(self):
        self.log.append(("close",))


def _stub_steps():
    """Deterministic stats per batch: train and eval steps of both fits."""
    calls = {"train": 0, "eval": 0}

    def train_step(state, batch):
        calls["train"] += 1
        i = calls["train"]
        return state, {"loss": 1.0 / i, "dice": 0.1 * i, "iou": 0.05 * i, "lr": 1e-3}

    def eval_step(state, batch):
        calls["eval"] += 1
        i = calls["eval"]
        return {"loss": 0.5 / i, "dice": 0.2 * i, "iou": 0.3 / i}

    return train_step, eval_step


def test_fit_logs_the_same_scalars_as_jax(tmp_path, monkeypatch):
    logs = {}
    for side in ("jax", "port"):
        log = logs[side] = []
        stub = types.ModuleType("tensorboardX")
        stub.SummaryWriter = _Writer(log)
        monkeypatch.setitem(sys.modules, "tensorboardX", stub)
        train_step, eval_step = _stub_steps()
        loaders = (lambda: iter([{}] * 3), lambda: iter([{}] * 2))
        if side == "jax":
            fns = JE.TrainStepFns(train_step, eval_step, None, None)
            JE.fit(fns, *loaders, epochs=3, tensorboard_dir=str(tmp_path / "tb"))
        else:
            fns = TE.TrainStepFns(train_step, eval_step, None, None)
            TE.fit(fns, *loaders, epochs=3, tensorboard_dir=str(tmp_path / "tb"))
    # JAX sums the stats in float32, the port in Python floats
    assert [e[::2] for e in logs["port"]] == [e[::2] for e in logs["jax"]]
    for got, want in zip(logs["port"], logs["jax"]):
        if len(got) == 3:
            assert got[1] == pytest.approx(want[1], rel=1e-6), got
    assert len(logs["port"]) == 1 + 3 * 6 + 1 and logs["port"][-1] == ("close",)


def test_fit_warns_once_without_tensorboardx(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    train_step, eval_step = _stub_steps()
    fns = TE.TrainStepFns(train_step, eval_step, None, None)
    with caplog.at_level(logging.WARNING, logger="accunet_tpu_torch"):
        _, hist = TE.fit(fns, lambda: iter([{}] * 2), lambda: iter([{}]), epochs=2,
                         tensorboard_dir=str(tmp_path / "tb"))
    assert len(hist) == 2
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert [r.getMessage() for r in warnings] == ["tensorboardX unavailable; skipping TB logging"]


def test_fit_saves_prediction_images_every_vis_frequency_epochs(tmp_path):
    batch = {"image": torch.rand(3, 8, 8, 1), "mask": (torch.rand(3, 8, 8, 1) > 0.5).float()}
    preds = []

    def predict_step(state, b):
        preds.append(b)
        return torch.sigmoid(b["image"])

    train_step, eval_step = _stub_steps()
    fns = TE.TrainStepFns(train_step, eval_step, predict_step, None)
    TE.fit(fns, lambda: iter([batch]), lambda: iter([batch, batch]), epochs=4,
           vis_dir=str(tmp_path / "vis"), vis_frequency=2)
    assert sorted(os.listdir(tmp_path / "vis")) == ["epoch_0002", "epoch_0004"]
    assert len(preds) == 2
    assert sorted(os.listdir(tmp_path / "vis" / "epoch_0004")) == sorted(
        f"{kind}_sample{i}.png" for kind in ("gt", "input", "pred") for i in range(3))


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the native data ops cannot build here")

SHAPES = [((450, 600), 224), ((300, 200), 224), ((7, 9), 32), ((224, 224), 512),
          ((513, 511), 256)]


@pytest.mark.parametrize("shape,size", SHAPES)
def test_native_ops_match_the_numpy_path(shape, size, monkeypatch, gxx):
    assert NL.available()
    rs = np.random.default_rng(size)
    img = (5 * rs.random(shape)).astype(np.float32)
    mask = rs.integers(0, 4, shape).astype(np.float32)
    native = (NL.resize2d(img, size, False), NL.resize2d(mask, size, True))
    monkeypatch.setattr(NL, "available", lambda: False)
    plain = (TDS._resize_image(img, size, False), TDS._resize_image(mask, size, True))
    assert native[0].dtype == plain[0].dtype == np.float64
    np.testing.assert_allclose(native[0], plain[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(native[1], plain[1])
    x = plain[0]
    want = (x - x.mean()) / (x.std(ddof=1) + 1e-8)
    np.testing.assert_allclose(NL.standardize(x), want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(NL.binarize(mask - 1), (mask - 1 > 0).astype(np.float32))


def test_native_ops_match_jax_native_ops(tmp_path, monkeypatch, gxx):
    """JAX's native ops, built into tmp_path: bilinear and standardise in
    float32, binarise."""
    from accunet_tpu.data import native_loader as JNL

    monkeypatch.setenv("ACCUNET_NATIVE_CACHE", str(tmp_path))
    monkeypatch.setattr(JNL, "_LIB", None)
    monkeypatch.setattr(JNL, "_TRIED", False)
    assert JNL.available()
    rs = np.random.default_rng(1)
    for shape, size in SHAPES[:3]:
        img = (5 * rs.random(shape)).astype(np.float32)
        got = NL.resize2d(img, size, False)
        np.testing.assert_allclose(got, JNL.resize2d(img, size, False), rtol=0,
                                   atol=1e-4 * np.abs(img).max())
        np.testing.assert_allclose(NL.standardize(got), JNL.standardize(got.astype(np.float32)),
                                   rtol=0, atol=1e-6 * 4)
        mask = rs.integers(-1, 3, shape).astype(np.float32)
        np.testing.assert_array_equal(NL.binarize(mask), JNL.binarize(mask))


def _folder(root, n=3, hw=(40, 50)):
    rs = np.random.default_rng(2)
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        np.save(os.path.join(root, "images", f"s{i}.npy"), rs.random((4, *hw), dtype=np.float32))
        np.save(os.path.join(root, "masks", f"s{i}.npy"),
                rs.integers(0, 3, hw).astype(np.float32))
    return root


def test_dataset_native_and_numpy_paths_agree(tmp_path, monkeypatch, gxx):
    root = _folder(str(tmp_path / "d"))
    native = [TDS.SegmentationDataset(root, 32)[i][0] for i in range(3)]
    monkeypatch.setattr(NL, "available", lambda: False)
    plain = [TDS.SegmentationDataset(root, 32)[i][0] for i in range(3)]
    for a, b in zip(native, plain):
        assert a["image"].dtype == b["image"].dtype == np.float32
        np.testing.assert_allclose(a["image"], b["image"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(a["label"], b["label"])


def test_failed_native_build_warns_once_and_uses_numpy(tmp_path, monkeypatch, caplog, gxx):
    root = _folder(str(tmp_path / "d"))
    NL.library.cache_clear()
    try:
        with monkeypatch.context() as m, caplog.at_level(logging.WARNING,
                                                         logger="accunet_tpu_torch"):
            m.setattr(NL, "FLAGS", NL.FLAGS + ["-fno-such-option"])
            ds = TDS.SegmentationDataset(root, 32)
            got = [ds[i][0] for i in range(3)]
            assert not NL.available()
        warnings = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
        assert len(warnings) == 1 and "failed to build" in warnings[0]
        assert "-fno-such-option" in warnings[0]  # the compiler's message
    finally:
        NL.library.cache_clear()
    assert NL.available()
    for i, s in enumerate(got):
        np.testing.assert_allclose(s["image"], ds[i][0]["image"], rtol=0, atol=1e-6)


def test_trace_report_on_a_cpu_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from accunet_tpu_torch.models import build, init_parameters

    model = init_parameters(build("UNext_S", n_channels=3, n_classes=1),
                            torch.Generator().manual_seed(0))
    fns = TE.make_train_fns(model)
    batch = {"image": torch.randn(2, 32, 32, 3), "mask": (torch.rand(2, 32, 32, 1) > 0.5).float()}
    with TR.module_ranges(model), profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            fns.train_step(fns.state, batch)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    rows = dict(TR.module_times(str(tmp_path), steps=2))
    assert {"block1.0", "dblock2.0", "patch_embed3", "(backward)"} <= set(rows)
    assert any(k.startswith("Optimizer.step") for k in rows)
    assert rows["total"] > 0
    assert abs(sum(t for k, t in rows.items() if k != "total") - rows["total"]) < 1e-6
    ops = TR.top_ops(str(tmp_path), n=5, steps=2)
    assert len(ops) == 5 and ops[0][1] >= ops[-1][1] > 0
    # hooks removed: a forward outside the context opens no range
    assert not model.block1[0]._forward_hooks and not model.block1[0]._forward_pre_hooks


def test_trace_report_attributes_device_kernels_through_their_launches(tmp_path):
    """Kernels on the device lane reach the module range around the runtime
    call that launched them (same correlation id), on that call's thread;
    one launched inside the autograd engine's backward op goes to
    "(backward)", one outside every range to "(other)"."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "module:cnv11", "pid": 1, "tid": 7,
         "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "module:cnv12", "pid": 1, "tid": 7,
         "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "cpu_op", "name": "autograd::engine::evaluate_function: XBackward0",
         "pid": 1, "tid": 9, "ts": 200.0, "dur": 20.0},
        *[{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": tid,
           "ts": ts, "dur": 1.0, "args": {"correlation": c}}
          for c, tid, ts in ((1, 7, 10.0), (2, 7, 120.0), (3, 9, 205.0), (4, 7, 300.0))],
        *[{"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 13, "ts": ts, "dur": dur,
           "args": {"correlation": c}}
          for c, cat, name, ts, dur in ((1, "kernel", "hanc_block_kernel", 20.0, 40.0),
                                        (2, "kernel", "respath_level_kernel", 130.0, 10.0),
                                        (3, "kernel", "hanc_block_kernel", 210.0, 30.0),
                                        (4, "gpu_memcpy", "Memcpy DtoH", 310.0, 5.0))],
    ]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": ev}))
    assert TR.module_times(str(tmp_path), steps=1) == [
        ("cnv11", 0.04), ("(backward)", 0.03), ("cnv12", 0.01), ("(other)", 0.005),
        ("total", 0.085)]
    assert TR.top_ops(str(tmp_path), n=2) == [("hanc_block_kernel", 0.07, "cnv11"),
                                             ("respath_level_kernel", 0.01, "cnv12")]
