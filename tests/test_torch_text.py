"""The port's text path vs the JAX package on the CPU.

  * `read_text` equals JAX's (pandas) on a CSV of each column convention,
    with a `.jpg` name, padded cells and an empty one; an .xlsx without
    pandas raises an ImportError naming the file;
  * `FakeTextEncoder` equals JAX's in the same process (its seeds come
    from the salted `hash` of a str, so they differ between processes);
  * ClinicalTextEncoder without transformers: a RuntimeWarning and the
    stub's embeddings;
  * the train CLI with the flagship on the CPU: one tiny epoch with a
    prompt CSV in the data folders, the prompts' embeddings reaching every
    train and validation forward; then the same folders without the CSV
    train on the images alone, as JAX's rule says, and `--text` forces the
    text path without one;
  * the flagship's output depends on the prompt, and without text equals
    the same weights with text_fusion None.
"""

import builtins
import os
import sys

import numpy as np
import pytest
import torch

from accunet_tpu.data.text_prompts import read_text as j_read_text
from accunet_tpu.nn.text import FakeTextEncoder as JFake
from accunet_tpu_torch.data.text_prompts import read_text
from accunet_tpu_torch.nn.text import ClinicalTextEncoder, FakeTextEncoder
from tests.test_torch_unext import _one_torch_thread  # noqa: F401

FLAGSHIP = "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA_SpatialMamba"
SIZE = dict(depths=(1, 1, 1, 1), feat_size=(8, 16, 24, 32), hidden_size=40)


@pytest.mark.parametrize("fcol,tcol", [("Filename", "Text"), ("image_name", "prompt_text"),
                                       ("Image", "Description")])
def test_read_text_matches_jax(tmp_path, fcol, tcol):
    rows = [f"{fcol},other,{tcol}", "a.jpg,1, a lesion on the left ", "b.png,2,",
            '" c.jpg ",3,"two, words"', "", "d.bmp,4,NA"]
    (tmp_path / "prompts.csv").write_text("\n".join(rows) + "\n")
    (tmp_path / "z_ignored.csv").write_text("x,y\n1,2\n")
    got, want = read_text(str(tmp_path)), j_read_text(str(tmp_path))
    assert got == want
    assert got == {"a.png": "a lesion on the left", "b.png": "nan", "c.png": "two, words",
                   "d.bmp": "nan"}


def test_read_text_edges(tmp_path, monkeypatch):
    assert read_text(str(tmp_path)) is None
    (tmp_path / "p.csv").write_text("name,prompt\na.png,x\n")
    with pytest.raises(ValueError, match="lacks expected columns"):
        read_text(str(tmp_path))
    (tmp_path / "a.xlsx").write_bytes(b"")
    real_import = builtins.__import__

    def no_pandas(name, *args, **kw):
        if name == "pandas":
            raise ImportError("no pandas")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pandas)
    with pytest.raises(ImportError, match="a.xlsx"):
        read_text(str(tmp_path))


def test_fake_text_encoder_matches_jax():
    texts = ["a lesion", "", "a lesion", "benign nevus"]
    got, want = FakeTextEncoder()(texts), JFake()(texts)
    assert got.shape == (4, 16, 768) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], got[2])
    assert FakeTextEncoder()(None) is None


@pytest.fixture
def no_transformers(monkeypatch):
    """transformers unimportable, as on a machine without it (and quick:
    importing it takes seconds)."""
    monkeypatch.setitem(sys.modules, "transformers", None)


def test_clinical_encoder_falls_back_loudly(no_transformers):
    """Without transformers (or ClinicalBERT's weights in the local cache)
    the encoder warns and gives the stub's embeddings."""
    with pytest.warns(RuntimeWarning, match="FakeTextEncoder"):
        enc = ClinicalTextEncoder("no-such-org/no-such-model")
    np.testing.assert_array_equal(enc(["x"]), FakeTextEncoder()(["x"]))


def _folders(root, prompts):
    from accunet_tpu_torch.cli.train import write_synthetic

    train, val = write_synthetic(str(root), 32, 1)
    if prompts:
        for d in (train, val):
            names = sorted(os.listdir(os.path.join(d, "images")))
            lines = ["Filename,Text"] + [f"{n},prompt {i}" for i, n in enumerate(names)]
            with open(os.path.join(d, "prompts.csv"), "w") as f:
                f.write("\n".join(lines) + "\n")
    return train, val


@pytest.mark.filterwarnings("ignore:ClinicalTextEncoder")
def test_flagship_train_cli_with_and_without_prompts(tmp_path, monkeypatch, no_transformers):
    from accunet_tpu_torch.cli import train as cli
    from accunet_tpu_torch.train import engine

    seen = []
    forward = engine.forward

    def recording_forward(model, batch):
        seen.append(None if batch.get("text_emb") is None else tuple(batch["text_emb"].shape))
        return forward(model, batch)

    monkeypatch.setattr(engine, "forward", recording_forward)

    def run(root, prompts, *extra):
        train, val = _folders(root, prompts)
        seen.clear()
        state, hist = cli.main(
            ["--model", FLAGSHIP, "--train-dir", train, "--val-dir", val, "--img-size", "32",
             "--batch", "2", "--epochs", "1", "--device", "cpu", "--check-numerics",
             "--ckpt-dir", str(root / "ck"), "--set", f"model.depths={SIZE['depths']}",
             f"model.feat_size={SIZE['feat_size']}", f"model.hidden_size={SIZE['hidden_size']}",
             *extra])
        assert state.step == 4 and np.isfinite(hist[0]["train"]["loss"])
        return list(seen)

    # 4 train steps and 2 validation batches, each with (2, 16, 768) text
    assert run(tmp_path / "text", True) == [(2, 16, 768)] * 6
    assert run(tmp_path / "image_only", False) == [None] * 6
    assert run(tmp_path / "forced", False, "--text") == [(2, 16, 768)] * 6


def test_text_fusion_reaches_the_output():
    """The flagship's output changes with the prompt and, without text,
    equals the model run with text_fusion None on the same weights."""
    from accunet_tpu_torch.models import build, init_parameters

    torch.manual_seed(0)
    m = init_parameters(build(FLAGSHIP, in_chans=3, **SIZE), torch.Generator().manual_seed(0))
    plain = build(FLAGSHIP, in_chans=3, text_fusion=None, **SIZE)
    plain.load_state_dict(m.state_dict(), strict=False)
    x = torch.randn(1, 32, 32, 3)
    t = torch.from_numpy(FakeTextEncoder()(["a", "b"]))
    with torch.no_grad():
        ya, yb = m(x, t[:1]), m(x, t[1:])
        assert not torch.equal(ya, yb)
        torch.testing.assert_close(m(x), plain.eval()(x), rtol=0, atol=0)
