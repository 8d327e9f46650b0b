"""Text encoders of the text-conditioned SegMamba variants: counterpart of
accunet_tpu/nn/text.py (`FakeTextEncoder`, `ClinicalTextEncoder`).

Both map a list of prompts to a (B, T, 768) float32 numpy array on the
host; the model takes it as its `text_tokens` (the frozen encoder's output
is a constant of the training).

  * FakeTextEncoder: per prompt, normal(0, 0.02) draws of shape (16, 768)
    seeded by Python's `hash` of the string. `hash` of a str is salted per
    process (PYTHONHASHSEED), so the embeddings are fixed within a process
    and differ between processes, as in JAX.
  * ClinicalTextEncoder: the frozen ClinicalBERT (transformers), token
    embeddings padded to 128; when transformers or the weights are missing
    it warns loudly (RuntimeWarning) and uses FakeTextEncoder. It reads the
    weights from the local cache only and never downloads them.
"""

from __future__ import annotations

import warnings

import numpy as np


class FakeTextEncoder:
    def __init__(self, dim: int = 768, max_len: int = 16):
        self.dim = dim
        self.max_len = max_len

    def __call__(self, texts):
        if texts is None:
            return None
        out = np.zeros((len(texts), self.max_len, self.dim), np.float32)
        for i, t in enumerate(texts):
            seed = abs(hash(t)) % (2 ** 31)
            out[i] = np.random.RandomState(seed).randn(self.max_len, self.dim) * 0.02
        return out


class ClinicalTextEncoder:
    def __init__(self, model_name: str = "medicalai/ClinicalBERT"):
        self._fallback = None
        try:
            import torch
            from transformers import AutoModel, AutoTokenizer

            self.tokenizer = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
            self.encoder = AutoModel.from_pretrained(model_name, local_files_only=True).eval()
            for p in self.encoder.parameters():
                p.requires_grad_(False)
            self._torch = torch
        except Exception as e:  # transformers or the weights missing
            warnings.warn(
                f"ClinicalTextEncoder: could not load '{model_name}' "
                f"({type(e).__name__}: {e}); falling back to the "
                "DETERMINISTIC FakeTextEncoder stub — text conditioning is "
                "NOT using real ClinicalBERT embeddings",
                RuntimeWarning,
                stacklevel=2,
            )
            self._fallback = FakeTextEncoder()

    def __call__(self, texts):
        if texts is None:
            return None
        if self._fallback is not None:
            return self._fallback(texts)
        # fixed-length padding keeps the (B, T, 768) shape the same every batch
        tokens = self.tokenizer(list(texts), padding="max_length", truncation=True,
                                max_length=128, return_tensors="pt")
        with self._torch.no_grad():
            out = self.encoder(**tokens)
        return out.last_hidden_state.numpy()
