"""Language embedding (a copy of the JAX package's ``utils/lang_utils.py``;
reference ``robomimic/utils/lang_utils.py``: CLIP
ViT-L/14 text encoder -> 768-d embeddings, one per demo).

Zero-egress gating: if a local CLIP text model is available (pass
``model_dir`` or set ``RMVQ_CLIP_DIR``), it is used exactly like the
reference. Otherwise a deterministic hash-seeded pseudo-embedding keeps the
pipeline runnable (distinct task strings -> distinct, stable unit vectors);
this divergence only matters for language-conditioned evals, which require
the real model anyway.
"""

import hashlib
import os

import numpy as np

LANG_EMB_KEY = "lang_emb"
EMB_DIM = 768


class LangEncoder:
    def __init__(self, model_dir=None, device=None):
        self._clip = None
        self._tok = None
        model_dir = model_dir or os.environ.get("RMVQ_CLIP_DIR")
        if model_dir:
            from transformers import AutoTokenizer, CLIPTextModelWithProjection

            self._tok = AutoTokenizer.from_pretrained(model_dir)
            self._clip = CLIPTextModelWithProjection.from_pretrained(model_dir)
            self._clip.eval()

    @property
    def is_real(self):
        return self._clip is not None

    def _pseudo_emb(self, text):
        seed = int.from_bytes(
            hashlib.sha256(text.encode()).digest()[:4], "little"
        )
        v = np.random.RandomState(seed).randn(EMB_DIM).astype(np.float32)
        return v / np.linalg.norm(v)

    def get_lang_emb(self, lang):
        """str or list[str] -> [768] or [N, 768] numpy."""
        if lang is None:
            return None
        single = isinstance(lang, str)
        texts = [lang] if single else list(lang)
        if self._clip is not None:
            import torch

            inputs = self._tok(texts, return_tensors="pt", padding=True)
            with torch.no_grad():
                embs = self._clip(**inputs).text_embeds.numpy()
        else:
            embs = np.stack([self._pseudo_emb(t) for t in texts])
        return embs[0] if single else embs
