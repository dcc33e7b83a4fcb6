"""FAST action-tokenizer modality, ``fast_enabled`` (counterpart of the JAX
package's ``models/tokenizers/fast.py``).

The reference tokenizes each prompt action chunk with the pretrained FAST
processor, embeds the stringified token ids with the frozen CLIP ViT-B/32
text encoder, L2-normalizes, resamples to seq_len rows and projects
512 -> the observation feature width with a small MLP. Both pretrained
stages are frozen, so they run on the host, in numpy, before the upload
(``FastHostEncoder``); only ``FastProjection`` runs on the device and
trains.

Neither artifact is in the repository and nothing fetches them:
``FastHostEncoder(fast_processor_dir, clip_model_dir)`` loads them from
local directories through HuggingFace ``transformers``, and
``FastHostEncoder.from_components(processor, clip_encode_fn)`` injects the
two stages (the tests and ``chip_smoke.py`` inject deterministic
stand-ins).

Checkpoint names (``...action_network.<name>``): ``fc{1,2,3}.*``.
"""

import numpy as np
import torch.nn as nn
import torch.nn.functional as F

CLIP_TEXT_DIM = 512


def resample_latents(latents, seq_len):
    """[D, dim] rows -> exactly [seq_len, dim]: the rows at
    ``linspace(0, D - 1, seq_len)`` truncated to int when D >= seq_len (in
    float32, as torch's ``linspace(...).long()`` picks them), else the D rows
    zero-padded below."""
    latents = np.asarray(latents)
    d, dim = latents.shape
    if d >= seq_len:
        idx = np.linspace(0, d - 1, seq_len, dtype=np.float32).astype(np.int64)
        return latents[idx]
    out = np.zeros((seq_len, dim), latents.dtype)
    out[:d] = latents
    return out


class FastProjection(nn.Module):
    """The trainable part: CLIP latents [..., 512] -> [..., output_dim]."""

    JAX_NAMES = {"fc1": "fc1", "fc2": "fc2", "fc3": "fc3"}

    def __init__(self, output_dim):
        super().__init__()
        self.fc1 = nn.Linear(CLIP_TEXT_DIM, 64)
        self.fc2 = nn.Linear(64, 128)
        self.fc3 = nn.Linear(128, output_dim)
        for lin in (self.fc1, self.fc2, self.fc3):
            nn.init.zeros_(lin.bias)

    def forward(self, clip_latents):
        return self.fc3(F.gelu(self.fc2(F.gelu(self.fc1(clip_latents)))))


class FastHostEncoder:
    """Host-side FAST tokenize + CLIP text encode (frozen, numpy): per
    sample, tokenize the [T, A] chunk, CLIP-encode the stringified token ids,
    L2-normalize, resample to seq_len rows.

    ``from_components(processor, clip_encode_fn)`` takes
    ``processor(actions [1, T, A]) -> [[token ids]]`` and
    ``clip_encode_fn(texts) -> [D, 512]`` (unnormalized)."""

    def __init__(self, fast_processor_dir, clip_model_dir=None):
        try:
            from transformers import AutoProcessor
        except ImportError as e:
            raise ImportError("FAST modality requires HuggingFace transformers") from e
        self._processor = AutoProcessor.from_pretrained(
            fast_processor_dir, trust_remote_code=True)
        try:
            import torch
            from transformers import CLIPTextModelWithProjection, CLIPTokenizer

            src = clip_model_dir or "openai/clip-vit-base-patch32"
            clip_tok = CLIPTokenizer.from_pretrained(src)
            clip_model = CLIPTextModelWithProjection.from_pretrained(src).eval()
        except Exception as e:
            raise RuntimeError(
                "FAST modality requires a local CLIP text model "
                "(zero-egress environments must pass clip_model_dir)") from e

        def clip_encode(texts):
            inputs = clip_tok(texts, return_tensors="pt", padding=True)
            with torch.no_grad():
                return clip_model(**inputs).text_embeds.numpy().astype(np.float32)

        self._clip_encode = clip_encode

    @classmethod
    def from_components(cls, processor, clip_encode_fn):
        self = cls.__new__(cls)
        self._processor = processor
        self._clip_encode = clip_encode_fn
        return self

    def encode_chunk(self, actions_ta, seq_len):
        """[T, A] -> [seq_len, 512] float32."""
        tokens = self._processor(np.asarray(actions_ta)[None])[0]
        latents = np.asarray(self._clip_encode([str(t) for t in tokens]), np.float32)
        latents = latents / np.linalg.norm(latents, axis=-1, keepdims=True)
        return resample_latents(latents, seq_len).astype(np.float32)

    def encode_batch(self, actions_bta, seq_len):
        """[B, T, A] -> [B, seq_len, 512] float32."""
        return np.stack([self.encode_chunk(a, seq_len) for a in np.asarray(actions_bta)])
