"""CLIP text embeddings for editing and segmentation label sets.

A copy of ``feature3dgs_tpu/tasks/clip_text.py`` (the original
utils/clip_utils.py:9-58). With no network, embeddings come either from a
HuggingFace CLIP checkpoint already on disk (``CLIP_MODEL_PATH``, or
openai/clip-vit-base-patch32 in the HF cache with ``local_files_only``),
through ``transformers`` on the CPU like the original's encoder stage, or
from a precomputed ``[C, F]`` ``.npy``/``.npz`` (``load_text_features``).
"""
from __future__ import annotations

import os

import numpy as np

_CACHE: dict = {}


def clip_available() -> bool:
    """Whether CLIP weights load from local files."""
    try:
        _load_clip()
        return True
    except Exception:
        return False


def _load_clip():
    if "model" in _CACHE:
        return _CACHE["model"], _CACHE["tokenizer"]
    from transformers import CLIPTextModelWithProjection, CLIPTokenizer
    path = os.environ.get("CLIP_MODEL_PATH", "openai/clip-vit-base-patch32")
    local_only = "CLIP_MODEL_PATH" not in os.environ
    tok = CLIPTokenizer.from_pretrained(path, local_files_only=local_only)
    model = CLIPTextModelWithProjection.from_pretrained(
        path, local_files_only=local_only)
    model.eval()
    _CACHE["model"] = model
    _CACHE["tokenizer"] = tok
    return model, tok


def encode_text(texts: list[str]) -> np.ndarray:
    """[C] strings -> [C, 512] L2-normalised embeddings
    (clip_utils.py:53-58)."""
    import torch
    model, tok = _load_clip()
    with torch.no_grad():
        inputs = tok(texts, padding=True, return_tensors="pt")
        emb = model(**inputs).text_embeds
        emb = emb / emb.norm(dim=-1, keepdim=True)
    return emb.float().numpy()


def load_text_features(path: str) -> np.ndarray:
    """Precomputed [C, F] text embeddings (.npy, or the first array of an
    .npz) as float32."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return np.asarray(z[z.files[0]], np.float32)
    return np.asarray(np.load(path), np.float32)
