"""Language-guided scene editing: extraction, deletion and colour edits.

Port of ``feature3dgs_tpu/render/editing.py`` (the original render_edit,
gaussian_renderer/__init__.py:21-170, and the edit config of
render.py:56-86). Each Gaussian's selection score compares its normalised
semantic feature with CLIP text embeddings; an edit masks the activated
opacity or re-colours the SH DC band before rendering. The similarity stays
float32, as in the JAX package (the original computes it in fp16 to save
CUDA memory).

Text embeddings come from ``tasks.clip_text`` (local CLIP weights) or a
precomputed ``.npy``. A config is read in two steps: ``read_edit_config``
parses the file (YAML through PyYAML, imported only there; JSON, a subset
of YAML, with the standard library), and ``edit_from_config`` turns the
mapping into an edit, so a caller that holds the mapping needs neither.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from feature3dgs_tpu_torch.model import gaussians as G


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True),
                               1e-12)


def _probs(features, text_features, positive_ids):
    """(raw scores [N,T], softmax [N,T], softmax with the positive classes'
    mass merged into the first positive column)."""
    scores = _normalize(features) @ _normalize(text_features).T
    probs = torch.softmax(scores, dim=-1)
    merged = probs.clone()
    merged[:, positive_ids[0]] = probs[:, positive_ids].sum(-1)
    return scores, probs, merged


def selection_scores(features: torch.Tensor, text_features: torch.Tensor,
                     score_threshold: float | None = None,
                     positive_ids: Sequence[int] = (0,)) -> torch.Tensor:
    """calculate_selection_score (gaussian_renderer/__init__.py:21-36):
    features [N,F] per Gaussian, text_features [T,F] -> a {0,1} float mask
    [N]: one text embedding is thresholded on the raw similarity; several
    on the positive classes' softmax mass, or without a threshold by
    whether the argmax (positives merged) is a positive class."""
    positive_ids = list(positive_ids)
    scores, probs, merged = _probs(features, text_features, positive_ids)
    if scores.shape[-1] == 1:
        return (scores[:, 0] >= score_threshold).float()
    if score_threshold is not None:
        return (probs[:, positive_ids].sum(-1) >= score_threshold).float()
    ids = torch.tensor(positive_ids, device=features.device)
    return torch.isin(torch.argmax(merged, dim=-1), ids).float()


def selection_scores_delete(features: torch.Tensor,
                            text_features: torch.Tensor,
                            score_threshold: float | None = None,
                            positive_ids: Sequence[int] = (0,)
                            ) -> torch.Tensor:
    """calculate_selection_score_delete (:38-55): argmax membership (the
    positives merged) OR the positive softmax mass past the threshold."""
    positive_ids = list(positive_ids)
    scores, probs, merged = _probs(features, text_features, positive_ids)
    if scores.shape[-1] == 1:
        return (scores[:, 0] >= score_threshold).float()
    ids = torch.tensor(positive_ids, device=features.device)
    mask = torch.isin(torch.argmax(merged, dim=-1), ids)
    if score_threshold is not None:
        mask = mask | (probs[:, positive_ids].sum(-1) >= score_threshold)
    return mask.float()


def apply_edits(params: G.GaussianParams, text_features: torch.Tensor,
                edit: dict) -> tuple[G.GaussianParams, torch.Tensor | None]:
    """Apply an edit (render_edit, gaussian_renderer/__init__.py:131-148).

    ``edit``: positive_ids (list of int), score_threshold (float or None),
    operations (any of deletion=True, extraction=True, color_func=callable
    on the SH DC [N,3]). Returns (params, an opacity override or None): the
    opacity edits replace the activated opacity, as the original does, and
    a colour edit returns new params with the selected DC replaced."""
    feats = G.get_semantic(params)
    ops = edit["operations"]
    pos = edit.get("positive_ids", [0])
    thr = edit.get("score_threshold")
    opacity = G.get_opacity(params)
    op_override = None
    zero = torch.zeros((), dtype=opacity.dtype, device=opacity.device)

    if "deletion" in ops:
        s = selection_scores_delete(feats, text_features, thr, pos)
        opacity = torch.where(s >= 0.5, zero, opacity)
        op_override = opacity
    if "extraction" in ops:
        s = selection_scores(feats, text_features, thr, pos)
        opacity = torch.where(s <= 0.5, zero, opacity)
        op_override = opacity
    if "color_func" in ops:
        s = selection_scores(feats, text_features, thr, pos)
        fn: Callable = ops["color_func"]
        dc = params.features_dc[:, 0, :]
        new_dc = dc * (1 - s[:, None]) + fn(dc) * s[:, None]
        params = dataclasses.replace(params, features_dc=new_dc[:, None, :])
    return params, op_override


def read_edit_config(path: str) -> dict:
    """The mapping of an edit config file: JSON (``.json``) with the
    standard library, otherwise YAML through PyYAML."""
    if path.endswith(".json"):
        import json
        with open(path) as f:
            return json.load(f)
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


def edit_from_config(cfg: dict):
    """An edit config mapping -> (edit, object names, target name), as
    render.py:56-86 reads it minus the CLIP call (the caller supplies the
    text features). ``colorFunc`` is a lambda string evaluated with
    ``torch`` and ``np`` in scope."""
    objects = cfg["edit"]["objects"]
    targets = cfg["edit"]["targets"].split(",")
    edit = {
        "positive_ids": [objects.index(t) for t in targets if t in objects],
        "score_threshold": cfg["edit"]["threshold"],
        "operations": {},
    }
    for operation in cfg["edit"]["operations"].split(","):
        if operation in ("extraction", "deletion"):
            edit["operations"][operation] = True
        elif operation == "color_func":
            # a config-authored lambda, e.g. "lambda x: x * 0.0"; the
            # original evaluates its yaml field the same way (render.py:79)
            edit["operations"]["color_func"] = eval(  # noqa: S307
                cfg["edit"]["colorFunc"], {"torch": torch, "np": np})
        else:
            raise NotImplementedError(f"edit operation {operation!r}")
    target = targets[edit["positive_ids"][0]] if edit["positive_ids"] else ""
    return edit, objects, target


def parse_edit_config(path: str):
    """``edit_from_config(read_edit_config(path))``."""
    return edit_from_config(read_edit_config(path))
