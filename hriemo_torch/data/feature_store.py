"""Feature store: per-utterance feature files + directory metadata (a copy
of ``hriemo/data/feature_store.py``, which the port does not import).

Artifact contract (SURVEY.md §1, preserved exactly):
  * seq-level file: ``{"hidden": float[L, d], "attention_mask": int[L]}``
    with 1 = valid, 0 = pad
    (reference: scripts/iemocap_feature_extraction_seq_level/extract_text_feats_bert_seq.py:70-76);
  * utter-level file: bare ``float[d]`` vector; loaders also tolerate dicts
    keyed ``feat/feats/embedding/hidden/repr``
    (reference: scripts/fusion/train_fusion_utter_level.py:183-198);
  * per-directory ``meta.json`` with ``hidden_dim`` (or ``dim``), model
    name, etc. (reference: extract_audio_feats_wavlm_seq.py:127-135).

Formats: ``.pt`` (torch, reference interchange), ``.npy`` (bare array),
``.npz`` (native — fastest host load, no torch import needed). NaN/Inf are
cleaned to 0 at load, mirroring the reference's load-time guard
(train_mosei_...py:249-257).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

UTTER_DICT_KEYS = ("feat", "feats", "embedding", "hidden", "repr")


def _clean(x: np.ndarray) -> np.ndarray:
    return np.nan_to_num(np.asarray(x, dtype=np.float32), nan=0.0, posinf=0.0, neginf=0.0)


def _load_raw(path: str | Path):
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith((".pt", ".pth")):
        import torch

        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict):
            return {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in obj.items()}
        return obj.numpy() if hasattr(obj, "numpy") else np.asarray(obj)
    raise ValueError(f"Unknown feature file format: {path}")


def load_feature(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Load a seq-level feature file → ``(hidden [L,d] f32, mask [L] int 1=valid)``."""
    obj = _load_raw(path)
    if isinstance(obj, dict):
        hidden = _clean(obj["hidden"])
        if "attention_mask" in obj:
            mask = np.asarray(obj["attention_mask"]).astype(np.int64)
        else:
            mask = np.ones(hidden.shape[0], dtype=np.int64)
    else:
        hidden = _clean(obj)
        mask = np.ones(hidden.shape[0], dtype=np.int64)
    return hidden, mask


def load_utter_feature(path: str | Path) -> np.ndarray:
    """Load an utter-level feature → ``[d]`` f32 (robust to dict layouts)."""
    obj = _load_raw(path)
    if isinstance(obj, dict):
        for key in UTTER_DICT_KEYS:
            if key in obj:
                obj = obj[key]
                break
        else:
            raise KeyError(f"No known feature key in {path}: {sorted(obj)}")
    vec = _clean(obj)
    if vec.ndim == 2 and vec.shape[0] == 1:
        vec = vec[0]
    if vec.ndim != 1:
        raise ValueError(f"Expected [d] utter feature at {path}, got {vec.shape}")
    return vec


def save_feature(
    path: str | Path,
    hidden: np.ndarray,
    attention_mask: np.ndarray | None = None,
) -> None:
    """Save a feature file; format chosen from the extension (.npz or .pt)."""
    path = str(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    hidden = np.asarray(hidden, dtype=np.float32)
    if attention_mask is None and hidden.ndim >= 1 and hidden.ndim != 1:
        attention_mask = np.ones(hidden.shape[0], dtype=np.int64)
    if path.endswith(".npz"):
        if attention_mask is None:
            np.savez(path, hidden=hidden)
        else:
            np.savez(path, hidden=hidden, attention_mask=np.asarray(attention_mask))
    elif path.endswith((".pt", ".pth")):
        import torch

        obj = {"hidden": torch.tensor(hidden)}
        if attention_mask is not None:
            obj["attention_mask"] = torch.tensor(np.asarray(attention_mask))
        torch.save(obj, path)
    else:
        raise ValueError(f"Unknown feature file format: {path}")


def read_meta(feat_dir: str | Path) -> dict:
    with open(Path(feat_dir) / "meta.json") as f:
        return json.load(f)


def hidden_dim_from_meta(meta: dict) -> int:
    """The reference accepts ``hidden_dim`` or ``dim``
    (scripts/infer/mosei_eval_infer.py:47-53)."""
    for key in ("hidden_dim", "dim"):
        if key in meta:
            return int(meta[key])
    raise KeyError(f"meta.json has no hidden_dim/dim: {sorted(meta)}")


def write_meta(feat_dir: str | Path, **meta) -> None:
    os.makedirs(feat_dir, exist_ok=True)
    with open(Path(feat_dir) / "meta.json", "w") as f:
        json.dump(meta, f, indent=2)
