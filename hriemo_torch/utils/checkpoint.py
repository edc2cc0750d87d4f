"""Checkpoints in the reference's ``best_*.pt`` layout (port of the torch
side of ``hriemo/utils/checkpoint.py``).

The checkpoint is a dict ``{"model_state_dict", "args", "label2id" or
"emo_cols", "epoch", metric fields, optional "val_calibrated_thresholds"}``
(reference: scripts/fusion/train_mosei_fusion_seq_level_decoder.py:616-630).
The port's state-dict names are the JAX package's, so either side's file
loads strictly into the other's model. Mid-run resume (orbax in JAX) waits
for ROADMAP.md queue 1 item 5.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
from torch import nn


def state_dict_cpu(model: nn.Module) -> dict:
    """``{name: tensor}`` copies on the CPU (fp32 masters in training)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def save_torch_checkpoint(path: str, ckpt: dict) -> None:
    """Write a reference-layout ``.pt`` checkpoint; numpy arrays become
    tensors."""
    def convert(obj):
        if isinstance(obj, dict):
            return {k: convert(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(convert(v) for v in obj)
        if isinstance(obj, np.ndarray):
            return torch.from_numpy(obj)
        return obj

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(convert(ckpt), path)


def load_torch_checkpoint(path: str) -> dict:
    """A reference-layout checkpoint, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False)


def load_model_from_torch_checkpoint(model: nn.Module, path: str) -> dict:
    """Load ``model_state_dict`` strictly into ``model``; returns the whole
    checkpoint (args, label maps, thresholds)."""
    ckpt = load_torch_checkpoint(path)
    model.load_state_dict(ckpt["model_state_dict"], strict=True)
    return ckpt


def write_meta_json(path: str, meta: dict) -> None:
    """The human-readable ``meta.json`` sidecar."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(meta, f, indent=2, default=str)
