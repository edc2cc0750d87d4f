"""Checkpoints in the reference's ``best_*.pt`` layout (port of the torch
side of ``hriemo/utils/checkpoint.py``).

The checkpoint is a dict ``{"model_state_dict", "args", "label2id" or
"emo_cols", "epoch", metric fields, optional "val_calibrated_thresholds"}``
(reference: scripts/fusion/train_mosei_fusion_seq_level_decoder.py:616-630).
The port's state-dict names are the JAX package's, so either side's file
loads strictly into the other's model.

Mid-run resume: :func:`save_native` and :func:`restore_native` write and
read a train state (parameters, AdamW's moments, the counts) or a parameter
dict where the JAX package writes orbax checkpoints (``out_dir/resume/state``,
``resume/best_params``, ``out_dir/native_state``). The port's are torch
files at those paths: orbax's format is JAX's own.

Under a mesh (``parallel/mesh.py``) a sharded model's state is saved whole,
in the format of a single-device run: every rank takes part in making the
leaves whole, and rank 0 alone writes.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch
from torch import nn


def state_dict_cpu(model: nn.Module, mesh=None) -> dict:
    """``{name: tensor}`` copies on the CPU (fp32 masters in training); a
    sharded model's leaves made whole under ``mesh`` (a collective)."""
    from ..parallel.mesh import full_state_dict

    return {k: v.detach().to("cpu", copy=True) for k, v in full_state_dict(model, mesh).items()}


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


def native_tree(obj: Any, mesh=None) -> dict:
    """A train state or a parameter dict as one dict of CPU tensors; a
    sharded state's leaves made whole under ``mesh`` (a collective)."""
    if isinstance(obj, dict):
        return {"params": {k: v.detach().to("cpu", copy=True) for k, v in obj.items()}}
    from ..parallel.mesh import full_tensor, param_shardings

    specs = {} if mesh is None else param_shardings(mesh, obj.model)
    names = [n for n, _ in obj.model.named_parameters()]
    cpu = lambda ts: {n: (t if mesh is None else full_tensor(t, specs[n], mesh))  # noqa: E731
                      .detach().to("cpu", copy=True) for n, t in zip(names, ts)}
    return {"params": state_dict_cpu(obj.model, mesh), "mu": cpu(obj.mu), "nu": cpu(obj.nu),
            **{k: getattr(obj, k).detach().to("cpu", copy=True)
               for k in ("count", "step", "total_notfinite")}}


def save_native(path: str, tree: Any, mesh=None) -> None:
    """Write a ``TrainState`` (``parallel/train_step.py``: parameters, mu,
    nu, count, step, total_notfinite) or a ``{name: tensor}`` parameter dict
    to ``path``, a torch file, replaced whole (written beside it first).
    Under ``mesh`` every rank calls it, a sharded state is saved whole, and
    rank 0 writes."""
    tree = native_tree(tree, mesh)
    if mesh is not None and mesh.rank != 0:
        return
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def restore_native(path: str, like: Any) -> Any:
    """Read what :func:`save_native` wrote into ``like``'s structure: a
    ``TrainState`` is restored in place, every leaf on its own device (the
    model strictly, the moments and counts by name), and returned; for a
    parameter dict, a new dict with ``like``'s names, each tensor on its
    device."""
    tree = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if isinstance(like, dict):
        if set(tree["params"]) != set(like):
            raise KeyError(f"{path}: parameter names differ from the model's")
        return {k: tree["params"][k].to(like[k].device) for k in like}
    like.model.load_state_dict(tree["params"], strict=True)
    names = [n for n, _ in like.model.named_parameters()]
    with torch.no_grad():
        for key in ("mu", "nu"):
            if set(tree[key]) != set(names):
                raise KeyError(f"{path}: {key} names differ from the model's parameters")
            for n, t in zip(names, getattr(like, key)):
                t.copy_(tree[key][n])
        for key in ("count", "step", "total_notfinite"):
            getattr(like, key).copy_(tree[key])
    return like


def write_meta_json(path: str, meta: dict) -> None:
    """The human-readable ``meta.json`` sidecar."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(meta, f, indent=2, default=str)
