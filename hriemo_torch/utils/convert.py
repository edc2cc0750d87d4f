"""Carry weights across from the JAX package.

The JAX package's parameters flatten (``hriemo.nn.module.flatten_params``)
to ``{name: array}`` with torch ``state_dict`` names, and the port's
modules use the same names, so loading is a strict copy: every name must
be present on both sides, with the same shape. The port never imports JAX;
callers (the tests) produce the dict, e.g. ``{k: np.asarray(v) for k, v in
flatten_params(jax_model.params).items()}``. The frontends' HF bridges
(``from_torch_state_dict``) load through the same strict copy.
"""

from __future__ import annotations

import numpy as np
import torch


def to_numpy(t) -> np.ndarray:
    """A torch tensor (any device) or array-like as a numpy array."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def load_flat_params(module: torch.nn.Module, flat: dict) -> torch.nn.Module:
    """Load ``{name: np.ndarray}`` into ``module`` (unquantized, before the
    serving cast). Raises on a missing or unexpected name or a shape
    mismatch. Returns ``module``."""
    sd = module.state_dict()
    missing = sorted(set(sd) - set(flat))
    unexpected = sorted(set(flat) - set(sd))
    if missing or unexpected:
        raise KeyError(f"parameter mismatch: missing={missing[:8]} "
                       f"unexpected={unexpected[:8]}")
    new = {}
    for name, ref in sd.items():
        arr = np.asarray(flat[name])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {name}: got {arr.shape}, "
                             f"want {tuple(ref.shape)}")
        new[name] = torch.from_numpy(np.array(arr, copy=True)).to(ref.dtype)
    module.load_state_dict(new, strict=True)
    return module
