"""Shared helpers for the model zoo."""

from __future__ import annotations

import torch

from ..nn.layers import derive


class RngStream:
    """Per-call-site dropout generators derived from one generator
    (``hriemo/models/_common.py::RngStream``): each call returns a fresh
    generator seeded from the base generator's seed and a counter, or None
    when no generator was given (eval)."""

    def __init__(self, generator: torch.Generator | None = None):
        self._gen = generator
        self._i = 0

    def __call__(self) -> torch.Generator | None:
        g = derive(self._gen, self._i)
        self._i += 1
        return g


def ensure_3d(x):
    """``[B, d]`` -> ``[B, 1, d]``; ``[B, L, d]`` passes through
    (reference: models/fusion_with_emotion_decoder.py:60-69)."""
    if x.ndim == 2:
        return x[:, None, :]
    if x.ndim == 3:
        return x
    raise ValueError(f"Expected 2D or 3D tensor, got shape {tuple(x.shape)}")
