"""Scalar beta gate, the legacy variant (port of ``hriemo/models/beta_gate.py``).

Masked-mean pools of each modality's raw features, gate input
``[a, t, |a - t|, a * t]`` in R^{4d}, MLP(4d -> hidden -> 1) + sigmoid ->
one ``beta`` per sample ``[B, 1]``; the fusion ``beta * h_a + (1 - beta) *
h_t`` is taken on the raw (not normalised) features. When the lengths
differ, the fused length is the text's, both sides truncated (or zero
padded, as ``beta_gate_tacfn._fit_length`` does).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.masking import masked_mean
from ..nn.layers import MLP2
from .beta_gate_tacfn import _fit_length

__all__ = ["BetaGate", "masked_mean"]


class BetaGate(nn.Module):
    def __init__(self, d_model: int = 768, hidden_dim: int = 256):
        super().__init__()
        self.mlp = MLP2(4 * d_model, hidden_dim, 1)

    def forward(self, h_a, h_t, mask_a=None, mask_t=None):
        a_pool = masked_mean(h_a, mask_a)                          # [B, d]
        t_pool = masked_mean(h_t, mask_t)
        gate_input = torch.cat([a_pool, t_pool, (a_pool - t_pool).abs(), a_pool * t_pool], -1)
        beta = torch.sigmoid(self.mlp(gate_input))                  # [B, 1]
        l_a, l_t = h_a.shape[1], h_t.shape[1]
        length = l_a if l_a == l_t else l_t                         # text length wins
        beta_b = beta[:, :, None]
        return (beta_b * _fit_length(h_a, length)
                + (1.0 - beta_b) * _fit_length(h_t, length)), beta
