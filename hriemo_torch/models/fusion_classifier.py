"""TACFN fusion classifier, the no-decoder baseline (port of
``hriemo/models/fusion_classifier.py``).

The TACFN ``CrossModalTransformer``, the vector beta gate, then the head
``LayerNorm -> Linear(d, d) -> ReLU -> Dropout -> Linear(d, C)`` (state-dict
keys ``classifier.0``, ``.1``, ``.4``, torch ``nn.Sequential`` indices).
The fused sequence is mean-pooled over time **without** its mask, a
reference quirk kept (``:78-79``). Takes utterance-level ``[B, d]`` or
sequence-level ``[B, L, d]`` inputs and returns ``(logits [B, C], beta [B,
1], h_fusion_pooled [B, d])``. ``dropout`` (JAX's default 0.2) acts in
training mode, where ``forward`` needs a ``generator`` on the inputs'
device; the model reads only its seed.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import LayerNorm, Linear, dropout, init_torch_defaults
from ._common import RngStream, ensure_3d
from .beta_gate_tacfn import BetaGate
from .cross_modal_block_tacfn import CrossModalTransformer


class FusionClassifier(nn.Module):
    def __init__(self, d_model: int = 768, num_classes: int = 4, n_heads: int = 8,
                 num_layers: int = 2, beta_hidden: int = 256, dropout: float = 0.2):
        super().__init__()
        self.dropout = dropout
        self.cross_modal = CrossModalTransformer(num_layers, d_model, n_heads, dropout)
        self.beta_gate = BetaGate(d_model, beta_hidden)
        self.classifier = nn.Module()
        self.classifier.add_module("0", LayerNorm(d_model))
        self.classifier.add_module("1", Linear(d_model, d_model))
        self.classifier.add_module("4", Linear(d_model, num_classes))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """torch's default inits, as the JAX package draws them."""
        init_torch_defaults(self, gen)

    def forward(self, h_a, h_t, mask_a=None, mask_t=None, generator=None):
        rs = RngStream(generator)
        h_a, h_t = ensure_3d(h_a), ensure_3d(h_t)
        h_a, h_t = self.cross_modal(h_a, h_t, mask_a, mask_t, rs())
        h_fusion, beta = self.beta_gate(h_a, h_t, mask_a, mask_t)
        h_fusion_pooled = h_fusion.mean(dim=1)      # unmasked (reference quirk)
        c = self.classifier._modules
        x = torch.relu(c["1"](c["0"](h_fusion_pooled)))
        x = dropout(x, self.dropout, rs(), self.training)
        return c["4"](x), beta, h_fusion_pooled
