"""Bidirectional cross-modal transformer, the legacy IEMOCAP variant (port of
``hriemo/models/cross_modal_block.py``).

Per layer: audio queries text (keys and values text, masked by the text
pad mask), residual + LayerNorm, a ReLU FFN(4d) + residual + LayerNorm;
then the symmetric text-queries-audio path. Works on utterance-level
``[B, 1, d]`` and sequence-level ``[B, L, d]`` inputs; no attention export.
In training, dropout at JAX's sites (``:62-80``): on each attention's
probabilities and on each sublayer output before its residual.
"""

from __future__ import annotations

from torch import nn

from ..nn.attention import MultiheadAttention
from ..nn.layers import MLP2, LayerNorm, derive, dropout
from ._common import RngStream


class CrossModalBlock(nn.Module):
    def __init__(self, d_model: int = 768, n_heads: int = 8, dropout: float = 0.1):
        super().__init__()
        d = d_model
        self.dropout = dropout
        self.attn_a2t = MultiheadAttention(d, n_heads, dropout=dropout)
        self.attn_t2a = MultiheadAttention(d, n_heads, dropout=dropout)
        self.ffn_a = MLP2(d, 4 * d, d)
        self.ffn_t = MLP2(d, 4 * d, d)
        for name in ("norm_a1", "norm_a2", "norm_t1", "norm_t2"):
            self.add_module(name, LayerNorm(d))

    def forward(self, h_a, h_t, mask_a=None, mask_t=None, generator=None):
        rs = RngStream(generator)
        drop = lambda x: dropout(x, self.dropout, rs(), self.training)  # noqa: E731

        a2t = self.attn_a2t(h_a, h_t, h_t, mask_t, rs())
        h_a_tilde = self.norm_a1(h_a + drop(a2t))
        h_a_tilde = self.norm_a2(h_a_tilde + drop(self.ffn_a(h_a_tilde)))

        t2a = self.attn_t2a(h_t, h_a, h_a, mask_a, rs())
        h_t_tilde = self.norm_t1(h_t + drop(t2a))
        h_t_tilde = self.norm_t2(h_t_tilde + drop(self.ffn_t(h_t_tilde)))
        return h_a_tilde, h_t_tilde


class CrossModalTransformer(nn.Module):
    """A stack of :class:`CrossModalBlock` (``:83-106``)."""

    def __init__(self, num_layers: int = 2, d_model: int = 768, n_heads: int = 8,
                 dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(CrossModalBlock(d_model, n_heads, dropout)
                                    for _ in range(num_layers))

    def forward(self, h_a, h_t, mask_a=None, mask_t=None, generator=None):
        for i, layer in enumerate(self.layers):
            h_a, h_t = layer(h_a, h_t, mask_a, mask_t, derive(generator, i))
        return h_a, h_t
