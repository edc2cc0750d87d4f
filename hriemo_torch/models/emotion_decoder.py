"""Emotion-query transformer decoder (port of
``hriemo/models/emotion_decoder.py``).

Learnable ``emotion_queries [E, d]``; each layer: self-attention over the
E queries, cross-attention to the fused memory with its pad mask, ReLU
FFN (``linear1``/``linear2``), each post-norm; with ``use_output_layer``
(the default), ``out_proj = Linear(d, 1)`` gives per-emotion logits ``[B,
E]``, else there is no ``out_proj`` and the logits are None
(``:109-146``). ``return_attention`` adds each layer's head-averaged
cross-attention map ``[B, E, L]``. With E = 4 queries the attention
fails ``use_mha_block``'s ``8 <= lq`` and runs per op, as in JAX. In
training, dropout at JAX's sites (``:68-90``): both attentions'
probabilities, each sublayer output before its residual, and the FFN's
hidden activation.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.attention import MultiheadAttention
from ..nn.layers import LayerNorm, Linear, derive, dropout
from ._common import RngStream


class ExplainableDecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model, nhead, dropout=dropout)
        self.norm1 = LayerNorm(d_model)
        self.cross_attn = MultiheadAttention(d_model, nhead, dropout=dropout)
        self.norm2 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm3 = LayerNorm(d_model)

    def forward(self, tgt, memory, memory_key_padding_mask=None, generator=None,
                return_attention: bool = False):
        """``(tgt, cross-attention map [B, E, L] or None)``."""
        rs = RngStream(generator)
        drop = lambda x: dropout(x, self.dropout, rs(), self.training)  # noqa: E731
        tgt = self.norm1(tgt + drop(self.self_attn(tgt, tgt, tgt, None, rs())))
        out = self.cross_attn(tgt, memory, memory, memory_key_padding_mask, rs(),
                              need_weights=return_attention)
        out, weights = out if return_attention else (out, None)
        tgt = self.norm2(tgt + drop(out))
        hidden = dropout(torch.relu(self.linear1(tgt)), self.dropout, rs(), self.training,
                         self.linear1.out_block)
        return self.norm3(tgt + drop(self.linear2(hidden))), weights


class EmotionDecoder(nn.Module):
    def __init__(self, d_model: int = 768, num_emotions: int = 4, n_heads: int = 8,
                 num_layers: int = 2, dim_feedforward: int = 2048, dropout: float = 0.1,
                 use_output_layer: bool = True):
        super().__init__()
        self.emotion_queries = nn.Parameter(torch.empty(num_emotions, d_model))
        self.layers = nn.ModuleList(
            ExplainableDecoderLayer(d_model, n_heads, dim_feedforward, dropout)
            for _ in range(num_layers))
        self.out_proj = Linear(d_model, 1) if use_output_layer else None

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        self.emotion_queries.normal_(generator=gen)

    def forward(self, memory, memory_key_padding_mask=None, generator=None,
                return_attention: bool = False):
        """Returns ``(z [B, E, d], logits [B, E] or None)``, and with
        ``return_attention`` the list of per-layer maps ``[B, E, L]``."""
        b = memory.shape[0]
        out = self.emotion_queries[None].expand(b, -1, -1).to(memory.dtype)
        maps = []
        for i, layer in enumerate(self.layers):
            out, weights = layer(out, memory, memory_key_padding_mask, derive(generator, i),
                                 return_attention)
            if return_attention:
                maps.append(weights)
        logits = None if self.out_proj is None else self.out_proj(out)[..., 0]
        return (out, logits, maps) if return_attention else (out, logits)
