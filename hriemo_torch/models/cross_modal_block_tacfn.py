"""TACFN-style cross-modal transformer (port of
``hriemo/models/cross_modal_block_tacfn.py``).

Per layer: intra-modal self-attention per modality (+ residual + LN),
then audio-queries-text and text-queries-audio cross-attention, each
followed by residual + LN and a ReLU FFN(4d) + residual + LN. In training,
dropout at JAX's sites (``:64-107``): on each attention's probabilities
and on each sublayer output before its residual. Where no dropout acts
and no map is kept, each attention hands its residual and post-norm
LayerNorm to the MHA call (``norm=``), whose int8 kernel takes them into
its out-projection; the result is the same. ``return_attention``
adds, per layer, a dict of the four head-averaged ``[B, Lq, Lk]`` maps
``audio_self``, ``text_self``, ``audio_queries_text`` and
``text_queries_audio``.
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
        for name in ("self_attn_a", "self_attn_t", "attn_a2t", "attn_t2a"):
            self.add_module(name, MultiheadAttention(d, n_heads, dropout=dropout))
        for name in ("self_norm_a", "self_norm_t", "norm_a1", "norm_a2", "norm_t1", "norm_t2"):
            self.add_module(name, LayerNorm(d))
        self.ffn_a = MLP2(d, 4 * d, d)
        self.ffn_t = MLP2(d, 4 * d, d)

    def forward(self, h_a, h_t, mask_a=None, mask_t=None, generator=None,
                return_attention: bool = False):
        rs = RngStream(generator)
        drop = lambda x: dropout(x, self.dropout, rs(), self.training)  # noqa: E731
        # no dropout and no map kept: the MHA takes the residual and the
        # post-norm LayerNorm into its call (its kernel's out-projection)
        fold = not return_attention and not (self.training and self.dropout > 0.0)
        maps = {}

        def attend(name, mha, q, kv, mask, ln):
            """``ln(q + drop(mha(q, kv)))``, drawing the same generators."""
            g = rs()
            if fold:
                rs()  # the dropout site the fold passes over
                return mha(q, kv, kv, mask, g, norm=ln.norm())
            out = mha(q, kv, kv, mask, g, need_weights=return_attention)
            if return_attention:
                out, maps[name] = out
            return ln(q + drop(out))

        h_a_self = attend("audio_self", self.self_attn_a, h_a, h_a, mask_a, self.self_norm_a)
        h_t_self = attend("text_self", self.self_attn_t, h_t, h_t, mask_t, self.self_norm_t)

        h_a_cm = attend("audio_queries_text", self.attn_a2t, h_a_self, h_t_self, mask_t,
                        self.norm_a1)
        h_a_cm = self.norm_a2(h_a_cm + drop(self.ffn_a(h_a_cm)))

        h_t_cm = attend("text_queries_audio", self.attn_t2a, h_t_self, h_a_self, mask_a,
                        self.norm_t1)
        h_t_cm = self.norm_t2(h_t_cm + drop(self.ffn_t(h_t_cm)))
        return (h_a_cm, h_t_cm, maps) if return_attention else (h_a_cm, h_t_cm)


class CrossModalTransformer(nn.Module):
    def __init__(self, num_layers: int = 2, d_model: int = 768, n_heads: int = 8,
                 dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(CrossModalBlock(d_model, n_heads, dropout)
                                    for _ in range(num_layers))

    def forward(self, h_a, h_t, mask_a=None, mask_t=None, generator=None,
                return_attention: bool = False):
        """``(h_a, h_t)``, or with ``return_attention`` also the list of
        per-layer map dicts."""
        maps = []
        for i, layer in enumerate(self.layers):
            out = layer(h_a, h_t, mask_a, mask_t, derive(generator, i), return_attention)
            h_a, h_t = out[:2]
            maps += out[2:]
        return (h_a, h_t, maps) if return_attention else (h_a, h_t)
