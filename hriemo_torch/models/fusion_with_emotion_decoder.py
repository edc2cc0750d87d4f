"""Cross-modal transformer + vector beta gate + emotion decoder (port of
``hriemo/models/fusion_with_emotion_decoder.py``).

2-D inputs are lifted to ``[B, 1, d]``; the decoder's key-padding mask is
the OR of both modality masks aligned (pad with True / truncate) to the
fused length. Returns ``(logits [B, E], beta [B, 1], z [B, E, d])``; with
``return_attention`` also ``{"encoder": [per-layer dicts of four maps],
"decoder": [per-layer [B, E, L]]}`` (``:62-94``).
``dropout`` (JAX's default 0.1) acts in training mode (``model.train()``),
where ``forward`` needs a ``generator`` on the inputs' device; the model
reads only its seed, so a recompute draws the same masks.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.masking import build_fused_mask
from ..nn.layers import init_torch_defaults
from ._common import RngStream, ensure_3d
from .beta_gate_tacfn import BetaGate
from .cross_modal_block_tacfn import CrossModalTransformer
from .emotion_decoder import EmotionDecoder


class FusionWithEmotionDecoder(nn.Module):
    def __init__(self, d_model: int = 768, num_emotions: int = 4, n_heads: int = 8,
                 num_layers_fusion: int = 2, num_layers_decoder: int = 2,
                 beta_hidden: int = 256, dropout: float = 0.1):
        super().__init__()
        self.cross_modal = CrossModalTransformer(num_layers_fusion, d_model, n_heads, dropout)
        self.beta_gate = BetaGate(d_model, beta_hidden)
        self.emotion_decoder = EmotionDecoder(d_model, num_emotions, n_heads,
                                              num_layers_decoder, dropout=dropout)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """torch's default inits, as the JAX package draws them."""
        init_torch_defaults(self, gen)
        self.emotion_decoder.init_weights(gen)

    def forward(self, h_a, h_t, mask_a=None, mask_t=None, generator=None,
                return_attention: bool = False):
        rs = RngStream(generator)
        h_a, h_t = ensure_3d(h_a), ensure_3d(h_t)
        h_a, h_t, *enc = self.cross_modal(h_a, h_t, mask_a, mask_t, rs(), return_attention)
        h_fusion, beta = self.beta_gate(h_a, h_t, mask_a, mask_t)
        fused_mask = build_fused_mask(mask_a, mask_t, h_fusion.shape[1])
        z, logits, *dec = self.emotion_decoder(h_fusion, fused_mask, rs(), return_attention)
        if return_attention:
            return logits, beta, z, {"encoder": enc[0], "decoder": dec[0]}
        return logits, beta, z
