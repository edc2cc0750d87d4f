"""MOSEI wrapper (port of ``hriemo/models/mosei_fusion_with_emotion_decoder.py``):
``audio_proj: Linear(d_audio -> d_model)`` and ``text_proj: Linear(d_text
-> d_model)`` (MOSEI: 74 COVAREP, 300 GloVe), then the fusion backbone.
Defaults: d_model 256, 6 emotions, 4 heads, dropout 0.2, beta hidden 128.
Returns the backbone's ``(logits, beta, z)``, and with
``return_attention`` its attention maps too.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import Linear, init_torch_defaults
from .fusion_with_emotion_decoder import FusionWithEmotionDecoder


class MoseiFusionWithEmotionDecoder(nn.Module):
    def __init__(self, d_audio: int, d_text: int, d_model: int = 256, num_emotions: int = 6,
                 n_heads: int = 4, num_layers_fusion: int = 2, num_layers_decoder: int = 2,
                 beta_hidden: int = 128, dropout: float = 0.2):
        super().__init__()
        self.audio_proj = Linear(d_audio, d_model)
        self.text_proj = Linear(d_text, d_model)
        self.backbone = FusionWithEmotionDecoder(d_model, num_emotions, n_heads,
                                                 num_layers_fusion, num_layers_decoder,
                                                 beta_hidden, dropout)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        init_torch_defaults(self, gen)
        self.backbone.emotion_decoder.init_weights(gen)

    def forward(self, h_a, h_t, mask_a=None, mask_t=None, generator=None,
                return_attention: bool = False):
        return self.backbone(self.audio_proj(h_a), self.text_proj(h_t), mask_a, mask_t,
                             generator, return_attention)
