"""The fusion models: the served IEMOCAP model and the MOSEI wrapper."""

from .fusion_with_emotion_decoder import FusionWithEmotionDecoder
from .mosei_fusion_with_emotion_decoder import MoseiFusionWithEmotionDecoder

__all__ = ["FusionWithEmotionDecoder", "MoseiFusionWithEmotionDecoder"]
