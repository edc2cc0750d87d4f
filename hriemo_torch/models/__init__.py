"""The model zoo under the JAX package's names (``hriemo/models/__init__.py``):
the served IEMOCAP model, the MOSEI wrapper, the fusion classifier and the
blocks they are built of."""

from ..core.masking import masked_mean
from .beta_gate import BetaGate
from .beta_gate_tacfn import BetaGate as VectorBetaGate
from .cross_modal_block import CrossModalBlock, CrossModalTransformer
from .cross_modal_block_tacfn import (CrossModalBlock as TacfnCrossModalBlock,
                                      CrossModalTransformer as TacfnCrossModalTransformer)
from .fusion_classifier import FusionClassifier
from .fusion_with_emotion_decoder import FusionWithEmotionDecoder
from .mosei_fusion_with_emotion_decoder import MoseiFusionWithEmotionDecoder

__all__ = [
    "CrossModalBlock",
    "CrossModalTransformer",
    "TacfnCrossModalBlock",
    "TacfnCrossModalTransformer",
    "BetaGate",
    "VectorBetaGate",
    "masked_mean",
    "FusionClassifier",
    "FusionWithEmotionDecoder",
    "MoseiFusionWithEmotionDecoder",
]
