"""voicebox_tpu_torch: the PyTorch and CUDA port of voicebox_tpu.

The JAX package `voicebox_tpu` is the reference; this package mirrors its
module names. It imports torch and never jax. Its first slice is the
serving path: the conditional-flow-matching sampler over the VoiceBox
denoiser, then the Encodec/Vocos decode. On CUDA tensors every attention
call runs K1, the hand-written Hopper kernel in `csrc/`.
"""

from .models.cfm import ConditionalFlowMatcherWrapper
from .models.codec import EncodecVoco
from .models.transformer import Transformer
from .models.vocos import Vocos
from .models.voicebox import VoiceBox

__version__ = "0.1.0"

__all__ = [
    "ConditionalFlowMatcherWrapper",
    "EncodecVoco",
    "Transformer",
    "Vocos",
    "VoiceBox",
]
