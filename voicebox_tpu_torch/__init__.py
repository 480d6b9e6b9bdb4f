"""voicebox_tpu_torch: the PyTorch and CUDA port of voicebox_tpu.

The JAX package `voicebox_tpu` is the reference; this package mirrors its
module names. It imports torch and never jax. Its slices so far: the
serving path (the conditional-flow-matching sampler over the VoiceBox
denoiser, fixed-grid or adaptive Tsit5, then the Encodec/Vocos decode), the
training step (the CFM loss, AdamW or bf16-moment Adam, bf16 live
parameters, the EMA, remat, reference-layout checkpoints, `VoiceBoxTrainer`,
`TrainConfig`) and quantized duration-mode serving (the
`DurationPredictor`'s inference, `TTSEngine`, `DynamicBatcher`,
`sample(quantize=...)`). On CUDA tensors every attention call runs K1
forward and K2 + K3 backward, and every quantized "w8a16" matmul runs K4,
the hand-written Hopper kernels in `csrc/`. Entry points run on the card
unless the caller passes `device="cpu"`.
"""

from .models.cfm import ConditionalFlowMatcherWrapper
from .models.codec import EncodecVoco
from .models.duration import DurationPredictor
from .models.transformer import Transformer
from .models.vocos import Vocos
from .models.voicebox import VoiceBox
from .serving import DynamicBatcher, TTSEngine
from .training.config import TrainConfig
from .training.data import ArrayDataset
from .training.trainer import VoiceBoxTrainer

__version__ = "0.1.0"

__all__ = [
    "ArrayDataset",
    "ConditionalFlowMatcherWrapper",
    "DurationPredictor",
    "DynamicBatcher",
    "EncodecVoco",
    "TTSEngine",
    "TrainConfig",
    "Transformer",
    "Vocos",
    "VoiceBox",
    "VoiceBoxTrainer",
]
