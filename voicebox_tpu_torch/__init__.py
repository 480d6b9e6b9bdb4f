"""voicebox_tpu_torch: the PyTorch and CUDA port of voicebox_tpu.

The JAX package `voicebox_tpu` is the reference; this package mirrors its
module names. It imports torch and never jax. Its slices so far: the
serving path (the conditional-flow-matching sampler over the VoiceBox
denoiser, fixed-grid or adaptive Tsit5, then the Encodec/Vocos or mel/Vocos
decode), the training step (the CFM loss, AdamW or bf16-moment Adam, bf16
live parameters, the EMA, remat, reference-layout checkpoints,
`VoiceBoxTrainer` on latents or raw waves, `TrainConfig`), the raw-audio
path (STFT, log-mel and resampling, `MelVoco`, the SEANet encoder and
decoder behind `EncodecVoco.encode`), quantized duration-mode serving (the
`DurationPredictor`'s inference, `TTSEngine`, `DynamicBatcher`,
`sample(quantize=...)`), duration-predictor training (the NS2 aligner,
monotonic alignment search, the forward-sum loss,
`DurationPredictorTrainer`) and the semantic stack (`HubertWithKmeans`
and k-means, `TextToSemantic` with its KV-cached, speculative and
quantized decode, semantic-mode `sample(texts=)` and `TTSEngine`,
`TextToSemanticTrainer`), the GateLoop layer, and long-form windowed
sampling with voice cloning (`sample_long`, `sample_long_stream`,
`TTSEngine` over its largest text bucket, `clone`, `clone_stream`,
`DynamicBatcher.submit_clone`), and training from audio files
(`training.data.AudioDataset`, `SpeechTextDataset`, `load_audio` over the
native WAV / FLAC decoders in `native/`) with the runnable `examples/`,
an HTTP server among them. On CUDA tensors every attention call runs K1
forward and K2 + K3 backward, and every quantized "w8a16" matmul runs K4,
the hand-written Hopper kernels in `csrc/`. Entry points run on the card
unless the caller passes `device="cpu"`.
"""

from .models.cfm import ConditionalFlowMatcherWrapper
from .models.codec import EncodecVoco, MelVoco
from .models.duration import DurationPredictor
from .models.hubert import HubertWithKmeans
from .models.text_to_semantic import TextToSemantic
from .models.transformer import Transformer
from .models.vocos import Vocos
from .models.voicebox import VoiceBox
from .serving import DynamicBatcher, TTSEngine
from .training.config import TrainConfig
from .training.data import ArrayDataset
from .training.duration_trainer import DurationPredictorTrainer
from .training.seq2seq_trainer import TextToSemanticTrainer
from .training.trainer import VoiceBoxTrainer

__version__ = "0.1.0"

__all__ = [
    "ArrayDataset",
    "ConditionalFlowMatcherWrapper",
    "DurationPredictor",
    "DurationPredictorTrainer",
    "DynamicBatcher",
    "EncodecVoco",
    "HubertWithKmeans",
    "MelVoco",
    "TTSEngine",
    "TextToSemantic",
    "TextToSemanticTrainer",
    "TrainConfig",
    "Transformer",
    "Vocos",
    "VoiceBox",
    "VoiceBoxTrainer",
]
