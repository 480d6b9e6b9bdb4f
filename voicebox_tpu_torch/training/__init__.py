"""Training: the optimizer, the data pipeline (in-memory and file-backed
datasets), checkpoints, the trainers' shared core, the VoiceBox,
duration-predictor and text -> semantic trainers and the VoiceBox
trainer's config."""

from .base import StageTrainer, TrainerBase
from .config import MeshConfig, TrainConfig
from .data import (ArrayDataset, AudioDataset, PairedDataset, PrefetchLoader,
                   SpeechTextDataset)
from .duration_trainer import DurationPredictorTrainer
from .seq2seq_trainer import TextToSemanticTrainer
from .trainer import VoiceBoxTrainer

__all__ = ["ArrayDataset", "AudioDataset", "DurationPredictorTrainer", "MeshConfig",
           "PairedDataset", "PrefetchLoader", "SpeechTextDataset", "StageTrainer",
           "TextToSemanticTrainer", "TrainConfig", "TrainerBase", "VoiceBoxTrainer"]
