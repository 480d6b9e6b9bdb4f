"""Training: the optimizer, the data pipeline, checkpoints, the trainers'
shared core, the VoiceBox, duration-predictor and text -> semantic trainers
and the VoiceBox trainer's config."""

from .base import StageTrainer, TrainerBase
from .config import MeshConfig, TrainConfig
from .data import ArrayDataset, PairedDataset, PrefetchLoader
from .duration_trainer import DurationPredictorTrainer
from .seq2seq_trainer import TextToSemanticTrainer
from .trainer import VoiceBoxTrainer

__all__ = ["ArrayDataset", "DurationPredictorTrainer", "MeshConfig", "PairedDataset",
           "PrefetchLoader", "StageTrainer", "TextToSemanticTrainer", "TrainConfig",
           "TrainerBase", "VoiceBoxTrainer"]
