"""Training on latents: the optimizer, the data pipeline, checkpoints, the
trainer and its config."""

from .config import MeshConfig, TrainConfig
from .data import ArrayDataset, PrefetchLoader
from .trainer import VoiceBoxTrainer

__all__ = ["ArrayDataset", "MeshConfig", "PrefetchLoader", "TrainConfig", "VoiceBoxTrainer"]
