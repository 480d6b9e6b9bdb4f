"""Training on latents: the optimizer, the data pipeline and the trainer."""

from .data import ArrayDataset
from .trainer import VoiceBoxTrainer

__all__ = ["ArrayDataset", "VoiceBoxTrainer"]
