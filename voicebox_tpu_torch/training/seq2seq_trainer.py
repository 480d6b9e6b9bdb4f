"""TextToSemanticTrainer: train the text -> semantic seq2seq.

Counterpart of `voicebox_tpu/training/seq2seq_trainer.py`, on
`StageTrainer`'s loop (AdamW under warmup -> cosine, accumulation, the fp32
clip, the optional EMA, validation, checkpoints under `text_to_semantic.`).
A step runs `TextToSemantic.loss_fn`, the teacher-forced cross-entropy with
eos at each row's true length; on the card the encoder's attention runs K1
forward and K2 + K3 backward in fp32. The loss is a mean over the batch's
tokens, so under a mesh each rank's loss is weighted by its share of the
token count (`_loss_weight`).

Dataset items are 2-tuples of either

* `(text | text_ids, semantic_ids)`: integer targets, or
* `(text | text_ids, wave)`: float waves at `wav2vec.target_sample_hz`,
  whose ids come per batch from the frozen `t2s.wav2vec`; frames at or past
  a row's true frame count (`wav2vec.num_frames` of its unpadded length)
  are masked to -1, so padding never fabricates targets or moves eos.

The kind is read from the first item's second field. Texts are tokenized
once by the model's tokenizer; text ids pad with -1 and bucket to a
multiple of `text_bucket_multiple`, ids to `semantic_bucket_multiple`,
waves to `semantic_bucket_multiple * wav2vec.downsample_factor` samples.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .base import StageTrainer
from .trainer import swapped

__all__ = ["TextToSemanticTrainer"]


class TextToSemanticTrainer(StageTrainer):
    project_name = "text_to_semantic"
    ckpt_prefix = "text_to_semantic"
    state_prefix = "text_to_semantic."

    def __init__(
        self,
        t2s,
        *,
        batch_size: int,
        dataset,
        num_train_steps: Optional[int] = None,
        num_warmup_steps: Optional[int] = None,
        num_epochs: Optional[int] = None,
        lr: float = 3e-4,
        initial_lr: float = 1e-5,
        grad_accum_every: int = 1,
        wd: float = 0.0,
        moment_dtype=None,
        ema_decay: Optional[float] = None,
        ema_dtype=None,
        max_grad_norm: Optional[float] = 0.5,
        valid_frac: float = 0.05,
        random_split_seed: int = 42,
        log_every: int = 10,
        save_results_every: int = 100,
        save_model_every: Optional[int] = None,
        results_folder: Optional[str] = None,
        force_clear_prev_results: bool = False,
        mesh=None,
        use_mesh: bool = True,
        split_batches: Optional[bool] = None,
        seed: int = 0,
        text_bucket_multiple: int = 64,
        semantic_bucket_multiple: int = 128,
        max_text_len: Optional[int] = None,
        max_semantic_len: Optional[int] = None,
        prefetch_batches: int = 2,
        checkpoint_backend: str = "msgpack",
        trackers: tuple = (),
        device="cuda",
    ):
        if num_train_steps is None and num_epochs is None:
            raise ValueError("either num_train_steps or num_epochs must be specified")
        if num_epochs is not None:
            num_train_steps = self._steps_from_epochs(num_epochs, len(dataset), batch_size,
                                                      grad_accum_every, valid_frac)
        self.t2s = t2s
        self._setup_core(
            module=t2s, num_train_steps=num_train_steps, num_warmup_steps=num_warmup_steps,
            lr=lr, initial_lr=initial_lr, wd=wd, max_grad_norm=max_grad_norm,
            moment_dtype=moment_dtype, ema_decay=ema_decay, ema_dtype=ema_dtype,
            log_every=log_every, save_results_every=save_results_every,
            save_model_every=save_model_every, results_folder=results_folder,
            force_clear_prev_results=force_clear_prev_results,
            checkpoint_backend=checkpoint_backend, trackers=trackers, seed=seed, device=device,
            batch_size=batch_size, mesh=mesh, use_mesh=use_mesh, split_batches=split_batches,
        )

        probe = np.asarray(dataset[0][1])
        self._targets_are_waves = np.issubdtype(probe.dtype, np.floating)
        if self._targets_are_waves:
            if probe.ndim != 1:
                raise ValueError("a float second field must be a 1-D wave at "
                                 "wav2vec.target_sample_hz")
            if t2s.wav2vec is None:
                raise ValueError("(text, wave) datasets need t2s.wav2vec (HubertWithKmeans) "
                                 "to derive semantic-token targets")
            ds_factor = int(t2s.wav2vec.downsample_factor)
            target_multiple = semantic_bucket_multiple * ds_factor
            max_target_len = max_semantic_len * ds_factor if max_semantic_len else None
            pad_value = 0.0
        else:
            target_multiple, max_target_len, pad_value = (semantic_bucket_multiple,
                                                          max_semantic_len, -1)
        self._setup_paired_loaders(
            dataset, t2s.tokenizer, batch_size=batch_size, grad_accum_every=grad_accum_every,
            valid_frac=valid_frac, random_split_seed=random_split_seed, seed=seed,
            bucket_multiples=(text_bucket_multiple, target_multiple),
            pad_values=(-1, pad_value), max_lengths=(max_text_len, max_target_len),
            prefetch_batches=prefetch_batches,
        )
        self._log_init_hps()

    @torch.no_grad()
    def _derive_semantic_ids(self, waves: torch.Tensor, wave_mask) -> torch.Tensor:
        """(b, n_samples) padded waves -> (b, frames) ids, -1 at every frame
        at or past a row's true frame count."""
        wav2vec = self.t2s.wav2vec
        ids = wav2vec(waves)
        lengths = torch.as_tensor(wave_mask).sum(dim=-1).tolist()  # host-side
        frames = torch.tensor([wav2vec.num_frames(int(n)) for n in lengths], device=ids.device)
        live = torch.arange(ids.shape[1], device=ids.device)[None, :] < frames[:, None]
        return torch.where(live, ids, torch.full_like(ids, -1))

    def _prepare_batch(self, fields) -> dict:
        (text_ids, _), (target, target_mask) = fields
        text_ids = self._put(text_ids, torch.int64)
        if self._targets_are_waves:
            sem = self._derive_semantic_ids(self._put(target, torch.float32), target_mask)
        else:
            sem = self._put(target, torch.int64)
        return {"text_ids": text_ids, "semantic_ids": sem}

    def _loss(self, batch: dict, generator, **draws) -> torch.Tensor:
        return self.t2s.loss_fn(batch["text_ids"], batch["semantic_ids"])

    def _loss_weight(self, batch: dict) -> torch.Tensor:
        """The loss's token count: each row's ids and its eos."""
        ids = batch["semantic_ids"]
        return ((ids != -1).sum(dim=-1) + 1).sum()

    def generate(self, *args, use_ema: bool = False, **kwargs):
        """`t2s.generate` with the trained weights, or the EMA's."""
        if not use_ema:
            return self.t2s.generate(*args, **kwargs)
        if self.ema is None:
            raise ValueError("use_ema=True needs TextToSemanticTrainer(ema_decay=...)")
        with swapped(self.params, self.ema.shadow):
            return self.t2s.generate(*args, **kwargs)
