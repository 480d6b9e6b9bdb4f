"""DurationPredictorTrainer: train the phoneme-duration model end to end.

Counterpart of `voicebox_tpu/training/duration_trainer.py`, on
`StageTrainer`'s loop (AdamW under warmup -> cosine, accumulation, the
fp32 clip, the optional EMA, validation, checkpoints). A step runs
`DurationPredictor.loss_fn`: on the card the transformer's attention runs
K1 forward and K2 + K3 backward in fp32, MAS (`ops/mas.py`) runs as torch
ops over the frame axis, and the forward-sum loss is `F.ctc_loss`.

Dataset items are tuples:

* `(text | phoneme_ids, wave)`: the codec attached to the predictor
  encodes the waves (no gradient) to conditioning latents, with frame masks
  from `ceil(len / downsample)`; the aligner's mel is the latents when
  `latent_dim == aligner_dim_in` (the MelVoco case), else a log-mel at
  `n_mels=aligner_dim_in` on the codec's hop grid;
* `(text | phoneme_ids, latents)`: conditioning latents (n, latent_dim),
  doubling as the aligner's mel (the widths must match);
* `(text | phoneme_ids, wave | latents, mel)`: an explicit aligner mel
  (n_mel, aligner_dim_in).

Texts are tokenized once, on the host, by the predictor's tokenizer; ids
pad with -1. Each field buckets on its own grid: phonemes to a multiple of
`phoneme_bucket_multiple`, latents and mels of `frame_bucket_multiple`
frames, waves of `frame_bucket_multiple * downsample` samples.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.codec import frame_mask
from ..ops.stft import amplitude_to_db, mel_spectrogram
from .base import StageTrainer

__all__ = ["DurationPredictorTrainer"]


class DurationPredictorTrainer(StageTrainer):
    project_name = "duration_predictor"
    ckpt_prefix = "duration"
    state_prefix = "duration_predictor."

    def __init__(
        self,
        duration_predictor,
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
        phoneme_bucket_multiple: int = 16,
        frame_bucket_multiple: int = 128,
        max_phoneme_len: Optional[int] = None,
        max_frame_len: Optional[int] = None,
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
        self.dp = duration_predictor
        self._setup_core(
            module=duration_predictor, num_train_steps=num_train_steps,
            num_warmup_steps=num_warmup_steps, lr=lr, initial_lr=initial_lr, wd=wd,
            max_grad_norm=max_grad_norm, moment_dtype=moment_dtype, ema_decay=ema_decay,
            ema_dtype=ema_dtype, log_every=log_every, save_results_every=save_results_every,
            save_model_every=save_model_every, results_folder=results_folder,
            force_clear_prev_results=force_clear_prev_results,
            checkpoint_backend=checkpoint_backend, trackers=trackers, seed=seed, device=device,
            batch_size=batch_size, mesh=mesh, use_mesh=use_mesh, split_batches=split_batches,
        )

        probe = dataset[0]
        if len(probe) not in (2, 3):
            raise ValueError("items must be (phonemes, wave | latents[, mel])")
        self._has_explicit_mel = len(probe) == 3
        second = np.asarray(probe[1])
        self._cond_is_wave = second.ndim == 1
        codec = duration_predictor.audio_enc_dec
        aligner_dim = int(duration_predictor.aligner_dim_in)
        if self._cond_is_wave:
            if codec is None:
                raise ValueError("wave datasets need the predictor's audio_enc_dec to encode "
                                 "the conditioning latents")
            codec.to(self.device)
            ds_factor = int(codec.downsample_factor)
            cond_multiple = frame_bucket_multiple * ds_factor
            max_cond_len = max_frame_len * ds_factor if max_frame_len is not None else None
            self._derive_mel = (not self._has_explicit_mel
                                and int(codec.latent_dim) != aligner_dim)
        else:
            if second.ndim != 2:
                raise ValueError("latents must be (n, latent_dim)")
            cond_multiple, max_cond_len = frame_bucket_multiple, max_frame_len
            self._derive_mel = False
            if not self._has_explicit_mel and second.shape[-1] != aligner_dim:
                raise ValueError(
                    f"2-field latent items reuse the latents as the aligner mel, but latent "
                    f"dim {second.shape[-1]} != aligner_dim_in {aligner_dim}; add a mel field"
                )
        multiples, pads, maxes = [phoneme_bucket_multiple, cond_multiple], [-1, 0.0], [
            max_phoneme_len, max_cond_len]
        if self._has_explicit_mel:
            multiples.append(frame_bucket_multiple)
            pads.append(0.0)
            maxes.append(max_frame_len)
        self._setup_paired_loaders(
            dataset, duration_predictor.tokenizer, batch_size=batch_size,
            grad_accum_every=grad_accum_every, valid_frac=valid_frac,
            random_split_seed=random_split_seed, seed=seed, bucket_multiples=multiples,
            pad_values=pads, max_lengths=maxes, prefetch_batches=prefetch_batches,
        )
        self._log_init_hps()

    def _aligner_mel(self, waves: torch.Tensor) -> torch.Tensor:
        """Log-mel (b, frames, aligner_dim_in) on the codec's hop grid."""
        codec = self.dp.audio_enc_dec
        mel = mel_spectrogram(waves, n_mels=int(self.dp.aligner_dim_in),
                              sample_rate=int(codec.sampling_rate),
                              hop_length=int(codec.downsample_factor))
        return amplitude_to_db(mel).transpose(1, 2)

    @torch.no_grad()
    def _prepare_batch(self, fields) -> dict:
        (ph_ids, ph_mask), (second, second_mask) = fields[0], fields[1]
        ph_ids, ph_mask = self._put(ph_ids, torch.int64), self._put(ph_mask, torch.bool)
        second, second_mask = self._put(second, torch.float32), self._put(second_mask, torch.bool)
        if self._cond_is_wave:
            cond = self.dp.audio_enc_dec.encode(second)
            cond_frames = frame_mask(second_mask, cond.shape[1])
        else:
            cond, cond_frames = second, second_mask
        if self._has_explicit_mel:
            mel, mel_mask = self._put(fields[2][0], torch.float32), self._put(fields[2][1],
                                                                              torch.bool)
        elif self._derive_mel:
            mel = self._aligner_mel(second)
            mel_mask = frame_mask(second_mask, mel.shape[1])
        else:
            mel, mel_mask = cond, cond_frames
        return dict(phoneme_ids=ph_ids, cond=cond, mel=mel, phoneme_len=ph_mask.sum(dim=-1),
                    mel_len=mel_mask.sum(dim=-1), phoneme_mask=ph_mask, mel_mask=mel_mask)

    def _loss(self, batch: dict, generator, **draws) -> torch.Tensor:
        return self.dp.loss_fn(generator=generator, **batch, **draws)
