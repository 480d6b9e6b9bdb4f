"""Held-out generalization canary.

The port's copy of `benchmarks/e2e_generalization_canary.py`.
`e2e_quality_canary.py` overfits 4 utterances and samples the same texts;
this sibling splits a corpus of distinct melodies, trains the pipeline on
the train split only (the k-means vocabulary, the seq2seq and the CFM) and
scores mel-spectral distance on texts it never saw, against the same two
anchors. Two held-out numbers:

* full pipeline: text -> `generate` -> CFM (the product path);
* oracle ids: the held-out utterances' own semantic ids -> CFM (the CFM's
  generalization apart from the seq2seq's).

`main_duration` runs the duration pipeline on the same split, sampled
through `sample(texts=)`.

Run on the card: `python3 -m voicebox_tpu_torch.canaries.e2e_generalization_canary`
(`--duration` for the duration pipeline, `--device cpu` for the CPU).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models.cfm import resolve_device
from .e2e_quality_canary import (
    NOTE_FREQS,
    cross_utterance,
    log_mel_latents,
    mel_msd,
    sample_from_text,
    stretch_ids,
    synth,
    train_semantic_pipeline,
    untrained_cfm,
)
from .e2e_quality_canary_duration import sample_from_text_duration, train_duration_pipeline

__all__ = ["build_and_train_gen", "build_and_train_gen_duration", "main", "main_duration",
           "make_corpus", "sample_oracle_ids", "sample_texts", "sample_texts_duration"]

ORACLE_SEED = 43  # the oracle-id samples' noise


def make_corpus(n_train: int = 24, n_held: int = 8, seed: int = 0):
    """Distinct 4-note melodies over the 8-note vocabulary, split so the
    held-out TEXTS never appear in training (notes individually do: the
    point is generalization to unseen composition, not unseen phonemes)."""
    rs = np.random.RandomState(seed)
    names = sorted(NOTE_FREQS)
    texts = set()
    while len(texts) < n_train + n_held:
        texts.add(" ".join(rs.choice(names, 4)))
    texts = sorted(texts)
    rs.shuffle(texts)
    return texts[:n_train], texts[n_train: n_train + n_held]


def _split(n_train, n_held, seed, device):
    train_texts, held_texts = make_corpus(n_train, n_held, seed)
    waves = {}
    for split, texts in (("train", train_texts), ("held", held_texts)):
        for sr in (24000, 16000):
            waves[split, sr] = torch.from_numpy(np.stack([synth(t, sr) for t in texts])).to(device)
    return train_texts, held_texts, waves


def build_and_train_gen(n_train: int = 24, n_held: int = 8, tts_steps: int = 1000,
                        cfm_steps: int = 2000, num_clusters: int = 12, seed: int = 0,
                        device="cuda", verbose=print):
    """Train the full stack on the train split only. Returns (pipe,
    train_texts, held_texts, gt_train, gt_held); `pipe["sem_held"]` holds
    the held-out utterances' ids under the train split's vocabulary (the
    oracle)."""
    device = resolve_device(device)
    train_texts, held_texts, waves = _split(n_train, n_held, seed, device)
    gt_tr, gt_he = log_mel_latents(waves["train", 24000]), log_mel_latents(waves["held", 24000])
    pipe = train_semantic_pipeline(train_texts, waves["train", 16000], gt_tr, tts_steps,
                                   cfm_steps, num_clusters, seed, device, verbose)
    pipe["sem_held"] = pipe["w2v"](waves["held", 16000])  # eval oracle only
    return pipe, train_texts, held_texts, gt_tr, gt_he


def sample_texts(pipe, texts, cfm=None, steps: int = 16, cond_scale: float = 1.0,
                 generator=None):
    """texts -> generated log-mel latents through the full trained stack."""
    return sample_from_text(pipe, cfm=cfm, texts=texts, steps=steps, cond_scale=cond_scale,
                            generator=generator)


def sample_oracle_ids(pipe, sem_ids, cfm=None, steps: int = 16, generator=None):
    """Ground-truth semantic ids -> CFM samples, one batched call."""
    cfm = cfm if cfm is not None else pipe["cfm"]
    device, n_frames, n_mels = pipe["device"], pipe["n_frames"], pipe["n_mels"]
    if generator is None:
        generator = torch.Generator(device).manual_seed(ORACLE_SEED)
    return cfm.sample(cond=torch.zeros(sem_ids.shape[0], n_frames, n_mels, device=device),
                      semantic_token_ids=stretch_ids(sem_ids, n_frames), ids_at_frame_rate=True,
                      steps=steps, cond_scale=1.0, decode_to_audio=False, generator=generator)


def build_and_train_gen_duration(n_train: int = 24, n_held: int = 8, dp_steps: int = 800,
                                 cfm_steps: int = 2000, seed: int = 0, device="cuda",
                                 verbose=print):
    """The duration pipeline (BASELINE config 4) trained on the train split
    only. Returns (pipe, train_texts, held_texts, gt_train, gt_held)."""
    device = resolve_device(device)
    train_texts, held_texts, waves = _split(n_train, n_held, seed, device)
    gt_tr, gt_he = log_mel_latents(waves["train", 24000]), log_mel_latents(waves["held", 24000])
    pipe = train_duration_pipeline(train_texts, gt_tr, dp_steps, cfm_steps, seed, device,
                                   verbose)
    return pipe, train_texts, held_texts, gt_tr, gt_he


def sample_texts_duration(pipe, texts, cfm=None, steps: int = 16, cond_scale: float = 1.0,
                          generator=None):
    """texts -> log-mel latents through `sample(texts=)`'s duration branch."""
    return sample_from_text_duration(pipe, cfm=cfm, texts=texts, steps=steps,
                                     cond_scale=cond_scale, generator=generator)


def main_duration(device="cuda") -> dict:
    pipe, train_texts, held_texts, gt_tr, gt_he = build_and_train_gen_duration(device=device)
    msd_he = mel_msd(sample_texts_duration(pipe, held_texts), gt_he)
    msd_tr = mel_msd(sample_texts_duration(pipe, train_texts), gt_tr)
    msd0_he = mel_msd(sample_texts_duration(pipe, held_texts, cfm=untrained_cfm(pipe)), gt_he)
    cross_he = cross_utterance(gt_he)
    print(f"held-out mel-spectral distance (duration pipeline, UNSEEN texts): "
          f"{msd_he:.2f} dB/frame")
    print(f"  train-split: {msd_tr:.2f}   untrained anchor: {msd0_he:.2f}   "
          f"cross-utterance anchor: {cross_he:.2f}")
    result = {"metric": "e2e_heldout_mel_spectral_distance_duration", "value": msd_he,
              "unit": "dB L2/frame", "train_split": msd_tr, "untrained": msd0_he,
              "cross_utterance": cross_he, "device": str(pipe["device"])}
    print(result)
    return result


def main(device="cuda") -> dict:
    pipe, train_texts, held_texts, gt_tr, gt_he = build_and_train_gen(device=device)
    msd_he = mel_msd(sample_texts(pipe, held_texts), gt_he)
    msd_tr = mel_msd(sample_texts(pipe, train_texts), gt_tr)
    oracle_he = mel_msd(sample_oracle_ids(pipe, pipe["sem_held"]), gt_he)
    msd0_he = mel_msd(sample_texts(pipe, held_texts, cfm=untrained_cfm(pipe)), gt_he)
    cross_he = cross_utterance(gt_he)
    print(f"held-out mel-spectral distance (text->speech, UNSEEN texts): {msd_he:.2f} dB/frame")
    print(f"  train-split: {msd_tr:.2f}   oracle-id held-out: {oracle_he:.2f}")
    print(f"  untrained anchor (held-out): {msd0_he:.2f}   "
          f"cross-utterance anchor (held-out): {cross_he:.2f}")
    result = {"metric": "e2e_heldout_mel_spectral_distance", "value": msd_he,
              "unit": "dB L2/frame", "train_split": msd_tr, "oracle_ids_heldout": oracle_he,
              "untrained": msd0_he, "cross_utterance": cross_he, "device": str(pipe["device"])}
    print(result)
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--duration", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    (main_duration if args.duration else main)(args.device)
