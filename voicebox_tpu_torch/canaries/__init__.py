"""Trained-weight canaries: the whole pipeline trained from scratch on a
synthetic corpus and scored, the port's copies of the JAX package's
`benchmarks/` scripts.

* `e2e_quality_canary`: text -> TextToSemantic -> semantic ids (HuBERT
  k-means fit on the corpus) -> CFM -> log-mel latents, overfit on four
  melodies, sampled from text alone, scored by mel-spectral distance
  beside an untrained and a cross-utterance anchor;
* `e2e_quality_canary_duration`: the same through the DurationPredictor
  (NS2 aligner, MAS, forward-sum) and `sample(texts=, frame_length=)`;
* `e2e_generalization_canary`: a held-out split of distinct melodies;
* `spec_decode_trained`: the full-width TextToSemantic overfit on a
  deterministic pattern, decoded plainly, speculatively and under w8a16.

Each runs on the card by default (`python3 -m
voicebox_tpu_torch.canaries.<name>`) and on the CPU with `device="cpu"`.
Random draws come from explicit `torch.Generator`s and module weights from
torch's default initialisation under a fixed seed.
"""
