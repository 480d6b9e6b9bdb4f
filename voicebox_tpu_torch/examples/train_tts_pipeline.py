"""Train every trainable stage of the TTS pipeline from a folder of audio
files and transcripts, then synthesize: the from-scratch path a user takes
when no pretrained seq2seq or duration checkpoints exist.

  1. `TextToSemanticTrainer` on `SpeechTextDataset(folder)`: (text, wave)
     pairs, the semantic targets derived per batch through the frozen
     `HubertWithKmeans`;
  2. `DurationPredictorTrainer` on the same (text, wave) pairs: the codec
     attached to the predictor encodes the waves, its latents the aligner's
     input;
  3. `VoiceBoxTrainer` on `AudioDataset(folder)`: waves encoded by the codec,
     their conditioning ids through the wav2vec;
  4. `cfm.sample` conditioned on the trained seq2seq's ids.

Without `--corpus` it writes a tiny synthetic corpus (16 kHz 16-bit WAV +
`.txt`, the LibriTTS / LJSpeech layout) into a temporary folder and trains
on it, with a random-init tiny HuBERT and a toy linear codec, so it runs
anywhere. Counterpart of `examples/train_tts_pipeline.py`; its heads are 16
wide where the JAX script's are 8, since the attention kernels take head
dims 16 to 128.

    python3 -m voicebox_tpu_torch.examples.train_tts_pipeline [--device cpu] \\
        [--corpus DIR --audio-extension .flac]
"""

from __future__ import annotations

import argparse
import tempfile
import wave
from pathlib import Path

import numpy as np
import torch

from ..models.codec import AudioEncoderDecoder

SAMPLE_RATE = 16000


class LinearCodec(AudioEncoderDecoder):
    """A toy invertible codec (a strided orthogonal projection) standing in
    for MelVoco / EncodecVoco, so the example needs no vocoder weights; also
    the smallest template of a custom codec: the trainers and the sampler use
    only this interface."""

    sampling_rate = SAMPLE_RATE
    latent_dim = 16
    downsample_factor = 320

    def __init__(self):
        super().__init__()
        q, _ = np.linalg.qr(np.random.RandomState(7).randn(320, 320))
        self.register_buffer("proj", torch.from_numpy(q[:, :self.latent_dim].astype(np.float32)))

    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        audio = audio.reshape(audio.shape[0], -1)
        b, n = audio.shape
        return audio.reshape(b, n // self.downsample_factor, self.downsample_factor) @ self.proj

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        return (latents @ self.proj.T).reshape(latents.shape[0], -1)


def write_corpus(folder, n: int = 16, seed: int = 0) -> Path:
    """`n` (16 kHz mono 16-bit WAV, transcript) pairs of random lengths."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(seed)
    for i in range(n):
        pcm = (rs.randn(rs.randint(10, 20) * 320) * 0.1 * 32767).astype("<i2")
        with wave.open(str(folder / f"utt{i:03d}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SAMPLE_RATE)
            w.writeframes(pcm.tobytes())
        (folder / f"utt{i:03d}.txt").write_text(f"utterance number {i}\n")
    return folder


def main(argv=None):
    from ..models.cfm import ConditionalFlowMatcherWrapper, resolve_device
    from ..models.duration import DurationPredictor
    from ..models.hubert import HubertWithKmeans
    from ..models.text_to_semantic import TextToSemantic
    from ..models.voicebox import VoiceBox
    from ..training.data import AudioDataset, SpeechTextDataset
    from ..training.duration_trainer import DurationPredictorTrainer
    from ..training.seq2seq_trainer import TextToSemanticTrainer
    from ..training.trainer import VoiceBoxTrainer

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--corpus", default=None, help="folder of audio files and .txt transcripts")
    ap.add_argument("--audio-extension", default=".wav")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = Path(tempfile.mkdtemp(prefix="tts_pipeline_"))
    corpus = Path(args.corpus) if args.corpus else write_corpus(out / "corpus")
    pairs = SpeechTextDataset(corpus, audio_extension=args.audio_extension,
                              sample_rate=SAMPLE_RATE)
    n_clusters = 24
    codec = LinearCodec()
    torch.manual_seed(0)
    # the frozen feature model (random-init here; load a real one with
    # HubertWithKmeans(checkpoint_path=..., kmeans_path=...))
    wav2vec = HubertWithKmeans(num_clusters=n_clusters, conv_dim=8, dim=16, depth=1,
                               heads=2).eval()

    # stage 1: text -> semantic
    t2s = TextToSemantic(dim=32, source_depth=2, target_depth=1, heads=2, dim_head=16,
                         wav2vec=wav2vec, device=device)
    TextToSemanticTrainer(
        t2s, batch_size=4, dataset=pairs, num_train_steps=20, valid_frac=0.25,
        results_folder=str(out / "t2s"), text_bucket_multiple=16, semantic_bucket_multiple=2,
        prefetch_batches=0, device=device,
    ).train()

    # stage 2: phoneme durations
    dp = DurationPredictor(dim_phoneme_emb=16, dim=32, depth=2, dim_head=16, heads=2,
                           aligner_dim_in=codec.latent_dim,
                           aligner_attn_channels=codec.latent_dim, audio_enc_dec=codec)
    DurationPredictorTrainer(
        dp, batch_size=4, dataset=pairs, num_train_steps=20, valid_frac=0.25,
        results_folder=str(out / "dur"), phoneme_bucket_multiple=8, frame_bucket_multiple=8,
        prefetch_batches=0, device=device,
    ).train()

    # stage 3: the CFM denoiser on the raw waves: the trainer encodes them
    # through the codec and derives the conditioning ids through
    # t2s.wav2vec, the reference's training flow (voicebox_pytorch.py:1356-1389)
    vb = VoiceBox(audio_enc_dec=codec, dim=32, depth=2, dim_head=16, heads=2,
                  num_cond_tokens=n_clusters + 1, dim_cond_emb=16, condition_on_text=True)
    cfm = ConditionalFlowMatcherWrapper(vb, text_to_semantic=t2s, device=device)
    VoiceBoxTrainer(
        cfm, batch_size=4,
        dataset=AudioDataset(corpus, audio_extension=args.audio_extension,
                             sample_rate=SAMPLE_RATE),
        num_train_steps=20, valid_frac=0.25, results_folder=str(out / "cfm"),
        bucket_multiple=320 * 4, device=device,
    ).train()

    # synthesis through the trained stages
    ids, mask = t2s.generate(["utterance number three"], max_length=16,
                             return_target_mask=True)
    audio = cfm.sample(semantic_token_ids=ids, steps=3)
    print("synthesized audio:", tuple(audio.shape),
          "finite:", bool(torch.isfinite(audio).all()))
    print("artifacts under", out)


if __name__ == "__main__":
    main()
