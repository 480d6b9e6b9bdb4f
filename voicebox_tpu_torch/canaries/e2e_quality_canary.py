"""End-to-end quality canary on the north-star metric, mel-spectral distance.

The port's copy of `benchmarks/e2e_quality_canary.py`. It overfits the full
text -> speech pipeline (text -> TextToSemantic -> semantic ids, a HuBERT
k-means vocabulary fit on the corpus -> CFM denoiser -> log-mel latents) on
a synthetic corpus of four melodies, samples each utterance from its text
alone and scores the mean over frames of the L2 distance between generated
and true log-mel frames (`utils/metrics.py::mel_spectral_distance`'s inner
computation, in the MelVoco latent space, so no vocoder enters the score).
Two anchors give its scale: the same geometry untrained (a fresh model at
seed 99, chance) and the corpus's cross-utterance distance.

Run on the card: `python3 -m voicebox_tpu_torch.canaries.e2e_quality_canary`
(`--device cpu` for the CPU). Optimisers are `torch.optim.Adam` with
optax.adam's defaults (betas 0.9 / 0.999, eps 1e-8 outside the square
root), as the JAX script trains. The port keeps torch's default
initialisation (the reference's), not flax's, so its untrained anchor
differs from the JAX package's; the gates are relative to the port's own.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models.cfm import ConditionalFlowMatcherWrapper, resolve_device
from ..models.hubert import HubertWithKmeans
from ..models.text_to_semantic import TextToSemantic
from ..models.voicebox import VoiceBox
from ..ops.stft import amplitude_to_db, mel_spectrogram
from ..utils.tokenizer import GraphemeTokenizer

__all__ = ["NOTE_FREQS", "NOTE_S", "TEXTS", "build_and_train", "cross_utterance",
           "log_mel_latents", "main", "mel_msd", "sample_from_text", "seeded", "stretch_ids",
           "sync_device", "synth", "train_semantic_pipeline", "train_steps", "untrained_cfm"]

# --- synthetic corpus: 4-note melodies, analytic at both sample rates -----

NOTE_FREQS = {
    "c": 261.6, "d": 293.7, "e": 329.6, "f": 349.2,
    "g": 392.0, "a": 440.0, "b": 493.9, "h": 523.3,
}
TEXTS = ["c e g h", "g e c e", "a f d f", "h g e c"]
NOTE_S = 0.2  # seconds per note

# the canary's denoiser: log-mel latents in, 2 registers, 4 x 32 heads
DENOISER = dict(dim=128, depth=4, dim_head=32, heads=4, dim_cond_emb=64,
                num_register_tokens=2, condition_on_text=True)
ANCHOR_SEED = 99  # the untrained anchor's weights
SAMPLE_SEED = 42  # the sampler's noise


def synth(text: str, sr: int) -> np.ndarray:
    """Melody -> waveform with harmonics + vibrato (spectrally non-trivial)."""
    notes = text.split()
    n = int(NOTE_S * sr)
    t = np.arange(n) / sr
    out = []
    for i, name in enumerate(notes):
        f = NOTE_FREQS[name]
        vib = 1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t + i)
        w = (
            0.6 * np.sin(2 * np.pi * f * vib * t)
            + 0.25 * np.sin(2 * np.pi * 2 * f * t)
            + 0.1 * np.sin(2 * np.pi * 3 * f * t)
        )
        env = np.minimum(1.0, np.minimum(t / 0.02, (NOTE_S - t) / 0.05))
        out.append((w * env).astype(np.float32))
    return np.concatenate(out)


def log_mel_latents(wavs24, n_mels: int = 40) -> torch.Tensor:
    """(b, n) 24 kHz -> (b, frames, n_mels) log-mel latents (the MelVoco
    latent layout), on the wave's device."""
    mel = mel_spectrogram(
        torch.as_tensor(wavs24), n_mels=n_mels, sample_rate=24000,
        f_max=8000.0, n_fft=512, win_length=400, hop_length=160,
    )
    return amplitude_to_db(mel).transpose(1, 2)


def mel_msd(lat_a, lat_b) -> float:
    """mel_spectral_distance's inner computation on (b, frames, mels)
    latents: mean over frames of the L2 across mel bins."""
    lat_a, lat_b = torch.as_tensor(lat_a), torch.as_tensor(lat_b)
    n = min(lat_a.shape[1], lat_b.shape[1])
    d = (lat_a[:, :n].double() - lat_b[:, :n].double().to(lat_a.device)).square().sum(-1).sqrt()
    return float(d.mean())


def cross_utterance(gt) -> float:
    """The corpus's cross-utterance anchor: each utterance against the next."""
    return mel_msd(gt, torch.roll(torch.as_tensor(gt), 1, dims=0))


def stretch_ids(ids, n_frames: int):
    """(b, m) -> (b, n_frames) nearest-neighbour stretch (the id -> latent
    frame mapping of the long-form sampler); numpy or torch in, same out."""
    m = ids.shape[1]
    idx = np.minimum((np.arange(n_frames) * m) // n_frames, m - 1)
    if torch.is_tensor(ids):
        return ids[:, torch.from_numpy(idx).to(ids.device)]
    return ids[:, idx]


def seeded(build, seed: int):
    """Build modules with torch's default initialisation under `seed`,
    without touching the caller's random state."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def sync_device(device) -> None:
    """Wait for the card's queued work, so that a host clock times it."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def train_steps(loss_fn, params, lr: float, steps: int, device, stop_below=None,
                check_every: int = 0, verbose=None):
    """`steps` Adam updates (optax.adam's defaults) of `params` on
    `loss_fn()`. With `check_every`, the loss is read on the host every that
    many steps (step 0 included) and the loop stops once it is under
    `stop_below`; otherwise only the last loss is read. Returns (last loss,
    steps taken, wall seconds)."""
    params = list(params)
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    sync_device(device)
    t0 = time.perf_counter()
    loss, taken = None, 0
    for step in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        opt.step()
        taken = step + 1
        if check_every and step % check_every == 0:
            value = float(loss.detach())
            if verbose is not None:
                verbose(f"step {step}: loss {value:.4f}")
            if stop_below is not None and value < stop_below:
                break
    value = float(loss.detach())
    sync_device(device)
    return value, taken, time.perf_counter() - t0


def _denoiser(n_mels: int, num_cond_tokens: int, seed: int) -> VoiceBox:
    return seeded(lambda: VoiceBox(dim_in=n_mels, num_cond_tokens=num_cond_tokens, **DENOISER),
                  seed)


def untrained_cfm(pipe, seed: int = ANCHOR_SEED) -> ConditionalFlowMatcherWrapper:
    """The untrained anchor: a fresh denoiser of the pipeline's geometry at
    `seed`, behind the pipeline's own text front end. The trained one is
    left as it is."""
    cfm = pipe["cfm"]
    vb = _denoiser(pipe["n_mels"], cfm.voicebox.num_cond_tokens, seed)
    front = dict(text_to_semantic=cfm.text_to_semantic, duration_predictor=cfm.duration_predictor)
    return ConditionalFlowMatcherWrapper(vb, cond_drop_prob=cfm.cond_drop_prob,
                                         device=pipe["device"], **front)


def train_semantic_pipeline(texts, wav16, gt, tts_steps: int, cfm_steps: int,
                            num_clusters: int, seed: int, device, verbose=print) -> dict:
    """Fit the k-means vocabulary on `wav16`'s HuBERT features, train the
    seq2seq from `texts` to their ids, then the CFM on the `gt` latents
    conditioned on the ids stretched to the frame rate. Returns the pipeline
    dict."""
    b, n_frames, n_mels = gt.shape
    # frozen HuBERT features + corpus-fit k-means vocabulary
    w2v = seeded(lambda: HubertWithKmeans(num_clusters=num_clusters, dim=32, depth=2,
                                          heads=4), seed).to(device)
    w2v.fit_kmeans(wavs=wav16, generator=torch.Generator(device).manual_seed(seed), iters=25)
    sem_ids = w2v(wav16)  # (b, ~39)
    verbose(f"semantic ids: {tuple(sem_ids.shape)}, "
            f"{len(torch.unique(sem_ids))}/{num_clusters} clusters used")

    # text -> semantic seq2seq, overfit
    tok = GraphemeTokenizer()
    tts = seeded(lambda: TextToSemantic(dim=64, source_depth=2, target_depth=2, heads=4,
                                        dim_head=16, wav2vec=w2v, tokenizer=tok,
                                        device=device), seed + 1)
    text_ids = torch.from_numpy(tok.texts_to_tensor_ids(texts)).to(device).long()
    tl, _, tts_s = train_steps(lambda: tts.loss_fn(text_ids, sem_ids), tts.parameters(), 3e-3,
                               tts_steps, device)
    verbose(f"tts loss after {tts_steps} steps: {tl:.4f} ({tts_steps / tts_s:.1f} steps/s)")

    # CFM denoiser in log-mel latent space (the raw dB latents, as the JAX
    # script measured best), ids pre-stretched to frame rate
    ids_frames = stretch_ids(sem_ids, n_frames)
    vb = _denoiser(n_mels, num_clusters, seed + 2)
    cfm = ConditionalFlowMatcherWrapper(vb, text_to_semantic=tts, cond_drop_prob=0.1,
                                        device=device)
    gen = torch.Generator(device).manual_seed(seed + 3)
    cl, _, cfm_s = train_steps(
        lambda: cfm.loss_fn(gt, cond_token_ids=ids_frames, generator=gen), vb.parameters(),
        1e-3, cfm_steps, device)
    verbose(f"cfm loss after {cfm_steps} steps: {cl:.4f} ({cfm_steps / cfm_s:.1f} steps/s)")
    return {"cfm": cfm, "tts": tts, "tok": tok, "w2v": w2v, "n_frames": n_frames,
            "n_mels": n_mels, "device": device,
            "train": {"tts": (tts_steps, tts_s, tl), "cfm": (cfm_steps, cfm_s, cl)}}


def build_and_train(tts_steps: int = 400, cfm_steps: int = 2000, num_clusters: int = 12,
                    seed: int = 0, device="cuda", verbose=print):
    """Returns (pipeline dict, gt latents (4, frames, 40)). Tiny models, the
    full stack, trained from scratch on `device`."""
    device = resolve_device(device)
    wav24 = np.stack([synth(t, 24000) for t in TEXTS])
    wav16 = torch.from_numpy(np.stack([synth(t, 16000) for t in TEXTS])).to(device)
    gt = log_mel_latents(torch.from_numpy(wav24).to(device))  # (4, frames, 40)
    pipe = train_semantic_pipeline(TEXTS, wav16, gt, tts_steps, cfm_steps, num_clusters, seed,
                                   device, verbose)
    return pipe, gt


def sample_from_text(pipe, cfm=None, texts=TEXTS, steps: int = 16, cond_scale: float = 1.0,
                     generator=None, noise=None, quantize=None) -> torch.Tensor:
    """TEXT -> generated log-mel latents (b, frames, mels) through the whole
    trained stack, one text at a time: greedy ids to the first eos, their
    valid prefix stretched to the frame rate, an ODE solve from y0. `cfm`
    replaces the pipeline's denoiser (the untrained anchor); y0 of text i is
    `noise[i]` or a draw from `generator` (default: seeded 42 on the
    pipeline's device)."""
    cfm = cfm if cfm is not None else pipe["cfm"]
    tts, device = pipe["tts"], pipe["device"]
    n_frames, n_mels = pipe["n_frames"], pipe["n_mels"]
    if generator is None and noise is None:
        generator = torch.Generator(device).manual_seed(SAMPLE_SEED)
    outs = []
    for i, t in enumerate(texts):
        ids, mask = tts.generate([t], max_length=48, return_target_mask=True)
        n_valid = max(int(mask[0].sum()), 1)
        ids_f = stretch_ids(torch.where(mask, ids, 0)[:, :n_valid], n_frames)
        outs.append(cfm.sample(
            cond=torch.zeros(1, n_frames, n_mels, device=device), semantic_token_ids=ids_f,
            ids_at_frame_rate=True, steps=steps, cond_scale=cond_scale, decode_to_audio=False,
            noise=None if noise is None else noise[i], generator=generator, quantize=quantize,
        ))
    return torch.cat(outs, dim=0)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    pipe, gt = build_and_train(device=args.device)
    msd = mel_msd(sample_from_text(pipe), gt)
    msd0 = mel_msd(sample_from_text(pipe, cfm=untrained_cfm(pipe)), gt)
    cross = cross_utterance(gt)
    print(f"mel-spectral distance, trained pipeline (text->speech): {msd:.2f} dB/frame")
    print(f"  untrained anchor: {msd0:.2f}   cross-utterance anchor: {cross:.2f}")
    result = {"metric": "e2e_mel_spectral_distance", "value": msd, "unit": "dB L2/frame",
              "untrained": msd0, "cross_utterance": cross, "device": str(pipe["device"])}
    print(result)
    return result


if __name__ == "__main__":
    main()
