"""The full text -> speech pipeline at the published widths (BASELINE
config 5; the reference README.md:39-98): HuBERT-base + k-means semantic
ids, a TextToSemantic of dim 512 with 6 + 6 layers, a conditional VoiceBox
of dim 512 and depth 8, and the EncodecVoco decode, on random weights: one
training loss on raw audio (ids through the frozen wav2vec), then one
speculatively decoded text -> speech sample. Counterpart of
`examples/text_to_speech.py`.

    python3 -m voicebox_tpu_torch.examples.text_to_speech [--device cpu]
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None):
    from ..models.cfm import ConditionalFlowMatcherWrapper, resolve_device
    from ..models.codec import EncodecVoco
    from ..models.hubert import HubertWithKmeans
    from ..models.text_to_semantic import TextToSemantic
    from ..models.voicebox import VoiceBox

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.manual_seed(0)
    wav2vec = HubertWithKmeans(num_clusters=500).eval()
    text_to_semantic = TextToSemantic(dim=512, source_depth=6, target_depth=6,
                                      wav2vec=wav2vec, device=device)
    torch.manual_seed(1)
    model = VoiceBox(audio_enc_dec=EncodecVoco(), num_cond_tokens=500, dim=512, depth=8,
                     condition_on_text=True)
    cfm_wrapper = ConditionalFlowMatcherWrapper(model, text_to_semantic=text_to_semantic,
                                                cond_drop_prob=0.2, device=device)

    # training on raw audio: the semantic ids come from the frozen wav2vec
    gen = torch.Generator(device=device).manual_seed(2)
    audio = torch.randn(2, 24000, generator=gen, device=device) * 0.1
    loss = cfm_wrapper(audio, generator=gen)
    print("train loss:", loss.detach().item())

    # text -> speech, with speculative decoding of the text -> semantic stage
    cfm_wrapper.eval()
    wave = cfm_wrapper.sample(
        texts=["the quick brown fox jumps over the lazy dog"], steps=3, cond_scale=1.3,
        max_semantic_token_ids=256, spec_decode=True, generator=gen,
    )
    print("synthesised audio:", tuple(wave.shape), "finite:", bool(torch.isfinite(wave).all()))


if __name__ == "__main__":
    main()
