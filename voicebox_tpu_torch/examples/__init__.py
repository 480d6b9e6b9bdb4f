"""Runnable examples on the port, counterparts of the scripts in `examples/`.

Each is a module with a `main()`, run as

    python3 -m voicebox_tpu_torch.examples.<name> [--device cpu]

on the card by default. Nothing runs when a module is imported.

* `serve_http`: a stdlib HTTP server over `TTSEngine` and `DynamicBatcher`
  (`build_engine`, `make_server`, `to_wav_bytes`, `wav_bytes_to_float`);
* `train_unconditional`: `VoiceBoxTrainer` on latents;
* `train_tts_pipeline`: the seq2seq, the duration predictor and the
  denoiser trained from a folder of (audio, transcript) files, then a
  sample through the trained stages;
* `text_to_speech`: the full-width semantic pipeline on random weights;
* `voice_cloning`: served cloning from a 3 s prompt, whole and streamed;
* `long_form_tts`: windowed `sample_long` over ~40 s with a prompt;
* `resume_from_reference`: a reference trainer's `.pt` resumed mid-run;
* `lora_finetune`: rank-8 adapters on a frozen base, then folded and
  sampled.
"""
