"""A minimal HTTP text-to-speech server on the port, standard library only.

`TTSEngine` (every bucket warmed before the first request) behind
`DynamicBatcher` (concurrent requests coalesce into batched calls on one
worker thread) behind a threading HTTP server: every concurrent POST is a
server thread of its own, and the batcher funnels them onto the device. The
engine carries a MelVoco codec and a Vocos vocoder, so a response is WAV
audio, and voice cloning has its own endpoint (`DynamicBatcher.submit_clone`:
the prompt conditions the first infilling window, as the reference's
`sample(cond=prompt_audio, texts=...)`). Counterpart of
`examples/serve_http.py`, with the same geometry, routes and bodies; the
denoiser computes in bf16 on the card. Unlike the JAX copy, a request the
engine refuses (a prompt over the largest prompt bucket, a transcript over
the largest text bucket: its `ValueError`) is the client's fault and gets
400, not 500, and a body whose `Content-Length` is over `max_body_bytes`
gets 413 before a byte of it is read.

    python3 -m voicebox_tpu_torch.examples.serve_http [port]

    curl -s -X POST localhost:8080/synthesize -d '{"text": "hello world"}' \\
         -o out.wav
    # voice cloning: prompt_wav is base64 of a mono 16-bit 24 kHz WAV (< 4 s)
    curl -s -X POST localhost:8080/clone \\
         -d "{\\"text\\": \\"in the prompt's voice\\", \\
              \\"prompt_wav\\": \\"$(base64 -w0 prompt.wav)\\"}" -o cloned.wav
    curl -s localhost:8080/healthz

The weights are random, so the audio is noise; load a trained checkpoint
into the wrapper for speech.
"""

from __future__ import annotations

import base64
import io
import json
import sys
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

SAMPLE_RATE = 24000
MAX_BODY_BYTES = 1 << 20  # a 4 s prompt is ~256 KiB of base64


def build_engine(device="cuda", batch_buckets=(1, 2, 4), max_semantic_token_ids: int = 512):
    """The example's semantic-mode engine: a small HuBERT + k-means and
    TextToSemantic (fp32), and a VoiceBox of dim 256 and depth 4 over a
    small MelVoco, bf16 on the card and fp32 on the CPU, at torch's
    initialisation under seeds 0 and 1; long-form windows of 512 frames and
    raw prompts of up to 4 s."""
    from ..models.cfm import ConditionalFlowMatcherWrapper, resolve_device
    from ..models.codec import MelVoco
    from ..models.hubert import HubertWithKmeans
    from ..models.text_to_semantic import TextToSemantic
    from ..models.vocos import Vocos
    from ..models.voicebox import VoiceBox
    from ..serving import TTSEngine
    from ..utils.tokenizer import GraphemeTokenizer

    device = resolve_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    torch.manual_seed(0)
    w2v = HubertWithKmeans(num_clusters=500, dim=64, depth=2, heads=4).eval()
    tts = TextToSemantic(dim=128, source_depth=2, target_depth=2, heads=4, dim_head=32,
                         wav2vec=w2v, tokenizer=GraphemeTokenizer(), device=device).eval()
    torch.manual_seed(1)
    codec = MelVoco(vocos=Vocos(input_channels=100, dim=64, intermediate_dim=128,
                                num_layers=2))
    vb = VoiceBox(audio_enc_dec=codec, num_cond_tokens=500, dim_cond_emb=256, dim=256,
                  depth=4, dim_head=64, heads=4, num_register_tokens=8, attn_qk_norm=True,
                  condition_on_text=True, dtype=dtype)
    cfm = ConditionalFlowMatcherWrapper(vb, text_to_semantic=tts, device=device).eval()
    return TTSEngine(
        cfm, text_buckets=(32, 64), batch_buckets=batch_buckets,
        steps=3, max_semantic_token_ids=max_semantic_token_ids, spec_decode=False,
        long_window_frames=512, long_overlap_frames=64,
        prompt_seconds_buckets=(2.0, 4.0),
    )


def to_wav_bytes(x, sample_rate: int = SAMPLE_RATE) -> bytes:
    """Float waveform (array or tensor) -> 16-bit mono WAV bytes, peak
    normalised."""
    if torch.is_tensor(x):
        x = x.detach().float().cpu().numpy()
    x = np.asarray(x, np.float32).reshape(-1)
    peak = max(float(np.abs(x).max()), 1e-6)
    pcm = np.clip(x / peak, -1.0, 1.0)
    pcm16 = (pcm * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm16.tobytes())
    return buf.getvalue()


def wav_bytes_to_float(b: bytes) -> np.ndarray:
    """16-bit mono WAV bytes -> float waveform in [-1, 1]."""
    with wave.open(io.BytesIO(b), "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError("prompt must be mono 16-bit PCM WAV")
        if w.getframerate() != SAMPLE_RATE:
            raise ValueError(f"prompt must be {SAMPLE_RATE} Hz")
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    return pcm.astype(np.float32) / 32767.0


class _TooLarge(Exception):
    pass


def make_server(batcher, host: str = "0.0.0.0", port: int = 8080,
                max_body_bytes: int = MAX_BODY_BYTES) -> ThreadingHTTPServer:
    """A `ThreadingHTTPServer` bound to (host, port) that serves `batcher`:
    `POST /synthesize` {"text"} and `POST /clone` {"text", "prompt_wav":
    base64 WAV} answer WAV audio, `GET /healthz` the batcher's counts as
    JSON; a malformed body or a request the engine refuses (`ValueError`)
    gives 400, a `Content-Length` over `max_body_bytes` 413 (the body
    unread), any other failure 500, any other path 404. Port 0 binds a free
    port (`server.server_address`). The caller runs `serve_forever()` and,
    to stop, `shutdown()` and `server_close()`."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body: bytes, ctype="application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                stats = dict(batcher.stats, mean_occupancy=batcher.mean_occupancy)
                self._send(200, json.dumps(stats).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def _read_json(self):
            n = int(self.headers.get("Content-Length", 0))
            if n > max_body_bytes:
                raise _TooLarge(f"a body of {n} bytes is over the limit of {max_body_bytes}")
            return json.loads(self.rfile.read(n) or b"{}")

        def _refused(self, e: Exception) -> None:
            if isinstance(e, _TooLarge):
                self.close_connection = True  # the unread body stays unread
                self._send(413, f"payload too large: {e}".encode(), "text/plain")
            else:
                self._send(400, f"bad request: {e}".encode(), "text/plain")

        def _answer(self, run, what: str) -> None:
            try:
                clip = run()
            except ValueError as e:  # the engine refused the request: the client's fault
                self._send(400, f"bad request: {e}".encode(), "text/plain")
                return
            except Exception as e:
                self._send(500, f"{what} failed: {e}".encode(), "text/plain")
                return
            self._send(200, to_wav_bytes(clip), "audio/wav")

        def do_POST(self):
            if self.path == "/synthesize":
                try:
                    text = self._read_json()["text"]
                except Exception as e:
                    self._refused(e)
                    return
                self._answer(lambda: batcher.synthesize(text, timeout=600), "synthesis")
            elif self.path == "/clone":
                try:
                    req = self._read_json()
                    text = req["text"]
                    prompt = wav_bytes_to_float(base64.b64decode(req["prompt_wav"]))
                except Exception as e:
                    self._refused(e)
                    return
                self._answer(lambda: batcher.submit_clone(text, prompt[None, :])
                             .result(timeout=600), "cloning")
            else:
                self._send(404, b"not found", "text/plain")

    return ThreadingHTTPServer((host, port), Handler)


def main():
    from ..serving import DynamicBatcher

    port = int(sys.argv[1]) if len(sys.argv) > 1 else 8080
    print("building engine...", flush=True)
    engine = build_engine()
    print(f"warmup: {engine.warmup():.1f}s", flush=True)
    batcher = DynamicBatcher(engine, max_wait_ms=10.0)
    server = make_server(batcher, port=port)
    print(f"serving on :{port}  (POST /synthesize, POST /clone, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
