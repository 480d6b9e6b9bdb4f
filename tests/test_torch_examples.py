"""The port's examples (`voicebox_tpu_torch/examples/`): each module imports
no `jax` and nothing of `voicebox_tpu` (read with `ast`) and has a `main`;
`serve_http`'s server, on the CPU with a tiny semantic-mode engine behind
`make_server` on 127.0.0.1:0, answers `/synthesize` and `/clone` (sent
concurrently) and `/healthz` with 200, each WAV 24 kHz 16-bit mono with
samples, counts the requests, gives 400 for a malformed body and 404 for
an unknown path, and closes; a prompt over the engine's largest prompt
bucket gives 400 (the engine's `ValueError`, the client's fault) and a
body over `max_body_bytes` 413, the server answering on after both.
"""

import ast
import base64
import importlib
import io
import json
import pkgutil
import threading
import urllib.error
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import voicebox_tpu_torch.examples as examples
from voicebox_tpu_torch import ConditionalFlowMatcherWrapper, DynamicBatcher, HubertWithKmeans
from voicebox_tpu_torch import MelVoco, TextToSemantic, TTSEngine, VoiceBox
from voicebox_tpu_torch.examples import serve_http
from voicebox_tpu_torch.models.vocos import Vocos
from voicebox_tpu_torch.utils.tokenizer import GraphemeTokenizer

EXAMPLES = sorted(m.name for m in pkgutil.iter_modules(examples.__path__))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_every_example_of_the_jax_package_has_a_port():
    jax_examples = {p.stem for p in (Path(__file__).parents[1] / "examples").glob("*.py")}
    assert set(EXAMPLES) == jax_examples


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_no_jax_and_has_main(name):
    tree = ast.parse((Path(examples.__file__).parent / f"{name}.py").read_text())
    imported = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    imported += [n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module]
    roots = {m.split(".")[0] for m in imported}
    assert not roots & {"jax", "jaxlib", "flax", "optax", "voicebox_tpu"}, roots
    assert any(isinstance(n, ast.FunctionDef) and n.name == "main" for n in tree.body)


def test_lora_finetune_runs_on_the_cpu(capsys):
    """Two of the example's 50 adapter steps (a step takes ~1.4 s on one CPU
    thread), then the fold and the 3-step sample."""
    out = importlib.import_module("voicebox_tpu_torch.examples.lora_finetune").main(
        ["--device", "cpu", "--steps", "2"])
    assert out.shape == (4, 128, 64) and bool(torch.isfinite(out).all())
    printed = capsys.readouterr().out
    assert "trainable adapter params" in printed and "step   0" in printed


def _tiny_engine():
    torch.manual_seed(0)
    hubert = HubertWithKmeans(num_clusters=24, conv_dim=8, dim=16, depth=1, heads=2).eval()
    t2s = TextToSemantic(dim=32, source_depth=2, target_depth=2, heads=2, dim_head=16,
                         wav2vec=hubert, tokenizer=GraphemeTokenizer(), device="cpu").eval()
    codec = MelVoco(vocos=Vocos(input_channels=8, dim=16, intermediate_dim=24, num_layers=1,
                                n_fft=256, hop_length=64), n_mels=8, n_fft=256, win_length=160)
    vb = VoiceBox(audio_enc_dec=codec, num_cond_tokens=24, dim_cond_emb=16, dim=32, depth=2,
                  dim_head=16, heads=2, num_register_tokens=2)
    cfm = ConditionalFlowMatcherWrapper(vb, text_to_semantic=t2s, device="cpu").eval()
    return TTSEngine(cfm, text_buckets=(16,), batch_buckets=(1, 2, 4), steps=2,
                     max_semantic_token_ids=24, spec_decode=False, long_window_frames=160,
                     long_overlap_frames=32, prompt_seconds_buckets=(0.5,))


def _call(url, body=None):
    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wav_samples(body) -> int:
    with wave.open(io.BytesIO(body), "rb") as w:
        assert (w.getframerate(), w.getsampwidth(), w.getnchannels()) == (24000, 2, 1)
        return w.getnframes()


def test_serve_http_routes():
    batcher = DynamicBatcher(_tiny_engine(), max_wait_ms=50.0)
    server = serve_http.make_server(batcher, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address
    try:
        prompt = (0.2 * np.sin(np.arange(9600) * 0.05)).astype(np.float32)  # 0.4 s
        clone = json.dumps({"text": "in my voice",
                            "prompt_wav": base64.b64encode(serve_http.to_wav_bytes(prompt))
                            .decode()}).encode()
        bodies = [json.dumps({"text": t}).encode() for t in ("hello", "a test", "four", "ok")]
        with ThreadPoolExecutor(5) as pool:
            futures = [pool.submit(_call, base + "/synthesize", b) for b in bodies]
            futures.append(pool.submit(_call, base + "/clone", clone))
            answers = [f.result() for f in futures]
        for code, body in answers:
            assert code == 200, body
            assert _wav_samples(body) > 0
        code, body = _call(base + "/healthz")
        stats = json.loads(body)
        assert code == 200 and stats["requests"] == 5 and stats["batches"] >= 1
        assert _call(base + "/synthesize", b"{not json")[0] == 400
        assert _call(base + "/clone", json.dumps({"text": "x"}).encode())[0] == 400
        assert _call(base + "/nowhere")[0] == 404
        assert _call(base + "/nowhere", b"{}")[0] == 404
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    thread.join(10)
    assert not thread.is_alive()
    assert batcher._thread is None or not batcher._thread.is_alive()


def test_serve_http_gives_400_for_what_the_engine_refuses_and_413_for_a_large_body():
    batcher = DynamicBatcher(_tiny_engine(), max_wait_ms=10.0)
    server = serve_http.make_server(batcher, host="127.0.0.1", port=0, max_body_bytes=80_000)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address
    try:
        long_prompt = (0.2 * np.sin(np.arange(14_400) * 0.05)).astype(np.float32)  # 0.6 s
        clone = json.dumps({"text": "in my voice",
                            "prompt_wav": base64.b64encode(
                                serve_http.to_wav_bytes(long_prompt)).decode()}).encode()
        code, body = _call(base + "/clone", clone)  # the largest prompt bucket is 0.5 s
        assert code == 400 and b"prompt bucket" in body, (code, body)
        big = json.dumps({"text": "x" * 90_000}).encode()
        code, body = _call(base + "/synthesize", big)
        assert code == 413 and b"too large" in body, (code, body)
        code, body = _call(base + "/healthz")  # the server answers on
        assert code == 200 and "requests" in json.loads(body)
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    thread.join(10)


def test_wav_bytes_round_trip_and_refusals():
    x = np.linspace(-0.5, 0.5, 480, dtype=np.float32)
    back = serve_http.wav_bytes_to_float(serve_http.to_wav_bytes(x))
    np.testing.assert_allclose(back, x / 0.5, atol=1 / 32767)  # peak normalised
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(b"\0\0" * 10)
    with pytest.raises(ValueError, match="24000 Hz"):
        serve_http.wav_bytes_to_float(buf.getvalue())
