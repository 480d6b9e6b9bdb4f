"""Text -> phoneme ids (host-side pre-processing, numpy only).

A restatement of `voicebox_tpu/utils/tokenizer.py` (the port imports
nothing of the JAX package): the ids are the JAX package's, id for id, and
the pad id is -1.

* `GraphemeTokenizer`: the deterministic character-level fallback over a
  fixed charset;
* `EspeakTokenizer`: IPA phonemes through an injectable backend (anything
  with `.phonemize(list[str]) -> list[str]`; by default phonemizer's
  espeak-ng backend, when that package is installed), over the frozen
  `_IPA_SYMBOLS` table: symbols outside it map to `<unk>` = 0;
* `Tokenizer()`: espeak when available, else graphemes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["ESPEAK_AVAILABLE", "EspeakTokenizer", "GraphemeTokenizer", "Tokenizer"]

try:  # optional: phonemizer and espeak-ng are not a dependency of the port
    from phonemizer.backend import EspeakBackend  # noqa: F401

    ESPEAK_AVAILABLE = True
except ImportError:
    ESPEAK_AVAILABLE = False


_DEFAULT_CHARSET = " abcdefghijklmnopqrstuvwxyz0123456789!'(),-.:;?"


def _pad_batch(encoded: List[List[int]], max_length: Optional[int]) -> np.ndarray:
    """(len(encoded), longest) int32 ids, right-padded with -1."""
    target = max(len(e) for e in encoded)
    if max_length is not None:
        target = min(target, max_length)
    out = np.full((len(encoded), target), -1, dtype=np.int32)
    for i, e in enumerate(encoded):
        out[i, : min(len(e), target)] = e[:target]
    return out


class GraphemeTokenizer:
    """Deterministic char-level tokenizer: lower-cased characters of the
    charset, others dropped. pad id = -1."""

    def __init__(self, charset: str = _DEFAULT_CHARSET):
        self.charset = charset
        self._to_id = {c: i for i, c in enumerate(charset)}

    @property
    def vocab_size(self) -> int:
        return len(self.charset)

    def encode(self, text: str) -> List[int]:
        return [self._to_id[c] for c in text.lower() if c in self._to_id]

    def texts_to_tensor_ids(self, texts: Sequence[str],
                            max_length: Optional[int] = None) -> np.ndarray:
        return _pad_batch([self.encode(t) for t in texts], max_length)


# Frozen IPA symbol table (the espeak-ng en-us inventory with stress and
# length marks, latin letters, digits, punctuation), in the JAX package's
# order: ids are stable across runs, and an embedding sized from vocab_size
# is never out-indexed
_IPA_SYMBOLS = (
    ["<unk>", " "]
    + list("abcdefghijklmnopqrstuvwxyz")
    + list("ABCDEFGHIJKLMNOPQRSTUVWXYZ")
    + list("0123456789")
    + list("!'(),-.:;?\"")
    + list("æɑɒɔəɚɛɜɝɪʊʌʒʃθðŋɹɾɡɫɬɱɳɲʔʕχʁħʰʲʷ")
    + list("ãẽĩõũáéíóúàèìòùâêîôû")
    + list("ˈˌːˑ̩̃‿͡")
    + list("ᵻɐɨʉɘɵɤøœɶɞʏʎʋʍɸβɗɖʂʐɻɽɢʡʢǀǁǂǃ")
)


class EspeakTokenizer:
    """IPA-phoneme tokenizer over `_IPA_SYMBOLS`; `backend` is injectable."""

    def __init__(self, language: str = "en-us", backend=None):
        if backend is None:
            from phonemizer.backend import EspeakBackend

            backend = EspeakBackend(language, preserve_punctuation=True, with_stress=True)
        self.backend = backend
        self._vocab: List[str] = list(_IPA_SYMBOLS)
        self._to_id = {s: i for i, s in enumerate(self._vocab)}

    @property
    def vocab_size(self) -> int:
        return max(len(self._vocab), 256)

    def texts_to_tensor_ids(self, texts: Sequence[str],
                            max_length: Optional[int] = None) -> np.ndarray:
        phonemized = self.backend.phonemize(list(texts))
        return _pad_batch([[self._to_id.get(c, 0) for c in p] for p in phonemized],
                          max_length)


def Tokenizer(**kwargs):
    """espeak when phonemizer is installed, the grapheme fallback otherwise
    (the JAX package's factory)."""
    if ESPEAK_AVAILABLE:
        return EspeakTokenizer(**kwargs)
    return GraphemeTokenizer(**kwargs)
