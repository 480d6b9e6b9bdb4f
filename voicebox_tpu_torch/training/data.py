"""Host-side data: audio files, datasets and batching, numpy only.

Counterpart of `voicebox_tpu/training/data.py`. File-backed datasets:
`load_audio` (.wav and .flac through the port's native C++ decoders,
`voicebox_tpu_torch/native`, else scipy or soundfile), `AudioDataset` (a
folder of audio files, each item a float32 mono wave, optionally resampled;
`item_length` reads the length from the header alone) and
`SpeechTextDataset` (audio files with same-stem transcripts, each item
`(text, wave)`, the LibriTTS / LJSpeech layout). In-memory datasets:
`ArrayDataset` (latents (n, d), raw waves (n,), or (latents, frame-aligned
ids) pairs), `PairedDataset` (K-field tuples whose first field may be
text) and `TokenizedTextDataset` (text tokenized once, cached). Batching:
`collate_with_mask` with its bucket grid, `DataLoader` (`get_dataloader`),
`AlignedPairedDataLoader` for (latents,
frame-aligned ids) pairs, `PairedDataLoader` with an independent bucket
grid, pad value and maximum length per field (the duration trainer's
phonemes and waves) and `random_split`. Shuffling uses numpy's
`RandomState(seed)`, as the JAX package does, so both visit the items in
the same order. Batches are padded to bucketed lengths: the bucket grid
`k * multiple - offset` keeps frames + registers on the 128 boundary (752
frames + 16 registers = 768 tokens; for raw waves the trainer sets it in
samples). `PrefetchLoader` decodes and collates the next batches on a
background thread (with an optional `transform`, such as copying into
pinned host memory) while the device works; the native decoders release
the GIL.

Data parallelism (`shard=(rank, world)`, as the JAX package's loaders take
it): every process runs the same seeded loader, so all agree on the order
and on each batch's items; each yields only its rank-block of
`shard_group_size / world` rows inside every group of `shard_group_size`
rows (default: the whole batch), which matches the trainer's split of a
step's batch into micro-batches. `DataLoader` and `AlignedPairedDataLoader`
agree on the bucket length from `_item_length` of every row (a dataset's
`item_length`, which reads a file's header alone) and decode only their
own rows; `PairedDataLoader` reads every row of the batch to agree on each
field's target (K-field tuples have no length accessor), then collates
only its own.
"""

from __future__ import annotations

import math
import queue
import threading
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "AlignedPairedDataLoader",
    "ArrayDataset",
    "AudioDataset",
    "DataLoader",
    "PairedDataLoader",
    "PairedDataset",
    "PrefetchLoader",
    "SpeechTextDataset",
    "TokenizedTextDataset",
    "collate_with_mask",
    "get_dataloader",
    "load_audio",
    "pad_to_multiple",
    "random_split",
]


def load_audio(path) -> Tuple[np.ndarray, int]:
    """Load an audio file -> (float32 mono wave in [-1, 1], sample_rate).

    .wav goes through the native decoder when g++ can build it, else scipy;
    .flac through the native FLAC decoder, else soundfile, as every other
    format does."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".wav":
        from ..native import wav_read

        native = wav_read(path)
        if native is not None:
            return native

        from scipy.io import wavfile

        sr, data = wavfile.read(str(path))
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            data = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            data = (data.astype(np.float32) - 128.0) / 128.0
        else:
            data = data.astype(np.float32)
        if data.ndim == 2:  # channels last -> mono
            data = data.mean(axis=1)
        return data, sr
    if suffix == ".flac":
        from ..native import flac_read

        native = flac_read(path)
        if native is not None:
            return native
    try:
        import soundfile as sf
    except ImportError as e:
        raise ImportError(
            f"loading {suffix} requires the native decoder toolchain (g++) "
            "for .flac or the 'soundfile' package; convert to .wav otherwise"
        ) from e
    data, sr = sf.read(str(path), dtype="float32")
    if data.ndim == 2:
        data = data.mean(axis=1)
    return data, sr


def _resampled(wave: np.ndarray, sr: int, sample_rate: Optional[int]) -> np.ndarray:
    if sample_rate is not None and sr != sample_rate:
        from ..ops.stft import resample_np

        wave = resample_np(wave, sr, sample_rate)
    return wave


class AudioDataset:
    """The audio files under a folder (`**/*{audio_extension}`, sorted), each
    item a float32 mono wave, resampled to `sample_rate` when given."""

    def __init__(self, folder, audio_extension: str = ".flac", sample_rate: Optional[int] = None):
        path = Path(folder)
        if not path.exists():
            raise ValueError(f"folder {folder} does not exist")
        self.audio_extension = audio_extension
        self.sample_rate = sample_rate
        self.files = sorted(path.glob(f"**/*{audio_extension}"))
        if not self.files:
            raise ValueError(f"no {audio_extension} files under {folder}")
        self._length_cache: dict = {}

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx) -> np.ndarray:
        wave, sr = load_audio(self.files[idx])
        return _resampled(wave, sr, self.sample_rate)

    def item_length(self, idx) -> int:
        """The item's length in samples at the output rate, read from the
        header alone (.wav through `wave`, .flac from STREAMINFO) and cached
        per index; other formats, or an unreadable header, decode once. A
        resampled length is `resample_np`'s, ceil(n * new / orig), where the
        JAX package rounds (ROADMAP Queue 3)."""
        if idx in self._length_cache:
            return self._length_cache[idx]
        path = self.files[idx]
        n = sr = None
        if path.suffix.lower() == ".wav":
            import wave as wave_mod

            try:
                with wave_mod.open(str(path), "rb") as w:
                    n, sr = w.getnframes(), w.getframerate()
            except Exception:
                pass
        elif path.suffix.lower() == ".flac":
            from ..native import flac_info

            info = flac_info(path)
            if info is not None:
                n, sr = info
        if n is None:
            n = len(self[idx])
            sr = self.sample_rate
        if self.sample_rate is not None and sr != self.sample_rate:
            n = -(-n * self.sample_rate // sr)  # resample_np's length, ceil(n new / orig)
        self._length_cache[idx] = int(n)
        return self._length_cache[idx]


class SpeechTextDataset:
    """Audio files paired with same-stem transcripts (`x.flac` + `x.txt`,
    the LibriTTS / LJSpeech layout); audio without a transcript is skipped.
    Each item is `(text, float32 mono wave)`, the wave resampled to
    `sample_rate` when given."""

    def __init__(self, folder, audio_extension: str = ".flac", text_extension: str = ".txt",
                 sample_rate: Optional[int] = None):
        path = Path(folder)
        if not path.exists():
            raise ValueError(f"folder {folder} does not exist")
        self.sample_rate = sample_rate
        self.files = [(audio, audio.with_suffix(text_extension))
                      for audio in sorted(path.glob(f"**/*{audio_extension}"))
                      if audio.with_suffix(text_extension).exists()]
        if not self.files:
            raise ValueError(f"no ({audio_extension}, {text_extension}) pairs under {folder}")

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        audio_path, txt_path = self.files[idx]
        wave, sr = load_audio(audio_path)
        return txt_path.read_text().strip(), _resampled(wave, sr, self.sample_rate)


class ArrayDataset:
    """In-memory dataset of numpy arrays (latents (n, d) or raw waves (n,))
    or of tuples of them ((latents (n, d), frame-aligned ids (n,)) pairs)."""

    def __init__(self, items: Sequence):
        self.items = [
            tuple(np.asarray(f) for f in it) if isinstance(it, (tuple, list)) else np.asarray(it)
            for it in items
        ]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        return self.items[idx]

    def item_length(self, idx) -> int:
        item = self.items[idx]
        return int((item[0] if isinstance(item, tuple) else item).shape[0])


class PairedDataset:
    """In-memory dataset of K-field tuples: (text | phoneme ids, wave |
    latents[, mel]) for the duration trainer. Strings pass through (the
    trainer tokenizes them); other fields become numpy arrays."""

    def __init__(self, items: Sequence[tuple]):
        self.items = [tuple(f if isinstance(f, str) else np.asarray(f) for f in it)
                      for it in items]
        if not self.items:
            raise ValueError("empty dataset")
        if len({len(it) for it in self.items}) != 1:
            raise ValueError("all items must have the same number of fields")

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        return self.items[idx]


class TokenizedTextDataset:
    """A view of K-field tuple items whose str first field becomes its int32
    ids without pads (tokenized once per item and cached); every other field
    passes through as a numpy array."""

    def __init__(self, dataset, tokenizer):
        self.dataset = dataset
        self.tokenizer = tokenizer
        self._cache: dict = {}

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        row = self.dataset[idx]
        first, rest = row[0], row[1:]
        if isinstance(first, str):
            ids = self._cache.get(idx)
            if ids is None:
                if self.tokenizer is None:
                    raise ValueError("the dataset yields text but the model has no tokenizer")
                arr = np.asarray(self.tokenizer.texts_to_tensor_ids([first]), np.int32)[0]
                ids = self._cache[idx] = arr[arr != -1]
            first = ids
        return (np.asarray(first), *(np.asarray(f) for f in rest))


class _Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def item_length(self, idx) -> int:
        return _item_length(self.dataset, self.indices[idx])


def random_split(dataset, valid_frac: float, seed: int = 42):
    """(train, valid) subsets: a seeded permutation, the first
    int((1 - valid_frac) n) items for training."""
    n = len(dataset)
    n_train = int((1 - valid_frac) * n)
    perm = np.random.RandomState(seed).permutation(n)
    return _Subset(dataset, perm[:n_train]), _Subset(dataset, perm[n_train:])


def _item_length(dataset, idx) -> int:
    """Length of item `idx` along axis 0 (of its first field for a tuple),
    through the dataset's cheap `item_length` where it has one, else by
    decoding."""
    fn = getattr(dataset, "item_length", None)
    if fn is not None:
        return int(fn(idx))
    item = dataset[idx]
    return int(np.shape(item[0] if isinstance(item, tuple) else item)[0])


def pad_to_multiple(length: int, multiple: int) -> int:
    return int(math.ceil(length / multiple)) * multiple


def _rank_positions(n_rows: int, shard: Optional[Tuple[int, int]],
                    group: Optional[int] = None) -> np.ndarray:
    """The positions in a batch of `n_rows` that rank `shard[0]` of
    `shard[1]` yields: its block of `group / world` rows inside each group
    of `group` rows (default: one group of the whole batch)."""
    if shard is None:
        return np.arange(n_rows)
    rank, world = shard
    group = group or n_rows
    block = group // world
    return np.concatenate([np.arange(g + rank * block, g + (rank + 1) * block)
                           for g in range(0, n_rows, group)])


def _check_shard(shard, batch_size: int, group: Optional[int]) -> None:
    if shard is None:
        return
    rank, world = shard
    group = group or batch_size
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if batch_size % group or group % world:
        raise ValueError(f"a batch of {batch_size} in groups of {group} does not split over "
                         f"{world} processes")


def _bucket_target(max_len: int, multiple: int, offset: int, align: int) -> int:
    """The bucket length for a batch whose longest item is `max_len`: of the
    grids k * multiple and k * multiple - offset, the one whose model length
    (bucket + offset, padded to `align`) is smaller, then the shorter."""
    t0 = pad_to_multiple(max_len, multiple)
    if offset <= 0:
        return t0
    t1 = pad_to_multiple(max_len + offset, multiple) - offset
    return min((t0, t1), key=lambda t: (pad_to_multiple(t + offset, align), t))


def _capped(target: int, max_length: Optional[int], multiple: int, offset: int) -> int:
    """`target` capped at `max_length`, snapped down onto the offset grid."""
    if max_length is None or target <= max_length:
        return target
    snapped = (max_length + offset) // multiple * multiple - offset
    return snapped if snapped > 0 else max_length


def collate_with_mask(
    items: List[np.ndarray],
    bucket_multiple: int = 256,
    pad_to_longest: bool = True,
    max_length: Optional[int] = None,
    bucket_offset: int = 0,
    align_multiple: int = 128,
    force_target: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length items into (batch, mask): padded with zeros to
    the bucketed longest length (or `force_target`), or with
    `pad_to_longest=False` cut to the shortest."""
    lengths = [it.shape[0] for it in items]
    if force_target is not None:
        target = _capped(force_target, max_length, bucket_multiple, bucket_offset)
    elif pad_to_longest:
        target = _bucket_target(max(lengths), bucket_multiple, bucket_offset, align_multiple)
        target = _capped(target, max_length, bucket_multiple, bucket_offset)
    else:
        target = min(lengths)
    batch = []
    mask = np.zeros((len(items), target), dtype=bool)
    for i, it in enumerate(items):
        n = min(it.shape[0], target)
        batch.append(np.pad(it[:n], [(0, target - n)] + [(0, 0)] * (it.ndim - 1)))
        mask[i, :n] = True
    return np.stack(batch), mask


class DataLoader:
    """Shuffling batch iterator yielding (batch, mask) numpy pairs with
    bucketed shapes. A short last batch wraps around to the full batch size
    unless `drop_last`. With `shard=(rank, world)` it yields this rank's
    rows only (module doc)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        pad_to_longest: bool = True,
        bucket_multiple: int = 256,
        max_length: Optional[int] = None,
        drop_last: bool = False,
        bucket_offset: int = 0,
        align_multiple: int = 128,
        shard: Optional[Tuple[int, int]] = None,
        shard_group_size: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.pad_to_longest = pad_to_longest
        self.bucket_multiple = bucket_multiple
        self.max_length = max_length
        self.drop_last = drop_last
        self.bucket_offset = bucket_offset
        self.align_multiple = align_multiple
        _check_shard(shard, batch_size, shard_group_size)
        self.shard, self.shard_group_size = shard, shard_group_size

    def _local_rows(self, idx: np.ndarray) -> np.ndarray:
        """The items of the batch `idx` that this rank decodes."""
        return idx[_rank_positions(len(idx), self.shard, self.shard_group_size)]

    def _global_target(self, idx: np.ndarray) -> Optional[int]:
        """Under `shard`, the bucket length every rank agrees on, from the
        lengths of all the batch's rows (none decoded)."""
        if self.shard is None or not self.pad_to_longest:
            return None
        return _bucket_target(max(_item_length(self.dataset, int(i)) for i in idx),
                              self.bucket_multiple, self.bucket_offset, self.align_multiple)

    def _batches(self) -> Iterator[np.ndarray]:
        n = len(self.dataset)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        for start in range(0, n, self.batch_size):
            idx = order[start : start + self.batch_size]
            if len(idx) < self.batch_size:
                if self.drop_last:
                    return
                idx = np.concatenate([idx, np.resize(order, self.batch_size - len(idx))])
            yield idx

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for idx in self._batches():
            yield collate_with_mask(
                [np.asarray(self.dataset[int(i)]) for i in self._local_rows(idx)],
                bucket_multiple=self.bucket_multiple, pad_to_longest=self.pad_to_longest,
                max_length=self.max_length, bucket_offset=self.bucket_offset,
                align_multiple=self.align_multiple, force_target=self._global_target(idx),
            )

    def cycle(self):
        while True:
            yield from iter(self)


def get_dataloader(ds, *, batch_size: int, pad_to_longest: bool = True, **kwargs) -> DataLoader:
    """The reference's constructor (data.py:89-91)."""
    return DataLoader(ds, batch_size=batch_size, pad_to_longest=pad_to_longest, **kwargs)


class AlignedPairedDataLoader(DataLoader):
    """Batches (latents (n, d), frame-aligned ids (n,)) pairs on one shared
    bucket grid, so the ids keep their alignment through padding. Yields
    ((latents, mask), (ids, mask)); ids pad with -1 (the null row)."""

    def __iter__(self):
        for idx in self._batches():
            rows = [self.dataset[int(i)] for i in self._local_rows(idx)]
            for x, ids in rows:
                if np.shape(x)[0] != np.shape(ids)[0]:
                    raise ValueError(
                        f"aligned pairs must have equal lengths per item, got "
                        f"latents {np.shape(x)[0]} vs ids {np.shape(ids)[0]}"
                    )
            target = self._global_target(idx)
            if target is None:
                target = _bucket_target(max(np.shape(x)[0] for x, _ in rows),
                                        self.bucket_multiple, self.bucket_offset,
                                        self.align_multiple)
            target = _capped(target, self.max_length, self.bucket_multiple, self.bucket_offset)
            xs, mask = collate_with_mask([np.asarray(x) for x, _ in rows], force_target=target)
            ids = np.full((len(rows), target), -1, dtype=np.int32)
            for i, (_, row_ids) in enumerate(rows):
                m = min(np.shape(row_ids)[0], target)
                ids[i, :m] = np.asarray(row_ids)[:m]
            yield (xs, mask), (ids, mask)


class PairedDataLoader:
    """Shuffling batch iterator over K-field tuple datasets with an
    independent bucket grid per field: field f pads to a multiple of
    `bucket_multiples[f]` (capped at `max_lengths[f]`) with
    `pad_values[f]` (-1 for ids). Yields one (padded, mask) pair per field.
    A short last batch wraps around to the full batch size unless
    `drop_last`. With `shard=(rank, world)` it yields this rank's rows only
    (module doc)."""

    def __init__(self, dataset, batch_size: int, *, bucket_multiples: Sequence[int],
                 pad_values: Optional[Sequence] = None,
                 max_lengths: Optional[Sequence[Optional[int]]] = None, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False,
                 shard: Optional[Tuple[int, int]] = None,
                 shard_group_size: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.bucket_multiples = tuple(bucket_multiples)
        k = len(self.bucket_multiples)
        self.pad_values = tuple(pad_values) if pad_values is not None else (0,) * k
        self.max_lengths = tuple(max_lengths) if max_lengths is not None else (None,) * k
        if len(self.pad_values) != k or len(self.max_lengths) != k:
            raise ValueError("one bucket multiple, pad value and max length per field")
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        _check_shard(shard, batch_size, shard_group_size)
        self.shard, self.shard_group_size = shard, shard_group_size

    def _local_positions(self, n_rows: int) -> np.ndarray:
        """The positions in a batch of `n_rows` that this rank yields."""
        return _rank_positions(n_rows, self.shard, self.shard_group_size)

    @staticmethod
    def _collate_field(items: List[np.ndarray], multiple: int, pad_value,
                       max_length: Optional[int], force_target: Optional[int] = None):
        target = pad_to_multiple(max(it.shape[0] for it in items), multiple)
        if force_target is not None:
            target = force_target
        if max_length is not None and target > max_length:
            target = max_length
        batch = np.full((len(items), target, *items[0].shape[1:]), pad_value,
                        dtype=items[0].dtype)
        mask = np.zeros((len(items), target), dtype=bool)
        for i, it in enumerate(items):
            n = min(it.shape[0], target)
            batch[i, :n] = it[:n]
            mask[i, :n] = True
        return batch, mask

    def __iter__(self):
        n = len(self.dataset)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        for start in range(0, n, self.batch_size):
            idx = order[start: start + self.batch_size]
            if len(idx) < self.batch_size:
                if self.drop_last:
                    return
                idx = np.concatenate([idx, np.resize(order, self.batch_size - len(idx))])
            rows = [self.dataset[int(i)] for i in idx]
            local = [rows[int(p)] for p in self._local_positions(len(rows))]
            yield tuple(
                self._collate_field(
                    [np.asarray(row[f]) for row in local], self.bucket_multiples[f],
                    self.pad_values[f], self.max_lengths[f],
                    force_target=pad_to_multiple(max(np.shape(row[f])[0] for row in rows),
                                                 self.bucket_multiples[f]))
                for f in range(len(self.bucket_multiples))
            )

    def cycle(self):
        while True:
            yield from iter(self)


class PrefetchLoader:
    """Bounded background-thread prefetch around a loader (`DataLoader`,
    with epoch `__iter__` and infinite `cycle()`, or any iterable): up to
    `prefetch` items are made ahead, each passed through `transform` on the
    thread. Counterpart of `voicebox_tpu/training/data.py::PrefetchLoader`:
    the items come in the loader's order, an exception in the producer
    re-raises in the consumer, and abandoning (closing or dropping) the
    iterator stops the thread."""

    _END = object()

    def __init__(self, loader, prefetch: int = 2, transform: Optional[Callable] = None):
        assert prefetch >= 1
        self.loader = loader
        self.prefetch = prefetch
        self.transform = transform

    def _iterate(self, source) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        transform = self.transform

        def put(item) -> bool:  # False once the consumer is gone
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for item in source:
                    if not put((None, item if transform is None else transform(item))):
                        return
                put((self._END, None))
            except BaseException as e:  # re-raised in the consumer
                put((e, None))

        thread = threading.Thread(target=producer, daemon=True, name="voicebox-prefetch")
        thread.start()
        try:
            while True:
                flag, item = q.get()
                if flag is self._END:
                    return
                if flag is not None:
                    raise flag
                yield item
        finally:
            stop.set()

    def __iter__(self) -> Iterator:
        return self._iterate(iter(self.loader))

    def cycle(self) -> Iterator:
        if hasattr(self.loader, "cycle"):
            return self._iterate(self.loader.cycle())

        def forever():
            while True:
                yield from iter(self.loader)

        return self._iterate(forever())
