"""Host-side batching of in-memory datasets, numpy only.

Counterpart of the in-memory parts of `voicebox_tpu/training/data.py`:
`ArrayDataset` (latents (n, d), raw waves (n,), or (latents, frame-aligned
ids) pairs), `PairedDataset` (K-field tuples whose first field may be
text), `collate_with_mask` with its bucket grid, `DataLoader` (without
multi-process sharding), `AlignedPairedDataLoader` for (latents,
frame-aligned ids) pairs, `PairedDataLoader` with an independent bucket
grid, pad value and maximum length per field (the duration trainer's
phonemes and waves), `TokenizedTextDataset` (text tokenized once, cached)
and `random_split`. Shuffling uses numpy's `RandomState(seed)`, as the JAX
package does, so both visit the items in the same order. Batches are padded
to bucketed lengths: the bucket grid `k * multiple - offset` keeps frames +
registers on the 128 boundary (752 frames + 16 registers = 768 tokens; for
raw waves the trainer sets it in samples). `PrefetchLoader` collates the
next batches on a background thread (with an optional `transform`, such as
copying into pinned host memory) while the device works. The file-backed
audio datasets and multi-host sharding are not ported yet (ROADMAP Queue 1,
items 12 and 15).
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "AlignedPairedDataLoader",
    "ArrayDataset",
    "DataLoader",
    "PairedDataLoader",
    "PairedDataset",
    "PrefetchLoader",
    "TokenizedTextDataset",
    "collate_with_mask",
    "random_split",
]


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


def random_split(dataset, valid_frac: float, seed: int = 42):
    """(train, valid) subsets: a seeded permutation, the first
    int((1 - valid_frac) n) items for training."""
    n = len(dataset)
    n_train = int((1 - valid_frac) * n)
    perm = np.random.RandomState(seed).permutation(n)
    return _Subset(dataset, perm[:n_train]), _Subset(dataset, perm[n_train:])


def _pad_to_multiple(length: int, multiple: int) -> int:
    return int(math.ceil(length / multiple)) * multiple


def _bucket_target(max_len: int, multiple: int, offset: int, align: int) -> int:
    """The bucket length for a batch whose longest item is `max_len`: of the
    grids k * multiple and k * multiple - offset, the one whose model length
    (bucket + offset, padded to `align`) is smaller, then the shorter."""
    t0 = _pad_to_multiple(max_len, multiple)
    if offset <= 0:
        return t0
    t1 = _pad_to_multiple(max_len + offset, multiple) - offset
    return min((t0, t1), key=lambda t: (_pad_to_multiple(t + offset, align), t))


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
    unless `drop_last`."""

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
                [np.asarray(self.dataset[int(i)]) for i in idx],
                bucket_multiple=self.bucket_multiple, pad_to_longest=self.pad_to_longest,
                max_length=self.max_length, bucket_offset=self.bucket_offset,
                align_multiple=self.align_multiple,
            )

    def cycle(self):
        while True:
            yield from iter(self)


class AlignedPairedDataLoader(DataLoader):
    """Batches (latents (n, d), frame-aligned ids (n,)) pairs on one shared
    bucket grid, so the ids keep their alignment through padding. Yields
    ((latents, mask), (ids, mask)); ids pad with -1 (the null row)."""

    def __iter__(self):
        for idx in self._batches():
            rows = [self.dataset[int(i)] for i in idx]
            for x, ids in rows:
                if np.shape(x)[0] != np.shape(ids)[0]:
                    raise ValueError(
                        f"aligned pairs must have equal lengths per item, got "
                        f"latents {np.shape(x)[0]} vs ids {np.shape(ids)[0]}"
                    )
            target = _bucket_target(max(np.shape(x)[0] for x, _ in rows), self.bucket_multiple,
                                    self.bucket_offset, self.align_multiple)
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
    `drop_last`."""

    def __init__(self, dataset, batch_size: int, *, bucket_multiples: Sequence[int],
                 pad_values: Optional[Sequence] = None,
                 max_lengths: Optional[Sequence[Optional[int]]] = None, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False):
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

    @staticmethod
    def _collate_field(items: List[np.ndarray], multiple: int, pad_value,
                       max_length: Optional[int]):
        target = _pad_to_multiple(max(it.shape[0] for it in items), multiple)
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
            yield tuple(
                self._collate_field([np.asarray(row[f]) for row in rows],
                                    self.bucket_multiples[f], self.pad_values[f],
                                    self.max_lengths[f])
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
