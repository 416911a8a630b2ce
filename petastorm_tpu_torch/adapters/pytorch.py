"""PyTorch adapters: ``DataLoader``, ``BatchedDataLoader``, ``InMemBatchedDataLoader``.

Port of ``petastorm_tpu.adapters.pytorch`` (the reference's ``petastorm.pytorch``): host
loaders over the port's readers, with host shuffling buffers. They yield CPU tensors for
the caller's own ``.to(device)``; the card path, which finishes ``decode_on_device`` JPEG
columns and batched NGram windows on the device, is
:class:`petastorm_tpu_torch.loader.DataLoader`. ``BatchedDataLoader`` rides the columnar
path (numpy column dicts → ``torch.as_tensor``, zero-copy for writable arrays; a
read-only one, such as a memcache serve, is copied) instead of a per-row collate.

On a process pool's shared-memory view wire (``wire_serializer='shm-view'``) a
delivery's arrays view a slab the reader recycles at its next fetch, and these loaders
keep rows across fetches, so they copy each delivery out of its slab first.
"""
from __future__ import annotations

import decimal
import logging

import numpy as np

from petastorm_tpu_torch.shuffle import NoopShufflingBuffer, RandomShufflingBuffer

logger = logging.getLogger(__name__)


def decimal_friendly_collate(batch):
    """``default_collate`` that passes ``decimal.Decimal`` (and other values it cannot
    convert) through as lists."""
    import torch

    first = batch[0]
    if isinstance(first, decimal.Decimal):
        return list(batch)
    if isinstance(first, (dict,)):
        return {k: decimal_friendly_collate([d[k] for d in batch]) for k in first}
    if hasattr(first, "_fields"):  # namedtuple
        return type(first)(*(decimal_friendly_collate([getattr(d, f) for d in batch])
                             for f in first._fields))
    if isinstance(first, (list, tuple)):
        return [decimal_friendly_collate(list(s)) for s in zip(*batch)]
    try:
        return torch.utils.data.default_collate(batch)
    except TypeError:
        return list(batch)


class LoaderBase:
    """Iterator and shutdown plumbing shared by the torch loaders."""

    def __init__(self, reader):
        if getattr(reader, "device_decode_fields", None):
            raise ValueError(
                "Reader was built with decode_on_device=True: its image columns carry "
                "device staging payloads only petastorm_tpu_torch.loader.DataLoader "
                "can finish. Use that loader, or rebuild the reader with "
                "decode_on_device=False for the torch path."
            )
        if getattr(reader, "ngram", None) is not None \
                and getattr(reader, "is_batched_reader", False):
            raise ValueError(
                "The torch adapters do not support batched NGram readers (their "
                "flat 'offset/field' columns are the device DataLoader's convention). "
                "Use make_reader(schema_fields=ngram) here, or "
                "petastorm_tpu_torch.loader.DataLoader for the columnar path.")
        self.reader = reader
        self._stopped = False
        self._copy_views = bool(getattr(reader, "wire_views", False))

    def _columns(self, item):
        """A delivery as a dict, copied out of its slab on a view wire."""
        columns = item._asdict() if hasattr(item, "_asdict") else item
        if self._copy_views:
            from petastorm_tpu_torch.loader import _detach_views

            columns = _detach_views(columns)
        return columns

    def __iter__(self):
        try:
            yield from self._iter_impl()
        except Exception:
            self.stop()
            raise

    def stop(self):
        self._stopped = True
        self.reader.stop()

    def join(self):
        self.reader.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        self.join()


class DataLoader(LoaderBase):
    """Per-row loader: reader rows → shuffling queue → ``collate_fn`` batches. Use with
    ``make_reader``; for ``make_batch_reader`` prefer :class:`BatchedDataLoader`."""

    def __init__(self, reader, batch_size=1, collate_fn=decimal_friendly_collate,
                 shuffling_queue_capacity=0, seed=None):
        super().__init__(reader)
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffling_queue_capacity = shuffling_queue_capacity
        self._seed = seed

    def _make_buffer(self):
        if self.shuffling_queue_capacity > 0:
            min_after = max(1, self.shuffling_queue_capacity // 2)
            return RandomShufflingBuffer(self.shuffling_queue_capacity, min_after,
                                         seed=self._seed)
        return NoopShufflingBuffer()

    def _iter_impl(self):
        buffer = self._make_buffer()
        rows = []
        for row in self.reader:
            if self._stopped:
                return
            buffer.add_many([self._columns(row)])
            while buffer.can_retrieve:
                rows.append(buffer.retrieve())
                if len(rows) == self.batch_size:
                    yield self.collate_fn(rows)
                    rows = []
        buffer.finish()
        while buffer.can_retrieve:
            rows.append(buffer.retrieve())
            if len(rows) == self.batch_size:
                yield self.collate_fn(rows)
                rows = []
        if rows:
            yield self.collate_fn(rows)


class BatchedDataLoader(LoaderBase):
    """Vectorized loader over the columnar batch path: numpy column dicts → batched
    shuffle buffer → torch tensors, no per-row work.

    Columns torch cannot hold (strings, objects, decimals) are yielded as numpy arrays.
    """

    def __init__(self, reader, batch_size=1, shuffling_queue_capacity=0, seed=None,
                 keep_last_batch=True):
        super().__init__(reader)
        self.batch_size = batch_size
        self.shuffling_queue_capacity = shuffling_queue_capacity
        self._seed = seed
        self.keep_last_batch = keep_last_batch

    def _iter_impl(self):
        import torch

        from petastorm_tpu_torch.loader import _HostBatcher

        batcher = _HostBatcher(self.batch_size, self.shuffling_queue_capacity, self._seed)

        def to_torch(batch):
            return {k: self._to_torch(torch, v) for k, v in batch.items()}

        for item in self.reader:
            if self._stopped:
                return
            columns = {k: v for k, v in self._columns(item).items() if v is not None}
            if columns:
                for batch in batcher.add(columns):
                    yield to_torch(batch)
        for batch in batcher.finish():
            n = len(next(iter(batch.values()))) if batch else 0
            if n == self.batch_size or (n and self.keep_last_batch):
                yield to_torch(batch)

    @staticmethod
    def _to_torch(torch, arr):
        if isinstance(arr, np.ndarray) and arr.dtype.kind in "biufc":
            # a read-only array (an Arrow column, a memcache serve) is copied: torch
            # tensors are writable, and a write must not land in a buffer others share
            return torch.as_tensor(arr if arr.flags.writeable else arr.copy())
        return arr


class InMemBatchedDataLoader(LoaderBase):
    """Loads up to ``rows_capacity`` rows ONCE, then serves epochs from host memory with a
    fresh permutation every epoch (numpy ``PCG64`` from ``seed``, as the JAX package's
    adapter draws). The device-resident form is
    :class:`petastorm_tpu_torch.loader.InMemDataLoader`."""

    def __init__(self, reader, batch_size=1, num_epochs=1, rows_capacity=None,
                 shuffle=True, seed=None):
        super().__init__(reader)
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.rows_capacity = rows_capacity
        self.shuffle = shuffle
        self._rng = np.random.Generator(np.random.PCG64(seed))
        self._columns_store = None

    def _load(self):
        chunks = {}
        total = 0
        for item in self.reader:
            columns = {k: v for k, v in self._columns(item).items() if v is not None}
            if not columns:
                continue
            if not all(isinstance(v, np.ndarray) and v.ndim >= 1 for v in columns.values()):
                from petastorm_tpu_torch.loader import _rows_to_columns

                columns = _rows_to_columns([columns])
            n = len(next(iter(columns.values())))
            for k, v in columns.items():
                chunks.setdefault(k, []).append(v)
            total += n
            if self.rows_capacity is not None and total >= self.rows_capacity:
                break
        if not chunks:
            raise ValueError("reader produced no rows to preload")
        cols = {k: np.concatenate(v, axis=0) if v[0].dtype != object
                else _object_concat(v) for k, v in chunks.items()}
        if self.rows_capacity is not None:
            cols = {k: v[: self.rows_capacity] for k, v in cols.items()}
        self._columns_store = cols

    def _iter_impl(self):
        import torch

        if self._columns_store is None:
            self._load()
        n = len(next(iter(self._columns_store.values())))
        for _ in range(self.num_epochs):
            order = self._rng.permutation(n) if self.shuffle else np.arange(n)
            for start in range(0, n, self.batch_size):
                if self._stopped:
                    return
                idx = order[start: start + self.batch_size]
                yield {k: BatchedDataLoader._to_torch(torch, v[idx])
                       for k, v in self._columns_store.items()}


def _object_concat(chunks):
    total = sum(len(c) for c in chunks)
    out = np.empty(total, dtype=object)
    pos = 0
    for c in chunks:
        out[pos: pos + len(c)] = c
        pos += len(c)
    return out
