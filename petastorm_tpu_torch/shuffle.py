"""Host-side shuffling buffers (port of ``petastorm_tpu.shuffle``): the columnar
``BatchedRandomShufflingBuffer`` the loader's host batcher uses, and the per-row
``NoopShufflingBuffer`` / ``RandomShufflingBuffer`` of the torch adapters
(:mod:`petastorm_tpu_torch.adapters.pytorch`). The on-device ring is
:mod:`petastorm_tpu_torch.ops.device_shuffle`.
"""
from __future__ import annotations

import numpy as np


class ShufflingBufferBase:
    def add_many(self, items):
        raise NotImplementedError

    def retrieve(self):
        raise NotImplementedError

    @property
    def can_add(self):
        raise NotImplementedError

    @property
    def can_retrieve(self):
        raise NotImplementedError

    @property
    def size(self):
        raise NotImplementedError

    def finish(self):
        """Signal no more items will be added; drain remaining."""
        raise NotImplementedError


class NoopShufflingBuffer(ShufflingBufferBase):
    """FIFO passthrough (reference ~L40)."""

    def __init__(self):
        from collections import deque

        self._items = deque()
        self._done = False

    def add_many(self, items):
        self._items.extend(items)

    def retrieve(self):
        return self._items.popleft()

    @property
    def can_add(self):
        return not self._done

    @property
    def can_retrieve(self):
        return len(self._items) > 0

    @property
    def size(self):
        return len(self._items)

    def finish(self):
        self._done = True


class RandomShufflingBuffer(ShufflingBufferBase):
    """Bounded reservoir: add until capacity, retrieve uniformly at random once past the
    retrieval threshold (reference ~L80: capacity + ``min_after_retrieve`` semantics).
    """

    def __init__(self, shuffling_buffer_capacity, min_after_retrieve, extra_capacity=1000,
                 seed=None):
        if min_after_retrieve > shuffling_buffer_capacity:
            raise ValueError("min_after_retrieve must be <= capacity")
        self._capacity = shuffling_buffer_capacity
        self._min_after_retrieve = min_after_retrieve
        self._extra_capacity = extra_capacity
        self._items = []
        self._done = False
        self._rng = np.random.Generator(np.random.PCG64(seed))

    def add_many(self, items):
        items = list(items)
        if self._done:
            raise RuntimeError("Cannot add to a finished shuffling buffer")
        if len(self._items) + len(items) > self._capacity + self._extra_capacity:
            raise RuntimeError(
                "Attempt to add %d items to a buffer at %d/%d capacity; honor can_add "
                "backpressure" % (len(items), len(self._items), self._capacity)
            )
        self._items.extend(items)

    def retrieve(self):
        if not self.can_retrieve:
            raise RuntimeError("Buffer below retrieval threshold and not finished")
        idx = int(self._rng.integers(len(self._items)))
        self._items[idx], self._items[-1] = self._items[-1], self._items[idx]
        return self._items.pop()

    @property
    def can_add(self):
        return len(self._items) < self._capacity and not self._done

    @property
    def can_retrieve(self):
        if self._done:
            return len(self._items) > 0
        return len(self._items) > self._min_after_retrieve

    @property
    def size(self):
        return len(self._items)

    def finish(self):
        self._done = True


class BatchedRandomShufflingBuffer:
    """Columnar shuffle: holds {name: ndarray} column batches, retrieves random fixed-size
    batches by index-select — one vectorized gather instead of per-row python shuffling.

    Generalizes the reference's torch-only batched buffer
    (petastorm/reader_impl/pytorch_shuffling_buffer.py ~L90) to numpy.
    """

    def __init__(self, shuffling_buffer_capacity, min_after_retrieve, batch_size, seed=None):
        if min_after_retrieve > shuffling_buffer_capacity:
            raise ValueError("min_after_retrieve must be <= capacity")
        self._capacity = shuffling_buffer_capacity
        self._min_after_retrieve = min_after_retrieve
        self._batch_size = batch_size
        self._staged = None  # {name: list of arrays} awaiting consolidation
        self._store = None  # {name: preallocated ndarray}; rows [0, _store_rows) valid
        self._store_rows = 0  # consolidated rows currently in _store
        self._num_rows = 0  # total rows (consolidated + staged)
        self._done = False
        self._rng = np.random.Generator(np.random.PCG64(seed))

    def add_many(self, column_batch):
        """column_batch: {name: np.ndarray} with equal leading dims."""
        if self._done:
            raise RuntimeError("Cannot add to a finished shuffling buffer")
        names = list(column_batch.keys())
        n = len(column_batch[names[0]])
        if self._staged is None:
            self._staged = {name: [] for name in names}
        for name in names:
            if len(column_batch[name]) != n:
                raise ValueError("Ragged column batch: %r" % name)
            self._staged[name].append(np.asarray(column_batch[name]))
        self._num_rows += n

    def retrieve(self):
        """Return a {name: ndarray} batch of up to batch_size random rows.

        O(batch) data movement per call: selected rows are copied out and the holes are
        back-filled from the buffer tail in place (the previous full-buffer gather of
        the kept rows copied the entire buffer's bytes on every retrieve)."""
        if not self.can_retrieve:
            raise RuntimeError("Buffer below retrieval threshold and not finished")
        self._consolidate()
        n = self._num_rows
        take = min(self._batch_size, n)
        # keep chosen UNSORTED: the gather order is the intra-batch shuffle (sorting
        # would emit rows in buffer-insertion order — FIFO when take ≈ n)
        chosen = self._rng.choice(n, size=take, replace=False)
        out = {}
        tail_start = n - take
        # tail rows that were NOT chosen backfill the holes chosen left below tail_start
        chosen_in_tail = chosen[chosen >= tail_start]
        holes = chosen[chosen < tail_start]
        tail_mask = np.ones(take, dtype=bool)
        tail_mask[chosen_in_tail - tail_start] = False
        for name, store in self._store.items():
            out[name] = store[chosen]  # fancy indexing already allocates fresh rows
            if len(holes):
                store[holes] = store[tail_start:n][tail_mask]
        self._num_rows -= take
        self._store_rows = self._num_rows
        return out

    def _consolidate(self):
        """Move staged chunks into the preallocated store (grown geometrically)."""
        if not self._staged:
            return
        base = self._store_rows
        for name, chunks in self._staged.items():
            if not chunks:
                continue
            add = sum(len(c) for c in chunks)
            store = None if self._store is None else self._store.get(name)
            need = base + add
            if store is None or len(store) < need:
                # grow geometrically toward (not eagerly to) the capacity ceiling: a
                # small dataset must not allocate capacity-sized buffers up front
                limit = max(need, self._capacity + self._batch_size)
                grown = need if store is None else max(need, 2 * len(store))
                grown = min(grown, limit)
                first = chunks[0]
                if self._store is None:
                    self._store = {}
                new = np.empty((grown,) + first.shape[1:], dtype=first.dtype)
                if store is not None:
                    new[:base] = store[:base]
                self._store[name] = store = new
            pos = base
            for c in chunks:
                store[pos:pos + len(c)] = c
                pos += len(c)
            self._staged[name] = []
        self._store_rows = self._num_rows

    @property
    def can_add(self):
        return self._num_rows < self._capacity and not self._done

    @property
    def can_retrieve(self):
        if self._done:
            return self._num_rows > 0
        return self._num_rows >= self._min_after_retrieve + self._batch_size

    @property
    def size(self):
        return self._num_rows

    def finish(self):
        self._done = True
