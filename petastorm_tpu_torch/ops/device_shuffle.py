"""Device-resident shuffle ring: sample decorrelation on the card.

Port of ``petastorm_tpu.ops.device_shuffle``. The reference petastorm shuffles rows in
host Python with a retrieve-and-remove buffer; at accelerator batch rates that costs
host CPU and pays the host-to-device link again. This ring keeps a fixed number of rows
in device memory and runs a **streaming exchange**: each incoming (already transferred)
batch picks ``b`` DISTINCT random slots of the full ring, emits the rows in those slots
and writes the incoming rows into them: one gather (``index_select`` into a fresh
tensor) and one scatter (``index_copy_``) a batch for each group of columns that share
a dtype and a row shape (the ring holds such a group as one tensor, a row of it a
column), on the caller's stream, with no host involvement.

Semantics are epoch-honest (the retrieve-and-remove contract, not sampling with
replacement): every inserted row is emitted exactly once. Displaced rows ARE the output,
and ``drain()`` flushes the residue as a permutation. A row stays in the ring for a
geometric number of exchanges (mean about capacity/batch), a decorrelation window of
about ``capacity`` rows.

The JAX package draws each exchange's slots with the first ``b`` steps of a
Fisher-Yates pass (a ``lax.scan`` of ``b`` swaps). Any uniform, ordered ``b``-subset of
distinct slots meets the contract; here it is the head of one ``torch.randperm`` of the
capacity, drawn from a generator the ring owns on its device, seeded from ``seed``: the
same seed gives the same slots on the same device. The draws cannot match the JAX
package's (threefry and Philox streams differ), only its contract.

Across ranks (``shardings=``) each rank's ring lives on its own card and holds only that
rank's rows, the split across cards that the JAX package's placed ring gives; every rank
seeds the same slot stream (as every JAX process folds the same seed), and the exchanged
rows leave the ring delivered as DTensors of the rank's rows.
"""
from __future__ import annotations


class DeviceShuffleBuffer:
    """Fixed-capacity device ring with an exact, without-replacement streaming shuffle.

    >>> buf = DeviceShuffleBuffer(capacity=4096, seed=0)
    >>> for batch in device_batches:          # {name: torch.Tensor}, equal leading dim
    ...     out = buf.push(batch)             # None during warm-up, else a shuffled batch
    ...     if out is not None: consume(out)
    >>> for out in buf.drain():               # flush the residue, permuted
    ...     consume(out)

    The ring is one preallocated tensor for each (dtype, row shape) group of the first
    batch's columns, on its device.
    ``capacity`` is rounded up to a multiple of the first batch's row count so warm-up
    fills exactly. Every row pushed is emitted exactly once (push outputs + drain == the
    inputs). A batch SHORTER than the first batch is legal only as the final push of a
    stream (the loader's ``last_batch='partial'`` tail); pushing again after a short
    warm-up batch raises: continuing would write past the ring and lose rows.

    ``shardings``: optional ``callable(name, local tensor) -> NamedSharding | None``
    (the loader passes its batch sharding adapted a column). Pushed columns may be
    DTensors or plain tensors: the ring keeps the rank's local rows of each, on its
    card, and each emitted column the callable lays out is delivered as a DTensor
    (:func:`~petastorm_tpu_torch.parallel.mesh.to_dtensor`); the others stay plain.
    """

    def __init__(self, capacity, seed=0, shardings=None):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._requested_capacity = int(capacity)
        self.capacity = None  # fixed at first push (rounded up to a batch multiple)
        self._seed = int(seed)
        self._generator = None
        self._fill_rows = 0
        self._lanes = None  # [(column names, (len(names), capacity, *row shape) tensor)]
        self._names = None  # the columns, in the first batch's order
        self._batch_rows = None
        self._short_warmup = False
        self._shardings = shardings
        self._layout = {}  # column -> its NamedSharding (None: emitted plain)

    @property
    def filled(self):
        return self._fill_rows

    @property
    def nbytes(self):
        """Bytes the ring holds on its device (0 before the first push)."""
        return sum(ring.numel() * ring.element_size() for _n, ring in self._lanes or ())

    def _init_store(self, batch):
        import torch

        first = next(iter(batch.values()))
        b = first.shape[0]
        self._batch_rows = b
        self._short_warmup = False  # the ring may be refilled after a drain()
        self.capacity = -(-self._requested_capacity // b) * b
        device = first.device
        if self._generator is None or self._generator.device != device:
            self._generator = torch.Generator(device=device)
            self._generator.manual_seed(self._seed)
        groups = {}
        for name, arr in batch.items():
            groups.setdefault((arr.dtype, tuple(arr.shape[1:])), []).append(name)
        self._names = list(batch)
        self._lanes = [(names, torch.empty((len(names), self.capacity) + shape, dtype=dtype,
                                           device=device))
                       for (dtype, shape), names in groups.items()]
        if self._shardings is not None:
            self._layout = {name: self._shardings(name, arr) for name, arr in batch.items()}

    def _local(self, batch):
        """The rank's local tensor of each pushed column (a DTensor's ``to_local()``)."""
        if self._shardings is None:
            return batch
        return {k: v.to_local() if hasattr(v, "to_local") else v for k, v in batch.items()}

    def _emit(self, columns):
        """The emitted columns, in the first batch's order, delivered per ``shardings``."""
        out = {name: columns[name] for name in self._names}
        if not self._layout:
            return out
        from petastorm_tpu_torch.parallel.mesh import to_dtensor

        return {k: v if self._layout.get(k) is None else to_dtensor(v, self._layout[k])
                for k, v in out.items()}

    @staticmethod
    def _stacked(batch, names, ring):
        """The batch's columns of one lane as one (len(names), b, ...) tensor of the
        ring's dtype (a view, for a lane of one column)."""
        import torch

        if len(names) == 1:
            return batch[names[0]].to(ring.dtype).unsqueeze(0)
        return torch.stack([batch[n].to(ring.dtype) for n in names])

    def push(self, batch):
        """Insert a device batch; returns the displaced batch once warm, else None."""
        import torch

        batch = self._local(batch)
        if self._lanes is None:
            self._init_store(batch)
        b = next(iter(batch.values())).shape[0]
        if set(batch) != set(self._names):
            raise ValueError("batch columns %s do not match buffer columns %s"
                             % (sorted(batch), sorted(self._names)))
        if self._fill_rows < self.capacity:
            if b > self._batch_rows:
                raise ValueError(
                    "warmup batches must not exceed the first batch's row count (%d), "
                    "got %d" % (self._batch_rows, b))
            if self._short_warmup:
                raise ValueError(
                    "a batch shorter than the first batch's row count is only legal as "
                    "the FINAL push of a stream (warmup writes would overrun the ring "
                    "and lose rows); drain() after the short batch")
            if b < self._batch_rows:
                self._short_warmup = True
            for names, ring in self._lanes:
                ring[:, self._fill_rows:self._fill_rows + b].copy_(
                    self._stacked(batch, names, ring))
            self._fill_rows += b
            return None
        if b > self._batch_rows:
            # an oversized batch would need more slots than one exchange frees
            raise ValueError("batches must not exceed the first batch's row count (%d), "
                             "got %d" % (self._batch_rows, b))
        slots = torch.randperm(self.capacity, generator=self._generator,
                               device=self._generator.device)[:b]
        out = {}
        for names, ring in self._lanes:
            taken = ring.index_select(1, slots)  # gather first: a fresh tensor
            ring.index_copy_(1, slots, self._stacked(batch, names, ring))
            out.update(zip(names, taken.unbind(0)))
        return self._emit(out)

    def drain(self, batch_rows=None):
        """Emit the resident rows as a fresh permutation, in batches of ``batch_rows``
        (default: the push batch size; the final batch may be short). The ring is empty
        afterwards."""
        import torch

        if self._lanes is None or self._fill_rows == 0:
            return
        b = batch_rows or self._batch_rows
        filled = self._fill_rows
        perm = torch.randperm(filled, generator=self._generator,
                              device=self._generator.device)
        shuffled = {}
        for names, ring in self._lanes:
            shuffled.update(zip(names, ring[:, :filled].index_select(1, perm).unbind(0)))
        names = self._names
        self._lanes = None
        self._fill_rows = 0
        for start in range(0, filled, b):
            yield self._emit({k: shuffled[k][start:start + b] for k in names})
