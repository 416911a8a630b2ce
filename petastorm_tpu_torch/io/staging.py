"""Pinned-host staging ring for the transfer thread's H2D copies.

Port of ``petastorm_tpu.io.staging.PinnedStagingPool``. A copy from pageable numpy
memory makes the CUDA runtime bounce through its own staging buffer, synchronously.
This pool keeps a small ring of page-locked slabs (``torch.empty(..., pin_memory=True)``):
:meth:`PinnedStagingPool.to_device` copies a request's arrays into one slab
(:meth:`~PinnedStagingPool.reserve` lets a producer write them there directly, and
:meth:`~PinnedStagingPool.reserve_bytes` hands out raw room filled front to back), launches
ONE ``.to(device, non_blocking=True)`` of the used span on the current stream (the
loader's transfer stream) and returns device views into it. The slab goes back to the
ring when a CUDA event recorded after that copy has completed, so a slab is never
rewritten under an in-flight DMA (the event replaces the JAX package's
``jax.block_until_ready``).

Degradations (never failures), counted in :data:`DEGRADATIONS` and logged once:

- ``staging_unpinned``: the slabs could not be page-locked; they stay pooled but pageable.
- ``staging_oversized``: a request larger than a slab is copied on its own, unpooled.
"""
from __future__ import annotations

import collections
import logging
import threading

import numpy as np

logger = logging.getLogger(__name__)

#: per-array offsets inside a slab are rounded up to this
_STAGE_ALIGN = 256

#: cause -> occurrences, process-wide
DEGRADATIONS = collections.Counter()
_degradation_lock = threading.Lock()


def _degrade(cause, msg, *args):
    with _degradation_lock:
        first = DEGRADATIONS[cause] == 0
        DEGRADATIONS[cause] += 1
    if first:
        logger.warning("[%s] " + msg, cause, *args)


def _torch_dtype(np_dtype):
    import torch

    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


class PinnedStagingPool:
    """Ring of ``num_slabs`` page-locked host slabs of ``slab_bytes`` each.

    ``slab_bytes=None`` sizes the slabs from the first :meth:`to_device` request (the
    loader's first batch) and allocates them then."""

    def __init__(self, slab_bytes=None, num_slabs=3):
        if (slab_bytes is not None and slab_bytes <= 0) or num_slabs <= 0:
            raise ValueError("slab_bytes and num_slabs must be positive")
        self.slab_bytes = None
        self._num_slabs = int(num_slabs)
        self._slabs = []
        self._free = collections.deque()
        self._in_flight = collections.deque()  # (slab id, event) in submission order
        if slab_bytes is not None:
            self._allocate(int(slab_bytes))

    def _allocate(self, slab_bytes):
        import torch

        self.slab_bytes = slab_bytes
        for i in range(self._num_slabs):
            try:
                slab = torch.empty(slab_bytes, dtype=torch.uint8, pin_memory=True)
            except RuntimeError as e:
                _degrade("staging_unpinned", "could not page-lock a %d-byte staging slab "
                         "(%s); slabs are pooled but PAGEABLE", slab_bytes, e)
                slab = torch.empty(slab_bytes, dtype=torch.uint8)
            self._slabs.append(slab)
            self._free.append(i)

    def _acquire(self):
        """A free slab id: reclaim slabs whose copies completed, else wait for the
        oldest in-flight copy."""
        while self._in_flight and self._in_flight[0][1].query():
            self._free.append(self._in_flight.popleft()[0])
        if not self._free:
            slab_id, event = self._in_flight.popleft()
            event.synchronize()
            self._free.append(slab_id)
        return self._free.popleft()

    def reserve_bytes(self, nbytes):
        """Claim room for ``nbytes`` in one slab (a slab-less pool allocates its slabs at
        this size).

        Returns ``(host, upload)``: a flat uint8 numpy view the caller fills from the
        front, and ``upload(device, used)``, which the caller must call once, after
        filling: it launches ONE non-blocking copy of ``host[:used]`` on the current
        CUDA stream and returns it as a uint8 device tensor."""
        import torch

        nbytes = int(nbytes)
        if self.slab_bytes is None:
            self._allocate(nbytes)
        if nbytes > self.slab_bytes:
            _degrade("staging_oversized", "request of %d bytes exceeds the %d-byte "
                     "staging slab; copying it unpooled", nbytes, self.slab_bytes)
            host = np.empty(nbytes, np.uint8)
            return host, lambda device, used: torch.from_numpy(host[:used]).to(device)
        slab_id = self._acquire()
        slab = self._slabs[slab_id]

        def upload(device, used):
            if not 0 <= used <= nbytes:
                raise ValueError("upload of %d bytes from a %d-byte reservation"
                                 % (used, nbytes))
            dev = slab[:used].to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            self._in_flight.append((slab_id, event))
            return dev

        return slab.numpy()[:nbytes], upload

    def reserve(self, specs):
        """Claim room for arrays of ``specs`` (``(shape, numpy dtype)`` pairs) in one slab.

        Returns ``(views, upload)``: numpy arrays the caller fills (views into the slab),
        and ``upload(device)``, which the caller must call once, after filling: it
        launches ONE non-blocking copy of the used span on the current CUDA stream and
        returns the device tensors, in order."""
        specs = [(tuple(shape), np.dtype(dtype)) for shape, dtype in specs]
        sizes = [int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
                 for shape, dtype in specs]
        spans = []
        end = 0
        for nbytes in sizes:
            start = -(-end // _STAGE_ALIGN) * _STAGE_ALIGN
            end = start + nbytes
            spans.append(start)
        host, send = self.reserve_bytes(end)
        views = [host[start:start + nbytes].view(dtype).reshape(shape)
                 for (shape, dtype), start, nbytes in zip(specs, spans, sizes)]

        def upload(device):
            dev = send(device, end)
            return [dev[start:start + nbytes].view(_torch_dtype(dtype)).view(shape)
                    for (shape, dtype), start, nbytes in zip(specs, spans, sizes)]

        return views, upload

    def to_device(self, arrays, device):
        """Copy ``arrays`` (numpy) into one slab and upload it with one non-blocking copy
        on the current CUDA stream; returns the device tensors, in order."""
        views, upload = self.reserve([(a.shape, a.dtype) for a in arrays])
        for dst, a in zip(views, arrays):
            np.copyto(dst, a)
        return upload(device)

    def close(self):
        """Wait for in-flight copies and drop the slabs (idempotent; a later
        :meth:`to_device` allocates anew)."""
        while self._in_flight:
            self._in_flight.popleft()[1].synchronize()
        self._slabs = []
        self._free.clear()
        self.slab_bytes = None
