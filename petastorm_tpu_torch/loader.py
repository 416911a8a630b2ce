"""``DataLoader``: reader batches → batches of torch tensors on one device.

Port of the core of ``petastorm_tpu.loader.DataLoader``. An async pipeline:

    reader (columnar numpy) → [pad_shapes] → host re-batch [+ shuffling buffer]
        → host-batch queue
        → transfer thread, on its own CUDA stream: the compressed-page inflate
          (pass-through columns; kernels K3, the run scan and K4), batched on-device JPEG
          decode (stage 2, kernel K1), pinned staging + non-blocking H2D of the other
          numeric columns, [the device shuffle ring,] the optional device transform
          (e.g. ``normalize_images``, kernel K2, or a ``FeaturePipeline``)
        → device-batch queue → consumer

so the training step's per-batch cost is a queue pop. Each device batch carries a CUDA
event recorded on the transfer stream after its last operation; the consumer's stream
waits on it and every delivered tensor is marked as used by the consumer's stream
(``record_stream``), so the caching allocator never hands its memory back to the
transfer stream while the consumer may still read it.

The parameters are the JAX package's, in its order, with ``device`` (keyword only) after
them. ``device=None`` means the CUDA device; without one the loader raises. Tests pass
``device="cpu"``: the same pipeline runs the kernels' plain PyTorch versions.
``to_device=False`` delivers host numpy after the staged decode, as the JAX package does.

A process pool's view wire (``wire_serializer='shm-view'``) delivers batches that view
pool slabs. The producer takes each delivery's lease from the reader; every batch cut
from it holds the lease until the transfer thread has read its host arrays (the staged
decode has packed its coefficients into the upload region, the inflate stage has copied
its pages, the other columns are staged), and only then is the slab free for reuse.
Where rows linger (the shuffling buffer) or are restacked (a per-row reader), the views
are copied out instead.

``pad_shapes`` zero-pads ragged tensor columns to a static shape in the producer, with
a ``name__mask`` column of the valid region, so they reach the device as ordinary
columns. ``state_dict()`` checkpoints at the consumer watermark: the newest reader state
whose deliveries the consumer has fully taken (:mod:`petastorm_tpu_torch.checkpoint`).
NGram windows arrive as flat ``offset/field`` columns (a per-row reader's ``{offset:
row}`` windows are flattened in the producer), so ``pad_shapes`` and a device transform
key by the flat name.

:class:`InMemDataLoader` fills device memory once through a ``DataLoader`` and serves
every epoch from it, one gather a batch; :func:`make_dataloader` is the one-call
``make_batch_reader`` + ``DataLoader``.

``trace=`` (a :class:`~petastorm_tpu_torch.trace.TraceRecorder`) records one span a
stage occurrence: ``reader.next``, ``batch.form`` and ``wait.host_queue_put`` on the
producer thread, ``wait.host_queue``, ``decode.device_inflate``, ``decode.dispatch`` and
``h2d.transfer`` on the transfer thread, ``wait.device_queue`` on the consumer; the
reader's pool and readahead spans join them. A span is host wall time around the
enqueue and launch of a stage's work: no span waits for the card.
``metrics=`` (a :class:`~petastorm_tpu_torch.obs.metrics.MetricsRegistry`, or True for
the process-wide one) adds the ``ptpu_pipeline_*``, ``ptpu_wire_*`` and ``ptpu_io_*``
families and a latency histogram a stage; :meth:`DataLoader.bottleneck_report` names the
limiting side.

``health=`` (or ``PTPU_HEALTH``) arms the stall watchdog
(:mod:`petastorm_tpu_torch.obs.health`): the producer heartbeats as ``loader.producer``
(``read``, ``batch``, ``wait:host_queue_put``), the transfer thread as
``loader.transfer`` (``decode`` from the inflate stage through the staged decode,
``h2d`` through the upload and the device transform, ``wait:host_queue`` and
``wait:device_queue_put``), and the reader's pool and IO threads heartbeat as their
modules say. A full queue is a ``wait:`` state, never a stall. The kernels build at their
first call, on the transfer thread inside a busy state (``decode``, or ``h2d`` for a
device transform's kernel): a cold build under a threshold of a few seconds can trip the
watchdog (the default threshold is 120 s). ``slos=`` evaluates
:class:`~petastorm_tpu_torch.obs.slo.SloSpec` objectives over the ``metrics=``
registry's windows (:mod:`petastorm_tpu_torch.obs.timeseries`), on whatever cadence
samples them (a :class:`~petastorm_tpu_torch.obs.export.Reporter`, or
``registry.sample_timelines()``).

``provenance=`` (or ``PTPU_PROVENANCE``) arms the attribution plane
(:mod:`petastorm_tpu_torch.obs.provenance`): every row group's spans through the reader,
the pool and its wire, and the batch plane's own (``loader.collate``,
``loader.host_queue_put``, ``decode.device_inflate``, ``loader.decode``, ``loader.h2d``)
recorded once in :meth:`DataLoader._timed` beside the trace, with no second clock; each
delivered batch knows the items that fed it. :meth:`DataLoader.attribution_report` folds
them into the critical path's per-site self seconds
(:mod:`petastorm_tpu_torch.obs.critical_path`), and with ``slos=`` each alert names its
culprit site. The spans are host time: ``loader.decode`` times the enqueue of the staged
decode's kernels, and ``decode.device_inflate`` includes its one read back to the host.

``controller=`` (with ``metrics=``) closes the loop
(:mod:`petastorm_tpu_torch.control`): a :class:`~petastorm_tpu_torch.control.Controller`
evaluates each window of the registry's time series and retunes the reader's live knobs
(readahead depth and bytes, the GET pool, the hedge quantile, the mem tier, the fleet
size) within its anti-oscillation contract; it only reads windows and never runs on the
loader's threads. ``tenant=`` bills this pipeline's work to a tenant
(:mod:`petastorm_tpu_torch.obs.tenant`): the reader charges rows, worker seconds and IO,
the loader its decode seconds.

``sharding=`` (a :class:`~petastorm_tpu_torch.parallel.mesh.NamedSharding` over a
torch ``DeviceMesh``, or a dict of them by field) feeds a ``torch.distributed`` job, one
card a rank (:mod:`petastorm_tpu_torch.parallel.mesh`). ``batch_size`` is then GLOBAL:
each rank's reader reads its shard (``cur_shard=rank``), its producer cuts the rank's
share (``local_batch_size``), the transfer thread runs the inflate, the staged decode and
the device transform on the rank's own card (every card of the mesh decodes its share at
once), and each delivered field is a ``DTensor`` whose local tensor is the rank's rows
(:func:`~petastorm_tpu_torch.parallel.mesh.to_dtensor`, the counterpart of
``jax.make_array_from_process_local_data``); a world of one delivers DTensors too, so a
step's code is the same at 1 and N ranks. The device transform runs on the rank's local
tensors before that wrap (a kernel reads raw pointers and cannot take a DTensor), where
the JAX package jits it over the global array: the same for row-wise transforms.
"""
from __future__ import annotations

import collections
import contextlib
import inspect
import itertools
import logging
import os
import queue
import threading
import time

import numpy as np

from petastorm_tpu_torch import chaos as _chaos
# at import, on the importing thread: pyarrow (which codecs imports) must not load first
# on the transfer thread. pyarrow's mimalloc first initialised on a thread that exits
# later faults in concurrent parquet reads (a trainer fed by a ServiceReader touches
# pyarrow nowhere else)
from petastorm_tpu_torch.codecs import CompressedImageCodec
from petastorm_tpu_torch.io.lease import attach_leases, count_copy, take_leases
from petastorm_tpu_torch.io.pagedec import (PassthroughColumn, is_passthrough,
                                            materialize_columns, pagedec_counters)
from petastorm_tpu_torch.obs import tenant as _tenant
from petastorm_tpu_torch.parallel.mesh import process_group, to_local
from petastorm_tpu_torch.shuffle import BatchedRandomShufflingBuffer
from petastorm_tpu_torch.utils import stack_as_column

logger = logging.getLogger(__name__)

_SENTINEL = object()

#: pipeline ids of the health scopes: loaders sharing one HealthMonitor must not share
#: heartbeat slots
_pipeline_seq = itertools.count()

#: slab size of the inflate stage's pinned ring: a batch's compressed pages, all columns
#: (a larger request is copied unpooled, counted as ``staging_oversized``)
_PAGE_SLAB_BYTES = 4 << 20


class PipelineStats:
    """Cheap per-stage counters for the loader pipeline; the same field names as the JAX
    package's, so reports line up.

    All times are cumulative seconds since the last ``reset()``:

    - ``read_s``: producer time blocked on the reader (parquet IO + worker decode)
    - ``batch_s``: producer time re-batching/shuffling host rows
    - ``put_wait_s``: producer time blocked putting into a FULL host-batch queue
    - ``decode_s``: transfer-thread time in batched on-device codec decode (enqueue)
    - ``inflate_s``: transfer-thread time in the compressed-page inflate stage (page
      packing, upload, kernel launches and the stage's reads back to the host)
    - ``h2d_s``: transfer-thread time staging and enqueuing host-to-device copies
    - ``queue_wait_s``: transfer-thread time starved waiting on the host-batch queue
    - ``device_queue_wait_s``: consumer time starved waiting on the device-batch queue

    The decode and H2D stages launch asynchronous CUDA work, so their seconds are host
    enqueue time; the inflate stage waits for the card where it reads values back.
    ``inflate_s`` is the port's own field (the JAX package counts the same time in its
    ``ptpu_pagedec_inflate_seconds`` histogram). The ``shm_*`` fields are the process
    pool's shared-memory wire gauges (``Reader.wire_stats()``), refreshed at each
    delivery. ``decode_unsharded_batches`` counts batches whose staged decode ran on
    fewer of the mesh's cards than the rank owns: with one card a rank every decode runs
    on the rank's card, so it stays 0 (the JAX package counts a batch whose sharding
    splits the batch axis but whose decode ran on one device, which under one card a
    rank would be every batch).
    """

    __slots__ = ("rows", "batches", "read_s", "batch_s", "put_wait_s",
                 "decode_s", "h2d_s",
                 "queue_wait_s", "device_queue_wait_s", "decode_unsharded_batches",
                 "shm_slabs_in_flight", "shm_bytes", "shm_fallbacks",
                 "shm_acquire_wait_s", "inflate_s")

    def __init__(self):
        self.reset()

    def reset(self):
        self.rows = 0
        self.batches = 0
        self.read_s = 0.0
        self.batch_s = 0.0
        self.put_wait_s = 0.0
        self.decode_s = 0.0
        self.h2d_s = 0.0
        self.queue_wait_s = 0.0
        self.device_queue_wait_s = 0.0
        self.decode_unsharded_batches = 0
        self.shm_slabs_in_flight = 0
        self.shm_bytes = 0
        self.shm_fallbacks = 0
        self.shm_acquire_wait_s = 0.0
        self.inflate_s = 0.0

    def snapshot(self):
        return {
            "rows": self.rows,
            "batches": self.batches,
            "read_s": round(self.read_s, 4),
            "batch_s": round(self.batch_s, 4),
            "put_wait_s": round(self.put_wait_s, 4),
            "decode_s": round(self.decode_s, 4),
            "h2d_s": round(self.h2d_s, 4),
            "queue_wait_s": round(self.queue_wait_s, 4),
            "device_queue_wait_s": round(self.device_queue_wait_s, 4),
            "decode_unsharded_batches": self.decode_unsharded_batches,
            "shm_slabs_in_flight": self.shm_slabs_in_flight,
            "shm_bytes": self.shm_bytes,
            "shm_fallbacks": self.shm_fallbacks,
            "shm_acquire_wait_s": round(self.shm_acquire_wait_s, 4),
            "inflate_s": round(self.inflate_s, 4),
        }

    def update_wire(self, wire_stats):
        """Fold in the pool's shared-memory gauges (a ``Reader.wire_stats()`` dict)."""
        if not wire_stats:
            return
        self.shm_slabs_in_flight = wire_stats.get("shm_slabs_in_flight", 0)
        self.shm_bytes = wire_stats.get("shm_bytes", 0)
        self.shm_fallbacks = wire_stats.get("shm_fallbacks", 0)
        self.shm_acquire_wait_s = wire_stats.get("shm_acquire_wait_s", 0.0)


#: the stage keys of the loader's latency histograms; the trace span names map 1:1
#: (reader.next -> read, batch.form -> batch, ...)
_OBS_STAGES = ("read", "batch", "host_queue_put", "host_queue_wait", "decode",
               "device_inflate", "h2d", "device_queue_wait")


class _LoaderObs:
    """Pre-resolved metric handles of one loader's hot path, built only for
    ``DataLoader(metrics=...)`` (the disabled path is one ``is None`` check a site).

    Holds one log-bucketed latency histogram a pipeline stage
    (``ptpu_pipeline_stage_seconds{stage=...}``) and registers pull collectors: the
    ``PipelineStats`` totals and the live queue depths as ``ptpu_pipeline_*``, and the
    reader's ``wire_stats()`` as ``ptpu_wire_*``. One metrics-enabled loader a registry
    at a time: the families carry no per-loader label.

    With provenance on, the recorder's summary exports as ``ptpu_prov_*``. The reader's
    ``io_stats()`` exports as ``ptpu_io_*`` (the ``io`` collector: the
    readahead pool's, the caches', the ranged-GET engine's and the arena's counts under
    the JAX package's key names; a process pool's children's counts, nested, are not
    exported), and a health monitor's heartbeats as ``ptpu_health_*``.

    The loader and its reader are held through WEAK references: a caller that skips the
    context-manager teardown leaves collectors that go quiet once the loader is
    collected, instead of pinning it or freezing its last gauges into every snapshot.
    """

    def __init__(self, registry, loader):
        import weakref

        self.registry = registry
        self._hists = {
            stage: registry.histogram(
                "ptpu_pipeline_stage_seconds",
                help="per-occurrence pipeline stage latency (seconds)", stage=stage)
            for stage in _OBS_STAGES}
        self._handles = [registry.register_collector("pipeline", self._collect_pipeline)]
        health = getattr(loader, "_health", None)
        if health is not None:
            # the monitor's lifetime is the loader's; close() unregisters it with the rest
            self._handles.append(registry.register_collector("health", health.collect))
        self._loader_ref = weakref.ref(loader)
        wire_stats_fn = getattr(loader.reader, "wire_stats", None)
        if wire_stats_fn is not None:
            wire_ref = weakref.WeakMethod(wire_stats_fn)
            self._handles.append(registry.register_collector(
                "wire", lambda: (wire_ref() or dict)()))
        io_stats_fn = getattr(loader.reader, "io_stats", None)
        if io_stats_fn is not None:
            io_ref = weakref.WeakMethod(io_stats_fn)
            self._handles.append(registry.register_collector(
                "io", lambda: (io_ref() or dict)()))
        prov = getattr(loader, "_prov_rec", None)
        if prov is not None:
            # the attribution plane: item and batch counts and the per-site critical-path
            # self seconds as ptpu_prov_* (the stats CLI's attribution panel)
            prov_ref = weakref.ref(prov)
            self._handles.append(registry.register_collector(
                "prov", lambda: (lambda r: r.summary() if r is not None
                                 else {})(prov_ref())))

    def add_collector(self, prefix, fn):
        """Register one more pull collector, unregistered with the rest at close."""
        self._handles.append(self.registry.register_collector(prefix, fn))

    def observe(self, stage, dur):
        self._hists[stage].observe(dur)

    def stage_histograms(self):
        return dict(self._hists)

    def _collect_pipeline(self):
        loader = self._loader_ref()
        if loader is None:
            return {}
        out = dict(loader.stats.snapshot())
        q = loader._queue
        dq = loader._dev_queue
        out["host_queue_depth"] = q.qsize() if q is not None else 0
        out["device_queue_depth"] = dq.qsize() if dq is not None else 0
        return out

    def close(self):
        """Unregister the pull collectors (loader ``__exit__``): a torn-down pipeline
        stops contributing stale families; the histograms stay readable."""
        handles, self._handles = self._handles, []
        for handle in handles:
            self.registry.unregister_collector(handle)


def _is_device_dtype(arr):
    """Only numeric/bool fixed-shape columns go to the device; strings/objects stay host."""
    return isinstance(arr, np.ndarray) and arr.dtype.kind in "biufc"


class _HostBatcher:
    """Accumulates columnar chunks and cuts exact fixed-size batches.

    A chunk added with a lease (its arrays view a pool slab) holds the lease once a
    column entry; each batch cut from it retains the lease (a
    :class:`~petastorm_tpu_torch.io.lease.LeasedBatch`), and the batcher's own holds drop
    as its chunks drain. Leases ride the plain path only: the shuffling buffer's callers
    copy views out first."""

    def __init__(self, batch_size, shuffling_queue_capacity=0, seed=None):
        self.batch_size = batch_size
        if shuffling_queue_capacity and shuffling_queue_capacity > 0:
            self._buffer = BatchedRandomShufflingBuffer(
                shuffling_queue_capacity,
                min_after_retrieve=min(shuffling_queue_capacity // 2,
                                       shuffling_queue_capacity - 1),
                batch_size=batch_size,
                seed=seed,
            )
        else:
            self._buffer = None
            # {name: list of [array, offset, lease]}: the remainder stays an offset into
            # the head chunk instead of a fresh slice per cut
            self._pending = {}
            self._pending_rows = 0

    def _cut_one(self, take):
        merged = {}
        batch_leases = {}
        drained = []
        for name, chunks in self._pending.items():
            parts = []
            need = take
            while need > 0:
                entry = chunks[0]
                arr, off, lease = entry
                if lease is not None:
                    batch_leases[id(lease)] = lease
                avail = len(arr) - off
                if avail > need:
                    parts.append(arr[off:off + need])
                    entry[1] = off + need
                    need = 0
                else:
                    parts.append(arr[off:] if off else arr)
                    chunks.pop(0)
                    if lease is not None:
                        drained.append(lease)
                    need -= avail
            merged[name] = parts[0] if len(parts) == 1 else _concat(parts)
        self._pending_rows -= take
        merged = attach_leases(merged, [lease.retain() for lease in batch_leases.values()])
        for lease in drained:
            lease.release()
        return merged

    def _plain_cut(self, final=False):
        out = []
        while self._pending_rows >= self.batch_size:
            out.append(self._cut_one(self.batch_size))
        if final and self._pending_rows > 0:
            out.append(self._cut_one(self._pending_rows))
        return out

    def add(self, columns, lease=None):
        """Feed one columnar chunk (and the ownership of ``lease``, when its arrays view
        a slab); returns the list of ready full-size batches."""
        if self._buffer is None:
            n = None
            for name, arr in columns.items():
                self._pending.setdefault(name, []).append(
                    [arr, 0, None if lease is None else lease.retain()])
                n = len(arr)
            if lease is not None:
                lease.release()  # the reference handed in: now held once a column entry
            if n is not None:
                self._pending_rows += n
            return self._plain_cut()
        if lease is not None:
            lease.release()  # callers copy views out before the shuffling buffer
        ready = []
        self._buffer.add_many(columns)
        while self._buffer.can_retrieve:
            ready.append(self._buffer.retrieve())
        return ready

    def finish(self):
        """Flush remaining rows as (possibly short) final batches."""
        if self._buffer is None:
            return self._plain_cut(final=True)
        self._buffer.finish()
        ready = []
        while self._buffer.can_retrieve:
            ready.append(self._buffer.retrieve())
        return ready

    def close(self):
        """Drop the holds on still-pending leased chunks (a producer stopped mid-epoch:
        rows that never formed a batch)."""
        if self._buffer is not None:
            return
        for chunks in self._pending.values():
            for _arr, _off, lease in chunks:
                if lease is not None:
                    lease.release()
        self._pending.clear()
        self._pending_rows = 0


def _release_leases(batch):
    """Release every lease a batch holds (no-op for plain dicts)."""
    for lease in take_leases(batch):
        lease.release()


def _detach_views(columns):
    """Copy every read-only slab view out of a view-wire delivery before it enters a
    stage the lease cannot ride (the shuffling buffer, a per-row reader's restacking):
    read-only arrays, read-only elements of object columns, and staged payloads with a
    ``detach()``. Charged to the ``loader_detach`` copy-census site."""
    out = {}
    copied = 0
    for name, v in columns.items():
        if isinstance(v, np.ndarray):
            if v.dtype.hasobject:
                fresh = np.empty(v.shape, dtype=object)
                for idx, e in np.ndenumerate(v):
                    if isinstance(e, np.ndarray) and not e.flags.writeable:
                        copied += e.nbytes
                        e = e.copy()
                    elif hasattr(e, "detach"):
                        e = e.detach()
                    fresh[idx] = e
                v = fresh
            elif not v.flags.writeable:
                copied += v.nbytes
                v = v.copy()
        out[name] = v
    count_copy("loader_detach", copied)
    return out


def _batch_row_count(batch):
    """Rows in a batch (leading dim of the first column; 0 when empty)."""
    if not batch:
        return 0
    return int(len(next(iter(batch.values()))))


def _batch_valid_rows(batch):
    """Rows the reader delivered in a host batch: a ``last_batch='pad'`` tail repeats
    its last row up to the batch size with a ``__valid__`` mask, and the padding must not
    advance the consumer watermark past the producer's delivered-row log."""
    if not batch:
        return 0
    valid = batch.get("__valid__")
    if isinstance(valid, np.ndarray) and valid.dtype == np.bool_:
        return int(valid.sum())
    return _batch_row_count(batch)


def _pad_ragged_columns(columns, pad_shapes):
    """Zero-pad ragged tensor columns to their declared max shape, plus a validity mask
    ``name__mask`` (the JAX package's ``_pad_ragged_columns``).

    Runs in the producer, before the shuffling buffer and the batcher, so every later
    stage sees static shapes."""
    columns = dict(columns)
    for name, target in pad_shapes.items():
        col = columns.get(name)
        if col is None:
            continue
        if isinstance(col, np.ndarray) and col.dtype != object:
            if col.shape[1:] == tuple(target):  # already uniform at the max: mask only
                columns[name + "__mask"] = np.ones(col.shape, dtype=bool)
                continue
            col = list(col)  # uniform but below the max: padded like a ragged column
        rows = [np.asarray(r) for r in col]
        target = tuple(target)
        out = np.zeros((len(rows),) + target, dtype=rows[0].dtype if rows else np.float64)
        mask = np.zeros((len(rows),) + target, dtype=bool)
        for i, r in enumerate(rows):
            if r.ndim != len(target):
                raise ValueError(
                    "pad_shapes[%r]=%r has rank %d but row %d has rank %d"
                    % (name, target, len(target), i, r.ndim)
                )
            if any(a > t for a, t in zip(r.shape, target)):
                raise ValueError(
                    "Row %d of field %r has shape %r exceeding declared pad max %r"
                    % (i, name, r.shape, target)
                )
            region = tuple(slice(0, s) for s in r.shape)
            out[i][region] = r
            mask[i][region] = True
        columns[name] = out
        columns[name + "__mask"] = mask
    return columns


def _concat(chunks):
    chunks = [c for c in chunks if len(c)]
    if not chunks:
        return np.empty((0,))
    if len(chunks) == 1:
        return chunks[0]
    if any(is_passthrough(c) for c in chunks):
        if all(is_passthrough(c) for c in chunks):
            # window chaining, not a copy: the batch keeps riding raw pages
            return PassthroughColumn.concat(chunks)
        # mixed chunk types for one column (read before and after a loader adopted
        # the reader): the decoded form is the common denominator
        chunks = [c.materialize() if is_passthrough(c) else c for c in chunks]
    if any(c.dtype == object for c in chunks):
        out = np.empty(sum(len(c) for c in chunks), dtype=object)
        pos = 0
        for c in chunks:
            out[pos:pos + len(c)] = c
            pos += len(c)
        return out
    return np.concatenate(chunks, axis=0)


def _materialize_passthrough(batch, cause):
    """Inflate any compressed-page pass-through columns with the host twin: counted in
    ``pagedec_counters()["host_inflate_columns"]``, and warned once when ``cause`` names a
    seam that bypasses the device inflate stage (None: host delivery, the designed
    host seam)."""
    n = sum(1 for v in batch.values() if is_passthrough(v))
    if n:
        pagedec_counters()["host_inflate_columns"].inc(n)
    return materialize_columns(batch, cause)


def _validate_decode_resize(resize, device_fields):
    """``device_decode_resize`` normalised and checked at construction: ``None``, an
    ``(h, w)`` pair, or a dict of such pairs keyed by device-decoded field. A misspelled
    key or a malformed target fails here, not later as a mixed-size error (the JAX
    package's ``_validate_decode_resize``)."""
    if resize is None:
        return None
    if not device_fields:
        raise ValueError(
            "device_decode_resize was given but the reader has no device-decoded "
            "fields — open it with decode_on_device=True (and an image-codec "
            "column) for the on-device resize to apply")

    def check_target(t, label):
        try:
            h, w = int(t[0]), int(t[1])
        except (TypeError, ValueError, IndexError):
            raise ValueError(
                "device_decode_resize%s must be an (h, w) pair, got %r" % (label, t))
        if h <= 0 or w <= 0 or len(tuple(t)) != 2:
            raise ValueError(
                "device_decode_resize%s must be two positive ints, got %r" % (label, t))
        return (h, w)

    if isinstance(resize, dict):
        known = set(device_fields or ())
        unknown = set(resize) - known
        if unknown:
            raise ValueError(
                "device_decode_resize names %s, but the reader's device-decoded "
                "fields are %s (is decode_on_device=True set, and are the names "
                "spelled right?)" % (sorted(unknown), sorted(known)))
        return {k: check_target(v, "[%r]" % k) for k, v in resize.items()}
    return check_target(resize, "")


def _flatten_ngram_window(window):
    """{offset: row} NGram window → one flat {'offset/field': value} row: every
    timestep's tensors reach the device as ordinary static-shape columns, and
    ``pad_shapes`` and device transforms key by names like ``'0/image'``."""
    flat = {}
    for off, row in window.items():
        row = row._asdict() if hasattr(row, "_asdict") else row
        for name, value in row.items():
            flat["%s/%s" % (off, name)] = value
    return flat


def _rows_to_columns(rows, object_fields=()):
    """Row dicts/namedtuples → columnar numpy dict (per-row ``make_reader`` path).

    ``object_fields`` are forced to object dtype: device-decode staging columns may mix
    JpegPlanes payloads with host-fallback ndarrays across rows."""
    if not rows:
        return {}
    if hasattr(rows[0], "_asdict"):
        rows = [r._asdict() for r in rows]
    return {
        name: stack_as_column([r[name] for r in rows], force_object=name in object_fields)
        for name in rows[0].keys()
    }


def _put_with_stop(q, item, stop_event):
    """Bounded-queue put that gives up once the loader is stopped. Returns False when
    stopped."""
    full = queue.Full  # bound early: may run during interpreter teardown
    while True:
        try:
            q.put(item, timeout=0.1)
            return True
        except full:
            if stop_event.is_set():
                return False


def _drain(q):
    """Empty a pipeline queue; host batches in it will never transfer, so their leases
    are released."""
    try:
        while True:
            item = q.get_nowait()
            if isinstance(item, dict):
                _release_leases(item)
    except queue.Empty:
        pass


def _put_sentinel(q, stop_event):
    """Deliver the end-of-stream sentinel even when the consumer is slow (retry until
    it lands or the loader is stopped)."""
    full = queue.Full
    while True:
        try:
            q.put(_SENTINEL, timeout=1)
            return
        except full:
            if stop_event.is_set():
                return


def _named_shardings(sharding):
    """The :class:`~petastorm_tpu_torch.parallel.mesh.NamedSharding` values of a loader's
    ``sharding`` (itself, or a dict's non-None values). Anything else raises
    ``ValueError``, as the JAX package's ``device_put`` refuses an object that is not a
    sharding (there at the first transfer, here at construction)."""
    from petastorm_tpu_torch.parallel.mesh import NamedSharding

    values = list(sharding.values()) if isinstance(sharding, dict) else [sharding]
    for s in values:
        if s is not None and not isinstance(s, NamedSharding):
            raise ValueError(
                "sharding must be a petastorm_tpu_torch.parallel.mesh.NamedSharding (or a "
                "dict of them by field, None for a field left local), got %r" % (s,))
    return [s for s in values if s is not None]


def _resolve_device(device, sharding=None):
    """The loader's device: ``device``, else the sharding's mesh device on this rank,
    else the CUDA device (raises without one). A ``device`` that contradicts the mesh
    raises ``ValueError``."""
    import torch

    named = _named_shardings(sharding) if sharding is not None else []
    if named:
        from petastorm_tpu_torch.parallel.mesh import mesh_device

        mesh_devs = {mesh_device(s.mesh) for s in named}
        if len(mesh_devs) > 1:
            raise ValueError("the sharding's fields lie on meshes of different devices "
                             "on this rank: %s" % sorted(map(str, mesh_devs)))
        mesh_dev = mesh_devs.pop()
        if device is None:
            return mesh_dev
        dev = _resolve_device(device)
        if dev != mesh_dev:
            raise ValueError(
                "device=%s contradicts the sharding's mesh, whose device on this rank is "
                "%s (one card a rank: the mesh's device type decides where batches land)"
                % (dev, mesh_dev))
        return dev
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "DataLoader: no CUDA device. petastorm_tpu_torch runs on the GPU unless "
                "the caller asks for the CPU (DataLoader(..., device='cpu')).")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _resolve_device_transform(device_transform, reader):
    """The device function the loader applies: a declarative ``FeaturePipeline``
    compiled against the reader's delivered schema, the given callable, or (when none is
    given) the reader's own ``TransformSpec(device=True)``."""
    if getattr(device_transform, "declarative", False):
        if getattr(reader, "ngram", None) is not None:
            # the pipeline's ops name schema fields, but NGram batches are keyed
            # 'offset/field'
            raise ValueError(
                "a declarative FeaturePipeline cannot be the device_transform of an "
                "NGram reader: batches are keyed 'offset/field', not by schema field "
                "names. Pass a function written against the flat columns instead.")
        # statistics-dependent ops must have been resolved: device_fn raises with the
        # fix otherwise
        return device_transform.device_fn(reader.schema)
    if device_transform is not None:
        return device_transform
    spec = getattr(reader, "transform_spec", None)
    if spec is not None and spec.device and spec.func is not None:
        if getattr(reader, "ngram", None) is not None:
            raise ValueError(
                "a device TransformSpec cannot be auto-applied to an NGram reader: "
                "batches are keyed 'offset/field', not by schema field names. Pass "
                "DataLoader(device_transform=...) written against the flat "
                "'offset/field' columns instead.")
        return spec.func
    return None


class DataLoader:
    """Iterable of batches: ``{field: torch.Tensor}`` on ``device`` (numeric fields and
    device-decoded images), host numpy for string/object fields.

    Parameters
    ----------
    reader : petastorm_tpu_torch.reader.Reader
        Batch reader (columnar) or per-row reader (rows are stacked host-side). A
        :class:`~petastorm_tpu_torch.service.client.ServiceReader`
        (:func:`~petastorm_tpu_torch.reader.make_service_reader`) plugs in unchanged:
        its batches come from a shared decode fleet instead of a local pool, with the
        same batch and checkpoint semantics, through the same H2D copy and device
        transform.
    batch_size : int
        GLOBAL rows per yielded batch: rows across all ranks. Under a ``sharding`` whose
        batch axis spans ranks each rank cuts only its share (``local_batch_size``), and
        the delivered DTensor is global; in a world of one (or with a replicated batch
        axis) local == global.
    sharding : NamedSharding or dict, optional
        Layout of the yielded tensors (:mod:`petastorm_tpu_torch.parallel.mesh`): a
        ``NamedSharding(mesh, spec)`` over a torch ``DeviceMesh``, adapted to each
        field's rank, or ``{field: NamedSharding or None}`` (None: that field stays a
        plain local tensor). Each rank's share is delivered as a ``DTensor`` (see the
        module docstring). The mesh's device on this rank is the loader's device.
    shuffling_queue_capacity : int
        >0 enables a host-side row shuffling buffer (reference ``shuffling_queue_capacity``).
    seed : int, optional
        Seeds the shuffling buffer and the generator handed to a two-argument
        ``device_transform``.
    last_batch : {"drop", "pad", "partial"}
        Remainder policy. ``drop`` (default) keeps shapes static; ``pad`` repeats the last
        row up to ``batch_size`` and adds a boolean ``__valid__`` mask column; ``partial``
        yields the short batch.
    device_transform : callable or FeaturePipeline, optional
        ``fn(batch) -> batch`` applied on the device after transfer, on the transfer
        stream (e.g. ``normalize_images``). A two-argument ``fn(batch, generator)``
        receives a ``torch.Generator`` on the device, seeded from ``seed`` — the hook for
        random augmentation. A declarative
        :class:`~petastorm_tpu_torch.ops.tabular.FeaturePipeline` runs through its
        ``device_fn(reader.schema)``. Without one, a reader opened with a
        ``TransformSpec(device=True)`` (declarative or not) supplies it.
    prefetch : int
        Device batches kept in flight by the transfer thread. 0 transfers synchronously
        on the consumer thread.
    to_device : bool
        False yields host numpy dicts: staged (``decode_on_device``) fields are still
        decoded on ``device`` and brought back, pass-through columns inflate on the host
        twin, and the device transform is not applied (as in the JAX package).
    host_queue_size : int
        Host batches buffered between the producer and the transfer thread.
    device_decode_resize : (h, w) or {field: (h, w)}, optional
        Lifts the uniform-size requirement of the device decode for mixed-size stores:
        each decoded image is resized to ``(h, w)`` on the device (host-decoded rows
        with cv2), so every batch leaves with one shape. Validated here.
    staging : None, bool or int, optional
        Pinned-host H2D staging (:class:`petastorm_tpu_torch.io.staging.PinnedStagingPool`).
        Default ``None`` = on for a CUDA device, off for the CPU; ``False`` disables; an
        ``int`` forces it on with that slab size in bytes (otherwise sized from the first
        upload).
    pad_shapes : dict, optional
        ``{field: max_shape}``: ragged tensor fields are zero-padded to ``max_shape`` in
        the producer, with a boolean ``field__mask`` column marking each row's valid
        region; both reach the device as ordinary columns. A ragged field without a pad
        shape cannot reach the device and raises.
    device_shuffle_capacity : int
        >0 puts a device shuffle ring of about this many rows
        (:class:`petastorm_tpu_torch.ops.device_shuffle.DeviceShuffleBuffer`, rounded up
        to a batch multiple) between the transfer and the device transform: each batch
        swaps into the ring and the displaced rows are delivered (exactly once, a
        decorrelation window of about the capacity, one gather and one scatter a column a
        batch). Requires ``to_device=True`` and every delivered column on the device (no
        strings). Seeded from ``seed``.
    trace : petastorm_tpu_torch.trace.TraceRecorder, optional
        Records a span for every stage occurrence (see the module docstring), and is
        handed to the reader (``Reader.set_trace``).
    metrics : MetricsRegistry or True, optional
        Stage latency histograms and the pipeline's gauges on this registry (True: the
        process-wide one); collectors unregister at ``__exit__``.
    health : True, HealthOptions or HealthMonitor, optional
        Stall monitoring (:mod:`petastorm_tpu_torch.obs.health`): every pipeline actor
        heartbeats and a watchdog thread calls an actor stalled when its heartbeat ages
        past its role's threshold in a busy state (a full queue never counts). ``True``:
        the defaults; a ``HealthOptions`` tunes thresholds, poll interval and escalation
        (``"raise"`` delivers a :class:`~petastorm_tpu_torch.errors.StallError` to the
        consumer; ``"heal"`` first lets the process pool kill a hung child); a
        ``HealthMonitor`` is shared (the caller owns it, and this loader's actors are
        scoped under ``pipeN/``). ``PTPU_HEALTH=1`` turns it on without code.
        :meth:`health_report` works whenever it is on; with ``metrics=`` the heartbeat
        ages export as ``ptpu_health_*``.
    slos : sequence of SloSpec, or an SloEngine, optional
        Objectives evaluated on each window of the ``metrics=`` registry's time series
        (required: ``ValueError`` without ``metrics=``). A window is one
        ``registry.sample_timelines()``, which a ``Reporter`` on that registry calls
        each flush. Debounced breaches fire ``slo_breach`` degradations and count
        ``ptpu_slo_alerts_total``; read them from :meth:`slo_alerts`. A pre-built
        :class:`~petastorm_tpu_torch.obs.slo.SloEngine` is shared and stays attached at
        ``__exit__``. With ``provenance=`` each alert carries an
        :meth:`attribution_report` snapshot naming the culprit site.
    provenance : True or ProvenanceRecorder, optional
        Causal per-item provenance (:mod:`petastorm_tpu_torch.obs.provenance`): every
        dispatched row group accumulates ``(site, t_start, t_end, pid)`` spans and
        annotations (the cache tier that served it, hedges, retries, quarantine, the
        readahead hit or miss) through the whole pipeline, a process pool's children
        included, and each delivered batch knows its contributing items.
        :meth:`batch_provenance` returns the latest batch's record and
        :meth:`attribution_report` folds the window into the critical path's per-site
        self times. ``True`` builds a recorder (released at ``__exit__``); a recorder
        the reader factory built (``provenance=`` there) is adopted; a
        :class:`~petastorm_tpu_torch.obs.provenance.ProvenanceRecorder` passed here is
        shared and stays armed. One armed recorder a process. ``PTPU_PROVENANCE=1``
        turns it on without code. Under shuffling (either buffer) batch membership is
        unknown (``items`` is None); the item records still collect.
    controller : True, ControlOptions or Controller, optional
        The closed-loop controller (:mod:`petastorm_tpu_torch.control`; requires
        ``metrics=``): on each window of the registry's time series it retunes the
        reader's live knobs through :func:`~petastorm_tpu_torch.control.build_knobset`
        (readahead depth and bytes, the GET pool's width, the hedge quantile, the mem
        tier's budget, disk admission, the fleet size: a shrink drains, never kills
        mid-item), with hysteresis, debounce, cooldowns, step limits and the
        revert-and-freeze no-gain guard. ``True``: the default rules; a
        ``ControlOptions`` tunes warmup, cooldown and the guard; a ``Controller`` is
        shared (the caller's: never detached here). With ``provenance=`` the rules read
        the attribution report. Decisions are ``ctl_actuate`` / ``ctl_revert`` /
        ``ctl_freeze`` degradation events and ``ptpu_ctl_*`` families; read them from
        :meth:`ctl_decisions` and :attr:`controller`.
    tenant : str or TenantContext, optional
        Who this pipeline's work is billed to (:mod:`petastorm_tpu_torch.obs.tenant`):
        this argument, else the reader's tenant, else the thread's or process's current
        one. The loader charges its decode seconds (``ptpu_tenant_decode_seconds_total``).
    device : torch.device or str, optional, keyword only
        Where batches land (and where staged fields decode). Default: the sharding's mesh
        device on this rank, else the CUDA device (raises when there is none). A device
        that contradicts the mesh raises ``ValueError``.

    A loader over a checkpointable reader checkpoints at its consumer's watermark
    (:meth:`state_dict`); it duck-types as a reader for
    :mod:`petastorm_tpu_torch.checkpoint`.
    """

    def __init__(self, reader, batch_size, sharding=None, shuffling_queue_capacity=0,
                 seed=None, last_batch="drop", device_transform=None, prefetch=2,
                 to_device=True, host_queue_size=8, pad_shapes=None,
                 device_shuffle_capacity=0, device_decode_resize=None, trace=None,
                 metrics=None, health=None, staging=None, provenance=None,
                 slos=None, controller=None, tenant=None, *, device=None):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if last_batch not in ("drop", "pad", "partial"):
            raise ValueError("last_batch must be drop|pad|partial, got %r" % last_batch)
        if device_shuffle_capacity and not to_device:
            raise ValueError("device_shuffle_capacity requires to_device=True "
                             "(the ring lives in device memory)")
        #: who the decode seconds are billed to: the explicit argument, else the reader's
        #: tenant, else the current one; None: untagged
        self.tenant_context = (_tenant.resolve(tenant, env_default=False)
                               or getattr(reader, "tenant_context", None)
                               or _tenant.current())
        #: rows THIS rank cuts a batch (== batch_size unless the sharding's batch axis
        #: spans ranks: batch_size is global)
        self.local_batch_size = _resolve_local_batch(int(batch_size), sharding)
        self.sharding = sharding
        self._declared = _declared_shapes(reader)
        self.device = _resolve_device(device, sharding)
        if staging and self.device.type != "cuda":
            raise ValueError("staging=%r needs a CUDA device, got %s" % (staging, self.device))
        self.reader = reader
        self.batch_size = int(batch_size)
        self.last_batch = last_batch
        self.prefetch = int(prefetch)
        self.to_device = bool(to_device)
        self._device_decode_resize = _validate_decode_resize(
            device_decode_resize, getattr(reader, "device_decode_fields", None))
        self._seed = seed
        self._pad_shapes = dict(pad_shapes) if pad_shapes else {}
        self._shuffling_queue_capacity = shuffling_queue_capacity
        self._host_queue_size = host_queue_size
        self._device_shuffle_capacity = int(device_shuffle_capacity or 0)
        self._device_transform = _resolve_device_transform(device_transform, reader)
        self._transform_takes_generator = None
        self._generator = None
        #: pinned H2D staging ring (None for the CPU or when disabled); its slabs are
        #: allocated at the first upload, sized from it unless ``staging`` gave a size
        self._staging = None
        if self.device.type == "cuda" and staging is not False:
            from petastorm_tpu_torch.io.staging import PinnedStagingPool

            self._staging = PinnedStagingPool(
                None if staging in (None, True) else int(staging), num_slabs=4)
        #: pinned ring for the compressed pages of the inflate stage (CUDA only; made at
        #: its first use, sized from it)
        self._page_staging = None
        #: compressed-page pass-through adoption: this loader finishes the inflate
        #: itself (kernels on a CUDA device, the host twin on the CPU), so the reader
        #: stops materializing PassthroughColumn values at delivery, and its
        #: ``pagedec="auto"`` engages when this device is a card. Undone at __exit__.
        self._adopted_passthrough = False
        if getattr(reader, "is_batched_reader", False) \
                and hasattr(reader, "adopt_passthrough"):
            reader.adopt_passthrough(on_device=self.device.type == "cuda" and self.to_device)
            self._adopted_passthrough = True
        self._stream = None
        self._pad_cache = {}
        self._producer = None
        self._queue = None
        self._dev_queue = None
        self._transfer_thread = None
        self._stop = threading.Event()
        self._producer_error = None
        #: False while a watchdog StallError is pending that no consumer has seen: the
        #: next __iter__ raises it instead of clearing it into an empty epoch
        self._producer_error_delivered = True
        #: bumped by every _start_producer(): a superseded iterator's finalizer must not
        #: stop the pipeline a newer __iter__ armed
        self._generation = 0
        self.stats = PipelineStats()
        #: span recorder (None: disabled, one check a stage site)
        self._trace = trace
        if trace is not None and hasattr(reader, "set_trace"):
            reader.set_trace(trace)
        self._init_health(health, metrics)
        self._init_provenance(provenance, trace, shuffling_queue_capacity)
        #: stage histograms and pull collectors (None: disabled)
        self._obs = None
        if metrics:
            from petastorm_tpu_torch.obs.metrics import MetricsRegistry, default_registry

            registry = metrics if isinstance(metrics, MetricsRegistry) \
                else default_registry()
            self._obs = _LoaderObs(registry, self)
        #: the SLO engine over the registry's windows (None: disabled); it runs on the
        #: sampling cadence, never on this loader's threads
        self._slo_engine = None
        self._slo_owned = False
        if slos:
            if self._obs is None:
                raise ValueError(
                    "DataLoader(slos=...) requires metrics=: the SLO engine evaluates "
                    "the metrics registry's windowed time series")
            from petastorm_tpu_torch.obs.slo import SloEngine

            registry = self._obs.registry
            if isinstance(slos, SloEngine):
                # caller-supplied and shared: never detached at __exit__, never moved
                # off a store its caller attached it to
                engine = slos
                if engine._registry is None:
                    engine._registry = registry
                if engine._store is None:
                    engine.attach(registry.timeline_store())
            else:
                engine = SloEngine(specs=list(slos), registry=registry)
                engine.attach(registry.timeline_store())
                self._slo_owned = True
            if engine._attribution is None and self._prov_rec is not None:
                # each alert names the site that owns the slow batches' critical path
                engine.set_attribution(self.attribution_report)
            self._slo_engine = engine
        self._init_controller(controller)
        # consumer-watermark checkpointing (see state_dict): the producer logs
        # (cumulative delivered rows, reader state) at its deliveries, the consumer counts
        # the rows it has taken, and state_dict() returns the newest logged state the
        # consumer has caught up to. Off under shuffling, where state_dict() refuses (and
        # behind the device ring the consumer's count would never catch the log up).
        self._ckpt_enabled = (hasattr(reader, "state_dict")
                              and not shuffling_queue_capacity
                              and not self._device_shuffle_capacity)
        self._ckpt_lock = threading.Lock()
        self._ckpt_log = collections.deque()
        self._ckpt_base = None
        self._rows_consumed = 0

    def _init_controller(self, controller):
        """The closed loop of ``controller=``: a loader-built controller over the
        reader's standard knobs, or a caller's shared one, on the registry's window
        cadence."""
        #: the Controller (None: off) and whether this loader built it (and so detaches
        #: it at __exit__)
        self._controller = None
        self._ctl_owned = False
        if not controller:
            return
        if self._obs is None:
            raise ValueError(
                "DataLoader(controller=...) requires metrics=: the controller reads the "
                "metrics registry's windowed time series")
        from petastorm_tpu_torch.control import ControlOptions, Controller, build_knobset

        registry = self._obs.registry
        if isinstance(controller, Controller):
            # the caller's, shared: never detached here (as a shared SLO engine)
            ctl = controller
            if ctl._registry is None:
                ctl._registry = registry
            if ctl._store is None:
                ctl.attach(registry.timeline_store())
        else:
            options = controller if isinstance(controller, ControlOptions) else None
            ctl = Controller(build_knobset(self.reader), registry=registry,
                             options=options)
            ctl.attach(registry.timeline_store())
            self._ctl_owned = True
        if ctl._attribution is None and self._prov_rec is not None:
            ctl.set_attribution(self.attribution_report)
        self._controller = ctl
        self._obs.add_collector("ctl", ctl.collect)

    def _init_health(self, health, metrics):
        """The health wiring of ``health=`` (None: the ``PTPU_HEALTH`` switch): the
        monitor, this pipeline's scope on it, the flight-record context and the
        fail-fast callback, the reader's pool and IO threads, and the watchdog."""
        from petastorm_tpu_torch.obs.health import normalize_health

        self._health, self._health_owned = normalize_health(health)
        self._health_scope = None
        self._health_handles = ()
        self._hb_transfer = None  # the transfer thread's heartbeat while it runs
        if self._health is None:
            return
        import weakref

        monitor = self._health
        if self._health_owned:
            self._health_scope = monitor  # an exclusive monitor: bare actor names
            prefix = None
        else:
            # a shared monitor: this pipeline's actors get their own slots, so another
            # loader's healthy stamps cannot mask this one's stall
            prefix = "pipe%d" % next(_pipeline_seq)
            self._health_scope = monitor.scoped(prefix)
        ref = weakref.ref(self)  # a shared monitor must not pin a dead loader
        self._health_handles = (
            monitor.add_context(
                "pipeline" if prefix is None else "pipeline/%s" % prefix,
                lambda: (lambda ld: ld._health_context() if ld is not None
                         else {})(ref())),
            monitor.add_stall_callback(
                lambda err: (lambda ld: ld._fail_fast(err) if ld is not None
                             else None)(ref()),
                prefix=prefix))
        if self._health_owned and metrics:
            # before the reader's pool is wired below: its workers record latencies as
            # soon as set_health lands, and set_registry is a no-op after that
            from petastorm_tpu_torch.obs.metrics import MetricsRegistry, default_registry

            monitor.set_registry(metrics if isinstance(metrics, MetricsRegistry)
                                 else default_registry())
        if hasattr(self.reader, "set_health"):
            self.reader.set_health(self._health_scope)
        monitor.start()

    def _init_provenance(self, provenance, trace, shuffling_queue_capacity):
        """The attribution plane of ``provenance=``: adopt the recorder the reader's
        factory attached (armed before its pool started, so it saw every item), share
        a caller's recorder, or build one (None: the ``PTPU_PROVENANCE`` switch)."""
        from petastorm_tpu_torch.obs import provenance as prov_mod

        #: the ProvenanceRecorder (None: off, one check a site) and whether this loader
        #: built it, and so releases it at __exit__
        self._prov_rec = None
        self._prov_owned = False
        existing = getattr(self.reader, "_prov", None)
        if isinstance(provenance, prov_mod.ProvenanceRecorder):
            rec = provenance.arm()  # the caller's: stays armed past __exit__
        elif existing is not None:
            rec = existing.arm()  # the reader's: its join() releases it
        else:
            rec = prov_mod.resolve(provenance)
            self._prov_owned = rec is not None
        if rec is None:
            return
        if trace is not None:
            rec.set_trace(trace)  # flow events linking each item's spans in the dump
        rec.set_batch_tracking(not shuffling_queue_capacity
                               and not self._device_shuffle_capacity)
        if hasattr(self.reader, "set_provenance") and existing is not rec:
            self.reader.set_provenance(rec)
        self._prov_rec = rec

    def _timed(self, span, stage, t0, site=None):
        """Seconds since ``t0``, recorded as a ``span`` in the trace, as a ``stage``
        observation in the metrics, and as the provenance ``site`` of the batch in
        transfer, when each is on (host time only: nothing here waits for the card)."""
        dt = time.perf_counter() - t0
        if self._trace is not None:
            self._trace.add(span, t0, dt)
        if self._obs is not None:
            self._obs.observe(stage, dt)
        if site is not None and self._prov_rec is not None:
            self._prov_rec.transfer_span(site, t0, dt)
        return dt

    # -- producer (background thread: reader → host batches) ---------------------------

    def _ckpt_record(self, cum_rows):
        """Log the reader's state as of ``cum_rows`` delivered rows, dropping the entries
        the consumer has already passed (the log stays about in-flight sized)."""
        state = self.reader.state_dict()
        with self._ckpt_lock:
            log = self._ckpt_log
            c = self._rows_consumed
            while len(log) >= 2 and log[1][0] <= c:
                log.popleft()
            if log and log[0][0] <= c:
                self._ckpt_base = log.popleft()[1]
            log.append((cum_rows, state))

    def _produce(self, q):
        batcher = _HostBatcher(self.local_batch_size, self._shuffling_queue_capacity,
                               self._seed)
        stats = self.stats
        device_fields = getattr(self.reader, "device_decode_fields", ())
        batched = bool(getattr(self.reader, "is_batched_reader", False))
        ngram = getattr(self.reader, "ngram", None) is not None
        wire_stats = getattr(self.reader, "wire_stats", None)
        if wire_stats is not None and not wire_stats():
            wire_stats = None  # a thread or dummy pool, or a socket wire: no gauges
        # on a view wire the plain batched path takes each delivery's lease; the
        # shuffling buffer and per-row readers copy the views out instead
        wire_views = bool(getattr(self.reader, "wire_views", False))
        lease_mode = wire_views and batched and not self._shuffling_queue_capacity
        ckpt_cum = 0  # rows the reader delivered in this iteration
        ckpt_deliveries = 0
        ckpt_next_snap = 1
        # one heartbeat for this thread (None: health off), registered through the
        # scope; the flight ring gets the read span of each delivery
        scope = self._health_scope
        hb = flight = None
        if scope is not None:
            hb = scope.register("loader.producer", "producer")
            flight = scope.flight
        try:
            it = iter(self.reader)
            while True:
                if hb is not None:
                    hb.beat("read")
                t0 = time.perf_counter()
                item = next(it, _SENTINEL)
                dt = self._timed("reader.next", "read", t0)
                stats.read_s += dt
                if flight is not None:
                    flight.record("span", name="read", dur_s=round(dt, 6))
                if wire_stats is not None:
                    stats.update_wire(wire_stats())
                if item is _SENTINEL:
                    if self._ckpt_enabled and ckpt_deliveries:
                        # the all-delivered state must be reachable even when the
                        # throttle skipped the last deliveries
                        self._ckpt_record(ckpt_cum)
                    break
                if self._stop.is_set():
                    return
                if hb is not None:
                    hb.beat("batch")
                t0 = time.perf_counter()
                if batched:
                    # a batched NGram reader delivers plain dicts of flat columns
                    columns = item._asdict() if hasattr(item, "_asdict") else item
                    columns = {k: v for k, v in columns.items() if v is not None}
                else:
                    if ngram:
                        item = _flatten_ngram_window(item)
                    columns = _rows_to_columns([item], object_fields=device_fields)
                lease = self.reader.take_lease() if lease_mode else None
                if wire_views and not lease_mode:
                    columns = _detach_views(columns)
                if self._pad_shapes:
                    columns = _pad_ragged_columns(columns, self._pad_shapes)
                if self._shuffling_queue_capacity:
                    # the shuffling buffer permutes ROWS: compressed pages cannot be
                    # row-permuted without decoding, so this seam inflates on the host
                    columns = _materialize_passthrough(columns, "pagedec_host_inflate")
                    # rows linger in the shuffling buffer across row groups: staged
                    # payloads that view a row group's stacked buffers are detached, or one
                    # straggler row pins its whole group's memory
                    for name in device_fields:
                        col = columns.get(name)
                        if col is not None and col.dtype == object:
                            for i, v in enumerate(col):
                                if hasattr(v, "detach"):
                                    col[i] = v.detach()
                ready = batcher.add(columns, lease)
                dt = self._timed("batch.form", "batch", t0)
                stats.batch_s += dt
                if self._ckpt_enabled:
                    ckpt_cum += _batch_row_count(columns)
                    # snapshots at delivery boundaries (a batched reader's items are row
                    # groups; a per-row reader's at batch cuts), thinned out after 512
                    # so that a long epoch does not make the producer quadratic
                    ckpt_deliveries += 1
                    if (ready or batched) and ckpt_deliveries >= ckpt_next_snap:
                        self._ckpt_record(ckpt_cum)
                        ckpt_next_snap = ckpt_deliveries + max(1, ckpt_deliveries // 512)
                if not self._deliver_batches(q, ready, hb, collate_span=(t0, dt)):
                    return
            # under last_batch='drop' the shuffling buffer can still hold whole batches at
            # reader exhaustion — only the short tail is dropped
            if not self._deliver_batches(q, batcher.finish(), hb,
                                         drop_short=self.last_batch == "drop"):
                return
        except Exception as e:  # noqa: BLE001 — surfaced to the consumer thread
            self._producer_error = e
            if flight is not None:
                flight.record("producer_error", error=repr(e))
        finally:
            batcher.close()
            if flight is not None:
                flight.record("queue", event="producer_end_of_stream")
            if hb is not None:
                hb.done()
            _put_sentinel(q, self._stop)

    def _deliver_batches(self, q, batches, hb=None, drop_short=False, collate_span=None):
        """Push cut batches into the host queue, padding per ``last_batch``. Returns
        False once the loader is stopped. A batch that is dropped, or not delivered
        because the loader stopped, releases its leases here.

        With provenance each batch opens its record here: its items from the delivery
        FIFO, an equal share of the ``collate_span`` ``(t0, seconds)`` that cut it, and
        its ``loader.host_queue_put`` span; a batch that dies on this path is retired, so
        the transfer and delivery pointers stay aligned."""
        rec = self._prov_rec
        collate_t0 = collate_share = None
        if rec is not None and collate_span is not None and batches:
            collate_t0 = collate_span[0]
            collate_share = collate_span[1] / len(batches)
        for i, batch in enumerate(batches):
            bp = None
            if rec is not None:
                bp = rec.producer_cut(_batch_row_count(batch), collate_t0, collate_share)
            if self._stop.is_set():
                if bp is not None:
                    rec.batch_dropped(bp)
                for b in batches[i:]:
                    _release_leases(b)
                return False
            if drop_short and _batch_row_count(batch) < self.local_batch_size:
                if bp is not None:
                    rec.batch_dropped(bp)
                _release_leases(batch)
                continue
            if self.last_batch == "pad":
                batch = self._pad(batch)
            if hb is not None:
                # a full host queue is backpressure: the consumer side is the slow one
                hb.wait("host_queue_put")
            t0 = time.perf_counter()
            ok = _put_with_stop(q, batch, self._stop)
            dt = self._timed("wait.host_queue_put", "host_queue_put", t0)
            self.stats.put_wait_s += dt
            if bp is not None:
                rec.batch_span(bp, "loader.host_queue_put", t0, dt)
            if hb is not None:
                hb.beat("batch")
            if not ok:
                if bp is not None:
                    rec.batch_dropped(bp)
                for b in batches[i:]:
                    _release_leases(b)
                return False
        return True

    def _pad(self, batch):
        n = _batch_row_count(batch)
        if n == 0 or n == self.local_batch_size:
            if batch and "__valid__" not in batch:
                batch["__valid__"] = np.ones(n, dtype=bool)
            return batch
        pad = self.local_batch_size - n
        # pass-through columns inflate on host before the gather below (a short TAIL
        # batch only — full batches never reach this line)
        leases = take_leases(batch)
        batch = _materialize_passthrough(batch, "pagedec_host_inflate")
        cached = self._pad_cache.get(n)
        if cached is None:
            idx = np.concatenate([np.arange(n), np.full(pad, n - 1)])
            valid = np.concatenate([np.ones(n, dtype=bool), np.zeros(pad, dtype=bool)])
            cached = self._pad_cache[n] = (idx, valid)
        idx, valid = cached
        out = {name: arr[idx] for name, arr in batch.items()}
        if leases:
            # the gather copied the arrays but only the outer pointers of object columns:
            # their elements may still view the slabs the release below frees
            out = _detach_views(out)
            for lease in leases:
                lease.release()
        out["__valid__"] = valid.copy()
        return out

    # -- transfer (decode + H2D + device transform) -------------------------------------

    def _start_producer(self):
        """Arm the pipeline for a fresh iteration (on the consumer thread). A new
        ``__iter__`` supersedes any previous one: the old pipeline is stopped and joined
        first."""
        alive = [t for t in (self._producer, self._transfer_thread)
                 if t is not None and t.is_alive()]
        if alive:
            self.stop()
            self.join()
            if any(t.is_alive() for t in alive):
                raise RuntimeError(
                    "previous DataLoader iteration did not shut down within the join "
                    "timeout; cannot safely start a new iteration")
        self._generation += 1
        self._stop.clear()
        pending = self._producer_error
        if pending is not None and not self._producer_error_delivered:
            from petastorm_tpu_torch.errors import StallError

            if isinstance(pending, StallError):
                # the watchdog failed fast while no consumer iterated (before the first
                # iteration or between epochs): the reader is stopped already and the
                # debounced watchdog will not report the same hang again, so clearing
                # it here would turn a detected stall into a silently empty epoch
                self._producer_error_delivered = True
                raise pending
        self._producer_error = None
        self._producer_error_delivered = True
        self.stats.reset()
        if self._ckpt_enabled:
            with self._ckpt_lock:
                # a fresh watermark for each iteration: the base is the reader's state
                # before any of this iteration's deliveries
                self._ckpt_log.clear()
                self._ckpt_base = self.reader.state_dict()
                self._rows_consumed = 0
        self._queue = queue.Queue(maxsize=max(2, self._host_queue_size))
        self._dev_queue = None
        self._producer = threading.Thread(target=self._produce, args=(self._queue,),
                                          name="ptpu-torch-loader", daemon=True)
        self._producer.start()

    def _host_batches(self, q):
        stats = self.stats
        while True:
            hb = self._hb_transfer  # set only while the transfer thread runs
            if hb is not None:
                hb.wait("host_queue")  # starved: the producer's side is the slow one
            t0 = time.perf_counter()
            item = q.get()
            stats.queue_wait_s += self._timed("wait.host_queue", "host_queue_wait", t0)
            if item is _SENTINEL:
                if self._producer_error is not None:
                    self._producer_error_delivered = True
                    raise self._producer_error
                return
            stats.batches += 1
            stats.rows += _batch_row_count(item)
            yield item

    def _decode_staged(self, batch):
        """Finish the two-stage codec decode on the device: staging-payload columns (JPEG
        coefficient planes from ``decode_on_device=True`` readers) become device tensors,
        one batched codec decode per column."""
        fields = getattr(self.reader, "device_decode_fields", None)
        if not fields:
            return batch, {}
        batch = dict(batch)
        decoded = {}
        for name in fields:
            arr = batch.pop(name, None)
            if arr is None:
                continue
            field = self.reader.schema.fields[name]
            if not isinstance(field.codec, CompressedImageCodec):
                raise TypeError("field %r: no device decode for codec %r"
                                % (name, field.codec))
            staged = list(arr)
            if any(s is None for s in staged):
                raise ValueError(
                    "Field %r has null rows; nullable columns are not supported with "
                    "decode_on_device (pad or filter nulls upstream)" % name)
            resize = self._device_decode_resize
            if isinstance(resize, dict):
                resize = resize.get(name)
            decoded[name] = field.codec.device_decode_batch(
                field, staged, self.device, stager=self._staging, resize_to=resize)
        return batch, decoded

    def _pages_stager(self):
        """The pinned ring the inflate stage packs compressed pages into (CUDA only)."""
        if self.device.type != "cuda" or self._staging is None:
            return None
        if self._page_staging is None:
            from petastorm_tpu_torch.io.staging import PinnedStagingPool

            self._page_staging = PinnedStagingPool(_PAGE_SLAB_BYTES, num_slabs=4)
        return self._page_staging

    def _inflate_passthrough(self, batch):
        """The inflate stage of the compressed-page pass-through: PassthroughColumn
        values → tensors on the device through the kernels
        (:mod:`petastorm_tpu_torch.ops.pagedec_kernels`) on a CUDA device; on the CPU
        the host twin decodes them, and the arrays ride the normal upload (with
        ``PTPU_PAGEDEC_DEVICE=1`` the CPU runs the kernels' plain versions instead).
        Returns ``(batch_without_passthrough, {name: tensor})``.

        Accounting (``pagedec_counters()``): pages and compressed/saved bytes for every
        pass-through column; ``host_inflate_columns`` for each one the host twin decoded
        (the CPU without the switch); the stage's seconds in ``inflate_seconds`` and
        ``PipelineStats.inflate_s``. When the kernels reject a column's pages
        (:class:`DeviceInflateError`), the host twin classifies the same pages without
        delivering them: ``PagedecCorruptError`` when the bytes are bad,
        :class:`KernelFaultError` when the twin decodes them."""
        names = [name for name, v in batch.items() if is_passthrough(v)]
        if not names:
            return batch, {}
        from petastorm_tpu_torch.ops import pagedec_kernels as pk

        hb = self._hb_transfer
        if hb is not None:
            # busy: the inflate's one read back to the host waits for the card here
            hb.beat("decode")

        counters = pagedec_counters()
        t0 = time.perf_counter()
        if _chaos.ACTIVE is not None:
            _chaos.ACTIVE.hit("decode.device_inflate")
        use_device = self.device.type == "cuda" \
            or os.environ.get("PTPU_PAGEDEC_DEVICE", "") not in ("", "0")
        batch = dict(batch)
        cols = {}
        for name in names:
            col = batch.pop(name)
            counters["pages"].inc(sum(
                (p1 - p0) + (1 if c.dict_page is not None else 0)
                for c, s, t in col.parts
                for p0, p1, _base in (c.covering_pages(s, t),)))
            shipped = col.shipped_nbytes
            counters["bytes_compressed"].inc(shipped)
            counters["bytes_saved"].inc(max(0, col.raw_nbytes - shipped))
            if not use_device:
                counters["host_inflate_columns"].inc()
                batch[name] = col.materialize()
                continue
            cols[name] = col
        inflated = {}
        if cols:
            try:
                # one upload, one launch each of K3, the scan and K4, and one read back
                inflated = pk.inflate_columns(cols, self.device, self._pages_stager())
            except pk.DeviceInflateError as e:
                cols[e.column].materialize()  # raises PagedecCorruptError on bad bytes
                raise pk.KernelFaultError(
                    "column %r: the device inflate rejected pages that the host twin "
                    "decodes (%s)" % (e.column, e)) from e
        dt = self._timed("decode.device_inflate", "device_inflate", t0,
                         site="decode.device_inflate")
        counters["inflate_seconds"].observe(dt)
        self.stats.inflate_s += dt
        return batch, inflated

    def _transfer_batch(self, batch):
        """Pass-through inflate, staged decode and upload of the numeric columns.
        Returns the device tensors and the host-only (string/object) columns
        separately."""
        import torch

        hb = self._hb_transfer
        if self._prov_rec is not None:
            # host batches reach this thread in FIFO order: the recorder's transfer
            # pointer moves to this batch's record
            self._prov_rec.transfer_next()
        batch, inflated = self._inflate_passthrough(batch)
        if hb is not None:
            hb.beat("decode")
        t0 = time.perf_counter()
        batch, decoded = self._decode_staged(batch)
        dt = self._timed("decode.dispatch", "decode", t0, site="loader.decode")
        self.stats.decode_s += dt
        if self.tenant_context is not None:
            _tenant.charge("decode_s", dt, label=self.tenant_context.tenant)
        if hb is not None:
            # busy through the upload (the pinned slab's reuse may wait for the card)
            # and the device transform
            hb.beat("h2d")
        t0 = time.perf_counter()
        device = {k: v for k, v in batch.items() if _is_device_dtype(v)}
        host = {k: v for k, v in batch.items() if k not in device}
        for name, arr in host.items():
            if isinstance(arr, np.ndarray) and arr.dtype == object and len(arr) \
                    and isinstance(arr[0], (np.ndarray, list, tuple)):
                raise ValueError(
                    "Field %r holds ragged tensors and cannot reach the device with a "
                    "static shape. Declare DataLoader(pad_shapes={%r: (max_dims...)}) "
                    "to zero-pad it (a %s__mask column marks the valid region)."
                    % (name, name, name)
                )
        names = list(device)
        if self._staging is not None and names:
            tensors = self._staging.to_device([device[k] for k in names], self.device)
        else:
            # torch tensors must own writable memory: Arrow's zero-copy columns are not
            tensors = [torch.from_numpy(np.require(device[k], requirements=["C", "W"]))
                       .to(self.device) for k in names]
        arrays = dict(zip(names, tensors))
        arrays.update(decoded)
        arrays.update(inflated)
        self.stats.h2d_s += self._timed("h2d.transfer", "h2d", t0, site="loader.h2d")
        return arrays, host

    def _apply_device_transform(self, arrays):
        """The device transform on this rank's tensors, then the sharding's delivery
        (:func:`_deliver`). DTensors coming in (from the device ring) are unwrapped to
        their local tensors first: the transform runs on the rank's card."""
        if self.sharding is not None:
            arrays = {k: to_local(v) for k, v in arrays.items()}
        if self._device_transform is not None:
            arrays = self._call_device_transform(arrays)
        return _deliver(self.sharding, arrays, self._declared)

    def _call_device_transform(self, arrays):
        import torch

        if self._transform_takes_generator is None:
            try:
                n_params = len(inspect.signature(self._device_transform).parameters)
            except (TypeError, ValueError):
                n_params = 1
            self._transform_takes_generator = n_params >= 2
        if self._transform_takes_generator:
            if self._generator is None:
                self._generator = torch.Generator(device=self.device)
                rank, world = process_group()
                # each rank draws its own stream (the JAX package draws one key for the
                # global batch); a world of one keeps the unsharded loader's draws
                seed = self._seed or 0
                self._generator.manual_seed(seed if world == 1 else _fold_seed(seed, rank))
            return self._device_transform(arrays, self._generator)
        return self._device_transform(arrays)

    def _transfer(self, batch):
        """:meth:`_transfer_batch` holding the batch's leases until every host array of
        it has been read. Returns ``(device tensors, host-only columns)``."""
        leases = take_leases(batch)
        try:
            arrays, host = self._transfer_batch(batch)
            if leases:
                host = _detach_views(host)  # the consumer keeps these past the release
        finally:
            # every host array of the batch has been read: packed into the upload
            # region, copied into the page slab, or staged; the slabs may be reused
            for lease in leases:
                lease.release()
        return arrays, host

    def _to_device(self, batch):
        arrays, host = self._transfer(batch)
        arrays = self._apply_device_transform(arrays)
        arrays.update(host)
        return arrays

    def _plain_batches(self, host_q):
        """host batches → ``(device batch, rows the reader delivered in it)``."""
        for batch in self._host_batches(host_q):
            if self._stop.is_set():
                _release_leases(batch)
                return
            rows = _batch_valid_rows(batch)
            yield self._to_device(batch), rows

    def _shuffled_batches(self, host_q, shuffler):
        """host batches → device batches through the device shuffle ring: each
        transferred batch (untransformed) is exchanged in the ring and the displaced rows
        go on to the device transform; the residue drains at the end. Yields ``(batch,
        0)``: the ring's loader takes no checkpoint, so its consumer counts no rows."""
        for batch in self._host_batches(host_q):
            if self._stop.is_set():
                _release_leases(batch)
                return
            arrays, host = self._transfer(batch)
            if host:
                raise ValueError(
                    "device_shuffle_capacity requires every delivered column to be "
                    "device-resident, but %s are host-only (strings/objects cannot live "
                    "in the device ring). Narrow schema_fields or drop the device "
                    "shuffle." % sorted(host))
            out = shuffler.push(arrays)
            if out is not None:
                yield self._apply_device_transform(out), 0
        for out in shuffler.drain():
            if self._stop.is_set():
                return
            yield self._apply_device_transform(out), 0

    def _device_batches(self, host_q):
        """host batches → ``(device batch, event, rows)``, on the transfer stream for a
        CUDA device; the event marks the batch's last operation on that stream, ``rows``
        are the reader's rows the batch carries (the consumer watermark's step). With
        ``device_shuffle_capacity`` the batches pass through the device shuffle ring
        between the transfer and the device transform."""
        import torch

        cuda = self.device.type == "cuda"
        if cuda and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if self._device_shuffle_capacity:
            from petastorm_tpu_torch.ops.device_shuffle import DeviceShuffleBuffer

            def ring_sharding(name, arr):
                # each ring column holds this rank's rows only, on its card, and the
                # exchanged rows leave it delivered like the batches
                return _field_sharding(self.sharding, name, arr)

            batches = self._shuffled_batches(host_q, DeviceShuffleBuffer(
                self._device_shuffle_capacity, seed=self._seed or 0,
                shardings=ring_sharding if self.sharding is not None else None))
        else:
            batches = self._plain_batches(host_q)
        while True:
            # the stream is current only while a batch's work is enqueued: the caller
            # runs between yields (on the consumer thread when prefetch=0)
            with torch.cuda.stream(self._stream) if cuda else contextlib.nullcontext():
                nxt = next(batches, None)
                if nxt is None:
                    return
                out, rows = nxt
                event = None
                if cuda:
                    event = torch.cuda.Event()
                    event.record(self._stream)
            yield out, event, rows

    def _hand_over(self, batch, event, rows):
        """Make a transfer-stream batch safe to use on the consumer's current stream; its
        ``rows`` now count as taken by the consumer (the checkpoint watermark: a
        pass-through batch counts here, with its inflated columns, not when its pages
        were staged); its provenance record is finalized (the step gap starts here)."""
        self._advance_consumed(rows)
        if self._prov_rec is not None:
            self._prov_rec.batch_delivered()
        if event is None:
            return batch
        import torch

        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        for v in batch.values():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                # a DTensor's memory is its local tensor's
                to_local(v).record_stream(consumer)
        return batch

    def _host_delivery(self, host_q):
        """``to_device=False``: host numpy batches, on the consumer thread. Pass-through
        columns inflate on the host twin (the designed host seam, not a degradation);
        staged fields decode on the device and come back as numpy."""
        for batch in self._host_batches(host_q):
            leases = take_leases(batch)
            try:
                batch = _materialize_passthrough(batch, None)
                if getattr(self.reader, "device_decode_fields", None):
                    rest, staged = self._decode_staged(batch)
                    rest.update({k: v.cpu().numpy() for k, v in staged.items()})
                    batch = rest
                if leases:
                    batch = _detach_views(batch)  # the consumer keeps these
            finally:
                for lease in leases:
                    lease.release()
            self._advance_consumed(_batch_valid_rows(batch))
            if self._prov_rec is not None:
                self._prov_rec.batch_delivered()
            yield batch

    def __iter__(self):
        self._start_producer()
        gen = self._generation  # superseded iterators must not stop a newer pipeline
        host_q = self._queue
        if not self.to_device:
            yield from self._host_delivery(host_q)
            return
        if self.prefetch <= 0:  # synchronous transfer on the consumer thread
            for item in self._device_batches(host_q):
                yield self._hand_over(*item)
            return
        dev_q = queue.Queue(maxsize=max(1, self.prefetch))
        self._dev_queue = dev_q
        transfer_error = []

        def _transfer():
            scope = self._health_scope
            hb = None
            if scope is not None:
                hb = scope.register("loader.transfer", "transfer")
                self._hb_transfer = hb
            try:
                for item in self._device_batches(host_q):
                    if self._stop.is_set():
                        return
                    if hb is not None:
                        # a full device queue: the training step is the slow one
                        hb.wait("device_queue_put")
                    if not _put_with_stop(dev_q, item, self._stop):
                        return
            except Exception as e:  # noqa: BLE001 — surfaced to the consumer thread
                transfer_error.append(e)
            finally:
                if hb is not None:
                    hb.done()
                self._hb_transfer = None
                _put_sentinel(dev_q, self._stop)

        self._transfer_thread = threading.Thread(
            target=_transfer, name="ptpu-torch-transfer", daemon=True)
        self._transfer_thread.start()
        stats = self.stats
        finished = False
        try:
            while True:
                t0 = time.perf_counter()
                while True:  # bounded wait: re-check the transfer thread every second
                    try:
                        item = dev_q.get(timeout=1.0)
                        break
                    except queue.Empty:
                        t_thread = self._transfer_thread
                        if t_thread is None or not t_thread.is_alive():
                            item = _SENTINEL
                            break
                stats.device_queue_wait_s += self._timed("wait.device_queue",
                                                         "device_queue_wait", t0)
                if item is _SENTINEL:
                    finished = True
                    if transfer_error:
                        raise transfer_error[0]
                    if self._producer_error is not None:
                        # the watchdog's fail-fast puts the sentinel straight into this
                        # queue: its StallError must surface, not end the epoch quietly
                        self._producer_error_delivered = True
                        raise self._producer_error
                    return
                yield self._hand_over(*item)
        finally:
            if not finished and gen == self._generation:
                # iterator abandoned mid-epoch: stop the pipeline so the transfer thread
                # does not keep prefetched device batches alive
                self.stop()

    # -- consumer watermark -------------------------------------------------------------

    def _advance_consumed(self, n):
        """Bump the consumer watermark under the checkpoint lock (the producer prunes its
        log against it concurrently)."""
        if n:
            with self._ckpt_lock:
                self._rows_consumed += n

    @property
    def cur_shard(self):
        """The reader's shard, so a loader duck-types as a checkpointable reader for
        :mod:`petastorm_tpu_torch.checkpoint` routing."""
        return getattr(self.reader, "cur_shard", None)

    def state_dict(self):
        """Exact-resume state at the CONSUMER watermark: checkpoint through the loader,
        not the reader, when batches flow through a ``DataLoader``.

        ``Reader.state_dict()`` counts a row group consumed when the reader hands it to
        the loader's producer, which runs ahead of the training loop by the queues'
        depth; restoring that state would skip every row still in the loader. This is
        the newest reader state whose deliveries the consumer has fully taken: rows in
        flight inside the loader replay after a restore (at-least-once at row-group
        granularity), and nothing is lost.

        Raises for shuffling loaders (``shuffling_queue_capacity`` or
        ``device_shuffle_capacity``): a row can linger in a shuffling buffer arbitrarily
        long, so no row-group watermark short of the epoch boundary is correct.
        """
        if self._shuffling_queue_capacity or self._device_shuffle_capacity:
            raise ValueError(
                "DataLoader.state_dict() is not available with shuffling enabled "
                "(shuffling_queue_capacity/device_shuffle_capacity): shuffled rows "
                "linger in the buffer indefinitely, so a mid-epoch row-group "
                "watermark would lose them. Checkpoint at an epoch boundary with "
                "Reader.state_dict() instead.")
        if not self._ckpt_enabled:
            raise AttributeError(
                "underlying reader %r has no state_dict" % type(self.reader).__name__)
        with self._ckpt_lock:
            state = self._ckpt_base
            for cum, st in self._ckpt_log:
                if cum <= self._rows_consumed:
                    state = st
                else:
                    break
        if state is None:  # never iterated: the reader's own state is the truth
            state = self.reader.state_dict()
        return state

    def load_state_dict(self, state):
        """Restore into the underlying reader (before iterating)."""
        self.reader.load_state_dict(state)

    # -- failure handling and its record ------------------------------------------------

    @property
    def quarantine_report(self):
        """The reader's :class:`~petastorm_tpu_torch.recovery.QuarantineReport` (every
        row group skipped under ``on_poison="quarantine"``); None for a reader without
        one."""
        return getattr(self.reader, "quarantine_report", None)

    def bottleneck_report(self):
        """Name the limiting side of the pipeline from the stage counters: a
        :class:`~petastorm_tpu_torch.obs.analyze.BottleneckReport` with verdict
        ``producer-bound``, ``wire-bound``, ``consumer-bound``, ``balanced`` or ``idle``
        and the utilization of each side (p50/p90/p99 of each stage attached when the
        loader was built with ``metrics=``). Reads the current ``stats`` window."""
        from petastorm_tpu_torch.obs.analyze import analyze_loader

        return analyze_loader(self)

    @property
    def provenance(self):
        """The attached :class:`~petastorm_tpu_torch.obs.provenance.ProvenanceRecorder`,
        or None without ``provenance=``."""
        return self._prov_rec

    def _require_provenance(self):
        if self._prov_rec is None:
            raise ValueError(
                "DataLoader was built without provenance: pass provenance=True (or a "
                "ProvenanceRecorder, or set PTPU_PROVENANCE=1) to enable "
                "batch_provenance()/attribution_report()")
        return self._prov_rec

    def batch_provenance(self):
        """The latest delivered batch's provenance: its contributing item records (spans
        across every seam and process, annotations) plus the batch-plane spans and the
        step gap. None before the first delivery. Requires ``provenance=``."""
        return self._require_provenance().last_batch()

    def attribution_report(self, tenant=None):
        """Fold the recorded batch window into a critical-path step-time attribution
        (:class:`~petastorm_tpu_torch.obs.critical_path.AttributionReport`): per-site
        self seconds and shares, the step gap's p50/p99 split by cache tier and by
        degradation cause, and the "your p99 batch spent N% of its critical path in
        <site>" verdict. ``tenant=`` folds only batches whose items carry that
        ``tenant`` annotation. Requires ``provenance=``."""
        return self._require_provenance().report(tenant=tenant)

    def _fail_fast(self, err):
        """The watchdog's ``raise`` escalation (from its thread): deliver ``err`` to the
        consumer and unblock every queue, so the training loop gets a
        :class:`~petastorm_tpu_torch.errors.StallError` instead of hanging. The reader is
        stopped too (a truncation, as a user's ``stop()``), so a producer blocked in the
        reader wakes; a worker thread wedged in native code stays behind as a daemon,
        reported by the pool's ``thread_join_timeout`` degradation at join."""
        self._producer_error = err
        self._producer_error_delivered = False
        try:
            self.reader.stop()
        except Exception:  # noqa: BLE001 — the StallError itself is the signal
            pass
        self.stop()

    def _health_context(self):
        """Queue depths, stats and the reader's gauges, snapshotted into each flight
        record: where the pipeline was backed up when it stalled."""
        q = self._queue
        dq = self._dev_queue
        out = {
            "host_queue_depth": q.qsize() if q is not None else 0,
            "host_queue_size": max(2, self._host_queue_size),
            "device_queue_depth": dq.qsize() if dq is not None else 0,
            "device_queue_size": max(1, self.prefetch),
            "stats": self.stats.snapshot(),
        }
        for name in ("io_stats", "wire_stats"):
            fn = getattr(self.reader, name, None)
            if fn is not None:
                try:
                    polled = fn()
                except Exception:  # noqa: BLE001 — the evidence is best effort
                    polled = None
                if polled:
                    out[name.replace("_stats", "")] = polled
        rec = self._prov_rec
        if rec is not None:
            # which site owned the critical path when it hung
            try:
                out["attribution"] = rec.summary()
            except Exception:  # noqa: BLE001 — the evidence is best effort
                out["attribution"] = None
        if self._slo_engine is not None:
            # a stall that followed a burn shows the burn
            alerts = self._slo_engine.alerts()
            out["slo"] = {"alerts": len(alerts), "breaching": self._slo_engine.breaching(),
                          "last_alert": alerts[-1].message if alerts else None}
        return out

    def health_report(self, dump_path=None):
        """The health snapshot on demand (the loader needs ``health=``): the full
        flight-record dict (heartbeat ages and states, driver and pool-child stacks,
        queue depths, degradation counts, per-worker latency, the recent events) plus
        the bottleneck analyzer's verdict under ``"bottleneck"``. ``dump_path`` also
        writes it as a JSON flight record."""
        if self._health is None:
            raise ValueError(
                "DataLoader was built without health monitoring: pass health=True (or "
                "a HealthOptions/HealthMonitor, or set PTPU_HEALTH=1) to enable "
                "health_report()")
        report = self._health.capture("on_demand")
        report["bottleneck"] = self.bottleneck_report().to_dict()
        if dump_path is not None:
            from petastorm_tpu_torch.obs.flight import write_flight_record

            write_flight_record(dump_path, report)
        return report

    @property
    def slo_engine(self):
        """The attached :class:`~petastorm_tpu_torch.obs.slo.SloEngine`, or None without
        ``slos=``."""
        return self._slo_engine

    def slo_alerts(self):
        """The debounced SLO breach and anomaly alerts so far (oldest first): each an
        :class:`~petastorm_tpu_torch.obs.slo.SloAlert`. Empty without ``slos=``."""
        return self._slo_engine.alerts() if self._slo_engine is not None else []

    @property
    def controller(self):
        """The attached :class:`~petastorm_tpu_torch.control.Controller`, or None without
        ``controller=``."""
        return self._controller

    def ctl_decisions(self):
        """The controller's decisions so far (oldest first): each a
        :class:`~petastorm_tpu_torch.control.Decision` with its cause (``ctl_actuate``,
        ``ctl_revert``, ``ctl_freeze``), the knob's values before and after and the
        triggering window. Empty without ``controller=``."""
        return self._controller.decisions() if self._controller is not None else []

    controller_decisions = ctl_decisions

    # -- lifecycle ----------------------------------------------------------------------

    def stop(self):
        self._stop.set()
        for q in (self._queue, self._dev_queue):
            if q is None:
                continue
            _drain(q)  # unblock a producer/transfer thread stuck on a full queue
            try:  # the drain may have eaten the end-of-stream sentinel: re-put it
                q.put_nowait(_SENTINEL)
            except queue.Full:
                pass
        # the consumer is going away: drop the host-wide arena's holder refcounts of
        # processes that died without releasing them (a killed pool child mid-read), so
        # their entries are evictable again; live peers' views are untouched
        from petastorm_tpu_torch.io import arena as arena_mod

        arena_obj = arena_mod.process_arena()
        if arena_obj is not None:
            arena_obj.reclaim()

    def join(self):
        if self._producer is not None:
            self._producer.join(timeout=60)
        if self._transfer_thread is not None:
            self._transfer_thread.join(timeout=60)
        if self._stop.is_set() and self._queue is not None:
            _drain(self._queue)  # what a thread put after stop()'s drain

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        self.join()
        self.reader.stop()
        self.reader.join()
        if self._adopted_passthrough:
            # a reader outliving this loader serves decoded batches again
            self.reader.release_passthrough()
            self._adopted_passthrough = False
        for pool in (self._staging, self._page_staging):
            if pool is not None:
                pool.close()
        if self._slo_engine is not None and self._slo_owned:
            # a loader-built engine stops evaluating (its alerts stay readable); a
            # shared one keeps watching: a sibling pipeline may still be burning
            self._slo_engine.detach()
        if self._controller is not None and self._ctl_owned:
            # the same ownership: a loader-built controller stops actuating (its
            # decisions stay readable); a shared one is the caller's to detach
            self._controller.detach()
        if self._obs is not None:
            self._obs.close()
        if self._prov_rec is not None and self._prov_owned:
            # a loader-built recorder releases the process-global slot (its records stay
            # readable); the reader's was released by its join() above, a caller's stays
            self._prov_rec.disarm()
        if self._health is not None:
            monitor = self._health
            context_handle, stall_handle = self._health_handles or (None, None)
            if context_handle is not None:
                monitor.remove_context(context_handle)
            if stall_handle is not None:
                monitor.remove_stall_callback(stall_handle)
            self._health_handles = ()
            if self._health_owned:
                monitor.stop()  # a shared monitor stays running: its owner stops it
            elif self._health_scope is not None:
                # retire this pipeline's actors, or closed loaders pile up on it
                self._health_scope.close()


def _resolve_local_batch(batch_size, sharding):
    """Rows this rank feeds a global batch of ``batch_size`` (one rank: all of them).

    A global batch that does not divide over the sharding's batch axis raises. Across
    ranks only a ``NamedSharding`` exposes the mesh needed to compute each rank's share:
    anything else (or a dict holding anything else) raises instead of feeding every rank
    the global batch. "Multi-process" is the ``torch.distributed`` world size, where the
    JAX package asks ``jax.process_count()``."""
    from petastorm_tpu_torch.parallel.mesh import NamedSharding, local_batch_size

    _rank, world = process_group()
    if sharding is None or world == 1:
        return batch_size

    def _reject(s):
        raise ValueError(
            "DataLoader cannot decompose the global batch across processes for %s: "
            "only NamedSharding exposes the mesh/axis structure needed to compute "
            "each process's local share. Use a NamedSharding over a DeviceMesh (batch "
            "axis in PartitionSpec position 0), or shard the reader per process and "
            "pass no sharding." % type(s).__name__)

    if isinstance(sharding, dict):  # per-field dict: the first named sharding decides
        for s in sharding.values():
            if s is not None and not isinstance(s, NamedSharding):
                _reject(s)
        named = [s for s in sharding.values() if s is not None]
        if not named:
            return batch_size  # every field stays local
        sharding = named[0]
    if not isinstance(sharding, NamedSharding):
        _reject(sharding)
    spec0 = sharding.spec[0] if len(sharding.spec) else None
    if spec0 is None:
        return batch_size  # batch axis replicated: every rank feeds all rows
    axes = (spec0,) if isinstance(spec0, str) else tuple(spec0)
    return local_batch_size(batch_size, sharding.mesh, batch_axes=axes)


def _batch_shard_count(sharding):
    """See :func:`petastorm_tpu_torch.parallel.mesh.batch_axis_shard_count`."""
    from petastorm_tpu_torch.parallel.mesh import batch_axis_shard_count

    return batch_axis_shard_count(sharding)


def _matching_sharding(sharding, arr):
    """Adapt a batch-axis sharding to a tensor's rank (replicate the trailing axes)."""
    from petastorm_tpu_torch.parallel.mesh import NamedSharding

    if isinstance(sharding, NamedSharding):
        spec = list(sharding.spec)
        if len(spec) < arr.ndim:
            spec = spec + [None] * (arr.ndim - len(spec))
        elif len(spec) > arr.ndim:
            spec = spec[: arr.ndim]
        return NamedSharding(sharding.mesh, spec)
    return sharding


def _field_sharding(sharding, name, arr):
    """The sharding of one delivered field: a dict's entry (None: stays local), or the
    loader's sharding adapted to the field's rank; None without ``sharding=``."""
    if sharding is None:
        return None
    if isinstance(sharding, dict):
        return sharding.get(name)
    return _matching_sharding(sharding, arr)


def _deliver(sharding, arrays, declared=None):
    """Each tensor with a sharding becomes a ``DTensor`` of the rank's rows
    (:func:`~petastorm_tpu_torch.parallel.mesh.to_dtensor`), cut first to the rank's part
    along each sharded non-batch dimension (:func:`~petastorm_tpu_torch.parallel.mesh.
    rank_part`; ``declared``: ``{field: schema shape}``); a field whose sharding is None
    in a dict, host columns, and everything without ``sharding=`` stay as they are."""
    if sharding is None:
        return arrays
    import torch

    from petastorm_tpu_torch.parallel.mesh import rank_part, to_dtensor

    out = {}
    for name, arr in arrays.items():
        s = _field_sharding(sharding, name, arr) if isinstance(arr, torch.Tensor) else None
        out[name] = arr if s is None else to_dtensor(
            rank_part(arr, s, (declared or {}).get(name)), s)
    return out


def _declared_shapes(reader):
    """``{field: shape}`` of the reader's schema fields with a known shape (None entries
    for variable dimensions): what :func:`_deliver` tells a whole row from a rank's
    part by."""
    fields = getattr(getattr(reader, "schema", None), "fields", None) or {}
    return {name: tuple(f.shape) for name, f in fields.items()
            if getattr(f, "shape", None) is not None}


def _fold_seed(*parts):
    """A torch seed (63 bits) from integers: numpy's ``SeedSequence`` mixes them, so
    ``(seed, n)`` and ``(seed, n + 1)`` seed unrelated streams."""
    state = np.random.SeedSequence([int(p) % (1 << 64) for p in parts]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


def _fill_order(plan, log, rows):
    """The gather that puts a fill's rows in the reader's item order, or None when they
    already are (or the reader logged no deliveries, or its plan grew). ``log``: the
    reader's ``(epoch, ordinal, rows)`` a work item, in the order the fill received
    them."""
    if plan is None or not log or sum(n for _e, _o, n in log) != rows:
        return None
    positions = {}
    keys = []
    for epoch, ordinal, _n in log:
        if epoch not in positions:
            positions[epoch] = plan.positions(epoch)
        if positions[epoch] is None:
            return None
        keys.append((epoch, int(positions[epoch][ordinal])))
    if keys == sorted(keys):
        return None
    starts = np.cumsum([0] + [n for _e, _o, n in log[:-1]])
    segments = sorted(range(len(log)), key=keys.__getitem__)
    return np.concatenate([np.arange(starts[i], starts[i] + log[i][2]) for i in segments])


class InMemDataLoader:
    """Epochs served from device memory: the reader is read ONCE into tensors on the
    device, then every batch is one gather of that store (``index_select`` a column),
    with no host work and no host-to-device copy after the fill.

    Port of ``petastorm_tpu.loader.InMemDataLoader``. The fill goes through a
    :class:`DataLoader` (unsharded, ``last_batch="partial"``, ``prefetch=2``), so staged
    JPEG columns decode on the device and pass-through columns inflate there; host-only
    columns (strings, objects) are dropped with a warning; the chunks are concatenated
    on the device. Each epoch's order is ``torch.randperm`` on the store's device with a
    ``torch.Generator`` seeded from ``(seed, epoch)``, so the same ``(seed, epoch)``
    always gives the same order on the same kind of device (a CPU and a CUDA generator
    give different orders) and :meth:`state_dict` resumes exactly. The fill puts the
    rows in the reader's item order (the order one worker delivers), whatever order
    several workers finish their row groups in, so two fills of one store hold the same
    rows at the same places.

    In a ``torch.distributed`` job of more than one rank each rank fills its own shard
    (pass a sharded reader, ``cur_shard=rank``) and keeps it on ITS card; every batch
    gathers the rank's share and is delivered as a ``DTensor`` of the global batch.
    ``batch_size`` stays GLOBAL; that needs a decomposable ``NamedSharding`` and
    ``last_batch='drop'``, and the batch count an epoch is agreed once at fill time from
    every rank's row count (``all_gather_object``, the only collective). A rank's epoch
    order is ``torch.randperm`` from ``(seed, epoch, rank + 1)``.

    Parameters
    ----------
    reader : Reader
        Source reader, consumed once during construction (its ``num_epochs`` must be
        finite, usually 1).
    batch_size : int
        Rows per yielded batch.
    num_epochs : int or None
        Epochs to serve; ``None`` = infinite.
    shuffle : bool
        A fresh permutation every epoch, from ``seed`` and the epoch.
    sharding : NamedSharding or dict, optional
        Layout of the yielded batches (:class:`DataLoader`'s ``sharding``): each batch is
        delivered as DTensors of the rank's rows. The store stays on the rank's card.
    last_batch : {"drop", "partial"}
        Remainder policy per epoch. With ``sharding``, a ``partial`` tail batch is
        delivered per the sharding when its row count divides the batch axis, and as
        plain tensors otherwise.
    device_transform : callable, optional
        ``fn(batch) -> batch`` on the device after the gather; a two-argument
        ``fn(batch, generator)`` receives a ``torch.Generator`` on the device seeded from
        ``(seed + 1, step)``, ``step`` the batch's position in the whole stream, so a
        resumed stream draws what the uninterrupted one would.
    device_decode_resize : see :class:`DataLoader` (applies to the fill).
    trace : petastorm_tpu_torch.trace.TraceRecorder, optional
        The fill's pipeline spans (through its :class:`DataLoader`) and one
        ``inmem.gather`` span a served batch (the gather, enqueued on the device).
    device : torch.device or str, optional, keyword only
        Where the store lives. Default: the sharding's mesh device on this rank, else the
        CUDA device (raises when there is none).
    """

    def __init__(self, reader, batch_size, num_epochs=1, shuffle=True, seed=0,
                 sharding=None, last_batch="drop", device_transform=None,
                 device_decode_resize=None, trace=None, *, device=None):
        import torch

        if last_batch not in ("drop", "partial"):
            raise ValueError("last_batch must be drop|partial, got %r" % last_batch)
        self.batch_size = int(batch_size)
        rank, world = process_group()
        #: more than one rank: each keeps ITS shard on its card and every batch is the
        #: global DTensor of the ranks' gathers
        self._multiprocess = world > 1
        if self._multiprocess:
            if sharding is None:
                raise ValueError(
                    "multi-process InMemDataLoader requires a sharding (a "
                    "NamedSharding whose batch axis decomposes per process)")
            if last_batch != "drop":
                raise ValueError(
                    "multi-process InMemDataLoader supports last_batch='drop' only "
                    "(a ragged tail cannot assemble into a uniform global array)")
            self.local_batch_size = _resolve_local_batch(self.batch_size, sharding)
            if self.local_batch_size >= self.batch_size:
                # a replicated batch axis would label each rank's DIFFERENT shard rows
                # replicas of one global tensor
                raise ValueError(
                    "multi-process InMemDataLoader requires a sharding whose batch "
                    "axis spans processes (each process contributes its shard); a "
                    "replicated batch axis would label divergent per-process shards "
                    "as replicas of the same array")
        else:
            self.local_batch_size = self.batch_size
        self._rank = rank
        self._sharding = sharding
        self._declared = _declared_shapes(reader)
        self.device = _resolve_device(device, sharding)
        self.num_epochs = num_epochs
        self.shuffle = shuffle
        self.last_batch = last_batch
        self._seed = int(seed)
        self._device_transform = device_transform
        self._trace = trace
        plan = getattr(reader, "_plan", None)
        if plan is not None and getattr(plan, "_num_epochs", 1) is None:
            raise ValueError(
                "InMemDataLoader consumes the reader ONCE to fill device memory; an "
                "infinite reader (num_epochs=None) would never finish the fill. Build "
                "the reader with num_epochs=1 and set epochs here.")
        chunks = []
        dropped = set()
        log = []
        if hasattr(reader, "delivery_log"):
            reader.delivery_log = log
        with DataLoader(reader, self.batch_size, last_batch="partial", prefetch=2,
                        device_decode_resize=device_decode_resize, trace=trace,
                        device=self.device) as fill:
            for batch in fill:
                kept = {}
                for k, v in batch.items():
                    # host-only columns (strings, objects) cannot live on the device
                    if isinstance(v, np.ndarray) and not _is_device_dtype(v):
                        dropped.add(k)
                    else:
                        kept[k] = v
                chunks.append(kept)
        if dropped:
            logger.warning("InMemDataLoader dropped host-only fields: %s", sorted(dropped))
        if not chunks:
            raise ValueError("reader yielded no rows to load in memory")
        if hasattr(reader, "delivery_log"):
            reader.delivery_log = None
        # torch.cat copies: the store owns its memory, whatever the fill's tensors view
        self._store = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
        del chunks
        self.rows = int(next(iter(self._store.values())).shape[0])
        order = _fill_order(plan, log, self.rows)
        if order is not None:
            idx = torch.from_numpy(order).to(self.device)
            self._store = {k: v.index_select(0, idx) for k, v in self._store.items()}
        if self._multiprocess:
            import torch.distributed as dist

            self._local_rows = self.rows
            all_rows = [None] * world
            dist.all_gather_object(all_rows, self._local_rows)
            lo, hi = min(all_rows), max(all_rows)
            self._batches_per_epoch = lo // self.local_batch_size
            if self._batches_per_epoch == 0:
                raise ValueError(
                    "multi-process InMemDataLoader: some process holds only %d rows "
                    "— fewer than its local batch share %d; no full global batch "
                    "can be formed" % (lo, self.local_batch_size))
            served = self._batches_per_epoch * self.local_batch_size
            if hi > served:
                logger.warning(
                    "InMemDataLoader shards are uneven (%d..%d rows/process): each "
                    "epoch serves %d rows/process; with shuffle=True the excluded "
                    "rows differ per epoch, with shuffle=False the SAME surplus "
                    "rows are never served — rebalance shards (shard_seed) or keep "
                    "shuffle on", lo, hi, served)
            self.rows = int(sum(all_rows))
        # one card a rank: the store stays on this rank's card; the gathered batches are
        # laid out per the sharding
        self._perm_gen = torch.Generator(device=self.device)
        self._transform_gen = None
        #: (epoch, next batch within the epoch) the NEXT yield serves: the exact-resume
        #: cursor (epoch orders are a function of seed and epoch)
        self._pos = (0, 0)
        self._resume = None

    # -- exact resume -------------------------------------------------------------------

    def state_dict(self):
        """Exact-resume cursor: ``(epoch, batch)`` of the next batch to serve, plus the
        stream's configuration; the JAX package's keys. Restoring it into a loader of
        the same configuration continues the stream exactly once, with no replay.

        A restored cursor not yet iterated is returned as it is; after a pass the cursor
        points past its last epoch, and a new iteration starts a new pass."""
        epoch, batch = self._resume if self._resume is not None else self._pos
        return {"inmem": True, "epoch": int(epoch), "batch": int(batch),
                "seed": self._seed, "shuffle": bool(self.shuffle),
                "rows": int(self.rows), "batch_size": int(self.batch_size),
                "last_batch": self.last_batch,
                "num_epochs": None if self.num_epochs is None else int(self.num_epochs)}

    def load_state_dict(self, state):
        """Resume a loader of the same configuration at a saved cursor (before
        iterating)."""
        if not state.get("inmem"):
            raise ValueError(
                "not an InMemDataLoader state (checkpoint from a streaming loader/"
                "reader? restore it into the matching object)")
        mismatches = {
            k: (state.get(k), have) for k, have in (
                ("seed", self._seed), ("shuffle", bool(self.shuffle)),
                ("rows", int(self.rows)), ("batch_size", int(self.batch_size)),
                ("last_batch", self.last_batch),
                # a shorter num_epochs would serve NOTHING when the cursor's epoch is
                # past it
                ("num_epochs", self.num_epochs),
            ) if state.get(k) != have
        }
        if mismatches:
            raise ValueError(
                "InMemDataLoader state does not match this loader's stream config "
                "(saved vs built): %s — a different config is a different epoch "
                "stream, and resuming would serve wrong rows" % (mismatches,))
        self._resume = (int(state["epoch"]), int(state["batch"]))
        return self

    @property
    def cur_shard(self):
        """The rank in a multi-process job (each rank serves its own resident shard: the
        routing key of :mod:`petastorm_tpu_torch.checkpoint`), else None."""
        return self._rank if self._multiprocess else None

    def __len__(self):
        if self._multiprocess:
            return self._batches_per_epoch
        full, rem = divmod(self.rows, self.batch_size)
        return full + (1 if rem and self.last_batch == "partial" else 0)

    def __iter__(self):
        import torch

        resume, self._resume = self._resume, None
        epoch = resume[0] if resume else 0
        skip = resume[1] if resume else 0  # batches to skip in the FIRST epoch only
        # a fresh pass resets the cursor
        self._pos = (epoch, skip)
        takes_gen = False
        if self._device_transform is not None:
            try:
                takes_gen = len(inspect.signature(self._device_transform).parameters) >= 2
            except (TypeError, ValueError):
                takes_gen = False
        per_epoch = len(self)
        while self.num_epochs is None or epoch < self.num_epochs:
            if self._multiprocess:
                yield from self._multiprocess_epoch(epoch, takes_gen, epoch * per_epoch,
                                                    skip)
                epoch += 1
                skip = 0
                continue
            if self.shuffle:
                self._perm_gen.manual_seed(_fold_seed(self._seed, epoch))
                perm = torch.randperm(self.rows, generator=self._perm_gen,
                                      device=self.device)
            else:
                perm = torch.arange(self.rows, device=self.device)
            for bidx, start in enumerate(range(0, self.rows, self.batch_size)):
                if bidx < skip:
                    continue
                n = min(self.batch_size, self.rows - start)
                if n < self.batch_size and self.last_batch == "drop":
                    break
                t_g = time.perf_counter()
                idx = perm[start:start + n]
                batch = {k: v.index_select(0, idx) for k, v in self._store.items()}
                if self._trace is not None:
                    self._trace.add("inmem.gather", t_g, time.perf_counter() - t_g)
                # the step is position-derived, so a resumed stream seeds the same
                # generators an uninterrupted one would
                batch = self._apply_transform(batch, epoch * per_epoch + bidx, takes_gen)
                if self._sharding is not None:
                    # a short tail batch is laid out too when its rows divide the batch
                    # axis; otherwise it stays plain (a step with fixed placements
                    # should use last_batch='drop')
                    if n % _batch_shard_count(self._sharding) == 0:
                        batch = _deliver(self._sharding, batch, self._declared)
                    else:
                        logger.warning(
                            "InMemDataLoader: final partial batch (%d rows) does not "
                            "divide the sharding's batch axis; yielded unsharded", n)
                self._pos = (epoch, bidx + 1)
                yield batch
            epoch += 1
            skip = 0

    def _multiprocess_epoch(self, epoch, takes_gen, step0, skip=0):
        """One epoch of a multi-process job: the rank's own permutation of its shard
        (seeded from ``(seed, epoch, rank + 1)``, so the ranks' orders decorrelate), a
        local gather a batch on the rank's card, delivered as the global DTensor."""
        import torch

        if self.shuffle:
            self._perm_gen.manual_seed(_fold_seed(self._seed, epoch, self._rank + 1))
            perm = torch.randperm(self._local_rows, generator=self._perm_gen,
                                  device=self.device)
        else:
            perm = torch.arange(self._local_rows, device=self.device)
        b = self.local_batch_size
        for bidx in range(skip, self._batches_per_epoch):
            t_g = time.perf_counter()
            idx = perm[bidx * b:(bidx + 1) * b]
            batch = {k: v.index_select(0, idx) for k, v in self._store.items()}
            if self._trace is not None:
                self._trace.add("inmem.gather", t_g, time.perf_counter() - t_g)
            batch = self._apply_transform(batch, step0 + bidx, takes_gen)
            self._pos = (epoch, bidx + 1)
            yield _deliver(self._sharding, batch, self._declared)

    def _apply_transform(self, batch, step, takes_gen):
        """The device transform on the rank's gathered tensors (before the delivery: a
        kernel cannot take a DTensor). In a multi-process job a two-argument transform's
        generator is seeded from ``(seed + 1, step, rank)``."""
        if self._device_transform is None:
            return batch
        if not takes_gen:
            return self._device_transform(batch)
        import torch

        if self._transform_gen is None:
            self._transform_gen = torch.Generator(device=self.device)
        parts = (self._seed + 1, step) + ((self._rank,) if self._multiprocess else ())
        self._transform_gen.manual_seed(_fold_seed(*parts))
        return self._device_transform(batch, self._transform_gen)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self._store = None  # release device memory


_UNSET = object()

#: DataLoader keyword parameters make_dataloader forwards when given explicitly: the
#: defaults stay defined once, on DataLoader.__init__
_LOADER_OPTS = ("last_batch", "device_transform", "prefetch", "pad_shapes",
                "device_shuffle_capacity", "to_device", "host_queue_size",
                "device_decode_resize", "trace", "metrics", "health", "staging",
                "provenance", "slos", "controller")


def make_dataloader(dataset_url_or_urls, batch_size, sharding=None, num_epochs=1,
                    shuffling_queue_capacity=0, reader_factory=None,
                    last_batch=_UNSET, device_transform=_UNSET, prefetch=_UNSET,
                    pad_shapes=_UNSET, device_shuffle_capacity=_UNSET,
                    to_device=_UNSET, host_queue_size=_UNSET,
                    device_decode_resize=_UNSET, trace=_UNSET, metrics=_UNSET,
                    health=_UNSET, staging=_UNSET, provenance=_UNSET,
                    slos=_UNSET, controller=_UNSET, *, device=None, **reader_kwargs):
    """One call for :func:`~petastorm_tpu_torch.reader.make_batch_reader` +
    :class:`DataLoader` (port of ``petastorm_tpu.loader.make_dataloader``).

    ``reader_kwargs`` go to ``make_batch_reader`` (or ``reader_factory``); the loader's
    parameters are :class:`DataLoader`'s, and only those passed explicitly are
    forwarded. ``seed`` (the loader's) falls back to ``shard_seed``. In a
    ``torch.distributed`` job of more than one process ``cur_shard``/``shard_count``
    default to the rank's coordinate along ``sharding``'s batch axes and their size
    (ranks that differ only along other axes read the same rows; the JAX package
    defaults to the process index and count), else to the rank and the world size;
    ``sharding`` is :class:`DataLoader`'s."""
    from petastorm_tpu_torch.parallel.mesh import batch_shard
    from petastorm_tpu_torch.reader import make_batch_reader

    factory = reader_factory or make_batch_reader
    if "cur_shard" not in reader_kwargs:
        rank, world = process_group()
        if world > 1:
            shard = batch_shard(sharding) if sharding is not None else (rank, world)
            if shard is not None and shard[1] > 1:
                reader_kwargs["cur_shard"], reader_kwargs["shard_count"] = shard
    reader = factory(dataset_url_or_urls, num_epochs=num_epochs, **reader_kwargs)
    seed = reader_kwargs.get("seed")
    if seed is None:
        seed = reader_kwargs.get("shard_seed")
    passed = locals()
    loader_kwargs = {name: passed[name] for name in _LOADER_OPTS
                     if passed[name] is not _UNSET}
    try:
        return DataLoader(reader, batch_size, sharding=sharding,
                          shuffling_queue_capacity=shuffling_queue_capacity, seed=seed,
                          device=device, **loader_kwargs)
    except BaseException:
        reader.stop()  # a refused option must not leave the reader's pool running
        reader.join()
        raise
