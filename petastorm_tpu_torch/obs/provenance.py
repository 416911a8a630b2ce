"""Causal per-item provenance: which row group lost time where.

Port of ``petastorm_tpu.obs.provenance``. The stage histograms, heartbeats and the
bottleneck verdict see stages, not items: when a p99 batch is slow, nothing there says
whether it lost time to a remote GET tail, a retry, a cache miss, the wire or the inflate
stage. This module records one :class:`ItemProvenance` per dispatched plan item, keyed
by the stable ``"epoch=E ordinal=O path:rg"`` item key the chaos plane uses
(:func:`petastorm_tpu_torch.chaos.item_key`), accumulating ``(site, t_start, t_end,
pid)`` spans and annotations (the cache tier that served it, hedges fired and won,
retries and quarantine attempts, the readahead hit or miss) as the item flows through
the seams:

- reader reads and coalesced runs (``reader.read`` / ``reader.read_run``), the
  compressed-page pass-through's read (``io.pagedec``),
- readahead-served tables (``io.readahead``, the IO thread's read, and
  ``io.readahead_wait``) and remote ranged GETs (``io.remote``),
- the cache-tier funnel (annotation ``cache_tier`` = mem/arena/disk/remote),
- transient-IO retries (``io_retries``) and poison-quarantine attempts,
- the host transform (``transform`` and ``transform.<fused-label>``),
- the process pool's wire (``wire.roundtrip`` / ``wire.decode``): the child's spans
  (``child.work``, ``child.serialize`` and every span inside them) cross the pool on the
  result header beside the trace piggyback, clock-aligned through the child's wall/perf
  anchor pair,
- the loader's batch plane (``loader.collate`` / ``loader.host_queue_put`` /
  ``decode.device_inflate`` / ``loader.decode`` / ``loader.h2d``).

Delivered batches are attributed to their contributing items through the in-order
delivery FIFO (non-shuffling loaders; shuffling decorrelates rows from items, so batch
membership is recorded as unknown there), exposed as ``DataLoader.batch_provenance()``;
the critical-path fold (:mod:`petastorm_tpu_torch.obs.critical_path`) turns the per-batch
span sets into a step-time attribution report (``DataLoader.attribution_report()``).

Spans are host ``perf_counter`` time. The transfer thread enqueues CUDA work without
waiting for it, so ``loader.decode`` times the launch of the staged decode's kernels;
``decode.device_inflate`` includes its one read back to the host, so the card's inflate
time is inside it.

Hot-path contract (the ``trace.py`` / chaos pattern): everything is a no-op behind
``ACTIVE is None``, one module-global check a site when disabled. Pool children arm a
lightweight :class:`_ChildCollector` at bootstrap (always: a handful of ``perf_counter``
pairs a row-group item, as the always-on child trace spans) and the parent merges the
piggybacked spans only when a recorder is attached.

One armed :class:`ProvenanceRecorder` per process at a time (like the chaos plane's
``ACTIVE`` fault plan): a second ``arm()`` raises; give concurrent provenance-enabled
loaders their own processes, or share one recorder. The JAX package's recorder is a
separate module global: arming one plane never arms the other.

Each item is stamped with the tenant active on the thread that begins it
(:mod:`petastorm_tpu_torch.obs.tenant`), as a plain ``tenant`` annotation that rides a
child's record to the parent unchanged; ``report(tenant=...)`` folds only the batches
whose items carry that tenant.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
import zlib

from petastorm_tpu_torch.chaos import item_key as _chaos_item_key
from petastorm_tpu_torch.obs import tenant as _tenant

#: the armed collector for THIS process: a :class:`ProvenanceRecorder` in the
#: consumer process, a :class:`_ChildCollector` in pool children, or None
#: (disabled — every hook is one ``is None`` check)
ACTIVE = None

_PID = os.getpid()

_tls = threading.local()


def item_key(tagged_item):
    """The stable provenance key of a dispatched plan item — the SAME
    ``"epoch=E ordinal=O path:rg"`` string the chaos plane keys its fault
    rules by (single-sourced: :func:`petastorm_tpu_torch.chaos.item_key`)."""
    return _chaos_item_key(tagged_item)


def item_identity(tagged_item):
    """``(epoch, ordinal, key)`` for a tagged plan item; ordinal pair falls
    back to the key string when the item is not the tagged 3-tuple shape."""
    key = _chaos_item_key(tagged_item)
    if isinstance(tagged_item, tuple) and len(tagged_item) == 3:
        return tagged_item[0], tagged_item[1], key
    return None, key, key


_item_identity = item_identity


class ItemProvenance:
    """One dispatched plan item's causal record: trace id, spans, annotations.

    Span times are ``perf_counter`` values on the OWNING recorder's timeline
    (child spans are clock-aligned into the parent recorder's timeline on
    absorption, the trace merge's scheme). ``trace_id`` is a stable crc32
    of the item key — identical in every process that touches the item, which
    is what lets Perfetto flow events link one item's spans across pid lanes.
    """

    __slots__ = ("epoch", "ordinal", "key", "trace_id", "spans",
                 "annotations", "rows", "attempts")

    def __init__(self, epoch, ordinal, key):
        self.epoch = epoch
        self.ordinal = ordinal
        self.key = key
        self.trace_id = zlib.crc32(key.encode("utf-8", "replace")) & 0x7FFFFFFF
        self.spans = []       # [(site, t0, t1, pid)]
        self.annotations = {}
        self.rows = 0         # rows this item delivered to the consumer
        self.attempts = 1     # dispatch attempts observed (retries/respawns)

    def add_span(self, site, t0, t1, pid=None):
        self.spans.append((site, t0, t1, _PID if pid is None else pid))

    def annotate(self, name, value):
        self.annotations[name] = value

    def annotate_add(self, name, n=1):
        self.annotations[name] = self.annotations.get(name, 0) + n

    def to_dict(self):
        return {
            "key": self.key,
            "trace_id": self.trace_id,
            "epoch": self.epoch,
            "ordinal": self.ordinal,
            "rows": self.rows,
            "attempts": self.attempts,
            "annotations": dict(self.annotations),
            "spans": [{"site": s, "t0": t0, "t1": t1, "pid": pid}
                      for s, t0, t1, pid in self.spans],
        }


class BatchProvenance:
    """One delivered batch: its contributing items + batch-plane spans.

    ``items`` is ``[(epoch, ordinal, rows_from_that_item)]`` consumed from the
    delivery FIFO (``None`` when membership is unknowable — shuffling buffers
    decorrelate rows from row groups). ``delivered_t``/``step_gap_s`` are
    stamped when the consumer takes the batch; the gap to the PREVIOUS
    delivery is the step-time denominator the attribution report splits."""

    __slots__ = ("seq", "rows", "items", "spans", "created_t", "delivered_t",
                 "step_gap_s", "dropped")

    def __init__(self, seq, rows, items):
        self.seq = seq
        self.rows = rows
        self.items = items
        self.spans = []  # batch-plane spans [(site, t0, t1, pid)]
        self.created_t = time.perf_counter()
        self.delivered_t = None
        self.step_gap_s = None
        self.dropped = False

    def add_span(self, site, t0, t1):
        self.spans.append((site, t0, t1, _PID))

    def to_dict(self):
        return {
            "seq": self.seq,
            "rows": self.rows,
            "items": None if self.items is None
            else [list(entry) for entry in self.items],
            "step_gap_s": self.step_gap_s,
            "spans": [{"site": s, "t0": t0, "t1": t1, "pid": pid}
                      for s, t0, t1, pid in self.spans],
        }


# --------------------------------------------------------------------------------------
# module-level hooks (the hot-path surface: one `ACTIVE is None` check each)
# --------------------------------------------------------------------------------------


def current():
    """The :class:`ItemProvenance` the calling thread is working, or None."""
    return getattr(_tls, "item", None)


def begin_item(tagged_item):
    """Arm the calling thread's item context (executor worker loops / pool
    children call this around ``worker(item)``). Re-begins of the same
    ``(epoch, ordinal)`` (poison retries, respawn re-dispatch) reuse the
    existing record and bump its attempt count. MUST be paired with
    :func:`end_item` in a ``finally``."""
    if ACTIVE is None:
        return None
    rec = ACTIVE.open_item(tagged_item)
    _tls.item = rec
    label = _tenant.current_label()
    if label is not None and "tenant" not in rec.annotations:
        rec.annotations["tenant"] = label
    return rec


def end_item():
    """Close the calling thread's item context; returns whatever the armed
    collector's ``close_item`` returns (the child collector returns the
    piggyback blob, the parent recorder returns None)."""
    if ACTIVE is None:
        return None
    rec = getattr(_tls, "item", None)
    _tls.item = None
    if rec is None:
        return None
    return ACTIVE.close_item(rec)


def add_span(site, t0, dur):
    """Record one span against the calling thread's current item (no-op when
    provenance is off or no item context is armed)."""
    if ACTIVE is None:
        return
    rec = getattr(_tls, "item", None)
    if rec is not None:
        rec.add_span(site, t0, t0 + dur)


@contextlib.contextmanager
def span(site):
    """Context manager recording the enclosed block as one item span."""
    if ACTIVE is None or getattr(_tls, "item", None) is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add_span(site, t0, time.perf_counter() - t0)


def annotate(name, value):
    """Set an annotation on the current item (cache tier, degradation cause)."""
    if ACTIVE is None:
        return
    rec = getattr(_tls, "item", None)
    if rec is not None:
        rec.annotate(name, value)


def annotate_add(name, n=1):
    """Accumulate a numeric annotation (retries, hedges) on the current item."""
    if ACTIVE is None:
        return
    rec = getattr(_tls, "item", None)
    if rec is not None:
        rec.annotate_add(name, n)


def open_span(site):
    """Explicit open/close span handle for sites where a ``with`` block cannot
    bracket the region (split across control flow). The returned handle's
    ``close()`` records the span; close it in a ``finally``."""
    return _SpanHandle(site)


class _SpanHandle:
    __slots__ = ("site", "t0", "_closed", "_rec")

    def __init__(self, site):
        self.site = site
        self.t0 = time.perf_counter()
        self._closed = False
        # bind the record at OPEN time: the close may run after end_item()
        # cleared the thread-local (teardown paths)
        self._rec = current() if ACTIVE is not None else None

    def close(self):
        if self._closed:
            return
        self._closed = True
        rec = self._rec
        if rec is not None:
            rec.add_span(self.site, self.t0, time.perf_counter())


# --------------------------------------------------------------------------------------
# child-side collector (pool children: record, piggyback, forget)
# --------------------------------------------------------------------------------------


class _ChildCollector:
    """Minimal per-item collector for pool children: the record lives only
    until :func:`end_item` hands it back as the result-header piggyback blob
    ``(epoch, ordinal, spans, annotations)`` — spans on THIS process's
    ``perf_counter`` timeline; the parent aligns them through the child's
    wall/perf anchor pair (the same anchors the trace piggyback ships)."""

    def open_item(self, tagged_item):
        epoch, ordinal, key = _item_identity(tagged_item)
        return ItemProvenance(epoch, ordinal, key)

    def close_item(self, rec):
        if not rec.spans and not rec.annotations:
            return None
        return (rec.epoch, rec.ordinal, rec.key, list(rec.spans),
                dict(rec.annotations))


def arm_child():
    """Arm the lightweight child collector (pool-child bootstrap). Idempotent;
    never replaces an already-armed parent recorder (in-process executors)."""
    global ACTIVE
    if ACTIVE is None:
        ACTIVE = _ChildCollector()
    return ACTIVE


def child_collector():
    """A private per-item collector for producers across a wire (the data service's
    decode workers): :func:`arm_child`'s record, piggyback and forget, owned by the
    caller instead of installed as the process's ``ACTIVE``. A
    :class:`~petastorm_tpu_torch.service.worker.DecodeWorker` in a trainer's process
    records its ``svc.decode`` spans without taking over the trainer's hooks, and a
    worker process of its own runs the same code."""
    return _ChildCollector()


# --------------------------------------------------------------------------------------
# parent-side recorder
# --------------------------------------------------------------------------------------


class ProvenanceRecorder:
    """Process-wide provenance collector: item registry + batch attribution.

    ``max_items``/``max_batches`` bound memory on long runs (oldest evicted —
    the attribution window is the recent one being debugged). All methods are
    thread-safe: the reader's executor threads, the loader's producer and
    transfer threads, and the consumer all feed one recorder.
    """

    def __init__(self, max_items=8192, max_batches=2048):
        self._lock = threading.RLock()
        self._origin = time.perf_counter()
        self._wall_origin = time.time()
        self._max_items = int(max_items)
        self._max_batches = int(max_batches)
        self._items = collections.OrderedDict()  # (epoch, ordinal) -> record
        self._delivery_fifo = collections.deque()  # [epoch, ordinal, rows left]
        self._pending_transfer = collections.deque()
        self._pending_delivery = collections.deque()
        self._completed = collections.deque(maxlen=self._max_batches)
        self._current_transfer = None
        self._batch_seq = 0
        self._last_delivered_t = None
        self._quarantined = []  # [(epoch, ordinal, attempts, kind)]
        self._track_batches = True
        self._tracer = None  # optional TraceRecorder for Perfetto flow events
        self.duplicate_absorbs = 0  # same-item child blobs merged twice
        #: set by resolve() on recorders IT constructed: the owning
        #: reader/loader disarms at teardown; caller-supplied recorders stay
        #: armed (the caller owns the lifecycle)
        self._auto_disarm = False
        self._summary_cache = None  # (version key, summary dict)

    # -- arming -------------------------------------------------------------------------

    def arm(self):
        """Install this recorder as the process's ``ACTIVE`` collector (worker
        threads' ``begin_item``/``span`` hooks feed it). One recorder per
        process: a second concurrent ``arm()`` raises."""
        global ACTIVE
        with self._lock:
            if ACTIVE is self:
                return self
            if ACTIVE is not None and not isinstance(ACTIVE, _ChildCollector):
                raise RuntimeError(
                    "another ProvenanceRecorder is already armed in this "
                    "process — run one provenance-enabled loader per process, "
                    "or share its recorder")
            ACTIVE = self
        return self

    def disarm(self):
        global ACTIVE
        if ACTIVE is self:
            ACTIVE = None

    def set_trace(self, tracer):
        """Attach a :class:`petastorm_tpu_torch.trace.TraceRecorder`: each finalized
        batch emits Perfetto flow events linking its items' spans across pid
        lanes in the trace dump."""
        with self._lock:
            self._tracer = tracer

    def set_batch_tracking(self, enabled):
        """Batch↔item attribution toggle: the loader disables it under
        shuffling (rows decorrelate from row groups there), and the delivery
        FIFO stays empty instead of growing unconsumed."""
        with self._lock:
            self._track_batches = bool(enabled)
            if not enabled:
                self._delivery_fifo.clear()

    # -- item plane ---------------------------------------------------------------------

    def open_item(self, tagged_item):
        epoch, ordinal, key = _item_identity(tagged_item)
        with self._lock:
            rec = self._items.get((epoch, ordinal))
            if rec is not None and rec.key == key:
                rec.attempts += 1  # retry/re-dispatch of the same item
                return rec
            rec = ItemProvenance(epoch, ordinal, key)
            self._store(rec)
        return rec

    def close_item(self, rec):
        # the record was registered at open; nothing to hand back parent-side
        return None

    def _store(self, rec):
        items = self._items
        items[(rec.epoch, rec.ordinal)] = rec
        while len(items) > self._max_items:
            items.popitem(last=False)

    def _get_or_create(self, epoch, ordinal, key=None):
        rec = self._items.get((epoch, ordinal))
        if rec is None:
            rec = ItemProvenance(epoch, ordinal,
                                 key or "epoch=%s ordinal=%s ?" % (epoch, ordinal))
            self._store(rec)
        elif key is not None and rec.key.endswith(" ?"):
            # a placeholder record (created by an out-of-order delivery note)
            # learns its full path:rg identity — trace id follows the key
            rec.key = key
            rec.trace_id = zlib.crc32(key.encode("utf-8", "replace")) \
                & 0x7FFFFFFF
        return rec

    def add_item_span(self, epoch, ordinal, site, t0, t1, key=None):
        """Driver-side span keyed by item identity (the pool driver threads
        record wire spans here — they never hold the item's thread context)."""
        with self._lock:
            self._get_or_create(epoch, ordinal, key).add_span(site, t0, t1)

    def annotate_item(self, epoch, ordinal, name, value, key=None):
        with self._lock:
            self._get_or_create(epoch, ordinal, key).annotate(name, value)

    def absorb_child(self, blob, pid, wall_anchor, perf_anchor):
        """Merge a pool child's piggybacked item record, clock-aligning its
        spans onto this recorder's timeline exactly like
        :meth:`petastorm_tpu_torch.trace.TraceRecorder.add_child` (same host, shared
        wall clock; alignment error is wall-sampling jitter)."""
        if blob is None:
            return
        epoch, ordinal, key, spans, annotations = blob
        base = (wall_anchor - self._wall_origin) - perf_anchor + self._origin
        with self._lock:
            rec = self._items.get((epoch, ordinal))
            if rec is None:
                rec = self._get_or_create(epoch, ordinal, key)
            elif rec.key.endswith(" ?"):
                self._get_or_create(epoch, ordinal, key)  # learn the identity
            if any(p == pid for _s, _t0, _t1, p in rec.spans):
                # a retry re-delivered the same item from the same child:
                # count it, keep the fresh attempt's spans (the delivered one)
                self.duplicate_absorbs += 1
                rec.spans = [sp for sp in rec.spans if sp[3] != pid]
                rec.attempts += 1
            for site, t0, t1, span_pid in spans:
                # span_pid is the child's own pid (stamped at record time)
                rec.spans.append((site, t0 + base, t1 + base, span_pid or pid))
            for name, value in annotations.items():
                if isinstance(value, (int, float)) and name in rec.annotations:
                    rec.annotations[name] = rec.annotations[name] + value
                else:
                    rec.annotations[name] = value

    def note_quarantined(self, epoch, ordinal, attempts, kind):
        """Quarantine accounting (exactly-once beside delivery: a quarantined
        item never enters the delivery FIFO)."""
        with self._lock:
            rec = self._get_or_create(epoch, ordinal)
            rec.annotate("quarantined", kind)
            rec.attempts = max(rec.attempts, attempts)
            self._quarantined.append((epoch, ordinal, attempts, kind))

    def note_delivery(self, epoch, ordinal, rows):
        """Reader-side: ``rows`` of item ``(epoch, ordinal)`` entered the
        consumer stream (in order) — the batch cutter consumes this FIFO to
        attribute batches to items."""
        with self._lock:
            rec = self._get_or_create(epoch, ordinal)
            rec.rows += int(rows)
            if self._track_batches:
                self._delivery_fifo.append([epoch, ordinal, int(rows)])

    # -- batch plane ----------------------------------------------------------------

    def producer_cut(self, rows, collate_t0=None, collate_s=None):
        """A batch of ``rows`` was cut by the host batcher: attribute its
        membership from the delivery FIFO and open its
        :class:`BatchProvenance` (returned for the loader's later span/drop
        calls)."""
        with self._lock:
            items = None
            if self._track_batches:
                items = []
                need = int(rows)
                fifo = self._delivery_fifo
                while need > 0 and fifo:
                    entry = fifo[0]
                    take = min(entry[2], need)
                    items.append((entry[0], entry[1], take))
                    entry[2] -= take
                    need -= take
                    if entry[2] <= 0:
                        fifo.popleft()
            self._batch_seq += 1
            bp = BatchProvenance(self._batch_seq, int(rows), items)
            if collate_t0 is not None and collate_s:
                bp.add_span("loader.collate", collate_t0,
                            collate_t0 + collate_s)
            self._pending_transfer.append(bp)
            self._pending_delivery.append(bp)
        return bp

    def batch_dropped(self, bp):
        """A cut batch died inside the pipeline (short tail dropped, stopped
        delivery): retire it so the transfer/delivery pointers stay aligned."""
        with self._lock:
            bp.dropped = True
            try:
                self._pending_transfer.remove(bp)
            except ValueError:
                pass
            try:
                self._pending_delivery.remove(bp)
            except ValueError:
                pass

    def batch_span(self, bp, site, t0, dur):
        """Record a batch-plane span on a specific open batch."""
        if bp is not None and dur is not None:
            bp.add_span(site, t0, t0 + dur)

    def transfer_next(self):
        """The transfer thread is starting the next batch (strict FIFO order
        through the host queue): returns its BatchProvenance."""
        with self._lock:
            self._current_transfer = (self._pending_transfer.popleft()
                                      if self._pending_transfer else None)
            return self._current_transfer

    def transfer_span(self, site, t0, dur):
        """Record a span against the batch currently in transfer."""
        bp = self._current_transfer
        if bp is not None:
            bp.add_span(site, t0, t0 + dur)

    def batch_delivered(self):
        """The consumer took the next batch: finalize its provenance (stamp
        the delivery time and the step gap to the previous one), emit flow
        events when a tracer is attached, and return it."""
        now = time.perf_counter()
        with self._lock:
            if not self._pending_delivery:
                return None
            bp = self._pending_delivery.popleft()
            try:
                # host-only delivery paths never run a transfer stage: keep
                # the transfer pointer from trailing ever further behind
                self._pending_transfer.remove(bp)
            except ValueError:
                pass
            bp.delivered_t = now
            if self._last_delivered_t is not None:
                bp.step_gap_s = now - self._last_delivered_t
            self._last_delivered_t = now
            self._completed.append(bp)
            tracer = self._tracer
            records = None
            if tracer is not None and bp.items:
                records = [self._items.get((e, o)) for e, o, _r in bp.items]
        if tracer is not None and records:
            self._emit_flows(tracer, bp, [r for r in records if r is not None])
        return bp

    def _emit_flows(self, tracer, bp, records):
        """Perfetto flow events: one flow per item (id = the stable trace_id),
        stepping through the item's spans on their pid lanes and terminating
        at the batch's delivery on the local loader lane."""
        local = _PID
        add_point = getattr(tracer, "add_flow_point", None)
        if add_point is None:
            return
        for rec in records:
            points = sorted(rec.spans, key=lambda sp: sp[1])
            if not points:
                continue
            for site, t0, _t1, pid in points:
                lane = "ptpu-prov" if pid == local else "ptpu-child-%d" % pid
                add_point(rec.trace_id, lane, pid, t0, name=site)
            add_point(rec.trace_id, "ptpu-prov", local, bp.delivered_t,
                      name="batch.delivered", terminate=True)

    # -- reporting ----------------------------------------------------------------------

    def last_batch(self):
        """The most recently delivered batch's provenance view (dict with the
        contributing item records resolved), or None."""
        with self._lock:
            if not self._completed:
                return None
            bp = self._completed[-1]
            return self._batch_view(bp)

    def _batch_view(self, bp):
        out = bp.to_dict()
        items = []
        if bp.items:
            for epoch, ordinal, rows in bp.items:
                rec = self._items.get((epoch, ordinal))
                if rec is not None:
                    d = rec.to_dict()
                    d["rows_in_batch"] = rows
                    items.append(d)
        out["item_records"] = items
        return out

    def batches(self):
        """Snapshot of completed batch provenance records (newest last)."""
        with self._lock:
            return [self._batch_view(bp) for bp in self._completed]

    def items(self):
        """Snapshot of the item registry: ``{key: record dict}``."""
        with self._lock:
            return {rec.key: rec.to_dict() for rec in self._items.values()}

    def quarantined(self):
        with self._lock:
            return list(self._quarantined)

    def report(self, tenant=None):
        """Fold the completed batches into a step-time
        :class:`~petastorm_tpu_torch.obs.critical_path.AttributionReport`.
        ``tenant`` restricts the fold to batches whose
        contributing items carry that tenant annotation — "whose tail is
        this" becomes a per-tenant question."""
        from petastorm_tpu_torch.obs.critical_path import analyze_batches

        batches = self.batches()
        if tenant is not None:
            batches = [b for b in batches if any(
                (item.get("annotations") or {}).get("tenant") == tenant
                for item in b.get("item_records") or ())]
        return analyze_batches(batches)

    def attribution_report(self, tenant=None):
        """Alias of :meth:`report` under the loader's public name, so a bare
        recorder answers ``attribution_report(tenant=...)`` the same way
        ``DataLoader.attribution_report`` does."""
        return self.report(tenant=tenant)

    def summary(self):
        """Flat numeric summary for the flight recorder and the metrics
        collector (``ptpu_prov_*`` families): counts plus per-site
        critical-path self seconds (site names sanitized to metric-safe
        suffixes). Memoized on the recorder's version (batches finalized /
        items seen): metric snapshots poll this on a cadence, and re-folding
        an unchanged 2k-batch window every few seconds would make the
        observability plane the thing the observability plane flags."""
        with self._lock:
            version = (self._batch_seq, len(self._completed),
                       len(self._items), len(self._quarantined),
                       self.duplicate_absorbs)
            cached = self._summary_cache
            if cached is not None and cached[0] == version:
                return dict(cached[1])
        report = self.report()
        with self._lock:
            out = {
                "items": len(self._items),
                "batches": len(self._completed),
                "quarantined": len(self._quarantined),
                "duplicate_absorbs": self.duplicate_absorbs,
            }
            for site, seconds in report.stage_self_s.items():
                out["self_s_%s" % _metric_safe(site)] = round(seconds, 6)
            self._summary_cache = (version, dict(out))
        return out


def _metric_safe(site):
    return "".join(c if c.isalnum() else "_" for c in site)


def env_enabled():
    """The ``PTPU_PROVENANCE`` no-code-change switch (mirrors ``PTPU_HEALTH``)
    — ONE copy of the accepted truthiness set."""
    return os.environ.get("PTPU_PROVENANCE", "") not in ("", "0", "false",
                                                         "no")


def resolve(provenance, env_default=True):
    """Normalize a ``provenance=`` argument (None/True/recorder) into an
    ARMED :class:`ProvenanceRecorder` or None. ``PTPU_PROVENANCE=1`` enables
    the default recorder when the argument is None (and ``env_default``).

    A recorder CONSTRUCTED here is tagged ``_auto_disarm``: the component it
    was built for (reader/loader) disarms it at ITS teardown. A recorder the
    caller passed in stays armed across teardowns — the caller owns its
    lifecycle (it may feed several pipelines in sequence)."""
    if provenance is None and env_default and env_enabled():
        provenance = True
    if not provenance:
        return None
    if isinstance(provenance, ProvenanceRecorder):
        rec = provenance
    else:
        rec = ProvenanceRecorder()
        rec._auto_disarm = True
    rec.arm()
    return rec
