"""The object-store read tier: parallel ranged GETs, hedging, footer GETs.

Port of ``petastorm_tpu.io.remote``. Against a cloud object store one
``ParquetFile.read_row_group`` call issues one serial ranged request a column chunk,
every worker re-reads each file's footer, and a single slow replica (the store's fat
tail) stalls a whole row group. This module is the tier that reads such a store:

- :class:`RemoteReadEngine` plans the exact column-chunk byte ranges of a row-group read
  from the (shared, cached) footer, **gap-coalesces** them
  (:func:`petastorm_tpu_torch.io.coalesce.plan_byte_ranges`: a gap of at most
  ``min_gap_bytes`` costs less than a second round trip), splits merged spans at
  ``target_request_bytes``, and issues them as **parallel ranged GETs** on a bounded
  pool. The fetched segments back a sparse in-memory file; pyarrow parses from it
  without opening the object.
- **Request hedging**: a per-(store, size class) log-bucketed latency histogram
  (:class:`LatencyModel`) learns what a GET of this size normally costs; an attempt
  still pending at the configured quantile gets a duplicate GET, and the first responder
  wins. The loser is drained and its accounting :class:`~petastorm_tpu_torch.io.lease.Lease`
  released, never delivered.
- **Footer GETs**: a footer-cache miss reads the file's *tail* (one GET of 32 KB, one
  more only when the footer outgrows it) and parses the metadata from those bytes alone.
  With a host-wide cache arena (:mod:`petastorm_tpu_torch.io.arena`) a footer another
  process already parsed is mapped from the arena first, so a process pool fetches each
  footer from the store once.
- :meth:`RemoteReadEngine.read_raw_column_chunks`: the compressed-page pass-through's
  raw column-chunk spans, split at walked page starts on a re-read
  (:func:`petastorm_tpu_torch.io.pagedec.shared_page_index`).

Every feature degrades: a failed engine build falls back to the classic ``ParquetFile``
path (degradation ``remote_unavailable``), and a read the sparse file cannot serve goes
to the store as one more ranged GET (``remote_sparse_fallbacks``; correct, just slower).
The counts are per engine, read through :meth:`RemoteReadEngine.stats` under the JAX
package's key names. Each GET attempt is the chaos site ``io.remote`` (key
``<path>:<offset>+<length>#primary|hedge``). Every count also rises on the process-wide
registry under the JAX package's families (``ptpu_io_remote_gets_total``,
``ptpu_io_remote_bytes_total``, ``ptpu_io_hedges_total``, ``ptpu_io_hedge_wins_total``,
``ptpu_io_remote_sparse_fallbacks_total``, ``ptpu_io_remote_footer_fetches_total``), and
the shared latency model's histograms are ``ptpu_io_remote_get_seconds{store=,
size_class=}`` there. With a :class:`~petastorm_tpu_torch.trace.TraceRecorder` attached
(:meth:`RemoteReadEngine.set_trace`) a row-group read and a raw chunk fetch are each an
``io.remote`` span (the GETs and the stitch), where the JAX package records the same span.
A GET issued by a tagged reader's thread (:mod:`petastorm_tpu_torch.obs.tenant`) also
counts on the tenant's twins of the GET, byte, hedge and hedge-win families
(``{tenant=...}``) and charges each hedge to the tenant's ``hedged_gets``.
:class:`RemoteIoOptions` and
:func:`fs_is_remote` carry the options and the auto probe.
"""
from __future__ import annotations

import os
import threading
import time
import weakref
import zlib

from petastorm_tpu_torch.io.coalesce import plan_byte_ranges
from petastorm_tpu_torch.obs import provenance as _prov
from petastorm_tpu_torch.obs import tenant as _tenant
from petastorm_tpu_torch.obs.metrics import MetricsRegistry

#: pyarrow filesystem type_names that are NOT object stores (the auto probe)
_LOCAL_TYPE_NAMES = frozenset({"local", "localfs", "mock", "subtree", "py::fsspec+file"})

#: first tail GET size: covers typical footers in one trip; a footer that outgrows it
#: costs exactly one more ranged GET (and the footer cache makes either once a file a
#: process, so a lean guess beats a fat one: the guessed bytes are paid at every miss)
_FOOTER_TAIL_GUESS = 32 << 10

#: per-process single flight of footer fetches, striped by path: the worker threads that
#: miss one footer together fetch it once
_FOOTER_FLIGHTS = tuple(threading.Lock() for _ in range(64))

#: seconds ``RemoteReadEngine.shutdown`` waits for executing GETs to land
_JOIN_TIMEOUT_S = 5.0


def _env_int(name, default):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def _env_float(name, default):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_bool(name, default):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off")


def _env_tristate(name):
    raw = os.environ.get(name)
    if raw is None or raw == "" or raw.strip().lower() == "auto":
        return None
    return raw.strip().lower() not in ("0", "false", "no", "off")


def _env_str(name, default):
    raw = os.environ.get(name)
    return default if raw is None or raw == "" else raw.strip()


class RemoteIoOptions:
    """Knobs of the remote tier, riding on :class:`petastorm_tpu_torch.io.IoOptions`
    (``io_options=dict(remote=...)``). Same fields, defaults and env overrides as the
    JAX package's:

    ======================  ==============================  =====================
    field                   env var                         meaning
    ======================  ==============================  =====================
    enabled                 PTPU_REMOTE                     ``None`` (default) =
                                                            auto: on when the
                                                            filesystem is not
                                                            local; True/False
                                                            force it
    target_request_bytes    PTPU_REMOTE_TARGET_REQUEST_     split merged spans
                            BYTES                           into parallel GETs of
                                                            at most this (8 MB)
    max_inflight            PTPU_REMOTE_MAX_INFLIGHT        ranged GETs in flight
                                                            a process (8)
    min_gap_bytes           PTPU_REMOTE_MIN_GAP_BYTES       merge reads whose
                                                            byte gap is at most
                                                            this (512 KB); also
                                                            the gap the row-group
                                                            run planner bridges
    hedge                   PTPU_REMOTE_HEDGE               duplicate a GET past
                                                            its deadline (on)
    hedge_quantile          PTPU_REMOTE_HEDGE_QUANTILE      latency quantile that
                                                            arms the deadline
                                                            (0.95)
    hedge_min_s             PTPU_REMOTE_HEDGE_MIN_S         deadline floor (0.05)
    hedge_min_samples       PTPU_REMOTE_HEDGE_MIN_SAMPLES   observations a (store,
                                                            size class) before
                                                            hedging (20)
    get_timeout_s           PTPU_REMOTE_GET_TIMEOUT_S       wall cap on one GET
                                                            with its hedge (300)
    footer_cache_bytes      PTPU_FOOTER_CACHE_BYTES         shared parsed-footer
                                                            budget (64 MB; 0 =
                                                            per-open re-reads)
    disk_admit              PTPU_TIER_DISK_ADMIT            ``always`` or
                                                            ``scan-resistant``
    ======================  ==============================  =====================
    """

    __slots__ = ("enabled", "target_request_bytes", "max_inflight",
                 "min_gap_bytes", "hedge", "hedge_quantile", "hedge_min_s",
                 "hedge_min_samples", "get_timeout_s", "footer_cache_bytes",
                 "disk_admit")

    def __init__(self, enabled=None, target_request_bytes=None, max_inflight=None,
                 min_gap_bytes=None, hedge=None, hedge_quantile=None,
                 hedge_min_s=None, hedge_min_samples=None, get_timeout_s=None,
                 footer_cache_bytes=None, disk_admit=None):
        self.enabled = _env_tristate("PTPU_REMOTE") if enabled is None \
            else (None if enabled == "auto" else bool(enabled))
        self.target_request_bytes = max(
            64 << 10, _env_int("PTPU_REMOTE_TARGET_REQUEST_BYTES", 8 << 20)
            if target_request_bytes is None else int(target_request_bytes))
        self.max_inflight = max(1, _env_int("PTPU_REMOTE_MAX_INFLIGHT", 8)
                                if max_inflight is None else int(max_inflight))
        self.min_gap_bytes = max(0, _env_int("PTPU_REMOTE_MIN_GAP_BYTES", 512 << 10)
                                 if min_gap_bytes is None else int(min_gap_bytes))
        self.hedge = _env_bool("PTPU_REMOTE_HEDGE", True) \
            if hedge is None else bool(hedge)
        self.hedge_quantile = min(0.999, max(0.5, _env_float(
            "PTPU_REMOTE_HEDGE_QUANTILE", 0.95) if hedge_quantile is None
            else float(hedge_quantile)))
        self.hedge_min_s = max(0.0, _env_float("PTPU_REMOTE_HEDGE_MIN_S", 0.05)
                               if hedge_min_s is None else float(hedge_min_s))
        self.hedge_min_samples = max(1, _env_int(
            "PTPU_REMOTE_HEDGE_MIN_SAMPLES", 20) if hedge_min_samples is None
            else int(hedge_min_samples))
        self.get_timeout_s = max(1.0, _env_float("PTPU_REMOTE_GET_TIMEOUT_S", 300.0)
                                 if get_timeout_s is None else float(get_timeout_s))
        self.footer_cache_bytes = max(0, _env_int(
            "PTPU_FOOTER_CACHE_BYTES", 64 << 20) if footer_cache_bytes is None
            else int(footer_cache_bytes))
        disk_admit = _env_str("PTPU_TIER_DISK_ADMIT", "always") \
            if disk_admit is None else str(disk_admit)
        if disk_admit not in ("always", "scan-resistant"):
            raise ValueError("disk_admit must be 'always' or 'scan-resistant', "
                             "got %r" % disk_admit)
        self.disk_admit = disk_admit

    @classmethod
    def normalize(cls, value):
        """``None`` → defaults (env-aware), dict → kwargs, instance → itself."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError("remote io options must be a RemoteIoOptions, a dict of "
                        "its fields, or None; got %r" % type(value).__name__)

    def active_for(self, fs):
        """Is the remote tier on for this filesystem? Explicit ``enabled`` wins; auto
        probes the pyarrow ``type_name`` (local stays off)."""
        if self.enabled is not None:
            return self.enabled
        return fs_is_remote(fs)

    def __getstate__(self):
        return {name: getattr(self, name) for name in self.__slots__}

    def __setstate__(self, state):
        for name in self.__slots__:
            setattr(self, name, state.get(name, getattr(type(self)(), name)))

    def __repr__(self):
        return "RemoteIoOptions(%s)" % ", ".join(
            "%s=%r" % (name, getattr(self, name)) for name in self.__slots__)


def fs_is_remote(fs):
    """Best-effort object-store probe: pyarrow filesystems expose ``type_name``
    ('local', 'gcs', 's3', 'hdfs', 'py::fsspec+gs', ...)."""
    try:
        type_name = getattr(fs, "type_name", None)
    except Exception:  # noqa: BLE001 - exotic proxies: assume local
        return False
    if not isinstance(type_name, str):
        return False
    return type_name.lower() not in _LOCAL_TYPE_NAMES


# --------------------------------------------------------------------------------------
# Latency model (feeds the hedge deadline)
# --------------------------------------------------------------------------------------

_SIZE_CLASSES = ((64 << 10, "64KB"), (256 << 10, "256KB"), (1 << 20, "1MB"),
                 (4 << 20, "4MB"), (16 << 20, "16MB"))

def size_class(nbytes):
    """Log-spaced request-size bucket label (hedge deadlines are a size class's: a
    16 MB GET is not slow just because it takes longer than a 64 KB one)."""
    for bound, label in _SIZE_CLASSES:
        if nbytes <= bound:
            return label
    return ">16MB"


class LatencyModel:
    """Per-(store, size class) GET latency histograms and the hedge deadline, on the
    log-bucketed :class:`~petastorm_tpu_torch.obs.metrics.Histogram` (the JAX package's
    primitive, so the same observations give the same deadline). Each histogram is the
    registry's ``ptpu_io_remote_get_seconds{store=,size_class=}``, so the learned
    distribution exports beside the hedge counters it drives. The shared model uses the
    process-wide registry; a model given none keeps its own."""

    def __init__(self, registry=None):
        self._registry = registry if registry is not None else MetricsRegistry()
        self._lock = threading.Lock()
        self._hists = {}

    def _hist(self, store, label):
        key = (store, label)
        with self._lock:
            hist = self._hists.get(key)
            if hist is None:
                hist = self._hists[key] = self._registry.histogram(
                    "ptpu_io_remote_get_seconds",
                    help="ranged GET latency by store and request size class",
                    store=store, size_class=label)
        return hist

    def observe(self, store, nbytes, seconds):
        self._hist(store, size_class(nbytes)).observe(seconds)

    def deadline(self, store, nbytes, quantile, min_samples, floor_s):
        """Seconds after which a pending GET of this size is tail-suspect, or ``None``
        while its class has too few observations to judge."""
        hist = self._hist(store, size_class(nbytes))
        if hist.count < min_samples:
            return None
        return max(floor_s, hist.percentile(quantile))

    def reset(self):
        """Zero every learned distribution."""
        with self._lock:
            hists = list(self._hists.values())
        for hist in hists:
            hist.reset()


_model_lock = threading.Lock()
_model = None

#: the engine counts that rise on the process-wide registry too, under the JAX
#: package's family names
_FAMILIES = {
    "gets": ("ptpu_io_remote_gets_total", "ranged GETs issued (incl. hedges)"),
    "bytes": ("ptpu_io_remote_bytes_total", "bytes fetched by ranged GETs"),
    "hedges": ("ptpu_io_hedges_total",
               "duplicate GETs issued past the latency-quantile deadline"),
    "hedge_wins": ("ptpu_io_hedge_wins_total",
                   "hedged GETs where the duplicate responded first"),
    "sparse_fallbacks": ("ptpu_io_remote_sparse_fallbacks_total",
                         "reads the prefetched segments could not serve (went to "
                         "storage)"),
    "footer_fetches": ("ptpu_io_remote_footer_fetches_total",
                       "footers fetched via ranged tail GETs"),
}


def _registry_families(reg):
    """``{count name: Counter}`` on ``reg``."""
    return {name: reg.counter(family, help=text)
            for name, (family, text) in _FAMILIES.items()}


def shared_latency_model():
    """The process-wide model: every engine (one a worker) feeds and consults the same
    distributions, so N workers learn the store's tail N times faster."""
    global _model
    with _model_lock:
        if _model is None:
            from petastorm_tpu_torch.obs.metrics import default_registry

            _model = LatencyModel(default_registry())
        return _model


# --------------------------------------------------------------------------------------
# Hedged GET machinery
# --------------------------------------------------------------------------------------


class _GetState:
    """Coordination slot of one logical ranged GET and its possible hedge.

    The first completed attempt wins: it parks its payload (under an accounting
    :class:`~petastorm_tpu_torch.io.lease.Lease`) and sets ``done``. A later attempt, the
    drained loser, releases its lease at once and its payload is dropped: the consumer
    never sees two copies. ``abandoned`` is set by the waiter once the GET's outcome is
    decided (payload taken, or error raised): an attempt landing after that is a loser,
    so even a very late success cannot strand a lease."""

    __slots__ = ("lock", "done", "data", "lease", "winner_role", "errors",
                 "outstanding", "hedged", "deadline_s", "abandoned",
                 "exec_start", "exec_started", "tenant")

    def __init__(self):
        self.lock = threading.Lock()
        self.done = threading.Event()
        self.data = None
        self.lease = None
        self.winner_role = None
        self.errors = []
        self.outstanding = 0
        self.hedged = False
        self.deadline_s = None  # hedge deadline from the primary's execution start
        self.abandoned = False
        self.exec_start = None  # monotonic time the primary began executing
        #: set the instant the primary starts executing (or dies before it starts): the
        #: supervisor waits on this while the GET is queued in the pool, so deadlines
        #: run from execution start exactly
        self.exec_started = threading.Event()
        #: the tenant slug of the issuing thread (the pool threads that run the
        #: attempts carry no tenant context)
        self.tenant = None

    def take(self):
        """Claim the winning payload (exactly once) and abandon the slot."""
        with self.lock:
            data, self.data = self.data, None
            lease, self.lease = self.lease, None
            self.abandoned = True
        if lease is not None:
            lease.release()
        return data


#: engines whose GET threads must be joined before interpreter finalization (the
#: readahead pool's exit drain, :mod:`petastorm_tpu_torch.io.readahead`): ``shutdown``
#: does not wait for an executing GET, so the exit hook joins them, bounded
_live_engines_lock = threading.Lock()
_live_engines = weakref.WeakSet()
_exit_drain = []


def _install_exit_drain():
    with _live_engines_lock:
        if _exit_drain:
            return
        _exit_drain.append(True)
    import concurrent.futures.thread  # noqa: F401 — its exit hook registers first

    register = getattr(threading, "_register_atexit", None)
    if register is not None:
        register(_drain_live_engines)
    else:  # pragma: no cover - Python < 3.9
        import atexit

        atexit.register(_drain_live_engines)


def _drain_live_engines():
    from concurrent.futures import thread as cf_thread

    from petastorm_tpu_torch.io.readahead import _abandon_pool_threads

    with _live_engines_lock:
        engines = list(_live_engines)
    for engine in engines:
        engine.shutdown()
    deadline = time.monotonic() + 10.0
    for engine in engines:
        for pool in engine._all_pools():
            for t in list(getattr(pool, "_threads", ()) or ()):
                t.join(max(0.05, deadline - time.monotonic()))
            _abandon_pool_threads(pool, cf_thread)


class RemoteReadEngine:
    """Per-process ranged-GET executor for one filesystem.

    Owns a bounded thread pool (``max_inflight``); :meth:`shutdown` stops it
    (idempotent; the worker's ``close()`` calls it at ``Reader.join``) and joins its
    threads, bounded. ``registry`` takes the engine's count families (the process-wide
    registry by default)."""

    def __init__(self, fs, options=None, footer_cache=None, registry=None,
                 latency_model=None, store_key=None):
        from concurrent.futures import ThreadPoolExecutor

        self._fs = fs
        self._opts = options if options is not None \
            else RemoteIoOptions.normalize(None)
        #: None: refetch the footer on every call (the measurable no-cache mode)
        self._footers = footer_cache
        self._model = latency_model if latency_model is not None \
            else shared_latency_model()
        self._store = store_key or str(getattr(fs, "type_name", "remote"))
        self._closed = False
        self._lock = threading.Lock()
        #: live knob state: seeded from the options once and retuned only through the
        #: apply_*() methods (the options struct is never mutated)
        self._max_inflight = self._opts.max_inflight
        self._hedge_quantile = self._opts.hedge_quantile
        #: GET pools replaced by a live apply_max_inflight() resize: their in-flight
        #: attempts finish on their own threads (a retune never fails a read)
        self._retired_pools = []
        self._pool = ThreadPoolExecutor(max_workers=self._max_inflight,
                                        thread_name_prefix="ptpu-torch-remote")
        self._n = {"gets": 0, "bytes": 0, "hedges": 0, "hedge_wins": 0,
                   "sparse_fallbacks": 0, "footer_fetches": 0, "footer_arena_maps": 0}
        if registry is None:
            from petastorm_tpu_torch.obs.metrics import default_registry

            registry = default_registry()
        self._reg = registry
        self._families = _registry_families(registry)
        #: a TraceRecorder the io.remote spans go to (set_trace; None: off)
        self._tracer = None
        with _live_engines_lock:
            _live_engines.add(self)
        _install_exit_drain()

    def set_trace(self, tracer):
        """Record an ``io.remote`` span for each row-group read and raw chunk fetch
        (None: stop)."""
        self._tracer = tracer

    def _span(self, t0):
        """The ``io.remote`` span of a row-group read or raw chunk fetch: into the trace,
        and onto the calling item's provenance record (nested in its ``reader.read`` or
        ``io.pagedec``: the fold charges those sites only their residual)."""
        dur = time.perf_counter() - t0
        tracer = self._tracer
        if tracer is not None:
            tracer.add("io.remote", t0, dur)
        if _prov.ACTIVE is not None:
            _prov.add_span("io.remote", t0, dur)

    def _count(self, name, n=1, tenant=None):
        with self._lock:
            self._n[name] += n
        family = self._families.get(name)
        if family is not None:
            family.inc(n)
            if tenant is not None:
                # the tenant's twin, beside the untagged total: the twins sum to it
                self._reg.counter(_FAMILIES[name][0], tenant=tenant).inc(n)

    def _all_pools(self):
        with self._lock:
            return [self._pool] + list(self._retired_pools)

    # -- footer plane -------------------------------------------------------------------

    def footer(self, path):
        """The parsed footer of ``path``, fetched with ranged tail GETs (never a full
        open). With a footer cache attached, each footer is fetched once a process: the
        threads that miss it together wait for one fetch. With a host-wide arena too, a
        footer another process published is mapped instead, and the fetch is single
        flight across the host (:meth:`~petastorm_tpu_torch.io.arena.CacheArena.single_flight`),
        so a process pool fetches each footer from the store once."""
        footers = self._footers
        if footers is None:
            from petastorm_tpu_torch.io.footercache import FooterEntry

            return FooterEntry(*self._fetch_footer(path))
        entry = footers.peek(path)
        if entry is not None:
            footers.count_hit()
            return entry
        footers.count_miss()
        flight = _FOOTER_FLIGHTS[zlib.crc32(path.encode("utf-8")) % len(_FOOTER_FLIGHTS)]
        with flight:
            entry = footers.peek(path)
            if entry is not None:  # another thread of this process fetched it
                return entry
            from petastorm_tpu_torch.io import arena as arena_mod

            arena_obj = arena_mod.process_arena()
            if arena_obj is None:
                metadata, size = self._fetch_footer(path)
                return footers.put(path, metadata, size)
            size = int(self._fs.get_file_info(path).size)
            with arena_obj.single_flight(("ft", path)):
                entry = footers.from_arena(path, size)
                if entry is not None:
                    self._count("footer_arena_maps")
                    return entry
                metadata, size = self._fetch_footer(path, size)
                return footers.put(path, metadata, size)  # publishes it host-wide

    def _fetch_footer(self, path, size=None):
        import pyarrow as pa
        import pyarrow.parquet as pq

        if size is None:
            size = int(self._fs.get_file_info(path).size)
        guess = min(size, _FOOTER_TAIL_GUESS)
        tail = bytes(self.fetch_ranges(path, [(size - guess, guess)])[0])
        if len(tail) < 8 or tail[-4:] != b"PAR1":
            raise OSError("%s: not a parquet file (bad magic in tail GET)" % path)
        footer_len = int.from_bytes(tail[-8:-4], "little")
        need = footer_len + 8
        if need > len(tail):
            if need > size:
                raise OSError("%s: footer length %d exceeds file size %d"
                              % (path, footer_len, size))
            head = self.fetch_ranges(path, [(size - need, need - len(tail))])[0]
            tail = bytes(head) + tail
        metadata = pq.read_metadata(pa.BufferReader(tail))
        self._count("footer_fetches")
        return metadata, size

    # -- data plane ---------------------------------------------------------------------

    def read_row_groups(self, path, row_groups, columns):
        """Read ``row_groups`` of ``path`` restricted to top-level ``columns`` (None:
        all) through parallel hedged ranged GETs. Returns ``(table, footer_entry)``: the
        row groups concatenated in list order, equal to a ``ParquetFile`` read.

        ``columns`` the file lacks (hive partition columns, schema drift) are dropped
        against the footer's arrow schema: the classic path's availability filter,
        resolved from the one footer this call already holds."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        t0 = time.perf_counter()
        entry = self.footer(path)
        md = entry.metadata
        if columns is not None:
            available = set(md.schema.to_arrow_schema().names)
            columns = [c for c in columns if c in available]
        ranges = column_chunk_ranges(md, row_groups, columns)
        plan = plan_byte_ranges(ranges, self._opts.min_gap_bytes,
                                self._opts.target_request_bytes)
        chunks = list(zip((off for off, _ in plan), self.fetch_ranges(path, plan)))
        size = entry.size
        if size is None:
            size = int(self._fs.get_file_info(path).size)
        src = _SparseFile(path, size, chunks, self)
        pf = pq.ParquetFile(pa.PythonFile(src, mode="r"), metadata=md)
        table = pf.read_row_groups(list(row_groups), columns=columns)
        self._span(t0)
        return table, entry

    def arrow_names(self, path):
        """Column names of ``path``'s arrow schema, from the cached footer."""
        return list(self.footer(path).metadata.schema.to_arrow_schema().names)

    def raw_chunk_plan(self, path, row_group, columns):
        """The request plan of :meth:`read_raw_column_chunks`: ``[(column, [(offset,
        length), ...]), ...]`` in the footer's column order.

        A chunk of at most ``target_request_bytes`` is one request. A bigger one splits
        at walked page starts when :func:`~petastorm_tpu_torch.io.pagedec.shared_page_index`
        holds its pages (a split only where the piece since the last split reaches the
        target), else at ``target_request_bytes``."""
        from petastorm_tpu_torch.io.pagedec import chunk_byte_range, shared_page_index

        rgmd = self.footer(path).metadata.row_group(row_group)
        wanted = set(columns)
        plans = []
        target = self._opts.target_request_bytes
        index = shared_page_index()
        for i in range(rgmd.num_columns):
            col = rgmd.column(i)
            name = col.path_in_schema.split(".")[0]
            if name not in wanted or any(p[0] == name for p in plans):
                continue
            start, length = chunk_byte_range(col)
            if length <= target:
                plans.append((name, [(start, length)]))
                continue
            cached = index.get(path, row_group, name)
            ranges = []
            prev = start
            if cached is not None:
                for off in cached[1]:
                    if start < off < start + length and off - prev >= target:
                        ranges.append((prev, off - prev))
                        prev = off
            else:
                while start + length - prev > target:
                    ranges.append((prev, target))
                    prev += target
            ranges.append((prev, start + length - prev))
            plans.append((name, [r for r in ranges if r[1] > 0]))
        return plans

    def read_raw_column_chunks(self, path, row_group, columns):
        """Raw column-chunk byte spans for the compressed-page pass-through: ``{column:
        bytes}`` of row group ``row_group``'s chunks, fetched as ONE batched hedged
        ranged-GET plan (:meth:`raw_chunk_plan`: page-granular splits once a walk cached
        the chunk's pages)."""
        t0 = time.perf_counter()
        plans = self.raw_chunk_plan(path, row_group, columns)
        payloads = self.fetch_ranges(path, [r for _name, ranges in plans for r in ranges])
        out = {}
        pos = 0
        for name, ranges in plans:
            parts = payloads[pos:pos + len(ranges)]
            pos += len(ranges)
            out[name] = bytes(parts[0]) if len(parts) == 1 \
                else b"".join(bytes(p) for p in parts)
        self._span(t0)
        return out

    def fetch_ranges(self, path, ranges):
        """Fetch ``[(offset, length), ...]`` as parallel hedged GETs; the payloads in
        request order. Ranges are issued as given (callers plan them first).

        Every primary is submitted up front (they run concurrently on the bounded pool);
        the calling thread then supervises the hedge deadlines. Attempts never wait on
        attempts, so the pool cannot deadlock on itself however large the plan is."""
        if not ranges:
            return []
        t0 = time.monotonic()
        states = [self._start_get(path, off, ln) for off, ln in ranges]
        out = []
        try:
            for state, (off, ln) in zip(states, ranges):
                out.append(self._finish_get(state, path, off, ln, t0))
        except BaseException:
            # the rest of the plan is abandoned: a parked winner's lease goes back now,
            # and an attempt still running drains when it lands
            for state in states[len(out):]:
                state.take()
            raise
        return out

    def _start_get(self, path, offset, length):
        """Submit the primary attempt; the latency model is consulted once, now."""
        state = _GetState()
        state.outstanding = 1
        state.tenant = _tenant.current_label()
        if self._opts.hedge:
            state.deadline_s = self._model.deadline(
                self._store, length, self._hedge_quantile,
                self._opts.hedge_min_samples, self._opts.hedge_min_s)
        self._submit_attempt(state, path, offset, length, "primary")
        return state

    def _finish_get(self, state, path, offset, length, t0):
        """Await one logical GET: hedge when its deadline passes, take the first
        responder, raise when every attempt failed.

        Supervising a fan-out in sequence is deliberate: while the caller waits on an
        earlier range, later primaries keep running, and a later range found past ITS
        deadline on arrival is hedged at once. The hedge deadline and the timeout run
        from the attempt's **execution start**, not the submit: a GET queued behind a
        big plan waits on us, not on a slow replica, and hedging it would only load the
        same saturated pool twice. ``t0`` bounds the never-started case (a dead pool)."""
        never_started_at = t0 + 2 * self._opts.get_timeout_s
        while True:
            now = time.monotonic()
            with state.lock:
                started = state.exec_start
                alive = state.outstanding > 0
            if state.done.is_set():
                break
            if started is None:
                # queued, not executing: wake the instant execution begins. A shutdown
                # cancels queued attempts, which then never start: stop waiting
                if now >= never_started_at or self._closed:
                    break
                state.exec_started.wait(min(0.5, never_started_at - now))
                continue
            timeout_at = started + self._opts.get_timeout_s
            if now >= timeout_at:
                break
            if state.deadline_s is not None and not state.hedged and alive \
                    and now - started >= state.deadline_s:
                with state.lock:
                    fire = state.outstanding > 0 and not state.hedged
                    if fire:
                        state.outstanding += 1
                        state.hedged = True
                if fire:
                    self._count("hedges", tenant=state.tenant)
                    if state.tenant is not None:
                        _tenant.charge("hedged_gets", 1, label=state.tenant)
                    if _prov.ACTIVE is not None:
                        # supervision runs on the item's own thread: the annotation
                        # lands on the right record
                        _prov.annotate_add("hedges", 1)
                    self._submit_attempt(state, path, offset, length, "hedge")
                continue
            next_wake = timeout_at
            if state.deadline_s is not None and not state.hedged:
                next_wake = min(next_wake, started + state.deadline_s)
            state.done.wait(max(0.0, next_wake - now))
        # take() abandons the slot, so a late attempt can only drain; a winner that
        # landed in the timeout race is delivered rather than stranded
        data = state.take()
        if data is not None:
            if _prov.ACTIVE is not None and state.winner_role == "hedge":
                _prov.annotate_add("hedge_wins", 1)
            return data
        if state.errors:
            raise state.errors[-1]
        if self._closed:
            raise OSError("remote engine shut down while fetching %s [%d, +%d)"
                          % (path, offset, length))
        raise TimeoutError("ranged GET of %s [%d, +%d) still pending after %.0fs"
                           % (path, offset, length, self._opts.get_timeout_s))

    def _submit_attempt(self, state, path, offset, length, role):
        with self._lock:
            pool = self._pool
        try:
            pool.submit(self._run_attempt, state, path, offset, length, role)
        except RuntimeError:
            # the pool shut down mid-flight (Reader.join raced a straggler read): the
            # attempt fails, so the waiter is released
            self._attempt_failed(state, OSError(
                "remote engine shut down while fetching %s" % path))

    def _run_attempt(self, state, path, offset, length, role):
        from petastorm_tpu_torch import chaos as _chaos
        from petastorm_tpu_torch.io.lease import Lease

        if role == "primary":
            with state.lock:
                state.exec_start = time.monotonic()
            state.exec_started.set()
        try:
            if _chaos.ACTIVE is not None:
                _chaos.ACTIVE.hit("io.remote",
                                  key="%s:%d+%d#%s" % (path, offset, length, role))
            t0 = time.perf_counter()
            data = self._fetch(path, offset, length)
            dur = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — stored, re-raised at the waiter
            self._attempt_failed(state, e)
            return
        self._model.observe(self._store, length, dur)
        self._count("gets", tenant=state.tenant)
        self._count("bytes", len(data), tenant=state.tenant)
        lease = Lease(kind="remote_get")
        deliver = False
        with state.lock:
            state.outstanding -= 1
            if state.winner_role is None and not state.abandoned:
                state.winner_role = role
                state.data = data
                state.lease = lease
                deliver = True
        if deliver:
            if role == "hedge":
                self._count("hedge_wins", tenant=state.tenant)
            state.done.set()
        else:
            # the drained loser: release the accounting lease, drop the bytes
            lease.release()

    def _attempt_failed(self, state, error):
        with state.lock:
            state.errors.append(error)
            state.outstanding -= 1
            last = state.outstanding <= 0 and state.winner_role is None
        if last:
            state.done.set()
        state.exec_started.set()  # wake a supervisor parked on the queue wait

    def _fetch(self, path, offset, length):
        """One ranged GET, on its own handle (the object store's request model, and
        what keeps attempts independently hedgeable)."""
        with self._fs.open_input_file(path) as f:
            f.seek(offset)
            return f.read(length)

    # -- live knobs ---------------------------------------------------------------------

    def apply_max_inflight(self, max_inflight):
        """Resize the GET pool live: new attempts go to a fresh pool of the target
        width; the old pool's queued and executing GETs finish on its own threads
        (their ``_GetState`` delivery keeps the lease accounting exact)."""
        from concurrent.futures import ThreadPoolExecutor

        max_inflight = max(1, int(max_inflight))
        with self._lock:
            if self._closed or max_inflight == self._max_inflight:
                return self._max_inflight
            old = self._pool
            self._pool = ThreadPoolExecutor(max_workers=max_inflight,
                                            thread_name_prefix="ptpu-torch-remote")
            self._max_inflight = max_inflight
            # prune retired pools whose threads have all exited
            self._retired_pools = [
                p for p in self._retired_pools
                if any(t.is_alive() for t in getattr(p, "_threads", ()) or ())]
            self._retired_pools.append(old)
        old.shutdown(wait=False)
        return max_inflight

    def apply_hedge_quantile(self, quantile):
        """Retune the hedge-arming latency quantile live (bounded to the options'
        [0.5, 0.999]); the next GET's deadline uses it."""
        quantile = min(0.999, max(0.5, float(quantile)))
        with self._lock:
            self._hedge_quantile = quantile
        return quantile

    @property
    def max_inflight(self):
        return self._max_inflight

    @property
    def hedge_quantile(self):
        return self._hedge_quantile

    # -- lifecycle ----------------------------------------------------------------------

    def shutdown(self):
        """Stop the GET pool(s) and join their threads, bounded by ``_JOIN_TIMEOUT_S``
        (idempotent). Queued GETs are cancelled (their waiters see an error); an
        executing one finishes and drains through its ``_GetState``, so the lease
        accounting stays exact either way."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pools = [self._pool] + list(self._retired_pools)
        for pool in pools:
            pool.shutdown(wait=False, cancel_futures=True)
        if threading.current_thread().name.startswith("ptpu-torch-remote"):
            return  # never join ourselves
        deadline = time.monotonic() + _JOIN_TIMEOUT_S
        for pool in pools:
            for t in list(getattr(pool, "_threads", ()) or ()):
                t.join(max(0.0, deadline - time.monotonic()))

    def stats(self):
        with self._lock:
            out = {"remote_%s" % k: v for k, v in self._n.items()}
            out["remote_max_inflight"] = self._max_inflight
            out["remote_hedge_quantile"] = self._hedge_quantile
        return out


def column_chunk_ranges(metadata, row_groups, columns):
    """The ``(offset, length)`` byte ranges of the column chunks a
    ``read_row_groups(row_groups, columns=columns)`` call touches (``columns`` match the
    top-level field of ``path_in_schema``: the arrow column names workers select by)."""
    wanted = None if columns is None else set(columns)
    ranges = []
    for rg in row_groups:
        rgmd = metadata.row_group(rg)
        for i in range(rgmd.num_columns):
            col = rgmd.column(i)
            if wanted is not None and col.path_in_schema.split(".")[0] not in wanted:
                continue
            start = col.data_page_offset
            if col.dictionary_page_offset is not None:
                start = min(start, col.dictionary_page_offset)
            ranges.append((start, col.total_compressed_size))
    return ranges


class _SparseFile:
    """Read-only file over prefetched ``(offset, bytes)`` segments.

    Serves pyarrow's column-chunk reads from memory; a read outside the segments (pyarrow
    reading a structure the planner did not anticipate) goes to the store as one ranged
    GET (counted ``remote_sparse_fallbacks``; correct, just slower). Wrapped in
    ``pa.PythonFile`` by the engine."""

    def __init__(self, path, size, chunks, engine):
        self._path = path
        self._size = int(size)
        self._segments = sorted((int(off), memoryview(data)) for off, data in chunks)
        self._engine = engine
        self._pos = 0
        self._closed = False

    def read(self, nbytes=None):
        if nbytes is None:
            nbytes = self._size - self._pos
        nbytes = max(0, min(int(nbytes), self._size - self._pos))
        if nbytes == 0:
            return b""
        pos = self._pos
        # gather across segments: a target-size split leaves contiguous neighbours, so a
        # chunk crossing a split still serves from memory, stitched
        parts = []
        need = nbytes
        p = pos
        for start, view in self._segments:
            if need == 0:
                break
            if start > p:
                break  # a gap: not covered
            if p < start + len(view):
                take = min(need, start + len(view) - p)
                parts.append(view[p - start:p - start + take])
                p += take
                need -= take
        if need == 0:
            self._pos = pos + nbytes
            if len(parts) == 1:
                return bytes(parts[0])
            return b"".join(bytes(v) for v in parts)
        self._engine._count("sparse_fallbacks")
        data = self._engine._fetch(self._path, pos, nbytes)
        self._pos = pos + len(data)
        return data

    def seek(self, pos, whence=0):
        if whence == 0:
            self._pos = int(pos)
        elif whence == 1:
            self._pos += int(pos)
        elif whence == 2:
            self._pos = self._size + int(pos)
        else:
            raise ValueError("unsupported whence %r" % (whence,))
        self._pos = max(0, min(self._pos, self._size))
        return self._pos

    def tell(self):
        return self._pos

    def size(self):
        return self._size

    def close(self):
        self._closed = True

    @property
    def closed(self):
        return self._closed

    def readable(self):
        return True

    def seekable(self):
        return True

    def writable(self):
        return False


def build_engine(fs, remote_opts, registry=None):
    """The engine with its footer cache, by policy: the shared process-wide cache when
    ``footer_cache_bytes`` asks for one, none (a tail GET a read) otherwise. ``None``
    when the tier is off for this filesystem. ``registry`` as the engine's."""
    if not remote_opts.active_for(fs):
        return None
    footer_cache = None
    if remote_opts.footer_cache_bytes:
        from petastorm_tpu_torch.io.footercache import configure_budget

        footer_cache = configure_budget(remote_opts.footer_cache_bytes)
    return RemoteReadEngine(fs, options=remote_opts, footer_cache=footer_cache,
                            registry=registry)
