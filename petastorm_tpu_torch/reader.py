"""Reader core: ``make_reader`` / ``make_batch_reader`` / ``Reader``.

Port of ``petastorm_tpu.reader``: the two worker types (``PyDictWorker`` per-row decode,
``ArrowWorker`` columnar batches), ``_column_to_numpy`` with its ``device_fields``
staging branch, sharding, epochs, shuffling of row groups, and the thread, dummy and
process pools (with the process pool's socket and shared-memory wires). Row selection
runs as in the JAX package: ``filters`` prune hive ``key=value`` directories and row
groups whose parquet statistics cannot match before anything is scheduled
(:mod:`petastorm_tpu_torch.partitions`), ``rowgroup_selector`` picks row groups through a
prebuilt index, and the remaining clauses, a ``predicate`` and
``shuffle_row_drop_partitions`` run as row masks in the workers; partition columns
materialize as ordinary values. ``Reader.state_dict()`` is the exact-resume cursor (the
consumed-work map, :mod:`petastorm_tpu_torch.checkpoint`). With
``decode_on_device=True`` the JPEG columns stop at stage 1 (host entropy decode into
coefficient planes, one native call per row group) and the
:class:`~petastorm_tpu_torch.loader.DataLoader` finishes them on its device. With the
compressed-page pass-through (``io_options={"pagedec": ...}``) eligible fixed-width
columns travel as their raw compressed pages, and the DataLoader inflates them on its
device. The read path is the JAX package's by default
(``io_options``, :class:`~petastorm_tpu_torch.io.IoOptions`): each worker's next row
groups are read ahead on a small IO thread pool while it decodes
(:mod:`~petastorm_tpu_torch.io.readahead`), adjacent row groups of one file merge into
one ranged read (:mod:`~petastorm_tpu_torch.io.coalesce`), idle workers steal claimed
items (:class:`~petastorm_tpu_torch.workers.PullDispatcher`), and each file's footer is
parsed once a process (:mod:`~petastorm_tpu_torch.io.footercache`). Every row group goes
through one cache funnel (:mod:`~petastorm_tpu_torch.io.tiers`): an in-memory LRU of
decoded payloads (``memcache_bytes``), the host-wide shared-memory arena every process
of the host maps (``arena_bytes``, :mod:`~petastorm_tpu_torch.io.arena`), then
``cache_type="local-disk"`` (:mod:`~petastorm_tpu_torch.cache`). On an object store
(a filesystem whose ``type_name`` is not local) reads go through the ranged-GET engine
(:mod:`~petastorm_tpu_torch.io.remote`): footers from the file's tail, column chunks as
parallel hedged GETs. A ``transform_spec`` (an opaque
:class:`~petastorm_tpu_torch.transform.TransformSpec` or a declarative
:class:`~petastorm_tpu_torch.ops.tabular.FeaturePipeline`, compiled by the factories)
runs in the workers, or on the device in the DataLoader when it says ``device=True``.
``schema_fields=NGram(...)`` (:mod:`petastorm_tpu_torch.ngram`) windows each row group in
the workers, after the host transform: the per-row reader delivers ``{offset:
namedtuple}`` windows, the batch reader flat ``{'offset/field': column}`` dicts, one row a
window.

Failure handling is the JAX package's (``recovery=``,
:class:`~petastorm_tpu_torch.recovery.RecoveryOptions`): a transient read error
(connection reset, timeout, a storage client's own exception) is retried ``io_retries``
times with jittered exponential backoff, once for a read whether it runs in the
foreground or in the readahead pool, and a poison row group is quarantined
(``Reader.quarantine_report``) and charged to the consumed-work map. The chaos sites
``reader.read``, ``reader.read_run`` and ``io.pagedec`` inject faults there
(:mod:`petastorm_tpu_torch.chaos`).

``provenance=True`` (or a shared
:class:`~petastorm_tpu_torch.obs.provenance.ProvenanceRecorder`, or ``PTPU_PROVENANCE=1``)
records each plan item's spans at the same sites (``reader.read``, ``reader.read_run``,
``io.pagedec``, ``transform``), its retries (``io_retries``) and the cache tier that
served it, and notes each delivery and quarantine for the loader's batch attribution.

``watch=`` (:mod:`petastorm_tpu_torch.dataset.watch`) reads a store that changes under
the reader: each file's generation token is stamped into its plan items and cache keys
and checked at every read (a rewritten file's pending items quarantine as
``piece_rewritten``, a deleted one's as ``piece_removed``), and a watch thread extends
the plan with appended files in the current epoch and a rewritten file's new generation
in the next.
"""
from __future__ import annotations

import logging
import random
import re
import threading
import time
import weakref
from collections import OrderedDict

import numpy as np

from petastorm_tpu_torch import chaos as _chaos
from petastorm_tpu_torch.cache import NullCache, make_cache
from petastorm_tpu_torch.errors import PERMANENT_IO_ERRORS as _PERMANENT_IO_ERRORS
from petastorm_tpu_torch.errors import (DecodeFieldError, NoDataAvailableError,
                                       PieceRemovedError, PieceRewrittenError)
from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths
from petastorm_tpu_torch.io import IoOptions
from petastorm_tpu_torch.io.lease import LEASE_KEY
from petastorm_tpu_torch.io.pagedec import materialize_columns
from petastorm_tpu_torch.metadata import get_schema, infer_or_load_unischema, load_row_groups
from petastorm_tpu_torch.parallel.shm_ring import degradation
from petastorm_tpu_torch.ngram import NGram, form_ngram_columns
from petastorm_tpu_torch.obs import provenance as _prov
from petastorm_tpu_torch.obs import tenant as _tenant
from petastorm_tpu_torch.plan import EpochPlan, shard_indices
from petastorm_tpu_torch.recovery import (QuarantinedItem, QuarantineEntry,
                                          QuarantineReport, RecoveryOptions,
                                          count_quarantined)
from petastorm_tpu_torch.transform import transform_schema
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.utils import decode_row, stack_as_column
from petastorm_tpu_torch.workers import make_executor

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------------------
# Workers (one instance shared by all pool threads)
# --------------------------------------------------------------------------------------


class _Tagged:
    """Runs the worker on ``(epoch, ordinal, (piece, partition))`` plan items and tags
    the result with its ``(epoch, ordinal)``, the reader's checkpoint identity.

    ``tenant`` (a :class:`~petastorm_tpu_torch.obs.tenant.TenantContext`, pickled into a
    process pool's children) is activated on the thread around each item, so every IO
    charge made there lands on it; the item's provenance record is stamped with it and
    its seconds are charged to the tenant's ``worker_s``. The live knobs
    (``apply_<knob>``) are forwarded to the worker: a child's control frame reaches them
    through this wrapper."""

    def __init__(self, worker, tenant=None):
        self._worker = worker
        self.tenant_context = tenant

    def __call__(self, tagged_item):
        epoch, ordinal, item = tagged_item
        ctx = self.tenant_context
        if ctx is None:
            return epoch, ordinal, self._worker(item)
        with _tenant.activate(ctx):
            # the pool began the item's record before this activation
            _prov.annotate("tenant", ctx.tenant)
            t0 = time.perf_counter()
            try:
                return epoch, ordinal, self._worker(item)
            finally:
                _tenant.charge("worker_s", time.perf_counter() - t0, label=ctx.tenant)

    def prefetch(self, tagged_items):
        """Readahead hint: the plan items without their dispatch tags."""
        self._worker.prefetch([tagged[2] for tagged in tagged_items])

    def warm(self):
        self._worker.warm()

    def close(self):
        self._worker.close()

    def io_stats(self):
        return self._worker.io_stats()

    def apply_settings(self, settings):
        """Set worker attributes in a process-pool child (``{name: value}``, sent by the
        parent ahead of an item: a loader's adoption of a running reader)."""
        for name, value in settings.items():
            setattr(self._worker, name, value)

    def live_io_knobs(self):
        return self._worker.live_io_knobs()

    def apply_readahead_depth(self, depth):
        return self._worker.apply_readahead_depth(depth)

    def apply_readahead_bytes(self, nbytes):
        return self._worker.apply_readahead_bytes(nbytes)

    def apply_remote_max_inflight(self, max_inflight):
        return self._worker.apply_remote_max_inflight(max_inflight)

    def apply_hedge_quantile(self, quantile):
        return self._worker.apply_hedge_quantile(quantile)

    def apply_pagedec(self, mode):
        return self._worker.apply_pagedec(mode)

    def apply_arena_bytes(self, nbytes):
        return self._worker.apply_arena_bytes(nbytes)


def _spec_wants_writable(spec):
    """True when the host transform is an OPAQUE callable that may mutate the worker
    payload in place: the workers hand it copies (fresh row dicts, a pandas frame), never
    the read's own arrays. Declarative pipelines are out of place by construction (each
    fused stage materializes its own output column) and device transforms do not run in
    the workers."""
    return (spec is not None and not spec.device and spec.func is not None
            and not getattr(spec, "declarative", False))


def _host_pipeline(spec):
    """True when ``spec`` is a declarative pipeline that runs in the workers."""
    return spec is not None and not spec.device and getattr(spec, "declarative", False)


def _pandas_transform(spec, columns):
    """An opaque host transform on the batch path: the columns as a pandas DataFrame
    through ``spec.func``, then back to columns (tensor rows stacked once, scalar
    object columns such as strings as object arrays)."""
    import pandas as pd

    pdf = spec.func(pd.DataFrame({k: list(v) if v.ndim > 1 else v
                                  for k, v in columns.items()}))
    out = {}
    for name in pdf.columns:
        series = pdf[name]
        out[name] = stack_as_column(series.to_list()) if series.dtype == object \
            else series.to_numpy()
    return out


#: exception-module roots of the storage client stacks that fsspec-bridged filesystems
#: raise through pyarrow (gcsfs, botocore, aiohttp, google.api_core, ...). Most of these
#: are not OSErrors, so they are classified by origin: an error born in the storage
#: layer is worth the bounded retries, and a permanent one just fails a little later.
_TRANSIENT_ERROR_MODULES = frozenset(
    ("gcsfs", "s3fs", "adlfs", "fsspec", "aiohttp", "aiobotocore", "botocore",
     "urllib3", "requests", "google", "azure"))


def _is_transient_io_error(exc):
    """Retry-worthy? OSErrors are (less the permanent subclasses); anything a storage
    client stack raised is; everything else (corrupt parquet as ``ArrowInvalid``, user
    code errors) fails at once."""
    if isinstance(exc, _PERMANENT_IO_ERRORS):
        return False
    if isinstance(exc, OSError):
        return True
    mod = (type(exc).__module__ or "").split(".")[0]
    return mod in _TRANSIENT_ERROR_MODULES


def _close_quietly(pf):
    """Close a cached ParquetFile for real: it wraps an already-open file
    (``_close_source=False``), so ``close()`` without ``force`` would leave the
    descriptor to the garbage collector."""
    try:
        pf.close(force=True)
    except Exception:  # noqa: BLE001 — best-effort close of an evicted handle
        pass


#: serializes the lazy per-process construction of the readahead pool (module level:
#: worker objects stay picklable, with no lock of their own)
_io_init_lock = threading.Lock()


class _WorkerBase:
    """Shared row-group loading: column-pruned reads through per-thread open files (each
    file's footer from the process-wide footer cache), the readahead pool that reads a
    worker's next row groups while it decodes, the cache funnel, the row masks
    (``filters``, ``predicate``, row-drop partitions), the hive partition columns, and
    the host half of a ``transform_spec``."""

    #: max cached open parquet files per thread (fd bound: threads × this)
    MAX_OPEN_FILES = 64

    def __init__(self, filesystem, read_schema, stored_schema, device_fields=frozenset(),
                 transform_spec=None, predicate=None, filters=None,
                 shuffle_row_drop_partitions=1, seed=None, partition_info=None,
                 cache=None, io_options=None, recovery=None):
        self._fs = filesystem
        self._read_schema = read_schema  # fields to deliver
        self._stored_schema = stored_schema  # full stored schema (decode source of truth)
        self._device_fields = frozenset(device_fields)  # host-stage-only decode columns
        self._transform_spec = transform_spec  # compiled by the factory; pickled to children
        self._predicate = predicate
        self._filters = filters  # normalized user filters: the row-level mask
        self._drop_partitions = max(1, int(shuffle_row_drop_partitions or 1))
        self._seed = seed
        self._partition_info = partition_info  # hive key=value layout (or None)
        self._cache = cache if cache is not None else NullCache()
        self._io_options = IoOptions.normalize(io_options)
        #: transient-IO retry policy (io_retries, backoff, read deadline)
        self._recovery = RecoveryOptions.normalize(recovery)
        self._local = threading.local()
        self._io_tracer = None  # the readahead pool's TraceRecorder (set_trace)
        self._io_health = None  # the readahead pool's HealthMonitor (set_health)
        self._readahead = None  # built lazily, in each process, by the first prefetch
        self._io_closed = False  # latched by close(); reopen() re-arms (Reader.reset)
        self._readahead_unavailable = False  # this worker's pool failed to build
        self._remote = None  # the ranged-GET engine, built lazily in each process
        self._remote_unavailable = False  # off for this filesystem, or failed to build
        #: live retunes ({knob: value}): a lazily built readahead pool or GET engine
        #: starts at them, and pool children spawned later inherit them in the pickle
        self._knob_overrides = {}

    def __getstate__(self):
        # a process-pool child opens its own files and builds its own readahead pool
        # and GET pool
        state = dict(self.__dict__)
        state["_local"] = None
        state["_readahead"] = None
        state["_io_closed"] = False
        state["_readahead_unavailable"] = False
        state["_remote"] = None
        state["_remote_unavailable"] = False
        state["_io_tracer"] = None
        state["_io_health"] = None  # holds threads: never crosses the pickle wire
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._local = threading.local()

    @staticmethod
    def warm():
        """Pay a process's first-use cost of a read before it takes work: pyarrow's first
        ``to_numpy`` imports pandas, half a second of one core and seconds on a busy
        host. A pool child calls this before it announces itself, so that its heartbeat,
        busy from the send of each item, times the work and not the import."""
        import pyarrow as pa

        pa.array([0]).to_numpy()

    def _cache_get(self, key, fill):
        """Read through the cache funnel. A memcache serves zero-copy read-only views;
        an opaque host ``TransformSpec`` runs user code that may write into the payload
        in place, so it takes the funnel's copy-on-write serve (``get_writable``).
        Declarative pipelines and device transforms keep the read-only views."""
        get_writable = getattr(self._cache, "get_writable", None)
        if _spec_wants_writable(self._transform_spec) and get_writable is not None:
            return get_writable(key, fill)
        if _prov.ACTIVE is not None and isinstance(self._cache, NullCache):
            # no funnel was built (no cache configured): every serve reads the store,
            # which the TieredCache annotates as "remote"
            _prov.annotate("cache_tier", "remote")
        return self._cache.get(key, fill)

    def _cache_key(self, item):
        piece, partition = item
        return _cache_key(piece, self._read_schema, self._predicate, self._filters,
                          partition, self._drop_partitions, self._seed,
                          self._device_fields)

    def _footer_cache(self):
        """The process-wide parsed-footer cache, or ``None`` when
        ``remote.footer_cache_bytes`` is 0. Shared by every worker thread, the IO
        threads and the planner's footer scan."""
        budget = self._io_options.remote.footer_cache_bytes
        if not budget:
            return None
        from petastorm_tpu_torch.io.footercache import configure_budget

        return configure_budget(budget)

    def _parquet_file(self, path):
        """This thread's open ``ParquetFile`` of ``path`` (LRU of ``MAX_OPEN_FILES``),
        opened with the cached footer (no footer read at open on a hit). The open handle
        is kept as ``_ptpu_source``: the pass-through's positional raw-chunk reads use
        it."""
        import pyarrow.parquet as pq

        cache = getattr(self._local, "files", None)
        if cache is None:
            cache = self._local.files = OrderedDict()
        pf = cache.get(path)
        if pf is None:
            # the stat identity this thread's last generation check saw (dataset
            # watching): the footer is pinned to it and the handle tagged with it
            stat = getattr(self._local, "stats", {}).get(path)
            f = self._fs.open_input_file(path)
            try:
                footers = self._footer_cache()
                metadata = None if footers is None \
                    else footers.get(self._fs, path, source=f, stat_token=stat).metadata
                pf = pq.ParquetFile(f, metadata=metadata)
            except BaseException:
                f.close()
                raise
            pf._ptpu_source = f
            pf._ptpu_stat = stat
            cache[path] = pf
            while len(cache) > self.MAX_OPEN_FILES:  # LRU-evict to bound open fds
                _, old = cache.popitem(last=False)
                _close_quietly(old)
        else:
            cache.move_to_end(path)
        return pf

    # -- the readahead pool -------------------------------------------------------------

    def _readahead_pool(self, create=False):
        """This process's readahead pool, or None (readahead off, closed, or failed to
        build). Built lazily by the first ``prefetch``: a reader whose executor sends no
        hints stays synchronous. A construction failure turns readahead off for this
        worker (degradation ``readahead_unavailable``)."""
        if not self._io_options.readahead or self._readahead_unavailable:
            return None
        pool = self._readahead
        if pool is None and create:
            with _io_init_lock:
                pool = self._readahead
                if pool is None and not self._io_closed:
                    from petastorm_tpu_torch.io.readahead import ReadaheadPool

                    opts = self._io_options
                    knobs = self._knob_overrides
                    try:
                        # byte-gap run merging only on an object store; local reads
                        # merge strictly adjacent row groups
                        gap_ok = self._rowgroup_gap_ok \
                            if opts.remote.active_for(self._fs) else None
                        pool = ReadaheadPool(
                            self._read_columns_sync, read_run_fn=self._read_run,
                            depth=knobs.get("readahead_depth", opts.readahead_depth),
                            byte_budget=knobs.get("readahead_bytes",
                                                  opts.readahead_bytes),
                            io_threads=knobs.get("io_threads", opts.io_threads),
                            coalesce=opts.coalesce,
                            coalesce_max_run=opts.coalesce_max_run, gap_ok=gap_ok)
                        if self._io_tracer is not None:
                            pool.set_trace(self._io_tracer)
                        if self._io_health is not None:
                            pool.set_health(self._io_health)
                    except Exception as e:  # noqa: BLE001 — degrade to sync reads
                        degradation("readahead_unavailable",
                                    "readahead pool construction failed (%s); reads "
                                    "stay synchronous", e)
                        # this worker's flag, never the caller's IoOptions (which other
                        # readers may share)
                        self._readahead_unavailable = True
                        return None
                    self._readahead = pool
        return pool

    # -- the object-store tier ---------------------------------------------------------

    def _remote_engine(self, create=False):
        """This process's ranged-GET engine, or ``None`` when the remote tier is off for
        this filesystem (local reads keep the classic ``ParquetFile`` path). Built
        lazily like the readahead pool, never pickled (each pool child builds its own);
        a failed build degrades this worker to classic reads (``remote_unavailable``)."""
        if self._remote_unavailable:
            return None
        engine = self._remote
        if engine is None and create:
            opts = self._io_options.remote
            if not opts.active_for(self._fs):
                self._remote_unavailable = True  # probe once
                return None
            with _io_init_lock:
                engine = self._remote
                if engine is None and not self._io_closed:
                    try:
                        from petastorm_tpu_torch.io.remote import build_engine

                        engine = build_engine(self._fs, opts)
                    except Exception as e:  # noqa: BLE001 — degrade to classic reads
                        degradation("remote_unavailable",
                                    "remote ranged-GET engine construction failed (%s); "
                                    "reads use the classic ParquetFile path", e)
                        engine = None
                    if engine is None:
                        self._remote_unavailable = True
                        return None
                    if self._io_tracer is not None:
                        engine.set_trace(self._io_tracer)
                    # retunes made before this lazy build: the engine starts at them
                    knobs = self._knob_overrides
                    if "remote_max_inflight" in knobs:
                        engine.apply_max_inflight(knobs["remote_max_inflight"])
                    if "hedge_quantile" in knobs:
                        engine.apply_hedge_quantile(knobs["hedge_quantile"])
                    self._remote = engine
        return engine

    def _rowgroup_gap_ok(self, prev, piece):
        """Byte-gap predicate of the run planner: True when the hole between two row
        groups of one file (footer-cache spans) is at most ``remote.min_gap_bytes``, so
        reading it costs less than a second request. False when the footer is not
        cached."""
        footers = self._footer_cache()
        if footers is None:
            return False
        entry = footers.peek(prev.path)
        if entry is None or piece.row_group >= entry.num_row_groups \
                or prev.row_group >= entry.num_row_groups:
            return False
        gap = entry.row_group_span(piece.row_group)[0] \
            - entry.row_group_span(prev.row_group)[1]
        return 0 <= gap <= self._io_options.remote.min_gap_bytes

    def prefetch(self, items):
        """Dispatch hint: queue background reads of the upcoming plan ``items``
        (``(piece, partition)``) so their IO overlaps the current item's decode. Skips
        what the cache funnel will serve and, on the batch path, the pass-through's
        columns (their raw pages are read by the foreground). Never raises: a failure
        leaves the reads synchronous (degradation ``readahead_fallback``)."""
        pool = self._readahead_pool(create=True)
        if pool is None or not items:
            return
        try:
            columns = self._first_read_columns()
            requests = []
            for item in items:
                if self._cache.contains(self._cache_key(item)):
                    continue  # the mem or disk tier serves it without a read
                cols = columns
                # peek_only: a prefetch never reads a footer; until the footer is cached
                # the hint asks for the classic set
                eligible = self._pagedec_eligible(item[0], columns, peek_only=True)
                if eligible:
                    cols = [c for c in columns if c not in eligible]
                    if not cols:
                        continue  # nothing classic left to prefetch
                requests.append((item[0], cols))
            if requests:
                pool.schedule(requests)
        except Exception as e:  # noqa: BLE001 — a prefetch must never fail a read
            degradation("readahead_fallback",
                        "prefetch scheduling failed (%s); reads stay synchronous", e)

    def _first_read_columns(self):
        """The column selection of this worker's FIRST read of any piece: what a
        prefetch must request for its table to be a hit."""
        raise NotImplementedError

    def _pagedec_eligible(self, piece, wanted, peek_only=False, stat_token=None):
        """The pass-through's eligible columns (the batch path's; none here)."""
        return {}

    def close(self):
        """Release this process's readahead pool and ranged-GET engine (``Reader.join``,
        a pool child's exit) and latch both off, so a straggling executor thread cannot
        rebuild them during teardown. Idempotent; :meth:`reopen` re-arms them."""
        with _io_init_lock:
            self._io_closed = True
            pool, self._readahead = self._readahead, None
            engine, self._remote = self._remote, None
        if pool is not None:
            pool.shutdown()
        if engine is not None:
            engine.shutdown()

    def set_trace(self, tracer):
        """Attach a :class:`~petastorm_tpu_torch.trace.TraceRecorder` to this process's
        readahead pool (``io.readahead`` and ``io.wait`` spans), now and when it is
        built."""
        self._io_tracer = tracer
        pool = self._readahead
        if pool is not None:
            pool.set_trace(tracer)
        engine = self._remote
        if engine is not None:
            engine.set_trace(tracer)

    def set_health(self, monitor):
        """Attach a health monitor to this process's readahead pool (each IO thread
        heartbeats its background reads), now and when it is built."""
        self._io_health = monitor
        pool = self._readahead
        if pool is not None:
            pool.set_health(monitor)

    def reopen(self):
        """Re-arm the lazy readahead pool after :meth:`close` (``Reader.reset``)."""
        with _io_init_lock:
            self._io_closed = False

    # -- live knobs -----------------------------------------------------------------------
    #
    # The retune seam the controller's KnobSet binds to. Each apply records the override
    # (a pool or engine built later starts retuned; a pool child spawned later inherits
    # it through the pickle) and forwards to the live component when there is one. The
    # IoOptions are never mutated: one options object may be shared across readers.

    #: the per-row worker decodes rows: the pass-through is the batch path's
    _pagedec_supported = False

    def live_io_knobs(self):
        """The LIVE IO knob values (the live component, else the override, else the
        options)."""
        opts = self._io_options
        pool = self._readahead
        engine = self._remote
        knobs = self._knob_overrides
        return {
            "readahead_depth": pool.depth if pool is not None
            else knobs.get("readahead_depth", opts.readahead_depth),
            "readahead_bytes": (pool.byte_budget or 0) if pool is not None
            else knobs.get("readahead_bytes", opts.readahead_bytes),
            "io_threads": pool.io_threads if pool is not None
            else knobs.get("io_threads", opts.io_threads),
            "remote_max_inflight": engine.max_inflight if engine is not None
            else knobs.get("remote_max_inflight", opts.remote.max_inflight),
            "hedge_quantile": engine.hedge_quantile if engine is not None
            else knobs.get("hedge_quantile", opts.remote.hedge_quantile),
        }

    def apply_readahead_depth(self, depth):
        """Retune the prefetch window. The IO thread pool grows with it (up to 16): a
        deeper window on the configured threads would queue, not overlap."""
        depth = max(1, int(depth))
        self._knob_overrides["readahead_depth"] = depth
        io_threads = max(self._io_options.io_threads, min(depth, 16))
        self._knob_overrides["io_threads"] = io_threads
        pool = self._readahead
        if pool is not None:
            pool.apply_depth(depth)
            pool.apply_io_threads(io_threads)
        return depth

    def apply_readahead_bytes(self, nbytes):
        nbytes = max(0, int(nbytes))
        self._knob_overrides["readahead_bytes"] = nbytes
        pool = self._readahead
        if pool is not None:
            pool.apply_byte_budget(nbytes)
        return nbytes

    def apply_remote_max_inflight(self, max_inflight):
        max_inflight = max(1, int(max_inflight))
        self._knob_overrides["remote_max_inflight"] = max_inflight
        engine = self._remote
        if engine is not None:
            engine.apply_max_inflight(max_inflight)
        return max_inflight

    def apply_hedge_quantile(self, quantile):
        quantile = min(0.999, max(0.5, float(quantile)))
        self._knob_overrides["hedge_quantile"] = quantile
        engine = self._remote
        if engine is not None:
            engine.apply_hedge_quantile(quantile)
        return quantile

    def apply_mem_cache_bytes(self, nbytes):
        """Retune the mem tier's budget; 0 (a no-op) without a mem tier."""
        mem = getattr(self._cache, "mem", None)
        if mem is None:
            return 0
        return mem.apply_budget(nbytes)

    def apply_arena_bytes(self, nbytes):
        """Retune the host-wide arena's budget. It lives in the arena's shared control
        segment, so one retune governs every attached process's admissions; a shrink
        evicts unheld entries host-wide at once. 0 (a no-op) without an arena."""
        from petastorm_tpu_torch.io import arena as arena_mod

        arena_obj = arena_mod.process_arena()
        if arena_obj is None:
            return 0
        return arena_obj.set_budget(nbytes)

    def live_pagedec(self):
        """The LIVE pass-through mode (the override, else the options)."""
        return self._knob_overrides.get("pagedec", self._io_options.pagedec)

    def apply_pagedec(self, mode):
        """Retune the pass-through mode; it applies from the worker's next read (a
        process pool's children get it in a control frame)."""
        mode = str(mode).strip().lower()
        if mode not in ("auto", "on", "off"):
            raise ValueError("pagedec accepts auto/on/off, got %r" % mode)
        self._knob_overrides["pagedec"] = mode
        return mode

    def io_stats(self):
        """This process's read-path counts: the readahead pool's, the cache funnel's
        (tiers, memcache), the ranged-GET engine's, the footer cache's and the host-wide
        arena's."""
        out = {}
        pool = self._readahead
        if pool is not None:
            out.update(pool.stats())
        stats_fn = getattr(self._cache, "stats", None)
        if stats_fn is not None:
            out.update(stats_fn())
        engine = self._remote
        if engine is not None:
            out.update(engine.stats())
        footers = self._footer_cache()
        if footers is not None:
            out.update(footers.stats())
        from petastorm_tpu_torch.io import arena as arena_mod

        arena_obj = arena_mod.process_arena()
        if arena_obj is not None:
            out.update(arena_obj.stats())
        return out

    # -- reads --------------------------------------------------------------------------

    def _read_columns(self, piece, columns):
        """One row group's ``columns``, from the readahead pool when the dispatch layer
        prefetched it (a failed background read re-raises here, as the synchronous read
        would), else read now."""
        pool = self._readahead_pool()
        if pool is not None:
            table = pool.get(piece, columns)
            if table is not None:
                return table
            # a miss falling to the blocking read is exposed read latency
            t0 = time.perf_counter()
            table = self._read_columns_sync(piece, columns)
            pool.note_sync_read(time.perf_counter() - t0)
            return table
        return self._read_columns_sync(piece, columns)

    def _read_columns_sync(self, piece, columns):
        """The blocking read of one row group's ``columns`` (those the file holds), with
        the piece's partition columns attached: through the ranged-GET engine on an
        object store, else the thread's open ``ParquetFile``; transient errors retried
        (:meth:`_retry_io`). The readahead pool runs this same read in the background."""
        return self._retry_io(
            lambda: self._read_columns_once(piece, columns), piece.path,
            "%s row group %d" % (piece.path, piece.row_group))

    def _retry_io(self, fn, path, what):
        """One copy of the transient-retry protocol, shared by the single and the
        coalesced reads (the same budget either way): ``io_retries`` extra attempts
        with jittered exponential backoff capped at ``io_retry_max_backoff_s``, within
        ``read_deadline_s`` across all attempts when set, the file's open handle and
        footer dropped between attempts. Every retry is a ``cause="io_retry"``
        degradation; permanent errors raise at once."""
        rec = self._recovery
        attempt = 0
        t_first = time.monotonic()
        while True:
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — classified below
                if not _is_transient_io_error(e) or attempt >= rec.io_retries:
                    raise
                if rec.read_deadline_s and \
                        time.monotonic() - t_first >= rec.read_deadline_s:
                    degradation(
                        "io_retry", "read deadline (%.0fs) exhausted for %s after %d "
                        "attempt(s); raising the last error", rec.read_deadline_s, what,
                        attempt + 1)
                    raise
                self._evict_parquet_file(path)
                _prov.annotate_add("io_retries", 1)
                delay = min(
                    rec.io_retry_backoff_s * (2 ** attempt) * (0.5 + random.random()),
                    rec.io_retry_max_backoff_s)
                degradation("io_retry", "Transient IO error reading %s (%s); retry "
                            "%d/%d in %.2fs", what, e, attempt + 1, rec.io_retries, delay)
                time.sleep(delay)
                attempt += 1

    def _evict_parquet_file(self, path):
        """Drop (and close) this thread's open handle of ``path`` and its shared footer
        entry: a transient failure may leave the handle on a dead connection, and a
        file replaced underneath must be planned again from its new footer."""
        cache = getattr(self._local, "files", None) if self._local is not None else None
        if cache is not None:
            pf = cache.pop(path, None)
            if pf is not None:
                _close_quietly(pf)
        stats = getattr(self._local, "stats", None) if self._local is not None else None
        if stats is not None:
            stats.pop(path, None)
        footers = self._footer_cache()
        if footers is not None:
            footers.invalidate(path)

    # -- generation checks (dataset watching) -------------------------------------------

    def _verify_generation(self, piece):
        """Check the piece's stamped generation token against the file as it is now,
        and return the file's stat identity.

        A removed file raises :class:`~petastorm_tpu_torch.errors.PieceRemovedError`;
        a stat or footer-crc mismatch drops the piece's footer, handle and cache entries
        and raises :class:`~petastorm_tpu_torch.errors.PieceRewrittenError`. Both are
        permanent (never retried as transient) and quarantine under the recovery policy
        with causes of their own. So a read delivers only rows of the generation stamped
        into its plan item, and no epoch mixes two generations of a file.

        On a match this thread's open handle of the file is pinned to the stat identity
        seen here: a handle opened under another one (the old generation's, whose
        replaced inode it still reads) is closed, and the next open parses the footer
        under this identity."""
        from petastorm_tpu_torch.dataset.watch import current_stat_token, stat_token_of

        stat = current_stat_token(self._fs, piece.path)  # raises PieceRemovedError
        stamped_crc = piece.generation.rsplit(".", 1)[1]
        mismatch = stat_token_of(piece.generation) != stat
        if not mismatch and stamped_crc != "-":
            # the stat identity held; a rewrite colliding on size and mtime can hide
            # behind it, and the footer crc (pinned to this stat identity, so a stale
            # parse cannot vouch for the new bytes) settles it
            from petastorm_tpu_torch.io.footercache import shared_footer_cache

            entry = shared_footer_cache().get(self._fs, piece.path, stat_token=stat)
            mismatch = ("%08x" % entry.crc) != stamped_crc
        if mismatch:
            # not counted here: a pool child's registry never reaches the parent's
            # export, so the parent counts ptpu_dataset_generation_conflicts_total when
            # it absorbs the piece_rewritten quarantine marker (Reader._absorb_quarantine)
            self.invalidate_pieces([piece])
            raise PieceRewrittenError(
                "%s row group %d was rewritten under the running reader (stamped "
                "generation %s no longer matches the file); its cache entries are "
                "invalidated and the watcher plans the new generation into a later epoch"
                % (piece.path, piece.row_group, piece.generation))
        stats = getattr(self._local, "stats", None)
        if stats is None:
            stats = self._local.stats = {}
        if stats.get(piece.path) != stat:
            stats[piece.path] = stat
            files = getattr(self._local, "files", None)
            pf = files.get(piece.path) if files is not None else None
            if pf is not None and getattr(pf, "_ptpu_stat", None) != stat:
                del files[piece.path]
                _close_quietly(pf)
        return stat

    def invalidate_pieces(self, pieces):
        """Drop every cache layer's entries for ``pieces`` under their stamped
        generation: this thread's open handle and the shared footer entry, the
        pass-through's refusals of the file (a rewritten file may compress otherwise,
        so its columns are judged again), and the memory and disk tiers' decoded
        payloads by exact key. Called by the read path on a generation conflict and by
        the dataset watcher when it sees a removal or a rewrite."""
        invalidate = getattr(self._cache, "invalidate", None)
        for piece in pieces:
            self._evict_parquet_file(piece.path)
            refused = getattr(self, "_pagedec_refused", None)
            if refused:
                self._pagedec_refused = {t for t in refused if t[0] != piece.path}
            if invalidate is not None:
                for partition in range(self._drop_partitions):
                    invalidate(_cache_key(piece, self._read_schema, self._predicate,
                                          self._filters, partition, self._drop_partitions,
                                          self._seed, self._device_fields))

    def _read_columns_once(self, piece, columns):
        with _prov.span("reader.read"):
            if _chaos.ACTIVE is not None:
                _chaos.ACTIVE.hit("reader.read",
                                  key="%s:%s" % (piece.path, piece.row_group))
            if getattr(piece, "generation", None) is not None:
                self._verify_generation(piece)
            engine = self._remote_engine(create=True)
            if engine is not None:
                # the engine drops the columns the file lacks against the footer it holds
                table, _ = engine.read_row_groups(piece.path, [piece.row_group], columns)
                return self._attach_partitions(table, piece, columns)
            pf = self._parquet_file(piece.path)
            available = set(pf.schema_arrow.names)
            table = pf.read_row_group(piece.row_group,
                                      columns=[c for c in columns if c in available])
            return self._attach_partitions(table, piece, columns)

    def _read_run(self, pieces, columns):
        """Coalesced ranged read: row groups of ONE file in a single ``read_row_groups``
        call, sliced back into one table a piece (zero-copy; the readahead pool's
        ``read_run_fn``, equal to the single reads), with the single read's retry."""
        return self._retry_io(
            lambda: self._read_run_once(pieces, columns), pieces[0].path,
            "%s row groups %s" % (pieces[0].path, [p.row_group for p in pieces]))

    def _read_run_once(self, pieces, columns):
        from petastorm_tpu_torch.io.coalesce import split_run_table

        with _prov.span("reader.read_run"):
            if _chaos.ACTIVE is not None:
                _chaos.ACTIVE.hit("reader.read_run", key="%s:%s" % (
                    pieces[0].path, ",".join(str(p.row_group) for p in pieces)))
            if getattr(pieces[0], "generation", None) is not None:
                # a run is one generation of one file (io.coalesce.plan_runs)
                self._verify_generation(pieces[0])
            row_groups = [p.row_group for p in pieces]
            engine = self._remote_engine(create=True)
            if engine is not None:
                table, entry = engine.read_row_groups(pieces[0].path, row_groups,
                                                      columns)
                sizes = [entry.row_group_rows[rg] for rg in row_groups]
                return [self._attach_partitions(t, piece, columns)
                        for t, piece in zip(split_run_table(table, sizes), pieces)]
            pf = self._parquet_file(pieces[0].path)
            available = set(pf.schema_arrow.names)
            table = pf.read_row_groups(row_groups,
                                       columns=[c for c in columns if c in available])
            sizes = [pf.metadata.row_group(rg).num_rows for rg in row_groups]
            return [self._attach_partitions(t, piece, columns)
                    for t, piece in zip(split_run_table(table, sizes), pieces)]

    def _attach_partitions(self, table, piece, columns):
        if self._partition_info:
            from petastorm_tpu_torch.partitions import attach_partition_columns

            table = attach_partition_columns(table, piece, self._partition_info,
                                             wanted=set(columns))
        return table

    def _mask_fields(self):
        """Sorted predicate + filter columns (empty: no row mask)."""
        fields = set(self._predicate.get_fields()) if self._predicate else set()
        if self._filters:
            fields |= _dnf_fields(self._filters)
        return sorted(fields)

    def _row_mask(self, table):
        """Boolean keep-mask from filters + predicate over a row-group table (or None)."""
        mask = None
        if self._filters:
            mask = _dnf_mask(table, self._filters)
        if self._predicate is not None:
            cols = {
                name: _column_to_numpy(table, name, self._stored_schema)
                for name in self._predicate.get_fields()
            }
            pmask = np.asarray(self._predicate.do_include_vectorized(cols), dtype=bool)
            mask = pmask if mask is None else (mask & pmask)
        return mask

    def _drop_partition_indices(self, item, num_rows):
        """The sorted rows of ``item``'s partition of its row group: a deterministic 1/k
        subset for ``shuffle_row_drop_partitions``, seeded with crc32 of the path (not
        ``hash()``, which differs between interpreters) with the JAX package's PCG64
        draw, so each partition holds the same rows as the reference's."""
        import zlib

        piece, partition = item
        seq = np.random.SeedSequence(
            [0 if self._seed is None else int(self._seed),
             zlib.crc32(piece.path.encode("utf-8")) & 0x7FFFFFFF,
             piece.row_group]
        )
        perm = np.random.Generator(np.random.PCG64(seq)).permutation(num_rows)
        return np.sort(np.array_split(perm, self._drop_partitions)[partition])

    def _selected_rows(self, item, table, mask):
        """Row indices of ``table`` that survive ``mask`` and ``item``'s row-drop
        partition."""
        indices = np.arange(table.num_rows)
        if mask is not None:
            indices = indices[mask]
        if self._drop_partitions > 1:
            indices = np.intersect1d(indices, self._drop_partition_indices(
                item, table.num_rows))
        return indices


class PyDictWorker(_WorkerBase):
    """Per-row decode path (reference ``PyDictReaderWorker``): row group → decoded row dicts.

    With a row mask the predicate and filter columns are read first; the other columns
    are fetched only when some rows match, and only matching rows are decoded. NGram
    windows are formed here, after the host transform, against the post-transform schema
    (``ngram_schema``), and travel as plain ``{offset: {field: value}}`` dicts (the pickle
    wire carries no namedtuple class); the Reader rebuilds the namedtuples."""

    def __init__(self, *args, ngram=None, ngram_schema=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._ngram = ngram
        self._ngram_schema = ngram_schema

    def __call__(self, item):
        rows = self._cache_get(self._cache_key(item), lambda: self._load_rows(item))
        spec = self._transform_spec
        if spec is not None and not spec.device:
            with _prov.span("transform"):
                if _host_pipeline(spec):
                    # one columnar application over the whole row group
                    rows = spec.apply_rows(rows)
                elif _spec_wants_writable(spec):
                    rows = [spec.func(dict(r)) for r in rows]
        if self._ngram is not None:
            return [{offset: nt._asdict() for offset, nt in w.items()}
                    for w in self._ngram.form_ngram(rows, self._ngram_schema)]
        return rows

    def _first_read_columns(self):
        # exactly the head read of _load_rows: the mask columns when a mask runs first,
        # else every wanted column (a prefetched table is keyed by this list)
        return self._mask_fields() or list(self._read_schema.fields.keys())

    def _load_rows(self, item):
        piece, _partition = item
        wanted = list(self._read_schema.fields.keys())
        first_pass = self._mask_fields()
        mask = None
        if first_pass:
            head = self._read_columns(piece, first_pass)
            mask = self._row_mask(head)
            if mask is not None and not mask.any():
                return []
            # the tail read goes straight to the blocking read: it is never prefetched,
            # and asking the pool would count a miss
            remaining = sorted(set(wanted) - set(head.column_names))
            table = _merge_tables(head, self._read_columns_sync(piece, remaining)) \
                if remaining else head
        else:
            table = self._read_columns(piece, wanted)
        indices = self._selected_rows(item, table, mask)
        if len(indices) == 0:
            return []
        if len(indices) < table.num_rows:
            table = table.take(indices)
        stored_rows = table.to_pylist()
        decode_view = self._stored_schema.create_schema_view(
            [c for c in table.column_names if c in self._stored_schema.fields])
        try:
            staged = {}
            for name in self._device_fields:
                # whole-row-group batched stage 1 (one native call), as the batch path
                field = decode_view.fields.get(name)
                if field is None:
                    continue
                try:
                    staged[name] = field.codec.host_stage_decode_batch(
                        field, [r.get(name) for r in stored_rows])
                except DecodeFieldError:
                    raise
                except Exception as e:  # noqa: BLE001 — decode_row contract
                    raise DecodeFieldError(
                        "Unable to decode field %r: %s" % (name, e)) from e
            rows = []
            for i, r in enumerate(stored_rows):
                prestaged = {name: col[i] for name, col in staged.items()}
                rows.append(decode_row(r, decode_view, self._device_fields, prestaged))
        except DecodeFieldError as e:
            raise _annotate_decode_error(e, piece) from e
        return rows


class ArrowWorker(_WorkerBase):
    """Vectorized batch path (reference ``ArrowReaderWorker``): row group → columnar numpy
    dict, the shape the loader batches. The row mask is applied to the Arrow table
    before any column is converted, so rows a predicate or filter drops cost no decode
    (a ``decode_on_device`` JPEG column's stage 1 included).

    With the compressed-page pass-through live (:meth:`_pagedec_active`), eligible
    fixed-width columns skip pyarrow's host inflate: their raw compressed pages ride the
    delivery path as opaque :class:`~petastorm_tpu_torch.io.pagedec.PassthroughColumn`
    values and inflate on the card in the loader
    (:mod:`petastorm_tpu_torch.ops.pagedec_kernels`). Ineligible columns degrade PER
    COLUMN to the classic read, so any store reads unchanged.

    With an ``ngram`` each row group is windowed here, after the host transform
    (:func:`~petastorm_tpu_torch.ngram.form_ngram_columns`), into flat ``offset/field``
    columns, one row a window."""

    _pagedec_supported = True

    def __init__(self, filesystem, read_schema, stored_schema, device_fields=frozenset(),
                 io_options=None, transform_spec=None, ngram=None, **selection):
        super().__init__(filesystem, read_schema, stored_schema, device_fields,
                         transform_spec, io_options=io_options, **selection)
        self._ngram = ngram
        #: set by the Reader when a DataLoader on a CUDA device adopts it: what ``auto``
        #: engages on
        self.pagedec_on_device = False
        #: (path, column) pairs whose pages declined the pass-through: read classically
        self._pagedec_refused = set()

    def __call__(self, item):
        out = self._cache_get(self._cache_key(item), lambda: self._load_columns(item))
        spec = self._transform_spec
        if spec is not None and not spec.device:
            with _prov.span("transform"):
                if _host_pipeline(spec):
                    # fused vectorized kernels over the columnar batch, no pandas round
                    # trip; untouched columns stay the read's arrays
                    out = spec.apply_columns(out)
                elif _spec_wants_writable(spec):
                    out = _pandas_transform(spec, out)
        if self._ngram is not None:
            out = form_ngram_columns(out, self._ngram)
        return out

    def _first_read_columns(self):
        # the batch path reads once: the wanted columns and the mask's, sorted
        return sorted(set(self._read_schema.fields) | set(self._mask_fields()))

    def _load_columns(self, item):
        piece, _partition = item
        wanted = list(self._read_schema.fields.keys())
        out = {}
        stat = None
        if getattr(piece, "generation", None) is not None and self._pagedec_active() \
                and self._pagedec_shape_ok():
            # the pass-through reads raw spans at its footer's offsets: check the
            # generation first, so that the footer and this thread's handle it reads
            # through are the stamped generation's
            stat = self._verify_generation(piece)
        eligible = self._pagedec_eligible(piece, wanted, stat_token=stat)
        if eligible:
            out.update(self._pagedec_read(piece, eligible, stat_token=stat))
        # one read: the wanted columns and the mask's, less the pass-through's
        read_columns = [c for c in self._first_read_columns() if c not in out]
        if not read_columns:
            if getattr(piece, "generation", None) is not None:
                # every wanted column passed through: no host read checked the
                # generation after the raw spans were read, so check it here
                self._verify_generation(piece)
            return out
        table = self._read_columns(piece, read_columns)
        indices = self._selected_rows(item, table, self._row_mask(table))
        if len(indices) < table.num_rows:
            table = table.take(indices)
        for name in wanted:
            if name in out or name not in table.column_names:
                continue
            try:
                out[name] = _column_to_numpy(table, name, self._read_schema,
                                             self._device_fields)
            except DecodeFieldError as e:
                raise _annotate_decode_error(e, piece) from e
            except Exception as e:  # noqa: BLE001 — decode_row contract below
                field = self._read_schema.fields.get(name)
                if field is None or field.codec is None:
                    raise  # plain-column conversion bug, not a decode failure
                raise _annotate_decode_error(
                    DecodeFieldError("Unable to decode field %r: %s" % (name, e)),
                    piece) from e
        return out

    # -- compressed-page pass-through ---------------------------------------------------

    def _pagedec_active(self):
        """Is the pass-through live for this worker's reads? ``auto`` engages only for a
        reader a DataLoader on a CUDA device adopted (there is no host to device link to
        save otherwise); ``on`` forces it."""
        mode = self.live_pagedec()
        if mode == "off":
            return False
        return mode == "on" or self.pagedec_on_device

    def _pagedec_shape_ok(self):
        """Row-selecting options (a predicate, filters, row-drop partitions) and
        in-worker rewrites (any ``transform_spec``, a device one too, and NGram windows)
        need decoded rows: each turns the pass-through off for the whole read, as in the
        JAX package. ``rowgroup_selector`` and hive pruning act at plan time and leave it
        on."""
        return (self._predicate is None and not self._filters
                and self._drop_partitions <= 1 and self._transform_spec is None
                and self._ngram is None)

    def _pagedec_footer(self, path, peek_only=False, stat_token=None):
        """The parsed footer for eligibility classification, from the shared footer
        cache, or ``None`` (the classic read then surfaces any error). ``peek_only`` (a
        prefetch) never opens the file: eligibility is then unknown until a real read
        has cached the footer. ``stat_token`` (a watched read: the stat identity its
        generation check saw) pins the footer to that identity."""
        footers = self._footer_cache()
        if footers is not None and stat_token is not None \
                and self._remote_engine(create=True) is None:
            try:
                return footers.get(self._fs, path, stat_token=stat_token).metadata
            except Exception:  # noqa: BLE001 — the classic read will surface it
                return None
        if footers is not None:
            entry = footers.peek(path)
            if entry is not None:
                return entry.metadata
        if peek_only:
            return None
        try:
            engine = self._remote_engine(create=True)
            if engine is not None:
                return engine.footer(path).metadata
            return self._parquet_file(path).metadata
        except Exception:  # noqa: BLE001 — the classic read will surface it
            return None

    def _pagedec_eligible(self, piece, wanted, peek_only=False, stat_token=None):
        """Footer-only eligibility: ``{column: (col_index, Eligibility)}`` for the
        eligible subset of ``wanted``. Cheap (no chunk bytes); the walker's page-level
        gate runs after the raw spans arrive."""
        if not self._pagedec_active() or not self._pagedec_shape_ok():
            return {}
        md = self._pagedec_footer(piece.path, peek_only=peek_only, stat_token=stat_token)
        if md is None or piece.row_group >= md.num_row_groups:
            return {}
        from petastorm_tpu_torch.io.pagedec import classify_chunk

        names = set(wanted)
        out = {}
        rgmd = md.row_group(piece.row_group)
        for i in range(rgmd.num_columns):
            name = rgmd.column(i).path_in_schema.split(".")[0]
            if name not in names or name in out \
                    or (piece.path, name) in self._pagedec_refused:
                continue
            el = classify_chunk(md, piece.row_group, i)
            if el.eligible:
                out[name] = (i, el)
        return out

    def _pagedec_read(self, piece, eligible, stat_token=None):
        """Fetch + walk the eligible columns' raw chunk spans into PassthroughColumn
        values. Page-level ineligibility degrades per column; corruption raises
        :class:`~petastorm_tpu_torch.errors.PagedecCorruptError`. Each walk records the
        chunk's page starts in :func:`~petastorm_tpu_torch.io.pagedec.shared_page_index`:
        the object-store planner splits the chunk's next fetch at them."""
        from petastorm_tpu_torch.io.pagedec import (PassthroughColumn, build_chunk,
                                                    chunk_byte_range, pagedec_counters,
                                                    shared_page_index)

        with _prov.span("io.pagedec"):
            if _chaos.ACTIVE is not None:
                _chaos.ACTIVE.hit("io.pagedec",
                                  key="%s:%s" % (piece.path, piece.row_group))
            md = self._pagedec_footer(piece.path, stat_token=stat_token)
            if md is None:
                return {}
            out = {}
            counters = pagedec_counters()
            rgmd = md.row_group(piece.row_group)
            raws = self._pagedec_fetch_raw(piece, eligible, rgmd)
            for name, (col_idx, el) in eligible.items():
                chunk, reason = build_chunk(raws[name], el,
                                            expected_values=rgmd.num_rows)
                if chunk is None:
                    counters["fallback_columns"].inc()
                    # mute the column for this file: re-fetching its raw span on every
                    # read just to decline again is pure overhead
                    self._pagedec_refused.add((piece.path, name))
                    degradation("pagedec_ineligible",
                                "column %r of %s degraded to the classic host-inflate "
                                "path (%s); further per-column fallbacks are counted in "
                                "ptpu_pagedec_fallback_columns_total", name, piece.path,
                                reason)
                    continue
                start, _length = chunk_byte_range(rgmd.column(col_idx))
                shared_page_index().put(
                    piece.path, piece.row_group, name, start,
                    [start + p.header_offset for p in
                     ((chunk.dict_page,) if chunk.dict_page else ()) + chunk.pages])
                out[name] = PassthroughColumn.from_chunk(chunk)
            return out

    def _pagedec_fetch_raw(self, piece, eligible, rgmd):
        """Raw chunk byte spans for the eligible columns (``rgmd``: the row group's
        footer entry): ONE batched ranged-GET plan through the object-store engine
        (page-granular splits on re-reads), else positional reads on this thread's open
        handle of the file, which never disturb the ``ParquetFile``'s own reads."""
        from petastorm_tpu_torch.io.pagedec import chunk_byte_range

        engine = self._remote_engine(create=True)
        if engine is not None:
            return engine.read_raw_column_chunks(piece.path, piece.row_group,
                                                 list(eligible))
        source = self._parquet_file(piece.path)._ptpu_source
        out = {}
        for name, (col_idx, _el) in eligible.items():
            start, length = chunk_byte_range(rgmd.column(col_idx))
            out[name] = bytes(source.read_at(length, start))
        return out


def _annotate_decode_error(err, piece):
    """Attach the failing row group's identity to a decode error."""
    return DecodeFieldError(
        "%s (while decoding %s row group %d)" % (err, piece.path, piece.row_group))


def _stable_repr(value):
    """Deterministic repr for cache keys (sets and dicts sorted)."""
    if isinstance(value, (set, frozenset)):
        return "{%s}" % ",".join(sorted(repr(v) for v in value))
    if isinstance(value, dict):
        return "{%s}" % ",".join(
            "%r:%s" % (k, _stable_repr(v)) for k, v in sorted(value.items()))
    if isinstance(value, (list, tuple)):
        return "[%s]" % ",".join(_stable_repr(v) for v in value)
    return repr(value)


_RUN_SALT = None

_ADDR_RE = re.compile(r" at 0x[0-9a-fA-F]+")


def _predicate_key(predicate):
    """Stable identity of a predicate: its class and parameters (the JAX package's
    key). A callable parameter is keyed by its bytecode, constants, defaults and
    closure values, so two lambdas with the same code but other captured thresholds do
    not collide in a persistent cache; one whose captures have no stable repr (an
    address) is salted per run, so a disk cache of another run can never serve it."""
    import hashlib

    global _RUN_SALT
    parts = [type(predicate).__name__]
    for name, value in sorted(vars(predicate).items()):
        if callable(value):
            code = getattr(value, "__code__", None)
            payload = None
            if code is not None:
                payload = [code.co_code, repr(code.co_consts).encode("utf-8")]
                defaults = getattr(value, "__defaults__", None)
                if defaults:
                    payload.append(_stable_repr(defaults).encode("utf-8"))
                kwdefaults = getattr(value, "__kwdefaults__", None)
                if kwdefaults:
                    payload.append(_stable_repr(kwdefaults).encode("utf-8"))
                closure = getattr(value, "__closure__", None)
                if closure:
                    try:
                        cells = tuple(c.cell_contents for c in closure)
                        payload.append(_stable_repr(cells).encode("utf-8"))
                    except ValueError:  # an empty cell: unkeyable
                        payload = None
            if payload is not None and any(_ADDR_RE.search(p.decode("utf-8", "ignore"))
                                           for p in payload[1:]):
                payload = None  # a capture whose repr holds an address
            if payload is not None:
                digest = hashlib.sha256(b"\x00".join(payload)).hexdigest()
                parts.append("%s=fn:%s" % (name, digest))
            else:
                if _RUN_SALT is None:
                    import os as _os

                    _RUN_SALT = _os.urandom(8).hex()
                parts.append("%s=unkeyable:%s:%d" % (name, _RUN_SALT, id(value)))
        else:
            parts.append("%s=%s" % (name, _stable_repr(value)))
    return "|".join(parts)


def _cache_key(piece, schema, predicate, filters, partition, num_partitions, seed,
               device_fields=frozenset()):
    """The cache key of one work item's payload (the JAX package's key, string for
    string): path, row group, schema fields, predicate, filters, the row-drop partition
    (and the seed that draws it), and the device-staged fields when any."""
    predicate_key = ""
    if predicate is not None:
        predicate_key = _predicate_key(predicate)
    parts = [
        piece.path,
        str(piece.row_group),
        ",".join(schema.fields.keys()),
        predicate_key,
        repr(filters) if filters else "",
        "%s/%s" % (partition, num_partitions),
        str(seed) if num_partitions > 1 else "",
    ]
    if device_fields:
        # staged payloads differ from host-decoded ones: never cross-serve
        parts.append("dev:%s" % ",".join(sorted(device_fields)))
    generation = getattr(piece, "generation", None)
    if generation is not None:
        parts.append("gen:%s" % generation)
    return "|".join(parts)


def _merge_tables(head, tail):
    """Column-wise merge of two same-length row-group reads into one table."""
    import pyarrow as pa

    cols = {name: head.column(name) for name in head.column_names}
    cols.update({name: tail.column(name) for name in tail.column_names})
    return pa.table(cols)


def _column_to_numpy(table, name, schema, device_fields=()):
    """Arrow column → numpy array; decodes codec columns, stacks list columns.

    Codec columns named in ``device_fields`` run only the host half of the two-stage
    decode and come back as an object array of staging payloads the loader finishes
    on its device."""
    import pyarrow as pa

    from petastorm_tpu_torch.codecs import ScalarCodec

    col = table.column(name)
    field = schema.fields.get(name)
    if field is not None and field.codec is not None:
        scalar = _scalar_codec_fast_path(col, field)
        if scalar is not None:
            return scalar
        values = None
        if not isinstance(field.codec, ScalarCodec):
            # blob codecs (ndarray/image): zero-copy memoryviews into Arrow buffers
            values = _binary_column_views(col)
        if values is None:
            values = col.to_pylist()
        if name in device_fields:
            # one native call stages the whole row group
            staged = field.codec.host_stage_decode_batch(field, values)
            return stack_as_column(staged, force_object=True)
        np_dtype = np.dtype(field.numpy_dtype)
        shape_known = field.shape and all(d is not None for d in field.shape)
        if shape_known and np_dtype.kind in "biufc" \
                and not any(v is None for v in values):
            # static-shape tensor column: decode straight into one preallocated array
            out = np.empty((len(values),) + tuple(field.shape), dtype=np_dtype)
            for i, v in enumerate(values):
                out[i] = field.codec.decode(field, v)
            return out
        decoded = [field.codec.decode(field, v) if v is not None else None for v in values]
        return _stack(decoded, field)
    if field is not None and field.shape:
        arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
        stacked = _list_column_to_numpy(arr, field)
        if stacked is not None:
            return stacked
        return _stack(arr.to_pylist(), field)
    return col.to_numpy(zero_copy_only=False)


def _scalar_codec_fast_path(col, field):
    """Vectorized ScalarCodec decode for plain numeric/bool scalar columns, or None
    (nulls, strings/decimals/dates, non-scalar codecs)."""
    from petastorm_tpu_torch.codecs import ScalarCodec

    if type(field.codec) is not ScalarCodec or field.shape:
        return None
    np_dtype = np.dtype(field.numpy_dtype)
    if np_dtype.kind not in "biuf":
        return None
    arr = col.combine_chunks() if hasattr(col, "combine_chunks") else col
    if arr.null_count:
        return None
    out = arr.to_numpy(zero_copy_only=False)
    if out.dtype.kind not in "biuf":
        return None
    return out.astype(np_dtype, copy=False)


def _binary_column_views(col):
    """Binary/string column → list of zero-copy memoryview slices into the Arrow data
    buffer (None entries for nulls), or None when the column is not binary-like."""
    import pyarrow as pa

    chunks = col.chunks if isinstance(col, pa.ChunkedArray) else [col]
    out = []
    for chunk in chunks:
        t = chunk.type
        if pa.types.is_binary(t) or pa.types.is_string(t):
            odt = np.int32
        elif pa.types.is_large_binary(t) or pa.types.is_large_string(t):
            odt = np.int64
        else:
            return None
        n = len(chunk)
        if n == 0:
            continue
        bufs = chunk.buffers()
        off = chunk.offset
        offsets = np.frombuffer(bufs[1], dtype=odt, count=off + n + 1)[off:]
        data = memoryview(bufs[2]) if bufs[2] is not None else memoryview(b"")
        if chunk.null_count:
            valid = np.asarray(chunk.is_valid())
            out.extend(data[offsets[i]:offsets[i + 1]] if valid[i] else None
                       for i in range(n))
        else:
            out.extend(data[offsets[i]:offsets[i + 1]] for i in range(n))
    return out


def _list_column_to_numpy(arr, field):
    """Vectorized (fixed-size or uniform) list-of-numeric column → (n, ...) ndarray, or
    None when the fast path does not apply (ragged rows, nulls, non-numeric)."""
    import pyarrow as pa

    shape_known = field.shape and all(d is not None for d in field.shape)
    if arr.null_count:
        return None
    if isinstance(arr.type, pa.FixedSizeListType):
        flat = arr.flatten().to_numpy(zero_copy_only=False)
        if flat.dtype.kind not in "biufc":
            return None
        out = flat.reshape(len(arr), arr.type.list_size)
    elif pa.types.is_list(arr.type) or pa.types.is_large_list(arr.type):
        lengths = np.diff(arr.offsets.to_numpy(zero_copy_only=False))
        if len(lengths) == 0 or not (lengths == lengths[0]).all():
            return None  # ragged: caller falls back to object rows
        flat = arr.flatten().to_numpy(zero_copy_only=False)
        if flat.dtype.kind not in "biufc":
            return None
        out = flat.reshape(len(arr), int(lengths[0]))
    else:
        return None
    if shape_known and int(np.prod(field.shape)) == out.shape[1]:
        out = out.reshape((len(out),) + tuple(field.shape))
    np_dtype = np.dtype(field.numpy_dtype)
    if np_dtype.kind in "biufc" and out.dtype != np_dtype:
        out = out.astype(np_dtype)
    return out


def _stack(values, field):
    """Stack per-row values into one array; ragged/object data degrades to an object array."""
    np_dtype = np.dtype(field.numpy_dtype)
    target = None if np_dtype.kind in "OUSM" else np_dtype
    try:
        return np.asarray(values, dtype=target)
    except (ValueError, TypeError):
        arr = np.empty(len(values), dtype=object)
        arr[:] = values
        return arr


class Reader:
    """Iterates decoded rows (per-row path) or columnar batches (batch path).

    Reference: ``Reader`` petastorm/reader.py ~L330. Context-manager protocol,
    ``reset()``, ``stop()``/``join()``, ``last_row_consumed``; checkpointable through
    ``state_dict()``/``load_state_dict()`` (the consumed-work map; equal to the JAX
    package's after the same deliveries, and loadable by it).

    With an NGram (``reader.ngram``) the per-row reader delivers windows, ``{offset:
    namedtuple}`` (one schema view a timestep, made once), and the batch reader plain
    dicts of flat ``offset/field`` columns (such names cannot be namedtuple fields).

    On a process pool's shared-memory view wire (``wire_serializer='shm-view'`` or
    ``'shm-arrow-view'``) a batch's arrays are read-only views into a pool slab, valid
    until the next ``__next__()`` or :meth:`release_batch`; a consumer that keeps them
    longer takes the batch's lease (:meth:`take_lease`) and releases it when done.

    Under ``recovery=RecoveryOptions(on_poison="quarantine")`` a poison row group is
    skipped: it is listed in :attr:`quarantine_report`, counted
    (``ptpu_quarantined_{items,rows}_total``) and charged to the consumed-work map like
    a delivery, so :meth:`state_dict` resumes without it and without losing anything.

    ``tenant`` (a slug or a :class:`~petastorm_tpu_torch.obs.tenant.TenantContext`; the
    ``PTPU_TENANT`` environment otherwise) bills the reader's work: delivered and
    quarantined rows here, worker seconds and IO in the pool (:mod:`~petastorm_tpu_torch
    .obs.tenant`). The live knobs (:meth:`resize_workers`, :meth:`apply_readahead_depth`
    and the other ``apply_*``) retune a running reader; ``reset()`` rebuilds the pool at
    the configured size.
    """

    def __init__(self, schema, worker, pieces, num_epochs=1, shuffle_row_groups=True,
                 seed=None, cur_shard=None, shard_count=None, shard_seed=None,
                 shuffle_row_drop_partitions=1,
                 reader_pool_type="thread", workers_count=4, results_queue_size=16,
                 is_batched_reader=False, results_timeout_s=300.0,
                 wire_serializer="pickle", worker_respawns=None, io_options=None,
                 transport=None, ngram=None, recovery=None, filesystem=None,
                 provenance=None, tenant=None, path=None, watch=None, watch_paths=None):
        #: the resolved TenantContext, or None (untagged): an explicit argument, else the
        #: PTPU_TENANT environment; an invalid explicit slug raises
        self.tenant_context = _tenant.resolve(tenant)
        self.schema = schema
        self._worker = worker
        self.is_batched_reader = is_batched_reader
        self.ngram = ngram
        self._ngram_views = {}  # offset -> the schema view its namedtuples come from
        self._row_type = schema.make_namedtuple_type()
        self.cur_shard = cur_shard
        self.shard_count = shard_count
        shard_idx = shard_indices(len(pieces), cur_shard, shard_count, shard_seed) \
            if shard_count else np.arange(len(pieces))
        self._drop_partitions = max(1, shuffle_row_drop_partitions)
        items = self._to_items([pieces[int(i)] for i in shard_idx])
        if not items:
            raise NoDataAvailableError(
                "No row groups to read (empty dataset, over-filtering selector/predicate, "
                "or an empty shard)")
        self._plan = EpochPlan(items, num_epochs=num_epochs, shuffle=shuffle_row_groups,
                               seed=seed if seed is not None else shard_seed,
                               with_epoch=True)
        self._num_items = len(items)
        self._io_options = IoOptions.normalize(io_options)
        self._pool_args = dict(
            reader_pool_type=reader_pool_type, workers_count=workers_count,
            results_queue_size=results_queue_size, results_timeout_s=results_timeout_s,
            serializer=wire_serializer, worker_respawns=worker_respawns,
            io_options=io_options, recovery=recovery, transport=transport)
        self._executor = None
        #: every plan item this reader quarantined (falsy while empty)
        self.quarantine_report = QuarantineReport()
        #: quarantined row groups whose footer could not be read (rows unknown, -1)
        self._footer_unreadable = 0
        self._fs = filesystem
        #: a TraceRecorder the pool and the readahead pool record into (set_trace)
        self._tracer = None
        #: the health monitor or scope of the pool and the readahead pool (set_health)
        self._health_monitor = None
        #: lease of the current batch or row buffer on a view wire: held until the next
        #: fetch, release_batch() or take_lease()
        self._held_lease = None
        #: every lease this reader delivered that a consumer may still hold: revoked when
        #: reset() rebuilds the pool whose slabs they view
        self._issued_leases = weakref.WeakSet()
        self._results_iter = None
        self._buffer = []
        self._buffer_pos = 0
        self._buffer_tag = None  # (epoch, ordinal) of the row group feeding _buffer
        self._consumed = {}  # epoch -> set(ordinal): fully delivered work items
        #: a list to append ``(epoch, ordinal, rows)`` to as each work item's rows start
        #: to be delivered, else None (an InMemDataLoader's fill sets it)
        self.delivery_log = None
        self._resume_epoch = 0  # every epoch below this one is fully consumed
        self.last_row_consumed = False
        self.stopped = False
        #: device-decodable fields staged by the workers (set by the factories)
        self.device_decode_fields = frozenset()
        #: the compiled transform_spec (set by the factories); a device one is the
        #: DataLoader's default device transform
        self.transform_spec = None
        #: compressed-page pass-through adoption: False (the default) materializes
        #: PassthroughColumn values into decoded arrays at delivery, so loader-less
        #: consumers see ordinary batches; a DataLoader that finishes the inflate itself
        #: sets it (:meth:`adopt_passthrough`)
        self.keep_passthrough = False
        #: the ProvenanceRecorder this reader notes deliveries and quarantines on and
        #: its pool merges wire spans into (None: off). Set before _start(): the pool
        #: claims items the moment it starts, and a recorder attached later misses the
        #: items a small plan has already drained
        self._prov = provenance
        #: the dataset watch (``watch=``): a thread that diffs the piece set every
        #: interval and feeds _apply_plan_delta; None for a frozen dataset (the default)
        self._watcher = None
        if watch is not None:
            from petastorm_tpu_torch.dataset.watch import DatasetWatcher

            self._watcher = DatasetWatcher(filesystem, path, watch,
                                           on_delta=self._apply_plan_delta)
            # every file that existed at plan time, those plan-time selection pruned
            # included: the first tick must not re-add what the selection excluded
            self._watcher.prime(pieces, known_paths=watch_paths)
        self._start()

    def _start(self):
        self._worker.reopen()  # a reset rebuilds the readahead pool lazily
        self._executor = make_executor(**self._pool_args)
        if self._tracer is not None:
            self._executor_set_trace(self._tracer)
        if self._health_monitor is not None:
            # before start(): a rebuilt process pool hands its children the monitor-era
            # handshake and registers its healer on the monitor
            self._executor.set_health(self._health_monitor)
        if self._prov is not None:
            # survives reset()'s pool rebuild; join() released a recorder the factory
            # built, and arming again raises if another recorder took the slot meanwhile
            self._prov.arm()
            self._executor_set_provenance(self._prov)
        self._executor.start(_Tagged(self._worker, tenant=self.tenant_context),
                             self._plan)
        self._results_iter = self._executor.results()
        self.stopped = False
        if self._watcher is not None:
            # started last: a failed pool start must not leak a watch thread, and
            # reset() and a restore restart the watch with the stream
            self._watcher.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self.is_batched_reader:
            return self._next_batch()
        return self._next_row()

    def _mark_consumed(self, tag):
        epoch, ordinal = tag
        self._consumed.setdefault(epoch, set()).add(ordinal)
        # advance the watermark: epochs below _resume_epoch are fully consumed, so the
        # state stays bounded over any number of epochs
        while len(self._consumed.get(self._resume_epoch, ())) \
                >= self._plan.items_in_epoch(self._resume_epoch):
            del self._consumed[self._resume_epoch]
            self._resume_epoch += 1

    # -- the dataset watch --------------------------------------------------------------

    @property
    def dataset_watcher(self):
        """The live :class:`~petastorm_tpu_torch.dataset.watch.DatasetWatcher`, or
        ``None`` for a reader opened without ``watch=``."""
        return self._watcher

    def _apply_plan_delta(self, delta):
        """The watcher's delta seam (runs on the watch thread). Added files extend the
        current epoch (a new path cannot mix generations); a rewritten file's new
        generation is deferred to the next epoch (the old generation may have delivered
        rows in this one); removed and rewritten pieces have their cache entries
        dropped, and their pending plan items fail the generation check at read time
        and quarantine as ``piece_removed`` / ``piece_rewritten``, charged to the
        watermark like any other skip."""
        stale = [p for _path, pieces in delta.removed for p in pieces]
        stale += [p for _path, old, _new in delta.rewritten for p in old]
        if stale:
            self._worker.invalidate_pieces(stale)
        extended = False
        added = [p for p in delta.added if self._owns_piece(p)]
        if added:
            self._plan.extend(self._to_items(added), defer=False)
            extended = True
        replanned = [p for _path, _old, new in delta.rewritten for p in new
                     if self._owns_piece(p)]
        if replanned:
            self._plan.extend(self._to_items(replanned), defer=True)
            extended = True
        if extended:
            self._num_items = len(self._plan.items)
            from petastorm_tpu_torch.dataset.watch import watch_metrics

            watch_metrics()["plan_extensions"].inc()

    def _owns_piece(self, piece):
        """The shard of a piece the watcher discovered: crc32 of ``path:row_group``
        modulo the shard count, the same on every process, so the shards' extensions
        stay disjoint and their union exact with no communication."""
        if not self.shard_count:
            return True
        import zlib

        key = "%s:%s" % (piece.path, piece.row_group)
        return zlib.crc32(key.encode("utf-8")) % self.shard_count == self.cur_shard

    def _to_items(self, pieces):
        return [(piece, partition) for piece in pieces
                for partition in range(self._drop_partitions)]

    def _items_identity_crc(self, count):
        """crc32 over the identity (``path:row_group:partition``) of the first ``count``
        plan items in ordinal order: what binds a checkpoint's consumed-ordinal map to
        the item order it was taken over (the JAX package's value for the same store)."""
        import zlib

        h = 0
        for piece, partition in self._plan.items[:count]:
            h = zlib.crc32(("%s:%s:%s" % (piece.path, piece.row_group,
                                          partition)).encode("utf-8"), h)
        return h & 0xFFFFFFFF

    def _next_payload(self):
        """The next ``(epoch, ordinal, payload)`` result of the pool; quarantine markers
        are absorbed on the way."""
        while True:
            nxt = next(self._results_iter, None)
            if nxt is None:
                if not self._executor.truncated:
                    self.last_row_consumed = True
                raise StopIteration
            if isinstance(nxt, QuarantinedItem):
                self._absorb_quarantine(nxt)
                continue
            return nxt

    def _absorb_quarantine(self, marker):
        """Absorb a :class:`~petastorm_tpu_torch.recovery.QuarantinedItem`: record it in
        the report, count it, and charge it to the consumed-work map exactly like a
        delivered item, so a checkpoint taken after the skip resumes without replaying
        it and without losing anything else. The consumer never sees the marker."""
        epoch, ordinal, inner = marker.item
        piece = inner[0] if isinstance(inner, tuple) and inner else inner
        path = getattr(piece, "path", repr(inner))
        row_group = getattr(piece, "row_group", -1)
        num_rows = getattr(piece, "num_rows", None)
        if num_rows is None or num_rows < 0:
            # the metadata fast path plans without footers: read the count now
            num_rows = self._resolve_quarantined_rows(path, row_group)
        # a skip because the file vanished or changed generation under the reader gets
        # a kind and a degradation cause of its own: bad data and a dataset that moved
        # must be told apart without reading exception chains
        kind, cause = marker.kind, "quarantined"
        if isinstance(marker.error, PieceRewrittenError):
            kind = cause = "piece_rewritten"
            from petastorm_tpu_torch.dataset.watch import watch_metrics

            # counted here, in the consumer's process, not where the worker found it:
            # a pool child's registry never reaches the parent's export
            watch_metrics()["generation_conflicts"].inc()
        elif isinstance(marker.error, PieceRemovedError):
            kind = cause = "piece_removed"
        self.quarantine_report.add(QuarantineEntry(
            epoch, ordinal, path, row_group, num_rows, marker.error, marker.attempts,
            kind))
        count_quarantined(num_rows)
        if self.tenant_context is not None:
            _tenant.charge("quarantined", max(0, num_rows or 0),
                           label=self.tenant_context.tenant)
        degradation(
            cause, "poison item quarantined after %d attempt(s): %s row group %s "
            "(epoch=%s ordinal=%s, %s); skipped and charged to the checkpoint "
            "watermark, see Reader.quarantine_report", marker.attempts, path, row_group,
            epoch, ordinal, kind, once=False)
        if self._prov is not None:
            # a quarantined item never enters the delivery FIFO: the ledgers stay
            # disjoint
            self._prov.note_quarantined(epoch, ordinal, marker.attempts, kind)
        self._mark_consumed((epoch, ordinal))

    def _resolve_quarantined_rows(self, path, row_group):
        """The quarantined row group's row count from its footer (the shared footer
        cache, usually already parsed), or -1 with a ``footer_unreadable`` degradation
        when the footer cannot be read or lacks the group."""
        try:
            from petastorm_tpu_torch.io.footercache import shared_footer_cache

            return shared_footer_cache().get(self._fs, path).row_group_rows[row_group]
        except Exception as e:  # noqa: BLE001 — an unreadable or mismatched footer
            self._footer_unreadable += 1
            degradation(
                "footer_unreadable", "quarantined %s row group %s has no readable footer "
                "(%s): the skipped row count is unknown (-1 in the quarantine report; "
                "see Reader.io_stats()['footer_unreadable'])", path, row_group, e,
                once=False)
            return -1

    def _next_row(self):
        while True:
            if self._buffer_pos < len(self._buffer):
                row = self._buffer[self._buffer_pos]
                self._buffer_pos += 1
                if self._buffer_pos >= len(self._buffer):
                    # the row group's last row is delivered: it counts as consumed
                    self._mark_consumed(self._buffer_tag)
                    self._buffer_tag = None
                return self._wrap_row(row)
            # past the drained buffer: its slab (view wire) returns to the ring
            self.release_batch()
            epoch, ordinal, payload = self._next_payload()
            self._held_lease = self._register_lease(getattr(payload, "lease", None))
            if not payload:
                self._mark_consumed((epoch, ordinal))  # a fully filtered row group
                continue
            if self._prov is not None:
                self._prov.note_delivery(epoch, ordinal, len(payload))
            if self.delivery_log is not None:
                self.delivery_log.append((epoch, ordinal, len(payload)))
            if self.tenant_context is not None:
                # charged at delivery: the tenant's rows are the rows it received
                _tenant.charge("rows", len(payload), label=self.tenant_context.tenant)
            self._buffer = payload
            self._buffer_pos = 0
            self._buffer_tag = (epoch, ordinal)

    def _wrap_row(self, row):
        if self.ngram is None:
            return self._row_type(**{name: row.get(name) for name in self.schema.fields})
        out = {}
        for offset, values in row.items():
            view = self._ngram_views.get(offset)
            if view is None:
                view = self._ngram_views[offset] = self.schema.create_schema_view(
                    self.ngram.get_field_names_at_timestep(offset))
            out[offset] = view.make_namedtuple(**values)
        return out

    def _next_batch(self):
        # the previous batch's slab (view wire) returns to the ring: a batch's views stay
        # valid until the consumer asks for the next one
        self.release_batch()
        while True:
            epoch, ordinal, columns = self._next_payload()
            if isinstance(columns, dict):
                self._held_lease = self._register_lease(columns.pop(LEASE_KEY, None))
            self._mark_consumed((epoch, ordinal))  # a batch's delivery is atomic
            if not (columns and len(next(iter(columns.values())))):
                self.release_batch()  # an empty row group
                continue
            if self._prov is not None:
                self._prov.note_delivery(epoch, ordinal, len(next(iter(columns.values()))))
            if self.delivery_log is not None:
                self.delivery_log.append((epoch, ordinal, len(next(iter(columns.values())))))
            if self.tenant_context is not None:
                _tenant.charge("rows", len(next(iter(columns.values()))),
                               label=self.tenant_context.tenant)
            if not self.keep_passthrough:
                # no loader adopted the pass-through: the host twin is the designed
                # decode for loader-less readers
                columns = materialize_columns(columns)
            if self.ngram is not None:
                return dict(columns)  # flat 'offset/field' names
            return self._row_type(**{name: columns.get(name)
                                     for name in self.schema.fields})

    def adopt_passthrough(self, on_device):
        """A DataLoader takes over the pass-through: batches keep their
        PassthroughColumn values, and ``pagedec="auto"`` engages when the loader's
        device is a CUDA card (``on_device``), in a process pool's running children
        from their next item on."""
        self.keep_passthrough = True
        self._set_pagedec_on_device(bool(on_device))

    def release_passthrough(self):
        """Undo :meth:`adopt_passthrough`: a reader outliving its loader serves decoded
        batches again, and ``auto`` reads classically."""
        self.keep_passthrough = False
        self._set_pagedec_on_device(False)

    def _set_pagedec_on_device(self, on_device):
        if not hasattr(self._worker, "pagedec_on_device"):
            return
        self._worker.pagedec_on_device = on_device  # and every child spawned from now
        update = getattr(self._executor, "update_settings", None)
        if update is not None:
            update(pagedec_on_device=on_device)

    # -- the lease-backed wire ----------------------------------------------------------

    def _register_lease(self, lease):
        if lease is not None:
            self._issued_leases.add(lease)
        return lease

    def take_lease(self):
        """Take ownership of the current batch's lease (view wires): the reader no longer
        releases it at the next fetch, the caller must ``release()`` it when it is done
        with the batch's buffers. ``None`` when the batch is not lease-backed."""
        lease, self._held_lease = self._held_lease, None
        return lease

    def release_batch(self):
        """Return the current batch's slab to the pool's ring (view wires; a no-op
        otherwise). The batch's arrays must not be touched afterwards."""
        lease, self._held_lease = self._held_lease, None
        if lease is not None:
            lease.release()

    def wire_stats(self):
        """The process pool's wire gauges (``ProcessExecutor.wire_stats``); ``{}`` for
        thread and dummy pools."""
        fn = getattr(self._executor, "wire_stats", None)
        return fn() if fn is not None else {}

    def io_stats(self):
        """The read path's counts: this process's worker (the readahead pool's hits,
        misses, exposed wait seconds and coalesced reads, the cache funnel's tiers and
        memcache, the footer cache) and the dispatcher's steals. On a process pool the
        children read: their counts come under ``"children"`` (``{feeder index:
        io_stats()}`` as of each child's latest result)."""
        out = dict(self._worker.io_stats())
        fn = getattr(self._executor, "dispatch_stats", None)
        if fn is not None:
            out.update(fn())
        fn = getattr(self._executor, "child_io_stats", None)
        if fn is not None:
            out["children"] = fn()
        if self._footer_unreadable:
            out["footer_unreadable"] = self._footer_unreadable
        if self._watcher is not None:
            out.update(self._watcher.stats())
        return out

    def set_trace(self, tracer):
        """Attach a :class:`~petastorm_tpu_torch.trace.TraceRecorder` to the pool (a
        process pool merges its children's ``child.work``/``child.serialize`` spans and
        records the slab ring's ``shm.acquire_wait``) and to the worker's readahead pool
        (``io.readahead``, ``io.wait``). Survives :meth:`reset`; None detaches. The
        DataLoader wires this from its ``trace=``."""
        self._tracer = tracer
        self._executor_set_trace(tracer)
        self._worker.set_trace(tracer)

    def set_health(self, monitor):
        """Attach a :class:`~petastorm_tpu_torch.obs.health.HealthMonitor` (or a scope
        of one; None detaches): the pool's workers or feeders heartbeat each work item
        (a process pool's children too, and they gain the SIGUSR1 stack dump and the
        healer), and the worker's readahead IO threads heartbeat each background read.
        Survives :meth:`reset`. The DataLoader wires this from ``health=``; call it
        directly for a reader without a loader."""
        self._health_monitor = monitor
        self._executor.set_health(monitor)
        self._worker.set_health(monitor)

    def set_provenance(self, recorder):
        """Attach a :class:`~petastorm_tpu_torch.obs.provenance.ProvenanceRecorder`:
        deliveries and quarantines are noted on it, and a process pool records its wire
        spans and merges its children's item records into it. Survives :meth:`reset`.
        The DataLoader wires this from ``provenance=``; a reader without a loader gets
        it from the factories' ``provenance=`` (or ``recorder.arm()`` and this call, so
        that the worker threads' spans are captured)."""
        self._prov = recorder
        self._executor_set_provenance(recorder)

    def _executor_set_provenance(self, recorder):
        fn = getattr(self._executor, "set_provenance", None)
        if fn is not None:
            fn(recorder)

    def _executor_set_trace(self, tracer):
        fn = getattr(self._executor, "set_trace", None)
        if fn is not None:
            fn(tracer)

    @property
    def wire_views(self):
        """True when batches are read-only views into pool slabs (a view wire)."""
        return bool(getattr(self._executor, "wire_views", False))

    # -- live knobs ---------------------------------------------------------------------

    def resize_workers(self, workers_count):
        """Grow or shrink the worker fleet live (thread and process pools; None on the
        dummy pool, which has none). A grow spawns; a shrink drains between items (never
        mid-item) and hands the retiring workers' claims back to the dispatcher, so the
        delivered rows and the checkpoint watermark are those of an un-resized run.
        Returns the applied target."""
        fn = getattr(self._executor, "resize", None)
        if fn is None:
            return None
        return fn(workers_count)

    def live_workers(self):
        """Workers running now (ones draining toward a shrink included), or None for a
        pool without a fleet."""
        return getattr(self._executor, "alive_workers", None)

    def apply_readahead_depth(self, depth):
        """Retune the readahead window: the worker's pool depth (and IO threads) and the
        dispatcher's claim lookahead (the claim is the prefetch hint window: a deeper
        pool without it would see no more hints)."""
        applied = self._worker.apply_readahead_depth(depth)
        set_lookahead = getattr(self._executor, "set_lookahead", None)
        if set_lookahead is not None and self._io_options.readahead:
            set_lookahead(applied)
        self._broadcast_child_knobs({"readahead_depth": applied})
        return applied

    def apply_readahead_bytes(self, nbytes):
        applied = self._worker.apply_readahead_bytes(nbytes)
        self._broadcast_child_knobs({"readahead_bytes": applied})
        return applied

    def apply_remote_max_inflight(self, max_inflight):
        applied = self._worker.apply_remote_max_inflight(max_inflight)
        self._broadcast_child_knobs({"remote_max_inflight": applied})
        return applied

    def apply_hedge_quantile(self, quantile):
        applied = self._worker.apply_hedge_quantile(quantile)
        self._broadcast_child_knobs({"hedge_quantile": applied})
        return applied

    def apply_pagedec(self, mode):
        """Retune the pass-through mode (the controller's lever back to the host
        inflate); it lands on the worker's next read."""
        applied = self._worker.apply_pagedec(mode)
        self._broadcast_child_knobs({"pagedec": applied})
        return applied

    def _broadcast_child_knobs(self, knobs):
        """A process pool's children own their IO runtimes, which the parent-side
        setters above cannot reach: the applied values also ride a control frame to
        every running child. Thread and dummy pools share the worker and need none."""
        fn = getattr(self._executor, "broadcast_io_knobs", None)
        if fn is not None:
            fn(dict(knobs))

    def reset(self):
        """Restart epochs on an existing reader (reference ``Reader.reset`` ~L700). Every
        lease this reader delivered is revoked: the pool rebuild recycles the slabs they
        view, so a batch kept across the reset raises ``LeaseRevoked``."""
        self.stop()
        self.join()
        for lease in list(self._issued_leases):
            lease.revoke()
        self._plan.reset()
        self._buffer = []
        self._buffer_pos = 0
        self._buffer_tag = None
        self._consumed = {}
        self._resume_epoch = 0
        self.last_row_consumed = False
        self._start()

    def stop(self):
        self.release_batch()  # a held slab must not outlive the stream it came from
        if self._executor is not None:
            self._executor.stop()
        self.stopped = True

    def join(self):
        # the watch thread first: a delta applied while the pool tears down would extend
        # a plan nobody drains (reset() and a restore start it again in _start)
        if self._watcher is not None:
            self._watcher.stop()
        # then the worker's IO runtime: a stop() mid-stream can leave executor threads
        # waiting in ReadaheadPool.get, and its shutdown releases them (to a synchronous
        # fallback) so the executor's join does not sit out its timeout
        self._worker.close()
        if self._executor is not None:
            self._executor.join()
        if self._prov is not None and self._prov._auto_disarm:
            # a recorder the factory built for this reader releases the process-global
            # slot here (its records stay readable; reset() arms it again); a recorder
            # the caller passed in stays armed, the caller's to release
            self._prov.disarm()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        self.join()

    # -- checkpoint ---------------------------------------------------------------------

    def state_dict(self):
        """Exact-resume checkpoint: the consumed-work map, not the dispatch cursor.

        Work items prefetched by the pool but not yet delivered are not counted, so a
        resume replays them: at-least-once delivery at row-group granularity (a
        partially consumed row group is replayed in full). The dict is plain JSON data,
        key for key the JAX package's ``Reader.state_dict()``.
        """
        plan_state = self._plan.state_dict()
        state = {
            "plan": {k: plan_state[k] for k in ("seed", "shuffle", "num_epochs", "num_items")},
            "resume_epoch": self._resume_epoch,
            "consumed": {int(e): sorted(v) for e, v in self._consumed.items()},
            # consumed ordinals mean something only against this item order
            "items_crc": self._items_identity_crc(self._num_items),
        }
        if self.shard_count:
            # the shard travels with the cursor, so a restore routes each process its own
            # state (petastorm_tpu_torch.checkpoint) and a mis-wired one fails loudly
            state["cur_shard"] = self.cur_shard
            state["shard_count"] = self.shard_count
        return state

    def load_state_dict(self, state):
        if "plan" not in state or "consumed" not in state:
            raise ValueError(
                "not a Reader state (keys: %s) — a WeightedSamplingReader/"
                "InMemDataLoader checkpoint must be restored into the matching "
                "object" % sorted(state))
        self.stop()
        self.join()
        if state["plan"]["num_items"] > self._num_items:
            raise ValueError(
                "Checkpoint was taken over %d work items; reader has %d"
                % (state["plan"]["num_items"], self._num_items)
            )
        ck_shard = state.get("cur_shard")
        if ck_shard is not None and self.shard_count and ck_shard != self.cur_shard:
            raise ValueError(
                "Checkpoint belongs to shard %s/%s but this reader is shard %s/%s — "
                "resuming would replay the wrong rows"
                % (ck_shard, state.get("shard_count"), self.cur_shard, self.shard_count))
        ck_crc = state.get("items_crc")
        if ck_crc is not None and \
                ck_crc != self._items_identity_crc(state["plan"]["num_items"]):
            raise ValueError(
                "Checkpoint's consumed ordinals do not match this reader's "
                "item order (the first %d work items differ — a file added "
                "between save and restore sorts BETWEEN existing names?): "
                "resuming would replay or lose rows. Mutable datasets must "
                "append files that sort after existing ones (e.g. "
                "monotonically-named parts) for cross-restart resume."
                % state["plan"]["num_items"])
        for lease in list(self._issued_leases):
            lease.revoke()  # the pool rebuild below recycles the slabs they view
        self._resume_epoch = int(state["resume_epoch"])
        self._consumed = {int(e): set(v) for e, v in state["consumed"].items()}
        self._plan.load_state_dict(
            {**state["plan"], "epoch": self._resume_epoch, "pos": 0}
        )
        self._plan.set_skip(self._consumed)
        self._buffer = []
        self._buffer_pos = 0
        self._buffer_tag = None
        self.last_row_consumed = False
        self._start()


# --------------------------------------------------------------------------------------
# Factories
# --------------------------------------------------------------------------------------


def _host_arena_early(io_opts):
    """Create (or join) the host-wide cache arena BEFORE dataset discovery: the
    factory's own footer reads (schema inference, row-group planning) go through the
    shared footer cache, which publishes host-wide only once this process has an arena;
    an arena born later (in ``_build_read_funnel``) would miss those footers, and every
    child would read them again from the store."""
    if io_opts.arena_bytes:
        from petastorm_tpu_torch.io import arena as arena_mod

        arena_mod.host_arena(io_opts.arena_bytes)


def _build_read_funnel(cache, io_opts, num_epochs=None, tenant=None):
    """The reader's cache funnel: ``MemCache → cache → the store`` as one
    :class:`~petastorm_tpu_torch.io.tiers.TieredCache`, with per-tier counts and the
    ``remote.disk_admit`` policy. The mem tier exists when ``io_options.memcache_bytes``
    (or ``PTPU_MEMCACHE_BYTES``) asks for one; ``num_epochs == 1`` is the scan hint the
    ``scan-resistant`` policy reads. With neither a mem nor a disk tier the funnel has
    nothing to serve and is left out: ``cache`` (a ``NullCache``) itself, so an uncached
    read sizes no payload (the JAX package counts it as a store serve), unless the reader
    is tagged: ``tenant`` (a slug) keeps the funnel, which charges each serve's bytes to
    the tenant's ``read_bytes``.

    ``io_options.arena_bytes`` creates (or joins) this process's host-wide cache arena
    and hands it to the mem tier, so every pool child maps ONE warm set of decoded row
    groups instead of filling its own. The arena alone implies a mem tier (its local
    budget defaults to the arena's); a failed create degrades once inside
    ``arena.host_arena``."""
    arena_obj = None
    if io_opts.arena_bytes:
        from petastorm_tpu_torch.io import arena as arena_mod

        arena_obj = arena_mod.host_arena(io_opts.arena_bytes)
    mem = None
    mem_budget = io_opts.memcache_bytes or (
        io_opts.arena_bytes if arena_obj is not None else 0)
    if mem_budget:
        from petastorm_tpu_torch.io.memcache import MemCache

        mem = MemCache(mem_budget, writable_hits=io_opts.memcache_writable_hits,
                       arena=arena_obj)
    if mem is None and isinstance(cache, NullCache) and tenant is None:
        return cache
    from petastorm_tpu_torch.io.tiers import TieredCache

    return TieredCache(mem=mem, disk=cache, disk_admit=io_opts.remote.disk_admit,
                       single_epoch=num_epochs == 1, tenant=tenant)


def _maybe_compile_pipeline(spec, schema, fs, pieces, cache=None):
    """Plan a declarative :class:`~petastorm_tpu_torch.ops.tabular.FeaturePipeline`
    against the read schema: resolve statistics-dependent op parameters (parquet
    row-group statistics when the footers cover them, one memoized streaming pass
    otherwise, written through the reader's cache funnel ``cache``), then compile to the
    fused host kernels (or the device function for ``device=True``). Opaque
    ``TransformSpec``\\ s pass through untouched; an already compiled pipeline (reused
    across readers) is kept as it is."""
    if spec is None or not getattr(spec, "declarative", False) \
            or getattr(spec, "compiled", False):
        return spec
    reqs = spec.required_statistics(schema)
    stats, sources = {}, {}
    if reqs:
        from petastorm_tpu_torch.io.statscache import resolve_statistics

        stats, sources = resolve_statistics(reqs, fs, pieces, cache=cache)
    spec.compile(schema, statistics=stats)
    spec.stats_info = dict(sources)
    return spec


def _resolve_device_fields(schema, decode_on_device, ngram=None, transform_spec=None):
    """Fields whose codec decode should stop at the host staging half (stage 1)."""
    if not decode_on_device:
        return frozenset()
    if ngram is not None:
        raise ValueError("decode_on_device is not supported with NGram readers")
    if transform_spec is not None and not transform_spec.device \
            and transform_spec.func is not None:
        raise ValueError(
            "decode_on_device is not compatible with a host transform_spec: the "
            "transform would receive coefficient staging payloads, not decoded images. "
            "Use a device transform (TransformSpec(..., device=True)) or the "
            "DataLoader's device_transform instead.")
    fields = frozenset(
        name for name, f in schema.fields.items()
        if f.codec is not None and getattr(f.codec, "device_decodable", False)
    )
    if not fields:
        logger.warning(
            "decode_on_device=True but the read schema has no device-decodable codec "
            "fields (only CompressedImageCodec('jpeg') columns qualify); reading "
            "proceeds fully host-decoded")
    return fields


def _resolve_ngram_schema(schema_fields, stored_schema, predicate):
    """Both factories' ``schema_fields`` policy: ``(ngram or None, read schema)``. An
    NGram reads every field a timestep needs plus its timestamp field, and refuses a
    predicate; otherwise a list of names, regexes or fields selects a schema view."""
    if isinstance(schema_fields, NGram):
        if predicate is not None:
            raise ValueError("NGram readers do not support predicates")
        schema_fields.resolve_regex_field_names(stored_schema)
        return schema_fields, schema_fields.make_schema_view(stored_schema)
    if schema_fields is None:
        return None, stored_schema
    if not isinstance(schema_fields, (list, tuple)) or not all(
            isinstance(f, (str, UnischemaField)) for f in schema_fields):
        raise ValueError("schema_fields must be a list of field names, regexes or "
                         "UnischemaFields, or an NGram; got %r" % (schema_fields,))
    return None, stored_schema.create_schema_view(schema_fields)


def make_reader(dataset_url, schema_fields=None, reader_pool_type="thread", workers_count=4,
                results_queue_size=16, shuffle_row_groups=True, shuffle_row_drop_partitions=1,
                predicate=None, rowgroup_selector=None, num_epochs=1,
                cur_shard=None, shard_count=None, shard_seed=None, seed=None,
                cache_type="null", cache_location=None, cache_size_limit=None,
                cache_row_size_estimate=None, cache_extra_settings=None,
                transform_spec=None, filters=None, storage_options=None, filesystem=None,
                results_timeout_s=300.0, decode_on_device=False, wire_serializer=None,
                io_retries=None, io_retry_backoff_s=None, worker_respawns=None,
                io_options=None, recovery=None, provenance=None, watch=None,
                transport=None, tenant=None):
    """Open a petastorm(-tpu) dataset for per-row decoded reading (reference ~L60).

    ``decode_on_device=True`` routes JPEG codec columns through the two-stage decode:
    workers run only the native entropy decode, and rows carry DCT coefficient staging
    payloads that :class:`petastorm_tpu_torch.loader.DataLoader` finishes on its device.

    ``transform_spec``: a :class:`~petastorm_tpu_torch.transform.TransformSpec` whose
    function runs on each decoded row dict in the workers (a declarative
    :class:`~petastorm_tpu_torch.ops.tabular.FeaturePipeline` runs once over each row
    group's columns), or on the device in the DataLoader with ``device=True``. The reader's
    schema is the post-transform schema of a host spec.

    ``reader_pool_type='process'`` runs the worker in child processes
    (:class:`~petastorm_tpu_torch.workers.ProcessExecutor`). ``wire_serializer`` is the
    wire they answer over: ``'pickle'`` (the default here) or ``'arrow'`` on the socket,
    ``'shm'`` or ``'shm-arrow'`` through shared-memory slabs (``PTPU_SHM_SLAB_BYTES``
    sizes a slab), and their ``-view`` forms, which deliver read-only views into the
    slabs (see :class:`Reader`). ``transport`` is the pool's wire: ``'pipe'`` (the
    default, or ``PTPU_TRANSPORT``), the unix sockets, or ``'tcp'``, framed tcp to a hub
    the children dial back to, with heartbeats, a redial after a link death and the
    in-flight ledger that sends a dead link's item again (a shared-memory wire takes its
    inner serializer there: slab grants cannot cross a host). The link policy is
    ``recovery``'s ``link_*`` fields.

    Failure handling: ``recovery`` (:class:`~petastorm_tpu_torch.recovery.RecoveryOptions`
    or a dict of its fields; defaults from the ``PTPU_IO_RETRIES``,
    ``PTPU_IO_RETRY_BACKOFF_S``, ``PTPU_IO_RETRY_MAX_BACKOFF_S``, ``PTPU_READ_DEADLINE_S``,
    ``PTPU_WORKER_RESPAWNS``, ``PTPU_ON_POISON`` and ``PTPU_POISON_ATTEMPTS``
    environment variables). Transient read errors are retried ``io_retries`` extra
    times (default 2) with jittered exponential backoff from ``io_retry_backoff_s``
    (0.1 s); the process pool replaces a dead child up to ``worker_respawns`` times (2);
    with ``on_poison="quarantine"`` a row group that fails ``poison_attempts`` times (2)
    is skipped into ``Reader.quarantine_report`` instead of ending the read. The legacy
    ``io_retries=``, ``io_retry_backoff_s=`` and ``worker_respawns=`` win over the struct
    when given.

    Row selection: ``predicate`` (:mod:`petastorm_tpu_torch.predicates`) masks rows in
    the workers, reading its columns first and the others only where a row matches;
    ``filters`` (pyarrow DNF tuples) prune hive ``key=value`` directories and row groups
    whose footer statistics cannot match, then mask rows; ``rowgroup_selector``
    (:mod:`petastorm_tpu_torch.selectors`) keeps the row groups a prebuilt index names
    (:mod:`petastorm_tpu_torch.etl.rowgroup_indexing`); ``shuffle_row_drop_partitions=k``
    splits each row group into k seeded row subsets, each its own work item. A predicate
    that matches nothing gives an empty read; ``filters`` that prune every row group
    raise ``NoDataAvailableError``.

    ``schema_fields`` is a list of field names, regexes or fields, or an
    :class:`~petastorm_tpu_torch.ngram.NGram`: then each row is a window ``{offset:
    namedtuple}`` of consecutive rows of one row group (sorted by the timestamp field),
    formed in the workers after the host transform. NGram refuses a ``predicate`` and
    ``decode_on_device``.

    ``io_options`` (:class:`~petastorm_tpu_torch.io.IoOptions` or a dict of its fields)
    is the read path, at the JAX package's defaults: readahead (depth 3, 256 MB, 2 IO
    threads a worker process), coalesced reads of up to 4 adjacent row groups, work
    stealing, the shared 64 MiB footer cache; ``memcache_bytes`` adds the in-memory LRU
    of decoded row groups (read-only views; an opaque host ``transform_spec`` gets
    writable copies). ``cache_type="local-disk"`` with ``cache_location`` (and
    ``cache_size_limit``, ``cache_row_size_estimate``, ``cache_extra_settings``) caches
    decoded row groups on local disk, behind the memcache (``Reader.io_stats()`` counts
    the serves of each tier). ``arena_bytes`` maps one host-wide shared-memory cache
    arena into every process of the reader (the pool's children attach it): footers,
    decoded row groups and page indexes warmed once a host. On an object store (a
    filesystem whose ``type_name`` is not local, ``CloudLatencyFS`` included) reads go
    through the ranged-GET engine (``io_options["remote"]``: parallel hedged GETs, footer
    GETs against the file's tail).

    ``tenant``: per-tenant accounting (:mod:`petastorm_tpu_torch.obs.tenant`), a bounded
    slug or a ``TenantContext`` (default: the ``PTPU_TENANT`` environment). Every
    ``ptpu_tenant_*`` family this reader's work touches is charged under its label:
    delivered and quarantined rows, worker seconds, bytes served, arena residency,
    hedged GETs.

    ``watch``: a store that changes under the reader
    (:class:`~petastorm_tpu_torch.dataset.WatchOptions`, a dict of its fields, or
    ``True`` for the defaults; a single dataset path). Each file's generation token
    (size, mtime and footer crc) is stamped into its plan items and cache keys and
    checked at every read: under ``recovery={"on_poison": "quarantine"}`` a rewritten
    file's pending items quarantine as ``piece_rewritten`` and a deleted one's as
    ``piece_removed``. A watch thread (``Reader.dataset_watcher``; ``poll_once()`` runs
    one tick) extends the plan with appended files in the current epoch and a rewritten
    file's new generation in the next, with the checkpoint watermark exact.
    """
    tenant_ctx = _tenant.resolve(tenant)
    recovery = RecoveryOptions.resolve(recovery, io_retries=io_retries,
                                       io_retry_backoff_s=io_retry_backoff_s,
                                       worker_respawns=worker_respawns)
    io_options = IoOptions.normalize(io_options)
    _host_arena_early(io_options)
    fs, path = get_filesystem_and_path_or_paths(dataset_url, storage_options, filesystem)
    stored_schema = get_schema(fs, path)
    pieces = load_row_groups(fs, path)
    watch_paths = {p.path for p in pieces}  # the file set before any selection
    pieces = _apply_rowgroup_selector(fs, path, pieces, rowgroup_selector)
    stats_pieces = pieces  # the plan's input, row-group statistics still attached
    pieces, partition_info, filters = _plan_pieces(pieces, filters, predicate, shard_count)
    watch = _resolve_watch(watch)
    if watch is not None:
        from petastorm_tpu_torch.dataset.watch import stamp_generation_tokens

        pieces = stamp_generation_tokens(fs, pieces, footer_crc=watch.footer_crc)
    if partition_info:
        stored_schema = _schema_with_partitions(stored_schema, partition_info)
    ngram, read_schema = _resolve_ngram_schema(schema_fields, stored_schema, predicate)
    cache = _build_read_funnel(
        make_cache(cache_type, cache_location, cache_size_limit, cache_row_size_estimate,
                   cache_extra_settings), io_options, num_epochs,
        tenant=tenant_ctx.tenant if tenant_ctx is not None else None)
    transform_spec = _maybe_compile_pipeline(transform_spec, read_schema, fs, stats_pieces,
                                             cache)
    final_schema = read_schema
    if transform_spec is not None and not transform_spec.device:
        final_schema = transform_schema(read_schema, transform_spec)
    device_fields = _resolve_device_fields(read_schema, decode_on_device, ngram,
                                           transform_spec)
    worker = PyDictWorker(
        fs, read_schema, stored_schema, device_fields, transform_spec, predicate=predicate,
        filters=filters, shuffle_row_drop_partitions=shuffle_row_drop_partitions,
        seed=seed if seed is not None else shard_seed, partition_info=partition_info,
        cache=cache, io_options=io_options, recovery=recovery,
        ngram=ngram, ngram_schema=final_schema if ngram is not None else None)
    r = Reader(final_schema, worker, pieces, num_epochs=num_epochs,
               shuffle_row_groups=shuffle_row_groups, seed=seed, cur_shard=cur_shard,
               shard_count=shard_count, shard_seed=shard_seed,
               shuffle_row_drop_partitions=shuffle_row_drop_partitions,
               reader_pool_type=reader_pool_type, workers_count=workers_count,
               results_queue_size=results_queue_size, is_batched_reader=False,
               results_timeout_s=results_timeout_s,
               wire_serializer=wire_serializer or "pickle",
               worker_respawns=recovery.worker_respawns, io_options=io_options,
               transport=transport, ngram=ngram, recovery=recovery, filesystem=fs,
               provenance=_prov.resolve(provenance), tenant=tenant_ctx, path=path,
               watch=watch, watch_paths=watch_paths)
    r.transform_spec = transform_spec
    r.device_decode_fields = device_fields
    return r


def _resolve_watch(watch):
    """The factories' normalization of ``watch=``."""
    from petastorm_tpu_torch.dataset.watch import WatchOptions

    return WatchOptions.normalize(watch)


def make_batch_reader(dataset_url_or_urls, schema_fields=None, reader_pool_type="thread",
                      workers_count=4, results_queue_size=16, shuffle_row_groups=True,
                      shuffle_row_drop_partitions=1, predicate=None, num_epochs=1,
                      cur_shard=None, shard_count=None, shard_seed=None, seed=None,
                      cache_type="null", cache_location=None, cache_size_limit=None,
                      cache_row_size_estimate=None, cache_extra_settings=None,
                      transform_spec=None, filters=None, storage_options=None,
                      filesystem=None, results_timeout_s=300.0, decode_on_device=False,
                      wire_serializer=None, io_retries=None, io_retry_backoff_s=None,
                      worker_respawns=None, io_options=None, recovery=None,
                      provenance=None, watch=None, transport=None, tenant=None):
    """Open ANY Parquet store for vectorized columnar batches (reference ~L200).

    ``decode_on_device``: see :func:`make_reader` — JPEG codec columns come back as
    staging payloads for the DataLoader's batched on-device decode.

    ``io_options``, ``cache_type`` and the other ``cache_*`` options: see
    :func:`make_reader`. ``{"pagedec": "auto" | "on" | "off"}`` sets the compressed-page
    pass-through (default ``off``): eligible fixed-width columns travel as their raw
    compressed pages and the :class:`~petastorm_tpu_torch.loader.DataLoader` inflates
    them on the card. A ``transform_spec`` turns the pass-through off for the whole read
    (the transform needs decoded columns), as in the JAX package.

    ``transform_spec``: see :func:`make_reader`; here an opaque function receives each
    row group as a pandas DataFrame, and a declarative ``FeaturePipeline`` runs its fused
    numpy kernels on the columns.

    The process pool's options, ``transport`` and ``recovery`` are :func:`make_reader`'s
    (a poison row group's quarantine entry counts its rows from the file's footer); the
    default wire here is
    ``'arrow'``, and ``'shm'``/``'shm-view'`` mean ``'shm-arrow'``/``'shm-arrow-view'``.

    ``predicate``, ``filters`` and ``shuffle_row_drop_partitions``: see
    :func:`make_reader` (``rowgroup_selector`` is ``make_reader``'s only, as in the JAX
    package). Each of them turns the compressed-page pass-through off for the read: the
    mask needs decoded rows. The mask is applied before any column is decoded, so rows it
    drops cost no stage 1 on a ``decode_on_device`` JPEG column.

    ``schema_fields=NGram(...)`` windows each row group into flat ``{'offset/field':
    column}`` dicts, one row a window (one argsort and one gather an (offset, field));
    it reads classically (no pass-through) and refuses a ``predicate`` and
    ``decode_on_device``, as :func:`make_reader` does.

    ``tenant`` and ``watch``: see :func:`make_reader`.
    """
    tenant_ctx = _tenant.resolve(tenant)
    recovery = RecoveryOptions.resolve(recovery, io_retries=io_retries,
                                       io_retry_backoff_s=io_retry_backoff_s,
                                       worker_respawns=worker_respawns)
    io_options = IoOptions.normalize(io_options)
    _host_arena_early(io_options)
    fs, path = get_filesystem_and_path_or_paths(
        dataset_url_or_urls, storage_options, filesystem)
    paths = path if isinstance(path, list) else [path]
    stored_schema = infer_or_load_unischema(fs, paths[0])
    pieces = []
    for p in paths:
        pieces.extend(load_row_groups(fs, p))
    watch_paths = {p.path for p in pieces}  # the file set before any selection
    stats_pieces = pieces  # the plan's input, row-group statistics still attached
    pieces, partition_info, filters = _plan_pieces(pieces, filters, predicate, shard_count)
    watch = _resolve_watch(watch)
    if watch is not None:
        from petastorm_tpu_torch.dataset.watch import stamp_generation_tokens

        pieces = stamp_generation_tokens(fs, pieces, footer_crc=watch.footer_crc)
    if partition_info:
        stored_schema = _schema_with_partitions(stored_schema, partition_info)
    ngram, read_schema = _resolve_ngram_schema(schema_fields, stored_schema, predicate)
    cache = _build_read_funnel(
        make_cache(cache_type, cache_location, cache_size_limit, cache_row_size_estimate,
                   cache_extra_settings), io_options, num_epochs,
        tenant=tenant_ctx.tenant if tenant_ctx is not None else None)
    transform_spec = _maybe_compile_pipeline(transform_spec, read_schema, fs, stats_pieces,
                                             cache)
    final_schema = read_schema
    if transform_spec is not None and not transform_spec.device:
        final_schema = transform_schema(read_schema, transform_spec)
    device_fields = _resolve_device_fields(read_schema, decode_on_device, ngram,
                                           transform_spec)
    worker = ArrowWorker(
        fs, read_schema, stored_schema, device_fields, io_options=io_options,
        transform_spec=transform_spec, ngram=ngram, predicate=predicate, filters=filters,
        shuffle_row_drop_partitions=shuffle_row_drop_partitions,
        seed=seed if seed is not None else shard_seed, partition_info=partition_info,
        cache=cache, recovery=recovery)
    r = Reader(final_schema, worker, pieces, num_epochs=num_epochs,
               shuffle_row_groups=shuffle_row_groups, seed=seed, cur_shard=cur_shard,
               shard_count=shard_count, shard_seed=shard_seed,
               shuffle_row_drop_partitions=shuffle_row_drop_partitions,
               reader_pool_type=reader_pool_type, workers_count=workers_count,
               results_queue_size=results_queue_size, is_batched_reader=True,
               results_timeout_s=results_timeout_s,
               # the JAX package's default wire for batches: Arrow IPC, and its framing
               # inside the slabs
               wire_serializer={"shm": "shm-arrow", "shm-view": "shm-arrow-view"}.get(
                   wire_serializer, wire_serializer) or "arrow",
               worker_respawns=recovery.worker_respawns, io_options=io_options,
               transport=transport, ngram=ngram, recovery=recovery, filesystem=fs,
               provenance=_prov.resolve(provenance), tenant=tenant_ctx, path=path,
               watch=watch, watch_paths=watch_paths)
    r.transform_spec = transform_spec
    r.device_decode_fields = device_fields
    return r


# --------------------------------------------------------------------------------------
# Plan-time selection (reference ``_plan_pieces`` and its helpers)
# --------------------------------------------------------------------------------------


def make_service_reader(address, token, job, trainer=None, tenant=None,
                        recovery=None, credits=8, arena=True):
    """Attach to a job of a :class:`~petastorm_tpu_torch.service.server.DataService`:
    the disaggregated twin of :func:`make_batch_reader`. The returned
    :class:`~petastorm_tpu_torch.service.client.ServiceReader` consumes the shared decode
    fleet's output instead of decoding here: batched columnar delivery with the same
    ``state_dict()`` consumed-watermark checkpoint, into
    :class:`~petastorm_tpu_torch.loader.DataLoader` unchanged (on a card its columns go
    through the loader's H2D copy and device transform).

    ``address`` and ``token`` come from the service
    (:meth:`~petastorm_tpu_torch.service.server.DataService.trainer_address` and
    ``.token``); ``arena=True`` maps co-hosted payloads zero-copy out of the host-wide
    cache arena.
    """
    from petastorm_tpu_torch.service.client import ServiceReader

    return ServiceReader(address, token, job, trainer=trainer, tenant=tenant,
                         recovery=recovery, credits=credits, arena=arena)


def _dnf_clauses(filters):
    """pyarrow-style DNF filters as a list of AND-clauses: the flat ``[(col, op, val),
    ...]`` form or the ``[[...], [...]]`` OR-of-ANDs form. Shared by the row mask and
    the statistics pruning, so their clause semantics cannot drift."""
    return [filters] if isinstance(filters[0][0], str) else filters


def _dnf_fields(filters):
    return {name for clause in _dnf_clauses(filters) for name, _op, _val in clause}


def _dnf_mask(table, filters):
    """Evaluate DNF filters over a row-group table as a boolean mask."""
    def term_mask(name, op, val):
        col = table.column(name).to_numpy(zero_copy_only=False)
        if op in ("=", "=="):
            return col == val
        if op == "!=":
            return col != val
        if op == "<":
            return col < val
        if op == "<=":
            return col <= val
        if op == ">":
            return col > val
        if op == ">=":
            return col >= val
        if op == "in":
            return np.isin(col, list(val))
        if op in ("not in", "not-in"):
            return ~np.isin(col, list(val))
        raise ValueError("Unsupported filter op %r" % op)

    total = None
    for clause in _dnf_clauses(filters):
        cmask = None
        for name, op, val in clause:
            t = term_mask(name, op, val)
            cmask = t if cmask is None else (cmask & t)
        total = cmask if total is None else (total | cmask)
    return np.asarray(total, dtype=bool)


def _plan_pieces(pieces, filters, predicate, shard_count=None):
    """Plan-time pruning: hive partition resolution and directory pruning, then
    row-group statistics pruning, with the clauses a predicate implies conjoined for the
    pruning only. Returns ``(pieces, partition_info, filters)``, ``filters`` being the
    normalized user filters the workers run as the row mask.

    When the predicate's clauses alone prune everything, one piece a shard is kept: a
    predicate that matches nothing gives an empty read (its row groups mask to zero
    rows), while user ``filters`` that prune everything leave no piece, and the reader
    raises ``NoDataAvailableError``. Statistics are stripped from the returned pieces:
    work items must not carry per-column bounds to the pool."""
    out, partition_info, norm_user = _resolve_partitions(pieces, filters)
    out = _prune_by_stats(out, norm_user)
    implied = None
    if predicate is not None:
        from petastorm_tpu_torch.predicates import implied_dnf_filters

        implied = implied_dnf_filters(predicate)
    if implied and out:
        # sequential pruning passes equal conjoining the clause sets (satisfiability is
        # checked per term), so the implied clauses prune the user-pruned set directly
        logger.debug("Predicate-implied pruning clauses: %s", implied)
        kept = out
        if partition_info:
            from petastorm_tpu_torch.partitions import normalize_filters, prune_pieces

            implied = normalize_filters(implied, partition_info)
            kept = prune_pieces(kept, partition_info, implied)
        kept = _prune_by_stats(kept, implied)
        # never hand a shard zero pieces: pad with unpruned survivors (they mask to zero
        # rows) up to one piece a shard
        min_pieces = max(1, int(shard_count or 1))
        if len(kept) < min_pieces:
            have = {(p.path, p.row_group) for p in kept}
            extra = [p for p in out if (p.path, p.row_group) not in have]
            kept = kept + extra[:min_pieces - len(kept)]
        out = kept
    return ([p._replace(stats=None) if p.stats else p for p in out],
            partition_info, norm_user)


def _resolve_partitions(pieces, filters):
    """Hive partitioning at plan time: a typed
    :class:`~petastorm_tpu_torch.partitions.PartitionInfo` from the pieces' paths and
    directory-level pruning by ``filters``. Returns ``(pieces, info or None, filters)``,
    filter values on partition columns coerced to the inferred column types (a string
    filter against an int-typed partition must match, here and in the row mask); flat
    layouts pass through untouched."""
    from petastorm_tpu_torch.partitions import (build_partition_info, normalize_filters,
                                                prune_pieces)

    info = build_partition_info([p.partition_values or {} for p in pieces])
    if not info:
        return pieces, None, filters
    filters = normalize_filters(filters, info)
    pruned = prune_pieces(pieces, info, filters)
    if len(pruned) < len(pieces):
        logger.info("Hive partition pruning: %d of %d row groups scheduled",
                    len(pruned), len(pieces))
    return pruned, info, filters


def _prune_by_stats(pieces, filters):
    """Drop the pieces that no OR-clause of ``filters`` can match given their footer
    statistics. Conservative: absent statistics, unknown columns and type mismatches
    count as satisfiable, so a piece goes only on a provable contradiction, and the row
    mask still runs on the survivors. Parquet min/max exclude nulls, so ``!=`` and
    ``not in`` prune only groups whose recorded null count is zero (null rows match
    those operators in the row mask)."""
    if not pieces or not filters:
        return pieces

    def term_unsat(stats, name, op, val):
        if not stats or name not in stats:
            return False
        mn, mx, nulls = stats[name]
        try:
            if op in ("=", "=="):
                return val < mn or val > mx
            if op == "!=":
                return nulls == 0 and bool(mn == mx == val)
            if op == "<":
                return mn >= val
            if op == "<=":
                return mn > val
            if op == ">":
                return mx <= val
            if op == ">=":
                return mx < val
            if op == "in":
                return all(v < mn or v > mx for v in val)
            if op in ("not in", "not-in"):
                if nulls != 0:
                    return False
                excluded = set(val)
                if bool(mn == mx):
                    return mn in excluded
                if isinstance(mn, (int, np.integer)) and isinstance(mx, (int, np.integer)):
                    # integer stats: unsatisfiable iff the excluded set covers every
                    # value in [mn, mx]
                    span = int(mx) - int(mn) + 1
                    return span <= len(excluded) and \
                        all((int(mn) + i) in excluded for i in range(span))
                return False
        except TypeError:  # mixed types (a str filter against bytes stats): no pruning
            return False
        return False

    kept = [p for p in pieces
            if any(not any(term_unsat(p.stats, *term) for term in clause)
                   for clause in _dnf_clauses(filters))]
    if len(kept) < len(pieces):
        logger.info("Row-group statistics pruning: %d of %d row groups scheduled",
                    len(kept), len(pieces))
    return kept


def _schema_with_partitions(schema, info):
    """The stored schema plus the partition-directory columns (in no file's schema, but
    delivered as row values); nullable for ``__HIVE_DEFAULT_PARTITION__`` directories."""
    from petastorm_tpu_torch.partitions import partition_fields

    extra = [f for f in partition_fields(info, nullable=True)
             if f.name not in schema.fields]
    if not extra:
        return schema
    return Unischema(schema._name, list(schema.fields.values()) + extra)


def _apply_rowgroup_selector(fs, path, pieces, rowgroup_selector):
    if rowgroup_selector is None:
        return pieces
    from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes

    index_dict = get_row_group_indexes(fs, path)
    selected = rowgroup_selector.select_row_groups(index_dict)
    return [p for i, p in enumerate(pieces) if i in selected]
