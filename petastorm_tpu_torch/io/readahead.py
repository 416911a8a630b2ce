"""Bounded row-group readahead: the next K reads run while the current table decodes.

Port of ``petastorm_tpu.io.readahead``. A :class:`ReadaheadPool` owns a small IO thread
pool and a keyed table of in-flight and completed background reads. The worker's
dispatch layer hands it the upcoming plan items (``_WorkerBase.prefetch``); when the
worker's synchronous path later asks for the same ``(path, row_group, columns)`` the
read is either done (a hit: the worker paid no read latency) or still in flight (the
worker waits only the remainder, counted as ``readahead_wait_s``). Misses fall straight
through to the synchronous read, so the pool never makes a read slower than the
blocking path, and a pool that fails to build degrades the worker to synchronous reads
(degradation ``readahead_unavailable``).

Failure semantics mirror the synchronous path exactly: a background read runs the
worker's own synchronous read, transient-IO retry loop included
(:class:`~petastorm_tpu_torch.recovery.RecoveryOptions`), and a read that exhausted its
retries re-raises the same exception from :meth:`ReadaheadPool.get`: readahead grants no
retry budget the synchronous path lacks, and the foreground spends none on top. Only cancelled entries (pool shutdown
mid-read) and a read still pending after ``wait_timeout_s`` fall back to a synchronous
read (degradation ``readahead_fallback``).

Bounds: at most ``depth`` background reads pending, completed-but-unclaimed tables
evicted oldest first past ``byte_budget``, and completed entries capped in number (a
stolen item's prefetched table, or a failed read nobody claims, ages out).

Each background read is the chaos site ``io.readahead`` and, with a
:class:`~petastorm_tpu_torch.trace.TraceRecorder` attached (:meth:`ReadaheadPool.set_trace`),
an ``io.readahead`` span; a foreground wait on an in-flight read is an ``io.wait`` span.
With a :class:`~petastorm_tpu_torch.obs.health.HealthMonitor` attached
(:meth:`ReadaheadPool.set_health`) each IO thread heartbeats as ``io.<thread name>``
(role ``io``): busy (``read``) during a background read, ``wait:idle`` between tasks, so
a read hung against a wedged filesystem trips the stall watchdog. With the provenance
plane armed (:mod:`petastorm_tpu_torch.obs.provenance`) the claiming item is annotated
``readahead`` = ``hit`` or ``miss``, and a hit carries the IO thread's read as an
``io.readahead`` span (its timestamps are the IO thread's, taken when it read, on the same
``perf_counter`` clock) plus the claimer's remaining wait as ``io.readahead_wait``. The
counts are per pool, read through :meth:`ReadaheadPool.stats`; ``Reader.io_stats()``
carries them, and a ``DataLoader(metrics=...)`` exports that dict through its ``io``
collector. The same events rise on a registry (``registry=``, the process-wide one by
default) under the JAX package's families: ``ptpu_io_readahead_{hits,misses,
evictions}_total``, ``ptpu_io_coalesced_{reads,items}_total``, the gauges
``ptpu_io_readahead_depth`` (reads in flight) and ``ptpu_io_readahead_bytes`` (completed
bytes awaiting their claim), and the histograms ``ptpu_io_read_seconds`` (background
reads) and ``ptpu_io_wait_seconds`` (foreground waits). The depth,
the byte budget and the IO thread count are live knobs (:meth:`ReadaheadPool.apply_depth`,
:meth:`~ReadaheadPool.apply_byte_budget`, :meth:`~ReadaheadPool.apply_io_threads`), the
seam :mod:`petastorm_tpu_torch.control` actuates; the options are never mutated.
"""
from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict

from petastorm_tpu_torch.io.coalesce import plan_runs
from petastorm_tpu_torch.obs import provenance as _prov
from petastorm_tpu_torch.obs.health import ActorSlots
from petastorm_tpu_torch.obs.metrics import default_registry
from petastorm_tpu_torch.parallel.shm_ring import degradation

#: pools whose IO threads must be joined before interpreter finalization.
#: ``shutdown()`` does not wait (a hung read must not block ``Reader.join``), so the IO
#: threads exit on their own; they are daemons, and nothing would join them before
#: ``Py_Finalize``. A daemon thread still destroying its thread-local ``ParquetFile``
#: cache when finalization begins re-enters pyarrow, is force-exited mid-C++, and the
#: forced unwind through a noexcept Arrow frame aborts the process. The exit hook
#: therefore shuts every live pool down and joins its threads (bounded: a read hung
#: past the cap forfeits the guarantee rather than hanging exit). It runs during
#: threading shutdown, before concurrent.futures' own unbounded join
#: (``threading._register_atexit`` callbacks run in reverse registration order, and
#: concurrent.futures registers at import, before any pool exists); threads still
#: alive after the bounded join are detached from concurrent.futures' bookkeeping.
_live_pools_lock = threading.Lock()
_live_pools = weakref.WeakSet()
#: strong refs to the executors of shut-down pools whose IO threads may still be
#: exiting: ``worker.close()`` drops the pool right after ``shutdown()``, and the exit
#: drain must still join its straggling threads. Pruned once their threads die.
_dying_executors = []
_drain_installed = False


def _install_exit_drain():
    global _drain_installed
    with _live_pools_lock:
        if _drain_installed:
            return
        _drain_installed = True
    # concurrent.futures' hook registers first, so the reversed order runs ours first
    import concurrent.futures.thread  # noqa: F401

    register = getattr(threading, "_register_atexit", None)
    if register is not None:
        register(_drain_live_pools)
    else:  # pragma: no cover - Python < 3.9
        import atexit

        atexit.register(_drain_live_pools)


def _executor_threads_alive(executor):
    return any(t.is_alive() for t in getattr(executor, "_threads", ()) or ())


def _drain_live_pools():
    with _live_pools_lock:
        pools = list(_live_pools)
    deadline = time.monotonic() + 10.0
    for pool in pools:
        pool.shutdown()  # cancels pending reads; only an executing one remains
    for pool in pools:
        pool.drain(max(0.1, deadline - time.monotonic()))
    for pool in pools:
        pool.join_threads(max(0.1, deadline - time.monotonic()))
    with _live_pools_lock:
        dying = list(_dying_executors)
    for executor in dying:
        for t in list(getattr(executor, "_threads", ()) or ()):
            t.join(max(0.05, deadline - time.monotonic()))
    from concurrent.futures import thread as cf_thread

    for pool in pools:
        pool.abandon_hung_threads()
    for executor in dying:
        _abandon_pool_threads(executor, cf_thread)


def _abandon_pool_threads(pool, cf_thread):
    """Detach still-alive IO threads from interpreter-exit bookkeeping after the bounded
    join expired: concurrent.futures' ``_python_exit`` join and ``threading._shutdown``'s
    wait would otherwise block on a read hung against a wedged filesystem."""
    try:
        for t in list(getattr(pool, "_threads", ()) or ()):
            if not t.is_alive():
                continue
            cf_thread._threads_queues.pop(t, None)
            lock = getattr(t, "_tstate_lock", None)
            shutdown_locks = getattr(threading, "_shutdown_locks", None)
            if lock is not None and shutdown_locks is not None:
                with threading._shutdown_locks_lock:
                    shutdown_locks.discard(lock)
    except Exception:  # noqa: BLE001
        pass  # graftlint: disable=GL-O002 (best-effort private-API detach at interpreter exit)


class _CancelledRead(Exception):
    """Internal marker: the pool shut down before this read completed."""


class _Entry:
    __slots__ = ("event", "table", "error", "nbytes", "claimed", "read_span")

    def __init__(self):
        self.event = threading.Event()
        self.table = None
        self.error = None
        self.nbytes = 0
        self.claimed = False
        #: (t0, seconds) of the IO thread's read that filled the entry
        self.read_span = None


def request_key(piece, columns):
    """Identity of one background read: file, row group, the piece's generation token
    (None unless the reader watches the dataset: two generations of one file are two
    reads) and the exact column selection (``None`` = all columns)."""
    return (piece.path, piece.row_group, getattr(piece, "generation", None),
            None if columns is None else tuple(columns))


class ReadaheadPool:
    """Per-process prefetcher of row-group reads.

    ``read_fn(piece, columns) -> table`` is the worker's synchronous read;
    ``read_run_fn(pieces, columns) -> [tables]`` (optional) its coalesced ranged read of
    adjacent row groups; ``gap_ok(prev, piece)`` (optional) lets the run planner bridge
    non-adjacent row groups. Shut down with :meth:`shutdown`: the pool owns threads.
    ``registry`` takes the pool's families (the process-wide registry by default).
    """

    def __init__(self, read_fn, read_run_fn=None, depth=3, byte_budget=256 << 20,
                 io_threads=2, coalesce=True, coalesce_max_run=4,
                 wait_timeout_s=300.0, registry=None, gap_ok=None):
        from concurrent.futures import ThreadPoolExecutor

        self._read_fn = read_fn
        self._read_run_fn = read_run_fn
        self._gap_ok = gap_ok
        self._tracer = None
        self._health = None  # a HealthMonitor: a heartbeat an IO thread (set_health)
        #: the IO threads' heartbeats and the start of each one's read in flight, so a
        #: monitor attached mid-read watches the threads and reads that already run
        self._io_slots = ActorSlots(self, "io.%s", "io", busy="read", idle="idle")
        self._depth = max(1, int(depth))
        # 0 or negative = no cap (the memcache_bytes=0 convention), not "hold nothing",
        # which would veto every schedule() while readahead reports itself on
        self._byte_budget = int(byte_budget) if int(byte_budget) > 0 else None
        self._wait_timeout_s = wait_timeout_s
        self._coalesce = bool(coalesce) and read_run_fn is not None
        self._max_run = max(1, int(coalesce_max_run))
        self._io_threads = max(1, int(io_threads))
        self._lock = threading.Lock()
        self._entries = OrderedDict()  # key -> _Entry (insertion order = age)
        self._pending = 0
        self._held_bytes = 0
        self._closed = False
        self._active_reads = 0
        self._idle = threading.Event()  # set whenever no read task is running
        self._idle.set()
        self._n_hits = 0
        self._n_misses = 0
        self._n_evictions = 0
        self._n_coalesced_reads = 0
        self._n_coalesced_items = 0
        #: cumulative seconds: background reads, foreground waits on in-flight reads,
        #: and miss-fallback synchronous reads (wait + sync = the exposed read latency)
        self._read_s_cum = 0.0
        self._wait_s_cum = 0.0
        self._sync_s_cum = 0.0
        self._pool = ThreadPoolExecutor(max_workers=self._io_threads,
                                        thread_name_prefix="ptpu-torch-io")
        # the families are process-wide (shared by every pool on the registry); the
        # _n_* tallies above are this pool's own, for stats()
        reg = registry if registry is not None else default_registry()
        self._hits = reg.counter("ptpu_io_readahead_hits_total",
                                 help="foreground reads served by readahead")
        self._misses = reg.counter("ptpu_io_readahead_misses_total",
                                   help="foreground reads not prefetched")
        self._evictions = reg.counter("ptpu_io_readahead_evictions_total",
                                      help="prefetched tables dropped for budget")
        self._coalesced_reads = reg.counter(
            "ptpu_io_coalesced_reads_total",
            help="ranged reads that merged >1 adjacent row group")
        self._coalesced_items = reg.counter(
            "ptpu_io_coalesced_items_total",
            help="row groups delivered through merged ranged reads")
        self._depth_gauge = reg.gauge("ptpu_io_readahead_depth",
                                      help="background reads currently in flight")
        self._bytes_gauge = reg.gauge(
            "ptpu_io_readahead_bytes",
            help="completed prefetched table bytes awaiting consumption")
        self._read_hist = reg.histogram("ptpu_io_read_seconds",
                                        help="background row-group read latency")
        self._wait_hist = reg.histogram(
            "ptpu_io_wait_seconds",
            help="foreground wait on an in-flight prefetched read")
        with _live_pools_lock:
            _live_pools.add(self)
        _install_exit_drain()

    # -- live knobs ---------------------------------------------------------------------

    def apply_depth(self, depth):
        """Retune the bound on background reads in flight. Takes effect at the next
        ``schedule()``: reads in flight above a lowered bound finish (the bound gates
        admission, it never cancels work)."""
        depth = max(1, int(depth))
        with self._lock:
            self._depth = depth
            self._evict_over_budget()  # the completed-entry cap scales with the depth
            self._bytes_gauge.set(self._held_bytes)
        return depth

    def apply_byte_budget(self, nbytes):
        """Retune the completed-unclaimed byte budget (<= 0: uncapped, the
        construction convention); tables over the new budget are evicted now."""
        nbytes = int(nbytes)
        with self._lock:
            self._byte_budget = nbytes if nbytes > 0 else None
            self._evict_over_budget()
            self._bytes_gauge.set(self._held_bytes)
        return 0 if self._byte_budget is None else self._byte_budget

    def apply_io_threads(self, io_threads):
        """Resize the IO thread pool by a swap: new reads go to a fresh pool of the
        target size; the old pool's queued and running reads finish on its own threads
        (a retune never fails a read), which the exit drain joins like any shut-down
        pool's."""
        from concurrent.futures import ThreadPoolExecutor

        io_threads = max(1, int(io_threads))
        with self._lock:
            if self._closed or io_threads == self._io_threads:
                return self._io_threads
            old = self._pool
            self._pool = ThreadPoolExecutor(max_workers=io_threads,
                                            thread_name_prefix="ptpu-torch-io")
            self._io_threads = io_threads
        old.shutdown(wait=False)
        with _live_pools_lock:
            _dying_executors[:] = [ex for ex in _dying_executors
                                   if _executor_threads_alive(ex)]
            _dying_executors.append(old)
        return io_threads

    @property
    def depth(self):
        return self._depth

    @property
    def byte_budget(self):
        return self._byte_budget

    @property
    def io_threads(self):
        return self._io_threads

    # -- scheduling ---------------------------------------------------------------------

    def schedule(self, requests):
        """Queue background reads for ``[(piece, columns), ...]``.

        Keys already queued are skipped (repeat hints are near free), the pending count
        is capped at ``depth``, and nothing is queued while the completed-unclaimed
        bytes exceed the budget. Returns the number of reads queued."""
        with self._lock:
            if self._closed or (self._byte_budget is not None
                                and self._held_bytes >= self._byte_budget):
                return 0
            capacity = self._depth - self._pending
            if capacity <= 0:
                return 0
            fresh = []
            for piece, columns in requests:
                if len(fresh) >= capacity:
                    break
                # columns as a hashable tuple once, here: the entry key AND the run key
                columns = None if columns is None else tuple(columns)
                key = request_key(piece, columns)
                if key in self._entries:
                    continue
                self._entries[key] = _Entry()
                fresh.append((piece, columns))
            self._pending += len(fresh)
            self._depth_gauge.set(self._pending)
        if not fresh:
            return 0
        submitted = set()
        try:
            runs = plan_runs(fresh, self._max_run, gap_ok=self._gap_ok) \
                if self._coalesce \
                else [([piece], columns) for piece, columns in fresh]
            for pieces, columns in runs:
                self._submit(pieces, columns)
                submitted.update(request_key(p, columns) for p in pieces)
        except BaseException:
            # roll back never-submitted registrations: an entry whose read was never
            # issued would park a later get() on an event nobody sets
            with self._lock:
                for piece, columns in fresh:
                    key = request_key(piece, columns)
                    if key not in submitted and \
                            self._entries.pop(key, None) is not None:
                        self._pending -= 1
                self._depth_gauge.set(self._pending)
            raise
        return len(fresh)

    def _submit(self, pieces, columns):
        """Submit one read to the current IO pool; a pool that apply_io_threads swapped
        out between the read of ``self._pool`` and the submit refuses it, and the read
        goes to its replacement."""
        while True:
            pool = self._pool
            try:
                pool.submit(self._read_task, pieces, columns)
                return
            except RuntimeError:
                if self._closed or self._pool is pool:
                    raise

    def _read_task(self, pieces, columns):
        with self._lock:
            self._active_reads += 1
            self._idle.clear()
        try:
            self._read_task_body(pieces, columns)
        finally:
            with self._lock:
                self._active_reads -= 1
                if self._active_reads == 0:
                    self._idle.set()

    def set_trace(self, tracer):
        """Attach a :class:`~petastorm_tpu_torch.trace.TraceRecorder`: background reads
        record ``io.readahead`` spans, foreground waits on an in-flight read ``io.wait``
        spans."""
        self._tracer = tracer

    def set_health(self, monitor):
        """Attach a health monitor (or a scope of one; None detaches): every IO thread
        heartbeats its background reads. The threads that already exist are registered
        at once, a read in flight as busy since it began."""
        self._health = monitor
        self._io_slots.attach(monitor)

    def _read_task_body(self, pieces, columns):
        name = threading.current_thread().name
        self._io_slots.begin(name)  # one slot an IO thread, reused by its later tasks
        t0 = time.perf_counter()
        tables = error = None
        try:
            from petastorm_tpu_torch import chaos as _chaos

            if _chaos.ACTIVE is not None:
                _chaos.ACTIVE.hit(
                    "io.readahead",
                    key="%s:%s" % (pieces[0].path,
                                   ",".join(str(p.row_group) for p in pieces)))
            if len(pieces) == 1:
                tables = [self._read_fn(pieces[0], columns)]
            else:
                tables = self._read_run_fn(pieces, columns)
                self._coalesced_reads.inc()
                self._coalesced_items.inc(len(pieces))
                with self._lock:
                    self._n_coalesced_reads += 1
                    self._n_coalesced_items += len(pieces)
        except Exception as e:  # noqa: BLE001 — stored, re-raised at get()
            error = e
            degradation(
                "readahead_read_failed",
                "background readahead read of %s row group(s) %s failed (%s); the "
                "foreground read will re-raise it", pieces[0].path,
                [p.row_group for p in pieces], e)
        dur = time.perf_counter() - t0
        self._read_hist.observe(dur)
        tracer = self._tracer
        if tracer is not None:
            tracer.add("io.readahead", t0, dur)
        with self._lock:
            self._read_s_cum += dur
            if not self._closed:
                # the in-flight count tracks READS, not entries: an entry a timed-out
                # waiter already dropped still finished its IO here
                self._pending -= len(pieces)
            for i, piece in enumerate(pieces):
                entry = self._entries.get(request_key(piece, columns))
                if entry is None or entry.event.is_set():
                    # shut down or abandoned while reading, or the key was abandoned
                    # (get timeout) and scheduled again and the fresh read already
                    # filled the new entry: a second fill would count its bytes twice
                    continue
                if error is not None:
                    entry.error = error
                else:
                    entry.table = tables[i]
                    entry.nbytes = getattr(tables[i], "nbytes", 0)
                    entry.read_span = (t0, dur)
                    self._held_bytes += entry.nbytes
                entry.event.set()
            self._evict_over_budget()
            self._depth_gauge.set(self._pending)
            self._bytes_gauge.set(self._held_bytes)
        self._io_slots.end(name, "idle")  # parked in the pool's queue until its next task

    def _evict_over_budget(self):
        """Age out completed, unclaimed entries; the caller holds ``self._lock``.

        Two bounds: tables past the byte budget (oldest first), and completed entries
        past a small count cap, which is what keeps abandoned entries (a stolen item's
        table, a failed read's error, whose traceback pins frames) from living forever."""
        cap = max(8, 4 * self._depth)
        for key in list(self._entries):
            over_bytes = self._byte_budget is not None \
                and self._held_bytes > self._byte_budget
            over_count = len(self._entries) > cap
            if not over_bytes and not over_count:
                break
            entry = self._entries[key]
            if entry.claimed or not entry.event.is_set():
                continue  # a getter owns it, or the read is still in flight
            if entry.table is None and not over_count:
                continue  # error entries free no bytes; only the cap drops them
            del self._entries[key]
            self._held_bytes -= entry.nbytes  # graftlint: disable=GL-C001 (callers hold self._lock: apply_depth, apply_byte_budget, the read task)
            self._n_evictions += 1  # graftlint: disable=GL-C001 (callers hold self._lock)
            self._evictions.inc()

    # -- consumption --------------------------------------------------------------------

    def get(self, piece, columns):
        """The prefetched table for ``(piece, columns)``, or ``None`` on a miss (the
        caller reads synchronously). Blocks on an in-flight read. A read that failed
        re-raises its exception; a read cancelled by shutdown, or still pending after
        ``wait_timeout_s``, returns ``None`` (synchronous fallback, counted)."""
        key = request_key(piece, columns)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry.claimed:
                self._n_misses += 1
                self._misses.inc()
                if _prov.ACTIVE is not None:
                    _prov.annotate("readahead", "miss")
                return None
            entry.claimed = True
        t0 = time.perf_counter()
        completed = entry.event.wait(self._wait_timeout_s)
        wait = time.perf_counter() - t0
        self._wait_hist.observe(wait)
        tracer = self._tracer
        if tracer is not None and wait > 1e-6:
            tracer.add("io.wait", t0, wait)
        with self._lock:
            self._wait_s_cum += wait
            self._entries.pop(key, None)
            if entry.table is not None:
                self._held_bytes -= entry.nbytes
                self._bytes_gauge.set(self._held_bytes)
                self._n_hits += 1
                self._hits.inc()
                if _prov.ACTIVE is not None:
                    # the background read (it overlapped earlier items' work: the fold
                    # charges only what was serialized) and the claimer's residual wait
                    _prov.annotate("readahead", "hit")
                    if entry.read_span is not None:
                        _prov.add_span("io.readahead", *entry.read_span)
                    if wait > 1e-6:
                        _prov.add_span("io.readahead_wait", t0, wait)
                return entry.table
        if not completed:
            # hung background read: abandon the entry (its late completion is dropped
            # above) and read synchronously
            degradation("readahead_fallback",
                        "readahead read of %s row group %d still pending after %.0fs; "
                        "reading synchronously", piece.path, piece.row_group,
                        self._wait_timeout_s)
            return None
        if isinstance(entry.error, _CancelledRead):
            degradation("readahead_fallback",
                        "readahead cancelled for %s row group %d; reading "
                        "synchronously", piece.path, piece.row_group)
            return None
        raise entry.error

    # -- lifecycle ----------------------------------------------------------------------

    def note_sync_read(self, seconds):
        """Account a miss-fallback synchronous read (timed by the worker): exposed
        latency the prefetch window failed to hide."""
        with self._lock:
            self._sync_s_cum += seconds

    def drain(self, timeout_s):
        """Wait (bounded) until no read task is executing; True when idle."""
        return self._idle.wait(timeout_s)

    def join_threads(self, timeout_s):
        """Join the IO threads (bounded): the process-exit path."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        for t in list(getattr(self._pool, "_threads", ()) or ()):
            t.join(max(0.05, deadline - time.monotonic()))

    def abandon_hung_threads(self):
        """Detach still-alive IO threads from interpreter-exit bookkeeping after a
        bounded join expired: a read hung against a wedged filesystem forfeits the
        clean-teardown guarantee instead of hanging exit (the exit drain calls this for
        every live pool)."""
        from concurrent.futures import thread as cf_thread

        _abandon_pool_threads(self._pool, cf_thread)

    def shutdown(self):
        """Cancel pending reads, release waiters, stop the IO threads. Idempotent; the
        worker calls it from ``close()`` (``Reader.join``). Does not wait for an
        in-flight read; the exit hook joins the threads before interpreter teardown."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            entries = list(self._entries.values())
            self._entries.clear()
            self._pending = 0
            self._held_bytes = 0
            self._depth_gauge.set(0)
            self._bytes_gauge.set(0)
        for entry in entries:
            if entry.table is None and entry.error is None:
                entry.error = _CancelledRead()
            entry.event.set()
        self._pool.shutdown(wait=False, cancel_futures=True)
        with _live_pools_lock:
            _dying_executors[:] = [ex for ex in _dying_executors
                                   if _executor_threads_alive(ex)]
            _dying_executors.append(self._pool)

    def stats(self):
        """The pool's gauges and counts (``Reader.io_stats()``). The keys differ from
        the registered gauge families (``readahead_held_bytes``, not
        ``readahead_bytes``): the ``io`` collector exports each key as ``ptpu_io_<key>``,
        and a collision would be a duplicate family, which scrapers reject."""
        with self._lock:
            return {
                "readahead_pending": self._pending,
                "readahead_held_bytes": self._held_bytes,
                "readahead_depth_limit": self._depth,
                "readahead_byte_budget": self._byte_budget or 0,
                "readahead_io_threads": self._io_threads,
                "readahead_read_s": round(self._read_s_cum, 4),
                "readahead_wait_s": round(self._wait_s_cum, 4),
                "readahead_exposed_s": round(self._wait_s_cum + self._sync_s_cum, 4),
                "readahead_hits": self._n_hits,
                "readahead_misses": self._n_misses,
                "readahead_evictions": self._n_evictions,
                "coalesced_reads": self._n_coalesced_reads,
                "coalesced_items": self._n_coalesced_items,
            }
