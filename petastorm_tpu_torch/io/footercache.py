"""Shared Parquet footer cache: each file's metadata is read and parsed once a process.

Port of ``petastorm_tpu.io.footercache``. Without it every worker thread's open-file
cache (``reader._WorkerBase._parquet_file``) reads and parses each file's footer on its
first touch: workers x threads x files footer reads for bytes that never change.
:class:`FooterCache` is one process-wide, byte-budgeted LRU of parsed
``pyarrow.parquet.FileMetaData`` keyed by path:

- ``_WorkerBase._parquet_file`` passes the cached metadata to
  ``pq.ParquetFile(source, metadata=...)``: pyarrow then reads no footer at open.
- The planner's footer scan (``metadata.load_row_groups``) fills the same store, so the
  statistics pruning and the workers' opens share one footer parse a file a process.
- The compressed-page pass-through classifies its columns from the cached footer, and a
  prefetch hint only peeks (never reads a footer to plan a prefetch).

Validation: an entry carries the file size seen at parse time; a later open whose
handle reports another size invalidates it (counted). A caller that knows the file's
stat identity (``<size>.<mtime_ns>``, the dataset watch of
:mod:`petastorm_tpu_torch.dataset.watch`) pins the entry to it (``stat_token=``): a parse
taken under another identity misses. A same-size rewrite that keeps the mtime too is
told apart by :func:`metadata_crc`, the footer half of a generation token
(:attr:`FooterEntry.crc`). The counters are per cache, read through
:meth:`FooterCache.stats`; the same events rise on a registry (``registry=``, the
process-wide one by default) under the JAX package's families,
``ptpu_io_footer_cache_{hits,misses,evictions,invalidations}_total`` and the gauge
``ptpu_io_footer_cache_bytes``.

Host-wide sharing: with a cache arena in the process
(:func:`petastorm_tpu_torch.io.arena.process_arena`), every footer this cache admits is
also published as its serialized thrift bytes under the key ``("ft", path)``, generation
``"sz:<file size>"``, and a local miss maps a footer another process published, parses it
once and admits it locally: a process pool reads each footer from the store once.
"""
from __future__ import annotations

import threading
import zlib
from collections import OrderedDict

from petastorm_tpu_torch.obs.metrics import default_registry


def metadata_crc(metadata):
    """crc32 of a parsed footer's layout and statistics (row counts, byte sizes, each
    column chunk's offsets and size, recorded min/max): the content half of a piece's
    generation token, the JAX package's value for the same footer. It tells apart the
    rewrite that size and mtime cannot: a file regenerated to the same length with a
    colliding mtime still moves its chunk offsets or sizes, or its statistics (two
    constant columns compress to the same layout, but their min/max differ)."""
    h = zlib.crc32(("%s|%s|%s" % (metadata.num_rows, metadata.num_row_groups,
                                  metadata.serialized_size)).encode("ascii"))
    for i in range(metadata.num_row_groups):
        rgmd = metadata.row_group(i)
        h = zlib.crc32(("%s|%s" % (rgmd.num_rows, rgmd.total_byte_size)).encode("ascii"),
                       h)
        for c in range(rgmd.num_columns):
            col = rgmd.column(c)
            h = zlib.crc32(("%s|%s|%s" % (
                col.data_page_offset, col.dictionary_page_offset,
                col.total_compressed_size)).encode("ascii"), h)
            try:
                st = col.statistics
                if st is not None and st.has_min_max:
                    h = zlib.crc32(("%r|%r" % (st.min, st.max)).encode("utf-8",
                                                                       "replace"), h)
            except Exception:  # noqa: BLE001 — exotic logical types: the layout
                pass  # graftlint: disable=GL-O002 (facts above still fold in)
    return h & 0xFFFFFFFF


#: parsed FileMetaData are a few KB to a few hundred KB (wide schemas); the default
#: budget holds ~1k typical footers
DEFAULT_BUDGET_BYTES = 64 << 20


def _host_arena():
    """This process's mapped cache arena, or None (the footer cache is a module
    singleton, so it rides the process's arena handle rather than a pickled spec)."""
    from petastorm_tpu_torch.io import arena as arena_mod

    return arena_mod.process_arena()


def _arena_gen(size, stat_token):
    """The arena generation of a footer blob: the stat identity when known, else the
    file size (the validation :meth:`FooterCache.lookup` applies locally)."""
    if stat_token is not None:
        return "st:%s" % (stat_token,)
    if size is not None:
        return "sz:%d" % int(size)
    return None


def _serialize_metadata(metadata):
    """The footer's thrift bytes (what ``pq.read_metadata`` parses), or None: a
    footer that does not serialize stays process-local."""
    try:
        import pyarrow as pa

        sink = pa.BufferOutputStream()
        metadata.write_metadata_file(sink)
        return sink.getvalue().to_pybytes()
    except Exception:  # noqa: BLE001 — exotic metadata: stay local
        return None


def _parse_metadata_blob(blob):
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq

        return pq.read_metadata(pa.BufferReader(blob))
    except Exception:  # noqa: BLE001 — a torn or foreign blob reads as a miss
        return None


class FooterEntry:
    """One cached footer: the parsed metadata plus derived planning facts."""

    __slots__ = ("metadata", "size", "nbytes", "num_row_groups", "row_group_rows",
                 "_spans", "stat_token", "_crc")

    def __init__(self, metadata, size, stat_token=None):
        self.metadata = metadata
        self.size = int(size) if size is not None else None
        #: the file's stat identity (``<size>.<mtime_ns>``) when the caller offered one
        #: (the dataset watch); None: size-only validation
        self.stat_token = stat_token
        self._crc = None
        # the serialized thrift size stands for the resident parse size
        try:
            self.nbytes = int(metadata.serialized_size) or 4096
        except Exception:  # noqa: BLE001 - the budget is a guardrail, not an allocator
            self.nbytes = 4096
        self.num_row_groups = metadata.num_row_groups
        self.row_group_rows = tuple(
            metadata.row_group(i).num_rows for i in range(self.num_row_groups))
        self._spans = None

    def row_group_span(self, rg):
        """``(start, end)`` byte span of one row group's column chunks: the unit the
        row-group run planner's byte-gap bridging reasons about."""
        if self._spans is None:
            spans = []
            for i in range(self.num_row_groups):
                rgmd = self.metadata.row_group(i)
                start = None
                end = 0
                for c in range(rgmd.num_columns):
                    col = rgmd.column(c)
                    first = col.data_page_offset
                    if col.dictionary_page_offset is not None:
                        first = min(first, col.dictionary_page_offset)
                    start = first if start is None else min(start, first)
                    end = max(end, first + col.total_compressed_size)
                spans.append((start or 0, end))
            self._spans = tuple(spans)
        return self._spans[rg]

    @property
    def crc(self):
        """:func:`metadata_crc` of this entry's footer (computed once)."""
        if self._crc is None:
            self._crc = metadata_crc(self.metadata)
        return self._crc


class FooterCache:
    """Process-wide byte-budgeted LRU of parsed Parquet footers.

    One instance a process (module-level, like the memcache store): pool children each
    build their own on first use. ``clear()`` releases the held bytes."""

    def __init__(self, budget_bytes=DEFAULT_BUDGET_BYTES, registry=None):
        self._lock = threading.Lock()
        self._entries = OrderedDict()  # path -> FooterEntry
        self._total = 0
        self._budget = max(0, int(budget_bytes))
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._invalidations = 0
        reg = registry if registry is not None else default_registry()
        self._hits_total = reg.counter(
            "ptpu_io_footer_cache_hits_total",
            help="ParquetFile opens served a cached parsed footer")
        self._misses_total = reg.counter(
            "ptpu_io_footer_cache_misses_total",
            help="footer reads+parses that went to storage")
        self._evictions_total = reg.counter(
            "ptpu_io_footer_cache_evictions_total",
            help="parsed footers dropped for budget")
        self._invalidations_total = reg.counter(
            "ptpu_io_footer_cache_invalidations_total",
            help="cached footers dropped because the file changed size")
        self._bytes_gauge = reg.gauge(
            "ptpu_io_footer_cache_bytes", help="parsed footer bytes held")

    def lookup(self, path, size=None, stat_token=None):
        """The cached :class:`FooterEntry` for ``path``, or ``None`` (a miss).

        ``size`` (the file's current length, free from an open handle) validates the
        entry; a mismatch invalidates it. ``stat_token`` validates harder: an entry
        parsed under another stat identity, or under none, misses."""
        with self._lock:
            entry = self._entries.get(path)
            stale = False
            if entry is not None and size is not None \
                    and entry.size is not None and entry.size != int(size):
                stale = True
            if entry is not None and stat_token is not None \
                    and entry.stat_token != stat_token:
                stale = True
            if stale:
                del self._entries[path]
                self._total -= entry.nbytes
                self._bytes_gauge.set(self._total)
                self._invalidations += 1
                self._invalidations_total.inc()
                entry = None
            if entry is None:
                self._misses += 1
                self._misses_total.inc()
                return None
            self._entries.move_to_end(path)
            self._hits += 1
            self._hits_total.inc()
            return entry

    def peek(self, path):
        """The cached entry without counting a hit or a miss and without validation
        (callers with no handle to validate against: a prefetch plan, the byte-gap
        predicate). Bumps LRU recency."""
        with self._lock:
            entry = self._entries.get(path)
            if entry is not None:
                self._entries.move_to_end(path)
            return entry

    def count_hit(self):
        """Counter hook for callers composing :meth:`peek` into their own hit and miss
        protocol (the remote engine's footer plane)."""
        with self._lock:
            self._hits += 1
        self._hits_total.inc()

    def count_miss(self):
        with self._lock:
            self._misses += 1
        self._misses_total.inc()

    def from_arena(self, path, size=None, stat_token=None):
        """The footer of ``path`` mapped from the host-wide arena (another process
        parsed it), parsed once and admitted here without publishing it back; ``None``
        when the arena holds no footer of this generation."""
        arena_obj = _host_arena()
        if arena_obj is None:
            return None
        blob = arena_obj.get_bytes(("ft", path), gen=_arena_gen(size, stat_token))
        if blob is None:
            return None
        metadata = _parse_metadata_blob(blob)
        if metadata is None:
            return None
        return self.put(path, metadata, size, stat_token=stat_token, _share=False)

    def invalidate(self, path):
        """Drop the entry for ``path`` (the file may have been replaced), here and in
        the host-wide arena, so no process maps the replaced file's footer."""
        with self._lock:
            entry = self._entries.pop(path, None)
            if entry is not None:
                self._total -= entry.nbytes
                self._bytes_gauge.set(self._total)
                self._invalidations += 1
                self._invalidations_total.inc()
        arena_obj = _host_arena()
        if arena_obj is not None:
            arena_obj.invalidate(("ft", path))

    def put(self, path, metadata, size=None, stat_token=None, _share=True):
        """Admit a parsed footer; returns its :class:`FooterEntry`. A footer larger
        than the whole budget is returned to the caller uncached. Unless the footer
        just came from the arena (``_share=False``), its serialized bytes are also
        published host-wide."""
        if _share:
            arena_obj = _host_arena()
            if arena_obj is not None:
                blob = _serialize_metadata(metadata)
                if blob is not None:
                    arena_obj.put_bytes(("ft", path), blob,
                                        gen=_arena_gen(size, stat_token))
        entry = FooterEntry(metadata, size, stat_token=stat_token)
        with self._lock:
            old = self._entries.pop(path, None)
            if old is not None:
                self._total -= old.nbytes
            if self._budget and entry.nbytes > self._budget:
                self._bytes_gauge.set(self._total)
                return entry
            self._entries[path] = entry
            self._total += entry.nbytes
            while self._budget and self._total > self._budget and \
                    len(self._entries) > 1:
                _, evicted = self._entries.popitem(last=False)
                self._total -= evicted.nbytes
                self._evictions += 1
                self._evictions_total.inc()
            self._bytes_gauge.set(self._total)
        return entry

    def get(self, fs, path, source=None, stat_token=None):
        """The footer for ``path``: cached, or read and parsed from ``source`` (an open
        pyarrow input file, whose ``size()`` is the validation token) or from a fresh
        ``fs.open_input_file``."""
        size = None
        if source is not None:
            try:
                size = source.size()
            except Exception:  # noqa: BLE001 - the validation token is best effort
                size = None
        entry = self.lookup(path, size, stat_token=stat_token)
        if entry is not None:
            return entry
        # another process on the host may have parsed this footer: map its bytes
        entry = self.from_arena(path, size, stat_token=stat_token)
        if entry is not None:
            return entry
        import pyarrow.parquet as pq

        if source is not None:
            pos = source.tell()
            metadata = pq.read_metadata(source)
            source.seek(pos)
        else:
            with fs.open_input_file(path) as f:
                size = f.size()
                metadata = pq.read_metadata(f)
        return self.put(path, metadata, size, stat_token=stat_token)

    def contains(self, path):
        with self._lock:
            return path in self._entries

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._total = 0
            self._bytes_gauge.set(0)

    def stats(self):
        with self._lock:
            return {
                "footer_cache_entries": len(self._entries),
                "footer_cache_held_bytes": self._total,
                "footer_cache_hits": self._hits,
                "footer_cache_misses": self._misses,
                "footer_cache_evictions": self._evictions,
                "footer_cache_invalidations": self._invalidations,
            }


_shared_lock = threading.Lock()
_shared = None


def shared_footer_cache():
    """The process-wide cache (created on first use; budget raised on demand by
    :func:`configure_budget`)."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = FooterCache()
        return _shared


def configure_budget(budget_bytes):
    """Raise the shared cache's budget (never lowers it: readers share the cache, as
    they share the memcache store's raise-only budget)."""
    cache = shared_footer_cache()
    with cache._lock:
        if budget_bytes > cache._budget:
            cache._budget = int(budget_bytes)
    return cache
