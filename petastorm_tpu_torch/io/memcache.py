"""Process-wide in-memory row-group LRU: hot row groups skip the read AND the decode.

Port of ``petastorm_tpu.io.memcache``. ``LocalDiskCache`` removes the store read on a
re-epoch but still pays a file read and an unpickle a hit. :class:`MemCache` keeps the
decoded payloads (the worker's row lists or column dicts) in one process-wide,
byte-budgeted LRU keyed by the reader's ``_cache_key``, which already encodes path, row
group, schema fields, predicate, filters, row-drop partition and device staging, so an
entry is never served to a mismatched read. For a ``decode_on_device`` JPEG store the
payload is the row group's stage-1 output: a re-epoch served from memory skips both
the read and stage 1.

Layering: ``MemCache`` wraps any :class:`petastorm_tpu_torch.cache.CacheBase` (the disk
cache or the null cache); a miss falls through to the inner cache's ``get`` and the
decoded value is admitted on the way back up.

Serving contract: entries are stored read-only under a per-entry
:class:`petastorm_tpu_torch.io.lease.Lease` (accounting: acquired at admit, released at
eviction or ``clear()``), and both the miss and the hit path hand out zero-copy
read-only views (fresh containers, shared buffers). A consumer that writes into a served
batch gets ``ValueError: assignment destination is read-only``, never a poisoned cache.
Staged JPEG rows (:class:`~petastorm_tpu_torch.ops.jpeg.JpegPlanes`) are frozen in
place at admit: their coefficient blocks, tables and their row group's stacked buffers
(``batch_ref``) become read-only, so the loader's packers, which only read them, can
never write into an entry. The one consumer that legitimately writes, an opaque host
``TransformSpec``, escalates through :meth:`MemCache.get_writable` (copy on write,
charged to the ``memcache_cow`` copy-census site); ``writable_hits=True`` makes every
serve a writable deep copy.

A payload is admitted in the process that decoded it (a pool child caches in its own
store, before its result is serialized), so a cached ``batch_ref`` never points into a
pool slab.

Sizing (:func:`payload_nbytes`) counts a staged JPEG row's coefficient bytes: its
blocks, or its row group's stacked buffers once when the row views them. The JAX
package sizes such a row with ``sys.getsizeof`` of the dataclass (ROADMAP.md Queue 3 M:
its budget does not bound a device-decode store); the port does not copy that.

Entries larger than the whole budget are served uncached (degradation
``memcache_oversized``). The counters are the store's, read through
:meth:`MemCache.stats`; ``Reader.io_stats()`` carries them, and a
``DataLoader(metrics=...)`` exports them as ``ptpu_io_*`` (its ``io`` collector). The
same events rise on the process-wide registry under the JAX package's families,
``ptpu_io_memcache_{hits,misses,evictions}_total`` and the gauge
``ptpu_io_memcache_bytes``.

The host-wide tier: ``arena=`` (an :class:`~petastorm_tpu_torch.io.arena.ArenaSpec` or a
live ``CacheArena``) layers the shared cache arena between this process's store and the
inner cache. A local miss maps a peer's entry as zero-copy read-only views pinned by
the arena holder lease (``kind="arena"``, held by the local entry and released when it
drops), and a real fill is admitted host-wide on the way up, so every other process on
the host serves it without reading or decoding it again.
"""
from __future__ import annotations

import sys
import threading
from collections import OrderedDict

import numpy as np

from petastorm_tpu_torch.cache import CacheBase, NullCache
from petastorm_tpu_torch.io.lease import Lease, count_copy, readonly_view
from petastorm_tpu_torch.obs.metrics import default_registry
from petastorm_tpu_torch.parallel.shm_ring import degradation


def _is_planes(value):
    """Duck-typed :class:`~petastorm_tpu_torch.ops.jpeg.JpegPlanes` (this module must
    not import the JPEG ops: pool children import it)."""
    return hasattr(value, "components") and hasattr(value, "batch_ref")


def _planes_nbytes(value, seen):
    """Coefficient bytes of one staged JPEG row: its row group's stacked buffers once
    (``seen`` holds the ids already counted) when it views them, else its own blocks
    and tables."""
    ref = value.batch_ref
    if ref is not None:
        coeffs, qtabs = ref[0], ref[1]
        if id(coeffs) in seen:
            return 0
        seen.add(id(coeffs))
        return sum(int(c.nbytes) for c in coeffs) + int(getattr(qtabs, "nbytes", 0))
    return sum(int(c.blocks.nbytes) + int(np.asarray(c.qtable).nbytes)
               for c in value.components)


def payload_nbytes(value, _seen=None):
    """Byte estimate of a worker payload (column dict, row list, pyarrow table, ndarray,
    scalars, staged JPEG rows): exact for ndarrays, bytes and tables, the coefficient
    bytes for staged JPEG rows, ``sys.getsizeof`` for the rest. The budget is a
    guardrail, not an allocator."""
    if isinstance(value, np.ndarray):
        if value.dtype == object:
            seen = set() if _seen is None else _seen
            return int(value.nbytes) + sum(payload_nbytes(v, seen) for v in value.flat)
        return int(value.nbytes)
    if isinstance(value, (bytes, bytearray, memoryview)):
        return len(value)
    if isinstance(value, dict):
        seen = set() if _seen is None else _seen
        return sum(payload_nbytes(v, seen) for v in value.values()) + 64 * len(value)
    if isinstance(value, (list, tuple)):
        seen = set() if _seen is None else _seen
        return sum(payload_nbytes(v, seen) for v in value) + 16 * len(value)
    if _is_planes(value):
        return _planes_nbytes(value, set() if _seen is None else _seen)
    nbytes = getattr(value, "nbytes", None)  # pyarrow.Table and friends
    if isinstance(nbytes, int):
        return nbytes
    return sys.getsizeof(value)


def _copied_nbytes(value):
    """Buffer bytes a deep copy of ``value`` copies (the copy census's measure)."""
    if isinstance(value, np.ndarray):
        if value.dtype == object:
            return sum(_copied_nbytes(v) for v in value.flat)
        return int(value.nbytes)
    if isinstance(value, (bytes, bytearray, memoryview)):
        return len(value)
    if isinstance(value, dict):
        return sum(_copied_nbytes(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(_copied_nbytes(v) for v in value)
    if _is_planes(value):
        return sum(int(c.blocks.nbytes) for c in value.components)
    return 0


#: leaves _defensive_copy passes through untouched (immutable, or numpy scalars)
_IMMUTABLE_LEAVES = (bytes, str, int, float, complex, bool, type(None), np.generic)


def _defensive_copy(value):
    """Fresh containers and copied ndarrays, so a consumer writing into its batch can
    never corrupt the cached original: the copy-on-write escalation
    (``get_writable``, ``writable_hits=True``). Plain ndarrays take one ``copy()``; the
    elements of object arrays (ragged rows, staged JPEG rows) are copied one by one,
    since an outer copy alone would leave them aliased."""
    if isinstance(value, np.ndarray):
        if value.dtype != object:
            return value.copy()
        out = np.empty(value.shape, dtype=object)
        out_flat, in_flat = out.reshape(-1), value.reshape(-1)
        for i in range(in_flat.size):
            e = in_flat[i]
            if type(e) is np.ndarray and e.dtype != object:
                out_flat[i] = e.copy()
            elif isinstance(e, _IMMUTABLE_LEAVES):
                out_flat[i] = e
            else:
                out_flat[i] = _defensive_copy(e)
        return out
    if isinstance(value, dict):
        return {k: _defensive_copy(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_defensive_copy(v) for v in value]
    if isinstance(value, tuple):
        return tuple(_defensive_copy(v) for v in value)
    if _is_planes(value):
        # an owned, writable copy of the row, outside its row group's buffers
        comps = [type(c)(c.blocks.copy(), np.array(c.qtable), c.h_samp, c.v_samp)
                 for c in value.components]
        specmax = value.specmax
        return type(value)(value.height, value.width, comps, batch_ref=None,
                           kmax=value.kmax,
                           specmax=specmax.copy() if isinstance(specmax, np.ndarray)
                           else specmax)
    return value


def _freeze_planes(value):
    """Make a staged JPEG row's buffers read-only in place (its blocks and tables, and
    its row group's stacked buffers). Rows of one row group keep sharing one
    ``batch_ref``, so the packers' row-group runs stay whole."""
    ref = value.batch_ref
    if ref is not None:
        for arr in tuple(ref[0]) + (ref[1],):
            if isinstance(arr, np.ndarray):
                arr.flags.writeable = False
    for c in value.components:
        c.blocks.flags.writeable = False
        if isinstance(c.qtable, np.ndarray):
            c.qtable.flags.writeable = False


def _freeze(value):
    """The stored form of a payload: read-only views of every ndarray (fresh
    containers) with staged JPEG rows frozen in place."""
    def walk(v):
        if isinstance(v, np.ndarray) and v.dtype == object:
            for e in v.flat:
                walk(e)
        elif isinstance(v, dict):
            for e in v.values():
                walk(e)
        elif isinstance(v, (list, tuple)):
            for e in v:
                walk(e)
        elif _is_planes(v):
            _freeze_planes(v)

    walk(value)
    return readonly_view(value)


class _Store:
    """The process-wide LRU: an OrderedDict and byte accounting under one lock. Entries
    are ``(frozen_value, nbytes, lease)``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = OrderedDict()  # key -> (value, nbytes, lease)
        self._total = 0
        self._budget = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        reg = default_registry()
        self._hits_total = reg.counter("ptpu_io_memcache_hits_total",
                                       help="row-group reads served from memory")
        self._misses_total = reg.counter("ptpu_io_memcache_misses_total",
                                         help="memcache misses (fell through to the "
                                              "inner cache / a real read)")
        self._evictions_total = reg.counter("ptpu_io_memcache_evictions_total",
                                            help="entries LRU-evicted for budget")
        self._bytes_gauge = reg.gauge("ptpu_io_memcache_bytes",
                                      help="decoded payload bytes held in memory")

    def raise_budget(self, budget):
        with self._lock:
            if budget > self._budget:
                self._budget = budget

    def set_budget(self, budget):
        """Move the store's ceiling, down too (a live retune): a shrink evicts
        oldest-first down to the new budget at once. Served views stay valid; the
        evicted entries' leases release as at any eviction."""
        evicted = []
        with self._lock:
            self._budget = max(0, int(budget))
            while self._total > self._budget and self._entries:
                _, (_, old_bytes, old_lease) = self._entries.popitem(last=False)
                self._total -= old_bytes
                self._evictions += 1
                self._evictions_total.inc()
                evicted.append(old_lease)
            self._bytes_gauge.set(self._total)
        for lease in evicted:
            lease.release()

    @property
    def budget(self):
        with self._lock:
            return self._budget

    def lookup(self, key):
        """``(hit, stored_value)``: the stored read-only structure; the caller picks
        the serve shape (views or a copy-on-write copy)."""
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self._misses += 1
                self._misses_total.inc()
                return False, None
            self._entries.move_to_end(key)
            self._hits += 1
            self._hits_total.inc()
            return True, hit[0]

    def contains(self, key):
        with self._lock:
            return key in self._entries

    def invalidate(self, key):
        """Drop one entry (outstanding served views stay valid: numpy refcounting keeps
        the buffers; the lease is accounting)."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._total -= entry[1]
                self._bytes_gauge.set(self._total)
        if entry is not None:
            entry[2].release()

    def put(self, key, value, nbytes=None, lease=None):
        """Admit ``value`` (already frozen by the caller; ``nbytes`` its
        :func:`payload_nbytes` when known); True when stored. Stored and served buffers
        may be shared: both are read-only.

        ``lease`` is a pin owned elsewhere (the arena holder lease of a shm-backed
        entry): the store releases it at eviction or ``clear()`` like its own
        accounting lease, so the arena entry stays unevictable host-wide while this
        store holds views of it. The caller keeps it when put returns False."""
        if nbytes is None:
            nbytes = payload_nbytes(value)
        evicted = []
        with self._lock:
            oversized = nbytes > self._budget
            if not oversized:
                old = self._entries.pop(key, None)
                if old is not None:
                    self._total -= old[1]
                    evicted.append(old[2])
                self._entries[key] = (value, nbytes,
                                      lease if lease is not None else Lease(kind="memcache"))
                self._total += nbytes
                while self._total > self._budget and self._entries:
                    _, (_, old_bytes, old_lease) = self._entries.popitem(last=False)
                    self._total -= old_bytes
                    self._evictions += 1
                    self._evictions_total.inc()
                    evicted.append(old_lease)
                self._bytes_gauge.set(self._total)
        for lease in evicted:
            lease.release()  # accounting: evicted buffers live on in served views
        if oversized:
            degradation(
                "memcache_oversized",
                "decoded row group of %d bytes exceeds the whole memcache budget (%d); "
                "serving uncached", nbytes, self._budget)
        return not oversized

    def clear(self):
        with self._lock:
            entries, self._entries = self._entries, OrderedDict()
            self._total = 0
            self._bytes_gauge.set(0)
        for _value, _nbytes, lease in entries.values():
            lease.release()

    def stats(self):
        # "held_bytes", not "bytes": the io collector exports each key as
        # ptpu_io_<key>, which must not collide with the ptpu_io_memcache_bytes family
        with self._lock:
            return {
                "memcache_entries": len(self._entries),
                "memcache_held_bytes": self._total,
                "memcache_budget_bytes": self._budget,
                "memcache_hits": self._hits,
                "memcache_misses": self._misses,
                "memcache_evictions": self._evictions,
            }


_store_lock = threading.Lock()
_store = None


def shared_store():
    """The process-wide store (created on first use)."""
    global _store
    with _store_lock:
        if _store is None:
            _store = _Store()
        return _store


class MemCache(CacheBase):
    """Byte-budgeted in-memory LRU over decoded row-group payloads, in front of an inner
    cache (:class:`~petastorm_tpu_torch.cache.LocalDiskCache` or ``NullCache``).

    Instances are thin picklable views onto the process-wide store (each pool child
    builds its own store on first use); the budget is the largest any instance asked
    for. ``get`` serves zero-copy read-only views, ``get_writable`` is the
    copy-on-write escalation, ``writable_hits=True`` deep-copies every serve (same
    values either way; only mutability and copies differ). ``clear()`` releases the
    store's bytes.

    ``arena=`` adds the host-wide tier (module docstring). The spec is picklable, so a
    pool child carries it in the worker's pickle; it resolves to a mapped arena lazily,
    in each process."""

    def __init__(self, size_limit_bytes, inner=None, store=None, writable_hits=False,
                 arena=None):
        if not size_limit_bytes or int(size_limit_bytes) <= 0:
            raise ValueError("MemCache needs a positive size_limit_bytes; use the inner "
                             "cache alone to disable it")
        self._budget = int(size_limit_bytes)
        self._inner = inner if inner is not None else NullCache()
        self._writable_hits = bool(writable_hits)
        #: a private store (tests needing isolation from the shared store's raise-only
        #: budget); dropped on pickling, so the unpickled instance uses the shared one
        self._private_store = store
        if arena is None:
            self._arena_spec, self._arena_obj = None, None
        elif hasattr(arena, "token"):  # an ArenaSpec
            self._arena_spec, self._arena_obj = arena, None
        else:  # a live CacheArena (thread pools, the creating reader)
            self._arena_spec, self._arena_obj = arena.spec, arena

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_private_store"] = None
        state["_arena_obj"] = None  # a child resolves the spec itself
        return state

    def _arena(self):
        """This process's mapped arena, or None (resolved lazily; an arena that does
        not attach degrades once inside ``arena.resolve``)."""
        if self._arena_spec is None:
            return None
        obj = self._arena_obj
        if obj is not None and not obj._closed:
            return obj
        from petastorm_tpu_torch.io import arena as arena_mod

        obj = self._arena_obj = arena_mod.resolve(self._arena_spec)
        return obj

    def _store(self):
        store = self._private_store if self._private_store is not None \
            else shared_store()
        store.raise_budget(self._budget)
        return store

    def get(self, key, fill_cache_func, served=None):
        """Zero-copy serve: hits and the admit path hand out fresh containers over the
        stored read-only buffers; only an oversized (uncached) value passes through
        writable. ``served`` (a one-slot list, the tiered funnel's attribution) is set
        to ``"arena"`` when the payload came off the host-wide arena."""
        origin, value = self._fetch(key, fill_cache_func)
        if served is not None and origin in ("arena", "arena_uncached"):
            served[0] = "arena"
        if self._writable_hits:
            copy = _defensive_copy(value)
            count_copy("memcache_hit" if origin == "mem" else "memcache_admit",
                       _copied_nbytes(copy))
            return copy
        if origin == "uncached":
            return value  # oversized fill: uncached, nothing aliases it
        return readonly_view(value)

    def _fetch(self, key, fill_cache_func):
        """``(origin, stored_value)``: the funnel of this store, the host-wide arena,
        then the inner cache or a real fill (admitted back up both). ``mem`` a local
        hit; ``arena`` mapped from the arena and admitted locally; ``arena_uncached``
        mapped, but the local store declined (the views stay valid: a mapping outlives
        its name); ``fill`` decoded and admitted; ``uncached`` decoded but oversized."""
        store = self._store()
        hit, value = store.lookup(key)
        if hit:
            return "mem", value
        arena_obj = self._arena()
        if arena_obj is not None:
            got = arena_obj.get(("mc", key))
            if got is not None:
                value, lease = got
                if store.put(key, value, lease=lease):
                    return "arena", value
                lease.release()
                return "arena_uncached", value
        value = self._inner.get(key, fill_cache_func)
        nbytes = payload_nbytes(value)
        if nbytes > store.budget:
            # counts the oversized degradation and stores nothing; the value is not
            # frozen: nothing else aliases it
            store.put(key, value, nbytes)
            if arena_obj is not None:
                arena_obj.put(("mc", key), value)
            return "uncached", value
        frozen = _freeze(value)
        if arena_obj is not None:
            arena_obj.put(("mc", key), frozen)
        if not store.put(key, frozen, nbytes):
            return "uncached", value
        return "fill", frozen

    def get_writable(self, key, fill_cache_func, served=None):
        """Copy-on-write escalation: a consumer that will write (an opaque host
        ``TransformSpec``) gets an owned writable deep copy of the entry, charged to
        the ``memcache_cow`` copy-census site."""
        origin, value = self._fetch(key, fill_cache_func)
        if served is not None and origin in ("arena", "arena_uncached"):
            served[0] = "arena"
        if origin == "uncached":
            return value  # oversized: uncached and unaliased, already owned
        copy = _defensive_copy(value)
        count_copy("memcache_cow", _copied_nbytes(copy))
        return copy

    def apply_budget(self, size_limit_bytes):
        """Retune the budget live (the controller's hot-row-group lever): a larger
        budget keeps more decoded row groups resident, a smaller one evicts down at
        once. Moves this instance's budget and the store's ceiling: the store is
        process-wide, so every MemCache over it sees the retune."""
        size_limit_bytes = max(1, int(size_limit_bytes))
        self._budget = size_limit_bytes
        store = self._private_store if self._private_store is not None \
            else shared_store()
        store.set_budget(size_limit_bytes)
        return size_limit_bytes

    @property
    def budget(self):
        return self._budget

    def would_admit(self, value):
        """Will the admit path store ``value``? False for oversized payloads: the
        tiered funnel's admission policy must not assume the mem tier holds them."""
        return payload_nbytes(value) <= self._budget

    def contains(self, key):
        """Will :meth:`get` serve ``key`` without a fill? The host-wide arena counts: a
        readahead hint must not read from the store what a peer already admitted (the
        JAX package's memcache asks only its own store and the inner cache)."""
        if self._store().contains(key) or self._inner.contains(key):
            return True
        arena_obj = self._arena()
        return arena_obj is not None and arena_obj.contains(("mc", key))

    def invalidate(self, key):
        """Drop ``key`` from every layer, the host-wide arena included, so no process
        on the host maps the stale payload again."""
        self._store().invalidate(key)
        arena_obj = self._arena()
        if arena_obj is not None:
            arena_obj.invalidate(("mc", key))
        self._inner.invalidate(key)

    def clear(self):
        """Release the process-wide store's entries (shared across instances)."""
        self._store().clear()

    def stats(self):
        return self._store().stats()

    def cleanup(self):
        self.clear()
        self._inner.cleanup()
