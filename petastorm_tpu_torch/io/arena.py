"""Host-wide zero-copy cache arena: one mapped warm set shared by every process.

Port of ``petastorm_tpu.io.arena``. Without it every pool child warms its own
:class:`~petastorm_tpu_torch.io.footercache.FooterCache`,
:class:`~petastorm_tpu_torch.io.memcache.MemCache` and
:class:`~petastorm_tpu_torch.io.pagedec.PageIndexCache`, so a host running N decode
workers pays N times the parse cost, the resident bytes and the cold start for one warm
set. The arena puts the hot bytes in ONE set of named shared-memory segments and makes
the per-process caches views that map instead of copy:

- One **creator** process (the first reader to ask, :func:`host_arena`) owns a small
  fixed-size **control segment** holding a pickled byte-budgeted LRU index (``{key ->
  (segment name, nbytes, generation, LRU tick, per-pid holder refcounts)}``) and one
  shm segment a cached entry.
- **Attachers** (pool children at bootstrap through :func:`attach_from_env`, or any
  process handed a picklable :class:`ArenaSpec`) map the same segments; admissions and
  evictions go through the control segment under a cross-process ``fcntl.flock``
  (taken after a per-process ``threading`` lock, in that order everywhere).
- Every serve is a **zero-copy read-only view** over the mapped entry segment pinned by
  a :class:`~petastorm_tpu_torch.io.lease.Lease` of ``kind="arena"`` (the lease census,
  ``io.lease.active_leases_by_kind()``, counts them). The per-pid holder refcount keeps
  an entry unevictable while ANY process holds it; :meth:`CacheArena.reclaim` drops the
  refcounts of dead pids (a killed child).
- **Generations** validate entries: a ``get`` under another generation invalidates and
  misses, so a rewritten file never serves its predecessor's bytes.
- Admission pays ONE copy into shm (the ``arena_admit`` site of the copy census); a
  serve copies nothing.

Unlinking a segment removes its NAME, never existing mappings, so peers' live views
survive any eviction or invalidation without a coherence protocol.

The payload codec splits a cached value into a picklable meta tree and one blob of
ndarray slots. A row group of staged JPEG rows
(:class:`~petastorm_tpu_torch.ops.jpeg.JpegPlanes`, the ``decode_on_device`` memcache
payload) is encoded by its shared buffers: the row group's stacked coefficients and
quantisation tables become blob slots once, and a serve rebuilds its rows as read-only
views into the mapping that share one ``batch_ref``, so the packers take the row group
as one run. (The JAX package pickles each such row whole and copies it at every serve:
ROADMAP.md records the port's encoding as a divergence by design.)

The segments are the port's own (prefix ``ptpu_torch_arena_``, attach variable
``PTPU_TORCH_ARENA_ATTACH``), so a JAX-package reader and a port reader on one host never
map each other's entries. ``PTPU_ARENA=off`` is the kill switch of both.

Degradations (never a raise on the read path, counted by
``parallel.shm_ring.degradation_counts()``): ``arena_unavailable`` (no shm or flock, a
failed create or attach, ``PTPU_ARENA=off``) keeps the per-process caches;
``arena_full`` declines an admission; ``arena_lease_revoked`` counts the holder
refcounts reclaimed from dead processes. The counts are this process's
(:func:`arena_counters`); each also rises on the process-wide registry under the JAX
package's families (``ptpu_io_arena_{hits,misses,admits,evictions,invalidations,
attaches}_total``, ``ptpu_io_arena_holders_revoked_total``), beside the gauges
``ptpu_io_arena_bytes`` and ``ptpu_io_arena_entries`` of the index this process last
wrote.
"""
from __future__ import annotations

import atexit
import contextlib
import os
import pickle
import struct
import tempfile
import threading
import zlib

import numpy as np

from petastorm_tpu_torch.io.lease import Lease, count_copy
from petastorm_tpu_torch.obs import tenant as _tenant
from petastorm_tpu_torch.parallel.shm_ring import degradation

#: /dev/shm segment name prefix (the tests' leak checks glob it)
ARENA_PREFIX = "ptpu_torch_arena_"

_CTL_MAGIC = b"PTAC"
_ENTRY_MAGIC = b"PTAE"
_HEADER = struct.Struct("<4sQ")  # magic, payload length
_ALIGN = 64  # ndarray blob slots align to cache lines (clean dtype views)

#: default control-segment size: holds the pickled index of a few thousand entries;
#: admission degrades (``arena_full``) when the index outgrows it
DEFAULT_CTL_BYTES = 1 << 20

#: byte-range stripes of the single-flight lock file (one record lock a stripe)
_FLIGHT_STRIPES = 4096


class ArenaSpec:
    """Picklable attach handle: everything a process needs to map an existing arena
    (segment names derive from the token). Rides worker pickles and ``ENV_ATTACH``."""

    __slots__ = ("token",)

    def __init__(self, token):
        self.token = str(token)

    def __repr__(self):
        return "ArenaSpec(%r)" % self.token

    def __eq__(self, other):
        return isinstance(other, ArenaSpec) and other.token == self.token

    def __hash__(self):
        return hash(self.token)


# -- zero-copy payload codec -----------------------------------------------------------
#
# A cached payload (column dict, row list, nested containers) splits into a picklable
# META tree, with ndarrays replaced by _ND placeholders, and one BLOB of ndarray slots.
# Decode rebuilds the tree with read-only np.frombuffer views over the mapped blob:
# fresh containers, shared buffers. An ndarray met twice in one payload (by identity) is
# one slot; pickle keeps the meta's shared placeholders shared, and the decode memo
# turns each into one view, so shared buffers stay shared after a round trip.


class _ND:
    """Placeholder of one non-object ndarray in the meta tree."""

    __slots__ = ("dtype", "shape", "off", "nbytes")

    def __init__(self, dtype, shape, off, nbytes):
        self.dtype = dtype
        self.shape = shape
        self.off = off
        self.nbytes = nbytes

    def __reduce__(self):
        return (_ND, (self.dtype, self.shape, self.off, self.nbytes))


class _NDObj:
    """Placeholder of an object-dtype ndarray: its shape and encoded elements."""

    __slots__ = ("shape", "elems")

    def __init__(self, shape, elems):
        self.shape = shape
        self.elems = elems

    def __reduce__(self):
        return (_NDObj, (self.shape, self.elems))


class _PlanesGroup:
    """A staged JPEG row group's shared buffers: the stacked coefficients (one _ND a
    component) and the quantisation tables (_ND). One instance a row group, shared by
    its rows' _Planes in the meta tree."""

    __slots__ = ("coeffs", "qtabs")

    def __init__(self, coeffs, qtabs):
        self.coeffs = coeffs
        self.qtabs = qtabs

    def __reduce__(self):
        return (_PlanesGroup, (self.coeffs, self.qtabs))


class _Planes:
    """One staged JPEG row. ``group`` is its row group's _PlanesGroup and ``row`` its
    index there, with ``layout`` ``[(h_samp, v_samp, blocks_y, blocks_x)]`` a
    component; or ``group`` is None and ``own`` holds ``[(blocks _ND, qtable _ND,
    h_samp, v_samp)]`` (a row staged on its own)."""

    __slots__ = ("height", "width", "group", "row", "layout", "own", "kmax", "specmax")

    def __init__(self, height, width, group, row, layout, own, kmax, specmax):
        self.height = height
        self.width = width
        self.group = group
        self.row = row
        self.layout = layout
        self.own = own
        self.kmax = kmax
        self.specmax = specmax

    def __reduce__(self):
        return (_Planes, (self.height, self.width, self.group, self.row, self.layout,
                          self.own, self.kmax, self.specmax))


def _is_planes(value):
    """Duck-typed :class:`~petastorm_tpu_torch.ops.jpeg.JpegPlanes` (this module must
    not import the JPEG ops at import time)."""
    return hasattr(value, "components") and hasattr(value, "batch_ref")


def _encode_payload(value):
    """``(meta, parts, blob_len)``: ``parts`` is ``[(offset, contiguous ndarray)]`` to
    copy into the entry segment's blob region."""
    parts = []
    state = [0]  # running blob offset
    slots = {}   # id(ndarray) -> (_ND, ndarray): one slot an array, however often met
    groups = {}  # id(coefficient tuple) -> (_PlanesGroup, tuple)

    def slot(arr):
        hit = slots.get(id(arr))
        if hit is not None:
            return hit[0]
        flat = np.ascontiguousarray(arr)
        off = (state[0] + _ALIGN - 1) & ~(_ALIGN - 1)
        state[0] = off + flat.nbytes
        parts.append((off, flat))
        nd = _ND(flat.dtype.str, flat.shape, off, flat.nbytes)
        slots[id(arr)] = (nd, arr)  # the array is kept: its id stays unique
        return nd

    def planes(p):
        specmax = p.specmax
        if isinstance(specmax, np.ndarray):
            specmax = slot(specmax)
        ref = p.batch_ref
        if ref is None:
            own = [(slot(c.blocks), slot(np.asarray(c.qtable)), c.h_samp, c.v_samp)
                   for c in p.components]
            return _Planes(p.height, p.width, None, None, None, own, p.kmax, specmax)
        hit = groups.get(id(ref[0]))
        if hit is None:
            group = _PlanesGroup(tuple(slot(c) for c in ref[0]), slot(ref[1]))
            groups[id(ref[0])] = (group, ref[0])
        else:
            group = hit[0]
        layout = [(c.h_samp, c.v_samp) + tuple(c.blocks.shape[:2]) for c in p.components]
        return _Planes(p.height, p.width, group, int(ref[2]), layout, None, p.kmax,
                       specmax)

    def enc(v):
        if isinstance(v, np.ndarray):
            if v.dtype == object:
                return _NDObj(v.shape, [enc(e) for e in v.reshape(-1)])
            return slot(v)
        if isinstance(v, dict):
            return {k: enc(e) for k, e in v.items()}
        if isinstance(v, list):
            return [enc(e) for e in v]
        if isinstance(v, tuple):
            return tuple(enc(e) for e in v)
        if _is_planes(v):
            return planes(v)
        return v

    meta = enc(value)
    return meta, parts, state[0]


def _decode_payload(meta, buf, blob_base):
    """Rebuild the payload with read-only zero-copy views over ``buf``."""
    memo = {}  # id(meta node) -> its decoded object: shared nodes decode once

    def nd(m):
        hit = memo.get(id(m))
        if hit is None:
            dtype = np.dtype(m.dtype)
            arr = np.frombuffer(buf, dtype=dtype,
                                count=m.nbytes // dtype.itemsize if dtype.itemsize else 0,
                                offset=blob_base + m.off)
            arr = arr.reshape(m.shape)
            arr.flags.writeable = False
            hit = memo[id(m)] = (arr, m)  # the node is kept: its id stays unique
        return hit[0]

    def planes(m):
        from petastorm_tpu_torch.ops.jpeg import JpegComponent, JpegPlanes

        specmax = nd(m.specmax) if isinstance(m.specmax, _ND) else m.specmax
        if m.group is None:
            comps = [JpegComponent(nd(blocks), nd(qtable), h, v)
                     for blocks, qtable, h, v in m.own]
            return JpegPlanes(m.height, m.width, comps, batch_ref=None, kmax=m.kmax,
                              specmax=specmax)
        hit = memo.get(id(m.group))
        if hit is None:
            hit = memo[id(m.group)] = (
                (tuple(nd(c) for c in m.group.coeffs), nd(m.group.qtabs)), m.group)
        coeffs, qtabs = hit[0]
        i = m.row
        comps = [JpegComponent(coeffs[c][i].reshape(by, bx, 64), qtabs[i, c], h, v)
                 for c, (h, v, by, bx) in enumerate(m.layout)]
        return JpegPlanes(m.height, m.width, comps, batch_ref=(coeffs, qtabs, i),
                          kmax=m.kmax, specmax=specmax)

    def dec(m):
        if isinstance(m, _ND):
            return nd(m)
        if isinstance(m, _NDObj):
            out = np.empty(m.shape, dtype=object)
            flat = out.reshape(-1)
            for i, e in enumerate(m.elems):
                flat[i] = dec(e)
            return out
        if isinstance(m, _Planes):
            return planes(m)
        if isinstance(m, dict):
            return {k: dec(e) for k, e in m.items()}
        if isinstance(m, list):
            return [dec(e) for e in m]
        if isinstance(m, tuple):
            return tuple(dec(e) for e in m)
        return m

    return dec(meta)


# -- counts ----------------------------------------------------------------------------

_counts_lock = threading.Lock()
_COUNTS = dict.fromkeys(("hits", "misses", "admits", "evictions", "invalidations",
                         "attaches", "revoked"), 0)


#: count name -> (registry family, help): the JAX package's ``ptpu_io_arena_*``
_FAMILIES = {
    "hits": ("ptpu_io_arena_hits_total", "reads served from the shared cache arena"),
    "misses": ("ptpu_io_arena_misses_total", "arena lookups that missed"),
    "admits": ("ptpu_io_arena_admits_total", "entries copied into the arena"),
    "evictions": ("ptpu_io_arena_evictions_total", "entries LRU-evicted for budget"),
    "invalidations": ("ptpu_io_arena_invalidations_total",
                      "entries dropped by keyed/generation invalidation"),
    "attaches": ("ptpu_io_arena_attaches_total", "processes that mapped this arena"),
    "revoked": ("ptpu_io_arena_holders_revoked_total",
                "dead-process holder refcounts dropped by reclaim()"),
}
_metrics = []  # [({name: Counter}, bytes gauge, entries gauge)], made at first use


def _registry_metrics():
    with _counts_lock:
        if not _metrics:
            from petastorm_tpu_torch.obs.metrics import default_registry

            reg = default_registry()
            _metrics.append((
                {name: reg.counter(fam, help=text) for name, (fam, text) in _FAMILIES.items()},
                reg.gauge("ptpu_io_arena_bytes", help="payload bytes resident in the arena"),
                reg.gauge("ptpu_io_arena_entries", help="entries resident in the arena")))
        return _metrics[0]


def _bump(name, n=1):
    with _counts_lock:
        _COUNTS[name] += n
    _registry_metrics()[0][name].inc(n)


def arena_counters():
    """This process's arena counts since it started: ``{hits, misses, admits, evictions,
    invalidations, attaches, revoked}``."""
    with _counts_lock:
        return dict(_COUNTS)


class _CtlFull(Exception):
    """Pickled index outgrew the control segment (admission declined)."""


class CacheArena:
    """The host-wide shared cache arena: one control segment + one shm segment
    per entry, cross-process coordinated under a flock'd lock file.

    Construct with ``budget_bytes`` to CREATE (this process owns the segments and
    unlinks them at :meth:`close`), or with ``spec=`` to ATTACH to an existing arena
    (:meth:`close` then detaches, never unlinks). ``close()``/``detach()`` are the
    closers.
    """

    def __init__(self, budget_bytes=None, spec=None, ctl_bytes=DEFAULT_CTL_BYTES):
        from multiprocessing import shared_memory

        if (budget_bytes is None) == (spec is None):
            raise ValueError("pass exactly one of budget_bytes (create) or "
                             "spec (attach)")
        import fcntl  # noqa: F401 — POSIX-only; ImportError → arena unavailable

        self._fcntl = fcntl
        self._tlock = threading.Lock()
        self._closed = False
        self._creator = spec is None
        self._maps = {}  # segment name -> SharedMemory (entry segments)
        self._pid = os.getpid()
        self._ctl_bytes = int(ctl_bytes)
        #: per-process stripes in front of the single-flight record locks (a record lock
        #: is the process's, so threads of one process must take turns first)
        self._flight_tlocks = tuple(threading.Lock() for _ in range(64))
        if self._creator:
            token = "%d_%s" % (os.getpid(), os.urandom(4).hex())
            self.spec = ArenaSpec(token)
            self._lock_path = _lock_path(token)
            lock_fd = os.open(self._lock_path,
                              os.O_CREAT | os.O_RDWR, 0o600)
            self._lock_fd = lock_fd
            self._flight_fd = os.open(_flight_path(token), os.O_CREAT | os.O_RDWR, 0o600)
            ctl = shared_memory.SharedMemory(
                create=True, size=self._ctl_bytes, name=_ctl_name(token))
            self._ctl = ctl
            index = {"budget": int(budget_bytes), "serial": 0, "tick": 0,
                     "total": 0, "attached": {self._pid: True}, "entries": {}}
            with self._tlock:
                self._flock()
                try:
                    self._write_index(index)
                finally:
                    self._funlock()
        else:
            token = spec.token
            self.spec = ArenaSpec(token)
            self._lock_path = _lock_path(token)
            lock_fd = os.open(self._lock_path, os.O_RDWR)  # must pre-exist
            self._lock_fd = lock_fd
            self._flight_fd = os.open(_flight_path(token), os.O_RDWR)
            ctl = shared_memory.SharedMemory(name=_ctl_name(token))
            _untrack_segment(ctl)
            self._ctl = ctl
            self._ctl_bytes = ctl.size
            with self._tlock:
                self._flock()
                try:
                    index = self._read_index()
                    index["attached"][self._pid] = True
                    self._write_index(index)
                finally:
                    self._funlock()
        _bump("attaches")

    # -- cross-process lock (order: _tlock -> flock, everywhere) ------------------------

    def _flock(self):
        self._fcntl.flock(self._lock_fd, self._fcntl.LOCK_EX)

    def _funlock(self):
        self._fcntl.flock(self._lock_fd, self._fcntl.LOCK_UN)

    @contextlib.contextmanager
    def single_flight(self, key):
        """Hold the host-wide fill lock of ``key``: one thread of one process at a time
        runs the block, so a cold entry that several processes miss together is read
        from the store once (the others wait, then map what it admitted). A record lock
        on one byte (a stripe) of the arena's flight file, behind a per-process stripe
        lock; the kernel drops it when its process dies. After :meth:`close` the block
        runs unlocked."""
        stripe = zlib.crc32(repr(key).encode("utf-8")) % _FLIGHT_STRIPES
        with self._flight_tlocks[stripe % len(self._flight_tlocks)]:
            if self._closed:
                yield
                return
            self._fcntl.lockf(self._flight_fd, self._fcntl.LOCK_EX, 1, stripe)
            try:
                yield
            finally:
                try:
                    self._fcntl.lockf(self._flight_fd, self._fcntl.LOCK_UN, 1, stripe)
                except OSError:
                    pass  # closed meanwhile: the lock went with the descriptor

    # -- control-segment index ----------------------------------------------------------

    def _read_index(self):
        buf = self._ctl.buf
        magic, length = _HEADER.unpack_from(buf, 0)
        if magic != _CTL_MAGIC or length > self._ctl_bytes - _HEADER.size:
            raise RuntimeError("arena control segment corrupt")
        return pickle.loads(bytes(buf[_HEADER.size:_HEADER.size + length]))

    def _write_index(self, index):
        blob = pickle.dumps(index, protocol=pickle.HIGHEST_PROTOCOL)
        if _HEADER.size + len(blob) > self._ctl_bytes:
            raise _CtlFull()
        buf = self._ctl.buf
        _HEADER.pack_into(buf, 0, _CTL_MAGIC, len(blob))
        buf[_HEADER.size:_HEADER.size + len(blob)] = blob
        _counters, nbytes, entries = _registry_metrics()
        nbytes.set(index["total"])
        entries.set(len(index["entries"]))

    # -- admission ----------------------------------------------------------------------

    def put(self, key, value, gen=None):
        """Admit ``value`` under ``key`` (idempotent: an existing same-
        generation entry is kept, not re-copied). Returns True when the entry
        is resident after the call. The one copy — payload bytes into shm —
        is charged to the ``arena_admit`` census site."""
        try:
            meta, parts, blob_len = _encode_payload(value)
        except Exception:  # noqa: BLE001 — unpicklable/exotic payloads stay local
            return False
        return self._admit(key, gen, meta, parts, blob_len)

    def put_bytes(self, key, data, gen=None):
        """Admit a raw blob (serialized footer, pickled page-boundary memo)."""
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
        return self._admit(key, gen, _ND("|u1", arr.shape, 0, arr.nbytes),
                           [(0, arr)], arr.nbytes)

    def _admit(self, key, gen, meta, parts, blob_len):
        from multiprocessing import shared_memory

        if self._closed:
            return False
        try:
            meta_blob = pickle.dumps(meta, protocol=pickle.HIGHEST_PROTOCOL)
        except Exception:  # noqa: BLE001 — unpicklable meta leaf: stay local
            return False
        blob_base = _blob_base(len(meta_blob))
        seg_size = max(16, blob_base + blob_len)
        # budget/census charge = EVERYTHING written into shm: the ndarray
        # blob plus the pickled meta tree (bytes-leaf payloads — binary
        # columns — live in the meta, and must not ride the budget for free)
        nbytes = blob_len + len(meta_blob)
        with self._tlock:
            self._flock()
            try:
                try:
                    index = self._read_index()
                except Exception:  # noqa: BLE001 — corrupt ctl: decline, keep serving locally
                    return False
                entry = index["entries"].get(key)
                if entry is not None and entry["gen"] == gen:
                    return True  # another process admitted it first
                if entry is not None:
                    self._drop_entry(index, key, entry, invalidation=True)
                if nbytes > index["budget"]:
                    degradation(
                        "arena_full",
                        "arena admission declined: %d-byte payload exceeds "
                        "the whole arena budget (%d)", nbytes,
                        index["budget"])
                    return False
                self._evict_for(index, nbytes)
                if index["total"] + nbytes > index["budget"]:
                    degradation(
                        "arena_full",
                        "arena admission declined: budget %d full with "
                        "held/hot entries", index["budget"])
                    return False
                index["serial"] += 1
                seg_name = _entry_name(self.spec.token, index["serial"])
                try:
                    seg = shared_memory.SharedMemory(
                        create=True, size=seg_size, name=seg_name)
                except Exception as e:  # noqa: BLE001 — /dev/shm full, etc.
                    degradation("arena_full",
                                "arena entry segment create failed (%s)", e)
                    return False
                if not self._creator:
                    _untrack_segment(seg)
                self._maps[seg_name] = seg
                buf = seg.buf
                _HEADER.pack_into(buf, 0, _ENTRY_MAGIC, len(meta_blob))
                buf[_HEADER.size:_HEADER.size + len(meta_blob)] = meta_blob
                for off, arr in parts:
                    if arr.nbytes:
                        start = blob_base + off
                        buf[start:start + arr.nbytes] = \
                            memoryview(arr).cast("B")
                index["tick"] += 1
                admit_tenant = _tenant.current_label()
                index["entries"][key] = {
                    "seg": seg_name, "nbytes": nbytes, "gen": gen,
                    "tick": index["tick"], "holders": {},
                    # the admitting tenant: an eviction debits the owner's residency,
                    # not the evictor's
                    "tenant": admit_tenant}
                index["total"] += nbytes
                try:
                    self._write_index(index)
                except _CtlFull:
                    # index outgrew the control segment: back the entry out
                    del index["entries"][key]
                    index["total"] -= nbytes
                    self._unlink_seg(seg_name)
                    self._rewrite_best_effort(index)
                    degradation(
                        "arena_full",
                        "arena index outgrew the %d-byte control segment; "
                        "admission declined", self._ctl_bytes)
                    return False
            finally:
                self._funlock()
        count_copy("arena_admit", nbytes)
        _bump("admits")
        if admit_tenant is not None:
            _tenant.meter().arena_adjust(admit_tenant, nbytes)
        return True

    def _rewrite_best_effort(self, index):
        try:
            self._write_index(index)
        except Exception:  # noqa: BLE001 — ctl already held a larger index
            pass  # graftlint: disable=GL-O002 (backout path; next write retries)

    def _evict_for(self, index, incoming):
        """LRU-evict unheld entries until ``incoming`` fits (lock held).
        Entries with live holders are skipped — a mapped view pinned by a
        lease must never have its bytes budget-reclaimed out from under the
        budget accounting; dead holders are self-healed here."""
        if index["total"] + incoming <= index["budget"]:
            return
        order = sorted(index["entries"].items(), key=lambda kv: kv[1]["tick"])
        for key, entry in order:
            if index["total"] + incoming <= index["budget"]:
                break
            self._prune_dead_holders(entry)
            if any(entry["holders"].values()):
                continue
            self._drop_entry(index, key, entry, invalidation=False)

    @staticmethod
    def _prune_dead_holders(entry):
        for pid in list(entry["holders"]):
            if not _pid_alive(pid):
                del entry["holders"][pid]

    def _drop_entry(self, index, key, entry, invalidation):
        del index["entries"][key]
        index["total"] -= entry["nbytes"]
        self._unlink_seg(entry["seg"])
        _bump("invalidations" if invalidation else "evictions")
        owner = entry.get("tenant")
        if owner is not None:
            # the owner's residency integral closes here: exact in this process; an
            # eviction by a peer process debits the peer's meter, and stats()'s
            # index-derived per-tenant bytes stay the host-wide truth
            _tenant.meter().arena_adjust(owner, -entry["nbytes"])

    def _unlink_seg(self, seg_name):
        """Remove a segment's NAME (POSIX keeps peers' live mappings valid).
        Our own mapping is kept in ``_maps`` — outstanding local views stay
        backed; the mapping frees when the map entry drops and the last view
        dies (numpy refcounting)."""
        from multiprocessing import shared_memory

        seg = self._maps.pop(seg_name, None)  # graftlint: disable=GL-C001 (every caller holds self._tlock: _admit, _lookup, invalidate and set_budget take it before the index mutation that reaches here)
        if seg is None:
            try:
                seg = shared_memory.SharedMemory(name=seg_name)
                _untrack_segment(seg)
            except FileNotFoundError:
                return
            except Exception:  # noqa: BLE001 — best-effort per segment
                return
        _tracked_unlink(seg)
        _close_mappings([seg])

    # -- serves -------------------------------------------------------------------------

    def get(self, key, gen=None):
        """``(value, lease)`` — zero-copy read-only views pinned by a
        ``kind="arena"`` lease — or ``None`` on miss/generation mismatch.
        The caller (a per-process cache admitting the views) releases the
        lease when its entry drops; the holder refcount in the control
        segment keeps the entry unevictable until then."""
        got = self._lookup(key, gen)
        if got is None:
            return None
        seg, meta_blob = got
        try:
            meta = pickle.loads(meta_blob)
            value = _decode_payload(meta, seg.buf, _blob_base(len(meta_blob)))
        except Exception:  # noqa: BLE001 — undecodable entry: release + miss
            self._drop_holder(key, seg.name)
            return None
        lease = Lease(release_cb=_release_cb(self, key, seg.name),
                      kind="arena")
        return value, lease

    def get_bytes(self, key, gen=None):
        """A raw blob admitted with :meth:`put_bytes`, as ``bytes`` — or
        ``None``. The (small, metadata-plane) blob is copied out and the
        holder refcount dropped before returning: blob consumers parse once
        per process and memoize the parse, not the bytes."""
        got = self._lookup(key, gen)
        if got is None:
            return None
        seg, meta_blob = got
        try:
            meta = pickle.loads(meta_blob)
            base = _blob_base(len(meta_blob))
            data = bytes(seg.buf[base:base + meta.nbytes])
        except Exception:  # noqa: BLE001 — undecodable entry: miss
            data = None
        self._drop_holder(key, seg.name)
        return data

    def _lookup(self, key, gen):
        """Hit: bump LRU + this pid's holder refcount, return the mapped
        segment and its meta blob. Generation mismatch invalidates."""
        from multiprocessing import shared_memory

        if self._closed:
            return None
        with self._tlock:
            self._flock()
            try:
                try:
                    index = self._read_index()
                except Exception:  # noqa: BLE001 — corrupt ctl: miss
                    _bump("misses")
                    return None
                entry = index["entries"].get(key)
                if entry is not None and gen is not None \
                        and entry["gen"] != gen:
                    self._drop_entry(index, key, entry, invalidation=True)
                    self._rewrite_best_effort(index)
                    entry = None
                if entry is None:
                    _bump("misses")
                    return None
                seg = self._maps.get(entry["seg"])
                if seg is None:
                    try:
                        seg = shared_memory.SharedMemory(name=entry["seg"])
                    except Exception:  # noqa: BLE001 — vanished segment: self-heal
                        self._drop_entry(index, key, entry, invalidation=True)
                        self._rewrite_best_effort(index)
                        _bump("misses")
                        return None
                    if not self._creator:
                        _untrack_segment(seg)
                    self._maps[entry["seg"]] = seg
                index["tick"] += 1
                entry["tick"] = index["tick"]
                holders = entry["holders"]
                holders[self._pid] = holders.get(self._pid, 0) + 1
                self._rewrite_best_effort(index)
            finally:
                self._funlock()
        try:
            magic, meta_len = _HEADER.unpack_from(seg.buf, 0)
            if magic != _ENTRY_MAGIC:
                raise RuntimeError("arena entry segment corrupt")
            meta_blob = bytes(seg.buf[_HEADER.size:_HEADER.size + meta_len])
        except Exception:  # noqa: BLE001 — torn entry: release holder, miss
            self._drop_holder(key, seg.name)
            _bump("misses")
            return None
        _bump("hits")
        return seg, meta_blob

    def _drop_holder(self, key, seg_name):
        """Lease release callback: drop one of this pid's holder refcounts.
        The entry may already be gone (invalidated/evicted after the holder's
        process died and was reclaimed) — then there is nothing to do; the
        local mapping stays until its views die."""
        if self._closed:
            return
        with self._tlock:
            self._flock()
            try:
                try:
                    index = self._read_index()
                except Exception:  # noqa: BLE001 — corrupt ctl during teardown
                    return
                entry = index["entries"].get(key)
                if entry is None or entry["seg"] != seg_name:
                    return
                holders = entry["holders"]
                n = holders.get(self._pid, 0)
                if n <= 1:
                    holders.pop(self._pid, None)
                else:
                    holders[self._pid] = n - 1
                self._rewrite_best_effort(index)
            finally:
                self._funlock()

    def contains(self, key):
        with self._tlock:
            if self._closed:
                return False
            self._flock()
            try:
                try:
                    return key in self._read_index()["entries"]
                except Exception:  # noqa: BLE001 — corrupt ctl reads as empty
                    return False
            finally:
                self._funlock()

    # -- invalidation / reclaim ---------------------------------------------------------

    def invalidate(self, key):
        """Drop one entry by key (a replaced source file). Peers' live views stay
        valid: unlink removes the name, not the mappings."""
        if self._closed:
            return
        with self._tlock:
            self._flock()
            try:
                try:
                    index = self._read_index()
                except Exception:  # noqa: BLE001
                    return
                entry = index["entries"].get(key)
                if entry is None:
                    return
                self._drop_entry(index, key, entry, invalidation=True)
                self._rewrite_best_effort(index)
            finally:
                self._funlock()

    def reclaim(self, pid=None):
        """Drop the holder refcounts (and attach record) of dead processes —
        the SIGKILLed-child path, same semantics as ``SlabRing.reclaim``:
        the dead holder's pins vanish so its entries become evictable again;
        live peers' views are untouched. ``pid=None`` sweeps every recorded
        pid; returns the number of holder refcounts revoked."""
        if self._closed:
            return 0
        revoked = 0
        with self._tlock:
            self._flock()
            try:
                try:
                    index = self._read_index()
                except Exception:  # noqa: BLE001
                    return 0
                targets = [pid] if pid is not None else None
                for entry in index["entries"].values():
                    for holder in list(entry["holders"]):
                        dead = (holder in targets) if targets is not None \
                            else not _pid_alive(holder)
                        if dead:
                            revoked += entry["holders"].pop(holder)
                for holder in list(index["attached"]):
                    dead = (holder in targets) if targets is not None \
                        else not _pid_alive(holder)
                    if dead:
                        del index["attached"][holder]
                if revoked:
                    self._rewrite_best_effort(index)
            finally:
                self._funlock()
        if revoked:
            _bump("revoked", revoked)
            degradation(
                "arena_lease_revoked",
                "%d arena holder refcount(s) of dead process(es) reclaimed; "
                "their entries are evictable again (live peers' views stay "
                "valid)", revoked, once=False)
        return revoked

    # -- budget / stats -----------------------------------------------------------------

    @property
    def budget(self):
        with self._tlock:
            if self._closed:
                return 0
            self._flock()
            try:
                try:
                    return self._read_index()["budget"]
                except Exception:  # noqa: BLE001
                    return 0
            finally:
                self._funlock()

    def set_budget(self, nbytes):
        """Live budget retune, host-wide: the budget lives in the control segment,
        so a retune in any process governs every attached process's admissions.
        Shrinking evicts unheld entries at once."""
        nbytes = max(0, int(nbytes))
        if self._closed:
            return 0
        with self._tlock:
            self._flock()
            try:
                try:
                    index = self._read_index()
                except Exception:  # noqa: BLE001
                    return 0
                index["budget"] = nbytes
                self._evict_for(index, 0)
                self._rewrite_best_effort(index)
            finally:
                self._funlock()
        return nbytes

    def stats(self):
        with self._tlock:
            if self._closed:
                return {}
            self._flock()
            try:
                try:
                    index = self._read_index()
                except Exception:  # noqa: BLE001
                    return {}
            finally:
                self._funlock()
        counts = arena_counters()
        tenant_bytes = {}
        for e in index["entries"].values():
            owner = e.get("tenant")
            if owner is not None:
                tenant_bytes[owner] = tenant_bytes.get(owner, 0) + e["nbytes"]
        return {
            "arena_entries": len(index["entries"]),
            "arena_payload_bytes": index["total"],
            "arena_budget_bytes": index["budget"],
            "arena_attached": len(index["attached"]),
            "arena_held_entries": sum(
                1 for e in index["entries"].values() if e["holders"]),
            "arena_held_leases": sum(
                sum(h.values()) for e in index["entries"].values()
                for h in (e["holders"],)),
            # this process's counts (each process warms on its own)
            "arena_hits": counts["hits"],
            "arena_misses": counts["misses"],
            "arena_admits": counts["admits"],
            "arena_evictions": counts["evictions"],
            "arena_invalidations": counts["invalidations"],
            # host-wide residency by tenant, from the index (exports as
            # ptpu_io_arena_tenant_bytes{tenant=...})
            "arena_tenant_bytes": tenant_bytes,
        }

    # -- teardown -----------------------------------------------------------------------

    def close(self):
        """Creator: unlink every entry segment, the control segment and the
        lock file — nothing survives in ``/dev/shm`` (peers' live views stay
        backed by their own mappings). Attacher: detach only. Idempotent."""
        with self._tlock:
            if self._closed:
                return
            self._closed = True
            maps, self._maps = self._maps, {}
            entry_names = []
            try:
                self._flock()
                try:
                    try:
                        index = self._read_index()
                        if self._creator:
                            entry_names = [e["seg"] for e in
                                           index["entries"].values()]
                        else:
                            index["attached"].pop(self._pid, None)
                            for entry in index["entries"].values():
                                entry["holders"].pop(self._pid, None)
                            self._rewrite_best_effort(index)
                    except Exception:  # noqa: BLE001 — corrupt ctl: unlink what we mapped
                        if self._creator:
                            entry_names = list(maps)
                finally:
                    self._funlock()
            except Exception:  # noqa: BLE001 — lock fd already gone (exit races)
                if self._creator:
                    entry_names = list(maps)
        for name in entry_names:
            seg = maps.pop(name, None)
            _unlink_by_name(name, seg)
        _close_mappings(maps.values())
        if self._creator:
            _unlink_by_name(self._ctl.name, self._ctl)
            for path in (self._lock_path, _flight_path(self.spec.token)):
                try:
                    os.unlink(path)
                except OSError:
                    pass
        else:
            _close_mappings([self._ctl])
        for fd in (self._lock_fd, self._flight_fd):
            try:
                os.close(fd)
            except OSError:
                pass

    def detach(self):
        """Alias of :meth:`close` for attachers."""
        self.close()

    def __repr__(self):
        return "<CacheArena %s token=%s%s>" % (
            "creator" if self._creator else "attached", self.spec.token,
            " CLOSED" if self._closed else "")


def _release_cb(arena, key, seg_name):
    def release():
        arena._drop_holder(key, seg_name)
    return release


def _close_mappings(segs):
    for seg in segs:
        try:
            seg.close()
        except BufferError:
            # exported views still alive (a consumer kept a served batch):
            # the mapping frees with the last view; shadow close() so the
            # segment's teardown does not retry and spam at GC
            seg.close = _noop
        except Exception:  # noqa: BLE001
            pass  # graftlint: disable=GL-O002 (exit path: mapping frees at process exit)


def _unlink_by_name(name, seg):
    from multiprocessing import shared_memory

    if seg is None:
        try:
            seg = shared_memory.SharedMemory(name=name)
            _untrack_segment(seg)
        except Exception:  # noqa: BLE001 — already gone
            return
    _tracked_unlink(seg)
    _close_mappings([seg])


def _tracked_unlink(seg):
    """Unlink with BALANCED resource_tracker bookkeeping: ``unlink()`` always
    sends an unregister, but attached segments were deliberately deregistered
    (gh-82300) — re-register first (the tracker's cache is a set; re-adding a
    creator-registered name is a no-op) so the pair never underflows into
    tracker KeyError spam at exit."""
    registered = False
    try:
        from multiprocessing import resource_tracker

        resource_tracker.register(seg._name, "shared_memory")
        registered = True
    except Exception:  # noqa: BLE001 — tracker internals vary
        pass  # graftlint: disable=GL-O002 (bookkeeping only; unlink below still runs)
    try:
        seg.unlink()  # sends the matching unregister on success
        registered = False
    except FileNotFoundError:
        pass  # another process already unlinked it
    except Exception:  # noqa: BLE001 — unlink is best-effort per segment
        pass  # graftlint: disable=GL-O002 (name removal; mappings stay valid)
    if registered:
        # unlink raised before its internal unregister: take the name back
        # out or the tracker would warn about (and re-unlink) it at exit
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(seg._name, "shared_memory")
        except Exception:  # noqa: BLE001
            pass  # graftlint: disable=GL-O002 (bookkeeping only)


def _noop():
    pass


def _ctl_name(token):
    return "%s%s_ctl" % (ARENA_PREFIX, token)


def _entry_name(token, serial):
    return "%s%s_e%d" % (ARENA_PREFIX, token, serial)


def _lock_path(token):
    return os.path.join(tempfile.gettempdir(), "%s%s.lock"
                        % (ARENA_PREFIX, token))


def _flight_path(token):
    return os.path.join(tempfile.gettempdir(), "%s%s.flight"
                        % (ARENA_PREFIX, token))


def _blob_base(meta_len):
    return (_HEADER.size + meta_len + _ALIGN - 1) & ~(_ALIGN - 1)


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    except OSError:
        return False


def _untrack_segment(seg):
    """gh-82300: deregister an ATTACHED segment from this process's resource_tracker
    (the shm_ring helper: one fix, one place)."""
    from petastorm_tpu_torch.parallel.shm_ring import untrack_attachment

    untrack_attachment(seg)


# -- process-wide singleton + env handoff ----------------------------------------------
#
# One arena handle a process, whoever asked first: the creating reader (host_arena), a
# pool child's bootstrap (attach_from_env), or a cache resolving a pickled spec
# (resolve).

#: the attach variable of the port's own: a JAX-package pool child (which reads
#: ``PTPU_ARENA_ATTACH``) never maps the port's arena, nor a port child the JAX package's
ENV_ATTACH = "PTPU_TORCH_ARENA_ATTACH"

_state_lock = threading.Lock()
_STATE = {"arena": None, "failed_tokens": set()}


def arena_enabled():
    """The ``PTPU_ARENA=off`` kill switch (also accepts 0/false/no)."""
    raw = (os.environ.get("PTPU_ARENA") or "").strip().lower()
    return raw not in ("0", "off", "false", "no")


def process_arena():
    """This process's arena handle, or ``None`` (never creates/attaches)."""
    with _state_lock:
        arena = _STATE["arena"]
    return arena if arena is not None and not arena._closed else None


def current_token():
    """The attach token children receive in ``ENV_ATTACH``."""
    arena = process_arena()
    return arena.spec.token if arena is not None else None


def host_arena(create_bytes, ctl_bytes=DEFAULT_CTL_BYTES):
    """Create (or return) this process's arena with ``create_bytes`` budget.

    Returns ``None`` — with a warn-once ``arena_unavailable`` degradation —
    when the kill switch is set or shared memory/flock is unusable on this
    platform; callers then keep today's per-process caches (byte-identical
    output, just N× resident)."""
    if not create_bytes or not arena_enabled():
        return None
    with _state_lock:
        arena = _STATE["arena"]
        if arena is not None and not arena._closed:
            return arena
        from petastorm_tpu_torch.parallel.shm_ring import shm_supported

        if not shm_supported():
            degradation("arena_unavailable",
                        "shared-memory cache arena unavailable (no shm); "
                        "per-process caches in effect")
            return None
        try:
            arena = CacheArena(budget_bytes=int(create_bytes),
                               ctl_bytes=ctl_bytes)
        except Exception as e:  # noqa: BLE001 — any failure degrades to local caches
            degradation("arena_unavailable",
                        "shared-memory cache arena create failed (%s); "
                        "per-process caches in effect", e)
            return None
        _STATE["arena"] = arena
        _register_atexit()
    return arena


def resolve(spec):
    """Attach to the arena named by ``spec`` (memoized per process). A pool
    child that already attached at bootstrap — or IS the creator (thread
    pools) — gets the existing handle. Returns ``None`` on failure (the
    creator died and unlinked, spec from another host, ...) with a warn-once
    degradation."""
    if spec is None or not arena_enabled():
        return None
    with _state_lock:
        arena = _STATE["arena"]
        if arena is not None and not arena._closed:
            return arena
        if spec.token in _STATE["failed_tokens"]:
            return None
        try:
            arena = CacheArena(spec=spec)
        except Exception as e:  # noqa: BLE001 — attach failure degrades to local caches
            _STATE["failed_tokens"].add(spec.token)
            degradation("arena_unavailable",
                        "cache arena attach failed for token %s (%s); "
                        "per-process caches in effect", spec.token, e)
            return None
        _STATE["arena"] = arena
        _register_atexit()
    return arena


def attach_from_env():
    """Pool-child bootstrap hook: attach the parent's arena named by ``ENV_ATTACH``
    (set on the executor's child environment, which every spawn of the pool reuses), so
    a child starts warm. Failure-tolerant; returns the arena or ``None``."""
    token = os.environ.get(ENV_ATTACH)
    if not token:
        return None
    return resolve(ArenaSpec(token))


_atexit_armed = []


def _register_atexit():
    if not _atexit_armed:
        _atexit_armed.append(True)
        atexit.register(close_process_arena)


def close_process_arena():
    """Close/detach this process's arena (atexit safety net + test hook).
    The creator unlinks every segment; attachers detach."""
    with _state_lock:
        arena, _STATE["arena"] = _STATE["arena"], None
    if arena is not None:
        arena.close()
    return arena is not None
