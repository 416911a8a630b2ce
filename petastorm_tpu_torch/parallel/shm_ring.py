"""Shared-memory slab ring for the process pool's zero-copy wire.

Port of ``petastorm_tpu.parallel.shm_ring``. The parent owns a ring of
``multiprocessing.shared_memory`` segments ("slabs") with a thread-safe free list. Per
item a feeder thread acquires a slab and grants it to its child with the work item; the
child writes its serialized frames straight into the slab and answers with a small
descriptor; the parent rebuilds views into the slab without a copy
(:class:`petastorm_tpu_torch.serializers.ShmSerializer`).

Lifecycle rules:

- The parent is the only creator and the only unlinker. ``SlabRing.close()``, called
  from ``ProcessExecutor.join()``, unlinks every segment, whatever the children did
  (SIGKILL mid-write included).
- Children attach by name and deregister from their ``resource_tracker`` (gh-82300: an
  attaching process otherwise unlinks the parent's segments when it exits).
- A slab granted to a child that dies mid-item goes back to the ring before the
  replacement child is spawned; if a consumer lease still views it, the lease is
  revoked instead.
- Consumer leases release idempotently, and a release after ``close()`` is a no-op.

Segments are named ``ptpu_torch_shm_<creator pid>_<token>_<i>``: a prefix of the port's
own, so the JAX package's slab checks (which glob ``ptpu_shm_*``) never see them, and
the creator's pid in the name lets a check count only the slabs of one process.
"""
from __future__ import annotations

import logging
import os
import queue
import threading
import time
import weakref

logger = logging.getLogger(__name__)

#: /dev/shm segment name prefix of the port's slabs
SEGMENT_PREFIX = "ptpu_torch_shm_"

_supported_cache = None
_warned = set()
_warned_lock = threading.Lock()
#: degradations this process took: {name: count}
_degradations = {}


def degradation(name, msg, *args, once=True):
    """Count degradation ``name`` and log it (a warning the first time, then debug when
    ``once``)."""
    with _warned_lock:
        _degradations[name] = _degradations.get(name, 0) + 1
        first = name not in _warned
        _warned.add(name)
    if first or not once:
        logger.warning(msg, *args)
    else:
        logger.debug(msg, *args)


def degradation_counts():
    """``{name: times}`` of the wire degradations this process took."""
    with _warned_lock:
        return dict(_degradations)


def _noop():
    pass


def shm_supported():
    """True when ``multiprocessing.shared_memory`` works here (probed once): a missing
    ``/dev/shm``, a denial, or a Python without ``_posixshmem`` all degrade the process
    pool to the socket wire."""
    global _supported_cache
    if _supported_cache is None:
        try:
            from multiprocessing import shared_memory

            probe = shared_memory.SharedMemory(create=True, size=16)
            try:
                probe.buf[0] = 1
            finally:
                probe.close()
                probe.unlink()
            _supported_cache = True
        except Exception as e:  # noqa: BLE001 — any failure means "not here"
            degradation("shm_unsupported", "shared-memory wire unavailable (%s); the "
                        "process pool will use the socket wire", e)
            _supported_cache = False
    return _supported_cache


def shm_free_bytes(path="/dev/shm"):
    """Bytes free in the shared-memory file system, or None where it has no mount to
    ask."""
    try:
        st = os.statvfs(path)
    except (OSError, AttributeError):
        return None
    return st.f_bavail * st.f_frsize


def _untrack(segment):
    """Deregister an attached segment from this process's resource_tracker (gh-82300:
    it would otherwise unlink the parent's segment when this process exits)."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(segment._name, "shared_memory")
    except Exception:  # noqa: BLE001 — tracker internals vary; worst case is a
        pass           # spurious unlink warning at child exit, not a leak


def untrack_attachment(segment):
    """The public seam of :func:`_untrack`: the cache arena (``io/arena.py``) attaches
    segments by name as :class:`SlabClient` does and needs the same deregistration."""
    _untrack(segment)


class SlabLease:
    """One consumer-held reference to an acquired slab: ``release()`` returns the slab
    to the ring exactly once, also when a consumer thread and ``stop()`` race to it.
    Dropping the last reference releases too."""

    __slots__ = ("_ring", "slab_id", "_released", "_lock")

    def __init__(self, ring, slab_id):
        self._ring = ring
        self.slab_id = slab_id
        self._released = False
        self._lock = threading.Lock()

    def release(self):
        with self._lock:
            if self._released:
                return
            self._released = True
        self._ring.release(self.slab_id)

    def __del__(self):
        try:
            self.release()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class SlabRing:
    """Parent-side slab owner: ``num_slabs`` segments of ``slab_bytes`` and a thread-safe
    free list.

    Creation checks the shared-memory file system's free bytes first: a segment larger
    than what tmpfs can back is created sparse and kills its writer with SIGBUS at the
    first page it cannot fault in, so a ring that does not fit raises ``OSError`` here
    and the pool degrades to the socket wire."""

    def __init__(self, slab_bytes, num_slabs):
        from multiprocessing import shared_memory

        if slab_bytes <= 0 or num_slabs <= 0:
            raise ValueError("slab_bytes and num_slabs must be positive")
        self.slab_bytes = int(slab_bytes)
        free = shm_free_bytes()
        if free is not None and free < self.slab_bytes * num_slabs:
            raise OSError("a ring of %d slabs of %d bytes needs %d bytes of /dev/shm, "
                          "%d are free" % (num_slabs, self.slab_bytes,
                                           self.slab_bytes * num_slabs, free))
        self._lock = threading.Lock()
        self._closed = False
        self._segs = []
        token = "%d_%s" % (os.getpid(), os.urandom(4).hex())
        try:
            for i in range(num_slabs):
                self._segs.append(shared_memory.SharedMemory(
                    create=True, size=self.slab_bytes,
                    name="%s%s_%d" % (SEGMENT_PREFIX, token, i)))
        except BaseException:
            self.close()  # a half-built ring must not leak its earlier segments
            raise
        self.names = [seg.name for seg in self._segs]
        self._free = queue.Queue()
        for i in range(num_slabs):
            self._free.put(i)
        #: ids out of the free list: release() takes only these, so a double release
        #: can never put one id in twice and grant one slab to two children
        self._granted = set()
        #: slab id -> weakref to the view-mode Lease issued over it (reclaim() revokes
        #: it rather than re-granting a slab a consumer still views)
        self._leases = {}
        self._grants = 0
        self._items = 0
        self._bytes_through = 0
        self._fallbacks = 0
        self._acquire_wait_s = 0.0

    def __len__(self):
        return len(self._segs)

    def acquire(self, timeout=2.0):
        """A free slab id, or None after ``timeout`` seconds (0: at once); that item
        then takes the socket wire, so the pool never blocks on the ring."""
        if self._closed:
            return None
        t0 = time.perf_counter()
        try:
            slab_id = self._free.get(timeout=timeout) if timeout > 0 \
                else self._free.get_nowait()
        except queue.Empty:
            slab_id = None
        waited = time.perf_counter() - t0
        with self._lock:
            self._acquire_wait_s += waited
            if slab_id is not None:
                self._grants += 1
                self._granted.add(slab_id)
        return slab_id

    def release(self, slab_id):
        """Return a slab to the free list (no-op after close()). An id that is not
        granted is ignored and counted: a double release must never insert a slab
        twice."""
        if self._closed:
            return
        with self._lock:
            if slab_id not in self._granted:
                degradation("shm_double_release", "slab %s released while not granted "
                            "(double release suppressed)", slab_id, once=False)
                return
            self._granted.discard(slab_id)
            self._leases.pop(slab_id, None)
        self._free.put(slab_id)

    def register_lease(self, slab_id, lease):
        """Record the consumer lease over a granted slab (view-mode deliveries); the
        entry drops when the lease's release returns the slab."""
        with self._lock:
            if slab_id in self._granted:
                self._leases[slab_id] = weakref.ref(lease)

    def reclaim(self, slab_id):
        """The dead-child path: return the slab, or, when a consumer lease still views
        it, revoke that lease (its holder's release returns the slab later)."""
        if self._closed:
            return
        with self._lock:
            ref = self._leases.pop(slab_id, None)
        lease = ref() if ref is not None else None
        if lease is not None and hasattr(lease, "revoke"):
            lease.revoke()
            degradation("lease_revoked_on_reclaim", "slab %s reclaimed from a dead child "
                        "while a consumer lease was outstanding; the lease was revoked",
                        slab_id, once=False)
            return
        self.release(slab_id)

    def buffer(self, slab_id):
        """Writable memoryview over one slab."""
        return self._segs[slab_id].buf

    def add_bytes(self, n):
        """Count one item delivered through a slab, of ``n`` bytes."""
        with self._lock:
            self._items += 1
            self._bytes_through += int(n)

    def count_fallback(self):
        with self._lock:
            self._fallbacks += 1

    def stats(self):
        """Wire gauges: slab occupancy, grants, items and bytes through the slabs, socket
        fallbacks (an empty ring, or a payload larger than a slab), cumulative acquire
        wait."""
        with self._lock:
            in_flight = len(self._segs) - self._free.qsize() if not self._closed else 0
            return {
                "shm_slabs_total": len(self._segs),
                "shm_slab_bytes": self.slab_bytes,
                "shm_slabs_in_flight": in_flight,
                "shm_grants": self._grants,
                "shm_items": self._items,
                "shm_bytes": self._bytes_through,
                "shm_fallbacks": self._fallbacks,
                "shm_acquire_wait_s": round(self._acquire_wait_s, 4),
            }

    def close(self):
        """Unlink and unmap every segment (idempotent). Runs after the children are
        reaped; a consumer still holding views defers the unmap to its last view, but
        the ``/dev/shm`` entry goes here either way."""
        with self._lock:
            self._closed = True
            segs, self._segs = self._segs, []
        for seg in segs:
            try:
                seg.unlink()
            except OSError:  # already gone, or a denial: nothing left to do here
                pass
            try:
                seg.close()
            except BufferError:
                # exported views still alive: the name is unlinked above and the mapping
                # frees with the last view; a no-op close keeps the segment's __del__
                # from retrying at garbage collection
                seg.close = _noop


class SlabClient:
    """Child-side view of the parent's ring, attached by name on first grant, detached
    (never unlinked) by ``close()``."""

    def __init__(self, names, slab_bytes):
        self._names = list(names)
        self.slab_bytes = int(slab_bytes)
        self._segs = {}

    def buffer(self, slab_id):
        seg = self._segs.get(slab_id)
        if seg is None:
            from multiprocessing import shared_memory

            seg = shared_memory.SharedMemory(name=self._names[slab_id])
            _untrack(seg)
            self._segs[slab_id] = seg
        return seg.buf

    def close(self):
        segs, self._segs = self._segs, {}
        for seg in segs.values():
            try:
                seg.close()
            except Exception:  # noqa: BLE001 — exit path
                pass
