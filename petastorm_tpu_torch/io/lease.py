"""Buffer leases for the zero-copy batch path.

Port of ``petastorm_tpu.io.lease``. A batch delivered over the process pool's shared
memory view wire holds read-only views into a slab that the pool reuses once the batch
is done; a :class:`Lease` is the refcounted claim that keeps the slab out of reuse until
every holder has released it.

- :class:`Lease`: ``retain()`` adds a holder, ``release()`` drops one; the owner's
  reclaim callback fires exactly once, when the last holder releases. ``revoke()`` lets
  the owner invalidate outstanding views (``Reader.reset()`` rebuilds the pool): lease
  aware accessors then raise :class:`~petastorm_tpu_torch.errors.LeaseRevoked`.
- :class:`LeasedBatch`: a columnar batch dict riding one or more leases; key access
  checks revocation, ``writable()`` copies one column on demand.
- The copy census: ``count_copy(site, nbytes)`` at every copy site of the batch path
  (``wire_writable`` and ``wire_owned`` in the serializers, ``lease_cow``,
  ``loader_detach`` where the loader copies views out), read with :func:`copy_census`.

The counters are the JAX package's ``ptpu_lease_*`` families and the
``ptpu_copy_bytes_total{site=...}`` census on the process-wide metrics registry
(:func:`petastorm_tpu_torch.obs.metrics.default_registry`); :func:`lease_stats` and
:func:`copy_census` read them as flat dicts. A lease dropped without a release reclaims at
garbage collection, so an abandoned batch cannot wedge a ring, and counts as leaked.
"""
from __future__ import annotations

import threading

import numpy as np

from petastorm_tpu_torch.errors import LeaseError, LeaseRevoked

#: key under which a batch's lease rides inside a tagged columnar payload crossing the
#: wire; the Reader pops it before exposing the batch
LEASE_KEY = "__lease__"

# re-entrant: a lease reclaimed by the garbage collector may run inside a holder of it
_stats_lock = threading.RLock()
#: live leases by ``kind`` (``"slab"``, ``"memcache"``, ``"arena"``, ``"remote_get"``,
#: ...): the census of who holds what
_active_kinds = {}


class _LeaseMetrics:
    """The process-wide ``ptpu_lease_*`` families (resolved at the first lease, so the
    registry import stays off the module's import path)."""

    __slots__ = ("acquired", "released", "retained", "cow", "revoked", "leaked",
                 "active")

    def __init__(self):
        from petastorm_tpu_torch.obs.metrics import default_registry

        reg = default_registry()
        self.acquired = reg.counter(
            "ptpu_lease_acquired_total", help="leases created over borrowed buffers")
        self.released = reg.counter(
            "ptpu_lease_released_total",
            help="leases fully released (owner reclaim callback fired)")
        self.retained = reg.counter(
            "ptpu_lease_retained_total", help="additional holders added via retain()")
        self.cow = reg.counter(
            "ptpu_lease_cow_total",
            help="copy-on-write escalations (a consumer actually wrote)")
        self.revoked = reg.counter(
            "ptpu_lease_revoked_total",
            help="leases invalidated by their buffer owner (reset/teardown)")
        self.leaked = reg.counter(
            "ptpu_lease_leaked_total",
            help="leases reclaimed by GC instead of an explicit release")
        self.active = reg.gauge(
            "ptpu_lease_active", help="leases currently alive (refcount > 0)")


_metrics = None


def _lease_metrics():
    global _metrics
    if _metrics is None:
        with _stats_lock:
            if _metrics is None:
                _metrics = _LeaseMetrics()
    return _metrics


def _bump(name, delta=1):
    getattr(_lease_metrics(), name).inc(delta)


class Lease:
    """One refcounted claim over read-only buffers owned by someone else.

    The constructor is the acquire (refcount 1). ``release_cb`` is the owner's reclaim
    hook (return a slab to its ring) and fires exactly once, when the count reaches
    zero. Thread-safe: batches cross the loader's producer and transfer threads and each
    may hold a retain."""

    __slots__ = ("_release_cb", "_refs", "_lock", "_revoked", "kind", "__weakref__")

    def __init__(self, release_cb=None, kind="lease"):
        self._release_cb = release_cb
        self._refs = 1
        self._lock = threading.Lock()
        self._revoked = False
        self.kind = kind
        m = _lease_metrics()
        m.acquired.inc()
        m.active.inc()
        with _stats_lock:
            _active_kinds[kind] = _active_kinds.get(kind, 0) + 1

    def retain(self):
        """Add a holder; returns ``self``."""
        with self._lock:
            if self._refs <= 0:
                raise LeaseError(
                    "retain() on a fully-released %s lease: its buffers are already "
                    "back with their owner" % self.kind)
            self._refs += 1
        _bump("retained")
        return self

    def release(self):
        """Drop one holder; the owner's reclaim callback runs at zero. Releasing past
        zero raises :class:`~petastorm_tpu_torch.errors.LeaseError`."""
        with self._lock:
            if self._refs <= 0:
                raise LeaseError("release() on an already-released %s lease (double "
                                 "release)" % self.kind)
            self._refs -= 1
            final = self._refs == 0
        if final:
            self._reclaim()

    def _reclaim(self):
        cb, self._release_cb = self._release_cb, None
        m = _lease_metrics()
        m.released.inc()
        m.active.dec()
        with _stats_lock:
            _active_kinds[self.kind] -= 1
        if cb is not None:
            cb()

    def revoke(self):
        """Owner-side invalidation: holders keep their refcounts (their releases stay
        balanced) but :meth:`check` and every :class:`LeasedBatch` accessor raise."""
        with self._lock:
            if self._revoked:
                return
            self._revoked = True
        _bump("revoked")

    @property
    def revoked(self):
        return self._revoked

    @property
    def alive(self):
        return self._refs > 0

    def check(self):
        """Raise :class:`~petastorm_tpu_torch.errors.LeaseRevoked` when the owner
        invalidated the buffers behind this lease."""
        if self._revoked:
            raise LeaseRevoked(
                "%s lease was revoked by its buffer owner (e.g. Reader.reset() rebuilt "
                "the pool backing this batch); the views are no longer valid" % self.kind)

    def __del__(self):
        try:
            with self._lock:
                refs, self._refs = self._refs, 0
            if refs > 0:
                # abandoned holder(s): reclaim so the owner's pool cannot wedge, but
                # count it: buffer return timed by the garbage collector is a caller bug
                _bump("leaked")
                self._reclaim()
        except Exception:  # noqa: BLE001
            pass  # graftlint: disable=GL-O002 (GC/exit path: metrics may be torn down)

    def __repr__(self):
        return "<Lease kind=%s refs=%d%s>" % (
            self.kind, self._refs, " REVOKED" if self._revoked else "")


class LeasedBatch(dict):
    """A columnar batch (``{name: ndarray}``) riding the lease(s) that own its buffers.
    A plain dict on the hot paths; key access also checks revocation, and
    :meth:`writable` copies one column. ``release()`` drops every lease once."""

    __slots__ = ("leases",)

    def __init__(self, columns=(), leases=()):
        super().__init__(columns)
        self.leases = tuple(leases)

    def _check(self):
        for lease in self.leases:
            lease.check()

    def __getitem__(self, key):
        self._check()
        return super().__getitem__(key)

    def get(self, key, default=None):
        self._check()
        return super().get(key, default)

    def items(self):
        self._check()
        return super().items()

    def values(self):
        self._check()
        return super().values()

    def writable(self, name):
        """Replace column ``name``'s read-only view with an owned writable copy
        (counted in the copy census) and return it."""
        arr = self[name]
        if isinstance(arr, np.ndarray) and not arr.flags.writeable:
            _bump("cow")
            arr = arr.copy()
            count_copy("lease_cow", arr.nbytes)
            super().__setitem__(name, arr)
        return arr

    def release(self):
        """Release every lease this batch holds (idempotent at the batch level)."""
        leases, self.leases = self.leases, ()
        for lease in leases:
            lease.release()


def attach_leases(batch, leases):
    """``batch`` as a :class:`LeasedBatch` holding ``leases``; ``batch`` unchanged when
    there are none."""
    if not leases:
        return batch
    if isinstance(batch, LeasedBatch):
        batch.leases = tuple(batch.leases) + tuple(leases)
        return batch
    return LeasedBatch(batch, leases)


def take_leases(batch):
    """Detach and return a batch's leases (``()`` for plain dicts): the caller now owns
    them and releases them when it is done with the batch's buffers."""
    if isinstance(batch, LeasedBatch):
        leases, batch.leases = batch.leases, ()
        return leases
    return ()


def readonly_view(value):
    """``value`` rebuilt with every ndarray replaced by a read-only zero-copy view
    (fresh containers, shared buffers). Object arrays get fresh outer arrays whose
    ndarray elements are read-only views too."""
    if isinstance(value, np.ndarray):
        if value.dtype == object:
            out = np.empty(value.shape, dtype=object)
            out_flat, in_flat = out.reshape(-1), value.reshape(-1)
            for i in range(in_flat.size):
                out_flat[i] = readonly_view(in_flat[i])
            return out
        view = value.view()
        view.flags.writeable = False
        return view
    if isinstance(value, dict):
        return {k: readonly_view(v) for k, v in value.items()}
    if isinstance(value, list):
        return [readonly_view(v) for v in value]
    if isinstance(value, tuple):
        return tuple(readonly_view(v) for v in value)
    return value


#: the copy sites the port charges: documentation, and a tripwire for a misspelt site
#: in a benchmark's assertion (a new site registers at its first charge all the same)
KNOWN_SITES = (
    "wire_writable",   # the default wire's writable-contract copy (serializers)
    "wire_owned",      # a shm pickle payload backed by owned buffers (serializers)
    "memcache_hit",    # the writable-hit deep copy (memcache writable_hits=True)
    "memcache_admit",  # the miss path's copy (memcache writable_hits=True)
    "memcache_cow",    # the writable escalation of a leased entry
    "lease_cow",       # LeasedBatch.writable()
    "loader_detach",   # the loader's copy out of view columns (shuffle, host only)
    "arena_admit",     # the one copy into the shared cache arena (io/arena.py)
)

_census = {}  # site -> its ptpu_copy_bytes_total{site=...} counter


def _site_counter(site):
    counter = _census.get(site)
    if counter is None:
        from petastorm_tpu_torch.obs.metrics import default_registry

        with _stats_lock:
            counter = _census.get(site)
            if counter is None:
                counter = _census[site] = default_registry().counter(
                    "ptpu_copy_bytes_total",
                    help="payload bytes memcpy'd on the batch path, by site", site=site)
    return counter


def count_copy(site, nbytes):
    """Charge ``nbytes`` to ``site`` in the copy census (zero-byte charges dropped)."""
    if nbytes:
        _site_counter(site).inc(int(nbytes))


def copy_census():
    """``{site: bytes copied}`` since the process started."""
    with _stats_lock:
        return {site: counter.value for site, counter in _census.items()}


def active_leases_by_kind():
    """``{kind: live leases}``, every kind a lease was ever made of (0 when none is
    live)."""
    with _stats_lock:
        return dict(_active_kinds)


def lease_stats():
    """``{acquired, released, retained, cow, revoked, leaked, active}`` since the
    process started (the ``ptpu_lease_*`` counters as a flat dict)."""
    m = _lease_metrics()
    return {name: getattr(m, name).value for name in _LeaseMetrics.__slots__}
