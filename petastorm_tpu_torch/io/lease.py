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

The JAX package publishes these counters on its metrics registry; the port keeps them
as plain in-module counters behind :func:`lease_stats` and :func:`copy_census` (the
registry is ROADMAP.md Queue 1 item 8). A lease dropped without a release reclaims at
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
_stats = dict.fromkeys(("acquired", "released", "retained", "cow", "revoked", "leaked",
                        "active"), 0)
#: live leases by ``kind`` (``"slab"``, ``"memcache"``, ``"arena"``, ``"remote_get"``,
#: ...): the census of who holds what
_active_kinds = {}


def _bump(name, delta=1):
    with _stats_lock:
        _stats[name] += delta


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
        with _stats_lock:
            _stats["acquired"] += 1
            _stats["active"] += 1
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
        with _stats_lock:
            _stats["released"] += 1
            _stats["active"] -= 1
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
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

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


_census = {}


def count_copy(site, nbytes):
    """Charge ``nbytes`` to ``site`` in the copy census (zero-byte charges dropped)."""
    if nbytes:
        with _stats_lock:
            _census[site] = _census.get(site, 0) + int(nbytes)


def copy_census():
    """``{site: bytes copied}`` since the process started."""
    with _stats_lock:
        return dict(_census)


def active_leases_by_kind():
    """``{kind: live leases}``, every kind a lease was ever made of (0 when none is
    live)."""
    with _stats_lock:
        return dict(_active_kinds)


def lease_stats():
    """``{acquired, released, retained, cow, revoked, leaked, active}`` since the
    process started."""
    with _stats_lock:
        return dict(_stats)
