"""One read funnel: MemCache → LocalDiskCache → the store, with an admission policy.

Port of ``petastorm_tpu.io.tiers``. :class:`TieredCache` is the one funnel every worker
read goes through:

- **Per-tier accounting**: every serve is attributed to the tier that served it,
  ``mem``, ``arena`` (a peer's entry mapped from the host-wide cache arena), ``disk`` or
  ``remote`` (a real read of the store, local or not), with its payload bytes (:meth:`TieredCache.stats`: ``tier_<tier>_hits`` and
  ``tier_<tier>_bytes``). Warm epochs should be mem or disk served.
- **Admission policy** (``disk_admit``): ``"always"`` writes every store read to the
  disk tier. ``"scan-resistant"`` does not write a value the mem tier just admitted (it
  will serve from memory) and admits nothing to disk on a single-epoch scan (each row
  group read once, nothing re-read). Disk hits are served either way.

The funnel degrades to its parts: no mem budget, no mem tier; ``cache_type="null"``,
a disk tier that holds nothing. The mem tier's read-only serving contract is
:class:`~petastorm_tpu_torch.io.memcache.MemCache`'s, which also holds the arena tier
and reports which of the two served. The funnel's counts reach the registry as
``ptpu_io_*`` through ``Reader.io_stats()`` (a loader's ``io`` collector). A funnel built
for a tagged reader (``tenant=``) also charges each serve's payload bytes to its tenant's
``read_bytes`` (:mod:`petastorm_tpu_torch.obs.tenant`). The admission policy is a live
knob (:meth:`TieredCache.apply_disk_admit`). With the provenance plane armed each serve
annotates its item's ``cache_tier`` with the tier that served it.
"""
from __future__ import annotations

import threading

from petastorm_tpu_torch.cache import CacheBase, NullCache
from petastorm_tpu_torch.io.memcache import payload_nbytes
from petastorm_tpu_torch.obs import provenance as _prov
from petastorm_tpu_torch.obs import tenant as _tenant

#: serve-attribution tiers, hot to cold: ``arena`` sits between this process's mem
#: store and the disk tier (a shared mapping costs less than a disk read, more than a
#: local dict hit: a cross-process lock and a map)
TIERS = ("mem", "arena", "disk", "remote")


class TieredCache(CacheBase):
    """The MemCache → disk cache → store read funnel (one a reader; thin and picklable,
    a pool child starts its tier counts at zero).

    ``mem`` is a :class:`~petastorm_tpu_torch.io.memcache.MemCache` or ``None``;
    ``disk`` any :class:`~petastorm_tpu_torch.cache.CacheBase` (a ``LocalDiskCache``, or
    ``NullCache`` for uncached readers). ``single_epoch`` is the reader's scan hint
    (``num_epochs == 1``) that ``scan-resistant`` consumes. ``clear()``/``cleanup()``
    release the mem tier's bytes. ``tenant`` is the reader's tenant slug (a plain string:
    it survives the pickle into a pool child)."""

    def __init__(self, mem=None, disk=None, disk_admit="always", single_epoch=False,
                 tenant=None):
        if disk_admit not in ("always", "scan-resistant"):
            raise ValueError("disk_admit must be 'always' or 'scan-resistant', "
                             "got %r" % (disk_admit,))
        self._mem = mem
        self._disk = disk if disk is not None else NullCache()
        self._disk_admit = disk_admit
        self._single_epoch = bool(single_epoch)
        self._tenant = tenant
        self._counts_lock = threading.Lock()
        self._counts = {t: [0, 0] for t in TIERS}

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_counts_lock"] = None
        state["_counts"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._counts_lock = threading.Lock()
        self._counts = {t: [0, 0] for t in TIERS}

    def _count(self, tier, value):
        n = payload_nbytes(value)
        with self._counts_lock:
            slot = self._counts[tier]
            slot[0] += 1
            slot[1] += n
        if self._tenant is not None:
            _tenant.charge("read_bytes", n, label=self._tenant)

    def _admit_disk(self, value):
        """Should this store-read ``value`` go to the disk tier? Decided from the value:
        ``scan-resistant`` skips disk only for what the mem tier will hold (a payload the
        mem tier rejects as oversized still earns its disk slot)."""
        if self._disk_admit == "always":
            return True
        if self._single_epoch:
            return False  # scan resistance: a one-shot sweep does not earn disk
        if self._mem is not None and self._mem.would_admit(value):
            return False  # the mem tier serves it; no second copy
        return True

    def _through_disk(self, key, fill, served):
        """The disk tier, then the store, honouring the admission policy."""
        def from_store():
            served[0] = "remote"
            return fill()

        served[0] = "disk"
        if isinstance(self._disk, NullCache):
            return from_store()
        if self._disk_admit == "always":
            return self._disk.get(key, from_store)
        # scan-resistant: serve hits; on a miss read the store first and admit by value
        # (a disk .get would write through unconditionally)
        if self._disk.contains(key):
            return self._disk.get(key, from_store)
        value = from_store()
        if self._admit_disk(value):
            self._disk.get(key, lambda: value)  # a miss: stores the value
        return value

    def get(self, key, fill_cache_func):
        served = ["mem"]
        if self._mem is not None:
            # the mem tier sets served[0] to "arena" when the payload came off the
            # host-wide mapping instead of the local store
            value = self._mem.get(
                key, lambda: self._through_disk(key, fill_cache_func, served),
                served=served)
        else:
            value = self._through_disk(key, fill_cache_func, served)
        self._count(served[0], value)
        if _prov.ACTIVE is not None:  # which tier fed this item
            _prov.annotate("cache_tier", served[0])
        return value

    def get_writable(self, key, fill_cache_func):
        """The mem tier's copy-on-write escalation through the funnel (opaque host
        ``TransformSpec`` consumers, see ``MemCache``)."""
        served = ["mem"]
        if self._mem is not None:
            value = self._mem.get_writable(
                key, lambda: self._through_disk(key, fill_cache_func, served),
                served=served)
        else:
            value = self._through_disk(key, fill_cache_func, served)
        self._count(served[0], value)
        if _prov.ACTIVE is not None:  # which tier fed this item
            _prov.annotate("cache_tier", served[0])
        return value

    def apply_disk_admit(self, policy):
        """Retune the disk admission policy live; it applies from the next store read
        (entries already on disk stay)."""
        if policy not in ("always", "scan-resistant"):
            raise ValueError("disk_admit must be 'always' or 'scan-resistant', "
                             "got %r" % (policy,))
        self._disk_admit = policy
        return policy

    @property
    def disk_admit(self):
        return self._disk_admit

    @property
    def mem(self):
        """The mem tier (:class:`~petastorm_tpu_torch.io.memcache.MemCache`) or None."""
        return self._mem

    def contains(self, key):
        if self._mem is not None and self._mem.contains(key):
            return True
        return self._disk.contains(key)

    def invalidate(self, key):
        if self._mem is not None:
            self._mem.invalidate(key)
        self._disk.invalidate(key)

    def clear(self):
        if self._mem is not None:
            self._mem.clear()

    def stats(self):
        out = {}
        if self._mem is not None:
            out.update(self._mem.stats())
        stats_fn = getattr(self._disk, "stats", None)
        if stats_fn is not None:
            out.update(stats_fn())
        with self._counts_lock:
            for tier, (hits, nbytes) in self._counts.items():
                out["tier_%s_hits" % tier] = hits
                out["tier_%s_bytes" % tier] = nbytes
        return out

    def cleanup(self):
        self.clear()
        self._disk.cleanup()
