"""Row-group result caches: ``CacheBase``, ``NullCache``, ``LocalDiskCache`` and
``make_cache``.

Port of ``petastorm_tpu.cache`` (capability parity with the reference petastorm's
``cache.py`` and ``local_disk_cache.py``): memoize decoded row-group results on local
disk keyed by the reader's ``_cache_key`` (url, piece, schema, predicate, filters,
row-drop partition, device staging). ``LocalDiskCache`` is a small self-contained file
cache: one file a key (sha256 name), pickle or Arrow IPC payloads, LRU-by-mtime
eviction against a size limit, and writes through a per-writer temporary name so
processes and threads may share one directory. The reader workers cache their payloads
with pickle; the Arrow IPC serializer serves direct users caching pyarrow Tables
(memory-mapped reads). A corrupt or vanished entry is refilled, and a failed write
serves the value uncached; both count the degradation ``disk_cache``
(``parallel.shm_ring.degradation_counts()``).
"""
from __future__ import annotations

import hashlib
import os
import pickle

from petastorm_tpu_torch.parallel.shm_ring import degradation


class CacheBase:
    def get(self, key, fill_cache_func):
        """Return cached value for ``key``; on miss call ``fill_cache_func()``, store, return."""
        raise NotImplementedError

    def contains(self, key):
        """Cheap (possibly stale) membership probe: the readahead layer skips
        prefetching row groups the cache will serve anyway. ``False`` is always a safe
        answer."""
        return False

    def invalidate(self, key):
        """Drop the entry for ``key`` if present. A no-op default: caches that hold
        nothing have nothing to drop."""

    def cleanup(self):
        pass


class NullCache(CacheBase):
    """No caching: always calls the fill function (reference ~L20)."""

    def get(self, key, fill_cache_func):
        return fill_cache_func()


class LocalDiskCache(CacheBase):
    """File-per-key local disk cache with LRU-by-mtime eviction.

    ``serializer``: 'pickle' (any python value) or 'arrow' (pyarrow.Table payloads, IPC format —
    the reference's LocalDiskArrowTableCache equivalent).
    """

    def __init__(self, path, size_limit_bytes=None, expected_row_size_bytes=None,
                 serializer="pickle", cleanup=False, **_ignored):
        self._path = path
        self._size_limit = size_limit_bytes
        self._serializer = serializer
        self._cleanup_on_exit = cleanup
        os.makedirs(path, exist_ok=True)

    def _key_path(self, key):
        digest = hashlib.sha256(str(key).encode("utf-8")).hexdigest()
        ext = "arrow" if self._serializer == "arrow" else "pkl"
        return os.path.join(self._path, "%s.%s" % (digest, ext))

    def contains(self, key):
        return os.path.exists(self._key_path(key))

    def invalidate(self, key):
        """Unlink the entry for ``key``. The cache has no validation of its own:
        entries are only as fresh as their keys (a source file rewritten in place keeps
        its keys; the generation-scoped keys of dataset watching are ROADMAP.md Queue 1
        item 8c)."""
        try:
            os.unlink(self._key_path(key))
        except OSError:
            pass  # absent (or concurrently evicted) is the goal state

    def get(self, key, fill_cache_func):
        fpath = self._key_path(key)
        if os.path.exists(fpath):
            try:
                value = self._read(fpath)
                try:  # touch for LRU; a concurrent evictor may have unlinked it
                    os.utime(fpath)
                except OSError:
                    pass
                return value
            except Exception as e:  # noqa: BLE001 - corrupt/vanished entry: refill
                degradation(
                    "disk_cache",
                    "disk cache read failed for %s (%s); refilling from source",
                    fpath, e)
                try:  # another process sharing the cache dir may have unlinked it already
                    os.unlink(fpath)
                except OSError:
                    pass
        value = fill_cache_func()
        try:
            self._write(fpath, value)
        except Exception as e:  # noqa: BLE001 — a full/readonly disk must not fail the read
            degradation(
                "disk_cache",
                "disk cache write failed for %s (%s); serving uncached", fpath, e)
            return value
        if self._size_limit:
            self._evict()
        return value

    def _read(self, fpath):
        if self._serializer == "arrow":
            import pyarrow as pa

            with pa.memory_map(fpath) as source:
                return pa.ipc.open_file(source).read_all()
        with open(fpath, "rb") as f:
            return pickle.load(f)

    def _write(self, fpath, value):
        # the tmp name is unique per WRITER, not per process: two pool threads filling
        # the same key at once would interleave writes into a shared tmp file, and the
        # loser's os.replace would raise FileNotFoundError after the winner moved it
        import uuid

        tmp = "%s.tmp.%s" % (fpath, uuid.uuid4().hex)
        try:
            if self._serializer == "arrow":
                import pyarrow as pa

                with pa.OSFile(tmp, "wb") as sink:
                    with pa.ipc.new_file(sink, value.schema) as writer:
                        writer.write_table(value)
            else:
                with open(tmp, "wb") as f:
                    pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, fpath)
        except BaseException:
            try:  # don't orphan a half-written tmp for the grace-period sweep
                os.unlink(tmp)
            except OSError:
                pass
            raise

    #: tmp files older than this are considered orphans of a crashed writer and are
    #: reclaimed by eviction; younger ones are in-flight (unlinking those would make
    #: the writer's os.replace fail)
    TMP_ORPHAN_GRACE_S = 300

    def _evict(self):
        import time

        entries = []
        total = 0
        now = time.time()
        for name in os.listdir(self._path):
            fpath = os.path.join(self._path, name)
            try:
                st = os.stat(fpath)
            except OSError:
                continue
            if ".tmp." in name:
                if now - st.st_mtime > self.TMP_ORPHAN_GRACE_S:
                    try:  # orphan of a SIGKILLed writer: reclaim the space
                        os.unlink(fpath)
                    except OSError:
                        pass
                continue  # in-flight writer: never unlink, never count
            entries.append((st.st_mtime, st.st_size, fpath))
            total += st.st_size
        entries.sort()
        for _, size, fpath in entries:
            if total <= self._size_limit:
                break
            try:
                os.unlink(fpath)
                total -= size
            except OSError:
                pass

    def cleanup(self):
        # ignore_errors covers concurrent removal too: two readers sharing one
        # cache dir may both clean up at exit, and files vanishing between the
        # tree walk and the unlink must not raise
        if self._cleanup_on_exit:
            import shutil

            shutil.rmtree(self._path, ignore_errors=True)


def make_cache(cache_type, cache_location=None, cache_size_limit=None,
               cache_row_size_estimate=None, cache_extra_settings=None):
    """Factory matching the reference's ``cache_type`` reader kwargs ('null'|'local-disk').

    Reader workers cache python/numpy payloads, so the pickle serializer is used; the 'arrow'
    serializer remains available to direct :class:`LocalDiskCache` users holding pyarrow Tables.
    """
    if cache_type in (None, "null"):
        return NullCache()
    if cache_type == "local-disk":
        if not cache_location:
            raise ValueError("cache_type='local-disk' requires cache_location")
        return LocalDiskCache(
            cache_location,
            size_limit_bytes=cache_size_limit,
            expected_row_size_bytes=cache_row_size_estimate,
            **(cache_extra_settings or {}),
        )
    raise ValueError("Unknown cache_type %r (expected 'null' or 'local-disk')" % cache_type)
