"""The port's row-group caches against the JAX package's: ``NullCache``,
``LocalDiskCache`` (pickle and Arrow IPC), ``make_cache`` and the tiered funnel
(``io/tiers.py``: mem → disk → the store, with ``disk_admit``). The cache cases of the
JAX package's ``tests/test_cache_and_selectors.py`` case for case, the funnel's
admission policy and per-tier counts, and a disk cache directory shared by the two
packages (same file names, same pickles)."""
import contextlib
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

from petastorm_tpu import cache as ref_cache  # noqa: E402
from petastorm_tpu.io import memcache as ref_memcache  # noqa: E402
from petastorm_tpu_torch.cache import LocalDiskCache, NullCache, make_cache  # noqa: E402
from petastorm_tpu_torch.io.memcache import MemCache, _Store, shared_store  # noqa: E402
from petastorm_tpu_torch.io.tiers import TieredCache  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clear_memcaches():
    yield
    shared_store().clear()
    ref_memcache.shared_store().clear()


# -- the JAX package's cache cases ------------------------------------------------------


def test_null_cache_always_fills():
    calls = []
    c = NullCache()
    assert c.get("k", lambda: calls.append(1) or 42) == 42
    assert c.get("k", lambda: calls.append(1) or 42) == 42
    assert len(calls) == 2
    assert not c.contains("k")


def test_disk_cache_memoizes(tmp_path):
    calls = []
    c = LocalDiskCache(str(tmp_path))

    def fill():
        calls.append(1)
        return {"a": np.arange(5)}

    v1 = c.get("key1", fill)
    v2 = c.get("key1", fill)
    assert len(calls) == 1
    np.testing.assert_array_equal(v1["a"], v2["a"])
    assert c.contains("key1") and not c.contains("key2")


def test_disk_cache_arrow_serializer(tmp_path):
    import pyarrow as pa

    c = LocalDiskCache(str(tmp_path), serializer="arrow")
    t = pa.table({"x": [1, 2, 3]})
    c.get("k", lambda: t)
    out2 = c.get("k", lambda: (_ for _ in ()).throw(AssertionError("should hit cache")))
    assert out2.column("x").to_pylist() == [1, 2, 3]


def test_disk_cache_eviction(tmp_path):
    c = LocalDiskCache(str(tmp_path), size_limit_bytes=2000)
    for i in range(50):
        c.get("k%d" % i, lambda i=i: np.zeros(100))
    total = sum(os.path.getsize(os.path.join(str(tmp_path), f))
                for f in os.listdir(str(tmp_path)))
    assert total <= 4000  # bounded (the limit plus one entry's slack)


def test_make_cache_factory(tmp_path):
    assert isinstance(make_cache("null"), NullCache)
    assert isinstance(make_cache(None), NullCache)
    assert isinstance(make_cache("local-disk", str(tmp_path / "c")), LocalDiskCache)
    with pytest.raises(ValueError):
        make_cache("local-disk")
    with pytest.raises(ValueError):
        make_cache("bogus")


def test_local_disk_cache_concurrent_processes(tmp_path):
    """Processes sharing one cache directory: concurrent fills and reads of the same
    keys never corrupt an entry or return a mismatched value."""
    script = r"""
import sys
import numpy as np
sys.path.insert(0, %r)
from petastorm_tpu_torch.cache import LocalDiskCache

cache = LocalDiskCache(%r, size_limit_bytes=None)
for round_ in range(30):
    for key in range(8):
        expected = np.full((64,), key, dtype=np.int64)
        got = cache.get("k-%%d" %% key, lambda k=key: np.full((64,), k, dtype=np.int64))
        assert (got == expected).all(), (key, got[:4])
print("ok")
"""
    cache_dir = str(tmp_path / "shared_cache")
    procs = [subprocess.Popen([sys.executable, "-c", script % (ROOT, cache_dir), str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(3)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0 and "ok" in out, out[-2000:]


def test_local_disk_cache_concurrent_threads(tmp_path):
    cache = LocalDiskCache(str(tmp_path / "tcache"))
    errors = []

    def worker():
        try:
            for _ in range(50):
                for key in range(6):
                    got = cache.get("k-%d" % key, lambda k=key: list(range(k, k + 10)))
                    assert got == list(range(key, key + 10))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


def test_eviction_reclaims_orphaned_tmp_files(tmp_path):
    cache = LocalDiskCache(str(tmp_path / "c"), size_limit_bytes=10_000)
    cache.get("k", lambda: list(range(100)))
    orphan = str(tmp_path / "c" / "deadbeef.pkl.tmp.abc123")
    young = str(tmp_path / "c" / "cafe.pkl.tmp.def456")
    for p in (orphan, young):
        with open(p, "wb") as f:
            f.write(b"x" * 64)
    old = time.time() - LocalDiskCache.TMP_ORPHAN_GRACE_S - 10
    os.utime(orphan, (old, old))
    cache.get("k2", lambda: list(range(100)))  # triggers an eviction pass
    assert not os.path.exists(orphan)
    assert os.path.exists(young)


def test_disk_cache_invalidate_and_cleanup(tmp_path):
    c = LocalDiskCache(str(tmp_path / "c"), cleanup=True)
    c.get("k", lambda: 1)
    c.invalidate("k")
    assert not c.contains("k")
    c.invalidate("never-there")  # absent is the goal state
    c.get("k", lambda: 2)
    c.cleanup()
    assert not os.path.exists(str(tmp_path / "c"))


# -- a cache directory shared with the JAX package --------------------------------------


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_disk_cache_directory_is_shared_with_the_reference(tmp_path, writer):
    """Same key → same file name (sha256 of the key), same pickle: an entry one package
    wrote serves the other."""
    key = "/data/part-0.parquet|3|id,image||0/1|"
    value = {"id": np.arange(4), "name": np.array(["a", "b", "c", "d"], dtype=object)}
    ours = LocalDiskCache(str(tmp_path / "c"))
    theirs = ref_cache.LocalDiskCache(str(tmp_path / "c"))
    assert ours._key_path(key) == theirs._key_path(key)
    first, second = (ours, theirs) if writer == "port" else (theirs, ours)
    first.get(key, lambda: value)
    got = second.get(key, lambda: (_ for _ in ()).throw(AssertionError("miss")))
    np.testing.assert_array_equal(got["id"], value["id"])
    assert list(got["name"]) == ["a", "b", "c", "d"]


# -- the tiered funnel ------------------------------------------------------------------


def _mem(budget):
    """A MemCache over a private store (isolated from the shared store's raise-only
    budget)."""
    return MemCache(budget, store=_Store())


@contextlib.contextmanager
def _tiered(mem_budget=None, **kwargs):
    funnel = TieredCache(mem=_mem(mem_budget) if mem_budget else None, **kwargs)
    try:
        yield funnel
    finally:
        funnel.cleanup()


class _CountingDisk(LocalDiskCache):
    def __init__(self, path):
        super().__init__(path)
        self.writes = 0

    def _write(self, fpath, value):
        self.writes += 1
        super()._write(fpath, value)


def test_tiers_count_each_serve_once(tmp_path):
    fills = []

    def fill():
        fills.append(1)
        return {"x": np.arange(16, dtype=np.int64)}

    with _tiered(1 << 20, disk=LocalDiskCache(str(tmp_path / "d"))) as funnel:
        funnel.get("a", fill)  # the store
        funnel.get("a", fill)  # memory
        stats = funnel.stats()
        assert fills == [1]
        assert stats["tier_remote_hits"] == 1 and stats["tier_mem_hits"] == 1
        assert stats["tier_disk_hits"] == 0 and stats["tier_mem_bytes"] >= 128
        funnel.clear()
        funnel.get("a", fill)  # the memcache was cleared: disk serves
        assert funnel.stats()["tier_disk_hits"] == 1 and fills == [1]


def test_tiers_disk_admit_always_writes_every_store_read(tmp_path):
    disk = _CountingDisk(str(tmp_path / "d"))
    with _tiered(1 << 20, disk=disk, disk_admit="always", single_epoch=True) as funnel:
        funnel.get("a", lambda: {"x": np.zeros(4)})
    assert disk.writes == 1 and disk.contains("a")


def test_tiers_scan_resistant_skips_single_epoch_and_mem_held_values(tmp_path):
    disk = _CountingDisk(str(tmp_path / "d"))
    with _tiered(disk=disk, disk_admit="scan-resistant", single_epoch=True) as scan:
        scan.get("a", lambda: {"x": np.zeros(4)})
    assert disk.writes == 0  # a one-shot sweep does not earn disk
    with _tiered(1 << 20, disk=disk, disk_admit="scan-resistant") as held:
        held.get("b", lambda: {"x": np.zeros(4)})
    assert disk.writes == 0  # the mem tier holds it
    with _tiered(64, disk=disk, disk_admit="scan-resistant") as big:
        big.get("c", lambda: {"x": np.zeros(4096)})
        assert disk.writes == 1 and disk.contains("c")  # oversized for mem: disk keeps it
        big.get("c", lambda: (_ for _ in ()).throw(AssertionError("miss")))
        assert big.stats()["tier_disk_hits"] == 1


def test_tiers_get_writable_copies_through_the_mem_tier(tmp_path):
    with _tiered(1 << 20, disk=NullCache()) as funnel:
        first = funnel.get("a", lambda: {"x": np.arange(4)})
        assert not first["x"].flags.writeable
        owned = funnel.get_writable("a", lambda: None)
        owned["x"][:] = -1
        np.testing.assert_array_equal(funnel.get("a", lambda: None)["x"], np.arange(4))


def test_tiers_contains_and_invalidate_reach_every_tier(tmp_path):
    disk = LocalDiskCache(str(tmp_path / "d"))
    with _tiered(1 << 20, disk=disk) as funnel:
        funnel.get("a", lambda: {"x": np.zeros(2)})
        assert funnel.contains("a") and funnel.mem.contains("a") and disk.contains("a")
        funnel.invalidate("a")
        assert not funnel.contains("a")


def test_tiers_pickle_into_a_child_with_fresh_counts(tmp_path):
    import pickle

    with _tiered(1 << 20, disk=LocalDiskCache(str(tmp_path / "d")),
                 disk_admit="scan-resistant") as funnel:
        funnel.get("a", lambda: {"x": np.zeros(2)})
        clone = pickle.loads(pickle.dumps(funnel))
        assert clone.disk_admit == "scan-resistant"
        assert clone.stats()["tier_remote_hits"] == 0
        assert funnel.stats()["tier_remote_hits"] == 1
    with pytest.raises(ValueError):
        with _tiered(disk_admit="sometimes"):
            pass


def test_tiers_equal_reference_serves_and_counts(tmp_path):
    """The same sequence of gets through both packages' funnels: the same values and
    the same tier attribution, under both admission policies."""
    from petastorm_tpu.io.tiers import TieredCache as RefTiered

    rng = np.random.default_rng(1)
    keys = ["k%d" % int(k) for k in rng.integers(0, 6, 40)]
    for policy in ("always", "scan-resistant"):
        ref_mem = ref_memcache.MemCache(300, store=ref_memcache._Store())
        theirs = RefTiered(mem=ref_mem,
                           disk=ref_cache.LocalDiskCache(str(tmp_path / ("r-" + policy))),
                           disk_admit=policy)
        try:
            with _tiered(300, disk=LocalDiskCache(str(tmp_path / ("p-" + policy))),
                         disk_admit=policy) as ours:
                for k in keys:
                    n = 8 + 8 * int(k[1:])
                    a = ours.get(k, lambda n=n: {"x": np.arange(n)})
                    b = theirs.get(k, lambda n=n: {"x": np.arange(n)})
                    np.testing.assert_array_equal(a["x"], b["x"])
                s_ours, s_theirs = ours.stats(), theirs.stats()
        finally:
            theirs.cleanup()
            ref_mem.clear()
        for tier in ("mem", "disk", "remote"):
            assert s_ours["tier_%s_hits" % tier] == s_theirs.get("tier_%s_hits" % tier, 0)
