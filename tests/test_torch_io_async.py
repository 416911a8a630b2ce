"""The port's read path against the JAX package's: readahead, coalesced reads, the
work-stealing dispatcher, the plan's lookahead, the shared footer cache and the
in-memory row-group cache (ROADMAP.md Queue 1 item 5a).

Three kinds of case:

- the JAX package's own contracts (``tests/test_io_async.py``), case for case, on the
  port's modules;
- the pure planners and bookkeeping (``plan_runs``, ``plan_byte_ranges``,
  ``slice_ranges``, ``PullDispatcher``, ``EpochPlan.peek``, ``payload_nbytes`` on
  ndarrays, ``_cache_key``) fed the same seeded inputs as the JAX package's, outputs
  equal;
- one store read through both packages' factories with the same ``IoOptions``: rows
  equal per id, and the JPEG store's uint8 images bit-exact through the port's plain
  stage 2.

The cases of ``test_io_async.py`` that need ROADMAP.md item 8 (the registry's
``ptpu_io_file_evictions_total``) have no port counterpart yet; ``gpu``-marked cases run
the kernels on the card and skip here.
"""
import collections
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

import petastorm_tpu.io as ref_io  # noqa: E402
from petastorm_tpu import metadata as ref_metadata  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu import types as ref_types  # noqa: E402
from petastorm_tpu import workers as ref_workers  # noqa: E402
from petastorm_tpu.codecs import CompressedImageCodec as RefImage  # noqa: E402
from petastorm_tpu.codecs import NdarrayCodec as RefNdarray  # noqa: E402
from petastorm_tpu.codecs import ScalarCodec as RefScalar  # noqa: E402
from petastorm_tpu.io import coalesce as ref_coalesce  # noqa: E402
from petastorm_tpu.io import memcache as ref_memcache  # noqa: E402
from petastorm_tpu.plan import EpochPlan as RefEpochPlan  # noqa: E402
from petastorm_tpu.unischema import Unischema as RefSchema  # noqa: E402
from petastorm_tpu.unischema import UnischemaField as RefField  # noqa: E402
from petastorm_tpu_torch import make_batch_reader, make_reader  # noqa: E402
from petastorm_tpu_torch import reader as port_reader  # noqa: E402
from petastorm_tpu_torch.io import IoOptions  # noqa: E402
from petastorm_tpu_torch.io.coalesce import (plan_byte_ranges, plan_runs,  # noqa: E402
                                             slice_ranges, split_run_table)
from petastorm_tpu_torch.io.memcache import MemCache, payload_nbytes, shared_store  # noqa: E402
from petastorm_tpu_torch.io.readahead import ReadaheadPool  # noqa: E402
from petastorm_tpu_torch.parallel.shm_ring import degradation_counts  # noqa: E402
from petastorm_tpu_torch.plan import EpochPlan  # noqa: E402
from petastorm_tpu_torch.workers import PullDispatcher  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clear_memcaches():
    """The memcache stores are process-wide and hold leases: every case leaves both
    packages' stores empty, so a later test in this process sees no active lease."""
    yield
    shared_store().clear()
    ref_memcache.shared_store().clear()


@pytest.fixture(autouse=True)
def _clean_io_env(monkeypatch):
    for name in list(os.environ):
        if name.startswith(("PTPU_READAHEAD", "PTPU_IO_", "PTPU_WORK_STEALING",
                            "PTPU_MEMCACHE", "PTPU_ARENA", "PTPU_REMOTE",
                            "PTPU_FOOTER_CACHE", "PTPU_TIER_")):
            monkeypatch.delenv(name)


# -- fixtures ---------------------------------------------------------------------------


@pytest.fixture()
def parquet_store(tmp_path):
    """Two files × 8 row groups × 5 rows, with an id and a payload column."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    d = tmp_path / "store"
    d.mkdir()
    for f in range(2):
        base = f * 40
        ids = np.arange(base, base + 40, dtype=np.int64)
        pq.write_table(
            pa.table({"id": ids, "payload": [bytes([i % 251]) * 64 for i in ids]}),
            str(d / ("part-%d.parquet" % f)), row_group_size=5)
    return str(d)


def _drain_ids(reader):
    return np.concatenate([np.asarray(b.id) for b in reader])


class _FakePiece:
    def __init__(self, path, row_group):
        self.path = path
        self.row_group = row_group


# -- IoOptions --------------------------------------------------------------------------


def test_io_options_defaults_and_env(monkeypatch):
    opts = IoOptions()
    assert opts.readahead and opts.coalesce and opts.work_stealing
    assert opts.readahead_depth == 3 and opts.memcache_bytes == 0
    assert opts.lookahead == 3
    monkeypatch.setenv("PTPU_READAHEAD", "0")
    monkeypatch.setenv("PTPU_MEMCACHE_BYTES", "1048576")
    opts = IoOptions()
    assert not opts.readahead and opts.lookahead == 0
    assert opts.memcache_bytes == 1 << 20
    assert IoOptions(readahead=True).readahead  # explicit kwargs beat the env


def test_io_options_normalize_and_pickle():
    assert IoOptions.normalize(None).readahead
    opts = IoOptions.normalize({"readahead_depth": 7, "work_stealing": False})
    assert opts.readahead_depth == 7 and not opts.work_stealing
    assert IoOptions.normalize(opts) is opts
    clone = pickle.loads(pickle.dumps(opts))
    assert clone.readahead_depth == 7 and not clone.work_stealing
    with pytest.raises(TypeError):
        IoOptions.normalize("fast")
    with pytest.raises(TypeError):
        IoOptions(readahed=True)  # a misspelt field is an error, never ignored


def test_io_options_defaults_equal_the_references(monkeypatch):
    """Every item-5a field defaults as the JAX package's does; ``pagedec`` keeps the
    port's ``off`` (a recorded divergence)."""
    monkeypatch.delenv("PTPU_PAGEDEC", raising=False)
    ours, theirs = IoOptions(), ref_io.IoOptions()
    for name in ("readahead", "readahead_depth", "readahead_bytes", "io_threads",
                 "coalesce", "coalesce_max_run", "work_stealing", "memcache_bytes",
                 "memcache_writable_hits", "arena_bytes"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.lookahead == theirs.lookahead
    assert ours.remote.footer_cache_bytes == theirs.remote.footer_cache_bytes == 64 << 20
    assert ours.remote.disk_admit == theirs.remote.disk_admit == "always"
    for name in ours.remote.__slots__:
        assert getattr(ours.remote, name) == getattr(theirs.remote, name), name
    assert ours.pagedec == "off" and theirs.pagedec == "auto"


def test_io_options_env_overrides_equal_the_references(monkeypatch):
    for name, value in (("PTPU_READAHEAD_DEPTH", "5"), ("PTPU_READAHEAD_BYTES", "0"),
                        ("PTPU_IO_THREADS", "4"), ("PTPU_IO_COALESCE", "off"),
                        ("PTPU_IO_COALESCE_MAX_RUN", "2"), ("PTPU_WORK_STEALING", "0"),
                        ("PTPU_MEMCACHE_WRITABLE_HITS", "1"),
                        ("PTPU_FOOTER_CACHE_BYTES", "0"),
                        ("PTPU_TIER_DISK_ADMIT", "scan-resistant")):
        monkeypatch.setenv(name, value)
    ours, theirs = IoOptions(), ref_io.IoOptions()
    for name in ("readahead_depth", "readahead_bytes", "io_threads", "coalesce",
                 "coalesce_max_run", "work_stealing", "memcache_writable_hits"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.remote.footer_cache_bytes == theirs.remote.footer_cache_bytes == 0
    assert ours.remote.disk_admit == theirs.remote.disk_admit == "scan-resistant"


@pytest.mark.parametrize("kwargs", [
    {"arena_bytes": 1 << 20}, {"remote": {"enabled": True}},
    {"remote": {"target_request_bytes": 1 << 20}}, {"remote": {"max_inflight": 2}},
    {"remote": {"min_gap_bytes": 0}}, {"remote": {"hedge": False}},
    {"remote": {"hedge_quantile": 0.9}}, {"remote": {"hedge_min_s": 0.5}},
    {"remote": {"hedge_min_samples": 5}}, {"remote": {"get_timeout_s": 30.0}},
])
def test_item_5b_fields_raise_naming_the_item(kwargs):
    """Item 5b is ported: its fields (the arena budget and the ranged-GET engine's) no
    longer raise; each parses to the JAX package's value."""
    ours, theirs = IoOptions.normalize(kwargs), ref_io.IoOptions.normalize(kwargs)
    assert ours.arena_bytes == theirs.arena_bytes
    for name in ours.remote.__slots__:
        assert getattr(ours.remote, name) == getattr(theirs.remote, name), name


def test_remote_auto_reads_classically_and_disk_admit_validates():
    """Auto engages the ranged-GET engine on an object store only: a local filesystem
    reads classically, the cloud simulator does not."""
    import pyarrow.fs as pafs

    from petastorm_tpu_torch.io.latencyfs import CloudLatencyFS
    from petastorm_tpu_torch.io.remote import RemoteIoOptions, fs_is_remote

    opts = RemoteIoOptions(enabled=False, disk_admit="scan-resistant")
    assert opts.enabled is False and opts.disk_admit == "scan-resistant"
    assert not fs_is_remote(pafs.LocalFileSystem())
    assert not RemoteIoOptions().active_for(pafs.LocalFileSystem())
    assert RemoteIoOptions().active_for(CloudLatencyFS(pafs.LocalFileSystem(),
                                                       sleep=False))
    assert not opts.active_for(CloudLatencyFS(pafs.LocalFileSystem(), sleep=False))
    with pytest.raises(ValueError):
        RemoteIoOptions(disk_admit="never")


# -- coalesce planning ------------------------------------------------------------------


def test_plan_runs_merges_adjacent_same_file():
    pieces = [_FakePiece("a", i) for i in (0, 1, 2)]
    runs = plan_runs([(p, ("x",)) for p in pieces])
    assert len(runs) == 1
    assert [p.row_group for p in runs[0][0]] == [0, 1, 2]


def test_plan_runs_splits_on_gap_file_and_columns():
    reqs = [
        (_FakePiece("a", 0), ("x",)),
        (_FakePiece("a", 2), ("x",)),   # gap
        (_FakePiece("b", 3), ("x",)),   # other file
        (_FakePiece("a", 3), ("y",)),   # other columns (adjacent to a:2)
    ]
    runs = plan_runs(reqs)
    assert [len(r[0]) for r in runs] == [1, 1, 1, 1]


def test_plan_runs_caps_run_length():
    pieces = [_FakePiece("a", i) for i in range(7)]
    runs = plan_runs([(p, None) for p in pieces], max_run=3)
    assert [len(r[0]) for r in runs] == [3, 3, 1]


def test_split_run_table_roundtrip():
    import pyarrow as pa

    table = pa.table({"v": list(range(10))})
    parts = split_run_table(table, [3, 5, 2])
    assert [p.num_rows for p in parts] == [3, 5, 2]
    assert parts[1].column("v").to_pylist() == [3, 4, 5, 6, 7]
    with pytest.raises(ValueError):
        split_run_table(table, [3, 3])


def _seeded_requests(seed, n=40):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        path = "f%d" % rng.integers(0, 3)
        cols = (None, ("x",), ("x", "y"))[rng.integers(0, 3)]
        reqs.append((_FakePiece(path, int(rng.integers(0, 12))), cols))
    return reqs


@pytest.mark.parametrize("seed", range(5))
def test_plan_runs_equal_reference_on_seeded_requests(seed):
    reqs = _seeded_requests(seed)
    gap_ok = lambda prev, piece: (piece.row_group - prev.row_group) <= 2  # noqa: E731

    def shape(runs):
        return [([(p.path, p.row_group) for p in pieces], cols) for pieces, cols in runs]

    for max_run in (1, 2, 4):
        for g in (None, gap_ok):
            assert shape(plan_runs(reqs, max_run, gap_ok=g)) == \
                shape(ref_coalesce.plan_runs(reqs, max_run, gap_ok=g))


@pytest.mark.parametrize("seed", range(3))
def test_byte_range_planning_and_slicing_equal_reference(seed):
    rng = np.random.default_rng(seed)
    blob = rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
    ranges = [(int(rng.integers(0, 60000)), int(rng.integers(0, 3000))) for _ in range(30)]
    for gap, target in ((0, None), (512, None), (4096, 2000), (1 << 20, 1 << 14)):
        ours = plan_byte_ranges(ranges, gap, target)
        assert ours == ref_coalesce.plan_byte_ranges(ranges, gap, target)
        chunks = [(off, blob[off:off + ln]) for off, ln in ours]
        got = [bytes(x) for x in slice_ranges(chunks, ranges)]
        assert got == [bytes(x) for x in ref_coalesce.slice_ranges(chunks, ranges)]
        assert got == [blob[o:o + n] for o, n in ranges]
    with pytest.raises(ValueError):
        slice_ranges([(0, blob[:10])], [(5, 10)])


# -- ReadaheadPool unit contracts -------------------------------------------------------


def _table(tag, nbytes=0):
    class T:
        pass

    t = T()
    t.tag = tag
    t.nbytes = nbytes
    return t


def test_readahead_hit_and_miss_counters():
    reads = []

    def read_fn(piece, columns):
        reads.append(piece.row_group)
        return _table(piece.row_group)

    pool = ReadaheadPool(read_fn, depth=4)
    try:
        p0, p1 = _FakePiece("a", 0), _FakePiece("a", 1)
        assert pool.schedule([(p0, None), (p1, None)]) == 2
        assert pool.get(p0, None).tag == 0
        assert pool.get(p1, None).tag == 1
        assert pool.get(_FakePiece("a", 9), None) is None  # never scheduled
        stats = pool.stats()
        assert stats["readahead_hits"] == 2 and stats["readahead_misses"] == 1
        assert sorted(reads) == [0, 1]
    finally:
        pool.shutdown()


def test_readahead_dedups_repeat_hints():
    calls = []

    def read_fn(piece, columns):
        calls.append(piece.row_group)
        return _table(piece.row_group)

    pool = ReadaheadPool(read_fn, depth=8)
    try:
        p = _FakePiece("a", 0)
        pool.schedule([(p, None)])
        assert pool.get(p, None) is not None
        # re-hinting the SAME key after consumption schedules a fresh read;
        # re-hinting while queued must not
        pool.schedule([(p, None), (p, None)])
        assert pool.get(p, None) is not None
        assert calls == [0, 0]
    finally:
        pool.shutdown()


def test_readahead_depth_bound():
    release = threading.Event()

    def read_fn(piece, columns):
        release.wait(10)
        return _table(piece.row_group)

    pool = ReadaheadPool(read_fn, depth=2, io_threads=1)
    try:
        reqs = [(_FakePiece("a", i), None) for i in range(5)]
        assert pool.schedule(reqs) == 2  # capacity-capped
        assert pool.schedule(reqs[2:]) == 0  # still full
    finally:
        release.set()
        pool.shutdown()


def test_readahead_error_reraised_at_get():
    """A failed background read re-raises the read's own exception at the foreground
    get: readahead grants no retry the synchronous path lacks."""
    calls = []

    def read_fn(piece, columns):
        calls.append(1)
        raise ConnectionResetError("flaky object store")

    pool = ReadaheadPool(read_fn, depth=2)
    try:
        p = _FakePiece("a", 0)
        pool.schedule([(p, None)])
        with pytest.raises(ConnectionResetError):
            pool.get(p, None)
        assert calls == [1]  # read once, as the synchronous path reads once
    finally:
        pool.shutdown()


def test_readahead_shutdown_cancels_to_sync_fallback():
    started = threading.Event()
    release = threading.Event()

    def read_fn(piece, columns):
        started.set()
        release.wait(10)
        return _table(piece.row_group)

    pool = ReadaheadPool(read_fn, depth=2, io_threads=1)
    try:
        p = _FakePiece("a", 0)
        pool.schedule([(p, None)])
        started.wait(5)
        before = degradation_counts().get("readahead_fallback", 0)
        pool.shutdown()
        release.set()
        assert pool.get(p, None) is None  # cancelled: the caller reads synchronously
        assert pool.schedule([(p, None)]) == 0  # scheduling after shutdown: a no-op
        assert degradation_counts().get("readahead_fallback", 0) >= before
    finally:
        pool.shutdown()


def test_readahead_byte_budget_evicts_oldest():
    def read_fn(piece, columns):
        return _table(piece.row_group, nbytes=600)

    pool = ReadaheadPool(read_fn, depth=8, byte_budget=1000)
    try:
        pieces = [_FakePiece("a", i) for i in range(3)]
        pool.schedule([(p, None) for p in pieces])
        deadline = time.time() + 5
        while pool.stats()["readahead_pending"] and time.time() < deadline:
            time.sleep(0.01)
        stats = pool.stats()
        assert stats["readahead_evictions"] >= 1
        assert stats["readahead_held_bytes"] <= 1000
    finally:
        pool.shutdown()


def test_readahead_coalesces_adjacent_reads():
    run_lengths = []

    def read_fn(piece, columns):
        run_lengths.append(1)
        return _table(piece.row_group)

    def read_run_fn(pieces, columns):
        run_lengths.append(len(pieces))
        return [_table(p.row_group) for p in pieces]

    pool = ReadaheadPool(read_fn, read_run_fn=read_run_fn, depth=8,
                         coalesce=True, coalesce_max_run=4)
    try:
        pieces = [_FakePiece("a", i) for i in range(3)]
        pool.schedule([(p, None) for p in pieces])
        for p in pieces:
            assert pool.get(p, None).tag == p.row_group
        assert run_lengths == [3]
        assert pool.stats()["coalesced_reads"] == 1
        assert pool.stats()["coalesced_items"] == 3
    finally:
        pool.shutdown()


def test_readahead_zero_byte_budget_means_unbounded():
    pool = ReadaheadPool(lambda piece, columns: _table(piece.row_group, nbytes=64),
                         depth=4, byte_budget=0)
    try:
        p = _FakePiece("a", 0)
        assert pool.schedule([(p, None)]) == 1
        assert pool.get(p, None).tag == 0
    finally:
        pool.shutdown()


def test_readahead_stale_read_does_not_double_count_bytes():
    """An abandoned (timed-out) read completing after its key was scheduled again must
    not fill the fresh entry a second time."""
    gates = [threading.Event(), threading.Event()]
    calls = []

    def read_fn(piece, columns):
        gate = gates[len(calls)]
        calls.append(piece.row_group)
        gate.wait(10)
        return _table(piece.row_group, nbytes=100)

    pool = ReadaheadPool(read_fn, depth=2, io_threads=2, byte_budget=10_000,
                         wait_timeout_s=0.05)
    try:
        p = _FakePiece("a", 0)
        pool.schedule([(p, None)])
        assert pool.get(p, None) is None  # times out: entry abandoned
        pool.schedule([(p, None)])  # registered again; the second read starts
        gates[1].set()  # the fresh read completes first and fills the new entry
        deadline = time.time() + 5
        while len(calls) < 2 and time.time() < deadline:
            time.sleep(0.01)
        while pool.stats()["readahead_held_bytes"] == 0 and time.time() < deadline:
            time.sleep(0.01)
        gates[0].set()  # the stale read completes into an already-filled entry
        time.sleep(0.1)
        table = pool.get(p, None)
        assert table is not None and table.nbytes == 100
        assert pool.stats()["readahead_held_bytes"] == 0  # subtracted exactly once
    finally:
        for g in gates:
            g.set()
        pool.shutdown()


def test_readahead_error_entries_age_out():
    def read_fn(piece, columns):
        if piece.row_group < 2:
            raise ConnectionResetError("flap")
        return _table(piece.row_group, nbytes=1)

    pool = ReadaheadPool(read_fn, depth=2, byte_budget=1 << 20)
    try:
        pool.schedule([(_FakePiece("a", 0), None), (_FakePiece("a", 1), None)])
        deadline = time.time() + 5
        while pool.stats()["readahead_pending"] and time.time() < deadline:
            time.sleep(0.01)
        for i in range(2, 16, 2):
            pool.schedule([(_FakePiece("a", i), None),
                           (_FakePiece("a", i + 1), None)])
            deadline = time.time() + 5
            while pool.stats()["readahead_pending"] and time.time() < deadline:
                time.sleep(0.01)
        with pool._lock:
            keys = set(pool._entries)
        assert len(keys) <= max(8, 4 * 2)
        assert ("a", 0, None, None) not in keys  # the error entries were swept
        assert ("a", 1, None, None) not in keys
    finally:
        pool.shutdown()


def test_readahead_threads_are_reaped_at_interpreter_exit(parquet_store):
    """A reader abandoned mid-stream (never joined) leaves IO threads behind; the exit
    drain joins them before finalization, so the interpreter exits cleanly."""
    code = (
        "import sys\n"
        "sys.path.insert(0, %r)\n"
        "from petastorm_tpu_torch import make_batch_reader\n"
        "r = make_batch_reader(%r, reader_pool_type='thread', workers_count=2,\n"
        "                      num_epochs=None)\n"
        "it = iter(r)\n"
        "for _ in range(5):\n"
        "    next(it)\n"
        "print('abandoned')\n" % (ROOT, "file://" + parquet_store))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "abandoned" in out.stdout
    assert "terminate called" not in out.stderr


# -- MemCache ---------------------------------------------------------------------------


def test_memcache_hit_skips_fill_and_serves_readonly_views():
    shared_store().clear()
    cache = MemCache(1 << 20)
    try:
        fills = []

        def fill():
            fills.append(1)
            return {"x": np.arange(8, dtype=np.int64)}

        first = cache.get("k1", fill)
        second = cache.get("k1", fill)
        assert len(fills) == 1
        np.testing.assert_array_equal(first["x"], second["x"])
        assert not first["x"].flags.writeable
        assert not second["x"].flags.writeable
        with pytest.raises(ValueError):
            second["x"][:] = -1  # fail loud, never cache poisoning
        second.pop("x")  # fresh containers a serve: key removal stays local
        third = cache.get("k1", fill)
        np.testing.assert_array_equal(third["x"], np.arange(8))
        assert len(fills) == 1
        assert cache.contains("k1") and not cache.contains("k2")
    finally:
        cache.clear()


def test_memcache_get_writable_is_cow_and_never_aliases_store():
    shared_store().clear()
    cache = MemCache(1 << 20)
    try:
        fills = []

        def fill():
            fills.append(1)
            return {"x": np.arange(8, dtype=np.int64)}

        first = cache.get_writable("k1", fill)  # miss path
        assert first["x"].flags.writeable
        first["x"][:] = -1
        second = cache.get_writable("k1", fill)  # hit path
        assert len(fills) == 1
        assert second["x"].flags.writeable
        np.testing.assert_array_equal(second["x"], np.arange(8))
        second["x"][:] = -2
        np.testing.assert_array_equal(cache.get("k1", fill)["x"], np.arange(8))
    finally:
        cache.clear()


def test_memcache_writable_hits_restores_legacy_copy_contract():
    shared_store().clear()
    cache = MemCache(1 << 20, writable_hits=True)
    try:
        fill = lambda: {"x": np.arange(4, dtype=np.int64)}  # noqa: E731
        first = cache.get("k", fill)
        assert first["x"].flags.writeable
        first["x"][:] = -1
        second = cache.get("k", fill)
        assert second["x"].flags.writeable
        np.testing.assert_array_equal(second["x"], np.arange(4))
    finally:
        cache.clear()


def test_memcache_object_dtype_elements_readonly_and_cow_not_aliased():
    shared_store().clear()
    cache = MemCache(1 << 20)
    try:
        def fill():
            col = np.empty(2, dtype=object)
            col[0] = np.zeros((2, 2), np.float32)
            col[1] = np.zeros((3, 2), np.float32)
            return {"ragged": col}

        first = cache.get("k", fill)
        with pytest.raises(ValueError):
            first["ragged"][0][0, 0] = 777.0  # element arrays frozen too
        first["ragged"][0] = None  # the outer array is the consumer's own
        writable = cache.get_writable("k", fill)
        writable["ragged"][0][0, 0] = 777.0
        writable["ragged"][1][0, 0] = -5.0
        third = cache.get("k", fill)
        assert third["ragged"][0][0, 0] == 0.0  # the store is never poisoned
        assert third["ragged"][1][0, 0] == 0.0
    finally:
        cache.clear()


def test_memcache_miss_path_serves_readonly_too():
    shared_store().clear()
    cache = MemCache(1 << 20)
    try:
        first = cache.get("k", lambda: {"x": np.arange(4, dtype=np.int64)})
        assert not first["x"].flags.writeable
        with pytest.raises(ValueError):
            first["x"][:] = -1
        second = cache.get("k", lambda: {"x": np.zeros(4, np.int64)})
        np.testing.assert_array_equal(second["x"], np.arange(4))
    finally:
        cache.clear()


def test_memcache_budget_eviction_and_oversized():
    from petastorm_tpu_torch.io.memcache import _Store

    cache = MemCache(4096, store=_Store())
    try:
        big = {"x": np.zeros(8192, np.uint8)}  # larger than the whole budget: skipped
        before = degradation_counts().get("memcache_oversized", 0)
        served = cache.get("big", lambda: big)
        assert served["x"].flags.writeable  # uncached: nothing aliases it
        assert not cache.contains("big")
        assert degradation_counts().get("memcache_oversized", 0) == before + 1
        for i in range(4):
            cache.get("k%d" % i, lambda: {"x": np.zeros(1500, np.uint8)})
        stats = cache.stats()
        assert stats["memcache_held_bytes"] <= 4096
        assert stats["memcache_evictions"] >= 2
    finally:
        cache.clear()


def test_memcache_layers_over_inner_cache():
    shared_store().clear()

    class CountingCache:
        def __init__(self):
            self.gets = 0

        def get(self, key, fill):
            self.gets += 1
            return fill()

        def contains(self, key):
            return False

        def cleanup(self):
            pass

    inner = CountingCache()
    cache = MemCache(1 << 20, inner=inner)
    try:
        cache.get("k", lambda: [1, 2])
        cache.get("k", lambda: [1, 2])
        assert inner.gets == 1  # the second get never reached the inner cache
    finally:
        cache.clear()


def test_memcache_entries_hold_leases_released_at_clear():
    from petastorm_tpu_torch.io.lease import lease_stats

    shared_store().clear()
    active = lease_stats()["active"]
    cache = MemCache(1 << 20)
    try:
        cache.get("a", lambda: {"x": np.zeros(4)})
        cache.get("b", lambda: {"x": np.ones(4)})
        assert lease_stats()["active"] == active + 2
    finally:
        cache.clear()
    assert lease_stats()["active"] == active


def test_payload_nbytes_shapes():
    assert payload_nbytes(np.zeros((4, 4), np.float32)) == 64
    assert payload_nbytes(b"abcd") == 4
    assert payload_nbytes({"a": np.zeros(8, np.uint8)}) >= 8
    assert payload_nbytes([np.zeros(8, np.uint8)] * 2) >= 16


@pytest.mark.parametrize("seed", range(4))
def test_payload_nbytes_on_ndarrays_equal_reference(seed):
    rng = np.random.default_rng(seed)
    ragged = np.empty(3, dtype=object)
    for i in range(3):
        ragged[i] = rng.standard_normal((int(rng.integers(1, 5)), 2)).astype(np.float32)
    payload = {
        "f": rng.standard_normal((int(rng.integers(1, 50)), 3)),
        "i": rng.integers(0, 9, int(rng.integers(1, 50)), dtype=np.int32),
        "ragged": ragged,
        "blob": rng.bytes(int(rng.integers(0, 100))),
    }
    rows = [{k: v[0] if isinstance(v, np.ndarray) else v for k, v in payload.items()}
            for _ in range(3)]
    for value in (payload, rows, payload["f"], ragged):
        assert payload_nbytes(value) == ref_memcache.payload_nbytes(value)


def test_memcache_rejects_nonpositive_budget():
    with pytest.raises(ValueError):
        MemCache(0)


# -- Queue 3 M: a staged JPEG column's size -------------------------------------------


def _jpeg_blobs(n, shape=(64, 48, 3), seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img = cv2.GaussianBlur(rng.randint(0, 256, shape).astype(np.float32), (5, 5), 2)
        ok, buf = cv2.imencode(".jpg", img.clip(0, 255).astype(np.uint8),
                               [cv2.IMWRITE_JPEG_QUALITY, 85])
        out.append(buf.tobytes())
    return out


def test_payload_nbytes_counts_a_staged_jpeg_columns_coefficients():
    """ROADMAP.md Queue 3 M: the JAX package sizes a decode-on-device JPEG column by
    ``sys.getsizeof`` of each ``JpegPlanes`` (a dataclass without ``nbytes``), far below
    its coefficient bytes, so its memcache budget does not bound such a store. The
    port counts the row group's stacked buffers (once) and at least every block."""
    from petastorm_tpu.ops import jpeg as ref_jpeg
    from petastorm_tpu_torch.ops import jpeg

    blobs = _jpeg_blobs(6)
    ours = jpeg.entropy_decode_jpeg_batch(blobs)
    col = np.empty(len(ours), dtype=object)
    col[:] = ours
    blocks = sum(c.blocks.nbytes for p in ours for c in p.components)
    assert payload_nbytes({"image": col}) >= blocks
    # one staged row owned outside a row group counts its own blocks
    solo = ours[0].detach()
    assert payload_nbytes(solo) >= sum(c.blocks.nbytes for c in solo.components)
    theirs = ref_jpeg.entropy_decode_jpeg_batch(blobs)
    ref_col = np.empty(len(theirs), dtype=object)
    ref_col[:] = theirs
    assert ref_memcache.payload_nbytes({"image": ref_col}) < blocks  # the pinned fault


def test_memcache_freezes_staged_jpeg_rows_in_place():
    """An admitted staged JPEG row group is read-only down to its coefficient buffers,
    its rows keep sharing one ``batch_ref`` (the packers' runs stay whole), and the
    copy-on-write serve hands out owned writable rows."""
    from petastorm_tpu_torch.ops import jpeg

    rows = jpeg.entropy_decode_jpeg_batch(_jpeg_blobs(4))
    col = np.empty(len(rows), dtype=object)
    col[:] = rows
    first = int(rows[1].components[0].blocks[0, 0, 0])
    cache = MemCache(64 << 20)
    try:
        served = cache.get("jpeg", lambda: {"image": col})["image"]
        assert served[0].batch_ref[0] is served[3].batch_ref[0]
        with pytest.raises(ValueError):
            served[1].components[0].blocks[0, 0, 0] = 7
        with pytest.raises(ValueError):
            served[1].batch_ref[0][0][0, 0, 0] = 7
        writable = cache.get_writable("jpeg", lambda: None)["image"]
        writable[1].components[0].blocks[0, 0, 0] = first + 1  # an owned copy
        assert writable[1].batch_ref is None
        assert int(served[1].components[0].blocks[0, 0, 0]) == first
    finally:
        cache.clear()


# -- PullDispatcher ---------------------------------------------------------------------


def _tagged_plan(n):
    return EpochPlan(list(range(n)), num_epochs=1, with_epoch=True)


def test_dispatcher_claims_in_plan_order_with_hints():
    d = PullDispatcher(_tagged_plan(6), workers_count=2, lookahead=2)
    item, upcoming = d.next(0)
    assert item[2] == 0 and [u[2] for u in upcoming] == [1, 2]
    item, upcoming = d.next(1)
    assert item[2] == 3 and [u[2] for u in upcoming] == [4, 5]


def test_dispatcher_steals_from_longest_claim_tail():
    d = PullDispatcher(_tagged_plan(4), workers_count=2, lookahead=3)
    item, upcoming = d.next(0)  # worker 0 claims 0 and holds [1, 2, 3]
    assert item[2] == 0 and len(upcoming) == 3
    item, _ = d.next(1)  # the plan is dry: worker 1 steals worker 0's furthest item
    assert item[2] == 3 and item[:2] == (0, 3)  # the stolen item keeps its tag
    assert d.steals == 1
    assert d.next(0)[0][2] == 1
    assert d.next(0)[0][2] == 2
    assert d.next(0) is None and d.next(1) is None


def test_dispatcher_stealing_disableable():
    d = PullDispatcher(_tagged_plan(4), workers_count=2, lookahead=3, stealing=False)
    d.next(0)  # claims everything
    assert d.next(1) is None  # starves rather than steals
    assert d.steals == 0


def test_dispatcher_zero_lookahead_is_plain_pull():
    d = PullDispatcher(_tagged_plan(3), workers_count=2, lookahead=0)
    seen = []
    while True:
        nxt = d.next(len(seen) % 2)
        if nxt is None:
            break
        item, upcoming = nxt
        assert upcoming == ()
        seen.append(item[2])
    assert seen == [0, 1, 2]
    assert d.steals == 0


@pytest.mark.parametrize("seed", range(3))
def test_dispatcher_equals_reference_on_seeded_pulls(seed):
    rng = np.random.default_rng(seed)
    workers, lookahead = int(rng.integers(1, 5)), int(rng.integers(0, 4))
    stealing = bool(rng.integers(0, 2))
    ours = PullDispatcher(EpochPlan(list(range(23)), num_epochs=2, shuffle=True,
                                    seed=seed, with_epoch=True),
                          workers, lookahead=lookahead, stealing=stealing)
    theirs = ref_workers.PullDispatcher(
        RefEpochPlan(list(range(23)), num_epochs=2, shuffle=True, seed=seed,
                     with_epoch=True), workers, lookahead=lookahead, stealing=stealing)
    for _ in range(80):
        w = int(rng.integers(0, workers))
        assert ours.next(w) == theirs.next(w)
    assert ours.steals == theirs.steals


# -- EpochPlan.peek ---------------------------------------------------------------------


def test_plan_peek_matches_next_without_advancing():
    plan = EpochPlan(list("abcd"), num_epochs=2, shuffle=True, seed=3, with_epoch=True)
    ahead = plan.peek(6)
    assert len(ahead) == 6
    got = [next(plan) for _ in range(6)]
    assert got == ahead  # peek crossed the epoch boundary exactly like __next__
    assert plan.peek(99) == [next(plan), next(plan)]  # truncates at exhaustion


def test_plan_peek_respects_skip():
    plan = EpochPlan(list("abcd"), num_epochs=1, with_epoch=True, skip={0: {0, 2}})
    assert [t[1] for t in plan.peek(10)] == [1, 3]
    assert [t[1] for t in plan] == [1, 3]


@pytest.mark.parametrize("seed", range(3))
def test_plan_peek_equals_reference_on_seeded_plans(seed):
    rng = np.random.default_rng(seed)
    n, epochs = int(rng.integers(1, 9)), int(rng.integers(1, 4))
    skip = {int(e): set(int(x) for x in rng.choice(n, int(rng.integers(0, n)),
                                                    replace=False))
            for e in range(epochs)}
    ours = EpochPlan(list(range(n)), num_epochs=epochs, shuffle=True, seed=seed,
                     with_epoch=True, skip=skip)
    theirs = RefEpochPlan(list(range(n)), num_epochs=epochs, shuffle=True, seed=seed,
                          with_epoch=True, skip=skip)
    while True:
        k = int(rng.integers(1, 6))
        assert ours.peek(k) == theirs.peek(k)
        a, b = next(ours, None), next(theirs, None)
        assert a == b
        if a is None:
            break


# -- cache keys -------------------------------------------------------------------------


def _predicates(mod):
    preds = mod.predicates
    return [None, preds.in_set({1, 5, 9}, "id"), preds.in_lambda(["id"], lambda i: i > 3),
            preds.in_pseudorandom_split([0.7, 0.3], 1, "id"),
            preds.in_lambda(["id"], lambda i, t=7: i % t == 0)]


@pytest.mark.parametrize("which", range(5))
def test_cache_key_equals_reference(which):
    import petastorm_tpu as ref_pkg
    import petastorm_tpu.predicates  # noqa: F401
    import petastorm_tpu_torch as port_pkg
    import petastorm_tpu_torch.predicates  # noqa: F401

    ours_pred, ref_pred = _predicates(port_pkg)[which], _predicates(ref_pkg)[which]
    schema = RefSchema("K", [RefField("id", np.int64, (), RefScalar(ref_types.LongType()),
                                      False)])
    piece = _FakePiece("/data/part-0.parquet", 3)
    for filters, partition, parts, seed, dev in (
            (None, 0, 1, None, frozenset()),
            ([("id", ">", 3)], 1, 4, 7, frozenset()),
            ([[("id", "in", [1, 2])], [("id", "=", 9)]], 0, 2, 0,
             frozenset({"image", "a"}))):
        assert port_reader._cache_key(piece, schema, ours_pred, filters, partition, parts,
                                      seed, dev) == \
            ref_reader._cache_key(piece, schema, ref_pred, filters, partition, parts,
                                  seed, dev)


# -- end-to-end identity and independence of the features -------------------------------


@pytest.mark.parametrize("pool_type", ["dummy", "thread"])
def test_readahead_identity_with_sync(parquet_store, pool_type):
    url = "file://" + parquet_store
    kwargs = dict(num_epochs=1, shuffle_row_groups=False,
                  reader_pool_type=pool_type, workers_count=2)
    with make_batch_reader(url, io_options={"readahead": False,
                                            "work_stealing": False}, **kwargs) as r:
        baseline = _drain_ids(r)
    with make_batch_reader(url, io_options={"readahead": True,
                                            "coalesce": False}, **kwargs) as r:
        ra = _drain_ids(r)
    with make_batch_reader(url, io_options={"readahead": True,
                                            "coalesce": True}, **kwargs) as r:
        rc = _drain_ids(r)
    assert sorted(baseline.tolist()) == sorted(ra.tolist()) == sorted(rc.tolist())
    if pool_type == "dummy":  # a single consumer: the order too
        np.testing.assert_array_equal(baseline, ra)
        np.testing.assert_array_equal(baseline, rc)


def test_readahead_payload_bytes_identical(parquet_store):
    url = "file://" + parquet_store
    kwargs = dict(num_epochs=1, shuffle_row_groups=False, reader_pool_type="dummy")

    def payloads(r):
        return [bytes(p) for b in r for p in b.payload]

    with make_batch_reader(url, io_options={"readahead": False}, **kwargs) as r:
        base = payloads(r)
    with make_batch_reader(url, io_options={"readahead": True, "coalesce": True,
                                            "readahead_depth": 6}, **kwargs) as r:
        coalesced = payloads(r)
    assert base == coalesced


def test_readahead_hits_and_coalesce_engage(parquet_store):
    """A sequential scan on the synchronous pool: every read after the first (which no
    hint can precede) is a hit, so the prefetched key is exactly the worker's first
    read; adjacent row groups merge."""
    with make_batch_reader("file://" + parquet_store, num_epochs=1,
                           shuffle_row_groups=False, reader_pool_type="dummy",
                           io_options={"readahead": True, "coalesce": True,
                                       "readahead_depth": 4}) as r:
        _drain_ids(r)
        stats = r.io_stats()
    assert stats["readahead_hits"] == 15 and stats["readahead_misses"] == 1
    assert stats["coalesced_reads"] > 0


def _petastorm_store(tmp_path, rows=40, rows_per_file=20):
    """A store written by the JAX package with a unischema (both packages'
    ``make_reader`` open it): id, an int32 label, a float32 vector."""
    schema = RefSchema("IoAsync", [
        RefField("id", np.int64, (), RefScalar(ref_types.LongType()), False),
        RefField("label", np.int32, (), RefScalar(ref_types.IntegerType()), False),
        RefField("vec", np.float32, (3,), RefNdarray(), False),
    ])
    rng = np.random.RandomState(4)

    def gen():
        for i in range(rows):
            yield {"id": i, "label": np.int32(i % 7),
                   "vec": rng.standard_normal(3).astype(np.float32)}

    url = "file://" + str(tmp_path / "pstore")
    ref_metadata.write_dataset(url, schema, gen(), row_group_size_mb=1,
                               rows_per_file=rows_per_file)
    return url


@pytest.mark.parametrize("kind", ["predicate", "filters"])
def test_first_read_columns_match_the_prefetch_under_a_row_mask(tmp_path, kind):
    """With a row mask the per-row worker reads the mask columns first and the batch
    worker the wanted and mask columns at once: the prefetched key must be exactly that
    first read, or every read is a silent miss."""
    from petastorm_tpu_torch.predicates import in_lambda

    url = _petastorm_store(tmp_path, rows=40, rows_per_file=5)
    kw = {"predicate": in_lambda(["label"], lambda v: v["label"] != 3)} \
        if kind == "predicate" \
        else {"filters": [("label", "!=", 3)]}
    for factory in (make_reader, make_batch_reader):
        with factory(url, reader_pool_type="dummy", shuffle_row_groups=False,
                     schema_fields=["id", "vec"] if factory is make_batch_reader else None,
                     **kw) as r:
            ids = sorted(int(i) for x in r for i in np.atleast_1d(x.id))
            stats = r.io_stats()
        assert ids == [i for i in range(40) if i % 7 != 3]
        assert stats["readahead_hits"] == 7 and stats["readahead_misses"] == 1, factory


def test_work_stealing_under_slow_worker(parquet_store):
    """One worker stuck on a slow piece must not strand its claimed pieces: peers steal
    them and the read completes exactly."""
    from petastorm_tpu_torch.transform import TransformSpec

    def maybe_sleep(pdf):
        # the row group of id 0 is the first plan item: whichever worker claims first
        # holds it with the next four behind it, and stalls on it
        if 0 in set(pdf["id"].tolist()):
            time.sleep(1.0)
        return pdf

    with make_batch_reader("file://" + parquet_store, num_epochs=1,
                           shuffle_row_groups=False, reader_pool_type="thread",
                           workers_count=4, transform_spec=TransformSpec(maybe_sleep),
                           io_options={"readahead": True, "readahead_depth": 4,
                                       "work_stealing": True}) as r:
        ids = _drain_ids(r)
        stats = r.io_stats()
    assert sorted(ids.tolist()) == list(range(80))
    assert stats["steals"] >= 1  # the slow worker's claim was taken by its peers


def test_memcache_reepoch_serves_from_memory(parquet_store):
    shared_store().clear()
    before = shared_store().stats()  # the store's counts are the process's
    with make_batch_reader("file://" + parquet_store, num_epochs=3,
                           shuffle_row_groups=False, reader_pool_type="dummy",
                           io_options={"memcache_bytes": 32 << 20}) as r:
        ids = _drain_ids(r)
        stats = r.io_stats()
    assert sorted(ids.tolist()) == sorted(list(range(80)) * 3)
    # epochs 2 and 3 served from memory
    assert stats["memcache_hits"] - before["memcache_hits"] == 32
    assert stats["memcache_misses"] - before["memcache_misses"] == 16
    assert stats["tier_mem_hits"] == 32 and stats["tier_remote_hits"] == 16


def test_memcache_disabled_by_default(parquet_store):
    with make_batch_reader("file://" + parquet_store, num_epochs=1,
                           reader_pool_type="dummy") as r:
        _drain_ids(r)
        stats = r.io_stats()
    assert "memcache_hits" not in stats


def test_memcache_serves_read_only_batches_and_the_loader_copies_them(parquet_store):
    """A memcache serve is read-only: a consumer writing into a delivered batch gets
    ``ValueError``; the port's DataLoader takes such arrays into torch through its
    copy-out path (no warning, tensors writable), and an opaque host transform gets
    writable copies (copy on write)."""
    import warnings

    from petastorm_tpu_torch.io.lease import copy_census
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.transform import TransformSpec

    url = "file://" + parquet_store
    opts = {"memcache_bytes": 32 << 20}
    with make_batch_reader(url, num_epochs=2, shuffle_row_groups=False,
                           reader_pool_type="dummy", io_options=opts) as r:
        batches = list(r)
    assert not batches[-1].id.flags.writeable
    with pytest.raises(ValueError):
        batches[-1].id[:] = -1
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        reader = make_batch_reader(url, num_epochs=2, shuffle_row_groups=False,
                                   reader_pool_type="dummy", io_options=opts,
                                   schema_fields=["id"])
        with DataLoader(reader, 10, device=CPU) as loader:
            got = [b["id"] for b in loader]
    assert not [w for w in caught if "not writable" in str(w.message)]
    assert all(isinstance(t, torch.Tensor) for t in got)
    assert sorted(torch.cat(got).tolist()) == sorted(list(range(80)) * 2)
    got[0][0] = -5  # the loader's tensors are its own to write

    def bump(pdf):
        pdf["id"] += 1000  # writes in place
        return pdf

    cow = copy_census().get("memcache_cow", 0)
    with make_batch_reader(url, num_epochs=2, shuffle_row_groups=False,
                           reader_pool_type="dummy", io_options=opts,
                           transform_spec=TransformSpec(bump)) as r:
        ids = _drain_ids(r)
    assert sorted(ids.tolist()) == sorted(list(range(1000, 1080)) * 2)
    assert copy_census().get("memcache_cow", 0) > cow


def test_adapter_tensors_never_alias_memcache_entries(parquet_store):
    """The host adapter's tensors are writable: over a memcache serve they are copies,
    so a consumer writing into one cannot change what the next epoch reads."""
    from petastorm_tpu_torch.adapters.pytorch import BatchedDataLoader

    reader = make_batch_reader("file://" + parquet_store, num_epochs=2,
                               shuffle_row_groups=False, reader_pool_type="dummy",
                               io_options={"memcache_bytes": 32 << 20},
                               schema_fields=["id"])
    seen = []
    with BatchedDataLoader(reader, batch_size=5) as loader:
        for batch in loader:
            seen.append(batch["id"].clone())
            batch["id"][:] = -1  # the consumer's own tensor
    assert len(seen) == 32
    assert sorted(torch.cat(seen).tolist()) == sorted(list(range(80)) * 2)


def test_dispatch_and_readahead_under_thread_stress(parquet_store):
    """More worker threads than cores share one dispatcher and one readahead pool, with
    a tiny byte budget and a short switch interval: every id arrives exactly once an
    epoch, and every foreground read is counted once, as a hit or a miss."""
    workers = min(16, 2 * (os.cpu_count() or 2))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with make_batch_reader("file://" + parquet_store, reader_pool_type="thread",
                               workers_count=workers, num_epochs=4, seed=3,
                               shuffle_row_groups=True, results_timeout_s=60,
                               io_options={"readahead_depth": 2,
                                           "readahead_bytes": 2000}) as r:
            ids = _drain_ids(r)
            stats = r.io_stats()
    finally:
        sys.setswitchinterval(old)
    counts = collections.Counter(ids.tolist())
    assert sorted(counts) == list(range(80)) and set(counts.values()) == {4}
    assert stats["readahead_hits"] + stats["readahead_misses"] == 4 * 16


def test_checkpoint_resume_exact_under_stealing_and_readahead(parquet_store):
    """state_dict/load_state_dict under the full async configuration: stolen items keep
    their tags, so a resume is exact at row-group granularity (nothing lost, whole row
    groups replayed at most once)."""
    url = "file://" + parquet_store
    kwargs = dict(num_epochs=1, shuffle_row_groups=True, seed=11,
                  reader_pool_type="thread", workers_count=3,
                  io_options={"readahead": True, "work_stealing": True})
    r1 = make_batch_reader(url, **kwargs)
    try:
        seen = []
        it = iter(r1)
        for _ in range(6):
            seen.append(np.asarray(next(it).id))
        state = r1.state_dict()
    finally:
        r1.stop()
        r1.join()
    r2 = make_batch_reader(url, **kwargs)
    r2.load_state_dict(state)
    with r2:
        rest = [np.asarray(b.id) for b in r2]
    counts = collections.Counter(np.concatenate(seen + rest).tolist())
    assert all(counts[i] >= 1 for i in range(80))  # nothing lost
    assert set(counts.values()) <= {1, 2}  # only whole-row-group replays
    replayed = sum(1 for v in counts.values() if v == 2)
    assert replayed % 5 == 0  # whole row groups of 5 rows


def test_checkpoint_state_equals_reference_after_the_same_deliveries(parquet_store):
    """The dummy pool with readahead: after the same deliveries both packages' reader
    states are equal dicts (the dispatcher's lookahead changes no cursor)."""
    url = "file://" + parquet_store
    kw = dict(num_epochs=2, shuffle_row_groups=True, seed=5, reader_pool_type="dummy")
    with make_batch_reader(url, **kw) as ours, ref_reader.make_batch_reader(url, **kw) \
            as theirs:
        a, b = iter(ours), iter(theirs)
        for _ in range(21):
            np.testing.assert_array_equal(np.asarray(next(a).id), np.asarray(next(b).id))
        assert ours.state_dict() == theirs.state_dict()


def test_reset_rebuilds_io_runtime(parquet_store):
    with make_batch_reader("file://" + parquet_store, num_epochs=1,
                           shuffle_row_groups=False, reader_pool_type="dummy") as r:
        first = _drain_ids(r)
        r.reset()
        second = _drain_ids(r)
        assert r.io_stats().get("readahead_hits", 0) > 0  # prefetching resumed
    np.testing.assert_array_equal(first, second)


def test_process_pool_hints_identity(parquet_store):
    """The hints ride with each item to the child, whose own readahead pool reads them
    while it decodes; the children's counts come back through ``io_stats()``."""
    with make_batch_reader("file://" + parquet_store, num_epochs=1,
                           shuffle_row_groups=False, reader_pool_type="process",
                           workers_count=2, results_timeout_s=120,
                           io_options={"readahead": True, "readahead_depth": 3}) as r:
        ids = _drain_ids(r)
        children = r.io_stats()["children"]
    assert sorted(ids.tolist()) == list(range(80))
    assert sum(c.get("readahead_hits", 0) for c in children.values()) > 0


def test_disk_cache_read_failure_degradation(tmp_path):
    from petastorm_tpu_torch.cache import LocalDiskCache

    cache = LocalDiskCache(str(tmp_path / "cache"))
    cache.get("k", lambda: {"v": 1})
    path = cache._key_path("k")
    with open(path, "wb") as f:
        f.write(b"not a pickle")
    before = degradation_counts().get("disk_cache", 0)
    assert cache.get("k", lambda: {"v": 2}) == {"v": 2}
    assert degradation_counts().get("disk_cache", 0) == before + 1


def test_disk_cache_write_failure_degradation(tmp_path, monkeypatch):
    from petastorm_tpu_torch import cache as cache_mod

    cache = cache_mod.LocalDiskCache(str(tmp_path / "cache"))

    def disk_full(*a, **k):
        raise OSError(28, "No space left on device")

    real_dump = pickle.dump
    monkeypatch.setattr(cache_mod.pickle, "dump", disk_full)
    before = degradation_counts().get("disk_cache", 0)
    assert cache.get("k", lambda: 42) == 42  # the value flows, uncached
    assert degradation_counts().get("disk_cache", 0) == before + 1
    monkeypatch.setattr(cache_mod.pickle, "dump", real_dump)
    assert cache.get("k", lambda: 43) == 43  # a healed disk caches again
    assert cache.contains("k")


def test_degradation_on_failed_pool_construction(parquet_store, monkeypatch):
    import petastorm_tpu_torch.io.readahead as ra_mod

    def boom(*a, **k):
        raise RuntimeError("no threads for you")

    monkeypatch.setattr(ra_mod.ReadaheadPool, "__init__", boom)
    before = degradation_counts().get("readahead_unavailable", 0)
    with make_batch_reader("file://" + parquet_store, num_epochs=1,
                           shuffle_row_groups=False, reader_pool_type="dummy") as r:
        ids = _drain_ids(r)
    assert sorted(ids.tolist()) == list(range(80))
    assert degradation_counts().get("readahead_unavailable", 0) == before + 1


# -- the footer cache -------------------------------------------------------------------


def test_footer_cache_one_parse_per_file_per_process(parquet_store):
    """The planner's footer scan fills the shared cache; every worker thread and IO
    thread then opens its files with the cached footer (hits, no second parse)."""
    from petastorm_tpu_torch.io.footercache import shared_footer_cache

    cache = shared_footer_cache()
    cache.clear()
    misses = cache.stats()["footer_cache_misses"]
    with make_batch_reader("file://" + parquet_store, num_epochs=2,
                           reader_pool_type="thread", workers_count=3) as r:
        _drain_ids(r)
        stats = r.io_stats()
    assert stats["footer_cache_misses"] - misses == 2  # two files, one parse each
    assert stats["footer_cache_entries"] >= 2 and stats["footer_cache_hits"] > 0


def test_footer_cache_validates_size_and_budget(tmp_path):
    import pyarrow as pa
    import pyarrow.fs as pafs
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.io.footercache import FooterCache

    path = str(tmp_path / "f.parquet")
    pq.write_table(pa.table({"v": np.arange(100)}), path, row_group_size=10)
    fs = pafs.LocalFileSystem()
    cache = FooterCache(budget_bytes=1 << 20)
    try:
        entry = cache.get(fs, path)
        assert entry.num_row_groups == 10 and entry.row_group_rows == (10,) * 10
        assert cache.get(fs, path) is entry and cache.stats()["footer_cache_hits"] == 1
        start, end = entry.row_group_span(3)
        assert 0 < start < end <= entry.size
        assert cache.peek(path) is entry and cache.stats()["footer_cache_hits"] == 1
        pq.write_table(pa.table({"v": np.arange(300)}), path, row_group_size=10)
        with fs.open_input_file(path) as f:
            fresh = cache.get(fs, path, source=f)  # another size: invalidated, reparsed
        assert fresh.num_row_groups == 30
        assert cache.stats()["footer_cache_invalidations"] == 1
    finally:
        cache.clear()
    tiny = FooterCache(budget_bytes=fresh.nbytes - 1)
    try:
        tiny.get(fs, path)
        assert not tiny.contains(path)  # larger than the whole budget: served uncached
    finally:
        tiny.clear()


def test_rowgroup_gap_predicate_uses_the_cached_footer(parquet_store):
    from petastorm_tpu_torch.io.footercache import shared_footer_cache

    with make_batch_reader("file://" + parquet_store, reader_pool_type="dummy") as r:
        worker = r._worker
        pieces = [item[0] for item in r._plan.items]
        _drain_ids(r)
    same_file = [p for p in pieces if p.path == pieces[0].path]
    assert shared_footer_cache().peek(same_file[0].path) is not None
    assert worker._rowgroup_gap_ok(same_file[0], same_file[2])  # a small gap: bridged
    uncached = port_reader._WorkerBase(worker._fs, worker._read_schema,
                                       worker._stored_schema,
                                       io_options={"remote": {"footer_cache_bytes": 0}})
    assert not uncached._rowgroup_gap_ok(same_file[0], same_file[2])  # no footer cache


# -- the same store through both packages -----------------------------------------------


IO_CASES = {
    "defaults": dict(io_options=None),
    "memcache": dict(io_options={"memcache_bytes": 64 << 20}),
    "local-disk": dict(cache_type="local-disk"),
}


def _with_cache_location(kw, tmp_path, tag):
    kw = dict(kw)
    if kw.get("cache_type") == "local-disk":
        kw["cache_location"] = str(tmp_path / ("cache-" + tag))
    return kw


@pytest.mark.parametrize("case", sorted(IO_CASES))
def test_batch_reader_rows_equal_reference_per_id(parquet_store, tmp_path, case):
    url = "file://" + parquet_store
    out = []
    for tag, factory in (("port", make_batch_reader), ("ref", ref_reader.make_batch_reader)):
        kw = _with_cache_location(IO_CASES[case], tmp_path, tag)
        rows = {}
        for _epoch in range(2):  # the second reader is served by the caches
            with factory(url, reader_pool_type="thread", workers_count=2,
                         num_epochs=1, **kw) as r:
                for b in r:
                    for i, p in zip(np.asarray(b.id), b.payload):
                        rows.setdefault(int(i), []).append(bytes(p))
        out.append(rows)
    assert out[0] == out[1] and sorted(out[0]) == list(range(80))


@pytest.mark.parametrize("case", sorted(IO_CASES))
def test_per_row_reader_rows_equal_reference_per_id(tmp_path, case):
    url = _petastorm_store(tmp_path)
    out = []
    for tag, factory in (("port", make_reader), ("ref", ref_reader.make_reader)):
        kw = _with_cache_location(IO_CASES[case], tmp_path, tag)
        rows = {}
        for _epoch in range(2):
            with factory(url, reader_pool_type="thread", workers_count=2,
                         num_epochs=1, **kw) as r:
                for row in r:
                    d = row._asdict()
                    rows.setdefault(int(d["id"]), []).append(
                        (int(d["label"]), np.asarray(d["vec"]).tobytes()))
        out.append(rows)
    assert out[0] == out[1] and sorted(out[0]) == list(range(40))


@pytest.fixture(scope="module")
def jpeg_store(tmp_path_factory):
    """32 JPEG rows (64x48, q85) in two files of one row group, written by the JAX
    package."""
    shape = (64, 48, 3)
    schema = RefSchema("IoAsyncJpeg", [
        RefField("id", np.int64, (), RefScalar(ref_types.LongType()), False),
        RefField("image", np.uint8, shape, RefImage("jpeg", 85), False),
    ])
    rng = np.random.RandomState(9)

    def rows():
        for i in range(32):
            noise = rng.randint(0, 256, shape).astype(np.float32)
            img = cv2.GaussianBlur(noise, (7, 7), 2.0)
            yield {"id": i, "image": img.clip(0, 255).astype(np.uint8)}

    url = "file://" + str(tmp_path_factory.mktemp("io_async_jpeg") / "ds")
    ref_metadata.write_dataset(url, schema, rows(), row_group_size_mb=1, rows_per_file=16)
    assert len(ref_metadata.load_row_groups(*_ref_fs_path(url))) == 2
    return url


def _ref_fs_path(url):
    from petastorm_tpu.fs import get_filesystem_and_path_or_paths

    return get_filesystem_and_path_or_paths(url)


def _images_by_id(batches):
    out = {}
    for b in batches:
        for i, img in zip(b["id"], b["image"]):
            out.setdefault(int(i), []).append(np.asarray(img))
    return out


def test_jpeg_memcache_reepoch_is_bit_exact_and_skips_stage_1(jpeg_store, monkeypatch):
    """Two epochs of the device-decode store with a memcache through the port's
    DataLoader on the CPU (the plain stage 2): epoch 2 runs no stage 1, and every
    image, in both epochs, is bit-exact against the JAX package's decode of the same
    id."""
    from petastorm_tpu import loader as ref_loader
    from petastorm_tpu_torch.codecs import CompressedImageCodec
    from petastorm_tpu_torch.loader import DataLoader

    staged = []
    orig = CompressedImageCodec.host_stage_decode_batch

    def counting(self, field, values):
        staged.append(len(values))
        return orig(self, field, values)

    monkeypatch.setattr(CompressedImageCodec, "host_stage_decode_batch", counting)
    reader = make_batch_reader(jpeg_store, decode_on_device=True, workers_count=1,
                               shuffle_row_groups=False, num_epochs=2,
                               io_options={"memcache_bytes": 64 << 20})
    with DataLoader(reader, 8, device=CPU) as loader:
        batches = [{k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                    for k, v in b.items()} for b in loader]
        stats = reader.io_stats()
    assert sum(staged) == 32  # epoch 1 only: epoch 2 was served from memory
    assert stats["tier_mem_hits"] == stats["tier_remote_hits"] == 2
    ref = ref_reader.make_batch_reader(jpeg_store, decode_on_device=True, workers_count=1,
                                       shuffle_row_groups=False)
    with ref_loader.DataLoader(ref, 8) as loader:
        theirs = _images_by_id([{k: np.asarray(v) for k, v in b.items()} for b in loader])
    ours = _images_by_id(batches)
    assert sorted(ours) == sorted(theirs) == list(range(32))
    for i in range(32):
        assert len(ours[i]) == 2
        for img in ours[i]:
            np.testing.assert_array_equal(img, theirs[i][0])


def test_jpeg_local_disk_cache_equals_the_uncached_read(jpeg_store, tmp_path):
    from petastorm_tpu_torch.loader import DataLoader

    def images(**kw):
        reader = make_batch_reader(jpeg_store, decode_on_device=True, workers_count=2,
                                   shuffle_row_groups=False, **kw)
        with DataLoader(reader, 8, device=CPU) as loader:
            return _images_by_id([{k: v.numpy() for k, v in b.items()} for b in loader]), \
                reader.io_stats()

    base, _ = images()
    kw = dict(cache_type="local-disk", cache_location=str(tmp_path / "jc"))
    first, _ = images(**kw)
    second, stats = images(**kw)
    assert stats["tier_disk_hits"] >= 2 and stats["tier_remote_hits"] == 0
    for i in range(32):
        np.testing.assert_array_equal(first[i][0], base[i][0])
        np.testing.assert_array_equal(second[i][0], base[i][0])


def test_passthrough_columns_never_prefetched(tmp_path, monkeypatch):
    """With the pass-through on, a prefetch leaves out the pagedec-eligible columns
    (their raw pages are read by the foreground), so the classic remainder's key
    still hits and no column is read twice."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.io.readahead import ReadaheadPool as Pool

    rng = np.random.default_rng(0)
    n = 4096
    pq.write_table(pa.table({"cat": rng.integers(0, 8, n).astype(np.int64),
                             "dense": np.repeat(rng.standard_normal(n // 64), 64)
                             .astype(np.float32),
                             "name": ["r%d" % (i % 5) for i in range(n)]}),
                   str(tmp_path / "p.parquet"), row_group_size=1024, compression="snappy")
    from petastorm_tpu_torch.io.pagedec import is_passthrough

    scheduled = []
    real = Pool.schedule

    def spy(self, requests):
        scheduled.extend(tuple(cols) for _p, cols in requests)
        return real(self, requests)

    monkeypatch.setattr(Pool, "schedule", spy)
    with make_batch_reader("file://" + str(tmp_path), reader_pool_type="dummy",
                           shuffle_row_groups=False,
                           io_options={"pagedec": "on"}) as r:
        r.adopt_passthrough(on_device=False)
        batches = list(r)
        stats = r.io_stats()
    assert len(batches) == 4
    passed = {name for b in batches for name in ("cat", "dense")
              if is_passthrough(getattr(b, name))}
    assert passed  # the pass-through engaged
    assert scheduled and not any(passed & set(cols) for cols in scheduled)
    assert stats["readahead_hits"] == 3 and stats["readahead_misses"] == 1


# -- on the card ------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_memcache_reepoch_launches_stage2_and_k2_on_the_card(cuda_device, jpeg_store):
    """Epoch 2 served from memory still runs the batched stage 2 and K2 on the card
    once a batch, and its images equal epoch 1's."""
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image, jpeg
    from petastorm_tpu_torch.ops.image import normalize_images

    def transform(batch):
        return {**batch, "norm": normalize_images(batch["image"], [0.5] * 3, [0.25] * 3)}

    jpeg.stage2_planes_segments.launches = 0
    jpeg.stage2_rgb.launches = 0
    image.normalize_images.launches = 0
    reader = make_batch_reader(jpeg_store, decode_on_device=True, workers_count=1,
                               shuffle_row_groups=False, num_epochs=2,
                               io_options={"memcache_bytes": 64 << 20})
    with DataLoader(reader, 8, device=cuda_device, device_transform=transform) as loader:
        batches = [(b["id"].cpu().numpy(), b["image"].clone(), b["norm"].clone())
                   for b in loader]
    assert jpeg.stage2_planes_segments.launches == jpeg.stage2_rgb.launches \
        == image.normalize_images.launches == 8
    for (ids_a, a, _), (ids_b, b, norm) in zip(batches[:4], batches[4:]):
        np.testing.assert_array_equal(ids_a, ids_b)
        assert torch.equal(a, b)
        assert torch.equal(norm, image._normalize_plain(b, [0.5] * 3, [0.25] * 3,
                                                        torch.bfloat16))


@pytest.mark.gpu
def test_passthrough_under_default_io_options_on_the_card(cuda_device, tmp_path):
    """The pass-through at the read path's defaults (readahead, coalescing, stealing):
    one K3, one scan and one K4 launch a batch, columns equal to the classic read."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import pagedec_kernels as pk

    rng = np.random.default_rng(0)
    n = 8192
    pq.write_table(pa.table({"cat": rng.integers(0, 8, n).astype(np.int64),
                             "dense": np.repeat(rng.standard_normal(n // 64), 64)
                             .astype(np.float32)}),
                   str(tmp_path / "p.parquet"), row_group_size=2048, compression="snappy")
    url = "file://" + str(tmp_path)
    pk.snappy_inflate_ragged.launches = 0
    pk.rle_scan_pages.launches = 0
    pk.extract_pages.launches = 0
    reader = make_batch_reader(url, workers_count=2, shuffle_row_groups=False,
                               io_options={"pagedec": "on"})
    with DataLoader(reader, 2048, device=cuda_device) as loader:
        batches = [{k: b[k].cpu() for k in ("cat", "dense")} for b in loader]
    got = {k: torch.cat([b[k] for b in batches]).numpy() for k in ("cat", "dense")}
    assert pk.snappy_inflate_ragged.launches == pk.rle_scan_pages.launches \
        == pk.extract_pages.launches == 4
    with make_batch_reader(url, reader_pool_type="dummy", shuffle_row_groups=False) as r:
        cols = list(r)
    want = {k: np.concatenate([getattr(b, k) for b in cols]) for k in ("cat", "dense")}
    for k in want:
        np.testing.assert_array_equal(np.sort(got[k]), np.sort(want[k]))
