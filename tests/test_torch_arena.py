"""The port's host-wide cache arena against the JAX package's (ROADMAP.md Queue 1 item 5b):
segment lifecycle, the codec's zero-copy discipline (staged JPEG row groups included),
generations, lease-pinned eviction, the cache planes (memcache, footer cache, page index,
the tiered funnel), the ``PTPU_ARENA=off`` kill switch, dead-holder reclaim, the
process pool's children attaching, and the loader's exit drain.

Every case of the JAX package's ``tests/test_arena.py`` has a counterpart here. Its two
slow cases drive the chaos plane (a child killed by a fault rule, quarantine); their
port counterparts kill a holder process directly and read a pool from the arena with the
store gone, and ``tests/test_torch_chaos.py`` kills a pool child reading through the
arena by a fault rule. The same scripted puts, gets and budget changes give both packages' arenas
the same hit, miss, admit and eviction counts. Every case leaves no segment of this
process's arenas in ``/dev/shm``.
"""
import glob
import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import pyarrow as pa
import pyarrow.fs as pafs
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

from petastorm_tpu.io import arena as ref_arena  # noqa: E402
from petastorm_tpu_torch import make_batch_reader  # noqa: E402
from petastorm_tpu_torch.io import arena as arena_mod  # noqa: E402
from petastorm_tpu_torch.io.arena import ArenaSpec, CacheArena  # noqa: E402
from petastorm_tpu_torch.io.footercache import shared_footer_cache  # noqa: E402
from petastorm_tpu_torch.io.lease import active_leases_by_kind, lease_stats  # noqa: E402
from petastorm_tpu_torch.io.memcache import MemCache, _Store, shared_store  # noqa: E402
from petastorm_tpu_torch.io.pagedec import shared_page_index  # noqa: E402
from petastorm_tpu_torch.parallel.shm_ring import degradation_counts  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _own_segments():
    """This process's arena segments (the token starts with the creator's pid)."""
    return set(glob.glob("/dev/shm/%s%d_*" % (arena_mod.ARENA_PREFIX, os.getpid())))


@pytest.fixture(autouse=True)
def _arena_isolation(monkeypatch):
    """Every case starts without a process arena and leaves none of its segments."""
    monkeypatch.delenv("PTPU_ARENA", raising=False)
    monkeypatch.delenv(arena_mod.ENV_ATTACH, raising=False)
    arena_mod.close_process_arena()
    arena_mod._STATE["failed_tokens"].clear()
    before = _own_segments()
    yield
    shared_store().clear()
    shared_page_index().clear()
    arena_mod.close_process_arena()
    arena_mod._STATE["failed_tokens"].clear()
    leaked = _own_segments() - before
    assert not leaked, "leaked arena segments: %s" % sorted(leaked)


def _payload(n=64, fill=7):
    return {"id": np.arange(n, dtype=np.int64),
            "x": np.full(n, fill, dtype=np.float32),
            "blob": b"\x01" * 128,
            "name": "row-group"}


# -- CacheArena -------------------------------------------------------------------------


def test_roundtrip_serves_readonly_views_and_lease_pins():
    arena = CacheArena(budget_bytes=1 << 20)
    try:
        assert arena.put(("mc", "k"), _payload())
        value, lease = arena.get(("mc", "k"))
        assert np.array_equal(value["id"], np.arange(64, dtype=np.int64))
        assert value["x"].dtype == np.float32 and value["x"][3] == 7.0
        assert value["blob"] == b"\x01" * 128 and value["name"] == "row-group"
        # zero-copy contract: ndarray leaves are read-only views over the mapping
        assert not value["id"].flags.writeable and not value["x"].flags.writeable
        with pytest.raises((ValueError, RuntimeError)):
            value["id"][0] = 99
        assert lease.kind == "arena"
        # the holder refcount pins the entry until the lease releases
        assert arena.stats()["arena_held_entries"] == 1
        lease.release()
        assert arena.stats()["arena_held_entries"] == 0
        assert arena.contains(("mc", "k"))
    finally:
        arena.close()
    assert not glob.glob("/dev/shm/%s%s*" % (arena_mod.ARENA_PREFIX, arena.spec.token))


def test_generation_mismatch_invalidates_and_rewrites():
    arena = CacheArena(budget_bytes=1 << 20)
    try:
        assert arena.put(("ft", "f.parquet"), _payload(fill=1), gen="sz:100")
        got = arena.get(("ft", "f.parquet"), gen="sz:100")
        assert got is not None
        got[1].release()
        # a rewritten file (a new generation) never serves the old bytes
        assert arena.get(("ft", "f.parquet"), gen="sz:200") is None
        assert not arena.contains(("ft", "f.parquet"))
        assert arena.put(("ft", "f.parquet"), _payload(fill=2), gen="sz:200")
        value, lease = arena.get(("ft", "f.parquet"), gen="sz:200")
        assert value["x"][0] == 2.0
        lease.release()
    finally:
        arena.close()


def test_bytes_api_roundtrip():
    arena = CacheArena(budget_bytes=1 << 20)
    try:
        assert arena.put_bytes(("pi", "p", 0, "c"), b"\x00\x07" * 33)
        assert arena.get_bytes(("pi", "p", 0, "c")) == b"\x00\x07" * 33
        assert arena.get_bytes(("pi", "p", 1, "c")) is None
        assert arena.stats()["arena_held_entries"] == 0  # bytes copy out
    finally:
        arena.close()


def test_eviction_skips_lease_held_entries():
    arena = CacheArena(budget_bytes=1 << 20)
    try:
        big = {"x": np.zeros(40000, dtype=np.int64)}  # ~320 KB each: 3 fit
        for key in "abc":
            assert arena.put(key, big)
        held = arena.get("a")  # pin the LRU-oldest entry
        assert arena.put("d", big)  # must evict, but never the held "a"
        assert arena.contains("a") and not arena.contains("b") and arena.contains("d")
        held[1].release()
    finally:
        arena.close()


def test_attach_by_spec_shares_entries_and_detaches():
    creator = CacheArena(budget_bytes=1 << 20)
    try:
        creator.put(("mc", "k"), _payload(fill=5))
        attacher = CacheArena(spec=ArenaSpec(creator.spec.token))
        try:
            value, lease = attacher.get(("mc", "k"))
            assert value["x"][0] == 5.0 and not value["x"].flags.writeable
            lease.release()
            assert attacher.stats()["arena_attached"] == 1  # keyed by pid
        finally:
            attacher.detach()
        assert creator.stats()["arena_attached"] in (0, 1)
    finally:
        creator.close()


def test_spec_pickles_and_attach_after_close_degrades_to_none():
    arena = CacheArena(budget_bytes=1 << 20)
    try:
        spec = pickle.loads(pickle.dumps(arena.spec))
        assert spec == arena.spec and hash(spec) == hash(arena.spec)
    finally:
        arena.close()
    before = degradation_counts().get("arena_unavailable", 0)
    assert arena_mod.resolve(spec) is None  # unlinked: per-process caches, no raise
    assert degradation_counts()["arena_unavailable"] == before + 1


def test_reclaim_revokes_dead_pid_holders_only():
    proc = subprocess.run([sys.executable, "-c", "import os; print(os.getpid())"],
                          stdout=subprocess.PIPE, check=True)
    dead_pid = int(proc.stdout)
    arena = CacheArena(budget_bytes=1 << 20)
    try:
        arena.put(("mc", "k"), _payload())
        live = arena.get(("mc", "k"))  # our own (live) holder
        with arena._tlock:  # forge a dead process's holder record
            arena._flock()
            try:
                index = arena._read_index()
                index["entries"][("mc", "k")]["holders"][dead_pid] = 2
                index["attached"][dead_pid] = True
                arena._write_index(index)
            finally:
                arena._funlock()
        assert arena.reclaim() == 2
        stats = arena.stats()
        assert stats["arena_held_entries"] == 1 and stats["arena_attached"] == 1
        assert np.array_equal(live[0]["id"], np.arange(64, dtype=np.int64))
        live[1].release()
    finally:
        arena.close()


def test_host_wide_budget_retune_evicts_on_shrink():
    arena = CacheArena(budget_bytes=1 << 20)
    try:
        big = {"x": np.zeros(40000, dtype=np.int64)}
        arena.put("a", big)
        arena.put("b", big)
        assert arena.stats()["arena_entries"] == 2
        assert arena.set_budget(400 << 10) == 400 << 10
        assert arena.stats()["arena_entries"] == 1  # the shrink evicted the LRU
        assert arena.budget == 400 << 10
    finally:
        arena.close()


def test_kill_switch_and_env_attach(monkeypatch):
    monkeypatch.setenv("PTPU_ARENA", "off")
    assert arena_mod.host_arena(1 << 20) is None
    monkeypatch.delenv("PTPU_ARENA")
    arena = arena_mod.host_arena(1 << 20)
    assert arena is not None
    assert arena_mod.host_arena(1 << 20) is arena  # memoized a process
    assert arena_mod.current_token() == arena.spec.token
    monkeypatch.setenv(arena_mod.ENV_ATTACH, arena.spec.token)
    assert arena_mod.attach_from_env() is arena
    assert arena_mod.close_process_arena()


def test_segments_and_attach_variable_are_the_ports_own():
    """A port arena's segments and attach variable differ from the JAX package's, so
    neither package's process maps the other's entries."""
    assert arena_mod.ARENA_PREFIX == "ptpu_torch_arena_"
    assert not arena_mod.ARENA_PREFIX.startswith(ref_arena.ARENA_PREFIX)
    assert arena_mod.ENV_ATTACH != ref_arena.ENV_ATTACH
    arena = arena_mod.host_arena(1 << 20)
    try:
        names = {os.path.basename(p) for p in _own_segments()}
        assert names and all(n.startswith("ptpu_torch_arena_") for n in names)
        assert ref_arena.process_arena() is None
    finally:
        arena_mod.close_process_arena()


def test_admission_past_the_budget_degrades_arena_full():
    arena = CacheArena(budget_bytes=64 << 10)
    try:
        before = degradation_counts().get("arena_full", 0)
        assert not arena.put("big", {"x": np.zeros(20000, np.int64)})
        assert degradation_counts()["arena_full"] == before + 1
        assert not arena.contains("big")
        assert arena.put("small", {"x": np.zeros(100, np.int64)})
    finally:
        arena.close()


def test_lease_census_counts_arena_serves():
    arena = CacheArena(budget_bytes=1 << 20)
    try:
        arena.put("k", _payload())
        base = active_leases_by_kind().get("arena", 0)
        held = [arena.get("k") for _ in range(3)]
        assert active_leases_by_kind()["arena"] == base + 3
        for _value, lease in held:
            lease.release()
        assert active_leases_by_kind()["arena"] == base
    finally:
        arena.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counts_equal_reference_on_a_scripted_sequence(seed):
    """The same puts, gets (leases held for a while, then released) and budget
    changes through both packages' arenas: the same hits, misses, admits, evictions
    and resident keys at every step."""
    rng = np.random.default_rng(seed)
    ours = CacheArena(budget_bytes=250_000)
    theirs = ref_arena.CacheArena(budget_bytes=250_000)
    names = ("hits", "misses", "admits", "evictions")
    ref0 = {k: theirs.stats()["arena_" + k] for k in names}
    ours0 = {k: ours.stats()["arena_" + k] for k in names}
    held = []
    try:
        for step in range(120):
            op = rng.random()
            key = "k%d" % int(rng.integers(0, 12))
            if op < 0.45:
                n = int(rng.choice([1000, 5000, 20000]))
                value = {"x": np.full(n, step, np.int64)}
                assert ours.put(key, value) == theirs.put(key, value), step
            elif op < 0.9:
                a, b = ours.get(key), theirs.get(key)
                assert (a is None) == (b is None), step
                if a is not None:
                    np.testing.assert_array_equal(a[0]["x"], b[0]["x"])
                    held.append((a[1], b[1]))
            elif op < 0.95:
                budget = int(rng.choice([150_000, 250_000, 400_000]))
                assert ours.set_budget(budget) == theirs.set_budget(budget)
            while len(held) > 2 or (held and rng.random() < 0.3):
                for lease in held.pop(0):
                    lease.release()
            for k in ("k%d" % i for i in range(12)):
                assert ours.contains(k) == theirs.contains(k), (step, k)
        got = {k: ours.stats()["arena_" + k] - ours0[k] for k in names}
        want = {k: theirs.stats()["arena_" + k] - ref0[k] for k in names}
        assert got == want and got["evictions"] > 0 and got["hits"] > 0
    finally:
        for pair in held:
            for lease in pair:
                lease.release()
        ours.close()
        theirs.close()


# -- staged JPEG row groups ---------------------------------------------------------------


def _jpeg_blobs(n, shape=(48, 64, 3), seed=5):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img = cv2.GaussianBlur(rng.randint(0, 256, shape).astype(np.float32), (5, 5), 2)
        ok, buf = cv2.imencode(".jpg", img.clip(0, 255).astype(np.uint8),
                               [cv2.IMWRITE_JPEG_QUALITY, 85])
        out.append(buf.tobytes())
    return out


def _staged_column(blobs):
    from petastorm_tpu_torch.ops import jpeg

    rows = jpeg.entropy_decode_jpeg_batch(blobs)
    col = np.empty(len(rows), dtype=object)
    col[:] = rows
    return col


def _inside(arr, seg):
    """Does ``arr``'s data lie inside the mapped segment ``seg``?"""
    base = np.frombuffer(seg.buf, np.uint8).__array_interface__["data"][0]
    ptr = arr.__array_interface__["data"][0]
    return base <= ptr and ptr + arr.nbytes <= base + seg.size


def test_staged_jpeg_row_group_is_served_as_views_sharing_one_batch_ref():
    """A staged row group's shared buffers are encoded once: a served row's coefficient
    blocks are read-only views into the mapped segment (no copy), every row of the
    row group shares one ``batch_ref`` (the packers' runs stay whole), and the
    admission counts the coefficients once."""
    col = _staged_column(_jpeg_blobs(6))
    ref = col[0].batch_ref
    coef_bytes = sum(int(c.nbytes) for c in ref[0]) + int(ref[1].nbytes)
    arena = CacheArena(budget_bytes=16 << 20)
    try:
        assert arena.put(("mc", "rg"), {"image": col, "id": np.arange(6)})
        value, lease = arena.get(("mc", "rg"))
        rows = value["image"]
        seg = arena._maps[arena._read_index()["entries"][("mc", "rg")]["seg"]]
        assert all(r.batch_ref[0] is rows[0].batch_ref[0] for r in rows)
        assert all(r.batch_ref[1] is rows[0].batch_ref[1] for r in rows)
        assert [r.batch_ref[2] for r in rows] == list(range(6))
        for r, orig in zip(rows, col):
            assert r.kmax == orig.kmax and (r.height, r.width) == (orig.height, orig.width)
            np.testing.assert_array_equal(r.specmax, orig.specmax)
            for c, oc in zip(r.components, orig.components):
                assert _inside(c.blocks, seg) and not c.blocks.flags.writeable
                assert _inside(c.qtable, seg)
                np.testing.assert_array_equal(c.blocks, oc.blocks)
                np.testing.assert_array_equal(c.qtable, oc.qtable)
                assert (c.h_samp, c.v_samp) == (oc.h_samp, oc.v_samp)
        # the stacked buffers once, not a copy a row
        assert coef_bytes <= arena.stats()["arena_payload_bytes"] < coef_bytes * 1.05
        lease.release()
    finally:
        arena.close()


def test_staged_jpeg_rows_staged_one_by_one_keep_their_own_blocks():
    """A row the batched stage 1 could not take (its own blocks, no ``batch_ref``)
    round-trips as its own views."""
    from petastorm_tpu_torch.ops import jpeg

    row = jpeg.entropy_decode_jpeg_fast(_jpeg_blobs(1)[0])
    col = np.empty(2, dtype=object)
    col[:] = [row, None]
    arena = CacheArena(budget_bytes=4 << 20)
    try:
        arena.put("one", {"image": col})
        value, lease = arena.get("one")
        got = value["image"]
        assert got[1] is None and got[0].batch_ref is None
        for c, oc in zip(got[0].components, row.components):
            np.testing.assert_array_equal(c.blocks, oc.blocks)
            assert not c.blocks.flags.writeable
        lease.release()
    finally:
        arena.close()


def test_staged_jpeg_images_from_the_arena_equal_the_fresh_read():
    """Through the port's plain stage 2 on the CPU: the arena-served rows decode to
    the fresh rows' images, per id, and take one run a row group."""
    from petastorm_tpu_torch.ops import jpeg

    col = _staged_column(_jpeg_blobs(8, seed=9))
    fresh = jpeg.decode_jpeg_batch(list(col), device=CPU).numpy()
    arena = CacheArena(budget_bytes=16 << 20)
    try:
        arena.put("rg", {"image": col})
        value, lease = arena.get("rg")
        served = list(value["image"])
        assert len(jpeg._runs(served)) == 1
        np.testing.assert_array_equal(jpeg.decode_jpeg_batch(served, device=CPU).numpy(),
                                      fresh)
        lease.release()
    finally:
        arena.close()


# -- the cache planes -------------------------------------------------------------------


def test_memcache_serves_peer_store_from_arena_without_refill():
    arena = CacheArena(budget_bytes=1 << 20)
    try:
        fills = []

        def fill():
            fills.append(1)
            return _payload(fill=3)

        # two private stores = two processes, one shared arena between them
        a = MemCache(1 << 20, store=_Store(), arena=arena)
        try:
            b = MemCache(1 << 20, store=_Store(), arena=arena)
            try:
                a.get("rg0", fill)
                assert fills == [1]
                served = [None]
                value = b.get("rg0", fill, served=served)
                assert fills == [1] and served[0] == "arena"  # the peer never refilled
                assert value["x"][0] == 3.0 and not value["x"].flags.writeable
                writable = b.get_writable("rg0", fill)  # CoW never poisons the entry
                writable["x"][0] = -1.0
                assert a.get("rg0", fill)["x"][0] == 3.0
                a.invalidate("rg0")  # reaches the arena too
                b2 = MemCache(1 << 20, store=_Store(), arena=arena)
                try:
                    b2.get("rg0", fill)
                    assert fills == [1, 1]
                finally:
                    b2.clear()
            finally:
                b.clear()
        finally:
            a.clear()
    finally:
        arena.close()


def test_tiered_funnel_attributes_arena_serves():
    """The funnel's counts: a fill in one "process", an arena serve in another."""
    from petastorm_tpu_torch.io.tiers import TieredCache

    arena = CacheArena(budget_bytes=1 << 20)
    try:
        one = TieredCache(mem=MemCache(1 << 20, store=_Store(), arena=arena))
        two = TieredCache(mem=MemCache(1 << 20, store=_Store(), arena=arena))
        try:
            one.get("k", lambda: _payload())
            two.get("k", lambda: pytest.fail("the arena must serve"))
            two.get("k", lambda: pytest.fail("the local store must serve"))
            s1, s2 = one.stats(), two.stats()
            assert s1["tier_remote_hits"] == 1 and s1["tier_arena_hits"] == 0
            assert s2["tier_arena_hits"] == 1 and s2["tier_mem_hits"] == 1
            assert s2["tier_remote_hits"] == 0
        finally:
            one.clear()
            two.clear()
    finally:
        arena.close()


def test_footercache_shares_serialized_blob_host_wide(tmp_path):
    from petastorm_tpu_torch.io.footercache import FooterCache

    path = str(tmp_path / "f.parquet")
    pq.write_table(pa.table({"id": np.arange(32, dtype=np.int64)}), path,
                   row_group_size=8)
    metadata = pq.read_metadata(path)
    size = os.path.getsize(path)
    assert arena_mod.host_arena(1 << 20) is not None
    first, second, third = FooterCache(), FooterCache(), FooterCache()
    try:
        first.put(path, metadata, size=size)  # publishes the thrift bytes
        # a fresh cache ("another process") parses on map: fs=None proves the store is
        # never touched
        entry = second.get(None, path, source=None)
        assert entry.num_row_groups == 4 and entry.row_group_rows == (8, 8, 8, 8)
        assert second.stats()["footer_cache_misses"] == 1  # a local miss, an arena hit
        # another size is another file: the blob must not serve
        with pytest.raises(Exception):
            third.get(None, path, source=_FakeSource(size + 1))
    finally:
        for cache in (first, second, third):
            cache.clear()


class _FakeSource:
    def __init__(self, size):
        self._size = size

    def size(self):
        return self._size

    def tell(self):
        raise IOError("the store must not be read in this test")

    def seek(self, pos):
        raise IOError("the store must not be read in this test")

    def read(self, *a):
        raise IOError("the store must not be read in this test")


def test_footer_blob_equals_the_parsed_footer(tmp_path):
    """The serialized footer the arena carries parses to the same footer: row-group
    rows, column-chunk offsets and sizes, statistics. Otherwise the pass-through would
    classify differently in a child that mapped the footer and one that parsed it."""
    from petastorm_tpu_torch.io.footercache import _parse_metadata_blob, _serialize_metadata

    rng = np.random.default_rng(4)
    path = str(tmp_path / "stats.parquet")
    pq.write_table(pa.table({"i": rng.integers(0, 1000, 5000),
                             "f": rng.standard_normal(5000).astype(np.float32),
                             "s": ["v%d" % (i % 17) for i in range(5000)]}),
                   path, row_group_size=1200, compression="snappy")
    md = pq.read_metadata(path)
    back = _parse_metadata_blob(_serialize_metadata(md))
    assert back.equals(md) and back.num_row_groups == md.num_row_groups == 5
    for rg in range(md.num_row_groups):
        a, b = md.row_group(rg), back.row_group(rg)
        assert a.num_rows == b.num_rows
        for c in range(a.num_columns):
            ca, cb = a.column(c), b.column(c)
            assert (ca.data_page_offset, ca.dictionary_page_offset,
                    ca.total_compressed_size, ca.compression, ca.encodings) == \
                (cb.data_page_offset, cb.dictionary_page_offset,
                 cb.total_compressed_size, cb.compression, cb.encodings)
            assert ca.statistics.equals(cb.statistics)


def test_remote_engine_maps_a_peers_footer_instead_of_fetching_it(tmp_path):
    """The engine's footer plane takes a footer another process published: no tail GET,
    counted as an arena map."""
    from petastorm_tpu_torch.io.footercache import FooterCache
    from petastorm_tpu_torch.io.latencyfs import CloudLatencyFS
    from petastorm_tpu_torch.io.remote import LatencyModel, RemoteIoOptions, RemoteReadEngine

    path = str(tmp_path / "f.parquet")
    pq.write_table(pa.table({"id": np.arange(64, dtype=np.int64)}), path,
                   row_group_size=16)
    assert arena_mod.host_arena(1 << 20) is not None
    peer = FooterCache()
    peer.put(path, pq.read_metadata(path), size=os.path.getsize(path))
    fs = CloudLatencyFS(pafs.LocalFileSystem(), sleep=False)
    mine = FooterCache()
    engine = RemoteReadEngine(fs, options=RemoteIoOptions(hedge=False), footer_cache=mine,
                              latency_model=LatencyModel())
    try:
        table, _ = engine.read_row_groups(path, [2], None)
        assert table.column("id").to_pylist() == list(range(32, 48))
        stats = engine.stats()
        assert stats["remote_footer_fetches"] == 0
        assert stats["remote_footer_arena_maps"] == 1
        assert fs.footer_requests({path: os.path.getsize(path)},
                                  {path: pq.read_metadata(path).serialized_size + 8}) == []
    finally:
        engine.shutdown()
        peer.clear()
        mine.clear()


def test_pageindexcache_memo_shared_through_arena():
    from petastorm_tpu_torch.io.pagedec import PageIndexCache

    assert arena_mod.host_arena(1 << 20) is not None
    a = PageIndexCache()
    a.put("f.parquet", 2, "col", 4096, (4096, 8192, 12288))
    b = PageIndexCache()  # a peer that never walked the chunk
    assert b.get("f.parquet", 2, "col") == (4096, (4096, 8192, 12288))
    assert b.get("f.parquet", 3, "col") is None


# -- the reader -------------------------------------------------------------------------


def _write_store(root, files=8, rows=16):
    os.makedirs(root, exist_ok=True)
    for i in range(files):
        pq.write_table(pa.table({"id": np.arange(rows, dtype=np.int64) + i * rows}),
                       os.path.join(root, "part_%02d.parquet" % i), row_group_size=rows)
    return "file://" + root, files * rows


def test_reader_funnel_creates_arena_and_children_inherit_env(tmp_path):
    """A reader with ``arena_bytes`` creates the process arena (before discovery) and
    serves through it; the token is what a process pool exports to its children
    (their attach: ``test_pool_children_serve_from_the_arena_with_the_store_gone``)."""
    root = str(tmp_path / "ds")
    os.makedirs(root)
    pq.write_table(pa.table({"id": np.arange(64, dtype=np.int64)}),
                   os.path.join(root, "p0.parquet"), row_group_size=16)
    with make_batch_reader("file://" + root, reader_pool_type="dummy",
                           shuffle_row_groups=False,
                           io_options={"arena_bytes": 16 << 20}) as reader:
        ids = sorted(int(v) for batch in reader for v in np.asarray(batch.id))
        stats = reader.io_stats()
    assert ids == list(range(64))
    assert stats["arena_entries"] >= 4  # one decoded entry a row group (+ the footer)
    assert arena_mod.current_token() == arena_mod.process_arena().spec.token


def test_arena_off_is_byte_identical(tmp_path, monkeypatch):
    root = str(tmp_path / "ds")
    os.makedirs(root)
    rng = np.random.default_rng(11)
    pq.write_table(pa.table({"id": np.arange(48, dtype=np.int64), "x": rng.random(48)}),
                   os.path.join(root, "p0.parquet"), row_group_size=16)

    def scan():
        with make_batch_reader("file://" + root, reader_pool_type="dummy",
                               shuffle_row_groups=False,
                               io_options={"arena_bytes": 16 << 20}) as reader:
            out = [(np.asarray(b.id).tolist(), np.asarray(b.x).tobytes()) for b in reader]
        shared_store().clear()
        return out

    monkeypatch.setenv("PTPU_ARENA", "off")
    baseline = scan()
    assert arena_mod.process_arena() is None  # the kill switch held
    monkeypatch.delenv("PTPU_ARENA")
    assert scan() == baseline
    assert arena_mod.process_arena() is not None


_HOLDER = r"""
import sys, time
sys.path.insert(0, %r)
from petastorm_tpu_torch.io.arena import ArenaSpec, CacheArena
arena = CacheArena(spec=ArenaSpec(%r))
held = [arena.get(("mc", "k")) for _ in range(2)]
assert all(h is not None for h in held)
print("held", flush=True)
time.sleep(60)
"""


def test_sigkilled_holder_is_reclaimed_without_corrupting_peers():
    """A process killed while it holds arena leases: its holder refcounts pin the
    entry until ``reclaim()`` drops them; this process's mapped view of the same entry
    survives bit-exact, and ``close()`` leaves no segment behind."""
    arena = arena_mod.host_arena(1 << 20)
    arena.put(("mc", "k"), {"x": np.arange(256, dtype=np.int64)})
    mine = arena.get(("mc", "k"))
    proc = subprocess.Popen([sys.executable, "-c", _HOLDER % (ROOT, arena.spec.token)],
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "held"
        assert arena.stats()["arena_held_leases"] == 3
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    assert arena.reclaim() == 2
    stats = arena.stats()
    assert stats["arena_held_leases"] == 1 and stats["arena_attached"] == 1
    assert np.array_equal(mine[0]["x"], np.arange(256, dtype=np.int64))
    mine[1].release()


def test_pool_children_serve_from_the_arena_with_the_store_gone(tmp_path):
    """A warm arena in this process; a process pool whose children attach at bootstrap
    reads every row with the store renamed away after the reader was built: no child
    read the store (readahead off: a prefetch would read it past the cache funnel)."""
    root = str(tmp_path / "ds")
    url, total = _write_store(root)
    opts = {"arena_bytes": 32 << 20, "readahead": False}
    with make_batch_reader(url, reader_pool_type="dummy", shuffle_row_groups=False,
                           io_options=opts) as reader:
        assert sorted(int(v) for b in reader for v in np.asarray(b.id)) == \
            list(range(total))
    with make_batch_reader(url, reader_pool_type="process", workers_count=2,
                           shuffle_row_groups=False, results_timeout_s=120,
                           io_options=opts) as reader:
        os.rename(root, root + ".gone")
        try:
            ids = sorted(int(v) for b in reader for v in np.asarray(b.id))
            children = reader.io_stats()["children"]
        finally:
            os.rename(root + ".gone", root)
    assert ids == list(range(total))
    assert sum(c["tier_arena_hits"] for c in children.values()) == 8
    assert sum(c.get("tier_remote_hits", 0) for c in children.values()) == 0
    assert all(c["arena_attached"] >= 2 for c in children.values())


def test_readahead_hints_skip_what_the_arena_holds(tmp_path):
    """A new pool's children with readahead on over a warm arena: their hints find the
    row groups in the arena, so they read nothing from the store (the JAX package's
    hints ask only the local store and the disk, and prefetch them again)."""
    from petastorm_tpu_torch.io.latencyfs import CloudLatencyFS

    url, total = _write_store(str(tmp_path / "ds"), files=4)
    opts = {"arena_bytes": 16 << 20, "remote": {"hedge": False}}
    fs = CloudLatencyFS(pafs.LocalFileSystem(), sleep=False)
    with make_batch_reader(url, filesystem=fs, reader_pool_type="dummy",
                           shuffle_row_groups=False, io_options=opts) as reader:
        assert sorted(int(v) for b in reader for v in np.asarray(b.id)) == \
            list(range(total))
    with make_batch_reader(url, filesystem=fs, reader_pool_type="process",
                           workers_count=2, results_timeout_s=120,
                           io_options=opts) as reader:
        ids = sorted(int(v) for b in reader for v in np.asarray(b.id))
        children = reader.io_stats()["children"]
    assert ids == list(range(total))
    assert sum(c.get("remote_gets", 0) for c in children.values()) == 0
    assert sum(c["tier_arena_hits"] for c in children.values()) == 4  # a row group a file


def test_process_pool_fetches_each_footer_from_the_store_once(tmp_path):
    """Over the simulator: with an arena, the parent's planning reads each footer and
    the children map them (no footer GET in any child); without one, each child fetches
    the footers of the files it reads."""
    from petastorm_tpu_torch.io.latencyfs import CloudLatencyFS

    url, total = _write_store(str(tmp_path / "ds"), files=4)

    def run(arena_bytes):
        shared_footer_cache().clear()
        fs = CloudLatencyFS(pafs.LocalFileSystem(), sleep=False)
        with make_batch_reader(url, filesystem=fs, reader_pool_type="process",
                               workers_count=2, shuffle_row_groups=False,
                               results_timeout_s=120,
                               io_options={"arena_bytes": arena_bytes,
                                           "remote": {"hedge": False}}) as reader:
            ids = sorted(int(v) for b in reader for v in np.asarray(b.id))
            children = reader.io_stats()["children"]
        assert ids == list(range(total))
        return (sum(c.get("remote_footer_fetches", 0) for c in children.values()),
                sum(c.get("remote_footer_arena_maps", 0) for c in children.values()))

    fetched, mapped = run(16 << 20)
    assert fetched == 0 and mapped >= 4
    arena_mod.close_process_arena()
    shared_store().clear()
    fetched, mapped = run(0)
    assert fetched >= 4 and mapped == 0


_FLIGHT_HOLDER = r"""
import sys, time
sys.path.insert(0, %r)
from petastorm_tpu_torch.io.arena import ArenaSpec, CacheArena
arena = CacheArena(spec=ArenaSpec(%r))
with arena.single_flight(("ft", "f.parquet")):
    print("in", flush=True)
    time.sleep(1.5)
arena.detach()
"""


def test_single_flight_serializes_a_key_across_processes():
    """While another process runs the fill of a key, this process waits for it; a key on
    another stripe does not wait."""
    arena = arena_mod.host_arena(1 << 20)
    proc = subprocess.Popen([sys.executable, "-c", _FLIGHT_HOLDER % (ROOT,
                                                                     arena.spec.token)],
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "in"
        t0 = time.perf_counter()
        with arena.single_flight(("ft", "other.parquet")):
            free = time.perf_counter() - t0
        with arena.single_flight(("ft", "f.parquet")):
            waited = time.perf_counter() - t0
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    assert free < 0.5 and waited >= 0.5  # the holder keeps the key 1.5 s


def test_footers_fetched_once_by_threads_and_once_across_a_pool(tmp_path):
    """A store planned from its key-value metadata (the planner reads no footer) over
    the simulator: four reader threads fetch each footer once in their process, and a
    pool of three children with an arena fetches each footer once across the pool."""
    from petastorm_tpu_torch.io.latencyfs import CloudLatencyFS
    from petastorm_tpu_torch.metadata import write_petastorm_tpu_metadata
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    root = str(tmp_path / "ds")
    url, total = _write_store(root, files=3, rows=64)
    for i in range(3):  # four row groups a file
        t = pq.read_table(os.path.join(root, "part_%02d.parquet" % i))
        pq.write_table(t, os.path.join(root, "part_%02d.parquet" % i), row_group_size=16)
    schema = Unischema("Ids", [UnischemaField("id", np.int64, (), None, False)])
    write_petastorm_tpu_metadata(pafs.LocalFileSystem(), root, schema,
                                 {"part_%02d.parquet" % i: 4 for i in range(3)})

    def run(pool, arena_bytes):
        shared_footer_cache().clear()
        fs = CloudLatencyFS(pafs.LocalFileSystem(), sleep=True, base_latency_s=0.01,
                            tail_fraction=0.0)
        with make_batch_reader(url, filesystem=fs, reader_pool_type=pool,
                               workers_count=3 if pool == "process" else 4,
                               results_timeout_s=120,
                               io_options={"arena_bytes": arena_bytes, "readahead": False,
                                           "remote": {"hedge": False}}) as reader:
            ids = sorted(int(v) for b in reader for v in np.asarray(b.id))
            io = reader.io_stats()
        assert ids == list(range(total))
        if pool == "process":
            return sum(c.get("remote_footer_fetches", 0) for c in io["children"].values())
        return io["remote_footer_fetches"]

    assert run("thread", 0) == 3
    assert run("process", 16 << 20) == 3


def test_loader_exit_drain_leaves_no_orphaned_segments(tmp_path):
    """Breaking out of a process-pool DataLoader mid-stream: the exit drain reclaims,
    and closing the arena leaves no segment behind (the autouse check)."""
    from petastorm_tpu_torch.loader import DataLoader

    url, _ = _write_store(str(tmp_path / "ds"))
    reclaims = []
    active0 = lease_stats()["active"]
    orig = CacheArena.reclaim

    def counting(self, pid=None):
        reclaims.append(pid)
        return orig(self, pid)

    CacheArena.reclaim = counting
    try:
        reader = make_batch_reader(url, num_epochs=None, workers_count=2,
                                   shuffle_row_groups=False, reader_pool_type="process",
                                   results_timeout_s=120,
                                   io_options={"arena_bytes": 32 << 20})
        with DataLoader(reader, batch_size=16, device=CPU) as loader:
            for i, _batch in enumerate(loader):
                if i >= 3:
                    break
    finally:
        CacheArena.reclaim = orig
    assert reclaims  # the exit drain swept dead holders
    assert arena_mod.process_arena() is not None
    arena_mod.close_process_arena()
    assert lease_stats()["active"] == active0
