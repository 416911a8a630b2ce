"""The port's object-store tier against the JAX package's: the cloud-latency simulator,
the ranged-GET engine (footer GETs, coalesced column-chunk GETs, the sparse file), request
hedging, the page-granular raw-chunk planner and the reader on a simulated store
(ROADMAP.md Queue 1 item 5b).

Three kinds of case:

- the JAX package's own contracts (``tests/test_remote_io.py``: ``TestCloudLatencyFS``,
  ``TestRemoteEngine``, ``TestHedging``, ``TestReaderIntegration``, ``TestOptions``),
  case for case, on the port's modules;
- the pure parts fed the same seeded inputs in both packages, outputs equal: the
  simulator's delays, the latency model's hedge deadline, ``column_chunk_ranges`` and the
  raw-chunk request plan with and without a walked page index;
- one store read through both packages' factories over their ``CloudLatencyFS`` (one
  worker, readahead off, ``sleep=False``): rows equal per id, the same GET count, and the
  JPEG store's uint8 images bit-exact through the port's plain stage 2.

The ``io.remote`` chaos case of ``TestHedging`` and the ``footer_unreadable`` quarantine
cases of ``TestReaderIntegration`` are in ``tests/test_torch_chaos.py``;
The JAX package's ``TestKwargProbe`` (its loader's probe of a codec's ``sharding=`` keyword)
has no counterpart: the port's codecs take ``device=``, and each rank decodes on its own
card, so no kwarg probe is needed. ``gpu``-marked cases run the kernels on the card and
skip here.
"""
import os
import pickle
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.fs as pafs
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

from petastorm_tpu import metadata as ref_metadata  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu import types as ref_types  # noqa: E402
from petastorm_tpu.codecs import CompressedImageCodec as RefImage  # noqa: E402
from petastorm_tpu.codecs import ScalarCodec as RefScalar  # noqa: E402
from petastorm_tpu.io import latencyfs as ref_latencyfs  # noqa: E402
from petastorm_tpu.io import memcache as ref_memcache  # noqa: E402
from petastorm_tpu.io import pagedec as ref_pagedec  # noqa: E402
from petastorm_tpu.io import remote as ref_remote  # noqa: E402
from petastorm_tpu.obs.metrics import MetricsRegistry  # noqa: E402
from petastorm_tpu.unischema import Unischema as RefSchema  # noqa: E402
from petastorm_tpu.unischema import UnischemaField as RefField  # noqa: E402
from petastorm_tpu_torch import make_batch_reader, make_reader  # noqa: E402
from petastorm_tpu_torch.io import IoOptions  # noqa: E402
from petastorm_tpu_torch.io.footercache import FooterCache, shared_footer_cache  # noqa: E402
from petastorm_tpu_torch.io.latencyfs import CloudLatencyFS, LatencyFS  # noqa: E402
from petastorm_tpu_torch.io.lease import lease_stats  # noqa: E402
from petastorm_tpu_torch.io.memcache import shared_store  # noqa: E402
from petastorm_tpu_torch.io.pagedec import shared_page_index  # noqa: E402
from petastorm_tpu_torch.io.remote import (LatencyModel, RemoteIoOptions,  # noqa: E402
                                           RemoteReadEngine, build_engine,
                                           column_chunk_ranges, fs_is_remote, size_class)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """No io env var leaks in; every case leaves both packages' process-wide memcache
    stores and page indexes empty."""
    for name in list(os.environ):
        if name.startswith(("PTPU_READAHEAD", "PTPU_IO_", "PTPU_MEMCACHE", "PTPU_ARENA",
                            "PTPU_REMOTE", "PTPU_FOOTER_CACHE", "PTPU_TIER_",
                            "PTPU_PAGEDEC")):
            monkeypatch.delenv(name)
    yield
    shared_store().clear()
    ref_memcache.shared_store().clear()
    shared_page_index().clear()
    ref_pagedec.shared_page_index().clear()


def _write_dataset(root, files=2, groups_per_file=4, rows_per_group=16, row_bytes=512):
    rows = files * groups_per_file * rows_per_group
    per_file = rows // files
    written = 0
    for i in range(files):
        ids = np.arange(written, written + per_file, dtype=np.int64)
        payload = [bytes([j % 251]) * row_bytes for j in ids]
        pq.write_table(pa.table({"id": ids, "payload": payload}),
                       os.path.join(root, "part-%02d.parquet" % i),
                       row_group_size=rows_per_group)
        written += per_file
    return sorted(os.path.join(root, n) for n in os.listdir(root))


def _engine_opts(**over):
    base = dict(enabled=True, hedge=False, footer_cache_bytes=0, min_gap_bytes=4096,
                target_request_bytes=1 << 20)
    base.update(over)
    return RemoteIoOptions(**base)


def _engine(fs=None, **over):
    return RemoteReadEngine(fs if fs is not None else pafs.LocalFileSystem(),
                            options=_engine_opts(**over), latency_model=LatencyModel())


# -- the cloud simulator ----------------------------------------------------------------


class TestCloudLatencyFS:
    def test_deterministic_and_attempt_sensitive(self):
        fs1 = CloudLatencyFS(pafs.LocalFileSystem(), seed=3, sleep=False)
        fs2 = CloudLatencyFS(pafs.LocalFileSystem(), seed=3, sleep=False)
        d1 = fs1.delay_for("p", 0, 100, 1)
        assert d1 == fs2.delay_for("p", 0, 100, 1)
        assert d1 != fs1.delay_for("p", 0, 100, 2)  # a hedge rolls fresh dice
        assert d1 != CloudLatencyFS(pafs.LocalFileSystem(), seed=4,
                                    sleep=False).delay_for("p", 0, 100, 1)

    def test_accounting_and_footer_window(self, tmp_path):
        paths = _write_dataset(str(tmp_path), files=1)
        fs = CloudLatencyFS(pafs.LocalFileSystem(), sleep=False)
        with fs.open_input_file(paths[0]) as f:
            f.seek(0)
            f.read(10)
        size = os.path.getsize(paths[0])
        assert fs.request_count() == 1
        assert fs.requests[0]["offset"] == 0 and fs.requests[0]["nbytes"] == 10
        assert fs.footer_requests({paths[0]: size}, 64) == []
        with fs.open_input_file(paths[0]) as f:
            f.seek(size - 8)
            f.read(8)
        assert len(fs.footer_requests({paths[0]: size}, 64)) == 1
        fs.reset_accounting()
        assert fs.request_count() == 0 and fs.read_calls[0] == 0

    def test_pickles_for_process_pools(self):
        fs = CloudLatencyFS(pafs.LocalFileSystem(), seed=1, sleep=False)
        fs._account("p", 0, 1)
        clone = pickle.loads(pickle.dumps(fs))
        assert clone.requests == [] and fs.request_count() == 1
        assert clone.delay_for("p", 0, 100, 1) == fs.delay_for("p", 0, 100, 1)

    def test_type_name_marks_remote(self):
        local = pafs.LocalFileSystem()
        assert not fs_is_remote(local)
        assert not fs_is_remote(LatencyFS(local, 0.0))  # delegates 'local'
        assert fs_is_remote(CloudLatencyFS(local, sleep=False))

    @pytest.mark.parametrize("seed", [0, 7, 123])
    def test_delay_for_equals_reference_on_a_grid(self, seed):
        """The same seed gives the same delay for each request in both packages: paths
        (basename dice), offsets, sizes and attempts, tails included."""
        kw = dict(seed=seed, sleep=False, tail_fraction=0.2)
        ours = CloudLatencyFS(pafs.LocalFileSystem(), **kw)
        theirs = ref_latencyfs.CloudLatencyFS(pafs.LocalFileSystem(), **kw)
        rng = np.random.default_rng(seed)
        paths = ["/tmp/run-%d/part-%02d.parquet" % (seed, i) for i in range(4)]
        tails = 0
        for _ in range(200):
            path = paths[int(rng.integers(0, len(paths)))]
            off, n = int(rng.integers(0, 1 << 30)), int(rng.integers(1, 1 << 24))
            attempt = int(rng.integers(1, 4))
            d = ours.delay_for(path, off, n, attempt)
            assert d == theirs.delay_for(path, off, n, attempt)
            tails += d - n / float(1 << 30) > 0.03
        assert tails > 0  # the grid reaches the tail too
        assert ours.delay_for("/a/x.parquet", 5, 9, 1) == \
            ours.delay_for("/b/x.parquet", 5, 9, 1)  # the dice roll on the basename

    def test_request_log_equals_reference(self, tmp_path):
        """The same GETs through both simulators log the same requests, delays and
        attempt numbers (a repeat of one range is attempt 2)."""
        paths = _write_dataset(str(tmp_path), files=1)
        logs = []
        for mod in (CloudLatencyFS, ref_latencyfs.CloudLatencyFS):
            fs = mod(pafs.LocalFileSystem(), seed=5, sleep=False)
            for off, n in ((0, 10), (100, 50), (0, 10), (7, 3)):
                with fs.open_input_file(paths[0]) as f:
                    f.seek(off)
                    assert len(f.read(n)) == n
            logs.append(fs.requests)
        assert logs[0] == logs[1]
        assert [r["attempt"] for r in logs[0]] == [1, 1, 2, 1]


# -- the engine -------------------------------------------------------------------------


class TestRemoteEngine:
    def test_read_row_groups_byte_identical(self, tmp_path):
        paths = _write_dataset(str(tmp_path), files=1)
        engine = _engine()
        try:
            table, entry = engine.read_row_groups(paths[0], [1, 3], None)
            assert table.equals(pq.ParquetFile(paths[0]).read_row_groups([1, 3]))
            assert entry.row_group_rows[1] == 16
            stats = engine.stats()
            assert stats["remote_gets"] >= 1
            assert stats["remote_sparse_fallbacks"] == 0
            assert stats["remote_footer_fetches"] == 1  # no cache attached
        finally:
            engine.shutdown()

    def test_column_pruning_fetches_fewer_bytes(self, tmp_path):
        rng = np.random.default_rng(0)
        ids = np.arange(64, dtype=np.int64)
        path = os.path.join(str(tmp_path), "part-00.parquet")
        pq.write_table(pa.table({"id": ids, "payload": [rng.bytes(4096) for _ in ids]}),
                       path, row_group_size=16, compression="NONE")
        engine, engine2 = _engine(min_gap_bytes=0), _engine(min_gap_bytes=0)
        try:
            table, _ = engine.read_row_groups(path, [0], ["id"])
            assert table.column_names == ["id"]
            engine2.read_row_groups(path, [0], None)
            # both pay one footer tail GET; the payload column dwarfs id
            assert engine.stats()["remote_bytes"] < engine2.stats()["remote_bytes"] / 2
            assert engine.stats()["remote_sparse_fallbacks"] == 0
        finally:
            engine.shutdown()
            engine2.shutdown()

    def test_footer_cache_attached_fetches_once(self, tmp_path):
        paths = _write_dataset(str(tmp_path), files=1)
        cache = FooterCache()
        engine = RemoteReadEngine(pafs.LocalFileSystem(), options=_engine_opts(),
                                  footer_cache=cache, latency_model=LatencyModel())
        try:
            for rg in (0, 1, 2):
                engine.read_row_groups(paths[0], [rg], None)
            assert engine.stats()["remote_footer_fetches"] == 1
            assert cache.stats()["footer_cache_hits"] >= 2
        finally:
            engine.shutdown()
            cache.clear()

    def test_column_chunk_ranges_match_top_level_names(self, tmp_path):
        paths = _write_dataset(str(tmp_path), files=1)
        md = pq.read_metadata(paths[0])
        assert len(column_chunk_ranges(md, [0], None)) == 2
        assert len(column_chunk_ranges(md, [0], ["id"])) == 1
        assert column_chunk_ranges(md, [0], ["nope"]) == []

    def test_size_class_buckets(self):
        assert size_class(1) == "64KB"
        assert size_class(100 << 10) == "256KB"
        assert size_class(64 << 20) == ">16MB"
        for n in (0, 1, 65536, 65537, 1 << 20, (16 << 20) + 1):
            assert size_class(n) == ref_remote.size_class(n)

    def test_error_propagates_when_all_attempts_fail(self, tmp_path):
        engine = _engine()
        try:
            with pytest.raises(FileNotFoundError):
                engine.fetch_ranges(str(tmp_path / "missing.bin"), [(0, 10)])
        finally:
            engine.shutdown()

    @pytest.mark.parametrize("columns", [None, ["id"], ["payload", "nope"]])
    def test_column_chunk_ranges_equal_reference(self, tmp_path, columns):
        paths = _write_dataset(str(tmp_path), files=1)
        md = pq.read_metadata(paths[0])
        for rgs in ([0], [1, 3], [0, 1, 2, 3]):
            assert column_chunk_ranges(md, rgs, columns) == \
                ref_remote.column_chunk_ranges(md, rgs, columns)

    def test_footer_bigger_than_the_first_tail_get_takes_one_more(self, tmp_path):
        """A wide schema's footer outgrows the 32 KB first tail GET: exactly one more
        ranged GET fetches the rest, and the parsed footer equals pyarrow's."""
        path = str(tmp_path / "wide.parquet")
        pq.write_table(pa.table({"col_%04d" % i: np.arange(4) for i in range(400)}), path)
        engine = _engine()
        try:
            entry = engine.footer(path)
            assert entry.metadata.equals(pq.read_metadata(path))
            assert entry.metadata.serialized_size > 32 << 10
            assert engine.stats()["remote_gets"] == 2
        finally:
            engine.shutdown()

    def test_sparse_file_falls_back_to_one_counted_get(self, tmp_path):
        """A read outside the prefetched segments goes to the store as one ranged GET,
        counted, and returns the store's bytes."""
        from petastorm_tpu_torch.io.remote import _SparseFile

        paths = _write_dataset(str(tmp_path), files=1)
        blob = open(paths[0], "rb").read()
        engine = _engine()
        try:
            f = _SparseFile(paths[0], len(blob), [(0, blob[:100]), (100, blob[100:200])],
                            engine)
            f.seek(50)
            assert f.read(100) == blob[50:150]  # stitched across two segments
            assert engine.stats()["remote_sparse_fallbacks"] == 0
            f.seek(300)
            assert f.read(20) == blob[300:320]
            assert engine.stats()["remote_sparse_fallbacks"] == 1
        finally:
            engine.shutdown()

    def test_shutdown_joins_the_get_threads(self, tmp_path):
        paths = _write_dataset(str(tmp_path), files=1)
        engine = _engine(max_inflight=3)
        engine.fetch_ranges(paths[0], [(0, 10), (10, 10), (20, 10)])
        threads = list(engine._pool._threads)
        assert threads
        engine.shutdown()
        assert not any(t.is_alive() for t in threads)
        engine.shutdown()  # idempotent

    def test_live_knobs(self, tmp_path):
        paths = _write_dataset(str(tmp_path), files=1)
        engine = _engine(max_inflight=2)
        try:
            assert engine.apply_max_inflight(5) == 5 == engine.stats()["remote_max_inflight"]
            assert engine.apply_hedge_quantile(2.0) == 0.999
            out = engine.fetch_ranges(paths[0], [(0, 4), (4, 4)])
            assert [bytes(o) for o in out] == [open(paths[0], "rb").read()[:4],
                                               open(paths[0], "rb").read()[4:8]]
        finally:
            engine.shutdown()


# -- the raw-chunk planner ---------------------------------------------------------------


def _write_paged_store(root, rows=400_000, seed=0):
    """One file of one row group whose snappy int64 chunk (~1/4 of its 3.2 MB raw) spans
    many 64 KB pages: bigger than the smallest request target."""
    rng = np.random.default_rng(seed)
    path = os.path.join(root, "paged.parquet")
    pq.write_table(pa.table({"v": np.repeat(rng.integers(0, 1 << 40, rows // 4), 4),
                             "w": np.repeat(rng.integers(0, 1 << 20, rows // 8), 8)}),
                   path, row_group_size=rows, compression="snappy", use_dictionary=False,
                   data_page_size=64 << 10)
    return path


def _walk_index(path):
    """``{column: (chunk offset, page starts)}`` from this package's walker."""
    from petastorm_tpu_torch.io.pagedec import chunk_byte_range, walk_pages

    md = pq.read_metadata(path)
    rgmd = md.row_group(0)
    out = {}
    blob = open(path, "rb").read()
    for i in range(rgmd.num_columns):
        start, length = chunk_byte_range(rgmd.column(i))
        dict_page, pages = walk_pages(blob[start:start + length], rgmd.num_rows)
        out[rgmd.column(i).path_in_schema] = (start, [
            start + p.header_offset
            for p in ((dict_page,) if dict_page else ()) + tuple(pages)])
    return out


def _ref_raw_plan(path, columns, target):
    """The JAX engine's request plan of ``read_raw_column_chunks`` (its GETs recorded,
    not issued)."""
    engine = ref_remote.RemoteReadEngine(
        pafs.LocalFileSystem(), options=ref_remote.RemoteIoOptions(
            enabled=True, hedge=False, footer_cache_bytes=0,
            target_request_bytes=target),
        registry=MetricsRegistry(), latency_model=ref_remote.LatencyModel(MetricsRegistry()))
    seen = []
    orig = engine.fetch_ranges

    def record(p, ranges):
        if len(ranges) == 1 and ranges[0][0] + ranges[0][1] == os.path.getsize(p):
            return orig(p, ranges)  # the footer's tail GET
        seen.extend(ranges)
        return [b"\0" * ln for _off, ln in ranges]

    engine.fetch_ranges = record
    try:
        engine.read_raw_column_chunks(path, 0, columns)
    finally:
        engine.shutdown()
    return seen


@pytest.mark.parametrize("walked", [False, True])
def test_raw_chunk_plan_equals_reference(tmp_path, walked):
    """``read_raw_column_chunks``' request plan in both packages, with and without a
    walked page index: the same ranges in the same order."""
    path = _write_paged_store(str(tmp_path))
    if walked:
        for name, (start, pages) in _walk_index(path).items():
            shared_page_index().put(path, 0, name, start, pages)
            ref_pagedec.shared_page_index().put(path, 0, name, start, pages)
    engine = _engine(target_request_bytes=64 << 10)
    try:
        plans = engine.raw_chunk_plan(path, 0, ["v", "w"])
        ours = [r for _name, ranges in plans for r in ranges]
    finally:
        engine.shutdown()
    assert ours == _ref_raw_plan(path, ["v", "w"], 64 << 10)
    assert len(ours) > 2  # the chunks split


def test_raw_chunks_split_at_page_starts_on_the_reread(tmp_path):
    """Through the reader on a simulated store: the first read of a chunk over the
    request target splits at the target (no page index yet), the reader's walk records
    its pages, and the re-read splits only at walked page starts. The raw bytes equal
    the file's both times."""
    root = tmp_path / "store"
    root.mkdir()
    path = _write_paged_store(str(root))
    fs = CloudLatencyFS(pafs.LocalFileSystem(), sleep=False)
    opts = dict(readahead=False, pagedec="on",
                remote=dict(hedge=False, target_request_bytes=64 << 10))
    blob = open(path, "rb").read()
    md = pq.read_metadata(path)
    chunks = {}
    for i in range(md.row_group(0).num_columns):
        col = md.row_group(0).column(i)
        start = min(col.data_page_offset, col.dictionary_page_offset or col.data_page_offset)
        chunks[col.path_in_schema] = (start, col.total_compressed_size)
    cuts = []
    for epoch in range(2):
        fs.reset_accounting()
        with make_batch_reader("file://" + str(root), filesystem=fs,
                               reader_pool_type="dummy", io_options=opts) as r:
            r.adopt_passthrough(on_device=False)
            b = next(iter(r))
            assert type(b.v).__name__ == "PassthroughColumn"
            got = r.io_stats()
        assert got["remote_sparse_fallbacks"] == 0
        # the planning reads (pyarrow's footer reads, which end at the file's end) aside
        starts = sorted(q["offset"] for q in fs.requests
                        if q["offset"] + q["nbytes"] < len(blob))
        cuts.append([s for s in starts if any(c < s < c + n for c, n in chunks.values())])
    index = {name: shared_page_index().get(path, 0, name) for name in chunks}
    assert all(v is not None for v in index.values())
    pages = {p for _start, offs in index.values() for p in offs}
    assert cuts[0] and not set(cuts[0]) <= pages  # the first read splits at the target
    assert cuts[1] and set(cuts[1]) <= pages  # the re-read at walked page starts
    for name, (start, n) in chunks.items():
        assert blob[start:start + n]  # the spans the reader walked are the file's


# -- hedging ----------------------------------------------------------------------------


class _SlowFirstAttemptFS:
    """The first GET of each range sleeps ``slow_s``; repeats are fast: the
    deterministic tail the hedge must beat."""

    type_name = "testremote"

    def __init__(self, payload, slow_s=0.5):
        self._payload = payload
        self._slow_s = slow_s
        self._lock = threading.Lock()
        self._attempts = {}
        self.attempt_log = []

    def open_input_file(self, path):
        fs = self

        class F:
            def __init__(self):
                self._pos = 0
                self.closed = False

            def seek(self, pos, whence=0):
                self._pos = pos
                return pos

            def tell(self):
                return self._pos

            def size(self):
                return len(fs._payload)

            def read(self, n=None):
                start = self._pos
                n = len(fs._payload) - start if n is None else n
                with fs._lock:
                    key = (path, start, n)
                    attempt = fs._attempts.get(key, 0) + 1
                    fs._attempts[key] = attempt
                    fs.attempt_log.append((start, n, attempt))
                if attempt == 1:
                    time.sleep(fs._slow_s)
                data = fs._payload[start:start + n]
                self._pos += len(data)
                return data

            def close(self):
                self.closed = True

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                self.close()

        return F()


def _warmed_model(store, nbytes, fast_s=0.002, n=32):
    model = LatencyModel()
    for _ in range(n):
        model.observe(store, nbytes, fast_s)
    return model


def _wait_leases(acquired0, released0, want):
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        s = lease_stats()
        got = (s["acquired"] - acquired0, s["released"] - released0)
        if got == want:
            return got
        time.sleep(0.02)
    return got


class TestHedging:
    def test_hedge_fires_wins_and_loser_releases_lease(self):
        payload = bytes(range(256)) * 16
        fs = _SlowFirstAttemptFS(payload, slow_s=0.6)
        opts = _engine_opts(hedge=True, hedge_min_samples=8, hedge_min_s=0.01,
                            hedge_quantile=0.9)
        engine = RemoteReadEngine(fs, options=opts,
                                  latency_model=_warmed_model("testremote", 512))
        s0 = lease_stats()
        try:
            t0 = time.perf_counter()
            out = engine.fetch_ranges("blob", [(64, 512)])
            elapsed = time.perf_counter() - t0
            # exactly one copy, byte-correct, delivered by the hedge far sooner than
            # the 0.6 s the stuck primary takes
            assert bytes(out[0]) == payload[64:64 + 512]
            assert elapsed < 0.4
            stats = engine.stats()
            assert stats["remote_hedges"] == 1 and stats["remote_hedge_wins"] == 1
            # the slow primary lands later: it releases its lease without delivering
            assert _wait_leases(s0["acquired"], s0["released"], (2, 2)) == (2, 2)
            assert lease_stats()["leaked"] == s0["leaked"]
            assert [a for _s, _n, a in fs.attempt_log] == [1, 2]
        finally:
            engine.shutdown()

    def test_queued_gets_are_not_hedged(self):
        """The hedge deadline runs from execution start, not the submit: a GET queued
        behind a saturated pool waits on us, not on a slow replica."""
        payload = bytes(range(256)) * 8
        fs = _SlowFirstAttemptFS(payload, slow_s=0.0)
        slow_once = [True]
        orig_open = fs.open_input_file

        def open_input_file(path):
            f = orig_open(path)
            orig_read = f.read

            def read(n=None):
                if slow_once[0]:
                    slow_once[0] = False
                    time.sleep(0.4)  # only the FIRST GET executed is slow
                return orig_read(n)

            f.read = read
            return f

        fs.open_input_file = open_input_file
        opts = _engine_opts(hedge=True, hedge_min_samples=8, hedge_min_s=0.01,
                            max_inflight=1)
        engine = RemoteReadEngine(fs, options=opts,
                                  latency_model=_warmed_model("testremote", 256))
        try:
            out = engine.fetch_ranges("blob", [(0, 256), (256, 256), (512, 256)])
            assert [bytes(o) for o in out] == \
                [payload[0:256], payload[256:512], payload[512:768]]
            # only the slow first GET hedged; the two queued behind it did not
            assert engine.stats()["remote_hedges"] == 1
        finally:
            engine.shutdown()

    def test_no_hedge_below_min_samples(self):
        fs = _SlowFirstAttemptFS(b"x" * 1024, slow_s=0.05)
        engine = RemoteReadEngine(fs, options=_engine_opts(hedge=True,
                                                           hedge_min_samples=20),
                                  latency_model=LatencyModel())  # cold: no deadline
        try:
            assert bytes(engine.fetch_ranges("blob", [(0, 100)])[0]) == b"x" * 100
            assert engine.stats()["remote_hedges"] == 0
        finally:
            engine.shutdown()

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_latency_model_deadline_equals_reference(self, seed):
        """The same observations give the same hedge deadline in both packages, for
        every size class and quantile (the port keeps its own copy of the log-bucketed
        percentile)."""
        rng = np.random.default_rng(seed)
        ours, theirs = LatencyModel(), ref_remote.LatencyModel(MetricsRegistry())
        sizes = [1 << 10, 100 << 10, 2 << 20, 40 << 20]
        for _ in range(300):
            n = sizes[int(rng.integers(0, len(sizes)))]
            v = float(rng.lognormal(-4.0, 1.0)) if rng.random() > 0.05 else 0.0
            ours.observe("s3", n, v)
            theirs.observe("s3", n, v)
        for n in sizes + [5 << 20]:
            for q in (0.5, 0.9, 0.95, 0.999):
                for min_samples in (1, 20, 10_000):
                    assert ours.deadline("s3", n, q, min_samples, 0.005) == \
                        theirs.deadline("s3", n, q, min_samples, 0.005)
        ours.reset()
        assert ours.deadline("s3", sizes[0], 0.9, 1, 0.0) is None

    def test_hedging_over_the_simulators_tail_delivers_once(self, tmp_path):
        """The reader over a simulator with 30 % of GETs at 10x and hedging armed at the
        median (half the GETs outlast it, however loaded the host): hedges fire, the rows
        equal the unhedged read, and every lease comes back."""
        _write_dataset(str(tmp_path), files=2, groups_per_file=4)
        s0 = lease_stats()

        def read(hedge):
            fs = CloudLatencyFS(pafs.LocalFileSystem(), seed=2, sleep=True,
                                base_latency_s=0.003, tail_fraction=0.3,
                                tail_multiplier=10)
            ids = []
            hedges = 0
            for _ in range(3):
                with make_batch_reader("file://" + str(tmp_path), filesystem=fs,
                                       reader_pool_type="dummy", shuffle_row_groups=False,
                                       io_options=dict(readahead=False, remote=dict(
                                           hedge=hedge, hedge_quantile=0.5,
                                           hedge_min_samples=6,
                                           hedge_min_s=0.002))) as r:
                    ids.append([int(i) for b in r for i in b.id])
                    hedges += r.io_stats()["remote_hedges"]
            return ids, hedges

        on, hedges_on = read(True)
        off, hedges_off = read(False)
        assert on == off and hedges_off == 0 and hedges_on >= 1
        acquired = lease_stats()["acquired"] - s0["acquired"]
        assert _wait_leases(s0["acquired"], s0["released"], (acquired, acquired)) == \
            (acquired, acquired)
        assert lease_stats()["leaked"] == s0["leaked"]


# -- the reader on a simulated store -----------------------------------------------------


def _read_all(reader):
    return [(np.asarray(b.id).tolist(), [bytes(p) for p in b.payload]) for b in reader]


def _cloud_fs(**kw):
    kw.setdefault("sleep", False)
    return CloudLatencyFS(pafs.LocalFileSystem(), **kw)


class TestReaderIntegration:
    @pytest.fixture()
    def dataset(self, tmp_path):
        _write_dataset(str(tmp_path), files=2, groups_per_file=4)
        return str(tmp_path)

    def test_remote_tier_end_to_end_identity(self, dataset):
        with make_batch_reader("file://" + dataset, reader_pool_type="dummy",
                               shuffle_row_groups=False) as r:
            base = _read_all(r)
        with make_batch_reader("file://" + dataset, filesystem=_cloud_fs(),
                               reader_pool_type="thread", workers_count=2,
                               shuffle_row_groups=False,
                               io_options=dict(remote=dict(hedge=False))) as r:
            got = sorted(_read_all(r))
        assert got == sorted(base)

    def test_remote_engine_stats_surface_in_io_stats(self, dataset):
        with make_batch_reader("file://" + dataset, filesystem=_cloud_fs(),
                               reader_pool_type="dummy", shuffle_row_groups=False,
                               io_options=dict(readahead=False,
                                               remote=dict(hedge=False))) as r:
            _read_all(r)
            stats = r.io_stats()
        assert stats["remote_gets"] >= 8  # every row group read from the store
        assert stats["remote_sparse_fallbacks"] == 0
        assert "footer_cache_hits" in stats
        # no mem or disk tier: the port leaves the funnel out, so no tier counts
        assert "tier_remote_hits" not in stats

    def test_reset_rebuilds_remote_engine(self, dataset):
        with make_batch_reader("file://" + dataset, filesystem=_cloud_fs(),
                               reader_pool_type="dummy", shuffle_row_groups=False,
                               io_options=dict(remote=dict(hedge=False))) as reader:
            first = _read_all(reader)
            reader.reset()
            assert _read_all(reader) == first

    def test_remote_off_for_local_filesystem(self, dataset):
        with make_batch_reader("file://" + dataset, reader_pool_type="dummy",
                               shuffle_row_groups=False) as r:
            _read_all(r)
            assert "remote_gets" not in r.io_stats()  # the engine was never built

    def test_remote_enabled_forces_engine_on_local(self, dataset):
        with make_batch_reader("file://" + dataset, reader_pool_type="dummy",
                               shuffle_row_groups=False,
                               io_options=dict(remote=dict(enabled=True,
                                                           hedge=False))) as r:
            _read_all(r)
            assert r.io_stats()["remote_gets"] > 0

    @pytest.mark.parametrize("factory", ["batch", "rows"])
    def test_rows_and_gets_equal_reference(self, dataset, jpeg_store, factory):
        """One worker, readahead off, over each package's simulator: the same rows per
        id and the same number of ranged GETs (the per-row reader on the JPEG store,
        host-decoded by both)."""
        opts = dict(readahead=False, remote=dict(hedge=False))
        kw = dict(reader_pool_type="dummy", shuffle_row_groups=False, io_options=opts)
        url = "file://" + dataset
        if factory == "batch":
            with make_batch_reader(url, filesystem=_cloud_fs(), **kw) as r:
                ours = sorted(_read_all(r))
                gets = r.io_stats()["remote_gets"]
            with ref_reader.make_batch_reader(
                    url, filesystem=ref_latencyfs.CloudLatencyFS(
                        pafs.LocalFileSystem(), sleep=False), **kw) as r:
                theirs = sorted(_read_all(r))
                ref_gets = r.io_stats()["remote_gets"]
        else:
            with make_reader(jpeg_store, filesystem=_cloud_fs(), **kw) as r:
                ours = sorted((int(row.id), row.image.tobytes()) for row in r)
                gets = r.io_stats()["remote_gets"]
            with ref_reader.make_reader(
                    jpeg_store, filesystem=ref_latencyfs.CloudLatencyFS(
                        pafs.LocalFileSystem(), sleep=False), **kw) as r:
                theirs = sorted((int(row.id), row.image.tobytes()) for row in r)
                ref_gets = r.io_stats()["remote_gets"]
        assert ours == theirs and ours
        assert gets == ref_gets > 0

    def test_stop_mid_stream_releases_queued_gets_and_leases(self, tmp_path):
        """Seven reader threads' GET plans queue on one engine of 8 in flight; a stop
        mid-stream shuts the engine down first (``Reader.join``), which cancels the
        queued GETs: their waiters are released at once (not after the 300 s GET
        timeout), and every lease comes back."""
        rng = np.random.default_rng(5)
        for f in range(2):
            pq.write_table(pa.table({"c%d" % i: rng.integers(0, 9, 8192).astype(np.int32)
                                     for i in range(20)}),
                           str(tmp_path / ("p%d.parquet" % f)), row_group_size=1024,
                           compression="snappy")
        s0 = lease_stats()
        reader = make_batch_reader("file://" + str(tmp_path),
                                   filesystem=_cloud_fs(sleep=True, seed=3),
                                   workers_count=7, num_epochs=None,
                                   io_options={"pagedec": "on"})
        try:
            reader.adopt_passthrough(on_device=False)
            it = iter(reader)
            for _ in range(6):
                next(it)
        finally:
            t0 = time.perf_counter()
            reader.stop()
            reader.join()
            joined = time.perf_counter() - t0
        assert joined < 10.0
        s = lease_stats()
        done = _wait_leases(s0["acquired"], s0["released"],
                            (s["acquired"] - s0["acquired"],) * 2)
        assert done[0] == done[1] and lease_stats()["leaked"] == s0["leaked"]

    def test_process_pool_children_issue_the_gets(self, dataset):
        """The simulator pickles to the children with accounting of their own: the
        parent's log holds only the planning reads, and the children's GETs show in
        their ``io_stats()`` under ``"children"``."""
        fs = _cloud_fs()
        with make_batch_reader("file://" + dataset, filesystem=fs,
                               reader_pool_type="process", workers_count=2,
                               results_timeout_s=120,
                               io_options=dict(remote=dict(hedge=False))) as r:
            got = sorted(i for ids, _p in _read_all(r) for i in ids)
            children = r.io_stats()["children"]
        assert got == list(range(128))
        assert sum(c.get("remote_gets", 0) for c in children.values()) > 0
        assert all(c.get("remote_sparse_fallbacks", 0) == 0 for c in children.values())
        # the parent's own log holds its planning reads only (its footer scan)
        assert fs.request_count() > 0
        assert sum(c.get("remote_gets", 0) for c in children.values()) >= 8

    def test_passthrough_over_the_simulator_equals_the_local_read(self, tmp_path):
        """The pass-through's raw chunks fetched through the engine decode (host twin)
        byte-identical to the local classic read."""
        from petastorm_tpu_torch.io.pagedec import materialize_columns

        rng = np.random.default_rng(3)
        n = 4096
        pq.write_table(pa.table({"cat": rng.integers(0, 8, n).astype(np.int64),
                                 "dense": np.repeat(rng.standard_normal(n // 64), 64)
                                 .astype(np.float32)}),
                       str(tmp_path / "p.parquet"), row_group_size=1024,
                       compression="snappy")
        url = "file://" + str(tmp_path)
        with make_batch_reader(url, reader_pool_type="dummy", shuffle_row_groups=False) as r:
            want = [{k: np.asarray(getattr(b, k)) for k in ("cat", "dense")} for b in r]
        with make_batch_reader(url, filesystem=_cloud_fs(), reader_pool_type="dummy",
                               shuffle_row_groups=False,
                               io_options=dict(pagedec="on", readahead=False,
                                               remote=dict(hedge=False))) as r:
            r.adopt_passthrough(on_device=False)
            got = []
            for b in r:
                cols = {k: getattr(b, k) for k in ("cat", "dense")}
                assert all(type(v).__name__ == "PassthroughColumn" for v in cols.values())
                got.append(materialize_columns(cols))
            assert r.io_stats()["remote_gets"] > 0
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


# -- the JPEG store on a simulated store --------------------------------------------------


@pytest.fixture(scope="module")
def jpeg_store(tmp_path_factory):
    """24 JPEG rows (32x48, q85) in two files of one row group, written by the JAX
    package."""
    shape = (32, 48, 3)
    schema = RefSchema("RemoteJpeg", [
        RefField("id", np.int64, (), RefScalar(ref_types.LongType()), False),
        RefField("image", np.uint8, shape, RefImage("jpeg", 85), False),
    ])
    rng = np.random.RandomState(13)

    def rows():
        for i in range(24):
            noise = rng.randint(0, 256, shape).astype(np.float32)
            img = cv2.GaussianBlur(noise, (5, 5), 1.5)
            yield {"id": i, "image": img.clip(0, 255).astype(np.uint8)}

    url = "file://" + str(tmp_path_factory.mktemp("remote_jpeg") / "ds")
    ref_metadata.write_dataset(url, schema, rows(), row_group_size_mb=1, rows_per_file=12)
    return url


def test_jpeg_store_over_the_simulator_is_bit_exact_against_the_reference(jpeg_store):
    """The device-decode store read through each package's simulator (one worker,
    readahead off): every id once, each uint8 image through the port's plain stage 2
    bit for bit the JAX package's decode, and the same GET count."""
    from petastorm_tpu import loader as ref_loader
    from petastorm_tpu_torch.loader import DataLoader

    kw = dict(decode_on_device=True, reader_pool_type="dummy", shuffle_row_groups=False,
              io_options=dict(readahead=False, remote=dict(hedge=False)))
    reader = make_batch_reader(jpeg_store, filesystem=_cloud_fs(), **kw)
    ours = {}
    with DataLoader(reader, 8, device=CPU) as loader:
        for b in loader:
            ours.update(zip(b["id"].numpy().tolist(), b["image"].numpy()))
        gets = reader.io_stats()["remote_gets"]
    ref = ref_reader.make_batch_reader(
        jpeg_store, filesystem=ref_latencyfs.CloudLatencyFS(pafs.LocalFileSystem(),
                                                            sleep=False), **kw)
    theirs = {}
    with ref_loader.DataLoader(ref, 8) as loader:
        for b in loader:
            theirs.update(zip(np.asarray(b["id"]).tolist(), np.asarray(b["image"])))
        ref_gets = ref.io_stats()["remote_gets"]
    assert sorted(ours) == sorted(theirs) == list(range(24))
    for i in range(24):
        np.testing.assert_array_equal(ours[i], theirs[i])
    assert gets == ref_gets > 0


# -- options ----------------------------------------------------------------------------


class TestOptions:
    def test_remote_options_pickle_and_normalize(self):
        opts = IoOptions(remote=dict(enabled=True, disk_admit="scan-resistant"))
        clone = pickle.loads(pickle.dumps(opts))
        assert clone.remote.enabled is True
        assert clone.remote.disk_admit == "scan-resistant"
        assert RemoteIoOptions.normalize(clone.remote) is clone.remote
        with pytest.raises(TypeError):
            RemoteIoOptions.normalize("nope")
        with pytest.raises(ValueError):
            RemoteIoOptions(disk_admit="sometimes")

    def test_env_overrides(self, monkeypatch):
        monkeypatch.setenv("PTPU_REMOTE", "1")
        monkeypatch.setenv("PTPU_REMOTE_MIN_GAP_BYTES", "1234")
        monkeypatch.setenv("PTPU_REMOTE_HEDGE_QUANTILE", "0.9")
        monkeypatch.setenv("PTPU_TIER_DISK_ADMIT", "scan-resistant")
        opts, ref = RemoteIoOptions(), ref_remote.RemoteIoOptions()
        assert opts.enabled is True and opts.min_gap_bytes == 1234
        assert opts.disk_admit == "scan-resistant"
        for name in opts.__slots__:
            assert getattr(opts, name) == getattr(ref, name), name
        monkeypatch.setenv("PTPU_REMOTE", "auto")
        assert RemoteIoOptions().enabled is None

    def test_worker_pickle_drops_engine(self, tmp_path):
        _write_dataset(str(tmp_path), files=1)
        with make_batch_reader("file://" + str(tmp_path), reader_pool_type="dummy",
                               shuffle_row_groups=False,
                               io_options=dict(remote=dict(enabled=True,
                                                           hedge=False))) as r:
            _read_all(r)
            worker = r._worker
            assert worker._remote is not None
            clone = pickle.loads(pickle.dumps(worker))
            assert clone._remote is None and clone._remote_unavailable is False

    def test_build_engine_follows_the_auto_probe(self):
        opts = RemoteIoOptions()
        assert build_engine(pafs.LocalFileSystem(), opts) is None
        engine = build_engine(_cloud_fs(), opts)
        try:
            assert engine is not None and engine._footers is shared_footer_cache()
        finally:
            engine.shutdown()
        engine = build_engine(_cloud_fs(), RemoteIoOptions(footer_cache_bytes=0))
        try:
            assert engine._footers is None
        finally:
            engine.shutdown()


# -- object-store listing ----------------------------------------------------------------


def test_flat_object_listing_on_fsspec_bridge_equals_reference():
    """On an fsspec-bridged store the listing is one flat ``find()``: the same files
    as the JAX package's, and the same as the selector walk."""
    import fsspec
    from pyarrow.fs import FSSpecHandler, PyFileSystem

    from petastorm_tpu_torch import metadata as md

    mfs = fsspec.filesystem("memory")
    root = "/port_flat_listing_%d" % os.getpid()
    rid = 0
    for part in ("a=1/b=x", "a=1/b=y", "a=2/b=x"):
        for j in range(2):
            t = pa.table({"id": np.arange(rid, rid + 4, dtype=np.int64)})
            rid += 4
            with mfs.open("%s/%s/part-%d.parquet" % (root, part, j), "wb") as f:
                pq.write_table(t, f)
    with mfs.open(root + "/_SUCCESS", "wb") as f:
        f.write(b"")
    try:
        fs = PyFileSystem(FSSpecHandler(mfs))
        calls = []
        orig_find = mfs.find

        def find(path, *a, **k):
            calls.append(path)
            return orig_find(path, *a, **k)

        mfs.find = find
        flat = md._list_parquet_files(fs, root)
        assert calls == [root]
        assert flat == ref_metadata._list_parquet_files(fs, root)
        assert md._flat_object_listing(fs, root) is not None
        assert md._flat_object_listing(pafs.LocalFileSystem(), root) is None
        del mfs.find
        selector = [p for p in sorted(fi.path for fi in fs.get_file_info(
            pafs.FileSelector(root, recursive=True)) if fi.type == pafs.FileType.File)
            if p.endswith(".parquet")]
        assert flat == selector and len(flat) == 6
    finally:
        mfs.rm(root, recursive=True)


# -- on the card ------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_main_path_over_the_simulator_launches_stage2_and_k2(cuda_device, jpeg_store):
    """The main path read through the simulator: one stage2_planes, one stage2_rgb and
    one K2 launch a batch, images equal to the local read's."""
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image, jpeg
    from petastorm_tpu_torch.ops.image import normalize_images

    def transform(batch):
        return {**batch, "norm": normalize_images(batch["image"], [0.5] * 3, [0.25] * 3)}

    def images(fs):
        out = {}
        reader = make_batch_reader(jpeg_store, filesystem=fs, decode_on_device=True,
                                   workers_count=1, shuffle_row_groups=False)
        with DataLoader(reader, 8, device=cuda_device, device_transform=transform) as ld:
            for b in ld:
                out.update(zip(b["id"].cpu().numpy().tolist(), b["image"].cpu().numpy()))
        return out

    local = images(None)
    jpeg.stage2_planes_segments.launches = 0
    jpeg.stage2_rgb.launches = 0
    image.normalize_images.launches = 0
    remote = images(_cloud_fs())
    assert jpeg.stage2_planes_segments.launches == jpeg.stage2_rgb.launches \
        == image.normalize_images.launches == 3
    assert sorted(remote) == sorted(local) == list(range(24))
    for i in local:
        np.testing.assert_array_equal(remote[i], local[i])


@pytest.mark.gpu
def test_passthrough_over_the_simulator_launches_k3_scan_k4(cuda_device, tmp_path):
    """The pass-through read through the simulator: one K3, one scan and one K4 launch
    a batch, columns equal to the local classic read."""
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
    reader = make_batch_reader(url, filesystem=_cloud_fs(), workers_count=1,
                               shuffle_row_groups=False, io_options={"pagedec": "on"})
    with DataLoader(reader, 2048, device=cuda_device) as loader:
        got = [{k: b[k].cpu().numpy() for k in ("cat", "dense")} for b in loader]
    assert pk.snappy_inflate_ragged.launches == pk.rle_scan_pages.launches \
        == pk.extract_pages.launches == 4
    with make_batch_reader(url, reader_pool_type="dummy", shuffle_row_groups=False) as r:
        want = [{k: np.asarray(getattr(b, k)) for k in ("cat", "dense")} for b in r]
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
