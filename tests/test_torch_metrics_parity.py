"""The read path's metric families in the port against the JAX package's.

One seeded store is read through both packages' ``make_reader`` and
``make_batch_reader`` with the same ``IoOptions`` (readahead on, the mem and the disk
tier, the footer cache, two open files a thread, a ``FeaturePipeline`` on the tabular
read), two epochs each on the thread pool. Every family the JAX package writes in that
run exists in the port's registry with the same type and label names, the counts the
seeded run fixes are equal, and the controller's ``tier_share("remote")`` over the
run's window is the same. A live port run also fills the stats CLI's tier, footer-cache
and transform panels, and ``Reader.register_metrics`` exports a loader-less reader.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

import petastorm_tpu as ref  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu.control.controller import WindowContext as RefWindowContext  # noqa: E402
from petastorm_tpu.io import memcache as ref_memcache  # noqa: E402
from petastorm_tpu.obs.metrics import default_registry as ref_registry  # noqa: E402
from petastorm_tpu.ops import tabular as ref_tabular  # noqa: E402
import petastorm_tpu_torch as port  # noqa: E402
from petastorm_tpu_torch import reader as port_reader  # noqa: E402
from petastorm_tpu_torch.control.controller import WindowContext  # noqa: E402
from petastorm_tpu_torch.io import memcache as port_memcache  # noqa: E402
from petastorm_tpu_torch.obs.metrics import MetricsRegistry, default_registry  # noqa: E402
from petastorm_tpu_torch.ops import tabular as port_tabular  # noqa: E402

FILES, RGS, RG_ROWS = 4, 3, 8

#: the families of the read path (the JAX package's io/readahead.py, io/memcache.py,
#: io/footercache.py, io/tiers.py, reader.py, workers.py, ops/tabular.py)
READ_PATH_FAMILIES = {
    "ptpu_io_readahead_hits_total": "counter", "ptpu_io_readahead_misses_total": "counter",
    "ptpu_io_readahead_evictions_total": "counter",
    "ptpu_io_coalesced_reads_total": "counter", "ptpu_io_coalesced_items_total": "counter",
    "ptpu_io_readahead_depth": "gauge", "ptpu_io_readahead_bytes": "gauge",
    "ptpu_io_read_seconds": "histogram", "ptpu_io_wait_seconds": "histogram",
    "ptpu_io_memcache_hits_total": "counter", "ptpu_io_memcache_misses_total": "counter",
    "ptpu_io_memcache_evictions_total": "counter", "ptpu_io_memcache_bytes": "gauge",
    "ptpu_io_footer_cache_hits_total": "counter",
    "ptpu_io_footer_cache_misses_total": "counter",
    "ptpu_io_footer_cache_evictions_total": "counter",
    "ptpu_io_footer_cache_invalidations_total": "counter",
    "ptpu_io_footer_cache_bytes": "gauge",
    "ptpu_io_tier_hits_total": "counter", "ptpu_io_tier_bytes_total": "counter",
    "ptpu_io_file_evictions_total": "counter", "ptpu_io_steals_total": "counter",
    "ptpu_transform_rows_total": "counter", "ptpu_transform_seconds": "histogram",
}


@pytest.fixture(autouse=True)
def _clear_memcaches():
    """Both packages' memcache stores are process-wide and hold leases: leave them empty
    (and the stores start empty, so epoch 1 misses in both)."""
    port_memcache.shared_store().clear()
    ref_memcache.shared_store().clear()
    yield
    port_memcache.shared_store().clear()
    ref_memcache.shared_store().clear()


@pytest.fixture()
def store(tmp_path):
    """``FILES`` files of ``RGS`` row groups of ``RG_ROWS`` rows (id, x in [0, 1), a),
    made from a seed, with the unischema and row-group counts in the metadata."""
    import pyarrow as pa
    import pyarrow.fs as pafs
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.metadata import write_petastorm_tpu_metadata
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    rng = np.random.RandomState(26)
    root = str(tmp_path / "ds")
    os.makedirs(root)
    n = RGS * RG_ROWS
    for f in range(FILES):
        pq.write_table(pa.table({
            "id": np.arange(f * n, (f + 1) * n, dtype=np.int64),
            "x": rng.rand(n),
            "a": rng.randint(0, 1000, n).astype(np.int64)}),
            os.path.join(root, "part_%d.parquet" % f), row_group_size=RG_ROWS)
    schema = Unischema("Parity", [UnischemaField("id", np.int64, (), None, False),
                                  UnischemaField("x", np.float64, (), None, False),
                                  UnischemaField("a", np.int64, (), None, False)])
    write_petastorm_tpu_metadata(pafs.LocalFileSystem(), root, schema,
                                 {"part_%d.parquet" % f: RGS for f in range(FILES)})
    return root


#: readahead on (one IO thread), the mem tier; the disk tier is the reader's
#: ``cache_type``, the footer cache the process-wide default. With readahead off every
#: read runs on the one worker thread, in plan order.
READAHEAD_ON = dict(readahead=True, readahead_depth=3, io_threads=1,
                    memcache_bytes=64 << 20)
READAHEAD_OFF = dict(READAHEAD_ON, readahead=False)


def _read(pkg, tabular, memcache, root, tmp_path, tag, io_options):
    """Two epochs of the per-row read, then two of the tabular read with a feature
    pipeline, each on one worker thread in plan order; returns the ids delivered. The
    mem tier is emptied between the two reads: its key does not name the reader kind,
    so the batch read would be served the per-row read's payloads."""
    opts = dict(reader_pool_type="thread", workers_count=1, shuffle_row_groups=False,
                num_epochs=2, cache_type="local-disk",
                cache_location=str(tmp_path / ("cache_" + tag)),
                cache_size_limit=1 << 30, io_options=io_options)
    ids = []
    with pkg.make_reader("file://" + root, **opts) as reader:
        ids.extend(int(row.id) for row in reader)
    memcache.shared_store().clear()
    pipe = tabular.FeaturePipeline([tabular.Normalize("x", min=0, max=1),
                                    tabular.HashField("a", 8, out="ah")])
    opts["cache_location"] = str(tmp_path / ("cache_batch_" + tag))
    with pkg.make_batch_reader("file://" + root, transform_spec=pipe, **opts) as reader:
        for batch in reader:
            ids.extend(int(i) for i in batch.id)
    memcache.shared_store().clear()
    return ids


def _run_both(root, tmp_path, tag, io_options):
    """One read of each package; ``(JAX series written, port series written)``."""
    ref_before, port_before = _series(ref_registry()), _series(default_registry())
    theirs = _read(ref, ref_tabular, ref_memcache, root, tmp_path, "ref_" + tag,
                   io_options)
    ours = _read(port, port_tabular, port_memcache, root, tmp_path, "port_" + tag,
                 io_options)
    assert sorted(ours) == sorted(theirs) == sorted(list(range(FILES * RGS * RG_ROWS)) * 4)
    return (_written(ref_before, _series(ref_registry())),
            _written(port_before, _series(default_registry())))


def _series(registry):
    """``{(family, labels): (kind, value)}`` of every series, histograms as counts."""
    with registry._lock:
        metrics = list(registry._metrics.values())
    return {(m.name, m.labels): (m.kind, m.count if m.kind == "histogram" else m.value)
            for m in metrics}


def _written(before, after):
    """``{(family, labels): delta}`` of the series the run created or changed."""
    out = {}
    for key, (kind, value) in after.items():
        old = before.get(key, (kind, None))[1]
        if old != value:
            out[key] = value - (old or 0)
    return out


def _family_total(written, family, **labels):
    return sum(v for (name, lab), v in written.items()
               if name == family and all((k, val) in lab for k, val in labels.items())
               and (labels or not lab))


def _window(written):
    """The run as one controller window: each series' delta under its snapshot name."""
    window = {}
    for (name, labels), delta in written.items():
        full = name + ("{%s}" % ",".join('%s="%s"' % kv for kv in labels) if labels else "")
        window[full] = {"delta": delta}
    return window


def test_read_path_families_match_the_jax_package(store, tmp_path, monkeypatch):
    """The read with readahead on fixes the families, the tier and memcache serves and
    the transform's rows; which thread opens a file, and so the handle LRU's closes and
    the footer cache's hits, moves with when the IO thread gets to a read, so those are
    compared on the read with readahead off, where one thread does every read."""
    monkeypatch.setattr(ref_reader._WorkerBase, "MAX_OPEN_FILES", 2)
    monkeypatch.setattr(port_reader._WorkerBase, "MAX_OPEN_FILES", 2)
    for name in list(os.environ):
        if name.startswith("PTPU_"):
            monkeypatch.delenv(name)
    ref_written, port_written = _run_both(store, tmp_path, "on", READAHEAD_ON)
    port_series = _series(default_registry())

    # every family the JAX package wrote in the run: present in the port, same type and
    # label names (whether a timing-bound one such as the coalesced reads moved in this
    # run is not fixed by the seed)
    missing = []
    for name, labels in ref_written:
        kind = ref_registry()._families[name][0]
        label_names = tuple(k for k, _ in labels)
        fam = default_registry()._families.get(name)
        if fam is None or fam[0] != kind or not any(
                n == name and tuple(k for k, _ in lab) == label_names
                for n, lab in port_series):
            missing.append((name, labels, kind))
    assert not missing, missing
    for name in ("ptpu_io_readahead_misses_total", "ptpu_io_read_seconds",
                 "ptpu_io_wait_seconds", "ptpu_io_tier_bytes_total"):
        assert any(n == name for n, _ in port_written), name
    # one worker steals nothing: a steal of each package's dispatcher registers the last
    for pkg_workers, registry in ((__import__("petastorm_tpu.workers", fromlist=["x"]),
                                   ref_registry()),
                                  (__import__("petastorm_tpu_torch.workers", fromlist=["x"]),
                                   default_registry())):
        steals = registry.counter("ptpu_io_steals_total")
        before = steals.value
        dispatch = pkg_workers.PullDispatcher(list(range(3)), 2, lookahead=2)
        assert dispatch.next(0) == (0, (1, 2))
        assert dispatch.next(1) == (2, ())  # the tail of worker 0's claim
        assert steals.value == before + 1
    for name, kind in READ_PATH_FAMILIES.items():
        assert default_registry()._families[name][0] == kind, name
        assert ref_registry()._families[name][0] == kind, name

    # the counts the seeded run fixes
    rgs = FILES * RGS
    for tier in ("mem", "arena", "disk", "remote"):
        assert _family_total(port_written, "ptpu_io_tier_hits_total", tier=tier) == \
            _family_total(ref_written, "ptpu_io_tier_hits_total", tier=tier), tier
    assert _family_total(port_written, "ptpu_io_tier_hits_total", tier="mem") == 2 * rgs
    assert _family_total(port_written, "ptpu_io_tier_hits_total", tier="remote") == 2 * rgs
    for family in ("ptpu_io_memcache_hits_total", "ptpu_transform_rows_total"):
        assert _family_total(port_written, family) == _family_total(ref_written, family), \
            family
    # epoch 1 of each read misses the mem tier, so every memcache hit is epoch 2's
    assert _family_total(port_written, "ptpu_io_memcache_hits_total") == 2 * rgs
    assert _family_total(port_written, "ptpu_transform_rows_total") == 2 * rgs * RG_ROWS

    # the controller's signal over the run's window
    share = WindowContext(_window(port_written), 1.0).tier_share("remote")
    assert share == RefWindowContext(_window(ref_written), 1.0).tier_share("remote")
    assert share == 0.5

    # one thread does every read: the handle LRU's closes and the footer cache's hits
    ref_written, port_written = _run_both(store, tmp_path, "off", READAHEAD_OFF)
    for family, labels in (("ptpu_io_file_evictions_total", {}),
                           ("ptpu_io_footer_cache_hits_total", {}),
                           ("ptpu_io_memcache_hits_total", {}),
                           ("ptpu_io_tier_hits_total", {"tier": "remote"})):
        assert _family_total(port_written, family, **labels) == \
            _family_total(ref_written, family, **labels), family
    # 4 files through a 2-handle LRU in plan order: 2 closes a pass, epoch 1 of each read
    assert _family_total(port_written, "ptpu_io_file_evictions_total") == 4
    assert _family_total(port_written, "ptpu_io_footer_cache_hits_total") > 0
    assert "ptpu_io_readahead_hits_total" not in {n for n, _ in port_written}


def test_stats_cli_renders_a_live_port_runs_tier_footer_and_transform_panels(
        tmp_path, capsys):
    """A live port run over the store simulator (remote tier on, footer cache, mem
    tier, a feature pipeline) exported through a loader's Reporter: the run raises the
    tier, footer-cache and transform families, and the stats CLI's cache-tier,
    footer-cache and transform panels render them."""
    import pyarrow as pa
    import pyarrow.fs as pafs
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.io.latencyfs import CloudLatencyFS
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.obs import stats_cli
    from petastorm_tpu_torch.obs.export import Reporter

    root = str(tmp_path / "ds")
    os.makedirs(root)
    rng = np.random.RandomState(7)
    for f in range(2):
        pq.write_table(pa.table({"id": np.arange(f * 32, (f + 1) * 32, dtype=np.int64),
                                 "x": rng.rand(32)}),
                       os.path.join(root, "part_%d.parquet" % f), row_group_size=8)
    pipe = port_tabular.FeaturePipeline([port_tabular.Normalize("x", min=0, max=1)])
    jsonl = str(tmp_path / "metrics.jsonl")
    reg = default_registry()
    watched = [reg.counter("ptpu_io_tier_hits_total", tier="mem"),
               reg.counter("ptpu_io_tier_hits_total", tier="remote"),
               reg.counter("ptpu_io_footer_cache_hits_total"),
               reg.counter("ptpu_transform_rows_total")]
    before = [c.value for c in watched]
    reader = port.make_batch_reader(
        "file://" + root, filesystem=CloudLatencyFS(pafs.LocalFileSystem(), sleep=False,
                                                    seed=3),
        transform_spec=pipe, num_epochs=2, workers_count=1,
        io_options=dict(memcache_bytes=16 << 20))
    with DataLoader(reader, 16, device="cpu", to_device=False,
                    metrics=default_registry()) as loader:
        with Reporter(default_registry(), jsonl_path=jsonl, interval_s=60.0):
            assert sum(len(b["id"]) for b in loader) == 128
    capsys.readouterr()
    assert stats_cli.main(["--watch", "--once", jsonl]) == 0
    out = capsys.readouterr().out
    assert "cache tiers:" in out and "mem hits=" in out and "remote hits=" in out
    assert "footer cache: hits=" in out
    assert "transform ops (ptpu_transform_seconds):" in out
    assert "  normalize " in out and "transform rows total:" in out


def test_register_metrics_exports_a_loaderless_readers_wire_and_io(tmp_path):
    """``Reader.register_metrics`` puts the reader's io counts on a registry as
    ``ptpu_io_*`` gauges, the same keys as the JAX package's, until unregistered."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    root = str(tmp_path / "ds")
    os.makedirs(root)
    pq.write_table(pa.table({"id": np.arange(16, dtype=np.int64)}),
                   os.path.join(root, "p.parquet"), row_group_size=4)
    keys = {}
    for name, pkg, reg in (("port", port, MetricsRegistry()),
                           ("ref", ref, __import__("petastorm_tpu.obs.metrics",
                                                   fromlist=["MetricsRegistry"])
                            .MetricsRegistry())):
        with pkg.make_batch_reader("file://" + root, reader_pool_type="dummy",
                                   io_options=dict(memcache_bytes=1 << 20)) as reader:
            handles = reader.register_metrics(reg)
            assert len(handles) == 2
            assert sum(len(b.id) for b in reader) == 16
            snap = reg.snapshot()
            keys[name] = {k for k in snap if k.startswith("ptpu_io_")}
            assert snap["ptpu_io_tier_remote_hits"] == 4
            reg.unregister_collector(handles)
            assert not any(k.startswith("ptpu_io_") for k in reg.snapshot())
    assert keys["ref"] <= keys["port"], sorted(keys["ref"] - keys["port"])


@pytest.mark.parametrize("factory", ["make_reader", "make_batch_reader"])
def test_an_uncached_read_counts_every_serve_as_the_remote_tiers(store, factory):
    """With no mem, disk or tenant tier the port builds no funnel: each worker counts
    its serves as the ``remote`` tier's itself, as many as the JAX package's funnel
    counts, so ``tier_share("remote")`` over the window is the same (1.0), and sizes
    them by the bytes each read returned."""
    opts = dict(reader_pool_type="thread", workers_count=1, shuffle_row_groups=False,
                num_epochs=2, io_options=dict(readahead=False))
    written = {}
    for name, pkg, registry in (("ref", ref, ref_registry), ("port", port,
                                                             default_registry)):
        before = _series(registry())
        with getattr(pkg, factory)("file://" + store, **opts) as reader:
            if name == "port":
                assert isinstance(reader._worker._cache, port_reader.NullCache)
            rows = sum(1 for _ in reader) if factory == "make_reader" else \
                sum(len(b.id) for b in reader)
        assert rows == 2 * FILES * RGS * RG_ROWS
        written[name] = _written(before, _series(registry()))
    hits = {name: _family_total(w, "ptpu_io_tier_hits_total", tier="remote")
            for name, w in written.items()}
    assert hits["port"] == hits["ref"] == 2 * FILES * RGS
    assert _family_total(written["port"], "ptpu_io_tier_bytes_total", tier="remote") >= \
        2 * FILES * RGS * RG_ROWS * 3 * 8  # three 8-byte columns a row, at least
    share = WindowContext(_window(written["port"]), 1.0).tier_share("remote")
    assert share == RefWindowContext(_window(written["ref"]), 1.0).tier_share("remote")
    assert share == 1.0
