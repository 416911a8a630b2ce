"""The port's observability base against the JAX package's (ROADMAP.md Queue 1 item 8a):
the metrics registry, the exporters, the structured degradation log, the bottleneck
analyzer, and the loader's ``metrics=`` wiring.

Every case of the JAX package's ``tests/test_obs.py`` has a counterpart here except the
two stats-CLI cases (``test_jsonl_reporter_and_stats_cli``'s CLI half and
``test_stats_cli_reads_prometheus_file``): the stats CLI is item 8b. Beside them:

- ``Histogram`` percentiles and ``to_prometheus()`` text are equal in both packages
  after the same operations, and each package's parser reads the other's text;
- ``analyze_snapshot`` gives the JAX package's verdict on the same snapshots;
- the counters that were plain module totals before (the pass-through's, the leases',
  the copy census) are registry families under the JAX package's names, and the
  wire's degradation table is the degradation log;
- the object-store latency model's hedge deadline equals the JAX package's on the same
  observations, through the registry's ``Histogram``.

The synthetic-bottleneck cases slow a stage by 50 ms a batch against a reader that takes
well under a millisecond, a margin that scheduler noise on a loaded host cannot close.
"""
import gc
import json
import logging
import os
import time
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu.obs import analyze as ref_analyze  # noqa: E402
from petastorm_tpu.obs import export as ref_export  # noqa: E402
from petastorm_tpu.obs import metrics as ref_metrics  # noqa: E402
from petastorm_tpu_torch.loader import DataLoader  # noqa: E402
from petastorm_tpu_torch.obs.analyze import analyze_snapshot  # noqa: E402
from petastorm_tpu_torch.obs.export import (  # noqa: E402
    Reporter,
    parse_prometheus_text,
    read_latest_jsonl_snapshot,
    read_recent_jsonl_snapshots,
    write_prometheus,
)
from petastorm_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from petastorm_tpu_torch.reader import make_batch_reader  # noqa: E402


# -- the registry ----------------------------------------------------------------------


def test_counter_gauge_families_and_labels():
    r = MetricsRegistry()
    a = r.counter("ptpu_events_total", help="events", kind="x")
    b = r.counter("ptpu_events_total", kind="y")
    assert a is not b
    assert a is r.counter("ptpu_events_total", kind="x")  # get-or-create
    a.inc()
    a.inc(4)
    b.inc()
    g = r.gauge("ptpu_depth")
    g.set(3)
    g.inc()
    g.dec(2)
    snap = r.snapshot()
    assert snap['ptpu_events_total{kind="x"}'] == 5
    assert snap['ptpu_events_total{kind="y"}'] == 1
    assert snap["ptpu_depth"] == 2


def test_family_type_conflict_raises():
    r = MetricsRegistry()
    r.counter("ptpu_x_total")
    with pytest.raises(ValueError, match="already registered as counter"):
        r.gauge("ptpu_x_total")
    with pytest.raises(ValueError, match="already registered as counter"):
        r.histogram("ptpu_x_total", stage="read")


def test_histogram_percentiles_without_samples():
    """Log buckets: p50/p90/p99 within a bucket width (~19 %) of the truth, from a few
    dozen integers however many observations."""
    h = MetricsRegistry().histogram("ptpu_lat_seconds", stage="read")
    samples = np.sort(np.random.RandomState(0).lognormal(-6, 1.0, 5000))
    for s in samples:
        h.observe(float(s))
    for q in (0.5, 0.9, 0.99):
        true = samples[int(q * len(samples)) - 1]
        assert true <= h.percentile(q) <= true * 1.25
    snap = h.snapshot()
    assert snap["count"] == 5000
    assert snap["p50"] <= snap["p90"] <= snap["p99"] <= snap["max"]
    assert snap["mean"] == pytest.approx(samples.mean(), abs=1e-6)


def test_histogram_zero_and_empty():
    h = MetricsRegistry().histogram("ptpu_lat_seconds", stage="x")
    assert h.percentile(0.5) == 0.0  # empty
    h.observe(0.0)
    h.observe(-1.0)
    assert h.percentile(0.99) == 0.0  # all in the underflow bucket
    h.observe(1.0)
    assert h.percentile(0.99) == pytest.approx(1.0)  # capped at the true max


def test_collector_families_and_unregister():
    r = MetricsRegistry()
    handle = r.register_collector("pipeline", lambda: {"read_s": 1.5, "batches": 2})
    r.register_collector("wire", lambda: 1 / 0)  # a failing source must not end export
    snap = r.snapshot()
    assert snap["ptpu_pipeline_read_s"] == 1.5
    assert snap["ptpu_pipeline_batches"] == 2
    r.unregister_collector(handle)
    assert "ptpu_pipeline_read_s" not in r.snapshot()


def test_non_numeric_collector_values_stay_out_of_the_exposition():
    r = MetricsRegistry()
    r.register_collector("io", lambda: {"hits": 3, "children": {0: {"hits": 1}},
                                        "token": "abc"})
    samples = parse_prometheus_text(r.to_prometheus())
    assert samples == {"ptpu_io_hits": 3.0}


def _drive(reg, seed):
    """The same seeded operations on either package's registry."""
    rng = np.random.default_rng(seed)
    for stage in ("read", "h2d"):
        h = reg.histogram("ptpu_pipeline_stage_seconds", help="latency", stage=stage)
        for v in rng.lognormal(-5, 1.5, 400):
            h.observe(float(v))
        h.observe(0.0)
    reg.counter("ptpu_degradations_total", help="by cause", cause="io_retry").inc(
        int(rng.integers(1, 9)))
    reg.gauge("ptpu_lease_active", help="live").set(float(rng.integers(0, 5)))
    reg.register_collector("pipeline", lambda: {"batches": 7, "read_s": 0.125})
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histograms_and_prometheus_text_equal_the_jax_packages(seed):
    port = _drive(MetricsRegistry(), seed)
    ref = _drive(ref_metrics.MetricsRegistry(), seed)
    assert port.to_prometheus() == ref.to_prometheus()
    assert port.snapshot() == ref.snapshot()
    hp = port.histogram("ptpu_pipeline_stage_seconds", stage="read")
    hr = ref.histogram("ptpu_pipeline_stage_seconds", stage="read")
    for q in (0.01, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert hp.percentile(q) == hr.percentile(q)
    assert hp.cumulative_buckets() == hr.cumulative_buckets()


def test_each_packages_parser_reads_the_others_exposition():
    port = _drive(MetricsRegistry(), 5).to_prometheus()
    ref = _drive(ref_metrics.MetricsRegistry(), 5).to_prometheus()
    assert parse_prometheus_text(ref) == ref_export.parse_prometheus_text(port)


# -- exporters ---------------------------------------------------------------------------


def _populated_registry():
    r = MetricsRegistry()
    r.counter("ptpu_degradations_total", help="by cause", cause="shm_unsupported").inc(2)
    h = r.histogram("ptpu_pipeline_stage_seconds", help="latency", stage="read")
    for v in (0.001, 0.002, 0.004, 0.1):
        h.observe(v)
    r.gauge("ptpu_depth").set(4)
    r.register_collector("pipeline", lambda: {"rows": 32})
    return r


def test_prometheus_export_parses_and_round_trips(tmp_path):
    path = write_prometheus(str(tmp_path / "m.prom"), _populated_registry())
    with open(path) as f:
        samples = parse_prometheus_text(f.read())
    assert samples['ptpu_degradations_total{cause="shm_unsupported"}'] == 2.0
    assert samples['ptpu_pipeline_stage_seconds_count{stage="read"}'] == 4.0
    assert samples["ptpu_depth"] == 4.0
    assert samples["ptpu_pipeline_rows"] == 32.0
    buckets = sorted((k, v) for k, v in samples.items()
                     if k.startswith("ptpu_pipeline_stage_seconds_bucket"))
    assert buckets
    assert any('le="+Inf"' in k and v == 4.0 for k, v in buckets)


def test_prometheus_parser_rejects_garbage():
    with pytest.raises(ValueError, match="malformed sample"):
        parse_prometheus_text("# TYPE x counter\nx{ 1.0\n")
    with pytest.raises(ValueError, match="no # TYPE"):
        parse_prometheus_text("never_declared 1.0\n")
    with pytest.raises(ValueError, match="non-monotonic"):
        parse_prometheus_text('# TYPE h histogram\nh_bucket{le="1"} 5\nh_bucket{le="2"} 3\n')


def test_jsonl_reporter_flushes_and_tolerates_a_torn_line(tmp_path):
    jsonl = str(tmp_path / "stats.jsonl")
    with Reporter(registry=_populated_registry(), interval_s=600.0, jsonl_path=jsonl):
        pass  # stop() flushes one final snapshot even on an instant run
    obj = read_latest_jsonl_snapshot(jsonl)
    assert obj is not None and "ts" in obj and obj["schema"] == Reporter.SCHEMA
    assert obj["metrics"]['ptpu_degradations_total{cause="shm_unsupported"}'] == 2
    with open(jsonl, "a") as f:
        f.write('{"ts": 1, "metr')  # a live writer's torn final line
    assert read_latest_jsonl_snapshot(jsonl)["metrics"] == obj["metrics"]
    assert len(read_recent_jsonl_snapshots(jsonl)) == 1


def test_reporter_periodic_writes(tmp_path):
    r = MetricsRegistry()
    c = r.counter("ptpu_ticks_total")
    jsonl = str(tmp_path / "s.jsonl")
    with Reporter(registry=r, interval_s=0.05, jsonl_path=jsonl,
                  prom_path=str(tmp_path / "s.prom")):
        c.inc()
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline:
            if os.path.exists(jsonl) and os.path.getsize(jsonl) > 0:
                break
            time.sleep(0.02)
    lines = read_recent_jsonl_snapshots(jsonl)
    assert lines and all("ts" in obj for obj in lines)
    with open(str(tmp_path / "s.prom")) as f:
        assert parse_prometheus_text(f.read())["ptpu_ticks_total"] >= 1.0


def test_reporter_rotates_past_max_bytes(tmp_path):
    jsonl = str(tmp_path / "r.jsonl")
    rep = Reporter(registry=_populated_registry(), interval_s=600.0, jsonl_path=jsonl,
                   max_bytes=200, keep=2)
    for _ in range(4):
        rep._write_once()
    assert os.path.exists(jsonl + ".1") and os.path.exists(jsonl + ".2")
    assert not os.path.exists(jsonl + ".3")
    assert read_latest_jsonl_snapshot(jsonl) is not None


# -- the structured degradation log ------------------------------------------------------


def test_degradation_logs_once_but_counts_every_time(caplog):
    from petastorm_tpu_torch.obs import log as obs_log

    obs_log._reset_announced_for_tests()
    before = obs_log.degradation_counts().get("test_cause_once", 0)
    with caplog.at_level(logging.WARNING, logger="petastorm_tpu_torch.obs"):
        for _ in range(3):
            obs_log.degradation("test_cause_once", "thing degraded (%s)", "why")
    records = [r for r in caplog.records if "test_cause_once" in r.getMessage()]
    assert len(records) == 1  # warn-once
    assert "[degradation cause=test_cause_once]" in records[0].getMessage()
    assert obs_log.degradation_counts()["test_cause_once"] == before + 3


def test_degradation_every_occurrence_mode(caplog):
    from petastorm_tpu_torch.obs import log as obs_log

    with caplog.at_level(logging.WARNING, logger="petastorm_tpu_torch.obs"):
        obs_log.degradation("test_cause_each", "died %d", 1, once=False)
        obs_log.degradation("test_cause_each", "died %d", 2, once=False)
    assert len([r for r in caplog.records if "test_cause_each" in r.getMessage()]) == 2


def test_the_wires_degradation_table_is_the_degradation_log():
    """parallel.shm_ring.degradation / degradation_counts stay importable, and every
    degradation the port takes counts in ptpu_degradations_total."""
    from petastorm_tpu_torch.obs import log as obs_log
    from petastorm_tpu_torch.obs.metrics import default_registry
    from petastorm_tpu_torch.parallel import shm_ring

    assert shm_ring.degradation is obs_log.degradation
    assert shm_ring.degradation_counts is obs_log.degradation_counts
    before = shm_ring.degradation_counts().get("test_wire_cause", 0)
    shm_ring.degradation("test_wire_cause", "wire %s", "degraded")
    assert default_registry().counter("ptpu_degradations_total",
                                      cause="test_wire_cause").value == before + 1


# -- the analyzer on synthetic snapshots -------------------------------------------------


def test_analyzer_wire_bound_and_balanced_and_idle():
    wire = analyze_snapshot(dict(
        batches=20, read_s=4.0, batch_s=0.1, put_wait_s=0.0, decode_s=0.1, h2d_s=0.1,
        queue_wait_s=3.8, shm_acquire_wait_s=3.5, shm_fallbacks=9))
    assert wire.verdict == "wire-bound" and "slab" in wire.reason
    balanced = analyze_snapshot(dict(batches=20, read_s=1.0, batch_s=0.0, put_wait_s=1.0,
                                     decode_s=1.0, h2d_s=0.0, queue_wait_s=1.0))
    assert balanced.verdict == "balanced"
    assert analyze_snapshot(dict(batches=0)).verdict == "idle"
    assert "wire-bound" in wire.render()
    assert json.dumps(wire.to_dict())


_SNAPSHOTS = [
    dict(batches=20, read_s=4.0, batch_s=0.1, put_wait_s=0.0, decode_s=0.1, h2d_s=0.1,
         queue_wait_s=3.8, shm_acquire_wait_s=3.5, shm_fallbacks=9),
    dict(batches=20, read_s=4.0, batch_s=0.1, put_wait_s=0.0, decode_s=0.1, h2d_s=0.1,
         queue_wait_s=3.8),
    dict(batches=20, read_s=0.1, batch_s=0.1, put_wait_s=3.0, decode_s=2.0, h2d_s=1.0,
         queue_wait_s=0.01, device_queue_wait_s=0.5),
    dict(batches=20, read_s=1.0, batch_s=0.0, put_wait_s=1.0, decode_s=1.0, h2d_s=0.0,
         queue_wait_s=1.0),
    dict(batches=3, read_s=0.001, batch_s=0.001, put_wait_s=0.0, decode_s=0.001,
         h2d_s=0.001, queue_wait_s=0.001),
    dict(batches=0),
]


@pytest.mark.parametrize("snap", _SNAPSHOTS)
def test_analyzer_verdicts_equal_the_jax_packages(snap):
    port, ref = analyze_snapshot(snap), ref_analyze.analyze_snapshot(snap)
    assert (port.verdict, port.utilization, port.reason) == \
        (ref.verdict, ref.utilization, ref.reason)


def test_detect_straggler_equals_the_jax_packages():
    from petastorm_tpu_torch.obs.analyze import detect_straggler

    lat = {0: {"mean": 0.01, "count": 10}, 1: {"mean": 0.011, "count": 9},
           2: {"mean": 0.09, "count": 8}, 3: {"mean": 0.012, "count": 2}}
    assert detect_straggler(lat) == ref_analyze.detect_straggler(lat)
    assert detect_straggler(lat)["worker"] == "2"
    assert detect_straggler({0: {"mean": 0.01, "count": 10}}) is None
    snap = dict(_SNAPSHOTS[1])
    assert analyze_snapshot(snap, worker_latency=lat).verdict == "straggler"


def test_the_inflate_stage_is_consumer_work():
    """The port's compressed-page inflate stage (PipelineStats.inflate_s) runs on the
    transfer side: a pipeline that spends its time there is consumer-bound."""
    snap = dict(batches=20, read_s=0.1, batch_s=0.1, put_wait_s=3.0, decode_s=0.0,
                h2d_s=0.1, inflate_s=2.5, queue_wait_s=0.01)
    report = analyze_snapshot(snap)
    assert report.verdict == "consumer-bound"
    assert "inflate 2.500s" in report.render()


# -- synthetic bottlenecks through a real pipeline ----------------------------------------


class _ThrottledReader:
    """A reader proxy that sleeps before each delivery: a slow producer."""

    def __init__(self, reader, delay_s):
        self._reader = reader
        self._delay_s = delay_s

    def __getattr__(self, name):
        return getattr(self._reader, name)

    def __iter__(self):
        for item in self._reader:
            time.sleep(self._delay_s)
            yield item


def test_throttled_reader_is_producer_bound(scalar_dataset):
    reader = make_batch_reader(scalar_dataset.url, num_epochs=3, shuffle_row_groups=False,
                               workers_count=1)
    loader = DataLoader(_ThrottledReader(reader, 0.05), batch_size=5, to_device=False,
                        device="cpu")
    with loader:
        for _ in loader:
            pass
    report = loader.bottleneck_report()
    assert report.verdict == "producer-bound", report.render()
    assert report.utilization["producer"] > report.utilization["consumer"]


def test_slow_decode_stage_is_consumer_bound(scalar_dataset, monkeypatch):
    """50 ms of decode a batch against a reader far under 1 ms a batch: the transfer
    side is saturated and the producer waits on the full host queue."""
    orig = DataLoader._decode_staged

    def slow_decode(self, batch):
        time.sleep(0.05)
        return orig(self, batch)

    monkeypatch.setattr(DataLoader, "_decode_staged", slow_decode)
    reader = make_batch_reader(scalar_dataset.url, num_epochs=3, shuffle_row_groups=False,
                               workers_count=1)
    loader = DataLoader(reader, batch_size=5, host_queue_size=2, prefetch=1, device="cpu")
    with loader:
        for _ in loader:
            pass
    snap = loader.stats.snapshot()
    assert snap["decode_s"] > 0 and snap["put_wait_s"] > 0
    report = loader.bottleneck_report()
    assert report.verdict == "consumer-bound", report.render()
    assert report.utilization["consumer"] > report.utilization["producer"]


# -- the loader's metrics= ---------------------------------------------------------------


def test_loader_metrics_disabled_by_default(scalar_dataset):
    reader = make_batch_reader(scalar_dataset.url, num_epochs=1, workers_count=1)
    with DataLoader(reader, 8, to_device=False, device="cpu") as loader:
        next(iter(loader))
        assert loader._obs is None  # the disabled path: one `is None` check a site


def test_loader_exports_metric_families(scalar_dataset):
    registry = MetricsRegistry()
    reader = make_batch_reader(scalar_dataset.url, num_epochs=1, shuffle_row_groups=False,
                               workers_count=1)
    with DataLoader(reader, 8, metrics=registry, device="cpu") as loader:
        n = sum(1 for _ in loader)
        snap = registry.snapshot()
    assert n > 0
    assert snap["ptpu_pipeline_batches"] == n
    assert snap["ptpu_pipeline_rows"] == loader.stats.rows
    assert "ptpu_pipeline_host_queue_depth" in snap
    assert "ptpu_pipeline_inflate_s" in snap
    read_hist = snap['ptpu_pipeline_stage_seconds{stage="read"}']
    assert read_hist["count"] > 0 and read_hist["p50"] <= read_hist["p99"]
    assert snap['ptpu_pipeline_stage_seconds{stage="h2d"}']["count"] == n
    report = loader.bottleneck_report()
    assert report.percentiles and "read" in report.percentiles
    # collectors unregister at __exit__; the histograms stay for post-hoc reads
    assert "ptpu_pipeline_batches" not in registry.snapshot()
    assert 'ptpu_pipeline_stage_seconds{stage="read"}' in registry.snapshot()


def test_loader_exports_the_process_pools_wire_gauges(scalar_dataset):
    registry = MetricsRegistry()
    reader = make_batch_reader(scalar_dataset.url, num_epochs=1, workers_count=2,
                               reader_pool_type="process", wire_serializer="shm",
                               results_timeout_s=60)
    with DataLoader(reader, 5, metrics=registry, to_device=False, device="cpu") as loader:
        n = sum(1 for _ in loader)
        snap = registry.snapshot()
    assert n > 0 and snap["ptpu_wire_shm_grants"] >= 1


def test_collectors_go_quiet_when_loader_is_garbage_collected(scalar_dataset):
    """A loader torn down without the context manager is not pinned by the registry,
    and its collectors stop exporting once it is collected."""
    registry = MetricsRegistry()
    reader = make_batch_reader(scalar_dataset.url, num_epochs=1, shuffle_row_groups=False,
                               workers_count=1)
    loader = DataLoader(reader, 8, to_device=False, metrics=registry, device="cpu")
    n = sum(1 for _ in loader)
    assert n > 0 and registry.snapshot()["ptpu_pipeline_batches"] == n
    loader.stop()
    loader.join()
    reader.stop()
    reader.join()
    ref = weakref.ref(loader)
    del loader, reader
    gc.collect()
    assert ref() is None
    assert "ptpu_pipeline_batches" not in registry.snapshot()


def test_loader_metrics_prometheus_end_to_end(scalar_dataset, tmp_path):
    registry = MetricsRegistry()
    reader = make_batch_reader(scalar_dataset.url, num_epochs=1, shuffle_row_groups=False,
                               workers_count=1)
    with DataLoader(reader, 8, to_device=False, metrics=registry, device="cpu") as loader:
        n = sum(1 for _ in loader)
        path = write_prometheus(str(tmp_path / "m.prom"), registry)
    with open(path) as f:
        samples = parse_prometheus_text(f.read())
    assert samples["ptpu_pipeline_batches"] == float(n)
    assert any(k.startswith("ptpu_pipeline_stage_seconds_bucket{") for k in samples)


def test_metrics_true_uses_the_process_wide_registry(scalar_dataset):
    from petastorm_tpu_torch.obs.metrics import default_registry

    reader = make_batch_reader(scalar_dataset.url, num_epochs=1, workers_count=1)
    with DataLoader(reader, 8, to_device=False, metrics=True, device="cpu") as loader:
        n = sum(1 for _ in loader)
        assert default_registry().snapshot()["ptpu_pipeline_batches"] == n
        assert loader._obs.registry is default_registry()


# -- the counters the registry took over ---------------------------------------------------


def test_pagedec_counters_are_registry_families():
    from petastorm_tpu.io import pagedec as ref_pagedec
    from petastorm_tpu_torch.io import pagedec
    from petastorm_tpu_torch.obs.metrics import default_registry

    counters = pagedec.pagedec_counters()
    assert counters is pagedec.pagedec_counters(default_registry())  # memoized
    private = MetricsRegistry()
    mine = pagedec.pagedec_counters(private)
    mine["pages"].inc(3)
    mine["inflate_seconds"].observe(0.5)
    snap = private.snapshot()
    assert snap["ptpu_pagedec_pages_total"] == 3
    assert snap["ptpu_pagedec_inflate_seconds"]["count"] == 1
    assert sorted(snap) == sorted(_family_names(ref_pagedec))  # the JAX names
    before = pagedec.counter_values()
    counters["bytes_compressed"].inc(10)
    assert pagedec.counter_values()["bytes_compressed"] == before["bytes_compressed"] + 10


def _family_names(ref_pagedec):
    reg = ref_metrics.MetricsRegistry()
    ref_pagedec.pagedec_counters(reg)
    return list(reg.snapshot())


def test_lease_and_copy_counters_are_registry_families():
    from petastorm_tpu_torch.io import lease
    from petastorm_tpu_torch.obs.metrics import default_registry

    reg = default_registry()
    acquired = reg.counter("ptpu_lease_acquired_total")
    before = lease.lease_stats()
    lease.Lease(kind="probe").release()
    assert lease.lease_stats()["acquired"] == before["acquired"] + 1 == acquired.value
    assert lease.lease_stats()["released"] == before["released"] + 1
    census0 = lease.copy_census().get("probe_site", 0)
    lease.count_copy("probe_site", 123)
    assert lease.copy_census()["probe_site"] == census0 + 123
    assert reg.counter("ptpu_copy_bytes_total", site="probe_site").value == census0 + 123


def test_the_latency_models_deadline_equals_the_jax_packages():
    """The object-store hedge deadline now reads the registry's log-bucketed Histogram:
    the same observations give the JAX package's deadline."""
    from petastorm_tpu.io import remote as ref_remote
    from petastorm_tpu_torch.io import remote

    port = remote.LatencyModel()
    ref = ref_remote.LatencyModel(ref_metrics.MetricsRegistry())
    rng = np.random.default_rng(8)
    for nbytes, secs in zip(rng.integers(1 << 10, 8 << 20, 300),
                            rng.lognormal(-4, 0.7, 300)):
        port.observe("s3", int(nbytes), float(secs))
        ref.observe("s3", int(nbytes), float(secs))
    for nbytes in (4 << 10, 200 << 10, 1 << 20, 3 << 20, 9 << 20):
        for q in (0.5, 0.9, 0.99):
            assert port.deadline("s3", nbytes, q, 8, 0.001) == \
                ref.deadline("s3", nbytes, q, 8, 0.001)
    assert not hasattr(remote, "_Histogram")
