"""The port's time-series plane against the JAX package's (ROADMAP.md Queue 1 item 8b(i)):
windowed series of the registry, the SLO and anomaly engine, the Reporter's sampling,
merges of exports and the scrape endpoint, and the loader's ``slos=``.

Every case of the JAX package's ``tests/test_timeseries.py`` has a counterpart here
(the two tenant cases since item 8c(i)) except the stats CLI's
(``test_stats_cli_merge_renders``, ``test_render_dashboard_trends_and_window_deltas``:
in ``tests/test_torch_stats_cli.py``) and run diffs (the five ``test_bench_diff_*``
cases and ``test_diff_self_times_significance_and_new_sites``: in
``tests/test_torch_bench_diff.py``). The SLO end-to-end
case reads a series that moves once a batch the test consumes (the ``pipeline``
collector's batch count) and samples the windows itself, so its windows are the test's,
not the reader's. Beside them:

- the same operations on both packages' registries give equal points (rates, counter
  restarts, window percentiles);
- the same specs over the same windows fire the same alerts on the same windows;
- a JAX Reporter's JSONL loads with the port's ``load_export``, and the other way round;
- the scrape endpoint binds port 0 on 127.0.0.1.
"""
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu.obs import export as ref_export  # noqa: E402
from petastorm_tpu.obs import metrics as ref_metrics  # noqa: E402
from petastorm_tpu.obs import slo as ref_slo  # noqa: E402
from petastorm_tpu.obs import timeseries as ref_timeseries  # noqa: E402
from petastorm_tpu_torch.obs.export import (  # noqa: E402
    Reporter,
    parse_prometheus_text,
    read_recent_jsonl_snapshots,
)
from petastorm_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from petastorm_tpu_torch.obs.slo import AnomalyDetector, SloEngine, SloSpec  # noqa: E402
from petastorm_tpu_torch.obs.timeseries import (  # noqa: E402
    fleet_rate_series,
    load_export,
    merge_exports,
    sparkline,
    uniquify_sources,
)


@pytest.fixture(scope="module")
def small_dataset(tmp_path_factory):
    """30 rows of ``id`` in 3 files (the JAX package's scalar dataset's row count)."""
    root = tmp_path_factory.mktemp("torch_ts_ds")
    for i in range(3):
        pq.write_table(pa.table({"id": np.arange(10, dtype=np.int64) + 10 * i}),
                       str(root / ("p%d.parquet" % i)))
    return "file://" + str(root)


# -- timeline rings ------------------------------------------------------------------------


def test_timeline_ring_bound_and_eviction():
    r = MetricsRegistry()
    c = r.counter("events_total")
    r.timeline_store(max_points=4)
    for _ in range(10):
        c.inc(5)
        r.sample_timelines()
    pts = r.timeline("events_total")
    assert len(pts) == 4
    assert [p["value"] for p in pts] == [35, 40, 45, 50]
    assert all(p["delta"] == 5 for p in pts)


def test_timeline_empty_without_store_or_series():
    r = MetricsRegistry()
    assert r.timeline("nope") == []
    r.sample_timelines()
    assert r.timeline("still_nope") == []


def test_counter_rate_from_delta():
    r = MetricsRegistry()
    c = r.counter("rows_total")
    r.sample_timelines()
    first = r.timeline("rows_total")[-1]
    assert first["delta"] is None and first["rate"] is None
    c.inc(100)
    time.sleep(0.02)
    r.sample_timelines()
    point = r.timeline("rows_total")[-1]
    assert point["delta"] == 100
    assert point["rate"] > 100


def test_counter_restart_charges_current_value():
    r = MetricsRegistry()
    state = {"v": 500}
    r.register_collector("io", lambda: {"gets_total": state["v"]})
    r.sample_timelines()
    state["v"] = 700
    r.sample_timelines()
    assert r.timeline("ptpu_io_gets_total")[-1]["delta"] == 200
    state["v"] = 30
    r.sample_timelines()
    point = r.timeline("ptpu_io_gets_total")[-1]
    assert point["delta"] == 30 and point["rate"] >= 0


def test_cumulative_collector_restart_never_yields_negative_rate():
    r = MetricsRegistry()
    state = {"rows": 5000}
    r.register_collector("pipeline", lambda: dict(state))
    r.sample_timelines()
    state["rows"] = 6000
    time.sleep(0.01)
    r.sample_timelines()
    state["rows"] = 40
    time.sleep(0.01)
    r.sample_timelines()
    points = r.timeline("ptpu_pipeline_rows")
    assert points[1]["rate"] > 0
    assert points[2]["delta"] == 40 - 6000
    assert points[2]["rate"] is None
    assert all(p["rate"] is None or p["rate"] >= 0 for p in points)


def test_load_export_honors_per_line_anchors(tmp_path):
    path = str(tmp_path / "restarted.jsonl")
    run1 = {"wall": 1000.0, "perf": 500.0, "host": "h", "pid": 1}
    run2 = {"wall": 1060.0, "perf": 2.0, "host": "h", "pid": 2}
    with open(path, "w") as f:
        for anchor, perf, rows in ((run1, 501.0, 100), (run1, 502.0, 200),
                                   (run2, 3.0, 50), (run2, 4.0, 150)):
            f.write(json.dumps({"schema": "ptpu-stats-v2", "ts": 0.0, "perf": perf,
                                "anchor": anchor, "metrics": {"rows_total": rows}})
                    + "\n")
    points = load_export(path)["series"]["rows_total"]
    assert [p["t"] for p in points] == [1001.0, 1002.0, 1061.0, 1062.0]
    assert points[2]["delta"] == 50
    assert all(p["rate"] is None or p["rate"] >= 0 for p in points)


def test_unregister_collector_accepts_handle_list():
    r = MetricsRegistry()
    handles = [r.register_collector("a", lambda: {"x": 1}),
               r.register_collector("b", lambda: {"y": 2})]
    assert "ptpu_a_x" in r.snapshot()
    r.unregister_collector(handles)
    snap = r.snapshot()
    assert "ptpu_a_x" not in snap and "ptpu_b_y" not in snap


def test_rates_survive_reporter_restart(tmp_path):
    """The store lives on the registry, not the Reporter: a second Reporter does not
    charge the cumulative count to its first window."""
    r = MetricsRegistry()
    c = r.counter("rows_total")
    with Reporter(registry=r, interval_s=600.0,
                  jsonl_path=str(tmp_path / "a.jsonl")) as rep:
        c.inc(1000)
        rep._write_once()
    c.inc(50)
    with Reporter(registry=r, interval_s=600.0,
                  jsonl_path=str(tmp_path / "b.jsonl")) as rep2:
        rep2._write_once()
    assert [p["delta"] for p in r.timeline("rows_total")] == [None, 0, 50, 0]


def test_histogram_window_percentiles():
    r = MetricsRegistry()
    h = r.histogram("lat_seconds")
    for _ in range(50):
        h.observe(0.01)
    r.sample_timelines()
    for _ in range(10):
        h.observe(0.5)
    r.sample_timelines()
    first, second = r.timeline("lat_seconds")[-2:]
    assert first["count"] == 50 and first["p99"] < 0.02
    assert second["count"] == 10
    assert second["p50"] >= 0.4


def test_histogram_reset_starts_fresh_window():
    r = MetricsRegistry()
    h = r.histogram("lat_seconds")
    for _ in range(8):
        h.observe(0.2)
    r.sample_timelines()
    h.reset()
    h.observe(0.01)
    r.sample_timelines()
    point = r.timeline("lat_seconds")[-1]
    assert point["count"] == 1 and point["p99"] < 0.02


def test_listener_error_does_not_kill_sampling():
    r = MetricsRegistry()
    c = r.counter("x_total")
    calls = []

    def bad(window, t):
        calls.append(1)
        raise RuntimeError("bad listener")

    r.timeline_store().add_listener(bad)
    c.inc()
    r.sample_timelines()
    c.inc()
    r.sample_timelines()
    assert len(calls) == 2
    assert len(r.timeline("x_total")) == 2


def test_series_cap_counts_dropped_series():
    r = MetricsRegistry()
    store = r.timeline_store(max_series=3)
    for i in range(5):
        r.counter("c%d_total" % i).inc()
    r.sample_timelines()
    assert len(store.series_names()) == 3 and store.dropped_series == 2


# -- the same points as the JAX package ------------------------------------------------


def _drive(registry, ops, sleep):
    """Apply the same counter/histogram/collector operations and samples to one
    registry; returns every series' points."""
    c = registry.counter("rows_total")
    h = registry.histogram("lat_seconds")
    state = {"v": 0.0}
    registry.register_collector("pipeline", lambda: {"rows": state["v"],
                                                     "gets_total": state["v"] * 2})
    names = ["rows_total", "lat_seconds", "ptpu_pipeline_rows",
             "ptpu_pipeline_gets_total"]
    for op, arg in ops:
        if op == "inc":
            c.inc(arg)
        elif op == "observe":
            for v in arg:
                h.observe(v)
        elif op == "level":
            state["v"] = arg
        elif op == "reset":
            h.reset()
        else:
            sleep()
            registry.sample_timelines()
    return {n: registry.timeline(n) for n in names}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_timelines_equal_the_jax_packages_on_the_same_operations(seed, monkeypatch):
    """One seeded sequence of increments, observations, collector levels (restarts
    included), histogram resets and samples on both packages' registries, with the same
    clock: equal points, rates, window percentiles."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(40):
        k = int(rng.integers(6))
        if k == 0:
            ops.append(("inc", int(rng.integers(0, 500))))
        elif k == 1:
            ops.append(("observe", [float(v) for v in rng.lognormal(-4, 1.2,
                                                                    int(rng.integers(1, 30)))]))
        elif k == 2:
            ops.append(("level", float(rng.integers(0, 10_000))))
        elif k == 3 and rng.random() < 0.3:
            ops.append(("reset", None))
        else:
            ops.append(("sample", None))
    clock = {"t": 1000.0}

    def fake_perf():
        return clock["t"]

    def tick():
        clock["t"] += 0.25

    import petastorm_tpu.obs.timeseries as theirs_mod
    import petastorm_tpu_torch.obs.timeseries as ours_mod

    for mod in (theirs_mod, ours_mod):
        monkeypatch.setattr(mod.time, "perf_counter", fake_perf)
        monkeypatch.setattr(mod.time, "time", lambda: 5000.0)
    ours = _drive(MetricsRegistry(), ops, tick)
    clock["t"] = 1000.0
    theirs = _drive(ref_metrics.MetricsRegistry(), ops, tick)
    assert ours == theirs
    assert any(p["rate"] for p in ours["rows_total"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_alerts_equal_the_jax_packages_on_the_same_windows(seed):
    """The same specs and anomaly watch over the same seeded windows: the same alerts
    (name, cause, window, value, streak), each on the same window."""
    rng = np.random.default_rng(seed)
    specs = dict(
        a=dict(name="p99", metric="m", stat="p99", op="<=", threshold=0.1,
               breach_windows=2, min_count=2),
        b=dict(name="rate", metric="q_total", stat="rate", op="<=", threshold=3.0,
               breach_windows=1),
        c=dict(name="idle", metric="wait_s", stat="share", denominator=None, op="<=",
               threshold=0.5, breach_windows=3),
        d=dict(name="mem", metric="mem_total", stat="share",
               denominator=("mem_total", "disk_total"), op=">=", threshold=0.5,
               breach_windows=2))
    ours = SloEngine(specs=[SloSpec(**v) for v in specs.values()],
                     anomaly_metrics=[("m", "p50")],
                     anomaly_kwargs=dict(min_history=5, z_threshold=4.0))
    theirs = ref_slo.SloEngine(specs=[ref_slo.SloSpec(**v) for v in specs.values()],
                               anomaly_metrics=[("m", "p50")],
                               anomaly_kwargs=dict(min_history=5, z_threshold=4.0))
    fired = {"ours": [], "theirs": []}
    for w in range(60):
        p99 = float(rng.choice([0.01, 0.05, 0.3, 0.9]))
        window = {"m": {"kind": "histogram", "count": int(rng.integers(0, 5)),
                        "p50": p99 / (1 + 9 * (w > 40)), "p99": p99},
                  "q_total": {"kind": "counter", "delta": 1,
                              "rate": float(rng.uniform(0, 6))},
                  "wait_s": {"kind": "gauge", "delta": float(rng.uniform(0, 1))},
                  "mem_total": {"kind": "counter", "delta": int(rng.integers(0, 9))},
                  "disk_total": {"kind": "counter", "delta": int(rng.integers(0, 9))}}
        if rng.random() < 0.1:
            window.pop("m")
        for name, engine in (("ours", ours), ("theirs", theirs)):
            for a in engine.evaluate(window, t=float(w)):
                fired[name].append((w, a.name, a.cause, a.value, a.threshold,
                                    a.windows, a.message))
    assert fired["ours"] == fired["theirs"] and fired["ours"]
    assert ours.breaching() == theirs.breaching()
    assert ours.collect() == theirs.collect()


def test_a_jax_reporters_stream_loads_in_the_port_and_back(tmp_path):
    """Each package's Reporter writes the JSONL the other's load_export reads, to the
    same merge shape."""
    streams = {}
    for name, reg_mod, rep_mod in (("port", None, None),
                                   ("jax", ref_metrics, ref_export)):
        registry = MetricsRegistry() if reg_mod is None else reg_mod.MetricsRegistry()
        reporter_cls = Reporter if rep_mod is None else rep_mod.Reporter
        c = registry.counter("rows_total")
        h = registry.histogram("lat_seconds")
        path = str(tmp_path / ("%s.jsonl" % name))
        with reporter_cls(registry=registry, interval_s=600.0, jsonl_path=path) as rep:
            for i in range(4):
                c.inc(100 * (i + 1))
                h.observe(0.01 * (i + 1))
                rep._write_once()
        streams[name] = path
    for path in streams.values():
        ours, theirs = load_export(path), ref_timeseries.load_export(path)
        assert ours == theirs
        assert [p["delta"] for p in ours["series"]["rows_total"]][1:4] == [200, 300, 400]
        assert ours["anchor"]["pid"] == os.getpid()


# -- the SLO engine ------------------------------------------------------------------------


class _StubReport:
    def __init__(self, slow_top="io.remote"):
        self.slow_top = slow_top

    def to_dict(self):
        return {"slow_top": self.slow_top, "slow_share": {self.slow_top: 0.8}}


def _hist_window(p99, count=5):
    return {"kind": "histogram", "t": 0, "count": count, "sum": p99 * count,
            "p50": p99, "p99": p99}


def test_slo_breach_debounce_and_attribution_snapshot():
    engine = SloEngine(
        specs=[SloSpec(name="p99", metric="m", stat="p99", op="<=", threshold=0.1,
                       breach_windows=3)],
        attribution=lambda: _StubReport("io.remote"))
    assert engine.evaluate({"m": _hist_window(0.5)}, t=1.0) == []
    assert engine.evaluate({"m": _hist_window(0.5)}, t=2.0) == []
    alerts = engine.evaluate({"m": _hist_window(0.5)}, t=3.0)
    assert len(alerts) == 1
    alert = alerts[0]
    assert alert.cause == "slo_breach" and alert.windows == 3
    assert alert.culprit == "io.remote"
    assert alert.attribution["slow_top"] == "io.remote"
    assert "io.remote" in alert.message
    assert engine.evaluate({"m": _hist_window(0.6)}, t=4.0) == []
    assert engine.evaluate({"m": _hist_window(0.01)}, t=5.0) == []
    assert engine.evaluate({"m": _hist_window(0.5)}, t=6.0) == []
    assert engine.evaluate({"m": _hist_window(0.5)}, t=7.0) == []
    assert len(engine.evaluate({"m": _hist_window(0.5)}, t=8.0)) == 1
    assert len(engine.alerts()) == 2


def test_slo_without_attribution_source_names_no_culprit():
    """Without an attribution source (a loader without provenance) an alert carries no
    attribution, as in the JAX package with provenance off."""
    engine = SloEngine(specs=[SloSpec(name="p99", metric="m", stat="p99", op="<=",
                                      threshold=0.1, breach_windows=1)])
    alert = engine.evaluate({"m": _hist_window(0.5)}, t=1.0)[0]
    assert alert.attribution is None and alert.culprit is None
    assert "critical path" not in alert.message


def test_slo_sparse_windows_neither_breach_nor_clear():
    engine = SloEngine(specs=[SloSpec(name="p99", metric="m", stat="p99", op="<=",
                                      threshold=0.1, breach_windows=2, min_count=3)])
    assert engine.evaluate({"m": _hist_window(0.5)}, t=1.0) == []
    assert engine.evaluate({}, t=2.0) == []
    assert engine.evaluate({"m": _hist_window(0.5, count=1)}, t=3.0) == []
    assert len(engine.evaluate({"m": _hist_window(0.5)}, t=4.0)) == 1


def test_slo_rate_share_and_time_share_stats():
    engine = SloEngine(specs=[
        SloSpec(name="quarantine-rate", metric="q_total", stat="rate", op="<=",
                threshold=1.0, breach_windows=1),
        SloSpec(name="mem-share", metric="mem_total", stat="share",
                denominator=("mem_total", "disk_total"), op=">=", threshold=0.5,
                breach_windows=1),
        SloSpec(name="idle-share", metric="wait_s", stat="share", denominator=None,
                op="<=", threshold=0.5, breach_windows=1),
    ])

    def scalar(delta, rate=None):
        return {"kind": "counter", "t": 0, "value": 0, "delta": delta,
                "rate": rate if rate is not None else delta}

    engine.evaluate({}, t=10.0)
    alerts = engine.evaluate({"q_total": scalar(6, rate=6.0), "mem_total": scalar(2),
                              "disk_total": scalar(8), "wait_s": scalar(0.2)}, t=11.0)
    assert sorted(a.name for a in alerts) == ["mem-share", "quarantine-rate"]
    alerts = engine.evaluate({"q_total": scalar(0, rate=0.0), "mem_total": scalar(9),
                              "disk_total": scalar(1), "wait_s": scalar(0.9)}, t=12.0)
    assert [a.name for a in alerts] == ["idle-share"]


def test_slo_spec_validation():
    with pytest.raises(ValueError, match="op"):
        SloSpec(name="x", metric="m", op="!=")
    with pytest.raises(ValueError, match="stat"):
        SloSpec(name="x", metric="m", stat="p75")


def test_per_tenant_spec_is_accepted_and_finds_no_series_without_tenants():
    """A per_tenant spec needs tenant-labelled series, which only the tenant plane
    (item 8c) makes: it is evaluated as in the JAX package, and fires nothing."""
    engine = SloEngine(specs=[SloSpec(name="t", metric="m", stat="p99", op="<=",
                                      threshold=0.1, breach_windows=1,
                                      per_tenant=True)])
    assert engine.evaluate({"m": _hist_window(0.9)}, t=1.0) == []
    alerts = engine.evaluate({'m{tenant="a"}': _hist_window(0.9)}, t=2.0)
    assert [a.tenant for a in alerts] == ["a"]


def test_slo_alert_counter_and_flight_mirror():
    from petastorm_tpu_torch.obs.flight import FlightRecorder, activate, deactivate

    registry = MetricsRegistry()
    recorder = FlightRecorder()
    activate(recorder)
    try:
        engine = SloEngine(specs=[SloSpec(name="p99", metric="m", stat="p99", op="<=",
                                          threshold=0.1, breach_windows=1)],
                           registry=registry)
        engine.evaluate({"m": _hist_window(0.7)}, t=1.0)
    finally:
        deactivate(recorder)
    assert registry.snapshot()['ptpu_slo_alerts_total{slo="p99"}'] == 1
    kinds = [e["kind"] for e in recorder.events()]
    assert "slo_alert" in kinds and "degradation" in kinds


def test_anomaly_fires_once_on_step_cliff():
    det = AnomalyDetector(min_history=6, z_threshold=5.0, ewma_alpha=1.0)
    assert not any(det.observe(v) for v in [10.0, 10.2, 9.9, 10.1, 10.0, 10.05, 9.95])
    fires = [det.observe(50.0) for _ in range(12)]
    assert sum(fires) == 1 and fires[0] is True


def test_anomaly_rearms_after_recovery():
    det = AnomalyDetector(min_history=5, z_threshold=5.0, z_clear=2.0, ewma_alpha=1.0)
    for v in [10, 10.1, 9.9, 10, 10.05, 10.02]:
        det.observe(v)
    assert det.observe(80.0) is True
    for v in [10, 10.1, 9.95, 10.0]:
        det.observe(v)
    assert det.observe(80.0) is True


def test_engine_anomaly_watch_end_to_end():
    engine = SloEngine(anomaly_metrics=[("m", "p99")],
                       anomaly_kwargs=dict(min_history=5, z_threshold=5.0,
                                           ewma_alpha=1.0),
                       attribution=lambda: _StubReport("transform"))
    for i in range(7):
        engine.evaluate({"m": _hist_window(0.01 + 0.0001 * (i % 2))}, t=float(i))
    alerts = engine.evaluate({"m": _hist_window(0.4)}, t=99.0)
    assert len(alerts) == 1
    assert alerts[0].cause == "anomaly_detected"
    assert alerts[0].culprit == "transform"


# -- the Reporter's schema and cadence -----------------------------------------------------


def test_reporter_v2_lines_carry_clock_anchor(tmp_path):
    r = MetricsRegistry()
    r.counter("x_total").inc()
    jsonl = str(tmp_path / "s.jsonl")
    with Reporter(registry=r, interval_s=600.0, jsonl_path=jsonl) as rep:
        rep._write_once()
    snaps = read_recent_jsonl_snapshots(jsonl)
    assert len(snaps) == 2
    for snap in snaps:
        assert snap["schema"] == "ptpu-stats-v2"
        assert isinstance(snap["perf"], float)
        assert {"wall", "perf", "host", "pid"} <= set(snap["anchor"])
    assert len(r.timeline("x_total")) == 2


def test_reporter_timelines_opt_out(tmp_path):
    r = MetricsRegistry()
    r.counter("x_total").inc()
    with Reporter(registry=r, interval_s=600.0, jsonl_path=str(tmp_path / "s.jsonl"),
                  timelines=False) as rep:
        rep._write_once()
    assert r.timeline("x_total") == []


def test_reporter_records_a_failed_sample_and_still_flushes(tmp_path):
    from petastorm_tpu_torch.obs.log import degradation_counts

    r = MetricsRegistry()
    r.counter("x_total").inc()

    def broken():
        raise RuntimeError("sampler down")

    r.sample_timelines = broken
    before = degradation_counts().get("timeline_sample_error", 0)
    jsonl = str(tmp_path / "s.jsonl")
    with Reporter(registry=r, interval_s=600.0, jsonl_path=jsonl) as rep:
        rep._write_once()
    assert degradation_counts()["timeline_sample_error"] >= before + 1
    assert read_recent_jsonl_snapshots(jsonl)[-1]["metrics"]["x_total"] == 1


# -- merges of exports ---------------------------------------------------------------------


def _write_export(path, anchor, rows_points, skew_ts=None):
    with open(path, "w") as f:
        for perf, rows in rows_points:
            f.write(json.dumps({
                "schema": "ptpu-stats-v2",
                "ts": skew_ts if skew_ts is not None else anchor["wall"] + perf,
                "perf": perf, "anchor": anchor,
                "metrics": {"ptpu_pipeline_rows": rows, "rows_total": rows}}) + "\n")


def test_merge_aligns_clock_skewed_exports(tmp_path):
    a = str(tmp_path / "a.jsonl")
    b = str(tmp_path / "b.jsonl")
    t0 = 1_000_000.0
    _write_export(a, {"wall": t0, "perf": 0.0, "host": "ha", "pid": 1},
                  [(1.0, 100), (2.0, 200), (3.0, 300)])
    _write_export(b, {"wall": t0, "perf": 50.0, "host": "hb", "pid": 2},
                  [(51.0, 10), (52.0, 30), (53.0, 60)], skew_ts=t0 + 9_999_999.0)
    ea, eb = load_export(a), load_export(b)
    assert [p["t"] for p in eb["series"]["rows_total"]] == [t0 + 1.0, t0 + 2.0, t0 + 3.0]
    fleet = fleet_rate_series([ea, eb], "rows_total", bin_s=1.0)
    assert len(fleet) == 2
    assert fleet[0][1] == pytest.approx(100 + 20)
    assert fleet[1][1] == pytest.approx(100 + 30)


def test_fleet_totals_equal_sum_of_sources(tmp_path):
    paths = []
    for i, rows in enumerate((300, 800)):
        p = str(tmp_path / ("s%d.jsonl" % i))
        _write_export(p, {"wall": 10.0, "perf": 0.0, "host": "h%d" % i, "pid": i},
                      [(1.0, rows)])
        paths.append(p)
    merged = merge_exports([load_export(p) for p in paths])
    assert merged["totals"]["rows_total"] == 1100
    assert merged["totals"]["rows_total"] == sum(
        m["rows_total"] for m in merged["per_source"].values())
    assert len(merged["sources"]) == 2


def test_merge_histogram_summaries_conservatively():
    docs = [{"source": "s%d" % i, "anchor": None,
             "metrics": {"lat": {"count": count, "sum": count * p99, "p50": p99 / 2,
                                 "p90": p99, "p99": p99}}, "series": {}}
            for i, (count, p99) in enumerate(((10, 0.1), (30, 0.4)))]
    agg = merge_exports(docs)["totals"]["lat"]
    assert agg["count"] == 40
    assert agg["p99"] == 0.4


def test_fleet_merge_keeps_tenant_labels_as_distinct_series():
    """Tenant-labelled counters merge per full labelled name: the fleet total of
    ``...{tenant="a"}`` sums that label across sources, never folded into the untagged
    family or another tenant; equal to the JAX package's merge."""
    docs = []
    for i, (a_rows, b_rows) in enumerate(((100, 900), (50, 100))):
        docs.append({"source": "h%d" % i, "anchor": None,
                     "metrics": {"ptpu_pipeline_rows": a_rows + b_rows,
                                 'ptpu_tenant_rows_total{tenant="a"}': a_rows,
                                 'ptpu_tenant_rows_total{tenant="b"}': b_rows},
                     "series": {}})
    merged = merge_exports(docs)
    assert merged["totals"]['ptpu_tenant_rows_total{tenant="a"}'] == 150
    assert merged["totals"]['ptpu_tenant_rows_total{tenant="b"}'] == 1000
    for name in ('ptpu_tenant_rows_total{tenant="a"}',
                 'ptpu_tenant_rows_total{tenant="b"}'):
        assert merged["totals"][name] == sum(
            m.get(name, 0) for m in merged["per_source"].values())
    assert merged["totals"]["ptpu_pipeline_rows"] == 1150
    assert merged["totals"] == ref_timeseries.merge_exports(docs)["totals"]


def test_tenant_usage_report_from_merged_fleet_totals():
    """The usage report of the merged fleet totals equals the merge of the per-source
    reports (the report is fleet-mergeable), and the JAX package's report."""
    from petastorm_tpu.obs.tenant import TenantUsageReport as RefReport
    from petastorm_tpu_torch.obs.tenant import TenantUsageReport

    per_source = [
        {'ptpu_tenant_rows_total{tenant="a"}': 100.0,
         'ptpu_tenant_worker_seconds_total{tenant="a"}': 1.0},
        {'ptpu_tenant_rows_total{tenant="a"}': 40.0,
         'ptpu_tenant_rows_total{tenant="b"}': 700.0,
         'ptpu_tenant_worker_seconds_total{tenant="b"}': 5.0},
    ]
    docs = [{"source": "h%d" % i, "anchor": None, "metrics": dict(m), "series": {}}
            for i, m in enumerate(per_source)]
    totals = merge_exports(docs)["totals"]
    fleet = TenantUsageReport.from_metrics(totals)
    by_parts = TenantUsageReport.from_metrics(per_source[0]).merge(
        TenantUsageReport.from_metrics(per_source[1]))
    assert fleet.to_dict() == by_parts.to_dict()
    assert fleet.get("a", "rows") == 140.0
    assert fleet.top_consumer("worker_s") == ("b", 5.0)
    assert fleet.to_dict() == RefReport.from_metrics(totals).to_dict()


def test_uniquify_sources_keeps_collisions_visible():
    exports = [{"source": "h:1", "metrics": {"x": 1}, "series": {}},
               {"source": "h:1", "metrics": {"x": 2}, "series": {}}]
    assert [e["source"] for e in uniquify_sources(exports)] == ["h:1", "h:1#2"]
    merged = merge_exports(exports)
    assert merged["totals"]["x"] == 3 and len(merged["per_source"]) == 2


def test_sparkline_shapes():
    assert sparkline([]) == ""
    assert sparkline([None, None]) == "  "
    s = sparkline([1, 2, 3, 4])
    assert len(s) == 4 and s[0] == "▁" and s[-1] == "█"
    assert sparkline([5, 5, 5]) == "▁▁▁"


# -- the scrape endpoint -------------------------------------------------------------------


def test_metrics_server_endpoints():
    from petastorm_tpu_torch.obs.serve import MetricsServer

    r = MetricsRegistry()
    r.counter("hits_total").inc(7)
    r.sample_timelines()
    engine = SloEngine(specs=[SloSpec(name="s", metric="hits_total", stat="value",
                                      op="<=", threshold=1, breach_windows=1)],
                       registry=r)
    engine.evaluate({"hits_total": {"kind": "counter", "value": 7, "delta": 7,
                                    "rate": 7.0}}, t=1.0)
    with MetricsServer(r, slo_engine=engine, routes={"/extra": lambda: {"k": 1}}) as srv:
        assert srv.port and srv.url.startswith("http://127.0.0.1:")
        prom = urllib.request.urlopen(srv.url + "/metrics").read().decode()
        assert parse_prometheus_text(prom)["hits_total"] == 7
        doc = json.loads(urllib.request.urlopen(srv.url + "/timelines").read())
        assert doc["schema"] == "ptpu-fleet-export-v1"
        assert doc["anchor"]["pid"] == os.getpid()
        assert doc["timelines"]["hits_total"]["points"]
        alerts = json.loads(urllib.request.urlopen(srv.url + "/alerts").read())["alerts"]
        assert len(alerts) == 1 and alerts[0]["cause"] == "slo_breach"
        assert json.loads(urllib.request.urlopen(srv.url + "/healthz").read())["ok"]
        assert json.loads(urllib.request.urlopen(srv.url + "/extra").read()) == {"k": 1}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(srv.url + "/nope")
    with pytest.raises(OSError):
        urllib.request.urlopen("http://127.0.0.1:%d/healthz" % srv.port, timeout=0.5)


def test_metrics_server_binds_port_zero_on_loopback():
    """The default is 127.0.0.1 and port 0: two servers get two free ports."""
    from petastorm_tpu_torch.obs.serve import MetricsServer

    with MetricsServer(MetricsRegistry()) as a, MetricsServer(MetricsRegistry()) as b:
        assert a._host == b._host == "127.0.0.1"
        assert a._requested_port == b._requested_port == 0
        assert a.port and b.port and a.port != b.port


def test_metrics_server_document_is_merge_loadable(tmp_path):
    from petastorm_tpu_torch.obs.serve import MetricsServer

    r = MetricsRegistry()
    r.counter("rows_total").inc(42)
    r.sample_timelines()
    with MetricsServer(r) as srv:
        body = urllib.request.urlopen(srv.url + "/timelines").read()
    path = str(tmp_path / "doc.json")
    with open(path, "wb") as f:
        f.write(body)
    export = load_export(path)
    assert export["metrics"]["rows_total"] == 42
    assert merge_exports([export])["totals"]["rows_total"] == 42
    assert ref_timeseries.load_export(path) == export


# -- the loader's slos= ----------------------------------------------------------------------


def test_loader_slos_requires_metrics(small_dataset):
    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader

    with make_batch_reader(small_dataset, num_epochs=1, workers_count=1) as reader:
        with pytest.raises(ValueError, match="requires metrics"):
            DataLoader(reader, 8, device="cpu", to_device=False,
                       slos=[SloSpec(name="x", metric="m", threshold=1)])


def test_loader_slos_end_to_end(small_dataset):
    """The spec that must fire reads the batch count of the ``pipeline`` collector,
    which moves once for each batch this test takes (on the consumer's thread with
    ``to_device=False``); the test samples each window itself. Every window after the
    first breaches ``delta <= 0``, so with ``breach_windows=2`` exactly one alert fires;
    the loose spec on the read stage's p99 fires none."""
    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader

    registry = MetricsRegistry()
    tight = SloSpec(name="batches-stall", metric="ptpu_pipeline_batches", stat="delta",
                    op="<=", threshold=0, breach_windows=2)
    loose = SloSpec(name="read-p99", metric='ptpu_pipeline_stage_seconds{stage="read"}',
                    stat="p99", op="<=", threshold=60.0, breach_windows=1)
    reader = make_batch_reader(small_dataset, num_epochs=1, workers_count=1)
    with DataLoader(reader, 8, device="cpu", to_device=False, metrics=registry,
                    last_batch="partial", slos=[tight, loose]) as loader:
        assert loader.slo_engine is not None
        registry.sample_timelines()  # the first window: no delta yet
        rows = 0
        for batch in loader:
            rows += len(batch["id"])
            registry.sample_timelines()
        assert rows == 30
        alerts = loader.slo_alerts()
        assert [(a.name, a.cause, a.windows) for a in alerts] == \
            [("batches-stall", "slo_breach", 2)]
        report = loader.bottleneck_report()
        assert report.slo_alerts and report.slo_alerts[0]["name"] == "batches-stall"
        assert "slo alerts" in report.render()
        assert loader._health_context()["slo"]["alerts"] == 1
    windows_before = loader.slo_engine.windows_evaluated
    registry.sample_timelines()
    assert loader.slo_engine.windows_evaluated == windows_before
    assert len(loader.slo_alerts()) == 1


def test_loader_shared_slo_engine_survives_loader_exit(small_dataset):
    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader

    registry = MetricsRegistry()
    engine = SloEngine(specs=[SloSpec(name="always", metric="never_total", stat="value",
                                      op="<=", threshold=1e9)], registry=registry)
    reader = make_batch_reader(small_dataset, num_epochs=1, workers_count=1)
    with DataLoader(reader, 8, device="cpu", to_device=False, metrics=registry,
                    last_batch="partial", slos=engine) as loader:
        assert loader.slo_engine is engine
        for _ in loader:
            pass
    before = engine.windows_evaluated
    registry.sample_timelines()
    assert engine.windows_evaluated == before + 1
    engine.detach()


def test_reporter_drives_the_loaders_slo_engine(small_dataset, tmp_path):
    """A Reporter on the loader's registry samples the windows: the engine evaluates on
    its cadence, and the JSONL carries the ptpu_io_* and ptpu_pipeline_* families."""
    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader

    registry = MetricsRegistry()
    jsonl = str(tmp_path / "r.jsonl")
    reader = make_batch_reader(small_dataset, num_epochs=1, workers_count=1)
    with DataLoader(reader, 8, device="cpu", to_device=False, metrics=registry,
                    slos=[SloSpec(name="x", metric="ptpu_pipeline_rows", stat="value",
                                  op="<=", threshold=1e9)]) as loader:
        with Reporter(registry=registry, interval_s=600.0, jsonl_path=jsonl) as rep:
            for _ in loader:
                rep._write_once()
        windows = loader.slo_engine.windows_evaluated
    assert windows >= 3
    last = read_recent_jsonl_snapshots(jsonl)[-1]["metrics"]
    assert any(k.startswith("ptpu_io_") for k in last)
    assert "ptpu_pipeline_batches" in last
