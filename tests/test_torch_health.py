"""The port's health plane against the JAX package's (ROADMAP.md Queue 1 item 8b(i)):
heartbeats, the backpressure-aware stall watchdog, flight records, straggler detection,
the Reporter's crash flush, and the liveness wiring of the loader, the pools and the
readahead IO threads.

Every case of the JAX package's ``tests/test_health.py`` has a counterpart here except
the three dashboard and stats-CLI cases (``test_dashboard_renders_health_sections``,
``test_stats_cli_watch_file_form_parses``,
``test_dashboard_renders_prometheus_histograms``), which are in
``tests/test_torch_stats_cli.py`` with the rest of the stats CLI's cases. The
hangs are chaos ``hang`` rules, disarmed as soon as a case has seen what it waits for,
so a case never waits out its hang; each watchdog case runs a threshold and a poll
interval below 1 s (a backpressure case, which must hold a wait longer than the
threshold, runs 1 s) and ends in a few seconds. Beside them:

- ``HealthOptions`` has the JAX package's defaults, environment reads and validation;
- ``check_stalls`` gives the same stalled set for the same heartbeat ages;
- a full queue (host or device side, thread or process pool) is never a stall;
- the stack dump signals only the pool's own children and reports one that does not
  answer;
- the loader, the pools and the IO threads register their heartbeats, and the
  ``ptpu_health_*`` and ``ptpu_io_*`` families reach the registry.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu.obs import health as ref_health  # noqa: E402
from petastorm_tpu_torch import chaos, make_batch_reader  # noqa: E402
from petastorm_tpu_torch.chaos import FaultPlan, FaultRule  # noqa: E402
from petastorm_tpu_torch.errors import PetastormTpuError, StallError  # noqa: E402
from petastorm_tpu_torch.loader import DataLoader  # noqa: E402
from petastorm_tpu_torch.obs.analyze import analyze_snapshot, detect_straggler  # noqa: E402
from petastorm_tpu_torch.obs.flight import FlightRecorder, write_flight_record  # noqa: E402
from petastorm_tpu_torch.obs.health import (  # noqa: E402
    ActorSlots,
    HealthMonitor,
    HealthOptions,
    Heartbeat,
    normalize_health,
)
from petastorm_tpu_torch.obs import health as port_health  # noqa: E402
from petastorm_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarmed():
    chaos.disarm()
    yield
    chaos.disarm()


def _write_dataset(root, files=4, rows_per_file=64):
    for i in range(files):
        base = i * rows_per_file
        pq.write_table(
            pa.table({"id": np.arange(base, base + rows_per_file, dtype=np.int64),
                      "x": np.random.default_rng(i).random(rows_per_file)}),
            os.path.join(str(root), "p%d.parquet" % i))
    return "file://" + str(root)


def _wait_for(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


# -- heartbeat and classification units --------------------------------------------------


def test_heartbeat_states_and_age():
    hb = Heartbeat("a", "worker", threshold_s=1.0)
    hb.beat("working")
    assert not hb.waiting
    assert hb.age() < 0.5
    hb.wait("host_queue_put")
    assert hb.waiting and hb.state == "wait:host_queue_put"
    hb.done()
    assert hb.waiting and hb.state == "done"


def test_check_stalls_busy_over_threshold_only():
    m = HealthMonitor(HealthOptions(stall_threshold_s=10.0))
    busy = m.register("busy", "worker", threshold_s=0.01)
    waiting = m.register("waiting", "producer", threshold_s=0.01)
    done = m.register("done", "transfer", threshold_s=0.01)
    busy.beat("working")
    waiting.wait("host_queue_put")
    done.done()
    time.sleep(0.05)
    stalled = m.check_stalls()
    assert [s["actor"] for s in stalled] == ["busy"]
    assert stalled[0]["state"] == "working"
    # debounce: the same hang is reported once until the actor beats again
    assert m.check_stalls() == []
    busy.beat("working")
    time.sleep(0.05)
    assert [s["actor"] for s in m.check_stalls()] == ["busy"]


def test_threshold_role_defaults_and_overrides():
    opts = HealthOptions(stall_threshold_s=30.0, thresholds={"io": 5.0})
    assert opts.threshold_for("worker") == 30.0
    assert opts.threshold_for("io") == 5.0
    with pytest.raises(ValueError, match="escalation"):
        HealthOptions(escalation="explode")


def test_normalize_health_shapes(monkeypatch):
    monkeypatch.delenv("PTPU_HEALTH", raising=False)
    assert normalize_health(None) == (None, False)
    assert normalize_health(False) == (None, False)
    monitor, owned = normalize_health(True)
    assert isinstance(monitor, HealthMonitor) and owned
    opts_monitor, owned = normalize_health(HealthOptions(stall_threshold_s=1))
    assert opts_monitor.options.stall_threshold_s == 1 and owned
    shared = HealthMonitor()
    assert normalize_health(shared) == (shared, False)
    monkeypatch.setenv("PTPU_HEALTH", "1")
    env_monitor, owned = normalize_health(None)
    assert isinstance(env_monitor, HealthMonitor) and owned


def test_stall_error_is_a_framework_error():
    err = StallError("pipeline stalled: x")
    assert isinstance(err, PetastormTpuError) and str(err) == "pipeline stalled: x"


# -- the same options and verdicts as the JAX package ------------------------------------


_ENVS = [
    {},
    {"PTPU_HEALTH_THRESHOLD_S": "7.5"},
    {"PTPU_HEALTH_POLL_S": "0.125", "PTPU_HEALTH_DIR": "/tmp/flights"},
    {"PTPU_HEALTH_THRESHOLD_S": "not-a-number", "PTPU_HEALTH_POLL_S": ""},
]


@pytest.mark.parametrize("env", _ENVS)
def test_health_options_defaults_and_env_equal_the_jax_packages(monkeypatch, env):
    for name in ("PTPU_HEALTH_THRESHOLD_S", "PTPU_HEALTH_POLL_S", "PTPU_HEALTH_DIR"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for kwargs in ({}, {"stall_threshold_s": 3, "thresholds": {"child": 2.0},
                        "poll_interval_s": 0.5, "escalation": "heal"}):
        ours, theirs = HealthOptions(**kwargs), ref_health.HealthOptions(**kwargs)
        for name in HealthOptions.__slots__:
            assert getattr(ours, name) == getattr(theirs, name), name
        for role in ("producer", "transfer", "worker", "io", "child"):
            assert ours.threshold_for(role) == theirs.threshold_for(role)


@pytest.mark.parametrize("value", ["PTPU_HEALTH=", "PTPU_HEALTH=0", "PTPU_HEALTH=no",
                                   "PTPU_HEALTH=1", "PTPU_HEALTH=yes"])
def test_the_health_switch_reads_as_the_jax_packages(monkeypatch, value):
    name, _, v = value.partition("=")
    monkeypatch.setenv(name, v)
    assert ref_health.health_enabled_by_env() == port_health.health_enabled_by_env()


@pytest.mark.parametrize("bad", [{"escalation": "explode"}, {"escalation": None},
                                 {"stall_threshold_s": "abc"}])
def test_health_options_validation_errors_equal_the_jax_packages(bad):
    with pytest.raises(Exception) as ours:
        HealthOptions(**bad)
    with pytest.raises(Exception) as theirs:
        ref_health.HealthOptions(**bad)
    assert type(ours.value) is type(theirs.value)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_check_stalls_gives_the_jax_packages_stalled_set(seed):
    """The same heartbeat ages and states (seeded) on both monitors: the same actors
    stalled, the same descriptions, and the same debounce on a second poll."""
    rng = np.random.default_rng(seed)
    ours = HealthMonitor(HealthOptions(stall_threshold_s=2.0, thresholds={"io": 0.5}))
    theirs = ref_health.HealthMonitor(ref_health.HealthOptions(
        stall_threshold_s=2.0, thresholds={"io": 0.5}))
    now = time.monotonic()
    states = ["working", "read", "decode", "wait:claim", "wait:host_queue_put", "done"]
    for i in range(24):
        role = ["producer", "transfer", "worker", "io", "child"][i % 5]
        state = states[int(rng.integers(len(states)))]
        age = float(rng.uniform(0.0, 4.0))
        for m in (ours, theirs):
            hb = m.register("actor-%d" % i, role)
            hb.beat(state)
            hb.last = now - age
    got, want = ours.check_stalls(now), theirs.check_stalls(now)
    assert got == want and got
    assert ours.check_stalls(now) == theirs.check_stalls(now) == []
    assert set(ours.collect()) == set(theirs.collect())


# -- flight recorder ---------------------------------------------------------------------


def test_flight_ring_bounded_and_ordered():
    rec = FlightRecorder(max_events=32)
    for i in range(100):
        rec.record("span", seq=i)
    events = rec.events()
    assert len(events) == 32
    assert [e["seq"] for e in events] == list(range(68, 100))
    assert all(e["kind"] == "span" for e in events)


def test_flight_record_json_roundtrip(tmp_path):
    path = str(tmp_path / "f.json")
    write_flight_record(path, {"a": 1, "weird": object()})  # stringified
    with open(path) as f:
        rec = json.load(f)
    assert rec["a"] == 1 and "object" in rec["weird"]


def test_dump_flight_record_contains_driver_stacks(tmp_path):
    m = HealthMonitor(HealthOptions(flight_path=str(tmp_path / "flight.json")))
    m.register("me", "worker").beat("working")
    m.add_context("extra", lambda: {"k": 1})
    path = m.dump_flight_record("on_demand")
    with open(path) as f:
        rec = json.load(f)
    assert rec["schema"] == "ptpu-flight-v1"
    assert rec["context"]["extra"] == {"k": 1}
    assert any("test_dump_flight_record_contains_driver_stacks" in s
               for s in rec["driver_stacks"].values())
    assert any(h["actor"] == "me" for h in rec["heartbeats"])


def test_default_flight_path_is_the_jax_packages_name(monkeypatch, tmp_path):
    monkeypatch.setenv("PTPU_HEALTH_DIR", str(tmp_path))
    assert HealthOptions().flight_path == \
        os.path.join(str(tmp_path), "ptpu_flight_%d.json" % os.getpid())


def test_degradations_mirror_into_active_flight_ring():
    from petastorm_tpu_torch.obs.log import degradation

    with HealthMonitor(HealthOptions(poll_interval_s=60.0)) as m:
        degradation("test_torch_mirror_cause", "mirrored into the ring", once=True)
    kinds = [(e["kind"], e.get("cause")) for e in m.flight.events()]
    assert ("degradation", "test_torch_mirror_cause") in kinds


def test_set_health_rewires_running_dispatcher_into_flight_ring():
    """The pool (and its dispatcher) starts in the reader's constructor, before a loader
    can attach health: set_health must point the live dispatcher at the flight ring."""
    from petastorm_tpu_torch.plan import EpochPlan
    from petastorm_tpu_torch.workers import PullDispatcher, ThreadExecutor

    ex = ThreadExecutor(workers_count=2)
    try:
        ex._dispatch = PullDispatcher(EpochPlan(list(range(4)), num_epochs=1),
                                      workers_count=2, lookahead=3)
        with HealthMonitor(HealthOptions(poll_interval_s=60.0)) as m:
            ex.set_health(m)
            ex._dispatch.next(0)      # worker 0 claims everything
            ex._dispatch.next(1)      # the plan is dry: it steals worker 0's tail
            assert ex._dispatch.steals == 1
            assert "steal" in [e["kind"] for e in m.flight.events()]
            ex.set_health(None)
            ex._dispatch.next(1)
            assert ex._dispatch._recorder is None
    finally:
        ex.stop()
        ex.join()


# -- the watchdog ------------------------------------------------------------------------


def test_watchdog_trips_within_threshold_and_writes_record(tmp_path):
    from petastorm_tpu_torch.obs.log import degradation_counts

    flight = str(tmp_path / "flight.json")
    m = HealthMonitor(HealthOptions(stall_threshold_s=0.3, poll_interval_s=0.05,
                                    escalation="flight", flight_path=flight))
    errors = []
    m.add_stall_callback(errors.append)  # raise/heal only: must not fire here
    with m:
        m.register("actor", "worker").beat("working")
        assert _wait_for(lambda: m.stall_count >= 1, 5.0)
    assert m.last_record_path == flight
    with open(flight) as f:
        rec = json.load(f)
    assert rec["reason"] == "stall"
    assert rec["stalled"][0]["actor"] == "actor"
    assert errors == []
    assert degradation_counts().get("stall_detected", 0) >= 1


def test_watchdog_escalation_warn_skips_flight_dump(tmp_path):
    flight = str(tmp_path / "never.json")
    with HealthMonitor(HealthOptions(stall_threshold_s=0.1, poll_interval_s=0.05,
                                     escalation="warn", flight_path=flight)) as m:
        m.register("actor", "worker").beat("working")
        assert _wait_for(lambda: m.stall_count >= 1, 5.0)
    assert not os.path.exists(flight)


# -- a hung decode on the thread pool ------------------------------------------------------


def test_hung_decode_trips_watchdog_and_raises(tmp_path):
    """A worker hung on its second item: StallError reaches the consumer while the hang
    lasts, and the flight record names the stalled actor and holds its stack."""
    url = _write_dataset(tmp_path)
    flight = str(tmp_path / "flight.json")
    hang_s = 30.0
    opts = HealthOptions(stall_threshold_s=0.5, poll_interval_s=0.1, escalation="raise",
                         flight_path=flight)
    plan = FaultPlan([FaultRule("worker.item", "hang", nth=2, times=1, hang_s=hang_s)])
    with chaos.armed(plan, propagate=False):
        reader = make_batch_reader(url, num_epochs=1, workers_count=1)
        t0 = time.monotonic()
        with DataLoader(reader, 16, device="cpu", to_device=False, health=opts) as loader:
            with pytest.raises(StallError, match="pipeline stalled"):
                for _ in loader:
                    pass
            detected_after = time.monotonic() - t0
            chaos.disarm()  # ends the hang: the pool joins at once
    assert detected_after < 10.0, detected_after
    with open(flight) as f:
        rec = json.load(f)
    assert {s["actor"] for s in rec["stalled"]} & {"worker.thread-0", "loader.producer"}
    assert any("_execute" in s or "sleep" in s for s in rec["driver_stacks"].values())
    pipeline = rec["context"]["pipeline"]
    assert "host_queue_depth" in pipeline and "stats" in pipeline


def test_hung_decode_flight_only_keeps_stream_alive(tmp_path):
    """escalation='flight': the record is written and the stream completes once the
    hang clears, nothing lost."""
    url = _write_dataset(tmp_path)
    flight = str(tmp_path / "flight.json")
    opts = HealthOptions(stall_threshold_s=0.4, poll_interval_s=0.1, escalation="flight",
                         flight_path=flight)
    plan = FaultPlan([FaultRule("worker.item", "hang", nth=2, times=1, hang_s=1.2)])
    with chaos.armed(plan, propagate=False):
        reader = make_batch_reader(url, num_epochs=1, workers_count=1)
        with DataLoader(reader, 16, device="cpu", to_device=False, health=opts) as loader:
            rows = sum(len(b["id"]) for b in loader)
            assert loader._health.stall_count >= 1
    assert rows == 256
    assert os.path.exists(flight)


# -- a hung process-pool child -----------------------------------------------------------


def test_hung_pool_child_flight_record_has_child_stacks(tmp_path):
    """A child hung in its item: the stalled actor is the child, and its faulthandler
    stack (SIGUSR1) shows the hang; escalation='flight' keeps the stream alive."""
    url = _write_dataset(tmp_path)
    flight = str(tmp_path / "flight.json")
    opts = HealthOptions(stall_threshold_s=0.8, poll_interval_s=0.2, escalation="flight",
                         flight_path=flight)
    plan = FaultPlan([FaultRule("child.item", "hang", item_key="ordinal=1",
                                hang_s=4.0)])
    with chaos.armed(plan, propagate=True):
        reader = make_batch_reader(url, num_epochs=1, workers_count=1,
                                   reader_pool_type="process", results_timeout_s=60)
    with DataLoader(reader, 16, device="cpu", to_device=False, health=opts) as loader:
        rows = sum(len(b["id"]) for b in loader)
        assert loader._health.stall_count >= 1
    assert rows == 256
    with open(flight) as f:
        rec = json.load(f)
    assert any(s["actor"].startswith("worker.child-") for s in rec["stalled"]), \
        rec["stalled"]
    joined = "\n".join(rec["child_stacks"].values())
    assert "chaos" in joined and ("_execute" in joined or "hit" in joined), joined[:2000]


# -- backpressure is never a stall -----------------------------------------------------------


@pytest.mark.parametrize("pool,to_device", [("thread", False), ("thread", True),
                                            ("process", False)])
def test_backpressure_full_queue_is_not_a_stall(tmp_path, pool, to_device):
    """The consumer stops for longer than the parked actors' thresholds while the
    queues are full: the producer parks in wait:host_queue_put, the transfer thread
    (to_device) in wait:device_queue_put, the pool's worker threads or feeders in
    wait:results_put. Waits, not stalls: no StallError, 0 stalls. The busy work itself
    (a row group's read, a child's item on a loaded host) gets roomier thresholds: this
    case is about the waits."""
    url = _write_dataset(tmp_path)
    opts = HealthOptions(stall_threshold_s=1.0, poll_interval_s=0.05, escalation="raise",
                         thresholds={"worker": 3.0, "io": 10.0, "child": 10.0},
                         flight_path=str(tmp_path / "flight.json"))
    reader = make_batch_reader(url, num_epochs=2, workers_count=2, reader_pool_type=pool,
                               results_queue_size=2, results_timeout_s=60)
    rows = 0
    with DataLoader(reader, 16, device="cpu", to_device=to_device, host_queue_size=2,
                    prefetch=1, health=opts) as loader:
        for i, batch in enumerate(loader):
            rows += len(batch["id"])
            if i == 1:
                time.sleep(3.5)  # every queue fills and stays full past the thresholds
                states = {h["actor"]: h["state"]
                          for h in loader._health.heartbeats()}
                assert states["loader.producer"] == "wait:host_queue_put", states
                if to_device:
                    assert states["loader.transfer"] == "wait:device_queue_put", states
                parked = [a for a in states if a.startswith(("worker.thread-", "pooldrv-"))]
                assert parked and all(states[a].startswith("wait:") for a in parked), \
                    states
        assert loader._health.stall_count == 0
    assert rows == 512


# -- straggler detection -----------------------------------------------------------------


def _lat(mean, count=10):
    return {"count": count, "mean": mean, "sum": mean * count, "max": mean,
            "p50": mean, "p90": mean, "p99": mean}


def test_detect_straggler_unit():
    assert detect_straggler(None) is None
    assert detect_straggler({"0": _lat(0.01)}) is None  # needs 2 workers or more
    flat = {str(i): _lat(0.01) for i in range(4)}
    assert detect_straggler(flat) is None
    skewed = dict(flat, **{"3": _lat(0.09)})
    s = detect_straggler(skewed)
    assert s["worker"] == "3" and s["ratio"] >= 3.0
    assert detect_straggler(dict(flat, **{"3": _lat(0.09, count=2)})) is None


def test_analyze_snapshot_refines_producer_bound_to_straggler():
    snap = dict(batches=10, read_s=10.0, batch_s=0.2, put_wait_s=0.0,
                decode_s=0.1, h2d_s=0.1, queue_wait_s=9.0)
    assert analyze_snapshot(snap).verdict == "producer-bound"
    skewed = {"0": _lat(0.01), "1": _lat(0.011), "2": _lat(0.2)}
    report = analyze_snapshot(snap, worker_latency=skewed)
    assert report.verdict == "straggler"
    assert report.straggler["worker"] == "2"
    assert "straggler" in report.render()
    assert json.dumps(report.to_dict())
    consumer = dict(snap, read_s=0.2, put_wait_s=9.0, decode_s=10.0, queue_wait_s=0.0)
    assert analyze_snapshot(consumer, worker_latency=skewed).verdict == "consumer-bound"


def test_worker_latency_histograms_feed_report(tmp_path):
    """The pool's workers record their item latencies once a monitor is attached. A
    results queue of one holds the workers back until the loader consumes, so items
    start after the loader attached its monitor however fast the reader is."""
    url = _write_dataset(tmp_path, files=8, rows_per_file=32)
    opts = HealthOptions(stall_threshold_s=60.0, poll_interval_s=1.0,
                         flight_path=str(tmp_path / "f.json"))
    reader = make_batch_reader(url, num_epochs=1, workers_count=2, results_queue_size=1)
    with DataLoader(reader, 16, device="cpu", to_device=False, health=opts) as loader:
        for _ in loader:
            pass
        latency = loader._health.worker_latency()
        report = loader.health_report()
    assert latency and all(s["count"] >= 1 for s in latency.values())
    assert "bottleneck" in report and "verdict" in report["bottleneck"]


# -- health_report and the registry --------------------------------------------------------


def test_health_report_requires_health_and_dumps(tmp_path):
    url = _write_dataset(tmp_path, files=1)
    reader = make_batch_reader(url, num_epochs=1, workers_count=1)
    with DataLoader(reader, 16, device="cpu", to_device=False) as loader:
        list(loader)
        with pytest.raises(ValueError, match="health"):
            loader.health_report()
    reader = make_batch_reader(url, num_epochs=1, workers_count=1)
    dump = str(tmp_path / "report.json")
    with DataLoader(reader, 16, device="cpu", to_device=False, health=True) as loader:
        list(loader)
        report = loader.health_report(dump_path=dump)
    assert report["reason"] == "on_demand"
    assert any(h["actor"] == "loader.producer" for h in report["heartbeats"])
    with open(dump) as f:
        assert json.load(f)["schema"] == "ptpu-flight-v1"


def test_health_families_export_through_metrics(tmp_path):
    url = _write_dataset(tmp_path)
    registry = MetricsRegistry()
    opts = HealthOptions(stall_threshold_s=60.0, poll_interval_s=1.0,
                         flight_path=str(tmp_path / "f.json"))
    reader = make_batch_reader(url, num_epochs=1, workers_count=1)
    with DataLoader(reader, 16, device="cpu", to_device=False, metrics=registry, health=opts) as loader:
        list(loader)
        snap = registry.snapshot()
        assert "ptpu_health_stalls_total" in snap
        assert any(k.startswith("ptpu_health_hb_age_s_") for k in snap)
    assert not any(k.startswith("ptpu_health_") for k in registry.snapshot())


def test_io_families_export_through_metrics(tmp_path):
    """The reader's io_stats() is the ``io`` collector: its keys export as ``ptpu_io_*``
    under the JAX package's names (the readahead pool's hits and misses among them),
    and go with the loader's other collectors at exit."""
    url = _write_dataset(tmp_path)
    registry = MetricsRegistry()
    reader = make_batch_reader(url, num_epochs=1, workers_count=1,
                               reader_pool_type="dummy")
    with DataLoader(reader, 16, device="cpu", to_device=False, metrics=registry) as loader:
        list(loader)
        snap = registry.snapshot()
        io = reader.io_stats()
        for key in ("readahead_hits", "readahead_misses"):
            assert snap["ptpu_io_" + key] == io[key]
        assert snap["ptpu_io_readahead_hits"] > 0
    assert not any(k.startswith("ptpu_io_readahead") for k in registry.snapshot())


def test_remote_and_arena_counts_rise_on_the_registry(tmp_path):
    """The ranged-GET engine's counts and the arena's are the JAX package's
    ``ptpu_io_remote_*``/``ptpu_io_hedges_*``/``ptpu_io_arena_*`` families on the
    process-wide registry, and the shared latency model's histograms are
    ``ptpu_io_remote_get_seconds``."""
    from petastorm_tpu_torch.io import arena as arena_mod
    from petastorm_tpu_torch.io.latencyfs import CloudLatencyFS
    from petastorm_tpu_torch.obs.metrics import default_registry

    url = _write_dataset(tmp_path, files=2)
    snap0 = default_registry().snapshot()
    fs = CloudLatencyFS(pa.fs.LocalFileSystem(), seed=3, sleep=False)
    with make_batch_reader(url, num_epochs=1, workers_count=1, reader_pool_type="dummy",
                           filesystem=fs) as reader:
        rows = sum(len(b.id) for b in reader)
        gets = reader.io_stats()["remote_gets"]
    assert rows == 128 and gets > 0
    snap = default_registry().snapshot()
    assert snap["ptpu_io_remote_gets_total"] - snap0.get("ptpu_io_remote_gets_total",
                                                         0) == gets
    assert snap["ptpu_io_remote_bytes_total"] > snap0.get("ptpu_io_remote_bytes_total", 0)
    assert any(k.startswith("ptpu_io_remote_get_seconds{") for k in snap)
    hits0 = snap.get("ptpu_io_arena_hits_total", 0)
    arena_mod._bump("hits", 2)
    assert default_registry().snapshot()["ptpu_io_arena_hits_total"] == hits0 + 2


def test_every_actor_registers_its_heartbeat(tmp_path):
    """The producer, the transfer thread, each worker thread and each readahead IO
    thread heartbeat under the JAX package's names and roles."""
    url = _write_dataset(tmp_path, files=8, rows_per_file=32)
    # a results queue of one: the workers still have items when the loader attaches
    reader = make_batch_reader(url, num_epochs=1, workers_count=2, results_queue_size=1)
    with DataLoader(reader, 16, device="cpu", health=HealthOptions(
            stall_threshold_s=60.0, poll_interval_s=1.0,
            flight_path=str(tmp_path / "f.json"))) as loader:
        list(loader)
        roles = {h["actor"]: h["role"] for h in loader._health.heartbeats()}
    assert roles["loader.producer"] == "producer"
    assert roles["loader.transfer"] == "transfer"
    assert roles["worker.thread-0"] == roles["worker.thread-1"] == "worker"
    assert any(a.startswith("io.") and r == "io" for a, r in roles.items()), roles


# -- a monitor attached while work is in flight ------------------------------------------


class _SlotOwner:
    _health = None


class _GatedMonitor(HealthMonitor):
    """Holds the attaching thread inside ``register`` until the case releases it."""

    def __init__(self):
        super().__init__(HealthOptions(stall_threshold_s=60.0))
        self.attacher = None
        self.entered = threading.Event()
        self.release = threading.Event()

    def register(self, name, role, threshold_s=None):
        hb = super().register(name, role, threshold_s)
        if threading.current_thread() is self.attacher:
            self.entered.set()
            assert self.release.wait(10.0)
        return hb


@pytest.mark.parametrize("busy,idle,end_state", [
    ("working", None, "results_put"),  # a pool's worker or child
    ("read", "idle", "idle"),  # a readahead IO thread
])
def test_attach_racing_the_end_of_an_item_keeps_the_wait_state(busy, idle, end_state):
    """An actor that ends its item while a monitor attaches: the attach holds the
    slots' lock from its look at the item to its stamp, so the actor's end waits for
    it and the end's wait state is the one that stays, never a busy state stamped at
    the item's start."""
    owner = _SlotOwner()
    slots = ActorSlots(owner, "actor-%d", "worker", busy=busy, idle=idle)
    slots.begin(0)
    time.sleep(0.05)
    monitor = _GatedMonitor()
    owner._health = monitor
    attacher = threading.Thread(target=slots.attach, args=(monitor,))
    monitor.attacher = attacher
    attacher.start()
    assert monitor.entered.wait(10.0)
    ended = threading.Event()

    def actor():
        slots.end(0, end_state)
        ended.set()

    ender = threading.Thread(target=actor)
    ender.start()
    assert not ended.wait(0.2)  # held until the attach has stamped its busy state
    monitor.release.set()
    attacher.join(10.0)
    ender.join(10.0)
    assert ended.is_set()
    (hb,) = monitor.heartbeats()
    assert hb["actor"] == "actor-0" and hb["state"] == "wait:" + end_state, hb
    assert hb["age_s"] < 0.05, hb


def test_attach_watches_only_work_still_in_flight_and_leaves_registered_actors():
    """An item in flight is busy since its start; an actor between items is not
    registered (or parked in the idle state, where one is given); an actor that
    already has its heartbeat on the monitor is left to stamp it itself."""
    owner = _SlotOwner()
    slots = ActorSlots(owner, "actor-%d", "worker")
    slots.begin(0)
    slots.begin(1)
    slots.end(1, "results_put")
    time.sleep(0.05)
    monitor = HealthMonitor(HealthOptions(stall_threshold_s=60.0))
    owner._health = monitor
    slots.attach(monitor)
    (hb,) = monitor.heartbeats()
    assert hb["actor"] == "actor-0" and hb["state"] == "working", hb
    assert hb["age_s"] >= 0.05, hb
    ended = slots.end(0, "results_put")
    slots.attach(monitor)
    assert ended.state == "wait:results_put"
    io_owner = _SlotOwner()
    io_slots = ActorSlots(io_owner, "io.%s", "io", busy="read", idle="idle")
    io_slots.begin("t0")
    io_slots.end("t0", "idle")
    io_owner._health = monitor
    io_slots.attach(monitor)
    states = {h["actor"]: h["state"] for h in monitor.heartbeats()}
    assert states == {"actor-0": "wait:results_put", "io.t0": "wait:idle"}, states
    io_slots.retire("t0")
    assert {h["actor"]: h["state"] for h in monitor.heartbeats()}["io.t0"] == "done"


def test_attach_under_thread_churn_leaves_every_finished_actor_waiting():
    """Stress: more actor threads than cores work items (one slot an item) while
    monitors attach over and over, with a short switch interval. Once every item has
    ended, each slot the last monitor watches is in its wait state."""
    owner = _SlotOwner()
    slots = ActorSlots(owner, "actor-%d", "worker")
    n_actors, n_items = max(16, 2 * (os.cpu_count() or 1)), 200
    halfway = threading.Event()

    def actor(idx):
        for j in range(n_items):
            if j == n_items // 2:
                halfway.set()
            slots.begin(idx * n_items + j)
            slots.end(idx * n_items + j, "results_put")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        actors = [threading.Thread(target=actor, args=(i,)) for i in range(n_actors)]
        for t in actors:
            t.start()
        attaches = 0
        while not attaches or not halfway.is_set():  # the last lands while items run
            monitor = HealthMonitor(HealthOptions(stall_threshold_s=60.0))
            owner._health = monitor
            slots.attach(monitor)
            attaches += 1
        for t in actors:
            t.join(60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in actors)
    states = [h["state"] for h in owner._health.heartbeats()]
    assert states and all(st == "wait:results_put" for st in states), sorted(set(states))


def test_shared_monitor_not_stopped_by_loader_exit(tmp_path):
    url = _write_dataset(tmp_path, files=1)
    with HealthMonitor(HealthOptions(stall_threshold_s=60.0, poll_interval_s=0.5,
                                     flight_path=str(tmp_path / "f.json"))) as shared:
        reader = make_batch_reader(url, num_epochs=1, workers_count=1)
        with DataLoader(reader, 16, device="cpu", to_device=False, health=shared):
            pass
        reader = make_batch_reader(url, num_epochs=1, workers_count=1)
        with DataLoader(reader, 16, device="cpu", to_device=False, health=shared) as loader:
            list(loader)
            producers = [h["actor"] for h in shared.heartbeats()
                         if h["actor"].endswith("loader.producer")]
            assert producers and all("/" in a for a in producers), producers
        assert shared._watchdog is not None and shared._watchdog.is_alive()
        assert shared.heartbeats() == [], shared.heartbeats()
        assert shared.worker_latency() == {}


def test_undelivered_stall_error_not_wiped_by_reiteration(tmp_path):
    """A fail-fast while no consumer iterates surfaces at the next iteration."""
    url = _write_dataset(tmp_path, files=1)
    reader = make_batch_reader(url, num_epochs=1, workers_count=1)
    with DataLoader(reader, 16, device="cpu", to_device=False, health=HealthOptions(
            stall_threshold_s=60.0, poll_interval_s=0.5, escalation="raise")) as loader:
        loader._fail_fast(StallError("pipeline stalled before iteration"))
        with pytest.raises(StallError, match="before iteration"):
            for _ in loader:
                pass


def test_process_pool_stack_provider_follows_monitor():
    """Re-attaching health moves the child-stack provider and the healer."""
    from petastorm_tpu_torch.workers import ProcessExecutor

    with ProcessExecutor(workers_count=1) as ex:
        a = HealthMonitor(HealthOptions(poll_interval_s=60.0))
        b = HealthMonitor(HealthOptions(poll_interval_s=60.0))
        ex.set_health(a)
        assert len(a._stack_providers) == 1 and len(a._healers) == 1
        ex.set_health(b)
        assert len(a._stack_providers) == 0 and len(a._healers) == 0
        assert len(b._stack_providers) == 1 and len(b._healers) == 1
        ex.set_health(None)
        assert len(b._stack_providers) == 0 and len(b._healers) == 0


def test_shared_monitor_scopes_isolate_pipelines(tmp_path):
    monitor = HealthMonitor(HealthOptions(stall_threshold_s=0.05, poll_interval_s=60.0,
                                          escalation="raise",
                                          flight_path=str(tmp_path / "f.json")))
    a = monitor.scoped("pipeA")
    b = monitor.scoped("pipeB")
    hb_a = a.register("loader.producer", "producer")
    hb_b = b.register("loader.producer", "producer")
    assert hb_a is not hb_b
    a.observe_worker(0, 0.5)
    b.observe_worker(0, 0.001)
    assert list(a.worker_latency()) == ["0"]
    assert a.worker_latency()["0"]["mean"] == pytest.approx(0.5)
    assert b.worker_latency()["0"]["mean"] == pytest.approx(0.001)
    fired = []
    monitor.add_stall_callback(lambda e: fired.append("A"), prefix="pipeA")
    monitor.add_stall_callback(lambda e: fired.append("B"), prefix="pipeB")
    monitor.add_stall_callback(lambda e: fired.append("*"))
    hb_a.beat("working")
    hb_b.wait("host_queue_put")
    time.sleep(0.1)
    stalled = monitor.check_stalls()
    assert [s["actor"] for s in stalled] == ["pipeA/loader.producer"]
    monitor._handle_stall(stalled)
    assert sorted(fired) == ["*", "A"]


# -- the child stack dump ------------------------------------------------------------------


def test_stack_dump_signals_only_the_pools_own_children():
    """SIGUSR1 goes to this pool's live children only: the dump's keys are exactly
    their pids, this process keeps its own SIGUSR1 disposition, and a second capture
    returns only what was written after its own signal."""
    from _torch_pool_helpers import slow_payload_worker
    from petastorm_tpu_torch.plan import EpochPlan
    from petastorm_tpu_torch.workers import ProcessExecutor

    before = signal.getsignal(signal.SIGUSR1)
    with ProcessExecutor(workers_count=2, results_timeout_s=60) as ex:
        ex.start(slow_payload_worker, EpochPlan(list(range(40)), num_epochs=1))
        results = ex.results()
        next(results)  # both children are up and working
        pids = ex.child_pids()
        first = ex._dump_child_stacks()
        second = ex._dump_child_stacks()
        ex.stop()
    assert set(first) == set(second) == {"child-%d" % p for p in pids}
    for text in list(first.values()) + list(second.values()):
        assert "Thread" in text or "thread" in text, text
        assert "<truncated" not in text
    assert signal.getsignal(signal.SIGUSR1) == before


def test_stack_dump_reports_a_silent_child_without_waiting_on_it(tmp_path):
    """A child that does not answer SIGUSR1 is reported as such after about 2 s."""
    from petastorm_tpu_torch.workers import ProcessExecutor

    silent = subprocess.Popen([sys.executable, "-c",
                               "import signal, time; signal.signal(signal.SIGUSR1, "
                               "signal.SIG_IGN); print('ready', flush=True); "
                               "time.sleep(30)"], stdout=subprocess.PIPE)
    with ProcessExecutor(workers_count=1) as ex:
        try:
            assert silent.stdout.readline().strip() == b"ready"
            ex._procs = [silent]
            ex._tmpdir = str(tmp_path)
            t0 = time.monotonic()
            out = ex._dump_child_stacks()
            took = time.monotonic() - t0
        finally:
            silent.kill()
            silent.wait()
            silent.stdout.close()
            ex._procs = []
            ex._tmpdir = None
    assert out == {"child-%d" % silent.pid: "<no faulthandler dump within 2s>"}
    assert 1.5 < took < 5.0, took


def test_pool_child_warms_the_read_before_its_first_item(tmp_path):
    """A child pays the reader worker's first-use import (pyarrow's first ``to_numpy``
    imports pandas, seconds on a busy host) before it acknowledges the pool, so its
    first item, which its heartbeat times from the send, holds no import: a cold child
    is not healed as a hung one at a low child threshold."""
    from _torch_pool_helpers import FirstItemProbe
    from petastorm_tpu_torch.plan import EpochPlan
    from petastorm_tpu_torch.reader import _Tagged
    from petastorm_tpu_torch.workers import ProcessExecutor

    url = _write_dataset(tmp_path, files=1)
    with make_batch_reader(url, reader_pool_type="dummy") as reader:
        piece = reader._plan._items[0]
        # the reader's own wrapper of its worker, as its pool's children get it
        worker = FirstItemProbe(_Tagged(reader._worker))
        with ProcessExecutor(workers_count=1, results_queue_size=2,
                             results_timeout_s=120) as ex:
            ex.start(worker, EpochPlan([(0, 0, piece)], num_epochs=1))
            (result,) = list(ex.results())
    assert result[2]["pandas_before_item"].tolist() == [True]


def test_child_pings_stamp_its_heartbeat(tmp_path, monkeypatch):
    """An idle child pings every PTPU_CHILD_PING_S seconds; the feeder drains the pings
    into the child's heartbeat before each result header."""
    from petastorm_tpu_torch.workers import ProcessExecutor

    monkeypatch.setenv("PTPU_CHILD_PING_S", "0.1")
    sent = []

    class _Conn:
        def __init__(self, msgs):
            self._msgs = list(msgs)

        def poll(self, timeout):
            return True

        def recv(self):
            return self._msgs.pop(0)

    class _Hb:
        def beat(self, state="working"):
            sent.append(state)

    class _Monitor:
        def register(self, name, role):
            assert (name, role) == ("worker.child-0", "child")
            return _Hb()

    with ProcessExecutor(workers_count=1) as ex:
        assert ex._ping_interval_s == 0.1
        ex._health = _Monitor()
        header = ex._recv_result(_Conn([("hb", 1.0), ("hb", 2.0), ("ok", 0, 0)]), 0)
        ex._health = None
    assert header == ("ok", 0, 0) and sent == ["working", "working"]


# -- the Reporter's crash flush ------------------------------------------------------------


def _run_port_script(code):
    env = {k: v for k, v in os.environ.items() if k != "PTPU_CHAOS_SPEC"}
    env["PYTHONPATH"] = REPO_ROOT
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO_ROOT, env=env, timeout=120)


def test_reporter_flushes_on_unhandled_exception(tmp_path):
    jsonl = str(tmp_path / "crash.jsonl")
    proc = _run_port_script(
        "from petastorm_tpu_torch.obs.metrics import default_registry\n"
        "from petastorm_tpu_torch.obs.export import Reporter\n"
        "default_registry().counter('ptpu_crash_probe_total').inc(7)\n"
        "Reporter(interval_s=3600.0, jsonl_path=%r).start()\n"
        "raise RuntimeError('mid-interval death')\n" % jsonl)
    assert proc.returncode != 0 and "mid-interval death" in proc.stderr
    with open(jsonl) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    assert lines and lines[-1]["metrics"]["ptpu_crash_probe_total"] == 7


def test_reporter_flushes_on_clean_exit_without_stop(tmp_path):
    jsonl = str(tmp_path / "atexit.jsonl")
    proc = _run_port_script(
        "from petastorm_tpu_torch.obs.metrics import default_registry\n"
        "from petastorm_tpu_torch.obs.export import Reporter\n"
        "default_registry().counter('ptpu_atexit_probe_total').inc(3)\n"
        "Reporter(interval_s=3600.0, jsonl_path=%r).start()\n" % jsonl)
    assert proc.returncode == 0, proc.stderr
    with open(jsonl) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    assert lines and lines[-1]["metrics"]["ptpu_atexit_probe_total"] == 3


# -- on the card ------------------------------------------------------------------------------


def _write_pagedec_store(root):
    """Two snappy files of compressible fixed-width columns: the pass-through ships
    them (repeated float32 and low-cardinality int64)."""
    root.mkdir()
    for i in range(2):
        pq.write_table(pa.table({"v": np.repeat(np.arange(64, dtype=np.float32), 64),
                                 "c": np.repeat(np.arange(16, dtype=np.int64), 256)}),
                       str(root / ("t%d.parquet" % i)), row_group_size=4096,
                       compression="snappy")
    return "file://" + str(root)


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_transfer_thread_heartbeats_around_the_kernels_on_the_card(tmp_path):
    """On the card the transfer thread heartbeats (decode through the inflate's read
    back, h2d through the upload) and a clean epoch at a 5 s threshold counts 0
    stalls."""
    url = _write_pagedec_store(tmp_path / "tab")
    reader = make_batch_reader(url, num_epochs=1, workers_count=1,
                               io_options={"pagedec": "on"})
    with DataLoader(reader, 4096, health=HealthOptions(
            stall_threshold_s=5.0, poll_interval_s=0.25, escalation="raise",
            flight_path=str(tmp_path / "f.json"))) as loader:
        for _ in loader:
            pass
        assert loader._health.stall_count == 0
        roles = {h["actor"]: h["role"] for h in loader._health.heartbeats()}
    assert roles["loader.transfer"] == "transfer"
    assert not os.path.exists(str(tmp_path / "f.json"))


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_phase_14_launches_equal_with_and_without_health_on_the_card(tmp_path):
    """The pass-through's K3, scan and K4 launch once a batch with health and time
    series on, as without."""
    from petastorm_tpu_torch.ops import pagedec_kernels as pk

    url = _write_pagedec_store(tmp_path / "tab")
    counts = []
    for health in (None, HealthOptions(stall_threshold_s=5.0, poll_interval_s=0.25)):
        pk.snappy_inflate_ragged.launches = 0
        reader = make_batch_reader(url, num_epochs=1, workers_count=1,
                                   io_options={"pagedec": "on"})
        with DataLoader(reader, 4096, health=health, metrics=MetricsRegistry()) as loader:
            n = sum(1 for _ in loader)
        counts.append((n, pk.snappy_inflate_ragged.launches))
    assert counts[0] == counts[1] and counts[0][1] == counts[0][0]
