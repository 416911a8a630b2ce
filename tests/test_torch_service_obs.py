"""The port's fleet observability plane against the JAX package's tests of it, on the
CPU, under the same names: provenance across the wire absorbed once beside the
quarantine ledger, worker metrics on a private registry, the /fleet view's merge on
anchored clocks, the per-worker SLO debounce, ordered (head-of-line) delivery, and the
wakeable transport poll."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments, no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from petastorm_tpu_torch.recovery import RecoveryOptions  # noqa: E402
from petastorm_tpu_torch.service import (DataService, DecodeWorker,  # noqa: E402
                                         JobSpec, ServiceOptions, ServiceReader)
from petastorm_tpu_torch.service.protocol import svc_worker_metrics  # noqa: E402
from petastorm_tpu_torch.unischema import Unischema, UnischemaField  # noqa: E402

SCHEMA = Unischema("t", [UnischemaField("x", np.int64, (), None, False)])


def _fast_links():
    return RecoveryOptions(link_heartbeat_s=0.1, link_miss_threshold=3,
                           link_reconnect_s=5.0, link_connect_timeout_s=5.0,
                           io_retry_backoff_s=0.01)


def decode_x10(item):
    return {"x": np.arange(4, dtype=np.int64) + item * 10}


def decode_poison2(item):
    if item == 2:
        raise FileNotFoundError("row group gone")
    return {"x": np.full(2, item, dtype=np.int64)}


def decode_staggered(item):
    # every third item decodes slow: with two workers racing, completion
    # order scrambles unless the reader re-sequences
    if item % 3 == 0:
        time.sleep(0.02)
    return {"x": np.full(2, item, dtype=np.int64)}


def _service(n_items, decode, workers=1, rec=None, job="j", **spec_kwargs):
    rec = rec or _fast_links()
    svc = DataService(options=ServiceOptions(arena=False), recovery=rec)
    svc.add_job(JobSpec(job, list(range(n_items)), decode, SCHEMA,
                        **spec_kwargs))
    fleet = [DecodeWorker(svc.worker_address(), svc.token, recovery=rec)
             for _ in range(workers)]
    return svc, fleet, rec


def _drain(reader, timeout_s=30.0):
    got = []
    deadline = time.monotonic() + timeout_s
    for batch in reader:
        got.append(int(batch.x[0]))
        assert time.monotonic() < deadline, "reader drain timed out"
    return got


# -- worker metric homing ----------------------------------------------------------------


def test_worker_metrics_home_on_private_registry():
    """A DecodeWorker handed its own registry must count there — not on the
    process default (first-touch memoization inside the serve loop would race
    private-registry workers)."""
    default_before = {k: v.value for k, v in svc_worker_metrics().items()}
    private = MetricsRegistry()
    rec = _fast_links()
    svc, _, _ = _service(4, decode_x10, workers=0, rec=rec)
    worker = DecodeWorker(svc.worker_address(), svc.token, recovery=rec,
                          registry=private)
    worker.start()
    reader = ServiceReader(svc.trainer_address(), svc.token, job="j",
                           recovery=rec, arena=False)
    assert sorted(v // 10 for v in _drain(reader)) == list(range(4))
    reader.stop()
    svc.stop()
    snap = private.snapshot()
    assert snap["ptpu_svc_worker_decodes_total"] == 4
    assert snap["ptpu_svc_worker_decode_seconds_total"] >= 0.0
    default_after = {k: v.value for k, v in svc_worker_metrics().items()}
    assert default_after["decodes"] == default_before["decodes"]


# -- /fleet merge on anchored clocks -----------------------------------------------------


class _StubService:
    def worker_health(self):
        return {}

    def advice(self):
        return None

    def straggler_alerts(self):
        return []


def test_fleet_document_merges_clock_skewed_worker_exports():
    """Two workers whose wall clocks disagree by minutes still merge into
    exact fleet totals: each export carries its own (wall, perf) anchor and
    the aggregator sums anchored snapshots, never wall-ordered ones."""
    from petastorm_tpu_torch.obs.timeseries import export_document
    from petastorm_tpu_torch.service.telemetry import FleetTelemetry

    reg_a, reg_b, reg_svc = (MetricsRegistry() for _ in range(3))
    # worker b's wall clock runs 5 minutes ahead (NTP step / bad host clock)
    reg_b.timeline_store().anchor_wall += 300.0
    reg_a.counter("ptpu_demo_decodes_total", help="t").inc(3)
    reg_b.counter("ptpu_demo_decodes_total", help="t").inc(4)
    for reg in (reg_a, reg_b):
        reg.sample_timelines()
    doc_a = export_document(reg_a, extra={"source": "worker:a"})
    doc_b = export_document(reg_b, extra={"source": "worker:b"})
    t_a = doc_a["timelines"]["ptpu_demo_decodes_total"]["points"][0]["t"]
    t_b = doc_b["timelines"]["ptpu_demo_decodes_total"]["points"][0]["t"]
    assert abs(t_b - t_a) > 250.0  # the skew is real in the exports

    fleet = FleetTelemetry(_StubService(), reg_svc)
    fleet.note_peer("worker", "a", doc_a)
    fleet.note_peer("worker", "b", doc_b)
    doc = fleet.document()
    assert doc["schema"] == "ptpu-svc-fleet-v1"
    assert "worker:a" in doc["sources"] and "worker:b" in doc["sources"]
    assert any(s.startswith("service:") for s in doc["sources"])
    assert doc["fleet"]["totals"]["ptpu_demo_decodes_total"] == 7
    per_source = doc["fleet"]["per_source"]
    assert per_source["worker:a"]["ptpu_demo_decodes_total"] == 3
    assert per_source["worker:b"]["ptpu_demo_decodes_total"] == 4
    # telemetry is a level: a fresh document from the same peer replaces
    reg_b.counter("ptpu_demo_decodes_total", help="t").inc(1)
    fleet.note_peer("worker", "b",
                    export_document(reg_b, extra={"source": "worker:b"}))
    assert fleet.document()["fleet"]["totals"][
        "ptpu_demo_decodes_total"] == 8


# -- per-worker SLO debounce -------------------------------------------------------------


def test_slo_per_worker_expansion_debounces_independently():
    from petastorm_tpu_torch.obs.slo import SloEngine, SloSpec, strip_label

    assert strip_label('m{worker="w1"}', "worker") == ("m", "w1")
    assert strip_label("m", "worker") == ("m", None)

    spec = SloSpec(name="straggler", metric="ptpu_svc_worker_decode_seconds",
                   stat="p99", op="<=", threshold=0.05, breach_windows=2,
                   per_worker=True)
    engine = SloEngine(specs=[spec])
    s1 = 'ptpu_svc_worker_decode_seconds{worker="w1"}'
    s2 = 'ptpu_svc_worker_decode_seconds{worker="w2"}'
    window = lambda p1, p2: {s1: {"count": 8, "p99": p1},
                             s2: {"count": 8, "p99": p2}}
    assert engine.evaluate(window(0.2, 0.01), t=1.0) == []  # streak 1
    assert engine.breaching() == {'straggler{worker="w1"}': 1}
    alerts = engine.evaluate(window(0.2, 0.01), t=2.0)
    assert len(alerts) == 1
    assert alerts[0].worker == "w1" and alerts[0].cause == "slo_breach"
    assert "by worker 'w1'" in alerts[0].message
    # latched: a third breaching window must not re-fire
    assert engine.evaluate(window(0.2, 0.01), t=3.0) == []
    # the other worker's debounce is independent — it fires on its own streak
    assert engine.evaluate(window(0.2, 0.3), t=4.0) == []
    w2_alerts = engine.evaluate(window(0.2, 0.3), t=5.0)
    assert [a.worker for a in w2_alerts] == ["w2"]


# -- cross-wire provenance exactly-once --------------------------------------------------


def test_cross_wire_spans_exactly_once_beside_quarantine_ledger():
    """Every delivered item absorbs exactly one decode + wire + lease-wait
    span; the poisoned item lands in the trainer's quarantine ledger (never
    the delivery FIFO); and no lease leaks across the fault."""
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.service.protocol import svc_metrics

    leaked_before = svc_metrics()["lease_leaked"].value
    svc, fleet, rec = _service(5, decode_poison2, workers=2)
    for w in fleet:
        w.start()
    reader = ServiceReader(svc.trainer_address(), svc.token, job="j",
                           recovery=rec, arena=False)
    loader = DataLoader(reader, batch_size=2, to_device=False,
                        provenance=True, device="cpu")
    tags = set()
    with loader:
        for batch in loader:
            tags.update(int(v) for v in np.asarray(batch["x"]))
        prov = loader.provenance
        items = prov.items()
        quarantined = prov.quarantined()
    assert svc.outstanding_leases() == 0
    svc.stop()
    assert tags == {0, 1, 3, 4}
    delivered = {d["ordinal"]: d for d in items.values()
                 if (d.get("annotations") or {}).get("quarantined") is None}
    assert sorted(delivered) == [0, 1, 3, 4]
    for ordinal, d in delivered.items():
        sites = [s["site"] for s in d["spans"]]
        assert sum(1 for s in sites if s.startswith("svc.decode@")) == 1, \
            (ordinal, sites)
        assert sites.count("svc.wire") == 1, (ordinal, sites)
        assert sites.count("svc.lease_wait") == 1, (ordinal, sites)
        assert d["annotations"].get("svc_worker") in {w.name for w in fleet}
    # the quarantine ledger's trainer-side twin: exactly one entry, with the
    # service's attempt count, and the item never got delivery spans
    assert [(e, o) for e, o, _a, _c in quarantined] == [(0, 2)]
    assert quarantined[0][2] >= 1
    assert svc_metrics()["lease_leaked"].value == leaked_before


# -- ordered (head-of-line) delivery -----------------------------------------------------


def test_ordered_reader_delivers_plan_order():
    svc, fleet, rec = _service(12, decode_staggered, workers=2)
    for w in fleet:
        w.start()
    reader = ServiceReader(svc.trainer_address(), svc.token, job="j",
                           recovery=rec, arena=False, ordered=True)
    got = _drain(reader)
    reader.stop()
    assert svc.outstanding_leases() == 0
    svc.stop()
    # exact plan order, not completion order
    assert got == list(range(12))


def test_ordered_reader_quarantine_keeps_order():
    svc, fleet, rec = _service(6, decode_poison2, workers=2)
    for w in fleet:
        w.start()
    reader = ServiceReader(svc.trainer_address(), svc.token, job="j",
                           recovery=rec, arena=False, ordered=True)
    got = _drain(reader)
    assert got == [0, 1, 3, 4, 5]  # the poisoned ordinal is skipped in place
    assert set(reader.quarantined) == {(0, 2)}
    reader.stop()
    svc.stop()


def test_ordered_reader_resumes_watermark_exact():
    svc, fleet, rec = _service(8, decode_staggered, workers=2)
    for w in fleet:
        w.start()
    r1 = ServiceReader(svc.trainer_address(), svc.token, job="j",
                       recovery=rec, arena=False, ordered=True)
    first = [int(next(r1).x[0]) for _ in range(3)]
    assert first == [0, 1, 2]  # ordered mode: the prefix is deterministic
    state = r1.state_dict()
    r1.stop()
    r2 = ServiceReader(svc.trainer_address(), svc.token, job="j",
                       recovery=rec, arena=False, ordered=True)
    r2.load_state_dict(state)
    rest = _drain(r2)
    r2.stop()
    svc.stop()
    assert rest == [3, 4, 5, 6, 7]  # no loss, no replay, still in order


# -- wakeable transport poll -------------------------------------------------------------


def _loopback_link(rec=None):
    from petastorm_tpu_torch.transport.tcp import TcpHub, connect_child_tcp

    rec = rec or _fast_links()
    hub = TcpHub(rec)
    parent = hub.create_session(0)
    child = connect_child_tcp(hub.address_for(0), bytes.fromhex(hub.token))
    assert parent.wait_connected(5.0)
    parent.mark_ready()
    child.mark_ready()
    return hub, parent, child


def test_wakeable_poll_returns_on_wake_without_a_frame():
    """wake() ends a wakeable poll early (False, nothing consumed) — the
    mechanism the service's serve loop uses to flush a just-completed item
    instead of waiting out the poll tick."""
    hub, parent, child = _loopback_link()
    try:
        out = {}

        def _poll():
            t0 = time.perf_counter()
            out["res"] = child.poll(5.0, wakeable=True)
            out["s"] = time.perf_counter() - t0

        t = threading.Thread(target=_poll)
        t.start()
        time.sleep(0.2)
        child.wake()
        t.join(timeout=5.0)
        assert not t.is_alive()
        assert out["res"] is False  # woken, no frame to consume
        assert out["s"] < 2.0, out  # did not wait out the 5s timeout
        # the link still carries frames normally after a wake
        parent.send({"n": 1})
        assert child.poll(2.0, wakeable=True)
        assert child.recv() == {"n": 1}
        # wake with no waiter is a no-op the next poll absorbs quickly
        child.wake()
        assert child.poll(0.2) is False
    finally:
        child.close()
        parent.close()
        hub.close()
