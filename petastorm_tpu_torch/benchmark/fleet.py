"""``petastorm-tpu-torch-bench fleet``: one decode fleet feeding many trainers —
does disaggregation actually cut decode work, and does it stay exact?

**The acceptance harness for the disaggregated data service.**
Scenarios (``--scenarios`` selects a subset; default runs the first three):

- ``shared``: 3 trainers attached to ONE service/fleet vs 3 dedicated
  pipelines decoding the same plan independently. The decode cost is a
  calibrated synthetic sleep, so decode worker-seconds are deterministic;
  the harness asserts the shared fleet's decode worker-seconds **per
  delivered row** are cut >=2x (decode-once/serve-many), that every trainer
  received the full plan exactly once (delivered sets duplicate-free and
  identical), and that zero leases leaked in either arm.
- ``elasticity``: a trainer detaches mid-epoch (``state_dict()`` +
  ``stop()``); a replacement attaches with ``load_state_dict`` and must
  receive EXACTLY the remaining plan — no loss, no replay, the
  checkpoint-watermark contract over the wire.
- ``qos``: two tenants share the fleet; the noisy one runs a slow decode.
  The per-tenant accounting plane must name it: ``TenantUsageReport`` shows the
  noisy tenant as the top worker-seconds consumer, and a per-tenant burn
  SLO (``SloSpec(per_tenant=True)``) fires an alert naming the noisy tenant
  while the quiet tenant never alerts.
- ``linkdeath``: a seeded ``chaos`` ``net.reset`` is armed on
  ``transport.send`` during dispatch. Whichever link it kills (worker or
  trainer), the run must stay exact: delivered == plan, ZERO quarantined
  items (link faults re-dispatch, they do not poison), zero leaked leases,
  and at least one observed reconnect.
- ``attribution``: the fleet-observability acceptance arm. Latency
  is injected into ONE of two decode workers for a bounded window; every
  layer must name that worker: the trainer's cross-wire provenance fold
  (``attribution_report().slow_top`` == ``svc.decode@<worker>``), the
  ``/fleet`` straggler alert scraped live during the drain, and the
  FleetAdvisor (``ptpu_svc_advised_workers`` rises above the actual fleet
  size during the injection and returns once it clears). Exactness and
  zero leaked leases still hold with provenance riding every frame.
- ``provoverhead``: the same 2-worker drain with the cross-wire provenance
  plane fully off vs fully on; wall-clock overhead must stay under the CI
  ceiling (20% — the paper target is <=1%, but CI hosts are noisy).

The last stdout line is a one-line JSON summary for bench artifacts.

Port of ``petastorm_tpu.benchmark.fleet``: the loaders of the ``attribution`` and
``provoverhead`` arms take ``--device`` (default ``cuda``) and deliver host batches.
"""
from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np

from petastorm_tpu_torch.benchmark import add_device_argument, require_device

from petastorm_tpu_torch.recovery import RecoveryOptions
from petastorm_tpu_torch.service import (
    DataService,
    DecodeWorker,
    JobSpec,
    ServiceOptions,
    ServiceReader,
)
from petastorm_tpu_torch.service.protocol import svc_metrics
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

QUIET = "a-quiet"
NOISY = "b-noisy"

SCHEMA = Unischema("fleet", [UnischemaField("id", np.int64, (), None, False)])

#: rows each synthetic decode yields (the per-row denominator below)
ROWS_PER_ITEM = 8
#: synthetic decode cost — sleeps dominate, so worker-seconds are a property
#: of the PLAN (items x cost), not of host speed: the shared-vs-dedicated
#: ratio is deterministic
DECODE_COST_S = 0.004
NOISY_COST_S = 0.04
_BURN_BUDGET_S = 0.05
_SAMPLE_S = 0.25


def _rec():
    return RecoveryOptions(link_heartbeat_s=0.1, link_miss_threshold=3,
                           link_reconnect_s=8.0, link_connect_timeout_s=5.0,
                           io_retry_backoff_s=0.01)


def decode_shared(item):
    time.sleep(DECODE_COST_S)
    return {"id": np.arange(ROWS_PER_ITEM, dtype=np.int64)
            + item * ROWS_PER_ITEM}


def decode_quiet(item):
    time.sleep(0.001)
    return {"id": np.full(ROWS_PER_ITEM, item, dtype=np.int64)}


def decode_noisy(item):
    time.sleep(NOISY_COST_S)
    return {"id": np.full(ROWS_PER_ITEM, item, dtype=np.int64)}


SLOW_WORKER = "w-slow"
FAST_WORKER = "w-fast"
ATTR_COST_S = 0.01
ATTR_LAG_S = 0.05
#: gate for the injected straggler: ``decode_attr`` lags ONLY on the thread
#: named ``ptpu-w-slow`` (``DecodeWorker.start`` names its thread after the
#: worker) and only until this monotonic deadline — armed by the scenario
_ATTR_LAG_UNTIL = [0.0]


def decode_attr(item):
    time.sleep(ATTR_COST_S)
    if (threading.current_thread().name == "ptpu-%s" % SLOW_WORKER
            and time.monotonic() < _ATTR_LAG_UNTIL[0]):
        time.sleep(ATTR_LAG_S)
    return {"id": np.arange(ROWS_PER_ITEM, dtype=np.int64)
            + item * ROWS_PER_ITEM}


def _svc_snapshot():
    return {k: v.value for k, v in svc_metrics().items()}


def _svc_delta(before, key):
    return svc_metrics()[key].value - before[key]


def _drain(reader, out, key):
    """Thread target: drain one trainer, collecting delivered item ids."""
    items = []
    try:
        for batch in reader:
            items.append(int(batch.id[0]) // ROWS_PER_ITEM
                         if key == "tagged" else int(batch.id[0]))
    except Exception as e:  # noqa: BLE001 — surfaced as a bench failure
        out["error"] = repr(e)
    out["items"] = items


def _exactness(name, items, plan, failures):
    """delivered must be the plan exactly once: duplicate-free and total."""
    if len(items) != len(set(items)):
        failures.append("%s: %d duplicate deliveries"
                        % (name, len(items) - len(set(items))))
    if sorted(set(items)) != sorted(plan):
        missing = set(plan) - set(items)
        extra = set(items) - set(plan)
        failures.append("%s: delivered != plan (missing %s, extra %s)"
                        % (name, sorted(missing)[:8], sorted(extra)[:8]))


def _run_fleet(n_items, n_trainers, n_workers, decode, rec):
    """One service, ``n_trainers`` attached BEFORE the fleet starts (the
    steady-state shape: decode-once fans out to everybody). Returns
    ``(per-trainer item lists, decode worker-seconds, failures)``."""
    failures = []
    before = _svc_snapshot()
    svc = DataService(options=ServiceOptions(arena=False), recovery=rec)
    svc.add_job(JobSpec("fleet", list(range(n_items)), decode, SCHEMA))
    readers = [ServiceReader(svc.trainer_address(), svc.token, job="fleet",
                             trainer="t%d" % i, recovery=rec, arena=False)
               for i in range(n_trainers)]
    fleet = [DecodeWorker(svc.worker_address(), svc.token, recovery=rec)
             for _ in range(n_workers)]
    for w in fleet:
        w.start()
    outs = [{} for _ in readers]
    threads = [threading.Thread(target=_drain, args=(r, out, "tagged"))
               for r, out in zip(readers, outs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for i, out in enumerate(outs):
        if "error" in out:
            failures.append("trainer %d drain died: %s" % (i, out["error"]))
        _exactness("trainer %d" % i, out.get("items", []),
                   range(n_items), failures)
    leases = svc.outstanding_leases()
    if leases:
        failures.append("%d leases outstanding after full drain" % leases)
    for r in readers:
        r.stop()
    svc.stop()
    if _svc_delta(before, "lease_leaked"):
        failures.append("%d leases leaked at service stop"
                        % _svc_delta(before, "lease_leaked"))
    return ([out.get("items", []) for out in outs],
            _svc_delta(before, "decode_seconds"), failures)


def scenario_shared(smoke, device=None):
    """3 trainers on one fleet vs 3 dedicated pipelines: decode
    worker-seconds per delivered row must drop >=2x."""
    failures = []
    n_items = 12 if smoke else 32
    rec = _rec()

    _sets, shared_ws, f = _run_fleet(n_items, 3, 2, decode_shared, rec)
    failures.extend("shared arm: %s" % x for x in f)
    shared_rows = 3 * n_items * ROWS_PER_ITEM

    dedicated_ws = 0.0
    dedicated_rows = 0
    for i in range(3):
        _s, ws, f = _run_fleet(n_items, 1, 2, decode_shared, rec)
        failures.extend("dedicated pipeline %d: %s" % (i, x) for x in f)
        dedicated_ws += ws
        dedicated_rows += n_items * ROWS_PER_ITEM

    shared_per_row = shared_ws / max(1, shared_rows)
    dedicated_per_row = dedicated_ws / max(1, dedicated_rows)
    cut = dedicated_per_row / max(shared_per_row, 1e-12)
    if cut < 2.0:
        failures.append(
            "decode worker-seconds per delivered row cut only %.2fx "
            "(shared %.6fs/row vs dedicated %.6fs/row) — acceptance "
            "needs >=2x" % (cut, shared_per_row, dedicated_per_row))
    return {
        "items": n_items,
        "shared_decode_s": round(shared_ws, 4),
        "dedicated_decode_s": round(dedicated_ws, 4),
        "worker_s_per_row_cut": round(cut, 2),
        "ok": not failures,
    }, failures


def scenario_elasticity(smoke, device=None):
    """Mid-epoch detach + reattach: the presented consumed-watermark is the
    ONLY resume authority, and it must be exact."""
    failures = []
    n_items = 12 if smoke else 24
    take = n_items // 3
    rec = _rec()
    svc = DataService(options=ServiceOptions(arena=False), recovery=rec)
    svc.add_job(JobSpec("fleet", list(range(n_items)), decode_shared, SCHEMA))
    worker = DecodeWorker(svc.worker_address(), svc.token, recovery=rec)
    worker.start()

    r1 = ServiceReader(svc.trainer_address(), svc.token, job="fleet",
                       trainer="elastic", recovery=rec, arena=False)
    first = [int(next(r1).id[0]) // ROWS_PER_ITEM for _ in range(take)]
    state = r1.state_dict()
    r1.stop()  # mid-epoch detach: unconsumed claims return, nothing lost

    r2 = ServiceReader(svc.trainer_address(), svc.token, job="fleet",
                       trainer="elastic", recovery=rec, arena=False)
    r2.load_state_dict(state)
    out = {}
    _drain(r2, out, "tagged")
    rest = out.get("items", [])
    r2.stop()
    leases = svc.outstanding_leases()
    svc.stop()

    if "error" in out:
        failures.append("reattached trainer died: %s" % out["error"])
    if set(first) & set(rest):
        failures.append("replayed after reattach: %s"
                        % sorted(set(first) & set(rest)))
    _exactness("detach+reattach union", first + rest, range(n_items),
               failures)
    if leases:
        failures.append("%d leases outstanding after reattach drain" % leases)
    return {"items": n_items, "before_detach": len(first),
            "after_reattach": len(rest), "ok": not failures}, failures


def scenario_qos(smoke, device=None):
    """Two tenants, one fleet: the accounting plane must name the noisy
    neighbor — usage report AND a per-tenant burn alert."""
    from petastorm_tpu_torch.obs import tenant as tenant_mod
    from petastorm_tpu_torch.obs.metrics import default_registry
    from petastorm_tpu_torch.obs.slo import SloEngine, SloSpec

    failures = []
    registry = default_registry()
    snap0 = registry.snapshot()
    rec = _rec()

    svc = DataService(options=ServiceOptions(arena=False), recovery=rec)
    svc.add_job(JobSpec("quiet", list(range(6)), decode_quiet, SCHEMA,
                        tenant=QUIET))
    # the noisy plan is sized so its drain spans several sample windows
    # (~0.25s each at 2 workers x 40ms/item): the burn SLO's 2-window
    # debounce needs consecutive breaching windows, not one spike
    svc.add_job(JobSpec("noisy", list(range(30 if smoke else 60)),
                        decode_noisy, SCHEMA, tenant=NOISY))

    spec = SloSpec(name="fleet-tenant-burn",
                   metric=tenant_mod.RESOURCES["worker_s"][0],
                   stat="delta", op="<=", threshold=_BURN_BUDGET_S,
                   breach_windows=2, per_tenant=True,
                   description="per-window decode worker-seconds budget "
                               "per tenant on the shared fleet")
    engine = SloEngine(specs=[spec], registry=registry)
    engine.attach(registry.timeline_store())

    rq = ServiceReader(svc.trainer_address(), svc.token, job="quiet",
                       recovery=rec, arena=False)
    rn = ServiceReader(svc.trainer_address(), svc.token, job="noisy",
                       recovery=rec, arena=False)
    workers = [DecodeWorker(svc.worker_address(), svc.token, recovery=rec)
               for _ in range(2)]
    for w in workers:
        w.start()
    out_q, out_n = {}, {}
    threads = [threading.Thread(target=_drain, args=(rq, out_q, "raw")),
               threading.Thread(target=_drain, args=(rn, out_n, "raw"))]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        time.sleep(_SAMPLE_S)
        registry.sample_timelines()
    for t in threads:
        t.join()
    registry.sample_timelines()
    rq.stop()
    rn.stop()
    svc.stop()

    report = tenant_mod.TenantUsageReport.from_metrics(
        {name: value - snap0.get(name, 0)
         for name, value in registry.snapshot().items()
         if isinstance(value, (int, float))
         and isinstance(snap0.get(name, 0), (int, float))})
    top, top_v = report.top_consumer("worker_s")
    if top != NOISY:
        failures.append("top worker-seconds consumer is %r (%.3fs), "
                        "expected %r" % (top, top_v, NOISY))
    svc_items = report.get(NOISY, "svc_items")
    if svc_items <= 0:
        failures.append("no ptpu_tenant_svc_items_total charged to %r"
                        % NOISY)

    breaches = [a for a in engine.alerts() if a.cause == "slo_breach"]
    noisy_alerts = [a for a in breaches if a.tenant == NOISY]
    quiet_alerts = [a for a in breaches if a.tenant == QUIET]
    if not noisy_alerts:
        failures.append("no per-tenant burn alert named %r (windows "
                        "evaluated: %d)" % (NOISY, engine.windows_evaluated))
    if quiet_alerts:
        failures.append("the quiet tenant %r fired %d burn alerts"
                        % (QUIET, len(quiet_alerts)))
    return {
        "top_worker_s": top,
        "noisy_worker_s": round(report.get(NOISY, "worker_s"), 4),
        "quiet_worker_s": round(report.get(QUIET, "worker_s"), 4),
        "alerts": [{"tenant": a.tenant, "value": a.value} for a in breaches],
        "ok": not failures,
    }, failures


def scenario_linkdeath(smoke, device=None):
    """Seeded chaos net.reset during dispatch: exactness must survive
    whichever link it kills."""
    from petastorm_tpu_torch import chaos
    from petastorm_tpu_torch.chaos import FaultPlan, FaultRule
    from petastorm_tpu_torch.obs.metrics import default_registry

    failures = []
    n_items = 12 if smoke else 24
    rec = _rec()
    before = _svc_snapshot()
    reconnects = default_registry().counter("ptpu_net_reconnects_total")
    reconnects0 = reconnects.value

    plan = FaultPlan([
        FaultRule("transport.send", "net.reset", nth=9, times=1),
    ], seed=7)
    svc = DataService(options=ServiceOptions(arena=False), recovery=rec)
    svc.add_job(JobSpec("fleet", list(range(n_items)), decode_shared, SCHEMA))
    reader = ServiceReader(svc.trainer_address(), svc.token, job="fleet",
                           recovery=rec, arena=False)
    worker = DecodeWorker(svc.worker_address(), svc.token, recovery=rec)
    out = {}
    chaos.arm(plan, propagate=False)
    try:
        worker.start()
        _drain(reader, out, "tagged")
    finally:
        chaos.disarm()
    leases = svc.outstanding_leases()
    reader.stop()
    svc.stop()

    if "error" in out:
        failures.append("trainer drain died under net.reset: %s"
                        % out["error"])
    _exactness("linkdeath trainer", out.get("items", []), range(n_items),
               failures)
    if _svc_delta(before, "quarantined"):
        failures.append("link faults must re-dispatch, not quarantine "
                        "(%d items)" % _svc_delta(before, "quarantined"))
    if leases or _svc_delta(before, "lease_leaked"):
        failures.append("leases outstanding/leaked after the link death "
                        "(%d/%d)" % (leases,
                                     _svc_delta(before, "lease_leaked")))
    recon = reconnects.value - reconnects0
    if plan.stats().get("injected_total", 0) and recon < 1:
        failures.append("net.reset fired but no transport reconnect "
                        "was observed")
    return {"items": n_items, "reconnects": recon,
            "redispatches": _svc_delta(before, "lease_redispatch"),
            "chaos": plan.stats(), "ok": not failures}, failures


def scenario_attribution(smoke, device=None):
    """Inject latency into ONE decode worker: the trainer's provenance fold,
    the live ``/fleet`` scrape, and the advisor must all name it."""
    import urllib.request

    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry

    failures = []
    n_items = 160 if smoke else 320
    rec = _rec()
    before = _svc_snapshot()
    svc = DataService(options=ServiceOptions(
        arena=False, sample_s=_SAMPLE_S,
        straggler_decode_p99_s=ATTR_COST_S + ATTR_LAG_S / 2), recovery=rec)
    svc.add_job(JobSpec("fleet", list(range(n_items)), decode_attr, SCHEMA,
                        tenant="attr-tenant"))
    # each worker homes its counters on a PRIVATE registry (the worker-side
    # homing contract): /fleet must still merge both sources by name
    workers = [DecodeWorker(svc.worker_address(), svc.token, recovery=rec,
                            name=name, registry=MetricsRegistry(),
                            telemetry_s=0.5)
               for name in (SLOW_WORKER, FAST_WORKER)]
    _ATTR_LAG_UNTIL[0] = time.monotonic() + (2.0 if smoke else 2.5)
    for w in workers:
        w.start()
    # ordered delivery pins the lagged worker's latency to its own items
    # (head of line) so the step-gap decile can name it
    reader = ServiceReader(svc.trainer_address(), svc.token, job="fleet",
                           trainer="attr", recovery=rec, arena=False,
                           ordered=True)
    loader = DataLoader(reader, batch_size=ROWS_PER_ITEM, to_device=False,
                        provenance=True, device=device)
    ms = svc.metrics_server()

    samples = []      # (advised, actual) at ~10Hz while the watcher runs
    fleet_docs = []   # /fleet scrapes taken DURING the drain
    scrape_errors = []
    draining = threading.Event()
    draining.set()
    done = threading.Event()

    def _watch():
        m = svc_metrics()
        next_scrape = time.monotonic()
        while not done.wait(0.1):
            samples.append((m["advised_workers"].value, m["workers"].value))
            if draining.is_set() and time.monotonic() >= next_scrape:
                next_scrape = time.monotonic() + 0.5
                try:
                    with urllib.request.urlopen(ms.url + "/fleet",
                                                timeout=2) as resp:
                        fleet_docs.append(json.loads(resp.read()))
                except Exception as exc:  # noqa: BLE001 — reported once below
                    scrape_errors.append(repr(exc))

    watcher = threading.Thread(target=_watch, daemon=True)
    watcher.start()
    items = []
    with loader:
        for batch in loader:
            items.append(int(batch["id"][0]) // ROWS_PER_ITEM)
        report = loader.attribution_report()
    draining.clear()
    # let the injection window close and the advisor walk back down
    time.sleep(8 * _SAMPLE_S)
    done.set()
    watcher.join(timeout=5)
    advised_after = svc_metrics()["advised_workers"].value
    leases = svc.outstanding_leases()
    ms.stop()
    svc.stop()

    _exactness("attribution trainer", items, range(n_items), failures)
    if leases or _svc_delta(before, "lease_leaked"):
        failures.append("leases outstanding/leaked with provenance riding "
                        "every frame (%d/%d)"
                        % (leases, _svc_delta(before, "lease_leaked")))
    culprit_site = "svc.decode@%s" % SLOW_WORKER
    if report.slow_top != culprit_site:
        failures.append("slow_top is %r, expected %r — cross-wire "
                        "provenance did not name the lagged worker (slow "
                        "share: %s)" % (report.slow_top, culprit_site,
                                        report.slow_share))
    if scrape_errors:
        failures.append("/fleet scrape failed %d times (first: %s)"
                        % (len(scrape_errors), scrape_errors[0]))
    if not fleet_docs:
        failures.append("no /fleet document captured during the drain")
    alert_workers = {a.get("worker") for doc in fleet_docs
                     for a in doc.get("alerts", ())}
    if SLOW_WORKER not in alert_workers:
        failures.append("no /fleet straggler alert named %r (alerts over "
                        "%d scrapes: %s)"
                        % (SLOW_WORKER, len(fleet_docs),
                           sorted(a for a in alert_workers if a)))
    if FAST_WORKER in alert_workers:
        failures.append("the healthy worker %r fired a straggler alert"
                        % FAST_WORKER)
    healthy = [doc for doc in fleet_docs
               if {SLOW_WORKER, FAST_WORKER} <= set(doc.get("workers", {}))]
    if not healthy:
        failures.append("/fleet never showed health for both workers")
    merged_sources = {src for doc in fleet_docs
                      for src in doc.get("sources", ())}
    for want in ("worker:%s" % SLOW_WORKER, "worker:%s" % FAST_WORKER,
                 "trainer:attr"):
        if want not in merged_sources:
            failures.append("/fleet fleet merge never included source %r "
                            "(saw %s)" % (want, sorted(merged_sources)))
    actual = max((a for _adv, a in samples), default=0)
    advised_peak = max((adv for adv, _a in samples), default=0)
    if actual != 2:
        failures.append("expected 2 connected workers, gauge peaked at %s"
                        % actual)
    if advised_peak <= actual:
        failures.append("ptpu_svc_advised_workers never rose above the "
                        "actual fleet size during the injection (peak %s, "
                        "actual %s)" % (advised_peak, actual))
    if advised_after > actual:
        failures.append("advised workers stuck at %s after the injection "
                        "cleared (actual %s)" % (advised_after, actual))
    return {
        "items": n_items,
        "slow_top": report.slow_top,
        "alert_workers": sorted(a for a in alert_workers if a),
        "advised_peak": advised_peak,
        "advised_after": advised_after,
        "fleet_scrapes": len(fleet_docs),
        "ok": not failures,
    }, failures


def _prov_arm(n_items, on, rec, failures, device=None):
    """One 2-worker drain through the DataLoader with the cross-wire
    provenance plane fully off or fully on; returns wall seconds."""
    from petastorm_tpu_torch.loader import DataLoader

    svc = DataService(options=ServiceOptions(arena=False), recovery=rec)
    svc.add_job(JobSpec("fleet", list(range(n_items)), decode_shared, SCHEMA))
    workers = [DecodeWorker(svc.worker_address(), svc.token, recovery=rec,
                            provenance=on, telemetry_s=2.0 if on else None)
               for _ in range(2)]
    for w in workers:
        w.start()
    reader = ServiceReader(svc.trainer_address(), svc.token, job="fleet",
                           recovery=rec, arena=False,
                           telemetry_s=2.0 if on else None)
    loader = DataLoader(reader, batch_size=ROWS_PER_ITEM, to_device=False,
                        provenance=True if on else None, device=device)
    items = []
    t0 = time.monotonic()
    with loader:
        for batch in loader:
            items.append(int(batch["id"][0]) // ROWS_PER_ITEM)
    wall = time.monotonic() - t0
    leases = svc.outstanding_leases()
    svc.stop()
    _exactness("provenance=%s arm" % on, items, range(n_items), failures)
    if leases:
        failures.append("provenance=%s arm: %d leases outstanding"
                        % (on, leases))
    return wall


def scenario_provoverhead(smoke, device=None):
    """Cross-wire provenance overhead: the same drain with the plane off vs
    on. Paper target <=1%; the CI assertion allows 20% (noisy hosts, tiny
    absolute walls)."""
    failures = []
    n_items = 96 if smoke else 192
    ceiling = 0.20
    rec = _rec()
    # min-of-2 per arm damps scheduler jitter on small absolute walls
    off = min(_prov_arm(n_items, False, rec, failures, device) for _ in range(2))
    on = min(_prov_arm(n_items, True, rec, failures, device) for _ in range(2))
    overhead = (on - off) / max(off, 1e-9)
    if overhead > ceiling:
        failures.append("cross-wire provenance overhead %.1f%% exceeds the "
                        "%.0f%% CI ceiling (off %.3fs, on %.3fs)"
                        % (100 * overhead, 100 * ceiling, off, on))
    return {
        "items": n_items,
        "wall_off_s": round(off, 4),
        "wall_on_s": round(on, 4),
        "overhead_pct": round(100 * overhead, 2),
        "ceiling_pct": round(100 * ceiling, 1),
        "ok": not failures,
    }, failures


SCENARIOS = {
    "shared": scenario_shared,
    "elasticity": scenario_elasticity,
    "qos": scenario_qos,
    "linkdeath": scenario_linkdeath,
    "attribution": scenario_attribution,
    "provoverhead": scenario_provoverhead,
}
DEFAULT_SCENARIOS = ("shared", "elasticity", "qos")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-bench fleet", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--smoke", action="store_true",
                        help="CI preset: small plans, hard assertions")
    parser.add_argument("--scenarios", nargs="+", default=None,
                        choices=sorted(SCENARIOS),
                        metavar="{%s}" % ",".join(sorted(SCENARIOS)),
                        help="subset to run (default: %s)"
                        % " ".join(DEFAULT_SCENARIOS))
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = require_device(args.device)

    names = tuple(args.scenarios) if args.scenarios else DEFAULT_SCENARIOS
    failures = []
    results = {}
    for name in names:
        result, scenario_failures = SCENARIOS[name](smoke=args.smoke, device=device)
        results[name] = result
        failures.extend("%s: %s" % (name, f) for f in scenario_failures)
        print("%s: %s (%s)" % (name,
                               {k: v for k, v in result.items() if k != "ok"},
                               "OK" if result["ok"] else "FAILING"))

    summary = {"bench": "fleet", "scenarios": results, "failures": failures}
    print(json.dumps(summary, ensure_ascii=False))
    if failures:
        for failure in failures:
            print("FAIL:", failure)
        return 1
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
