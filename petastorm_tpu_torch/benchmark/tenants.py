"""``petastorm-tpu-torch-bench tenants``: does the accounting plane name the noisy
neighbor — and what does it cost when nobody asks?

**The acceptance harness for the per-tenant accounting plane.**
Four parts:

- ``contention`` scenario: two concurrent loaders share one host and one
  cache arena. Tenant ``a-quiet`` drains a small local store; tenant
  ``b-noisy`` drains an oversized store through a
  :class:`~petastorm_tpu_torch.io.latencyfs.CloudLatencyFS` remote tail (the same
  injected bottleneck the slo/attribution benches use). The harness asserts
  the plane answers "who ate it?": the :class:`TenantUsageReport` names the
  noisy tenant as the top worker-seconds consumer, and a per-tenant burn
  SLO (``SloSpec(per_tenant=True)``) fires an alert that names BOTH the
  culprit tenant and (through the attached attribution snapshot) the culprit
  site — while the quiet tenant never alerts. Zero leaked arena leases after
  both drains.
- ``reconcile``: the tenant twins are charged ALONGSIDE the untagged totals,
  never instead — so cross-tenant sums must equal the untagged totals
  exactly: Σ ``ptpu_tenant_rows_total`` == delivered rows, and
  Σ ``ptpu_tenant_decode_seconds_total`` == the loaders' own decode stats.
- ``frames``: wire-compat of the version-negotiated tenant frame header —
  tagged and untagged frames round-trip byte-identically through
  ``pack_frame``/``take_frame``/``split_tenant`` (an old peer's unflagged
  frame passes through untouched; a truncated tenant header is a corrupt
  frame, not garbage), plus an end-to-end process-pool drain over the tcp
  transport asserting negotiated tagged frames bill ``wire_bytes`` to the
  owning tenant.
- ``overhead`` arm: the plane must be free when nobody tenants — a tagged vs
  untagged thread-pool workload over a randomized epoch schedule, comparing
  best-of-epoch envelopes. Measured ≤1% on a quiet host (the acceptance
  target), asserted at a 20% ceiling because shared CI cores jitter far more
  than the instrument. Identical delivered row sets in both arms.

The last stdout line is a one-line JSON summary for bench artifacts.

Port of ``petastorm_tpu.benchmark.tenants``: the loaders take ``--device`` (default
``cuda``) and deliver host batches.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import tempfile
import threading
import time

from petastorm_tpu_torch.benchmark import add_device_argument, require_device

QUIET = "a-quiet"
NOISY = "b-noisy"

#: per-window worker-seconds burn budget for the per-tenant SLO. The noisy
#: tenant is latency-bound (its single worker spends nearly the whole window
#: inside injected remote reads), so its per-window delta tracks the sampling
#: cadence (~_SAMPLE_S); the quiet tenant's TOTAL worker time for its tiny
#: local store sits well under one budget, so it cannot breach even once.
_BURN_BUDGET_S = 0.2
_SAMPLE_S = 0.5


def _make_store(root, files=2, rows_per_file=256):
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(18)
    for i in range(files):
        pq.write_table(
            pa.table({
                "id": np.arange(rows_per_file, dtype=np.int64)
                + i * rows_per_file,
                "x": rng.random(rows_per_file),
                "y": rng.random(rows_per_file),
            }),
            os.path.join(root, "part-%02d.parquet" % i),
            row_group_size=max(32, rows_per_file // 4))
    return files * rows_per_file


def _snapshot_delta(registry, snap0):
    """Numeric counter movement since ``snap0`` (scenario-scoped metrics on
    the process-wide default registry)."""
    out = {}
    for name, value in registry.snapshot().items():
        if not isinstance(value, (int, float)):
            continue
        before = snap0.get(name)
        out[name] = value - before if isinstance(before, (int, float)) \
            else value
    return out


def _drain(loader, reader, out):
    """Drain one loader to exhaustion (thread target); arena stats are read
    INSIDE the with-block — after teardown the funnel is gone."""
    rows = 0
    try:
        with loader:
            for batch in loader:
                rows += len(batch["id"])
            out["io"] = reader.io_stats()
    except Exception as e:  # noqa: BLE001 — surfaced as a bench failure
        out["error"] = repr(e)
    out["rows"] = rows


def scenario_contention(workdir, smoke, device=None):
    """Two tenants, one host, one arena: the noisy one must be named."""
    import pyarrow.fs as pafs

    from petastorm_tpu_torch.io import arena as arena_mod
    from petastorm_tpu_torch.io.latencyfs import CloudLatencyFS
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.obs import tenant as tenant_mod
    from petastorm_tpu_torch.obs.metrics import default_registry
    from petastorm_tpu_torch.obs.slo import SloEngine, SloSpec
    from petastorm_tpu_torch.reader import make_batch_reader

    registry = default_registry()
    snap0 = registry.snapshot()
    failures = []

    root_a = os.path.join(workdir, "quiet")
    root_b = os.path.join(workdir, "noisy")
    os.makedirs(root_a)
    os.makedirs(root_b)
    total_a = _make_store(root_a, files=2, rows_per_file=256)
    # the noisy tenant reads OVERSIZED: more files, more rows per file, and
    # every byte through an injected remote tail
    total_b = _make_store(root_b, files=4 if smoke else 6, rows_per_file=512)
    fs_b = CloudLatencyFS(pafs.LocalFileSystem(), seed=7,
                          base_latency_s=0.06, tail_fraction=0.25,
                          tail_multiplier=4.0)

    arena_opts = {"readahead": False, "work_stealing": False,
                  "arena_bytes": 32 << 20}
    # workers_count=1 on the noisy side: serialized reads keep every window's
    # worker delta carrying the injected latency (same reasoning as the slo
    # bench's breach scenario)
    reader_a = make_batch_reader(
        "file://" + root_a, num_epochs=1, workers_count=1, tenant=QUIET,
        io_options=dict(arena_opts))
    reader_b = make_batch_reader(
        "file://" + root_b, filesystem=fs_b, num_epochs=1, workers_count=1,
        provenance=True, tenant=NOISY,
        io_options=dict(arena_opts,
                        remote=dict(enabled=True, hedge=False)))

    spec = SloSpec(name="tenant-worker-burn",
                   metric=tenant_mod.RESOURCES["worker_s"][0],
                   stat="delta", op="<=", threshold=_BURN_BUDGET_S,
                   breach_windows=2, per_tenant=True,
                   description="per-window worker-seconds budget per tenant")
    engine = SloEngine(specs=[spec], registry=registry)
    engine.attach(registry.timeline_store())

    loader_a = DataLoader(reader_a, 64, to_device=False, host_queue_size=2,
                          device=device)
    # slos= on the noisy loader wires its attribution_report (provenance is
    # on) so the burn alert names the culprit SITE beside the tenant
    loader_b = DataLoader(reader_b, 64, to_device=False, host_queue_size=2,
                          metrics=registry, slos=engine, device=device)

    out_a, out_b = {}, {}
    threads = [threading.Thread(target=_drain, args=(loader_a, reader_a,
                                                     out_a)),
               threading.Thread(target=_drain, args=(loader_b, reader_b,
                                                     out_b))]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        time.sleep(_SAMPLE_S)
        registry.sample_timelines()
    for t in threads:
        t.join()
    registry.sample_timelines()

    for label, out in ((QUIET, out_a), (NOISY, out_b)):
        if "error" in out:
            failures.append("tenant %s drain died: %s" % (label,
                                                          out["error"]))
    assert out_a.get("rows") == total_a, (out_a, total_a)
    assert out_b.get("rows") == total_b, (out_b, total_b)

    # zero leaked leases on the SHARED arena after both drains
    arena = arena_mod.process_arena()
    held = arena.stats().get("arena_held_leases", 0) \
        if arena is not None else 0
    if held:
        failures.append("%d arena leases leaked after both drains" % held)
    arena_mod.close_process_arena()

    delta = _snapshot_delta(registry, snap0)
    report = tenant_mod.TenantUsageReport.from_metrics(delta)
    tenant_mod.meter(registry).arena_settle()

    top_worker, top_worker_v = report.top_consumer("worker_s")
    if top_worker != NOISY:
        failures.append("top worker-seconds consumer is %r (%.3fs), "
                        "expected %r" % (top_worker, top_worker_v, NOISY))
    top_bytes, _v = report.top_consumer("read_bytes")
    if top_bytes not in (NOISY, None):
        # None = this config's read path didn't route through a counting
        # tier; wrong-tenant is a real failure
        failures.append("top read-bytes consumer is %r, expected %r"
                        % (top_bytes, NOISY))

    breaches = [a for a in engine.alerts() if a.cause == "slo_breach"]
    noisy_alerts = [a for a in breaches if a.tenant == NOISY]
    quiet_alerts = [a for a in breaches if a.tenant == QUIET]
    if not noisy_alerts:
        failures.append(
            "no per-tenant burn alert named %r (windows evaluated: %d, "
            "breaching: %s)" % (NOISY, engine.windows_evaluated,
                                engine.breaching()))
    if quiet_alerts:
        failures.append("the quiet tenant %r fired %d burn alerts"
                        % (QUIET, len(quiet_alerts)))
    culprit = noisy_alerts[0].culprit if noisy_alerts else None
    if noisy_alerts and culprit != "io.remote":
        failures.append("burn alert for %r blamed site %r, expected "
                        "io.remote" % (NOISY, culprit))

    # -- reconcile: cross-tenant sums == untagged totals --------------------
    rows_sum = sum(report.get(t, "rows") for t in report.tenants())
    if int(rows_sum) != total_a + total_b:
        failures.append(
            "tenant rows do not reconcile: sum(ptpu_tenant_rows_total) = %d "
            "!= %d delivered" % (int(rows_sum), total_a + total_b))
    decode_sum = sum(report.get(t, "decode_s") for t in report.tenants())
    decode_total = loader_a.stats.decode_s + loader_b.stats.decode_s
    if abs(decode_sum - decode_total) > 1e-6 + 1e-3 * decode_total:
        failures.append(
            "tenant decode seconds do not reconcile: %.6fs tagged vs %.6fs "
            "untagged" % (decode_sum, decode_total))

    return {
        "rows": {QUIET: out_a["rows"], NOISY: out_b["rows"]},
        "report": report.to_dict(),
        "top_worker_s": top_worker,
        "alerts": [{"tenant": a.tenant, "culprit": a.culprit,
                    "value": a.value} for a in breaches],
        "held_leases": held,
        "decode_s_tagged": round(decode_sum, 6),
        "decode_s_untagged": round(decode_total, 6),
        "ok": not failures,
    }, failures


def check_frames():
    """Tenant frame-header compat: tagged <-> untagged peers, both ways."""
    from petastorm_tpu_torch.errors import TransportFrameCorrupt
    from petastorm_tpu_torch.transport.framing import (
        K_OBJ,
        K_TENANT_FLAG,
        pack_frame,
        split_tenant,
        take_frame,
    )

    payload = b"row-group-result-bytes"
    # new sender -> new receiver: tagged round-trip, byte-identical payload
    buf = bytearray(pack_frame(K_OBJ, payload, tenant=NOISY))
    kind, body = take_frame(buf)
    assert kind == K_OBJ | K_TENANT_FLAG, kind
    assert split_tenant(kind, body) == (K_OBJ, payload, NOISY)
    # old sender -> new receiver: unflagged frame passes through untagged
    buf = bytearray(pack_frame(K_OBJ, payload))
    kind, body = take_frame(buf)
    assert split_tenant(kind, body) == (K_OBJ, payload, None)
    # new sender -> old peer: pack_frame without tenant= (what an
    # un-negotiated link sends after the downgrade) is byte-identical to the
    # old wire format
    assert pack_frame(K_OBJ, payload) == pack_frame(K_OBJ, payload,
                                                    tenant=None)
    # a truncated tenant header is a corrupt frame, never garbage delivery
    try:
        split_tenant(K_OBJ | K_TENANT_FLAG, b"\xff" + b"ab")
    except TransportFrameCorrupt:
        pass
    else:
        raise AssertionError("truncated tenant header parsed as a frame")


def scenario_wire(workdir):
    """End-to-end tcp pool drain with a tenant: negotiated tagged frames must
    deliver every row and bill wire bytes to the owning tenant."""
    from petastorm_tpu_torch.obs import tenant as tenant_mod
    from petastorm_tpu_torch.obs.metrics import default_registry
    from petastorm_tpu_torch.reader import make_batch_reader

    registry = default_registry()
    snap0 = registry.snapshot()
    failures = []

    root = os.path.join(workdir, "wire")
    os.makedirs(root)
    total = _make_store(root, files=1, rows_per_file=128)
    rows = 0
    with make_batch_reader("file://" + root, num_epochs=1,
                           reader_pool_type="process", workers_count=1,
                           transport="tcp", tenant="c-wire") as reader:
        for batch in reader:
            rows += len(batch.id)
    assert rows == total, (rows, total)

    delta = _snapshot_delta(registry, snap0)
    report = tenant_mod.TenantUsageReport.from_metrics(delta)
    wire_bytes = report.get("c-wire", "wire_bytes")
    if wire_bytes <= 0:
        failures.append("tcp pool drain with tenant= charged no "
                        "ptpu_tenant_wire_bytes_total (negotiation or "
                        "rx accounting broken)")
    return {"rows": rows, "wire_bytes": int(wire_bytes),
            "ok": not failures}, failures


def measure_overhead(workdir, epochs=5, device=None):
    """BEST rows/s with a tenant tagged on every charge site vs fully
    untagged (the disabled plane pays only ``is None`` checks — tagged is a
    strict superset of that cost, so bounding tagged bounds disabled too).
    Randomized epoch order; identical delivered row sets asserted. Returns
    ``(off_best, on_best, overhead_fraction)``."""
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.reader import make_batch_reader

    root = os.path.join(workdir, "overhead")
    os.makedirs(root)
    _make_store(root, files=3)

    def one_epoch(tagged):
        reader = make_batch_reader(
            "file://" + root, num_epochs=1, workers_count=2,
            tenant="ovh" if tagged else None)
        ids = []
        t0 = time.perf_counter()
        with DataLoader(reader, 64, to_device=False,
                        tenant="ovh" if tagged else None, device=device) as loader:
            for batch in loader:
                ids.extend(int(v) for v in batch["id"])
        dt = time.perf_counter() - t0
        return len(ids) / dt, sorted(ids)

    one_epoch(False)  # warmup
    arms = [False] * epochs + [True] * epochs
    random.Random(18).shuffle(arms)
    off, on = [], []
    ids_off = ids_on = None
    for arm in arms:
        rate, ids = one_epoch(arm)
        (on if arm else off).append(rate)
        if arm:
            ids_on = ids
        else:
            ids_off = ids
    assert ids_off == ids_on, "the tenant plane changed the delivered rows"
    print("overhead medians: untagged %.0f vs tagged %.0f rows/s"
          % (statistics.median(off), statistics.median(on)))
    off_best, on_best = max(off), max(on)
    return off_best, on_best, max(0.0, 1.0 - on_best / off_best)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-bench tenants", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--smoke", action="store_true",
                        help="CI preset: tiny stores, hard assertions, 20%% "
                             "overhead ceiling")
    parser.add_argument("--skip-overhead", action="store_true",
                        help="skip the tagged/untagged throughput arms")
    parser.add_argument("--skip-wire", action="store_true",
                        help="skip the process-pool tcp wire leg (frame "
                             "round-trips still run)")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = require_device(args.device)

    failures = []
    with tempfile.TemporaryDirectory(prefix="ptpu-tenants-") as workdir:
        contention, contention_failures = scenario_contention(
            workdir, smoke=args.smoke, device=device)
    failures.extend(contention_failures)
    print("contention: top worker-seconds consumer %s, %d burn alert(s) %s, "
          "%d leaked leases (%s)"
          % (contention["top_worker_s"], len(contention["alerts"]),
             [(a["tenant"], a["culprit"]) for a in contention["alerts"]],
             contention["held_leases"],
             "OK" if contention["ok"] else "FAILING"))
    print("reconcile: rows %s; decode %.4fs tagged vs %.4fs untagged"
          % (contention["rows"], contention["decode_s_tagged"],
             contention["decode_s_untagged"]))

    check_frames()
    print("frames: tagged/untagged round-trips byte-identical, truncated "
          "header rejected")

    wire = None
    if not args.skip_wire:
        with tempfile.TemporaryDirectory(prefix="ptpu-tenants-") as workdir:
            wire, wire_failures = scenario_wire(workdir)
        failures.extend(wire_failures)
        print("wire: %d rows over the tagged tcp pool, %d tenant wire bytes "
              "(%s)" % (wire["rows"], wire["wire_bytes"],
                        "OK" if wire["ok"] else "FAILING"))

    overhead = None
    if not args.skip_overhead:
        with tempfile.TemporaryDirectory(prefix="ptpu-tenants-") as workdir:
            off_best, on_best, overhead = measure_overhead(
                workdir, epochs=5 if args.smoke else 9, device=device)
        print("overhead: untagged %.0f rows/s vs tagged %.0f rows/s "
              "best-of-epochs (delta %.2f%%; acceptance target <=1%% on a "
              "quiet host)" % (off_best, on_best, 100 * overhead))
        if args.smoke and overhead > 0.20:
            failures.append("tenant-plane overhead %.1f%% exceeds the 20%% "
                            "smoke ceiling" % (100 * overhead))

    summary = {"bench": "tenants", "contention": contention, "wire": wire,
               "overhead_fraction": None if overhead is None
               else round(overhead, 4),
               "failures": failures}
    print(json.dumps(summary, ensure_ascii=False))
    if failures:
        for failure in failures:
            print("FAIL:", failure)
        return 1
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
