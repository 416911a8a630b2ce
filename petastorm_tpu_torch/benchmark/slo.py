"""``petastorm-tpu-torch-bench slo``: does the temporal plane catch a burn and name
the culprit — and what does arming it cost?

**The acceptance harness for the SLO/anomaly engine.** Two parts:

- ``breach`` scenario: the :class:`~petastorm_tpu_torch.io.latencyfs.CloudLatencyFS`
  remote-tail injection (the same bottleneck the attribution bench uses)
  behind a loader whose step-p99 SLO was calibrated against a CLEAN run of
  the identical workload (threshold = 3× the clean windowed p99 — the bench
  carries no magic milliseconds). The injected run must trip **exactly one**
  debounced ``slo_breach`` alert, and the alert's attached attribution
  snapshot must name ``io.remote`` as the critical-path culprit — the alert
  names the site, not just the symptom.
- ``overhead`` arm: the same thread-pool workload with the WHOLE plane armed
  (metrics registry + a live Reporter sampling timelines on its cadence + the
  SLO engine evaluating every window) vs fully disarmed, over a randomized
  epoch schedule (strict alternation couples an arm to host load drift),
  comparing best-of-epoch envelopes. Measured ≤1% on a quiet host — the
  acceptance target — and asserted at a 20% ceiling because shared CI cores
  jitter far more than the instrument. Identical delivered row sets are
  asserted in both arms.

The last stdout line is a one-line JSON summary for bench artifacts.

Port of ``petastorm_tpu.benchmark.slo``: the loaders take ``--device`` (default ``cuda``)
and deliver host batches.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import tempfile
import time

from petastorm_tpu_torch.benchmark import add_device_argument, require_device


def _make_store(root, files=3, rows_per_file=256):
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(23)
    for i in range(files):
        pq.write_table(
            pa.table({
                "id": np.arange(rows_per_file, dtype=np.int64)
                + i * rows_per_file,
                "x": rng.random(rows_per_file),
                "y": rng.random(rows_per_file),
            }),
            os.path.join(root, "part-%02d.parquet" % i),
            # 4 row groups per file: enough distinct reads that the injected
            # tail spans several consumer windows
            row_group_size=max(32, rows_per_file // 4))
    return files * rows_per_file


def _drain_with_windows(reader, registry, batch_size=64, sample_every=1,
                        device=None, **loader_kwargs):
    """Drain one epoch, sampling the registry's timelines every
    ``sample_every`` delivered batches (a deterministic cadence — the bench
    must not depend on a timer thread winning races on loaded CI hosts). The
    host queue is kept SHORT so the producer's reads spread across consumer
    windows instead of all landing in the first one.
    Returns ``(loader, delivered_rows)``."""
    from petastorm_tpu_torch.loader import DataLoader

    rows = 0
    loader_kwargs.setdefault("host_queue_size", 2)
    with DataLoader(reader, batch_size, to_device=False,
                    metrics=registry, device=device, **loader_kwargs) as loader:
        for i, batch in enumerate(loader):
            rows += len(batch["id"])
            if (i + 1) % sample_every == 0:
                registry.sample_timelines()
        registry.sample_timelines()
    return loader, rows


_STEP_METRIC = 'ptpu_pipeline_stage_seconds{stage="read"}'


def _clean_p99(workdir, files, device=None):
    """Windowed step p99 of the CLEAN (no injection) workload — the SLO
    calibration baseline."""
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry
    from petastorm_tpu_torch.reader import make_batch_reader

    root = os.path.join(workdir, "clean")
    os.makedirs(root)
    total = _make_store(root, files=files)
    registry = MetricsRegistry()
    # workers_count=1 (here AND in the breach run): with 2 workers, reads
    # overlap and some reader.next calls return instantly from the ready
    # queue — legitimate recovery windows that re-arm the debounce and turn
    # "exactly one alert" into a race. Serialized reads make every window's
    # read observation carry the (injected) latency.
    reader = make_batch_reader(
        "file://" + root, num_epochs=1, workers_count=1,
        io_options=dict(readahead=False))
    _loader, rows = _drain_with_windows(reader, registry, device=device)
    assert rows == total, (rows, total)
    p99s = [p["p99"] for p in registry.timeline(_STEP_METRIC)
            if p.get("count")]
    assert p99s, "clean run produced no step windows"
    return max(p99s)


def scenario_breach(workdir, smoke, device=None):
    """Injected remote tail → exactly ONE debounced slo_breach naming
    io.remote."""
    import pyarrow.fs as pafs

    from petastorm_tpu_torch.io.latencyfs import CloudLatencyFS
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry
    from petastorm_tpu_torch.obs.slo import SloEngine, SloSpec
    from petastorm_tpu_torch.reader import make_batch_reader

    files = 2 if smoke else 4
    threshold = 3.0 * _clean_p99(workdir, files, device=device)

    root = os.path.join(workdir, "breach")
    os.makedirs(root)
    total = _make_store(root, files=files)
    fs = CloudLatencyFS(pafs.LocalFileSystem(), seed=11,
                        base_latency_s=0.02, tail_fraction=0.3,
                        tail_multiplier=6.0)
    registry = MetricsRegistry()
    spec = SloSpec(name="loader-step-p99", metric=_STEP_METRIC, stat="p99",
                   op="<=", threshold=threshold, breach_windows=2,
                   min_count=1)
    engine = SloEngine(specs=[spec], registry=registry)
    engine.attach(registry.timeline_store())
    reader = make_batch_reader(
        "file://" + root, filesystem=fs, num_epochs=1, workers_count=1,
        provenance=True,
        io_options=dict(readahead=False,
                        remote=dict(enabled=True, hedge=False)))
    # the engine needs the loader's attribution; wire it through slos= so the
    # loader binds attribution_report for us
    from petastorm_tpu_torch.loader import DataLoader

    rows = 0
    with DataLoader(reader, 64, to_device=False, metrics=registry,
                    slos=engine, host_queue_size=2, device=device) as loader:
        for i, batch in enumerate(loader):
            rows += len(batch["id"])
            registry.sample_timelines()
        registry.sample_timelines()
    assert rows == total, (rows, total)
    alerts = engine.alerts()
    assert len(alerts) == 1, (
        "expected exactly one debounced breach, got %d: %s"
        % (len(alerts), [a.name for a in alerts]))
    alert = alerts[0]
    assert alert.cause == "slo_breach", alert.cause
    assert alert.windows >= spec.breach_windows, alert.windows
    assert alert.attribution is not None, "alert carries no attribution"
    ok_culprit = alert.culprit == "io.remote"
    return {
        "delivered_rows": rows,
        "threshold_s": round(threshold, 6),
        "alert_value_s": alert.value,
        "alert_windows": alert.windows,
        "culprit": alert.culprit,
        "ok": ok_culprit,
    }, ([] if ok_culprit else
        ["breach alert blamed %r, expected io.remote (slow shares: %s)"
         % (alert.culprit, (alert.attribution or {}).get("slow_share"))])


def measure_overhead(workdir, epochs=5, device=None):
    """BEST rows/s with the temporal plane fully ARMED (metrics + Reporter
    sampling timelines on its cadence + SLO engine per window) vs fully OFF,
    randomized epoch order, plus row-set identity. Returns
    ``(off_best, on_best, overhead_fraction)``."""
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.obs.export import Reporter
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry
    from petastorm_tpu_torch.obs.slo import SloEngine, SloSpec
    from petastorm_tpu_torch.reader import make_batch_reader

    root = os.path.join(workdir, "overhead")
    os.makedirs(root)
    _make_store(root, files=3)
    jsonl = os.path.join(root, "stats.jsonl")

    def one_epoch(armed):
        reader = make_batch_reader("file://" + root, num_epochs=1,
                                   workers_count=2)
        ids = []
        if armed:
            registry = MetricsRegistry()
            engine = SloEngine(
                specs=[SloSpec(name="step-p99", metric=_STEP_METRIC,
                               stat="p99", op="<=", threshold=60.0)],
                registry=registry)
            engine.attach(registry.timeline_store())
            t0 = time.perf_counter()
            with Reporter(registry=registry, interval_s=0.05,
                          jsonl_path=jsonl):
                with DataLoader(reader, 64, to_device=False,
                                metrics=registry, slos=engine,
                                device=device) as loader:
                    for batch in loader:
                        ids.extend(int(v) for v in batch["id"])
            dt = time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            with DataLoader(reader, 64, to_device=False, device=device) as loader:
                for batch in loader:
                    ids.extend(int(v) for v in batch["id"])
            dt = time.perf_counter() - t0
        return len(ids) / dt, sorted(ids)

    one_epoch(False)  # warmup
    arms = [False] * epochs + [True] * epochs
    random.Random(43).shuffle(arms)
    off, on = [], []
    ids_off = ids_on = None
    for arm in arms:
        rate, ids = one_epoch(arm)
        (on if arm else off).append(rate)
        if arm:
            ids_on = ids
        else:
            ids_off = ids
    assert ids_off == ids_on, "the armed plane changed the delivered row set"
    print("overhead medians: off %.0f vs armed %.0f rows/s"
          % (statistics.median(off), statistics.median(on)))
    off_best, on_best = max(off), max(on)
    return off_best, on_best, max(0.0, 1.0 - on_best / off_best)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-bench slo", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--smoke", action="store_true",
                        help="CI preset: tiny store, hard assertions, 20%% "
                             "overhead ceiling")
    parser.add_argument("--skip-overhead", action="store_true",
                        help="skip the armed/disarmed throughput arms")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = require_device(args.device)

    failures = []
    with tempfile.TemporaryDirectory(prefix="ptpu-slo-") as workdir:
        breach, breach_failures = scenario_breach(workdir, smoke=args.smoke,
                                                  device=device)
    failures.extend(breach_failures)
    print("breach scenario: one %s alert after %d windows, value %.1fms vs "
          "threshold %.1fms, culprit %s (%s)"
          % ("slo_breach", breach["alert_windows"],
             breach["alert_value_s"] * 1e3, breach["threshold_s"] * 1e3,
             breach["culprit"], "OK" if breach["ok"] else "WRONG"))

    overhead = None
    if not args.skip_overhead:
        with tempfile.TemporaryDirectory(prefix="ptpu-slo-") as workdir:
            off_best, on_best, overhead = measure_overhead(
                workdir, epochs=5 if args.smoke else 9, device=device)
        print("overhead: plane off %.0f rows/s vs armed %.0f rows/s "
              "best-of-epochs (delta %.2f%%; acceptance target <=1%% on a "
              "quiet host)" % (off_best, on_best, 100 * overhead))
        if args.smoke and overhead > 0.20:
            failures.append("temporal-plane overhead %.1f%% exceeds the 20%% "
                            "smoke ceiling" % (100 * overhead))

    summary = {"bench": "slo", "breach": breach,
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
