"""``petastorm-tpu-torch-bench attribution``: does the provenance plane name the
right culprit?

**The acceptance harness for the attribution report: inject a known
bottleneck, then assert the critical-path analyzer blames exactly that site.**

Scenarios (each a fresh tiny parquet store + loader run with
``provenance=True``):

- ``remote-tail`` — reads go through the seeded :class:`~petastorm_tpu_torch.io
  .latencyfs.CloudLatencyFS` simulator with a fat injected base + tail
  latency (remote ranged-GET engine active, hedging off so the tail LANDS).
  The report's top critical-path stage must be ``io.remote``.
- ``slow-transform`` — a host ``TransformSpec`` sleeping per row group on a
  thread pool. Top stage must be ``transform``.
- ``wire-stall`` — a PROCESS pool (shm-view wire) with a chaos-plane latency
  fault at the ``wire.decode`` hook site. Top stage must be ``wire.decode``,
  and the contributing items' spans must carry ≥2 distinct pids — the proof
  that provenance merges across the process-pool boundary.

Every scenario additionally asserts the bookkeeping invariants: provenance
ids are exactly-once (each delivered row attributed to exactly one item, the
per-item attributed rows summing to the delivered total) and
``ptpu_lease_leaked_total`` moved by 0.

``--smoke`` (the CI preset) runs all three scenarios plus the OVERHEAD
measurement the acceptance bar requires: the same thread-pool workload with
provenance disabled vs enabled over a RANDOMIZED epoch schedule (strict
alternation couples an arm to the host's load drift), asserting identical
delivered row sets and comparing best-of-epoch envelopes (contention can
only lower an epoch). Measured ≤1% on a quiet host — the acceptance target
— and asserted at a ≤20% ceiling because shared CI cores jitter far more
than the instrument itself. The last stdout line is a one-line JSON summary
for bench artifacts.

Port of ``petastorm_tpu.benchmark.attribution``: the loaders take ``--device`` (default
``cuda``) and deliver host batches.
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

    rng = np.random.default_rng(7)
    for i in range(files):
        pq.write_table(
            pa.table({
                "id": np.arange(rows_per_file, dtype=np.int64)
                + i * rows_per_file,
                "x": rng.random(rows_per_file),
                "y": rng.random(rows_per_file),
            }),
            os.path.join(root, "part-%02d.parquet" % i),
            row_group_size=rows_per_file // 2)
    return files * rows_per_file


def _leaked_total():
    from petastorm_tpu_torch.obs.metrics import default_registry

    return default_registry().counter("ptpu_lease_leaked_total").value


def _run_loader(reader, batch_size=64, device=None):
    """Drain one epoch through a host DataLoader with provenance on; returns
    ``(loader, delivered_rows, ids)``."""
    from petastorm_tpu_torch.loader import DataLoader

    ids = []
    with DataLoader(reader, batch_size, to_device=False, device=device) as loader:
        for batch in loader:
            ids.extend(int(v) for v in batch["id"])
    return loader, len(ids), ids


def _assert_exactly_once(loader, delivered_rows, scenario):
    """Provenance bookkeeping invariants: attributed rows == delivered rows,
    each item charged once, quarantine ledger disjoint from delivery."""
    rec = loader.provenance
    per_item = {}
    for b in rec.batches():
        for epoch, ordinal, rows in (b["items"] or ()):
            per_item[(epoch, ordinal)] = per_item.get((epoch, ordinal), 0) + rows
    attributed = sum(per_item.values())
    assert attributed == delivered_rows, (
        "[%s] provenance attributed %d rows, delivered %d"
        % (scenario, attributed, delivered_rows))
    quarantined = {(e, o) for e, o, _a, _k in rec.quarantined()}
    assert not (quarantined & set(per_item)), (
        "[%s] items both delivered and quarantined: %s"
        % (scenario, quarantined & set(per_item)))
    assert rec.duplicate_absorbs == 0, (
        "[%s] duplicate child-record absorbs: %d"
        % (scenario, rec.duplicate_absorbs))


def scenario_remote_tail(workdir, smoke, device=None):
    """Injected remote GET tail → the report must blame ``io.remote``."""
    import pyarrow.fs as pafs

    from petastorm_tpu_torch.io.latencyfs import CloudLatencyFS
    from petastorm_tpu_torch.reader import make_batch_reader

    root = os.path.join(workdir, "remote")
    os.makedirs(root)
    total = _make_store(root, files=2 if smoke else 4)
    fs = CloudLatencyFS(pafs.LocalFileSystem(), seed=11,
                        base_latency_s=0.02, tail_fraction=0.3,
                        tail_multiplier=6.0)
    leaked0 = _leaked_total()
    reader = make_batch_reader(
        "file://" + root, filesystem=fs, num_epochs=1, workers_count=2,
        provenance=True,
        io_options=dict(readahead=False,
                        remote=dict(enabled=True, hedge=False)))
    loader, rows, _ids = _run_loader(reader, device=device)
    assert rows == total, (rows, total)
    report = loader.attribution_report()
    _assert_exactly_once(loader, rows, "remote-tail")
    assert _leaked_total() - leaked0 == 0, "leaked leases under remote-tail"
    return report, {"delivered_rows": rows}


def scenario_slow_transform(workdir, smoke, device=None):
    """A slow host transform → the report must blame ``transform``."""
    from petastorm_tpu_torch.reader import make_batch_reader
    from petastorm_tpu_torch.transform import TransformSpec

    root = os.path.join(workdir, "transform")
    os.makedirs(root)
    total = _make_store(root, files=2 if smoke else 4)
    leaked0 = _leaked_total()
    reader = make_batch_reader(
        "file://" + root, num_epochs=1, workers_count=2,
        reader_pool_type="thread", provenance=True,
        transform_spec=TransformSpec(_sleepy_transform))
    loader, rows, _ids = _run_loader(reader, device=device)
    assert rows == total, (rows, total)
    report = loader.attribution_report()
    _assert_exactly_once(loader, rows, "slow-transform")
    assert _leaked_total() - leaked0 == 0, "leaked leases under slow-transform"
    return report, {"delivered_rows": rows}


def _sleepy_transform(df):
    time.sleep(0.04)  # the injected bottleneck: ~40ms of host transform per group
    return df


def scenario_wire_stall(workdir, smoke, device=None):
    """Chaos latency at the wire.decode hook on a process pool → the report
    must blame ``wire.decode`` AND the item spans must span ≥2 pids."""
    from petastorm_tpu_torch import chaos
    from petastorm_tpu_torch.chaos.plan import FaultPlan, FaultRule
    from petastorm_tpu_torch.reader import make_batch_reader

    root = os.path.join(workdir, "wire")
    os.makedirs(root)
    total = _make_store(root, files=2 if smoke else 4)
    leaked0 = _leaked_total()
    plan = FaultPlan([FaultRule("wire.decode", "latency", every=1,
                                latency_s=0.05)], seed=5)
    with chaos.armed(plan):
        # readahead off: the scenario isolates WIRE attribution — child-side
        # background reads would otherwise compete with the injected stall
        # for the slow-decile share on loaded hosts
        reader = make_batch_reader(
            "file://" + root, num_epochs=1, workers_count=2,
            reader_pool_type="process", wire_serializer="shm-view",
            provenance=True, io_options=dict(readahead=False))
        loader, rows, _ids = _run_loader(reader, device=device)
    assert rows == total, (rows, total)
    report = loader.attribution_report()
    _assert_exactly_once(loader, rows, "wire-stall")
    assert _leaked_total() - leaked0 == 0, "leaked leases under wire-stall"
    pids = {sp["pid"] for rec in loader.provenance.items().values()
            for sp in rec["spans"]}
    assert len(pids) >= 2, (
        "wire-stall item spans stayed in one process (%s) — the pool-pid "
        "provenance merge is broken" % pids)
    return report, {"delivered_rows": rows, "span_pids": len(pids)}


SCENARIOS = (
    ("remote-tail", scenario_remote_tail, "io.remote"),
    ("slow-transform", scenario_slow_transform, "transform"),
    ("wire-stall", scenario_wire_stall, "wire.decode"),
)


def measure_overhead(workdir, epochs=5, device=None):
    """BEST rows/s of the same thread-pool workload with provenance OFF vs
    ON (alternating epochs so host noise hits both arms; best-of like the
    trend gate — contention can only LOWER an epoch, so the envelopes are
    the comparable numbers and a shared-CI co-tenant cannot fake an
    overhead), plus row-set identity. Returns
    ``(off_best, on_best, overhead_fraction)``; the median delta is printed
    too for quiet-host runs."""
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.reader import make_batch_reader

    root = os.path.join(workdir, "overhead")
    os.makedirs(root)
    _make_store(root, files=3)

    def one_epoch(provenance):
        reader = make_batch_reader("file://" + root, num_epochs=1,
                                   workers_count=2,
                                   provenance=True if provenance else None)
        ids = []
        t0 = time.perf_counter()
        with DataLoader(reader, 64, to_device=False, device=device) as loader:
            for batch in loader:
                ids.extend(int(v) for v in batch["id"])
        return len(ids) / (time.perf_counter() - t0), sorted(ids)

    one_epoch(False)  # warmup: imports, footer parses, allocator
    # RANDOMIZED arm order (fixed seed): strict off-then-on alternation
    # couples each arm to a phase of the host's load/frequency drift and
    # measured a phantom 20% "overhead" that a shuffled schedule dissolves
    # to noise (±5% here)
    arms = [False] * epochs + [True] * epochs
    random.Random(41).shuffle(arms)
    off, on = [], []
    ids_off = ids_on = None
    for arm in arms:
        rate, ids = one_epoch(arm)
        if arm:
            on.append(rate)
            ids_on = ids
        else:
            off.append(rate)
            ids_off = ids
    assert ids_off == ids_on, "provenance changed the delivered row set"
    print("overhead medians: off %.0f vs on %.0f rows/s"
          % (statistics.median(off), statistics.median(on)))
    off_best = max(off)
    on_best = max(on)
    return off_best, on_best, max(0.0, 1.0 - on_best / off_best)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-bench attribution", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--smoke", action="store_true",
                        help="CI preset: tiny stores, all scenarios + the "
                             "overhead measurement, hard culprit assertions")
    parser.add_argument("--scenario", choices=[s[0] for s in SCENARIOS],
                        default=None, help="run one scenario only")
    parser.add_argument("--skip-overhead", action="store_true",
                        help="skip the provenance on/off throughput arms")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = require_device(args.device)

    results = {}
    failures = []
    for name, fn, culprit in SCENARIOS:
        if args.scenario and name != args.scenario:
            continue
        with tempfile.TemporaryDirectory(prefix="ptpu-attr-") as workdir:
            report, extra = fn(workdir, smoke=args.smoke, device=device)
        # the report's culprit is the SLOW-decile top (report.slow_top): an
        # injected bottleneck inflates the slow batches, while one-off costs
        # (pool-child cold start) can dominate the overall totals
        top = report.slow_top
        ok = top == culprit
        if not ok:
            failures.append("%s: expected culprit %r, got %r (slow shares: %s)"
                            % (name, culprit, top, report.slow_share))
        print("== %s ==" % name)
        print(report.render())
        print("expected culprit: %-12s report culprit: %-12s %s"
              % (culprit, top, "OK" if ok else "WRONG"))
        results[name] = {"culprit": top, "top_stage": report.top_stage,
                         "expected": culprit, "ok": ok,
                         "slow_share": report.slow_share,
                         "step_p99_s": report.step_p99_s, **extra}

    overhead = None
    if not args.scenario and not args.skip_overhead:
        with tempfile.TemporaryDirectory(prefix="ptpu-attr-") as workdir:
            off_best, on_best, overhead = measure_overhead(
                workdir, epochs=5 if args.smoke else 9, device=device)
        print("overhead: provenance off %.0f rows/s vs on %.0f rows/s "
              "best-of-epochs (delta %.2f%%; acceptance target <=1%% on a "
              "quiet host)" % (off_best, on_best, 100 * overhead))
        results["overhead"] = {"rows_per_s_off": round(off_best, 1),
                               "rows_per_s_on": round(on_best, 1),
                               "fraction": round(overhead, 4)}
        if args.smoke and overhead > 0.20:
            # the instrument itself costs ~perf_counter pairs per row group;
            # 20% headroom absorbs shared-CI noise, a real regression blows
            # straight through it
            failures.append("provenance overhead %.1f%% exceeds the 20%% "
                            "smoke ceiling" % (100 * overhead))

    summary = {"bench": "attribution", "scenarios": results,
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
