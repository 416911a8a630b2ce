"""``python -m petastorm_tpu_torch.benchmark.trend``: the throughput-regression gate.

Port of ``petastorm_tpu.benchmark.trend``, with its schema, so the two packages'
histories stay readable by each other's ``diff``:

1. run a small fixed synthetic workload through the real reader → DataLoader path (best
   of N post-warmup epochs: contention on shared cores can only LOWER an epoch, so the
   best one is the machine's throughput envelope, and a real code regression lowers the
   envelope itself),
2. append the one-line JSON summary (schema ``ptpu-bench-trend-v2``) to the history file
   (``--history``, by default ``BENCH_HISTORY.jsonl`` in the working directory, as in
   the JAX package: pass ``--history`` to keep a run out of a shared file),
3. FAIL (exit 1) when the measured best rows/s regresses more than ``--threshold``
   (default 30%) against the MEDIAN of the stored history for the SAME workload
   fingerprint: a median baseline, so one lucky run cannot ratchet the bar up, per
   workload, so a full run's numbers never gate a smoke run.

An empty (or missing) history is seeded with the current run and passes: the gate arms
itself on first use. The entry is appended BEFORE the verdict, so a failing run is still
recorded.

Entries carry the measured workload's per-site critical-path self times (``"sites"``,
from the attribution plane: every epoch runs with ``provenance=True``) and its step p99,
so a failing gate says WHY: it diffs the run against the baseline entry
(:func:`petastorm_tpu_torch.obs.diff.diff_runs`) and names the regressed site. v1
entries stay loadable (they carry no sites).

The workload is host-side (``to_device=False``: the loader delivers host batches); the
loader still takes its ``device`` (``--device``, default the CUDA card). What the
provenance plane costs when it is on was not measured for this gate.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

SCHEMA = "ptpu-bench-trend-v2"
#: older entries stay comparable — the gate metric (rows_per_s per workload
#: fingerprint) is identical across versions; only the forensic fields grew
ACCEPTED_SCHEMAS = ("ptpu-bench-trend-v1", "ptpu-bench-trend-v2")


def _make_store(root, files, rows_per_file):
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(13)
    for i in range(files):
        pq.write_table(
            pa.table({
                "id": np.arange(rows_per_file, dtype=np.int64)
                + i * rows_per_file,
                "a": rng.random(rows_per_file),
                "b": rng.random(rows_per_file),
                "c": rng.integers(0, 1000, rows_per_file),
            }),
            os.path.join(root, "part-%02d.parquet" % i),
            row_group_size=max(64, rows_per_file // 4))
    return files * rows_per_file


def measure(files=4, rows_per_file=2048, batch_size=256, epochs=5, device=None):
    """Gate metric: BEST rows/s over ``epochs`` fresh single-epoch loader runs of the
    fixed synthetic workload (thread pool, readahead on: the default read path), after
    one discarded warmup epoch (imports and first-open costs). Best of N, not median:
    contention can only lower an epoch, never inflate one.

    Every epoch runs with the provenance plane on, so the best epoch's per-site
    critical-path self times ride into the trend entry: the forensic baseline
    :mod:`petastorm_tpu_torch.obs.diff` compares against. ``device`` is the loader's
    (None: the CUDA card). Returns ``(best, all_measured_rates, best_forensics)`` where
    ``best_forensics`` is ``{"sites": {...}, "step_p99_s": ...}``."""
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.reader import make_batch_reader

    def one_epoch():
        reader = make_batch_reader("file://" + root, num_epochs=1,
                                   workers_count=2, provenance=True)
        rows = 0
        t0 = time.perf_counter()
        with DataLoader(reader, batch_size, to_device=False, device=device) as loader:
            for batch in loader:
                rows += len(batch["id"])
        rate = rows / (time.perf_counter() - t0)
        assert rows == total, (rows, total)
        report = loader.attribution_report()
        return rate, {"sites": {site: round(sec, 4) for site, sec
                                in report.stage_self_s.items()},
                      "step_p99_s": report.step_p99_s}

    rates = []
    forensics = []
    with tempfile.TemporaryDirectory(prefix="ptpu-trend-") as root:
        total = _make_store(root, files, rows_per_file)
        one_epoch()  # warmup: imports, first-open footers, allocator warm
        for _ in range(epochs):
            rate, f = one_epoch()
            rates.append(rate)
            forensics.append(f)
    best_idx = max(range(len(rates)), key=rates.__getitem__)
    return rates[best_idx], rates, forensics[best_idx]


def load_history(path, workload=None):
    """Prior trend entries (same schema, same WORKLOAD fingerprint) from the
    history JSONL, oldest first; malformed/foreign lines are skipped (the
    file is shared with other bench artifacts). The workload filter keeps
    the baseline comparable: a full run's median must never gate a smoke
    run (different store size/batch size = a different number)."""
    entries = []
    if not os.path.exists(path):
        return entries
    with open(path) as f:
        for line in f:
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict) and obj.get("schema") in ACCEPTED_SCHEMAS \
                    and obj.get("rows_per_s") \
                    and (workload is None or obj.get("workload") == workload):
                entries.append(obj)
    return entries


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m petastorm_tpu_torch.benchmark.trend", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--history", default="BENCH_HISTORY.jsonl",
                        help="history JSONL to append to / gate against")
    parser.add_argument("--threshold", type=float, default=0.30,
                        help="fail when best-of-N rows/s drops more than this "
                             "fraction below the history median (default "
                             "0.30)")
    parser.add_argument("--epochs", type=int, default=5,
                        help="post-warmup epochs to sample (default 5)")
    parser.add_argument("--smoke", action="store_true",
                        help="CI preset: smaller store, 3 epochs")
    parser.add_argument("--dry-run", action="store_true",
                        help="measure + compare but do not append")
    parser.add_argument("--device", default=None,
                        help="the loader's torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    if args.smoke:
        shape = dict(files=3, rows_per_file=1024, batch_size=128)
        best, rates, forensics = measure(epochs=min(args.epochs, 3), device=args.device,
                                         **shape)
    else:
        shape = dict(files=4, rows_per_file=2048, batch_size=256)
        best, rates, forensics = measure(epochs=args.epochs, device=args.device)
    #: the comparability fingerprint: only same-shaped runs share a baseline
    workload = "f%d-r%d-b%d" % (shape["files"], shape["rows_per_file"],
                                shape["batch_size"])

    history = load_history(args.history, workload=workload)
    baseline = statistics.median(e["rows_per_s"] for e in history) \
        if history else None

    entry = {
        "schema": SCHEMA,
        "ts": time.time(),
        "workload": workload,
        "rows_per_s": round(best, 1),
        "epoch_rates": [round(r, 1) for r in rates],
        "smoke": bool(args.smoke),
        "baseline_rows_per_s": None if baseline is None
        else round(baseline, 1),
        "history_entries": len(history),
        #: forensic fields (schema v2): the best epoch's per-site
        #: critical-path self-times + step p99 — what obs.diff compares
        "sites": forensics["sites"],
        "step_p99_s": forensics["step_p99_s"],
    }
    regressed = baseline is not None \
        and best < (1.0 - args.threshold) * baseline
    entry["regressed"] = regressed
    if not args.dry_run:
        # append before the verdict: a FAILING run must still be recorded
        with open(args.history, "a") as f:
            f.write(json.dumps(entry) + "\n")

    if baseline is None:
        print("trend: history empty for workload %s — seeded with %.0f "
              "rows/s (gate arms on the next run)" % (workload, best))
    else:
        delta = best / baseline - 1.0
        print("trend: %.0f rows/s vs history median %.0f (%+.1f%%; gate "
              "fails below %+.0f%%, %d prior %s entries)"
              % (best, baseline, 100 * delta, -100 * args.threshold,
                 len(history), workload))
    print(json.dumps(entry))
    if regressed:
        # forensics: diff the regressed run against the baseline
        # entry closest to the gating median, so the failure NAMES the site
        # that regressed instead of just the number
        baseline_entry = min(
            history, key=lambda e: abs(e["rows_per_s"] - baseline))
        if baseline_entry.get("sites"):
            from petastorm_tpu_torch.obs.diff import diff_runs

            verdict = diff_runs(baseline_entry, entry)
            print("why: %s" % verdict["verdict"])
            if verdict["regressed_site"]:
                print("     rerun `python -m petastorm_tpu_torch.obs.diff -2 -1 "
                      "--history %s` for the per-site table" % args.history)
        print("FAIL: throughput regressed more than %.0f%% vs the stored "
              "median — investigate before merging (history: %s)"
              % (100 * args.threshold, args.history))
        return 1
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
