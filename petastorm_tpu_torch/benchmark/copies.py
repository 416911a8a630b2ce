"""Copy-census micro-benchmark: the copying default path vs the leased path.

Measures exactly what the buffer-lease contract removed: the memcpy
every hop of the read path used to pay defensively. Each scenario drives the
REAL pipeline (``make_batch_reader`` + ``DataLoader``, host delivery) over a
synthetic numeric parquet dataset and diffs the process-wide **copy census**
(``ptpu_copy_bytes_total{site=}``, see :mod:`petastorm_tpu_torch.io.lease`) around
the drain, reporting **bytes copied per delivered batch** per path:

====================  ====================================================
scenario              configuration
====================  ====================================================
wire-default          process pool, ``wire_serializer='shm'`` — the
                      writable-batch contract deep-copies every read-only
                      reconstruction out of the slab (``wire_writable``)
wire-leased           process pool, ``wire_serializer='shm-view'`` — the
                      loader RETAINS the delivery's lease through batching
                      (no writable copy, no copy-out before buffering)
memcache-default      dummy pool, in-memory cache with the legacy
                      ``writable_hits`` contract — a deep copy per admit
                      AND per warm hit; the warm epoch is timed
memcache-leased       dummy pool, lease-contract cache — zero-copy
                      read-only views both ways; the warm epoch is timed
====================  ====================================================

``--check`` asserts each leased scenario delivers **byte-identical** batches
to its copying twin (ids + per-column CRC per batch, order included), and that
no lease leaked (``ptpu_lease_leaked_total`` delta must be 0). ``--smoke`` is
the CI preset: tiny dataset, identity checks, and a hard assertion that the
leased paths copy strictly fewer bytes per delivered batch than the default
paths (copied bytes are deterministic, so this is safe on shared CI cores —
unlike the wall-clock warm-hit throughput, which is reported but only asserted
in full runs).

The last line of output is a one-line JSON summary (``copies_summary``) with
the copied-bytes-per-batch of both paths and the reduction factors, so
bench artifacts record the census trajectory alongside throughput.

Run as ``petastorm-tpu-torch-bench copies`` (or
``python -m petastorm_tpu_torch.benchmark.copies``). Port of
``petastorm_tpu.benchmark.copies``: the loaders take ``--device`` (default ``cuda``) and
deliver host batches, as in the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import zlib

import numpy as np

from petastorm_tpu_torch.benchmark import add_device_argument, require_device

SCENARIOS = ("wire-default", "wire-leased", "memcache-default", "memcache-leased")

#: numeric feature columns per row (float64): the payload the census counts
_FEATURE_COLS = 8


def make_dataset(root, rows, rows_per_group, files=2):
    """Synthetic numeric parquet store: an int64 ``id`` plus ``_FEATURE_COLS``
    float64 features, deterministic per id so identity checks compare exact
    bytes. All-numeric on purpose — every copy site the census tracks charges
    ndarray buffer bytes, so the per-batch numbers line up across paths."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    per_file = max(rows_per_group, rows // files)
    written = 0
    index = 0
    while written < rows:
        n = min(per_file, rows - written)
        ids = np.arange(written, written + n, dtype=np.int64)
        cols = {"id": ids}
        for k in range(_FEATURE_COLS):
            cols["f%d" % k] = (ids * (k + 1)).astype(np.float64) * 0.5
        pq.write_table(pa.table(cols),
                       os.path.join(root, "part-%05d.parquet" % index),
                       row_group_size=rows_per_group)
        written += n
        index += 1
    return root


def _batch_record(batch):
    """(ids, [(name, crc)]) for one delivered batch — the identity unit. Sorted
    column order so dict ordering differences can't fail the comparison."""
    ids = np.asarray(batch["id"]).tolist()
    crcs = []
    for name in sorted(batch):
        v = batch[name]
        if isinstance(v, np.ndarray) and v.dtype != object:
            crcs.append((name, zlib.crc32(np.ascontiguousarray(v).tobytes())))
    return ids, crcs


def _drain_loader(loader, collect):
    """Consume every host batch; returns (batches, rows, [records])."""
    batches = 0
    rows = 0
    records = []
    for batch in loader:
        batches += 1
        rows += len(batch["id"])
        if collect:
            records.append(_batch_record(batch))
    return batches, rows, records


def _census_delta(before):
    from petastorm_tpu_torch.io.lease import copy_census

    after = copy_census()
    return {site: after.get(site, 0) - before.get(site, 0)
            for site in set(after) | set(before)
            if after.get(site, 0) != before.get(site, 0)}


def _measure_wire(scenario, root, batch_size, workers, check, device=None):
    """Process-pool scenario: shm (writable copies) vs shm-view (leases)."""
    from petastorm_tpu_torch.io.lease import copy_census, lease_stats
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.reader import make_batch_reader

    wire = "shm" if scenario == "wire-default" else "shm-view"
    before = copy_census()
    leases_before = lease_stats()
    t0 = time.perf_counter()
    with make_batch_reader("file://" + root, reader_pool_type="process",
                           workers_count=workers, wire_serializer=wire,
                           shuffle_row_groups=False, num_epochs=1) as reader:
        with DataLoader(reader, batch_size=batch_size, to_device=False,
                        last_batch="drop", device=device) as loader:
            batches, rows, records = _drain_loader(loader, check)
    elapsed = time.perf_counter() - t0
    return _result_row(scenario, batches, rows, elapsed, _census_delta(before),
                       lease_stats(), leases_before), records


def _measure_memcache(scenario, root, batch_size, memcache_mb, check,
                      device=None):
    """Dummy-pool scenario (cache runs in-process, so its census is visible):
    legacy writable_hits deep copies vs lease-contract read-only views. Two
    epochs — the cold one fills the cache, only the WARM epoch is measured."""
    from petastorm_tpu_torch.io.lease import copy_census, lease_stats
    from petastorm_tpu_torch.io.memcache import shared_store
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.reader import make_batch_reader

    writable = scenario == "memcache-default"
    io_opts = {"memcache_bytes": memcache_mb << 20,
               "memcache_writable_hits": writable}
    shared_store().clear()  # cold start regardless of scenario order
    try:
        # cold epoch: fill the cache through the same pipeline shape
        with make_batch_reader("file://" + root, reader_pool_type="dummy",
                               shuffle_row_groups=False, num_epochs=1,
                               io_options=io_opts) as reader:
            with DataLoader(reader, batch_size=batch_size, to_device=False,
                            last_batch="drop", device=device) as loader:
                _drain_loader(loader, collect=False)
        # warm epoch: every read is a cache hit — the memcpy-per-hit (or its
        # absence) is the whole difference between the two scenarios
        before = copy_census()
        leases_before = lease_stats()
        t0 = time.perf_counter()
        with make_batch_reader("file://" + root, reader_pool_type="dummy",
                               shuffle_row_groups=False, num_epochs=1,
                               io_options=io_opts) as reader:
            with DataLoader(reader, batch_size=batch_size, to_device=False,
                            last_batch="drop", device=device) as loader:
                batches, rows, records = _drain_loader(loader, check)
        elapsed = time.perf_counter() - t0
        return _result_row(scenario, batches, rows, elapsed,
                           _census_delta(before), lease_stats(),
                           leases_before), records
    finally:
        shared_store().clear()


def _result_row(scenario, batches, rows, elapsed, census, leases, leases_before):
    copied = sum(census.values())
    return {
        "scenario": scenario,
        "batches": batches,
        "rows": rows,
        "seconds": round(elapsed, 4),
        "rows_s": round(rows / elapsed, 1) if elapsed > 0 else None,
        "copied_bytes": copied,
        "copied_bytes_per_batch": round(copied / batches, 1) if batches else 0.0,
        "census": {k: census[k] for k in sorted(census)},
        "leases_leaked": leases["leaked"] - leases_before["leaked"],
    }


def run_copies_bench(rows=4096, rows_per_group=64, batch_size=32, files=2,
                     workers=2, memcache_mb=256, scenarios=SCENARIOS,
                     check=False, root=None, device=None):
    """One result row per scenario. With ``check``, each ``*-leased`` scenario
    must deliver byte-identical batches to its ``*-default`` twin and leak no
    leases; identity failures raise."""
    if rows_per_group % batch_size:
        raise ValueError("rows_per_group must be a multiple of batch_size so "
                         "both paths cut identical batch boundaries")
    tmp = None
    if root is None:
        tmp = tempfile.TemporaryDirectory(prefix="ptpu-copies-bench-")
        root = tmp.name
    try:
        make_dataset(root, rows, rows_per_group, files=files)
        results = []
        baselines = {}  # group -> records of the *-default twin
        for scenario in scenarios:
            group, _, variant = scenario.partition("-")
            if group == "wire":
                row, records = _measure_wire(scenario, root, batch_size,
                                             workers, check, device=device)
            else:
                row, records = _measure_memcache(scenario, root, batch_size,
                                                 memcache_mb, check, device=device)
            if check:
                if row["leases_leaked"]:
                    raise AssertionError(
                        "scenario %r leaked %d lease(s) (GC reclaimed a hold "
                        "no one released)" % (scenario, row["leases_leaked"]))
                if variant == "default":
                    baselines[group] = records
                else:
                    base = baselines.get(group)
                    if base is None:
                        raise ValueError(
                            "--check needs %s-default before %s as the "
                            "identity baseline" % (group, scenario))
                    # multi-worker pools deliver in ARRIVAL order, which varies
                    # run to run; batch boundaries are deterministic (the
                    # rows_per_group % batch_size == 0 guard above), so the
                    # identity claim is over the SET of delivered batches
                    if sorted(records) != sorted(base):
                        raise AssertionError(
                            "scenario %r delivered different batches than the "
                            "copying %s-default path" % (scenario, group))
                    row["identical_to_default"] = True
            results.append(row)
        return results
    finally:
        if tmp is not None:
            tmp.cleanup()


def summarize(results):
    """The last-line summary: copied-bytes-per-batch per path + reduction
    factors (None when a side is missing or the leased side copied nothing —
    reported as ``inf``-like ``None`` rather than a fake huge number)."""
    by_name = {r["scenario"]: r for r in results}
    summary = {"copies_summary": True}
    for group in ("wire", "memcache"):
        default = by_name.get(group + "-default")
        leased = by_name.get(group + "-leased")
        if not default or not leased:
            continue
        d, l = default["copied_bytes_per_batch"], leased["copied_bytes_per_batch"]
        summary[group] = {
            "default_copied_bytes_per_batch": d,
            "leased_copied_bytes_per_batch": l,
            "reduction_factor": round(d / l, 2) if l else None,
            "leased_strictly_below_default": l < d,
        }
        if default.get("rows_s") and leased.get("rows_s"):
            summary[group]["warm_rows_s_default"] = default["rows_s"]
            summary[group]["warm_rows_s_leased"] = leased["rows_s"]
    return summary


def _format_table(rows):
    cols = ("scenario", "batches", "rows", "seconds", "rows_s", "copied_bytes",
            "copied_bytes_per_batch", "leases_leaked")
    widths = [max(len(c), *(len(str(r.get(c, ""))) for r in rows)) for c in cols]
    lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths))]
    for r in rows:
        lines.append("  ".join(str(r.get(c, "")).ljust(w)
                               for c, w in zip(cols, widths)))
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-bench copies", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rows", type=int, default=4096)
    parser.add_argument("--rows-per-group", type=int, default=64)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--files", type=int, default=2)
    parser.add_argument("--workers", type=int, default=2,
                        help="process-pool workers for the wire scenarios")
    parser.add_argument("--memcache-mb", type=int, default=256)
    parser.add_argument("--scenarios", nargs="*", default=list(SCENARIOS),
                        choices=SCENARIOS)
    parser.add_argument("--check", action="store_true",
                        help="assert leased scenarios deliver byte-identical "
                             "batches to their copying twins and leak nothing")
    parser.add_argument("--json", action="store_true", help="JSON lines output")
    parser.add_argument("--smoke", action="store_true",
                        help="CI preset: tiny dataset, --check, and a hard "
                             "assert that the leased paths copy strictly fewer "
                             "bytes per batch (correctness-only: wall-clock "
                             "numbers carry no claims on shared CI cores)")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = require_device(args.device)

    if args.smoke:
        kwargs = dict(rows=512, rows_per_group=32, batch_size=16, files=2,
                      workers=2, memcache_mb=64, scenarios=SCENARIOS,
                      check=True)
    else:
        kwargs = dict(rows=args.rows, rows_per_group=args.rows_per_group,
                      batch_size=args.batch_size, files=args.files,
                      workers=args.workers, memcache_mb=args.memcache_mb,
                      scenarios=tuple(args.scenarios), check=args.check)

    results = run_copies_bench(**kwargs, device=device)
    if args.json:
        for r in results:
            print(json.dumps(r))
    else:
        print(_format_table(results))
    summary = summarize(results)
    if args.smoke:
        for group in ("wire", "memcache"):
            s = summary.get(group)
            assert s and s["leased_strictly_below_default"], \
                "leased %s path did not copy strictly fewer bytes per batch " \
                "than the default path: %r" % (group, s)
    if kwargs["check"]:
        print("identity: leased scenarios delivered byte-identical batches")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
