"""Async-IO micro-benchmark: cold sequential vs readahead vs readahead+coalesce.

Measures exactly what ``petastorm_tpu_torch/io/`` was built to hide: the
per-row-group read latency that dominated the JAX package's overlap scenarios
(``read_s`` 3-6.6 s per window against 0.8-2.6 s of decode). A
synthetic parquet dataset is scanned sequentially through a latency-injecting
filesystem proxy — every ``read()`` call against the file pays a configurable
round-trip delay, emulating an object store from a local disk — and each
scenario toggles one feature:

==================  ==========================================================
scenario            io_options
==================  ==========================================================
sync                readahead off (the blocking read path)
readahead           next-K prefetch on the IO thread pool, no coalescing
readahead+coalesce  prefetch + adjacent row groups merged into ranged reads
memcache-warm       readahead+coalesce + in-memory LRU, second epoch measured
==================  ==========================================================

The score is payload MB/s through the reader (single sequential consumer, dummy
pool: the overlap comes from the IO threads, not from more workers — the same
per-worker overlap the real pools get). ``--check`` asserts every scenario
delivers byte-identical tables to the synchronous path; ``--smoke`` is the CI
preset (tiny dataset, identity assertions, no throughput claims — shared CI
cores). A perf run wants real latency (``--latency-ms 5`` ≈ same-region object
store) — at 0 latency every scenario measures parse/decode and converges.

Run as ``petastorm-tpu-torch-bench io`` (or ``python -m petastorm_tpu_torch.benchmark.cli io``).
Port of ``petastorm_tpu.benchmark.io``; no loader runs here, but ``--device`` is checked
like every harness's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from petastorm_tpu_torch.benchmark import add_device_argument, require_device

SCENARIOS = ("sync", "readahead", "readahead+coalesce", "memcache-warm")

#: io_options per scenario (memcache budget filled in at run time)
_SCENARIO_OPTS = {
    "sync": {"readahead": False, "work_stealing": False},
    "readahead": {"readahead": True, "coalesce": False},
    "readahead+coalesce": {"readahead": True, "coalesce": True},
    "memcache-warm": {"readahead": True, "coalesce": True},
}


# the latency-injection filesystem lives in a shared module so the remote
# bench's CloudLatencyFS extends one copy; the import keeps the
# `benchmark.io.LatencyFS` name the remote and shmcache harnesses import
from petastorm_tpu_torch.io.latencyfs import LatencyFS  # noqa: E402,F401


def make_dataset(root, rows, row_bytes, rows_per_group, files=2):
    """Synthetic parquet store: an int64 id plus a ``row_bytes`` binary payload
    per row (deterministic fill — identity checks compare exact bytes),
    ``rows_per_group`` rows per row group, split over ``files`` files."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    per_file = max(rows_per_group, rows // files)
    written = 0
    index = 0
    while written < rows:
        n = min(per_file, rows - written)
        ids = np.arange(written, written + n, dtype=np.int64)
        payload = [bytes([i % 251]) * row_bytes for i in ids]
        pq.write_table(
            pa.table({"id": ids, "payload": payload}),
            os.path.join(root, "part-%05d.parquet" % index),
            row_group_size=rows_per_group)
        written += n
        index += 1
    return root


def _drain(reader, collect):
    """Consume every batch; returns (rows, payload_bytes, [per-batch records])."""
    rows = 0
    payload_bytes = 0
    records = []
    for batch in reader:
        ids = np.asarray(batch.id)
        rows += len(ids)
        sizes = [len(p) for p in batch.payload]
        payload_bytes += sum(sizes)
        if collect:
            import zlib

            crc = 0
            for p in batch.payload:
                crc = zlib.crc32(p, crc)
            records.append((ids.tolist(), sizes, crc))
    return rows, payload_bytes, records


def _measure_one(scenario, root, latency_s, depth, io_threads, memcache_mb,
                 check):
    from petastorm_tpu_torch.reader import make_batch_reader

    import pyarrow.fs as pafs

    opts = dict(_SCENARIO_OPTS[scenario])
    opts["readahead_depth"] = depth
    opts["io_threads"] = io_threads
    warm = scenario == "memcache-warm"
    if warm:
        opts["memcache_bytes"] = memcache_mb << 20
    fs = LatencyFS(pafs.LocalFileSystem(), latency_s)
    num_epochs = 2 if warm else 1
    with make_batch_reader("file://" + root, filesystem=fs,
                           reader_pool_type="dummy", shuffle_row_groups=False,
                           num_epochs=num_epochs, io_options=opts) as reader:
        if warm:
            # cold epoch fills the memcache; only the warm epoch is timed
            t0 = time.perf_counter()
            cold_rows, _, _ = _drain_epoch_rows(reader)
            t_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows, payload_bytes, records = _drain(reader, collect=check)
        elapsed = time.perf_counter() - t0
        io_stats = reader.io_stats()
    row = {
        "scenario": scenario,
        "rows": rows,
        "payload_mb": round(payload_bytes / 1e6, 3),
        "seconds": round(elapsed, 4),
        "mb_s": round(payload_bytes / 1e6 / elapsed, 1) if elapsed > 0 else None,
        "read_calls": fs.read_calls[0],
        "readahead_hits": io_stats.get("readahead_hits", 0),
        "coalesced_reads": io_stats.get("coalesced_reads", 0),
        "coalesced_items": io_stats.get("coalesced_items", 0),
        "memcache_hits": io_stats.get("memcache_hits", 0),
    }
    if warm:
        row["cold_epoch_seconds"] = round(t_cold, 4)
    return row, records


def _drain_epoch_rows(reader):
    """Consume exactly one epoch's worth of rows (the plan repeats the same item
    count per epoch, so counting rows is exact for an unfiltered scan)."""
    target = None
    rows = 0
    batches = 0
    for batch in reader:
        ids = np.asarray(batch.id)
        rows += len(ids)
        batches += 1
        if target is None:
            target = reader._num_items  # row groups per epoch
        if batches >= target:
            break
    return rows, batches, target


def run_io_bench(rows=2048, row_bytes=16384, rows_per_group=64, files=2,
                 latency_ms=5.0, depth=4, io_threads=2, memcache_mb=512,
                 scenarios=SCENARIOS, check=False, root=None):
    """One result row per scenario; with ``check`` every scenario's delivered
    batches (ids, payload sizes, payload CRC) must be byte-identical to the
    synchronous path's."""
    tmp = None
    if root is None:
        tmp = tempfile.TemporaryDirectory(prefix="ptpu-io-bench-")
        root = tmp.name
    try:
        make_dataset(root, rows, row_bytes, rows_per_group, files=files)
        results = []
        baseline_records = None
        for scenario in scenarios:
            row, records = _measure_one(scenario, root, latency_ms / 1e3, depth,
                                        io_threads, memcache_mb, check)
            if check:
                if baseline_records is None:
                    if scenario != "sync":
                        raise ValueError("--check needs the 'sync' scenario "
                                         "first as the identity baseline")
                    baseline_records = records
                elif scenario != "memcache-warm":
                    # warm scenario drains 2 epochs; identity is asserted on the
                    # single-epoch scenarios where batch order is deterministic
                    if records != baseline_records:
                        raise AssertionError(
                            "scenario %r delivered different tables than the "
                            "synchronous path" % scenario)
                    row["identical_to_sync"] = True
            results.append(row)
        return results
    finally:
        from petastorm_tpu_torch.io.memcache import shared_store

        # the memcache-warm scenario fills the PROCESS-WIDE store; a
        # programmatic caller (tests, a long-lived process) must not keep
        # paying those bytes after the bench returns
        shared_store().clear()
        if tmp is not None:
            tmp.cleanup()


def _format_table(rows):
    cols = ("scenario", "rows", "payload_mb", "seconds", "mb_s", "read_calls",
            "readahead_hits", "coalesced_reads", "memcache_hits")
    present = [c for c in cols if any(c in r for r in rows)]
    widths = [max(len(c), *(len(str(r.get(c, ""))) for r in rows)) for c in present]
    lines = ["  ".join(c.ljust(w) for c, w in zip(present, widths))]
    for r in rows:
        lines.append("  ".join(str(r.get(c, "")).ljust(w)
                               for c, w in zip(present, widths)))
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-bench io", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rows", type=int, default=2048)
    parser.add_argument("--row-bytes", type=int, default=16384,
                        help="binary payload bytes per row (default 16 KB)")
    parser.add_argument("--rows-per-group", type=int, default=64)
    parser.add_argument("--files", type=int, default=2)
    parser.add_argument("--latency-ms", type=float, default=5.0,
                        help="injected delay per file read call (object-store "
                             "round-trip emulation; 0 = bare local disk)")
    parser.add_argument("--depth", type=int, default=4,
                        help="readahead depth (row groups in flight)")
    parser.add_argument("--io-threads", type=int, default=2)
    parser.add_argument("--memcache-mb", type=int, default=512)
    parser.add_argument("--scenarios", nargs="*", default=list(SCENARIOS),
                        choices=SCENARIOS)
    parser.add_argument("--check", action="store_true",
                        help="assert readahead/coalesce deliver byte-identical "
                             "tables to the synchronous path")
    parser.add_argument("--json", action="store_true", help="JSON lines output")
    parser.add_argument("--smoke", action="store_true",
                        help="CI preset: tiny dataset, low latency, --check, "
                             "correctness-only (no throughput claims)")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    require_device(args.device)

    if args.smoke:
        kwargs = dict(rows=256, row_bytes=2048, rows_per_group=16, files=2,
                      latency_ms=1.0, depth=4, io_threads=2, memcache_mb=64,
                      scenarios=SCENARIOS, check=True)
    else:
        kwargs = dict(rows=args.rows, row_bytes=args.row_bytes,
                      rows_per_group=args.rows_per_group, files=args.files,
                      latency_ms=args.latency_ms, depth=args.depth,
                      io_threads=args.io_threads, memcache_mb=args.memcache_mb,
                      scenarios=tuple(args.scenarios), check=args.check)

    results = run_io_bench(**kwargs)
    if args.json:
        for r in results:
            print(json.dumps(r))
    else:
        print(_format_table(results))
    by_name = {r["scenario"]: r for r in results}
    sync = by_name.get("sync")
    best = by_name.get("readahead+coalesce") or by_name.get("readahead")
    if sync and best and sync.get("mb_s") and best.get("mb_s"):
        print("readahead%s speedup over cold synchronous: %.2fx"
              % ("+coalesce" if "coalesce" in best["scenario"] else "",
                 best["mb_s"] / sync["mb_s"]))
    if kwargs["check"]:
        print("identity: all checked scenarios delivered byte-identical tables")
    return 0


if __name__ == "__main__":
    sys.exit(main())
