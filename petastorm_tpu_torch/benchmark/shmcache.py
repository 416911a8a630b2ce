"""Shared-memory cache arena acceptance bench: one mapped warm set per host.

Measures exactly what ``petastorm_tpu_torch/io/arena.py`` exists to
deliver: a SECOND process on the same host serving its warm reads out of the
first process's mapped cache arena instead of refilling a private copy. Three
legs over one synthetic parquet store behind the :class:`LatencyFS` read
counter:

==================  ==========================================================
leg                 what runs
==================  ==========================================================
per-process         subprocess with ``PTPU_ARENA=off`` — today's private
                    caches; its per-batch (ids, sizes, crc) records are the
                    byte-identity baseline
arena-warm          this process reads with ``io_options.arena_bytes`` set:
                    creates the host arena and admits every decoded row
                    group + footer blob (the single-process warm set)
arena-attach        a fresh subprocess attaches via ``PTPU_TORCH_ARENA_ATTACH``
                    (the exact env handoff pool children get) and reads the
                    same store — its DRAIN must be served from the arena
==================  ==========================================================

Asserted invariants (``--smoke`` is the CI preset — tiny store, correctness
only, shared CI cores):

- **byte identity**: both arena legs deliver per-batch records identical to
  the ``PTPU_ARENA=off`` baseline;
- **warm attach, zero store IO**: the attacher's drain issues ZERO
  ``LatencyFS`` read calls and its arena hit ratio is >= 0.9;
- **zero-copy serves**: the attacher's ``arena_admit`` copy-census delta is
  0 — mapping an admitted entry charges nothing, only the original admit
  copied;
- **one warm set**: host-wide arena resident bytes after the attacher leg are
  <= 1.2x the single-process warm set (the attacher added ~nothing);
- **no leftovers**: after ``close()`` nothing named ``ptpu_torch_arena_*``
  survives in ``/dev/shm``.

Run as ``petastorm-tpu-torch-bench shmcache`` (or
``python -m petastorm_tpu_torch.benchmark.shmcache``). Port of
``petastorm_tpu.benchmark.shmcache``: its child legs run
``python -m petastorm_tpu_torch.benchmark.shmcache``; no loader runs here, but
``--device`` is checked like every harness's.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from petastorm_tpu_torch.benchmark import add_device_argument, require_device
from petastorm_tpu_torch.benchmark.io import LatencyFS, _drain, make_dataset


def _reader_opts(arena_mb):
    """One io_options dict for every leg: deterministic sequential scan, the
    arena budget the only variable (the PTPU_ARENA env decides per-process
    vs shared for the subprocess legs)."""
    return {"readahead": False, "work_stealing": False,
            "arena_bytes": arena_mb << 20}


def _run_leg(root, latency_s, arena_mb):
    """Scan the store once through a LatencyFS counter; returns the leg's
    report row (records, drain-phase read calls, arena funnel stats)."""
    import pyarrow.fs as pafs

    from petastorm_tpu_torch.io.lease import copy_census
    from petastorm_tpu_torch.reader import make_batch_reader

    fs = LatencyFS(pafs.LocalFileSystem(), latency_s)
    census_before = copy_census()
    with make_batch_reader("file://" + root, filesystem=fs,
                           reader_pool_type="dummy",
                           shuffle_row_groups=False, num_epochs=1,
                           io_options=_reader_opts(arena_mb)) as reader:
        construct_reads = fs.read_calls[0]
        t0 = time.perf_counter()
        rows, payload_bytes, records = _drain(reader, collect=True)
        elapsed = time.perf_counter() - t0
        io_stats = reader.io_stats()
    census_after = copy_census()
    hits = io_stats.get("arena_hits", 0)
    misses = io_stats.get("arena_misses", 0)
    looked = hits + misses
    return {
        "rows": rows,
        "payload_mb": round(payload_bytes / 1e6, 3),
        "seconds": round(elapsed, 4),
        "construct_read_calls": construct_reads,
        "drain_read_calls": fs.read_calls[0] - construct_reads,
        "arena_hits": hits,
        "arena_misses": misses,
        "arena_hit_ratio": round(hits / looked, 3) if looked else None,
        "arena_payload_bytes": io_stats.get("arena_payload_bytes", 0),
        "arena_admit_census_delta": (census_after.get("arena_admit", 0)
                                     - census_before.get("arena_admit", 0)),
        "records": records,
    }


def _child_main(args):
    """Internal subprocess entry (``--child``): attach the arena named by
    PTPU_TORCH_ARENA_ATTACH when present (exactly what a pool child's bootstrap
    does), run one leg, print the JSON report on the LAST stdout line."""
    from petastorm_tpu_torch.io import arena as arena_mod

    arena_mod.attach_from_env()
    report = _run_leg(args.root, args.latency_ms / 1e3, args.arena_mb)
    report["attached"] = arena_mod.process_arena() is not None
    arena_mod.close_process_arena()
    print(json.dumps(report))
    return 0


def _spawn_leg(root, latency_ms, arena_mb, env_overrides):
    """Run one leg in a fresh interpreter; returns its parsed JSON report."""
    env = dict(os.environ)
    env.update(env_overrides)
    cmd = [sys.executable, "-m", "petastorm_tpu_torch.benchmark.shmcache",
           "--child", "--root", root, "--latency-ms", str(latency_ms),
           "--arena-mb", str(arena_mb)]
    proc = subprocess.run(cmd, env=env, stdout=subprocess.PIPE, check=False)
    out = proc.stdout.decode("utf-8", "replace").strip().splitlines()
    if proc.returncode != 0 or not out:
        raise RuntimeError("shmcache child leg failed (rc=%d)"
                           % proc.returncode)
    return json.loads(out[-1])


def _records_key(records):
    """Normalize per-batch records through a JSON round trip so the in-process
    leg's tuples compare equal to the subprocess legs' parsed lists."""
    return json.loads(json.dumps(records))


def _shm_leftovers():
    from petastorm_tpu_torch.io.arena import ARENA_PREFIX

    try:
        return sorted(n for n in os.listdir("/dev/shm")
                      if n.startswith(ARENA_PREFIX))
    except OSError:
        return []  # no /dev/shm on this platform: nothing to leak


def run_shmcache_bench(rows=256, row_bytes=2048, rows_per_group=16, files=2,
                       latency_ms=1.0, arena_mb=64, root=None):
    """The three-leg harness; returns ``(results, failures)`` where every
    acceptance invariant that did not hold appends one message."""
    from petastorm_tpu_torch.io import arena as arena_mod
    from petastorm_tpu_torch.io.memcache import shared_store

    tmp = None
    if root is None:
        tmp = tempfile.TemporaryDirectory(prefix="ptpu-shmcache-bench-")
        root = tmp.name
    results = []
    failures = []
    try:
        make_dataset(root, rows, row_bytes, rows_per_group, files=files)

        # leg 1 — per-process baseline: a fresh interpreter with the arena
        # kill switch set; its records are the byte-identity reference
        base = _spawn_leg(root, latency_ms, arena_mb, {"PTPU_ARENA": "off"})
        base["leg"] = "per-process"
        baseline_records = _records_key(base.pop("records"))
        results.append(base)

        # leg 2 — arena warm: THIS process creates the host arena and fills
        # the one warm set (decoded row groups + footer blobs)
        warm = _run_leg(root, latency_ms / 1e3, arena_mb)
        warm["leg"] = "arena-warm"
        warm_records = _records_key(warm.pop("records"))
        results.append(warm)
        warm_set_bytes = warm["arena_payload_bytes"]
        token = arena_mod.current_token()
        if token is None:
            failures.append("arena-warm leg did not create a host arena "
                            "(shm unavailable?)")
            return results, failures
        if warm_records != baseline_records:
            failures.append("arena-warm leg delivered different batches than "
                            "the PTPU_ARENA=off baseline")

        # leg 3 — second attacher: a fresh interpreter joins via the same
        # PTPU_TORCH_ARENA_ATTACH handoff pool children get and drains warm
        attach = _spawn_leg(root, latency_ms, arena_mb,
                            {arena_mod.ENV_ATTACH: token})
        attach["leg"] = "arena-attach"
        attach_records = _records_key(attach.pop("records"))
        results.append(attach)

        if not attach.get("attached"):
            failures.append("attacher leg failed to attach the arena")
        if attach_records != baseline_records:
            failures.append("attacher leg delivered different batches than "
                            "the PTPU_ARENA=off baseline")
        if attach["drain_read_calls"] != 0:
            failures.append(
                "attacher drain issued %d store read calls (want 0: every "
                "row group served from the arena)"
                % attach["drain_read_calls"])
        ratio = attach.get("arena_hit_ratio")
        if ratio is None or ratio < 0.9:
            failures.append("attacher arena hit ratio %r < 0.9" % (ratio,))
        if attach["arena_admit_census_delta"] != 0:
            failures.append(
                "attacher charged %d arena_admit copy-census bytes (want 0: "
                "serves map, only the original admit copies)"
                % attach["arena_admit_census_delta"])
        if warm_set_bytes and \
                attach["arena_payload_bytes"] > 1.2 * warm_set_bytes:
            failures.append(
                "host-wide arena resident bytes %d > 1.2x the "
                "single-process warm set %d"
                % (attach["arena_payload_bytes"], warm_set_bytes))
        return results, failures
    finally:
        arena_mod.close_process_arena()
        shared_store().clear()
        leftovers = _shm_leftovers()
        if leftovers:
            failures.append("orphaned shm segments after close(): %s"
                            % ", ".join(leftovers))
        if tmp is not None:
            tmp.cleanup()


def _format_table(rows):
    cols = ("leg", "rows", "payload_mb", "seconds", "construct_read_calls",
            "drain_read_calls", "arena_hits", "arena_hit_ratio",
            "arena_payload_bytes")
    present = [c for c in cols if any(c in r for r in rows)]
    widths = [max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in present]
    lines = ["  ".join(c.ljust(w) for c, w in zip(present, widths))]
    for r in rows:
        lines.append("  ".join(str(r.get(c, "")).ljust(w)
                               for c, w in zip(present, widths)))
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-bench shmcache", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rows", type=int, default=2048)
    parser.add_argument("--row-bytes", type=int, default=16384,
                        help="binary payload bytes per row (default 16 KB)")
    parser.add_argument("--rows-per-group", type=int, default=64)
    parser.add_argument("--files", type=int, default=2)
    parser.add_argument("--latency-ms", type=float, default=5.0,
                        help="injected delay per file read call (object-store "
                             "round-trip emulation; 0 = bare local disk)")
    parser.add_argument("--arena-mb", type=int, default=256)
    parser.add_argument("--json", action="store_true", help="JSON lines output")
    parser.add_argument("--smoke", action="store_true",
                        help="CI preset: tiny dataset, correctness-only "
                             "(no throughput claims)")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--root", default=None, help=argparse.SUPPRESS)
    add_device_argument(parser)
    args = parser.parse_args(argv)

    if args.child:
        return _child_main(args)  # a leg of a run whose parent checked --device
    require_device(args.device)

    if args.smoke:
        kwargs = dict(rows=256, row_bytes=2048, rows_per_group=16, files=2,
                      latency_ms=1.0, arena_mb=64)
    else:
        kwargs = dict(rows=args.rows, row_bytes=args.row_bytes,
                      rows_per_group=args.rows_per_group, files=args.files,
                      latency_ms=args.latency_ms, arena_mb=args.arena_mb)

    results, failures = run_shmcache_bench(**kwargs, root=args.root)
    if args.json:
        for r in results:
            print(json.dumps(r))
    else:
        print(_format_table(results))
    if failures:
        for msg in failures:
            print("FAIL: %s" % msg)
        return 1
    print("shmcache: byte identity held; attacher drained warm from the "
          "arena with zero store reads and zero copy-census bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
