"""Remote read-path benchmark: the object-store tier under a cloud simulator.

Measures what :mod:`petastorm_tpu_torch.io.remote` was built for, with no
credentials and no network: every scenario scans a synthetic multi-file
parquet store through :class:`petastorm_tpu_torch.io.latencyfs.CloudLatencyFS`
(same-region profile — ~5 ms request floor, ~1 s/GB streaming, seeded
lognormal jitter and tail spikes) and asserts on the simulator's per-request
ledger, so the claims are GET counts and wall latencies, not vibes:

==============  ==========================================================
scenario        configuration
==============  ==========================================================
cold            remote tier on, footer cache OFF — every row-group read
                re-fetches the file footer (the metadata-plane round trips
                the cache exists to collapse)
footer-cached   footer cache ON — footers are fetched once per file per
                process, row-group reads issue data GETs only
unhedged-tail   seeded tail spikes injected, hedging OFF — epoch-2 p99
                batch latency eats the spikes
hedged-tail     hedging ON — a GET pending past the learned latency
                quantile gets a duplicate; first responder wins, the p99
                collapses toward the deadline (``hedge_wins > 0``)
tiered          memcache + footer cache + hedging (the production combo):
                epoch 2 serves from the mem tier — the warm epoch must beat
                the cold one ≥2×
==============  ==========================================================

``--check`` asserts every scenario's delivered batches are byte-identical
(ids, payload sizes, payload CRCs) to a plain local read, and that the run
leaked zero leases (hedge losers drain clean). ``--smoke`` is the CI preset:
tiny dataset, every assertion on, no throughput claims.

Run as ``petastorm-tpu-torch-bench remote``. Port of ``petastorm_tpu.benchmark.remote``;
no loader runs here, but ``--device`` is checked like every harness's.
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
from petastorm_tpu_torch.benchmark.io import make_dataset

SCENARIOS = ("cold", "footer-cached", "unhedged-tail", "hedged-tail", "tiered")

#: same-region object-store profile (a GCS-shaped bucket in the same region)
PROFILE = dict(base_latency_s=0.005, per_byte_s=1.0 / (1 << 30),
               jitter_sigma=0.1)

_TAIL = dict(tail_fraction=0.06, tail_multiplier=10.0)
_NO_TAIL = dict(tail_fraction=0.0, tail_multiplier=1.0)


def _scenario_config(scenario, memcache_mb, hedge_min_samples):
    """(fs kwargs, io_options dict, num_epochs) per scenario."""
    remote = dict(enabled=True, hedge=False, footer_cache_bytes=0,
                  hedge_min_samples=hedge_min_samples, hedge_quantile=0.9,
                  hedge_min_s=0.001)
    io_opts = dict(readahead=False, work_stealing=False, remote=remote)
    fs_kwargs = dict(PROFILE, **_NO_TAIL)
    epochs = 1
    if scenario == "cold":
        pass
    elif scenario == "footer-cached":
        remote["footer_cache_bytes"] = 64 << 20
    elif scenario == "unhedged-tail":
        remote["footer_cache_bytes"] = 64 << 20
        fs_kwargs.update(_TAIL)
        epochs = 2
    elif scenario == "hedged-tail":
        remote["footer_cache_bytes"] = 64 << 20
        remote["hedge"] = True
        fs_kwargs.update(_TAIL)
        epochs = 2
    elif scenario == "tiered":
        remote["footer_cache_bytes"] = 64 << 20
        remote["hedge"] = True
        io_opts["readahead"] = True
        io_opts["memcache_bytes"] = memcache_mb << 20
        epochs = 2
    else:
        raise ValueError(scenario)
    return fs_kwargs, io_opts, epochs


def _reset_process_state():
    """Scenario isolation: the footer cache, memcache store and latency model
    are process-wide by design — a bench comparing with/without must clear
    them between scenarios."""
    from petastorm_tpu_torch.io.footercache import shared_footer_cache
    from petastorm_tpu_torch.io.memcache import shared_store
    from petastorm_tpu_torch.io.remote import shared_latency_model

    shared_footer_cache().clear()
    shared_store().clear()
    shared_latency_model().reset()


def _drain_epochs(reader, num_epochs, collect):
    """Consume ``num_epochs`` epochs; per epoch returns (seconds, [per-batch
    wall latencies], [identity records])."""
    per_epoch = reader._num_items  # row groups per epoch (unfiltered scan)
    out = []
    t_epoch = t_prev = time.perf_counter()
    lat, records, batches = [], [], 0
    for batch in reader:
        now = time.perf_counter()
        lat.append(now - t_prev)
        t_prev = now
        if collect:
            ids = np.asarray(batch.id)
            sizes = [len(p) for p in batch.payload]
            crc = 0
            for p in batch.payload:
                crc = zlib.crc32(p, crc)
            records.append((ids.tolist(), sizes, crc))
        batches += 1
        if batches == per_epoch:
            out.append((time.perf_counter() - t_epoch, lat, records))
            t_epoch = t_prev = time.perf_counter()
            lat, records, batches = [], [], 0
    if batches:
        out.append((time.perf_counter() - t_epoch, lat, records))
    while len(out) < num_epochs:
        out.append((0.0, [], []))
    return out


def _footer_windows(file_sizes):
    """Each file's EXACT footer length (thrift + trailer) from its last 8
    bytes — so tail data GETs on small files never count as metadata GETs."""
    out = {}
    for path, size in file_sizes.items():
        with open(path, "rb") as f:
            f.seek(size - 8)
            out[path] = int.from_bytes(f.read(4), "little") + 8
    return out


def _p99(latencies):
    if not latencies:
        return 0.0
    ordered = sorted(latencies)
    return ordered[min(len(ordered) - 1, int(0.99 * (len(ordered) - 1)))]


def _leaked_leases():
    from petastorm_tpu_torch.obs.metrics import default_registry

    return default_registry().snapshot().get("ptpu_lease_leaked_total", 0)


def _measure_one(scenario, root, file_sizes, footer_windows, seed, memcache_mb,
                 hedge_min_samples, check):
    import pyarrow.fs as pafs

    from petastorm_tpu_torch.io.latencyfs import CloudLatencyFS
    from petastorm_tpu_torch.reader import make_batch_reader

    _reset_process_state()
    fs_kwargs, io_opts, epochs = _scenario_config(scenario, memcache_mb,
                                                  hedge_min_samples)
    fs = CloudLatencyFS(pafs.LocalFileSystem(), seed=seed, **fs_kwargs)
    with make_batch_reader("file://" + root, filesystem=fs,
                           reader_pool_type="dummy", shuffle_row_groups=False,
                           num_epochs=epochs, io_options=io_opts) as reader:
        # measure the READ PATH: construction (file listing, schema inference,
        # the planner's one footer scan per file) is identical across
        # scenarios and is dropped from the ledger here — the footer-cache
        # claim is about the scan-time re-reads N workers issue, and the
        # dummy pool reads nothing until the drain below starts
        fs.reset_accounting()
        t0 = time.perf_counter()
        epoch_results = _drain_epochs(reader, epochs, collect=check)
        elapsed = time.perf_counter() - t0
        io_stats = reader.io_stats()
    footer_gets = len(fs.footer_requests(file_sizes, footer_windows))
    last_seconds, last_lat, _ = epoch_results[-1]
    row = {
        "scenario": scenario,
        "epochs": epochs,
        "seconds": round(elapsed, 4),
        "gets": fs.request_count(),
        "footer_gets": footer_gets,
        "epoch_seconds": [round(e[0], 4) for e in epoch_results],
        "last_epoch_p99_ms": round(_p99(last_lat) * 1e3, 2),
        "hedges": io_stats.get("remote_hedges", 0),
        "hedge_wins": io_stats.get("remote_hedge_wins", 0),
        "sparse_fallbacks": io_stats.get("remote_sparse_fallbacks", 0),
        "tier_mem_hits": io_stats.get("tier_mem_hits", 0),
        "footer_cache_misses": io_stats.get("footer_cache_misses", 0),
    }
    records = [e[2] for e in epoch_results]
    return row, records


def _local_baseline(root, check):
    """The identity baseline: a plain local read with the remote tier off."""
    from petastorm_tpu_torch.reader import make_batch_reader

    with make_batch_reader("file://" + root, reader_pool_type="dummy",
                           shuffle_row_groups=False, num_epochs=1,
                           io_options=dict(readahead=False,
                                           remote=dict(enabled=False))) as reader:
        return _drain_epochs(reader, 1, collect=check)[0][2]


def run_remote_bench(files=4, rows_per_group=32, row_bytes=2048,
                     groups_per_file=8, seed=7, memcache_mb=256,
                     hedge_min_samples=8, scenarios=SCENARIOS, check=False,
                     smoke=False, workers_hint=4, root=None):
    """One result row per scenario, plus the cross-scenario assertions.

    ``workers_hint`` is the N in the footer-cache acceptance bar (metadata
    GETs cut ≥ N×): the per-thread ``ParquetFile`` footer re-reads this
    replaces scale with the worker count, so the cache must beat at least
    that."""
    tmp = None
    if root is None:
        tmp = tempfile.TemporaryDirectory(prefix="ptpu-remote-bench-")
        root = tmp.name
    try:
        rows = files * rows_per_group * groups_per_file
        make_dataset(root, rows, row_bytes, rows_per_group, files=files)
        file_sizes = {
            os.path.join(root, name): os.path.getsize(os.path.join(root, name))
            for name in os.listdir(root) if name.endswith(".parquet")}
        footer_windows = _footer_windows(file_sizes)
        leaked_before = _leaked_leases()
        baseline = _local_baseline(root, check) if check else None
        results = {}
        all_records = {}
        for scenario in scenarios:
            row, records = _measure_one(scenario, root, file_sizes,
                                        footer_windows, seed, memcache_mb,
                                        hedge_min_samples, check)
            results[scenario] = row
            all_records[scenario] = records
            if check:
                for i, epoch_records in enumerate(records):
                    if not epoch_records:
                        continue
                    if epoch_records != baseline:
                        raise AssertionError(
                            "scenario %r epoch %d delivered different batches "
                            "than the plain local read" % (scenario, i))
                row["identical_to_local"] = True
        checks = _assert_scenarios(results, scenarios, workers_hint,
                                   smoke=smoke)
        leaked = _leaked_leases() - leaked_before
        if check and leaked:
            raise AssertionError("%d lease(s) leaked during the bench (hedge "
                                 "losers must drain clean)" % leaked)
        checks["leaked_leases"] = leaked
        return list(results.values()), checks
    finally:
        _reset_process_state()
        if tmp is not None:
            tmp.cleanup()


def _assert_scenarios(results, scenarios, workers_hint, smoke):
    """The acceptance bars, computed (and, under --smoke, enforced)."""
    checks = {}
    cold = results.get("cold")
    cached = results.get("footer-cached")
    if cold and cached:
        ratio = cold["footer_gets"] / max(1, cached["footer_gets"])
        checks["footer_get_cut"] = round(ratio, 2)
        if smoke and ratio < workers_hint:
            raise AssertionError(
                "footer cache cut metadata GETs only %.1fx (%d -> %d); "
                "acceptance bar is >= %dx" % (ratio, cold["footer_gets"],
                                              cached["footer_gets"],
                                              workers_hint))
        if smoke and not cold["gets"] > cached["gets"]:
            raise AssertionError(
                "footer cache did not reduce total GET round trips "
                "(%d vs %d)" % (cold["gets"], cached["gets"]))
    unhedged = results.get("unhedged-tail")
    hedged = results.get("hedged-tail")
    if unhedged and hedged:
        checks["p99_unhedged_ms"] = unhedged["last_epoch_p99_ms"]
        checks["p99_hedged_ms"] = hedged["last_epoch_p99_ms"]
        checks["hedges"] = hedged["hedges"]
        checks["hedge_wins"] = hedged["hedge_wins"]
        if smoke:
            if hedged["hedges"] < 1 or hedged["hedge_wins"] < 1:
                raise AssertionError(
                    "hedging never fired/won under injected tail (hedges=%d, "
                    "wins=%d)" % (hedged["hedges"], hedged["hedge_wins"]))
            if not hedged["last_epoch_p99_ms"] < unhedged["last_epoch_p99_ms"]:
                raise AssertionError(
                    "hedged p99 batch latency (%.2f ms) did not beat unhedged "
                    "(%.2f ms) under injected tail"
                    % (hedged["last_epoch_p99_ms"],
                       unhedged["last_epoch_p99_ms"]))
    tiered = results.get("tiered")
    if tiered and len(tiered["epoch_seconds"]) >= 2:
        cold_s, warm_s = tiered["epoch_seconds"][0], tiered["epoch_seconds"][1]
        speedup = cold_s / warm_s if warm_s > 0 else float("inf")
        checks["tiered_warm_speedup"] = round(speedup, 2)
        if smoke:
            if tiered["tier_mem_hits"] < 1:
                raise AssertionError("tiered warm epoch never hit the mem tier")
            if speedup < 2.0:
                raise AssertionError(
                    "tiered warm epoch only %.2fx over cold (bar: >= 2x; "
                    "cold=%.3fs warm=%.3fs)" % (speedup, cold_s, warm_s))
    return checks


def _format_table(rows):
    cols = ("scenario", "epochs", "seconds", "gets", "footer_gets",
            "last_epoch_p99_ms", "hedges", "hedge_wins", "tier_mem_hits",
            "sparse_fallbacks")
    widths = [max(len(c), *(len(str(r.get(c, ""))) for r in rows)) for c in cols]
    lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths))]
    for r in rows:
        lines.append("  ".join(str(r.get(c, "")).ljust(w)
                               for c, w in zip(cols, widths)))
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-bench remote", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--files", type=int, default=4)
    parser.add_argument("--rows-per-group", type=int, default=32)
    parser.add_argument("--row-bytes", type=int, default=2048)
    parser.add_argument("--groups-per-file", type=int, default=8)
    parser.add_argument("--seed", type=int, default=7,
                        help="cloud simulator seed (jitter + tail spikes)")
    parser.add_argument("--memcache-mb", type=int, default=256)
    parser.add_argument("--workers-hint", type=int, default=4,
                        help="N in the footer-cache acceptance bar (metadata "
                             "GETs cut >= N x)")
    parser.add_argument("--scenarios", nargs="*", default=list(SCENARIOS),
                        choices=SCENARIOS)
    parser.add_argument("--check", action="store_true",
                        help="assert byte-identity vs a plain local read and "
                             "zero leaked leases")
    parser.add_argument("--json", action="store_true", help="JSON lines output")
    parser.add_argument("--smoke", action="store_true",
                        help="CI preset: tiny dataset, --check, and every "
                             "acceptance assertion enforced (footer-GET cut, "
                             "hedges fire and win, tiered warm >= 2x cold)")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    require_device(args.device)

    if args.smoke:
        kwargs = dict(files=3, rows_per_group=16, row_bytes=1024,
                      groups_per_file=8, seed=args.seed, memcache_mb=64,
                      hedge_min_samples=8, scenarios=SCENARIOS, check=True,
                      smoke=True, workers_hint=args.workers_hint)
    else:
        kwargs = dict(files=args.files, rows_per_group=args.rows_per_group,
                      row_bytes=args.row_bytes,
                      groups_per_file=args.groups_per_file, seed=args.seed,
                      memcache_mb=args.memcache_mb, hedge_min_samples=8,
                      scenarios=tuple(args.scenarios), check=args.check,
                      smoke=False, workers_hint=args.workers_hint)

    results, checks = run_remote_bench(**kwargs)
    if args.json:
        for r in results:
            print(json.dumps(r))
    else:
        print(_format_table(results))
    if "footer_get_cut" in checks:
        print("footer cache metadata-GET cut: %.1fx" % checks["footer_get_cut"])
    if "p99_hedged_ms" in checks:
        print("tail p99 batch latency: unhedged %.2f ms -> hedged %.2f ms "
              "(%d hedges, %d wins)"
              % (checks["p99_unhedged_ms"], checks["p99_hedged_ms"],
                 checks["hedges"], checks["hedge_wins"]))
    if "tiered_warm_speedup" in checks:
        print("tiered warm epoch speedup over cold: %.2fx"
              % checks["tiered_warm_speedup"])
    if kwargs["check"]:
        print("identity: all scenarios byte-identical to the local read; "
              "leaked leases: %d" % checks.get("leaked_leases", 0))
    print(json.dumps({"remote_summary": checks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
