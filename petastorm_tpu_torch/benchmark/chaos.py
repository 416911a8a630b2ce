"""Chaos acceptance harness: scripted fault scenarios against the
real pipeline, asserting the invariant that makes the recovery machinery
production-grade:

    **every planned row is either delivered exactly once or listed in the
    quarantine report — no hangs, no duplicates, no leaked leases or slabs.**

Each scenario arms a deterministic :class:`petastorm_tpu_torch.chaos.FaultPlan`,
runs a full epoch through ``make_batch_reader`` (readahead on; the process
pool runs the shm **view** wire, so slab leases are live under fault), and
checks:

- ``delivered ∪ quarantined == plan`` with the two sets disjoint and the
  delivered ids duplicate-free (quarantined ids are recovered by reading the
  quarantined row groups straight from parquet);
- ``ptpu_lease_leaked_total`` moved by exactly 0 during the scenario;
- for the shm wire, the pool's slab ring reports no in-flight slabs after the
  epoch (nothing wedged);
- the ``stall-heal`` scenario additionally requires the watchdog's ``heal``
  escalation to recover a LIVE injected hang without the consumer ever seeing
  :class:`~petastorm_tpu_torch.errors.StallError`, while the respawn budget lasts.

Scenarios: ``transient-io`` (seeded transient read errors on the sync AND
readahead paths, absorbed by the shared retry budget), ``kills`` (children
SIGKILL-equivalent mid-item — re-dispatch on respawn — plus one poison item
that kills every child it meets and must be quarantined), ``poison`` (an item
that deterministically raises in the worker), ``corrupt`` (a flipped byte in
a wire payload — absorbed by re-dispatch, never delivered corrupt),
``stall-heal`` (an injected in-child hang healed in place), and
``mutating-dataset`` (seeded ``append_piece``/``remove_file``/
``rewrite_file`` actions fired at the watcher's ``dataset.mutate`` hook while
an epoch runs on dummy, thread AND process pools — asserting delivered ∪
quarantined == final plan, disjoint and duplicate-free, no batch mixing two
generations of one file, zero leaked leases; plus a ``num_epochs=None`` run
that must observe an appended piece through the live watch thread).

``--smoke`` is the CI preset: tiny dataset, every scenario on BOTH the thread
and process pools (where the fault applies to that pool), hard asserts on the
invariant. The full mode grows the dataset and prints per-scenario timings.

Run as ``petastorm-tpu-torch-bench chaos`` (or ``python -m
petastorm_tpu_torch.benchmark.cli chaos``). Port of ``petastorm_tpu.benchmark.chaos``; the
scenarios drive readers, not loaders, but ``--device`` is checked like every harness's.
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


def _write_dataset(root, files, rows_per_file):
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(11)
    for i in range(files):
        base = i * rows_per_file
        table = pa.table({
            "id": np.arange(base, base + rows_per_file, dtype=np.int64),
            "x": rng.random(rows_per_file),
        })
        # one row group per file: plan ordinals map 1:1 to files, so scenario
        # item_keys ("ordinal=3") pin faults to a known set of ids
        pq.write_table(table, os.path.join(root, "part_%03d.parquet" % i),
                       row_group_size=rows_per_file)


def _quarantined_ids(report):
    """Recover the rows the quarantine skipped by reading the quarantined row
    groups straight from parquet — the ground truth the invariant diffs."""
    import pyarrow.parquet as pq

    ids = []
    for entry in report:
        pf = pq.ParquetFile(entry.path)
        ids.extend(pf.read_row_group(entry.row_group, columns=["id"])
                   .column("id").to_pylist())
    return ids


def _leaked_total():
    from petastorm_tpu_torch.obs.metrics import default_registry

    return default_registry().counter("ptpu_lease_leaked_total").value


def _run_scenario(name, root, expected_ids, pool, plan, recovery=None,
                  wire=None, health=None, workers=2, timeout_s=180.0,
                  transport=None):
    """One epoch under an armed plan; returns the scenario result dict and
    raises AssertionError the moment the invariant breaks."""
    import gc

    from petastorm_tpu_torch import chaos
    from petastorm_tpu_torch.reader import make_batch_reader

    gc.collect()  # settle any straggler leases from a previous scenario
    leaked_before = _leaked_total()
    t0 = time.perf_counter()
    stall_error = None
    monitor = None
    with chaos.armed(plan):
        reader = make_batch_reader(
            "file://" + root, num_epochs=1, shuffle_row_groups=False,
            reader_pool_type=pool, workers_count=workers,
            results_timeout_s=timeout_s, wire_serializer=wire,
            recovery=recovery, transport=transport)
        delivered = []
        wire_stats = {}
        try:
            if health is not None:
                from petastorm_tpu_torch.obs.health import HealthMonitor

                monitor = HealthMonitor(health)
                reader.set_health(monitor)
                monitor.start()
            try:
                for batch in reader:
                    delivered.extend(int(v) for v in np.asarray(batch.id))
            except Exception as e:  # noqa: BLE001 — classified below
                from petastorm_tpu_torch.errors import StallError

                if isinstance(e, StallError):
                    stall_error = e
                else:
                    raise
            report = reader.quarantine_report
            wire_stats = reader.wire_stats()
        finally:
            reader.stop()
            reader.join()
            if monitor is not None:
                monitor.stop()
    duration = time.perf_counter() - t0
    gc.collect()  # any lease dropped without release would count as a leak now
    leak_delta = _leaked_total() - leaked_before

    quarantined = _quarantined_ids(report)
    result = {
        "scenario": name, "pool": pool, "wire": wire or "default",
        "transport": transport or "pipe",
        "delivered": len(delivered), "quarantined_items": len(report),
        "quarantined_rows": len(quarantined),
        "injected": plan.stats()["injected_total"],
        "lease_leak_delta": leak_delta, "seconds": round(duration, 3),
        "heals": monitor.heal_count if monitor is not None else 0,
    }
    # -- the invariant ------------------------------------------------------------------
    assert stall_error is None, \
        "%s: consumer saw %r despite the heal tier" % (name, stall_error)
    assert len(delivered) == len(set(delivered)), \
        "%s: duplicate rows delivered" % name
    assert not (set(delivered) & set(quarantined)), \
        "%s: rows both delivered AND quarantined" % name
    assert sorted(delivered + quarantined) == expected_ids, \
        "%s: delivered ∪ quarantined != plan (%d + %d vs %d)" \
        % (name, len(delivered), len(quarantined), len(expected_ids))
    assert leak_delta == 0, \
        "%s: ptpu_lease_leaked_total moved by %d" % (name, leak_delta)
    in_flight = wire_stats.get("shm_slabs_in_flight")
    assert not in_flight, \
        "%s: %s slabs still in flight after the epoch" % (name, in_flight)
    return result


def _scenarios(files, smoke):
    """(name, pools, plan factory, recovery, needs_health) — plan factories
    build a FRESH plan per run (hit ledgers are stateful)."""
    from petastorm_tpu_torch.chaos import FaultPlan, FaultRule
    from petastorm_tpu_torch.recovery import RecoveryOptions

    mid = "ordinal=%d" % (files // 2)
    quarantine = RecoveryOptions(on_poison="quarantine", poison_attempts=2,
                                 worker_respawns=4 * files,
                                 io_retry_backoff_s=0.01)
    return [
        ("transient-io", ("thread", "process"), lambda: FaultPlan([
            # every 3rd read attempt resets: absorbed by the shared retry
            # budget (a retry attempt hits the site again, so the budget is
            # genuinely spent). The readahead site gets LATENCY, not a raise:
            # a background-read failure re-raises at get() with no extra
            # retries by contract (pinned in test_io_retry), so a raise
            # there is a poison-policy scenario, not a transient one.
            FaultRule("reader.read", "raise_transient", every=3),
            FaultRule("io.readahead", "latency", every=2, latency_s=0.02),
        ], seed=7), RecoveryOptions(io_retries=3, io_retry_backoff_s=0.01),
            None),
        ("poison", ("thread", "process"), lambda: FaultPlan([
            FaultRule("worker.item", "raise_permanent", item_key=mid),
            FaultRule("child.item", "raise_permanent", item_key=mid),
        ], seed=7), quarantine, None),
        ("kills", ("process",), lambda: FaultPlan([
            # every child (original or respawned) dies at its 2nd item: pure
            # respawn-and-re-dispatch traffic ...
            FaultRule("child.item", "kill", nth=2, times=1),
            # ... plus one poison item that kills EVERY child it meets and
            # must end up quarantined (uncharged respawns)
            FaultRule("child.item", "kill", item_key=mid),
        ], seed=7), quarantine, None),
        ("corrupt", ("process",), lambda: FaultPlan([
            FaultRule("wire.decode", "corrupt", nth=2, times=1),
        ], seed=7), quarantine, None),
        ("stall-heal", ("process",), lambda: FaultPlan([
            # every child (original AND respawned) hangs once, at its 2nd
            # item: the heal tier must keep killing/respawning until the plan
            # drains — budget scaled to the plan so heal, not StallError, is
            # what carries the epoch
            FaultRule("child.item", "hang", nth=2, times=1,
                      hang_s=60.0),
        ], seed=7), RecoveryOptions(worker_respawns=4 * files), "heal"),
    ]


# -- network scenario --------------------------------------------------------------------


def _run_transport_identity(root, expected_count):
    """Clean-run twin check: the default pipe pool and the tcp pool must
    deliver BYTE-IDENTICAL payloads (per-id crc over the float column) — the
    framed transport is a wire, not a transform."""
    import zlib

    from petastorm_tpu_torch.reader import make_batch_reader

    def run(transport):
        reader = make_batch_reader(
            "file://" + root, num_epochs=1, shuffle_row_groups=False,
            reader_pool_type="process", workers_count=2, transport=transport)
        out = {}
        try:
            for batch in reader:
                for i, x in zip(np.asarray(batch.id), np.asarray(batch.x)):
                    out[int(i)] = zlib.crc32(np.float64(x).tobytes())
        finally:
            reader.stop()
            reader.join()
        return out

    pipe, tcp = run(None), run("tcp")
    assert len(pipe) == expected_count, len(pipe)
    assert pipe == tcp, \
        "transport identity: pipe vs tcp delivered payloads differ"
    return len(pipe)


def _run_network(root, expected_ids, timeout_s=180.0):
    """Seeded partition/reset/slow/corrupt-frame injection on a loopback
    ``TcpTransport`` pool. ``worker_respawns=0`` makes the assertion sharp:
    every injected link fault must be absorbed by RECONNECT + ledgered
    re-dispatch alone (a reconnect slower than the configured ceiling would
    surface as ``WorkerDiedError`` and fail the scenario), and no plan item
    may quarantine — link faults re-dispatch, they do not poison."""
    from petastorm_tpu_torch.chaos import FaultPlan, FaultRule
    from petastorm_tpu_torch.obs.metrics import default_registry
    from petastorm_tpu_torch.recovery import RecoveryOptions

    recovery = RecoveryOptions(
        on_poison="quarantine", poison_attempts=10, worker_respawns=0,
        io_retry_backoff_s=0.01, link_heartbeat_s=0.2, link_miss_threshold=3,
        link_reconnect_s=8.0, link_connect_timeout_s=5.0)
    plan = FaultPlan([
        FaultRule("transport.send", "net.slow", every=7, latency_s=0.005),
        FaultRule("transport.send", "net.reset", nth=5, times=1),
        FaultRule("transport.send", "net.corrupt_frame", nth=11, times=1),
        # the drop window (latency_s) sits ABOVE the half-open threshold
        # (miss_threshold x heartbeat = 0.6s): detection — and therefore
        # teardown + re-dispatch — is guaranteed, not probabilistic
        FaultRule("transport.send", "net.partition", nth=17, times=1,
                  latency_s=1.0),
    ], seed=7)
    reconnects = default_registry().counter("ptpu_net_reconnects_total")
    before = reconnects.value
    result = _run_scenario("network", root, expected_ids, "process", plan,
                           recovery=recovery, transport="tcp",
                           timeout_s=timeout_s)
    delta = reconnects.value - before
    assert delta >= 1, \
        "network: no transport reconnect observed (delta=%d)" % delta
    assert result["quarantined_items"] == 0, \
        "network: link faults must re-dispatch, not quarantine (%d items)" \
        % result["quarantined_items"]
    result["reconnects"] = delta
    return result


# -- mutating-dataset scenario ------------------------------------------------------------

#: the id range rewritten generations start at — far above any planned id, so
#: "a new-generation row leaked into the epoch" is one integer comparison
_REWRITE_BASE = 10_000_000


def _expected_ids_for_entry(entry, rows_per_file, files):
    """A quarantined entry's planned ids by NAME CONVENTION (the file may be
    removed or rewritten — reading it back is impossible or wrong)."""
    name = os.path.basename(entry.path)
    if name.startswith("part_zz"):
        return list(range(files * rows_per_file,
                          (files + 1) * rows_per_file))
    index = int(name.split("_")[1].split(".")[0])
    return list(range(index * rows_per_file, (index + 1) * rows_per_file))


def _run_mutating_dataset(pool, files, rows, timeout_s=180.0):
    """One epoch under seeded dataset mutations driven through the
    ``dataset.mutate`` chaos hook: append at tick 1, remove + rewrite (of the
    two LAST files, still pending behind the throttled consumer) at tick 2.
    Asserts the exactly-once-or-quarantined invariant over the FINAL plan
    (initial ∪ appended ids), no mixed generations, zero leaked leases."""
    import time as _time

    from petastorm_tpu_torch import chaos
    from petastorm_tpu_torch.chaos import FaultPlan, FaultRule
    from petastorm_tpu_torch.dataset.mutate import LocalDatasetMutator
    from petastorm_tpu_torch.reader import make_batch_reader
    from petastorm_tpu_torch.recovery import RecoveryOptions

    root = tempfile.mkdtemp(prefix="ptpu-chaos-mut-")
    try:
        _write_dataset(root, files, rows)
        remove_name = "part_%03d.parquet" % (files - 1)
        rewrite_name = "part_%03d.parquet" % (files - 2)
        plan = FaultPlan([
            FaultRule("dataset.mutate", "append_piece", nth=1, times=1,
                      target={"name": "part_zz0.parquet",
                              "start": files * rows, "rows": rows}),
            FaultRule("dataset.mutate", "remove_file", nth=2, times=1,
                      target={"name": remove_name}),
            FaultRule("dataset.mutate", "rewrite_file", nth=2, times=1,
                      target={"name": rewrite_name, "start": _REWRITE_BASE,
                              "rows": rows}),
        ], seed=11)
        recovery = RecoveryOptions(on_poison="quarantine", poison_attempts=2,
                                   io_retries=1, io_retry_backoff_s=0.01,
                                   worker_respawns=4 * files)
        leaked_before = _leaked_total()
        t0 = time.perf_counter()
        with chaos.armed(plan):
            reader = make_batch_reader(
                "file://" + root, num_epochs=1, shuffle_row_groups=False,
                reader_pool_type=pool, workers_count=2, results_queue_size=2,
                results_timeout_s=timeout_s,
                wire_serializer="shm-view" if pool == "process" else None,
                recovery=recovery, watch={"interval_s": 0.1})
            mutator = LocalDatasetMutator(root)
            reader.dataset_watcher.set_mutator(mutator)
            delivered = []
            wire_stats = {}
            try:
                for batch in reader:
                    delivered.extend(int(v) for v in np.asarray(batch.id))
                    # throttle until the seeded mutations have all fired AND
                    # the watcher has applied the resulting deltas — the
                    # bounded results queue holds the plan open meanwhile, so
                    # the appended piece joins THIS epoch deterministically
                    deadline = _time.monotonic() + 60.0
                    while (plan.stats()["injected_total"] < 3
                           or reader.io_stats().get("watch_deltas", 0) < 1) \
                            and _time.monotonic() < deadline:
                        _time.sleep(0.02)
                report = reader.quarantine_report
                wire_stats = reader.wire_stats()
            finally:
                reader.stop()
                reader.join()
        duration = time.perf_counter() - t0
        import gc

        gc.collect()
        leak_delta = _leaked_total() - leaked_before

        assert plan.stats()["injected_total"] == 3, plan.stats()
        assert len(mutator.applied) == 3, mutator.applied
        quarantined = []
        for entry in report:
            quarantined.extend(_expected_ids_for_entry(entry, rows, files))
        expected = list(range((files + 1) * rows))  # initial ∪ appended
        # -- the invariant, over the final plan ------------------------------------------
        new_gen = [i for i in delivered if i >= _REWRITE_BASE]
        assert not new_gen, \
            "mutating-dataset(%s): rewritten generation leaked into the " \
            "epoch (%d rows)" % (pool, len(new_gen))
        assert len(delivered) == len(set(delivered)), \
            "mutating-dataset(%s): duplicate rows delivered" % pool
        assert not (set(delivered) & set(quarantined)), \
            "mutating-dataset(%s): rows both delivered AND quarantined" % pool
        assert sorted(delivered + quarantined) == expected, \
            "mutating-dataset(%s): delivered ∪ quarantined != final plan " \
            "(%d + %d vs %d)" % (pool, len(delivered), len(quarantined),
                                 len(expected))
        assert leak_delta == 0, \
            "mutating-dataset(%s): ptpu_lease_leaked_total moved by %d" \
            % (pool, leak_delta)
        in_flight = wire_stats.get("shm_slabs_in_flight")
        assert not in_flight, \
            "mutating-dataset(%s): %s slabs still in flight" % (pool, in_flight)
        return {
            "scenario": "mutating-dataset", "pool": pool,
            "wire": "shm-view" if pool == "process" else "default",
            "delivered": len(delivered), "quarantined_items": len(report),
            "quarantined_rows": len(quarantined), "injected": 3,
            "lease_leak_delta": leak_delta, "seconds": round(duration, 3),
            "heals": 0,
        }
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)


def _run_infinite_watch(files, rows, timeout_s=60.0):
    """num_epochs=None acceptance: the LIVE watch thread (no manual polling)
    must observe a chaos-appended piece and feed it to the consumer within
    the run's deadline (~a handful of 0.1s watch intervals)."""
    import time as _time

    from petastorm_tpu_torch import chaos
    from petastorm_tpu_torch.chaos import FaultPlan, FaultRule
    from petastorm_tpu_torch.dataset.mutate import LocalDatasetMutator
    from petastorm_tpu_torch.reader import make_batch_reader

    root = tempfile.mkdtemp(prefix="ptpu-chaos-watch-")
    try:
        _write_dataset(root, files, rows)
        appended = set(range(files * rows, (files + 1) * rows))
        plan = FaultPlan([
            FaultRule("dataset.mutate", "append_piece", nth=2, times=1,
                      target={"name": "part_zz0.parquet",
                              "start": files * rows, "rows": rows}),
        ], seed=13)
        t0 = time.perf_counter()
        seen = False
        with chaos.armed(plan):
            reader = make_batch_reader(
                "file://" + root, num_epochs=None, shuffle_row_groups=False,
                reader_pool_type="thread", workers_count=2,
                results_queue_size=2, results_timeout_s=timeout_s,
                watch={"interval_s": 0.1})
            reader.dataset_watcher.set_mutator(LocalDatasetMutator(root))
            deadline = _time.monotonic() + timeout_s
            try:
                for batch in reader:
                    if {int(v) for v in np.asarray(batch.id)} & appended:
                        seen = True
                        break
                    if _time.monotonic() > deadline:
                        break
            finally:
                reader.stop()
                reader.join()
        assert seen, \
            "infinite-watch: the appended piece never reached the consumer " \
            "within %.0fs" % timeout_s
        return {"scenario": "infinite-watch", "pool": "thread",
                "wire": "default", "delivered": len(appended),
                "quarantined_items": 0, "quarantined_rows": 0, "injected": 1,
                "lease_leak_delta": 0,
                "seconds": round(time.perf_counter() - t0, 3), "heals": 0}
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-bench chaos", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--smoke", action="store_true",
                        help="CI preset: tiny dataset, all scenarios, hard "
                             "asserts on the exactly-once-or-quarantined "
                             "invariant and zero leaked leases")
    parser.add_argument("--files", type=int, default=None,
                        help="parquet files (= plan items); default 8 "
                             "(smoke) / 16")
    parser.add_argument("--rows-per-file", type=int, default=None,
                        help="rows per file; default 64 (smoke) / 512")
    parser.add_argument("--scenario", default=None,
                        help="run only this scenario (by name)")
    parser.add_argument("scenario_pos", nargs="?", default=None,
                        metavar="SCENARIO",
                        help="positional form of --scenario "
                             "(petastorm-tpu-torch-bench chaos network --smoke)")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    require_device(args.device)
    args.scenario = args.scenario or args.scenario_pos

    files = args.files or (8 if args.smoke else 16)
    rows = args.rows_per_file or (64 if args.smoke else 512)
    results = []
    with tempfile.TemporaryDirectory(prefix="ptpu-chaos-") as root:
        _write_dataset(root, files, rows)
        expected = list(range(files * rows))
        for name, pools, plan_fn, recovery, heal in _scenarios(files,
                                                               args.smoke):
            if args.scenario and name != args.scenario:
                continue
            for pool in pools:
                health = None
                if heal == "heal":
                    from petastorm_tpu_torch.obs.health import HealthOptions

                    health = HealthOptions(
                        stall_threshold_s=1.5, poll_interval_s=0.3,
                        escalation="heal", thresholds={"child": 1.5},
                        flight_path=os.path.join(root, "chaos_flight.json"))
                wire = "shm-view" if pool == "process" else None
                result = _run_scenario(
                    name, root, expected, pool, plan_fn(), recovery=recovery,
                    wire=wire, health=health)
                if heal == "heal":
                    assert result["heals"] >= 1, \
                        "stall-heal: watchdog never healed (heals=0)"
                print("chaos %-13s %-8s delivered=%-6d quarantined=%-3d "
                      "injected=%-3d heals=%d leak_delta=%d %.2fs"
                      % (name, pool, result["delivered"],
                         result["quarantined_rows"], result["injected"],
                         result["heals"], result["lease_leak_delta"],
                         result["seconds"]))
                results.append(result)

        # network scenario: seeded link faults on the loopback
        # tcp transport — reconnect + ledgered re-dispatch must carry the
        # epoch with a ZERO respawn budget; plus the clean-run pipe-vs-tcp
        # byte-identity twin
        if not args.scenario or args.scenario == "network":
            count = _run_transport_identity(root, len(expected))
            print("chaos %-13s %-8s pipe vs tcp byte-identical over %d rows"
                  % ("transport-id", "process", count))
            result = _run_network(root, expected)
            print("chaos %-13s %-8s delivered=%-6d quarantined=%-3d "
                  "injected=%-3d reconnects=%d leak_delta=%d %.2fs"
                  % ("network", "process", result["delivered"],
                     result["quarantined_rows"], result["injected"],
                     result["reconnects"], result["lease_leak_delta"],
                     result["seconds"]))
            results.append(result)

    # mutating-dataset runs against its own per-run dataset dirs
    # (the mutations destroy them); at least 16 files so the pools' claimed/
    # prefetched window never covers the remove/rewrite targets
    if not args.scenario or args.scenario == "mutating-dataset":
        mut_files = max(files, 16)
        for pool in ("dummy", "thread", "process"):
            result = _run_mutating_dataset(pool, mut_files, rows)
            print("chaos %-13s %-8s delivered=%-6d quarantined=%-3d "
                  "injected=%-3d heals=%d leak_delta=%d %.2fs"
                  % (result["scenario"], pool, result["delivered"],
                     result["quarantined_rows"], result["injected"],
                     result["heals"], result["lease_leak_delta"],
                     result["seconds"]))
            results.append(result)
        result = _run_infinite_watch(4, rows)
        print("chaos %-13s %-8s appended piece observed live in %.2fs"
              % (result["scenario"], result["pool"], result["seconds"]))
        results.append(result)

    summary = {
        "chaos_summary": {
            "scenarios": results,
            "invariant": "delivered ∪ quarantined == plan; no duplicates; "
                         "zero leaked leases/slabs; no hangs; no batch mixes "
                         "two generations of one file",
            "ok": True,
        }
    }
    print(json.dumps(summary, ensure_ascii=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
