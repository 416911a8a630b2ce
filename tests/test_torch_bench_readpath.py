"""The read-path harnesses of the port against the JAX package's: ``decompress``,
``io``, ``remote`` and ``shmcache``.

Each harness's ``--smoke`` runs green through the port's ``cli.main`` on ``--device
cpu`` (its own acceptance bars enforced), and what it counts equals the JAX harness's
on the same store and seed: the pass-through's bytes and pages, the rows and payload of
every read-path scenario, the metadata GETs of the simulator's scenarios, the arena
legs' rows and store reads. Timings are never compared across packages. The
``decompress`` and ``remote`` smokes assert bars on wall-clock rates (the ineligible
store's overhead, the hedged p99, the warm epoch's speedup): they take the best of three
attempts (``best_of_three``) on those bars alone; byte identity, counts and leaks fail
at once.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_bench_helpers import best_of_three, last_json, missed_bars  # noqa: E402
from _torch_bench_helpers import run_main, wall_clock  # noqa: E402
from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu.benchmark import cli as ref_cli  # noqa: E402
from petastorm_tpu.benchmark import io as ref_io  # noqa: E402
from petastorm_tpu.benchmark import remote as ref_remote  # noqa: E402
from petastorm_tpu.benchmark import shmcache as ref_shmcache  # noqa: E402
from petastorm_tpu_torch.benchmark import cli  # noqa: E402
from petastorm_tpu_torch.benchmark import io as io_bench  # noqa: E402
from petastorm_tpu_torch.benchmark import remote  # noqa: E402
from petastorm_tpu_torch.benchmark import shmcache  # noqa: E402

CPU = ["--device", "cpu"]
#: fragments of the messages of the bars that read the wall clock: decompress's rate on
#: an ineligible store; remote's hedges firing and winning, its hedged p99 and its warm
#: tier's speedup
DECOMPRESS_BARS = ("the classifier is not cheap",)
REMOTE_BARS = ("hedging never fired/won", "did not beat unhedged", "tiered warm epoch only")


def test_decompress_smoke_counts_the_reference_bytes_and_pages(capsys):
    def smoke():
        rc, out = run_main(cli.main, ["decompress", "--smoke"] + CPU, capsys)
        ours = last_json(out)
        missed_bars(ours["failures"], DECOMPRESS_BARS)
        assert rc == 0 and ours["ok"], out
        return ours

    ours = best_of_three(smoke)
    rc, out = run_main(ref_cli.main, ["decompress", "--smoke"], capsys)
    theirs = last_json(out)
    assert rc == 0 and theirs["ok"]
    for key in ("rows", "raw_bytes_per_batch", "shipped_bytes_per_batch", "h2d_ratio",
                "bytes_saved_total", "pages_shipped", "byte_identity_checked",
                "lease_leak_delta", "ineligible_degradations"):
        assert ours[key] == theirs[key], key
    assert ours["h2d_ratio"] <= 0.60


def test_io_smoke_delivers_the_reference_tables(capsys):
    rc, out = run_main(cli.main, ["io", "--smoke"] + CPU, capsys)
    assert rc == 0 and "identity: all checked scenarios delivered byte-identical" in out
    kwargs = dict(rows=256, row_bytes=2048, rows_per_group=16, files=2, latency_ms=1.0,
                  depth=4, io_threads=2, memcache_mb=64, check=True)
    ours = {r["scenario"]: r for r in io_bench.run_io_bench(**kwargs)}
    theirs = {r["scenario"]: r for r in ref_io.run_io_bench(**kwargs)}
    assert list(ours) == list(theirs) == list(io_bench.SCENARIOS)
    for name in ours:
        for key in ("rows", "payload_mb", "identical_to_sync"):
            assert ours[name].get(key) == theirs[name].get(key), (name, key)
    # the sync scan's read calls are the store's own (the caches' hit counts are
    # process-wide totals: the port's smoke above ran in this process, the JAX one not)
    assert ours["sync"]["read_calls"] == theirs["sync"]["read_calls"]


def test_io_drain_records_equal_the_reference(tmp_path):
    root = str(tmp_path / "io")
    import os

    os.makedirs(root)
    io_bench.make_dataset(root, 128, 512, 16, files=2)
    from petastorm_tpu.reader import make_batch_reader as ref_make_batch_reader
    from petastorm_tpu_torch.reader import make_batch_reader

    def drain(factory, module):
        with factory("file://" + root, reader_pool_type="dummy", shuffle_row_groups=False,
                     num_epochs=1) as reader:
            return module._drain(reader, collect=True)

    assert drain(make_batch_reader, io_bench) == drain(ref_make_batch_reader, ref_io)


def test_remote_smoke_cuts_the_reference_metadata_gets(capsys):
    def smoke():
        rc, out = wall_clock(lambda: run_main(cli.main, ["remote", "--smoke"] + CPU, capsys),
                             REMOTE_BARS)
        summary = last_json(out)["remote_summary"]
        assert rc == 0 and summary["leaked_leases"] == 0, out
        return summary

    summary = best_of_three(smoke)
    assert summary["footer_get_cut"] >= 4 and summary["hedge_wins"] >= 1
    assert summary["tiered_warm_speedup"] >= 2.0
    kwargs = dict(files=3, rows_per_group=16, row_bytes=1024, groups_per_file=8, seed=7,
                  memcache_mb=64, hedge_min_samples=8, scenarios=("cold", "footer-cached"),
                  check=True, smoke=False)
    ours, ours_checks = remote.run_remote_bench(**kwargs)
    theirs, theirs_checks = ref_remote.run_remote_bench(**kwargs)
    for a, b in zip(ours, theirs):
        assert a["scenario"] == b["scenario"] and a.get("identical_to_local")
        for key in ("epochs", "footer_gets"):
            assert a[key] == b[key], (a["scenario"], key)
    assert ours_checks["footer_get_cut"] == theirs_checks["footer_get_cut"]


def test_shmcache_smoke_serves_the_reference_legs(capsys):
    rc, out = run_main(cli.main, ["shmcache", "--smoke"] + CPU, capsys)
    assert rc == 0 and "shmcache: byte identity held" in out, out
    kwargs = dict(rows=128, row_bytes=1024, rows_per_group=16, files=2, latency_ms=0.5,
                  arena_mb=32)
    ours, ours_failures = shmcache.run_shmcache_bench(**kwargs)
    theirs, theirs_failures = ref_shmcache.run_shmcache_bench(**kwargs)
    assert not ours_failures and not theirs_failures, (ours_failures, theirs_failures)
    assert [r["leg"] for r in ours] == [r["leg"] for r in theirs]
    for a, b in zip(ours, theirs):
        for key in ("rows", "payload_mb", "drain_read_calls"):
            assert a[key] == b[key], (a["leg"], key)
    assert ours[-1]["arena_hit_ratio"] == 1.0 and ours[-1]["drain_read_calls"] == 0
