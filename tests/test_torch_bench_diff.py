"""Run diffs and the trend gate: :mod:`petastorm_tpu_torch.obs.diff` and
:mod:`petastorm_tpu_torch.benchmark.trend` against the JAX package's.

The ``test_bench_diff_*`` cases and ``test_diff_self_times_significance_and_new_sites``
of the JAX package's ``tests/test_timeseries.py`` have counterparts here under their
names. Beside them: the gate's history loading and its seed, pass and fail verdicts
(every run passes ``--history`` under the test's temporary directory, so no repository
file is written), and cross-reading: the port's ``diff`` reads a JAX-written trend
entry, and the JAX package's reads a port-written one, with equal verdict lines.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu.benchmark import trend as ref_trend  # noqa: E402
from petastorm_tpu.obs import diff as ref_diff  # noqa: E402
from petastorm_tpu.obs import provenance as ref_prov  # noqa: E402
from petastorm_tpu_torch.benchmark import trend  # noqa: E402
from petastorm_tpu_torch.obs import diff  # noqa: E402
from petastorm_tpu_torch.obs import provenance as prov  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_plane():
    for mod in (prov, ref_prov):
        mod.ACTIVE = None
    yield
    for mod in (prov, ref_prov):
        mod.ACTIVE = None


def _run_entry(rows, sites, schema="ptpu-bench-trend-v2", **extra):
    return dict({"schema": schema, "ts": 1.0, "workload": "f3-r1024-b128",
                 "rows_per_s": rows, "sites": sites}, **extra)


def test_bench_diff_names_regressed_site():
    a = _run_entry(50000, {"io.remote": 0.42, "transform": 0.60,
                           "wire.roundtrip": 0.20}, step_p99_s=0.010)
    b = _run_entry(36000, {"io.remote": 0.97, "transform": 0.61,
                           "wire.roundtrip": 0.21}, step_p99_s=0.025)
    verdict = diff.diff_runs(a, b)
    assert verdict["regressed_site"] == "io.remote"
    assert verdict["regressed_site_ratio"] == pytest.approx(2.31, abs=0.01)
    assert verdict["rows_per_s_delta"] == pytest.approx(-0.28)
    assert "io.remote self-time 2.3x" in verdict["verdict"]
    assert verdict["verdict"].startswith("rows/s -28.0%")
    assert verdict == ref_diff.diff_runs(a, b)


def test_bench_diff_ignores_noise_sites():
    # the 40x blowup on a 0.1% site must not outrank the flat dominant site
    a = _run_entry(1000, {"transform": 10.0, "tiny.site": 0.001})
    b = _run_entry(990, {"transform": 10.1, "tiny.site": 0.04})
    verdict = diff.diff_runs(a, b)
    assert verdict["regressed_site"] is None
    assert "tiny.site" not in verdict["site_ratios"]
    assert verdict == ref_diff.diff_runs(a, b)


def test_bench_diff_hedge_note():
    a = _run_entry(1000, {"io.remote": 1.0}, io={"hedges": 100, "hedge_wins": 80})
    b = _run_entry(700, {"io.remote": 2.0}, io={"hedges": 100, "hedge_wins": 20})
    verdict = diff.diff_runs(a, b)
    assert "hedge win rate 80% -> 20%" in verdict["verdict"]
    assert verdict == ref_diff.diff_runs(a, b)


def test_bench_diff_tenant_breakdown_equals_the_reference():
    """Entries that carry per-tenant site maps (written by the JAX package's tenant
    workloads) diff as the reference diffs them."""
    a = _run_entry(1000, {"io.remote": 1.0},
                   tenants={"a": {"io.remote": 0.5}, "b": {"io.remote": 0.5}})
    b = _run_entry(800, {"io.remote": 1.4},
                   tenants={"a": {"io.remote": 0.5}, "b": {"io.remote": 1.1}})
    verdict = diff.diff_runs(a, b)
    assert "tenant b's io.remote self-time 2.2x" in verdict["verdict"]
    assert verdict == ref_diff.diff_runs(a, b)
    assert diff.render(verdict, a, b) == ref_diff.render(verdict, a, b)


def test_bench_diff_cli_on_synthetic_regression(tmp_path, capsys):
    """The CLI's one-line JSON verdict names the regressed site on a synthetic
    regression."""
    a = tmp_path / "run_a.json"
    b = tmp_path / "run_b.json"
    a.write_text(json.dumps(_run_entry(50000, {"io.remote": 0.42, "transform": 0.60})))
    b.write_text(json.dumps(_run_entry(36000, {"io.remote": 0.97, "transform": 0.61})))
    assert diff.main([str(a), str(b)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    verdict = json.loads(out[-1])  # the LAST line is the JSON verdict
    assert verdict["schema"] == "ptpu-bench-diff-v1"
    assert verdict["regressed_site"] == "io.remote"
    assert "<-- regressed" in "\n".join(out[:-1])
    # --fail-threshold turns the regression into a failing exit code
    assert diff.main([str(a), str(b), "--fail-threshold", "0.1"]) == 1
    capsys.readouterr()
    # a reference that resolves to nothing is exit 2
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert diff.main([str(a), "7", "--history", str(empty)]) == 2
    capsys.readouterr()


def test_bench_diff_history_indices(tmp_path, capsys):
    history = tmp_path / "hist.jsonl"
    with open(history, "w") as f:
        for rows in (50000, 48000, 36000):
            f.write(json.dumps(_run_entry(rows, {"io.remote": 0.4})) + "\n")
        f.write("not json\n")  # foreign lines are skipped
    assert diff.load_run("latest", history=str(history))["rows_per_s"] == 36000
    assert diff.load_run("prev", history=str(history))["rows_per_s"] == 48000
    assert diff.load_run("0", history=str(history))["rows_per_s"] == 50000
    with pytest.raises(ValueError, match="out of range"):
        diff.load_run("7", history=str(history))
    # v1 entries load too (schema compatibility)
    v1 = tmp_path / "old.json"
    v1.write_text(json.dumps(_run_entry(100, {}, schema="ptpu-bench-trend-v1")))
    assert diff.load_run(str(v1))["rows_per_s"] == 100


def test_diff_self_times_significance_and_new_sites():
    from petastorm_tpu_torch.obs.critical_path import diff_self_times

    out = diff_self_times({"a": 1.0, "noise": 0.001},
                          {"a": 3.0, "noise": 0.1, "new.site": 2.0})
    sites = {site: ratio for site, ratio, _x, _y in out}
    assert "noise" not in sites
    assert sites["a"] == pytest.approx(3.0)
    assert sites["new.site"] > 100  # new work: a huge ratio against the floor
    assert out[0][0] == "new.site"  # sorted worst first


# -- the trend gate ---------------------------------------------------------------------


def test_trend_schema_is_the_reference_schema():
    assert trend.SCHEMA == ref_trend.SCHEMA
    assert trend.ACCEPTED_SCHEMAS == ref_trend.ACCEPTED_SCHEMAS


def test_load_history_filters_schema_and_workload(tmp_path):
    history = tmp_path / "h.jsonl"
    with open(history, "w") as f:
        f.write(json.dumps(_run_entry(10.0, {})) + "\n")
        f.write(json.dumps(dict(_run_entry(20.0, {}), workload="f4-r2048-b256")) + "\n")
        f.write(json.dumps(_run_entry(30.0, {}, schema="ptpu-bench-trend-v1")) + "\n")
        f.write(json.dumps(_run_entry(40.0, {}, schema="something-else")) + "\n")
        f.write(json.dumps(_run_entry(0, {})) + "\n")  # no rows: skipped
        f.write("{torn\n")
    assert [e["rows_per_s"] for e in trend.load_history(str(history))] == [10, 20, 30]
    assert [e["rows_per_s"] for e in
            trend.load_history(str(history), workload="f3-r1024-b128")] == [10, 30]
    assert trend.load_history(str(tmp_path / "missing.jsonl")) == []
    for workload in (None, "f3-r1024-b128"):
        assert trend.load_history(str(history), workload) \
            == ref_trend.load_history(str(history), workload)


def test_trend_gate_seeds_with_a_real_run_on_the_cpu(tmp_path, capsys):
    """A real smoke run (the port's reader and loader with provenance on) seeds an empty
    history: exit 0, one entry appended, carrying the per-site self times."""
    history = str(tmp_path / "hist.jsonl")
    assert trend.main(["--history", history, "--smoke", "--epochs", "1",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "seeded" in out
    entries = trend.load_history(history)
    assert len(entries) == 1
    entry = entries[0]
    assert entry["schema"] == trend.SCHEMA and entry["workload"] == "f3-r1024-b128"
    assert entry["rows_per_s"] > 0 and entry["baseline_rows_per_s"] is None
    assert entry["sites"] and {"reader.read", "io.readahead"} & set(entry["sites"])
    assert json.loads(out.strip().splitlines()[-1]) == entry
    assert prov.ACTIVE is None  # every epoch's recorder was released


def _fixed_measure(rate, sites):
    def measure(files=4, rows_per_file=2048, batch_size=256, epochs=5, device=None):
        return rate, [rate] * epochs, {"sites": dict(sites), "step_p99_s": 0.01}
    return measure


def test_trend_gate_passes_and_fails_against_the_history_median(tmp_path, monkeypatch,
                                                                 capsys):
    history = str(tmp_path / "hist.jsonl")
    monkeypatch.setattr(trend, "measure", _fixed_measure(
        1000.0, {"reader.read": 0.5, "loader.collate": 0.1}))
    assert trend.main(["--history", history, "--device", "cpu"]) == 0  # seed
    assert trend.main(["--history", history, "--device", "cpu"]) == 0  # pass
    capsys.readouterr()
    # within the 30% margin: pass
    monkeypatch.setattr(trend, "measure", _fixed_measure(
        800.0, {"reader.read": 0.6, "loader.collate": 0.1}))
    assert trend.main(["--history", history, "--device", "cpu"]) == 0
    assert "gate fails below -30%" in capsys.readouterr().out
    # beyond it: fail, the entry still appended, the regressed site named
    monkeypatch.setattr(trend, "measure", _fixed_measure(
        500.0, {"reader.read": 1.5, "loader.collate": 0.1}))
    assert trend.main(["--history", history, "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "FAIL: throughput regressed" in out
    assert "why: rows/s -50.0%: reader.read self-time 3.0x" in out
    entries = trend.load_history(history)
    assert len(entries) == 4 and entries[-1]["regressed"] is True
    # --dry-run compares and appends nothing
    assert trend.main(["--history", history, "--device", "cpu", "--dry-run"]) == 1
    assert len(trend.load_history(history)) == 4


def test_cross_reading_of_the_two_packages_histories(tmp_path, monkeypatch, capsys):
    """A history holding a JAX-written entry then a port-written one (each written by
    its package's own gate): both packages' ``diff`` print the same verdict line."""
    history = str(tmp_path / "hist.jsonl")
    monkeypatch.setattr(ref_trend, "measure", _fixed_measure(
        1200.0, {"reader.read": 0.4, "wire.roundtrip": 0.3}))
    assert ref_trend.main(["--history", history]) == 0
    monkeypatch.setattr(trend, "measure", _fixed_measure(
        700.0, {"reader.read": 1.2, "wire.roundtrip": 0.3}))
    assert trend.main(["--history", history, "--device", "cpu"]) == 1
    capsys.readouterr()
    verdicts = []
    for main in (diff.main, ref_diff.main):
        assert main(["-2", "-1", "--history", history]) == 0
        verdicts.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdicts[0] == verdicts[1]
    verdict = json.loads(verdicts[0])
    assert verdict["schema"] == "ptpu-bench-diff-v1"
    assert verdict["regressed_site"] == "reader.read"
    # and the other way round: a port-written entry first, a JAX-written one second
    history2 = str(tmp_path / "hist2.jsonl")
    assert trend.main(["--history", history2, "--device", "cpu"]) == 0
    assert ref_trend.main(["--history", history2]) == 0
    capsys.readouterr()
    for main in (diff.main, ref_diff.main):
        assert main(["prev", "latest", "--history", history2]) == 0
        verdicts.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdicts[2] == verdicts[3]
