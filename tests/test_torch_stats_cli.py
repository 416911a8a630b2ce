"""The port's stats CLI (:mod:`petastorm_tpu_torch.obs.stats_cli`) against the JAX
package's: the same snapshot renders the same dashboard frame, string for string, on
every panel (the attribution and dataset-watch panels included), with and without a
snapshot history; the fleet merge renders the same frame; a snapshot holding tenant
series renders the same per-tenant panel.

The stats-CLI cases of the JAX package's ``tests/test_health.py``,
``tests/test_timeseries.py``, ``tests/test_obs.py`` and ``tests/test_provenance.py``
have counterparts here under their names, driven by the port's loader, Reporter and
registry.
"""
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu.obs import stats_cli as ref_cli  # noqa: E402
from petastorm_tpu.obs import timeseries as ref_ts  # noqa: E402
from petastorm_tpu_torch.obs import stats_cli as cli  # noqa: E402
from petastorm_tpu_torch.obs import timeseries as ts  # noqa: E402
from petastorm_tpu_torch.obs.export import (Reporter, read_latest_jsonl_snapshot,  # noqa: E402
                                            write_prometheus)
from petastorm_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402


def _hist(p50, p99, count=6, total=None):
    return {"count": count, "sum": total if total is not None else p50 * count,
            "mean": p50, "p50": p50, "p90": (p50 + p99) / 2, "p99": p99}


#: one snapshot a panel of the dashboard (the reference's families and label forms)
PANELS = {
    "verdict_and_pipeline": {
        "ptpu_pipeline_rows": 4096, "ptpu_pipeline_batches": 16,
        "ptpu_pipeline_read_s": 2.0, "ptpu_pipeline_batch_s": 0.1,
        "ptpu_pipeline_put_wait_s": 0.05, "ptpu_pipeline_queue_wait_s": 0.01,
        "ptpu_pipeline_decode_s": 0.3, "ptpu_pipeline_h2d_s": 0.2,
        "ptpu_pipeline_device_queue_wait_s": 0.4, "ptpu_pipeline_host_queue_depth": 3,
        "ptpu_pipeline_device_queue_depth": 1},
    "stages_and_workers": {
        'ptpu_pipeline_stage_seconds{stage="read"}': _hist(0.004, 0.03),
        'ptpu_pipeline_stage_seconds{stage="h2d"}': _hist(0.001, 0.002),
        'ptpu_worker_item_seconds{worker="0"}': _hist(0.01, 0.02, count=9),
        'ptpu_worker_item_seconds{worker="1"}': _hist(0.09, 0.2, count=4)},
    "health": {
        "ptpu_health_hb_age_s_loader.producer": 0.4,
        "ptpu_health_hb_age_s_worker.thread-0": 61.0,
        "ptpu_health_hb_stalled_worker.thread-0": 1,
        "ptpu_health_stalls_total": 2},
    "degradations": {'ptpu_degradations_total{cause="io_retry"}': 3,
                     'ptpu_degradations_total{cause="quarantined"}': 1,
                     'ptpu_degradations_total{cause="none"}': 0},
    "tiers_and_arena": {
        'ptpu_io_tier_hits_total{tier="mem"}': 5,
        'ptpu_io_tier_hits_total{tier="arena"}': 2,
        'ptpu_io_tier_bytes_total{tier="mem"}': 1e6,
        'ptpu_io_tier_bytes_total{tier="arena"}': 3e6,
        "ptpu_io_arena_entries": 7, "ptpu_io_arena_admits_total": 9,
        "ptpu_io_arena_hits_total": 6, "ptpu_io_arena_misses_total": 2,
        "ptpu_io_arena_bytes": 5.5e7, "ptpu_io_arena_attaches_total": 3,
        "ptpu_io_arena_evictions_total": 1},
    "remote": {
        "ptpu_io_remote_gets_total": 12, "ptpu_io_remote_bytes_total": 3.2e7,
        "ptpu_io_hedges_total": 4, "ptpu_io_hedge_wins_total": 3,
        "ptpu_io_remote_sparse_fallbacks_total": 0,
        "ptpu_io_footer_cache_hits_total": 9, "ptpu_io_footer_cache_misses_total": 1,
        'ptpu_io_remote_get_seconds{size_class="20",store="s"}': _hist(0.04, 0.2, 12)},
    "dataset_watch": {"ptpu_dataset_pieces_added_total": 4,
                      "ptpu_dataset_pieces_removed_total": 1,
                      "ptpu_dataset_plan_extensions_total": 2},
    "transform": {'ptpu_transform_seconds{op="normalize(x)"}': _hist(0.04, 0.1),
                  'ptpu_transform_seconds{op="bucketize(y)"}': _hist(0.01, 0.02, 3),
                  "ptpu_transform_rows_total": 384},
    "attribution": {"ptpu_prov_items": 6, "ptpu_prov_batches": 12,
                    "ptpu_prov_quarantined": 1, "ptpu_prov_duplicate_absorbs": 0,
                    "ptpu_prov_self_s_decode_device_inflate": 1.25,
                    "ptpu_prov_self_s_reader_read": 0.25,
                    "ptpu_prov_self_s_loader_h2d": 0.01},
    "pagedec": {"ptpu_pagedec_pages_total": 79, "ptpu_pagedec_fallback_columns_total": 1,
                "ptpu_pagedec_bytes_compressed_total": 2e6,
                "ptpu_pagedec_bytes_saved_h2d_total": 6e6,
                "ptpu_pagedec_inflate_seconds": _hist(0.002, 0.01, 30)},
    "transport": {"ptpu_net_connects_total": 2, "ptpu_net_reconnects_total": 1,
                  'ptpu_net_frames_total{dir="tx"}': 10,
                  'ptpu_net_frames_total{dir="rx"}': 12,
                  'ptpu_net_bytes_total{dir="tx"}': 1e5,
                  "ptpu_net_rtt_seconds": _hist(0.0002, 0.001, 8)},
    "slo_and_controller": {'ptpu_slo_alerts_total{slo="p99"}': 2,
                           "ptpu_ctl_windows": 5, "ptpu_ctl_actuations": 1,
                           "ptpu_ctl_knob_readahead_depth": 4,
                           "ptpu_ctl_knob_readahead_depth_default": 3,
                           "ptpu_ctl_knob_hedge_quantile": 0.95,
                           "ptpu_ctl_knob_hedge_quantile_default": 0.95},
    "service": {"ptpu_svc_workers": 2, "ptpu_svc_decodes_total": 10,
                "ptpu_svc_served_items_total": 20, "ptpu_svc_advised_workers": 3,
                'ptpu_svc_worker_decode_seconds{worker="w0"}': _hist(0.01, 0.02),
                'ptpu_svc_worker_decode_seconds{worker="w1"}': _hist(0.02, 0.05)},
    "other": {"ptpu_wire_bytes_total": 1234, "ptpu_lease_ratio": 0.25,
              "custom_latency_seconds": _hist(0.003, 0.009)},
}


@pytest.mark.parametrize("panel", sorted(PANELS))
def test_render_dashboard_equals_the_reference_on_every_panel(panel):
    metrics = PANELS[panel]
    assert cli.render_dashboard(metrics, title="t") \
        == ref_cli.render_dashboard(metrics, title="t")


def test_render_dashboard_equals_the_reference_on_all_panels_with_history():
    merged = {}
    for metrics in PANELS.values():
        merged.update(metrics)
    history = []
    for i in range(1, 6):
        frame = dict(merged)
        frame.update({"ptpu_pipeline_rows": 1000 * i,
                      "ptpu_dataset_pieces_added_total": i,
                      "ptpu_prov_self_s_reader_read": 0.1 * i,
                      "ptpu_io_arena_hits_total": 3 * i,
                      "ptpu_io_arena_misses_total": i,
                      "ptpu_net_reconnects_total": i // 2})
        history.append((float(i), frame))
    ours = cli.render_dashboard(history[-1][1], title="fleet", history=history)
    assert ours == ref_cli.render_dashboard(history[-1][1], title="fleet",
                                            history=history)
    assert "trends (last 5 windows):" in ours and "attribution" in ours
    assert "dataset watch:" in ours and "(+1 this window)" in ours


def test_render_merge_equals_the_reference(tmp_path):
    paths = []
    for i in range(2):
        p = str(tmp_path / ("s%d.jsonl" % i))
        _write_export(p, {"wall": 10.0, "perf": 0.0, "host": "h%d" % i, "pid": i},
                      [(1.0, 0), (2.0, 500 * (i + 1)), (3.0, 1000 * (i + 1))])
        paths.append(p)
    ours = cli.render_merge([ts.load_export(p) for p in paths])
    assert ours == ref_cli.render_merge([ref_ts.load_export(p) for p in paths])


def test_tenant_series_render_one_line_naming_item_8c():
    """Tenant series render the per-tenant panel (ported with item 8c(i)), the whole
    frame equal to the reference's; the tenant families stay out of the catch-all."""
    metrics = dict(PANELS["attribution"])
    metrics['ptpu_tenant_rows_total{tenant="b"}'] = 100
    metrics['ptpu_tenant_rows_total{tenant="a"}'] = 50
    metrics['ptpu_tenant_read_bytes_total{tenant="a"}'] = 1e6
    metrics['ptpu_tenant_worker_seconds_total{tenant="b"}'] = 2.5
    out = cli.render_dashboard(metrics)
    assert out == ref_cli.render_dashboard(metrics)
    lines = out.splitlines()
    start = lines.index("tenants (ptpu_tenant_*):")
    assert lines[start + 1].lstrip().startswith("b ")  # most worker seconds first
    assert lines[start + 2].lstrip().startswith("a ")
    assert "item 8c" not in out


def _write_export(path, anchor, rows_points):
    """A v2 Reporter JSONL stream: ``rows_points`` is ``[(perf, cumulative rows)]``."""
    with open(path, "w") as f:
        for perf, rows in rows_points:
            f.write(json.dumps({
                "schema": "ptpu-stats-v2", "ts": anchor["wall"] + perf, "perf": perf,
                "anchor": anchor,
                "metrics": {"ptpu_pipeline_rows": rows, "rows_total": rows}}) + "\n")


def _write_dataset(root, files=4, rows_per_file=64):
    for i in range(files):
        base = i * rows_per_file
        pq.write_table(
            pa.table({"id": np.arange(base, base + rows_per_file),
                      "x": np.random.default_rng(i).random(rows_per_file)}),
            os.path.join(str(root), "p%d.parquet" % i))
    return "file://" + str(root)


def _populated_registry():
    r = MetricsRegistry()
    r.counter("ptpu_degradations_total", help="by cause", cause="shm_unsupported").inc(2)
    h = r.histogram("ptpu_pipeline_stage_seconds", help="latency", stage="read")
    for v in (0.001, 0.002, 0.004, 0.1):
        h.observe(v)
    r.gauge("ptpu_depth").set(4)
    r.register_collector("pipeline", lambda: {"rows": 32})
    return r


# -- the JAX package's stats-CLI cases --------------------------------------------------


def test_dashboard_renders_health_sections(tmp_path, capsys):
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.obs.health import HealthOptions
    from petastorm_tpu_torch.reader import make_batch_reader

    os.makedirs(str(tmp_path / "data"))
    url = _write_dataset(tmp_path / "data")
    registry = MetricsRegistry()
    opts = HealthOptions(stall_threshold_s=60.0, poll_interval_s=1.0,
                         flight_path=str(tmp_path / "f.json"))
    jsonl = str(tmp_path / "stats.jsonl")
    reader = make_batch_reader(url, num_epochs=1, workers_count=2)
    with DataLoader(reader, 16, to_device=False, device="cpu", metrics=registry,
                    health=opts) as loader:
        for _ in loader:
            pass
        with Reporter(registry=registry, interval_s=600.0, jsonl_path=jsonl):
            pass  # the final flush writes one snapshot while the collectors are live
    with open(jsonl) as f:
        frame = cli.render_dashboard(json.loads(f.readline())["metrics"])
    assert "heartbeat ages:" in frame
    assert "stage latencies" in frame
    assert "workers:" in frame
    assert "verdict:" in frame
    # --watch --once: a single frame, exit 0 (the CI render check)
    assert cli.main(["--watch", "--once", jsonl]) == 0
    out = capsys.readouterr().out
    assert "petastorm-tpu-stats" in out and "heartbeat ages:" in out


def test_stats_cli_watch_file_form_parses(tmp_path, capsys):
    """``--watch FILE`` (the default-interval form) takes FILE as the path, not as the
    SECONDS value; with --once the test renders a single frame instead of looping."""
    registry = MetricsRegistry()
    registry.counter("ptpu_probe_total").inc()
    jsonl = str(tmp_path / "w.jsonl")
    with Reporter(registry=registry, interval_s=600.0, jsonl_path=jsonl):
        pass
    assert cli.main(["--once", "--watch", jsonl]) == 0
    assert "ptpu_probe_total" in capsys.readouterr().out
    # a real interval still parses as one
    assert cli.main(["--once", "--watch", "1.5", jsonl]) == 0


def test_dashboard_renders_prometheus_histograms(tmp_path, capsys):
    registry = MetricsRegistry()
    hist = registry.histogram("ptpu_pipeline_stage_seconds", stage="read")
    for v in (0.001, 0.002, 0.004, 0.1):
        hist.observe(v)
    registry.counter("ptpu_degradations_total", cause="test").inc(3)
    path = write_prometheus(str(tmp_path / "m.prom"), registry)
    assert cli.main([path]) == 0
    out = capsys.readouterr().out
    assert "stage latencies" in out
    assert "ptpu_degradations_total" in out
    # the folded histogram summaries are the reference's
    assert cli._load_snapshot(path) == ref_cli._load_snapshot(path)


def test_stats_cli_merge_renders(tmp_path, capsys):
    paths = []
    for i in range(2):
        p = str(tmp_path / ("s%d.jsonl" % i))
        _write_export(p, {"wall": 10.0, "perf": 0.0, "host": "h%d" % i, "pid": i},
                      [(1.0, 0), (2.0, 500 * (i + 1)), (3.0, 1000 * (i + 1))])
        paths.append(p)
    assert cli.main(["--merge"] + paths) == 0
    out = capsys.readouterr().out
    assert "fleet merge: 2 sources" in out
    assert "fleet totals (summed)" in out
    assert "rows=1000" in out and "rows=2000" in out  # per-source breakdown
    assert "rows=3000" in out                          # fleet total = the sum
    assert "fleet rows/s" in out
    assert cli.main(["--merge", str(tmp_path / "missing.jsonl")]) == 1


def test_render_dashboard_trends_and_window_deltas():
    def frame(rows, added, self_s):
        return {"ptpu_pipeline_rows": rows, "ptpu_pipeline_batches": 1,
                "ptpu_dataset_pieces_added_total": added,
                "ptpu_prov_self_s_io_remote": self_s,
                "ptpu_prov_items": 4, "ptpu_prov_batches": 2}

    history = [(float(i), frame(1000 * i, i, 0.1 * i)) for i in range(1, 5)]
    out = cli.render_dashboard(history[-1][1], history=history)
    assert "trends (last 4 windows):" in out
    assert "rows/s" in out
    assert "(+1 this window)" in out            # dataset-watch delta
    assert "(+0.100 this window)" in out        # attribution self-time delta
    # a single frame renders without any trend panel
    out_single = cli.render_dashboard(history[-1][1])
    assert "trends" not in out_single


def test_jsonl_reporter_and_stats_cli(tmp_path, capsys):
    r = _populated_registry()
    jsonl = str(tmp_path / "stats.jsonl")
    with Reporter(registry=r, interval_s=600.0, jsonl_path=jsonl):
        pass  # stop() flushes one final snapshot even on an instant run
    obj = read_latest_jsonl_snapshot(jsonl)
    assert obj is not None and "ts" in obj
    assert obj["metrics"]['ptpu_degradations_total{cause="shm_unsupported"}'] == 2
    # a torn final line (a live writer) is tolerated
    with open(jsonl, "a") as f:
        f.write('{"ts": 1, "metr')
    assert read_latest_jsonl_snapshot(jsonl)["metrics"] == obj["metrics"]
    assert cli.main([jsonl]) == 0
    out = capsys.readouterr().out
    assert "ptpu_degradations_total" in out
    assert "p50" in out  # a histogram summary line
    assert cli.main([str(tmp_path / "missing.jsonl")]) == 1


def test_stats_cli_reads_prometheus_file(tmp_path, capsys):
    path = write_prometheus(str(tmp_path / "m.prom"), _populated_registry())
    assert cli.main([path]) == 0
    assert "ptpu_depth" in capsys.readouterr().out


def test_dashboard_renders_remote_tier_transform_and_prov_panels():
    metrics = {
        "ptpu_io_tier_hits_total{tier=\"mem\"}": 5,
        "ptpu_io_tier_hits_total{tier=\"remote\"}": 2,
        "ptpu_io_tier_bytes_total{tier=\"mem\"}": 1e6,
        "ptpu_io_tier_bytes_total{tier=\"remote\"}": 2e6,
        "ptpu_io_remote_gets_total": 12,
        "ptpu_io_remote_bytes_total": 3.2e7,
        "ptpu_io_hedges_total": 4,
        "ptpu_io_hedge_wins_total": 3,
        "ptpu_io_remote_sparse_fallbacks_total": 0,
        "ptpu_io_footer_cache_hits_total": 9,
        "ptpu_io_footer_cache_misses_total": 1,
        "ptpu_io_remote_get_seconds{size_class=\"20\",store=\"s\"}":
            {"count": 12, "sum": 0.6, "mean": 0.05, "p50": 0.04, "p90": 0.09,
             "p99": 0.2},
        "ptpu_transform_seconds{op=\"normalize(x)\"}":
            {"count": 6, "sum": 0.3, "mean": 0.05, "p50": 0.04, "p90": 0.08,
             "p99": 0.1},
        "ptpu_transform_rows_total": 384,
        "ptpu_prov_items": 6,
        "ptpu_prov_batches": 12,
        "ptpu_prov_quarantined": 1,
        "ptpu_prov_self_s_io_remote": 1.25,
        "ptpu_prov_self_s_transform": 0.25,
    }
    out = cli.render_dashboard(metrics, title="t")
    assert "cache tiers:" in out and "remote hits=2" in out
    assert "remote io:" in out and "hedges=4 (wins=3)" in out
    assert "footer cache: hits=9" in out
    assert "transform ops" in out and "normalize(x)" in out
    assert "attribution" in out and "io_remote" in out
    assert "quarantined items: 1" in out
    # the families no longer spill into the catch-all section
    assert "other metrics:" not in out
    assert out == ref_cli.render_dashboard(metrics, title="t")


def test_attribution_panel_from_a_provenance_loader(tmp_path):
    """A provenance loader's Reporter JSONL renders the attribution panel with the
    recorder's own per-site self seconds."""
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.obs import provenance as prov
    from petastorm_tpu_torch.reader import make_batch_reader

    os.makedirs(str(tmp_path / "data"))
    url = _write_dataset(tmp_path / "data")
    registry = MetricsRegistry()
    jsonl = str(tmp_path / "prov.jsonl")
    try:
        reader = make_batch_reader(url, num_epochs=1, workers_count=1,
                                   reader_pool_type="dummy", provenance=True)
        with DataLoader(reader, 32, to_device=False, device="cpu",
                        metrics=registry) as loader:
            for _ in loader:
                pass
            with Reporter(registry=registry, interval_s=600.0, jsonl_path=jsonl):
                pass
            summary = loader.provenance.summary()
    finally:
        prov.ACTIVE = None
    with open(jsonl) as f:
        metrics = json.loads(f.readline())["metrics"]
    out = cli.render_dashboard(metrics)
    assert "attribution (critical-path self time, 4 items / 8 batches):" in out
    assert "reader_read" in out
    assert metrics["ptpu_prov_self_s_reader_read"] == summary["self_s_reader_read"]
    assert out == ref_cli.render_dashboard(metrics)
