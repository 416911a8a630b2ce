"""``python -m petastorm_tpu_torch.obs.stats_cli``: terminal dashboard for a run's metrics.

Port of ``petastorm_tpu.obs.stats_cli``: the same frames from the same snapshots. Reads
what a :class:`petastorm_tpu_torch.obs.export.Reporter` writes (a JSONL snapshot stream,
last line wins, so it works against a file another process is appending to) or a
Prometheus text file, and renders one dashboard frame: the bottleneck verdict, stage
latency percentiles, queue depths, heartbeat ages (stalled actors flagged), per-worker
latencies, degradation counts, the cache tiers and arena, the remote read path, the
dataset-watch counters, the transform ops, the attribution panel (the provenance plane's
``ptpu_prov_*`` per-site critical-path self seconds), the pass-through, the transport,
SLO alerts, the controller and the data service. Against multi-line JSONL streams (and
in ``--watch`` mode) the frame gains sparkline trend columns (rows/s, stage p99,
mem-tier share) and window-over-window deltas on the dataset-watch and attribution
panels.

    python -m petastorm_tpu_torch.obs.stats_cli run_stats.jsonl            # one frame
    python -m petastorm_tpu_torch.obs.stats_cli --watch run_stats.jsonl    # every 2s
    python -m petastorm_tpu_torch.obs.stats_cli --watch 0.5 metrics.prom   # every 0.5s
    python -m petastorm_tpu_torch.obs.stats_cli --watch --once stats.jsonl # ONE frame
    python -m petastorm_tpu_torch.obs.stats_cli --merge a.jsonl b.json ... # fleet merge:
        several processes' or hosts' exports (Reporter JSONL streams and/or the scrape
        endpoint's /timelines JSON documents) into one dashboard, totals summed per
        family, a per-source breakdown and the fleet rows/s sparkline, windows aligned
        on each source's (wall, perf) clock anchor.

A snapshot holding ``ptpu_tenant_*`` series renders the per-tenant panel
(:class:`~petastorm_tpu_torch.obs.tenant.TenantUsageReport`), tenants ranked by worker
seconds.

Exit codes: 0 printed a snapshot, 1 no snapshot found / unreadable file.
"""
from __future__ import annotations

import argparse
import os
import re
import sys
import time


def _load_snapshot(path):
    """{metric full name: number-or-histogram-summary} from either format."""
    from petastorm_tpu_torch.obs.export import (
        parse_prometheus_text,
        read_latest_jsonl_snapshot,
    )

    with open(path, "r") as f:
        head = f.read(1)
    if head == "{":  # Reporter JSONL stream
        obj = read_latest_jsonl_snapshot(path)
        return None if obj is None else obj["metrics"]
    with open(path, "r") as f:
        return _fold_prom_histograms(parse_prometheus_text(f.read()))


def _load_history(path, limit=40):
    """Recent ``(t, metrics)`` snapshots from a Reporter JSONL stream, oldest
    first (the sparkline feed); None for Prometheus files (the watch loop
    accumulates its own frames there). Times sit on the anchored timeline
    when the stream carries the v2 (wall, perf) anchor."""
    from petastorm_tpu_torch.obs.export import read_recent_jsonl_snapshots
    from petastorm_tpu_torch.obs.timeseries import _anchored_t

    with open(path, "r") as f:
        if f.read(1) != "{":
            return None
    return [(_anchored_t(snap), snap["metrics"])
            for snap in read_recent_jsonl_snapshots(path, limit=limit)]


_BUCKET_RE = re.compile(r"^(?P<name>\w+)_bucket(?P<labels>\{.*\})$")


def _fold_prom_histograms(samples):
    """Collapse Prometheus ``_bucket``/``_sum``/``_count`` sample triplets into
    the same summary-dict shape JSONL snapshots carry (count/sum/mean/p50/p90/
    p99), so the renderer has ONE histogram representation."""
    out = {}
    hists = {}  # base full name (labels minus le) -> [(upper, cumulative)]
    for name, value in samples.items():
        m = _BUCKET_RE.match(name)
        if m:
            # anchor `le` as a whole label name: an unanchored match would
            # also hit inside labels merely ENDING in le (handle=, role=)
            labels = re.sub(r',le="[^"]*"|(?<=\{)le="[^"]*",?', "",
                            m.group("labels"))
            labels = "" if labels == "{}" else labels
            base = m.group("name") + labels
            le = re.search(r'(?<=[{,])le="([^"]*)"', name).group(1)
            upper = float("inf") if le == "+Inf" else float(le)
            hists.setdefault(base, []).append((upper, value))
            continue
        out[name] = value
    for base, buckets in hists.items():
        count = out.pop(base + "_count", None)
        total = out.pop(base + "_sum", 0.0)
        # reconstruct labeled _count/_sum keys too (labels ride on base)
        if count is None:
            bare = re.match(r"^(\w+)(\{.*\})?$", base)
            count = out.pop("%s_count%s" % (bare.group(1), bare.group(2) or ""),
                            None)
            total = out.pop("%s_sum%s" % (bare.group(1), bare.group(2) or ""),
                            0.0)
        buckets.sort()
        if count is None:
            count = buckets[-1][1] if buckets else 0
        summary = {"count": int(count), "sum": total,
                   "mean": (total / count) if count else 0.0}
        for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            target = q * count
            val = 0.0
            prev_finite = 0.0
            if count:
                for upper, cum in buckets:
                    if cum >= target:
                        # +Inf bucket matches: report the last finite bound
                        val = prev_finite if upper == float("inf") else upper
                        break
                    if upper != float("inf"):
                        prev_finite = upper
            summary[key] = val
        out[base] = summary
    return out


def _labeled(metrics, family):
    """``{label value: metric value}`` for one single-label family."""
    out = {}
    prefix = family + "{"
    for name, value in metrics.items():
        if name.startswith(prefix):
            m = re.search(r'="([^"]*)"', name)
            if m:
                out[m.group(1)] = value
    return out


def _pipeline_stats_from(metrics):
    """Reconstruct a ``PipelineStats.snapshot()``-shaped dict from the exported
    ``ptpu_pipeline_*`` families (None when the run exported none)."""
    prefix = "ptpu_pipeline_"
    snap = {}
    for name, value in metrics.items():
        if name.startswith(prefix) and "{" not in name \
                and isinstance(value, (int, float)):
            snap[name[len(prefix):]] = value
    return snap or None


def _fmt_ms(v):
    return "%8.2f" % (v * 1e3)


def _history_series(history, fn):
    """Apply ``fn(metrics) -> value|None`` over snapshot history (oldest
    first); returns the value series."""
    return [fn(m) for _t, m in history]


def _delta_series(history, key):
    """Window deltas of one cumulative scalar across the history, divided by
    the window length (a rate series); None where the series is absent."""
    out = []
    prev = None
    for t, m in history:
        v = m.get(key)
        if not isinstance(v, (int, float)):
            out.append(None)
            prev = None
            continue
        if prev is None:
            out.append(None)
        else:
            pv, pt = prev
            dt = max(1e-9, t - pt)
            out.append(max(0.0, v - pv) / dt)
        prev = (v, t)
    return out


def _render_trends(lines, history):
    """Sparkline trend panel over the snapshot history: rows/s
    and mem-tier hit share from window deltas, read p99 from each snapshot's
    cumulative histogram summary (JSONL lines carry summaries, not buckets —
    the label says "cum"; scrape ``/timelines`` for true per-window p99)."""
    from petastorm_tpu_torch.obs.timeseries import sparkline

    if len(history) < 3:
        return
    rows = _delta_series(history, "ptpu_pipeline_rows")

    def stage_p99(m):
        s = m.get('ptpu_pipeline_stage_seconds{stage="read"}')
        return s.get("p99") if isinstance(s, dict) else None

    p99s = _history_series(history, stage_p99)

    def mem_share(m):
        hits = {t: m.get('ptpu_io_tier_hits_total{tier="%s"}' % t, 0)
                for t in ("mem", "arena", "disk", "remote")}
        total = sum(v for v in hits.values() if isinstance(v, (int, float)))
        return (hits.get("mem", 0) / total) if total else None

    shares = _history_series(history, mem_share)

    # arena trends: hit ratio from window deltas of the
    # hit/miss counters (the CUMULATIVE ratio the static panel shows goes
    # flat the moment the warm set stabilizes — the windowed one moves), and
    # resident bytes straight off the gauge
    arena_hit_rates = _delta_series(history, "ptpu_io_arena_hits_total")
    arena_miss_rates = _delta_series(history, "ptpu_io_arena_misses_total")
    arena_ratio = []
    for h, miss in zip(arena_hit_rates, arena_miss_rates):
        if h is None and miss is None:
            arena_ratio.append(None)
            continue
        h, miss = h or 0.0, miss or 0.0
        arena_ratio.append(h / (h + miss) if (h + miss) else None)

    def arena_bytes(m):
        v = m.get("ptpu_io_arena_bytes")
        return v if isinstance(v, (int, float)) and v else None

    arena_res = _history_series(history, arena_bytes)
    panel = []
    for label, series, fmt in (
            ("rows/s", rows, lambda v: "%.0f" % v),
            ("read p99 ms (cum)", p99s, lambda v: "%.2f" % (v * 1e3)),
            ("mem-tier share", shares, lambda v: "%.0f%%" % (100 * v)),
            ("arena hit ratio", arena_ratio, lambda v: "%.0f%%" % (100 * v)),
            ("arena res MB", arena_res, lambda v: "%.1f" % (v / 1e6))):
        present = [v for v in series if v is not None]
        if not present:
            continue
        panel.append("  %-16s %s  now %s"
                     % (label, sparkline(series), fmt(present[-1])))
    if panel:
        lines.append("trends (last %d windows):" % len(history))
        lines.extend(panel)


def _fmt_delta(cur, prev, as_int=True):
    """`` (+N this window)`` suffix, empty when unchanged/unknown."""
    if prev is None or cur is None:
        return ""
    d = cur - prev
    if not d:
        return ""
    return " (%+d this window)" % d if as_int else " (%+.3f this window)" % d


def render_dashboard(metrics, title="", history=None):
    """One dashboard frame (a plain string — the CLI prints it, tests assert
    on it). Sections appear only when their families are present, so the same
    renderer serves a bare-metrics run and a full health-enabled one.
    ``history`` is an optional oldest-first ``[(t, metrics)]`` list (the
    current snapshot last) enabling the sparkline trend panel and the
    window-over-window deltas."""
    lines = []
    history = history or []
    prev_metrics = history[-2][1] if len(history) >= 2 else {}
    if title:
        lines.append(title)
        lines.append("=" * min(78, max(20, len(title))))

    snap = _pipeline_stats_from(metrics)
    worker_lat = _labeled(metrics, "ptpu_worker_item_seconds")
    worker_lat = {k: v for k, v in worker_lat.items() if isinstance(v, dict)}

    # -- verdict first: the one line an operator reads under pager pressure
    # (computed ONCE per frame; the utilization detail rides right below it)
    if snap is not None and snap.get("batches"):
        from petastorm_tpu_torch.obs.analyze import analyze_snapshot

        report = analyze_snapshot(snap, worker_latency=worker_lat or None)
        lines.append("verdict: %s" % report.verdict)
        lines.append("  %s" % report.reason)
        if report.utilization:
            lines.append("  utilization: " + "  ".join(
                "%s %.0f%%" % (side, 100 * report.utilization[side])
                for side in sorted(report.utilization)))

    # -- pipeline counters + queue depths
    if snap is not None:
        lines.append("pipeline: rows=%d batches=%d  host_queue=%d  "
                     "device_queue=%d"
                     % (snap.get("rows", 0), snap.get("batches", 0),
                        snap.get("host_queue_depth", 0),
                        snap.get("device_queue_depth", 0)))

    # -- sparkline trends over the snapshot history
    _render_trends(lines, history)

    # -- stage latency percentiles
    stages = _labeled(metrics, "ptpu_pipeline_stage_seconds")
    stages = {k: v for k, v in stages.items() if isinstance(v, dict)}
    if stages:
        lines.append("stage latencies (ms):   %8s %8s %8s %8s"
                     % ("p50", "p90", "p99", "count"))
        for stage in sorted(stages):
            s = stages[stage]
            lines.append("  %-20s %s %s %s %8d"
                         % (stage, _fmt_ms(s.get("p50", 0)),
                            _fmt_ms(s.get("p90", 0)), _fmt_ms(s.get("p99", 0)),
                            s.get("count", 0)))

    # -- per-worker latency (straggler fodder)
    if worker_lat:
        from petastorm_tpu_torch.obs.analyze import detect_straggler

        straggler = detect_straggler(worker_lat)
        parts = []
        for w in sorted(worker_lat):
            s = worker_lat[w]
            flag = " [STRAGGLER]" if straggler \
                and straggler["worker"] == str(w) else ""
            parts.append("w%s %.1fms×%d%s"
                         % (w, s.get("mean", 0) * 1e3, s.get("count", 0), flag))
        lines.append("workers: " + "  ".join(parts))

    # -- heartbeats (the health layer's export)
    ages = {name[len("ptpu_health_hb_age_s_"):]: v
            for name, v in metrics.items()
            if name.startswith("ptpu_health_hb_age_s_")}
    if ages:
        stalled = {name[len("ptpu_health_hb_stalled_"):]: v
                   for name, v in metrics.items()
                   if name.startswith("ptpu_health_hb_stalled_")}
        parts = []
        for actor in sorted(ages, key=lambda a: -ages[a]):
            flag = " [STALLED]" if stalled.get(actor) else ""
            parts.append("%s %.1fs%s" % (actor, ages[actor], flag))
        lines.append("heartbeat ages: " + "  ".join(parts))
        stalls = metrics.get("ptpu_health_stalls_total", 0)
        if stalls:
            lines.append("stalls detected: %d (see the flight record)"
                         % int(stalls))

    # -- degradations by cause
    degr = _labeled(metrics, "ptpu_degradations_total")
    degr = {k: v for k, v in degr.items() if v}
    if degr:
        lines.append("degradations (ptpu_degradations_total): " + "  ".join(
            "%s=%d" % (c, degr[c]) for c in sorted(degr)))

    # -- cache-tier funnel (dedicated panel, not "other")
    tier_hits = _labeled(metrics, "ptpu_io_tier_hits_total")
    tier_bytes = _labeled(metrics, "ptpu_io_tier_bytes_total")
    if any(tier_hits.values()):
        lines.append("cache tiers:  " + "  ".join(
            "%s hits=%d (%.1f MB)" % (t, int(tier_hits.get(t, 0)),
                                      tier_bytes.get(t, 0) / 1e6)
            for t in ("mem", "arena", "disk", "remote") if tier_hits.get(t)))

    # -- host-wide cache arena (dedicated panel, not "other")
    arena_entries = metrics.get("ptpu_io_arena_entries", 0)
    arena_admits = metrics.get("ptpu_io_arena_admits_total", 0)
    if arena_entries or arena_admits:
        arena_hits = metrics.get("ptpu_io_arena_hits_total", 0)
        arena_misses = metrics.get("ptpu_io_arena_misses_total", 0)
        looked = arena_hits + arena_misses
        lines.append(
            "cache arena:  mapped=%.1f MB in %d entries  attaches=%d  "
            "hit-rate=%s  admits=%d  evict=%d inval=%d revoked=%d"
            % (metrics.get("ptpu_io_arena_bytes", 0) / 1e6, int(arena_entries),
               int(metrics.get("ptpu_io_arena_attaches_total", 0)),
               ("%.0f%%" % (100.0 * arena_hits / looked)) if looked else "n/a",
               int(arena_admits),
               int(metrics.get("ptpu_io_arena_evictions_total", 0)),
               int(metrics.get("ptpu_io_arena_invalidations_total", 0)),
               int(metrics.get("ptpu_io_arena_holders_revoked_total", 0))))

    # -- per-tenant accounting: who used the shared resources
    from petastorm_tpu_torch.obs.tenant import TenantUsageReport

    tenant_report = TenantUsageReport.from_metrics(metrics)
    if tenant_report.tenants():
        lines.extend(tenant_report.render())

    # -- remote read path: GETs, hedging, footer cache
    r = {name: metrics[name] for name in metrics
         if name.startswith(("ptpu_io_remote_", "ptpu_io_hedge",
                             "ptpu_io_footer_cache_"))}
    scalar_gets = r.get("ptpu_io_remote_gets_total", 0)
    if scalar_gets:
        lines.append(
            "remote io:    gets=%d (%.1f MB)  hedges=%d (wins=%d)  "
            "sparse_fallbacks=%d"
            % (int(scalar_gets), r.get("ptpu_io_remote_bytes_total", 0) / 1e6,
               int(r.get("ptpu_io_hedges_total", 0)),
               int(r.get("ptpu_io_hedge_wins_total", 0)),
               int(r.get("ptpu_io_remote_sparse_fallbacks_total", 0))))
        fc_hits = r.get("ptpu_io_footer_cache_hits_total", 0)
        fc_miss = r.get("ptpu_io_footer_cache_misses_total", 0)
        if fc_hits or fc_miss:
            lines.append(
                "footer cache: hits=%d misses=%d evictions=%d "
                "invalidations=%d (%.1f MB held)"
                % (int(fc_hits), int(fc_miss),
                   int(r.get("ptpu_io_footer_cache_evictions_total", 0)),
                   int(r.get("ptpu_io_footer_cache_invalidations_total", 0)),
                   r.get("ptpu_io_footer_cache_bytes", 0) / 1e6))
        get_hists = [(n, v) for n, v in sorted(r.items())
                     if n.startswith("ptpu_io_remote_get_seconds")
                     and isinstance(v, dict)]
        for name, h in get_hists:
            label = name[len("ptpu_io_remote_get_seconds"):] or "{}"
            lines.append("  GET %-28s p50 %s  p99 %s ms  ×%d"
                         % (label, _fmt_ms(h.get("p50", 0)),
                            _fmt_ms(h.get("p99", 0)), h.get("count", 0)))

    # -- dataset watch: mutation counters, excluded from "other";
    # window-over-window deltas ride along when history is present
    ds = {name[len("ptpu_dataset_"):]: v for name, v in metrics.items()
          if name.startswith("ptpu_dataset_") and isinstance(v, (int, float))}
    if any(ds.values()):
        def _ds_prev(key):
            v = prev_metrics.get("ptpu_dataset_" + key)
            return int(v) if isinstance(v, (int, float)) else None

        parts = []
        for label, key in (("added", "pieces_added_total"),
                           ("removed", "pieces_removed_total"),
                           ("rewritten", "pieces_rewritten_total"),
                           ("extensions", "plan_extensions_total"),
                           ("generation_conflicts",
                            "generation_conflicts_total")):
            cur = int(ds.get(key, 0))
            parts.append("%s=%d%s" % (label, cur,
                                      _fmt_delta(cur, _ds_prev(key))))
        lines.append("dataset watch: " + " ".join(parts))

    # -- declarative transform ops: per-fused-stage timings
    ops = _labeled(metrics, "ptpu_transform_seconds")
    ops = {k: v for k, v in ops.items() if isinstance(v, dict)}
    if ops:
        lines.append("transform ops (ptpu_transform_seconds):  %8s %8s %8s"
                     % ("p50", "p99", "count"))
        for op in sorted(ops, key=lambda o: -ops[o].get("sum", 0)):
            h = ops[op]
            lines.append("  %-28s %s %s %8d"
                         % (op, _fmt_ms(h.get("p50", 0)),
                            _fmt_ms(h.get("p99", 0)), h.get("count", 0)))
        rows_total = metrics.get("ptpu_transform_rows_total")
        if rows_total:
            lines.append("  transform rows total: %d" % int(rows_total))

    # -- provenance / critical-path attribution; per-site
    # window-over-window self-time deltas when history is present
    prov_self = {name[len("ptpu_prov_self_s_"):]: v
                 for name, v in metrics.items()
                 if name.startswith("ptpu_prov_self_s_")}
    if prov_self:
        total = sum(prov_self.values()) or 1.0
        top = sorted(prov_self.items(), key=lambda kv: -kv[1])
        lines.append("attribution (critical-path self time, "
                     "%d items / %d batches):"
                     % (int(metrics.get("ptpu_prov_items", 0)),
                        int(metrics.get("ptpu_prov_batches", 0))))
        for site, sec in top[:8]:
            prev_sec = prev_metrics.get("ptpu_prov_self_s_" + site)
            if not isinstance(prev_sec, (int, float)):
                prev_sec = None
            lines.append("  %-28s %9.3fs  %5.1f%%%s"
                         % (site, sec, 100.0 * sec / total,
                            _fmt_delta(sec, prev_sec, as_int=False)))
        quarantined = metrics.get("ptpu_prov_quarantined", 0)
        if quarantined:
            lines.append("  quarantined items: %d" % int(quarantined))

    # -- compressed-page pass-through: pages/bytes shipped,
    # H2D bytes saved, per-column fallbacks, inflate-stage latency
    pd_pages = metrics.get("ptpu_pagedec_pages_total", 0)
    pd_fallbacks = metrics.get("ptpu_pagedec_fallback_columns_total", 0)
    if pd_pages or pd_fallbacks:
        shipped = metrics.get("ptpu_pagedec_bytes_compressed_total", 0)
        saved = metrics.get("ptpu_pagedec_bytes_saved_h2d_total", 0)
        raw = shipped + saved
        lines.append(
            "pagedec pass-through: pages=%d  shipped=%.1f MB  "
            "saved=%.1f MB%s  fallback columns=%d"
            % (int(pd_pages), shipped / 1e6, saved / 1e6,
               ("  (%.0f%% of raw)" % (100.0 * shipped / raw)) if raw else "",
               int(pd_fallbacks)))
        inflate = metrics.get("ptpu_pagedec_inflate_seconds")
        if isinstance(inflate, dict) and inflate.get("count"):
            lines.append("  inflate stage: p50=%s p99=%s over %d batches"
                         % (_fmt_ms(inflate.get("p50", 0)),
                            _fmt_ms(inflate.get("p99", 0)),
                            int(inflate.get("count", 0))))

    # -- transport plane: link traffic, reconnects, heartbeat
    # misses, rtt — excluded from the catch-all; window-over-window deltas
    # on the fault counters when history is present
    net_frames = _labeled(metrics, "ptpu_net_frames_total")
    net_connects = metrics.get("ptpu_net_connects_total", 0)
    if net_connects or any(net_frames.values()):
        net_bytes = _labeled(metrics, "ptpu_net_bytes_total")

        def _net_prev(key):
            v = prev_metrics.get("ptpu_net_%s_total" % key)
            return int(v) if isinstance(v, (int, float)) else None

        reconnects = int(metrics.get("ptpu_net_reconnects_total", 0))
        missed = int(metrics.get("ptpu_net_heartbeats_missed_total", 0))
        corrupt = int(metrics.get("ptpu_net_frames_corrupt_total", 0))
        lines.append(
            "transport:    connects=%d  reconnects=%d%s  hb_missed=%d%s  "
            "corrupt_frames=%d%s"
            % (int(net_connects),
               reconnects, _fmt_delta(reconnects, _net_prev("reconnects")),
               missed, _fmt_delta(missed, _net_prev("heartbeats_missed")),
               corrupt, _fmt_delta(corrupt, _net_prev("frames_corrupt"))))
        lines.append(
            "  frames tx=%d (%.1f MB)  rx=%d (%.1f MB)"
            % (int(net_frames.get("tx", 0)), net_bytes.get("tx", 0) / 1e6,
               int(net_frames.get("rx", 0)), net_bytes.get("rx", 0) / 1e6))
        rtt = metrics.get("ptpu_net_rtt_seconds")
        if isinstance(rtt, dict) and rtt.get("count"):
            lines.append("  rtt: p50=%s p99=%s ms over %d heartbeat echoes"
                         % (_fmt_ms(rtt.get("p50", 0)),
                            _fmt_ms(rtt.get("p99", 0)),
                            int(rtt.get("count", 0))))

    # -- SLO alerts: debounced breach/anomaly counters
    slo = _labeled(metrics, "ptpu_slo_alerts_total")
    slo = {k: v for k, v in slo.items() if v}
    if slo:
        lines.append("slo alerts: " + "  ".join(
            "%s=%d" % (name, int(slo[name])) for name in sorted(slo)))

    # -- self-tuning controller: live knob values vs defaults,
    # decision totals, freeze state — excluded from the catch-all
    knob_names = sorted(name[len("ptpu_ctl_knob_"):]
                        for name in metrics
                        if name.startswith("ptpu_ctl_knob_")
                        and not name.endswith("_default"))
    if knob_names or metrics.get("ptpu_ctl_windows"):
        frozen = metrics.get("ptpu_ctl_frozen", 0)
        actuations = _labeled(metrics, "ptpu_ctl_actuations_total")
        lines.append(
            "controller: windows=%d  actuations=%d  reverts=%d  freezes=%d%s"
            % (int(metrics.get("ptpu_ctl_windows", 0)),
               int(metrics.get("ptpu_ctl_actuations", 0)),
               int(metrics.get("ptpu_ctl_reverts", 0)),
               int(metrics.get("ptpu_ctl_freezes", 0)),
               "  [FROZEN]" if frozen else ""))
        for knob in knob_names:
            value = metrics.get("ptpu_ctl_knob_" + knob, 0)
            default = metrics.get("ptpu_ctl_knob_%s_default" % knob, 0)
            acted = int(actuations.get(knob, 0)) if actuations else 0
            retuned = value != default
            lines.append("  knob %-22s %12s  (default %s)%s%s"
                         % (knob,
                            ("%.4g" % value) if isinstance(value, float)
                            and not float(value).is_integer()
                            else str(int(value)),
                            ("%.4g" % default) if isinstance(default, float)
                            and not float(default).is_integer()
                            else str(int(default)),
                            "  [RETUNED]" if retuned else "",
                            ("  actuations=%d" % acted) if acted else ""))

    # -- data service fleet: decode-once fan-out, per-worker
    # straggler fodder, starvation, and the advised-vs-actual fleet size
    svc_workers = metrics.get("ptpu_svc_workers", 0)
    svc_decodes = metrics.get("ptpu_svc_decodes_total", 0)
    if svc_workers or svc_decodes or metrics.get("ptpu_svc_trainers", 0):
        served = int(metrics.get("ptpu_svc_served_items_total", 0))
        advised = metrics.get("ptpu_svc_advised_workers", 0)
        advised_part = ""
        if advised:
            gap = int(advised) - int(svc_workers)
            advised_part = "  advised=%d%s" % (
                int(advised),
                "  [GROW +%d]" % gap if gap > 0
                else ("  [SHRINK %d]" % gap if gap < 0 else ""))
        lines.append(
            "service:      workers=%d%s  trainers=%d  jobs=%d  "
            "leases_out=%d  redispatches=%d"
            % (int(svc_workers), advised_part,
               int(metrics.get("ptpu_svc_trainers", 0)),
               int(metrics.get("ptpu_svc_jobs", 0)),
               int(metrics.get("ptpu_svc_leases_outstanding", 0)),
               int(metrics.get("ptpu_svc_lease_redispatch_total", 0))))
        lines.append(
            "  decodes=%d (redecodes=%d)  served=%d  fan-out=%s  "
            "quarantined=%d  starved=%.1fs"
            % (int(svc_decodes),
               int(metrics.get("ptpu_svc_redecodes_total", 0)), served,
               ("%.2fx" % (served / svc_decodes)) if svc_decodes else "n/a",
               int(metrics.get("ptpu_svc_quarantined_total", 0)),
               metrics.get("ptpu_svc_starved_seconds_total", 0.0)))
        leaked = int(metrics.get("ptpu_svc_lease_leaked_total", 0))
        if leaked:
            lines.append("  LEAKED LEASES: %d (dispatcher bug)" % leaked)
        per_worker = _labeled(metrics, "ptpu_svc_worker_decode_seconds")
        per_worker = {k: v for k, v in per_worker.items()
                      if isinstance(v, dict) and v.get("count")}
        if per_worker:
            slowest = max(v.get("p99", 0) for v in per_worker.values())
            lines.append("  per-worker decode (ms):  %8s %8s %8s"
                         % ("p50", "p99", "count"))
            for w in sorted(per_worker,
                            key=lambda w: -per_worker[w].get("p99", 0)):
                h = per_worker[w]
                flag = " [SLOWEST]" if len(per_worker) > 1 \
                    and h.get("p99", 0) == slowest else ""
                lines.append("    %-24s %s %s %8d%s"
                             % (w, _fmt_ms(h.get("p50", 0)),
                                _fmt_ms(h.get("p99", 0)),
                                h.get("count", 0), flag))

    # -- everything else, compact (numbers only; histogram summaries as p50s)
    shown_prefixes = ("ptpu_pipeline_", "ptpu_worker_item_seconds",
                      "ptpu_health_", "ptpu_degradations_total",
                      "ptpu_io_tier_", "ptpu_io_remote_", "ptpu_io_hedge",
                      "ptpu_io_footer_cache_", "ptpu_transform_",
                      "ptpu_prov_", "ptpu_dataset_", "ptpu_slo_",
                      "ptpu_ctl_", "ptpu_pagedec_", "ptpu_net_",
                      "ptpu_io_arena_", "ptpu_tenant_", "ptpu_svc_")
    rest = {n: v for n, v in metrics.items()
            if not n.startswith(shown_prefixes)}
    scalars = [(n, v) for n, v in sorted(rest.items())
               if isinstance(v, (int, float))]
    hists = [(n, v) for n, v in sorted(rest.items()) if isinstance(v, dict)]
    if scalars:
        width = max(len(n) for n, _v in scalars)
        lines.append("other metrics:")
        for name, value in scalars:
            if isinstance(value, float) and not float(value).is_integer():
                lines.append("  %-*s %12.4f" % (width, name, value))
            else:
                lines.append("  %-*s %12d" % (width, name, int(value)))
    for name, h in hists:
        lines.append("  %s  count=%d mean=%.2fms p50=%.2fms p90=%.2fms "
                     "p99=%.2fms"
                     % (name, h.get("count", 0), h.get("mean", 0.0) * 1e3,
                        h.get("p50", 0.0) * 1e3, h.get("p90", 0.0) * 1e3,
                        h.get("p99", 0.0) * 1e3))
    return "\n".join(lines)


def render_merge(exports):
    """Fleet-merge dashboard: per-source breakdown + fleet totals
    (counters summed across the sources' last snapshots — unit-pinned by the
    test suite) + the fleet rows/s sparkline on the anchored timeline."""
    from petastorm_tpu_torch.obs.timeseries import (
        fleet_rate_series,
        merge_exports,
        sparkline,
        uniquify_sources,
    )

    exports = uniquify_sources(exports)
    merged = merge_exports(exports)
    lines = ["fleet merge: %d sources" % len(merged["sources"])]
    for export in exports:
        m = export["metrics"]
        rows = m.get("ptpu_pipeline_rows", 0)
        rates = [p.get("rate") for p in
                 export["series"].get("ptpu_pipeline_rows", ())]
        lines.append("  %-28s rows=%-10d %s"
                     % (export["source"], int(rows or 0), sparkline(rates)))
    fleet = fleet_rate_series(exports, "ptpu_pipeline_rows")
    if fleet:
        lines.append("  %-28s peak %.0f rows/s  %s"
                     % ("fleet rows/s", max(v for _t, v in fleet),
                        sparkline([v for _t, v in fleet])))
    lines.append("")
    lines.append(render_dashboard(merged["totals"],
                                  title="fleet totals (summed)"))
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-stats",
        description="Live dashboard for a petastorm_tpu_torch metrics snapshot "
                    "(Reporter JSONL stream or Prometheus text file).")
    parser.add_argument(
        "path", nargs="?",
        default=os.environ.get("PTPU_STATS_PATH", "ptpu_stats.jsonl"),
        help="snapshot file (default: $PTPU_STATS_PATH or ./ptpu_stats.jsonl)")
    parser.add_argument("--watch", nargs="?", metavar="SECONDS",
                        const=2.0, default=None,
                        help="redraw every SECONDS (default 2) until "
                             "interrupted")
    parser.add_argument("--once", action="store_true",
                        help="render exactly one frame and exit (with --watch: "
                             "one watch-mode frame, no screen clear — the CI "
                             "render check)")
    parser.add_argument("--merge", nargs="+", metavar="EXPORT", default=None,
                        help="fleet mode: aggregate several exports (Reporter "
                             "JSONL streams and/or /timelines JSON documents) "
                             "into one dashboard — totals summed, per-source "
                             "breakdown, clock-anchor-aligned windows")
    args = parser.parse_args(argv)
    if args.merge:
        from petastorm_tpu_torch.obs.timeseries import load_export

        exports = []
        for path in args.merge:
            try:
                exports.append(load_export(path))
            except (OSError, ValueError) as e:
                print("petastorm-tpu-stats: cannot read export %s: %s"
                      % (path, e), file=sys.stderr)
                return 1
        print(render_merge(exports))
        return 0
    if isinstance(args.watch, str):
        # `--watch FILE` (the documented default-interval form): argparse's
        # greedy nargs="?" consumes the path as the SECONDS value — reclaim it
        try:
            args.watch = float(args.watch)
        except ValueError:
            if args.path != parser.get_default("path"):
                parser.error("invalid --watch interval: %r" % args.watch)
            args.path = args.watch
            args.watch = 2.0

    #: prometheus files carry no history — the watch loop accumulates its own
    #: frames so the sparklines still move
    from collections import deque

    frame_history = deque(maxlen=40)

    def show():
        # one parse per frame: a JSONL stream's history already contains the
        # latest snapshot (its last entry) — only Prometheus files / empty
        # streams fall through to the single-snapshot loader
        try:
            history = _load_history(args.path)
        except (OSError, ValueError):
            history = None
        if history:
            metrics = history[-1][1]
        else:
            try:
                metrics = _load_snapshot(args.path)
            except (OSError, ValueError) as e:
                print("petastorm-tpu-stats: cannot read %s: %s"
                      % (args.path, e), file=sys.stderr)
                return 1
            if not metrics:
                print("petastorm-tpu-stats: no snapshot in %s yet"
                      % args.path, file=sys.stderr)
                return 1
            frame_history.append((time.time(), metrics))
            history = list(frame_history)
        title = "petastorm-tpu-stats · %s · %s" % (
            args.path, time.strftime("%H:%M:%S"))
        print(render_dashboard(metrics, title=title, history=history))
        return 0

    if args.watch is None or args.once:
        return show()
    try:
        while True:
            # ANSI clear+home (no os.system shell-out): redraw in place
            sys.stdout.write("\x1b[2J\x1b[H")
            show()
            time.sleep(max(0.2, args.watch))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
