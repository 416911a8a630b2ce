"""Windowed metric time series: bounded rings a series, sampled on the Reporter cadence.

Port of ``petastorm_tpu.obs.timeseries``. The registry's counters only grow and its
histogram percentiles cover the whole run; this module adds windows over time without
touching a hot path:

- :class:`TimelineStore` samples a :class:`~petastorm_tpu_torch.obs.metrics
  .MetricsRegistry` on demand (the :class:`~petastorm_tpu_torch.obs.export.Reporter`
  thread calls it once a flush: one pass over the registry, one lock a metric, no cost on
  the observe/inc paths) and appends one point a series to a bounded ring.
- Counters are stored as **deltas and rates**; a counter that shrank is a restart and is
  charged its current value, so rates stay right across process or Reporter restarts.
- Histograms are stored as **per-window percentiles**: the sampler differences the
  cumulative log buckets between samples and computes p50/p99 of just the observations
  of the window (the series the SLO engine, :mod:`petastorm_tpu_torch.obs.slo`,
  evaluates).
- Every sample notifies the registered listeners with the whole window.

Points are timestamped on a **(wall, perf) clock-anchor pair** taken once at store
construction (``t = anchor_wall + (perf_now - anchor_perf)``): the wall clock is trusted
once, so a clock step mid-run cannot reorder windows, and :func:`merge_exports` aligns
several processes' exports on their anchors.

``MetricsRegistry.timeline(name)`` is the read seam; :func:`export_document` is the JSON
shape the scrape endpoint (:mod:`petastorm_tpu_torch.obs.serve`) serves at
``/timelines``. The documents, and the Reporter JSONL streams :func:`load_export` reads,
are the JAX package's: either package's export loads in the other.
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import deque

#: schema tag on the fleet-export JSON document (the /timelines endpoint and
#: the stats CLI's merge inputs)
EXPORT_SCHEMA = "ptpu-fleet-export-v1"

#: default ring bound per series: at the Reporter's 5 s default cadence this
#: holds ~42 minutes of windows in a few KB per series
DEFAULT_MAX_POINTS = 512

#: series-count cap: a labels-cardinality explosion (one family per item key,
#: say) must not grow the store unbounded — new series beyond the cap are
#: counted in ``TimelineStore.dropped_series``, never silently ignored
DEFAULT_MAX_SERIES = 4096


class MetricTimeline:
    """One metric's bounded point ring. Points are plain dicts (JSON-ready):

    - counters/gauges/collector values: ``{"t", "value", "delta", "rate"}``
      (``delta``/``rate`` are None on a series' first window — there is no
      prior sample to difference against);
    - histograms: ``{"t", "count", "sum", "p50", "p99"}`` where every field
      covers ONLY the window (count of new observations, their percentiles).
    """

    __slots__ = ("name", "kind", "_points")

    def __init__(self, name, kind, max_points=DEFAULT_MAX_POINTS):
        self.name = name
        self.kind = kind
        self._points = deque(maxlen=max(2, int(max_points)))

    def append(self, point):
        self._points.append(point)

    def points(self):
        """Oldest-first list of point dicts (a copy — safe to mutate)."""
        return [dict(p) for p in self._points]

    def __len__(self):
        return len(self._points)


def _window_percentile(buckets, count, q):
    """Percentile upper bound from non-cumulative ``{bound: count}`` window
    buckets (0.0 bound = the underflow bucket, reported as 0.0)."""
    if count <= 0:
        return 0.0
    target = q * count
    cum = 0
    for bound in sorted(buckets):
        cum += buckets[bound]
        if cum >= target:
            return bound
    return max(buckets) if buckets else 0.0


def _decumulate(export_state):
    """``Histogram.export_state()`` → (non-cumulative {bound: count}, count,
    sum)."""
    cum_buckets, count, total = export_state
    out = {}
    prev = 0
    for bound, cum in cum_buckets:
        out[bound] = cum - prev
        prev = cum
    return out, count, total


class TimelineStore:
    """Bounded time-series store over one registry; sampled on demand.

    ``sample()`` is the only write path and is designed to be called from ONE
    cadence thread (the Reporter); it takes the store lock for the whole pass,
    so a second caller serializes rather than corrupting the delta state. The
    registry's metric locks are taken one at a time inside — the instrumented
    hot paths never see more than their usual single-lock acquire.
    """

    def __init__(self, registry, max_points=DEFAULT_MAX_POINTS,
                 max_series=DEFAULT_MAX_SERIES):
        self._registry = registry
        self._max_points = int(max_points)
        self._max_series = int(max_series)
        self._lock = threading.Lock()
        self._series = {}       # name -> MetricTimeline
        self._prev_scalar = {}  # name -> last sampled value
        self._prev_hist = {}    # name -> (non-cum buckets, count, sum)
        self._listeners = []
        #: the clock anchor (satellite: the same pair every export carries):
        #: wall trusted ONCE here, elapsed time measured on the perf clock
        self.anchor_wall = time.time()
        self.anchor_perf = time.perf_counter()
        self._last_perf = None
        #: series refused past ``max_series`` (bounded-store honesty: a
        #: cardinality explosion is VISIBLE, not silently truncated)
        self.dropped_series = 0

    # -- wiring -------------------------------------------------------------------------

    def add_listener(self, fn):
        """Register ``fn(window, t)`` called after every sample with the full
        window dict ``{name: {"kind": ..., **point}}``. Returns ``fn`` (the
        detach token for :meth:`remove_listener`)."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)
        return fn

    def remove_listener(self, fn):
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def anchored_now(self):
        """Current time on the anchored timeline (wall-at-anchor + perf
        elapsed) — immune to wall-clock steps after construction."""
        return self.anchor_wall + (time.perf_counter() - self.anchor_perf)

    # -- sampling -----------------------------------------------------------------------

    def _timeline(self, name, kind):
        tl = self._series.get(name)
        if tl is None:
            if len(self._series) >= self._max_series:
                self.dropped_series += 1
                return None
            tl = MetricTimeline(name, kind, self._max_points)
            self._series[name] = tl
        return tl

    def sample(self):
        """Sample every registry series into the rings; returns the window
        dict ``{name: {"kind": ..., **point}}`` and notifies listeners."""
        with self._lock:
            now_perf = time.perf_counter()
            t = round(self.anchor_wall + (now_perf - self.anchor_perf), 6)
            dt = None if self._last_perf is None else now_perf - self._last_perf
            self._last_perf = now_perf
            window = {}
            for name, kind, payload in self._registry._timeline_sources():
                if kind == "histogram":
                    point = self._sample_hist(name, payload, t)
                else:
                    point = self._sample_scalar(name, kind, payload, t, dt)
                if point is None:
                    continue
                window[name] = dict(point, kind=kind)
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(window, t)
            except Exception:  # noqa: BLE001 — a bad listener must not kill the cadence
                from petastorm_tpu_torch.obs.log import degradation

                degradation("timeline_listener_error",
                            "timeline listener %r raised; window dropped for "
                            "it (series keep sampling)", fn)
        return window

    def _sample_scalar(self, name, kind, value, t, dt):
        tl = self._timeline(name, kind)
        if tl is None:
            return None
        prev = self._prev_scalar.get(name)
        self._prev_scalar[name] = value
        if prev is None:
            point = {"t": t, "value": value, "delta": None, "rate": None}
        else:
            delta = value - prev
            if kind == "counter" and delta < 0:
                # a counter can only shrink across a restart (new process
                # re-registered the family, or a test reset it): the current
                # value IS the window's worth of events
                delta = value
            # rates NEVER go negative (the documented contract): a shrunken
            # gauge-kind series — a real level dropping, or a cumulative
            # collector (ptpu_pipeline_rows/read_s, no *_total suffix) whose
            # pipeline restarted — keeps its honest negative delta but has no
            # meaningful per-second event rate for that window
            rate = None if not dt or delta < 0 else round(delta / dt, 6)
            point = {"t": t, "value": value, "delta": delta, "rate": rate}
        tl.append(point)
        return point

    def _sample_hist(self, name, export_state, t):
        tl = self._timeline(name, "histogram")
        if tl is None:
            return None
        buckets, count, total = _decumulate(export_state)
        prev = self._prev_hist.get(name)
        self._prev_hist[name] = (buckets, count, total)
        if prev is None:
            wbuckets, wcount, wsum = buckets, count, total
        else:
            pbuckets, pcount, psum = prev
            if count < pcount:  # histogram reset (benchmark window re-anchor)
                wbuckets, wcount, wsum = buckets, count, total
            else:
                wbuckets = {b: n - pbuckets.get(b, 0)
                            for b, n in buckets.items()
                            if n - pbuckets.get(b, 0) > 0}
                wcount = count - pcount
                wsum = total - psum
        point = {"t": t, "count": wcount, "sum": round(wsum, 6),
                 "p50": round(_window_percentile(wbuckets, wcount, 0.50), 6),
                 "p99": round(_window_percentile(wbuckets, wcount, 0.99), 6)}
        tl.append(point)
        return point

    # -- reads --------------------------------------------------------------------------

    def points(self, name):
        with self._lock:
            tl = self._series.get(name)
            return tl.points() if tl is not None else []

    def series_names(self):
        with self._lock:
            return sorted(self._series)

    def to_dict(self):
        """``{name: {"kind", "points"}}`` — the export/serve shape."""
        with self._lock:
            return {name: {"kind": tl.kind, "points": tl.points()}
                    for name, tl in self._series.items()}


# -- export / merge ---------------------------------------------------------------------

def export_document(registry, extra=None):
    """The fleet-export JSON document: last snapshot + timelines + the clock
    anchor identifying this source. Served by :mod:`petastorm_tpu_torch.obs.serve`
    at ``/timelines`` and consumed by :func:`load_export` and :func:`merge_exports`."""
    store = registry.timeline_store()
    doc = {
        "schema": EXPORT_SCHEMA,
        "source": "%s:%d" % (socket.gethostname(), os.getpid()),
        "ts": time.time(),
        "anchor": {"wall": store.anchor_wall, "perf": store.anchor_perf,
                   "host": socket.gethostname(), "pid": os.getpid()},
        "metrics": registry.snapshot(),
        "timelines": store.to_dict(),
        "dropped_series": store.dropped_series,
    }
    if extra:
        doc.update(extra)
    return doc


def _anchored_t(line, anchor=None):
    """A Reporter JSONL line's time on the anchored timeline: trust the
    anchor's wall once and the line's perf elapsed — NOT the line's own wall
    stamp (which may step under NTP / be skewed on another host). The line's
    OWN anchor wins over the caller's fallback: a restarted process appending
    to the same stream carries a fresh (wall, perf) pair, and placing its
    windows via the first run's anchor would throw them onto the wrong epoch
    of the perf clock entirely."""
    line_anchor = line.get("anchor") or anchor
    perf = line.get("perf")
    if line_anchor and perf is not None \
            and line_anchor.get("perf") is not None:
        return line_anchor["wall"] + (perf - line_anchor["perf"])
    return line.get("ts", 0.0)


def export_to_merge_shape(doc, fallback_source="?"):
    """An in-memory ``/timelines`` export document in the common merge
    shape (``{"source", "anchor", "metrics", "series"}``) — the same
    conversion :func:`load_export` applies to a document read from disk.
    A fleet aggregator runs live piggybacked
    peer documents through this before :func:`merge_exports`."""
    series = {name: tl.get("points", [])
              for name, tl in (doc.get("timelines") or {}).items()}
    return {"source": doc.get("source") or fallback_source,
            "anchor": doc.get("anchor"),
            "metrics": doc.get("metrics") or {},
            "series": series}


def load_export(path):
    """Load one process's export — a ``/timelines`` JSON document or a
    Reporter JSONL stream — into the common merge shape::

        {"source", "anchor", "metrics", "series": {name: [points]}}

    For JSONL streams the scalar series are rebuilt from consecutive
    snapshots (delta/rate between lines; counter shrink = restart), and each
    line is placed on the anchored timeline via the (wall, perf) pair the
    v2 Reporter stamps — older v1 lines fall back to their wall ``ts``.
    """
    with open(path) as f:
        head = f.read(4096)
    if '"%s"' % EXPORT_SCHEMA in head.split("\n", 1)[0]:
        with open(path) as f:
            doc = json.load(f)
        return export_to_merge_shape(
            doc, fallback_source=os.path.basename(path))

    lines = []
    with open(path) as f:
        for raw in f:
            try:
                obj = json.loads(raw)
            except ValueError:
                continue  # torn final line from a live writer
            if isinstance(obj, dict) and "metrics" in obj:
                lines.append(obj)
    if not lines:
        raise ValueError("no snapshots in %s" % path)
    anchor = next((ln.get("anchor") for ln in lines if ln.get("anchor")), None)
    source = os.path.basename(path)
    if anchor and anchor.get("host") is not None:
        source = "%s:%s" % (anchor["host"], anchor.get("pid", "?"))
    series = {}
    prev = {}
    prev_t = None
    for line in lines:
        t = round(_anchored_t(line, anchor), 6)
        # a restarted writer's fresh anchor can begin a new epoch: a
        # non-advancing timeline yields no window length, not a negative one
        dt = None if prev_t is None or t <= prev_t else t - prev_t
        prev_t = t
        for name, value in line["metrics"].items():
            if isinstance(value, dict):  # histogram summary: cumulative view
                series.setdefault(name, []).append(
                    {"t": t, "count": value.get("count", 0),
                     "p50": value.get("p50", 0.0),
                     "p99": value.get("p99", 0.0)})
                continue
            p = prev.get(name)
            prev[name] = value
            if p is None:
                point = {"t": t, "value": value, "delta": None, "rate": None}
            else:
                delta = value - p
                rate = None
                if delta < 0:
                    if name.endswith("_total"):
                        delta = value  # counter restart: current value IS the window
                    # a shrunken level (queue depth, or a cumulative collector
                    # behind a restarted pipeline) has no meaningful event
                    # rate — rates never go negative, the delta stays honest
                if dt and delta >= 0:
                    rate = round(delta / dt, 6)
                point = {"t": t, "value": value, "delta": delta, "rate": rate}
            series.setdefault(name, []).append(point)
    return {"source": source, "anchor": anchor,
            "metrics": lines[-1]["metrics"], "series": series}


def uniquify_sources(exports):
    """Deterministically disambiguate colliding source names (two exports of
    one host:pid — twin registries in one process, a rotated pair): the
    second same-named export becomes ``name#2`` and so on. Both merge and
    fleet-series grouping go through this, so the names agree."""
    seen = {}
    out = []
    for export in exports:
        source = export["source"]
        count = seen.get(source, 0) + 1
        seen[source] = count
        if count > 1:
            export = dict(export, source="%s#%d" % (source, count))
        out.append(export)
    return out


def merge_exports(exports):
    """Aggregate per-process exports into the fleet view.

    ``totals`` is unit-pinned: every scalar family is the SUM of the sources'
    last snapshots (counters add; additive gauges like queue depths add too —
    a fleet has that many items queued). Histogram summaries merge as summed
    count/sum and the MAX of the sources' percentiles — a conservative upper
    bound (true fleet percentiles need the buckets, which JSONL summaries do
    not carry; the Prometheus endpoint serves full buckets for scrapers that
    want exact fleet quantiles).
    """
    totals = {}
    per_source = {}
    for export in uniquify_sources(exports):
        per_source[export["source"]] = export["metrics"]
        for name, value in export["metrics"].items():
            if isinstance(value, dict):
                agg = totals.setdefault(
                    name, {"count": 0, "sum": 0.0, "mean": 0.0,
                           "p50": 0.0, "p90": 0.0, "p99": 0.0})
                agg["count"] += value.get("count", 0)
                agg["sum"] += value.get("sum", 0.0)
                for q in ("p50", "p90", "p99"):
                    agg[q] = max(agg[q], value.get(q, 0.0))
                agg["mean"] = agg["sum"] / agg["count"] if agg["count"] else 0.0
            else:
                totals[name] = totals.get(name, 0) + value
    return {"sources": sorted(per_source), "totals": totals,
            "per_source": per_source}


def fleet_rate_series(exports, name, bin_s=5.0):
    """Fleet-total rate of one counter family: each source's rate points are
    binned onto the common anchored timeline (mean rate per source per bin,
    sources summed per bin). Returns ``[(bin_start_t, fleet_rate)]`` ascending
    — the merge panels' sparkline input."""
    bins = {}  # bin index -> {source: [rates]}
    for export in uniquify_sources(exports):
        for point in export["series"].get(name, ()):
            rate = point.get("rate")
            if rate is None:
                continue
            idx = int(point["t"] // bin_s)
            bins.setdefault(idx, {}).setdefault(
                export["source"], []).append(rate)
    out = []
    for idx in sorted(bins):
        total = sum(sum(rates) / len(rates)
                    for rates in bins[idx].values())
        out.append((idx * bin_s, round(total, 6)))
    return out


# -- rendering helpers ------------------------------------------------------------------

_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def sparkline(values, width=24):
    """Unicode sparkline of the last ``width`` values (min-max normalized;
    None values render as spaces). Empty/flat series render as a flat line."""
    vals = list(values)[-width:]
    if not vals:
        return ""
    present = [v for v in vals if v is not None]
    if not present:
        return " " * len(vals)
    lo, hi = min(present), max(present)
    span = hi - lo
    chars = []
    for v in vals:
        if v is None:
            chars.append(" ")
        elif span <= 0:
            chars.append(_SPARK_CHARS[0])
        else:
            idx = int((v - lo) / span * (len(_SPARK_CHARS) - 1))
            chars.append(_SPARK_CHARS[idx])
    return "".join(chars)
