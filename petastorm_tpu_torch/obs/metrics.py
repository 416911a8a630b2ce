"""Process-wide metrics registry: counters, gauges, log-bucketed histograms.

Port of ``petastorm_tpu.obs.metrics`` (the timeline hooks ``timeline_store``,
``sample_timelines`` and ``timeline`` belong to the time-series plane, ROADMAP.md Queue 1
item 8b). A named metric **family** is a metric name plus a label set (the Prometheus
data model); a **registry** owns every family in the process, and exporters and the
bottleneck analyzer read one ``snapshot()`` instead of each subsystem's own dict.

- **Near-zero disabled path.** Nothing in the hot loops touches the registry unless
  observability was requested; instrumented sites take a pre-resolved metric object
  (or a small struct of them), never a registry lookup per event.
- **Cheap enabled path.** ``Counter.inc``/``Histogram.observe`` are one lock acquire
  plus integer arithmetic. Histograms are log-bucketed: an observation maps to a bucket
  index through ``math.frexp`` (no logarithm, no stored samples), so p50/p90/p99 come
  from a few dozen integers however long the run.
- **Pull, not push, for existing totals.** Subsystems that already keep cheap totals
  (``PipelineStats``, the slab ring, ``Reader.io_stats()``) export through registered
  *collectors*, callables polled at snapshot time, so their hot paths do not change.

``default_registry()`` is the process-wide registry (made at first use); tests build
private ``MetricsRegistry()`` instances.
"""
from __future__ import annotations

import math
import threading

#: log-bucket resolution: buckets per power of two (2**(1/4) ≈ 19% wide — tight
#: enough that a p99 read from a bucket upper bound is within ~19% of the true
#: sample, coarse enough that a microseconds-to-minutes range is ~80 buckets)
_BUCKETS_PER_OCTAVE = 4


class _Metric:
    """Shared identity/labels plumbing; subclasses hold the value under _lock."""

    kind = "untyped"

    def __init__(self, name, labels=(), help=""):
        self.name = name
        self.labels = tuple(labels)  # sorted (key, value) pairs
        self.help = help
        self._lock = threading.Lock()

    def label_suffix(self):
        if not self.labels:
            return ""
        return "{%s}" % ",".join('%s="%s"' % (k, v) for k, v in self.labels)

    @property
    def full_name(self):
        """``name{k="v",...}`` — the flat snapshot/JSONL key."""
        return self.name + self.label_suffix()


class Counter(_Metric):
    """Monotonic count (events, bytes, degradations)."""

    kind = "counter"

    def __init__(self, name, labels=(), help=""):
        super().__init__(name, labels, help)
        self._value = 0

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge(_Metric):
    """Point-in-time level (queue depth, slabs in flight)."""

    kind = "gauge"

    def __init__(self, name, labels=(), help=""):
        super().__init__(name, labels, help)
        self._value = 0.0

    def set(self, v):
        with self._lock:
            self._value = v

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    @property
    def value(self):
        with self._lock:
            return self._value


def _bucket_index(v):
    """Log-bucket index of a positive value: ``i`` such that the bucket upper
    bound is ``2**(i / _BUCKETS_PER_OCTAVE)``. frexp-based — no transcendental
    call on the observe path."""
    # frexp: v = m * 2**e with m in [0.5, 1) -> the index is
    # ceil(log2(v) * S) = S*(e-1) + ceil(S * log2(2m)); the sub-octave step is
    # resolved by comparing m against S precomputed mantissa thresholds instead
    # of calling a transcendental on the observe path.
    m, e = math.frexp(v)
    octave_base = (e - 1) * _BUCKETS_PER_OCTAVE
    if m == 0.5:  # exact power of two sits on its own bucket boundary
        return octave_base
    for step, bound in enumerate(_MANTISSA_BOUNDS, start=1):
        if m <= bound:
            return octave_base + step
    return octave_base + _BUCKETS_PER_OCTAVE  # unreachable: last bound is 1.0


#: mantissa thresholds for sub-octave steps: 0.5 * 2**(k/4), k=1..4
_MANTISSA_BOUNDS = tuple(0.5 * 2 ** (k / _BUCKETS_PER_OCTAVE)
                         for k in range(1, _BUCKETS_PER_OCTAVE + 1))


def bucket_upper_bound(index):
    """Upper bound of bucket ``index`` (seconds/bytes/whatever was observed)."""
    return 2.0 ** (index / _BUCKETS_PER_OCTAVE)


class Histogram(_Metric):
    """Log-bucketed distribution: percentiles without storing samples.

    ``observe(v)`` increments one bucket counter (``{index: count}`` dict);
    ``percentile(q)`` walks the cumulative counts and returns the matched
    bucket's upper bound — an over-estimate by at most one bucket width (~19%),
    the right bias for latency percentiles. Zero/negative observations land in
    a dedicated underflow bucket reported as 0.0.
    """

    kind = "histogram"

    def __init__(self, name, labels=(), help=""):
        super().__init__(name, labels, help)
        self._buckets = {}  # bucket index -> count
        self._zero = 0      # observations <= 0
        self._count = 0
        self._sum = 0.0
        self._max = 0.0

    def observe(self, v):
        with self._lock:
            self._count += 1
            self._sum += v
            if v <= 0.0:
                self._zero += 1
                return
            if v > self._max:
                self._max = v
            idx = _bucket_index(v)
            self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def reset(self):
        """Zero the distribution (benchmark windows re-anchor percentiles to the
        measured window, like ``PipelineStats.reset()`` re-anchors the totals)."""
        with self._lock:
            self._buckets = {}
            self._zero = 0
            self._count = 0
            self._sum = 0.0
            self._max = 0.0

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def percentile(self, q):
        """Upper bound of the bucket holding the ``q``-quantile (0 < q <= 1);
        0.0 for an empty histogram."""
        with self._lock:
            count = self._count
            if count == 0:
                return 0.0
            target = q * count
            cum = self._zero
            if cum >= target:
                return 0.0
            for idx in sorted(self._buckets):
                cum += self._buckets[idx]
                if cum >= target:
                    return min(bucket_upper_bound(idx), self._max)
            return self._max

    def snapshot(self):
        """Summary dict: count/sum/mean/max + p50/p90/p99 (export + CLI shape)."""
        with self._lock:
            count, total, mx = self._count, self._sum, self._max
        return {
            "count": count,
            "sum": round(total, 6),
            "mean": round(total / count, 6) if count else 0.0,
            "max": round(mx, 6),
            "p50": round(self.percentile(0.50), 6),
            "p90": round(self.percentile(0.90), 6),
            "p99": round(self.percentile(0.99), 6),
        }

    def cumulative_buckets(self):
        """[(upper_bound, cumulative_count)] ascending — Prometheus export shape
        (the +Inf bucket is the caller's job: it equals ``count``)."""
        return self.export_state()[0]

    def export_state(self):
        """``(cumulative_buckets, count, sum)`` read under ONE lock acquisition:
        the Prometheus invariant ``le="+Inf" bucket == _count`` must hold even
        while another thread observes between exposition lines."""
        with self._lock:
            items = sorted(self._buckets.items())
            cum = self._zero
            out = []
            if self._zero:
                out.append((0.0, cum))
            for idx, n in items:
                cum += n
                out.append((bucket_upper_bound(idx), cum))
            return out, self._count, self._sum


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Owns every metric family in the process; snapshot/export entry point.

    A family is get-or-created by ``counter()``/``gauge()``/``histogram()``
    (idempotent — same name+labels returns the same object, so callers resolve
    once and keep the reference off the hot path). ``register_collector``
    attaches a pull-mode source: a callable returning ``{suffix: number}``
    polled at snapshot time and exported as gauges named
    ``ptpu_<prefix>_<suffix>`` — the migration path for ``PipelineStats``,
    ``Reader.wire_stats()`` and the slab-ring gauges, whose hot paths stay
    exactly as cheap as before.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}     # (name, labels tuple) -> metric
        self._families = {}    # name -> (kind, help)
        self._collectors = {}  # handle (int) -> (prefix, fn)
        self._next_handle = 0

    # -- family construction ------------------------------------------------------------

    def _get_or_create(self, kind, name, help, labels):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            metric = self._metrics.get(key)
            if metric is not None:
                if metric.kind != kind:
                    raise ValueError(
                        "metric family %r already registered as %s, not %s"
                        % (name, metric.kind, kind))
                return metric
            fam = self._families.get(name)
            if fam is not None and fam[0] != kind:
                raise ValueError(
                    "metric family %r already registered as %s, not %s"
                    % (name, fam[0], kind))
            metric = _METRIC_TYPES[kind](name, key[1], help or (fam[1] if fam else ""))
            self._metrics[key] = metric
            if fam is None:
                self._families[name] = (kind, help)
            return metric

    def counter(self, name, help="", **labels):
        return self._get_or_create("counter", name, help, labels)

    def gauge(self, name, help="", **labels):
        return self._get_or_create("gauge", name, help, labels)

    def histogram(self, name, help="", **labels):
        return self._get_or_create("histogram", name, help, labels)

    # -- pull-mode collectors -----------------------------------------------------------

    def register_collector(self, prefix, fn):
        """Register ``fn() -> {suffix: number}`` polled at snapshot time; values
        export as gauges ``ptpu_<prefix>_<suffix>``. Returns a handle for
        :meth:`unregister_collector` (loaders unregister at ``__exit__`` so a
        dead pipeline stops contributing stale families)."""
        with self._lock:
            handle = self._next_handle
            self._next_handle += 1
            self._collectors[handle] = (prefix, fn)
        return handle

    def unregister_collector(self, handle):
        """Accepts one handle or an iterable of handles (``Reader
        .register_metrics`` returns a list since it registers wire AND io
        collectors)."""
        handles = handle if isinstance(handle, (list, tuple, set)) \
            else (handle,)
        with self._lock:
            for h in handles:
                self._collectors.pop(h, None)

    def _collect(self):
        with self._lock:
            collectors = list(self._collectors.values())
        out = {}
        for prefix, fn in collectors:
            try:
                polled = fn()
            except Exception:  # noqa: BLE001 — a dead source must not kill export
                continue
            for suffix, value in (polled or {}).items():
                if isinstance(value, dict):
                    # tenant-keyed breakdowns flatten into tenant-labeled
                    # series (export speaks scalars); nested dicts are dropped
                    for tenant, v in value.items():
                        if isinstance(v, (int, float)):
                            out['ptpu_%s_%s{tenant="%s"}'
                                % (prefix, suffix, tenant)] = v
                    continue
                out["ptpu_%s_%s" % (prefix, suffix)] = value
        return out

    # -- output -------------------------------------------------------------------------

    def snapshot(self):
        """Flat ``{full_name: value}`` dict — numbers for counters/gauges and
        collector values, summary dicts (count/sum/percentiles) for histograms."""
        with self._lock:
            metrics = list(self._metrics.values())
        out = {}
        for m in metrics:
            out[m.full_name] = m.snapshot() if m.kind == "histogram" else m.value
        out.update(self._collect())
        return out

    def to_prometheus(self):
        """Prometheus text exposition format (one string, trailing newline)."""
        with self._lock:
            metrics = list(self._metrics.values())
            families = dict(self._families)
        by_family = {}
        for m in metrics:
            by_family.setdefault(m.name, []).append(m)
        lines = []
        for name in sorted(by_family):
            kind, help = families.get(name, ("gauge", ""))
            if help:
                lines.append("# HELP %s %s" % (name, help))
            lines.append("# TYPE %s %s" % (name, kind))
            for m in sorted(by_family[name], key=lambda m: m.labels):
                if m.kind == "histogram":
                    base = list(m.labels)
                    buckets, count, total = m.export_state()  # one consistent read
                    for bound, cum in buckets:
                        le = _labels_text(base + [("le", "%.6g" % bound)])
                        lines.append("%s_bucket%s %d" % (name, le, cum))
                    le = _labels_text(base + [("le", "+Inf")])
                    lines.append("%s_bucket%s %d" % (name, le, count))
                    lines.append("%s_sum%s %.9g" % (name, m.label_suffix(), total))
                    lines.append("%s_count%s %d" % (name, m.label_suffix(), count))
                else:
                    lines.append("%s%s %.9g" % (name, m.label_suffix(), m.value))
        for full_name, value in sorted(self._collect().items()):
            if not isinstance(value, (int, float)):
                continue  # a non-numeric collector value has no exposition line
            lines.append("# TYPE %s gauge" % full_name)
            lines.append("%s %.9g" % (full_name, float(value)))
        return "\n".join(lines) + "\n"


def _labels_text(pairs):
    return "{%s}" % ",".join('%s="%s"' % (k, v) for k, v in pairs)


_default_lock = threading.Lock()
_default = None


def default_registry():
    """The process-wide registry (created on first use). Degradation counters
    (:mod:`petastorm_tpu_torch.obs.log`) and anything wired with ``metrics=True``
    land here, so one exporter sees the whole process."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default
