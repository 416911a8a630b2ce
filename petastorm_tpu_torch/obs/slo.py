"""SLO and anomaly engine: declarative objectives evaluated a time-series window, with
debounced alerts.

Port of ``petastorm_tpu.obs.slo``. The time-series plane
(:mod:`petastorm_tpu_torch.obs.timeseries`) turns the registry into windowed series;
this module watches them:

- **SLO specs** (:class:`SloSpec`): "this series must stay on this side of this
  threshold", evaluated on every window; a spec must breach ``breach_windows``
  consecutive windows before its alert fires (one slow window on a shared host is not an
  incident), fires once an excursion, and re-arms only after a clean window.
- **Anomaly detection** (:class:`AnomalyDetector`): for series without a known
  threshold, EWMA-smoothed robust-z drift detection against the trailing window history
  (median/MAD). A step fires once: the detector latches while the series stays out of
  band.

Every firing is a degradation event (``cause=slo_breach`` or ``anomaly_detected``:
counted on ``ptpu_degradations_total``, logged once, mirrored into every live flight
recorder) and counted on ``ptpu_slo_alerts_total{slo=...}``. An alert carries an
attribution snapshot when the engine has an attribution source:
``DataLoader(slos=..., provenance=...)`` wires its
:meth:`~petastorm_tpu_torch.loader.DataLoader.attribution_report`, so ``culprit`` names
the site owning the slow batches' critical path. Without provenance ``attribution`` and
``culprit`` stay None, as in the JAX package.

Evaluation happens on the sampling cadence (the Reporter thread), never on the loader or
reader paths.
"""
from __future__ import annotations

import dataclasses
import re
import threading
import time

_OPS = {
    "<=": lambda v, t: v <= t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    ">": lambda v, t: v > t,
}

#: stats resolvable from a window point (see SloSpec.stat)
_STATS = ("value", "delta", "rate", "p50", "p99", "share")

_LABEL_RES = {
    "tenant": re.compile(r'tenant="([^"]*)"'),
    "worker": re.compile(r'worker="([^"]*)"'),
}


def strip_label(full_name, label):
    """``'base{a="1",tenant="x"}'`` → ``('base{a="1"}', 'x')`` for
    ``label='tenant'``; a series without that label returns
    ``(full_name, None)``. Per-dimension spec expansion (``per_tenant`` /
    ``per_worker``) uses this to match every labeled twin of one base
    metric; the fleet advisor reads worker-labeled series the same way."""
    m = _LABEL_RES[label].search(full_name)
    if m is None:
        return full_name, None
    value = m.group(1)
    base = full_name[:m.start()] + full_name[m.end():]
    base = base.replace("{,", "{").replace(",,", ",").replace(",}", "}")
    if base.endswith("{}"):
        base = base[:-2]
    return base, value


def _strip_tenant(full_name):
    return strip_label(full_name, "tenant")


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One declarative objective over one windowed series.

    ``metric`` is the snapshot full name (labels included), e.g.
    ``'ptpu_pipeline_stage_seconds{stage="read"}'``. ``stat`` picks the window
    statistic:

    - ``value`` — the sampled level (gauges);
    - ``delta`` / ``rate`` — the window's counter movement / per-second rate;
    - ``p50`` / ``p99`` — the window-local histogram percentile;
    - ``share`` — ``delta(metric) / Σ delta(denominator)``; with
      ``denominator=None`` the denominator is the window length in seconds
      (a *time share*: ``metric='ptpu_pipeline_put_wait_s', stat='share'``
      is the producer's idle fraction).

    A window where the series is absent, has no prior sample to delta
    against, or (for histograms) saw fewer than ``min_count`` observations is
    SKIPPED — it neither breaches nor clears, so sparse windows cannot flap
    the debounce state.
    """

    name: str
    metric: str
    stat: str = "value"
    op: str = "<="
    threshold: float = 0.0
    #: for ``stat='share'``: denominator series name(s), deltas summed;
    #: None = the window duration (time share)
    denominator: tuple | str | None = None
    #: consecutive breaching windows before the alert fires (burn debounce)
    breach_windows: int = 2
    #: histogram windows with fewer observations than this are skipped
    min_count: int = 1
    description: str = ""
    #: per-tenant dimensioning: evaluate this spec independently
    #: against EVERY ``metric{...,tenant="X"}`` series in the window —
    #: debounce streaks and latches are kept per (spec, tenant), and a firing
    #: alert names the culprit tenant alongside the culprit site
    per_tenant: bool = False
    #: per-worker dimensioning: the same expansion over
    #: ``metric{...,worker="X"}`` twins — a straggler alert
    #: debounces independently per decode worker and names the worker id
    per_worker: bool = False

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError("SloSpec op must be one of %s, got %r"
                             % (sorted(_OPS), self.op))
        if self.stat not in _STATS:
            raise ValueError("SloSpec stat must be one of %s, got %r"
                             % (_STATS, self.stat))

    def resolve(self, window, window_s=None, metric=None):
        """The spec's statistic from one window dict, or None to skip.
        ``metric`` overrides the looked-up series name (per-tenant expansion
        resolves the same spec against each tenant-labeled twin)."""
        point = window.get(metric if metric is not None else self.metric)
        if point is None:
            return None
        if self.stat in ("p50", "p99"):
            if point.get("count", 0) < self.min_count:
                return None
            return point.get(self.stat)
        if self.stat == "value":
            return point.get("value")
        if self.stat in ("delta", "rate"):
            return point.get(self.stat)  # None on a series' first window
        # share
        num = point.get("delta")
        if num is None:
            return None
        if self.denominator is None:
            if not window_s:
                return None
            return num / window_s
        denoms = (self.denominator,) if isinstance(self.denominator, str) \
            else tuple(self.denominator)
        total = 0.0
        for name in denoms:
            dpoint = window.get(name)
            if dpoint is None or dpoint.get("delta") is None:
                return None
            total += dpoint["delta"]
        if total <= 0:
            return None  # nothing moved: no share to judge
        return num / total

    def ok(self, value):
        return _OPS[self.op](value, self.threshold)


class AnomalyDetector:
    """EWMA + robust-z drift detector over one series' window values.

    ``observe(value)`` returns True exactly when an anomaly FIRES: the
    EWMA-smoothed value sits more than ``z_threshold`` robust standard
    deviations (median/MAD over the trailing ``history`` windows) from the
    baseline, with at least ``min_history`` windows of history. The detector
    then latches — an injected step cliff fires ONCE, not once per window —
    and re-arms when the smoothed series returns within ``z_clear`` (either
    the series recovered, or the trailing baseline adapted to the new
    normal)."""

    def __init__(self, history=32, min_history=8, z_threshold=6.0,
                 z_clear=3.0, ewma_alpha=0.4):
        from collections import deque

        self._history = deque(maxlen=max(min_history, int(history)))
        self._min_history = int(min_history)
        self._z_threshold = float(z_threshold)
        self._z_clear = float(z_clear)
        self._alpha = float(ewma_alpha)
        self._ewma = None
        self._fired = False
        self.last_z = 0.0

    def _z(self, value):
        vals = sorted(self._history)
        n = len(vals)
        med = vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1] + vals[n // 2])
        devs = sorted(abs(v - med) for v in vals)
        mad = devs[n // 2] if n % 2 else 0.5 * (devs[n // 2 - 1] + devs[n // 2])
        scale = 1.4826 * mad
        if scale <= 0:
            # a perfectly flat baseline: any departure is infinitely many
            # MADs away — use a small floor relative to the median instead
            scale = max(abs(med) * 0.05, 1e-9)
        return abs(value - med) / scale

    def observe(self, value):
        if value is None:
            return False
        if self._ewma is None:
            self._ewma = float(value)
        else:
            self._ewma = (self._alpha * float(value)
                          + (1.0 - self._alpha) * self._ewma)
        fired = False
        if len(self._history) >= self._min_history:
            z = self._z(self._ewma)
            self.last_z = round(z, 3)
            if not self._fired and z >= self._z_threshold:
                self._fired = True
                fired = True
            elif self._fired and z <= self._z_clear:
                self._fired = False  # recovered / baseline adapted: re-arm
        self._history.append(float(value))
        return fired


@dataclasses.dataclass
class SloAlert:
    """One debounced firing (breach or anomaly)."""

    name: str
    cause: str          # slo_breach | anomaly_detected
    metric: str
    stat: str
    t: float            # anchored window time
    value: float
    threshold: float | None   # None for anomalies
    windows: int        # consecutive breaching windows at fire time
    message: str
    #: AttributionReport.to_dict() at fire time (None without an attribution
    #: source) — the alert names the culprit site, not just the symptom
    attribution: dict | None = None
    #: the attribution snapshot's slow-decile culprit site (convenience)
    culprit: str | None = None
    #: culprit tenant for ``per_tenant`` specs: the tenant whose
    #: series breached — None for untagged specs and anomalies
    tenant: str | None = None
    #: culprit worker for ``per_worker`` specs: the decode worker
    #: whose series breached — a straggler alert names it
    worker: str | None = None

    def to_dict(self):
        return dataclasses.asdict(self)


class SloEngine:
    """Evaluates :class:`SloSpec`s (+ anomaly watches) per sampled window.

    Attach to a :class:`~petastorm_tpu_torch.obs.timeseries.TimelineStore` with
    :meth:`attach` (the Reporter's ``sample_timelines()`` cadence then drives
    evaluation), or call :meth:`evaluate` directly with a window dict (tests,
    manual cadences). ``attribution`` is a zero-arg callable returning an
    attribution report (an object with ``to_dict()`` and ``slow_top``) or None;
    ``DataLoader(slos=..., provenance=...)`` sets its ``attribution_report`` here. Alerts
    are kept in a bounded list (newest last) and counted as
    ``ptpu_slo_alerts_total{slo=...}`` on the engine's registry."""

    def __init__(self, specs=(), registry=None, attribution=None,
                 anomaly_metrics=(), anomaly_kwargs=None, max_alerts=256):
        self._specs = list(specs)
        self._registry = registry
        self._attribution = attribution
        #: [(metric, stat)] series watched for anomalies without a threshold
        self._anomaly_watch = [(m, s) for m, s in
                               (tuple(w) for w in anomaly_metrics)]
        self._anomaly_kwargs = dict(anomaly_kwargs or {})
        self._detectors = {}
        self._lock = threading.Lock()
        self._alerts = []
        self._max_alerts = int(max_alerts)
        self._breach_streak = {}   # spec name -> consecutive breaching windows
        self._breach_latched = {}  # spec name -> alert already fired this excursion
        self._last_t = None
        self._store = None
        self._listener = None
        self.windows_evaluated = 0

    # -- wiring -------------------------------------------------------------------------

    def set_attribution(self, fn):
        self._attribution = fn

    def attach(self, store):
        """Subscribe to a TimelineStore's sampling cadence. Idempotent per
        store; :meth:`detach` unsubscribes (loader ``__exit__``)."""
        self.detach()
        self._store = store
        self._listener = store.add_listener(self._on_window)
        return self

    def detach(self):
        store, self._store = self._store, None
        if store is not None and self._listener is not None:
            store.remove_listener(self._listener)
        self._listener = None

    def _on_window(self, window, t):
        self.evaluate(window, t)

    # -- evaluation ---------------------------------------------------------------------

    def evaluate(self, window, t=None):
        """Evaluate all specs + anomaly watches against one window; returns
        the alerts fired by THIS window (possibly empty)."""
        t = time.time() if t is None else t
        with self._lock:
            window_s = None if self._last_t is None else max(0.0, t - self._last_t)
            self._last_t = t
            self.windows_evaluated += 1
            fired = []
            for spec in self._specs:
                if spec.per_tenant or spec.per_worker:
                    # per-dimension expansion: one independent
                    # debounce per labeled twin of the base series
                    label = "tenant" if spec.per_tenant else "worker"
                    for series in window:
                        base, who = strip_label(series, label)
                        if who is None or base != spec.metric:
                            continue
                        value = spec.resolve(window, window_s=window_s,
                                             metric=series)
                        self._judge(spec, value, fired,
                                    **{label: who})
                    continue
                value = spec.resolve(window, window_s=window_s)
                self._judge(spec, value, fired)
            anomalies = []
            for metric, stat in self._anomaly_watch:
                point = window.get(metric)
                value = None if point is None else point.get(stat)
                key = (metric, stat)
                det = self._detectors.get(key)
                if det is None:
                    det = self._detectors[key] = AnomalyDetector(
                        **self._anomaly_kwargs)
                if det.observe(value):
                    anomalies.append((metric, stat, value, det.last_z))
        out = []
        for spec, value, streak, tenant, worker in fired:
            out.append(self._fire_breach(spec, value, streak, t,
                                         tenant=tenant, worker=worker))
        for metric, stat, value, z in anomalies:
            out.append(self._fire_anomaly(metric, stat, value, z, t))
        return out

    def _judge(self, spec, value, fired, tenant=None, worker=None):
        """One spec × one (possibly tenant-/worker-dimensioned) value through
        the debounce state machine. Caller holds ``self._lock``."""
        if value is None:
            return  # sparse window: neither breaches nor clears
        if worker is not None:
            key = (spec.name, "worker", worker)
        elif tenant is not None:
            key = (spec.name, tenant)
        else:
            key = spec.name
        if spec.ok(value):
            self._breach_streak[key] = 0
            self._breach_latched[key] = False
            return
        streak = self._breach_streak.get(key, 0) + 1
        self._breach_streak[key] = streak
        if streak >= spec.breach_windows \
                and not self._breach_latched.get(key):
            self._breach_latched[key] = True
            fired.append((spec, value, streak, tenant, worker))

    # -- alert plumbing -----------------------------------------------------------------

    def _attribution_snapshot(self, tenant=None):
        if self._attribution is None:
            return None, None
        try:
            if tenant is not None:
                # tenant-scoped attribution when the source takes the kwarg
                # (ProvenanceRecorder/DataLoader do); older callables fall
                # back to the unscoped report
                try:
                    report = self._attribution(tenant=tenant)
                except TypeError:
                    report = self._attribution()
            else:
                report = self._attribution()
        except Exception:  # noqa: BLE001 — a broken source must not kill alerting
            from petastorm_tpu_torch.obs.log import degradation

            degradation("slo_attribution_error",
                        "SLO alert attribution snapshot failed; alert carries "
                        "no culprit")
            return None, None
        if report is None:
            return None, None
        return report.to_dict(), report.slow_top

    def _record_alert(self, alert):
        from petastorm_tpu_torch.obs import flight as _flight
        from petastorm_tpu_torch.obs.log import degradation

        with self._lock:
            self._alerts.append(alert)
            del self._alerts[:-self._max_alerts]
        if self._registry is not None:
            labels = {"slo": alert.name}
            if alert.tenant is not None:
                labels["tenant"] = alert.tenant
            if alert.worker is not None:
                labels["worker"] = alert.worker
            self._registry.counter(
                "ptpu_slo_alerts_total",
                help="debounced SLO-breach/anomaly alerts", **labels).inc()
        # count + warn-once log + flight mirror of the CAUSE; then the full
        # alert (culprit included) into every live flight recorder
        degradation(alert.cause, "%s", alert.message)
        for recorder in _flight.active_recorders():
            recorder.record("slo_alert", name=alert.name, cause=alert.cause,
                            metric=alert.metric, value=alert.value,
                            threshold=alert.threshold, culprit=alert.culprit,
                            tenant=alert.tenant, worker=alert.worker)
        return alert

    def _fire_breach(self, spec, value, streak, t, tenant=None, worker=None):
        attribution, culprit = self._attribution_snapshot(tenant=tenant)
        who = ""
        if tenant is not None:
            who = " by tenant %r" % tenant
        elif worker is not None:
            who = " by worker %r" % worker
        message = ("SLO %r breached%s: %s %s = %.6g violates %s %.6g for %d "
                   "consecutive windows%s"
                   % (spec.name, who,
                      spec.metric, spec.stat, value, spec.op,
                      spec.threshold, streak,
                      " — critical path owned by %s" % culprit
                      if culprit else ""))
        return self._record_alert(SloAlert(
            name=spec.name, cause="slo_breach", metric=spec.metric,
            stat=spec.stat, t=t, value=round(float(value), 6),
            threshold=spec.threshold, windows=streak, message=message,
            attribution=attribution, culprit=culprit, tenant=tenant,
            worker=worker))

    def _fire_anomaly(self, metric, stat, value, z, t):
        attribution, culprit = self._attribution_snapshot()
        message = ("anomaly on %s %s: window value %.6g sits %.1f robust "
                   "stddevs from the trailing baseline%s"
                   % (metric, stat, value, z,
                      " — critical path owned by %s" % culprit
                      if culprit else ""))
        return self._record_alert(SloAlert(
            name="anomaly:%s:%s" % (metric, stat), cause="anomaly_detected",
            metric=metric, stat=stat, t=t, value=round(float(value), 6),
            threshold=None, windows=1, message=message,
            attribution=attribution, culprit=culprit))

    # -- reads --------------------------------------------------------------------------

    def alerts(self):
        """All alerts so far (oldest first, bounded at ``max_alerts``)."""
        with self._lock:
            return list(self._alerts)

    def breaching(self):
        """Specs currently in a breach streak: ``{name: streak}`` —
        per-tenant expansions key as ``'name{tenant="x"}'`` and per-worker
        ones as ``'name{worker="x"}'``."""

        def _render(key):
            if isinstance(key, str):
                return key
            if len(key) == 3:
                return '%s{worker="%s"}' % (key[0], key[2])
            return '%s{tenant="%s"}' % key

        with self._lock:
            return {_render(n): s
                    for n, s in self._breach_streak.items() if s}

    def collect(self):
        """Pull-collector shape (``ptpu_slo_*``): alert totals + live breach
        streaks, for registries that want the engine state exported."""
        with self._lock:
            return {"alerts": len(self._alerts),
                    "windows_evaluated": self.windows_evaluated,
                    "breaching": sum(1 for s in self._breach_streak.values()
                                     if s)}
