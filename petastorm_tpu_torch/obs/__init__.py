"""Observability for the port: metrics, exporters, degradation log, bottleneck analyzer.

Port of the base of ``petastorm_tpu.obs``:

- :mod:`petastorm_tpu_torch.obs.metrics`: the process-wide registry of counters, gauges
  and log-bucketed histograms (``default_registry()``), and private
  ``MetricsRegistry()`` instances for ``DataLoader(metrics=...)``;
- :mod:`petastorm_tpu_torch.obs.export`: Prometheus text-format files and a periodic
  JSONL :class:`~petastorm_tpu_torch.obs.export.Reporter`;
- :mod:`petastorm_tpu_torch.obs.analyze`: the bottleneck analyzer behind
  ``DataLoader.bottleneck_report()``;
- :mod:`petastorm_tpu_torch.obs.log`: warn-once degradation messages counted as
  ``ptpu_degradations_total{cause=...}``;
- :mod:`petastorm_tpu_torch.obs.flight`: the bounded event ring the degradation log and
  the chaos plane mirror into.

and the liveness and time planes:

- :mod:`petastorm_tpu_torch.obs.health`: heartbeats on every pipeline actor, the
  backpressure-aware stall watchdog, flight records and the heal escalation;
- :mod:`petastorm_tpu_torch.obs.timeseries`: windowed series of the registry, sampled on
  the Reporter's cadence;
- :mod:`petastorm_tpu_torch.obs.slo`: declarative SLOs and anomaly watches over those
  windows, with debounced alerts;
- :mod:`petastorm_tpu_torch.obs.serve`: the loopback HTTP scrape endpoint.

and the attribution plane:

- :mod:`petastorm_tpu_torch.obs.provenance`: per-item causal spans and annotations
  through every seam of the read path, the pool and the loader, and each delivered
  batch's contributing items;
- :mod:`petastorm_tpu_torch.obs.critical_path`: the self-time fold of those spans into
  an :class:`~petastorm_tpu_torch.obs.critical_path.AttributionReport`;
- :mod:`petastorm_tpu_torch.obs.diff`: site-by-site diffs of two trend-gate runs
  (``python -m petastorm_tpu_torch.obs.diff``);
- :mod:`petastorm_tpu_torch.obs.stats_cli`: the terminal dashboard over a Reporter's
  JSONL stream or a Prometheus file (``python -m petastorm_tpu_torch.obs.stats_cli``).

and the tenant plane:

- :mod:`petastorm_tpu_torch.obs.tenant`: a validated :class:`TenantContext` carried
  through every layer a batch touches, ``tenant=``-labelled twins beside the untagged
  totals, and the fleet-mergeable :class:`TenantUsageReport` (the stats CLI's tenant
  panel).

The closed-loop controller is :mod:`petastorm_tpu_torch.control`.
"""
from petastorm_tpu_torch.obs.flight import FlightRecorder
from petastorm_tpu_torch.obs.health import HealthMonitor, HealthOptions
from petastorm_tpu_torch.obs.critical_path import AttributionReport
from petastorm_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from petastorm_tpu_torch.obs.provenance import ProvenanceRecorder
from petastorm_tpu_torch.obs.serve import MetricsServer
from petastorm_tpu_torch.obs.slo import AnomalyDetector, SloEngine, SloSpec
from petastorm_tpu_torch.obs.tenant import TenantContext, TenantUsageReport
from petastorm_tpu_torch.obs.timeseries import TimelineStore

__all__ = ["AnomalyDetector", "AttributionReport", "Counter", "FlightRecorder", "Gauge",
           "HealthMonitor", "HealthOptions", "Histogram", "MetricsRegistry",
           "MetricsServer", "ProvenanceRecorder", "SloEngine", "SloSpec", "TenantContext",
           "TenantUsageReport", "TimelineStore", "default_registry"]
