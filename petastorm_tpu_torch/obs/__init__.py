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

Provenance, the critical path, run diffs and the stats CLI are ROADMAP.md Queue 1 item
8b(ii); tenants and the controller item 8c.
"""
from petastorm_tpu_torch.obs.flight import FlightRecorder
from petastorm_tpu_torch.obs.health import HealthMonitor, HealthOptions
from petastorm_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from petastorm_tpu_torch.obs.serve import MetricsServer
from petastorm_tpu_torch.obs.slo import AnomalyDetector, SloEngine, SloSpec
from petastorm_tpu_torch.obs.timeseries import TimelineStore

__all__ = ["AnomalyDetector", "Counter", "FlightRecorder", "Gauge", "HealthMonitor",
           "HealthOptions", "Histogram", "MetricsRegistry", "MetricsServer", "SloEngine",
           "SloSpec", "TimelineStore", "default_registry"]
