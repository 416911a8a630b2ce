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

The health monitor, provenance, the time series, SLOs and the stats CLI are ROADMAP.md
Queue 1 item 8b; tenants and the controller item 8c.
"""
from petastorm_tpu_torch.obs.flight import FlightRecorder
from petastorm_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)

__all__ = ["FlightRecorder", "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry"]
