"""The data service: one decode fleet, many trainers.

Port of ``petastorm_tpu.service``, with its exports.

- :class:`DataService`: the server. It owns each job's plan, leases items to decode
  workers over the tcp transport, sends every decoded payload to all attached trainers
  (decode once, serve many), and runs QoS between the tenants' jobs.
- :class:`DecodeWorker`: one fleet member; it dials a hub session and decodes leases
  until stopped.
- :class:`ServiceReader`: the trainer's batched reader; it plugs into
  :class:`~petastorm_tpu_torch.loader.DataLoader` unchanged and checkpoints the
  consumed-ordinal watermark the service resumes from.
- :class:`JobSpec` and :func:`parquet_job`: job definitions.
- :class:`FleetTelemetry` and :class:`FleetAdvisor`: the ``GET /fleet`` view and the
  read-only sensor that publishes ``ptpu_svc_advised_workers``.
"""
from petastorm_tpu_torch.service.client import ServiceAttachRejected, ServiceReader
from petastorm_tpu_torch.service.protocol import PROTOCOL_VERSION, JobSpec, \
    svc_metrics, svc_worker_metrics
from petastorm_tpu_torch.service.server import DataService, ServiceOptions
from petastorm_tpu_torch.service.telemetry import FleetAdvisor, FleetTelemetry
from petastorm_tpu_torch.service.worker import DecodeWorker, \
    ParquetRowGroupDecoder, parquet_job

__all__ = [
    "DataService",
    "DecodeWorker",
    "FleetAdvisor",
    "FleetTelemetry",
    "JobSpec",
    "PROTOCOL_VERSION",
    "ParquetRowGroupDecoder",
    "ServiceAttachRejected",
    "ServiceOptions",
    "ServiceReader",
    "parquet_job",
    "svc_metrics",
    "svc_worker_metrics",
]
