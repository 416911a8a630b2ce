"""The decode-worker side of the data service.

Port of ``petastorm_tpu.service.worker``. A :class:`DecodeWorker` dials one hub session,
announces itself, then runs the strict request-and-response lease conversation: receive
a lease, run the job's decode callable, answer done (the columns and timings) or fail
(the error and whether it is permanent). A link death rides the child transport's
redial: :class:`~petastorm_tpu_torch.errors.TransportLinkDown` means the conversation
died but the link is back, so the worker waits for the service's re-dispatch (the
service always speaks first); ``EOFError`` means the service is gone and the worker
exits.

Decode callables arrive over the wire in the first lease of each job a link generation
(``JobSpec.wire_spec()``), so a worker process needs no job-specific code, only the
modules the pickled callable imports. Decoding runs on the host: a worker process makes
no CUDA context.

Provenance across the wire: the worker arms a private per-item collector
(:func:`~petastorm_tpu_torch.obs.provenance.child_collector`, the pool child's pattern)
and records one ``svc.decode@<name>`` span a lease on its own ``perf_counter`` timeline.
The record rides the done reply with the (wall, perf) anchor pair sampled at
construction, so the trainer's recorder aligns it as it does a pool child's, and
``slow_top`` names the worker. A ``/timelines``-shaped telemetry document rides the same
replies every ``telemetry_s`` seconds for the service's ``/fleet`` view.
"""
from __future__ import annotations

import os
import threading
import time

from petastorm_tpu_torch.errors import (
    PERMANENT_IO_ERRORS,
    PagedecCorruptError,
    TransportLinkDown,
)
from petastorm_tpu_torch.obs.provenance import child_collector
from petastorm_tpu_torch.recovery import RecoveryOptions
from petastorm_tpu_torch.service.protocol import (
    OP_DONE,
    OP_FAIL,
    OP_LEASE,
    OP_READY,
    OP_STOP,
    svc_worker_metrics,
)


def _normalize(result):
    """``decode(item)`` contract: ``{name: ndarray}`` or ``(cols, rows)``;
    without an explicit count the first column's length is the row count."""
    if isinstance(result, tuple):
        cols, rows = result
        return cols, int(rows)
    rows = 0
    for value in result.values():
        rows = int(len(value))
        break
    return result, rows


def _is_permanent(exc):
    return isinstance(exc, PERMANENT_IO_ERRORS) \
        or isinstance(exc, PagedecCorruptError)


class DecodeWorker:
    """One fleet member: dial ``address`` (from
    :meth:`~petastorm_tpu_torch.service.server.DataService.worker_address`) with
    the service's hello ``token`` and decode leases until told to stop."""

    def __init__(self, address, token, recovery=None, name=None,
                 decoders=None, registry=None, provenance=True,
                 telemetry_s=2.0):
        from petastorm_tpu_torch.transport.tcp import TcpChildTransport, \
            parse_address

        self._rec = recovery or RecoveryOptions()
        host, port, session = parse_address(address)
        self._transport = TcpChildTransport(host, port, session, token,
                                            self._rec)
        self.name = name or "decode-%d" % session
        #: preloaded {job: decode} (tests / co-hosted fleets); wire specs
        #: from lease messages land here too
        self._decoders = dict(decoders or {})
        self._thread = None
        #: worker-side counters resolved HERE, before the serve loop starts,
        #: so they home on the caller's registry (see svc_worker_metrics)
        self._registry = registry
        self._wm = svc_worker_metrics(registry)
        self._collector = child_collector() if provenance else None
        # the clock-alignment anchor pair: wall trusted ONCE, here; every
        # span ships perf_counter times relative to this anchor
        self._wall_anchor = time.time()
        self._perf_anchor = time.perf_counter()
        self._telemetry_s = None if telemetry_s is None \
            else max(0.1, float(telemetry_s))
        self._telemetry_next = time.monotonic()

    def run(self):
        """Dial and serve until the service stops or the link dies for good.
        Safe to call in a dedicated thread (:meth:`start`)."""
        transport = self._transport
        transport.dial()
        transport.mark_ready()
        try:
            transport.send({"op": OP_READY, "worker": self.name})
        except TransportLinkDown:
            pass  # redialed; the ready that mattered was the hello itself
        except EOFError:
            return
        while True:
            try:
                msg = transport.recv()
            except TransportLinkDown:
                continue  # link is back; await the service's re-dispatch
            except (EOFError, OSError):
                break
            op = msg.get("op")
            if op == OP_STOP:
                break
            if op != OP_LEASE:
                continue
            spec = msg.get("spec")
            if spec:
                self._decoders[spec["job"]] = spec["decode"]
            reply = self._decode_lease(msg)
            try:
                transport.send(reply)
            except TransportLinkDown:
                continue  # reply died with its generation; service requeues
            except (EOFError, OSError):
                break
        transport.close()

    def _decode_lease(self, msg):
        t0 = time.monotonic()
        decode = self._decoders.get(msg.get("job"))
        if decode is None:
            self._wm["failures"].inc()
            return self._with_telemetry(
                {"op": OP_FAIL, "lease": msg["lease"],
                 "error": "no decoder for job %r" % msg.get("job"),
                 "permanent": False})
        rec = None
        if self._collector is not None:
            rec = self._collector.open_item(
                (msg.get("epoch", 0), msg.get("ordinal", 0), msg.get("item")))
        try:
            td0 = time.monotonic()
            p0 = time.perf_counter()
            cols, rows = _normalize(decode(msg["item"]))
            p1 = time.perf_counter()
            decode_s = time.monotonic() - td0
        except Exception as exc:  # noqa: BLE001 — every decode error is a wire verdict
            self._wm["failures"].inc()
            return self._with_telemetry(
                {"op": OP_FAIL, "lease": msg["lease"],
                 "error": "%s: %s" % (type(exc).__name__, exc),
                 "permanent": _is_permanent(exc)})
        self._wm["decodes"].inc()
        self._wm["decode_seconds"].inc(decode_s)
        reply = {"op": OP_DONE, "lease": msg["lease"], "payload": cols,
                 "rows": rows,
                 "meta": {"decode_s": decode_s,
                          "wall_s": time.monotonic() - t0}}
        if rec is not None:
            rec.add_span("svc.decode@%s" % self.name, p0, p1)
            rec.annotate("svc_worker", self.name)
            blob = self._collector.close_item(rec)
            if blob is not None:
                reply["prov"] = (blob, os.getpid(), self._wall_anchor,
                                 self._perf_anchor)
        return self._with_telemetry(reply)

    def _with_telemetry(self, reply):
        """Piggyback a ``/timelines``-shaped export on this reply when the
        telemetry cadence elapsed (strict request/response conversation: the
        replies that already flow are the only frames we get)."""
        if self._telemetry_s is None:
            return reply
        now = time.monotonic()
        if now < self._telemetry_next:
            return reply
        self._telemetry_next = now + self._telemetry_s
        try:
            from petastorm_tpu_torch.obs.metrics import default_registry
            from petastorm_tpu_torch.obs.timeseries import export_document

            reg = self._registry if self._registry is not None \
                else default_registry()
            reg.sample_timelines()
            reply["telemetry"] = export_document(
                reg, extra={"source": "worker:%s" % self.name})
        except Exception:  # noqa: BLE001 — telemetry must never fail a lease
            from petastorm_tpu_torch.obs.log import degradation

            degradation("svc_worker_telemetry_error",
                        "decode worker %r could not export telemetry; the "
                        "reply ships without it", self.name)
        return reply

    def start(self):
        """Run :meth:`run` on a daemon thread; returns the thread."""
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="ptpu-%s" % self.name)
        self._thread.start()
        return self._thread

    def join(self, timeout=None):
        if self._thread is not None:
            self._thread.join(timeout)

    def close(self):
        self._transport.close()


# -- parquet helpers ---------------------------------------------------------------------


class ParquetRowGroupDecoder:
    """Picklable decode callable for ``(path, row_group)`` plan items: one
    classic columnar read of that row group into numpy columns."""

    def __init__(self, columns=None):
        self.columns = list(columns) if columns else None

    def __call__(self, item):
        import pyarrow.parquet as pq

        path, row_group = item
        table = pq.ParquetFile(path).read_row_group(row_group,
                                                    columns=self.columns)
        cols = {name: table.column(name).to_numpy(zero_copy_only=False)
                for name in table.column_names}
        return cols, table.num_rows


def parquet_job(job, paths, tenant=None, priority=None, num_epochs=1,
                shuffle=False, seed=0, columns=None):
    """Build a :class:`~petastorm_tpu_torch.service.protocol.JobSpec` over a
    parquet store: one plan item per ``(file, row_group)``, schema inferred
    from the first file (the trainer-facing
    :class:`~petastorm_tpu_torch.unischema.Unischema`)."""
    import os

    import pyarrow.parquet as pq

    from petastorm_tpu_torch.service.protocol import JobSpec
    from petastorm_tpu_torch.unischema import Unischema

    if isinstance(paths, str):
        root = paths[len("file://"):] if paths.startswith("file://") else paths
        if os.path.isdir(root):
            paths = sorted(
                os.path.join(root, f) for f in os.listdir(root)
                if f.endswith(".parquet") and not f.startswith("_"))
        else:
            paths = [root]
    if not paths:
        raise ValueError("parquet_job %r: no parquet files found" % job)
    items = []
    schema = None
    for path in paths:
        pf = pq.ParquetFile(path)
        if schema is None:
            schema = Unischema.from_arrow_schema(pf.schema_arrow)
        items.extend((path, rg) for rg in range(pf.num_row_groups))
    return JobSpec(job, items, ParquetRowGroupDecoder(columns), schema,
                   tenant=tenant, priority=priority, num_epochs=num_epochs,
                   shuffle=shuffle, seed=seed)
