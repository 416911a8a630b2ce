"""The trainer side of the data service: :class:`ServiceReader`.

Port of ``petastorm_tpu.service.client``. A ServiceReader attaches to one job of a
:class:`~petastorm_tpu_torch.service.server.DataService` and offers the batched-reader
surface the :class:`~petastorm_tpu_torch.loader.DataLoader` consumes: iteration yields
the schema's namedtuple of numpy columns, and ``state_dict()``/``load_state_dict()``
checkpoint the consumed-ordinal watermark a :class:`~petastorm_tpu_torch.reader.Reader`
keeps, under the JAX package's keys (a state saved by either package's reader loads into
the other's). The service tracks no delivery acks: this watermark, presented at every
(re)attach, is the resume contract, so a link death mid-epoch becomes a fresh attach that
computes the remaining shard exactly (no loss from the detach, no replay to the
trainer). On a ``DataLoader(device='cuda')`` the delivered columns go through the
loader's pinned H2D copy and its device transform like a local reader's.

Delivery is credit-flow push: the reader grants the service a small window of pushes
(``credits``) and tops it up as it consumes, so a stalled trainer holds the service back
instead of filling its socket. Co-hosted trainers take the host-wide cache arena at
attach: items then arrive as an ``arena_key`` instead of pickled columns and are mapped
zero-copy out of the shared warm set (a key evicted between admit and get is served
again through ``refetch``).

Delivery follows the fleet's completion order by default: the lowest latency, but a
straggler worker's delay smears over whichever items arrive after it. ``ordered=True``
puts pushes back into plan (epoch, ordinal) order through a reorder buffer: deterministic
delivery at head-of-line latency, which also pins a straggler's cost to its own items.

Provenance across the wire: with a
:class:`~petastorm_tpu_torch.obs.provenance.ProvenanceRecorder` wired
(``DataLoader(provenance=...)`` calls :meth:`ServiceReader.set_provenance`), each item
push's entries (the decode worker's ``svc.decode@<name>`` record and the service's
``svc.wire`` span, each with its own wall/perf anchor pair) are absorbed through the
recorder's clock-aligned child merge, and the reader adds its own ``svc.lease_wait``
span around the blocking receive, so ``slow_top`` can name the worker. A
``/timelines``-shaped telemetry document rides the ``want`` credit grants every
``telemetry_s`` seconds for the service's ``/fleet`` view.
"""
from __future__ import annotations

import threading
import time

from petastorm_tpu_torch.errors import TransportLinkDown
from petastorm_tpu_torch.recovery import RecoveryOptions
from petastorm_tpu_torch.service.protocol import (
    OP_ATTACH,
    OP_ATTACHED,
    OP_DETACH,
    OP_DETACHED,
    OP_END,
    OP_ITEM,
    OP_QUARANTINED,
    OP_REFETCH,
    OP_REJECTED,
    OP_WANT,
)


class ServiceAttachRejected(RuntimeError):
    """The service's admission control refused the attach."""


class ServiceReader:
    """Batched reader over a data-service job. Plugs into
    :class:`~petastorm_tpu_torch.loader.DataLoader` unchanged::

        reader = ServiceReader(svc.trainer_address(), svc.token, job="train")
        loader = DataLoader(reader, batch_size=256)
    """

    is_batched_reader = True

    def __init__(self, address, token, job, trainer=None, tenant=None,
                 recovery=None, credits=8, arena=True, registry=None,
                 telemetry_s=2.0, ordered=False):
        from petastorm_tpu_torch.transport.tcp import TcpChildTransport, \
            parse_address

        self._rec = recovery or RecoveryOptions()
        self._prov = None
        self._registry = registry
        self._telemetry_s = None if telemetry_s is None \
            else max(0.1, float(telemetry_s))
        self._telemetry_next = time.monotonic()
        #: ordered=True yields items in plan (epoch, ordinal) order instead
        #: of fleet completion order: out-of-order pushes park in a reorder
        #: buffer until the cursor item lands. Deterministic delivery, and a
        #: straggler worker's latency surfaces AT ITS OWN ITEMS (head-of-
        #: line), where the provenance fold can name it — completion order
        #: launders a straggler into uniform inter-arrival waits.
        self._ordered = bool(ordered)
        self._pending = {}           # (epoch, ordinal) -> buffered push
        self._cursor = (0, 0)        # next (epoch, ordinal) to yield (ordered)
        host, port, session = parse_address(address)
        self.job = job
        self.trainer = trainer or "trainer-%d" % session
        self.tenant = tenant
        self._want_arena = bool(arena)
        self._credit_target = max(1, int(credits))
        self._credits_out = 0
        self._consumed = {}          # epoch -> set(ordinal) — THE watermark
        self.quarantined = {}        # (epoch, ordinal) -> cause
        self._arena = None
        self._arena_leases = []
        self._refetching = set()     # keys re-requested after an arena miss
        self._end_seen = False
        self._stopped = False
        self._lock = threading.Lock()
        self.schema = None
        self.num_epochs = 0
        self.epoch_sizes = {}
        # loader duck surface
        self.keep_passthrough = False
        self.transform_spec = None
        self.last_row_consumed = False
        self.cur_shard = None
        self.shard_count = None
        self._transport = TcpChildTransport(host, port, session, token,
                                            self._rec)
        self._transport.dial()
        self._transport.mark_ready()
        self._attach()

    # -- attach / detach ----------------------------------------------------------------

    def _attach(self):
        """(Re)attach with the current watermark; retries across link deaths
        until the service answers or the redial ceiling kills the link."""
        out = {"op": OP_ATTACH, "job": self.job, "trainer": self.trainer,
               "tenant": self.tenant, "arena": self._want_arena,
               "consumed": {e: sorted(v)
                            for e, v in self._consumed.items()}}
        while True:
            try:
                self._transport.send(out)
                while True:
                    reply = self._transport.recv()
                    op = reply.get("op")
                    if op in (OP_ATTACHED, OP_REJECTED):
                        break
                    # stale pushes from the dead conversation: unconsumed,
                    # so the fresh attach re-serves them — drop here
            except TransportLinkDown:
                continue
            break
        if reply["op"] == OP_REJECTED:
            raise ServiceAttachRejected(reply.get("reason", "rejected"))
        self.schema = reply["schema"]
        self.num_epochs = reply["num_epochs"]
        self.epoch_sizes = dict(reply["epoch_sizes"])
        self._row_type = self.schema.make_namedtuple_type()
        self._credits_out = 0
        self._refetching = set()
        self._end_seen = False
        # stale reorder-buffered pushes belong to the dead conversation;
        # they are unconsumed, so the fresh attach re-serves them
        self._pending = {}
        self._cursor = (0, 0)
        self._advance_cursor()
        if reply.get("arena") and self._arena is None:
            from petastorm_tpu_torch.io.arena import process_arena

            self._arena = process_arena()

    def detach(self):
        """Clean mid-epoch detach: unconsumed work returns to the pool with
        no loss; a later :class:`ServiceReader` restored from this reader's
        :meth:`state_dict` resumes watermark-exact."""
        try:
            self._transport.send({"op": OP_DETACH})
            while True:
                reply = self._transport.recv()
                if reply.get("op") == OP_DETACHED:
                    break
        except (TransportLinkDown, EOFError, OSError):
            pass  # a dead link IS a detach server-side

    # -- iteration ----------------------------------------------------------------------

    def __iter__(self):
        return self

    def _mark_consumed(self, epoch, ordinal):
        self._consumed.setdefault(int(epoch), set()).add(int(ordinal))

    def _advance_cursor(self):
        """Move the ordered-mode cursor to the smallest unconsumed
        (epoch, ordinal) at or after its current position."""
        if not self._ordered:
            return
        e, o = self._cursor
        while e < self.num_epochs:
            size = int(self.epoch_sizes.get(e, 0))
            consumed = self._consumed.get(e, ())
            while o < size and o in consumed:
                o += 1
            if o < size:
                break
            e, o = e + 1, 0
        self._cursor = (e, o)

    def _consume_quarantine(self, msg, epoch, ordinal):
        """A quarantine push occupies its ordinal: record the cause, mark
        the slot consumed, and (ordered mode) advance past it."""
        self._refetching.discard((epoch, ordinal))
        self._mark_consumed(epoch, ordinal)
        self.quarantined[(epoch, ordinal)] = msg.get("cause")
        if self._prov is not None:
            # the trainer-side twin of the service's exactly-once
            # quarantine ledger entry
            self._prov.note_quarantined(
                epoch, ordinal, int(msg.get("attempts", 1)),
                msg.get("cause") or "quarantined")
        self._advance_cursor()

    def _flush_pending(self):
        """Deliver the reorder-buffered push parked at the cursor, if any.
        Returns the row, or None when the head of line hasn't arrived yet
        (or a buffered quarantine / arena miss advanced state row-lessly)."""
        while True:
            entry = self._pending.pop(self._cursor, None)
            if entry is None:
                return None
            epoch, ordinal = self._cursor
            if entry[0] == "quar":
                self._consume_quarantine(entry[1], epoch, ordinal)
                continue
            _, msg, r0, r1 = entry
            try:
                cols = self._materialize(msg)
            except TransportLinkDown:
                self._attach()  # clears the buffer; the attach re-serves
                return None
            if cols is None:
                return None  # arena miss: the refetch re-serves at cursor
            self._refetching.discard((epoch, ordinal))
            self._mark_consumed(epoch, ordinal)
            self._absorb_prov(msg, epoch, ordinal, r0, r1)
            self._advance_cursor()
            return self._row_type(**cols)

    def _materialize(self, msg):
        """Columns for one item push: inline payload, or an arena mapping
        pinned by a lease the reader holds until :meth:`stop`. Returns None
        when the arena missed (a refetch was sent)."""
        payload = msg.get("payload")
        if payload is not None:
            return payload
        key = msg.get("arena_key")
        got = self._arena.get(tuple(key)) if self._arena is not None else None
        if got is None:
            self._refetching.add((int(msg["epoch"]), int(msg["ordinal"])))
            self._transport.send({"op": OP_REFETCH, "epoch": msg["epoch"],
                                  "ordinal": msg["ordinal"]})
            return None
        value, lease = got
        self._arena_leases.append(lease)
        return value

    def __next__(self):
        if self._stopped:
            raise StopIteration
        while True:
            if self._ordered:
                row = self._flush_pending()
                if row is not None:
                    return row
            if self._end_seen and not self._refetching and not self._pending:
                # "end" marks the plan complete, but an in-flight refetch
                # (arena miss) or a reorder-buffered push still owes us its
                # item — drain those first
                self.last_row_consumed = True
                raise StopIteration
            low_water = max(1, self._credit_target // 2)
            r0 = time.perf_counter()
            try:
                if self._credits_out < low_water:
                    grant = self._credit_target - self._credits_out
                    out = {"op": OP_WANT, "credits": grant}
                    doc = self._maybe_telemetry()
                    if doc is not None:
                        out["telemetry"] = doc
                    self._transport.send(out)
                    self._credits_out += grant
                msg = self._transport.recv()
            except TransportLinkDown:
                self._attach()  # link is back: resume watermark-exact
                continue
            except (EOFError, OSError):
                self.last_row_consumed = True
                raise StopIteration from None
            r1 = time.perf_counter()
            op = msg.get("op")
            if op == OP_ITEM:
                self._credits_out = max(0, self._credits_out - 1)
                epoch, ordinal = int(msg["epoch"]), int(msg["ordinal"])
                if self._ordered and (epoch, ordinal) != self._cursor:
                    if ordinal not in self._consumed.get(epoch, ()):
                        self._pending[(epoch, ordinal)] = \
                            ("item", msg, r0, r1)
                    continue  # head of line hasn't arrived yet
                try:
                    cols = self._materialize(msg)
                except TransportLinkDown:
                    self._attach()
                    continue
                if cols is None:
                    continue  # arena miss: the refetch re-serves it
                self._refetching.discard((epoch, ordinal))
                self._mark_consumed(epoch, ordinal)
                self._absorb_prov(msg, epoch, ordinal, r0, r1)
                self._advance_cursor()
                return self._row_type(**cols)
            if op == OP_QUARANTINED:
                self._credits_out = max(0, self._credits_out - 1)
                epoch, ordinal = int(msg["epoch"]), int(msg["ordinal"])
                if self._ordered and (epoch, ordinal) != self._cursor:
                    if ordinal not in self._consumed.get(epoch, ()):
                        self._pending[(epoch, ordinal)] = ("quar", msg)
                    continue
                self._consume_quarantine(msg, epoch, ordinal)
                continue
            if op == OP_END:
                self._end_seen = True

    def _absorb_prov(self, msg, epoch, ordinal, r0, r1):
        """Merge the push's cross-wire provenance into the wired recorder:
        absorb each producer blob through its own clock anchors, then record
        this reader's blocking receive as ``svc.lease_wait``."""
        rec = self._prov
        if rec is None:
            return
        try:
            for entry in msg.get("prov") or ():
                blob, pid, wall_anchor, perf_anchor = entry
                rec.absorb_child(tuple(blob), pid, wall_anchor, perf_anchor)
            rec.add_item_span(epoch, ordinal, "svc.lease_wait", r0, r1)
            rec.note_delivery(epoch, ordinal, int(msg.get("rows") or 0))
        except Exception:  # noqa: BLE001 — provenance must never fail delivery
            from petastorm_tpu_torch.obs.log import degradation

            degradation(
                "svc_prov_absorb_error",
                "trainer %r could not absorb cross-wire provenance for "
                "%d:%d; the item is delivered without attribution",
                self.trainer, epoch, ordinal)

    def _maybe_telemetry(self):
        """An export document for the next ``want`` frame when the telemetry
        cadence elapsed, else None (the credit grants that already flow are
        the trainer's only service-bound frames)."""
        if self._telemetry_s is None:
            return None
        now = time.monotonic()
        if now < self._telemetry_next:
            return None
        self._telemetry_next = now + self._telemetry_s
        try:
            from petastorm_tpu_torch.obs.metrics import default_registry
            from petastorm_tpu_torch.obs.timeseries import export_document

            reg = self._registry if self._registry is not None \
                else default_registry()
            reg.sample_timelines()
            return export_document(
                reg, extra={"source": "trainer:%s" % self.trainer})
        except Exception:  # noqa: BLE001 — telemetry must never fail a credit grant
            from petastorm_tpu_torch.obs.log import degradation

            degradation("svc_trainer_telemetry_error",
                        "trainer %r could not export telemetry; the credit "
                        "grant ships without it", self.trainer)
            return None

    def next(self):
        return self.__next__()

    # -- checkpoint ---------------------------------------------------------------------

    def state_dict(self):
        """The consumed-work watermark — restoring it into a fresh
        ServiceReader (or this one) resumes exactly where this shard
        stopped, quarantined items charged exactly once."""
        return {
            "service": 1,
            "job": self.job,
            "consumed": {int(e): sorted(v)
                         for e, v in self._consumed.items()},
        }

    def load_state_dict(self, state):
        if state.get("service") != 1 or "consumed" not in state:
            raise ValueError(
                "not a ServiceReader state (keys: %s)" % sorted(state))
        if state.get("job") != self.job:
            raise ValueError(
                "checkpoint belongs to job %r; this reader is attached to "
                "%r — resuming would replay the wrong plan"
                % (state.get("job"), self.job))
        self.detach()
        self._consumed = {int(e): set(v)
                          for e, v in state["consumed"].items()}
        self.last_row_consumed = False
        self._attach()

    # -- loader duck surface ------------------------------------------------------------

    def set_trace(self, tracer):
        pass

    def set_provenance(self, recorder):
        """Wire the loader's recorder; pushed items then absorb their
        cross-wire spans (see the module docstring)."""
        self._prov = recorder

    def set_health(self, monitor):
        pass

    def reset(self):
        """Fresh pass over the full plan (clears the watermark)."""
        self.detach()
        self._consumed = {}
        self.last_row_consumed = False
        self._attach()

    def stop(self):
        if self._stopped:
            return
        self._stopped = True
        self.detach()
        leases, self._arena_leases = self._arena_leases, []
        for lease in leases:
            lease.release()
        self._transport.close()

    def join(self):
        pass
