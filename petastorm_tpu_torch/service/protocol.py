"""The data service's wire protocol: ops, job specs, metrics.

Port of ``petastorm_tpu.service.protocol``, with the same ops, messages and metric
families. The service speaks pickled-object frames over the framed tcp transport
(:mod:`petastorm_tpu_torch.transport.tcp`); every message is a plain dict with an
``"op"`` key, so peers skip fields they do not know. Two conversations share the hub.

Decode worker <-> service (strict request and response a lease)::

    worker:  {"op": "ready", "worker": name}          once a fresh link
    service: {"op": "lease", "lease": id, "job": j, "epoch": e,
              "ordinal": o, "item": spec_item, ["spec": JobSpec]}
    worker:  {"op": "done", "lease": id, "payload": cols, "rows": n,
              "meta": {"decode_s": ..., "wall_s": ...},
              ["prov": (blob, pid, wall_anchor, perf_anchor)],
              ["telemetry": export_doc]}
          |  {"op": "fail", "lease": id, "error": str, "permanent": bool,
              ["telemetry": export_doc]}
    service: {"op": "stop"}                            shutdown

Provenance across the wire rides frames that already flow. ``prov`` has the pool
child's blob shape: ``((epoch, ordinal, key, spans, annotations), pid, wall_anchor,
perf_anchor)``, spans on the sender's ``perf_counter`` timeline with one (wall, perf)
anchor pair sampled at worker start. ``telemetry`` is a ``/timelines``-shaped export
document (:func:`~petastorm_tpu_torch.obs.timeseries.export_document`) sent on a slow
cadence; the service's ``/fleet`` view merges the latest one a peer on anchored clocks.

A lease conversation is pinned to its link generation by the transport's in-flight
ledger: a link death mid-conversation sends the un-acknowledged lease again (never
twice: frames of a dead generation are dropped with it).

Trainer <-> service (credit-flow push)::

    trainer: {"op": "attach", "job": j, "trainer": t, "tenant": slug,
              "consumed": {epoch: [ordinals]}, "arena": bool}
    service: {"op": "attached", "schema": Unischema, "num_epochs": n,
              "epoch_sizes": {epoch: count}, "arena": bool, "version": 1}
          |  {"op": "rejected", "reason": str}
    trainer: {"op": "want", "credits": n, ["telemetry": export_doc]}
    service: {"op": "item", "epoch": e, "ordinal": o, "rows": n,
              "payload": cols | None, ["arena_key": key],
              ["prov": [(blob, pid, wall, perf), ...]]}
          |  {"op": "quarantined", "epoch": e, "ordinal": o, "cause": str,
              ["attempts": n]}
          |  {"op": "end"}
    trainer: {"op": "refetch", "epoch": e, "ordinal": o}  arena-key miss
    trainer: {"op": "detach", "consumed": {...}}
    service: {"op": "detached"}

``consumed`` is the trainer's checkpoint watermark, the ``{epoch: set(ordinal)}`` map a
:class:`~petastorm_tpu_torch.reader.Reader` keeps. The service tracks no delivery acks: a
(re)attach computes the remaining shard from the map the client presents, so a detach
returns unconsumed work with no loss, and a reattach resumes at the watermark with no
replay.
"""
from __future__ import annotations

PROTOCOL_VERSION = 1

# worker <-> service
OP_READY = "ready"
OP_LEASE = "lease"
OP_DONE = "done"
OP_FAIL = "fail"
OP_STOP = "stop"

# trainer <-> service
OP_ATTACH = "attach"
OP_ATTACHED = "attached"
OP_REJECTED = "rejected"
OP_WANT = "want"
OP_ITEM = "item"
OP_QUARANTINED = "quarantined"
OP_END = "end"
OP_DETACH = "detach"
OP_DETACHED = "detached"
OP_REFETCH = "refetch"

#: scheduler tiers for the TenantContext priority hints (lower = first)
PRIORITY_TIERS = {"high": 0, "normal": 1, None: 1, "low": 2}


class JobSpec:
    """One job the fleet decodes: a plan over picklable items plus the decode
    callable that turns one item into a columns dict.

    ``decode(item)`` must be picklable (module-level function or
    ``functools.partial`` over one) and return either ``{name: ndarray}`` or
    ``({name: ndarray}, rows)``; without an explicit row count the first
    column's length is used. ``schema`` is the
    :class:`~petastorm_tpu_torch.unischema.Unischema` trainers receive at attach —
    the :class:`~petastorm_tpu_torch.service.client.ServiceReader` exposes it to
    the :class:`~petastorm_tpu_torch.loader.DataLoader` unchanged.
    """

    __slots__ = ("job", "items", "decode", "schema", "tenant", "priority",
                 "num_epochs", "shuffle", "seed")

    def __init__(self, job, items, decode, schema, tenant=None, priority=None,
                 num_epochs=1, shuffle=False, seed=0):
        if not items:
            raise ValueError("JobSpec %r needs at least one plan item" % job)
        if priority not in PRIORITY_TIERS:
            raise ValueError("priority must be one of %r, got %r"
                             % (sorted(k for k in PRIORITY_TIERS if k),
                                priority))
        self.job = str(job)
        self.items = list(items)
        self.decode = decode
        self.schema = schema
        self.tenant = tenant
        self.priority = priority
        self.num_epochs = num_epochs
        self.shuffle = bool(shuffle)
        self.seed = seed

    def wire_spec(self):
        """The worker-facing subset: just enough to run ``decode`` (the plan
        and trainer bookkeeping never leave the service)."""
        return {"job": self.job, "decode": self.decode,
                "tenant": self.tenant}


# -- metrics ---------------------------------------------------------------------------

_default_metrics = None


def svc_metrics(registry=None):
    """The ``ptpu_svc_*`` family (memoized for the default registry — the
    lease and delivery hot paths resolve handles once per process)."""
    global _default_metrics
    from petastorm_tpu_torch.obs.metrics import default_registry

    if registry is None or registry is default_registry():
        if _default_metrics is None:
            _default_metrics = _build_metrics(default_registry())
        return _default_metrics
    return _build_metrics(registry)


def _build_metrics(reg):
    return {
        "workers": reg.gauge(
            "ptpu_svc_workers",
            help="decode workers currently connected to the data service"),
        "trainers": reg.gauge(
            "ptpu_svc_trainers",
            help="trainers currently attached to the data service"),
        "jobs": reg.gauge(
            "ptpu_svc_jobs", help="jobs registered with the data service"),
        "leases": reg.counter(
            "ptpu_svc_leases_total",
            help="decode leases dispatched to the worker fleet"),
        "lease_redispatch": reg.counter(
            "ptpu_svc_lease_redispatch_total",
            help="leases returned to the pool by a dead link / transient "
                 "failure and dispatched again"),
        "lease_leaked": reg.counter(
            "ptpu_svc_lease_leaked_total",
            help="leases still outstanding when the service stopped — "
                 "should be 0; growth is a dispatcher bug"),
        "leases_outstanding": reg.gauge(
            "ptpu_svc_leases_outstanding",
            help="decode leases currently held by workers"),
        "decodes": reg.counter(
            "ptpu_svc_decodes_total",
            help="plan items decoded by the fleet (decode-once: compare "
                 "with served items for the fan-out ratio)"),
        "redecodes": reg.counter(
            "ptpu_svc_redecodes_total",
            help="items decoded again after their payload was dropped "
                 "(reattach after eviction — correctness, not the hot path)"),
        "decode_seconds": reg.counter(
            "ptpu_svc_decode_seconds_total",
            help="fleet decode seconds (the worker-seconds numerator of the "
                 "decode-once acceptance ratio)"),
        "served_items": reg.counter(
            "ptpu_svc_served_items_total",
            help="decoded items pushed to trainers (each decode serves "
                 "every attached trainer that still needs it)"),
        "served_rows": reg.counter(
            "ptpu_svc_served_rows_total",
            help="rows pushed to trainers"),
        "fanout_serves": reg.counter(
            "ptpu_svc_fanout_serves_total",
            help="serves beyond the first per decoded item — the rows a "
                 "dedicated pipeline would have decoded again"),
        "quarantined": reg.counter(
            "ptpu_svc_quarantined_total",
            help="plan items quarantined service-wide (broadcast to every "
                 "trainer's watermark exactly once)"),
        "attaches": reg.counter(
            "ptpu_svc_attaches_total", help="trainer attach handshakes"),
        "detaches": reg.counter(
            "ptpu_svc_detaches_total",
            help="trainer detaches (clean requests + link deaths)"),
        "rejected": reg.counter(
            "ptpu_svc_rejected_total",
            help="attach requests refused by admission control"),
        "refetches": reg.counter(
            "ptpu_svc_refetches_total",
            help="arena-key misses a trainer asked the service to re-serve"),
        "cache_items": reg.gauge(
            "ptpu_svc_cache_items",
            help="decoded payloads resident in the serve cache"),
        "cache_bytes": reg.gauge(
            "ptpu_svc_cache_bytes",
            help="decoded payload bytes resident in the serve cache"),
        "starved_seconds": reg.counter(
            "ptpu_svc_starved_seconds_total",
            help="seconds trainers sat with credits granted and an empty "
                 "push queue while their plan still had work — the fleet "
                 "undersupplied them (the autoscaling pressure signal)"),
        "advised_workers": reg.gauge(
            "ptpu_svc_advised_workers",
            help="decode fleet size the FleetAdvisor currently recommends "
                 "(read-only sensor: compare with ptpu_svc_workers)"),
    }


def svc_worker_metrics(registry=None):
    """The ``ptpu_svc_worker_*`` families a :class:`DecodeWorker` owns in its
    OWN process. Never memoized: the worker resolves these once in
    ``__init__`` — before the serve loop starts — so the counters home on
    the registry the caller intended (a first touch inside the hot loop
    would race the default registry's memoization when a co-hosted caller
    hands each worker a private registry)."""
    from petastorm_tpu_torch.obs.metrics import default_registry

    reg = registry if registry is not None else default_registry()
    return {
        "decodes": reg.counter(
            "ptpu_svc_worker_decodes_total",
            help="leases this worker process decoded successfully"),
        "decode_seconds": reg.counter(
            "ptpu_svc_worker_decode_seconds_total",
            help="seconds this worker process spent inside decode callables"),
        "failures": reg.counter(
            "ptpu_svc_worker_failures_total",
            help="leases this worker process failed (transient + permanent)"),
    }
