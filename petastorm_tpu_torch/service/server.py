"""The DataService: one decode fleet feeding many trainers.

Port of ``petastorm_tpu.service.server``. The service owns each job's
:class:`~petastorm_tpu_torch.plan.EpochPlan` and leases plan items to remote decode
workers over the framed tcp transport, with the
:class:`~petastorm_tpu_torch.workers.PullDispatcher`'s claim-and-return discipline
across the wire: a dead link's un-acknowledged lease goes out again (the transport's
in-flight ledger pins the conversation to its link generation), a withdraw returns
claims with no loss and no duplicate, and a quarantine is decided once for the whole
service.

Decode once, serve many: each decoded payload goes to every attached trainer of its job
that still needs it, so N trainers sharing a job cost the fleet about one decode a plan
item instead of N. The service keeps no payload once it went to every current needer;
the host-wide cache arena (:mod:`petastorm_tpu_torch.io.arena`) is the serve cache, so
co-hosted trainers map the decoded warm set instead of receiving a copy, and a trainer
that attaches after an eviction costs a decode again (counted as
``ptpu_svc_redecodes_total``).

Attach and detach: the service tracks no delivery acks. The trainer's consumed-ordinal
watermark, the ``{epoch: set(ordinal)}`` map a
:class:`~petastorm_tpu_torch.reader.Reader` checkpoints, comes with every (re)attach,
and the remaining shard is computed from it: a detach (clean or a link death) returns
unconsumed work with no loss, and a reattach resumes at the watermark with no replay.

QoS between tenants: decode dispatch runs stride scheduling over jobs inside strict
priority tiers (``TenantContext`` priorities high/normal/low), with a live per-tenant
weight knob (``svc_weight:<tenant>``, :meth:`DataService.register_knobs`) that the
controller's :func:`~petastorm_tpu_torch.control.controller.tenant_qos_rules` moves. A
weight of 0 refuses the tenant's attaches. Admission caps the attached trainers in all
and a tenant.

The fleet's record: a worker's labelled decode latency, idle and lease families
(``ptpu_svc_worker_*{worker=...}``); the ``/timelines``-shaped telemetry the workers and
trainers send on frames they already send; each item's provenance across the wire (the
worker's ``svc.decode@`` record and a service-side ``svc.wire`` span) passed on to the
trainers that receive it; the trainers' starved seconds (credits granted, queue empty,
plan unfinished: the undersupply signal); and the merged fleet view at ``GET /fleet``
(:meth:`DataService.fleet_document`, :meth:`DataService.metrics_server`). With
``ServiceOptions.straggler_decode_p99_s`` a ``per_worker`` SLO debounces a straggler
alert naming the worker, and the read-only
:class:`~petastorm_tpu_torch.service.telemetry.FleetAdvisor` publishes
``ptpu_svc_advised_workers`` on the TimelineStore's cadence (``ServiceOptions.sample_s``
runs that cadence in the service's process).

The service runs on the host: it moves numpy payloads and makes no CUDA context; the
trainers' loaders put the batches on their cards.
"""
from __future__ import annotations

import os
import threading
import time

from petastorm_tpu_torch.errors import TransportLinkDown
from petastorm_tpu_torch.plan import EpochPlan
from petastorm_tpu_torch.recovery import RecoveryOptions
from petastorm_tpu_torch.service.protocol import (
    OP_ATTACH,
    OP_ATTACHED,
    OP_DETACH,
    OP_DETACHED,
    OP_DONE,
    OP_END,
    OP_FAIL,
    OP_ITEM,
    OP_LEASE,
    OP_QUARANTINED,
    OP_READY,
    OP_REFETCH,
    OP_REJECTED,
    OP_STOP,
    OP_WANT,
    PRIORITY_TIERS,
    PROTOCOL_VERSION,
    svc_metrics,
)
from petastorm_tpu_torch.workers import PullDispatcher

#: service poll tick — trainer serve loops alternate between flushing their
#: push queue and polling the socket at this cadence
TICK_S = 0.05


def _degradation(*args, **kwargs):
    from petastorm_tpu_torch.obs.log import degradation

    degradation(*args, **kwargs)


def _charge(resource, amount, label):
    if label is None:
        return
    from petastorm_tpu_torch.obs import tenant as tenant_mod

    tenant_mod.charge(resource, amount, label=label)


class ServiceOptions:
    """Service-side policy knobs."""

    __slots__ = ("host", "max_trainers", "max_trainers_per_tenant", "arena",
                 "link_redispatch_limit", "straggler_decode_p99_s",
                 "sample_s", "min_workers", "max_workers")

    def __init__(self, host="127.0.0.1", max_trainers=64,
                 max_trainers_per_tenant=None, arena=True,
                 link_redispatch_limit=None, straggler_decode_p99_s=None,
                 sample_s=None, min_workers=1, max_workers=64):
        self.host = host
        self.max_trainers = int(max_trainers)
        self.max_trainers_per_tenant = max_trainers_per_tenant
        #: admit decoded payloads into the host-wide cache arena so
        #: co-hosted trainers map the warm set instead of copying it
        self.arena = bool(arena)
        #: per-item ceiling on link-death re-dispatches before the item is
        #: quarantined as poison (a payload that reliably kills its link);
        #: None derives a generous multiple of the poison budget — plain
        #: link flaps must re-dispatch, never quarantine
        self.link_redispatch_limit = link_redispatch_limit
        #: per-worker window decode p99 above this arms the straggler SLO
        #: (debounced per worker) AND the advisor's replace-a-straggler term;
        #: None disables the straggler alert
        self.straggler_decode_p99_s = straggler_decode_p99_s
        #: run an in-process timeline sampling cadence at this period so the
        #: SLO engine + FleetAdvisor see windows without an external Reporter;
        #: None = whoever owns the registry samples (loader Reporter, tests)
        self.sample_s = sample_s
        #: FleetAdvisor clamp — the advice never leaves [min, max]
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)


class _Trainer:
    __slots__ = ("tid", "session", "tenant", "priority", "arena", "queue",
                 "credits", "remaining", "end_sent", "transport")

    def __init__(self, tid, session, tenant, priority, arena):
        self.tid = tid
        self.session = session
        self.tenant = tenant
        self.priority = priority
        self.arena = bool(arena)
        self.queue = []          # entries ready to push (credit-gated)
        self.credits = 0
        self.remaining = {}      # epoch -> set(ordinal) not yet queued
        self.end_sent = False
        #: the serve loop's transport while attached — queue producers
        #: ``wake()`` it so a fresh entry flushes without riding out the
        #: poll tick (delivery latency would quantize to it otherwise)
        self.transport = None

    def finished(self):
        return not self.queue and all(not s for s in self.remaining.values())


def _nudge(trainer):
    """Wake ``trainer``'s serve loop out of its wakeable poll so the entry
    just queued flushes immediately. Safe anywhere: a no-op before the serve
    loop attaches (attach replay entries flush on its first pass) and never
    blocks or raises."""
    transport = trainer.transport
    if transport is not None:
        transport.wake()


class _Job:
    __slots__ = ("spec", "plan", "dispatcher", "epoch_sizes", "trainers",
                 "need", "done_with", "quarantined", "fail_attempts",
                 "link_attempts", "arena_admitted", "inline_keys", "rows_of",
                 "decoded", "pass_value", "prov_of")

    def __init__(self, spec):
        self.spec = spec
        self.plan = EpochPlan(list(range(len(spec.items))),
                              num_epochs=spec.num_epochs,
                              shuffle=spec.shuffle, seed=spec.seed,
                              with_epoch=True)
        self.dispatcher = PullDispatcher(self.plan, workers_count=1,
                                         lookahead=0)
        self.epoch_sizes = {e: self.plan.items_in_epoch(e)
                            for e in range(spec.num_epochs)}
        self.trainers = {}       # tid -> _Trainer
        self.need = {}           # (epoch, ordinal) -> set(tid)
        #: items that exited the dispatch pipeline (decoded or quarantined);
        #: a late attach needing one re-enters it via return_items()
        self.done_with = set()
        self.quarantined = {}    # (epoch, ordinal) -> cause
        self.fail_attempts = {}  # (epoch, ordinal) -> decode failures
        self.link_attempts = {}  # (epoch, ordinal) -> link-death redispatches
        self.arena_admitted = set()
        #: keys that missed the arena once — re-served inline so a refetch
        #: can never loop on admit/evict races
        self.inline_keys = set()
        self.rows_of = {}        # (epoch, ordinal) -> delivered row count
        self.decoded = set()     # keys ever completed (second pass = redecode)
        self.pass_value = 0.0    # stride-scheduling virtual time
        #: (epoch, ordinal) -> [(blob, pid, wall, perf), ...] cross-wire
        #: provenance entries riding every push of that item
        self.prov_of = {}

    def tier(self):
        return PRIORITY_TIERS.get(self.spec.priority, 1)


class _Lease:
    __slots__ = ("lease_id", "job", "epoch", "ordinal", "slot", "t0",
                 "worker")

    def __init__(self, lease_id, job, epoch, ordinal, slot, worker=None):
        self.lease_id = lease_id
        self.job = job
        self.epoch = epoch
        self.ordinal = ordinal
        self.slot = slot
        self.t0 = time.monotonic()
        self.worker = worker


class DataService:
    """The disaggregated data-service server. See the module docstring for
    semantics; :mod:`petastorm_tpu_torch.service.protocol` for the wire contract.

    Lifecycle::

        svc = DataService(recovery=RecoveryOptions(...))
        svc.add_job(JobSpec(...))
        addr = svc.worker_address()    # hand to a DecodeWorker + svc.token
        addr2 = svc.trainer_address()  # hand to a ServiceReader
        ...
        svc.stop()
    """

    def __init__(self, options=None, recovery=None, registry=None):
        from petastorm_tpu_torch.obs.metrics import default_registry
        from petastorm_tpu_torch.service.telemetry import FleetAdvisor, \
            FleetTelemetry
        from petastorm_tpu_torch.transport.tcp import TcpHub

        self._opt = options or ServiceOptions()
        self._rec = recovery or RecoveryOptions()
        self._registry = registry if registry is not None \
            else default_registry()
        self._m = svc_metrics(self._registry)
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._jobs = {}
        self._leases = {}
        self._threads = []
        self._transports = {}
        self._next_session = 1
        self._next_lease_id = 1
        self._next_slot = 0
        self._tenant_weight = {}
        # the service's clock-anchor pair: its svc.wire spans ship perf
        # times relative to this, exactly like a pool child's piggyback
        self._wall_anchor = time.time()
        self._perf_anchor = time.perf_counter()
        self._workers = {}        # worker name -> health/handle dict
        self._worker_tenants = {} # worker name -> set(tenant)
        self._telemetry = FleetTelemetry(self, self._registry)
        store = self._registry.timeline_store()
        self._advisor = FleetAdvisor(
            self._registry,
            straggler_p99_s=self._opt.straggler_decode_p99_s,
            min_workers=self._opt.min_workers,
            max_workers=self._opt.max_workers).attach(store)
        self._slo = None
        if self._opt.straggler_decode_p99_s is not None:
            from petastorm_tpu_torch.obs.slo import SloEngine, SloSpec

            self._slo = SloEngine(specs=[SloSpec(
                name="svc-straggler",
                metric="ptpu_svc_worker_decode_seconds",
                stat="p99", op="<=",
                threshold=float(self._opt.straggler_decode_p99_s),
                per_worker=True, breach_windows=2, min_count=1,
                description="a decode worker's window p99 ran past the "
                            "straggler threshold — the fleet is dragging "
                            "an outlier")],
                registry=self._registry).attach(store)
        self._arena = None
        if self._opt.arena:
            from petastorm_tpu_torch.io import arena as arena_mod

            self._arena = arena_mod.process_arena()
        self._hub = TcpHub(self._rec, host=self._opt.host)
        if self._opt.sample_s:
            t = threading.Thread(target=self._sample_loop,
                                 args=(float(self._opt.sample_s),),
                                 daemon=True, name="ptpu-svc-sampler")
            self._threads.append(t)
            t.start()

    # -- public surface -----------------------------------------------------------------

    @property
    def token(self):
        """The hub's shared-secret hello token (hex string)."""
        return self._hub.token

    def add_job(self, spec):
        with self._cond:
            if spec.job in self._jobs:
                raise ValueError("job %r already registered" % spec.job)
            self._jobs[spec.job] = _Job(spec)
            self._m["jobs"].set(len(self._jobs))
            self._cond.notify_all()

    def worker_address(self):
        """Register a fresh worker session and return its dial address (the
        hub idiom: sessions exist before the peer dials them)."""
        return self._spawn_session(self._worker_loop, "ptpu-svc-worker")

    def trainer_address(self):
        """Register a fresh trainer session and return its dial address."""
        return self._spawn_session(self._trainer_loop, "ptpu-svc-trainer")

    def get_tenant_weight(self, tenant):
        with self._cond:
            return self._tenant_weight.get(tenant, 1.0)

    def set_tenant_weight(self, tenant, weight):
        """Live QoS actuation seam (the ``svc_weight:<tenant>`` knob): a
        tenant's stride-scheduling share of the decode fleet."""
        weight = max(0.0, float(weight))
        with self._cond:
            self._tenant_weight[tenant] = weight
            self._cond.notify_all()
        return weight

    def register_knobs(self, knobs, tenants):
        """Add one ``svc_weight:<tenant>`` knob per tenant to ``knobs`` (a
        :class:`~petastorm_tpu_torch.control.knobs.KnobSet`) — the actuation seam
        :func:`~petastorm_tpu_torch.control.controller.tenant_qos_rules` moves."""
        import functools

        for tenant in tenants:
            knobs.numeric(
                "svc_weight:%s" % tenant,
                get=functools.partial(self.get_tenant_weight, tenant),
                apply_fn=functools.partial(self.set_tenant_weight, tenant),
                lo=0.05, hi=8.0, default=1.0, integer=False, unit="x")

    def usage_report(self, registry=None):
        """The per-tenant usage report over the service's charges (delegates
        to :class:`~petastorm_tpu_torch.obs.tenant.TenantUsageReport`)."""
        from petastorm_tpu_torch.obs.tenant import TenantUsageReport

        return TenantUsageReport.from_registry(registry)

    def outstanding_leases(self):
        with self._cond:
            return len(self._leases)

    # -- fleet observability surface ----------------------------------------------------

    @property
    def slo_engine(self):
        """The straggler SLO engine (None unless
        ``ServiceOptions.straggler_decode_p99_s`` is set)."""
        return self._slo

    @property
    def advisor(self):
        """The read-only :class:`~petastorm_tpu_torch.service.telemetry
        .FleetAdvisor` publishing ``ptpu_svc_advised_workers``."""
        return self._advisor

    def fleet_document(self):
        """The ``GET /fleet`` JSON document: per-worker health, advice,
        straggler alerts, and every peer's telemetry merged with the
        service's own export on anchored clocks."""
        return self._telemetry.document()

    def metrics_server(self, host="127.0.0.1", port=0):
        """A started :class:`~petastorm_tpu_torch.obs.serve.MetricsServer` over the
        service's registry with ``/fleet`` mounted and the straggler SLO
        engine wired into ``/alerts``. Caller stops it."""
        from petastorm_tpu_torch.obs.serve import MetricsServer

        return MetricsServer(self._registry, host=host, port=port,
                             slo_engine=self._slo,
                             routes={"/fleet": self.fleet_document}).start()

    def worker_health(self):
        """Per-worker health gauges: connection state, outstanding leases +
        oldest lease age, cumulative decode p50/p99, idle/lease totals, and
        the tenants the worker has decoded for."""
        now = time.monotonic()
        with self._cond:
            leases = {}
            for lease in self._leases.values():
                if lease.worker is not None:
                    leases.setdefault(lease.worker, []).append(lease.t0)
            out = {}
            for name, info in self._workers.items():
                mine = leases.get(name, ())
                out[name] = {
                    "connected": info["connected"],
                    "leases_outstanding": len(mine),
                    "oldest_lease_age_s":
                        round(now - min(mine), 3) if mine else 0.0,
                    "decode_p50_s": info["hist"].percentile(0.5),
                    "decode_p99_s": info["hist"].percentile(0.99),
                    "leases_total": info["leases"].value,
                    "idle_seconds_total": round(info["idle"].value, 3),
                    "tenants": sorted(
                        t for t in self._worker_tenants.get(name, ())
                        if t is not None),
                }
            return out

    def advice(self):
        """The advisor's latest decision detail (None before the first
        sampled window with a connected fleet)."""
        return self._advisor.last_detail

    def straggler_alerts(self):
        """Debounced straggler alerts, enriched with the provenance site the
        trainer-side fold charges (``svc.decode@<worker>``) and the tenants
        the worker served — [] with no SLO engine armed."""
        if self._slo is None:
            return []
        out = []
        for alert in self._slo.alerts():
            worker = getattr(alert, "worker", None)
            if worker is None:
                continue
            with self._cond:
                tenants = sorted(
                    t for t in self._worker_tenants.get(worker, ())
                    if t is not None)
            out.append({"slo": alert.name, "worker": worker,
                        "site": "svc.decode@%s" % worker,
                        "tenants": tenants, "value": alert.value,
                        "threshold": alert.threshold, "t": alert.t})
        return out

    def _sample_loop(self, period):
        while not self._stop.wait(period):
            try:
                self._registry.sample_timelines()
            except Exception:  # noqa: BLE001 — sampling must never kill the service
                _degradation("svc_sample_error",
                             "data service timeline sampling failed; the "
                             "SLO/advisor cadence skipped a window")

    def stop(self):
        """Drain and shut down: wakes every loop, closes the hub, joins the
        loops, and counts any lease STILL outstanding after they exit as
        leaked (should be zero — every loop requeues its un-acked leases on
        the way out, so a survivor means a dispatcher bug). Counting before
        the joins would flag leases merely in flight at stop time — normal
        when tearing down mid-decode — as leaks."""
        with self._cond:
            self._stop.set()
            self._cond.notify_all()
            transports = list(self._transports.values())
        self._advisor.detach()
        if self._slo is not None:
            self._slo.detach()
        for transport in transports:
            transport.close()  # wakes loops blocked in recv/poll
        self._hub.close()
        for t in self._threads:
            t.join(timeout=10.0)
        with self._cond:
            leaked = len(self._leases)
            if leaked:
                self._m["lease_leaked"].inc(leaked)
                _degradation(
                    "svc_lease_leaked",
                    "data service stopped with %d outstanding decode "
                    "lease(s) — dispatcher bug, items were neither "
                    "delivered nor requeued", leaked, once=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- session plumbing ---------------------------------------------------------------

    def _spawn_session(self, loop, name):
        with self._cond:
            session = self._next_session
            self._next_session += 1
        transport = self._hub.create_session(session)
        t = threading.Thread(target=loop, args=(session, transport),
                             daemon=True, name="%s-%d" % (name, session))
        with self._cond:
            self._threads.append(t)
            self._transports[session] = transport
        t.start()
        return self._hub.address_for(session)

    def _wait_connected(self, transport):
        while not self._stop.is_set():
            if transport.wait_connected(0.2):
                transport.mark_ready()
                return True
        return False

    # -- decode dispatch ----------------------------------------------------------------

    def _alloc_slot(self):
        with self._cond:
            slot = self._next_slot
            self._next_slot += 1
            return slot

    def _try_claim(self, slot, worker=None):
        """One dispatch decision under the lock: strict priority tiers, then
        stride scheduling (min virtual time / tenant weight) across jobs with
        attached trainers and pending work."""
        candidates = [j for j in self._jobs.values()
                      if j.trainers and j.dispatcher.has_work()]
        candidates.sort(key=lambda j: (j.tier(), j.pass_value))
        for job in candidates:
            job.dispatcher.ensure_workers(slot + 1)
            claim = job.dispatcher.next(slot)
            if claim is None:
                continue
            (epoch, ordinal, _idx), _upcoming = claim
            weight = max(self._tenant_weight.get(job.spec.tenant, 1.0), 1e-3)
            job.pass_value += 1.0 / weight
            lease = _Lease(self._next_lease_id, job, epoch, ordinal, slot,
                           worker)
            self._next_lease_id += 1
            self._leases[lease.lease_id] = lease
            self._m["leases"].inc()
            self._m["leases_outstanding"].set(len(self._leases))
            return lease
        return None

    def _next_lease(self, slot, timeout=0.2, worker=None):
        with self._cond:
            lease = self._try_claim(slot, worker)
            if lease is None and not self._stop.is_set():
                self._cond.wait(timeout)
                lease = self._try_claim(slot, worker)
            return lease

    def _requeue_lease(self, lease_id, link=False):
        """A lease whose conversation died: return the item to its job's
        dispatcher pool (claim/return discipline across the wire). Link
        deaths re-dispatch essentially forever — only a pathological per-item
        ceiling quarantines them as poison."""
        with self._cond:
            lease = self._leases.pop(lease_id, None)
            if lease is None:
                return
            self._m["leases_outstanding"].set(len(self._leases))
            job, key = lease.job, (lease.epoch, lease.ordinal)
            if link:
                limit = self._opt.link_redispatch_limit
                if limit is None:
                    limit = max(10, 3 * self._rec.poison_attempts)
                job.link_attempts[key] = job.link_attempts.get(key, 0) + 1
                if job.link_attempts[key] >= limit:
                    self._quarantine_locked(job, lease.epoch, lease.ordinal,
                                            "poison")
                    return
            job.dispatcher.return_items(
                [(lease.epoch, lease.ordinal, lease.ordinal)])
            self._m["lease_redispatch"].inc()
            self._cond.notify_all()

    def _withdraw_slot(self, slot):
        with self._cond:
            for job in self._jobs.values():
                job.dispatcher.ensure_workers(slot + 1)
                job.dispatcher.withdraw(slot)
            self._cond.notify_all()

    def _complete(self, lease_id, payload, rows, meta, prov=None, wire=None):
        """A decode finished: charge its tenant, fan the payload out to every
        attached trainer that still needs it, admit it to the arena, and drop
        the service-side reference.

        ``prov`` is the worker's piggybacked ``(blob, pid, wall, perf)``
        entry; ``wire`` the service-side ``(perf0, perf1)`` send→reply stamp.
        Both land in ``job.prov_of`` and ride every push of this item. The
        service entry ships ``-os.getpid()`` as its pid: co-hosted fleets
        (worker threads in the trainer's process) would otherwise collide
        with the worker blob's pid and trip the recorder's same-pid retry
        replacement, dropping the decode spans it just absorbed."""
        with self._cond:
            lease = self._leases.pop(lease_id, None)
            if lease is None:
                return
            self._m["leases_outstanding"].set(len(self._leases))
            job, key = lease.job, (lease.epoch, lease.ordinal)
            job.done_with.add(key)
            job.rows_of[key] = rows
            entries = []
            if prov is not None:
                entries.append(tuple(prov))
            if wire is not None:
                from petastorm_tpu_torch.obs.provenance import item_identity

                _e, _o, ikey = item_identity(
                    (lease.epoch, lease.ordinal,
                     job.spec.items[lease.ordinal]))
                annotations = {} if lease.worker is None \
                    else {"svc_worker": lease.worker}
                entries.append((
                    (lease.epoch, lease.ordinal, ikey,
                     [("svc.wire", wire[0], wire[1], None)], annotations),
                    -os.getpid(), self._wall_anchor, self._perf_anchor))
            if entries:
                job.prov_of[key] = entries
            if lease.worker is not None and job.spec.tenant is not None:
                self._worker_tenants.setdefault(
                    lease.worker, set()).add(job.spec.tenant)
            if key in job.decoded:
                self._m["redecodes"].inc()
            job.decoded.add(key)
            needers = job.need.pop(key, set())
            served = 0
            for tid in needers:
                trainer = job.trainers.get(tid)
                if trainer is None:
                    continue
                trainer.remaining.get(lease.epoch, set()).discard(
                    lease.ordinal)
                trainer.queue.append(("item", lease.epoch, lease.ordinal,
                                      payload, rows))
                _nudge(trainer)
                served += 1
            self._m["decodes"].inc()
            self._m["decode_seconds"].inc(
                max(0.0, float(meta.get("decode_s", 0.0))))
            if served > 1:
                self._m["fanout_serves"].inc(served - 1)
            tenant = job.spec.tenant
            self._cond.notify_all()
        _charge("worker_s", max(0.0, float(meta.get("wall_s", 0.0))), tenant)
        _charge("decode_s", max(0.0, float(meta.get("decode_s", 0.0))),
                tenant)
        if self._arena is not None:
            arena_key = ("svc", job.spec.job, lease.epoch, lease.ordinal)
            if self._arena.put(arena_key, payload):
                with self._cond:
                    job.arena_admitted.add(key)

    def _fail(self, lease_id, error, permanent):
        with self._cond:
            lease = self._leases.pop(lease_id, None)
            if lease is None:
                return
            self._m["leases_outstanding"].set(len(self._leases))
            job, key = lease.job, (lease.epoch, lease.ordinal)
            job.fail_attempts[key] = job.fail_attempts.get(key, 0) + 1
            if permanent or \
                    job.fail_attempts[key] >= self._rec.poison_attempts:
                self._quarantine_locked(job, lease.epoch, lease.ordinal,
                                        "decode_error" if permanent
                                        else "poison")
                return
            job.dispatcher.return_items(
                [(lease.epoch, lease.ordinal, lease.ordinal)])
            self._m["lease_redispatch"].inc()
            self._cond.notify_all()
        _degradation(
            "svc_decode_retry",
            "data service decode of %s[%d:%d] failed transiently (%s); "
            "re-dispatching", job.spec.job, lease.epoch, lease.ordinal,
            error, once=False)

    def _quarantine_locked(self, job, epoch, ordinal, cause):
        """Caller holds self._cond. Exactly-once: the verdict is recorded in
        the job ledger and broadcast to every attached trainer's watermark;
        trainers attaching later receive it during their attach replay."""
        key = (epoch, ordinal)
        if key in job.quarantined:
            return
        job.quarantined[key] = cause
        job.done_with.add(key)
        for tid in job.need.pop(key, set()):
            trainer = job.trainers.get(tid)
            if trainer is None:
                continue
            trainer.remaining.get(epoch, set()).discard(ordinal)
            trainer.queue.append(("quar", epoch, ordinal, cause))
            _nudge(trainer)
        self._m["quarantined"].inc()
        self._cond.notify_all()
        _degradation(
            "svc_quarantine",
            "data service quarantined %s[%d:%d] (cause=%s); every trainer's "
            "watermark is charged exactly once", job.spec.job, epoch,
            ordinal, cause, once=False)

    # -- worker loop --------------------------------------------------------------------

    def _register_worker(self, wname, session):
        """Resolve this worker's labeled health families ONCE at READY —
        never inside the lease loop (get-or-create takes the registry lock).
        A reconnecting worker of the same name reclaims its families: the
        totals are the worker's story, not the link's."""
        reg = self._registry
        info = {
            "session": session,
            "connected": True,
            "hist": reg.histogram(
                "ptpu_svc_worker_decode_seconds",
                help="per-lease decode seconds as reported by this worker "
                     "(the straggler SLO and FleetAdvisor read the window "
                     "p99 of this family)",
                worker=wname),
            "idle": reg.counter(
                "ptpu_svc_worker_idle_seconds_total",
                help="seconds this worker's dispatch slot waited with no "
                     "claimable work (the fleet-shrink signal)",
                worker=wname),
            "leases": reg.counter(
                "ptpu_svc_worker_leases_total",
                help="leases dispatched to this worker that reached a "
                     "verdict (done or fail)",
                worker=wname),
        }
        with self._cond:
            self._workers[wname] = info
        return info

    def _worker_loop(self, session, transport):
        slot = self._alloc_slot()
        counted = False
        try:
            if not self._wait_connected(transport):
                return
            try:
                msg = transport.recv()
            except (TransportLinkDown, EOFError, OSError):
                return
            if msg.get("op") != OP_READY:
                return
            wname = msg.get("worker") or "worker-%d" % session
            winfo = self._register_worker(wname, session)
            self._m["workers"].inc()
            counted = True
            announced = set()
            while not self._stop.is_set():
                i0 = time.perf_counter()
                lease = self._next_lease(slot, worker=wname)
                if lease is None:
                    # the whole timed-out claim was idle capacity
                    winfo["idle"].inc(time.perf_counter() - i0)
                    continue
                job = lease.job
                out = {"op": OP_LEASE, "lease": lease.lease_id,
                       "job": job.spec.job, "epoch": lease.epoch,
                       "ordinal": lease.ordinal,
                       "item": job.spec.items[lease.ordinal]}
                if job.spec.job not in announced:
                    out["spec"] = job.spec.wire_spec()
                transport.track(lease.lease_id)
                ws0 = time.perf_counter()
                try:
                    transport.send(out)
                    reply = transport.recv()
                except (TransportLinkDown, OSError):
                    self._requeue_lease(lease.lease_id, link=True)
                    self._withdraw_slot(slot)
                    announced = set()  # fresh generation: re-announce specs
                    if transport.reconnect(self._rec.link_reconnect_s):
                        continue
                    return
                except EOFError:
                    self._requeue_lease(lease.lease_id, link=True)
                    self._withdraw_slot(slot)
                    return
                ws1 = time.perf_counter()
                transport.settle()
                doc = reply.get("telemetry")
                if doc:
                    self._telemetry.note_peer("worker", wname, doc)
                op = reply.get("op")
                if op == OP_DONE and reply.get("lease") == lease.lease_id:
                    meta = reply.get("meta") or {}
                    winfo["leases"].inc()
                    winfo["hist"].observe(
                        max(0.0, float(meta.get("decode_s", 0.0))))
                    self._complete(lease.lease_id, reply.get("payload"),
                                   reply.get("rows"), meta,
                                   prov=reply.get("prov"), wire=(ws0, ws1))
                elif op == OP_FAIL and reply.get("lease") == lease.lease_id:
                    winfo["leases"].inc()
                    self._fail(lease.lease_id, reply.get("error"),
                               bool(reply.get("permanent")))
                else:
                    # an unparseable reply is a broken conversation: requeue
                    self._requeue_lease(lease.lease_id, link=True)
        finally:
            with self._cond:
                for lid, lease in list(self._leases.items()):
                    if lease.slot == slot:
                        self._leases.pop(lid)
                        self._m["leases_outstanding"].set(len(self._leases))
                        lease.job.dispatcher.return_items(
                            [(lease.epoch, lease.ordinal, lease.ordinal)])
                        self._m["lease_redispatch"].inc()
                self._cond.notify_all()
            self._withdraw_slot(slot)
            if counted:
                self._m["workers"].dec()
                with self._cond:
                    info = self._workers.get(wname)
                    if info is not None and info["session"] == session:
                        info["connected"] = False
                self._telemetry.drop_peer("worker", wname)
            try:
                transport.send({"op": OP_STOP})
            except Exception:  # noqa: BLE001 — a goodbye on a possibly dead link
                pass
            transport.close()
            self._hub.drop_session(session)
            with self._cond:
                self._transports.pop(session, None)

    # -- trainer loop -------------------------------------------------------------------

    def _trainer_loop(self, session, transport):
        job = trainer = None
        try:
            if not self._wait_connected(transport):
                return
            while not self._stop.is_set():
                try:
                    msg = transport.recv()
                except (TransportLinkDown, OSError):
                    if transport.reconnect(self._rec.link_reconnect_s):
                        continue
                    return
                except EOFError:
                    return
                if msg.get("op") != OP_ATTACH:
                    continue
                while True:
                    job, trainer, reply = self._attach(session, msg)
                    try:
                        transport.send(reply)
                    except (TransportLinkDown, EOFError, OSError) as exc:
                        if trainer is not None:
                            self._detach(job, trainer)
                            job = trainer = None
                        if isinstance(exc, EOFError) or \
                                not transport.reconnect(
                                    self._rec.link_reconnect_s):
                            return
                        break
                    if trainer is None:
                        break  # rejected: the peer may retry another attach
                    transport.set_tenant(trainer.tenant)
                    outcome = self._serve(transport, job, trainer)
                    if isinstance(outcome, tuple):
                        # a fresh attach raced ahead of the link-death
                        # notice: the old conversation is dead — detach it
                        # and process the new watermark in place
                        self._detach(job, trainer)
                        job = trainer = None
                        msg = outcome[1]
                        continue
                    if outcome == "dead":
                        self._detach(job, trainer)
                        job = trainer = None
                        if transport.reconnect(self._rec.link_reconnect_s):
                            break  # await a watermark-exact re-attach
                        return
                    job = trainer = None
                    if outcome == "stop":
                        return
                    break  # clean detach: loop for a possible re-attach
        finally:
            if trainer is not None:
                self._detach(job, trainer)
            transport.close()
            self._hub.drop_session(session)
            with self._cond:
                self._transports.pop(session, None)

    def _attach(self, session, msg):
        """Admission + watermark-exact shard computation. Returns
        ``(job, trainer, reply)`` — trainer None when rejected."""
        job_name = msg.get("job")
        tid = msg.get("trainer") or "trainer-%d" % session
        tenant = msg.get("tenant")
        consumed = {int(e): set(v)
                    for e, v in (msg.get("consumed") or {}).items()}
        with self._cond:
            job = self._jobs.get(job_name)
            eff_tenant = tenant if tenant is not None else \
                (job.spec.tenant if job is not None else None)
            reason = None
            if job is None:
                reason = "unknown job %r" % job_name
            elif tid in job.trainers:
                reason = "trainer id %r already attached" % tid
            elif sum(len(j.trainers) for j in self._jobs.values()) \
                    >= self._opt.max_trainers:
                reason = "service at max_trainers=%d" % self._opt.max_trainers
            elif self._opt.max_trainers_per_tenant is not None and sum(
                    1 for j in self._jobs.values()
                    for t in j.trainers.values() if t.tenant == eff_tenant) \
                    >= self._opt.max_trainers_per_tenant:
                reason = "tenant %r at max_trainers_per_tenant=%d" \
                    % (eff_tenant, self._opt.max_trainers_per_tenant)
            elif self._tenant_weight.get(eff_tenant, 1.0) <= 0.0:
                reason = "tenant %r is throttled to weight 0 (admission)" \
                    % eff_tenant
            if reason is not None:
                self._m["rejected"].inc()
                return job, None, {"op": OP_REJECTED, "reason": reason}
            trainer = _Trainer(tid, session, eff_tenant, job.spec.priority,
                               msg.get("arena") and self._arena is not None)
            redecode = []
            for epoch, size in job.epoch_sizes.items():
                rem = set(range(size)) - consumed.get(epoch, set())
                queued = set()
                for ordinal in rem:
                    key = (epoch, ordinal)
                    if key in job.quarantined:
                        trainer.queue.append(("quar", epoch, ordinal,
                                              job.quarantined[key]))
                        queued.add(ordinal)
                    elif key in job.done_with:
                        # decoded before this trainer existed: serve from the
                        # arena warm set, or re-decode (correctness path)
                        if trainer.arena and key in job.arena_admitted:
                            trainer.queue.append(("arena", epoch, ordinal))
                            queued.add(ordinal)
                        else:
                            job.need.setdefault(key, set()).add(tid)
                            job.done_with.discard(key)
                            redecode.append((epoch, ordinal, ordinal))
                    else:
                        job.need.setdefault(key, set()).add(tid)
                trainer.remaining[epoch] = rem - queued
            if redecode:
                job.dispatcher.return_items(redecode)
            job.trainers[tid] = trainer
            self._m["attaches"].inc()
            self._m["trainers"].inc()
            self._cond.notify_all()
            return job, trainer, {
                "op": OP_ATTACHED, "version": PROTOCOL_VERSION,
                "schema": job.spec.schema, "trainer": tid,
                "num_epochs": job.spec.num_epochs,
                "epoch_sizes": dict(job.epoch_sizes),
                "arena": trainer.arena}

    def _detach(self, job, trainer):
        """Remove the trainer; its unconsumed interest leaves every need set
        (no loss: a re-attach recomputes from the client's watermark)."""
        with self._cond:
            trainer.transport = None
            job.trainers.pop(trainer.tid, None)
            for key in list(job.need):
                s = job.need[key]
                s.discard(trainer.tid)
                if not s:
                    del job.need[key]
            trainer.queue = []
            self._m["detaches"].inc()
            self._m["trainers"].dec()
            self._cond.notify_all()
        self._telemetry.drop_peer("trainer", trainer.tid)

    def _entry_msg(self, job, trainer, entry):
        kind = entry[0]
        if kind == "quar":
            _, epoch, ordinal, cause = entry
            key = (epoch, ordinal)
            return {"op": OP_QUARANTINED, "epoch": epoch,
                    "ordinal": ordinal, "cause": cause,
                    "attempts": max(1, job.fail_attempts.get(key, 0)
                                    + job.link_attempts.get(key, 0))}, 0
        if kind == "arena":
            _, epoch, ordinal = entry
            msg = {"op": OP_ITEM, "epoch": epoch, "ordinal": ordinal,
                   "rows": job.rows_of.get((epoch, ordinal)),
                   "payload": None,
                   "arena_key": ("svc", job.spec.job, epoch, ordinal)}
            prov = job.prov_of.get((epoch, ordinal))
            if prov:
                msg["prov"] = prov
            return msg, job.rows_of.get((epoch, ordinal)) or 0
        _, epoch, ordinal, payload, rows = entry
        msg = {"op": OP_ITEM, "epoch": epoch, "ordinal": ordinal,
               "rows": rows}
        if trainer.arena and (epoch, ordinal) in job.arena_admitted \
                and (epoch, ordinal) not in job.inline_keys:
            msg["payload"] = None
            msg["arena_key"] = ("svc", job.spec.job, epoch, ordinal)
        else:
            msg["payload"] = payload
        prov = job.prov_of.get((epoch, ordinal))
        if prov:
            # every fan-out push carries the item's cross-wire provenance:
            # each receiving trainer's recorder absorbs it independently
            msg["prov"] = prov
        return msg, rows or 0

    def _serve(self, transport, job, trainer):
        """The attached steady state: flush credit-gated pushes, poll for
        want/refetch/detach. Returns "detach" | "dead" | "stop", or
        ``("attach", msg)`` when a redialed peer's fresh attach raced ahead
        of this side's link-death notice."""
        with self._cond:
            trainer.transport = transport
        while not self._stop.is_set():
            to_send = []
            with self._cond:
                while trainer.credits > 0 and trainer.queue:
                    to_send.append(trainer.queue.pop(0))
                    trainer.credits -= 1
                finished = trainer.finished() and not trainer.end_sent
                # the undersupply signal: credits granted, nothing to push,
                # plan unfinished — the decode fleet is behind this trainer
                starving = trainer.credits > 0 and not trainer.queue \
                    and not trainer.finished()
            try:
                for entry in to_send:
                    msg, rows = self._entry_msg(job, trainer, entry)
                    transport.send(msg)
                    if msg["op"] == OP_ITEM:
                        self._m["served_items"].inc()
                        self._m["served_rows"].inc(rows)
                        _charge("rows", rows, trainer.tenant)
                        _charge("svc_items", 1, trainer.tenant)
                if finished:
                    transport.send({"op": OP_END})
                    trainer.end_sent = True
                w0 = time.monotonic()
                if not transport.poll(TICK_S, wakeable=True):
                    if starving:
                        # a wake() can end the poll early — charge the time
                        # actually spent waiting, not the full tick
                        self._m["starved_seconds"].inc(
                            max(0.0, time.monotonic() - w0))
                    continue
                msg = transport.recv()
            except (TransportLinkDown, OSError):
                return "dead"
            except EOFError:
                return "dead"
            op = msg.get("op")
            if op == OP_WANT:
                doc = msg.get("telemetry")
                if doc:
                    self._telemetry.note_peer("trainer", trainer.tid, doc)
                with self._cond:
                    trainer.credits += max(0, int(msg.get("credits", 0)))
            elif op == OP_REFETCH:
                self._refetch(job, trainer, int(msg.get("epoch", 0)),
                              int(msg.get("ordinal", 0)))
            elif op == OP_DETACH:
                self._detach(job, trainer)
                try:
                    transport.send({"op": OP_DETACHED})
                except (TransportLinkDown, EOFError, OSError):
                    return "dead"
                return "detach"
            elif op == OP_ATTACH:
                return ("attach", msg)
        return "stop"

    def _refetch(self, job, trainer, epoch, ordinal):
        """An arena-key push the trainer could not map (evicted between admit
        and get): re-serve it — from a decode if the payload is gone."""
        key = (epoch, ordinal)
        with self._cond:
            self._m["refetches"].inc()
            job.arena_admitted.discard(key)
            job.inline_keys.add(key)
            if key in job.quarantined:
                trainer.queue.append(("quar", epoch, ordinal,
                                      job.quarantined[key]))
                _nudge(trainer)
                self._cond.notify_all()
                return
            job.need.setdefault(key, set()).add(trainer.tid)
            if key in job.done_with:
                job.done_with.discard(key)
                job.dispatcher.return_items([(epoch, ordinal, ordinal)])
            self._cond.notify_all()
