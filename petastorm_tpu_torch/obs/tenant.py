"""Per-tenant accounting: who used the shared resources.

Port of ``petastorm_tpu.obs.tenant``. The observability planes below this module
(provenance, the time series and SLOs, the cache arena's counters) aggregate every
consumer of a host into one stream. This module adds the missing dimension: a
validated, bounded tenant label carried through every layer a batch touches, so decode
seconds, store bytes, hedged GETs, arena residency and quarantined rows each say whose
they were.

Three pieces:

- :class:`TenantContext`: tenant id, job id and priority hint. The tenant id is a
  validated slug (``[a-z0-9][a-z0-9._-]{0,31}``), so it is always a bounded metric label.
- resolution and propagation: an explicit ``make_reader(tenant=)`` /
  ``DataLoader(tenant=)`` argument wins, then the ``PTPU_TENANT`` /
  ``PTPU_TENANT_JOB`` / ``PTPU_TENANT_PRIORITY`` environment, which is also how a process
  pool's children inherit the parent's tenant (the pool stamps the environment, the
  child calls :func:`attach_from_env`). Worker threads activate the context
  thread-locally around each item, so the IO layers deep in the stack (tiers, arena,
  remote) ask :func:`current_label` without plumbing. An invalid slug in the environment
  degrades (``tenant_label_invalid``) instead of raising; an invalid explicit argument
  raises.
- the meter: the ``ptpu_tenant_*`` counter families charged at the resource sites, and
  :class:`TenantUsageReport`, a fleet-mergeable rollup built from any metrics snapshot
  (a live registry's, a JSONL export's, or the summed totals of ``stats_cli --merge``).

With no tenant resolved every instrumented site pays one ``is None`` check. Untagged
runs charge nothing here: the untagged families stay the totals, and the per-tenant
twins appear only when a tenant is known.
"""
from __future__ import annotations

import os
import re
import threading
import time
from contextlib import contextmanager

#: the label rendered for unattributed flow in reports and panels; the slug grammar
#: forbids it, so it never collides with a real tenant
UNTAGGED = "-"

#: bounded-slug grammar: lowercase alphanumerics plus ``._-``, 1 to 32 characters,
#: leading alphanumeric
_SLUG_RE = re.compile(r"^[a-z0-9][a-z0-9._-]{0,31}$")

_PRIORITIES = ("low", "normal", "high")

#: the environment (resolution order: explicit argument > environment > none)
ENV_TENANT = "PTPU_TENANT"
ENV_JOB = "PTPU_TENANT_JOB"
ENV_PRIORITY = "PTPU_TENANT_PRIORITY"


def valid_slug(value):
    """True when ``value`` is a legal bounded tenant or job slug."""
    return isinstance(value, str) and _SLUG_RE.match(value) is not None


class TenantContext:
    """Who this pipeline's work is billed to.

    Immutable (instances are shared across threads and pickled into pool workers);
    compares and hashes by value."""

    __slots__ = ("tenant", "job", "priority")

    def __init__(self, tenant, job=None, priority=None):
        if not valid_slug(tenant):
            raise ValueError(
                "tenant id %r is not a bounded slug (%s): tenant ids become metric "
                "labels, so they must be small and closed-alphabet"
                % (tenant, _SLUG_RE.pattern))
        if job is not None and not valid_slug(job):
            raise ValueError("tenant job id %r is not a bounded slug (%s)"
                             % (job, _SLUG_RE.pattern))
        if priority is not None and priority not in _PRIORITIES:
            raise ValueError("tenant priority %r not in %r" % (priority, _PRIORITIES))
        object.__setattr__(self, "tenant", tenant)
        object.__setattr__(self, "job", job)
        object.__setattr__(self, "priority", priority)

    def __setattr__(self, name, value):
        raise AttributeError("TenantContext is immutable")

    def __eq__(self, other):
        return (isinstance(other, TenantContext)
                and other.tenant == self.tenant and other.job == self.job
                and other.priority == self.priority)

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash((self.tenant, self.job, self.priority))

    def __repr__(self):
        parts = [repr(self.tenant)]
        if self.job:
            parts.append("job=%r" % self.job)
        if self.priority:
            parts.append("priority=%r" % self.priority)
        return "TenantContext(%s)" % ", ".join(parts)

    def __getstate__(self):
        return (self.tenant, self.job, self.priority)

    def __setstate__(self, state):
        tenant, job, priority = state
        object.__setattr__(self, "tenant", tenant)
        object.__setattr__(self, "job", job)
        object.__setattr__(self, "priority", priority)

    def env(self):
        """The environment that carries this context into a child process."""
        out = {ENV_TENANT: self.tenant}
        if self.job:
            out[ENV_JOB] = self.job
        if self.priority:
            out[ENV_PRIORITY] = self.priority
        return out


def from_env(environ=None):
    """The environment's tenant context, or None.

    An invalid ``PTPU_TENANT`` slug fires the ``tenant_label_invalid`` degradation and
    resolves to None (untagged) instead of raising: launchers set the environment, and a
    typo there must degrade attribution, not kill the job. An invalid job id or priority
    is dropped the same way and the valid tenant id kept."""
    from petastorm_tpu_torch.obs.log import degradation

    environ = os.environ if environ is None else environ
    raw = environ.get(ENV_TENANT)
    if not raw:
        return None
    if not valid_slug(raw):
        degradation("tenant_label_invalid",
                    "%s=%r is not a bounded slug (%s): running untagged",
                    ENV_TENANT, raw, _SLUG_RE.pattern)
        return None
    job = environ.get(ENV_JOB) or None
    priority = environ.get(ENV_PRIORITY) or None
    if job is not None and not valid_slug(job):
        degradation("tenant_label_invalid",
                    "%s=%r is not a bounded slug: dropping the job id", ENV_JOB, job)
        job = None
    if priority is not None and priority not in _PRIORITIES:
        degradation("tenant_label_invalid", "%s=%r not in %r: dropping the priority",
                    ENV_PRIORITY, priority, _PRIORITIES)
        priority = None
    return TenantContext(raw, job=job, priority=priority)


def resolve(tenant=None, env_default=True):
    """Resolution order: explicit argument > environment > None.

    ``tenant`` is a :class:`TenantContext`, a bare slug string or None. An invalid
    explicit value raises; the environment degrades instead (:func:`from_env`)."""
    if isinstance(tenant, TenantContext):
        return tenant
    if isinstance(tenant, str):
        return TenantContext(tenant)
    if tenant is not None:
        raise TypeError("tenant= must be a TenantContext, a slug string or None, not %r"
                        % (tenant,))
    return from_env() if env_default else None


# -- the current context: a thread-local activation (worker threads, around each item)
# -- over a process default (pool children, through attach_from_env)

_tls = threading.local()
_process_default = None


def set_default(ctx):
    """Install ``ctx`` (or None) as the process-wide default tenant."""
    global _process_default
    _process_default = ctx


def attach_from_env():
    """Adopt the environment's tenant as the process default: a pool child calls this at
    bootstrap, so its IO charges land on the parent's tenant."""
    set_default(from_env())
    return _process_default


def current():
    """The active :class:`TenantContext` (the thread's activation, else the process
    default), or None."""
    ctx = getattr(_tls, "ctx", None)
    return ctx if ctx is not None else _process_default


def current_label():
    """The active tenant id, or None when untagged."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        ctx = _process_default
    return None if ctx is None else ctx.tenant


def label_of(ctx):
    """A context's report label (None gives ``"-"``)."""
    return UNTAGGED if ctx is None else ctx.tenant


@contextmanager
def activate(ctx):
    """Activate ``ctx`` on this thread for the block (None: the surrounding default
    keeps applying)."""
    if ctx is None:
        yield
        return
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield
    finally:
        _tls.ctx = prev


# -- the meter: ptpu_tenant_* families charged at the resource sites

#: resource key -> (metric family, what it counts). The report and the stats panel
#: iterate this table.
RESOURCES = {
    "rows": ("ptpu_tenant_rows_total", "delivered rows"),
    "read_bytes": ("ptpu_tenant_read_bytes_total", "bytes read (all tiers)"),
    "decode_s": ("ptpu_tenant_decode_seconds_total", "decode seconds"),
    "worker_s": ("ptpu_tenant_worker_seconds_total", "worker item seconds"),
    "arena_byte_s": ("ptpu_tenant_arena_byte_seconds_total",
                     "arena residency (byte*seconds)"),
    "arena_bytes": ("ptpu_tenant_arena_resident_bytes",
                    "arena resident bytes (gauge)"),
    "hedged_gets": ("ptpu_tenant_hedged_gets_total", "hedged remote GETs"),
    "quarantined": ("ptpu_tenant_quarantined_rows_total", "quarantined rows"),
    "wire_bytes": ("ptpu_tenant_wire_bytes_total",
                   "transport frame bytes (tagged frames)"),
    "svc_items": ("ptpu_tenant_svc_items_total", "data-service items served"),
}


class _Meter:
    """One registry's cache of tenant-labelled counters and gauges, and the arena
    residency integral."""

    __slots__ = ("_registry", "_counters", "_gauges", "_lock", "_arena")

    def __init__(self, registry):
        self._registry = registry
        self._counters = {}
        self._gauges = {}
        self._lock = threading.Lock()
        #: tenant label -> [resident bytes, monotonic time of the last adjustment]
        self._arena = {}

    def counter(self, family, label):
        key = (family, label)
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.get(key)
                if c is None:
                    c = self._registry.counter(family, tenant=label)
                    self._counters[key] = c
        return c

    def gauge(self, family, label):
        key = (family, label)
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.get(key)
                if g is None:
                    g = self._registry.gauge(family, tenant=label)
                    self._gauges[key] = g
        return g

    def charge(self, resource, label, amount=1):
        if amount:
            self.counter(RESOURCES[resource][0], label).inc(amount)

    def arena_adjust(self, label, delta_bytes, now=None):
        """An arena residency change of ``label``: accrue the byte*seconds integral
        since the last adjustment, then move the resident-bytes gauge by
        ``delta_bytes`` (negative on an eviction). Exact between events, with no
        sampler thread."""
        now = time.monotonic() if now is None else now
        # the metrics are built outside the meter lock: counter() takes it on a miss
        with self._lock:
            state = self._arena.get(label)
            if state is None:
                state = [0.0, now]
                self._arena[label] = state
            resident, last = state
            accrued = resident * (now - last) if resident > 0 and now > last else 0.0
            state[0] = max(0.0, resident + delta_bytes)
            state[1] = now
            resident_now = state[0]
        if accrued:
            self.counter(RESOURCES["arena_byte_s"][0], label).inc(accrued)
        self.gauge(RESOURCES["arena_bytes"][0], label).set(resident_now)

    def arena_settle(self, now=None):
        """Accrue every tenant's byte*seconds up to ``now`` (a report must bill the
        residency since the last event)."""
        now = time.monotonic() if now is None else now
        accrued = []
        with self._lock:
            for label, state in self._arena.items():
                resident, last = state
                if resident > 0 and now > last:
                    accrued.append((label, resident * (now - last)))
                state[1] = now
        for label, amount in accrued:
            self.counter(RESOURCES["arena_byte_s"][0], label).inc(amount)


_meters = {}
_meters_lock = threading.Lock()


def meter(registry=None):
    """The tenant meter of ``registry`` (default: the process-wide registry, where the
    IO and arena families live)."""
    if registry is None:
        from petastorm_tpu_torch.obs.metrics import default_registry

        registry = default_registry()
    m = _meters.get(id(registry))
    if m is None:
        with _meters_lock:
            m = _meters.get(id(registry))
            if m is None:
                m = _Meter(registry)
                _meters[id(registry)] = m
    return m


def charge(resource, amount=1, label=None, registry=None):
    """Charge ``amount`` of ``resource`` to ``label`` (default: the current tenant).
    Untagged, nothing is charged: the untagged families stay the totals."""
    if label is None:
        label = current_label()
        if label is None:
            return
    meter(registry).charge(resource, label, amount)


# -- TenantUsageReport: the fleet-mergeable rollup

_LABELED_RE = re.compile(r'^(?P<family>\w+)\{(?P<labels>[^}]*)\}$')
_TENANT_LABEL_RE = re.compile(r'(?:^|,)tenant="(?P<tenant>[^"]*)"')


def _tenant_of(full_name):
    """``(family, tenant)`` of a flat metric name with a ``tenant=`` label, else
    ``(None, None)``."""
    m = _LABELED_RE.match(full_name)
    if not m:
        return None, None
    t = _TENANT_LABEL_RE.search(m.group("labels"))
    if not t:
        return None, None
    return m.group("family"), t.group("tenant")


class TenantUsageReport:
    """Per-tenant resource rollup of any flat metrics snapshot: a live registry's
    ``snapshot()``, a loaded export's ``metrics``, or the summed ``totals`` of a fleet
    merge (counters sum per full labelled name there, so per-tenant fleet totals come
    free). ``usage`` maps tenant label -> resource key (:data:`RESOURCES`) -> value."""

    __slots__ = ("usage",)

    def __init__(self, usage=None):
        self.usage = dict(usage or {})

    @classmethod
    def from_metrics(cls, metrics):
        family_to_resource = {fam: res for res, (fam, _note) in RESOURCES.items()}
        usage = {}
        for name, value in metrics.items():
            family, tenant = _tenant_of(name)
            if family is None or not isinstance(value, (int, float)):
                continue
            resource = family_to_resource.get(family)
            if resource is None:
                continue
            usage.setdefault(tenant, {})[resource] = \
                usage.get(tenant, {}).get(resource, 0.0) + value
        return cls(usage)

    @classmethod
    def from_registry(cls, registry=None):
        if registry is None:
            from petastorm_tpu_torch.obs.metrics import default_registry

            registry = default_registry()
        meter(registry).arena_settle()
        return cls.from_metrics(registry.snapshot())

    def tenants(self):
        return sorted(self.usage)

    def get(self, tenant, resource, default=0.0):
        return self.usage.get(tenant, {}).get(resource, default)

    def top_consumer(self, resource):
        """``(tenant, value)`` of the heaviest consumer of ``resource`` (``(None, 0.0)``
        when nothing is charged)."""
        best, best_v = None, 0.0
        for tenant in sorted(self.usage):
            v = self.usage[tenant].get(resource, 0.0)
            if v > best_v:
                best, best_v = tenant, v
        return best, best_v

    def merge(self, other):
        """A new report summing ``other`` into this one (fleet aggregation)."""
        usage = {t: dict(r) for t, r in self.usage.items()}
        for tenant, resources in other.usage.items():
            mine = usage.setdefault(tenant, {})
            for resource, value in resources.items():
                mine[resource] = mine.get(resource, 0.0) + value
        return TenantUsageReport(usage)

    def to_dict(self):
        return {t: dict(r) for t, r in sorted(self.usage.items())}

    def render(self, top=8):
        """The stats panel's lines: tenants ranked by worker seconds, one row each."""
        lines = ["tenants (ptpu_tenant_*):"]
        order = sorted(self.usage,
                       key=lambda t: (-self.usage[t].get("worker_s", 0.0),
                                      -self.usage[t].get("read_bytes", 0.0), t))
        for tenant in order[:top]:
            r = self.usage[tenant]
            lines.append(
                "  %-16s rows=%-8d read=%-9s worker=%6.2fs decode=%6.2fs  "
                "arena=%s*s  hedges=%d  quarantined=%d"
                % (tenant, int(r.get("rows", 0)),
                   "%.1fMB" % (r.get("read_bytes", 0.0) / 1e6),
                   r.get("worker_s", 0.0), r.get("decode_s", 0.0),
                   "%.1fMB" % (r.get("arena_byte_s", 0.0) / 1e6),
                   int(r.get("hedged_gets", 0)), int(r.get("quarantined", 0))))
        if len(order) > top:
            lines.append("  ... and %d more tenants" % (len(order) - top))
        return lines

    def __repr__(self):
        return "TenantUsageReport(%d tenants)" % len(self.usage)


def _reset_for_tests():
    """Drop the meters and the default (test isolation)."""
    global _process_default
    _process_default = None
    if getattr(_tls, "ctx", None) is not None:
        _tls.ctx = None
    with _meters_lock:
        _meters.clear()
