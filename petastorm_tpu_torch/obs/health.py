"""Pipeline health: heartbeats, a backpressure-aware stall watchdog, flight dumps.

Port of ``petastorm_tpu.obs.health``. A pipeline that hangs (rather than crashes)
leaves no evidence behind. This module is the active monitoring layer: every
long-lived actor (the loader's producer and transfer threads, the pool's worker threads
and feeder threads, each pool child, the readahead IO threads) stamps a
:class:`Heartbeat`, a daemon watchdog compares heartbeat ages against per-role
thresholds, and a detected stall produces one structured **flight record** (driver
thread stacks via ``sys._current_frames``, child-process stacks via the process pool's
SIGUSR1/faulthandler hook, queue depths, metrics, degradations, and the
:class:`~petastorm_tpu_torch.obs.flight.FlightRecorder` ring of recent events).

Backpressure awareness is the load-bearing design point: a producer blocked on a full
host queue is *waiting on downstream*, not stalled, so every blocking site stamps a
``wait:*`` state before parking, and the watchdog only calls an actor stalled when its
age exceeds the threshold **in a busy state**. A slow consumer therefore produces no
false positive, while a hung decode (busy state, age growing) trips within one poll
interval of its threshold. The port's transfer thread waits on the card inside its busy
states (``decode`` covers the inflate stage's read back to the host, ``h2d`` the pinned
slab reuse), so a threshold must exceed the longest of those waits.

Cost: disabled (the default) is one ``is None`` check a site; enabled is one or two
attribute stores a pipeline stage a batch (a ``Heartbeat.beat`` is two plain attribute
writes, no lock).

Escalation policy (:class:`HealthOptions.escalation`): ``"warn"`` logs and counts
(``ptpu_degradations_total{cause="stall_detected"}``), ``"flight"`` (default) also
writes the flight record, ``"heal"`` asks the registered healers (the process pool's
kills the hung child, whose item the respawn and poison machinery re-dispatches or
quarantines) and raises only for what no healer took, ``"raise"`` also delivers a
:class:`petastorm_tpu_torch.errors.StallError` to the consumer.

Environment (read when an option is not given): ``PTPU_HEALTH`` (non-empty and not
``0``/``false``/``no``: a ``DataLoader`` monitors without ``health=``),
``PTPU_HEALTH_THRESHOLD_S`` (default 120), ``PTPU_HEALTH_POLL_S`` (default 1) and
``PTPU_HEALTH_DIR`` (the flight record's directory, default the working directory; the
file is ``ptpu_flight_<pid>.json``).
"""
from __future__ import annotations

import logging
import os
import sys
import threading
import time
import traceback

from petastorm_tpu_torch.errors import StallError
from petastorm_tpu_torch.obs.flight import (
    FlightRecorder,
    activate,
    deactivate,
    write_flight_record,
)

logger = logging.getLogger("petastorm_tpu_torch.obs")


def _env_float(name, default):
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def health_enabled_by_env():
    """True when ``PTPU_HEALTH`` requests monitoring without code changes."""
    return os.environ.get("PTPU_HEALTH", "") not in ("", "0", "false", "no")


class HealthOptions:
    """Configuration for one :class:`HealthMonitor`.

    Parameters
    ----------
    stall_threshold_s : float
        Default busy-state heartbeat age past which an actor is stalled
        (``PTPU_HEALTH_THRESHOLD_S`` overrides). Generous by default: a real
        row-group read + decode against a cold object store can take tens of
        seconds without anything being wrong.
    thresholds : dict, optional
        Per-role overrides, e.g. ``{"worker": 30.0, "io": 60.0}`` — roles are
        ``producer``, ``transfer``, ``worker``, ``io``, ``child``.
    poll_interval_s : float
        Watchdog wake cadence; detection latency is ``threshold + poll``.
    escalation : {"warn", "flight", "heal", "raise"}
        Cumulative: ``warn`` logs+counts, ``flight`` also dumps the flight
        record, ``heal`` additionally asks registered healers to recover the
        stalled actors in place (the process pool's healer kills the hung
        child so the respawn machinery re-dispatches its item) and only
        delivers :class:`StallError` when no healer could
        act (no registered healer for the actor, or the respawn budget is
        exhausted), ``raise`` always delivers :class:`StallError` to the
        consumer.
    flight_path : str
        Where the flight record lands (most recent record wins; the path is
        stable so dashboards/CI can poll it). Default
        ``ptpu_flight_<pid>.json`` in the working directory.
    max_events : int
        Flight-recorder ring size.
    """

    __slots__ = ("stall_threshold_s", "thresholds", "poll_interval_s",
                 "escalation", "flight_path", "max_events")

    def __init__(self, stall_threshold_s=None, thresholds=None,
                 poll_interval_s=None, escalation="flight", flight_path=None,
                 max_events=2048):
        if escalation not in ("warn", "flight", "heal", "raise"):
            raise ValueError(
                "escalation must be warn|flight|heal|raise, got %r"
                % (escalation,))
        self.stall_threshold_s = float(
            stall_threshold_s if stall_threshold_s is not None
            else _env_float("PTPU_HEALTH_THRESHOLD_S", 120.0))
        self.thresholds = dict(thresholds or {})
        self.poll_interval_s = float(
            poll_interval_s if poll_interval_s is not None
            else _env_float("PTPU_HEALTH_POLL_S", 1.0))
        self.escalation = escalation
        self.flight_path = flight_path or os.path.join(
            os.environ.get("PTPU_HEALTH_DIR", "") or ".",
            "ptpu_flight_%d.json" % os.getpid())
        self.max_events = int(max_events)

    def threshold_for(self, role):
        return float(self.thresholds.get(role, self.stall_threshold_s))


class Heartbeat:
    """One actor's liveness stamp: ``(state, last-beat monotonic time)``.

    ``beat(state)`` is two attribute stores — no lock, by design: each slot is
    written by ONE actor thread and read by the watchdog. ``last`` is stored
    BEFORE ``state`` so a torn read lands on the safe side: at a wait→busy
    transition (where ``last`` may be arbitrarily stale after a long
    legitimate block) the watchdog can only ever pair the busy state with the
    FRESH timestamp — the other interleaving shows the old wait state, which
    is exempt. The reverse order could pair busy with the stale stamp and
    deliver a spurious ``StallError`` under ``escalation="raise"``. States:
    plain strings are BUSY (``working``, ``read``, ``decode``, ...); a
    ``wait:*`` prefix marks a legitimate block (backpressure, idle claim
    polling) the watchdog must not call a stall; ``done`` retires the actor.
    """

    __slots__ = ("name", "role", "threshold_s", "last", "state", "_reported")

    def __init__(self, name, role, threshold_s):
        self.name = name
        self.role = role
        self.threshold_s = threshold_s
        self.last = time.monotonic()
        self.state = "init"
        self._reported = False

    def beat(self, state="working"):
        self.last = time.monotonic()  # before state: see the torn-read note
        self.state = state
        self._reported = False

    def wait(self, what):
        """Stamp a legitimate blocking state (backpressure / idle)."""
        self.beat("wait:" + what)

    def done(self):
        self.beat("done")

    def age(self, now=None):
        return (now if now is not None else time.monotonic()) - self.last

    @property
    def waiting(self):
        return self.state == "done" or self.state.startswith("wait:")

    def describe(self, now=None):
        return {"actor": self.name, "role": self.role, "state": self.state,
                "age_s": round(self.age(now), 3),
                "threshold_s": self.threshold_s}


class ActorSlots:
    """The heartbeats of one pool's actors, and the start of the work each has in flight.

    A pool takes its monitor from ``owner._health``, which may be set while the pool
    runs: a reader starts working in its constructor, before a loader attaches one.
    :meth:`attach` then watches the work already in flight as busy since it began (the
    reference watches only work that starts after the attach). :meth:`begin` and
    :meth:`end` are the actor's own transitions. They and :meth:`attach` hold one lock,
    and :meth:`attach` leaves alone an actor that already has its heartbeat on the
    monitor, so it never stamps an actor that has just finished its work as busy since
    the old start."""

    def __init__(self, owner, name, role, busy="working", idle=None):
        self._owner = owner
        self._name = name  # a format of the actor key, e.g. "worker.thread-%d"
        self._role = role
        self._busy = busy
        self._idle = idle  # the wait state attach gives an idle actor (None: skip it)
        self._lock = threading.Lock()
        self._started = {}  # actor key -> monotonic start of its work (None: idle)
        self._hbs = {}  # actor key -> (monitor, its heartbeat there)

    def _heartbeat(self, key, monitor):
        if monitor is None:
            return None
        got = self._hbs.get(key)
        if got is not None and got[0] is monitor:
            return got[1]
        hb = monitor.register(self._name % key, self._role)
        self._hbs[key] = (monitor, hb)
        return hb

    def heartbeat(self, key):
        """``key``'s heartbeat on the owner's monitor (registered at first use), or
        None without a monitor."""
        with self._lock:
            return self._heartbeat(key, self._owner._health)

    def attach(self, monitor):
        """Watch on ``monitor`` every actor that has no heartbeat there yet: busy since
        its start when its work is in flight, else in the idle wait state if one was
        given."""
        if monitor is None:
            return
        with self._lock:
            for key, started in self._started.items():
                got = self._hbs.get(key)
                if (got is not None and got[0] is monitor) or \
                        (started is None and self._idle is None):
                    continue
                hb = self._heartbeat(key, monitor)
                if started is None:
                    hb.wait(self._idle)
                else:
                    hb.beat(self._busy)
                    hb.last = started

    def begin(self, key):
        """The actor starts a piece of work: busy from now. Returns its heartbeat."""
        with self._lock:
            self._started[key] = time.monotonic()
            hb = self._heartbeat(key, self._owner._health)
            if hb is not None:
                hb.beat(self._busy)
            return hb

    def end(self, key, wait):
        """The actor's work is over: in the wait state ``wait`` from now."""
        with self._lock:
            self._started[key] = None
            hb = self._heartbeat(key, self._owner._health)
            if hb is not None:
                hb.wait(wait)
            return hb

    def retire(self, key):
        """The actor exits: its heartbeat, if it has one, is done."""
        with self._lock:
            self._started.pop(key, None)
            got = self._hbs.pop(key, None)
            if got is not None:
                got[1].done()


def _sanitize(name):
    """Metric-suffix-safe actor name (collector keys become Prometheus names)."""
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def driver_thread_stacks():
    """``{thread-name-ident: formatted stack}`` for every live thread in THIS
    process (``sys._current_frames`` — the same evidence ``faulthandler``
    prints, but structured and capturable without a signal)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, frame in sys._current_frames().items():
        label = "%s-%d" % (names.get(tid, "thread"), tid)
        out[label] = "".join(traceback.format_stack(frame))
    return out


class HealthMonitor:
    """Registry of heartbeats + the flight recorder + the stall watchdog.

    One monitor watches one pipeline (a ``DataLoader`` builds and owns one via
    ``health=``; standalone readers/executors can share one through their
    ``set_health``). ``start()`` arms the watchdog daemon and activates the
    flight recorder for degradation mirroring; ``stop()`` (or the context
    manager) retires both. All registration APIs are thread-safe; the beat
    path itself is lock-free (see :class:`Heartbeat`).
    """

    def __init__(self, options=None, registry=None):
        self.options = options if options is not None else HealthOptions()
        self.flight = FlightRecorder(self.options.max_events)
        self._lock = threading.Lock()
        self._hbs = {}                # name -> Heartbeat
        self._stack_providers = {}    # handle -> fn() -> {label: stack text}
        self._contexts = {}           # handle -> (name, fn() -> dict)
        self._stall_callbacks = {}    # handle -> fn(StallError)
        self._healers = {}            # handle -> fn(stalled) -> healed names
        self._heals = 0
        self._next_handle = 0
        self._stalls = 0
        self._last_record_path = None
        self._watchdog = None
        self._stop_event = threading.Event()
        self._registry = registry
        self._worker_hists = {}       # key -> Histogram

    # -- heartbeat registry -------------------------------------------------------------

    def register(self, name, role, threshold_s=None):
        """Get-or-create the heartbeat for ``name`` (idempotent — actors
        re-registering across iterations reuse their slot, re-stamped)."""
        with self._lock:
            hb = self._hbs.get(name)
            if hb is None:
                hb = self._hbs[name] = Heartbeat(
                    name, role,
                    threshold_s if threshold_s is not None
                    else self.options.threshold_for(role))
            else:
                hb.beat("init")
            return hb

    def unregister(self, name):
        with self._lock:
            self._hbs.pop(name, None)

    def unregister_prefix(self, prefix):
        """Retire every actor and worker-latency slot under ``prefix + "/"``:
        a scoped pipeline detaching from a shared monitor. Without this each
        closed loader generation would leave its ``pipeN/*`` heartbeats
        registered forever — exported as ever-aging gauges, listed in every
        future flight record, and growing the monitor unboundedly."""
        cut = prefix + "/"
        with self._lock:
            for name in [n for n in self._hbs
                         if isinstance(n, str) and n.startswith(cut)]:
                del self._hbs[name]
            for key in [k for k in self._worker_hists
                        if isinstance(k, str) and k.startswith(cut)]:
                del self._worker_hists[key]

    def heartbeats(self, now=None):
        """Point-in-time description of every registered actor."""
        now = now if now is not None else time.monotonic()
        with self._lock:
            hbs = list(self._hbs.values())
        return [hb.describe(now) for hb in hbs]

    # -- per-worker latency (straggler detection) ---------------------------------------

    def observe_worker(self, key, dur):
        """Record one work-item latency for worker ``key`` (executor index) —
        the ``ptpu_worker_item_seconds{worker=...}`` histograms feeding the
        analyzer's ``straggler`` verdict."""
        hist = self._worker_hists.get(key)
        if hist is None:
            from petastorm_tpu_torch.obs.metrics import default_registry

            reg = self._registry if self._registry is not None \
                else default_registry()
            hist = reg.histogram(
                "ptpu_worker_item_seconds",
                help="per-worker work-item latency (straggler detection)",
                worker=str(key))
            with self._lock:
                self._worker_hists.setdefault(key, hist)
        hist.observe(dur)

    def set_registry(self, registry):
        """Route the per-worker latency histograms onto ``registry`` (the
        loader wires its ``metrics=`` registry here so worker latencies export
        beside the stage histograms). No-op once observations exist — moving a
        live family would split its history across registries."""
        with self._lock:
            if not self._worker_hists:
                self._registry = registry

    def worker_latency(self):
        """``{worker key: histogram summary}`` — the straggler detector's
        input (:func:`petastorm_tpu_torch.obs.analyze.detect_straggler`)."""
        with self._lock:
            hists = dict(self._worker_hists)
        return {key: hist.snapshot() for key, hist in hists.items()}

    # -- evidence/context wiring --------------------------------------------------------

    def _add(self, table, value):
        with self._lock:
            handle = self._next_handle
            self._next_handle += 1
            table[handle] = value
        return handle

    def add_stack_provider(self, fn):
        """Register ``fn() -> {label: stack text}`` (the process pool's
        signal-children-and-collect hook). Returns a removal handle."""
        return self._add(self._stack_providers, fn)

    def remove_stack_provider(self, handle):
        with self._lock:
            self._stack_providers.pop(handle, None)

    def add_context(self, name, fn):
        """Register ``fn() -> dict`` snapshotted into every flight record
        under ``context[name]`` (queue depths, pipeline stats, io gauges)."""
        return self._add(self._contexts, (name, fn))

    def remove_context(self, handle):
        with self._lock:
            self._contexts.pop(handle, None)

    def add_stall_callback(self, fn, prefix=None):
        """Register ``fn(StallError)`` fired under ``escalation="raise"`` (the
        loader uses it to fail the consumer fast). With ``prefix`` (a
        :meth:`scoped` namespace) the callback only fires when a STALLED
        actor belongs to that scope — on a shared monitor, one pipeline's
        stall must not fail every other pipeline's consumer. Returns a
        removal handle."""
        return self._add(self._stall_callbacks, (prefix, fn))

    def remove_stall_callback(self, handle):
        with self._lock:
            self._stall_callbacks.pop(handle, None)

    def add_healer(self, fn):
        """Register ``fn(stalled) -> iterable of actor names it healed`` (the
        process pool's kill-the-hung-child hook). ``stalled`` is the
        list of describe dicts from :meth:`check_stalls`. Under
        ``escalation="heal"`` every healer runs; stalled actors NO healer
        claims escalate to :class:`StallError`. Returns a removal handle."""
        return self._add(self._healers, fn)

    def remove_healer(self, handle):
        with self._lock:
            self._healers.pop(handle, None)

    # -- stall detection ----------------------------------------------------------------

    def check_stalls(self, now=None):
        """Actors whose busy-state heartbeat age exceeds their threshold —
        each reported ONCE per hang (re-armed by its next beat). The watchdog
        calls this every poll; tests call it directly."""
        now = now if now is not None else time.monotonic()
        with self._lock:
            hbs = list(self._hbs.values())
        stalled = []
        for hb in hbs:
            if hb.waiting or hb._reported:
                continue
            if hb.age(now) > hb.threshold_s:
                hb._reported = True  # debounce until the actor beats again
                stalled.append(hb.describe(now))
        return stalled

    @property
    def stall_count(self):
        return self._stalls

    @property
    def last_record_path(self):
        """Path of the most recently written flight record (None before any)."""
        return self._last_record_path

    def _handle_stall(self, stalled):
        from petastorm_tpu_torch.obs.log import degradation

        self._stalls += len(stalled)
        actors = ", ".join("%s (%s %.1fs > %.1fs)"
                           % (s["actor"], s["state"], s["age_s"],
                              s["threshold_s"]) for s in stalled)
        self.flight.record("stall", actors=[s["actor"] for s in stalled])
        path = None
        if self.options.escalation in ("flight", "heal", "raise"):
            try:
                path = self.dump_flight_record("stall", stalled=stalled)
            except Exception as e:  # noqa: BLE001 — evidence capture must not
                # kill the watchdog (it re-arms at the next beat)
                logger.warning("flight-record dump failed: %s", e)
        # dump first, log after: the log must point at a record that exists
        # (warn mode writes none — say so rather than send the operator to a
        # missing file, or a stale one from a previous run at the same path)
        degradation(
            "stall_detected",
            "Pipeline stall: %s missed the heartbeat threshold%s", actors,
            ("; see the flight record at %s" % path) if path is not None
            else ("; no flight record (escalation='warn')"
                  if self.options.escalation == "warn"
                  else "; flight-record dump FAILED (see preceding warning)"),
            once=False)
        if self.options.escalation == "heal":
            stalled = self._try_heal(stalled)
            if not stalled:
                return  # every stalled actor healed in place: no fail-fast
            actors = ", ".join("%s (%s %.1fs > %.1fs)"
                               % (s["actor"], s["state"], s["age_s"],
                                  s["threshold_s"]) for s in stalled)
        if self.options.escalation in ("heal", "raise"):
            err = StallError(
                "pipeline stalled: %s%s" % (
                    actors, (" (flight record: %s)" % path) if path else ""))
            with self._lock:
                callbacks = list(self._stall_callbacks.values())
            actors = [s["actor"] for s in stalled]
            for prefix, cb in callbacks:
                if prefix is not None and not any(
                        a.startswith(prefix + "/") for a in actors):
                    continue  # scoped callback: none of ITS actors stalled
                try:
                    cb(err)
                except Exception as e:  # noqa: BLE001 — one bad callback must
                    # not stop the fail-fast delivery to the others
                    logger.warning("stall callback failed: %s", e)

    def _try_heal(self, stalled):
        """Run every registered healer against ``stalled``; returns the
        actors nobody healed (empty = fully recovered). A healed actor's next
        beat re-arms its debounce, so a *re*-hang after a heal is detected
        again — and escalates again, until the healer's budget runs out and
        the leftover stall falls through to :class:`StallError`."""
        from petastorm_tpu_torch.obs.log import degradation

        with self._lock:
            healers = list(self._healers.values())
        remaining = list(stalled)
        for fn in healers:
            if not remaining:
                break
            try:
                healed = set(fn(remaining) or ())
            except Exception as e:  # noqa: BLE001 — a broken healer must not
                # kill the watchdog; the stall then escalates instead
                logger.warning("stall healer failed: %s", e)
                continue
            if healed:
                remaining = [s for s in remaining if s["actor"] not in healed]
        healed_n = len(stalled) - len(remaining)
        if healed_n:
            self._heals += healed_n
            self.flight.record("heal", healed=healed_n,
                               remaining=[s["actor"] for s in remaining])
            degradation(
                "stall_healed",
                "Stall auto-heal recovered %d actor(s) in place%s", healed_n,
                ("; %d still stalled (escalating)" % len(remaining))
                if remaining else "", once=False)
        return remaining

    @property
    def heal_count(self):
        """Actors recovered in place by the ``heal`` escalation tier."""
        return self._heals

    # -- flight record ------------------------------------------------------------------

    def dump_flight_record(self, reason, stalled=(), path=None):
        """Capture + atomically write one flight record; returns its path.

        The record is self-contained JSON: stalled actors, every heartbeat,
        all driver thread stacks, child stacks from registered providers,
        context snapshots (queue depths / stats / io), degradation counts,
        per-worker latency summaries, and the event ring.
        """
        record = self.capture(reason, stalled=stalled)
        path = path or self.options.flight_path
        write_flight_record(path, record)
        self._last_record_path = path
        return path

    def capture(self, reason, stalled=()):
        """The flight-record dict (no file IO) — ``health_report()``'s body."""
        from petastorm_tpu_torch.obs.log import degradation_counts

        with self._lock:
            providers = list(self._stack_providers.values())
            contexts = list(self._contexts.values())
        child_stacks = {}
        for fn in providers:
            try:
                child_stacks.update(fn() or {})
            except Exception as e:  # noqa: BLE001 — partial evidence beats none
                child_stacks["<provider error>"] = repr(e)
        context = {}
        for name, fn in contexts:
            try:
                context[name] = fn()
            except Exception as e:  # noqa: BLE001 — partial evidence beats none
                context[name] = {"error": repr(e)}
        return {
            "schema": "ptpu-flight-v1",
            "ts": time.time(),
            "pid": os.getpid(),
            "reason": reason,
            "stalls_total": self._stalls,
            "stalled": list(stalled),
            "heartbeats": self.heartbeats(),
            "driver_stacks": driver_thread_stacks(),
            "child_stacks": child_stacks,
            "context": context,
            "degradations": degradation_counts(),
            "worker_latency": self.worker_latency(),
            "events": self.flight.events(),
        }

    # -- metrics export -----------------------------------------------------------------

    def collect(self):
        """Pull-mode collector payload (registered by the loader's metrics
        wiring as the ``ptpu_health_*`` family): per-actor heartbeat age and
        stalled flag, plus the stall total."""
        now = time.monotonic()
        out = {"stalls_total": self._stalls, "heals_total": self._heals}
        with self._lock:
            hbs = list(self._hbs.values())
        for hb in hbs:
            key = _sanitize(hb.name)
            out["hb_age_s_" + key] = round(hb.age(now), 3)
            out["hb_stalled_" + key] = int(
                not hb.waiting and hb.age(now) > hb.threshold_s)
        return out

    # -- lifecycle ----------------------------------------------------------------------

    def scoped(self, prefix):
        """A :class:`HealthScope` namespacing actor registrations under
        ``prefix`` — required when one monitor watches several pipelines."""
        return HealthScope(self, prefix)

    def start(self):
        """Arm the watchdog daemon + activate the flight recorder. Idempotent."""
        if self._watchdog is not None and self._watchdog.is_alive():
            return self
        self._stop_event.clear()
        activate(self.flight)
        self._watchdog = threading.Thread(
            target=self._watch, name="ptpu-health-watchdog", daemon=True)
        self._watchdog.start()
        return self

    def _watch(self):
        while not self._stop_event.wait(self.options.poll_interval_s):
            try:
                stalled = self.check_stalls()
                if stalled:
                    self._handle_stall(stalled)
            except Exception as e:  # noqa: BLE001 — the watchdog must outlive
                # any single bad poll (it IS the last line of defense)
                logger.warning("health watchdog poll failed: %s", e)

    def stop(self):
        self._stop_event.set()
        deactivate(self.flight)
        watchdog, self._watchdog = self._watchdog, None
        if watchdog is not None:
            watchdog.join(timeout=max(5.0, 2 * self.options.poll_interval_s))

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()


class HealthScope:
    """Namespaced view of a :class:`HealthMonitor` for ONE pipeline.

    The registry is get-or-create by actor NAME — so two pipelines sharing a
    monitor would otherwise hand their producers/workers the SAME heartbeat
    slots, and the healthy pipeline's stamps would mask the hung one's stall
    (plus merge their per-worker latency histograms). A scope prefixes every
    registration and latency key with ``<prefix>/``, giving each pipeline its
    own actors on the shared monitor. Downstream components (executors, the
    readahead pool) duck-type against this surface, so a bare monitor — the
    loader-owned single-pipeline case — works unchanged in their hands.
    """

    def __init__(self, monitor, prefix):
        self.monitor = monitor
        self.prefix = prefix
        self.flight = monitor.flight
        self.options = monitor.options

    def _name(self, name):
        return "%s/%s" % (self.prefix, name)

    def register(self, name, role, threshold_s=None):
        return self.monitor.register(self._name(name), role, threshold_s)

    def unregister(self, name):
        self.monitor.unregister(self._name(name))

    def observe_worker(self, key, dur):
        self.monitor.observe_worker(self._name(str(key)), dur)

    def worker_latency(self):
        """Only THIS scope's workers (straggler detection must compare peers
        within one executor, never across pipelines)."""
        cut = len(self.prefix) + 1
        return {k[cut:]: v for k, v in self.monitor.worker_latency().items()
                if isinstance(k, str) and k.startswith(self.prefix + "/")}

    def add_stack_provider(self, fn):
        return self.monitor.add_stack_provider(fn)

    def remove_stack_provider(self, handle):
        self.monitor.remove_stack_provider(handle)

    def add_healer(self, fn):
        """Forwarded as-is: the healer receives FULL (prefixed) actor names in
        the stalled dicts and must return the same names — the process pool's
        healer rebuilds its own scoped names (via this scope's ``_name``) and
        claims only exact matches, so one pipeline's healer never touches a
        sibling's children on a shared monitor."""
        return self.monitor.add_healer(fn)

    def remove_healer(self, handle):
        self.monitor.remove_healer(handle)

    def close(self):
        """Retire every actor this scope registered (loader ``__exit__`` on a
        shared monitor — the monitor itself stays running for its owner)."""
        self.monitor.unregister_prefix(self.prefix)


def normalize_health(health):
    """``DataLoader(health=...)`` / reader-factory normalization:
    ``None``/``False`` (honoring ``PTPU_HEALTH``) → ``(monitor-or-None,
    owned)``; ``True`` → fresh monitor with default options; a
    :class:`HealthOptions` → fresh monitor with it; a :class:`HealthMonitor`
    → shared as-is (caller keeps ownership)."""
    if isinstance(health, HealthMonitor):
        return health, False
    if isinstance(health, HealthOptions):
        return HealthMonitor(health), True
    if health or (health is None and health_enabled_by_env()):
        return HealthMonitor(), True
    return None, False
