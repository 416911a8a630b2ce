"""Closed-loop pipeline controller: the time-series plane's windows actuating the knobs.

Port of ``petastorm_tpu.control.controller``. The time-series plane
(:mod:`petastorm_tpu_torch.obs.timeseries`) produces the windowed series and the
attribution report names the critical path's culprit site; a :class:`Controller` rides
the same sampling cadence (attached to the registry's
:class:`~petastorm_tpu_torch.obs.timeseries.TimelineStore`, like the SLO engine) and
applies declarative :class:`PolicyRule`\\ s to the
:class:`~petastorm_tpu_torch.control.knobs.KnobSet`:

- grow readahead when exposed read latency dominates the slow decile;
- widen the ranged-GET pool against the learned per-(store, size class) latency model
  (Little's law: desired inflight ~ GET rate x learned p50), and arm hedges earlier,
  when ``io.remote`` owns the slow decile;
- grow the mem tier's budget when the share of store re-reads stays high;
- shrink the worker fleet when the pipeline is consumer-bound (the producer's put-wait
  share: unused producer CPU is the bill);
- flip the compressed-page pass-through back to the host inflate when the device
  inflate stage owns the slow decile.

**Anti-oscillation contract** (every clause enforced in :meth:`Controller.evaluate`):

1. *Hysteresis*: a rule fires above ``fire_above`` and its streak only clears below
   ``clear_below``; the band between cannot flap it.
2. *Debounce*: the signal must exceed ``fire_above`` for ``windows`` consecutive windows
   before the first actuation.
3. *Cooldown*: after actuating a knob, that knob is frozen for ``cooldown_windows``
   windows.
4. *Step limits*: one actuation moves a knob by at most ``max_step_factor``
   (multiplicative), and by at least one integer step; bounds come from the knob.
5. *Warmup*: the first ``warmup_windows`` windows are observe-only.
6. *No-gain guard*: the first actuation opens an **experiment**: the knobs are
   checkpointed and the objective (delivered rows/s from the windowed
   ``ptpu_pipeline_rows`` delta) is baselined. If ``max_steps_without_gain`` settled
   windows pass without the objective improving by ``min_gain``, every knob reverts to
   the checkpoint and the controller freezes until :meth:`Controller.reset`.
7. *Efficiency guard*: unguarded (efficiency) rules bypass the experiment; their knob
   reverts if the objective drops after the step.

Every decision is an event: a ``ctl_actuate`` / ``ctl_revert`` / ``ctl_freeze``
degradation (counted, logged, mirrored into live flight recorders) carrying the knob's
values and the triggering window, a ``ctl_decision`` flight event, and the
``ptpu_ctl_*`` counter families on the registry.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time


@dataclasses.dataclass
class Decision:
    """One controller action (actuation, revert, or freeze)."""

    t: float            # anchored window time
    window: int         # controller window index at decision time
    cause: str          # ctl_actuate | ctl_revert | ctl_freeze
    rule: str
    knob: str | None
    before: object = None
    after: object = None
    #: what fired: the signal description with its window value/culprit site
    trigger: str = ""
    #: the objective (rows/s) in the triggering window, when known
    rows_per_s: float | None = None

    def to_dict(self):
        return dataclasses.asdict(self)


class WindowContext:
    """One window's read surface for rule signals: the sampled series, the
    window length, and a lazily-resolved attribution snapshot."""

    def __init__(self, window, window_s, attribution=None):
        self.window = window
        self.window_s = window_s
        self._attribution = attribution
        self._report = None
        self._report_resolved = False

    def point(self, name):
        return self.window.get(name)

    def stat(self, name, stat):
        point = self.window.get(name)
        return None if point is None else point.get(stat)

    def delta(self, name):
        return self.stat(name, "delta")

    def rate(self, name):
        return self.stat(name, "rate")

    def time_share(self, name):
        """delta(name) / window seconds — e.g. the producer's put-wait share
        of the window (cumulative-seconds collector series)."""
        delta = self.delta(name)
        if delta is None or not self.window_s:
            return None
        return max(0.0, delta) / self.window_s

    def report(self):
        """The attribution snapshot (memoized per window; None without an
        attribution source or when it fails — rules then skip)."""
        if not self._report_resolved:
            self._report_resolved = True
            if self._attribution is not None:
                try:
                    self._report = self._attribution()
                except Exception:  # noqa: BLE001 — a broken source skips rules
                    from petastorm_tpu_torch.obs.log import degradation

                    degradation("ctl_attribution_error",
                                "controller attribution snapshot failed; "
                                "attribution-driven rules skip this window")
        return self._report

    def slow_share(self, site):
        """``site``'s share of the slow-decile critical path, or None when no
        attribution is available."""
        report = self.report()
        if report is None:
            return None
        return report.slow_share.get(site, 0.0) if report.slow_share else None

    def tier_share(self, tier, min_hits=8):
        """``tier``'s share of this window's cache-tier serves (None below
        ``min_hits`` total — a quiet window proves nothing)."""
        total = 0.0
        part = None
        for t in ("mem", "disk", "remote"):
            delta = self.delta('ptpu_io_tier_hits_total{tier="%s"}' % t)
            if delta:
                total += delta
            if t == tier:
                part = delta or 0.0
        if part is None or total < min_hits:
            return None
        return part / total

    def tenant_share(self, tenant, resource="worker_s", min_total=1e-3):
        """``tenant``'s share of this window's per-tenant resource deltas
        (the ``ptpu_tenant_*`` twins) — the fleet-fairness signal
        behind :func:`tenant_qos_rules`. None when the window's total charge
        across all tenants is below ``min_total`` (an idle fleet proves
        nothing about fairness)."""
        from petastorm_tpu_torch.obs.tenant import RESOURCES

        family = RESOURCES[resource][0]
        prefix = family + '{tenant="'
        total = 0.0
        part = 0.0
        for name in self.window:
            if not name.startswith(prefix):
                continue
            delta = self.delta(name) or 0.0
            total += max(0.0, delta)
            if name == '%s%s"}' % (prefix, tenant):
                part = max(0.0, delta)
        if total < min_total:
            return None
        return part / total

    def model_latency_s(self):
        """The learned remote-GET p50 of the busiest (store, size-class)
        histogram — the latency-model input to the Little's-law pool sizing.
        None while the model has too few samples to trust."""
        from petastorm_tpu_torch.io.remote import shared_latency_model

        best = None
        model = shared_latency_model()
        with model._lock:
            hists = list(model._hists.values())
        for hist in hists:
            if hist.count >= 20 and (best is None
                                     or hist.count > best.count):
                best = hist
        return None if best is None else best.percentile(0.5)


class PolicyRule:
    """One declarative control rule: a windowed signal moving one knob.

    ``signal(ctx)`` returns the watched statistic (None = sparse window,
    neither fires nor clears the streak). When it has exceeded ``fire_above``
    for ``windows`` consecutive windows, ``propose(ctx, current)`` computes
    the target value; the controller step-limits, bound-clamps (via the
    knob), cools down and logs the actuation.
    """

    def __init__(self, name, knob, signal, fire_above, clear_below,
                 propose, windows=2, cooldown=3, max_step_factor=2.0,
                 guarded=True, description=""):
        if clear_below > fire_above:
            raise ValueError("clear_below must be <= fire_above (hysteresis)")
        self.name = name
        self.knob = knob
        self.signal = signal
        self.fire_above = float(fire_above)
        self.clear_below = float(clear_below)
        self.propose = propose
        self.windows = max(1, int(windows))
        self.cooldown = max(0, int(cooldown))
        self.max_step_factor = float(max_step_factor)
        #: guarded rules seek THROUGHPUT: their actuations open the global
        #: no-gain experiment (no improvement -> revert + freeze). Unguarded
        #: rules seek EFFICIENCY (shrink-workers: rows/s should stay FLAT);
        #: they bypass the no-gain experiment and instead carry the safety
        #: guard — the knob reverts if the objective DROPS after the step.
        self.guarded = bool(guarded)
        self.description = description


def _slow_share_signal(site):
    return lambda ctx: ctx.slow_share(site)


#: read-path sites whose slow-decile time is EXPOSED latency a deeper
#: prefetch window can hide: synchronous reads (misses) and residual waits on
#: in-flight prefetches. ``io.readahead`` itself is excluded — the background
#: read span is charged to items even when fully overlapped, so a healthy
#: deep pipeline still shows it; only the exposed remainder is actionable.
_READ_EXPOSED_SITES = ("reader.read", "reader.read_run",
                       "io.readahead_wait", "io.wait")


def _exposed_read_signal(ctx):
    """Slow-decile share of EXPOSED read latency, gated on a measured time
    scale: the window's exposed read seconds — foreground waits on in-flight
    prefetches plus miss-fallback sync reads
    (``ptpu_io_readahead_exposed_s`` deltas) — as a share of wall time.
    Share-based signals alone carry no scale — a healthy fast pipeline's
    slow decile is trivially owned by its largest µs-level site (usually the
    read), which would look identical to an injected 20 ms bottleneck. A
    pipeline that spends under a quarter of wall-clock actually BLOCKED on
    in-flight prefetches has its reads hidden; the signal clears."""
    wait_share = ctx.time_share("ptpu_io_readahead_exposed_s")
    if wait_share is None:
        return None
    if wait_share < 0.25:
        return 0.0
    shares = [ctx.slow_share(site) for site in _READ_EXPOSED_SITES]
    if all(s is None for s in shares):
        return None
    return sum(s or 0.0 for s in shares)


def _grow(factor):
    def propose(ctx, current):
        return current * factor if current else 1
    return propose


def _propose_inflight(ctx, current):
    """Little's law against the learned latency model: a GET stream of λ/s
    at p50 service time W wants ~λ·W slots busy; 1.5× headroom covers the
    tail the hedges then clip. Falls back to doubling while the model is
    still learning."""
    rate = ctx.rate("ptpu_io_remote_gets_total")
    latency = ctx.model_latency_s()
    if rate and latency:
        return max(current + 1, int(math.ceil(rate * latency * 1.5)))
    return current * 2


def _propose_hedge_quantile(ctx, current):
    return current - 0.04


def _shrink_one(ctx, current):
    return current - 1


def default_rules():
    """The built-in rule table. Rules whose
    knob is absent from the KnobSet are skipped."""
    return [
        PolicyRule(
            "grow-readahead", "readahead_depth",
            signal=_exposed_read_signal,
            fire_above=0.4, clear_below=0.15, windows=2, cooldown=2,
            propose=_grow(2),
            description="exposed read latency (sync reads + "
                        "io.readahead_wait) dominates the slow decile while "
                        "the consumer starves -> double the prefetch window "
                        "(and its IO threads)"),
        PolicyRule(
            "widen-get-pool", "remote_max_inflight",
            signal=_slow_share_signal("io.remote"),
            fire_above=0.35, clear_below=0.15, windows=2, cooldown=2,
            propose=_propose_inflight,
            description="io.remote dominates the slow decile -> size the GET "
                        "pool to GET-rate x learned p50 (Little's law)"),
        PolicyRule(
            "hedge-sooner", "hedge_quantile",
            signal=_slow_share_signal("io.remote"),
            fire_above=0.45, clear_below=0.2, windows=3, cooldown=3,
            propose=_propose_hedge_quantile,
            description="io.remote still dominates after widening -> arm the "
                        "hedge deadline at a lower latency quantile"),
        PolicyRule(
            "promote-hot-rows", "mem_cache_bytes",
            signal=lambda ctx: ctx.tier_share("remote"),
            fire_above=0.5, clear_below=0.2, windows=3, cooldown=3,
            propose=_grow(2),
            description="remote re-fetch share stays high -> grow the mem "
                        "tier budget so hot row groups stay resident"),
        PolicyRule(
            "shrink-workers", "workers",
            signal=lambda ctx: ctx.time_share("ptpu_pipeline_put_wait_s"),
            fire_above=0.5, clear_below=0.2, windows=3, cooldown=3,
            propose=_shrink_one, guarded=False,
            description="producer blocked on a full host queue most of the "
                        "window (consumer-bound) -> drain one worker; unused "
                        "producer CPU is the bill"),
        PolicyRule(
            "pagedec-host-inflate", "pagedec",
            signal=_slow_share_signal("decode.device_inflate"),
            fire_above=0.5, clear_below=0.2, windows=3, cooldown=6,
            propose=lambda ctx, current: "off", guarded=False,
            description="the device inflate stage owns the slow decile -> "
                        "flip the compressed-page pass-through back to host "
                        "inflate live (efficiency rule, guarded like "
                        "shrink-workers: its own guard reverts on a rows/s "
                        "drop)"),
    ]


def _tenant_share_signal(tenant, resource):
    def signal(ctx):
        return ctx.tenant_share(tenant, resource=resource)
    return signal


def _halve(ctx, current):
    return current / 2.0


def tenant_qos_rules(tenants, resource="worker_s", fire_above=0.6,
                     clear_below=0.35, windows=2, cooldown=3):
    """Per-tenant fleet-fairness rules for the data service: when
    one tenant's share of the fleet's ``resource`` charge (default decode
    worker-seconds) stays above ``fire_above``, halve that tenant's
    ``svc_weight:<tenant>`` stride-scheduling weight. Efficiency rules
    (``guarded=False``): fairness is the objective, not throughput — the
    safety guard still reverts a weight cut that tanks delivered rows/s.

    The ``svc_weight:<tenant>`` knobs belong to the data service
    (:meth:`~petastorm_tpu_torch.service.server.DataService.register_knobs`); rules whose
    knob is absent are skipped, so the table composes with :func:`default_rules`
    unconditionally."""
    rules = []
    for tenant in tenants:
        rules.append(PolicyRule(
            "throttle-tenant-%s" % tenant, "svc_weight:%s" % tenant,
            signal=_tenant_share_signal(tenant, resource),
            fire_above=fire_above, clear_below=clear_below,
            windows=windows, cooldown=cooldown,
            propose=_halve, guarded=False,
            description="tenant %r eats >%d%% of the fleet's %s -> halve "
                        "its stride-scheduling weight so the other jobs "
                        "stop queueing behind it"
                        % (tenant, int(fire_above * 100), resource)))
    return rules


class ControlOptions:
    """Controller-wide policy (the per-rule thresholds live on the rules)."""

    __slots__ = ("warmup_windows", "cooldown_windows", "max_steps_without_gain",
                 "min_gain", "settle_windows", "max_decisions")

    def __init__(self, warmup_windows=5, cooldown_windows=None,
                 max_steps_without_gain=6, min_gain=0.05, settle_windows=2,
                 max_decisions=256):
        self.warmup_windows = max(0, int(warmup_windows))
        #: overrides every rule's cooldown when set (tests/benches)
        self.cooldown_windows = cooldown_windows
        self.max_steps_without_gain = max(1, int(max_steps_without_gain))
        self.min_gain = float(min_gain)
        #: windows after the last actuation before its objective is judged
        self.settle_windows = max(0, int(settle_windows))
        self.max_decisions = int(max_decisions)


class Controller:
    """The closed-loop policy engine over one :class:`KnobSet`.

    Attach to a :class:`~petastorm_tpu_torch.obs.timeseries.TimelineStore`
    (:meth:`attach`) so every Reporter/``sample_timelines()`` window drives
    one :meth:`evaluate` pass, exactly like the SLO engine — zero hot-path
    cost. ``attribution`` is a zero-arg callable returning an
    :class:`~petastorm_tpu_torch.obs.critical_path.AttributionReport` (or None);
    ``DataLoader(controller=...)`` wires ``attribution_report`` when
    provenance is on.
    """

    #: objective series: delivered rows (collector gauge; windows carry deltas)
    OBJECTIVE = "ptpu_pipeline_rows"

    def __init__(self, knobs, rules=None, registry=None, attribution=None,
                 options=None):
        self.knobs = knobs
        self._rules = list(rules) if rules is not None else default_rules()
        self._registry = registry
        self._attribution = attribution
        self._opts = options if options is not None else ControlOptions()
        self._lock = threading.Lock()
        self._decisions = []
        self._streaks = {}        # rule name -> consecutive firing windows
        self._cooldowns = {}      # knob name -> windows left frozen
        self._frozen = False
        self._last_t = None
        self.windows_evaluated = 0
        self._rate_history = []   # recent objective rows/s (bounded)
        #: the open actuation experiment (no-gain guard), or None
        self._experiment = None
        #: open efficiency-actuation watches (safety guard: revert on a
        #: throughput DROP; flat is success)
        self._efficiency = []
        self._store = None
        self._listener = None

    # -- wiring -------------------------------------------------------------------------

    def set_attribution(self, fn):
        with self._lock:
            self._attribution = fn

    def attach(self, store):
        """Ride a TimelineStore's sampling cadence (idempotent per store);
        :meth:`detach` unsubscribes (loader ``__exit__``)."""
        self.detach()
        self._store = store
        self._listener = store.add_listener(self._on_window)
        return self

    def detach(self):
        store, self._store = self._store, None
        if store is not None and self._listener is not None:
            store.remove_listener(self._listener)
        self._listener = None

    def _on_window(self, window, t):
        self.evaluate(window, t)

    # -- evaluation ---------------------------------------------------------------------

    def evaluate(self, window, t=None):
        """One control pass over a sampled window; returns the decisions this
        window produced (possibly empty)."""
        t = time.time() if t is None else t
        with self._lock:
            window_s = None if self._last_t is None \
                else max(0.0, t - self._last_t)
            self._last_t = t
            self.windows_evaluated += 1
            idx = self.windows_evaluated
            ctx = WindowContext(window, window_s, self._attribution)
            rate = self._objective_rate(ctx)
            if rate is not None:
                self._rate_history.append(rate)
                del self._rate_history[:-64]
            for knob in list(self._cooldowns):
                self._cooldowns[knob] = max(0, self._cooldowns[knob] - 1)
            if self._frozen:
                return []
            decisions = []
            if idx > self._opts.warmup_windows:
                decisions.extend(self._run_rules(ctx, t, idx, rate))
            decisions.extend(self._no_gain_guard(t, idx, rate))
            decisions.extend(self._efficiency_guard(t, idx, rate))
        for decision in decisions:
            self._publish(decision)
        return decisions

    def _objective_rate(self, ctx):
        delta = ctx.delta(self.OBJECTIVE)
        if delta is None or not ctx.window_s:
            return None
        return max(0.0, delta) / ctx.window_s

    def _run_rules(self, ctx, t, idx, rate):
        # caller MUST hold self._lock: evaluate(), its one caller, does (the analyzer
        # cannot see cross-method lock ownership)
        decisions = []
        for rule in self._rules:
            if rule.knob not in self.knobs:
                continue
            value = rule.signal(ctx)
            if value is None:
                continue  # sparse window: streak untouched (like SLO specs)
            if value >= rule.fire_above:
                streak = self._streaks.get(rule.name, 0) + 1
            elif value <= rule.clear_below:
                streak = 0
            else:
                streak = self._streaks.get(rule.name, 0)  # hysteresis band
            self._streaks[rule.name] = streak
            if streak < rule.windows or self._cooldowns.get(rule.knob, 0):
                continue
            current = self.knobs.get(rule.knob)
            try:
                target = rule.propose(ctx, current)
            except Exception:  # noqa: BLE001 — a broken proposer skips
                from petastorm_tpu_torch.obs.log import degradation

                degradation("ctl_rule_error",
                            "controller rule %r propose() raised; skipped",
                            rule.name)
                continue
            target = self._step_limit(rule, current, target)
            # checkpoint BEFORE the actuation: the experiment's revert target
            checkpoint = self.knobs.checkpoint() \
                if rule.guarded and self._experiment is None else None
            before, after = self.knobs.apply(rule.knob, target)
            if after == before:
                continue  # at a bound / quantized away: not an actuation
            if rule.guarded:
                if self._experiment is None:
                    self._experiment = {  # graftlint: disable=GL-C001 (evaluate() holds self._lock)
                        "checkpoint": checkpoint,
                        "baseline": self._baseline_rate(),
                        "opened": idx,
                        "steps": 0,
                        "stale_windows": 0,
                    }
                self._experiment["steps"] += 1
                self._experiment["last_actuation"] = idx
            else:
                # efficiency actuation (e.g. shrink-workers): rows/s should
                # stay FLAT — watched by the safety guard, not the no-gain
                # experiment (flat throughput is its success, not a failure)
                self._efficiency.append({  # graftlint: disable=GL-C001 (evaluate() holds self._lock)
                    "knob": rule.knob, "revert_to": before,
                    "baseline": self._baseline_rate(), "applied": idx})
            cooldown = self._opts.cooldown_windows \
                if self._opts.cooldown_windows is not None else rule.cooldown
            self._cooldowns[rule.knob] = cooldown
            trigger = "%s=%.3f >= %.3f for %d windows" \
                % (_signal_label(rule), value, rule.fire_above, streak)
            decisions.append(self._record(Decision(
                t=t, window=idx, cause="ctl_actuate", rule=rule.name,
                knob=rule.knob, before=before, after=after, trigger=trigger,
                rows_per_s=rate)))
            self._streaks[rule.name] = 0  # re-debounce after acting
        return decisions

    def _step_limit(self, rule, current, target):
        """Bound one actuation's movement: at most ``max_step_factor``
        multiplicative (and never less than one integer step, so a rule can
        always make progress toward its bound)."""
        try:
            cur = float(current)
            tgt = float(target)
        except (TypeError, ValueError):
            return target  # enum knob: propose() picks a member directly
        if cur > 0:
            hi = cur * rule.max_step_factor
            lo = cur / rule.max_step_factor
            tgt = min(max(tgt, lo), hi)
            if abs(tgt - cur) < 1.0 and self.knobs.knob(rule.knob).integer:
                tgt = cur + (1 if target > current else -1)
        return tgt

    def _baseline_rate(self):
        """The objective before the experiment: median of the recent settled
        windows (robust to one noisy window)."""
        recent = [r for r in self._rate_history[-8:] if r is not None]
        if not recent:
            return None
        recent.sort()
        n = len(recent)
        return recent[n // 2] if n % 2 \
            else 0.5 * (recent[n // 2 - 1] + recent[n // 2])

    def _no_gain_guard(self, t, idx, rate):
        """The revert-and-freeze clause: judge the open experiment on settled
        windows only; commit on ``min_gain`` improvement, revert + freeze
        after ``max_steps_without_gain`` settled windows without it. The caller
        MUST hold self._lock: evaluate(), its one caller, does."""
        exp = self._experiment
        if exp is None or rate is None:
            return []
        if idx - exp.get("last_actuation", exp["opened"]) \
                < self._opts.settle_windows:
            return []  # the actuation has not settled into the windows yet
        baseline = exp["baseline"]
        if baseline is None:
            exp["baseline"] = rate  # first measurable window IS the baseline
            return []
        # judge the BEST settled window since the experiment opened, not just
        # the current one: a converged pipeline plateaus, and judging the
        # plateau window against an already-improved baseline would revert a
        # retune that genuinely helped (window phasing also makes single
        # windows noisy — one good window is proof the knob moved the needle)
        exp["best"] = max(exp.get("best", 0.0), rate)
        if baseline <= 0 or exp["best"] >= baseline * (1.0 + self._opts.min_gain):
            self._experiment = None  # graftlint: disable=GL-C001 (evaluate() holds self._lock) — improvement: commit
            return []
        exp["stale_windows"] += 1
        if exp["stale_windows"] < self._opts.max_steps_without_gain:
            return []
        # no improvement after K settled windows: revert every knob to the
        # pre-experiment checkpoint and freeze
        decisions = []
        for name, before, after in self.knobs.restore(exp["checkpoint"]):
            decisions.append(self._record(Decision(
                t=t, window=idx, cause="ctl_revert", rule="no-gain-guard",
                knob=name, before=before, after=after,
                trigger="rows/s %.1f never improved >= %d%% over the "
                        "pre-actuation baseline %.1f"
                        % (rate, round(100 * self._opts.min_gain), baseline),
                rows_per_s=rate)))
        self._frozen = True  # graftlint: disable=GL-C001 (evaluate() holds self._lock)
        self._experiment = None  # graftlint: disable=GL-C001 (evaluate() holds self._lock)
        decisions.append(self._record(Decision(
            t=t, window=idx, cause="ctl_freeze", rule="no-gain-guard",
            knob=None,
            trigger="%d settled windows without gain after %d actuation "
                    "step(s); controller frozen until reset()"
                    % (exp["stale_windows"], exp["steps"]),
            rows_per_s=rate)))
        return decisions

    def _efficiency_guard(self, t, idx, rate):
        """Safety guard for unguarded (efficiency) actuations: if the
        objective DROPPED materially after the step, revert that knob (no
        freeze — the rule misjudged one window shape, it is not broken);
        a settled flat window confirms the step and closes the watch. The caller
        MUST hold self._lock: evaluate(), its one caller, does."""
        if not self._efficiency or rate is None:
            return []
        decisions = []
        keep = []
        confirm_after = self._opts.settle_windows + 2
        for watch in self._efficiency:
            age = idx - watch["applied"]
            if age < self._opts.settle_windows:
                keep.append(watch)
                continue
            baseline = watch["baseline"]
            if baseline is None:
                # no pre-step history (step landed in the first windows):
                # the first settled rate becomes the reference — a LATER
                # drop against it still reverts
                watch["baseline"] = rate
                keep.append(watch)
                continue
            if rate < baseline * (1.0 - 2.0 * self._opts.min_gain):
                before, after = self.knobs.apply(watch["knob"],
                                                 watch["revert_to"])
                if after != before:
                    decisions.append(self._record(Decision(
                        t=t, window=idx, cause="ctl_revert",
                        rule="efficiency-guard", knob=watch["knob"],
                        before=before, after=after,
                        trigger="rows/s %.1f dropped >%d%% below the "
                                "pre-step baseline %.1f"
                                % (rate,
                                   round(200 * self._opts.min_gain),
                                   baseline),
                        rows_per_s=rate)))
                self._cooldowns[watch["knob"]] = max(
                    self._cooldowns.get(watch["knob"], 0), 3)
                continue  # watch closed by the revert
            if age < confirm_after:
                keep.append(watch)  # settled flat so far: watch a bit longer
            # past the horizon: confirmed — flat throughput IS the success
        self._efficiency = keep  # graftlint: disable=GL-C001 (evaluate() holds self._lock)
        return decisions

    # -- decision plumbing --------------------------------------------------------------

    def _record(self, decision):
        # caller MUST hold self._lock (evaluate's helpers run inside it)
        self._decisions.append(decision)  # graftlint: disable=GL-C001 (callers hold self._lock)
        del self._decisions[:-self._opts.max_decisions]
        return decision

    def _publish(self, decision):
        """Count + log + flight-mirror one decision (outside the lock)."""
        from petastorm_tpu_torch.obs import flight as _flight
        from petastorm_tpu_torch.obs.log import degradation

        if self._registry is not None:
            if decision.cause == "ctl_actuate":
                self._registry.counter(
                    "ptpu_ctl_actuations_total",
                    help="controller knob actuations",
                    knob=decision.knob).inc()
            elif decision.cause == "ctl_revert":
                self._registry.counter(
                    "ptpu_ctl_reverts_total",
                    help="knobs reverted by the no-gain guard").inc()
            else:
                self._registry.counter(
                    "ptpu_ctl_freezes_total",
                    help="controller freezes (no-gain guard)").inc()
        degradation(
            decision.cause,
            "controller %s: rule %s knob %s %r -> %r (window %d: %s)",
            decision.cause, decision.rule, decision.knob, decision.before,
            decision.after, decision.window, decision.trigger, once=False,
            level=20)  # INFO: actuation is the controller working, not failing
        for recorder in _flight.active_recorders():
            recorder.record("ctl_decision", cause=decision.cause,
                            rule=decision.rule, knob=decision.knob,
                            before=decision.before, after=decision.after,
                            window=decision.window, trigger=decision.trigger)

    # -- reads / lifecycle --------------------------------------------------------------

    @property
    def frozen(self):
        return self._frozen

    def decisions(self):
        """All decisions so far (oldest first, bounded)."""
        with self._lock:
            return list(self._decisions)

    def actuations(self):
        return [d for d in self.decisions() if d.cause == "ctl_actuate"]

    def reset(self):
        """Un-freeze and clear streak/experiment state (knobs stay where they
        are — restore a checkpoint explicitly to rewind them)."""
        with self._lock:
            self._frozen = False
            self._experiment = None
            self._efficiency = []
            self._streaks.clear()
            self._cooldowns.clear()

    def state(self):
        """The stats-panel payload: knob table + recent decisions + freeze
        state."""
        with self._lock:
            decisions = [d.to_dict() for d in self._decisions[-16:]]
            frozen = self._frozen
            windows = self.windows_evaluated
        return {"frozen": frozen, "windows": windows,
                "knobs": self.knobs.describe(), "decisions": decisions}

    def collect(self):
        """Pull-collector payload (``ptpu_ctl_*``): live knob values +
        defaults, decision totals, freeze state."""
        with self._lock:
            out = {
                "decisions": len(self._decisions),
                "actuations": sum(1 for d in self._decisions
                                  if d.cause == "ctl_actuate"),
                "reverts": sum(1 for d in self._decisions
                               if d.cause == "ctl_revert"),
                "freezes": sum(1 for d in self._decisions
                               if d.cause == "ctl_freeze"),
                "frozen": 1 if self._frozen else 0,
                "windows": self.windows_evaluated,
            }
        out.update(self.knobs.collect())
        return out


def _signal_label(rule):
    """A stable, human-readable name for what the rule watches (rides in the
    decision trigger so the operator sees the culprit, not a lambda repr)."""
    return {
        "grow-readahead": "slow_share(exposed reads: reader.read + "
                          "io.readahead_wait)",
        "widen-get-pool": "slow_share(io.remote)",
        "hedge-sooner": "slow_share(io.remote)",
        "promote-hot-rows": "tier_share(remote)",
        "shrink-workers": "time_share(put_wait)",
        "pagedec-host-inflate": "slow_share(decode.device_inflate)",
    }.get(rule.name, rule.name)
