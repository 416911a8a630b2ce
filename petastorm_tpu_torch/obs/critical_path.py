"""Critical-path attribution: fold per-batch span DAGs into a step-time report.

Port of ``petastorm_tpu.obs.critical_path``, pure Python with the reference's behaviour:
the same span sets give the same dicts and the same ``render()`` string.

Input is what :class:`petastorm_tpu_torch.obs.provenance.ProvenanceRecorder` stores per
delivered batch: batch-plane spans (collate, queue put, the inflate stage, decode, H2D)
plus the contributing items' spans (reader reads, readahead, remote GETs, wire,
transform, child work) on one clock-aligned timeline. The fold is the flame-graph
self-time rule: a span's **self time** is its duration minus the time covered by spans
strictly nested inside it, so nesting works whatever the sites are named. A
``reader.read`` that spends most of its time inside an ``io.remote`` span is charged the
residual only, and a ``wire.roundtrip`` containing the child's ``child.work`` span is
charged just the wire overhead. Partially overlapping siblings (a background readahead
read racing the current decode) are charged independently: overlap means the time was
not serialized behind the step, and the per-site totals say where wall time went, not
how it summed.

The :class:`AttributionReport` answers what the stage histograms cannot: which site owns
the critical path of the slow batches. It holds per-site self seconds and shares, batch
step-time percentiles split by cache tier and by degradation or quarantine cause, and a
verdict line of the form "your p99 batch spent 61% of its critical path in io.remote",
computed over the slowest decile. It refines ``DataLoader.bottleneck_report()`` (which
names a side of the host queue) down to a concrete site.

Spans are host time. On a CUDA device the transfer thread's ``loader.decode`` span times
the enqueue of the staged decode's kernels, not their run on the card: the card's work
shows up wherever the host next waits for it (the inflate stage's one read back, or the
consumer).
"""
from __future__ import annotations

import dataclasses


def fold_self_times(spans):
    """Per-site self time from possibly-nested spans of ONE logical chain.

    ``spans`` is ``[(site, t0, t1, pid)]``. Sorted by ``(t0, -t1)`` and folded
    with a stack: a span contained in the stack top is its child (its duration
    subtracts from the parent's self time); a span partially overlapping the
    top pops ONLY the top (a sibling, not a parent — enclosing ancestors that
    still contain the new span keep their parenthood). Returns
    ``{site: self_seconds}``.

    Feed this one item's (or one batch-plane's) spans at a time: two
    CONCURRENT items' timelines interleave, and folding them together would
    charge an outer span twice (once as itself, once through the overlapping
    peer that blocked its child subtraction) — :func:`analyze_batches` folds
    per record and sums."""
    out = {}
    stack = []  # [site, t0, t1, child_cover]
    for site, t0, t1, _pid in sorted(spans, key=lambda s: (s[1], -s[2])):
        dur = max(0.0, t1 - t0)
        while stack and stack[-1][2] <= t0:
            _flush(stack, out)  # fully before us: finished branch
        while stack and stack[-1][2] < t1:
            _flush(stack, out)  # ends mid-span: a sibling, never a parent
        if stack:
            stack[-1][3] += dur  # nested: cover the parent
        stack.append([site, t0, t1, 0.0])
    while stack:
        _flush(stack, out)
    return out


def _flush(stack, out):
    site, t0, t1, covered = stack.pop()
    self_s = max(0.0, (t1 - t0) - covered)
    out[site] = out.get(site, 0.0) + self_s


def diff_self_times(sites_a, sites_b, min_share=0.05):
    """Per-site self-time movement between two runs' ``stage_self_s`` maps
    (a = baseline, b = candidate): ``[(site, ratio, a_s, b_s)]`` sorted
    worst-growth-first. Only *significant* sites are compared — a site must
    own at least ``min_share`` of either run's total self time, so a
    0.1ms→0.4ms noise site cannot outrank a real 2× regression of the
    dominant seam. A site absent from the baseline is ratioed against a tiny
    epsilon floor of the baseline total (new work showing up IS a
    regression). Feeds :mod:`petastorm_tpu_torch.obs.diff`."""
    total_a = sum(sites_a.values()) or 0.0
    total_b = sum(sites_b.values()) or 0.0
    floor = max(total_a, total_b) * 1e-3 + 1e-9
    out = []
    for site in set(sites_a) | set(sites_b):
        a = sites_a.get(site, 0.0)
        b = sites_b.get(site, 0.0)
        share_a = a / total_a if total_a else 0.0
        share_b = b / total_b if total_b else 0.0
        if max(share_a, share_b) < min_share:
            continue
        ratio = b / max(a, floor)
        out.append((site, ratio, a, b))
    out.sort(key=lambda e: -e[1])
    return out


def _percentile(sorted_values, q):
    if not sorted_values:
        return 0.0
    idx = min(len(sorted_values) - 1, int(q * len(sorted_values)))
    return sorted_values[idx]


@dataclasses.dataclass
class AttributionReport:
    """Step-time attribution over the recorded batch window."""

    batches: int
    #: per-site critical-path self seconds, summed over the window
    stage_self_s: dict
    #: per-site share of total critical-path self time (0..1)
    stage_share: dict
    #: site owning the largest critical-path share (None when idle)
    top_stage: str | None
    #: batch step-gap percentiles over the window (seconds)
    step_p50_s: float
    step_p99_s: float
    #: step-gap percentiles split by the batch's dominant cache tier
    by_tier: dict
    #: step-gap percentiles split by degradation/quarantine annotation
    by_cause: dict
    #: per-site share of self time within the SLOWEST decile of batches
    slow_share: dict
    #: the "your p99 batch spent 61% in io.remote" line
    verdict: str

    @property
    def slow_top(self):
        """The site owning the largest share of the SLOW-decile batches'
        critical path — the report's culprit (falls back to the overall top
        when no step gaps were recorded). This is what the bench harness
        asserts: an injected bottleneck inflates the slow batches, whatever
        one-off costs (child cold start, first-open footer reads) dominate
        the overall totals."""
        if self.slow_share:
            return max(self.slow_share, key=self.slow_share.get)
        return self.top_stage

    def to_dict(self):
        out = dataclasses.asdict(self)
        out["slow_top"] = self.slow_top
        return out

    def render(self):
        lines = ["attribution over %d batches (step p50 %.1fms, p99 %.1fms)"
                 % (self.batches, self.step_p50_s * 1e3, self.step_p99_s * 1e3),
                 "  %s" % self.verdict]
        total = sum(self.stage_self_s.values()) or 1.0
        for site in sorted(self.stage_self_s,
                           key=lambda s: -self.stage_self_s[s]):
            lines.append("  %-24s %9.3fs self  %5.1f%% of critical path"
                         % (site, self.stage_self_s[site],
                            100.0 * self.stage_self_s[site] / total))
        for label, split in (("cache tier", self.by_tier),
                             ("cause", self.by_cause)):
            for key in sorted(split):
                s = split[key]
                lines.append("  by %-10s %-12s %4d batches  p50 %8.1fms  "
                             "p99 %8.1fms"
                             % (label, key, s["batches"], s["p50_s"] * 1e3,
                                s["p99_s"] * 1e3))
        return "\n".join(lines)

    def __str__(self):
        return self.render()


def _batch_self_times(batch):
    """Per-site self seconds of one recorded batch view, folded PER RECORD
    (the batch-plane spans, then each contributing item's spans) and summed.
    Items run concurrently on different workers — folding their interleaved
    timelines together would double-charge outer spans, so each record's
    chain folds alone (cross-pid nesting WITHIN an item, like the child spans
    inside the driver's wire.roundtrip, is intended and preserved)."""
    totals = {}
    groups = [batch.get("spans", ())]
    groups.extend(rec.get("spans", ())
                  for rec in batch.get("item_records", ()))
    for group in groups:
        folded = fold_self_times(
            [(sp["site"], sp["t0"], sp["t1"], sp["pid"]) for sp in group])
        for site, sec in folded.items():
            totals[site] = totals.get(site, 0.0) + sec
    return totals


def _batch_tier(batch):
    """Dominant ``cache_tier`` annotation among the batch's items."""
    tiers = [rec.get("annotations", {}).get("cache_tier")
             for rec in batch.get("item_records", ())]
    tiers = [t for t in tiers if t]
    if not tiers:
        return None
    return max(set(tiers), key=tiers.count)


def _batch_causes(batch):
    causes = set()
    for rec in batch.get("item_records", ()):
        ann = rec.get("annotations", {})
        if ann.get("io_retries"):
            causes.add("io_retry")
        if ann.get("quarantined"):
            causes.add("quarantined")
        if ann.get("hedges"):
            causes.add("hedged")
        if rec.get("attempts", 1) > 1:
            causes.add("retried")
    return causes or {"clean"}


def analyze_batches(batch_views):
    """Fold recorded batch views (``ProvenanceRecorder.batches()``) into an
    :class:`AttributionReport`."""
    totals = {}
    gaps = []
    tier_gaps = {}
    cause_gaps = {}
    per_batch = []  # (gap, per-site self dict) for the slow-decile split
    for batch in batch_views:
        self_times = _batch_self_times(batch)
        for site, sec in self_times.items():
            totals[site] = totals.get(site, 0.0) + sec
        gap = batch.get("step_gap_s")
        if gap is not None:
            gaps.append(gap)
            per_batch.append((gap, self_times))
            tier = _batch_tier(batch)
            if tier:
                tier_gaps.setdefault(tier, []).append(gap)
            for cause in _batch_causes(batch):
                cause_gaps.setdefault(cause, []).append(gap)
    total_self = sum(totals.values())
    share = {site: (sec / total_self if total_self else 0.0)
             for site, sec in totals.items()}
    top = max(totals, key=totals.get) if totals else None
    gaps.sort()

    def split(groups):
        return {key: {"batches": len(vals),
                      "p50_s": round(_percentile(sorted(vals), 0.50), 6),
                      "p99_s": round(_percentile(sorted(vals), 0.99), 6)}
                for key, vals in groups.items()}

    # slow-decile attribution: where did the SLOWEST batches spend their path?
    slow_share = {}
    verdict = "not enough recorded batches to attribute"
    if per_batch:
        per_batch.sort(key=lambda e: e[0])
        slow = per_batch[max(0, int(0.9 * len(per_batch))):] or per_batch[-1:]
        slow_totals = {}
        for _gap, self_times in slow:
            for site, sec in self_times.items():
                slow_totals[site] = slow_totals.get(site, 0.0) + sec
        slow_sum = sum(slow_totals.values())
        if slow_sum > 0:
            slow_share = {site: sec / slow_sum
                          for site, sec in slow_totals.items()}
            slow_top = max(slow_share, key=slow_share.get)
            verdict = ("your p99 batch spent %d%% of its critical path in %s"
                       % (round(100 * slow_share[slow_top]), slow_top))
        elif top is not None:
            verdict = ("critical path dominated by %s (%d%% of self time)"
                       % (top, round(100 * share.get(top, 0.0))))
    elif top is not None:
        verdict = ("critical path dominated by %s (%d%% of self time)"
                   % (top, round(100 * share.get(top, 0.0))))
    return AttributionReport(
        batches=len(batch_views),
        stage_self_s={site: round(sec, 6) for site, sec in totals.items()},
        stage_share={site: round(f, 4) for site, f in share.items()},
        top_stage=top,
        step_p50_s=round(_percentile(gaps, 0.50), 6),
        step_p99_s=round(_percentile(gaps, 0.99), 6),
        by_tier=split(tier_gaps),
        by_cause=split(cause_gaps),
        slow_share={site: round(f, 4) for site, f in slow_share.items()},
        verdict=verdict,
    )
