"""Bottleneck analyzer: name the pipeline stage that limits throughput.

Port of ``petastorm_tpu.obs.analyze``; the port's transfer side also counts its
compressed-page inflate stage (``PipelineStats.inflate_s``) as consumer work.

The loader pipeline is three actors around two bounded queues::

    producer (reader.next + batch.form) --host queue--> transfer/consumer side
    (inflate + decode.dispatch + h2d + training step) ... with the process pool's shm
    wire feeding the producer from below.

``PipelineStats`` already records, per actor, both its WORK time and its WAIT
time on the queue between them — and in a steady-state bounded pipeline those
waits identify the limiting stage exactly: the actor that never waits is the
bottleneck, and everyone upstream piles up on full queues while everyone
downstream starves on empty ones.

Verdicts (the JAX package's):

- ``producer-bound`` — the reader side can't keep up: the producer is ~always
  working (never blocked putting into the host queue) while the consumer side
  starves on ``queue_wait_s``. Fix: more workers, a faster wire, less host
  decode.
- ``consumer-bound`` — everything downstream of the host queue limits: decode
  dispatch, H2D, or the training step itself. The producer spends its time
  blocked on a full host queue (``put_wait_s``). Fix: on-device decode, bigger
  prefetch, a faster step.
- ``wire-bound`` — a producer-bound pipeline whose reader time is actually slab
  starvation on the shm wire (``shm_acquire_wait_s`` rivals ``read_s``, or most
  items fell back to the socket): the ring, not the readers, is the limiter.
  Fix: more/bigger slabs, release batches sooner.
- ``straggler`` — a producer-bound pipeline whose reader time is actually ONE
  slow worker: the per-worker latency histograms (recorded when a health
  monitor is attached, ``DataLoader(health=...)``) show one worker's mean item latency
  far above its peers' — a bad disk, a hot row-group shard, a throttled child. Fix: look
  at that worker's host/shard, enable work stealing, or drop the worker.
- ``balanced`` — no stage dominates (utilizations within tolerance), and
  ``idle`` — not enough data to judge.

Utilization per side = work / (work + wait); the verdict is the side with the
higher utilization, refined to wire-bound by the shm gauges. Percentile detail
(p50/p90/p99 per stage) rides along when the loader was built with
``metrics=`` (log-bucketed histograms, :mod:`petastorm_tpu_torch.obs.metrics`).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class BottleneckReport:
    """Analyzer output: machine-readable verdict + human-readable rendering."""

    verdict: str  # producer-bound | consumer-bound | wire-bound | straggler | balanced | idle
    utilization: dict  # side -> work/(work+wait) fraction
    detail: dict       # the inputs the verdict was computed from
    reason: str
    percentiles: dict | None = None  # stage -> {p50, p90, p99}, when metrics on
    straggler: dict | None = None    # {worker, mean_s, peer_median_s, ratio}, when detected
    transform_ops: dict | None = None  # fused-op label -> histogram summary
    slo_alerts: list | None = None   # recent debounced SLO/anomaly alerts

    def to_dict(self):
        return dataclasses.asdict(self)

    def render(self):
        """Multi-line human-readable report."""
        lines = ["bottleneck: %s" % self.verdict,
                 "  %s" % self.reason]
        for side in sorted(self.utilization):
            lines.append("  %-9s utilization %5.1f%%"
                         % (side, 100.0 * self.utilization[side]))
        d = self.detail
        lines.append("  producer: read %.3fs + batch %.3fs, blocked-on-full-queue %.3fs"
                     % (d["read_s"], d["batch_s"], d["put_wait_s"]))
        lines.append("  consumer: inflate %.3fs + decode %.3fs + h2d %.3fs, "
                     "starved-on-empty-queue %.3fs"
                     % (d["inflate_s"], d["decode_s"], d["h2d_s"], d["queue_wait_s"]))
        if d.get("shm_acquire_wait_s") or d.get("shm_fallbacks"):
            lines.append("  wire:     slab wait %.3fs, socket fallbacks %d"
                         % (d.get("shm_acquire_wait_s", 0.0),
                            d.get("shm_fallbacks", 0)))
        if d.get("device_queue_wait_s") is not None:
            lines.append("  training loop starved %.3fs on the device queue"
                         % d["device_queue_wait_s"])
        if self.straggler:
            s = self.straggler
            lines.append("  straggler: worker %s mean %.1fms vs peer median "
                         "%.1fms (%.1fx)"
                         % (s["worker"], s["mean_s"] * 1e3,
                            s["peer_median_s"] * 1e3, s["ratio"]))
        if self.percentiles:
            for stage in sorted(self.percentiles):
                p = self.percentiles[stage]
                lines.append("  %-16s p50 %8.2fms  p90 %8.2fms  p99 %8.2fms"
                             % (stage, p["p50"] * 1e3, p["p90"] * 1e3,
                                p["p99"] * 1e3))
        if self.transform_ops:
            lines.append("  transform stage (declarative ops, this process):")
            for op in sorted(self.transform_ops,
                             key=lambda o: -self.transform_ops[o]["sum"]):
                s = self.transform_ops[op]
                lines.append("    %-20s total %8.3fs over %6d calls  p50 %7.2fms  "
                             "p99 %7.2fms" % (op, s["sum"], s["count"], s["p50"] * 1e3,
                                              s["p99"] * 1e3))
        if self.slo_alerts:
            lines.append("  slo alerts (newest last):")
            for alert in self.slo_alerts[-5:]:
                lines.append("    [%s] %s" % (alert.get("cause", "?"),
                                             alert.get("message", "")))
        return "\n".join(lines)

    def __str__(self):
        return self.render()


#: a side must beat the other by this much utilization to be called the
#: bottleneck (below it the pipeline is genuinely balanced)
_MARGIN = 0.15
#: slab-wait share of reader time above which producer-bound refines to
#: wire-bound (the readers are mostly waiting for slabs, not reading)
_WIRE_SHARE = 0.5
#: a worker whose mean item latency exceeds its peers' median by this factor
#: (with enough samples on both sides) is a straggler
_STRAGGLER_RATIO = 3.0
#: minimum per-worker item count before its mean is trusted at all
_STRAGGLER_MIN_ITEMS = 4


def detect_straggler(worker_latency, ratio=_STRAGGLER_RATIO,
                     min_items=_STRAGGLER_MIN_ITEMS):
    """One slow worker among peers, or ``None``.

    ``worker_latency`` is ``{worker key: histogram summary}`` (the
    ``HealthMonitor.worker_latency()`` shape — needs ``count`` and ``mean``).
    A straggler verdict needs at least two workers with ``min_items`` each:
    the slowest worker's mean must exceed the MEDIAN of the others' means by
    ``ratio`` (median, not mean, so one straggler cannot drag the baseline up
    with it)."""
    eligible = {k: s for k, s in (worker_latency or {}).items()
                if s.get("count", 0) >= min_items and s.get("mean", 0) > 0}
    if len(eligible) < 2:
        return None
    slowest = max(eligible, key=lambda k: eligible[k]["mean"])
    peers = sorted(eligible[k]["mean"] for k in eligible if k != slowest)
    peer_median = peers[len(peers) // 2]
    if peer_median <= 0 or eligible[slowest]["mean"] < ratio * peer_median:
        return None
    return {"worker": str(slowest),
            "mean_s": round(eligible[slowest]["mean"], 6),
            "peer_median_s": round(peer_median, 6),
            "ratio": round(eligible[slowest]["mean"] / peer_median, 2),
            "items": eligible[slowest].get("count", 0)}


def analyze_snapshot(snap, percentiles=None, worker_latency=None):
    """Analyze one ``PipelineStats.snapshot()``-shaped dict (shm gauges
    optional) into a :class:`BottleneckReport`. ``worker_latency`` (the
    per-worker histogram summaries a health monitor records) refines a
    producer-bound verdict to ``straggler`` when one worker limits the pack."""
    read_s = snap.get("read_s", 0.0)
    batch_s = snap.get("batch_s", 0.0)
    put_wait_s = snap.get("put_wait_s", 0.0)
    decode_s = snap.get("decode_s", 0.0)
    h2d_s = snap.get("h2d_s", 0.0)
    # the port's compressed-page inflate stage runs on the transfer side too
    inflate_s = snap.get("inflate_s", 0.0)
    queue_wait_s = snap.get("queue_wait_s", 0.0)
    wire_wait_s = snap.get("shm_acquire_wait_s", 0.0)

    detail = {
        "read_s": round(read_s, 4), "batch_s": round(batch_s, 4),
        "put_wait_s": round(put_wait_s, 4), "decode_s": round(decode_s, 4),
        "h2d_s": round(h2d_s, 4), "inflate_s": round(inflate_s, 4),
        "queue_wait_s": round(queue_wait_s, 4),
        "device_queue_wait_s": round(snap.get("device_queue_wait_s", 0.0), 4),
        "shm_acquire_wait_s": round(wire_wait_s, 4),
        "shm_fallbacks": snap.get("shm_fallbacks", 0),
        "batches": snap.get("batches", 0),
    }

    producer_work = read_s + batch_s
    producer_total = producer_work + put_wait_s
    consumer_work = decode_s + h2d_s + inflate_s
    consumer_total = consumer_work + queue_wait_s
    # below ~20ms of total measured stage time the fractions are scheduler
    # noise, not a pipeline shape — refuse to name a bottleneck
    if snap.get("batches", 0) == 0 or (producer_total + consumer_total) < 0.02:
        return BottleneckReport(
            verdict="idle", utilization={},
            detail=detail, reason="not enough measured stage time to judge",
            percentiles=percentiles)

    producer_util = producer_work / producer_total if producer_total else 0.0
    consumer_util = consumer_work / consumer_total if consumer_total else 0.0
    utilization = {"producer": round(producer_util, 4),
                   "consumer": round(consumer_util, 4)}

    if producer_util >= consumer_util + _MARGIN:
        # the producer side limits; is it the readers or the shm wire that
        # reader time is actually spent in?
        if read_s > 0 and wire_wait_s >= _WIRE_SHARE * read_s:
            return BottleneckReport(
                "wire-bound", utilization, detail,
                "reader time is dominated by waiting for free shm slabs "
                "(%.3fs slab wait vs %.3fs read) — grow the ring or release "
                "batches sooner" % (wire_wait_s, read_s), percentiles)
        straggler = detect_straggler(worker_latency)
        if straggler is not None:
            return BottleneckReport(
                "straggler", utilization, detail,
                "the reader side is limited by ONE slow worker: worker %s "
                "averages %.1fms per item vs a %.1fms peer median (%.1fx) — "
                "check its host/shard, or rely on work stealing"
                % (straggler["worker"], straggler["mean_s"] * 1e3,
                   straggler["peer_median_s"] * 1e3, straggler["ratio"]),
                percentiles, straggler=straggler)
        return BottleneckReport(
            "producer-bound", utilization, detail,
            "the reader side is saturated (%.0f%% busy) while the consumer "
            "side starves %.3fs on an empty host queue"
            % (100 * producer_util, queue_wait_s), percentiles)
    if consumer_util >= producer_util + _MARGIN:
        return BottleneckReport(
            "consumer-bound", utilization, detail,
            "the decode/transfer/step side is saturated (%.0f%% busy) while "
            "the producer blocks %.3fs on a full host queue"
            % (100 * consumer_util, put_wait_s), percentiles)
    return BottleneckReport(
        "balanced", utilization, detail,
        "no stage dominates (producer %.0f%% vs consumer %.0f%% busy)"
        % (100 * producer_util, 100 * consumer_util), percentiles)


def analyze_loader(loader):
    """:func:`analyze_snapshot` over a live ``DataLoader``: the implementation behind
    ``DataLoader.bottleneck_report()`` (stage percentiles attached when the loader was
    built with ``metrics=``; per-worker straggler detection when it was built with
    ``health=``; the SLO engine's alerts when it was built with ``slos=``)."""
    snap = loader.stats.snapshot()
    percentiles = None
    obs = getattr(loader, "_obs", None)
    if obs is not None:
        percentiles = {}
        for stage, hist in obs.stage_histograms().items():
            s = hist.snapshot()
            percentiles[stage] = {"p50": s["p50"], "p90": s["p90"],
                                  "p99": s["p99"]}
    # the SCOPE, not the monitor: on a shared monitor the straggler detector compares
    # peers within this pipeline's pool only
    scope = getattr(loader, "_health_scope", None)
    worker_latency = scope.worker_latency() if scope is not None else None
    report = analyze_snapshot(snap, percentiles=percentiles,
                              worker_latency=worker_latency)
    # declarative-transform visibility: per-fused-op timings from
    # the process-wide registry — live for thread/dummy pools, where the
    # transform runs in this process (pool children keep their own registries)
    from petastorm_tpu_torch.ops.tabular import transform_op_stats

    ops = transform_op_stats()
    if ops:
        report.transform_ops = ops
    # the time-series plane: recent debounced alerts ride on the verdict, so one report
    # shows both the steady-state shape and any burn a window crossed
    engine = getattr(loader, "_slo_engine", None)
    if engine is not None:
        alerts = engine.alerts()
        if alerts:
            report.slo_alerts = [
                {"name": a.name, "cause": a.cause, "t": a.t, "value": a.value,
                 "culprit": a.culprit, "message": a.message}
                for a in alerts]
    return report
