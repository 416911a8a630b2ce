"""Dataset-statistics resolution for declarative pipelines.

Port of ``petastorm_tpu.io.statscache``. Statistics-dependent ops (``Normalize``
without bounds, ``Standardize``, quantile ``Bucketize``, computed ``VocabLookup``) need
dataset-level numbers before the pipeline can compile. Resolution is tiered, cheapest
first:

1. **Row-group statistics**: min/max aggregate from the parquet footers via
   :func:`petastorm_tpu_torch.metadata.aggregate_column_stats` (zero data reads). Only
   exact aggregates ride this tier: mean/std/quantiles/vocab cannot.
2. **One streaming data pre-pass**: needed columns of every scheduled row group are
   read once, feeding per-column accumulators (count/sum/sumsq for mean/std, a
   deterministic stride-decimated sample for quantiles, a frequency table for
   vocabularies).
3. **Cache**: the pass result is memoized per ``(dataset fingerprint, requirement
   set)`` in a process-wide table, and written through the reader's tiered cache when
   one is given (``cache``; the port has no tiered cache yet, ROADMAP.md Queue 1 item 5,
   so its readers pass ``None``).

``resolve_statistics`` returns ``{requirement key: value}`` plus a ``sources`` ledger
(``rowgroup-stats`` / ``data-pass`` / ``cached``) the pipeline surfaces as
``FeaturePipeline.stats_info``.
"""
from __future__ import annotations

import hashlib
import threading

import numpy as np

#: cap on the deterministic quantile sample per column (stride-decimated: when the
#: stream exceeds the cap, every other retained sample is dropped and the stride
#: doubles, so the kept set stays uniform and run-deterministic)
QUANTILE_SAMPLE_CAP = 65536

#: distinct values tracked per vocabulary column before low-frequency entries are pruned
#: (bound on the frequency table, not on the final vocab)
VOCAB_TRACK_CAP = 1 << 16

_memo_lock = threading.Lock()
_memo = {}  # fingerprint -> {req key: value}


def dataset_fingerprint(fs, pieces, req_keys):
    """Stable identity of (scheduled data, requested statistics): the sorted
    ``(path, row_group, num_rows, generation)`` piece set, each file's size/mtime (so a
    dataset regenerated in place invalidates the cached pass), plus the requirement
    keys. A piece without a generation token (a reader that does not watch the
    dataset) counts it as empty. Two readers over the same pieces share one pass."""
    h = hashlib.sha256()
    for p in sorted((p.path, p.row_group, p.num_rows,
                     getattr(p, "generation", None) or "") for p in pieces):
        h.update(repr(p).encode("utf-8"))
    for path in sorted({p.path for p in pieces}):
        try:
            info = fs.get_file_info(path)
            token = "%s|%s|%s" % (path, getattr(info, "size", None),
                                  getattr(info, "mtime_ns", None))
        except Exception:  # noqa: BLE001 — stat failure: path-only identity
            token = path
        h.update(token.encode("utf-8"))
    for key in sorted(req_keys):
        h.update(key.encode("utf-8"))
    return h.hexdigest()


def clear_memo():
    """Drop the in-process pass memo (test isolation)."""
    with _memo_lock:
        _memo.clear()


class _ColumnAccumulator:
    """Streaming accumulators for every pass-tier statistic of one column."""

    def __init__(self, want_moments, want_quantiles, want_vocab):
        self.want_moments = want_moments
        self.want_quantiles = want_quantiles
        self.want_vocab = want_vocab
        self.count = 0
        self.total = 0.0
        self.sq_total = 0.0
        self.minimum = None
        self.maximum = None
        self.samples = []
        self.stride = 1
        self._stride_phase = 0
        self.freq = {}
        self.freq_floor = 0  # lossy-counting error bound once pruning starts

    def update(self, arr):
        arr = np.asarray(arr)
        if self.want_moments or self.want_quantiles:
            values = arr.astype(np.float64, copy=False).ravel()
            if values.size and np.issubdtype(values.dtype, np.floating):
                values = values[~np.isnan(values)]
            if values.size:
                self.count += int(values.size)
                self.total += float(values.sum())
                self.sq_total += float(np.square(values).sum())
                mn, mx = float(values.min()), float(values.max())
                self.minimum = mn if self.minimum is None else min(self.minimum, mn)
                self.maximum = mx if self.maximum is None else max(self.maximum, mx)
                if self.want_quantiles:
                    self._sample(values)
        if self.want_vocab:
            uniques, counts = np.unique(arr.ravel(), return_counts=True)
            freq = self.freq
            # lossy counting: once pruning has happened, an unseen (or pruned and
            # returned) value re-enters at the error floor, so a frequent value spread
            # across the stream is undercounted by at most freq_floor, never zeroed
            floor = self.freq_floor
            for value, n in zip(uniques.tolist(), counts.tolist()):
                freq[value] = freq.get(value, floor) + n
            if len(freq) > VOCAB_TRACK_CAP:
                ranked = sorted(freq.items(), key=lambda kv: (-kv[1], str(kv[0])))
                cut = ranked[VOCAB_TRACK_CAP // 2:]
                self.freq_floor = max(self.freq_floor, max(c for _v, c in cut))
                self.freq = dict(ranked[:VOCAB_TRACK_CAP // 2])

    def _sample(self, values):
        take = values[self._stride_phase::self.stride]
        self._stride_phase = (self._stride_phase - values.size) % self.stride
        self.samples.extend(take.tolist())
        while len(self.samples) > QUANTILE_SAMPLE_CAP:
            self.samples = self.samples[::2]
            self.stride *= 2

    def moments(self):
        if not self.count:
            raise ValueError("statistics pass saw no values for the column")
        mean = self.total / self.count
        var = max(self.sq_total / self.count - mean * mean, 0.0)
        return mean, float(np.sqrt(var))

    def quantile_boundaries(self, num_buckets):
        if not self.samples:
            raise ValueError("statistics pass saw no values for the column")
        qs = [i / num_buckets for i in range(1, num_buckets)]
        return np.quantile(np.asarray(self.samples, dtype=np.float64), qs)

    def vocabulary(self, max_size):
        ranked = sorted(self.freq.items(), key=lambda kv: (-kv[1], str(kv[0])))
        return [value for value, _n in ranked[:max_size]]


def _column_pass(fs, pieces, accumulators):
    """The streaming pre-pass: read only the accumulated columns of every scheduled row
    group once and feed the accumulators."""
    import pyarrow.parquet as pq

    columns = sorted(accumulators)
    by_path = {}
    for piece in pieces:
        by_path.setdefault(piece.path, set()).add(piece.row_group)
    for path in sorted(by_path):
        with fs.open_input_file(path) as f:
            pf = pq.ParquetFile(f)
            available = set(pf.schema_arrow.names)
            wanted = [c for c in columns if c in available]
            if not wanted:
                continue
            for rg in sorted(by_path[path]):
                table = pf.read_row_group(rg, columns=wanted)
                for name in wanted:
                    accumulators[name].update(
                        table.column(name).to_numpy(zero_copy_only=False))


def _tier_key(fingerprint):
    return "ptpu-tabular-stats|%s" % fingerprint


def resolve_statistics(requirements, fs, pieces, cache=None):
    """Resolve every :class:`~petastorm_tpu_torch.ops.tabular.StatRequirement` into
    ``(stats, sources)``: the value dict the pipeline binds, and the per-key resolution
    ledger. ``cache`` is a tiered cache with ``get(key, fill)`` (optional)."""
    stats = {}
    sources = {}
    remaining = []
    # tier 1: exact min/max from the row-group statistics
    minmax = [r for r in requirements if r.kind in ("min", "max")]
    if minmax:
        from petastorm_tpu_torch.metadata import aggregate_column_stats

        covered = aggregate_column_stats(fs, pieces, sorted({r.field for r in minmax}))
        for req in minmax:
            bounds = covered.get(req.field)
            if bounds is not None:
                stats[req.key] = bounds[0] if req.kind == "min" else bounds[1]
                sources[req.key] = "rowgroup-stats"
            else:
                remaining.append(req)
    remaining.extend(r for r in requirements if r.kind not in ("min", "max"))
    if not remaining:
        return stats, sources

    fingerprint = dataset_fingerprint(fs, pieces, [r.key for r in remaining])
    with _memo_lock:
        memo = _memo.get(fingerprint)
    if memo is not None:
        stats.update(memo)
        for req in remaining:
            sources[req.key] = "cached"
        return stats, sources

    def run_pass():
        accumulators = {}
        for req in remaining:
            acc = accumulators.get(req.field)
            if acc is None:
                acc = accumulators[req.field] = _ColumnAccumulator(False, False, False)
            if req.kind in ("min", "max", "mean", "std"):
                acc.want_moments = True
            if req.kind == "quantiles":
                acc.want_quantiles = True
            if req.kind == "vocab":
                acc.want_vocab = True
        _column_pass(fs, pieces, accumulators)
        out = {}
        for req in remaining:
            acc = accumulators[req.field]
            if req.kind == "min":
                if acc.minimum is None:
                    raise ValueError("statistics pass saw no values for %r" % req.field)
                out[req.key] = acc.minimum
            elif req.kind == "max":
                if acc.maximum is None:
                    raise ValueError("statistics pass saw no values for %r" % req.field)
                out[req.key] = acc.maximum
            elif req.kind == "mean":
                out[req.key] = acc.moments()[0]
            elif req.kind == "std":
                out[req.key] = acc.moments()[1]
            elif req.kind == "quantiles":
                out[req.key] = acc.quantile_boundaries(int(req.param))
            elif req.kind == "vocab":
                out[req.key] = acc.vocabulary(int(req.param))
        return out

    passed = [False]
    pass_result = {}  # survives a cache.get that throws after fill ran

    def fill():
        passed[0] = True
        pass_result["payload"] = run_pass()
        return {"payload": pass_result["payload"]}

    if cache is not None:
        try:
            value = cache.get(_tier_key(fingerprint), fill)
            computed = dict(value["payload"])
        except Exception:  # noqa: BLE001 — a cache tier that can't hold this payload
            # shape must not fail the pipeline; keep the pass result if fill already ran
            # (never read the dataset twice), else run it
            computed = pass_result.get("payload")
            if computed is None:
                passed[0] = True
                computed = run_pass()
    else:
        passed[0] = True
        computed = run_pass()
    with _memo_lock:
        _memo[fingerprint] = computed
    source = "data-pass" if passed[0] else "cached"
    stats.update(computed)
    for req in remaining:
        sources[req.key] = source
    return stats, sources
