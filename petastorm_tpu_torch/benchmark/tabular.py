"""Tabular-preprocessing micro-benchmark: declarative pipeline vs pandas callable.

Measures exactly what the declarative pipeline replaced: the opaque per-batch pandas
``TransformSpec`` forces an Arrow→pandas→Arrow round trip, a writable payload
copy, and per-element python work for ops pandas has no vectorized primitive
for (hashing, crossing). The declarative
:class:`~petastorm_tpu_torch.ops.tabular.FeaturePipeline` compiles the SAME feature
math to fused vectorized numpy kernels that run columnar in the workers.

Each scenario drives the REAL pipeline (``make_batch_reader`` +
``DataLoader``, host delivery) over a synthetic multi-column feature workload
(8 float features standardized/normalized/clipped/cast, a hashed id, a
quantile bucketize, a vocabulary lookup, and a 2-column feature cross):

====================  ====================================================
scenario              configuration
====================  ====================================================
pandas-dummy          ``TransformSpec(pandas_twin)`` — the equivalent
                      per-batch pandas callable (vectorized Series ops
                      where pandas has them, per-element ``apply``-style
                      work for hash/cross), dummy pool — the timing twin
declarative-dummy     the ``FeaturePipeline``, dummy pool — timing +
                      value-identity vs the pandas twin
declarative-thread    the same pipeline on a thread pool (identity)
declarative-process   the same pipeline on a process pool with the
                      ``shm-view`` lease wire (identity + census)
====================  ====================================================

``--check`` asserts every declarative scenario delivers **value-identical**
batches to the pandas twin (elementwise, compared as sorted-by-id per-column
CRCs — pool arrival order is not deterministic), that
``ptpu_lease_leaked_total`` moved by 0, and that the declarative scenarios
charged ZERO bytes to the ``loader_detach`` and ``wire_writable`` census
sites (the whole-batch writable copy the opaque callable forces is gone).
``--smoke`` is the CI preset: tiny dataset, all checks, plus the hard
assertion that the fused-vectorized path delivers **≥ 2× rows/s** over the
pandas twin (the per-batch pandas overhead is deterministic work, so the
ratio is stable even on shared CI cores).

The last line of output is a one-line JSON summary (``tabular_summary``).
Run as ``petastorm-tpu-torch-bench tabular`` (or
``python -m petastorm_tpu_torch.benchmark.tabular``). Port of
``petastorm_tpu.benchmark.tabular``: the loaders take ``--device`` (default ``cuda``) and
deliver host batches, as in the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import zlib

import numpy as np

from petastorm_tpu_torch.benchmark import add_device_argument, require_device

SCENARIOS = ("pandas-dummy", "declarative-dummy", "declarative-thread",
             "declarative-process")

_FLOAT_COLS = 8
_VOCAB = list(range(50))

#: fixed feature-statistics constants shared by both paths (explicit
#: parameters: the statistics tiers are exercised by tests, not timed here)
_MEANS = [0.5 * (k + 1) for k in range(4)]
_STDS = [1.0 + 0.25 * k for k in range(4)]
_MIN, _MAX = 0.0, 64.0
_BOUNDS = np.linspace(-2.0, 2.0, 15)


def make_dataset(root, rows, rows_per_group, files=2):
    """Synthetic recommender-ish feature store: 8 float features, a wide id to
    hash, a small-cardinality category, and a second id to cross — all
    deterministic per row id so identity checks compare exact values."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    per_file = max(rows_per_group, rows // files)
    written = 0
    index = 0
    while written < rows:
        n = min(per_file, rows - written)
        ids = np.arange(written, written + n, dtype=np.int64)
        cols = {"id": ids}
        for k in range(_FLOAT_COLS):
            cols["f%d" % k] = np.sin(ids.astype(np.float64) * (k + 1) * 0.1) \
                * 2.0 + k * 0.5
        cols["u0"] = (ids * 2654435761) % 1000003  # wide id to hash
        cols["c0"] = ids % len(_VOCAB)             # vocab category
        cols["u1"] = ids % 97                      # cross partner
        pq.write_table(pa.table(cols),
                       os.path.join(root, "part-%05d.parquet" % index),
                       row_group_size=rows_per_group)
        written += n
        index += 1
    return root


def build_pipeline():
    """The declarative side of the workload."""
    from petastorm_tpu_torch.ops.tabular import (
        Bucketize,
        Cast,
        Clip,
        FeatureCross,
        HashField,
        Normalize,
        Standardize,
        VocabLookup,
    )

    ops = []
    for k in range(4):
        ops.append(Standardize("f%d" % k, mean=_MEANS[k], std=_STDS[k]))
    for k in (4, 5):
        ops.append(Normalize("f%d" % k, min=_MIN, max=_MAX))
        ops.append(Clip("f%d" % k, 0.0, 1.0))
    for k in (6, 7):
        ops.append(Cast("f%d" % k, np.float32))
    ops.append(Bucketize("f0", boundaries=_BOUNDS, out="f0b"))
    ops.append(HashField("u0", 1000, out="u0h"))
    ops.append(VocabLookup("c0", vocab=_VOCAB, out="c0v"))
    ops.append(FeatureCross(("u0", "u1"), 4096, out="x01"))
    from petastorm_tpu_torch.ops.tabular import FeaturePipeline

    return FeaturePipeline(ops)


def _fnv32_scalar(value, seed=0):
    """Pure-python twin of the vectorized 32-bit hash (what a pandas user
    writes per element — pandas has no wrapping-uint32 hash primitive)."""
    h = (2166136261 ^ seed) & 0xFFFFFFFF
    v = int(value) & 0xFFFFFFFFFFFFFFFF
    for shift in (0, 8, 16, 24):
        h = ((h ^ ((v >> shift) & 0xFF)) * 16777619) & 0xFFFFFFFF
    return h


def pandas_twin(df):
    """The equivalent per-batch pandas callable: identical values, idiomatic
    pandas — vectorized Series arithmetic where pandas has it, per-element
    python for the hash/cross ops it does not."""
    for k in range(4):
        df["f%d" % k] = (df["f%d" % k].astype(np.float32)
                         - np.float32(_MEANS[k])) * np.float32(1.0 / _STDS[k])
    scale = np.float32(1.0 / (_MAX - _MIN))
    for k in (4, 5):
        df["f%d" % k] = ((df["f%d" % k].astype(np.float32) - np.float32(_MIN))
                         * scale).clip(0.0, 1.0)
    for k in (6, 7):
        df["f%d" % k] = df["f%d" % k].astype(np.float32)
    df["f0b"] = np.searchsorted(
        _BOUNDS, df["f0"].to_numpy().astype(np.float64),
        side="right").astype(np.int32)
    df["u0h"] = df["u0"].map(
        lambda v: _fnv32_scalar(v) % 1000).astype(np.int64)
    df["c0v"] = df["c0"].map({v: i for i, v in enumerate(_VOCAB)}) \
        .fillna(-1).astype(np.int64)
    df["x01"] = [((_fnv32_scalar(a) * 16777619) & 0xFFFFFFFF
                  ^ _fnv32_scalar(b)) % 4096
                 for a, b in zip(df["u0"], df["u1"])]
    df["x01"] = df["x01"].astype(np.int64)
    return df


def build_pandas_spec():
    from petastorm_tpu_torch.transform import TransformSpec

    edits = [("f%d" % k, np.float32, (), False) for k in range(_FLOAT_COLS)]
    edits += [("f0b", np.int32, (), False), ("u0h", np.int64, (), False),
              ("c0v", np.int64, (), False), ("x01", np.int64, (), False)]
    return TransformSpec(pandas_twin, edit_fields=edits)


def _batch_record(batch):
    """Sorted-by-id per-column CRCs — the identity unit (pool arrival order
    and in-batch row order both vary across pool types)."""
    ids = np.asarray(batch["id"])
    order = np.argsort(ids, kind="stable")
    crcs = [("id", zlib.crc32(np.ascontiguousarray(ids[order]).tobytes()))]
    for name in sorted(batch):
        v = batch[name]
        if name != "id" and isinstance(v, np.ndarray) and v.dtype != object:
            crcs.append(
                (name, str(v.dtype),
                 zlib.crc32(np.ascontiguousarray(np.asarray(v)[order])
                            .tobytes())))
    return int(ids.min()), crcs


def _census_delta(before):
    from petastorm_tpu_torch.io.lease import copy_census

    after = copy_census()
    return {site: after.get(site, 0) - before.get(site, 0)
            for site in set(after) | set(before)
            if after.get(site, 0) != before.get(site, 0)}


def _measure(scenario, root, batch_size, workers, check, device=None):
    from petastorm_tpu_torch.io.lease import copy_census, lease_stats
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.reader import make_batch_reader

    kind, _, pool = scenario.partition("-")
    spec = build_pandas_spec() if kind == "pandas" else build_pipeline()
    kwargs = {"reader_pool_type": pool, "shuffle_row_groups": False,
              "num_epochs": 1, "transform_spec": spec}
    if pool == "process":
        kwargs.update(workers_count=workers, wire_serializer="shm-view")
    elif pool == "thread":
        kwargs.update(workers_count=workers)
    before = copy_census()
    leases_before = lease_stats()
    t0 = time.perf_counter()
    with make_batch_reader("file://" + root, **kwargs) as reader:
        with DataLoader(reader, batch_size=batch_size, to_device=False,
                        last_batch="drop", device=device) as loader:
            batches = 0
            rows = 0
            records = []
            for batch in loader:
                batches += 1
                rows += len(batch["id"])
                if check:
                    records.append(_batch_record(batch))
    elapsed = time.perf_counter() - t0
    census = _census_delta(before)
    leases = lease_stats()
    row = {
        "scenario": scenario,
        "batches": batches,
        "rows": rows,
        "seconds": round(elapsed, 4),
        "rows_s": round(rows / elapsed, 1) if elapsed > 0 else None,
        "census": {k: census[k] for k in sorted(census)},
        "leases_leaked": leases["leaked"] - leases_before["leaked"],
    }
    return row, records


def run_tabular_bench(rows=16384, rows_per_group=256, batch_size=256, files=2,
                      workers=2, scenarios=SCENARIOS, check=False, root=None,
                      device=None):
    """One result row per scenario. With ``check``, every declarative scenario
    must deliver value-identical batches to the pandas twin, leak no leases,
    and charge zero ``loader_detach``/``wire_writable`` census bytes."""
    if rows_per_group % batch_size:
        raise ValueError("rows_per_group must be a multiple of batch_size so "
                         "all paths cut identical batch boundaries")
    tmp = None
    if root is None:
        tmp = tempfile.TemporaryDirectory(prefix="ptpu-tabular-bench-")
        root = tmp.name
    try:
        make_dataset(root, rows, rows_per_group, files=files)
        results = []
        baseline = None
        for scenario in scenarios:
            row, records = _measure(scenario, root, batch_size, workers, check,
                                    device=device)
            if check:
                if row["leases_leaked"]:
                    raise AssertionError(
                        "scenario %r leaked %d lease(s)"
                        % (scenario, row["leases_leaked"]))
                if scenario.startswith("declarative"):
                    for site in ("loader_detach", "wire_writable"):
                        if row["census"].get(site):
                            raise AssertionError(
                                "declarative scenario %r charged %d bytes to "
                                "census site %r — the writable-batch copy is "
                                "supposed to be gone"
                                % (scenario, row["census"][site], site))
                    if baseline is None:
                        raise ValueError(
                            "--check needs pandas-dummy before declarative "
                            "scenarios as the identity baseline")
                    if sorted(records) != sorted(baseline):
                        raise AssertionError(
                            "scenario %r delivered different values than the "
                            "pandas twin" % scenario)
                    row["identical_to_pandas"] = True
                else:
                    baseline = records
            results.append(row)
        return results
    finally:
        if tmp is not None:
            tmp.cleanup()


def string_hash_bench(rows=200000, reps=3, check=True):
    """The string-hash micro-bench: the vectorized byte-matrix crc32
    (:func:`petastorm_tpu_torch.ops.tabular._hash_strings_matrix` behind
    ``_hash_strings_host``) vs the per-element ``zlib.crc32`` loop it
    replaced as the default lane, on the hot tabular string shapes
    (short-uniform ids, categorical codes, emails). With ``check`` the two
    lanes must be bit-identical on every shape — the dispatch is invisible
    to pipelines. Each lane's time is its fastest of ``reps`` runs, the two
    lanes alternating."""
    from petastorm_tpu_torch.ops.tabular import (_hash_strings_host,
                                           _hash_strings_scalar)

    shapes = {
        "ids": ["u%08d" % i for i in range(rows)],
        "categories": ["cat-%03d" % (i % 512) for i in range(rows)],
        "emails": ["user-%d@example.com" % i for i in range(rows)],
    }
    out = []
    for name, data in shapes.items():
        if check:
            a = _hash_strings_host(data)
            b = _hash_strings_scalar(data)
            if a.dtype != np.uint32 or not (a == b).all():
                raise AssertionError(
                    "vectorized string hash diverged from zlib.crc32 on %r"
                    % name)
        # the lanes alternate rep by rep and each keeps its fastest rep: a burst of
        # host load (a pool still winding down, a neighbour) lands on both lanes
        # alike instead of on whichever ran first, and only ever adds time
        vec_s = loop_s = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            _hash_strings_host(data)
            t1 = time.perf_counter()
            _hash_strings_scalar(data)
            t2 = time.perf_counter()
            vec_s, loop_s = min(vec_s, t1 - t0), min(loop_s, t2 - t1)
        out.append({"shape": name, "rows": len(data),
                    "vectorized_s": round(vec_s, 4),
                    "scalar_loop_s": round(loop_s, 4),
                    "speedup": round(loop_s / vec_s, 2) if vec_s else None,
                    "identical": bool(check)})
    return out


def summarize(results):
    by_name = {r["scenario"]: r for r in results}
    summary = {"tabular_summary": True}
    pandas_row = by_name.get("pandas-dummy")
    decl = by_name.get("declarative-dummy")
    if pandas_row and decl and pandas_row.get("rows_s") and decl.get("rows_s"):
        summary["pandas_rows_s"] = pandas_row["rows_s"]
        summary["declarative_rows_s"] = decl["rows_s"]
        summary["speedup"] = round(decl["rows_s"] / pandas_row["rows_s"], 2)
    for name, row in by_name.items():
        if name.startswith("declarative"):
            summary.setdefault("census", {})[name] = row["census"]
    summary["leases_leaked"] = sum(r["leases_leaked"] for r in results)
    return summary


def _format_table(rows):
    cols = ("scenario", "batches", "rows", "seconds", "rows_s",
            "leases_leaked")
    widths = [max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in cols]
    lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths))]
    for r in rows:
        lines.append("  ".join(str(r.get(c, "")).ljust(w)
                               for c, w in zip(cols, widths)))
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-bench tabular", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rows", type=int, default=16384)
    parser.add_argument("--rows-per-group", type=int, default=256)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--files", type=int, default=2)
    parser.add_argument("--workers", type=int, default=2,
                        help="thread/process-pool workers")
    parser.add_argument("--scenarios", nargs="*", default=list(SCENARIOS),
                        choices=SCENARIOS)
    parser.add_argument("--check", action="store_true",
                        help="assert declarative scenarios deliver "
                             "value-identical batches to the pandas twin, "
                             "leak nothing, and copy nothing on the "
                             "loader_detach/wire_writable census sites")
    parser.add_argument("--json", action="store_true", help="JSON lines output")
    parser.add_argument("--smoke", action="store_true",
                        help="CI preset: tiny dataset, --check, plus the hard "
                             "assertion that the declarative path is >= 2x "
                             "the pandas twin's rows/s")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = require_device(args.device)

    if args.smoke:
        kwargs = dict(rows=4096, rows_per_group=128, batch_size=128, files=2,
                      workers=2, scenarios=SCENARIOS, check=True)
    else:
        kwargs = dict(rows=args.rows, rows_per_group=args.rows_per_group,
                      batch_size=args.batch_size, files=args.files,
                      workers=args.workers, scenarios=tuple(args.scenarios),
                      check=args.check)

    results = run_tabular_bench(**kwargs, device=device)
    if args.json:
        for r in results:
            print(json.dumps(r))
    else:
        print(_format_table(results))
    summary = summarize(results)
    # string-hash micro-bench: identity always asserted; the timing
    # is informational off-smoke and a soft floor on smoke (the vectorized
    # lane must not LOSE to the loop it replaced on its target shapes)
    hash_rows = string_hash_bench(rows=20000 if args.smoke else 200000,
                                  reps=5, check=True)
    summary["string_hash"] = hash_rows
    for r in hash_rows:
        print("string-hash %-10s %d rows: vectorized %.4fs vs loop %.4fs "
              "(%.2fx, bit-identical)" % (r["shape"], r["rows"],
                                          r["vectorized_s"],
                                          r["scalar_loop_s"], r["speedup"]))
    if args.smoke:
        assert summary.get("speedup") and summary["speedup"] >= 2.0, \
            "declarative path is not >= 2x the pandas twin: %r" % summary
        assert summary["leases_leaked"] == 0, summary
        slow = [r for r in hash_rows if r["speedup"] is not None
                and r["speedup"] < 0.8]
        assert not slow, ("vectorized string hash regressed below the scalar "
                          "loop on: %r" % slow)
    if kwargs["check"]:
        print("identity: declarative scenarios delivered value-identical "
              "batches to the pandas twin")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
