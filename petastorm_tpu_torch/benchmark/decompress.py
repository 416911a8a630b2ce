"""``petastorm-tpu-torch-bench decompress`` — the compressed-page pass-through
acceptance harness.

Arms:

- ``passthrough``: a snappy-compressed fixed-width store read with
  ``pagedec=on`` through a device-bound ``DataLoader``. Measures the
  device-bound bytes per batch on the pass-through columns (compressed pages
  + page tables, from ``ptpu_pagedec_bytes_compressed_total``) against the
  host-inflate twin's raw array bytes, asserts the ≤60%-of-raw bar, byte
  identity of every delivered batch vs the classic arm (``--check``), and a
  zero ``ptpu_lease_leaked_total`` delta.
- ``classic``: the identical read with ``pagedec=off`` — the identity twin
  and the raw-bytes denominator.
- ``ineligible``: a store with no eligible column (strings + incompressible
  float noise): ``pagedec=on`` must degrade per column to the classic path
  with a single warn-once ``pagedec_ineligible`` degradation and no
  measurable rows/s overhead vs ``pagedec=off`` (asserted at a loose CI
  noise ceiling).

The last line is a one-line JSON document (``"bench": "decompress"``) for
scripts; ``--smoke`` enforces every acceptance bar.

Port of ``petastorm_tpu.benchmark.decompress``. The loader runs on ``--device`` (default
``cuda``): there a pass-through batch is one upload of its compressed pages and one
launch each of the snappy inflate, the run scan and the extract kernel. A delivered
batch is copied to the host only where ``check`` collects it; otherwise its rows are
counted from the tensor's shape.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

from petastorm_tpu_torch.benchmark import add_device_argument, require_device


def _leaked_total():
    from petastorm_tpu_torch.obs.metrics import default_registry

    return default_registry().counter("ptpu_lease_leaked_total").value


def _counter(name):
    from petastorm_tpu_torch.obs.metrics import default_registry

    return default_registry().counter(name).value


def _make_store(root, rows=60_000, row_group_size=5_000, eligible=True,
                seed=7):
    """A deterministic parquet store. ``eligible=True`` writes compressible
    fixed-width columns (the realistic feature-table shape: quantized floats,
    low-cardinality categoricals, monotonic ids); ``eligible=False`` writes
    only shapes the classifier must refuse (strings, float noise)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(root)
    rng = np.random.default_rng(seed)
    n = rows
    if eligible:
        cols = {
            "feat": pa.array(np.repeat(rng.normal(size=-(-n // 64))
                                       .astype(np.float32), 64)[:n]),
            "quant": pa.array((rng.integers(0, 255, size=n) / 8.0)
                              .astype(np.float32)),
            "cat": pa.array(rng.integers(0, 17, size=n).astype(np.int64)),
            "id": pa.array(np.arange(n, dtype=np.int32)),
        }
    else:
        cols = {
            "s": pa.array(["row-%d-%d" % (i, i * 31 % 997) for i in range(n)]),
            "noise": pa.array(rng.normal(size=n)),  # f64 noise: no saving
        }
    pq.write_table(pa.table(cols), os.path.join(root, "part-0.parquet"),
                   compression="snappy", row_group_size=row_group_size)
    return n


def _host(value):
    """A delivered column on the host (a device tensor is copied back)."""
    import numpy as np

    if hasattr(value, "cpu"):
        return value.cpu().numpy()
    return np.asarray(value)


def _drain(url, pagedec, batch_size, check=False, device=None):
    """One epoch through a device-bound loader on ``device``; returns (rows,
    seconds, batches, delivered) — ``delivered`` only collected under
    ``check`` (the only place a batch is copied back to the host)."""
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.reader import make_batch_reader

    delivered = []
    rows = 0
    batches = 0
    with make_batch_reader(url, reader_pool_type="thread", workers_count=1,
                           shuffle_row_groups=False,
                           io_options={"pagedec": pagedec}) as reader:
        with DataLoader(reader, batch_size, to_device=True,
                        last_batch="partial", device=device) as loader:
            t0 = time.perf_counter()
            for b in loader:
                batches += 1
                rows += len(next(iter(b.values())))
                if check:
                    delivered.append({k: _host(v) for k, v in b.items()})
            dt = time.perf_counter() - t0
    return rows, dt, batches, delivered


def run(workdir, batch_size=2048, rows=60_000, check=True, smoke=False,
        device=None):
    failures = []
    url = "file://" + workdir + "/eligible"
    total = _make_store(os.path.join(workdir, "eligible"), rows=rows)

    # classic twin first: identity target + the raw-bytes denominator
    leaked0 = _leaked_total()
    classic_rows, classic_s, classic_batches, classic_batches_data = _drain(
        url, "off", batch_size, check=check, device=device)
    comp0 = _counter("ptpu_pagedec_bytes_compressed_total")
    saved0 = _counter("ptpu_pagedec_bytes_saved_h2d_total")
    pages0 = _counter("ptpu_pagedec_pages_total")
    pt_rows, pt_s, pt_batches, pt_batches_data = _drain(
        url, "on", batch_size, check=check, device=device)
    leak_delta = _leaked_total() - leaked0
    shipped = _counter("ptpu_pagedec_bytes_compressed_total") - comp0
    saved = _counter("ptpu_pagedec_bytes_saved_h2d_total") - saved0
    pages = _counter("ptpu_pagedec_pages_total") - pages0

    if pt_rows != classic_rows:
        failures.append("row counts differ: classic %d vs pass-through %d"
                        % (classic_rows, pt_rows))
    if check:
        if len(classic_batches_data) != len(pt_batches_data):
            failures.append("batch counts differ under --check")
        else:
            for i, (a, b) in enumerate(zip(classic_batches_data,
                                           pt_batches_data)):
                for k in a:
                    # byte identity: the dtype and every byte (a value compare would
                    # pass a widened or sign-flipped zero column)
                    if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape \
                            or a[k].tobytes() != b[k].tobytes():
                        failures.append(
                            "delivered batch %d column %r differs from the "
                            "classic twin" % (i, k))
                        break
                else:
                    continue
                break
    # raw denominator: what the classic path would hand the device for
    # exactly the columns that passed through — shipped + saved IS that raw
    # volume (the saved counter is raw-minus-shipped per column), so columns
    # that declined (e.g. an incompressible id) don't flatter the ratio
    raw_total = shipped + saved
    raw_per_batch = raw_total / max(1, pt_batches)
    shipped_per_batch = shipped / max(1, pt_batches)
    ratio = shipped_per_batch / raw_per_batch if raw_per_batch else None
    if ratio is None:
        failures.append("no raw-bytes denominator measured")
    elif ratio > 0.60:
        failures.append(
            "pass-through device-bound bytes/batch %.0f is %.0f%% of the "
            "raw twin's %.0f — the <=60%% bar failed"
            % (shipped_per_batch, 100 * ratio, raw_per_batch))
    if shipped <= 0 or pages <= 0:
        failures.append("pass-through shipped no pages (did eligibility "
                        "classify the store away?)")
    if leak_delta:
        failures.append("ptpu_lease_leaked_total moved by %d" % leak_delta)

    # ineligible arm: classic fallback, warn-once, no measurable overhead
    inurl = "file://" + workdir + "/ineligible"
    _make_store(os.path.join(workdir, "ineligible"), rows=max(2000, rows // 6),
                eligible=False)
    from petastorm_tpu_torch.obs.log import degradation_counts

    off_rows, off_s, _b, _d = _drain(inurl, "off", batch_size, check=False,
                                     device=device)
    ineligible0 = degradation_counts().get("pagedec_ineligible", 0)
    comp_in0 = _counter("ptpu_pagedec_bytes_compressed_total")
    on_rows, on_s, _b, _d = _drain(inurl, "on", batch_size, check=False,
                                   device=device)
    ineligible_hits = degradation_counts().get("pagedec_ineligible", 0) \
        - ineligible0
    if on_rows != off_rows:
        failures.append("ineligible arm delivered %d rows vs %d classic"
                        % (on_rows, off_rows))
    if _counter("ptpu_pagedec_bytes_compressed_total") != comp_in0:
        failures.append("ineligible arm still shipped compressed pages")
    off_rate = off_rows / off_s if off_s else 0.0
    on_rate = on_rows / on_s if on_s else 0.0
    # loose CI-noise ceiling; the design target is "no measurable overhead"
    if off_rate and on_rate < 0.5 * off_rate:
        failures.append(
            "pagedec=on on an ineligible store ran at %.0f rows/s vs "
            "%.0f classic (>2x overhead — the classifier is not cheap "
            "enough)" % (on_rate, off_rate))

    result = {
        "bench": "decompress",
        "rows": total,
        "classic_rows_s": round(classic_rows / classic_s, 1),
        "passthrough_rows_s": round(pt_rows / pt_s, 1),
        "raw_bytes_per_batch": int(raw_per_batch),
        "shipped_bytes_per_batch": int(shipped_per_batch),
        "h2d_ratio": round(ratio, 4) if ratio is not None else None,
        "bytes_saved_total": int(saved),
        "pages_shipped": int(pages),
        "byte_identity_checked": bool(check),
        "host_inflate_columns": int(
            _counter("ptpu_pagedec_host_inflate_columns_total")),
        "lease_leak_delta": int(leak_delta),
        "ineligible_classic_rows_s": round(off_rate, 1),
        "ineligible_pagedec_rows_s": round(on_rate, 1),
        "ineligible_degradations": int(ineligible_hits),
        "ok": not failures,
        "failures": failures,
    }
    return result, failures


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-bench decompress", description=__doc__)
    parser.add_argument("--rows", type=int, default=60_000)
    parser.add_argument("--batch-size", type=int, default=2048)
    parser.add_argument("--check", action="store_true", default=True,
                        help="assert delivered-batch byte identity vs the "
                             "classic twin (default on)")
    parser.add_argument("--no-check", dest="check", action="store_false")
    parser.add_argument("--smoke", action="store_true",
                        help="CI preset: smaller store, every acceptance bar "
                             "enforced (non-zero exit on failure)")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = require_device(args.device)
    rows = 24_000 if args.smoke else args.rows
    workdir = tempfile.mkdtemp(prefix="ptpu-decompress-")
    try:
        result, failures = run(workdir, batch_size=args.batch_size,
                               rows=rows, check=args.check,
                               smoke=args.smoke, device=device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    ratio = result["h2d_ratio"]
    print("pass-through: %d B/batch shipped vs %d B/batch raw (%s of raw), "
          "%d pages, %.1f MB saved; rows/s classic %.0f vs pass-through %.0f"
          % (result["shipped_bytes_per_batch"], result["raw_bytes_per_batch"],
             ("%.0f%%" % (100 * ratio)) if ratio is not None else "n/a",
             result["pages_shipped"], result["bytes_saved_total"] / 1e6,
             result["classic_rows_s"], result["passthrough_rows_s"]))
    print("ineligible store: classic %.0f rows/s vs pagedec=on %.0f rows/s "
          "(%d pagedec_ineligible degradation(s), all columns classic)"
          % (result["ineligible_classic_rows_s"],
             result["ineligible_pagedec_rows_s"],
             result["ineligible_degradations"]))
    for failure in failures:
        print("FAIL: %s" % failure)
    print(json.dumps(result))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
