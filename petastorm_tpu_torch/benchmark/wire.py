"""Process-pool WIRE micro-benchmark: socket-pickle vs socket-arrow vs shm slabs.

Measures exactly the transport hop the shared-memory ring was built to remove
(docs/performance.md): a pool child produces a tagged columnar payload of a given
size, the parent consumes it through the configured wire, and the score is
consumer-side payload MB/s. The payload copy counts per wire are structural, not
measured:

====================  =======================================================
wire                  full-payload copies (child serialize → usable batch)
====================  =======================================================
pickle / arrow        3 — socket send (kernel), ``recv_bytes`` allocation,
                      writable-contract copy of the read-only reconstruction
shm / shm-arrow       2 — child's write into the slab, writable-contract copy
shm-view variants     1 — child's write into the slab (batches are delivered
                      as read-only zero-copy slab views)
====================  =======================================================

Run it as ``petastorm-tpu-torch-bench wire`` (or ``python -m petastorm_tpu_torch.benchmark.cli
wire``); ``--check`` adds correctness assertions on every received payload, and
``--smoke`` is the CI preset — tiny payloads, every wire, correctness only, no
throughput claims (CI machines share cores; the MB/s column is still printed for
the curious). A perf run wants ≥1 MB payloads: below that the per-item socket
round-trip dominates and every wire measures the same dispatch overhead.

Port of ``petastorm_tpu.benchmark.wire``. Every run measures over both of the pool's
links, and each row names its link: ``pipe``, then ``tcp``, the framed loopback
transport, which carries every payload over its socket and so measures only the socket
wires, ``pickle`` and ``arrow``. A row whose pool found no
shared memory reports ``shm_unavailable``: its shm columns then measured the socket
fallback. ``--device`` is checked like every harness's, though no loader runs here.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from petastorm_tpu_torch.benchmark import add_device_argument, require_device
from petastorm_tpu_torch.io.lease import LEASE_KEY

#: structural full-payload copy counts per wire (see module docstring)
WIRE_COPIES = {
    "pickle": 3,
    "arrow": 3,
    "shm": 2,
    "shm-pickle": 2,
    "shm-arrow": 2,
    "shm-view": 1,
    "shm-pickle-view": 1,
    "shm-arrow-view": 1,
}

DEFAULT_WIRES = ("pickle", "arrow", "shm", "shm-arrow")

#: the pool links a row may run over (``None`` in the executor is the pipe)
TRANSPORTS = ("pipe", "tcp")
#: the tcp link bypasses the shared-memory slabs (its frames carry the payload), so
#: only the socket wires are measured over it
TCP_WIRES = ("pickle", "arrow")


class _PayloadWorker:
    """Pool worker producing one tagged columnar payload of ``nbytes`` (picklable;
    runs in the clean child interpreters). The fill is a cheap deterministic
    function of the item index so ``--check`` can verify every byte arrived."""

    def __call__(self, item):
        nbytes, idx = item
        return (0, idx, {"x": np.full((nbytes,), idx % 251, np.uint8)})


def expected_payload(nbytes, idx):
    return np.full((nbytes,), idx % 251, np.uint8)


def _measure_one(wire, nbytes, items, workers, warmup, check, timeout_s,
                 slab_bytes=None, transport="pipe"):
    from petastorm_tpu_torch.plan import EpochPlan
    from petastorm_tpu_torch.workers import ProcessExecutor

    plan = EpochPlan([(nbytes, i) for i in range(warmup + items)], num_epochs=1)
    seen = 0
    with ProcessExecutor(workers_count=workers, results_queue_size=4,
                         results_timeout_s=timeout_s, serializer=wire,
                         shm_slab_bytes=slab_bytes,
                         transport=None if transport == "pipe" else transport) as ex:
        ex.start(_PayloadWorker(), plan)
        t0 = time.perf_counter() if warmup == 0 else None
        for _epoch, idx, columns in ex.results():
            lease = columns.pop(LEASE_KEY, None)
            if check:
                np.testing.assert_array_equal(columns["x"],
                                              expected_payload(nbytes, idx))
            elif columns["x"].nbytes != nbytes:
                raise AssertionError("payload size mismatch on wire %r" % wire)
            if lease is not None:
                lease.release()  # view wire: hand the slab back promptly
            seen += 1
            if seen == warmup:
                t0 = time.perf_counter()
        elapsed = time.perf_counter() - (t0 if t0 is not None else time.perf_counter())
        wire_stats = ex.wire_stats()
    if seen != warmup + items:
        raise AssertionError("wire %r delivered %d of %d items"
                             % (wire, seen, warmup + items))
    measured = seen - warmup
    return {
        "wire": wire,
        "transport": transport,
        "payload_mb": round(nbytes / 1e6, 3),
        "items": measured,
        "seconds": round(elapsed, 4),
        "mb_s": round(measured * nbytes / 1e6 / elapsed, 1) if elapsed > 0 else None,
        "items_s": round(measured / elapsed, 1) if elapsed > 0 else None,
        "payload_copies": WIRE_COPIES[wire],
        "shm_fallbacks": wire_stats.get("shm_fallbacks", 0),
        "shm_unavailable": bool(wire_stats.get("shm_unavailable", 0)),
        "checked": bool(check),
    }


def run_wire_bench(sizes, items=32, wires=DEFAULT_WIRES, workers=2, warmup=4,
                   check=False, timeout_s=120.0, slab_bytes=None):
    """One row dict per (transport, wire, size), over every link of
    :data:`TRANSPORTS`: MB/s, items/s, structural copy count, and the shm
    fallback/degradation gauges. Sizes are payload bytes. Over ``tcp`` only the
    socket wires of ``wires`` run (:data:`TCP_WIRES`)."""
    rows = []
    for transport in TRANSPORTS:
        for nbytes in sizes:
            for wire in wires:
                if transport == "tcp" and wire not in TCP_WIRES:
                    continue
                rows.append(_measure_one(wire, int(nbytes), items, workers, warmup,
                                         check, timeout_s, slab_bytes=slab_bytes,
                                         transport=transport))
    return rows


def _format_table(rows):
    header = ("transport", "wire", "payload_mb", "mb_s", "items_s", "payload_copies",
              "shm_fallbacks")
    widths = [max(len(h), *(len(str(r[h])) for r in rows)) for h in header]
    lines = ["  ".join(h.ljust(w) for h, w in zip(header, widths))]
    for r in rows:
        lines.append("  ".join(str(r[h]).ljust(w) for h, w in zip(header, widths)))
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-bench wire", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--sizes-mb", type=float, nargs="*", default=[0.25, 1.0, 8.0],
                        help="payload sizes in MB (default: 0.25 1 8)")
    parser.add_argument("--items", type=int, default=32,
                        help="measured items per (wire, size)")
    parser.add_argument("--warmup", type=int, default=4,
                        help="untimed leading items (pool spawn, first-touch)")
    parser.add_argument("--wires", nargs="*", default=list(DEFAULT_WIRES),
                        choices=sorted(WIRE_COPIES),
                        help="wire formats to measure")
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--slab-mb", type=float, default=None,
                        help="override slab size (MB) for the shm wires")
    parser.add_argument("--check", action="store_true",
                        help="assert every received payload byte-exact")
    parser.add_argument("--json", action="store_true", help="JSON lines output")
    parser.add_argument("--smoke", action="store_true",
                        help="CI preset: tiny payloads, all wires incl. view "
                             "variants, --check, correctness-only")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    require_device(args.device)

    if args.smoke:
        sizes = [64 << 10]
        wires = ["pickle", "arrow", "shm", "shm-arrow", "shm-view",
                 "shm-arrow-view"]
        items, warmup, check = 6, 2, True
    else:
        sizes = [int(mb * 1e6) for mb in args.sizes_mb]
        wires = args.wires
        items, warmup, check = args.items, args.warmup, args.check

    rows = run_wire_bench(sizes, items=items, wires=wires, workers=args.workers,
                          warmup=warmup, check=check,
                          slab_bytes=int(args.slab_mb * 1e6) if args.slab_mb else None)
    if args.json:
        for r in rows:
            print(json.dumps(r))
    else:
        print(_format_table(rows))
    degraded = [r for r in rows if r["shm_unavailable"]]
    if degraded:
        print("note: shared memory unavailable on this platform — shm rows "
              "measured the socket fallback", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
