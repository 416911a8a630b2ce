"""Throughput CLI (reference petastorm/benchmark/cli.py, console script
``petastorm-throughput``): measure rows/sec of a reader config from the command line.

Port of ``petastorm_tpu.benchmark.cli`` (console scripts ``petastorm-tpu-torch-throughput``
and ``petastorm-tpu-torch-bench``): the same subcommands, flags and checks, plus
``--device`` (default ``cuda``; ``cpu`` runs on the host). Without a CUDA device and
without ``--device cpu`` it raises, as the port's other entry points do."""
from __future__ import annotations

import argparse

from petastorm_tpu_torch.benchmark import add_device_argument, require_device


#: the synthetic step's square operand: a (1024, 1024) bf16 matmul chain, as in the JAX
#: package's ``--overlap-step-ms`` step
_STEP_N = 1024


def _make_synthetic_step(target_ms, device):
    """A device step calibrated to ~``target_ms`` per call on ``device``: a chain of
    ``(1024, 1024)`` bf16 matmuls, each by the all-ones operand scaled by 1/1024 (the
    JAX package's ``(a @ base) * (1/1024)``, with the power-of-two scale folded into
    the operand). The step folds a one-element dependency on the incoming batch so it
    cannot run ahead of the batch's arrival; operators probe "can this pipeline feed a
    step of X ms?" without writing model code.

    On a CUDA device the chain is captured once as a CUDA graph, so a step is ONE host
    launch (a Python loop of launches would make a long step mostly host time, and hold
    the GIL the loader's threads need); its length is calibrated from the CUDA-event
    device time of a captured probe chain (an eager chain's time would count the gaps
    between its launches, about half of it at this size). The batch's element enters
    through a device-to-device ``copy_`` into the graph's static input on the
    consumer's current stream, which the loader has made wait for the batch. A host
    (numpy) batch is indexed on the host. On the CPU the chain is a plain loop,
    calibrated from wall time.

    The returned ``step(batch)`` returns the chain's result (on the card the graph's
    static output, which the next call overwrites) and carries ``matmuls`` (the chain's
    length) and ``device_ms`` (one call's measured time: CUDA events on the card, wall
    time on the CPU)."""
    import time

    import numpy as np
    import torch

    dev = torch.device(device)
    base = torch.full((_STEP_N, _STEP_N), 1.0 / _STEP_N, dtype=torch.bfloat16,
                      device=dev)
    ones = torch.ones_like(base)
    seed = torch.zeros((1,), dtype=torch.bfloat16, device=dev)
    bufs = [torch.empty_like(base), torch.empty_like(base)]

    def chain(n):
        # a0 = 1 + seed * 1e-6, then a_{k+1} = a_k @ base: ping-pong between two
        # buffers so a captured chain allocates nothing
        a = torch.add(ones, seed, alpha=1e-6, out=bufs[0])
        for k in range(n):
            a = torch.matmul(a, base, out=bufs[(k + 1) % 2])
        return a

    def set_seed(batch):
        for v in batch.values():
            if isinstance(v, np.ndarray):
                if v.dtype.kind in "biuf":
                    # host batch (to_device=False paths): index on the HOST; a
                    # device copy here would ship the whole array every step
                    seed.fill_(float(v.ravel()[0]))
                    return
            elif isinstance(v, torch.Tensor) and not v.dtype.is_complex \
                    and v.dtype != torch.bool and v.numel():
                # device tensor: one-element device-to-device copy, no bulk
                # transfer and no host read — the cheap dependency that orders the
                # step after the batch's arrival
                seed.copy_(v.reshape(-1)[:1])
                return

    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        chain(8)  # first-use costs: cuBLAS handle, workspace
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            chain(2)  # warm the capture stream's allocator and cuBLAS state
        stream.wait_stream(side)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)

        def capture(n):
            """``(graph, its output, one replay's device ms)`` for a chain of ``n``."""
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = chain(n)
            graph.replay()  # the first replay uploads the graph
            start.record(stream)
            graph.replay()
            stop.record(stream)
            stop.synchronize()
            return graph, out, start.elapsed_time(stop)

        probe = 256
        _probe_graph, _out, probe_ms = capture(probe)
        n = max(1, int(round(target_ms * probe / max(probe_ms, 1e-6))))
        del _probe_graph, _out
        graph, out, device_ms = capture(n)

        def step(batch):
            set_seed(batch)
            graph.replay()
            return out
    else:
        chain(1)
        t0 = time.perf_counter()
        chain(2)
        per_matmul_ms = (time.perf_counter() - t0) * 1e3 / 2
        n = max(1, int(round(target_ms / max(per_matmul_ms, 1e-6))))
        t0 = time.perf_counter()
        chain(n)
        device_ms = (time.perf_counter() - t0) * 1e3

        def step(batch):
            set_seed(batch)
            return chain(n)

    step.matmuls = n
    step.device_ms = device_ms
    return step


def main(argv=None):
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "wire":
        # `petastorm-tpu-torch-bench wire ...`: the process-pool wire micro-benchmark
        # (socket-pickle vs socket-arrow vs shm slabs) — see benchmark/wire.py
        from petastorm_tpu_torch.benchmark import wire

        return wire.main(argv[1:])
    if argv and argv[0] == "io":
        # `petastorm-tpu-torch-bench io ...`: the async read-path micro-benchmark
        # (cold sequential vs readahead vs readahead+coalesce vs memcache-warm)
        # — see benchmark/io.py
        from petastorm_tpu_torch.benchmark import io as io_bench

        return io_bench.main(argv[1:])
    if argv and argv[0] == "remote":
        # `petastorm-tpu-torch-bench remote ...`: the object-store read-path
        # benchmark under the CloudLatencyFS simulator (footer cache GET cut,
        # request hedging under injected tail, tiered warm-epoch speedup,
        # byte-identity) — see benchmark/remote.py
        from petastorm_tpu_torch.benchmark import remote as remote_bench

        return remote_bench.main(argv[1:])
    if argv and argv[0] == "copies":
        # `petastorm-tpu-torch-bench copies ...`: the copy-census micro-benchmark
        # (copying default path vs the leased path, bytes memcpy'd per
        # delivered batch + byte-identity) — see benchmark/copies.py
        from petastorm_tpu_torch.benchmark import copies as copies_bench

        return copies_bench.main(argv[1:])
    if argv and argv[0] == "tabular":
        # `petastorm-tpu-torch-bench tabular ...`: declarative tabular preprocessing
        # vs the equivalent per-batch pandas TransformSpec callable
        # (fused-vectorized rows/s, value identity, zero writable-copy census)
        # — see benchmark/tabular.py
        from petastorm_tpu_torch.benchmark import tabular as tabular_bench

        return tabular_bench.main(argv[1:])
    if argv and argv[0] == "chaos":
        # `petastorm-tpu-torch-bench chaos ...`: the chaos acceptance harness —
        # scripted kill/transient-IO/poison/corrupt/stall-heal scenarios
        # asserting delivered ∪ quarantined == plan with zero leaked leases
        # — see benchmark/chaos.py
        from petastorm_tpu_torch.benchmark import chaos as chaos_bench

        return chaos_bench.main(argv[1:])
    if argv and argv[0] == "health":
        # `petastorm-tpu-torch-bench health ...`: heartbeat-instrumentation overhead
        # (enabled vs disabled, plus beat/record primitive ns/op) — see
        # benchmark/health.py
        from petastorm_tpu_torch.benchmark import health as health_bench

        return health_bench.main(argv[1:])
    if argv and argv[0] == "attribution":
        # `petastorm-tpu-torch-bench attribution ...`: the provenance acceptance
        # harness — inject a known bottleneck (remote tail / slow transform /
        # wire stall) and assert the critical-path attribution report names
        # that culprit, with cross-pid span merge and the on/off overhead
        # measurement — see benchmark/attribution.py
        from petastorm_tpu_torch.benchmark import attribution as attribution_bench

        return attribution_bench.main(argv[1:])
    if argv and argv[0] == "slo":
        # `petastorm-tpu-torch-bench slo ...`: the temporal-plane acceptance harness
        # — calibrate a step-p99 SLO on a clean run, inject a CloudLatencyFS
        # remote tail, assert exactly one debounced slo_breach whose attached
        # attribution snapshot names io.remote, and measure the armed-vs-off
        # throughput delta — see benchmark/slo.py
        from petastorm_tpu_torch.benchmark import slo as slo_bench

        return slo_bench.main(argv[1:])
    if argv and argv[0] == "autotune":
        # `petastorm-tpu-torch-bench autotune ...`: the closed-loop controller's
        # acceptance harness — wrong initial knobs + injected latency must
        # converge live to >=80% of the hand-tuned arm, a consumer-bound run
        # must shrink the fleet under the chaos-style invariant, and a clean
        # run must see ZERO actuations at <=1% overhead — see
        # benchmark/autotune.py
        from petastorm_tpu_torch.benchmark import autotune as autotune_bench

        return autotune_bench.main(argv[1:])
    if argv and argv[0] == "decompress":
        # `petastorm-tpu-torch-bench decompress ...`: the compressed-page
        # pass-through acceptance harness — device-bound bytes/batch on
        # pass-through columns <=60% of the host-inflate twin, delivered-
        # batch byte identity, zero leaked leases, and the no-eligible-
        # columns store running classic with one warn-once degradation —
        # see benchmark/decompress.py
        from petastorm_tpu_torch.benchmark import decompress as decompress_bench

        return decompress_bench.main(argv[1:])
    if argv and argv[0] == "shmcache":
        # `petastorm-tpu-torch-bench shmcache ...`: the host-wide cache arena
        # acceptance harness — a second process attaches the first's mapped
        # warm set and must drain byte-identical batches with ZERO store
        # reads, >=90% arena hits, zero copy-census bytes on serves, and
        # host-wide resident bytes <=1.2x one process's warm set — see
        # benchmark/shmcache.py
        from petastorm_tpu_torch.benchmark import shmcache as shmcache_bench

        return shmcache_bench.main(argv[1:])
    if argv and argv[0] == "tenants":
        # `petastorm-tpu-torch-bench tenants ...`: the per-tenant accounting-plane
        # acceptance harness — two concurrent loaders on one host/arena, the
        # noisy tenant named by the usage report AND a per-tenant burn alert
        # (site + tenant), cross-tenant sums reconciled against the untagged
        # totals, tenant frame-header compat, and the tagged-vs-untagged
        # overhead arms — see benchmark/tenants.py
        from petastorm_tpu_torch.benchmark import tenants as tenants_bench

        return tenants_bench.main(argv[1:])
    if argv and argv[0] == "fleet":
        # `petastorm-tpu-torch-bench fleet ...`: the disaggregated data-service
        # acceptance harness — 3 trainers on one decode fleet vs 3 dedicated
        # pipelines (decode worker-seconds per delivered row cut >=2x),
        # mid-epoch detach+reattach watermark exactness, per-tenant QoS
        # naming the noisy neighbor, and a seeded link-death arm asserting
        # re-dispatch-not-quarantine — see benchmark/fleet.py
        from petastorm_tpu_torch.benchmark import fleet as fleet_bench

        return fleet_bench.main(argv[1:])
    if argv and argv[0] == "diff":
        # `petastorm-tpu-torch-bench diff run_a run_b`: regression forensics over
        # two trend entries — names WHICH site's critical-path self time
        # regressed ("rows/s -28%: io.remote self-time 2.3x") — see
        # petastorm_tpu_torch/obs/diff.py
        from petastorm_tpu_torch.obs import diff as diff_cli

        return diff_cli.main(argv[1:])
    if argv and argv[0] == "trend":
        # `petastorm-tpu-torch-bench trend ...`: the throughput-regression gate —
        # best rows/s of a fixed synthetic workload appended to the --history
        # JSONL and compared against the stored median — see benchmark/trend.py
        from petastorm_tpu_torch.benchmark import trend as trend_bench

        return trend_bench.main(argv[1:])
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("dataset_url")
    parser.add_argument("--batch", action="store_true",
                        help="use make_batch_reader (vanilla parquet) instead of make_reader")
    parser.add_argument("--pool-type", choices=["thread", "process", "dummy"],
                        default="thread")
    parser.add_argument("--workers-count", type=int, default=4)
    parser.add_argument("--schema-fields", nargs="*", default=None)
    parser.add_argument("--warmup-rows", type=int, default=1000)
    parser.add_argument("--measure-rows", type=int, default=10000)
    parser.add_argument("--loader", action="store_true",
                        help="measure through the DataLoader (device feed + stage "
                             "counters + device-idle estimate) instead of the bare reader")
    parser.add_argument("--decode-on-device", action="store_true",
                        help="two-stage JPEG decode (requires --loader for the device half)")
    parser.add_argument("--loader-batch-size", type=int, default=256)
    parser.add_argument("--trace", metavar="PATH", default=None,
                        help="write a chrome://tracing / Perfetto span trace of the "
                             "measured pipeline to PATH (requires --loader)")
    parser.add_argument("--report", action="store_true",
                        help="print the bottleneck analyzer's verdict (producer-"
                             "bound / wire-bound / consumer-bound, with stage "
                             "utilizations and p50/p90/p99 latencies) after the "
                             "measurement (requires --loader)")
    parser.add_argument("--overlap-step-ms", type=float, default=0.0,
                        help="overlap mode: keep the device busy with a calibrated "
                             "synthetic step of ~this many milliseconds per batch and "
                             "report the device's idle share (CUDA events on the "
                             "card, the consumer's starvation on the CPU; the "
                             "north-star metric) instead of drain-only rows/s; "
                             "requires --loader")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    if args.decode_on_device and not args.loader:
        parser.error("--decode-on-device requires --loader: without the loader's device "
                     "half the reader yields stage-1 staging payloads, not images, and "
                     "the throughput number would be meaningless")
    if args.overlap_step_ms and not args.loader:
        parser.error("--overlap-step-ms requires --loader (the overlap runs on the "
                     "device batches the loader delivers)")
    if args.trace and not args.loader:
        parser.error("--trace requires --loader (the spans are the loader's "
                     "pipeline stages)")
    if args.report and not args.loader:
        parser.error("--report requires --loader (the analyzer reads the "
                     "loader's stage counters)")
    device = require_device(args.device)

    from petastorm_tpu_torch.benchmark.throughput import reader_throughput
    from petastorm_tpu_torch.reader import make_batch_reader, make_reader

    factory = make_batch_reader if args.batch else make_reader
    kwargs = {}
    if args.decode_on_device:
        kwargs["decode_on_device"] = True
    reader = factory(args.dataset_url, schema_fields=args.schema_fields,
                     reader_pool_type=args.pool_type, workers_count=args.workers_count,
                     num_epochs=None, **kwargs)
    try:
        if args.loader:
            from petastorm_tpu_torch.benchmark.throughput import loader_throughput
            from petastorm_tpu_torch.loader import DataLoader

            tracer = None
            if args.trace:
                from petastorm_tpu_torch.trace import TraceRecorder

                tracer = TraceRecorder()
            loader_kwargs = {}
            if args.report:
                # per-stage histograms ride into the report's p50/p90/p99 lines;
                # a PRIVATE registry so the one-shot report never mixes with (or
                # leaks into) the process-wide default registry
                from petastorm_tpu_torch.obs.metrics import MetricsRegistry

                loader_kwargs["metrics"] = MetricsRegistry()
            bs = args.loader_batch_size
            xfer0 = None
            if args.decode_on_device:
                from petastorm_tpu_torch.ops.jpeg import transfer_byte_counters

                xfer0 = transfer_byte_counters()  # delta, not process-lifetime total
            try:
                # the with-block matters: an abandoned pipeline torn down at
                # interpreter exit can kill a daemon transfer thread mid C++
                # dispatch (observed: 'FATAL: exception not rethrown' abort)
                with DataLoader(reader, args.loader_batch_size,
                                trace=tracer, device=device, **loader_kwargs) as loader:
                    if args.overlap_step_ms:
                        from petastorm_tpu_torch.benchmark.throughput import (
                            overlap_throughput,
                        )

                        step = _make_synthetic_step(args.overlap_step_ms, device)
                        print("synthetic step: %d chained (%d, %d) bf16 matmuls a call, "
                              "%.4f ms a call (%s)"
                              % (step.matmuls, _STEP_N, _STEP_N, step.device_ms,
                                 "CUDA events" if device.type == "cuda"
                                 else "wall time"))
                        result = overlap_throughput(
                            loader, step, step_repeats=1,
                            warmup_batches=max(1, args.warmup_rows // bs),
                            measure_batches=max(1, args.measure_rows // bs),
                        )
                    else:
                        result = loader_throughput(
                            loader,
                            warmup_batches=max(1, args.warmup_rows // bs),
                            measure_batches=max(1, args.measure_rows // bs),
                        )
            finally:
                if tracer is not None:
                    # dump in finally: the trace matters MOST when the run dies
                    # mid-measure (the spans up to the failure show where)
                    tracer.dump(args.trace)
            if xfer0 is not None:
                xfer = transfer_byte_counters()
                raw = xfer["raw"] - xfer0["raw"]
                shipped = xfer["shipped"] - xfer0["shipped"]
                if raw:
                    # printed as the shipped/raw RATIO — same semantics as the
                    # artifact key `coeff_bytes_shipped_ratio` (a "x0.42
                    # narrowing" phrasing would read as a speedup factor)
                    print("coefficient transfer: shipped %.1f MB of %.1f MB raw "
                          "int16 (%.2f of raw shipped)"
                          % (shipped / 1e6, raw / 1e6, shipped / raw))
            if args.report:
                # stats cover the measured window (loader_throughput resets them)
                report = loader.bottleneck_report()
        else:
            result = reader_throughput(reader, args.warmup_rows, args.measure_rows)
        print(result)
        if args.overlap_step_ms:
            print("overlap: device_idle_fraction=%r step_seconds=%r step_repeats=%r "
                  "batches=%r seconds=%r"
                  % (result.device_idle_fraction, result.step_seconds,
                     result.step_repeats, result.batches, result.seconds))
        if args.report:
            print(report.render())
    finally:
        reader.stop()
        reader.join()


if __name__ == "__main__":
    main()
