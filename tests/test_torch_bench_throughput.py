"""The throughput tool: :mod:`petastorm_tpu_torch.benchmark.throughput` and
:mod:`petastorm_tpu_torch.benchmark.cli` against the JAX package's.

The counterparts of ``tests/test_tools.py``'s throughput and CLI cases, on the CPU
(``--device cpu``): the two packages' ``reader_throughput`` and ``loader_throughput``
count the same rows and batches on the same store; both CLIs print the same line
format and refuse the same four flag combinations with the same words; ``--trace`` and
``--report`` work; ``--decode-on-device`` prints the shipped/raw ratio of the JAX CLI
on the same store; the overlap measure keeps a busy step fed, and a deadline in the
past skips its re-measure. Timings are never compared across packages.
"""
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu.benchmark import cli as ref_cli  # noqa: E402
from petastorm_tpu.benchmark import throughput as ref_tp  # noqa: E402
from petastorm_tpu.loader import DataLoader as RefDataLoader  # noqa: E402
from petastorm_tpu.reader import make_batch_reader as ref_make_batch_reader  # noqa: E402
from petastorm_tpu_torch.benchmark import cli  # noqa: E402
from petastorm_tpu_torch.benchmark import throughput as tp  # noqa: E402
from petastorm_tpu_torch.loader import DataLoader  # noqa: E402
from petastorm_tpu_torch.reader import make_batch_reader, make_reader  # noqa: E402

CPU = "cpu"
#: BenchmarkResult's line: "<rate> rows/s (<rows> rows in <seconds>s)" and what follows
RESULT_LINE = re.compile(r"^[0-9.]+ rows/s \((\d+) rows in [0-9.]+s\)(.*)$")


def _result_line(out):
    lines = [ln for ln in out.splitlines() if RESULT_LINE.match(ln)]
    assert len(lines) == 1, out
    return RESULT_LINE.match(lines[0])


def test_reader_throughput_counts_the_rows_and_batches_of_the_reference(scalar_dataset):
    def run(factory, module):
        reader = factory(scalar_dataset.url, num_epochs=None, shuffle_row_groups=False,
                         reader_pool_type="dummy")
        try:
            return module.reader_throughput(reader, warmup_rows=10, measure_rows=50)
        finally:
            reader.stop()
            reader.join()

    ours = run(make_batch_reader, tp)
    theirs = run(ref_make_batch_reader, ref_tp)
    assert ours.rows >= 50 and ours.rows_per_second > 0
    assert (ours.rows, ours.batches) == (theirs.rows, theirs.batches)
    assert ours.device_idle_fraction is None and ours.stages is None


def test_loader_throughput_device_idle_counts_as_the_reference(scalar_dataset):
    def run(factory, loader_cls, module, **kw):
        reader = factory(scalar_dataset.url, num_epochs=20, shuffle_row_groups=False,
                         reader_pool_type="dummy")
        with loader_cls(reader, batch_size=5, to_device=False, **kw) as loader:
            return module.loader_throughput(loader, consume_fn=lambda b: None,
                                            warmup_batches=2, measure_batches=10)

    ours = run(make_batch_reader, DataLoader, tp, device=CPU)
    theirs = run(ref_make_batch_reader, RefDataLoader, ref_tp)
    assert ours.batches == theirs.batches == 10
    assert ours.rows == theirs.rows == 50
    assert ours.device_idle_fraction is not None and 0.0 <= ours.device_idle_fraction <= 1
    # the stage split covers the measured window only, as in the reference
    assert ours.stages["batches"] <= 12 and set(theirs.stages) <= set(ours.stages)


def test_benchmark_cli_prints_the_reference_line(capsys, scalar_dataset):
    argv = [scalar_dataset.url, "--batch", "--pool-type", "dummy", "--warmup-rows", "5",
            "--measure-rows", "20"]
    cli.main(argv + ["--device", CPU])
    ours = _result_line(capsys.readouterr().out)
    ref_cli.main(argv)
    theirs = _result_line(capsys.readouterr().out)
    assert ours.group(1) == theirs.group(1)
    assert ours.group(2) == theirs.group(2) == ""


@pytest.mark.parametrize("flags", [
    ["--decode-on-device"], ["--overlap-step-ms", "1"], ["--trace", "t.json"],
    ["--report"]])
def test_benchmark_cli_refuses_what_the_reference_refuses(capsys, scalar_dataset, flags):
    """The four ``parser.error`` checks, with the JAX package's words, before any
    reader is built (the device is not even resolved)."""
    with pytest.raises(SystemExit) as ours:
        cli.main([scalar_dataset.url, "--batch"] + flags)
    ours_err = capsys.readouterr().err
    with pytest.raises(SystemExit) as theirs:
        ref_cli.main([scalar_dataset.url, "--batch"] + flags)
    theirs_err = capsys.readouterr().err
    assert ours.value.code == theirs.value.code == 2
    assert ours_err.split("error:")[1] == theirs_err.split("error:")[1]
    assert "requires --loader" in ours_err


def test_benchmark_cli_overlap_mode(capsys, scalar_dataset):
    """--overlap-step-ms: a calibrated synthetic step overlaps the pipeline and the
    result reports the consumer's starvation (the operator's device-idle probe)."""
    cli.main([scalar_dataset.url, "--batch", "--loader", "--loader-batch-size", "5",
              "--overlap-step-ms", "1", "--warmup-rows", "10", "--measure-rows", "40",
              "--device", CPU])
    out = capsys.readouterr().out
    match = _result_line(out)
    assert "device idle" in match.group(2)
    assert re.search(r"^synthetic step: \d+ chained \(1024, 1024\) bf16 matmuls a call, "
                     r"[0-9.]+ ms a call \(wall time\)$", out, re.M), out
    line = [ln for ln in out.splitlines() if ln.startswith("overlap: ")]
    assert line and "step_repeats=1" in line[0], out


def test_synthetic_step_depends_on_the_batch_and_reads_nothing_back():
    step = cli._make_synthetic_step(1, torch.device(CPU))
    assert step.matmuls >= 1 and step.device_ms > 0
    a = step({"x": torch.zeros(4, dtype=torch.int64)}).clone()
    b = step({"x": torch.full((4,), 100000, dtype=torch.int64)}).clone()
    c = step({"x": np.full(4, 100000, dtype=np.int64)}).clone()
    assert a.shape == (1024, 1024) and a.dtype == torch.bfloat16
    assert torch.isfinite(a.float()).all()
    # a0 = 1 + x * 1e-6: the batch's first element moves the result
    assert not torch.equal(a, b)
    # a host batch is indexed on the host and gives the device batch's result
    assert torch.equal(b, c)


def test_benchmark_cli_trace(scalar_dataset, tmp_path):
    """--trace writes a loadable chrome trace of the measured pipeline."""
    out = tmp_path / "cli_trace.json"
    cli.main([scalar_dataset.url, "--batch", "--loader", "--loader-batch-size", "5",
              "--warmup-rows", "10", "--measure-rows", "40", "--trace", str(out),
              "--device", CPU])
    with open(out) as f:
        doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert "reader.next" in names and "wait.device_queue" in names


def test_benchmark_cli_report_prints_the_verdict(capsys, scalar_dataset):
    cli.main([scalar_dataset.url, "--batch", "--loader", "--loader-batch-size", "5",
              "--warmup-rows", "10", "--measure-rows", "40", "--report", "--device", CPU])
    out = capsys.readouterr().out
    assert re.search(r"^bottleneck: \S+", out, re.M), out
    assert "read " in out and "p99" in out


def test_loader_throughput_reanchors_the_stage_histograms(scalar_dataset):
    """``--report``'s percentiles cover the measured window: the stage histograms are
    reset beside ``PipelineStats`` after the warm-up."""
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry

    reader = make_batch_reader(scalar_dataset.url, num_epochs=20, shuffle_row_groups=False,
                               reader_pool_type="dummy")
    with DataLoader(reader, 5, metrics=MetricsRegistry(), device=CPU) as loader:
        res = tp.loader_throughput(loader, warmup_batches=4, measure_batches=6)
        counts = {k: h.count for k, h in loader._obs.stage_histograms().items()}
    assert res.batches == 6
    # the consumer's wait is observed once a measured batch: the warm-up's 4 are gone
    assert counts["device_queue_wait"] == 6, counts


def _uniform_jpeg_store(url, rows=24):
    """Every row the same image: each batch ships the same bytes, so the shipped/raw
    ratio does not depend on how many batches a run decoded ahead."""
    from test_common import JpegSchema, write_dataset

    base = np.random.RandomState(0).randint(0, 256, (8, 12)).astype(np.float32)
    img = np.kron(base, np.ones((4, 4), np.float32))
    img = np.stack([img, np.flipud(img), np.fliplr(img)], -1).clip(0, 255).astype(np.uint8)
    write_dataset(url, JpegSchema, [{"id": i, "image_jpeg": img, "label": np.int32(0)}
                                    for i in range(rows)], rows_per_file=rows // 3)


def _reset_transfer_state(mod):
    with mod._STICKY_KS_LOCK:
        mod._STICKY_KS.clear()
        mod._STICKY_SPLIT.clear()
        mod._PACK12_DISABLED.clear()
        mod._SPLIT_DISABLED.clear()
        mod._TRANSFER_BYTES.update(shipped=0, raw=0)


def test_benchmark_cli_decode_on_device_prints_the_reference_ratio(capsys, tmp_path):
    """--decode-on-device prints the realized shipped/raw ratio of the coefficient
    transfer, equal to the JAX CLI's on the same store (the narrowed transfer is
    bit-identical between the packages)."""
    from petastorm_tpu.ops import jpeg as ref_jpeg
    from petastorm_tpu_torch.ops import jpeg

    url = "file://" + str(tmp_path / "jds")
    _uniform_jpeg_store(url)
    argv = [url, "--loader", "--loader-batch-size", "6", "--decode-on-device",
            "--pool-type", "dummy", "--warmup-rows", "6", "--measure-rows", "12"]
    ratios = []
    try:
        for main, mod, extra in ((cli.main, jpeg, ["--device", CPU]),
                                 (ref_cli.main, ref_jpeg, [])):
            _reset_transfer_state(mod)
            main(argv + extra)
            out = capsys.readouterr().out
            line = [ln for ln in out.splitlines() if ln.startswith("coefficient transfer")]
            assert line and "of raw shipped" in line[0], out
            counters = mod.transfer_byte_counters()
            ratios.append((re.search(r"\(([0-9.]+) of raw shipped\)", line[0]).group(1),
                           counters["shipped"] / counters["raw"]))
    finally:
        _reset_transfer_state(jpeg)
        _reset_transfer_state(ref_jpeg)
    assert ratios[0][0] == ratios[1][0]
    assert ratios[0][1] == pytest.approx(ratios[1][1], rel=1e-12)
    assert float(ratios[0][0]) < 1.0


def test_overlap_throughput_keeps_busy_device_fed(tmp_path):
    """With a step auto-calibrated to at least the pipeline's per-batch cost, the
    pipeline keeps the consumer fed: starvation (device_queue_wait / wall) stays low.

    The counterpart of the JAX package's case. The CPU is the device here, so the
    step's compute and the pipeline share the host's cores: starvation may not exceed
    the pipeline's share of the wall by more than 0.2, and with 4 cores or more stays
    under 0.2. The step runs torch on one intra-op thread (its threads would otherwise
    take every core from the pipeline's, which is no property of the pipeline), and the
    best of two windows is taken, as in the reference."""
    import os

    from test_common import create_test_jpeg_dataset

    url = "file://" + str(tmp_path / "jds")
    create_test_jpeg_dataset(url, num_rows=48)
    w = torch.from_numpy(np.random.RandomState(0).standard_normal((512, 512))
                         .astype(np.float32))

    def step(batch):
        x = batch["image_jpeg"].to(torch.float32).reshape(batch["image_jpeg"].shape[0], -1)
        x = x @ torch.eye(x.shape[1], 512)
        for _ in range(4):
            x = torch.tanh(x @ w)
        return x.sum()

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        results = []
        for _attempt in range(2):
            reader = make_reader(url, decode_on_device=True, num_epochs=None,
                                 shuffle_row_groups=False, workers_count=1)
            with DataLoader(reader, batch_size=8, prefetch=3, device=CPU) as loader:
                results.append(tp.overlap_throughput(loader, step, warmup_batches=2,
                                                     measure_batches=12))
    finally:
        torch.set_num_threads(threads)
    res = min(results, key=lambda r: r.device_idle_fraction)
    assert res.batches == 12
    assert res.step_repeats >= 1
    # the window's stage counts start at its reset: the transfer thread may have taken
    # up to ``prefetch`` (3) of the window's batches from the host queue before it
    assert res.stages is not None and res.stages["batches"] >= 12 - 3
    assert res.device_idle_fraction is not None
    st = res.stages
    host_work = st["read_s"] + st["batch_s"] + st["decode_s"] + st["h2d_s"]
    host_frac = host_work / res.seconds
    assert res.device_idle_fraction <= min(0.9, host_frac + 0.2), (res, host_frac)
    if (os.cpu_count() or 1) >= 4:
        assert res.device_idle_fraction < 0.2, res


def test_overlap_throughput_deadline_skips_remeasure(scalar_dataset):
    """A ``deadline`` in the past suppresses the adaptive re-measure: exactly one window
    runs although the observed idle would escalate."""
    import time

    calls = []

    def step(batch):
        calls.append(1)
        return torch.as_tensor(batch["id"]).sum()  # a near-zero step: "idle" for sure

    reader = make_batch_reader(scalar_dataset.url, num_epochs=None,
                               shuffle_row_groups=False, workers_count=1)
    with DataLoader(reader, batch_size=5, prefetch=2, device=CPU) as loader:
        res = tp.overlap_throughput(loader, step, warmup_batches=1, measure_batches=3,
                                    deadline=time.perf_counter() - 1.0)
    assert res.batches == 3
    assert res.device_idle_fraction is not None
    # 1 warm-up + 10 step-cost probes + batches x repeats window dispatches
    assert len(calls) == 11 + res.batches * res.step_repeats, len(calls)


def test_block_until_ready_returns_at_once_on_the_cpu():
    t = torch.ones(3)
    assert tp.block_until_ready(t) is t
    assert tp.block_until_ready(None) is None
    assert tp.block_until_ready({"a": [1, (t,)]})["a"][1][0] is t
