"""The port's span tracing against the JAX package's (ROADMAP.md Queue 1 item 8a):
:class:`~petastorm_tpu_torch.trace.TraceRecorder`, the DataLoader's stage spans, the
InMemDataLoader's gather spans, and the process pool's cross-process merge.

Every case of the JAX package's ``tests/test_trace.py`` has a counterpart here. Beside
them:

- the Chrome trace of a ``to_device=False`` loader holds the same set of span names as
  the JAX package's over the same store;
- the spans and ``PipelineStats`` time the same intervals;
- no span is open while ``torch.cuda.synchronize`` (or an event or stream wait) runs:
  tracing adds no synchronisation the untraced path lacks;
- the readahead pool, the slab ring and the pass-through inflate stage record their
  spans;
- ``gpu``-marked cases hold a traced run's kernel launches a batch equal to an untraced
  run's on the card (they skip here).
"""
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import negate, no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu import loader as ref_loader  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu import trace as ref_trace  # noqa: E402
from petastorm_tpu_torch.loader import DataLoader, InMemDataLoader  # noqa: E402
from petastorm_tpu_torch.reader import make_batch_reader  # noqa: E402
from petastorm_tpu_torch.trace import TraceRecorder  # noqa: E402

#: the DataLoader's stage spans on the device path (the JAX package's names)
STAGE_SPANS = {"reader.next", "batch.form", "decode.dispatch", "h2d.transfer",
               "wait.host_queue", "wait.device_queue"}


def test_loader_records_all_stage_spans(scalar_dataset, tmp_path):
    tracer = TraceRecorder()
    reader = make_batch_reader(scalar_dataset.url, num_epochs=1, shuffle_row_groups=False,
                               workers_count=1)
    seen_rows = 0
    with DataLoader(reader, 10, trace=tracer, device="cpu") as loader:
        for batch in loader:
            with tracer.span("train.step"):
                seen_rows += len(batch["id"])
    assert seen_rows > 0
    names = {e["name"] for e in tracer.events()}
    assert STAGE_SPANS | {"train.step"} <= names
    # the producer, transfer and consumer threads each record
    threads = {e["thread"] for e in tracer.events()}
    assert len(threads) >= 3, threads
    for e in tracer.events():
        assert e["duration_s"] >= 0 and e["start_s"] >= 0
    path = tracer.dump(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    spans = [e for e in evs if e["ph"] == "X"]
    assert meta and spans
    assert {m["args"]["name"] for m in meta} == threads
    for s in spans:
        assert s["ts"] >= 0 and s["dur"] >= 0 and s["pid"] and s["tid"]


def test_inmem_loader_trace(scalar_dataset):
    """InMemDataLoader records the fill pipeline's spans (through its DataLoader) and one
    gather span a served batch."""
    tracer = TraceRecorder()
    reader = make_batch_reader(scalar_dataset.url, num_epochs=1, shuffle_row_groups=False,
                               workers_count=1)
    with InMemDataLoader(reader, batch_size=10, num_epochs=1, trace=tracer,
                         device="cpu") as loader:
        batches = sum(1 for _ in loader)
    names = {e["name"] for e in tracer.events()}
    assert "reader.next" in names
    gathers = [e for e in tracer.events() if e["name"] == "inmem.gather"]
    assert len(gathers) == batches > 0


def test_trace_disabled_is_default(scalar_dataset):
    reader = make_batch_reader(scalar_dataset.url, num_epochs=1, workers_count=1)
    with DataLoader(reader, 10, device="cpu") as loader:
        assert loader._trace is None
        next(iter(loader))


def test_recorder_bounded_memory():
    """max_events is a ring: a long run keeps the newest window."""
    tracer = TraceRecorder(max_events=10)
    for i in range(25):
        tracer.add("s%d" % i, float(i), 0.5)
    assert len(tracer) == 10
    assert [e["name"] for e in tracer.events()] == ["s%d" % i for i in range(15, 25)]


def test_same_thread_name_distinct_lanes(tmp_path):
    """Two live threads sharing a name land on distinct trace tids."""
    tracer = TraceRecorder()
    barrier = threading.Barrier(2)

    def worker():
        barrier.wait()
        for _ in range(5):
            with tracer.span("work"):
                pass

    threads = [threading.Thread(target=worker, name="ptpu-torch-loader")
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    path = tracer.dump(str(tmp_path / "t.json"))
    with open(path) as f:
        doc = json.load(f)
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert len(meta) == 2  # one lane a thread identity
    assert all(m["args"]["name"] == "ptpu-torch-loader" for m in meta)
    assert len({e["tid"] for e in doc["traceEvents"] if e["ph"] == "X"}) == 2


def test_recorder_thread_safety():
    tracer = TraceRecorder()

    def hammer():
        for i in range(200):
            with tracer.span("t%d" % (i % 3)):
                pass

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(tracer) == 800


def test_dump_equals_the_jax_recorders_for_the_same_spans(tmp_path):
    """The same spans, flow points and child merges give the same trace-event JSON in
    both packages (the recorder's origin aside; the port names this process's lane
    ``ptpu-parent``)."""
    port, ref = TraceRecorder(), ref_trace.TraceRecorder()
    ref._origin, ref._wall_origin = port._origin, port._wall_origin
    for rec in (port, ref):
        rec.add("a", port._origin + 0.5, 0.25)
        rec.add("b", port._origin + 1.0, 0.125)
        rec.add_child(4242, [("child.work", 10.0, 0.5)], port._wall_origin + 2.0, 10.0)
        rec.add_flow_point(7, "lane", 4242, port._origin + 2.1)
        rec.add_flow_point(7, "lane", 4242, port._origin + 2.2, terminate=True)
    with open(port.dump(str(tmp_path / "a.json"))) as f:
        a = json.load(f)["traceEvents"]
    with open(ref.dump(str(tmp_path / "b.json"))) as f:
        b = json.load(f)["traceEvents"]

    def lanes_and_spans(evs):
        return [e for e in evs if e["name"] != "process_name"]

    assert lanes_and_spans(a) == lanes_and_spans(b)
    procs = {e["pid"]: e["args"]["name"] for e in a if e["name"] == "process_name"}
    assert procs == {os.getpid(): "ptpu-parent", 4242: "ptpu-pool-child-4242"}
    assert port.events() == ref.events()


# -- the cross-process merge --------------------------------------------------------------


def test_merged_child_process_dump_has_distinct_pid_lanes(tmp_path):
    """One dump holds spans from the parent's threads and from the pool's children, on
    distinct pid lanes, and loads as trace-event JSON."""
    from petastorm_tpu_torch.plan import EpochPlan
    from petastorm_tpu_torch.workers import ProcessExecutor

    tracer = TraceRecorder()
    with ProcessExecutor(workers_count=2, results_queue_size=4,
                         results_timeout_s=60) as ex:
        ex.set_trace(tracer)
        ex.start(negate, EpochPlan(list(range(8)), num_epochs=1))
        with tracer.span("parent.drain"):
            got = sorted(ex.results())
    assert got == sorted(-x for x in range(8))
    evs = tracer.events()
    child_pids = {e["pid"] for e in evs if e["name"] == "child.work"}
    assert child_pids and os.getpid() not in child_pids
    assert {e["name"] for e in evs} >= {"child.work", "child.serialize", "parent.drain"}
    path = tracer.dump(str(tmp_path / "merged.json"))
    with open(path) as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    span_pids = {e["pid"] for e in spans}
    assert os.getpid() in span_pids and span_pids & child_pids
    procs = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert procs[os.getpid()] == "ptpu-parent"
    assert any(name.startswith("ptpu-pool-child") for name in procs.values())
    # clock alignment: every child span lands inside the parent's drain window
    drain = next(e for e in spans if e["name"] == "parent.drain")
    slack = 0.5e6  # us: a child may start an item just before the drain span opens
    for e in spans:
        if e["pid"] in child_pids:
            assert drain["ts"] - slack <= e["ts"] <= drain["ts"] + drain["dur"] + slack


def test_child_spans_discarded_without_a_recorder():
    """No recorder attached: the children's spans are dropped at the feeder."""
    from petastorm_tpu_torch.plan import EpochPlan
    from petastorm_tpu_torch.workers import ProcessExecutor

    with ProcessExecutor(workers_count=1, results_queue_size=4,
                         results_timeout_s=60) as ex:
        ex.start(negate, EpochPlan([1, 2, 3], num_epochs=1))
        assert sorted(ex.results()) == [-3, -2, -1]
        assert ex._tracer is None


def test_a_traced_pool_reader_shows_a_lane_for_each_child(scalar_dataset):
    """A DataLoader's trace reaches its reader's process pool: the children's
    child.work spans merge on one pid lane each, beside the loader's stage spans."""
    tracer = TraceRecorder()
    reader = make_batch_reader(scalar_dataset.url, num_epochs=1, workers_count=2,
                               reader_pool_type="process", results_timeout_s=60,
                               wire_serializer="shm", shuffle_row_groups=False)
    with DataLoader(reader, 5, trace=tracer, device="cpu", to_device=False) as loader:
        pids = set(reader._executor.child_pids())
        n = sum(1 for _ in loader)
    assert n > 0
    evs = tracer.events()
    lanes = {e["pid"] for e in evs if e["name"] == "child.work"}
    assert lanes and lanes <= pids
    assert {"reader.next", "wait.host_queue"} <= {e["name"] for e in evs}


# -- the port's own contracts -----------------------------------------------------------


def test_to_device_false_span_names_equal_the_jax_packages(scalar_dataset):
    """The same store through both packages' loaders on the host delivery path
    (readahead off, so the IO spans do not depend on timing): the same span names."""
    def names(loader_cls, factory, **kw):
        tracer = (TraceRecorder if loader_cls is DataLoader else ref_trace.TraceRecorder)()
        reader = factory(scalar_dataset.url, num_epochs=1, shuffle_row_groups=False,
                         workers_count=1, io_options={"readahead": False})
        with loader_cls(reader, 10, trace=tracer, to_device=False, **kw) as loader:
            assert sum(1 for _ in loader) > 0
        return {e["name"] for e in tracer.events()}

    port = names(DataLoader, make_batch_reader, device="cpu")
    ref = names(ref_loader.DataLoader, ref_reader.make_batch_reader)
    assert port == ref
    assert {"reader.next", "batch.form", "wait.host_queue_put", "wait.host_queue"} <= port


def test_spans_and_pipeline_stats_time_the_same_intervals(scalar_dataset):
    tracer = TraceRecorder()
    reader = make_batch_reader(scalar_dataset.url, num_epochs=2, shuffle_row_groups=False,
                               workers_count=1)
    with DataLoader(reader, 5, trace=tracer, device="cpu") as loader:
        for _ in loader:
            pass
        snap = loader.stats.snapshot()
    total = {}
    for e in tracer.events():
        total[e["name"]] = total.get(e["name"], 0.0) + e["duration_s"]
    for span, key in (("reader.next", "read_s"), ("batch.form", "batch_s"),
                      ("decode.dispatch", "decode_s"), ("h2d.transfer", "h2d_s"),
                      ("wait.host_queue", "queue_wait_s"),
                      ("wait.device_queue", "device_queue_wait_s")):
        assert total.get(span, 0.0) == pytest.approx(snap[key], abs=2e-4), span


def test_no_span_is_open_while_the_card_is_synchronized(scalar_dataset, monkeypatch):
    """Tracing must not change what it measures: no span of the pipeline may enclose a
    torch.cuda.synchronize, or an event or stream wait. The calls are recorded (with
    their thread and time) and checked against every recorded span; a planted call
    inside a span shows the check catches one."""
    calls = []

    def recorder(name):
        def call(*_a, **_k):
            calls.append((threading.get_ident(), time.perf_counter(), name))
        return call

    monkeypatch.setattr(torch.cuda, "synchronize", recorder("synchronize"))
    monkeypatch.setattr(torch.cuda.Event, "synchronize", recorder("event.synchronize"))
    monkeypatch.setattr(torch.cuda.Event, "wait", recorder("event.wait"))
    monkeypatch.setattr(torch.cuda.Stream, "synchronize", recorder("stream.synchronize"))

    class _Recorder(TraceRecorder):
        def __init__(self):
            super().__init__()
            self.intervals = []

        def add(self, name, t0, dur):
            self.intervals.append((threading.get_ident(), t0, t0 + dur, name))
            super().add(name, t0, dur)

    def inside(tracer):
        return [(c[2], s[3]) for c in calls for s in tracer.intervals
                if c[0] == s[0] and s[1] <= c[1] <= s[2]]

    tracer = _Recorder()
    reader = make_batch_reader(scalar_dataset.url, num_epochs=1, shuffle_row_groups=False,
                               workers_count=1)
    with DataLoader(reader, 5, trace=tracer, device="cpu") as loader:
        for _ in loader:
            pass
    assert tracer.intervals and inside(tracer) == []
    with tracer.span("planted"):
        torch.cuda.synchronize()
    assert inside(tracer) == [("synchronize", "planted")]


def test_readahead_pool_records_its_spans(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(pa.table({"id": np.arange(64, dtype=np.int64)}),
                   str(tmp_path / "p.parquet"), row_group_size=4)
    tracer = TraceRecorder()
    reader = make_batch_reader("file://" + str(tmp_path), reader_pool_type="dummy",
                               shuffle_row_groups=False, num_epochs=1)
    with DataLoader(reader, 8, trace=tracer, device="cpu", to_device=False) as loader:
        assert sum(len(b["id"]) for b in loader) == 64
    assert "io.readahead" in {e["name"] for e in tracer.events()}


def test_the_slab_ring_records_acquire_waits():
    from petastorm_tpu_torch.parallel.shm_ring import SlabRing, shm_supported

    if not shm_supported():
        pytest.skip("no shared memory on this platform")
    tracer = TraceRecorder()
    ring = SlabRing(1024, 1)
    try:
        ring.set_trace(tracer)
        slab = ring.acquire()
        assert ring.acquire(timeout=0.02) is None  # starved: a recorded wait
        ring.release(slab)
    finally:
        ring.close()
    waits = [e for e in tracer.events() if e["name"] == "shm.acquire_wait"]
    assert len(waits) == 1 and waits[0]["duration_s"] >= 0.015


def test_the_inflate_stage_records_its_span(tmp_path):
    """A pass-through batch's inflate stage is a decode.device_inflate span (the host
    twin on the CPU, the kernels on the card)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    n = 4000
    pq.write_table(pa.table({"v": np.repeat(np.arange(n // 10, dtype=np.float32), 10)}),
                   str(tmp_path / "p.parquet"), row_group_size=1000, compression="snappy")
    tracer = TraceRecorder()
    reader = make_batch_reader("file://" + str(tmp_path), reader_pool_type="dummy",
                               shuffle_row_groups=False, io_options={"pagedec": "on"})
    with DataLoader(reader, 1000, trace=tracer, device="cpu") as loader:
        got = np.concatenate([b["v"].numpy() for b in loader])
    np.testing.assert_array_equal(got, np.repeat(np.arange(n // 10, dtype=np.float32), 10))
    inflates = [e for e in tracer.events() if e["name"] == "decode.device_inflate"]
    assert len(inflates) == 4


# -- on the card ---------------------------------------------------------------------------


def _launch_counts():
    from petastorm_tpu_torch.ops import pagedec_kernels as pk

    return (pk.snappy_inflate_ragged.launches, pk.rle_scan_pages.launches,
            pk.extract_pages.launches)


@pytest.mark.gpu
def test_a_traced_pass_through_run_launches_what_an_untraced_one_does(tmp_path):
    """On the card a traced run launches K3, the scan and K4 once a batch, as the
    untraced run does, and delivers the same bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.obs.metrics import MetricsRegistry

    n = 8192
    pq.write_table(pa.table({"v": np.repeat(np.arange(n // 8, dtype=np.float32), 8),
                             "k": np.arange(n, dtype=np.int64) % 7}),
                   str(tmp_path / "p.parquet"), row_group_size=1024, compression="snappy")

    def run(trace, metrics):
        reader = make_batch_reader("file://" + str(tmp_path), reader_pool_type="dummy",
                                   shuffle_row_groups=False,
                                   io_options={"pagedec": "auto"})
        before = _launch_counts()
        with DataLoader(reader, 1024, trace=trace, metrics=metrics,
                        device="cuda") as loader:
            out = [{k: v.cpu().numpy() for k, v in b.items()} for b in loader]
        return out, tuple(a - b for a, b in zip(_launch_counts(), before))

    plain, plain_launches = run(None, None)
    tracer = TraceRecorder()
    traced, traced_launches = run(tracer, MetricsRegistry())
    assert traced_launches == plain_launches == (len(plain),) * 3
    for a, b in zip(plain, traced):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert "decode.device_inflate" in {e["name"] for e in tracer.events()}


@pytest.mark.gpu
def test_a_traced_jpeg_run_launches_what_an_untraced_one_does(tmp_path):
    """On the card the traced main path launches stage2_planes and stage2_rgb as often
    as the untraced one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cv2

    from petastorm_tpu_torch import types as ptypes
    from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.metadata import write_dataset
    from petastorm_tpu_torch.ops import jpeg
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema("S", [
        UnischemaField("id", np.int64, (), ScalarCodec(ptypes.LongType()), False),
        UnischemaField("image", np.uint8, (32, 48, 3), CompressedImageCodec("jpeg", 85),
                       False)])
    rng = np.random.RandomState(3)
    url = "file://" + str(tmp_path / "s")
    write_dataset(url, schema, ({"id": i, "image": cv2.GaussianBlur(
        rng.randint(0, 256, (32, 48, 3)).astype(np.uint8), (5, 5), 2.0)}
        for i in range(32)), row_group_size_mb=0, rows_per_file=8)

    def run(trace):
        reader = make_batch_reader(url, reader_pool_type="dummy", decode_on_device=True,
                                   shuffle_row_groups=False)
        before = (jpeg.stage2_planes_segments.launches, jpeg.stage2_rgb.launches)
        with DataLoader(reader, 8, trace=trace, device="cuda") as loader:
            imgs = [b["image"].cpu().numpy() for b in loader]
        return imgs, (jpeg.stage2_planes_segments.launches - before[0],
                      jpeg.stage2_rgb.launches - before[1])

    plain, plain_launches = run(None)
    traced, traced_launches = run(TraceRecorder())
    assert traced_launches == plain_launches and plain_launches[0] >= len(plain)
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)
