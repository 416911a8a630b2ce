"""The port's process pool (``reader_pool_type='process'``) against the JAX package's,
on the CPU: a small JPEG store read with ``decode_on_device=True`` through both
packages' process pools on every wire (the same ids exactly once, uint8 images bit for
bit per id, the port's plain stage 2 against the reference's), scalar stores through
``make_reader`` and ``make_batch_reader``, the compressed-page pass-through over the view
wire with no leaked lease, mixed-size JPEG rows copied out of their slab where no lease
rides them, the options that are not ported, and what a child loads."""
import os
import signal
import time

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
torch = pytest.importorskip("torch")

from _torch_pool_helpers import (ModulesProbe, _no_leaked_shm_segments,  # noqa: E402,F401
                                 failing_worker, no_leaked_port_slabs,
                                 slow_payload_worker)
from petastorm_tpu import loader as ref_loader  # noqa: E402
from petastorm_tpu import metadata as ref_metadata  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu import types as ref_types  # noqa: E402
from petastorm_tpu.codecs import CompressedImageCodec as RefImage  # noqa: E402
from petastorm_tpu.codecs import ScalarCodec as RefScalar  # noqa: E402
from petastorm_tpu.unischema import Unischema as RefSchema  # noqa: E402
from petastorm_tpu.unischema import UnischemaField as RefField  # noqa: E402
from petastorm_tpu_torch import make_batch_reader, make_reader  # noqa: E402
from petastorm_tpu_torch.errors import LeaseRevoked, WorkerDiedError  # noqa: E402
from petastorm_tpu_torch.io.lease import lease_stats  # noqa: E402
from petastorm_tpu_torch.loader import DataLoader  # noqa: E402
from petastorm_tpu_torch.plan import EpochPlan  # noqa: E402
from petastorm_tpu_torch.workers import ProcessExecutor  # noqa: E402

ROWS = 40
SHAPE = (32, 48, 3)
CPU = torch.device("cpu")
WIRES = ["pickle", "arrow", "shm", "shm-arrow", "shm-view", "shm-arrow-view"]
POOL = dict(reader_pool_type="process", workers_count=2, results_timeout_s=120)
#: the JAX package's pools run one child: each imports that package, which costs the
#: other test workers of a parallel run more CPU than the port's children do
REF_POOL = dict(POOL, workers_count=1)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The CPU stage 2 of these small batches on one thread: the default spreads each op
    over every core, which buys nothing here and costs the tests running beside these in
    a parallel run. Restored after each test."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jpeg_store(tmp_path_factory):
    """A JPEG store the reference wrote: four row groups of ten rows."""
    schema = RefSchema("PoolSchema", [
        RefField("id", np.int64, (), RefScalar(ref_types.LongType()), False),
        RefField("image", np.uint8, SHAPE, RefImage("jpeg", 85), False),
        RefField("label", np.int32, (), RefScalar(ref_types.IntegerType()), False),
    ])
    rng = np.random.RandomState(11)

    def rows():
        for i in range(ROWS):
            noise = rng.randint(0, 256, SHAPE).astype(np.float32)
            img = cv2.GaussianBlur(noise, (5, 5), 1.5).clip(0, 255).astype(np.uint8)
            yield {"id": i, "image": img, "label": np.int32(i % 7)}

    url = "file://" + str(tmp_path_factory.mktemp("torch_pool_store") / "ds")
    ref_metadata.write_dataset(url, schema, rows(), row_group_size_mb=32, rows_per_file=10)
    return url


@pytest.fixture(scope="module")
def reference_images(jpeg_store):
    """{id: uint8 image} from the JAX package's process pool (its default wire)."""
    reader = ref_reader.make_batch_reader(jpeg_store, decode_on_device=True, **REF_POOL)
    out = {}
    with ref_loader.DataLoader(reader, 8, last_batch="partial") as loader:
        for b in loader:
            for i, img in zip(np.asarray(b["id"]), np.asarray(b["image"])):
                assert int(i) not in out
                out[int(i)] = img
    assert sorted(out) == list(range(ROWS))
    return out


def _port_images(url, factory=make_batch_reader, shuffling=0, **kw):
    reader = factory(url, decode_on_device=True, **POOL, **kw)
    ids = []
    out = {}
    with DataLoader(reader, 8, device=CPU, last_batch="partial",
                    shuffling_queue_capacity=shuffling) as loader:
        for b in loader:
            for i, img in zip(b["id"].numpy(), b["image"].numpy()):
                ids.append(int(i))
                out[int(i)] = img
    return ids, out


@pytest.mark.parametrize("wire", WIRES)
def test_jpeg_process_pool_bit_identical_to_reference_per_id(jpeg_store, reference_images,
                                                             wire):
    """Every id exactly once, each image bit for bit the JAX package's process pool's;
    on the view wires every slab lease comes back, none by garbage collection."""
    leaked0 = lease_stats()["leaked"]
    ids, ours = _port_images(jpeg_store, wire_serializer=wire)
    assert sorted(ids) == list(range(ROWS))
    for i, img in ours.items():
        assert img.dtype == np.uint8 and img.shape == SHAPE
        np.testing.assert_array_equal(img, reference_images[i])
    stats = lease_stats()
    assert stats["leaked"] == leaked0 and stats["active"] == 0


@pytest.mark.parametrize("wire", ["pickle", "arrow"])
def test_jpeg_process_pool_through_the_wires_of_the_reference(jpeg_store, wire):
    """The same wire in both packages: the JAX package's pool on ``wire`` and the port's
    deliver the same ids and pixels. The port's shared-memory wires are held to the
    reference's default wire above: the JAX package's own slabs would trip the conftest
    leak fixture in other xdist workers (ROADMAP.md Queue 3 C), and its view wires let
    staged JPEG rows view a slab its loader has already released (Queue 3 F)."""
    reader = ref_reader.make_batch_reader(jpeg_store, decode_on_device=True,
                                          wire_serializer=wire, **REF_POOL)
    theirs = {}
    with ref_loader.DataLoader(reader, 8, last_batch="partial") as loader:
        for b in loader:
            theirs.update(zip(np.asarray(b["id"]).tolist(), np.asarray(b["image"])))
    _ids, ours = _port_images(jpeg_store, wire_serializer=wire)
    assert sorted(ours) == sorted(theirs) == list(range(ROWS))
    for i in ours:
        np.testing.assert_array_equal(ours[i], theirs[i])


def test_jpeg_per_row_reader_and_shuffling_buffer_over_the_view_wire(jpeg_store,
                                                                     reference_images):
    """Where the lease cannot ride (a per-row reader's restacking, the shuffling
    buffer), the loader copies the views out: the images stay equal."""
    for kw in ({"factory": make_reader, "wire_serializer": "shm-view"},
               {"shuffling": 16, "wire_serializer": "shm-view"}):
        ids, ours = _port_images(jpeg_store, **kw)
        assert sorted(ids) == list(range(ROWS))
        for i, img in ours.items():
            np.testing.assert_array_equal(img, reference_images[i])


MIXED_ROWS = 48
MIXED_SHAPES = [(40, 56, 3), (56, 40, 3), (33, 47, 3)]
RESIZE = (36, 44)


@pytest.fixture(scope="module")
def mixed_store(tmp_path_factory):
    """A mixed-size JPEG store the reference wrote: eight row groups of six rows, each
    row's size drawn from a seed. Most rows differ from their row group's first and take
    the per-image stage 1, whose rows hold no row-group buffer."""
    schema = RefSchema("MixedPoolSchema", [
        RefField("id", np.int64, (), RefScalar(ref_types.LongType()), False),
        RefField("image", np.uint8, (None, None, 3), RefImage("jpeg", 85), False),
    ])
    rng = np.random.RandomState(23)

    def rows():
        for i in range(MIXED_ROWS):
            shape = MIXED_SHAPES[rng.randint(len(MIXED_SHAPES))]
            noise = rng.randint(0, 256, shape).astype(np.float32)
            img = cv2.GaussianBlur(noise, (5, 5), 1.5).clip(0, 255).astype(np.uint8)
            yield {"id": i, "image": img}

    url = "file://" + str(tmp_path_factory.mktemp("torch_pool_mixed") / "ds")
    ref_metadata.write_dataset(url, schema, rows(), row_group_size_mb=32, rows_per_file=6)
    return url


@pytest.fixture(scope="module")
def mixed_reference(mixed_store):
    """{id: resized uint8 image} from the JAX package's process pool (its default wire)."""
    reader = ref_reader.make_batch_reader(mixed_store, decode_on_device=True, **REF_POOL)
    out = {}
    with ref_loader.DataLoader(reader, 8, last_batch="partial",
                               device_decode_resize=RESIZE) as loader:
        for b in loader:
            out.update(zip(np.asarray(b["id"]).tolist(), np.asarray(b["image"])))
    assert sorted(out) == list(range(MIXED_ROWS))
    return out


@pytest.mark.parametrize("case", ["per_row", "shuffling", "pad"])
def test_mixed_size_rows_outside_lease_mode_over_the_view_wire(mixed_store, mixed_reference,
                                                              case):
    """Rows that reach the loader outside lease mode on the view wire (a per-row reader,
    the shuffling buffer, a padded tail) are copied out of their slab before its lease
    is released, the per-image stage-1 rows too: every id once, each image within 1 of
    the reference's resize on under 1% of the values. A row left viewing a recycled slab
    decodes another image."""
    factory = make_reader if case == "per_row" else make_batch_reader
    reader = factory(mixed_store, decode_on_device=True, wire_serializer="shm-view", **POOL)
    out = {}
    with DataLoader(reader, 5 if case == "pad" else 8, device=CPU,
                    last_batch="pad" if case == "pad" else "partial",
                    shuffling_queue_capacity=16 if case == "shuffling" else 0,
                    device_decode_resize={"image": RESIZE}) as loader:
        for b in loader:
            valid = b["__valid__"].numpy() if "__valid__" in b else slice(None)
            for i, img in zip(b["id"].numpy()[valid], b["image"].numpy()[valid]):
                assert int(i) not in out
                out[int(i)] = img
    assert sorted(out) == list(range(MIXED_ROWS))
    diff = np.stack([np.abs(out[i].astype(np.int32) - mixed_reference[i].astype(np.int32))
                     for i in range(MIXED_ROWS)])
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    assert lease_stats()["active"] == 0


@pytest.mark.parametrize("factory,wire", [
    ("make_reader", None), ("make_reader", "shm-view"),
    ("make_batch_reader", None), ("make_batch_reader", "shm-view")])
def test_scalar_store_through_both_factories(scalar_dataset, synthetic_dataset, factory,
                                             wire):
    """A scalar store through the port's process pool on ``wire`` and the JAX package's
    thread pool: the same rows (values and dtypes) by id."""
    url = (scalar_dataset if factory == "make_batch_reader" else synthetic_dataset).url
    ours = {"make_reader": make_reader, "make_batch_reader": make_batch_reader}[factory]
    theirs = getattr(ref_reader, factory)
    fields = ["id", "float_col", "int_col", "string_col"] \
        if factory == "make_batch_reader" else ["id", "id2", "sensor_name"]

    def collect(fn, **pool):
        rows = {}
        with fn(url, schema_fields=fields, num_epochs=1, results_timeout_s=120,
                **pool) as r:
            for item in r:
                if factory == "make_batch_reader":
                    cols = [np.asarray(getattr(item, f)) for f in fields]
                    for vals in zip(*cols):
                        rows[int(vals[0])] = vals
                    r.release_batch()
                else:
                    rows[int(item.id)] = tuple(getattr(item, f) for f in fields)
        return rows

    a = collect(ours, reader_pool_type="process", workers_count=2, wire_serializer=wire)
    b = collect(theirs, reader_pool_type="thread", workers_count=2)
    assert sorted(a) == sorted(b) and len(a) > 0
    for k in a:
        for x, y in zip(a[k], b[k]):
            assert type(x) is type(y) and x == y, (k, x, y)


@pytest.mark.parametrize("mode", ["auto", "on"])
def test_passthrough_over_the_view_wire_leaks_no_lease(tmp_path, mode):
    """The pass-through over ``shm-view``: batches equal the classic read, no lease is
    leaked, and with ``on`` the pass-through columns cross the wire (``auto`` on a CPU
    loader reads classically, as for the thread pool)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.io import pagedec

    rng = np.random.RandomState(3)
    n = 4000
    table = pa.table({"feat": np.repeat(rng.rand(n // 8).astype(np.float32), 8),
                      "cat": (rng.zipf(1.5, n) % 50).astype(np.int64)})
    path = str(tmp_path / "part.parquet")
    pq.write_table(table, path, row_group_size=500, compression="snappy")
    url = "file://" + str(tmp_path)

    def run(m):
        # to_device=False: pass-through columns that crossed the wire inflate on the
        # host twin at delivery, each counted in host_inflate_columns
        before = pagedec.counter_values()["host_inflate_columns"]
        with make_batch_reader(url, reader_pool_type="process", workers_count=2,
                               shuffle_row_groups=False, wire_serializer="shm-view",
                               io_options={"pagedec": m}, results_timeout_s=120) as r:
            with DataLoader(r, 250, to_device=False, device=CPU) as loader:
                out = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
        return out, pagedec.counter_values()["host_inflate_columns"] - before

    leaked0 = lease_stats()["leaked"]
    classic, shipped_off = run("off")
    passed, shipped = run(mode)
    assert lease_stats()["leaked"] == leaked0 and lease_stats()["active"] == 0
    for k in ("feat", "cat"):
        a = np.sort(np.concatenate([b[k] for b in classic]), kind="stable")
        b = np.sort(np.concatenate([b[k] for b in passed]), kind="stable")
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert shipped_off == 0
    assert (shipped > 0) == (mode == "on")


def test_adoption_reaches_running_children(tmp_path):
    """A loader's adoption (``pagedec='auto'`` with a device) reaches the children that
    are already running: items they read after it ship pass-through columns."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.io.pagedec import is_passthrough

    n = 6000
    pq.write_table(pa.table({"v": np.repeat(np.arange(n // 10, dtype=np.float32), 10)}),
                   str(tmp_path / "p.parquet"), row_group_size=500, compression="snappy")
    with make_batch_reader("file://" + str(tmp_path), reader_pool_type="process",
                           workers_count=2, results_queue_size=1, shuffle_row_groups=False,
                           io_options={"pagedec": "auto"}, results_timeout_s=120) as r:
        r.adopt_passthrough(on_device=True)
        kinds = [is_passthrough(b.v) for b in r]
    assert len(kinds) == n // 500
    # each of the two children may have had one item in flight before the adoption (its
    # result can arrive at any position); every later item ships pass-through columns
    assert sum(kinds) >= len(kinds) - 2


@pytest.mark.parametrize("kwargs,item", [
    # the tcp transport is ported (item 4(c)): its case reads through a process pool
    # whose children dial back to the pool's hub
    ({"transport": "tcp"}, "item 4(c)"),
    # the recovery policy is ported (item 8a): its case reads through a process pool
    # under the poison policy, and quarantines nothing on a sound store
    ({"recovery": {"on_poison": "quarantine"}}, "item 8"),
    # readahead_depth and work_stealing are ported (item 5a), and so are the arena and
    # the ranged-GET engine (item 5b): these two cases now read through a process pool
    ({"io_options": {"arena_bytes": 2 << 20}}, "item 5"),
    ({"io_options": {"remote": {"max_inflight": 2}}}, "item 5"),
])
def test_unported_pool_options_raise_naming_their_item(scalar_dataset, kwargs, item):
    if item == "item 4(c)":
        with make_batch_reader(scalar_dataset.url, reader_pool_type="process",
                               workers_count=2, results_timeout_s=120, **kwargs) as r:
            assert r._executor._transport_name == "tcp"
            got = sorted(int(i) for b in r for i in np.asarray(b.id))
        assert got == list(range(len(scalar_dataset.data)))
        return
    if item == "item 8":
        with make_batch_reader(scalar_dataset.url, reader_pool_type="process",
                               workers_count=2, results_timeout_s=120, **kwargs) as r:
            got = sorted(int(i) for b in r for i in np.asarray(b.id))
            assert r._executor._recovery.quarantine and not r.quarantine_report
        assert got == list(range(len(scalar_dataset.data)))
        return
    if item == "item 5":
        from petastorm_tpu_torch.io import arena as arena_mod
        from petastorm_tpu_torch.io.memcache import shared_store

        try:
            with make_batch_reader(scalar_dataset.url, reader_pool_type="process",
                                   workers_count=2, results_timeout_s=120,
                                   **kwargs) as r:
                got = sorted(int(i) for b in r for i in np.asarray(b.id))
        finally:
            arena_mod.close_process_arena()
            shared_store().clear()  # the arena implies a process-wide memcache
        assert got == list(range(len(scalar_dataset.data)))
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 %s" % item.replace(
            "(", r"\(").replace(")", r"\)")):
        make_batch_reader(scalar_dataset.url, reader_pool_type="process", **kwargs)


def test_tcp_from_the_environment_raises_too(scalar_dataset, monkeypatch):
    """``PTPU_TRANSPORT=tcp`` selects the tcp wire (item 4(c) is ported); a name that is
    neither wire still raises."""
    monkeypatch.setenv("PTPU_TRANSPORT", "tcp")
    with make_batch_reader(scalar_dataset.url, reader_pool_type="process",
                           workers_count=2, results_timeout_s=120) as r:
        assert r._executor._transport_name == "tcp"
        got = sorted(int(i) for b in r for i in np.asarray(b.id))
    assert got == list(range(len(scalar_dataset.data)))
    monkeypatch.setenv("PTPU_TRANSPORT", "quic")
    with pytest.raises(ValueError, match="transport must be one of"):
        make_batch_reader(scalar_dataset.url, reader_pool_type="thread")


def test_child_loads_neither_jax_nor_the_reference_nor_torch(jpeg_store):
    """A child started by the port, after it read and stage-1 decoded a row group, has
    loaded neither jax nor the JAX package (nor torch), and sees no card."""
    with make_batch_reader(jpeg_store, reader_pool_type="dummy",
                           decode_on_device=True) as r:
        piece = r._plan._items[0]
        with ProcessExecutor(workers_count=1, results_queue_size=2,
                             results_timeout_s=120) as ex:
            ex.start(ModulesProbe(r._worker), EpochPlan([piece], num_epochs=1))
            (result,) = list(ex.results())
    assert result[2]["loaded"].tolist() == [""]
    assert result[2]["cuda_visible"].tolist() == [""]


def test_worker_exception_reaches_the_consumer():
    with ProcessExecutor(workers_count=2, results_queue_size=2,
                         results_timeout_s=120) as ex:
        ex.start(failing_worker, EpochPlan(list(range(8)), num_epochs=1))
        with pytest.raises(ValueError, match="item 3 is bad"):
            list(ex.results())


def test_children_dying_past_the_budget_raise_worker_died_error():
    """With a respawn budget of 0 the first dead child ends the stream in
    WorkerDiedError, carrying the child's failure."""
    with ProcessExecutor(workers_count=1, results_queue_size=2, results_timeout_s=120,
                         worker_respawns=0) as ex:
        ex.start(slow_payload_worker, EpochPlan(list(range(6)), num_epochs=1))
        time.sleep(1.0)
        os.kill(ex.child_pids()[0], signal.SIGKILL)
        with pytest.raises(WorkerDiedError) as info:
            list(ex.results())
    assert isinstance(info.value, RuntimeError) and info.value.original is not None


def test_respawn_budget_defaults_to_the_references(monkeypatch):
    assert ProcessExecutor()._respawn_budget == 2
    monkeypatch.setenv("PTPU_WORKER_RESPAWNS", "5")
    assert ProcessExecutor()._respawn_budget == 5
    assert ProcessExecutor(worker_respawns=1)._respawn_budget == 1


def test_reset_revokes_a_lease_kept_across_it(scalar_dataset):
    """A batch whose lease was taken and kept across ``reset()`` raises LeaseRevoked on
    access instead of reading a recycled slab."""
    with make_batch_reader(scalar_dataset.url, reader_pool_type="process", workers_count=1,
                           wire_serializer="shm-view", results_timeout_s=120) as r:
        assert r.wire_views
        next(r)
        lease = r.take_lease()
        from petastorm_tpu_torch.io.lease import LeasedBatch

        kept = LeasedBatch({"x": np.zeros(2)}, [lease])
        r.reset()
        with pytest.raises(LeaseRevoked):
            kept["x"]
        kept.release()
        assert sum(1 for _ in r) > 0


def test_reader_factory_defaults_are_the_references(scalar_dataset):
    with make_batch_reader(scalar_dataset.url, reader_pool_type="process",
                           workers_count=1, results_timeout_s=120) as r:
        assert r._executor._serializer_name == "arrow" and not r.wire_views
        assert r.wire_stats() == {}
    with make_batch_reader(scalar_dataset.url, reader_pool_type="process", workers_count=1,
                           wire_serializer="shm", results_timeout_s=120) as r:
        assert r._executor._serializer_name == "shm-arrow"
        assert r.wire_stats()["shm_slabs_total"] == 3



def test_make_reader_default_wire_is_pickle(synthetic_dataset):
    with make_reader(synthetic_dataset.url, schema_fields=["id"], workers_count=1,
                     reader_pool_type="process", results_timeout_s=120) as r:
        assert r._executor._serializer_name == "pickle"
        assert sorted(int(row.id) for row in r) == sorted(
            int(d["id"]) for d in synthetic_dataset.data)


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["arrow", "shm-view"])
def test_process_pool_on_the_card_equals_the_thread_pool(jpeg_store, wire):
    """On the card: the process pool's batches, decoded by the kernels, equal the thread
    pool's per id; every view lease comes back; the children see no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def collect(**kw):
        out = {}
        reader = make_batch_reader(jpeg_store, decode_on_device=True, workers_count=2,
                                   results_timeout_s=120, **kw)
        with DataLoader(reader, 8, device="cuda", last_batch="partial") as loader:
            for b in loader:
                out.update(zip(b["id"].cpu().tolist(), b["image"].cpu().numpy()))
                for pid in (reader._executor.child_pids() if kw else ()):
                    try:
                        with open("/proc/%d/maps" % pid) as f:
                            assert "libcuda" not in f.read()
                    except FileNotFoundError:
                        pass  # a child that finished its share has exited
        return out

    leaked0 = lease_stats()["leaked"]
    theirs = collect()
    ours = collect(reader_pool_type="process", wire_serializer=wire)
    assert sorted(ours) == sorted(theirs) == list(range(ROWS))
    for i in ours:
        np.testing.assert_array_equal(ours[i], theirs[i])
    assert lease_stats()["leaked"] == leaked0 and lease_stats()["active"] == 0
