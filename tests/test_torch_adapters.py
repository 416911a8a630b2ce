"""Port vs reference: the torch adapters (``DataLoader``, ``BatchedDataLoader``,
``InMemBatchedDataLoader``, ``decimal_friendly_collate``). The JAX package's adapters are
torch already: on the same store and seed the port's loaders yield the same tensors
(values and dtypes) and the same host columns, shuffled or not; per-row NGram windows
collate alike; a view-wire reader's batches are copied out of their slabs; the refusals
name the port's device DataLoader; the ``pytorch`` alias, and the TensorFlow bridges,
which the package routes to ``adapters.tf``."""
import decimal
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments, no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu import ngram as ref_ngram  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu.adapters import pytorch as ref_adapters  # noqa: E402
from petastorm_tpu_torch import make_batch_reader, make_reader, ngram, types  # noqa: E402
from petastorm_tpu_torch import reader as port_reader  # noqa: E402
from petastorm_tpu_torch.adapters import pytorch as adapters  # noqa: E402
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec  # noqa: E402
from petastorm_tpu_torch.metadata import write_dataset  # noqa: E402
from petastorm_tpu_torch.unischema import Unischema, UnischemaField  # noqa: E402

ROWS = 40


@pytest.fixture(scope="module")
def row_store(tmp_path_factory):
    """40 rows through the port's writer: id, ts, a float, a (3, 4) float32 tensor and a
    string."""
    schema = Unischema("AdapterSchema", [
        UnischemaField("id", np.int64, (), ScalarCodec(types.LongType()), False),
        UnischemaField("ts", np.int64, (), ScalarCodec(types.LongType()), False),
        UnischemaField("x", np.float64, (), ScalarCodec(types.DoubleType()), False),
        UnischemaField("matrix", np.float32, (3, 4), NdarrayCodec(), False),
        UnischemaField("name", np.str_, (), ScalarCodec(types.StringType()), False),
    ])
    rng = np.random.RandomState(6)
    url = "file://" + str(tmp_path_factory.mktemp("torch_adapters") / "rows")
    write_dataset(url, schema, ({"id": i, "ts": 10 * i + 30 * (i // 9), "x": rng.normal(),
                                 "matrix": rng.rand(3, 4).astype(np.float32),
                                 "name": "n%d" % i} for i in range(ROWS)),
                  row_group_size_mb=1, rows_per_file=20)
    return url


@pytest.fixture(scope="module")
def batch_store(tmp_path_factory):
    """A vanilla parquet store: 96 rows in row groups of 12 with int64, float32, int32
    and string columns."""
    root = tmp_path_factory.mktemp("torch_adapters") / "batch"
    os.makedirs(root)
    rng = np.random.RandomState(2)
    ids = np.arange(96, dtype=np.int64)
    pq.write_table(pa.table({"id": ids, "v": rng.rand(96).astype(np.float32),
                             "k": (ids % 5).astype(np.int32),
                             "s": ["s%d" % i for i in ids]}),
                   str(root / "p.parquet"), row_group_size=12)
    return "file://" + str(root)


def _kw(**extra):
    kw = dict(shuffle_row_groups=False, num_epochs=1, reader_pool_type="dummy")
    kw.update(extra)
    return kw


def _assert_batches_equal(ours, theirs):
    assert len(ours) == len(theirs) and ours
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(b[k], torch.Tensor):
                assert isinstance(a[k], torch.Tensor) and a[k].dtype == b[k].dtype
                assert torch.equal(a[k], b[k]), k
            else:
                assert not isinstance(a[k], torch.Tensor)
                assert list(a[k]) == list(b[k]), k


@pytest.mark.parametrize("capacity,seed", [(0, None), (8, 3), (16, 11)])
def test_per_row_loader_equals_the_reference(row_store, capacity, seed):
    fields = ["id", "x", "matrix", "name"]
    with adapters.DataLoader(make_reader(row_store, schema_fields=fields, **_kw()), 4,
                             shuffling_queue_capacity=capacity, seed=seed) as loader:
        ours = list(loader)
    with ref_adapters.DataLoader(ref_reader.make_reader(row_store, schema_fields=fields,
                                                        **_kw()), 4,
                                 shuffling_queue_capacity=capacity, seed=seed) as loader:
        theirs = list(loader)
    _assert_batches_equal(ours, theirs)
    assert ours[0]["matrix"].shape == (4, 3, 4)
    assert sorted(int(i) for b in ours for i in b["id"]) == list(range(ROWS))


@pytest.mark.parametrize("capacity,seed,keep", [(0, None, True), (0, None, False),
                                                (16, 3, True), (30, 5, False)])
def test_batched_loader_equals_the_reference(batch_store, capacity, seed, keep):
    with adapters.BatchedDataLoader(make_batch_reader(batch_store, **_kw()), 10,
                                    shuffling_queue_capacity=capacity, seed=seed,
                                    keep_last_batch=keep) as loader:
        ours = list(loader)
    with ref_adapters.BatchedDataLoader(ref_reader.make_batch_reader(batch_store, **_kw()),
                                        10, shuffling_queue_capacity=capacity, seed=seed,
                                        keep_last_batch=keep) as loader:
        theirs = list(loader)
    _assert_batches_equal(ours, theirs)
    assert ours[0]["v"].dtype == torch.float32 and not isinstance(ours[0]["s"], torch.Tensor)


@pytest.mark.parametrize("shuffle,capacity", [(True, None), (False, None), (True, 50)])
def test_in_memory_loader_equals_the_reference(batch_store, shuffle, capacity):
    with adapters.InMemBatchedDataLoader(make_batch_reader(batch_store, **_kw()), 16,
                                         num_epochs=3, rows_capacity=capacity,
                                         shuffle=shuffle, seed=4) as loader:
        ours = list(loader)
    with ref_adapters.InMemBatchedDataLoader(
            ref_reader.make_batch_reader(batch_store, **_kw()), 16, num_epochs=3,
            rows_capacity=capacity, shuffle=shuffle, seed=4) as loader:
        theirs = list(loader)
    _assert_batches_equal(ours, theirs)
    rows = capacity or 96
    assert sum(len(b["id"]) for b in ours) == 3 * rows


def test_in_memory_loader_over_a_per_row_reader_equals_the_reference(row_store):
    fields = ["id", "x", "matrix"]
    with adapters.InMemBatchedDataLoader(make_reader(row_store, schema_fields=fields,
                                                     **_kw()), 8, seed=1) as loader:
        ours = list(loader)
    with ref_adapters.InMemBatchedDataLoader(ref_reader.make_reader(
            row_store, schema_fields=fields, **_kw()), 8, seed=1) as loader:
        theirs = list(loader)
    _assert_batches_equal(ours, theirs)


def test_per_row_ngram_windows_collate_like_the_reference(row_store):
    fields = {0: ["id", "matrix"], 1: ["id", "x"]}
    with adapters.DataLoader(make_reader(row_store, schema_fields=ngram.NGram(
            fields, 10, "ts"), **_kw()), 3) as loader:
        ours = list(loader)
    with ref_adapters.DataLoader(ref_reader.make_reader(row_store, schema_fields=ref_ngram
                                                        .NGram(fields, 10, "ts"), **_kw()),
                                 3) as loader:
        theirs = list(loader)
    assert len(ours) == len(theirs) and ours
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == [0, 1]
        for off in a:
            assert type(a[off]).__name__ == type(b[off]).__name__
            for x, y in zip(a[off], b[off]):
                assert torch.equal(x, y)
        assert torch.equal(a[1].id, a[0].id + 1)


def test_decimal_friendly_collate_equals_the_references():
    rows = [{"a": 1, "d": decimal.Decimal("1.5"), "t": (np.float32(1), "u")},
            {"a": 2, "d": decimal.Decimal("2.5"), "t": (np.float32(2), "v")}]
    ours = adapters.decimal_friendly_collate(rows)
    theirs = ref_adapters.decimal_friendly_collate(rows)
    assert ours["d"] == theirs["d"] == [decimal.Decimal("1.5"), decimal.Decimal("2.5")]
    assert torch.equal(ours["a"], theirs["a"])
    assert torch.equal(ours["t"][0], theirs["t"][0]) and ours["t"][1] == theirs["t"][1]


def test_a_view_wire_reader_is_copied_out_of_its_slabs(batch_store):
    """Batches of a process pool's ``'shm-view'`` wire view slabs the reader recycles at
    its next fetch; the adapters keep rows across fetches, so they copy them out."""
    kw = _kw(reader_pool_type="process", workers_count=2, wire_serializer="shm-view",
             results_timeout_s=120)
    with adapters.BatchedDataLoader(make_batch_reader(batch_store, **kw), 10,
                                    shuffling_queue_capacity=40, seed=2) as loader:
        assert loader.reader.wire_views
        got = {int(i): float(v) for b in loader for i, v in zip(b["id"], b["v"])}
    with make_batch_reader(batch_store, **_kw()) as r:
        want = {int(i): float(v) for b in r for i, v in zip(b.id, b.v)}
    assert got == want


def test_a_decode_on_device_reader_is_refused_naming_the_card_path(tmp_path):
    import cv2

    from petastorm_tpu_torch.codecs import CompressedImageCodec

    schema = Unischema("J", [
        UnischemaField("id", np.int64, (), ScalarCodec(types.LongType()), False),
        UnischemaField("image", np.uint8, (16, 16, 3), CompressedImageCodec("jpeg", 90),
                       False)])
    url = "file://" + str(tmp_path / "j")
    assert cv2 is not None
    write_dataset(url, schema, ({"id": i, "image": np.full((16, 16, 3), i, np.uint8)}
                                for i in range(4)))
    for factory, cls in ((make_reader, adapters.DataLoader),
                         (make_batch_reader, adapters.BatchedDataLoader),
                         (make_batch_reader, adapters.InMemBatchedDataLoader)):
        with factory(url, decode_on_device=True, reader_pool_type="dummy") as r:
            with pytest.raises(ValueError, match="petastorm_tpu_torch.loader.DataLoader"):
                cls(r)


def test_the_pytorch_alias_and_the_unported_tf_bridges(batch_store):
    from petastorm_tpu_torch import adapters as package
    from petastorm_tpu_torch import pytorch

    for name in ("DataLoader", "BatchedDataLoader", "InMemBatchedDataLoader",
                 "decimal_friendly_collate"):
        assert getattr(pytorch, name) is getattr(adapters, name) is getattr(package, name)
    # the TensorFlow bridges are ported: both build a dataset over a port reader
    from petastorm_tpu_torch.adapters import tf as tf_adapter

    for name in ("make_petastorm_dataset", "tf_tensors"):
        assert getattr(package, name) is getattr(tf_adapter, name)
    try:
        import tensorflow  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="tensorflow"):
            package.make_petastorm_dataset(None)
    else:
        with make_batch_reader(batch_store, **_kw()) as r:
            got = [int(i) for b in package.make_petastorm_dataset(r)
                   for i in b["id"].numpy()]
        assert got == list(range(96))
        with make_batch_reader(batch_store, **_kw()) as r:
            first = package.tf_tensors(r)()
        assert [int(i) for i in first["id"].numpy()] == list(range(12))
    with pytest.raises(AttributeError):
        package.nothing_here


def test_an_error_stops_the_reader(batch_store):
    reader = port_reader.make_batch_reader(batch_store, **_kw())
    with adapters.DataLoader(reader, 10, collate_fn=_boom) as loader:
        with pytest.raises(RuntimeError, match="collate failed"):
            list(loader)
        assert reader.stopped


def _boom(rows):
    raise RuntimeError("collate failed")
