"""Vanilla-Parquet type coverage through the port's ``make_batch_reader``: the JAX
package's ``tests/test_parquet_types.py`` case for case, over the same pools, each case
also read by the JAX package's reader.

Comparison level: bit-exact. Every column of every batch equals the JAX reader's batch
for batch (dtype and values; object columns element for element) on a one-worker
plan-order read; reads over several workers compare the same rows by id.
"""
import datetime
import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

import petastorm_tpu as ref  # noqa: E402
from petastorm_tpu_torch import make_batch_reader  # noqa: E402


def _write(tmp_path, table, row_group_size=None):
    path = tmp_path / "store"
    path.mkdir()
    pq.write_table(table, str(path / "part-0.parquet"),
                   row_group_size=row_group_size or table.num_rows)
    return "file://" + str(path)


def _batches(factory, url, **kw):
    out = []
    with factory(url, num_epochs=1, **kw) as reader:
        for batch in reader:
            d = batch._asdict() if hasattr(batch, "_asdict") else dict(batch)
            out.append({k: np.asarray(v) if not isinstance(v, np.ndarray) else v
                        for k, v in d.items()})
    return out


def _concat(batches):
    cols = {}
    for b in batches:
        for k, v in b.items():
            cols.setdefault(k, []).append(v)
    return {k: np.concatenate(v) for k, v in cols.items()}


def _read_all(url, **kw):
    return _concat(_batches(make_batch_reader, url, **kw))


def _same_value(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and (
            np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")
            if a.dtype != object else all(_same_value(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a) and np.isnan(b):
        return True
    return type(a) is type(b) and a == b


def _assert_same_columns(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for name in ours:
        assert _same_value(ours[name], theirs[name]), name


def _assert_as_reference(url, order_by=None, **kw):
    """The port's read equals the JAX reader's: batch for batch in plan order on one
    worker, or row for row by ``order_by`` when several workers race."""
    ours = _batches(make_batch_reader, url, **kw)
    theirs = _batches(ref.make_batch_reader, url, **kw)
    if order_by is None:
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            _assert_same_columns(a, b)
        return
    a, b = _concat(ours), _concat(theirs)
    ia, ib = np.argsort(a[order_by], kind="stable"), np.argsort(b[order_by], kind="stable")
    _assert_same_columns({k: v[ia] for k, v in a.items()},
                         {k: v[ib] for k, v in b.items()})


N = 7


@pytest.fixture(scope="module")
def typed_table():
    rng = np.random.RandomState(5)
    data = {
        "i8": pa.array(rng.randint(-100, 100, N).astype(np.int8), pa.int8()),
        "i16": pa.array(rng.randint(-1000, 1000, N).astype(np.int16), pa.int16()),
        "i32": pa.array(rng.randint(-10**6, 10**6, N).astype(np.int32), pa.int32()),
        "i64": pa.array(rng.randint(-10**12, 10**12, N), pa.int64()),
        "u8": pa.array(rng.randint(0, 255, N).astype(np.uint8), pa.uint8()),
        "f32": pa.array(rng.randn(N).astype(np.float32), pa.float32()),
        "f64": pa.array(rng.randn(N), pa.float64()),
        "flag": pa.array(rng.randint(0, 2, N).astype(bool), pa.bool_()),
        "s": pa.array(["row-%d" % i for i in range(N)], pa.string()),
        "ls": pa.array(["large-%d" % i for i in range(N)], pa.large_string()),
        "raw": pa.array([b"\x00\x01" * i for i in range(N)], pa.binary()),
        "d32": pa.array([datetime.date(2020, 1, 1 + i) for i in range(N)],
                        pa.date32()),
        "ts_s": pa.array([datetime.datetime(2021, 3, 4, 5, 6, i) for i in range(N)],
                         pa.timestamp("s")),
        "ts_us": pa.array([datetime.datetime(2021, 3, 4, 5, 6, 0, i * 11)
                           for i in range(N)], pa.timestamp("us")),
        "ts_ns": pa.array(np.arange(N) * 1_000_003, pa.timestamp("ns")),
        "dec": pa.array([decimal.Decimal("12.345") + i for i in range(N)],
                        pa.decimal128(12, 3)),
        "vec": pa.array([np.arange(4, dtype=np.float32) + i for i in range(N)],
                        pa.list_(pa.float32())),
        "fvec": pa.array([np.full(3, i, dtype=np.int64) for i in range(N)],
                         pa.list_(pa.int64(), 3)),
    }
    return pa.table(data)


@pytest.mark.parametrize("pool", ["dummy", "thread", "process"])
def test_all_types_roundtrip(tmp_path_factory, typed_table, pool):
    url = _write(tmp_path_factory.mktemp("types_%s" % pool), typed_table)
    got = _read_all(url, reader_pool_type=pool, workers_count=2)
    t = typed_table

    for name, np_dtype in [("i8", np.int8), ("i16", np.int16), ("i32", np.int32),
                           ("i64", np.int64), ("u8", np.uint8),
                           ("f32", np.float32), ("f64", np.float64),
                           ("flag", np.bool_)]:
        assert got[name].dtype == np_dtype, name
        np.testing.assert_array_equal(got[name], t[name].to_numpy())

    # strings arrive as numpy object/str arrays with the exact values
    assert list(got["s"]) == t["s"].to_pylist()
    assert list(got["ls"]) == t["ls"].to_pylist()
    assert [bytes(v) for v in got["raw"]] == t["raw"].to_pylist()

    # dates/timestamps arrive as datetime64 of the stored unit
    assert got["d32"].dtype.kind == "M"
    np.testing.assert_array_equal(got["d32"].astype("datetime64[D]"),
                                  np.array(t["d32"].to_pylist(), "datetime64[D]"))
    for name in ("ts_s", "ts_us", "ts_ns"):
        assert got[name].dtype.kind == "M", name
        np.testing.assert_array_equal(
            got[name].astype("datetime64[ns]"),
            t[name].cast(pa.timestamp("ns")).to_numpy())

    # decimals keep exact Decimal values (reference: decimal columns stay objects)
    assert [decimal.Decimal(str(v)) for v in got["dec"]] == t["dec"].to_pylist()

    # list columns stack to (rows, len) tensors
    assert got["vec"].shape == (N, 4) and got["vec"].dtype == np.float32
    np.testing.assert_array_equal(got["vec"], np.stack(t["vec"].to_pylist()))
    assert got["fvec"].shape == (N, 3) and got["fvec"].dtype == np.int64
    np.testing.assert_array_equal(got["fvec"], np.stack(t["fvec"].to_pylist()))

    # one row group: one batch, the JAX reader's on the same pool
    _assert_as_reference(url, reader_pool_type=pool, workers_count=2)


def test_nulls_in_nullable_columns(tmp_path_factory):
    table = pa.table({
        "id": pa.array(np.arange(6), pa.int64()),
        "maybe_f": pa.array([1.5, None, 2.5, None, 3.5, None], pa.float64()),
        "maybe_i": pa.array([1, None, 3, None, 5, None], pa.int32()),
        "maybe_s": pa.array(["a", None, "c", None, "e", None], pa.string()),
        "maybe_vec": pa.array([[1.0, 2.0], None, [3.0, 4.0], None, [5.0, 6.0], None],
                              pa.list_(pa.float64())),
    })
    url = _write(tmp_path_factory.mktemp("nulls"), table)
    got = _read_all(url)
    order = np.argsort(got["id"])
    f = got["maybe_f"][order]
    assert np.isnan(f[1]) and f[0] == 1.5  # float nulls -> NaN
    i = got["maybe_i"][order]
    assert i[0] == 1  # int nulls: masked/NaN-promoted or None-object, but values intact
    s = got["maybe_s"][order]
    assert s[0] == "a" and s[1] is None
    v = got["maybe_vec"][order]
    assert v[1] is None and np.array_equal(v[0], [1.0, 2.0])
    _assert_as_reference(url, reader_pool_type="dummy")


def test_schema_fields_projection_and_regex(tmp_path_factory, typed_table):
    url = _write(tmp_path_factory.mktemp("proj"), typed_table)
    got = _read_all(url, schema_fields=["i64", "f32"])
    assert set(got) == {"i64", "f32"}
    got = _read_all(url, schema_fields=["ts_.*"])
    assert set(got) == {"ts_s", "ts_us", "ts_ns"}
    for fields in (["i64", "f32"], ["ts_.*"]):
        _assert_as_reference(url, schema_fields=fields, reader_pool_type="dummy")


def test_ragged_list_column_stays_object(tmp_path_factory):
    """Rows of different list lengths cannot stack: object array of per-row arrays."""
    table = pa.table({
        "id": pa.array(np.arange(4), pa.int64()),
        "r": pa.array([[1.0], [1.0, 2.0], [], [1.0, 2.0, 3.0]], pa.list_(pa.float64())),
    })
    url = _write(tmp_path_factory.mktemp("ragged"), table)
    got = _read_all(url)
    order = np.argsort(got["id"])
    r = got["r"][order]
    assert got["r"].dtype == object
    np.testing.assert_array_equal(r[1], [1.0, 2.0])
    assert len(r[2]) == 0
    _assert_as_reference(url, reader_pool_type="dummy")


def test_multi_rowgroup_store_reads_all(tmp_path_factory, typed_table):
    url = _write(tmp_path_factory.mktemp("rg"), typed_table, row_group_size=2)
    got = _read_all(url, workers_count=2, reader_pool_type="thread")
    assert sorted(got["i64"]) == sorted(typed_table["i64"].to_numpy())
    _assert_as_reference(url, order_by="i64", workers_count=2, reader_pool_type="thread")
    _assert_as_reference(url, reader_pool_type="dummy", shuffle_row_groups=False)


def test_dictionary_encoded_columns_transparent(tmp_path_factory):
    """Dictionary-encoded (categorical) columns decode to plain values; the encoding is
    a storage detail."""
    table = pa.table({
        "id": pa.array(np.arange(12), pa.int64()),
        "cat": pa.array(["red", "green", "blue"] * 4).dictionary_encode(),
    })
    url = _write(tmp_path_factory.mktemp("dict"), table)
    got = _read_all(url)
    order = np.argsort(got["id"])
    assert [str(v) for v in got["cat"][order][:3]] == ["red", "green", "blue"]
    _assert_as_reference(url, reader_pool_type="dummy")


def test_timezone_aware_timestamps(tmp_path_factory):
    """tz-aware timestamps arrive as ABSOLUTE UTC instants, not wall-clock local."""
    from zoneinfo import ZoneInfo

    ny = ZoneInfo("America/New_York")
    base = datetime.datetime(2022, 6, 1, 12, 0, 0, tzinfo=ny)  # = 16:00 UTC (EDT)
    table = pa.table({
        "id": pa.array(np.arange(4), pa.int64()),
        "ts": pa.array([base + datetime.timedelta(hours=i) for i in range(4)],
                       pa.timestamp("us", tz="America/New_York")),
    })
    url = _write(tmp_path_factory.mktemp("tz"), table)
    got = _read_all(url)
    order = np.argsort(got["id"])
    ts = got["ts"][order]
    assert ts.dtype.kind == "M"
    # the UTC instant, NOT the 12:00 New York wall-clock value
    assert ts[0].astype("datetime64[s]") == np.datetime64("2022-06-01T16:00:00")
    deltas = np.diff(ts).astype("timedelta64[s]").astype(int)
    assert list(deltas) == [3600] * 3  # hourly spacing preserved as instants
    _assert_as_reference(url, reader_pool_type="dummy")


def test_large_binary_and_large_list(tmp_path_factory):
    table = pa.table({
        "id": pa.array(np.arange(5), pa.int64()),
        "lb": pa.array([b"x" * (i + 1) for i in range(5)], pa.large_binary()),
        "ll": pa.array([np.arange(3, dtype=np.float64) * i for i in range(5)],
                       pa.large_list(pa.float64())),
    })
    url = _write(tmp_path_factory.mktemp("large"), table)
    got = _read_all(url)
    order = np.argsort(got["id"])
    assert [len(bytes(v)) for v in got["lb"][order]] == [1, 2, 3, 4, 5]
    assert got["ll"].shape == (5, 3)
    np.testing.assert_allclose(got["ll"][order][2], [0.0, 2.0, 4.0])
    _assert_as_reference(url, reader_pool_type="dummy")


def test_zero_row_store_yields_empty_read(tmp_path_factory):
    """A parquet file with zero rows still has a (single, empty) row group: the
    reader constructs and delivers an empty read — it does not error."""
    url = _write(tmp_path_factory.mktemp("empty"),
                 pa.table({"id": pa.array([], pa.int64())}), row_group_size=1)
    with make_batch_reader(url, reader_pool_type="dummy") as reader:
        total = sum(len(b.id) for b in reader)
    assert total == 0
    _assert_as_reference(url, reader_pool_type="dummy")


def test_many_tiny_files_single_row_groups(tmp_path_factory):
    """60 one-row files: enumeration, scheduling, and delivery stay exact."""
    tmp = tmp_path_factory.mktemp("tiny")
    path = tmp / "store"
    path.mkdir()
    for i in range(60):
        pq.write_table(pa.table({"id": pa.array([i], pa.int64())}),
                       str(path / ("part-%03d.parquet" % i)))
    url = "file://" + str(path)
    got = _read_all(url, workers_count=4, reader_pool_type="thread")
    assert sorted(got["id"].tolist()) == list(range(60))
    _assert_as_reference(url, reader_pool_type="dummy", shuffle_row_groups=False)
