"""Port vs reference: hive ``key=value`` partitions. Path parsing, type inference, filter
coercion, directory pruning (file opens counted), partition columns materialised by both
factories and through the ``DataLoader(device="cpu")``, and the
``__HIVE_DEFAULT_PARTITION__`` null directory: the port delivers, per id, the JAX
package's rows and values on the same stores."""
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

from petastorm_tpu import partitions as ref_partitions  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu_torch import partitions  # noqa: E402
from petastorm_tpu_torch import reader as port_reader  # noqa: E402
from petastorm_tpu_torch.loader import DataLoader  # noqa: E402


@pytest.fixture(scope="module")
def hive_dataset(tmp_path_factory):
    """Two-level hive store: date (string) x chunk (int), 3 x 2 directories, 8 rows in
    row groups of 4 each, plus a ``value`` column; rows from a numpy seed."""
    root = tmp_path_factory.mktemp("torch_hive_ds")
    rng = np.random.RandomState(3)
    rows = []
    rid = 0
    for date in ("2020-01-01", "2020-01-02", "2020-01-03"):
        for chunk in (0, 1):
            d = root / ("date=%s" % date) / ("chunk=%d" % chunk)
            os.makedirs(d, exist_ok=True)
            ids = np.arange(rid, rid + 8, dtype=np.int64)
            vals = rng.rand(8)
            pq.write_table(pa.table({"id": ids, "value": vals}), str(d / "part-0.parquet"),
                           row_group_size=4)
            rows += [{"id": int(i), "value": float(v), "date": date, "chunk": chunk}
                     for i, v in zip(ids, vals)]
            rid += 8
    return {"url": "file://" + str(root), "rows": rows}


@pytest.fixture(scope="module")
def hive_petastorm_dataset(tmp_path_factory):
    """A store with a unischema in ``_common_metadata`` whose ``label`` column lives only
    in the hive path (the Spark ``partitionBy`` layout), metadata written by the port."""
    import pyarrow.fs as pafs

    from petastorm_tpu_torch import types
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.metadata import write_petastorm_tpu_metadata
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema("HivePart", [
        UnischemaField("id", np.int64, (), ScalarCodec(types.LongType()), False),
        UnischemaField("value", np.float64, (), ScalarCodec(types.DoubleType()), False),
        UnischemaField("label", np.int32, (), ScalarCodec(types.IntegerType()), False),
    ])
    root = tmp_path_factory.mktemp("torch_hive_ps")
    counts = {}
    rid = 0
    for label in (0, 1, 2):
        d = root / ("label=%d" % label)
        os.makedirs(d, exist_ok=True)
        ids = np.arange(rid, rid + 6, dtype=np.int64)
        pq.write_table(pa.table({"id": ids, "value": ids + 0.25}),
                       str(d / "part-0.parquet"), row_group_size=3)
        counts["label=%d/part-0.parquet" % label] = 2
        rid += 6
    write_petastorm_tpu_metadata(pafs.LocalFileSystem(), str(root), schema, counts)
    return "file://" + str(root)


def _batches_by_id(module, url, **kwargs):
    """{id: {field: value}} of a batch reader of ``module`` (dummy pool)."""
    out = {}
    with module.make_batch_reader(url, reader_pool_type="dummy", **kwargs) as r:
        for b in r:
            cols = b._asdict()
            for i, rid in enumerate(np.asarray(cols["id"])):
                out[int(rid)] = {k: _scalar(v[i]) for k, v in cols.items()}
    return out


def _rows_by_id(module, url, **kwargs):
    out = {}
    with module.make_reader(url, reader_pool_type="dummy", **kwargs) as r:
        for row in r:
            out[int(row.id)] = {k: _scalar(v) for k, v in row._asdict().items()}
    return out


def _scalar(v):
    if isinstance(v, np.generic):
        return (v.item(), v.dtype.str)
    return (v, type(v).__name__)


# -- unit: parsing, inference, coercion, pruning ------------------------------------------


@pytest.mark.parametrize("path", [
    "/data/ds/date=2020-01-01/part-0.parquet", "/data/ds/a=1/b=x%20y/f.parquet",
    "/data/ds/part-0.parquet", "/data/ds/k=__HIVE_DEFAULT_PARTITION__/f.parquet",
    "/data/ds/sub/part-0.parquet", "/data/ds/a%3Db=c%2Fd/f.parquet", "/other/a=1/f.parquet",
], ids=["one", "encoded", "flat", "null", "plain_dir", "encoded_key", "outside_root"])
def test_partition_values_for_path_equal_reference(path):
    got = partitions.partition_values_for_path(path, "/data/ds")
    assert got == ref_partitions.partition_values_for_path(path, "/data/ds")
    assert list(got) == list(ref_partitions.partition_values_for_path(path, "/data/ds"))


@pytest.mark.parametrize("raw", [
    [{"a": "1", "b": "1.5", "c": "x"}, {"a": "2", "b": "2", "c": "y"}],
    [{"n": "-3"}, {"n": "7"}, {"n": None}],
    [{"f": "1e3"}, {"f": "nan"}, {"f": "2"}],
    [{"s": "01"}, {"s": "x1"}],
    [{}, {}],
], ids=["mixed", "int_with_null", "float", "string", "flat"])
def test_type_inference_equal_reference(raw):
    info = partitions.build_partition_info(raw)
    want = ref_partitions.build_partition_info(raw)
    assert bool(info) == bool(want) and info.keys == want.keys
    assert info.numpy_dtypes == want.numpy_dtypes
    for values in raw:
        got, exp = info.typed_values(values), want.typed_values(values)
        assert got.keys() == exp.keys()
        for k in got:
            assert type(got[k]) is type(exp[k])
            assert got[k] == exp[k] or (got[k] != got[k] and exp[k] != exp[k])  # nan
    fields = partitions.partition_fields(info, nullable=True)
    ref_fields = ref_partitions.partition_fields(want, nullable=True)
    assert [(f.name, f.numpy_dtype, f.shape, f.nullable) for f in fields] == \
        [(f.name, f.numpy_dtype, f.shape, f.nullable) for f in ref_fields]


def test_inconsistent_partitioning_raises_like_the_reference():
    with pytest.raises(ValueError, match="Inconsistent") as err:
        partitions.build_partition_info([{"a": "1"}, {}])
    with pytest.raises(ValueError) as ref_err:
        ref_partitions.build_partition_info([{"a": "1"}, {}])
    assert str(err.value) == str(ref_err.value)


FILTERS = [
    [("chunk", "=", "1")], [("chunk", "in", ["0", "1"])], [("chunk", "in", {"1"})],
    [[("date", "=", "2020-01-02")], [("chunk", "<", "1"), ("id", ">", 3)]],
    [("chunk", "=", "one")], [("value", ">", 0.5)],
]


@pytest.mark.parametrize("flt", FILTERS, ids=["eq", "in_list", "in_set", "or_of_ands",
                                              "uncoercible", "not_a_partition"])
def test_filter_coercion_and_directory_pruning_equal_reference(hive_dataset, flt):
    raw = [{"date": d, "chunk": str(c)} for d in ("2020-01-01", "2020-01-02", "2020-01-03")
           for c in (0, 1)]
    info, ref_info = partitions.build_partition_info(raw), \
        ref_partitions.build_partition_info(raw)
    norm = partitions.normalize_filters(flt, info)
    ref_norm = ref_partitions.normalize_filters(flt, ref_info)
    assert norm == ref_norm and repr(norm) == repr(ref_norm)
    for values in raw:
        typed = info.typed_values(values)
        assert partitions.piece_matches_filters(typed, norm, info.keys) == \
            ref_partitions.piece_matches_filters(typed, ref_norm, ref_info.keys)


@pytest.mark.parametrize("op,val", [("=", "a"), ("!=", "a"), ("in", ["a"]),
                                    ("in", ["a", None]), ("not in", ["a"]), ("<", "b")])
def test_null_directory_matches_like_the_reference(op, val):
    keys = ("k",)
    for value in ("a", None):
        got = partitions.piece_matches_filters({"k": value}, [("k", op, val)], keys)
        assert got == ref_partitions.piece_matches_filters({"k": value}, [("k", op, val)],
                                                           keys)


def test_attach_partition_columns_equal_reference():
    from petastorm_tpu_torch.metadata import RowGroupPiece

    raw = [{"d": "x", "n": "3", "f": "1.5"}, {"d": partitions.HIVE_NULL, "n": "4", "f": "2"}]
    raw = [{k: (None if v == partitions.HIVE_NULL else v) for k, v in r.items()} for r in raw]
    info = partitions.build_partition_info(raw)
    ref_info = ref_partitions.build_partition_info(raw)
    table = pa.table({"id": np.arange(5), "n": np.arange(5) * 10})  # n stored inline too
    for pv in raw:
        piece = RowGroupPiece("/p", 0, 5, pv)
        for wanted in (None, {"d", "id"}):
            got = partitions.attach_partition_columns(table, piece, info, wanted)
            want = ref_partitions.attach_partition_columns(table, piece, ref_info, wanted)
            assert got.equals(want)


# -- readers ---------------------------------------------------------------------------


def test_batch_reader_materializes_partition_columns_like_the_reference(hive_dataset):
    got = _batches_by_id(port_reader, hive_dataset["url"], shuffle_row_groups=False)
    want = _batches_by_id(ref_reader, hive_dataset["url"], shuffle_row_groups=False)
    assert got == want and len(got) == len(hive_dataset["rows"])
    for r in hive_dataset["rows"]:
        assert got[r["id"]]["date"] == (r["date"], "str")
        assert got[r["id"]]["chunk"] == (r["chunk"], "<i8")  # int64, as inferred


@pytest.mark.parametrize("flt", FILTERS[:5] + [[("date", "=", "2020-01-01"), ("id", ">=", 4)],
                                               [("chunk", "<", "1")]],
                         ids=["eq", "in_list", "in_set", "or_of_ands", "uncoercible",
                              "partition_and_row", "string_lt"])
def test_batch_reader_filters_deliver_the_references_rows(hive_dataset, flt):
    if flt == [("chunk", "=", "one")]:  # prunes everything: both refuse
        with pytest.raises(Exception) as err:
            port_reader.make_batch_reader(hive_dataset["url"], filters=flt)
        with pytest.raises(Exception) as ref_err:
            ref_reader.make_batch_reader(hive_dataset["url"], filters=flt)
        assert type(err.value).__name__ == type(ref_err.value).__name__ \
            == "NoDataAvailableError"
        return
    got = _batches_by_id(port_reader, hive_dataset["url"], filters=flt)
    assert got == _batches_by_id(ref_reader, hive_dataset["url"], filters=flt)
    assert got


def test_partition_filter_prunes_file_opens(hive_dataset, monkeypatch):
    """Directory pruning happens before scheduling: only the matching directories'
    files are ever opened."""
    opened = set()
    orig = port_reader._WorkerBase._parquet_file

    def counting(self, path):
        opened.add(path)
        return orig(self, path)

    monkeypatch.setattr(port_reader._WorkerBase, "_parquet_file", counting)
    with port_reader.make_batch_reader(hive_dataset["url"],
                                       filters=[("date", "=", "2020-01-02")]) as reader:
        ids = sorted(int(x) for b in reader for x in np.asarray(b.id))
        assert reader._num_items == 4  # 2 chunks x 2 row groups: 1/3 of the 12
    assert ids == sorted(r["id"] for r in hive_dataset["rows"] if r["date"] == "2020-01-02")
    assert len(opened) == 2 and all("date=2020-01-02" in p for p in opened)


def test_schema_fields_select_a_partition_column(hive_dataset):
    kw = dict(schema_fields=["id", "chunk"], shuffle_row_groups=False)
    got = _batches_by_id(port_reader, hive_dataset["url"], **kw)
    assert got == _batches_by_id(ref_reader, hive_dataset["url"], **kw)
    assert set(next(iter(got.values()))) == {"id", "chunk"}


def test_sharding_composes_with_pruning(hive_dataset):
    kw = dict(filters=[("chunk", "=", 1)], shard_count=2, shard_seed=1)
    union = {}
    for shard in (0, 1):
        got = _batches_by_id(port_reader, hive_dataset["url"], cur_shard=shard, **kw)
        assert got == _batches_by_id(ref_reader, hive_dataset["url"], cur_shard=shard, **kw)
        assert not set(got) & set(union)
        union.update(got)
    assert sorted(union) == sorted(r["id"] for r in hive_dataset["rows"] if r["chunk"] == 1)


def test_make_reader_partition_column_in_the_schema(hive_petastorm_dataset):
    """Per-row path: the declared partition column decodes from the directory value
    through its codec (int32), rows equal to the reference's."""
    got = _rows_by_id(port_reader, hive_petastorm_dataset, shuffle_row_groups=False)
    assert got == _rows_by_id(ref_reader, hive_petastorm_dataset, shuffle_row_groups=False)
    assert len(got) == 18 and all(r["label"][1] == "<i4" for r in got.values())


def test_make_reader_filter_prunes_file_opens(hive_petastorm_dataset, monkeypatch):
    opened = set()
    orig = port_reader._WorkerBase._parquet_file

    def counting(self, path):
        opened.add(path)
        return orig(self, path)

    monkeypatch.setattr(port_reader._WorkerBase, "_parquet_file", counting)
    flt = [("label", "in", [0, 2])]
    with port_reader.make_reader(hive_petastorm_dataset, filters=flt) as reader:
        assert reader._num_items == 4
        ids = sorted(int(r.id) for r in reader)
    assert ids == sorted(_rows_by_id(ref_reader, hive_petastorm_dataset, filters=flt))
    assert len(opened) == 2 and not any("label=1" in p for p in opened)


def test_null_partition_directory_like_the_reference(tmp_path):
    from petastorm_tpu_torch.predicates import in_negate, in_set

    from petastorm_tpu.predicates import in_negate as ref_negate, in_set as ref_in_set

    rid = 0
    for seg in ("k=a", "k=" + partitions.HIVE_NULL):
        d = tmp_path / seg
        os.makedirs(d, exist_ok=True)
        pq.write_table(pa.table({"id": np.arange(rid, rid + 4, dtype=np.int64)}),
                       str(d / "f.parquet"))
        rid += 4
    url = "file://" + str(tmp_path)
    got = _batches_by_id(port_reader, url, shuffle_row_groups=False)
    assert got == _batches_by_id(ref_reader, url, shuffle_row_groups=False)
    assert [got[i]["k"][0] for i in range(8)] == ["a"] * 4 + [None] * 4
    for flt, want in (([("k", "=", "a")], [0, 1, 2, 3]), ([("k", "!=", "a")], [4, 5, 6, 7]),
                      ([("k", "not in", ["a"])], [4, 5, 6, 7])):
        assert sorted(_batches_by_id(port_reader, url, filters=flt)) == want
        assert sorted(_batches_by_id(ref_reader, url, filters=flt)) == want
    assert sorted(_batches_by_id(port_reader, url, predicate=in_negate(in_set({"a"}, "k")))) \
        == sorted(_batches_by_id(ref_reader, url,
                                 predicate=ref_negate(ref_in_set({"a"}, "k")))) == [4, 5, 6, 7]


def test_partition_columns_through_the_dataloader(hive_dataset):
    """Partition columns ride the loader like any column: the numeric one reaches the
    device as a tensor, the string one stays on the host; values per id equal the JAX
    package's batch reader."""
    want = _batches_by_id(ref_reader, hive_dataset["url"], shuffle_row_groups=False)
    reader = port_reader.make_batch_reader(hive_dataset["url"], shuffle_row_groups=False,
                                           reader_pool_type="dummy",
                                           filters=[("chunk", "=", 1)])
    got = {}
    with DataLoader(reader, 4, device="cpu", last_batch="partial") as loader:
        for batch in loader:
            assert isinstance(batch["chunk"], torch.Tensor)
            assert batch["chunk"].dtype == torch.int64
            assert not isinstance(batch["date"], torch.Tensor)
            for i, rid in enumerate(batch["id"].tolist()):
                got[rid] = (batch["date"][i], int(batch["chunk"][i]),
                            float(batch["value"][i]))
    assert sorted(got) == sorted(k for k, v in want.items() if v["chunk"][0] == 1)
    for rid, (date, chunk, value) in got.items():
        assert (date, chunk, value) == (want[rid]["date"][0], want[rid]["chunk"][0],
                                        want[rid]["value"][0])
