"""Port vs reference: the Spark surface (``petastorm_tpu_torch.spark``,
``spark_utils.dataset_as_rdd``, ``metadata.materialize_dataset`` and the unischema's
Spark veneer) against ``tests/test_spark_contract.py``'s duck-typed session and
DataFrame over real Parquet (pyspark is not installed here).

Each of that file's seven cases runs against the port and is held against the JAX
package on the same frame: the converter materializes the same rows (precision
normalized alike), keys its cache alike and deletes alike; its device loader
(``make_device_dataloader``, the counterpart of the JAX package's
``make_jax_dataloader``) delivers tensors; ``materialize_dataset`` writes a
``_common_metadata`` that both packages read alike; ``dataset_as_rdd`` yields the JAX
package's rows; and without pyspark every entry point raises the JAX package's
``ImportError``.
"""
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu.spark import spark_dataset_converter as ref_conv  # noqa: E402
from petastorm_tpu_torch.spark import spark_dataset_converter as port_conv  # noqa: E402
from test_spark_contract import FakeDataFrame, FakeSparkSession  # noqa: E402


def _no_pyspark():
    try:
        import pyspark  # noqa: F401
    except ImportError:
        return True
    return False


@pytest.fixture
def session(tmp_path):
    s = FakeSparkSession()
    s.conf.set(port_conv.SparkDatasetConverter.PARENT_CACHE_DIR_URL_CONF,
               "file://" + str(tmp_path / "conv_cache"))
    yield s
    port_conv._materialized.clear()
    ref_conv._materialized.clear()


def _frame(session, n=16, extra=(), seed=29):
    rng = np.random.RandomState(seed)
    cols = {"x": rng.standard_normal(n), "y": np.arange(n, dtype=np.int64)}
    types = {"x": "double", "y": "bigint"}
    for name in extra:
        cols[name] = np.ones(n)
        types[name] = "double"
    return FakeDataFrame(session, cols, types)


def _stored(conv):
    return pq.read_table(conv.cache_dir_url[len("file://"):])


def test_the_conf_key_is_the_references():
    assert port_conv.SparkDatasetConverter.PARENT_CACHE_DIR_URL_CONF \
        == ref_conv.SparkDatasetConverter.PARENT_CACHE_DIR_URL_CONF \
        == "petastorm.spark.converter.parentCacheDirUrl"


def test_converter_materializes_and_the_device_loader_reads_back(session):
    df = _frame(session)
    conv = port_conv.make_spark_converter(df)
    theirs = ref_conv.make_spark_converter(_frame(session))
    assert len(conv) == len(theirs) == 16
    assert _stored(conv).equals(_stored(theirs))
    rows = []
    with conv.make_device_dataloader(batch_size=8, num_epochs=1, shuffle_row_groups=False,
                                     device="cpu") as loader:
        for batch in loader:
            assert isinstance(batch["y"], torch.Tensor) and batch["y"].device.type == "cpu"
            rows.extend(batch["y"].tolist())
            np.testing.assert_array_equal(
                batch["x"].numpy(), _stored(conv).column("x").to_numpy()[batch["y"].numpy()])
    assert sorted(rows) == list(range(16))
    assert not hasattr(conv, "make_jax_dataloader")


def test_converter_precision_normalization_casts_doubles(session):
    casts = []
    for mod in (port_conv, ref_conv):
        df = _frame(session)
        conv = mod.make_spark_converter(df, dtype="float32")
        # the cast protocol was exercised on the double column only
        assert ("x", "float") in df.casts and all(c[0] != "y" for c in df.casts)
        assert _stored(conv).schema.field("x").type == pa.float32()
        casts.append(df.casts)
    assert casts[0] == casts[1]


def test_converter_cache_hit_and_distinct_plans(session):
    c1 = port_conv.make_spark_converter(_frame(session))
    c2 = port_conv.make_spark_converter(_frame(session))  # same logical plan: a hit
    assert c1 is c2
    c3 = port_conv.make_spark_converter(_frame(session, extra=("z",)))  # another plan
    assert c3 is not c1 and c3.cache_dir_url != c1.cache_dir_url
    for df in (_frame(session), _frame(session, extra=("z",))):
        for dtype in ("float32", "float64", None):
            assert port_conv._df_cache_key(df, "p", "snappy", dtype) \
                == ref_conv._df_cache_key(df, "p", "snappy", dtype)


def test_converter_delete_removes_dir_and_cache_entry(session):
    conv = port_conv.make_spark_converter(_frame(session))
    path = conv.cache_dir_url[len("file://"):]
    assert os.path.isdir(path)
    conv.delete()
    assert not os.path.exists(path)
    conv2 = port_conv.make_spark_converter(_frame(session))
    assert conv2 is not conv  # the cache entry was forgotten: materialized again
    seen = []
    port_conv.register_delete_dir_handler(seen.append)
    try:
        conv2.delete()
    finally:
        port_conv.register_delete_dir_handler(None)
    assert seen == [conv2.cache_dir_url]


def test_the_torch_and_tf_context_managers(session):
    conv = port_conv.make_spark_converter(_frame(session))
    with conv.make_torch_dataloader(batch_size=4, reader_pool_type="dummy",
                                    shuffle_row_groups=False) as loader:
        ys = [int(v) for b in loader for v in b["y"]]
    assert ys == list(range(16))
    pytest.importorskip("tensorflow")
    with conv.make_tf_dataset(batch_size=5, reader_pool_type="dummy",
                              shuffle_row_groups=False) as ds:
        sizes = [int(b["y"].shape[0]) for b in ds]
    assert sizes == [5, 5, 5, 1]


def test_a_frame_without_plan_identity_is_refused(session):
    class NoIdentity(FakeDataFrame):
        semanticHash = None

    df = NoIdentity(session, {"y": np.arange(4)}, {"y": "bigint"})
    for mod in (port_conv, ref_conv):
        with pytest.raises(ValueError, match="cache identity"):
            mod.make_spark_converter(df)


def test_materialize_dataset_with_fake_session(tmp_path):
    from petastorm_tpu import metadata as ref_metadata
    from petastorm_tpu.fs import get_filesystem_and_path_or_paths as ref_resolve
    from petastorm_tpu.reader import make_reader as ref_make_reader
    from petastorm_tpu_torch import types as ptypes
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths
    from petastorm_tpu_torch.metadata import get_schema, materialize_dataset
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField, encode_row

    schema = Unischema("M", [
        UnischemaField("id", np.int64, (), ScalarCodec(ptypes.LongType()), False),
        UnischemaField("vec", np.float32, (4,), NdarrayCodec(), False),
    ])
    session = FakeSparkSession()
    hadoop = session.sparkContext._jsc.hadoopConfiguration()
    hadoop.set("parquet.block.size", "1234")
    url = "file://" + str(tmp_path / "mds")
    rng = np.random.RandomState(30)
    rows = [{"id": i, "vec": rng.standard_normal(4).astype(np.float32)} for i in range(10)]

    with materialize_dataset(session, url, schema, row_group_size_mb=8):
        # the block sets row-group sizing for the executors (restored after)
        assert hadoop.get("parquet.block.size") == 8 << 20
        encoded = [encode_row(schema, r) for r in rows]
        table = pa.table({"id": [e["id"] for e in encoded],
                          "vec": [bytes(e["vec"]) for e in encoded]},
                         schema=schema.as_arrow_schema())
        os.makedirs(str(tmp_path / "mds"), exist_ok=True)
        pq.write_table(table, str(tmp_path / "mds" / "part-0.parquet"), row_group_size=4)
    assert hadoop.get("parquet.block.size") == "1234"  # restored

    fs, path = get_filesystem_and_path_or_paths(url)
    ours = get_schema(fs, path)
    theirs = ref_metadata.get_schema(*ref_resolve(url))
    assert ours.to_json() == theirs.to_json()
    assert [(p.path, p.row_group) for p in ref_metadata.load_row_groups(*ref_resolve(url))] \
        == [("%s/part-0.parquet" % path, rg) for rg in range(3)]
    want = {r["id"]: r["vec"] for r in rows}
    for factory in (make_reader, ref_make_reader):
        with factory(url, num_epochs=1, shuffle_row_groups=False,
                     reader_pool_type="dummy") as reader:
            got = {row.id: row.vec for row in reader}
        assert sorted(got) == sorted(want)
        for i, v in got.items():
            np.testing.assert_array_equal(v, want[i])


def test_dataset_as_rdd_with_fake_session(tmp_path):
    from petastorm_tpu.spark_utils import dataset_as_rdd as ref_as_rdd
    from petastorm_tpu_torch.spark_utils import dataset_as_rdd
    from test_common import create_test_dataset

    ds = create_test_dataset("file://" + str(tmp_path / "rdd_ds"), num_rows=12, seed=31)
    session = FakeSparkSession()
    ours = dataset_as_rdd(ds.url, session, schema_fields=["id", "matrix"]).collect()
    theirs = ref_as_rdd(ds.url, session, schema_fields=["id", "matrix"]).collect()
    assert len(ours) == len(theirs) == 12
    assert set(ours[0]._fields) == {"id", "matrix"}
    for a, b in zip(ours, theirs):
        assert a.id == b.id
        np.testing.assert_array_equal(a.matrix, b.matrix)
    by_id = {r.id: r for r in ours}
    for expected in ds.data:
        np.testing.assert_array_equal(by_id[expected["id"]].matrix, expected["matrix"])


@pytest.mark.skipif(not _no_pyspark(), reason="pyspark installed: gating not applicable")
def test_every_spark_entry_point_requires_pyspark_cleanly():
    from petastorm_tpu_torch import codecs
    from petastorm_tpu_torch.spark import make_spark_converter
    from petastorm_tpu_torch.unischema import Unischema, dict_to_spark_row

    class FakeDf:
        pass

    with pytest.raises(ImportError, match="pyspark"):
        make_spark_converter(FakeDf())
    with pytest.raises(ImportError, match="pyspark"):
        dict_to_spark_row(None, {})
    with pytest.raises(ImportError, match="pyspark"):
        Unischema("S", []).as_spark_schema()
    with pytest.raises(ImportError, match="pyspark"):
        codecs.NdarrayCodec().spark_dtype()
    from petastorm_tpu.unischema import dict_to_spark_row as ref_dict_to_spark_row

    with pytest.raises(ImportError) as theirs:
        ref_dict_to_spark_row(None, {})
    with pytest.raises(ImportError) as ours:
        dict_to_spark_row(None, {})
    assert type(ours.value) is type(theirs.value)
