"""The port's metadata and write path against the JAX package's
``tests/test_metadata.py``, case for case, plus both directions across packages: a store
written by ``petastorm_tpu.metadata`` read by the port, and the reverse.

Comparison level: bit-exact (schema fields, row-group pieces in order, decoded values,
the ``_common_metadata`` key-value pairs and the data tables of one write).
"""
import os
import pickle

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

import petastorm_tpu as ref_pkg  # noqa: E402
import petastorm_tpu.codecs as ref_codecs  # noqa: E402
import petastorm_tpu.errors as ref_errors  # noqa: E402
import petastorm_tpu.fs as ref_fs  # noqa: E402
import petastorm_tpu.metadata as ref_md  # noqa: E402
import petastorm_tpu.types as ref_types  # noqa: E402
import petastorm_tpu.unischema as ref_us  # noqa: E402
import petastorm_tpu.utils as ref_utils  # noqa: E402
import petastorm_tpu_torch as port_pkg  # noqa: E402
from petastorm_tpu_torch import types as ptypes  # noqa: E402
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec  # noqa: E402
from petastorm_tpu_torch.errors import MetadataError  # noqa: E402
from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths  # noqa: E402
from petastorm_tpu_torch.metadata import (  # noqa: E402
    PTPU_SCHEMA_KEY,
    RowGroupPiece,
    RowWriter,
    get_schema,
    get_schema_from_dataset_url,
    infer_or_load_unischema,
    load_row_groups,
    write_dataset,
)
from petastorm_tpu_torch.unischema import Unischema, UnischemaField  # noqa: E402
from petastorm_tpu_torch.utils import decode_row  # noqa: E402


@pytest.fixture
def schema():
    return Unischema(
        "M",
        [
            UnischemaField("id", np.int64, (), ScalarCodec(ptypes.LongType()), False),
            UnischemaField("vec", np.float32, (4,), NdarrayCodec(), False),
        ],
    )


@pytest.fixture
def ref_schema():
    return ref_us.Unischema(
        "M",
        [
            ref_us.UnischemaField("id", np.int64, (),
                                  ref_codecs.ScalarCodec(ref_types.LongType()), False),
            ref_us.UnischemaField("vec", np.float32, (4,), ref_codecs.NdarrayCodec(), False),
        ],
    )


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    return [{"id": i, "vec": rng.standard_normal(4).astype(np.float32)} for i in range(n)]


def _fields(schema):
    return [(f.name, np.dtype(f.numpy_dtype), tuple(f.shape), bool(f.nullable),
             None if f.codec is None else type(f.codec).__name__)
            for f in schema.fields.values()]


def _pieces(pieces):
    return [(p.path, p.row_group, p.num_rows) for p in pieces]


def test_write_and_recover_schema(tmp_path, schema, ref_schema):
    url = "file://" + str(tmp_path / "ds")
    write_dataset(url, schema, _rows(10, 1))
    back = get_schema_from_dataset_url(url)
    assert list(back.fields.keys()) == ["id", "vec"]
    assert back.vec.shape == (4,)
    assert isinstance(back.vec.codec, NdarrayCodec)
    ref_url = "file://" + str(tmp_path / "ref_ds")
    ref_md.write_dataset(ref_url, ref_schema, _rows(10, 1))
    assert _fields(back) == _fields(ref_md.get_schema_from_dataset_url(ref_url)) \
        == _fields(ref_md.get_schema_from_dataset_url(url)) \
        == _fields(get_schema_from_dataset_url(ref_url))


def test_row_group_pieces_from_kv(tmp_path, schema):
    url = str(tmp_path / "ds")
    write_dataset(url, schema, _rows(20, 2), rows_per_file=10)
    fs, path = get_filesystem_and_path_or_paths(url)
    pieces = load_row_groups(fs, path)
    assert len(pieces) >= 2
    assert all(isinstance(p, RowGroupPiece) for p in pieces)
    # KV fast-path does not know num_rows
    assert all(p.num_rows == -1 for p in pieces)
    # footer scan agrees on count
    validated = load_row_groups(fs, path, validate=True)
    assert len(validated) == len(pieces)
    assert sum(p.num_rows for p in validated) == 20
    ref_fsys, ref_path = ref_fs.get_filesystem_and_path_or_paths(url)
    assert _pieces(pieces) == _pieces(ref_md.load_row_groups(ref_fsys, ref_path))
    assert _pieces(validated) == _pieces(ref_md.load_row_groups(ref_fsys, ref_path,
                                                                validate=True))


def test_rows_readable_via_pieces(tmp_path, schema, ref_schema):
    url = str(tmp_path / "ds")
    rows = _rows(15, 3)
    write_dataset(url, schema, rows, rows_per_file=8)
    fs, path = get_filesystem_and_path_or_paths(url)
    seen = {}
    for piece in load_row_groups(fs, path, validate=True):
        with fs.open_input_file(piece.path) as f:
            table = pq.ParquetFile(f).read_row_group(piece.row_group)
        for stored in table.to_pylist():
            d = decode_row(stored, schema)
            seen[d["id"]] = d["vec"]
            theirs = ref_utils.decode_row(stored, ref_schema)
            np.testing.assert_array_equal(theirs["vec"], d["vec"])
    assert sorted(seen.keys()) == list(range(15))
    np.testing.assert_array_equal(seen[3], rows[3]["vec"])


def test_vanilla_parquet_infer(tmp_path):
    table = pa.table({"a": [1, 2, 3], "b": [1.0, 2.0, 3.0]})
    p = tmp_path / "vanilla"
    p.mkdir()
    pq.write_table(table, p / "x.parquet")
    fs, path = get_filesystem_and_path_or_paths(str(p))
    schema = infer_or_load_unischema(fs, path)
    assert schema.a.codec is None
    with pytest.raises(MetadataError):
        get_schema(fs, path)
    pieces = load_row_groups(fs, path)
    assert len(pieces) == 1 and pieces[0].num_rows == 3
    ref_fsys, ref_path = ref_fs.get_filesystem_and_path_or_paths(str(p))
    assert _fields(schema) == _fields(ref_md.infer_or_load_unischema(ref_fsys, ref_path))
    assert _pieces(pieces) == _pieces(ref_md.load_row_groups(ref_fsys, ref_path))
    with pytest.raises(ref_errors.MetadataError) as theirs:
        ref_md.get_schema(ref_fsys, ref_path)
    with pytest.raises(MetadataError) as ours:
        get_schema(fs, path)
    # the port's message also names materialize_dataset; both point at the batch reader
    for err in (ours.value, theirs.value):
        assert str(err).startswith("Dataset at '%s'" % path) or path in str(err)
        assert "Use make_batch_reader for vanilla Parquet stores." in str(err)


def test_common_metadata_has_native_key(tmp_path, schema, ref_schema):
    url = str(tmp_path / "ds")
    write_dataset(url, schema, _rows(5, 4))
    md = pq.read_schema(str(tmp_path / "ds" / "_common_metadata")).metadata
    assert PTPU_SCHEMA_KEY in md
    assert PTPU_SCHEMA_KEY == ref_md.PTPU_SCHEMA_KEY
    ref_md.write_dataset(str(tmp_path / "ref"), ref_schema, _rows(5, 4))
    theirs = pq.read_schema(str(tmp_path / "ref" / "_common_metadata")).metadata
    # the same keys and the same native schema payload; the row-group map names files
    # of the same names
    assert sorted(md) == sorted(theirs)
    assert md[PTPU_SCHEMA_KEY] == theirs[PTPU_SCHEMA_KEY]
    ours_files = sorted(f for f in os.listdir(tmp_path / "ds") if f.endswith(".parquet"))
    ref_files = sorted(f for f in os.listdir(tmp_path / "ref") if f.endswith(".parquet"))
    assert ours_files == ref_files
    for name in ours_files:
        assert pq.read_table(tmp_path / "ds" / name).equals(
            pq.read_table(tmp_path / "ref" / name))


def test_reference_pickled_schema_readable(tmp_path, schema, ref_schema):
    """Simulate a dataset written by real petastorm: pickled schema under the reference
    key. The JAX package reads the same file to the same fields."""
    url = str(tmp_path / "refds")
    write_dataset(url, schema, _rows(5, 5))
    # Rewrite _common_metadata with a reference-style pickled payload. The pickle references
    # the port's classes; rewrite module names to 'petastorm.*' to simulate the reference.
    payload = pickle.dumps(schema, protocol=2)
    payload = payload.replace(b"petastorm_tpu_torch.unischema", b"petastorm.unischema")
    payload = payload.replace(b"petastorm_tpu_torch.codecs", b"petastorm.codecs")
    # GLOBAL opcode module names are newline-terminated, so differing lengths are fine
    payload = payload.replace(b"petastorm_tpu_torch.types", b"pyspark.sql.types")
    assert b"petastorm_tpu" not in payload
    arrow_schema = schema.as_arrow_schema().with_metadata(
        {b"dataset-toolkit.unischema.v1": payload}
    )
    pq.write_metadata(arrow_schema, str(tmp_path / "refds" / "_common_metadata"))
    fs, path = get_filesystem_and_path_or_paths(url)
    back = get_schema(fs, path)
    assert list(back.fields.keys()) == ["id", "vec"]
    ref_fsys, ref_path = ref_fs.get_filesystem_and_path_or_paths(url)
    assert _fields(back) == _fields(ref_md.get_schema(ref_fsys, ref_path))


def test_writer_context_manager_no_metadata_on_error(tmp_path, schema, ref_schema):
    url = str(tmp_path / "err")
    with pytest.raises(RuntimeError):
        with RowWriter(url, schema) as w:
            w.write({"id": 0, "vec": np.zeros(4, np.float32)})
            raise RuntimeError("boom")
    fs, path = get_filesystem_and_path_or_paths(url)
    with pytest.raises(MetadataError):
        get_schema(fs, path)
    ref_url = str(tmp_path / "ref_err")
    with pytest.raises(RuntimeError):
        with ref_md.RowWriter(ref_url, ref_schema) as w:
            w.write({"id": 0, "vec": np.zeros(4, np.float32)})
            raise RuntimeError("boom")
    assert sorted(os.listdir(url)) == sorted(os.listdir(ref_url))


# -- across packages ----------------------------------------------------------------------


def _read_all(pkg, url):
    with pkg.make_reader(url, reader_pool_type="dummy", shuffle_row_groups=False) as r:
        return {int(row.id): row.vec for row in r}


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_store_written_by_one_package_reads_in_the_other(tmp_path, schema, ref_schema,
                                                         writer):
    """A store written by ``petastorm_tpu.metadata`` reads in the port, and the
    reverse: the same schema, the same pieces and the same rows through both."""
    url = "file://" + str(tmp_path / "ds")
    rows = _rows(24, 6)
    if writer == "ref":
        ref_md.write_dataset(url, ref_schema, rows, rows_per_file=8)
    else:
        write_dataset(url, schema, rows, rows_per_file=8)
    fs, path = get_filesystem_and_path_or_paths(url)
    ref_fsys, ref_path = ref_fs.get_filesystem_and_path_or_paths(url)
    assert _fields(get_schema(fs, path)) == _fields(ref_md.get_schema(ref_fsys, ref_path))
    for validate in (False, True):
        assert _pieces(load_row_groups(fs, path, validate=validate)) == \
            _pieces(ref_md.load_row_groups(ref_fsys, ref_path, validate=validate))
    ours, theirs = _read_all(port_pkg, url), _read_all(ref_pkg, url)
    assert sorted(ours) == sorted(theirs) == list(range(24))
    for i, row in enumerate(rows):
        np.testing.assert_array_equal(ours[i], row["vec"])
        np.testing.assert_array_equal(theirs[i], row["vec"])
