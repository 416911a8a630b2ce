"""The port's ``Unischema`` against the JAX package's ``tests/test_unischema.py``, case
for case.

Each JAX case has a counterpart of the same name run on the port's schema, and the same
call on the JAX package's schema built from the same fields, compared:

- bit-exact: field names and order, dtypes, shapes, nullability, codec kinds, the Arrow
  schema, ``from_arrow_schema``'s fields field for field, encoded bytes, decoded values
  and error messages.

``dict_to_record``'s case in ``test_torch_public_names.py`` stays as it is; the
counterpart here adds the JAX case's own schema and comparison.
"""
import pickle

import numpy as np
import pyarrow as pa
import pytest

pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

import petastorm_tpu.codecs as ref_codecs  # noqa: E402
import petastorm_tpu.types as ref_types  # noqa: E402
import petastorm_tpu.unischema as ref_us  # noqa: E402
import petastorm_tpu.utils as ref_utils  # noqa: E402
import petastorm_tpu_torch.codecs as port_codecs  # noqa: E402
import petastorm_tpu_torch.types as port_types  # noqa: E402
import petastorm_tpu_torch.unischema as port_us  # noqa: E402
import petastorm_tpu_torch.utils as port_utils  # noqa: E402

PKGS = {"port": (port_us, port_codecs, port_types, port_utils),
        "ref": (ref_us, ref_codecs, ref_types, ref_utils)}


def _build(pkg):
    us, codecs, types, _ = PKGS[pkg]
    return us.Unischema(
        "TestSchema",
        [
            us.UnischemaField("id", np.int64, (), codecs.ScalarCodec(types.LongType()), False),
            us.UnischemaField("value", np.float64, (),
                              codecs.ScalarCodec(types.DoubleType()), False),
            us.UnischemaField("matrix", np.float64, (3, 4), codecs.NdarrayCodec(), False),
            us.UnischemaField("image", np.uint8, (8, 8, 3),
                              codecs.CompressedImageCodec("png"), False),
            us.UnischemaField("name", np.str_, (),
                              codecs.ScalarCodec(types.StringType()), True),
        ],
    )


@pytest.fixture
def schema():
    return _build("port")


@pytest.fixture
def ref_schema():
    return _build("ref")


def _field_tuple(f):
    """What a field is, package-free: name, dtype, shape, nullability, codec kind and
    its settings."""
    codec = f.codec
    if codec is None:
        desc = None
    else:
        desc = (type(codec).__name__, getattr(codec, "image_codec", None),
                type(getattr(codec, "scalar_type", None)).__name__)
    return (f.name, np.dtype(f.numpy_dtype), tuple(f.shape), bool(f.nullable), desc)


def _fields(schema):
    return [_field_tuple(f) for f in schema.fields.values()]


def _message(exc_type, fn):
    with pytest.raises(exc_type) as info:
        fn()
    return str(info.value)


def _row(rng):
    return {
        "id": 7,
        "value": 3.5,
        "matrix": rng.standard_normal((3, 4)),
        "image": rng.randint(0, 255, (8, 8, 3)).astype(np.uint8),
        "name": "abc",
    }


def test_field_access(schema, ref_schema):
    assert schema.id.name == "id"
    assert schema.matrix.shape == (3, 4)
    with pytest.raises(AttributeError):
        schema.nonexistent
    assert _fields(schema) == _fields(ref_schema)
    assert _message(AttributeError, lambda: schema.nonexistent) == \
        _message(AttributeError, lambda: ref_schema.nonexistent)


def test_create_schema_view_by_field(schema, ref_schema):
    view = schema.create_schema_view([schema.id, schema.matrix])
    assert list(view.fields.keys()) == ["id", "matrix"]
    assert _fields(view) == _fields(ref_schema.create_schema_view(
        [ref_schema.id, ref_schema.matrix]))


def test_create_schema_view_by_name_and_regex(schema, ref_schema):
    view = schema.create_schema_view(["id", "ima.*"])
    assert list(view.fields.keys()) == ["id", "image"]
    assert _fields(view) == _fields(ref_schema.create_schema_view(["id", "ima.*"]))


def test_create_schema_view_bad_selector(schema, ref_schema):
    with pytest.raises(ValueError, match="matched no fields"):
        schema.create_schema_view(["nope_.*"])
    assert _message(ValueError, lambda: schema.create_schema_view(["nope_.*"])) == \
        _message(ValueError, lambda: ref_schema.create_schema_view(["nope_.*"]))


def test_view_preserves_order(schema, ref_schema):
    view = schema.create_schema_view(["matrix", "id"])
    assert list(view.fields.keys()) == ["id", "matrix"]
    assert _fields(view) == _fields(ref_schema.create_schema_view(["matrix", "id"]))


def test_match_unischema_fields(schema, ref_schema):
    match = port_us.match_unischema_fields
    assert [f.name for f in match(schema, ["i.*"])] == ["id", "image"]
    # plain names are exact matches
    assert [f.name for f in match(schema, ["id"])] == ["id"]
    for regexes in (["i.*"], ["id"], ["na.*", "value"], ["zzz"]):
        assert [_field_tuple(f) for f in match(schema, regexes)] == \
            [_field_tuple(f) for f in ref_us.match_unischema_fields(ref_schema, regexes)]


def test_namedtuple_roundtrip(schema, ref_schema):
    row = schema.make_namedtuple(id=1, value=2.0, matrix=None, image=None, name="x")
    assert row.id == 1 and row.name == "x"
    # same type across calls (cache)
    assert type(row) is type(schema.make_namedtuple(id=2, value=1.0, matrix=None, image=None))
    theirs = ref_schema.make_namedtuple(id=1, value=2.0, matrix=None, image=None, name="x")
    assert row._fields == theirs._fields and tuple(row) == tuple(theirs)
    short = dict(id=2, value=1.0, matrix=None, image=None)
    assert tuple(schema.make_namedtuple(**short)) == \
        tuple(ref_schema.make_namedtuple(**short))


def test_insert_explicit_nulls(schema, ref_schema):
    row = {"id": 1, "value": 1.0, "matrix": np.zeros((3, 4)), "image": np.zeros((8, 8, 3), np.uint8)}
    theirs = dict(row)
    port_us.insert_explicit_nulls(schema, row)
    assert row["name"] is None
    ref_us.insert_explicit_nulls(ref_schema, theirs)
    assert sorted(row) == sorted(theirs) and theirs["name"] is None
    with pytest.raises(ValueError, match="not nullable"):
        port_us.insert_explicit_nulls(schema, {"id": 1})
    assert _message(ValueError, lambda: port_us.insert_explicit_nulls(schema, {"id": 1})) \
        == _message(ValueError, lambda: ref_us.insert_explicit_nulls(ref_schema, {"id": 1}))


def test_encode_decode_row_roundtrip(schema, ref_schema):
    row = _row(np.random.RandomState(11))
    encoded = port_us.encode_row(schema, row)
    assert isinstance(encoded["matrix"], bytearray)
    decoded = port_utils.decode_row(encoded, schema)
    assert decoded["id"] == 7
    np.testing.assert_array_equal(decoded["matrix"], row["matrix"])
    np.testing.assert_array_equal(decoded["image"], row["image"])
    assert decoded["name"] == "abc"
    theirs = ref_us.encode_row(ref_schema, row)
    assert sorted(theirs) == sorted(encoded)
    for name, value in encoded.items():
        assert type(value) is type(theirs[name]) and value == theirs[name], name
    # each package decodes the other's encoding to the same values
    for got in (port_utils.decode_row(theirs, schema),
                ref_utils.decode_row(encoded, ref_schema)):
        for name, value in decoded.items():
            np.testing.assert_array_equal(got[name], value)


def test_encode_row_unknown_field(schema, ref_schema):
    with pytest.raises(ValueError, match="not part of schema"):
        port_us.encode_row(schema, {"bogus": 1})
    assert _message(ValueError, lambda: port_us.encode_row(schema, {"bogus": 1})) == \
        _message(ValueError, lambda: ref_us.encode_row(ref_schema, {"bogus": 1}))


def test_encode_row_null_in_non_nullable(schema, ref_schema):
    row = {"id": None, "value": 1.0, "matrix": np.zeros((3, 4)),
           "image": np.zeros((8, 8, 3), np.uint8)}
    with pytest.raises(ValueError, match="not nullable"):
        port_us.encode_row(schema, dict(row))
    assert _message(ValueError, lambda: port_us.encode_row(schema, dict(row))) == \
        _message(ValueError, lambda: ref_us.encode_row(ref_schema, dict(row)))


def test_as_arrow_schema(schema, ref_schema):
    arrow = schema.as_arrow_schema()
    assert arrow.field("id").type == pa.int64()
    assert arrow.field("matrix").type == pa.binary()
    assert arrow.field("name").type == pa.string()
    assert arrow.field("name").nullable
    assert arrow.equals(ref_schema.as_arrow_schema(), check_metadata=True)


def _arrow_with_every_supported_type():
    return pa.schema(
        [
            pa.field("a", pa.int32(), nullable=False),
            pa.field("b", pa.float64()),
            pa.field("s", pa.string()),
            pa.field("v", pa.list_(pa.float32())),
            pa.field("ts", pa.timestamp("us")),
        ]
    )


def test_from_arrow_schema():
    arrow = _arrow_with_every_supported_type()
    schema = port_us.Unischema.from_arrow_schema(arrow)
    assert schema.a.numpy_dtype == np.dtype("int32")
    assert schema.a.shape == ()
    assert schema.v.shape == (None,)
    assert schema.v.numpy_dtype == np.dtype("float32")
    assert schema.s.numpy_dtype == np.dtype("object")
    assert schema.ts.numpy_dtype == np.dtype("datetime64[us]")
    assert all(f.codec is None for f in schema.fields.values())
    # field for field the JAX package's, over a wider set of Arrow types too
    wider = pa.schema(list(arrow) + [
        pa.field(str(t).replace("[", "_").replace("]", "").replace(",", "_")
                 .replace(" ", "").replace(":", "_"), t)
        for t in (pa.int8(), pa.int16(), pa.int64(), pa.uint8(), pa.uint16(), pa.uint32(),
                  pa.uint64(), pa.float16(), pa.float32(), pa.bool_(), pa.binary(),
                  pa.large_string(), pa.large_binary(), pa.date32(), pa.date64(),
                  pa.timestamp("ms"), pa.timestamp("ns", tz="UTC"), pa.decimal128(12, 3),
                  pa.list_(pa.int64()), pa.large_list(pa.int16()),
                  pa.list_(pa.string()))])
    for source in (arrow, wider):
        assert _fields(port_us.Unischema.from_arrow_schema(source)) == \
            _fields(ref_us.Unischema.from_arrow_schema(source))


def test_from_arrow_schema_unsupported_omitted():
    arrow = pa.schema([pa.field("ok", pa.int32()), pa.field("bad", pa.map_(pa.string(), pa.int32()))])
    schema = port_us.Unischema.from_arrow_schema(arrow)
    assert list(schema.fields.keys()) == ["ok"]
    with pytest.raises(ValueError):
        port_us.Unischema.from_arrow_schema(arrow, omit_unsupported_fields=False)
    assert _fields(schema) == _fields(ref_us.Unischema.from_arrow_schema(arrow))
    assert _message(ValueError, lambda: port_us.Unischema.from_arrow_schema(
        arrow, omit_unsupported_fields=False)) == _message(
        ValueError, lambda: ref_us.Unischema.from_arrow_schema(
            arrow, omit_unsupported_fields=False))


def test_json_roundtrip(schema, ref_schema):
    payload = schema.to_json()
    back = port_us.Unischema.from_json(payload)
    assert list(back.fields.keys()) == list(schema.fields.keys())
    assert back.matrix == schema.matrix
    assert back.image.codec.image_codec == "png"
    assert isinstance(back.id.codec, port_codecs.ScalarCodec)
    # the JSON is the JAX package's, and each package reads the other's
    assert payload == ref_schema.to_json()
    assert _fields(port_us.Unischema.from_json(ref_schema.to_json())) == _fields(schema)
    assert _fields(ref_us.Unischema.from_json(payload)) == _fields(ref_schema)


def test_pickle_roundtrip(schema, ref_schema):
    back = pickle.loads(pickle.dumps(schema))
    assert list(back.fields.keys()) == list(schema.fields.keys())
    assert back.matrix == schema.matrix
    assert _fields(back) == _fields(pickle.loads(pickle.dumps(ref_schema)))


def test_dict_to_record(schema, ref_schema):
    row = _row(np.random.RandomState(12))
    del row["name"]
    rec = port_us.dict_to_record(schema, dict(row))
    assert rec["name"] is None
    assert isinstance(rec["image"], bytearray)
    theirs = ref_us.dict_to_record(ref_schema, dict(row))
    assert sorted(rec) == sorted(theirs)
    for name, value in rec.items():
        assert type(value) is type(theirs[name]) and value == theirs[name], name


def test_arrow_write_read_roundtrip(schema, ref_schema, tmp_path):
    """Encoded rows are storable via pyarrow parquet and decode back exactly; the JAX
    package decodes the port's stored rows to the same values."""
    import pyarrow.parquet as pq

    rng = np.random.RandomState(13)
    rows = []
    for i in range(5):
        rows.append(
            {
                "id": i,
                "value": float(i),
                "matrix": rng.standard_normal((3, 4)),
                "image": rng.randint(0, 255, (8, 8, 3)).astype(np.uint8),
                "name": "row%d" % i,
            }
        )
    encoded = [port_us.encode_row(schema, r) for r in rows]
    table = pa.Table.from_pylist(
        [{k: (bytes(v) if isinstance(v, bytearray) else v) for k, v in e.items()} for e in encoded],
        schema=schema.as_arrow_schema(),
    )
    path = tmp_path / "t.parquet"
    pq.write_table(table, path)
    read_back = pq.read_table(path).to_pylist()
    for orig, stored in zip(rows, read_back):
        decoded = port_utils.decode_row(stored, schema)
        assert decoded["id"] == orig["id"]
        np.testing.assert_array_equal(decoded["matrix"], orig["matrix"])
        np.testing.assert_array_equal(decoded["image"], orig["image"])
        theirs = ref_utils.decode_row(stored, ref_schema)
        for name, value in decoded.items():
            np.testing.assert_array_equal(theirs[name], value)


def test_many_fields_namedtuple():
    # reference tests namedtuples >255 fields (python 3.7+ allows)
    def build(pkg):
        us, codecs, types, _ = PKGS[pkg]
        return [us.UnischemaField("f%03d" % i, np.int32, (),
                                  codecs.ScalarCodec(types.IntegerType()), False)
                for i in range(300)]

    fields = build("port")
    schema = port_us.Unischema("big", fields)
    row = schema.make_namedtuple(**{f.name: i for i, f in enumerate(fields)})
    assert row.f299 == 299
    theirs = ref_us.Unischema("big", build("ref")).make_namedtuple(
        **{f.name: i for i, f in enumerate(fields)})
    assert tuple(row) == tuple(theirs) and row._fields == theirs._fields
