"""Port vs reference: stores written by the reference petastorm (pickled unischema and
row-group counts under its key-value keys) open in the port as in the JAX package.

The reference's pickles are built here from classes registered, for the ``dumps`` only,
under the reference's module names (``petastorm.unischema``, ``petastorm.codecs``,
``pyspark.sql.types``) with the reference's instance state: a ``ScalarCodec`` holding
``_spark_type``, a ``CompressedImageCodec`` holding cv2's extension (``'.png'``), a
``DecimalType`` holding ``precision``/``scale``/``hasPrecisionInfo``. Both packages'
``get_schema``, ``load_row_groups`` (fast path and ``validate=True``) and ``make_reader``
go over the same store, made from a numpy seed.
"""
import collections
import contextlib
import decimal
import os
import pickle
import sys
import types as pytypes

import numpy as np
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu import metadata as ref_metadata  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu.compat import reference as ref_compat  # noqa: E402
from petastorm_tpu.fs import get_filesystem_and_path_or_paths as ref_resolve  # noqa: E402
from petastorm_tpu_torch import codecs, metadata, reader, types  # noqa: E402
from petastorm_tpu_torch.compat import reference  # noqa: E402
from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths  # noqa: E402

ROWS = 30


# -- the reference's classes, as its pickles name them ----------------------------------


def _fake_modules():
    """Modules named as the reference's, holding classes with its instance state."""
    mods = {name: pytypes.ModuleType(name) for name in (
        "petastorm", "petastorm.unischema", "petastorm.codecs", "pyspark", "pyspark.sql",
        "pyspark.sql.types")}

    def cls(module, name, init=None):
        c = type(name, (), {"__module__": module, "__qualname__": name})
        if init is not None:
            c.__init__ = init
        setattr(mods[module], name, c)
        return c

    field = collections.namedtuple("UnischemaField",
                                   ["name", "numpy_dtype", "shape", "codec", "nullable"])
    field.__module__ = "petastorm.unischema"
    mods["petastorm.unischema"].UnischemaField = field

    def unischema_init(self, name, fields):
        self._name = name
        self._fields = collections.OrderedDict((f.name, f) for f in fields)
        self._namedtuple = None

    cls("petastorm.unischema", "Unischema", unischema_init)

    def scalar_init(self, spark_type):
        self._spark_type = spark_type

    def image_init(self, image_codec="png", quality=80):
        self._image_codec = "." + image_codec
        self._quality = quality

    cls("petastorm.codecs", "ScalarCodec", scalar_init)
    cls("petastorm.codecs", "NdarrayCodec")
    cls("petastorm.codecs", "CompressedNdarrayCodec")
    cls("petastorm.codecs", "CompressedImageCodec", image_init)
    for name in ("LongType", "IntegerType", "ShortType", "StringType", "DoubleType"):
        cls("pyspark.sql.types", name)

    def decimal_init(self, precision=10, scale=0):
        self.precision, self.scale, self.hasPrecisionInfo = precision, scale, True

    cls("pyspark.sql.types", "DecimalType", decimal_init)
    cls("pyspark.sql.types", "Unknown")
    return mods


@contextlib.contextmanager
def _registered(mods):
    """``mods`` in ``sys.modules`` for the block only (nothing else may see a pyspark)."""
    saved = {name: sys.modules.get(name) for name in mods}
    sys.modules.update(mods)
    try:
        yield
    finally:
        for name, old in saved.items():
            if old is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = old


def _reference_schema_pickle(mods, schema):
    """The reference's pickle of ``schema`` (a JAX-package Unischema, read for its
    fields): the reference's classes and codec state."""
    t = mods["pyspark.sql.types"]
    c = mods["petastorm.codecs"]
    u = mods["petastorm.unischema"]
    fields = []
    for f in schema.fields.values():
        codec = f.codec
        kind = type(codec).__name__
        if kind == "ScalarCodec":
            tag = codec.scalar_type
            spark = t.DecimalType(tag.precision, tag.scale) \
                if type(tag).__name__ == "DecimalType" else getattr(t, type(tag).__name__)()
            ref_codec = c.ScalarCodec(spark)
        elif kind == "CompressedImageCodec":
            ref_codec = c.CompressedImageCodec(codec.image_codec, codec._quality)
        else:
            ref_codec = getattr(c, kind)()
        fields.append(u.UnischemaField(f.name, f.numpy_dtype, f.shape, ref_codec,
                                       f.nullable))
    with _registered(mods):
        return pickle.dumps(u.Unischema(schema._name, fields), protocol=2)


def _write_reference_metadata(path, schema_payload, counts):
    """Replace ``_common_metadata`` with one carrying only the reference's keys."""
    arrow_schema = pq.read_schema(path + "/_common_metadata").remove_metadata()
    pq.write_metadata(arrow_schema.with_metadata({
        metadata.REFERENCE_SCHEMA_KEY: schema_payload,
        metadata.REFERENCE_ROW_GROUPS_KEY: pickle.dumps(counts, protocol=2)}),
        path + "/_common_metadata")


@pytest.fixture(scope="module")
def ref_store(tmp_path_factory):
    """The JAX test schema's 30 rows (every codec; numpy seed 22) in three files, its
    ``_common_metadata`` rewritten with the reference's pickled keys only."""
    from test_common import TestSchema, create_test_dataset

    ds = create_test_dataset("file://" + str(tmp_path_factory.mktemp("torch_compat") / "ds"),
                             num_rows=ROWS, seed=22)
    fs, path = get_filesystem_and_path_or_paths(ds.url)
    counts = metadata._count_row_groups_per_file(fs, path)
    _write_reference_metadata(ds.path, _reference_schema_pickle(_fake_modules(), TestSchema),
                              counts)
    return ds, counts


def _field_key(f):
    codec = f.codec
    state = None
    if codec is not None:
        state = (type(codec).__name__,
                 repr(getattr(codec, "scalar_type", None)),
                 getattr(codec, "image_codec", None), getattr(codec, "_quality", None))
    return (f.name, str(np.dtype(f.numpy_dtype)), f.shape, state, bool(f.nullable))


def test_reference_keys_are_the_reference_packages():
    assert metadata.REFERENCE_SCHEMA_KEY == ref_metadata.REFERENCE_SCHEMA_KEY
    assert metadata.REFERENCE_ROW_GROUPS_KEY == ref_metadata.REFERENCE_ROW_GROUPS_KEY


def test_a_reference_pickled_schema_opens_alike(ref_store):
    ds, _counts = ref_store
    kv = pq.read_schema(ds.path + "/_common_metadata").metadata
    assert set(kv) == {metadata.REFERENCE_SCHEMA_KEY, metadata.REFERENCE_ROW_GROUPS_KEY}
    ours = metadata.get_schema(*get_filesystem_and_path_or_paths(ds.url))
    theirs = ref_metadata.get_schema(*ref_resolve(ds.url))
    assert type(ours).__module__ == "petastorm_tpu_torch.unischema"
    assert [_field_key(f) for f in ours.fields.values()] \
        == [_field_key(f) for f in theirs.fields.values()]
    assert isinstance(ours.fields["id"].codec.scalar_type, types.LongType)
    assert ours.fields["decimal"].codec.scalar_type == types.DecimalType(12, 9)
    image = ours.fields["image_png"].codec
    assert isinstance(image, codecs.CompressedImageCodec) and image.image_codec == "png"


def _piece_key(p, root):
    return (p.path[len(root):], p.row_group, p.num_rows, p.partition_values)


@pytest.mark.parametrize("validate", [False, True])
def test_reference_row_group_counts_give_the_same_pieces(ref_store, validate):
    ds, counts = ref_store
    ours = metadata.load_row_groups(*get_filesystem_and_path_or_paths(ds.url),
                                    validate=validate)
    theirs = ref_metadata.load_row_groups(*ref_resolve(ds.url), validate=validate)
    assert [_piece_key(p, ds.path) for p in ours] == [_piece_key(p, ds.path) for p in theirs]
    assert len(ours) == sum(counts.values())
    if validate:
        # the footer scan: row counts and statistics, as without any metadata
        assert sum(p.num_rows for p in ours) == ROWS
        assert all(p.stats is not None for p in ours)
    else:
        assert all(p.num_rows == -1 and p.stats is None for p in ours)


def test_validate_equals_the_footer_scan_of_a_json_keyed_store(tmp_path):
    from test_common import create_test_dataset

    ds = create_test_dataset("file://" + str(tmp_path / "ds"), num_rows=12, seed=23)
    fs, path = get_filesystem_and_path_or_paths(ds.url)
    fast = metadata.load_row_groups(fs, path)
    scanned = metadata.load_row_groups(fs, path, validate=True)
    assert [(p.path, p.row_group) for p in fast] == [(p.path, p.row_group) for p in scanned]
    theirs = ref_metadata.load_row_groups(*ref_resolve(ds.url), validate=True)
    assert [(p.path, p.row_group, p.num_rows, p.stats) for p in scanned] \
        == [(p.path, p.row_group, p.num_rows, p.stats) for p in theirs]


def _rows_by_id(factory, url, **kw):
    with factory(url, reader_pool_type="dummy", shuffle_row_groups=False, **kw) as r:
        return {int(row.id): row._asdict() for row in r}


def test_a_reference_store_reads_the_same_rows(ref_store):
    ds, _counts = ref_store
    ours = _rows_by_id(reader.make_reader, ds.url)
    theirs = _rows_by_id(ref_reader.make_reader, ds.url)
    assert sorted(ours) == sorted(theirs) == list(range(ROWS))
    for i, row in ours.items():
        want = theirs[i]
        assert sorted(row) == sorted(want)
        for name, value in row.items():
            if isinstance(value, np.ndarray):
                assert value.dtype == want[name].dtype, name
                np.testing.assert_array_equal(value, want[name])
            else:
                assert value == want[name], name
    expected = {d["id"]: d for d in ds.data}
    for i, row in ours.items():
        np.testing.assert_array_equal(row["image_png"], expected[i]["image_png"])
        assert row["decimal"] == expected[i]["decimal"]


def test_the_batch_reader_reads_a_reference_store(ref_store):
    ds, _counts = ref_store
    fields = ["id", "matrix", "sensor_name"]
    got = []
    for factory in (reader.make_batch_reader, ref_reader.make_batch_reader):
        with factory(ds.url, schema_fields=fields, reader_pool_type="dummy",
                     shuffle_row_groups=False) as r:
            batches = list(r)
        got.append({name: np.concatenate([np.asarray(getattr(b, name)) for b in batches])
                    for name in fields})
    ours, theirs = got
    assert len(ours["id"]) == ROWS
    for name in fields:
        np.testing.assert_array_equal(ours[name], theirs[name])


@pytest.mark.parametrize("state,want", [
    ({"_spark_type": types.LongType()}, types.LongType()),
    ({"_spark_type": types.DecimalType(7, 2)}, types.DecimalType(7, 2)),
    ({"_scalar_type": types.StringType()}, types.StringType()),
])
def test_scalar_codec_state_of_either_form(state, want):
    codec = codecs.ScalarCodec.__new__(codecs.ScalarCodec)
    codec.__setstate__(dict(state))
    assert codec.scalar_type == want
    # the same state under the reference's module names, through both unpicklers
    payload = pickle.dumps(codec, protocol=2).replace(
        b"petastorm_tpu_torch.codecs", b"petastorm.codecs").replace(
        b"petastorm_tpu_torch.types", b"pyspark.sql.types")
    assert reference.loads_reference_pickle(payload).scalar_type == want
    assert repr(ref_compat.loads_reference_pickle(payload).scalar_type) == repr(want)


@pytest.mark.parametrize("stored,want", [(".png", "png"), (".jpeg", "jpeg"),
                                         (".jpg", "jpeg"), ("jpeg", "jpeg")])
def test_image_codec_state_takes_cv2_extensions(stored, want):
    codec = codecs.CompressedImageCodec.__new__(codecs.CompressedImageCodec)
    codec.__setstate__({"_image_codec": stored, "_quality": 90})
    assert (codec.image_codec, codec._quality) == (want, 90)
    with pytest.raises(ValueError, match="Unsupported image codec"):
        codec.__setstate__({"_image_codec": ".bmp"})


def test_codec_pickles_round_trip_for_the_process_pool():
    for codec in (codecs.ScalarCodec(types.DecimalType(12, 9)),
                  codecs.CompressedImageCodec("jpeg", 85), codecs.NdarrayCodec()):
        assert pickle.loads(pickle.dumps(codec)) == codec


def test_a_pyspark_type_instance_becomes_a_tag():
    mods = _fake_modules()
    t = mods["pyspark.sql.types"]
    assert codecs.ScalarCodec(t.IntegerType()).scalar_type == types.IntegerType()
    assert codecs.ScalarCodec(t.DecimalType(9, 3)).scalar_type == types.DecimalType(9, 3)
    with pytest.raises(ValueError, match="Unsupported scalar type"):
        codecs.ScalarCodec(t.Unknown())
    from petastorm_tpu.codecs import ScalarCodec as RefScalar

    for spark in (t.IntegerType(), t.DecimalType(9, 3)):
        assert repr(RefScalar(spark).scalar_type) \
            == repr(codecs.ScalarCodec(spark).scalar_type)


def test_unsupported_reference_classes_refuse_alike():
    mods = _fake_modules()
    with _registered(mods):
        payload = pickle.dumps(mods["pyspark.sql.types"].Unknown(), protocol=2)
    for loads in (reference.loads_reference_pickle, ref_compat.loads_reference_pickle):
        with pytest.raises(pickle.UnpicklingError, match="pyspark.sql.types.Unknown"):
            loads(payload)
    assert reference.loads_reference_pickle(pickle.dumps({"a.parquet": 2})) \
        == {"a.parquet": 2}


class _Runs:
    """An object whose pickle calls ``fn(*args)`` when loaded."""

    def __init__(self, fn, *args):
        self.call = (fn, args)

    def __reduce__(self):
        return self.call


@pytest.mark.parametrize("payload", [
    _Runs(os.system, "true"), _Runs(eval, "1 + 1"), _Runs(getattr, object, "__class__"),
    {"schema": _Runs(os.getcwd)}], ids=["os_system", "eval", "getattr", "nested"])
def test_a_pickle_naming_any_other_callable_is_refused(payload):
    # the port takes only what a reference schema is built from; what the reference's
    # pickle of numpy and decimal values names still loads
    with pytest.raises(pickle.UnpicklingError, match="a reference schema does not hold"):
        reference.loads_reference_pickle(pickle.dumps(payload, protocol=2))
    values = [np.dtype("<U3"), np.int32, np.float64(3.5), np.arange(3),
              decimal.Decimal("1.5"), collections.OrderedDict(a=(1, 2.0)), b"xy"]
    for protocol in (2, 4, 5):
        out = reference.loads_reference_pickle(pickle.dumps(values, protocol=protocol))
        assert repr(out) == repr(values)


def test_the_pre_rename_package_maps_too():
    payload = pickle.dumps(codecs.NdarrayCodec(), protocol=2).replace(
        b"petastorm_tpu_torch.codecs", b"dataset_toolkit.codecs")
    assert isinstance(reference.loads_reference_pickle(payload), codecs.NdarrayCodec)
    assert set(reference._CLASS_MAP) == set(ref_compat._CLASS_MAP)


def test_the_compat_package_exports_the_unpickler():
    from petastorm_tpu_torch import compat

    assert compat.loads_reference_pickle is reference.loads_reference_pickle
