"""The port's codecs against the JAX package's ``tests/test_codecs.py``, case for case.

Each JAX case has a counterpart of the same name, parametrised the same way, run on the
port's codecs. Where the output is deterministic it is also held against the JAX
package's codec on the same seeded value:

- bit-exact: the encoded bytes of the scalar, npy (``NdarrayCodec``), npz
  (``CompressedNdarrayCodec``) and PNG paths (both packages encode with the same
  library), and every decoded value;
- across packages: a value encoded by one package decodes in the other to the same
  array (JPEG included: the bytes are the same stream, so the pixels are too).
"""
import decimal

import numpy as np
import pyarrow as pa
import pytest

pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

from petastorm_tpu import codecs as ref_codecs  # noqa: E402
from petastorm_tpu import types as ref_types  # noqa: E402
from petastorm_tpu import unischema as ref_unischema  # noqa: E402
from petastorm_tpu_torch import types as ptypes  # noqa: E402
from petastorm_tpu_torch.codecs import (  # noqa: E402
    CompressedImageCodec,
    CompressedNdarrayCodec,
    NdarrayCodec,
    ScalarCodec,
)
from petastorm_tpu_torch.unischema import UnischemaField  # noqa: E402


def _roundtrip(codec, field, value):
    return codec.decode(field, codec.encode(field, value))


def _ref_field(field):
    """The JAX package's field of the same name, dtype, shape and codec."""
    codec = field.codec
    if isinstance(codec, ScalarCodec):
        ref_codec = ref_codecs.ScalarCodec(
            getattr(ref_types, type(codec.scalar_type).__name__)(
                *_tag_args(codec.scalar_type)))
    elif isinstance(codec, CompressedImageCodec):
        ref_codec = ref_codecs.CompressedImageCodec(codec.image_codec, codec._quality)
    else:
        ref_codec = getattr(ref_codecs, type(codec).__name__)()
    return ref_unischema.UnischemaField(field.name, field.numpy_dtype, field.shape,
                                        ref_codec, field.nullable)


def _tag_args(tag):
    if isinstance(tag, ptypes.DecimalType):
        return (tag.precision, tag.scale)
    return ()


def _hold_against_reference(field, value, same_bytes=True):
    """Encode ``value`` with both packages: the bytes agree (``same_bytes``), and each
    package decodes the other's bytes to its own decode of its own bytes."""
    ref_field = _ref_field(field)
    ours = field.codec.encode(field, value)
    theirs = ref_field.codec.encode(ref_field, value)
    if same_bytes:
        assert bytes(ours) == bytes(theirs) if isinstance(ours, (bytes, bytearray)) \
            else ours == theirs
    mine = field.codec.decode(field, ours)
    for got in (field.codec.decode(field, theirs),
                ref_field.codec.decode(ref_field, ours)):
        if isinstance(mine, np.ndarray):
            assert got.dtype == mine.dtype
            np.testing.assert_array_equal(got, mine)
        else:
            assert got == mine and type(got) is type(mine)
    return mine


@pytest.mark.parametrize(
    "tag,np_dtype,value",
    [
        (ptypes.IntegerType(), np.int32, 42),
        (ptypes.LongType(), np.int64, -(2**40)),
        (ptypes.FloatType(), np.float32, 1.5),
        (ptypes.DoubleType(), np.float64, 2.25),
        (ptypes.BooleanType(), np.bool_, True),
        (ptypes.ShortType(), np.int16, -7),
        (ptypes.ByteType(), np.int8, 5),
    ],
)
def test_scalar_roundtrip(tag, np_dtype, value):
    field = UnischemaField("x", np_dtype, (), ScalarCodec(tag), False)
    out = _roundtrip(field.codec, field, value)
    assert out == value
    assert np.dtype(type(out)) == np.dtype(np_dtype)
    _hold_against_reference(field, value)


def test_scalar_string():
    field = UnischemaField("s", np.str_, (), ScalarCodec(ptypes.StringType()), False)
    assert _roundtrip(field.codec, field, "hello") == "hello"
    _hold_against_reference(field, "hello")


def test_scalar_decimal():
    field = UnischemaField(
        "d", np.object_, (), ScalarCodec(ptypes.DecimalType(10, 2)), False
    )
    out = _roundtrip(field.codec, field, decimal.Decimal("123.45"))
    assert isinstance(out, decimal.Decimal)
    assert out == decimal.Decimal("123.45")
    _hold_against_reference(field, decimal.Decimal("123.45"))


def test_scalar_accepts_numpy_scalar():
    field = UnischemaField("x", np.int32, (), ScalarCodec(ptypes.IntegerType()), False)
    assert field.codec.encode(field, np.int32(7)) == 7
    assert field.codec.encode(field, np.array(7, dtype=np.int32)) == 7
    ref_field = _ref_field(field)
    for v in (np.int32(7), np.array(7, dtype=np.int32)):
        ours, theirs = field.codec.encode(field, v), ref_field.codec.encode(ref_field, v)
        assert ours == theirs and type(ours) is type(theirs)


def test_ndarray_roundtrip():
    rng = np.random.RandomState(1)
    field = UnischemaField("m", np.float64, (3, 4), NdarrayCodec(), False)
    value = rng.standard_normal((3, 4))
    out = _roundtrip(field.codec, field, value)
    np.testing.assert_array_equal(out, value)
    # encoded payload is npy bytes
    enc = field.codec.encode(field, value)
    assert bytes(enc[:6]) == b"\x93NUMPY"
    _hold_against_reference(field, value)


def test_ndarray_ragged_dim():
    rng = np.random.RandomState(2)
    field = UnischemaField("m", np.int64, (None, 2), NdarrayCodec(), False)
    value = rng.randint(0, 10, (5, 2)).astype(np.int64)
    np.testing.assert_array_equal(_roundtrip(field.codec, field, value), value)
    _hold_against_reference(field, value)


def _raise_message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_ndarray_wrong_dtype_raises():
    rng = np.random.RandomState(3)
    field = UnischemaField("m", np.float32, (2, 2), NdarrayCodec(), False)
    value = rng.standard_normal((2, 2))  # float64
    with pytest.raises(ValueError, match="dtype"):
        field.codec.encode(field, value)
    ref_field = _ref_field(field)
    assert _raise_message(lambda: field.codec.encode(field, value)) == \
        _raise_message(lambda: ref_field.codec.encode(ref_field, value))


def test_ndarray_wrong_shape_raises():
    rng = np.random.RandomState(4)
    field = UnischemaField("m", np.float64, (2, 2), NdarrayCodec(), False)
    value = rng.standard_normal((2, 3))
    with pytest.raises(ValueError, match="shape|rank"):
        field.codec.encode(field, value)
    ref_field = _ref_field(field)
    assert _raise_message(lambda: field.codec.encode(field, value)) == \
        _raise_message(lambda: ref_field.codec.encode(ref_field, value))


def test_compressed_ndarray_roundtrip():
    rng = np.random.RandomState(5)
    field = UnischemaField("m", np.float64, (8, 8), CompressedNdarrayCodec(), False)
    value = rng.standard_normal((8, 8))
    np.testing.assert_array_equal(_roundtrip(field.codec, field, value), value)
    # compresses well on redundant data
    zeros = np.zeros((8, 8))
    assert len(field.codec.encode(field, zeros)) < len(NdarrayCodec().encode(field, zeros))
    _hold_against_reference(field, value)
    _hold_against_reference(field, zeros)


def test_png_roundtrip_lossless():
    rng = np.random.RandomState(6)
    field = UnischemaField("im", np.uint8, (16, 16, 3), CompressedImageCodec("png"), False)
    value = rng.randint(0, 255, (16, 16, 3)).astype(np.uint8)
    np.testing.assert_array_equal(_roundtrip(field.codec, field, value), value)
    _hold_against_reference(field, value)


def test_jpeg_roundtrip_lossy():
    field = UnischemaField(
        "im", np.uint8, (32, 32, 3), CompressedImageCodec("jpeg", quality=90), False
    )
    # smooth gradient compresses with low error
    yy, xx = np.mgrid[0:32, 0:32]
    value = np.stack([yy * 8, xx * 8, (yy + xx) * 4], axis=-1).astype(np.uint8)
    out = _roundtrip(field.codec, field, value)
    assert out.shape == value.shape
    assert np.mean(np.abs(out.astype(int) - value.astype(int))) < 10
    # each package's bytes decode in the other to the same pixels
    _hold_against_reference(field, value, same_bytes=False)


def test_jpeg_is_device_decodable():
    assert CompressedImageCodec("jpeg").device_decodable
    assert not CompressedImageCodec("png").device_decodable
    assert not NdarrayCodec().device_decodable
    for name in ("jpeg", "png"):
        assert CompressedImageCodec(name).device_decodable == \
            ref_codecs.CompressedImageCodec(name).device_decodable


def test_grayscale_png():
    rng = np.random.RandomState(7)
    field = UnischemaField("im", np.uint8, (8, 8), CompressedImageCodec("png"), False)
    value = rng.randint(0, 255, (8, 8)).astype(np.uint8)
    np.testing.assert_array_equal(_roundtrip(field.codec, field, value), value)
    _hold_against_reference(field, value)


def test_scalar_codec_from_spark_style_tag():
    # our type tags stand in for pyspark.sql.types
    codec = ScalarCodec(ptypes.IntegerType())
    assert codec.arrow_dtype() == pa.int32()
    for name in ("IntegerType", "LongType", "FloatType", "DoubleType", "BooleanType",
                 "ShortType", "ByteType", "StringType", "BinaryType"):
        assert ScalarCodec(getattr(ptypes, name)()).arrow_dtype() == \
            ref_codecs.ScalarCodec(getattr(ref_types, name)()).arrow_dtype(), name


def test_randomized_codec_roundtrips():
    """Property-style sweep: random shapes/dtypes round-trip bit-exact through
    Ndarray/CompressedNdarray codecs with the JAX package's bytes, and scalar codecs
    preserve value/dtype."""
    rng = np.random.RandomState(77)
    dtypes = [np.uint8, np.int16, np.int32, np.int64, np.float32, np.float64, np.bool_]
    for trial in range(30):
        dt = dtypes[trial % len(dtypes)]
        ndim = rng.randint(1, 4)
        shape = tuple(int(s) for s in rng.randint(1, 9, ndim))
        if dt is np.bool_:
            value = rng.rand(*shape) > 0.5
        elif np.issubdtype(dt, np.floating):
            value = rng.standard_normal(shape).astype(dt)
        else:
            value = rng.randint(0, 100, shape).astype(dt)
        for codec in (NdarrayCodec(), CompressedNdarrayCodec()):
            field = UnischemaField("f", dt, shape, codec, False)
            out = codec.decode(field, bytes(codec.encode(field, value)))
            assert out.dtype == value.dtype
            np.testing.assert_array_equal(out, value)
            _hold_against_reference(field, value)

    scalar_cases = [
        (np.int32, ptypes.IntegerType(), 42),
        (np.int64, ptypes.LongType(), -7),
        (np.float32, ptypes.FloatType(), 1.5),
        (np.float64, ptypes.DoubleType(), -2.25),
        (np.bool_, ptypes.BooleanType(), True),
    ]
    for np_dtype, tag, v in scalar_cases:
        codec = ScalarCodec(tag)
        field = UnischemaField("s", np_dtype, (), codec, False)
        out = codec.decode(field, codec.encode(field, np_dtype(v)))
        assert out == np_dtype(v)
        assert np.dtype(type(out)) == np.dtype(np_dtype) or out.dtype == np_dtype
        _hold_against_reference(field, np_dtype(v))
