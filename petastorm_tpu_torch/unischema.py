"""Unischema: one schema definition for writing (pyarrow) and reading (numpy/torch).

Port of ``petastorm_tpu.unischema`` (``UnischemaField``, ``Unischema``, ``encode_row``,
the JSON round trip). The JSON written under the dataset's key-value metadata is the
same in both packages, so a store written by either reads in the other; the codec
objects built from it are this package's own (:mod:`petastorm_tpu_torch.codecs`).
The Spark veneer (``as_spark_schema``, ``dict_to_spark_row``) imports pyspark only when
called, for the Spark write path (:func:`petastorm_tpu_torch.metadata.materialize_dataset`).
"""
from __future__ import annotations

import re
from collections import OrderedDict, namedtuple
from typing import NamedTuple, Optional, Tuple

import numpy as np


class UnischemaField(NamedTuple):
    """A single field: name, numpy dtype, shape, codec, nullability.

    Field order matches the reference namedtuple (petastorm/unischema.py ~L40) so that pickled
    reference schemas unpickle onto this class via the compat unpickler.
    """

    name: str
    numpy_dtype: object
    shape: Optional[Tuple[Optional[int], ...]]
    codec: object = None
    nullable: bool = False

    def __hash__(self):
        return hash((self.name, str(np.dtype(self.numpy_dtype)), self.shape, self.nullable))

    def __eq__(self, other):
        if not isinstance(other, UnischemaField):
            return NotImplemented
        return (
            self.name == other.name
            and np.dtype(self.numpy_dtype) == np.dtype(other.numpy_dtype)
            and self.shape == other.shape
            and self.codec == other.codec
            and self.nullable == other.nullable
        )


class _NamedtupleCache:
    """Process-wide cache of row namedtuple types, keyed by (schema name, field names).

    Reference: ``Unischema._get_namedtuple`` caches per schema instance; caching process-wide
    keeps types identical across pickling boundaries (worker processes)."""

    _d = {}

    @classmethod
    def get(cls, parent_name, field_names):
        key = (parent_name, tuple(field_names))
        if key not in cls._d:
            cls._d[key] = namedtuple(parent_name + "_view", field_names, rename=False)
        return cls._d[key]


class Unischema:
    """Ordered collection of :class:`UnischemaField` (reference: petastorm/unischema.py ~L100)."""

    def __init__(self, name, fields):
        self._name = name
        for f in fields:
            if not isinstance(f, UnischemaField):
                raise ValueError("Expected UnischemaField, got %r" % (f,))
        names = [f.name for f in fields]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError("Duplicate field names in schema %r: %r" % (name, sorted(dupes)))
        self._fields = OrderedDict((f.name, f) for f in fields)

    # -- basic access -------------------------------------------------------------------

    @property
    def fields(self):
        return self._fields

    def __getattr__(self, name):
        fields = self.__dict__.get("_fields")
        if fields is not None and name in fields:
            return fields[name]
        raise AttributeError("Schema %r has no field %r" % (self.__dict__.get("_name"), name))

    def __getstate__(self):
        return self.__dict__

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __repr__(self):
        lines = ["Unischema(%r, [" % self._name]
        for f in self._fields.values():
            lines.append("  %r," % (f,))
        lines.append("])")
        return "\n".join(lines)

    # -- views & selection --------------------------------------------------------------

    def create_schema_view(self, fields):
        """Subset view; ``fields`` may be UnischemaFields, names, or regex patterns.

        Reference: ``Unischema.create_schema_view`` (~L150) + ``match_unischema_fields``.
        """
        selected = []
        for f in fields:
            if isinstance(f, UnischemaField):
                ours = self._fields.get(f.name)
                if ours is None or ours != f:
                    raise ValueError(
                        "Field %r does not belong to schema %r (name, dtype, shape and codec "
                        "must all match)" % (f, self._name)
                    )
                selected.append(ours)
            elif isinstance(f, str):
                matched = match_unischema_fields(self, [f])
                if not matched:
                    raise ValueError(
                        "Field selector %r matched no fields of schema %r" % (f, self._name)
                    )
                selected.extend(matched)
            else:
                raise ValueError("Unexpected field selector %r" % (f,))
        # preserve schema order, dedupe
        names = {f.name for f in selected}
        ordered = [f for f in self._fields.values() if f.name in names]
        return Unischema(self._name, ordered)

    def make_namedtuple(self, **kwargs):
        """Build a row namedtuple from per-field kwargs (missing nullable fields -> None)."""
        typ = self.make_namedtuple_type()
        values = {}
        for name, field in self._fields.items():
            if name in kwargs:
                values[name] = kwargs[name]
            elif field.nullable:
                values[name] = None
            else:
                raise ValueError(
                    "Field %r is not nullable but missing from the row" % name
                )
        return typ(**values)

    def make_namedtuple_type(self):
        return _NamedtupleCache.get(self._name, list(self._fields.keys()))

    # -- arrow interop ------------------------------------------------------------------

    def as_arrow_schema(self):
        """Storage-level pyarrow schema (codec storage types, not logical tensor types)."""
        import pyarrow as pa

        pa_fields = []
        for f in self._fields.values():
            if f.codec is not None:
                typ = f.codec.arrow_dtype(f)
            else:
                typ = _numpy_to_arrow(f)
            pa_fields.append(pa.field(f.name, typ, nullable=bool(f.nullable)))
        return pa.schema(pa_fields)

    # -- spark interop (optional) -------------------------------------------------------

    def as_spark_schema(self):
        """The pyspark ``StructType`` of the stored columns (requires pyspark)."""
        import pyspark.sql.types as T

        sql_fields = []
        for f in self._fields.values():
            if f.codec is None:
                from petastorm_tpu_torch.types import tag_for_numpy_dtype

                spark_type = tag_for_numpy_dtype(f.numpy_dtype).spark_type()
            else:
                spark_type = f.codec.spark_dtype()
            sql_fields.append(T.StructField(f.name, spark_type, bool(f.nullable)))
        return T.StructType(sql_fields)

    @classmethod
    def from_arrow_schema(cls, arrow_schema_or_dataset, omit_unsupported_fields=True):
        """Infer a codec-less Unischema from an Arrow schema (make_batch_reader path).

        Reference: ``Unischema.from_arrow_schema`` (petastorm/unischema.py ~L300).
        """
        import pyarrow as pa

        if isinstance(arrow_schema_or_dataset, pa.Schema):
            arrow_schema = arrow_schema_or_dataset
            name = "inferred"
        else:  # pyarrow.dataset.Dataset or parquet dataset
            arrow_schema = arrow_schema_or_dataset.schema
            if hasattr(arrow_schema, "to_arrow_schema"):
                arrow_schema = arrow_schema.to_arrow_schema()
            name = "inferred"
        fields = []
        for pa_field in arrow_schema:
            try:
                fields.append(_arrow_field_to_unischema_field(pa_field))
            except ValueError:
                if not omit_unsupported_fields:
                    raise
        return cls(name, fields)

    # -- JSON metadata (native format) --------------------------------------------------

    def to_json(self):
        import json

        return json.dumps(
            {
                "name": self._name,
                "fields": [_field_to_jsonable(f) for f in self._fields.values()],
            }
        )

    @classmethod
    def from_json(cls, payload):
        import json

        obj = json.loads(payload)
        return cls(obj["name"], [_field_from_jsonable(d) for d in obj["fields"]])

    @property
    def name(self):
        return self._name


def match_unischema_fields(schema, field_regexes):
    """Fields of ``schema`` whose names fully match any regex (reference ~L500).

    Plain names behave as exact matches (they are valid regexes that fullmatch themselves).
    """
    matched = []
    compiled = [re.compile(p) for p in field_regexes]
    for f in schema.fields.values():
        if any(p.fullmatch(f.name) for p in compiled):
            matched.append(f)
    return matched


def insert_explicit_nulls(schema, row_dict):
    """Add ``None`` for nullable fields missing from ``row_dict`` (reference ~L450)."""
    for name, f in schema.fields.items():
        if name not in row_dict:
            if f.nullable:
                row_dict[name] = None
            else:
                raise ValueError("Field %r is not nullable but is missing from the row" % name)


def encode_row(schema, row_dict):
    """Encode a {field: value} dict through codecs into Parquet-storable values.

    This is the storage-agnostic core of the reference's ``dict_to_spark_row``
    (petastorm/unischema.py ~L400): same validation and codec dispatch, minus Spark ``Row``.
    """
    if not isinstance(row_dict, dict):
        raise TypeError("row must be a dict, got %r" % type(row_dict))
    unknown = set(row_dict.keys()) - set(schema.fields.keys())
    if unknown:
        raise ValueError("Fields %r not part of schema %r" % (sorted(unknown), schema.name))
    full = dict(row_dict)
    insert_explicit_nulls(schema, full)
    encoded = {}
    for name, field in schema.fields.items():
        value = full[name]
        if value is None:
            if not field.nullable:
                raise ValueError("Field %r is not nullable but got None" % name)
            encoded[name] = None
        elif field.codec is not None:
            encoded[name] = field.codec.encode(field, value)
        else:
            encoded[name] = value
    return encoded


def dict_to_spark_row(schema, row_dict):
    """Encode a row and wrap it in a pyspark ``Row`` in the schema's field order
    (requires pyspark; the reference's name)."""
    from pyspark.sql import Row

    encoded = encode_row(schema, row_dict)
    # Row(**kwargs) sorts by key on old pyspark: build positionally to keep schema order
    cls = Row(*schema.fields.keys())
    return cls(*[_bytes_for_spark(encoded[name]) for name in schema.fields.keys()])


def _bytes_for_spark(value):
    return bytearray(value) if isinstance(value, bytes) else value


def _numpy_to_arrow(field):
    import pyarrow as pa

    np_dtype = np.dtype(field.numpy_dtype)
    shape = field.shape or ()
    if len(shape) == 0:
        if np_dtype.kind in ("U", "S", "O"):
            return pa.string()
        if np_dtype.kind == "M":
            return pa.timestamp("us")
        return pa.from_numpy_dtype(np_dtype)
    # codec-less tensor columns are stored as (nested) arrow lists
    typ = pa.from_numpy_dtype(np_dtype)
    for _ in shape:
        typ = pa.list_(typ)
    return typ


_ARROW_DECIMAL_KINDS = ("decimal128", "decimal256")


def _arrow_field_to_unischema_field(pa_field):
    import pyarrow as pa
    import pyarrow.types as pat

    typ = pa_field.type
    shape = ()
    depth = 0
    while pat.is_list(typ) or pat.is_large_list(typ) or pat.is_fixed_size_list(typ):
        size = typ.list_size if pat.is_fixed_size_list(typ) else None
        shape = shape + (size,)
        typ = typ.value_type
        depth += 1
    if pat.is_dictionary(typ):
        # dictionary encoding (pandas categoricals) is a storage detail: the field's
        # logical type is the dictionary's VALUE type — silently dropping the column
        # (the old behavior via the unsupported-type omit) loses data
        typ = typ.value_type
    if pat.is_decimal(typ):
        np_dtype = np.dtype("object")
    elif pat.is_string(typ) or pat.is_large_string(typ):
        np_dtype = np.dtype("object")
    elif pat.is_binary(typ) or pat.is_large_binary(typ):
        np_dtype = np.dtype("object")
    elif pat.is_date(typ):
        np_dtype = np.dtype("datetime64[D]")
    elif pat.is_timestamp(typ):
        np_dtype = np.dtype("datetime64[%s]" % typ.unit)
    elif pat.is_boolean(typ) or pat.is_integer(typ) or pat.is_floating(typ):
        np_dtype = np.dtype(typ.to_pandas_dtype())
    else:
        raise ValueError("Unsupported arrow type %r for field %r" % (typ, pa_field.name))
    return UnischemaField(pa_field.name, np_dtype, shape, None, pa_field.nullable)


def _field_to_jsonable(f):
    from petastorm_tpu_torch import codecs as C
    from petastorm_tpu_torch import types as ptypes

    codec = None
    if isinstance(f.codec, C.ScalarCodec):
        t = f.codec.scalar_type
        codec = {"kind": "scalar", "type": type(t).__name__}
        if isinstance(t, ptypes.DecimalType):
            codec.update(precision=t.precision, scale=t.scale)
    elif isinstance(f.codec, C.NdarrayCodec):
        codec = {"kind": "ndarray"}
    elif isinstance(f.codec, C.CompressedNdarrayCodec):
        codec = {"kind": "compressed_ndarray"}
    elif isinstance(f.codec, C.CompressedImageCodec):
        codec = {
            "kind": "image",
            "format": f.codec.image_codec,
            "quality": f.codec._quality,
        }
    elif f.codec is not None:
        raise ValueError("Cannot serialize custom codec %r to JSON metadata" % (f.codec,))
    return {
        "name": f.name,
        "numpy_dtype": "object" if np.dtype(f.numpy_dtype).kind == "O"
        else np.dtype(f.numpy_dtype).str,
        "shape": list(f.shape) if f.shape is not None else None,
        "codec": codec,
        "nullable": bool(f.nullable),
    }


def _field_from_jsonable(d):
    from petastorm_tpu_torch import codecs as C
    from petastorm_tpu_torch import types as ptypes

    codec_desc = d.get("codec")
    codec = None
    if codec_desc:
        kind = codec_desc["kind"]
        if kind == "scalar":
            tname = codec_desc["type"]
            if tname == "DecimalType":
                tag = ptypes.DecimalType(codec_desc["precision"], codec_desc["scale"])
            else:
                tag = getattr(ptypes, tname)()
            codec = C.ScalarCodec(tag)
        elif kind == "ndarray":
            codec = C.NdarrayCodec()
        elif kind == "compressed_ndarray":
            codec = C.CompressedNdarrayCodec()
        elif kind == "image":
            codec = C.CompressedImageCodec(codec_desc["format"], codec_desc.get("quality", 80))
        else:
            raise ValueError("Unknown codec kind %r" % kind)
    dtype = d["numpy_dtype"]
    np_dtype = np.dtype("object") if dtype == "object" else np.dtype(dtype)
    shape = tuple(d["shape"]) if d["shape"] is not None else None
    return UnischemaField(d["name"], np_dtype, shape, codec, d["nullable"])
