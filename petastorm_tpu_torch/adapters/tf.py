"""TensorFlow adapters: ``make_petastorm_dataset`` and ``tf_tensors``.

Port of ``petastorm_tpu.adapters.tf`` (reference petastorm/tf_utils.py:
``make_petastorm_dataset`` ~L350, ``tf_tensors`` ~L250, ``_schema_to_tf_dtypes``): a
``tf.data.Dataset`` over a port reader, its dtypes and shapes derived from the
(post-TransformSpec) Unischema; NGram readers yield ``{timestep: dict}`` structures.
Datetime and Decimal values are converted to types TF takes, as the reference does
(dates to int days, datetimes to int64 nanoseconds, Decimal to string). tensorflow is
imported when a function is called, never at import.

Bridging a Python reader into TF costs a Python call a step; a consumer that cares about
feed throughput uses :class:`petastorm_tpu_torch.loader.DataLoader`. This adapter is for
migration.
"""
from __future__ import annotations

import datetime
import decimal

import numpy as np


def _tf():
    import tensorflow as tf

    return tf


def _field_tf_dtype(tf, field):
    np_dtype = np.dtype(field.numpy_dtype)
    kind = np_dtype.kind
    if kind in "US" or field.numpy_dtype in (str, bytes):
        return tf.string
    if np_dtype == np.dtype("object"):
        return tf.string
    if kind == "M":  # datetime64 -> int64 nanoseconds
        return tf.int64
    return tf.as_dtype(np_dtype)


def _schema_to_tf_dtypes(tf, schema):
    return {name: _field_tf_dtype(tf, f) for name, f in schema.fields.items()}


def _schema_to_tf_shapes(schema):
    out = {}
    for name, f in schema.fields.items():
        if f.shape is None or f.shape == ():
            out[name] = ()
        else:
            out[name] = tuple(d if d is not None else None for d in f.shape)
    return out


def _tf_compatible(value):
    """Convert a decoded python/numpy value to something TF accepts (scalars AND object
    ndarrays of Decimals/dates, which is how batch readers deliver decimal columns)."""
    if isinstance(value, decimal.Decimal):
        return str(value)
    if isinstance(value, datetime.datetime):
        if value.tzinfo is None:
            # naive datetimes are UTC by convention (upstream behavior): timegm reads
            # the struct_time as UTC — value.timestamp() would apply the LOCAL zone
            # and make the same dataset yield different int64s per machine
            import calendar

            epoch_us = calendar.timegm(value.utctimetuple()) * 1_000_000 \
                + value.microsecond
            return np.int64(epoch_us * 1000)
        return np.int64(int(value.timestamp() * 1e9))
    if isinstance(value, datetime.date):
        return np.int64((value - datetime.date(1970, 1, 1)).days)
    if isinstance(value, np.datetime64):
        return value.astype("datetime64[ns]").astype(np.int64)
    if value is None:
        return b""
    if isinstance(value, np.ndarray):
        if value.dtype == object and value.size:
            return np.asarray([_tf_compatible(v) for v in value.reshape(-1)]) \
                .reshape(value.shape)
        if value.dtype.kind == "M":
            return value.astype("datetime64[ns]").astype(np.int64)
    return value


def _reject_device_decode_reader(reader):
    if getattr(reader, "device_decode_fields", None):
        raise ValueError(
            "Reader was built with decode_on_device=True: its image columns carry "
            "device staging payloads only the port's DataLoader can finish. Use "
            "petastorm_tpu_torch.loader.DataLoader, or rebuild the reader with "
            "decode_on_device=False for the TF path."
        )


def make_petastorm_dataset(reader):
    """``tf.data.Dataset`` over a reader (reference ``make_petastorm_dataset`` ~L350).

    Per-row readers yield dicts of tensors; batch readers yield dicts of batched tensors;
    NGram readers yield ``{timestep: dict}`` structures.
    """
    tf = _tf()
    _reject_device_decode_reader(reader)
    schema = reader.schema

    if reader.ngram is not None:
        if getattr(reader, "is_batched_reader", False):
            raise ValueError(
                "The TF adapter does not support batched NGram readers (their "
                "flat 'offset/field' columns are the DataLoader's device "
                "convention). Use make_reader(schema_fields=ngram) here, or "
                "petastorm_tpu_torch.loader.DataLoader for the columnar path.")
        return _make_ngram_dataset(tf, reader)

    dtypes = _schema_to_tf_dtypes(tf, schema)
    shapes = _schema_to_tf_shapes(schema)
    if reader.is_batched_reader:
        shapes = {name: (None,) + tuple(s) if s != () else (None,)
                  for name, s in shapes.items()}

    def gen():
        for item in reader:
            d = item._asdict() if hasattr(item, "_asdict") else item
            yield {k: _tf_compatible(v) for k, v in d.items() if k in dtypes}

    signature = {
        name: tf.TensorSpec(shape=shapes[name], dtype=dtypes[name])
        for name in dtypes
    }
    return tf.data.Dataset.from_generator(gen, output_signature=signature)


def _make_ngram_dataset(tf, reader):
    ngram = reader.ngram
    schema = reader.schema
    specs = {}
    for offset in sorted(ngram.fields.keys()):
        names = ngram.get_field_names_at_timestep(offset)
        view = schema.create_schema_view([n for n in names if n in schema.fields])
        specs[str(offset)] = {
            name: tf.TensorSpec(shape=_schema_to_tf_shapes(view)[name],
                                dtype=_schema_to_tf_dtypes(tf, view)[name])
            for name in view.fields
        }

    def gen():
        for window in reader:
            yield {
                str(offset): {k: _tf_compatible(v) for k, v in nt._asdict().items()}
                for offset, nt in window.items()
            }

    return tf.data.Dataset.from_generator(gen, output_signature=specs)


def tf_tensors(reader, shuffling_queue_capacity=0, min_after_dequeue=0):
    """Graph-mode tensors for TF1-style consumers (reference ``tf_tensors`` ~L250).

    Returns a structure of tensors that advances the reader each time it is evaluated.
    In TF2 eager this delegates to a dataset iterator.

    ``min_after_dequeue`` maps onto tf.data semantics as a floor on the shuffle buffer
    (the reference's ``tf.train.shuffle_batch`` used it as the minimum buffered rows
    for shuffle quality): the effective buffer is
    ``max(shuffling_queue_capacity, min_after_dequeue + 1)``.
    """
    tf = _tf()
    _reject_device_decode_reader(reader)
    buffer_size = max(int(shuffling_queue_capacity or 0), int(min_after_dequeue or 0) + 1
                      if min_after_dequeue else 0)
    if buffer_size > 1:
        ds = make_petastorm_dataset(reader).shuffle(
            buffer_size, seed=None, reshuffle_each_iteration=True)
    else:
        ds = make_petastorm_dataset(reader)
    if tf.executing_eagerly():
        it = iter(ds)
        return lambda: next(it)
    it = tf.compat.v1.data.make_one_shot_iterator(ds)
    return it.get_next()
