"""Row decode driver and small helpers (port of ``petastorm_tpu.utils``: ``decode_row``,
``stack_as_column``)."""
from __future__ import annotations

import numpy as np

from petastorm_tpu_torch.errors import DecodeFieldError


def decode_row(row, schema, device_fields=(), prestaged=None):
    """Decode one stored row dict through codecs into a {field: numpy value} dict.

    Mirrors the reference decode driver (petastorm/utils.py ~L80): codec dispatch plus nullable
    handling; wraps codec failures with the field name for debuggability.

    Fields named in ``device_fields`` run only the HOST half of their codec's two-stage
    decode (``host_stage_decode``): the row carries a staging object (e.g. JPEG DCT
    coefficient planes) that the loader finishes on device in one batched dispatch.
    ``prestaged`` supplies this row's already-staged payloads for device fields the
    caller batch-decoded at the row-group level (one native call for the whole group).
    """
    decoded = {}
    for name, field in schema.fields.items():
        if name not in row:
            continue
        value = row[name]
        if value is None:
            if not field.nullable:
                raise DecodeFieldError("Field %r is not nullable but stored value is None" % name)
            decoded[name] = None
        elif field.codec is not None:
            try:
                if name in device_fields:
                    if prestaged is not None and name in prestaged:
                        decoded[name] = prestaged[name]
                    else:
                        decoded[name] = field.codec.host_stage_decode(field, value)
                else:
                    decoded[name] = field.codec.decode(field, value)
            except Exception as e:  # noqa: BLE001 - annotate and rethrow
                raise DecodeFieldError("Unable to decode field %r: %s" % (name, e)) from e
        else:
            decoded[name] = _coerce_plain(field, value)
    return decoded


def _coerce_plain(field, value):
    """Coerce a codec-less stored value to the field's declared numpy dtype."""
    np_dtype = np.dtype(field.numpy_dtype)
    shape = field.shape or ()
    if len(shape) > 0:
        return np.asarray(value, dtype=None if np_dtype.kind == "O" else np_dtype)
    if np_dtype.kind in ("U", "S", "O"):
        return value
    if np_dtype.kind == "M":
        return np.datetime64(value) if value is not None else value
    if isinstance(value, np.ndarray) and value.ndim == 0:
        return value[()]
    return np_dtype.type(value)


def stack_as_column(values, force_object=False):
    """Pack per-row values into one column array: a stacked ndarray when rows are
    uniform, an object array otherwise (ragged rows, staging payloads, strings).

    ``force_object=True`` skips the stacking attempt — required for columns whose rows
    may MIX ndarrays and non-array payloads (e.g. device-decode staging objects with
    per-stream host fallbacks), where np.asarray would pick a layout per batch and
    downstream concatenation would break.
    """
    if not force_object:
        try:
            return np.asarray(values)
        except (ValueError, TypeError):
            pass
    arr = np.empty(len(values), dtype=object)
    arr[:] = values
    return arr


def pad_to_shape(array, shape, pad_value=0):
    """Pad and validate an array against a shape of ints or ``None`` (keep that
    dimension): the fixed shapes a batch of ragged rows is padded to."""
    if len(shape) != array.ndim:
        raise ValueError(
            "Shape rank %d does not match array rank %d" % (len(shape), array.ndim)
        )
    target = tuple(s if s is not None else a for s, a in zip(shape, array.shape))
    if target == array.shape:
        return array
    pads = []
    for t, a in zip(target, array.shape):
        if a > t:
            raise ValueError("Array dim %d exceeds padded max %d" % (a, t))
        pads.append((0, t - a))
    return np.pad(array, pads, constant_values=pad_value)
