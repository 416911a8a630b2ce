"""Column codecs: encode tensor/scalar fields into Parquet-storable values and back.

Port of ``petastorm_tpu.codecs``. The storage half (``encode``/``decode``) is host numpy
and cv2, byte-for-byte what the JAX package writes and reads. The device half of
``CompressedImageCodec`` (``device_decode_batch``) finishes the two-stage JPEG decode
with torch on the loader's device: dequantise, IDCT (CUDA kernel K1), range limit,
upsample and colour (:mod:`petastorm_tpu_torch.ops.jpeg`). ``spark_dtype`` gives each
codec's pyspark storage type for the Spark write path (pyspark imported when called), and
``__setstate__`` takes the reference petastorm's pickled codec state
(:mod:`petastorm_tpu_torch.compat.reference`).
"""
from __future__ import annotations

import io
import threading
import zlib

import numpy as np

from petastorm_tpu_torch import types as ptypes


class DataframeColumnCodec:
    """Base codec contract (reference: petastorm/codecs.py ~L30)."""

    #: True when the codec has an on-device decode path.
    device_decodable = False

    def encode(self, unischema_field, value):
        """Encode ``value`` into a Parquet-storable python value (scalar or bytes)."""
        raise NotImplementedError

    def decode(self, unischema_field, encoded):
        """Decode a stored value back into the numpy value declared by the field."""
        raise NotImplementedError

    def arrow_dtype(self, unischema_field=None):
        """pyarrow storage type for this codec's column."""
        raise NotImplementedError

    def spark_dtype(self):
        """pyspark storage type (requires pyspark; only needed on the Spark write path)."""
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash(type(self).__name__)


class ScalarCodec(DataframeColumnCodec):
    """Stores a scalar in a typed Parquet column (reference: petastorm/codecs.py ~L60).

    Takes a :mod:`petastorm_tpu_torch.types` tag or a ``pyspark.sql.types`` instance,
    which is converted to the equivalent tag."""

    def __init__(self, scalar_type):
        if not isinstance(scalar_type, ptypes.ScalarType):
            scalar_type = _tag_from_spark_type(scalar_type)
        self._scalar_type = scalar_type

    @property
    def scalar_type(self):
        return self._scalar_type

    def encode(self, unischema_field, value):
        if isinstance(value, np.ndarray):
            if value.ndim != 0 and value.size != 1:
                raise ValueError(
                    "Expected a scalar for field %r, got array of shape %r"
                    % (unischema_field.name, value.shape)
                )
            value = value.reshape(())[()]
        t = self._scalar_type
        if isinstance(t, ptypes.StringType):
            return str(value)
        if isinstance(t, ptypes.BinaryType):
            return bytes(value)
        if isinstance(t, ptypes.BooleanType):
            return bool(value)
        if isinstance(t, ptypes.DecimalType):
            import decimal

            return decimal.Decimal(str(value))
        if isinstance(t, (ptypes.DateType, ptypes.TimestampType)):
            return value
        np_dtype = t.to_numpy_dtype()
        if np_dtype.kind in "iu":
            return int(value)
        if np_dtype.kind == "f":
            return float(value)
        return value

    def decode(self, unischema_field, encoded):
        import decimal

        if isinstance(self._scalar_type, ptypes.DecimalType) or isinstance(
            encoded, decimal.Decimal
        ):
            return decimal.Decimal(encoded) if not isinstance(encoded, decimal.Decimal) \
                else encoded
        np_dtype = np.dtype(unischema_field.numpy_dtype)
        if np_dtype.kind in ("U", "S", "O"):
            return encoded
        return np_dtype.type(encoded)

    def arrow_dtype(self, unischema_field=None):
        return self._scalar_type.arrow_type()

    def spark_dtype(self):
        return self._scalar_type.spark_type()

    def __setstate__(self, state):
        # the reference's ScalarCodec pickles as {'_spark_type': <pyspark type>}, which
        # the compat unpickler has already mapped onto a tag
        if "_spark_type" in state and "_scalar_type" not in state:
            spark_type = state["_spark_type"]
            self._scalar_type = spark_type if isinstance(spark_type, ptypes.ScalarType) \
                else _tag_from_spark_type(spark_type)
        else:
            self.__dict__.update(state)

    def __repr__(self):
        return "ScalarCodec(%r)" % (self._scalar_type,)

    def __eq__(self, other):
        return type(self) is type(other) and self._scalar_type == other._scalar_type

    def __hash__(self):
        return hash((type(self).__name__, self._scalar_type))


class NdarrayCodec(DataframeColumnCodec):
    """Stores an ndarray as npy bytes in a binary column (reference: petastorm/codecs.py ~L130)."""

    def encode(self, unischema_field, value):
        expected = np.dtype(unischema_field.numpy_dtype)
        if not isinstance(value, np.ndarray):
            raise ValueError(
                "Expected numpy ndarray for field %r, got %r"
                % (unischema_field.name, type(value))
            )
        if value.dtype != expected:
            raise ValueError(
                "Field %r expected dtype %r, got %r"
                % (unischema_field.name, expected, value.dtype)
            )
        _check_shape(unischema_field, value)
        memfile = io.BytesIO()
        np.save(memfile, value, allow_pickle=False)
        return bytearray(memfile.getvalue())

    def decode(self, unischema_field, encoded):
        return np.load(io.BytesIO(encoded), allow_pickle=False)

    def arrow_dtype(self, unischema_field=None):
        import pyarrow as pa

        return pa.binary()

    def spark_dtype(self):
        import pyspark.sql.types as T

        return T.BinaryType()


class CompressedNdarrayCodec(DataframeColumnCodec):
    """npy bytes + zlib (reference: petastorm/codecs.py ~L170)."""

    def encode(self, unischema_field, value):
        raw = NdarrayCodec().encode(unischema_field, value)
        return bytearray(zlib.compress(bytes(raw)))

    def decode(self, unischema_field, encoded):
        return NdarrayCodec().decode(unischema_field, zlib.decompress(encoded))

    def arrow_dtype(self, unischema_field=None):
        import pyarrow as pa

        return pa.binary()

    def spark_dtype(self):
        import pyspark.sql.types as T

        return T.BinaryType()


#: Rows of device-decoded image columns that stage 1 could not take (lossless,
#: arithmetic-coded, CMYK or corrupt-for-us streams) and cv2 decoded on the host
#: instead. Content semantics, not a device fallback; counted so a run can show
#: how much of its corpus took that road.
_host_decoded_rows = 0
_host_decoded_lock = threading.Lock()


def host_decoded_rows(reset=False):
    """Rows that took the host cv2 decode inside ``host_stage_decode`` so far."""
    global _host_decoded_rows
    with _host_decoded_lock:
        n = _host_decoded_rows
        if reset:
            _host_decoded_rows = 0
    return n


def _count_host_decoded():
    global _host_decoded_rows
    with _host_decoded_lock:
        _host_decoded_rows += 1


#: Rows the row-group batched stage 1 handed back (a layout other than the row group's
#: first stream's: a mixed-size store) and stage 1 decoded one by one instead. Such rows
#: carry no ``kmax`` or ``specmax``, which turns the zigzag truncation off for their
#: batch's group; counted so a run can show how much of its corpus took that road.
_per_image_stage1_rows = 0


def per_image_stage1_rows(reset=False):
    """Rows that ``host_stage_decode_batch`` sent through the per-image stage 1 so far."""
    global _per_image_stage1_rows
    with _host_decoded_lock:
        n = _per_image_stage1_rows
        if reset:
            _per_image_stage1_rows = 0
    return n


class CompressedImageCodec(DataframeColumnCodec):
    """PNG/JPEG image bytes (reference: petastorm/codecs.py ~L200, cv2 imencode/imdecode).

    For ``jpeg`` payloads the loader can route decode through the two-stage path: host
    entropy decode to quantized DCT coefficients in the reader pool, then dequantise,
    IDCT, upsample and YCbCr to BGR on the loader's device. ``decode`` is the host path.
    """

    def __init__(self, image_codec="png", quality=80):
        if image_codec not in ("png", "jpeg", "jpg"):
            raise ValueError("Unsupported image codec %r" % image_codec)
        self._image_codec = "jpeg" if image_codec == "jpg" else image_codec
        self._quality = int(quality)

    @property
    def image_codec(self):
        return self._image_codec

    @property
    def device_decodable(self):
        return self._image_codec == "jpeg"

    def encode(self, unischema_field, value):
        if not isinstance(value, np.ndarray):
            raise ValueError("Expected ndarray image for field %r" % unischema_field.name)
        if np.dtype(unischema_field.numpy_dtype) != value.dtype:
            raise ValueError(
                "Field %r expected dtype %r, got %r"
                % (unischema_field.name, unischema_field.numpy_dtype, value.dtype)
            )
        _check_shape(unischema_field, value)
        import cv2

        if self._image_codec == "png":
            ok, contents = cv2.imencode(".png", value)
        else:
            ok, contents = cv2.imencode(
                ".jpeg", value, [int(cv2.IMWRITE_JPEG_QUALITY), self._quality]
            )
        if not ok:
            raise ValueError("cv2.imencode failed for field %r" % unischema_field.name)
        return bytearray(contents.tobytes())

    def decode(self, unischema_field, encoded):
        import cv2

        from petastorm_tpu_torch.errors import DecodeFieldError

        img = cv2.imdecode(np.frombuffer(encoded, dtype=np.uint8), cv2.IMREAD_UNCHANGED)
        if img is None:
            raise DecodeFieldError(
                "cv2.imdecode failed for field %r (stream is corrupt or uses a JPEG "
                "family cv2 does not support, e.g. lossless)" % unischema_field.name)
        return img.astype(np.dtype(unischema_field.numpy_dtype), copy=False)

    def host_stage_decode(self, unischema_field, encoded):
        """JPEG bytes → quantized DCT coefficient planes (native C++ entropy decode,
        GIL released). Streams the two-stage path cannot handle fall back to the full
        host decode of this row (counted by :func:`host_decoded_rows`)."""
        if not self.device_decodable:
            raise NotImplementedError("on-device decode is only available for jpeg")
        from petastorm_tpu_torch.errors import DecodeFieldError
        from petastorm_tpu_torch.ops.jpeg import entropy_decode_jpeg_fast

        try:
            return entropy_decode_jpeg_fast(bytes(encoded))
        except ValueError as stage_err:
            try:
                img = self.decode(unischema_field, encoded)
            except DecodeFieldError as host_err:
                raise DecodeFieldError(
                    "Field %r: stream is decodable by neither the two-stage device "
                    "path (%s) nor host cv2 (%s)"
                    % (unischema_field.name, stage_err, host_err)) from host_err
            _count_host_decoded()
            return img

    def host_stage_decode_batch(self, unischema_field, values):
        """Sequence of encoded blobs (``None`` entries preserved) → list of staging
        payloads, one native call per row group when possible; streams the batched
        stage 1 cannot take go through :meth:`host_stage_decode` one by one."""
        if not self.device_decodable:
            raise NotImplementedError("on-device decode is only available for jpeg")
        from petastorm_tpu_torch.ops.jpeg import entropy_decode_jpeg_batch

        idx = [i for i, v in enumerate(values) if v is not None]
        out = [None] * len(values)
        if not idx:
            return out
        blobs = [bytes(values[i]) for i in idx]
        try:
            planes = entropy_decode_jpeg_batch(blobs)
        except (ValueError, RuntimeError):
            planes = [None] * len(blobs)
        global _per_image_stage1_rows
        redone = 0
        for j, i in enumerate(idx):
            p = planes[j]
            if p is None:
                redone += 1
                p = self.host_stage_decode(unischema_field, blobs[j])
            out[i] = p
        if redone:
            with _host_decoded_lock:
                _per_image_stage1_rows += redone
        return out

    def device_decode_batch(self, unischema_field, staged, device, stager=None,
                            resize_to=None):
        """Coefficient planes (one per row) → (n, ...) uint8 tensor on ``device``.

        Matches :meth:`decode`'s per-row contract: stored (BGR) channel order for colour,
        2-D for grayscale fields. Rows that fell back to host decode arrive as ndarrays
        and are merged in at their original positions. ``resize_to=(h, w)`` takes a
        mixed-size store: the device rows are resized on the device after decode
        (:func:`petastorm_tpu_torch.ops.jpeg.resize_image_batch`), the host rows with
        ``cv2.resize(INTER_LINEAR)``, the matching sampling. The decode runs in stored
        order, which the resize (channel by channel) does not mind. ``stager``: see
        :func:`petastorm_tpu_torch.ops.jpeg.decode_jpeg_batch`."""
        if not self.device_decodable:
            raise NotImplementedError("on-device decode is only available for jpeg")
        import torch

        from petastorm_tpu_torch.ops.jpeg import JpegPlanes, decode_jpeg_batch

        staged = list(staged)
        plane_idx = [i for i, s in enumerate(staged) if isinstance(s, JpegPlanes)]
        host_idx = [i for i, s in enumerate(staged) if not isinstance(s, JpegPlanes)]
        shape = unischema_field.shape
        grayscale = shape is not None and len(shape) == 2

        parts = []
        order = []
        if plane_idx:
            img = decode_jpeg_batch([staged[i] for i in plane_idx], device=device,
                                    bgr=not grayscale, stager=stager, resize_to=resize_to)
            parts.append(img[..., 0].contiguous() if grayscale else img)
            order.extend(plane_idx)
        if host_idx:
            # host-decoded rows are already in stored order
            fallbacks = [staged[i] for i in host_idx]
            if resize_to is not None:
                import cv2

                h, w = int(resize_to[0]), int(resize_to[1])
                fallbacks = [f if f.shape[0] == h and f.shape[1] == w
                             else cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR)
                             for f in fallbacks]
            host = torch.from_numpy(np.stack(fallbacks))
            parts.append(host.to(device))
            order.extend(host_idx)
        out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        if order != sorted(order):
            inverse = torch.from_numpy(np.argsort(np.asarray(order))).to(out.device)
            out = out.index_select(0, inverse)
        return out

    def arrow_dtype(self, unischema_field=None):
        import pyarrow as pa

        return pa.binary()

    def spark_dtype(self):
        import pyspark.sql.types as T

        return T.BinaryType()

    def __setstate__(self, state):
        # the reference's CompressedImageCodec keeps cv2's extension ('.png', '.jpeg')
        codec = state.get("_image_codec", "png").lstrip(".")
        codec = "jpeg" if codec == "jpg" else codec
        if codec not in ("png", "jpeg"):
            raise ValueError("Unsupported image codec %r in pickled state" % codec)
        self._image_codec = codec
        self._quality = int(state.get("_quality", 80))

    def __repr__(self):
        return "CompressedImageCodec(%r, quality=%d)" % (self._image_codec, self._quality)


def _check_shape(unischema_field, value):
    shape = unischema_field.shape
    if shape is None:
        return
    if len(shape) != value.ndim:
        raise ValueError(
            "Field %r declares rank %d, got array rank %d"
            % (unischema_field.name, len(shape), value.ndim)
        )
    for declared, actual in zip(shape, value.shape):
        if declared is not None and declared != actual:
            raise ValueError(
                "Field %r declares shape %r, got %r"
                % (unischema_field.name, shape, value.shape)
            )


def _tag_from_spark_type(spark_type):
    """The :mod:`petastorm_tpu_torch.types` tag of a ``pyspark.sql.types`` instance
    (matched by class name: pyspark need not be installed)."""
    name = type(spark_type).__name__
    if name == "DecimalType":
        return ptypes.DecimalType(spark_type.precision, spark_type.scale)
    tag_cls = getattr(ptypes, name, None)
    if tag_cls is None or not isinstance(tag_cls, type) \
            or not issubclass(tag_cls, ptypes.ScalarType):
        raise ValueError("Unsupported scalar type %r" % (spark_type,))
    return tag_cls()
