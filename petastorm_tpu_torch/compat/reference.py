"""Read datasets written by the reference petastorm without importing petastorm.

Port of ``petastorm_tpu.compat.reference``. A reference dataset keeps a *pickled*
``Unischema`` under the Parquet key-value key ``dataset-toolkit.unischema.v1`` (and its
row-group counts, pickled, under ``dataset-toolkit.num_row_groups_per_file.v1``). The
pickle stream names ``petastorm.unischema``, ``petastorm.codecs`` and
``pyspark.sql.types`` classes (or the pre-rename ``dataset_toolkit`` package's); this
unpickler maps those onto this package's classes, so the bytes deserialize into the
port's objects with neither petastorm nor pyspark installed. The metadata is the store's,
and a pickle may name any callable: beyond those classes the unpickler takes only what
such a schema is built from (builtin containers, numpy's dtypes and scalar types,
``Decimal``) and refuses anything else.
"""
from __future__ import annotations

import io
import pickle

_CLASSES = {
    "unischema": {"Unischema": "petastorm_tpu_torch.unischema",
                  "UnischemaField": "petastorm_tpu_torch.unischema"},
    "codecs": {name: "petastorm_tpu_torch.codecs"
               for name in ("ScalarCodec", "NdarrayCodec", "CompressedNdarrayCodec",
                            "CompressedImageCodec")},
}

#: (module, class) of the reference (and its pre-rename package) → the port's module
_CLASS_MAP = {
    ("%s.%s" % (package, module), name): (target, name)
    for package in ("petastorm", "dataset_toolkit")
    for module, names in _CLASSES.items()
    for name, target in names.items()
}

_PYSPARK_TYPE_NAMES = {
    "BooleanType", "ByteType", "ShortType", "IntegerType", "LongType", "FloatType",
    "DoubleType", "StringType", "BinaryType", "DateType", "TimestampType", "DecimalType",
}


#: (module, names) a reference schema's pickle may name besides the classes above
_SAFE_GLOBALS = {
    "builtins": {"object", "tuple", "list", "dict", "set", "frozenset", "str", "bytes",
                 "bytearray", "int", "float", "complex", "bool"},
    "copyreg": {"_reconstructor"},
    "_codecs": {"encode"},
    "collections": {"OrderedDict"},
    "decimal": {"Decimal"},
    "numpy": {"dtype", "ndarray"},
    "numpy.core.multiarray": {"scalar", "_reconstruct"},
    "numpy._core.multiarray": {"scalar", "_reconstruct"},
    "numpy.core.numeric": {"_frombuffer"},
    "numpy._core.numeric": {"_frombuffer"},
}


def _is_numpy_type(module, name):
    """``numpy.<name>`` is a scalar type (``numpy.int32``) or, under ``numpy.dtypes``, a
    dtype class."""
    import numpy as np

    if module == "numpy":
        value = getattr(np, name, None)
        return isinstance(value, type) and issubclass(value, np.generic)
    if module == "numpy.dtypes":
        value = getattr(getattr(np, "dtypes", None), name, None)
        return isinstance(value, type) and issubclass(value, np.dtype)
    return False


class _ReferenceUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _CLASS_MAP:
            target_module, target_name = _CLASS_MAP[(module, name)]
            mod = __import__(target_module, fromlist=[target_name])
            return getattr(mod, target_name)
        if module.startswith("pyspark.sql.types") and name in _PYSPARK_TYPE_NAMES:
            from petastorm_tpu_torch import types as ptypes

            return getattr(ptypes, name)
        if module.startswith(("petastorm", "dataset_toolkit", "pyspark")):
            raise pickle.UnpicklingError(
                "Reference pickle references unsupported class %s.%s" % (module, name)
            )
        if name in _SAFE_GLOBALS.get(module, ()) or _is_numpy_type(module, name):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            "Reference pickle references %s.%s, which a reference schema does not hold"
            % (module, name))


def loads_reference_pickle(payload):
    """Deserialize a reference-petastorm pickle into petastorm_tpu_torch objects."""
    return _ReferenceUnpickler(io.BytesIO(payload)).load()
