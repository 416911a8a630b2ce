"""Schema/codec contract rule for literal ``UnischemaField`` declarations.

A field whose codec cannot faithfully store its declared numpy dtype fails at
runtime — at encode (object arrays through ``NdarrayCodec``'s
``allow_pickle=False`` save), at decode (int32 values round-tripped through an
int8 storage column), or silently (float64 truncated to float32) — always far
from the schema declaration that caused it. The checks mirror
``petastorm_tpu_torch/codecs.py`` + ``petastorm_tpu_torch/types.py`` exactly; anything the
rule cannot resolve statically is skipped, never guessed.
"""
from __future__ import annotations

import ast

import numpy as np

from petastorm_tpu_torch.analysis.findings import Severity
from petastorm_tpu_torch.analysis.engine import Rule
from petastorm_tpu_torch.analysis.rules._astutil import attr_chain, call_func_name, call_kwarg

#: scalar type tag -> (numpy storage dtype or None for object-backed, allowed
#: field dtype kinds). Mirrors petastorm_tpu_torch/types.py.
_SCALAR_TAGS = {
    "BooleanType": ("bool_", "b"),
    "ByteType": ("int8", "iu"),
    "ShortType": ("int16", "iu"),
    "IntegerType": ("int32", "iu"),
    "LongType": ("int64", "iu"),
    "FloatType": ("float32", "fiu"),
    "DoubleType": ("float64", "fiu"),
    "StringType": (None, "USO"),
    "BinaryType": (None, "SO"),
    "DateType": (None, "MO"),
    "TimestampType": (None, "MO"),
    "DecimalType": (None, "O"),
}

#: exact-integer bits representable by each float storage width
_FLOAT_EXACT_BITS = {4: 24, 8: 53}

#: declarative tabular ops whose output is integer ids by contract
#: (petastorm_tpu_torch/ops/tabular.py): op name -> positional index of ``out=``
_INT_OUTPUT_OPS = {"HashField": 2, "Bucketize": 3, "VocabLookup": 3,
                   "FeatureCross": 2}
#: declarative ops whose output is floating by contract
_FLOAT_OUTPUT_OPS = {"Normalize": 1, "Standardize": 1}


def _resolve_dtype(node, numpy_aliases):
    """AST dtype expression -> np.dtype, or None when not statically literal."""
    try:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return np.dtype(node.value)
        chain = attr_chain(node)
        if chain and "." in chain:
            root, rest = chain.split(".", 1)
            if root in numpy_aliases and "." not in rest:
                attr = getattr(np, rest, None)
                if attr is not None:
                    return np.dtype(attr)
        if isinstance(node, ast.Call) and call_func_name(node) == "dtype" \
                and node.args:
            return _resolve_dtype(node.args[0], numpy_aliases)
    except TypeError:
        return None
    return None


def _resolve_shape(node):
    """AST shape expression -> ('known', tuple) or ('unknown', None)."""
    if isinstance(node, ast.Constant) and node.value is None:
        return "known", None
    if isinstance(node, (ast.Tuple, ast.List)):
        dims = []
        for elt in node.elts:
            if isinstance(elt, ast.Constant) and (
                    elt.value is None or isinstance(elt.value, int)):
                dims.append(elt.value)
            else:
                return "unknown", None
        return "known", tuple(dims)
    return "unknown", None


def _resolve_codec(node):
    """AST codec expression -> ('scalar', tag) | ('ndarray',) | ('image', fmt)
    | ('none',) | None when not statically resolvable."""
    if isinstance(node, ast.Constant) and node.value is None:
        return ("none",)
    if not isinstance(node, ast.Call):
        return None
    name = call_func_name(node)
    if name == "ScalarCodec":
        if not node.args:
            return None
        tag_call = node.args[0]
        if isinstance(tag_call, ast.Call):
            tag = call_func_name(tag_call)
            if tag in _SCALAR_TAGS:
                return ("scalar", tag)
        return None
    if name in ("NdarrayCodec", "CompressedNdarrayCodec"):
        return ("ndarray",)
    if name == "CompressedImageCodec":
        fmt_node = node.args[0] if node.args else call_kwarg(node, "image_codec")
        if fmt_node is None:
            fmt = "png"
        elif isinstance(fmt_node, ast.Constant) and isinstance(fmt_node.value, str):
            fmt = "jpeg" if fmt_node.value == "jpg" else fmt_node.value
        else:
            return None
        return ("image", fmt)
    return None


def _int_range_fits(field_dtype, storage_dtype):
    lo, hi = np.iinfo(field_dtype).min, np.iinfo(field_dtype).max
    slo, shi = np.iinfo(storage_dtype).min, np.iinfo(storage_dtype).max
    return lo >= slo and hi <= shi


class SchemaCodecContractRule(Rule):
    """GL-S001: literal ``UnischemaField`` whose codec and numpy dtype are
    incompatible per codecs.py — plus declarative tabular-op dtype contracts:
    hash/bucketize/vocab/cross ids must land in integer fields,
    normalize/standardize outputs in floating ones. Ops are correlated with
    literal ``UnischemaField`` declarations in the same module by output
    field name; anything not statically resolvable is skipped, never
    guessed."""

    rule_id = "GL-S001"
    severity = Severity.ERROR
    description = "UnischemaField codec cannot faithfully store the declared dtype"
    fix_hint = ("pick the codec whose storage type covers the field dtype (see "
                "petastorm_tpu_torch/types.py for the ScalarCodec storage map); "
                "declarative op outputs must match the op's dtype contract "
                "(ops/tabular.py)")

    def check(self, tree, ctx):
        declared = {}   # field name -> resolved np.dtype (literal declarations)
        op_calls = []
        for node in ctx.by_type(ast.Call):
            name = call_func_name(node)
            if name == "UnischemaField":
                yield from self._check_field(node, ctx)
                fname, dtype_node, _shape, _codec = self._field_args(node)
                if fname != "?" and dtype_node is not None:
                    dtype = _resolve_dtype(dtype_node, ctx.numpy_aliases)
                    if dtype is not None:
                        declared[fname] = dtype
            elif name in _INT_OUTPUT_OPS or name in _FLOAT_OUTPUT_OPS:
                op_calls.append((name, node))
        for name, node in op_calls:
            yield from self._check_tabular_op(name, node, declared, ctx)

    def _op_out_name(self, op_name, call):
        """The op's EXPLICIT output field name (constant string), or None.

        Only an explicit ``out=`` is correlated with field declarations:
        when ``out`` defaults to the input field the op legitimately
        REPLACES the stored declaration (int32 source → float32 normalize is
        valid code), so flagging against the stored dtype would be a false
        positive."""
        node = call_kwarg(call, "out")
        out_pos = (_INT_OUTPUT_OPS.get(op_name)
                   if op_name in _INT_OUTPUT_OPS
                   else _FLOAT_OUTPUT_OPS[op_name])
        if node is None and len(call.args) > out_pos:
            node = call.args[out_pos]
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        return None

    def _check_tabular_op(self, op_name, call, declared, ctx):
        integer = op_name in _INT_OUTPUT_OPS
        want_kinds = "iu" if integer else "f"
        contract = "integer ids" if integer else "floating values"
        dtype_node = call_kwarg(call, "dtype")
        if dtype_node is not None:
            dtype = _resolve_dtype(dtype_node, ctx.numpy_aliases)
            if dtype is not None and dtype.kind not in want_kinds:
                yield ctx.finding(
                    self, call,
                    "%s produces %s but declares dtype=%s — use %s dtype"
                    % (op_name, contract, dtype,
                       "an integer" if integer else "a floating"))
                return
        out = self._op_out_name(op_name, call)
        if out is None:
            return
        field_dtype = declared.get(out)
        if field_dtype is not None and field_dtype.kind not in want_kinds:
            yield ctx.finding(
                self, call,
                "%s writes %s into field %r, but that UnischemaField is "
                "declared %s — declare %s field"
                % (op_name, contract, out, field_dtype,
                   "an integer" if integer else "a floating"))

    def _field_args(self, call):
        """(name, dtype_node, shape_node, codec_node) by position/keyword."""
        sig = ["name", "numpy_dtype", "shape", "codec", "nullable"]
        bound = dict(zip(sig, call.args))
        for kw in call.keywords:
            if kw.arg in sig:
                bound[kw.arg] = kw.value
        name_node = bound.get("name")
        name = name_node.value if isinstance(name_node, ast.Constant) else "?"
        return (name, bound.get("numpy_dtype"), bound.get("shape"),
                bound.get("codec"))

    def _check_field(self, call, ctx):
        name, dtype_node, shape_node, codec_node = self._field_args(call)
        if dtype_node is None or codec_node is None:
            return
        codec = _resolve_codec(codec_node)
        if codec is None or codec == ("none",):
            return
        dtype = _resolve_dtype(dtype_node, ctx.numpy_aliases)
        if dtype is None:
            return
        shape_known, shape = _resolve_shape(shape_node) if shape_node is not None \
            else ("unknown", None)

        if codec[0] == "scalar":
            tag = codec[1]
            if shape_known and shape:
                yield ctx.finding(
                    self, call,
                    "field %r: ScalarCodec(%s) cannot store a tensor of shape "
                    "%r — use NdarrayCodec" % (name, tag, shape))
                return
            storage_name, kinds = _SCALAR_TAGS[tag]
            if dtype.kind not in kinds:
                yield ctx.finding(
                    self, call,
                    "field %r: dtype %s is not storable via ScalarCodec(%s) "
                    "(storage %s)" % (name, dtype, tag,
                                      storage_name or tag.replace("Type", "").lower()))
                return
            if storage_name is not None:
                storage = np.dtype(storage_name)
                if dtype.kind in "iu" and storage.kind in "iu":
                    if not _int_range_fits(dtype, storage):
                        yield ctx.finding(
                            self, call,
                            "field %r: %s values overflow the %s storage column "
                            "of ScalarCodec(%s)" % (name, dtype, storage, tag))
                elif dtype.kind == "f" and storage.kind == "f":
                    if dtype.itemsize > storage.itemsize:
                        yield ctx.finding(
                            self, call,
                            "field %r: %s silently truncates to %s through "
                            "ScalarCodec(%s)" % (name, dtype, storage, tag))
                elif dtype.kind in "iu" and storage.kind == "f":
                    exact_bits = _FLOAT_EXACT_BITS[storage.itemsize]
                    if np.iinfo(dtype).max > (1 << exact_bits):
                        yield ctx.finding(
                            self, call,
                            "field %r: %s integers exceed the exact-integer "
                            "range of %s storage (ScalarCodec(%s))"
                            % (name, dtype, storage, tag))
        elif codec[0] == "ndarray":
            if dtype.kind == "O":
                yield ctx.finding(
                    self, call,
                    "field %r: object dtype cannot round-trip through "
                    "NdarrayCodec (np.save(allow_pickle=False) raises at "
                    "write time)" % name)
        elif codec[0] == "image":
            fmt = codec[1]
            allowed = ("uint8",) if fmt == "jpeg" else ("uint8", "uint16")
            if str(dtype) not in allowed:
                yield ctx.finding(
                    self, call,
                    "field %r: CompressedImageCodec(%r) stores %s images only, "
                    "dtype is %s" % (name, fmt, "/".join(allowed), dtype))
                return
            if shape_known and shape is not None:
                if len(shape) not in (2, 3):
                    yield ctx.finding(
                        self, call,
                        "field %r: CompressedImageCodec expects a (H, W) or "
                        "(H, W, C) image shape, got rank %d"
                        % (name, len(shape)))
                elif len(shape) == 3 and isinstance(shape[2], int):
                    ok_ch = (1, 3) if fmt == "jpeg" else (1, 3, 4)
                    if shape[2] not in ok_ch:
                        yield ctx.finding(
                            self, call,
                            "field %r: CompressedImageCodec(%r) supports %s "
                            "channels, shape declares %d"
                            % (name, fmt,
                               "/".join(str(c) for c in ok_ch), shape[2]))
