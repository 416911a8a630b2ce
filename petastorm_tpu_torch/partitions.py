"""Hive-partitioned dataset support: ``key=value`` directory layouts.

Port of ``petastorm_tpu.partitions``: a hive-partitioned store (a) materializes the
partition-directory columns as row values and (b) prunes whole directories from
``filters=`` before any row group is scheduled, through four functions over the piece
list:

- :func:`partition_values_for_path` — parse ``key=value`` segments out of a file path
  relative to the dataset root (hive URL-encoding and ``__HIVE_DEFAULT_PARTITION__``
  null markers included).
- :func:`build_partition_info` — infer one typed :class:`PartitionInfo` for the whole
  dataset (key order from the directory depth; value dtype int64 → float64 → string by
  the narrowest type every observed value parses as — pyarrow's inference rule).
- :func:`prune_pieces` — drop whole pieces whose partition values cannot satisfy the
  DNF ``filters`` BEFORE scheduling (the remaining row-level clauses still run as
  vectorized masks in the workers).
- :func:`attach_partition_columns` — append the constant partition columns to a
  row-group table after the (column-pruned) file read, so delivered rows/batches carry
  the partition values like any other column.
"""
from __future__ import annotations

import posixpath
from urllib.parse import unquote

import numpy as np

#: Hive's marker for a null partition value.
HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"


class PartitionInfo:
    """Typed description of a dataset's hive partitioning.

    Attributes
    ----------
    keys : tuple of str
        Partition column names in directory order (outermost first).
    converters : dict
        ``{key: callable(str) -> value}`` applying the inferred type.
    numpy_dtypes : dict
        ``{key: numpy dtype}`` of the materialized columns.
    """

    def __init__(self, keys, converters, numpy_dtypes):
        self.keys = tuple(keys)
        self.converters = dict(converters)
        self.numpy_dtypes = dict(numpy_dtypes)

    def __bool__(self):
        return bool(self.keys)

    def typed_values(self, raw_values):
        """Apply the inferred types to one piece's raw string values."""
        out = {}
        for key in self.keys:
            raw = raw_values.get(key)
            out[key] = None if raw is None else self.converters[key](raw)
        return out


def partition_values_for_path(file_path, root):
    """Ordered ``{key: raw-string-value}`` parsed from ``key=value`` path segments of
    ``file_path`` relative to ``root`` (empty dict for flat layouts). Values are
    URL-unquoted (hive percent-encodes special characters); the hive null marker maps
    to ``None``."""
    root = root.rstrip("/")
    path = file_path
    if not path.startswith(root):
        return {}
    rel = path[len(root):].lstrip("/")
    values = {}
    for segment in rel.split("/")[:-1]:  # last segment is the file name
        if "=" not in segment:
            continue
        key, _, raw = segment.partition("=")
        raw = unquote(raw)
        values[unquote(key)] = None if raw == HIVE_NULL else raw
    return values


def _infer_converter(raw_values):
    """Narrowest of int64/float64/string that every observed value parses as."""
    non_null = [v for v in raw_values if v is not None]
    try:
        for v in non_null:
            int(v)
        return int, np.dtype(np.int64)
    except ValueError:
        pass
    try:
        for v in non_null:
            float(v)
        return float, np.dtype(np.float64)
    except ValueError:
        pass
    return str, np.dtype("O")


def build_partition_info(per_piece_raw):
    """One :class:`PartitionInfo` from every piece's raw partition values.

    ``per_piece_raw``: iterable of ``{key: raw string}`` dicts (one per piece). Key sets
    must agree across pieces (a store mixing partitioned and flat files is malformed);
    raises ValueError otherwise. Returns a falsy PartitionInfo for flat datasets."""
    per_piece_raw = list(per_piece_raw)
    if not per_piece_raw or not any(per_piece_raw):
        return PartitionInfo((), {}, {})
    keys = tuple(per_piece_raw[0].keys())
    keyset = set(keys)
    for values in per_piece_raw:
        if set(values.keys()) != keyset:
            raise ValueError(
                "Inconsistent hive partitioning: saw partition keys %s and %s in the "
                "same dataset" % (sorted(keyset), sorted(values.keys()))
            )
    converters = {}
    dtypes = {}
    for key in keys:
        conv, dtype = _infer_converter([v.get(key) for v in per_piece_raw])
        converters[key] = conv
        dtypes[key] = dtype
    return PartitionInfo(keys, converters, dtypes)


def partition_fields(info, nullable=False):
    """Partition columns as codec-less :class:`UnischemaField` scalars (decode is a
    plain dtype coercion — see ``utils.decode_row`` codec-None branch)."""
    from petastorm_tpu_torch.unischema import UnischemaField

    fields = []
    for key in info.keys:
        dtype = info.numpy_dtypes[key]
        np_type = str if dtype == np.dtype("O") else dtype.type
        fields.append(UnischemaField(key, np_type, (), None, nullable))
    return fields


def normalize_filters(filters, info):
    """Coerce filter values on partition columns to the columns' inferred types.

    Directory values arrive as strings but infer to int64/float64; a user writing the
    legacy pyarrow/petastorm convention ``filters=[('chunk', '=', '1')]`` against an
    int-typed ``chunk`` would otherwise silently match nothing (``1 == '1'`` is False)
    both at directory-prune time and in the row-level mask over the attached typed
    column. Uncoercible values are left as-is (the term can then never match — the
    reader's no-data error surfaces the mismatch rather than wrong results)."""
    if not filters or not info:
        return filters
    keyset = set(info.keys)

    def coerce(name, val):
        conv = info.converters[name]
        try:
            if isinstance(val, (list, tuple, set, frozenset)):
                return type(val)(conv(v) for v in val) if not isinstance(val, (set, frozenset)) \
                    else set(conv(v) for v in val)
            return conv(val)
        except (TypeError, ValueError):
            return val

    def norm_clause(clause):
        return [(name, op, coerce(name, val)) if name in keyset else (name, op, val)
                for name, op, val in clause]

    if isinstance(filters[0][0], str):
        return norm_clause(filters)
    return [norm_clause(c) for c in filters]


def _term_matches(value, op, filter_val):
    if op in ("=", "=="):
        return value == filter_val
    if op == "!=":
        return value != filter_val
    if op == "<":
        return value < filter_val
    if op == "<=":
        return value <= filter_val
    if op == ">":
        return value > filter_val
    if op == ">=":
        return value >= filter_val
    if op == "in":
        return value in set(filter_val)
    if op in ("not in", "not-in"):
        return value not in set(filter_val)
    raise ValueError("Unsupported filter op %r" % op)


def piece_matches_filters(typed_values, filters, keys):
    """Can a piece with these partition values satisfy the DNF ``filters``?

    Terms over non-partition columns are treated as satisfiable (they become row-level
    masks later); a piece is dropped only when EVERY or-clause contains a partition
    term its values fail — pruning is conservative-correct."""
    if not filters:
        return True
    clauses = [filters] if isinstance(filters[0][0], str) else filters
    keyset = set(keys)
    for clause in clauses:
        ok = True
        for name, op, val in clause:
            if name not in keyset:
                continue
            value = typed_values.get(name)
            try:
                if value is None:
                    # __HIVE_DEFAULT_PARTITION__ directory: null values MATCH the
                    # negative operators (same convention as the row-level mask and
                    # _prune_by_stats' nulls==0 guard), and an 'in' list may name
                    # None explicitly; ordering/equality ops never match null.
                    if op in ("!=", "not in", "not-in"):
                        matched = True
                    elif op == "in":
                        matched = None in set(val)
                    else:
                        matched = False
                else:
                    matched = _term_matches(value, op, val)
            except TypeError:  # uncoercible filter value vs typed partition value
                matched = False
            if not matched:
                ok = False
                break
        if ok:
            return True
    return False


def prune_pieces(pieces, info, filters):
    """Directory-level pruning: drop pieces whose partition values cannot satisfy
    ``filters`` — their files are never opened, never scheduled."""
    if not info or not filters:
        return pieces
    kept = []
    for piece in pieces:
        typed = info.typed_values(piece.partition_values or {})
        if piece_matches_filters(typed, filters, info.keys):
            kept.append(piece)
    return kept


def attach_partition_columns(table, piece, info, wanted=None):
    """Append this piece's partition values as constant columns to a row-group table.

    ``wanted``: only attach these columns (None = all partition keys). Columns already
    present in the file win (a writer may also store the partition column inline)."""
    import pyarrow as pa

    if not info:
        return table
    typed = info.typed_values(piece.partition_values or {})
    existing = set(table.column_names)
    for key in info.keys:
        if key in existing or (wanted is not None and key not in wanted):
            continue
        value = typed[key]
        dtype = info.numpy_dtypes[key]
        if value is None:
            arr = pa.nulls(table.num_rows)
        elif dtype == np.dtype("O"):
            arr = pa.array([value] * table.num_rows, type=pa.string())
        else:
            arr = pa.array(np.full(table.num_rows, value, dtype=dtype))
        table = table.append_column(key, arr)
    return table
