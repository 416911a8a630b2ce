"""Row-group indexing: build value→row-group indexes enabling ``rowgroup_selector`` pruning.

Port of ``petastorm_tpu.etl.rowgroup_indexing`` (``SingleFieldIndexer``,
``build_rowgroup_index``, ``get_row_group_indexes``): a plain pyarrow scan, stored as
zlib'd JSON under the same key-value key (``PTPU_INDEX_KEY``) in ``_common_metadata``, so
an index built by either package is read by the other.
"""
from __future__ import annotations

import json
import posixpath
import zlib

from petastorm_tpu_torch.metadata import _read_kv_metadata, load_row_groups

PTPU_INDEX_KEY = b"petastorm_tpu.rowgroup_index.json.zlib.v1"  # the JAX package's key


class SingleFieldIndexer:
    """Maps each distinct value of one field to the set of row-group ordinals containing it."""

    def __init__(self, index_name, index_field):
        self.index_name = index_name
        self.index_field = index_field
        self._index = {}

    def add(self, value, row_group_ordinal):
        self._index.setdefault(_key(value), set()).add(int(row_group_ordinal))

    def get_row_group_indexes(self, value=None):
        if value is None:
            return sorted(set().union(*self._index.values())) if self._index else []
        return sorted(self._index.get(_key(value), set()))

    @property
    def indexed_values(self):
        return sorted(self._index.keys())

    def to_jsonable(self):
        return {
            "field": self.index_field,
            "values": {k: sorted(v) for k, v in self._index.items()},
        }

    @classmethod
    def from_jsonable(cls, index_name, payload):
        idx = cls(index_name, payload["field"])
        idx._index = {k: set(v) for k, v in payload["values"].items()}
        return idx


def _key(value):
    return str(value)


def build_rowgroup_index(dataset_url, indexers, storage_options=None, filesystem=None):
    """Scan the dataset once and persist the requested indexes in ``_common_metadata``.

    ``indexers``: list of :class:`SingleFieldIndexer` (empty ``_index``; filled here).
    """
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths
    from petastorm_tpu_torch.metadata import get_schema

    fs, path = get_filesystem_and_path_or_paths(dataset_url, storage_options, filesystem)
    schema = get_schema(fs, path)
    pieces = load_row_groups(fs, path)
    fields = sorted({ix.index_field for ix in indexers})
    for name in fields:
        if name not in schema.fields:
            raise ValueError("Cannot index unknown field %r" % name)
    for ordinal, piece in enumerate(pieces):
        with fs.open_input_file(piece.path) as f:
            table = pq.ParquetFile(f).read_row_group(piece.row_group, columns=fields)
        for ix in indexers:
            field = schema.fields[ix.index_field]
            stored = table.column(ix.index_field).to_pylist()
            for v in stored:
                if field.codec is not None:
                    v = field.codec.decode(field, v)
                ix.add(v, ordinal)
    _write_index_metadata(fs, path, {ix.index_name: ix for ix in indexers})
    return indexers


def _write_index_metadata(fs, path, index_dict):
    import pyarrow.parquet as pq

    kv = _read_kv_metadata(fs, path) or {}
    payload = {name: ix.to_jsonable() for name, ix in index_dict.items()}
    kv[PTPU_INDEX_KEY] = zlib.compress(json.dumps(payload).encode("utf-8"))
    meta_path = posixpath.join(path, "_common_metadata")
    with fs.open_input_file(meta_path) as f:
        arrow_schema = pq.read_schema(f)
    with fs.open_output_stream(meta_path) as sink:
        pq.write_metadata(arrow_schema.with_metadata(kv), sink)


def get_row_group_indexes(fs, path):
    """Load {index_name: SingleFieldIndexer} from dataset metadata."""
    kv = _read_kv_metadata(fs, path)
    if not kv or PTPU_INDEX_KEY not in kv:
        raise ValueError(
            "Dataset at %r has no row-group index; run build_rowgroup_index first" % path
        )
    payload = json.loads(zlib.decompress(kv[PTPU_INDEX_KEY]).decode("utf-8"))
    return {
        name: SingleFieldIndexer.from_jsonable(name, body) for name, body in payload.items()
    }