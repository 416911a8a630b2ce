"""Dataset metadata: write datasets, persist/recover schemas, enumerate row groups.

Port of ``petastorm_tpu.metadata`` (``RowWriter``, ``write_dataset``, ``get_schema``,
``infer_or_load_unischema``, ``load_row_groups``, ``aggregate_column_stats``,
``materialize_dataset``). It reads and writes the SAME key-value keys
(``PTPU_SCHEMA_KEY``, ``PTPU_ROW_GROUPS_KEY``) as the JAX package, so a store written by
either package reads in the other. A store written by the reference petastorm carries a
pickled unischema and pickled row-group counts under its own keys
(``REFERENCE_SCHEMA_KEY``, ``REFERENCE_ROW_GROUPS_KEY``); they are read after the JSON
keys, through :mod:`petastorm_tpu_torch.compat.reference`, so such a store opens without
petastorm or pyspark installed. Hive ``key=value`` directories are parsed into each
piece's ``partition_values`` (:mod:`petastorm_tpu_torch.partitions`).
"""
from __future__ import annotations

import json
import logging
import posixpath
from collections import namedtuple
from contextlib import contextmanager

from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths

logger = logging.getLogger(__name__)

# Key-value keys (JSON payloads); the same bytes as the JAX package's
PTPU_SCHEMA_KEY = b"petastorm_tpu.unischema.json.v1"
PTPU_ROW_GROUPS_KEY = b"petastorm_tpu.num_row_groups_per_file.json.v1"
# The reference petastorm's keys (pickled payloads; read only)
REFERENCE_SCHEMA_KEY = b"dataset-toolkit.unischema.v1"
REFERENCE_ROW_GROUPS_KEY = b"dataset-toolkit.num_row_groups_per_file.v1"

_METADATA_FILES = ("_common_metadata", "_metadata")

#: One unit of scheduled work: a single row group of a single file.
#: ``partition_values``: raw ``{key: str}`` parsed from hive ``key=value`` path segments
#: (None for flat layouts), typed and pruned by :mod:`petastorm_tpu_torch.partitions`.
#: ``stats``: ``{column: (min, max, null_count)}`` from the parquet row-group statistics
#: when the footer was read (None on the KV fast path): ``filters`` skip whole row groups
#: with them before scheduling, and the planner strips them before items reach the pool.
#: ``generation``: the file's generation token (``<size>.<mtime_ns>.<footer crc>``, see
#: :mod:`petastorm_tpu_torch.dataset.watch`) stamped when dataset watching is on (None
#: otherwise): reads check it, cache keys carry it, and a mismatch at read time means the
#: file was rewritten under the running reader.
RowGroupPiece = namedtuple("RowGroupPiece", ["path", "row_group", "num_rows",
                                             "partition_values", "stats",
                                             "generation"],
                           defaults=(None, None, None))


# --------------------------------------------------------------------------------------
# Write side
# --------------------------------------------------------------------------------------


class RowWriter:
    """pyarrow-native dataset writer: encode rows through codecs, write parquet files, then
    persist schema + row-group counts in ``_common_metadata``."""

    def __init__(self, dataset_url, schema, row_group_size_mb=32, rows_per_file=None,
                 filesystem=None, storage_options=None, compression="snappy"):
        self._url = str(dataset_url)
        self._schema = schema
        self._row_group_bytes = int(row_group_size_mb) << 20
        self._rows_per_file = rows_per_file
        self._compression = compression
        self._fs, self._path = get_filesystem_and_path_or_paths(
            self._url, storage_options=storage_options, filesystem=filesystem
        )
        self._arrow_schema = schema.as_arrow_schema()
        self._pending = []
        self._pending_bytes = 0
        self._file_index = 0
        self._files_written = []  # (filename, row_group_count)
        self._closed = False
        self._fs.create_dir(self._path, recursive=True)

    def write(self, row_dict):
        """Encode and stage one {field: value} row."""
        from petastorm_tpu_torch.unischema import encode_row

        self.write_encoded(encode_row(self._schema, row_dict))

    def write_encoded(self, encoded):
        """Stage one row whose values are already in storage form (codec output)."""
        clean = {
            k: (bytes(v) if isinstance(v, bytearray) else v) for k, v in encoded.items()
        }
        self._pending.append(clean)
        self._pending_bytes += sum(len(v) for v in clean.values() if isinstance(v, bytes)) + 64
        if self._rows_per_file and len(self._pending) >= self._rows_per_file:
            self._flush_file()
        elif self._pending_bytes >= self._row_group_bytes * 4:
            self._flush_file()

    def write_many(self, rows):
        for row in rows:
            self.write(row)

    def _flush_file(self):
        if not self._pending:
            return
        import pyarrow as pa
        import pyarrow.parquet as pq

        table = pa.Table.from_pylist(self._pending, schema=self._arrow_schema)
        fname = "part-%05d.parquet" % self._file_index
        full = posixpath.join(self._path, fname)
        rows_per_group = max(1, _rows_for_bytes(table, self._row_group_bytes))
        with self._fs.open_output_stream(full) as sink:
            pq.write_table(table, sink, row_group_size=rows_per_group,
                           compression=self._compression)
        num_row_groups = -(-table.num_rows // rows_per_group)
        self._files_written.append((fname, num_row_groups))
        self._file_index += 1
        self._pending = []
        self._pending_bytes = 0

    def close(self):
        if self._closed:
            return
        self._flush_file()
        write_petastorm_tpu_metadata(
            self._fs, self._path, self._schema, dict(self._files_written)
        )
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()


def write_dataset(dataset_url, schema, rows, row_group_size_mb=32, rows_per_file=None,
                  filesystem=None, storage_options=None):
    """One-shot pyarrow-native dataset write (iterable of row dicts)."""
    with RowWriter(dataset_url, schema, row_group_size_mb, rows_per_file,
                   filesystem, storage_options) as w:
        w.write_many(rows)


def write_petastorm_tpu_metadata(fs, path, schema, row_groups_per_file):
    """Write ``_common_metadata`` carrying the JSON schema + row-group counts."""
    import pyarrow.parquet as pq

    arrow_schema = schema.as_arrow_schema()
    existing = dict(arrow_schema.metadata or {})
    existing[PTPU_SCHEMA_KEY] = schema.to_json().encode("utf-8")
    existing[PTPU_ROW_GROUPS_KEY] = json.dumps(row_groups_per_file).encode("utf-8")
    tagged = arrow_schema.with_metadata(existing)
    with fs.open_output_stream(posixpath.join(path, "_common_metadata")) as sink:
        pq.write_metadata(tagged, sink)


@contextmanager
def materialize_dataset(spark, dataset_url, schema, row_group_size_mb=32,
                        filesystem_factory=None):
    """Spark materialization context manager (the reference's name and shape).

    Sets the Hadoop configuration's ``parquet.block.size`` to ``row_group_size_mb`` for
    the executors' writes inside the block and restores it after; then counts the row
    groups of every written file and writes ``_common_metadata`` with the schema. Takes
    a pyspark ``SparkSession`` (or any object with its ``sparkContext._jsc`` Hadoop
    configuration protocol). ``filesystem_factory`` is accepted for the reference's
    signature; the URL resolves the filesystem."""
    hadoop_conf = spark.sparkContext._jsc.hadoopConfiguration()
    key = "parquet.block.size"
    saved = hadoop_conf.get(key)
    hadoop_conf.setInt(key, int(row_group_size_mb) << 20)
    try:
        yield
    finally:
        if saved is None:
            hadoop_conf.unset(key)
        else:
            hadoop_conf.set(key, saved)
    fs, path = get_filesystem_and_path_or_paths(dataset_url)
    write_petastorm_tpu_metadata(fs, path, schema, _count_row_groups_per_file(fs, path))


def _count_row_groups_per_file(fs, path):
    """``{file path relative to path: row groups}`` from each file's footer."""
    import pyarrow.parquet as pq

    counts = {}
    for full in _list_parquet_files(fs, path):
        with fs.open_input_file(full) as f:
            counts[posixpath.relpath(full, path)] = pq.ParquetFile(f).metadata.num_row_groups
    return counts


# --------------------------------------------------------------------------------------
# Read side
# --------------------------------------------------------------------------------------


def _list_parquet_files(fs, path):
    import pyarrow.fs as pafs

    info = fs.get_file_info(path)
    if info.type == pafs.FileType.File:
        return [path]
    if info.type == pafs.FileType.NotFound:
        raise FileNotFoundError("Dataset path does not exist: %r" % path)
    names = _flat_object_listing(fs, path)
    if names is None:
        selector = pafs.FileSelector(path, recursive=True)
        names = [fi.path for fi in fs.get_file_info(selector)
                 if fi.type == pafs.FileType.File]
    files = []
    for full in names:
        base = posixpath.basename(full)
        if not base.startswith(("_", ".")):
            if base.endswith((".parquet", ".parq")) or "." not in base:
                files.append(full)
    return sorted(files)


def _flat_object_listing(fs, path):
    """One flat prefix listing for an fsspec-bridged object store, or None.

    An fsspec store (gcsfs, s3fs) emulates directories, so a recursive ``FileSelector``
    walk through pyarrow's ``FSSpecHandler`` costs one API round trip a directory,
    while the store lists any prefix in one paginated call: fsspec's ``find()``. The
    handler maps paths one to one, so the keys it returns are valid for the bridged
    pyarrow filesystem as they are."""
    handler = getattr(fs, "handler", None)
    inner = getattr(handler, "fs", None)
    if inner is None or not hasattr(inner, "find"):
        return None
    try:
        found = inner.find(path)
    except Exception as e:  # noqa: BLE001 — fall back to the selector walk
        logger.debug("flat listing failed (%s); selector walk", e)
        return None
    return [str(p) for p in found]


def _read_kv_metadata(fs, path):
    """Merged KV metadata from ``_common_metadata`` and ``_metadata`` if present, else None
    (``_common_metadata`` wins on conflicts)."""
    import pyarrow.parquet as pq

    merged = None
    for meta_name in reversed(_METADATA_FILES):
        full = posixpath.join(path, meta_name)
        try:
            with fs.open_input_file(full) as f:
                md = pq.read_schema(f).metadata
        except (FileNotFoundError, OSError):
            continue
        if md:
            merged = {**(merged or {}), **dict(md)}
        elif merged is None:
            merged = {}
    return merged


def get_schema(fs, path):
    """Recover the Unischema stored with a dataset: the JSON key, else the reference
    petastorm's pickled one."""
    kv = _read_kv_metadata(fs, path)
    if kv is None:
        raise MetadataError(
            "Dataset at %r has no _common_metadata/_metadata; was it written by "
            "write_dataset? Use make_batch_reader for vanilla Parquet stores." % path
        )
    if PTPU_SCHEMA_KEY in kv:
        from petastorm_tpu_torch.unischema import Unischema

        return Unischema.from_json(kv[PTPU_SCHEMA_KEY].decode("utf-8"))
    if REFERENCE_SCHEMA_KEY in kv:
        from petastorm_tpu_torch.compat.reference import loads_reference_pickle

        return loads_reference_pickle(kv[REFERENCE_SCHEMA_KEY])
    raise MetadataError(
        "Dataset at %r has parquet metadata but no unischema key; use make_batch_reader "
        "or regenerate metadata (petastorm-tpu-torch-generate-metadata)." % path
    )


def get_schema_from_dataset_url(dataset_url, storage_options=None, filesystem=None):
    """URL → stored Unischema."""
    fs, path = get_filesystem_and_path_or_paths(
        dataset_url, storage_options=storage_options, filesystem=filesystem
    )
    return get_schema(fs, path)


def infer_or_load_unischema(fs, path):
    """Stored Unischema if present, else infer a codec-less one from the Arrow schema."""
    try:
        return get_schema(fs, path)
    except MetadataError:
        import pyarrow.parquet as pq

        from petastorm_tpu_torch.unischema import Unischema

        files = _list_parquet_files(fs, path)
        if not files:
            raise MetadataError("No parquet files found under %r" % path)
        with fs.open_input_file(files[0]) as f:
            arrow_schema = pq.read_schema(f)
        return Unischema.from_arrow_schema(arrow_schema)


def load_row_groups(fs, path, validate=False):
    """Enumerate :class:`RowGroupPiece` work units for a dataset.

    Fast path: per-file row-group counts from KV metadata, the JSON key or the reference
    petastorm's pickled one (no footer scans; ``num_rows`` is then -1 and ``stats``
    None). Fallback, and always with ``validate=True``: read each footer through the
    process-wide footer cache (:mod:`~petastorm_tpu_torch.io.footercache`), which also
    gives each piece its row count and min/max/null-count statistics. Either way a piece
    under hive ``key=value`` directories carries its raw partition values."""
    from petastorm_tpu_torch.partitions import partition_values_for_path

    kv = _read_kv_metadata(fs, path)
    counts = None
    if kv is not None:
        if PTPU_ROW_GROUPS_KEY in kv:
            counts = json.loads(kv[PTPU_ROW_GROUPS_KEY].decode("utf-8"))
        elif REFERENCE_ROW_GROUPS_KEY in kv:
            from petastorm_tpu_torch.compat.reference import loads_reference_pickle

            counts = loads_reference_pickle(kv[REFERENCE_ROW_GROUPS_KEY])
    if counts is not None and not validate:
        pieces = []
        for fname in sorted(counts):
            full = fname if posixpath.isabs(fname) else posixpath.join(path, fname)
            pv = partition_values_for_path(full, path) or None
            for rg in range(int(counts[fname])):
                pieces.append(RowGroupPiece(full, rg, -1, pv))
        return pieces
    # the footer scan's parses land in the shared footer cache, so the statistics read
    # here and the workers' opens later share one footer read a file a process
    from petastorm_tpu_torch.io.footercache import shared_footer_cache

    footers = shared_footer_cache()
    pieces = []
    for full in _list_parquet_files(fs, path):
        md = footers.get(fs, full).metadata
        pv = partition_values_for_path(full, path) or None
        for rg in range(md.num_row_groups):
            rgmd = md.row_group(rg)
            pieces.append(RowGroupPiece(full, rg, rgmd.num_rows, pv,
                                        _rowgroup_stats(rgmd)))
    return pieces


def _rows_for_bytes(table, target_bytes):
    """Rows per row group so groups land near ``target_bytes`` (pre-compression estimate)."""
    if table.num_rows == 0:
        return 1
    per_row = max(1, table.nbytes // table.num_rows)
    return max(1, target_bytes // per_row)


def _rowgroup_stats(rgmd):
    """``{column: (min, max, null_count)}`` from a row group's parquet statistics, or
    None. ``null_count`` is None when the footer does not record it. Only simple
    (non-nested) columns with valid min/max are recorded; min/max exclude nulls (parquet
    semantics)."""
    stats = {}
    for ci in range(rgmd.num_columns):
        col = rgmd.column(ci)
        st = col.statistics
        if st is None or not st.has_min_max:
            continue
        name = col.path_in_schema
        if "." in name:  # nested columns: path is not a plain field name
            continue
        try:
            nulls = st.null_count if st.has_null_count else None
            stats[name] = (st.min, st.max, nulls)
        except Exception:  # noqa: BLE001 — exotic logical types: skip, stay safe
            continue
    return stats or None


def aggregate_column_stats(fs, pieces, columns):
    """Dataset-level ``{column: (min, max)}`` aggregated from parquet row-group
    statistics over ``pieces``: the resolution tier declarative pipelines try before any
    data pre-pass.

    Pieces that already carry ``stats`` (footer-scan planning) are consumed as they are;
    for the KV fast path's pieces each file's footer is read once (a metadata read, never
    a data read). A column is returned only when EVERY piece
    contributes valid min/max for it (a single silent gap would make the bound wrong);
    numeric coercion failures drop the column the same way. min/max exclude nulls
    (parquet semantics), the right bound for normalization."""
    import pyarrow.parquet as pq

    wanted = list(columns)
    if not wanted or not pieces:
        return {}
    footer_stats = {}  # path -> [per-row-group stats dict]

    def piece_stats(piece):
        if piece.stats is not None:
            return piece.stats
        per_group = footer_stats.get(piece.path)
        if per_group is None:
            with fs.open_input_file(piece.path) as f:
                md = pq.ParquetFile(f).metadata
            per_group = footer_stats[piece.path] = [
                _rowgroup_stats(md.row_group(rg)) or {}
                for rg in range(md.num_row_groups)
            ]
        if piece.row_group >= len(per_group):
            return {}
        return per_group[piece.row_group]

    out = {}
    for piece in pieces:
        try:
            stats = piece_stats(piece)
        except Exception:  # noqa: BLE001 — unreadable footer: no bounds at all
            return {}
        for name in list(wanted):
            entry = (stats or {}).get(name)
            if entry is None:
                wanted.remove(name)
                out.pop(name, None)
                continue
            try:
                mn, mx = float(entry[0]), float(entry[1])
            except (TypeError, ValueError):  # non-numeric stats (str/bytes)
                wanted.remove(name)
                out.pop(name, None)
                continue
            prev = out.get(name)
            if prev is None:
                out[name] = (mn, mx)
            else:
                out[name] = (min(prev[0], mn), max(prev[1], mx))
        if not wanted:
            break
    return out
