"""Spark RDD helper: ``dataset_as_rdd`` (port of ``petastorm_tpu.spark_utils``;
reference petastorm/spark_utils.py ~L30).

Reads a dataset back into a Spark RDD of namedtuple rows. The per-piece decode is the
reader's own picklable :class:`~petastorm_tpu_torch.reader.PyDictWorker` (the property
the process pool relies on), so executors run the same column-pruned read and codec
decode as ``make_reader``. Takes any session object with ``sparkContext.parallelize``
(pyspark, or a duck-typed session)."""
from __future__ import annotations


def dataset_as_rdd(dataset_url, spark_session, schema_fields=None,
                   storage_options=None, filesystem=None):
    """Return an RDD of decoded namedtuple rows for the dataset at ``dataset_url``."""
    from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths
    from petastorm_tpu_torch.metadata import get_schema, load_row_groups
    from petastorm_tpu_torch.reader import PyDictWorker

    fs, path = get_filesystem_and_path_or_paths(dataset_url, storage_options, filesystem)
    stored_schema = get_schema(fs, path)
    read_schema = (
        stored_schema.create_schema_view(schema_fields) if schema_fields else stored_schema
    )
    pieces = load_row_groups(fs, path)
    worker = PyDictWorker(fs, read_schema, stored_schema)
    row_type = read_schema.make_namedtuple_type()
    field_names = list(read_schema.fields.keys())

    def piece_to_rows(piece):
        rows = worker((piece, 0))
        return [row_type(**{name: r.get(name) for name in field_names}) for r in rows]

    rdd = spark_session.sparkContext.parallelize(pieces, max(1, len(pieces)))
    return rdd.flatMap(piece_to_rows)
