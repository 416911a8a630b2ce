"""Copy or subset a dataset and regenerate its metadata: ``copy_dataset`` and the console
script ``petastorm-tpu-torch-copy-dataset``.

Port of ``petastorm_tpu.tools.copy_dataset`` (reference petastorm/tools/copy_dataset.py
~L40). The reference runs a Spark job; this streams row groups with pyarrow (no
cluster). It projects columns (``field_regex``), drops rows with nulls in chosen fields
(``not_null_fields``) and sets the number of output files (``partitions_count``); the
copy's ``_common_metadata`` carries the schema (view) and the row-group counts in the
JSON keys, also when the source carried the reference's pickled ones.
"""
from __future__ import annotations

import argparse
import logging

logger = logging.getLogger(__name__)


def copy_dataset(source_url, target_url, field_regex=None, not_null_fields=None,
                 overwrite_output=False, partitions_count=None, row_group_size_mb=32,
                 storage_options=None, filesystem=None):
    """Copy ``source_url`` → ``target_url`` (optionally a subset of columns/rows).

    ``field_regex``: list of regex patterns selecting fields; ``not_null_fields``: rows with
    nulls in these fields are dropped; ``partitions_count``: number of output files.
    """
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths
    from petastorm_tpu_torch.metadata import (
        _count_row_groups_per_file,
        _list_parquet_files,
        infer_or_load_unischema,
        write_petastorm_tpu_metadata,
    )
    from petastorm_tpu_torch.unischema import match_unischema_fields

    src_fs, src_path = get_filesystem_and_path_or_paths(source_url, storage_options)
    dst_fs, dst_path = get_filesystem_and_path_or_paths(target_url, storage_options,
                                                        filesystem)
    schema = infer_or_load_unischema(src_fs, src_path)

    if field_regex:
        fields = match_unischema_fields(schema, field_regex)
        if not fields:
            raise ValueError("field_regex %r matched no fields" % (field_regex,))
        schema = schema.create_schema_view([f.name for f in fields])
    columns = list(schema.fields.keys())

    try:
        dst_fs.create_dir(dst_path, recursive=True)
    except Exception as e:  # noqa: BLE001 - exists
        logger.debug("create_dir(%s): %s (continuing — existing dir is fine)",
                     dst_path, e)
    existing = _list_parquet_files(dst_fs, dst_path)
    if existing and not overwrite_output:
        raise ValueError("Target %s is non-empty; pass overwrite_output=True" % target_url)
    for f in existing:
        dst_fs.delete_file(f)

    src_files = _list_parquet_files(src_fs, src_path)
    n_out = partitions_count or len(src_files)
    writers = {}
    total_rows = 0
    try:
        for i, src_file in enumerate(src_files):
            with src_fs.open_input_file(src_file) as f:
                pf = pq.ParquetFile(f)
                for rg in range(pf.num_row_groups):
                    table = pf.read_row_group(rg, columns=columns)
                    if not_null_fields:
                        import pyarrow.compute as pc

                        mask = None
                        for name in not_null_fields:
                            valid = pc.is_valid(table.column(name))
                            mask = valid if mask is None else pc.and_(mask, valid)
                        table = table.filter(mask)
                    if table.num_rows == 0:
                        continue
                    out_idx = i % n_out
                    w = writers.get(out_idx)
                    if w is None:
                        out = dst_fs.open_output_stream(
                            "%s/part-%05d.parquet" % (dst_path, out_idx))
                        w = writers[out_idx] = (pq.ParquetWriter(out, table.schema), out)
                    w[0].write_table(table, row_group_size=max(1, table.num_rows))
                    total_rows += table.num_rows
    finally:
        for w, out in writers.values():
            w.close()
            out.close()

    row_groups = _count_row_groups_per_file(dst_fs, dst_path)
    write_petastorm_tpu_metadata(dst_fs, dst_path, schema, row_groups)
    logger.info("Copied %d rows, %d output files", total_rows, len(writers))
    return total_rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("source_url")
    parser.add_argument("target_url")
    parser.add_argument("--field-regex", nargs="*", default=None)
    parser.add_argument("--not-null-fields", nargs="*", default=None)
    parser.add_argument("--overwrite-output", action="store_true")
    parser.add_argument("--partitions-count", type=int, default=None)
    args = parser.parse_args(argv)
    copy_dataset(args.source_url, args.target_url, field_regex=args.field_regex,
                 not_null_fields=args.not_null_fields,
                 overwrite_output=args.overwrite_output,
                 partitions_count=args.partitions_count)


if __name__ == "__main__":
    main()
