"""Regenerate a dataset's metadata: ``generate_metadata`` and the console script
``petastorm-tpu-torch-generate-metadata``.

Port of ``petastorm_tpu.tools.generate_metadata`` (reference
petastorm/etl/petastorm_generate_metadata.py ~L40). For a store written without
``RowWriter``/``materialize_dataset``, or by the reference petastorm (its pickled
unischema read through :mod:`petastorm_tpu_torch.compat.reference`), it rewrites
``_common_metadata`` with the JSON schema and row-group counts, so ``make_reader`` opens
the store.
"""
from __future__ import annotations

import argparse
import logging

logger = logging.getLogger(__name__)


def generate_metadata(dataset_url, use_summary_metadata=True, storage_options=None,
                      filesystem=None):
    """Infer-or-recover the schema and (re)write ``_common_metadata``."""
    from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths
    from petastorm_tpu_torch.metadata import (
        _count_row_groups_per_file,
        infer_or_load_unischema,
        write_petastorm_tpu_metadata,
    )

    fs, path = get_filesystem_and_path_or_paths(dataset_url, storage_options, filesystem)
    schema = infer_or_load_unischema(fs, path)
    row_groups = _count_row_groups_per_file(fs, path) if use_summary_metadata else {}
    write_petastorm_tpu_metadata(fs, path, schema, row_groups)
    logger.info("Wrote metadata for %s (%d files)", dataset_url, len(row_groups))
    return schema


# reference console-script name kept as an alias
generate_petastorm_metadata = generate_metadata


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("dataset_url")
    parser.add_argument("--no-summary-metadata", action="store_true",
                        help="skip row-group counting (footers read at open instead)")
    args = parser.parse_args(argv)
    generate_metadata(args.dataset_url,
                      use_summary_metadata=not args.no_summary_metadata)


if __name__ == "__main__":
    main()
