"""hello_world, hive-partitioned Parquet store (the most common vanilla-Parquet layout;
reference: ``pq.ParquetDataset`` partition handling): partition-directory columns
materialize as row values, and ``filters=`` prunes whole directories before any file is
opened. The counterpart of ``examples/hello_world/hive_partitioned.py``."""
import argparse
import os
import tempfile

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch import make_batch_reader
from petastorm_tpu_torch.loader import DataLoader


def generate_dataset(path, rows_per_part=40):
    rng = np.random.RandomState(0)
    rid = 0
    for date in ("2024-06-01", "2024-06-02", "2024-06-03"):
        for region in ("us", "eu"):
            d = os.path.join(path, "date=%s" % date, "region=%s" % region)
            os.makedirs(d, exist_ok=True)
            table = pa.table({
                "id": np.arange(rid, rid + rows_per_part, dtype=np.int64),
                "value": rng.standard_normal(rows_per_part),
            })
            pq.write_table(table, os.path.join(d, "part-0.parquet"),
                           row_group_size=10)
            rid += rows_per_part


def main(argv=None):
    """Returns ``{"columns", "first_rows", "day_rows", "eu_positive_rows"}``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", default=None)
    parser.add_argument("--device", default="cuda",
                        help="where the loader's batches land (cuda, or cpu)")
    args = parser.parse_args(argv)
    path = args.path or tempfile.mkdtemp(prefix="hive_ds")
    generate_dataset(path)
    url = "file://" + path

    # partition columns (date: string, region: string) arrive as ordinary columns
    with make_batch_reader(url, shuffle_row_groups=False) as reader:
        batch = next(iter(reader))
        columns = list(batch._fields)
        first = list(zip(batch.id[:3].tolist(), list(batch.date[:3]),
                         list(batch.region[:3])))
        print("columns:", columns)
        print("first rows:", first)

    # directory pruning: only date=2024-06-02 files are ever opened
    with make_batch_reader(url, filters=[("date", "=", "2024-06-02")]) as reader:
        total = sum(len(b.id) for b in reader)
        print("rows for 2024-06-02:", total)  # 80 of 240

    # mixed DNF: directory pruning + row-level mask, straight into the loader
    reader = make_batch_reader(
        url, filters=[("region", "=", "eu"), ("value", ">", 0.0)],
        shuffle_row_groups=False)
    with DataLoader(reader, batch_size=16, last_batch="partial",
                    device=args.device) as loader:
        n = sum(len(b["id"]) for b in loader)
        print("eu rows with positive value:", n)
    return {"columns": columns, "first_rows": first, "day_rows": total,
            "eu_positive_rows": n}


if __name__ == "__main__":
    main()
