"""hello_world, vanilla-Parquet dataset (reference examples/hello_world/external_dataset):
any Parquet store read with make_batch_reader and the port's DataLoader. The
counterpart of ``examples/hello_world/external_dataset.py``."""
import argparse
import tempfile

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch import make_batch_reader
from petastorm_tpu_torch.loader import DataLoader


def generate_dataset(path, rows=100):
    rng = np.random.RandomState(0)
    table = pa.table({
        "id": np.arange(rows, dtype=np.int64),
        "value1": rng.standard_normal(rows),
        "value2": rng.randint(0, 10, rows).astype(np.int32),
    })
    pq.write_table(table, path + "/data.parquet", row_group_size=20)


def main(argv=None):
    """Returns ``{"rows": n, "batch": {field: (shape, dtype)}}`` of the first batch."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", default=None)
    parser.add_argument("--device", default="cuda",
                        help="where the loader's batches land (cuda, or cpu)")
    args = parser.parse_args(argv)
    path = args.path or tempfile.mkdtemp(prefix="external_ds")
    generate_dataset(path)
    url = "file://" + path

    # plain iteration
    with make_batch_reader(url) as reader:
        total = sum(len(b.id) for b in reader)
        print("rows:", total)

    # the loader: batches as tensors on the device
    first = None
    reader = make_batch_reader(url, shuffle_row_groups=False)
    with DataLoader(reader, batch_size=16, device=args.device) as loader:
        for batch in loader:
            first = {k: (tuple(v.shape), str(v.dtype)) for k, v in batch.items()}
            print("batch:", first)
            break
    return {"rows": total, "batch": first}


if __name__ == "__main__":
    main()
