"""hello_world, petastorm-format dataset (reference examples/hello_world/petastorm_dataset):
write a tensor-columned dataset with the port's writer (no Spark needed), read it with
make_reader. The counterpart of ``examples/hello_world/petastorm_dataset.py``."""
import argparse
import tempfile

import numpy as np

from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.metadata import write_dataset
from petastorm_tpu_torch.types import IntegerType
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

HelloWorldSchema = Unischema("HelloWorldSchema", [
    UnischemaField("id", np.int32, (), ScalarCodec(IntegerType()), False),
    UnischemaField("image1", np.uint8, (128, 256, 3), CompressedImageCodec("png"), False),
    UnischemaField("array_4d", np.uint8, (None, 128, 30, None), NdarrayCodec(), False),
])


def row_generator(x):
    return {
        "id": x,
        "image1": np.random.randint(0, 255, (128, 256, 3), dtype=np.uint8),
        "array_4d": np.random.randint(0, 255, (4, 128, 30, 3), dtype=np.uint8),
    }


def generate_dataset(url, rows=10):
    write_dataset(url, HelloWorldSchema, (row_generator(i) for i in range(rows)),
                  row_group_size_mb=8)


def main(argv=None):
    """Write and read the dataset; returns the ids read, in order."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--url", default=None)
    args = parser.parse_args(argv)
    url = args.url or "file://" + tempfile.mkdtemp(prefix="hello_world_ds")
    generate_dataset(url)
    ids = []
    with make_reader(url) as reader:
        for row in reader:
            print(row.id, row.image1.shape, row.array_4d.shape)
            ids.append(int(row.id))
    return ids


if __name__ == "__main__":
    main()
