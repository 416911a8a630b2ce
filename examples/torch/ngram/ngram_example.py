"""NGram windowed reading (reference NGram usage): consecutive timestamped rows assembled
into {offset: row} windows for sequence models. The counterpart of
``examples/ngram/ngram_example.py``."""
import argparse
import tempfile

import numpy as np

from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.metadata import write_dataset
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.types import LongType
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

SeqSchema = Unischema("SeqSchema", [
    UnischemaField("timestamp", np.int64, (), ScalarCodec(LongType()), False),
    UnischemaField("sensor", np.float32, (8,), NdarrayCodec(), False),
])


def main(argv=None):
    """Returns ``{"rows": [window timestamps...], "columnar": windows}``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--url", default=None)
    args = parser.parse_args(argv)
    url = args.url or "file://" + tempfile.mkdtemp(prefix="ngram_ds")

    rng = np.random.RandomState(0)
    write_dataset(url, SeqSchema, (
        {"timestamp": t, "sensor": rng.standard_normal(8).astype(np.float32)}
        for t in range(100)
    ))

    def mk():
        return NGram(fields={-1: ["timestamp", "sensor"],
                             0: ["timestamp", "sensor"],
                             1: ["timestamp"]},
                     delta_threshold=2, timestamp_field="timestamp")

    # reference-style per-row windows: {offset: row namedtuple} dicts
    stamps = []
    with make_reader(url, schema_fields=mk(), shuffle_row_groups=False) as reader:
        for i, window in enumerate(reader):
            if i < 3:
                print({k: (v.timestamp, getattr(v, "sensor", None) is not None)
                       for k, v in window.items()})
            stamps.append([int(window[k].timestamp) for k in sorted(window)])
        print("per-row windows:", i + 1)

    # columnar windows: whole row groups windowed in the worker, delivered as flat
    # 'offset/field' columns; feed these straight to the DataLoader for device batches
    from petastorm_tpu_torch.reader import make_batch_reader

    total = 0
    with make_batch_reader(url, schema_fields=mk(),
                           shuffle_row_groups=False) as reader:
        for batch in reader:
            if not total:
                print("columnar batch columns:", sorted(batch))
            total += len(batch["0/timestamp"])
    print("columnar windows:", total)
    return {"rows": stamps, "columnar": total}


if __name__ == "__main__":
    main()
