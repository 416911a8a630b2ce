"""Exact mid-epoch resume after preemption, a capability the reference lacks.

Simulates a preempted training job: read part of an epoch, checkpoint the reader
cursor (beside model state), "crash", rebuild the reader from the checkpoint, and
finish. The union of rows seen before and after the preemption covers the epoch
exactly, with duplicates only at row-group granularity (the at-least-once contract for
in-flight work). The counterpart of ``examples/checkpoint_resume/resume_example.py``,
with ``torch.distributed.checkpoint`` in place of orbax.

Run: ``python resume_example.py`` (the CPU is fine).
"""
import json
import os
import tempfile

import numpy as np

from petastorm_tpu_torch import types as ptypes
from petastorm_tpu_torch.codecs import ScalarCodec
from petastorm_tpu_torch.metadata import write_dataset
from petastorm_tpu_torch.reader import make_batch_reader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

ROWS = 96


def build_dataset():
    schema = Unischema("S", [
        UnischemaField("id", np.int64, (), ScalarCodec(ptypes.LongType()), False),
        UnischemaField("x", np.float32, (4,), None, False),
    ])
    root = tempfile.mkdtemp(prefix="resume_ds")
    rng = np.random.RandomState(0)
    write_dataset("file://" + root, schema,
                  ({"id": i, "x": rng.standard_normal(4).astype(np.float32)}
                   for i in range(ROWS)),
                  rows_per_file=48, row_group_size_mb=1)
    return "file://" + root


def main(argv=None):
    """Run the three resumes; returns ``{"before", "after", "dcp", "loader"}``: the ids
    of the first resume's two phases and the row counts of the other two."""
    url = build_dataset()
    kwargs = dict(shuffle_row_groups=True, seed=7, num_epochs=1, workers_count=2)

    # ---- phase 1: consume part of the epoch, checkpoint, "crash" ----
    seen_before = []
    with make_batch_reader(url, **kwargs) as reader:
        for batch in reader:
            seen_before.extend(np.asarray(batch.id).tolist())
            if len(seen_before) >= ROWS // 3:
                break
        ckpt = reader.state_dict()      # goes into the same checkpoint as the model
    blob = json.dumps(ckpt)             # plain data: JSON, torch.save or DCP
    print("preempted after %d rows; checkpoint: %s..." % (len(seen_before), blob[:70]))

    # ---- phase 2: new process, restore, finish the epoch ----
    seen_after = []
    with make_batch_reader(url, **kwargs) as reader:
        reader.load_state_dict(json.loads(blob))
        for batch in reader:
            seen_after.extend(np.asarray(batch.id).tolist())

    union = set(seen_before) | set(seen_after)
    assert union == set(range(ROWS)), "resume missed rows!"
    overlap = set(seen_before) & set(seen_after)
    print("resumed: %d rows after restore; %d replayed (at-least-once, row-group "
          "granularity); epoch coverage exact." % (len(seen_after), len(overlap)))

    # ---- the production shape: one checkpoint holds the model AND the data cursor ----
    dcp_rows = dcp_roundtrip(url, kwargs)

    # ---- training through a DataLoader? checkpoint the LOADER (consumer
    # watermark): rows prefetched into its buffers replay instead of vanishing ----
    loader_rows = loader_watermark(url, kwargs)
    return {"before": seen_before, "after": seen_after, "dcp": dcp_rows,
            "loader": loader_rows}


def loader_watermark(url, kwargs):
    from petastorm_tpu_torch import checkpoint as ptck
    from petastorm_tpu_torch.loader import DataLoader

    ckpt = os.path.join(tempfile.mkdtemp(prefix="loader_ckpt"), "step0.pt")
    loader = DataLoader(make_batch_reader(url, **kwargs), batch_size=8,
                        prefetch=3, to_device=False, device="cpu")
    pre = []
    with loader:
        it = iter(loader)
        for _ in range(4):
            pre.extend(int(x) for x in next(it)["id"])
        # the producer thread has read AHEAD of these 4 batches; saving the
        # READER here would skip the buffered rows: the loader's state saves at
        # what the training loop actually received
        ptck.save(ckpt, loader)

    resumed = DataLoader(make_batch_reader(url, **kwargs), batch_size=8,
                         to_device=False, device="cpu")
    ptck.restore(ckpt, resumed)
    post = []
    with resumed:
        for b in resumed:
            post.extend(int(x) for x in b["id"])
    assert set(pre) | set(post) == set(range(ROWS))
    print("loader watermark: %d rows pre-save + %d post-restore; prefetched rows "
          "replayed, none lost." % (len(pre), len(post)))
    return len(pre) + len(post)


def dcp_roundtrip(url, kwargs):
    import torch
    import torch.distributed.checkpoint as dcp

    from petastorm_tpu_torch import checkpoint as ptck

    ckpt_dir = tempfile.mkdtemp(prefix="dcp_ckpt")
    params = {"w": torch.ones((4, 2))}
    reader = make_batch_reader(url, **kwargs)
    first = np.asarray(next(iter(reader)).id).tolist()
    dcp.save({"params": params, "reader": ptck.state_item(reader)},
             checkpoint_id=ckpt_dir)
    reader.stop()
    reader.join()

    resumed = make_batch_reader(url, **kwargs)
    restored = {"params": {"w": torch.zeros((4, 2))}, "reader": ptck.state_item(resumed)}
    dcp.load(restored, checkpoint_id=ckpt_dir)
    assert torch.equal(restored["params"]["w"], params["w"])
    rest = [int(x) for b in resumed for x in np.asarray(b.id)]
    resumed.stop()
    resumed.join()
    assert set(first) | set(rest) == set(range(ROWS))
    print("torch.distributed.checkpoint: params + data cursor saved/restored together; "
          "epoch coverage exact after restore.")
    return len(first) + len(rest)


if __name__ == "__main__":
    main()
