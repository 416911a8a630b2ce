"""MNIST end to end on a CUDA card: synthetic-or-real MNIST → Parquet →
make_batch_reader → the port's DataLoader → an Adam train step on MnistCNN.

The counterpart of ``examples/mnist/train_mnist_jax.py``: schema inference, row-group
planning, the async transfer thread, tensors on the card, epoch semantics. The prep (a
``TransformSpec(device=True)``) reshapes the flat pixels and scales them on the card.
``--in-memory`` reads the store once into device memory and serves each epoch as
permutation gathers (``InMemDataLoader``): no host work a step.

Run: python examples/torch/mnist/train_mnist_torch.py [--epochs 2] [--in-memory]
"""
import argparse
import tempfile
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq


def generate_mnist_parquet(path, rows=2048):
    """Writes an MNIST-shaped Parquet dataset (random pixels unless real data is at hand)."""
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (rows, 28 * 28), dtype=np.uint8)
    labels = rng.randint(0, 10, rows).astype(np.int32)
    table = pa.table({
        "image": pa.FixedSizeListArray.from_arrays(pa.array(images.reshape(-1)), 28 * 28),
        "digit": labels,
    })
    pq.write_table(table, path + "/mnist.parquet", row_group_size=256)


def _prep(batch):
    return {"image": batch["image"].reshape(-1, 28, 28, 1).float() / 255.0,
            "digit": batch["digit"]}


def main(argv=None):
    """Train; returns ``{"steps", "losses", "seconds"}``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", default=None)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--in-memory", action="store_true",
                        help="load the dataset to device memory once and serve epochs "
                             "as on-device permutation gathers (InMemDataLoader): no "
                             "host work a step, ideal at MNIST scale")
    parser.add_argument("--device", default="cuda",
                        help="where batches land and the model trains (cuda, or cpu)")
    args = parser.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader, InMemDataLoader
    from petastorm_tpu_torch.models.mnist import MnistCNN
    from petastorm_tpu_torch.transform import TransformSpec

    path = args.path or tempfile.mkdtemp(prefix="mnist_pq")
    generate_mnist_parquet(path)
    url = "file://" + path

    torch.manual_seed(0)
    model = MnistCNN(device=args.device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    prep = TransformSpec(func=_prep, device=True)

    def train_step(batch):
        logits = model(batch["image"])
        loss = F.cross_entropy(logits, batch["digit"].long())
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    t0 = time.perf_counter()
    losses = []
    if args.in_memory:
        reader = make_batch_reader(url, num_epochs=1, transform_spec=prep,
                                   shuffle_row_groups=False)
        loader_cm = InMemDataLoader(reader, args.batch_size, num_epochs=args.epochs,
                                    seed=0, device=args.device)
    else:
        reader = make_batch_reader(url, num_epochs=args.epochs, transform_spec=prep,
                                   shuffle_row_groups=True, seed=0)
        loader_cm = DataLoader(reader, args.batch_size, shuffling_queue_capacity=1024,
                               device=args.device)
    with loader_cm as loader:
        for batch in loader:
            losses.append(train_step(batch))
    values = [float(v) for v in losses]
    seconds = time.perf_counter() - t0
    print("trained %d steps in %.1fs, final loss %.4f" % (len(values), seconds, values[-1]))
    return {"steps": len(values), "losses": values, "seconds": seconds}


if __name__ == "__main__":
    main()
