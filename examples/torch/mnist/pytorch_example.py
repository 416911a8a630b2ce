"""MNIST with the PyTorch adapter (reference examples/mnist/pytorch_example.py):
Parquet → make_batch_reader → petastorm_tpu_torch.adapters.pytorch.BatchedDataLoader →
a small torch CNN train loop on the host (the adapter yields CPU tensors).

The counterpart of ``examples/mnist/pytorch_example.py``.

Run: python examples/torch/mnist/pytorch_example.py [--epochs 1]
"""
import argparse
import tempfile

from train_mnist_torch import generate_mnist_parquet


def main(argv=None):
    """Train; returns ``{"steps": [...], "accuracy": [...]}``, one entry an epoch."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", default=None)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=128)
    args = parser.parse_args(argv)

    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.adapters.pytorch import BatchedDataLoader

    path = args.path or tempfile.mkdtemp(prefix="mnist_pq")
    generate_mnist_parquet(path)
    url = "file://" + path

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(1, 16, 3, padding=1)
            self.conv2 = nn.Conv2d(16, 32, 3, padding=1)
            self.fc = nn.Linear(32 * 7 * 7, 10)

        def forward(self, x):
            x = F.max_pool2d(F.relu(self.conv1(x)), 2)
            x = F.max_pool2d(F.relu(self.conv2(x)), 2)
            return self.fc(x.flatten(1))

    torch.manual_seed(0)
    model = Net()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    out = {"steps": [], "accuracy": []}
    for epoch in range(args.epochs):
        reader = make_batch_reader(url, num_epochs=1, shuffle_row_groups=True, seed=epoch)
        loader = BatchedDataLoader(reader, batch_size=args.batch_size,
                                   shuffling_queue_capacity=4096)
        total, correct, steps = 0, 0, 0
        with loader:
            for batch in loader:
                images = batch["image"].float().reshape(-1, 1, 28, 28) / 255.0
                labels = batch["digit"].long()
                opt.zero_grad()
                logits = model(images)
                loss = F.cross_entropy(logits, labels)
                loss.backward()
                opt.step()
                correct += (logits.argmax(1) == labels).sum().item()
                total += len(labels)
                steps += 1
        print("epoch %d: %d steps, train acc %.3f" % (epoch, steps, correct / max(1, total)))
        out["steps"].append(steps)
        out["accuracy"].append(correct / max(1, total))
    return out


if __name__ == "__main__":
    main()
