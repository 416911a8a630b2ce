"""MNIST with the TensorFlow adapter (reference examples/mnist/tf_example.py):
Parquet → make_batch_reader → petastorm_tpu_torch.adapters.tf.make_petastorm_dataset →
a tf.data pipeline → a small Keras CNN. Needs tensorflow.

The counterpart of ``examples/mnist/tf_example.py``.

Run: python examples/torch/mnist/tf_example.py [--epochs 1]
"""
import argparse
import tempfile

from train_mnist_torch import generate_mnist_parquet


def main(argv=None):
    """Train; returns the Keras ``History`` of each epoch."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", default=None)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=128)
    args = parser.parse_args(argv)

    import tensorflow as tf

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.adapters.tf import make_petastorm_dataset

    path = args.path or tempfile.mkdtemp(prefix="mnist_pq")
    generate_mnist_parquet(path)
    url = "file://" + path

    model = tf.keras.Sequential([
        tf.keras.layers.Input((28, 28, 1)),
        tf.keras.layers.Conv2D(16, 3, activation="relu", padding="same"),
        tf.keras.layers.MaxPool2D(),
        tf.keras.layers.Conv2D(32, 3, activation="relu", padding="same"),
        tf.keras.layers.MaxPool2D(),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(10),
    ])
    model.compile(
        optimizer="adam",
        loss=tf.keras.losses.SparseCategoricalCrossentropy(from_logits=True),
        metrics=["accuracy"],
    )

    def prep(batch):
        image = tf.cast(tf.reshape(batch["image"], (-1, 28, 28, 1)), tf.float32) / 255.0
        return image, batch["digit"]

    histories = []
    for epoch in range(args.epochs):
        with make_batch_reader(url, num_epochs=1, shuffle_row_groups=True,
                               seed=epoch) as reader:
            ds = make_petastorm_dataset(reader).map(prep)
            histories.append(model.fit(ds, epochs=1, verbose=2))
    return histories


if __name__ == "__main__":
    main()
