"""petastorm_tpu_torch: the PyTorch + CUDA port of petastorm_tpu.

Same module paths and public names as the JAX package: ``make_reader`` /
``make_batch_reader`` open a Parquet store, and
:class:`petastorm_tpu_torch.loader.DataLoader` turns its batches into torch tensors on a
CUDA device, finishing JPEG decode on the device with hand-written CUDA kernels
(``csrc/``); :class:`~petastorm_tpu_torch.loader.InMemDataLoader` serves epochs from
device memory, ``make_dataloader`` is the one-call form, ``schema_fields=NGram(...)``
windows rows, and :class:`WeightedSamplingReader` mixes readers. ``transform_spec`` takes a :class:`TransformSpec` or a declarative
:class:`~petastorm_tpu_torch.ops.tabular.FeaturePipeline`. The port imports nothing of
``petastorm_tpu`` and no ``jax``. Kernels and the host JPEG decoder build at first use,
never at import.
"""
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.transform import TransformSpec, transform_schema

__all__ = ["make_reader", "make_batch_reader", "TransformSpec", "transform_schema"]


def __getattr__(name):
    # the heavier entry points and the feature pipeline's names load lazily, as in the
    # JAX package
    if name in ("DataLoader", "InMemDataLoader", "make_dataloader"):
        from petastorm_tpu_torch import loader

        return getattr(loader, name)
    if name in ("WatchOptions", "DatasetWatcher"):
        from petastorm_tpu_torch.dataset import watch

        return getattr(watch, name)
    if name == "WeightedSamplingReader":
        from petastorm_tpu_torch.weighted_sampling import WeightedSamplingReader

        return WeightedSamplingReader
    if name in ("FeaturePipeline", "Normalize", "Standardize", "Clip", "Cast", "FillNull",
                "Bucketize", "HashField", "VocabLookup", "FeatureCross"):
        from petastorm_tpu_torch.ops import tabular

        return getattr(tabular, name)
    raise AttributeError("module 'petastorm_tpu_torch' has no attribute %r" % name)
