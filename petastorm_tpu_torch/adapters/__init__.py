"""Framework adapters (port of ``petastorm_tpu.adapters``): the PyTorch loaders of
:mod:`petastorm_tpu_torch.adapters.pytorch` and the TensorFlow dataset bridges of
:mod:`petastorm_tpu_torch.adapters.tf`, imported lazily (tensorflow is optional)."""


def __getattr__(name):
    if name in ("DataLoader", "BatchedDataLoader", "InMemBatchedDataLoader",
                "decimal_friendly_collate"):
        from petastorm_tpu_torch.adapters import pytorch

        return getattr(pytorch, name)
    if name in ("make_petastorm_dataset", "tf_tensors"):
        from petastorm_tpu_torch.adapters import tf

        return getattr(tf, name)
    raise AttributeError("module 'petastorm_tpu_torch.adapters' has no attribute %r" % name)
