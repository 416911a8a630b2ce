"""Framework adapters (port of ``petastorm_tpu.adapters``): the PyTorch loaders of
:mod:`petastorm_tpu_torch.adapters.pytorch`, imported lazily. The TensorFlow bridges
(``make_petastorm_dataset``, ``tf_tensors``) are not ported and raise naming their
ROADMAP.md item."""


def __getattr__(name):
    if name in ("DataLoader", "BatchedDataLoader", "InMemBatchedDataLoader",
                "decimal_friendly_collate"):
        from petastorm_tpu_torch.adapters import pytorch

        return getattr(pytorch, name)
    if name in ("make_petastorm_dataset", "tf_tensors"):
        from petastorm_tpu_torch._unported import not_ported

        def unported(*args, **kwargs):
            raise not_ported("petastorm_tpu_torch.adapters.%s" % name, "tf")

        unported.__name__ = name
        return unported
    raise AttributeError("module 'petastorm_tpu_torch.adapters' has no attribute %r" % name)
