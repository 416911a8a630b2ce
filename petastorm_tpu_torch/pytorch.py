"""Migration alias: the reference exposes its torch adapters as ``petastorm.pytorch``;
users keep their import path with ``from petastorm_tpu_torch.pytorch import DataLoader,
BatchedDataLoader``.

Canonical home: :mod:`petastorm_tpu_torch.adapters.pytorch`.
"""
from petastorm_tpu_torch.adapters.pytorch import (  # noqa: F401
    BatchedDataLoader,
    DataLoader,
    InMemBatchedDataLoader,
    decimal_friendly_collate,
)
