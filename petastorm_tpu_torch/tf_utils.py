"""The reference's import path of the TF adapters (``petastorm.tf_utils``): users
switching frameworks keep it, ``from petastorm_tpu_torch.tf_utils import
make_petastorm_dataset, tf_tensors``. Port of ``petastorm_tpu.tf_utils``; the canonical
home is :mod:`petastorm_tpu_torch.adapters.tf`.
"""
from petastorm_tpu_torch.adapters.tf import (  # noqa: F401
    make_petastorm_dataset,
    tf_tensors,
)
