"""Tiny MNIST convnet: the hello_world model (port of ``petastorm_tpu.models.mnist``).

Its 3x3 convs are stride 1, so flax's ``"SAME"`` is (1, 1) here, and its ``avg_pool``
is ``"VALID"``. The features flatten in NHWC order, as the flax model reshapes them, so
the first dense layer's kernel carries across unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.models.layers import Conv, Dense, nhwc_to_nchw


class MnistCNN(nn.Module):
    """``forward(x)``: a (b, 28, 28) or (b, 28, 28, 1) batch to float32 logits."""

    def __init__(self, num_classes=10, dtype=torch.float32, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.compute_dtype = dtype
        self.conv0 = Conv(1, 32, 3, **kw)
        self.conv1 = Conv(32, 64, 3, **kw)
        self.dense0 = Dense(7 * 7 * 64, 128, **kw)
        self.dense1 = Dense(128, num_classes, dtype=torch.float32, device=device)

    def forward(self, x):
        if x.ndim == 3:
            x = x[..., None]  # (b, 28, 28) -> NHWC
        x = nhwc_to_nchw(x, self.compute_dtype)
        x = F.avg_pool2d(F.relu(self.conv0(x)), 2, 2)
        x = F.avg_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.dense1(F.relu(self.dense0(x)))
