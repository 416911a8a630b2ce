"""ResNet family (v1.5 bottleneck) as torch modules: the port's flagship image model.

Port of ``petastorm_tpu.models.resnet``. The main path's account is ResNet-50 training
on ImageNet-Parquet (BASELINE.json's north star), so this is the consumer the port's
loader is measured against. The modules take the loader's NHWC ``(n, h, w, 3)`` batch,
compute in ``channels_last`` NCHW, in bfloat16 with float32 parameters and batch-norm
statistics by default (the JAX model's ``dtype=jnp.bfloat16``), and follow flax's
numerics (:mod:`petastorm_tpu_torch.models.layers`): ``"SAME"`` padding with the odd
pixel after, flax's running variance, zero-initialised scale on each block's last norm,
``lecun_normal`` kernels. :func:`petastorm_tpu_torch.models.weights.load_flax_variables`
carries a flax ``variables`` tree across.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.models.layers import (BatchNorm, Conv, Dense, max_pool_same,
                                               nhwc_to_nchw)


class _Block(nn.Module):
    """A residual block: ``convs`` (kernel, stride, out channels) each followed by a
    norm (the last one's scale zero-initialised) and ReLU (the last one after the sum),
    with the projection flax adds when the residual's shape changes."""

    def __init__(self, in_channels, convs, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        c = in_channels
        for i, (k, s, out) in enumerate(convs):
            setattr(self, "conv%d" % i, Conv(c, out, k, s, bias=False, **kw))
            setattr(self, "norm%d" % i, BatchNorm(out, zero_scale=i == len(convs) - 1,
                                                  **kw))
            c = out
        self.depth = len(convs)
        stride = max(s for _k, s, _o in convs)
        if stride != 1 or in_channels != c:
            self.conv_proj = Conv(in_channels, c, 1, stride, bias=False, **kw)
            self.norm_proj = BatchNorm(c, **kw)
        else:
            self.conv_proj = self.norm_proj = None

    def forward(self, x):
        y = x
        for i in range(self.depth):
            y = getattr(self, "norm%d" % i)(getattr(self, "conv%d" % i)(y))
            if i < self.depth - 1:
                y = F.relu(y)
        residual = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class BasicBlock(_Block):
    """Two 3x3 convs: the ResNet-18/34 block (He et al. 2015, table 1)."""

    expansion = 1

    def __init__(self, in_channels, filters, strides, dtype=torch.bfloat16, device="cuda"):
        super().__init__(in_channels, [(3, strides, filters), (3, 1, filters)], dtype,
                         device)


class BottleneckBlock(_Block):
    """1x1, 3x3 (strided: v1.5), 1x1 x4."""

    expansion = 4

    def __init__(self, in_channels, filters, strides, dtype=torch.bfloat16, device="cuda"):
        super().__init__(in_channels, [(1, 1, filters), (3, strides, filters),
                                       (1, 1, filters * 4)], dtype, device)


class ResNet(nn.Module):
    """``forward(x)``: an NHWC image batch (any dtype) to float32 logits. ``train()``
    mode normalises with batch statistics and updates the running ones, ``eval()``
    uses the running ones (flax's ``train=`` argument)."""

    def __init__(self, stage_sizes, num_classes=1000, num_filters=64,
                 dtype=torch.bfloat16, block_cls=BottleneckBlock, device="cuda"):
        super().__init__()
        self.block_cls = block_cls
        self.compute_dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.conv_init = Conv(3, num_filters, 7, 2, padding=((3, 3), (3, 3)), bias=False,
                              **kw)
        self.bn_init = BatchNorm(num_filters, **kw)
        blocks = []
        c = num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                strides = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(c, num_filters * 2 ** i, strides, **kw))
                c = num_filters * 2 ** i * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(c, num_classes, dtype=torch.float32, device=device)

    def forward(self, x):
        x = nhwc_to_nchw(x, self.compute_dtype)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = max_pool_same(x, 3, 2)
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean(dim=(2, 3))).float()


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3])
