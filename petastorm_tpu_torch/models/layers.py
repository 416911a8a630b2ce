"""flax.linen's layers as torch modules, numerics and all: the building blocks of the
port's model zoo.

Each keeps the flax layer's parameters in float32 and computes in its ``dtype`` (the
JAX models' ``dtype=jnp.bfloat16``: inputs and weights cast, products in that type),
and follows flax where torch's layer of the same name differs:

- :class:`Conv` pads ``"SAME"`` as XLA does, the odd pixel after (a 3x3 stride-2 conv on
  an even input pads (0, 1), where ``Conv2d(padding=1)`` pads (1, 1));
- :class:`BatchNorm` keeps flax's running averages: momentum 0.9 on the old value and
  the *biased* batch variance (torch's ``BatchNorm2d`` takes the unbiased one); under
  data parallelism (:func:`sync_batch_norm`) its statistics are those of the global
  batch, as a jitted flax step over a sharded batch computes them;
- :class:`LayerNorm` defaults to ``epsilon=1e-6`` (torch: 1e-5) and computes in float32;
- kernels start from flax's ``lecun_normal`` (a normal truncated at two standard
  deviations, variance 1/fan_in), biases from zeros.

Images are NHWC at the model's edge, as the loader delivers them; inside, tensors are
NCHW in ``channels_last`` memory, which is the same bytes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

#: flax's truncated-normal correction: the standard deviation of a unit normal
#: truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight, fan_in):
    """flax ``lecun_normal``: truncated normal of variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


def same_pads(size, kernel, stride):
    """``(before, after)`` that XLA's ``"SAME"`` pads a dimension of ``size`` by."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x, kernel, stride, value=0.0):
    """``x`` (N, C, H, W) padded as ``"SAME"`` pads it for a ``kernel`` x ``kernel``
    window at ``stride``."""
    (t, b), (l, r) = (same_pads(x.shape[d], kernel, stride) for d in (2, 3))
    if t == b == l == r == 0:
        return x
    return F.pad(x, (l, r, t, b), value=value)


def nhwc_to_nchw(x, dtype):
    """The loader's (n, h, w, c) batch as an NCHW view in ``channels_last`` memory, cast
    to ``dtype``."""
    return x.permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=torch.channels_last)


def max_pool_same(x, window, stride):
    """flax ``nn.max_pool(..., padding="SAME")``: the pad is ``-inf``."""
    return F.max_pool2d(pad_same(x, window, stride, float("-inf")), window, stride)


class Conv(nn.Conv2d):
    """flax ``nn.Conv``: an OIHW kernel (flax's HWIO, transposed), ``"SAME"`` padding
    (or explicit ``((top, bottom), (left, right))``, or ``"VALID"``), computed in
    ``dtype``."""

    def __init__(self, in_channels, out_channels, kernel, stride=1, padding="SAME",
                 bias=True, dtype=torch.float32, device="cuda"):
        super().__init__(in_channels, out_channels, kernel, stride, padding=0, bias=bias,
                         device=device)
        self.same = padding == "SAME"
        if padding in ("SAME", "VALID"):
            self.pads = (0, 0, 0, 0)
        else:
            (t, b), (l, r) = padding
            self.pads = (l, r, t, b)
        self.compute_dtype = dtype
        lecun_normal_(self.weight, in_channels * kernel * kernel)
        if bias:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        x = x.to(self.compute_dtype)
        if self.same:
            x = pad_same(x, k, s)
        elif any(self.pads):
            x = F.pad(x, self.pads)
        bias = None if self.bias is None else self.bias.to(self.compute_dtype)
        return F.conv2d(x, self.weight.to(self.compute_dtype), bias, s)


class Dense(nn.Linear):
    """flax ``nn.Dense``: ``x @ kernel + bias`` computed in ``dtype`` (the weight is
    flax's ``(in, out)`` kernel, transposed)."""

    def __init__(self, in_features, out_features, bias=True, dtype=torch.float32,
                 device="cuda"):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype
        lecun_normal_(self.weight, in_features)
        if bias:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.compute_dtype)
        return F.linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype), bias)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over (N, H, W) of an NCHW tensor: float32 statistics and
    parameters, output in ``dtype``. Training updates ``mean``/``var`` as flax does,
    ``momentum * old + (1 - momentum) * batch`` with the biased batch variance."""

    def __init__(self, channels, momentum=0.9, epsilon=1e-5, zero_scale=False,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(channels, device=device) if zero_scale
                                  else torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))
        self.momentum = momentum
        self.epsilon = epsilon
        self.compute_dtype = dtype
        #: the ranks whose batches make one batch (:func:`sync_batch_norm`); None: this
        #: rank's batch alone
        self.process_group = None

    def forward(self, x):
        x = x.to(self.compute_dtype)
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, False,
                                0.0, self.epsilon)
        if self.process_group is not None:
            return self._global_batch_norm(x)
        # torch's running update takes the unbiased variance: with momentum 1 it leaves
        # the batch's mean and unbiased variance in scratch buffers, which update flax's
        # averages here (torch picks the kernels: on channels_last, its native ones)
        mean = torch.zeros_like(self.mean)
        var = torch.zeros_like(self.var)
        y = F.batch_norm(x, mean, var, self.scale, self.bias, True, 1.0, self.epsilon)
        n = x.numel() // x.shape[1]  # > 1: torch refuses one value a channel in training
        biased = (n - 1) / n  # out of place: the scratch buffers are saved for backward
        with torch.no_grad():
            self.mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.var.mul_(self.momentum).add_(var, alpha=(1 - self.momentum) * biased)
        return y

    def _global_batch_norm(self, x):
        """Training over the batch of every rank of ``process_group``, in float32 and in
        two passes (the mean, then the squared deviations from it), each an all-reduce
        that autograd reduces again backward: with ``DistributedDataParallel``'s mean of
        the ranks' gradients, the step's gradient is the global batch's."""
        from torch.distributed.nn.functional import all_reduce

        shape = (1, -1, 1, 1)
        xf = x.float()
        count = xf.new_full((1,), x.numel() // x.shape[1])
        sums = all_reduce(torch.cat([xf.sum((0, 2, 3)), count]), group=self.process_group)
        n = sums[-1]
        mean = sums[:-1] / n
        dev = xf - mean.view(shape)
        var = all_reduce((dev * dev).sum((0, 2, 3)), group=self.process_group) / n
        y = dev * torch.rsqrt(var + self.epsilon).view(shape) * self.scale.view(shape) \
            + self.bias.view(shape)
        with torch.no_grad():
            self.mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
        return y.to(self.compute_dtype)


def sync_batch_norm(module, process_group):
    """Make every :class:`BatchNorm` in ``module`` normalise over the batch of all the
    ranks of ``process_group`` (a data-parallel group, each rank holding its slice of
    the global batch), as ``SyncBatchNorm`` does; ``None`` restores per-rank
    statistics. Returns ``module``."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.process_group = process_group
    return module


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last dimension: computed and returned in float32
    (the JAX models' ``dtype=jnp.float32``), ``epsilon`` 1e-6."""

    def __init__(self, features, epsilon=1e-6, device="cuda"):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.epsilon = epsilon

    def forward(self, x):
        return F.layer_norm(x.float(), self.scale.shape, self.scale, self.bias,
                            self.epsilon)
