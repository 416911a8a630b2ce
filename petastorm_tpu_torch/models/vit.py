"""Vision Transformer (ViT) as torch modules: the port's second image family.

Port of ``petastorm_tpu.models.vit``: patchify as one strided conv turns the loader's
``(n, h, w, 3)`` batch into ``(n, tokens, d)``, a ``[cls]`` token and learned positions
join, pre-norm encoder blocks follow, and the head reads the ``[cls]`` token. bfloat16
compute with float32 parameters and float32 layer norms by default, as in the JAX
model, and flax's numerics where torch's defaults differ: ``LayerNorm`` epsilon 1e-6,
``gelu`` in its tanh form, the attention's query scaled by ``head_dim ** -0.5`` before
the product and its dropout on the attention weights (one mask for every batch row and
head, flax's ``broadcast_dropout``). The attention is written as einsums, as flax's is.

The positions are a parameter of ``(1, 1 + tokens, d)``, so the module takes the image
size it is built for (flax sizes it from the first batch).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.models.layers import Conv, Dense, LayerNorm, nhwc_to_nchw


def _dropout(x, rate, train, shape=None):
    """Inverted dropout with keep probability ``1 - rate``; ``shape`` broadcasts one
    mask (flax ``Dropout`` / the attention's ``broadcast_dropout``)."""
    if not train or rate == 0.0:
        return x
    keep = torch.rand(shape or x.shape, device=x.device) >= rate
    return x * (keep.to(x.dtype) / (1.0 - rate))


class MlpBlock(nn.Module):
    def __init__(self, d, mlp_dim, dropout_rate=0.0, dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.dense0 = Dense(d, mlp_dim, dtype=dtype, device=device)
        self.dense1 = Dense(mlp_dim, d, dtype=dtype, device=device)
        self.dropout_rate = dropout_rate

    def forward(self, x):
        x = F.gelu(self.dense0(x), approximate="tanh")
        x = _dropout(x, self.dropout_rate, self.training)
        return self.dense1(x)


class SelfAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` on ``(x, x)``: query, key and value
    projections to ``(heads, d / heads)``, softmax over the keys, the output
    projection."""

    def __init__(self, d, num_heads, dropout_rate=0.0, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.query, self.key, self.value = (Dense(d, d, **kw) for _ in range(3))
        self.out = Dense(d, d, **kw)
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate

    def forward(self, x):
        n, s, d = x.shape
        h = self.num_heads
        q, k, v = (proj(x).view(n, s, h, d // h) for proj in (self.query, self.key,
                                                               self.value))
        q = q / math.sqrt(d // h)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        w = _dropout(w, self.dropout_rate, self.training, (1, 1, s, s))
        o = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out(o.reshape(n, s, d))


class EncoderBlock(nn.Module):
    def __init__(self, d, num_heads, mlp_dim, dropout_rate=0.0, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        self.norm0 = LayerNorm(d, device=device)
        self.attention = SelfAttention(d, num_heads, dropout_rate, dtype, device)
        self.norm1 = LayerNorm(d, device=device)
        self.mlp = MlpBlock(d, mlp_dim, dropout_rate, dtype, device)

    def forward(self, x):
        x = x + self.attention(self.norm0(x)).to(x.dtype)
        return x + self.mlp(self.norm1(x)).to(x.dtype)


class ViT(nn.Module):
    """ViT classifier: patchify, ``[cls]`` + learned positions, encoder, head.

    Defaults are ViT-B/16 (Dosovitskiy et al. 2020 table 1): 12 layers, width 768, 12
    heads, MLP 3072; 86.6M parameters at 224² with 1000 classes. ``forward(x)``: an NHWC
    batch of ``image_size`` to float32 logits; ``train()`` mode applies dropout."""

    def __init__(self, num_classes=1000, patch_size=16, hidden_size=768, num_layers=12,
                 num_heads=12, mlp_dim=3072, dropout_rate=0.0, dtype=torch.bfloat16,
                 image_size=224, device="cuda"):
        super().__init__()
        h, w = (image_size, image_size) if isinstance(image_size, int) else image_size
        tokens = (h // patch_size) * (w // patch_size)
        self.compute_dtype = dtype
        self.dropout_rate = dropout_rate
        self.embedding = Conv(3, hidden_size, patch_size, patch_size, padding="VALID",
                              dtype=dtype, device=device)
        self.cls = nn.Parameter(torch.zeros(1, 1, hidden_size, device=device))
        self.pos_embedding = nn.Parameter(
            torch.randn(1, 1 + tokens, hidden_size, device=device) * 0.02)
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden_size, num_heads, mlp_dim, dropout_rate, dtype, device)
            for _ in range(num_layers))
        self.encoder_norm = LayerNorm(hidden_size, device=device)
        self.head = Dense(hidden_size, num_classes, dtype=torch.float32, device=device)

    def forward(self, x):
        n = x.shape[0]
        x = self.embedding(nhwc_to_nchw(x, self.compute_dtype))
        x = x.flatten(2).transpose(1, 2)  # (n, tokens, d), tokens in row-major order
        cls = self.cls.to(self.compute_dtype).expand(n, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(self.compute_dtype)
        x = _dropout(x, self.dropout_rate, self.training)
        for block in self.blocks:
            x = block(x)
        return self.head(self.encoder_norm(x)[:, 0]).float()


ViT_B16 = functools.partial(ViT)  # 86.6M @ 224^2 / 1000 classes
ViT_S16 = functools.partial(ViT, hidden_size=384, num_layers=12, num_heads=6,
                            mlp_dim=1536)  # 22.1M
ViT_L16 = functools.partial(ViT, hidden_size=1024, num_layers=24, num_heads=16,
                            mlp_dim=4096)  # 304M
