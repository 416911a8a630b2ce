"""Carry flax ``variables`` into the port's models and back out.

The JAX models keep their parameters in flax trees (``{"params": ..., "batch_stats":
...}``, auto-named modules such as ``BottleneckBlock_3/Conv_1``). The port's modules hold
the same tensors in torch's layouts. :func:`load_flax_variables` takes such a tree as
nested dicts of numpy arrays (no flax import: a caller hands over
``jax.tree.map(np.asarray, variables)``) and copies it into a model;
:func:`flax_variables` gives a model's tensors (or their gradients) back in the flax
tree's names and layouts, so the two packages can be compared leaf by leaf.

Layouts: conv kernels HWIO → OIHW; dense kernels ``(in, out)`` → ``(out, in)``; the
``DenseGeneral`` kernels of flax's attention, ``(d, heads, head_dim)`` for query, key and
value and ``(heads, head_dim, d)`` for the output, → ``(heads * head_dim, d)`` and
``(d, heads * head_dim)``, their biases flattened. Everything else as it is.
"""
from __future__ import annotations

import numpy as np
import torch


def _conv():
    return (lambda a: np.transpose(a, (3, 2, 0, 1)),
            lambda t: np.transpose(t, (2, 3, 1, 0)))


def _dense():
    return lambda a: a.T, lambda t: t.T


def _same():
    return lambda a: a, lambda t: t


def _heads_in(heads):
    """A query/key/value kernel ``(d, heads, head_dim)``."""
    return (lambda a: a.reshape(a.shape[0], -1).T,
            lambda t: t.T.reshape(t.shape[1], heads, -1))


def _heads_bias(heads):
    return lambda a: a.reshape(-1), lambda t: t.reshape(heads, -1)


def _heads_out(heads):
    """The output kernel ``(heads, head_dim, d)``."""
    return (lambda a: a.reshape(-1, a.shape[-1]).T,
            lambda t: t.T.reshape(heads, -1, t.shape[0]))


def _conv_entries(path, conv):
    yield ("params",) + path + ("kernel",), conv.weight, _conv()
    if conv.bias is not None:
        yield ("params",) + path + ("bias",), conv.bias, _same()


def _dense_entries(path, dense, kernel=None, bias=None):
    yield ("params",) + path + ("kernel",), dense.weight, kernel or _dense()
    if dense.bias is not None:
        yield ("params",) + path + ("bias",), dense.bias, bias or _same()


def _norm_entries(path, norm):
    yield ("params",) + path + ("scale",), norm.scale, _same()
    yield ("params",) + path + ("bias",), norm.bias, _same()
    if hasattr(norm, "mean"):  # a batch norm's running statistics
        yield ("batch_stats",) + path + ("mean",), norm.mean, _same()
        yield ("batch_stats",) + path + ("var",), norm.var, _same()


def _resnet_entries(model):
    yield from _conv_entries(("conv_init",), model.conv_init)
    yield from _norm_entries(("bn_init",), model.bn_init)
    for i, block in enumerate(model.blocks):
        name = "%s_%d" % (model.block_cls.__name__, i)
        for j in range(block.depth):
            yield from _conv_entries((name, "Conv_%d" % j), getattr(block, "conv%d" % j))
            yield from _norm_entries((name, "BatchNorm_%d" % j),
                                     getattr(block, "norm%d" % j))
        if block.conv_proj is not None:
            yield from _conv_entries((name, "conv_proj"), block.conv_proj)
            yield from _norm_entries((name, "norm_proj"), block.norm_proj)
    yield from _dense_entries(("head",), model.head)


def _vit_entries(model):
    yield from _conv_entries(("embedding",), model.embedding)
    yield ("params", "cls"), model.cls, _same()
    yield ("params", "pos_embedding"), model.pos_embedding, _same()
    for i, block in enumerate(model.blocks):
        name = "encoderblock_%d" % i
        yield from _norm_entries((name, "LayerNorm_0"), block.norm0)
        att = block.attention
        heads = att.num_heads
        for proj in ("query", "key", "value"):
            yield from _dense_entries((name, "MultiHeadDotProductAttention_0", proj),
                                      getattr(att, proj), _heads_in(heads),
                                      _heads_bias(heads))
        yield from _dense_entries((name, "MultiHeadDotProductAttention_0", "out"),
                                  att.out, _heads_out(heads))
        yield from _norm_entries((name, "LayerNorm_1"), block.norm1)
        yield from _dense_entries((name, "MlpBlock_0", "Dense_0"), block.mlp.dense0)
        yield from _dense_entries((name, "MlpBlock_0", "Dense_1"), block.mlp.dense1)
    yield from _norm_entries(("encoder_norm",), model.encoder_norm)
    yield from _dense_entries(("head",), model.head)


def _mnist_entries(model):
    yield from _conv_entries(("Conv_0",), model.conv0)
    yield from _conv_entries(("Conv_1",), model.conv1)
    yield from _dense_entries(("Dense_0",), model.dense0)
    yield from _dense_entries(("Dense_1",), model.dense1)


def _entries(model):
    """``(flax path, tensor, (to_torch, to_flax))`` of every tensor of ``model``."""
    from petastorm_tpu_torch.models.mnist import MnistCNN
    from petastorm_tpu_torch.models.resnet import ResNet
    from petastorm_tpu_torch.models.vit import ViT

    for cls, entries in ((ResNet, _resnet_entries), (ViT, _vit_entries),
                         (MnistCNN, _mnist_entries)):
        if isinstance(model, cls):
            return list(entries(model))
    raise TypeError("no flax layout for %s" % type(model).__name__)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def load_flax_variables(model, variables):
    """Copy a flax ``variables`` tree (nested dicts of numpy arrays: ``params`` and, for
    a ResNet, ``batch_stats``) into ``model``'s tensors; returns ``model``. Every leaf
    must find its tensor with the same shape, and every tensor its leaf."""
    leaves = dict(_leaves(variables))
    entries = _entries(model)
    missing = [path for path, _t, _c in entries if path not in leaves]
    extra = sorted(set(leaves) - {path for path, _t, _c in entries})
    if missing or extra:
        raise ValueError("flax tree does not match %s: missing %s, unexpected %s"
                         % (type(model).__name__, missing[:5], extra[:5]))
    with torch.no_grad():
        for path, tensor, (to_torch, _to_flax) in entries:
            value = torch.from_numpy(np.array(to_torch(np.asarray(leaves[path])),
                                              dtype=np.float32))
            if value.shape != tensor.shape:
                raise ValueError("%s: flax %s is %s in torch, %s expected"
                                 % ("/".join(path), tuple(np.shape(leaves[path])),
                                    tuple(value.shape), tuple(tensor.shape)))
            tensor.copy_(value)
    return model


def flax_variables(model, grads=False):
    """``model``'s tensors as a flax ``variables`` tree of numpy arrays; ``grads=True``:
    the parameters' ``.grad`` instead (``{"params": ...}`` only)."""
    out = {}
    for path, tensor, (_to_torch, to_flax) in _entries(model):
        if grads:
            if path[0] != "params":
                continue
            tensor = tensor.grad
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = to_flax(tensor.detach().float().cpu().numpy())
    return out
