"""Differentiable collectives over one axis of a ``DeviceMesh``: the port's counterparts
of ``lax.ppermute``, ``lax.all_to_all`` and ``lax.psum`` inside ``shard_map``.

Each is a ``torch.autograd.Function`` over ``mesh.get_group(axis)``, so a rank's local
computation with explicit collectives differentiates as the JAX step does:

- :func:`ppermute` sends a rank's tensor ``shift`` places along the axis's ring; its
  backward sends the cotangent back the other way. One ``dist.batch_isend_irecv`` does
  a step's send and receive, so a ring of two does not deadlock. On an axis of size 1 it
  is the identity (no send to self, which hangs NCCL).
- :func:`all_to_all` is ``lax.all_to_all(tiled=True)``: the tensor splits along
  ``split_axis`` into one chunk a rank, and the chunks received concatenate along
  ``concat_axis`` in rank order. Its backward is the inverse exchange.
- Megatron's pair (Shoeybi et al. 2019), which is how JAX's varying-axes typing
  transposes a ``psum``: :func:`f` is the identity forward and an all-reduce of the
  cotangent backward (in front of a column-parallel product: an activation replicated
  over the axis meets a weight split over it); :func:`g` is an all-reduce forward and
  the identity backward (after a row-parallel product, and for a loss summed over the
  data axes). ``torch.distributed.nn.functional.all_reduce`` is neither: it all-reduces
  the cotangent too, which on a loss summed over ``(dp, sp)`` scales every gradient by
  dp x sp.

Every rank of an axis must call the same collectives in the same order, forward and
backward: a rank's graph holds each of them on every rank (a stage that does not use a
value masks it with ``torch.where``, it does not skip it).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from petastorm_tpu_torch.parallel.mesh import axis_coordinate


def axis_size(mesh, axis):
    """Positions along ``axis`` (1 for an axis the mesh does not have)."""
    return axis_coordinate(mesh, (axis,))[1] if axis in (mesh.mesh_dim_names or ()) else 1


def axis_index(mesh, axis):
    """This rank's coordinate along ``axis`` (0 for an axis the mesh does not have)."""
    return axis_coordinate(mesh, (axis,))[0] if axis in (mesh.mesh_dim_names or ()) else 0


def _axis_ranks(mesh, axis):
    """The global ranks along ``axis`` through this rank, in axis order."""
    names = list(mesh.mesh_dim_names)
    coord = list(mesh.get_coordinate())
    dim = names.index(axis)
    ranks = []
    for i in range(int(mesh.mesh.shape[dim])):
        coord[dim] = i
        ranks.append(int(mesh.mesh[tuple(coord)]))
    return ranks


def _shift(x, mesh, axis, shift):
    ranks = _axis_ranks(mesh, axis)
    n, me = len(ranks), axis_index(mesh, axis)
    x = x.contiguous()
    out = torch.empty_like(x)
    group = mesh.get_group(axis)
    ops = [dist.P2POp(dist.isend, x, ranks[(me + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _shift(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.mesh, ctx.axis, -ctx.shift), None, None, None


def ppermute(x, mesh, axis, shift=1):
    """``lax.ppermute(x, axis, [(j, (j + shift) % n) for j in range(n)])``: rank ``j``
    of the axis receives rank ``j - shift``'s ``x``."""
    if axis_size(mesh, axis) == 1:
        return x
    return _PPermute.apply(x, mesh, axis, shift)


def _exchange(x, mesh, axis, split_axis, concat_axis):
    n = axis_size(mesh, axis)
    chunks = [c.contiguous() for c in x.chunk(n, dim=split_axis)]
    out = [torch.empty_like(chunks[0]) for _ in range(n)]
    dist.all_to_all(out, chunks, group=mesh.get_group(axis))
    return torch.cat(out, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return _exchange(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, split_axis, concat_axis = ctx.args
        return _exchange(grad, mesh, axis, concat_axis, split_axis), None, None, None, None


def all_to_all(x, mesh, axis, split_axis, concat_axis):
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    if x.shape[split_axis] % n:
        raise ValueError("all_to_all: dimension %d of size %d does not split over %d "
                         "ranks" % (split_axis, x.shape[split_axis], n))
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


def _all_reduce(x, mesh, axes):
    x = x.contiguous().clone()
    for axis in axes:
        if axis_size(mesh, axis) > 1:
            dist.all_reduce(x, group=mesh.get_group(axis))
    return x


def _live(mesh, axes):
    return tuple(a for a in ((axes,) if isinstance(axes, str) else axes)
                 if axis_size(mesh, a) > 1)


class _F(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh, ctx.axes), None, None


class _G(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def f(x, mesh, axes):
    """Identity forward, all-reduce (sum) of the cotangent over ``axes`` backward."""
    axes = _live(mesh, axes)
    return _F.apply(x, mesh, axes) if axes else x


def g(x, mesh, axes):
    """All-reduce (sum) over ``axes`` forward, identity backward: ``lax.psum`` of a
    value whose cotangent every rank holds whole."""
    axes = _live(mesh, axes)
    return _G.apply(x, mesh, axes) if axes else x


def all_reduce_(x, mesh, axes):
    """Sum ``x`` in place over ``axes`` (no autograd): a gradient's sum over the axes
    its parameter is replicated on."""
    for axis in _live(mesh, axes):
        dist.all_reduce(x, group=mesh.get_group(axis))
    return x
