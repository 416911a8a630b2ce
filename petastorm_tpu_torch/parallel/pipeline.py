"""Pipeline parallelism: a GPipe-schedule microbatch pipeline over a ``pp`` mesh axis.

Port of ``petastorm_tpu.parallel.pipeline``. Stages live on different ranks along the
``pp`` axis; activations hop stage to stage with :func:`~.collectives.ppermute`, and the
schedule runs ``n_micro + n_stages - 1`` ticks with the classic bubble. Every rank runs
every tick (a stage that does not use a value masks it with ``torch.where``), so each
rank's autograd graph holds the same hops, and the backward pass sends the cotangents
back along the ring in step.

Layout contract: stage parameters are stacked on a leading ``n_stages`` axis and
sharded over ``pp`` (one stage a rank, :func:`stage_sharding`); inputs are microbatched
(n_micro, micro_b, ...) and replicated along ``pp`` (only stage 0 consumes them, only the
last stage emits outputs, and the closing sum over ``pp`` hands them to every stage).
"""
from __future__ import annotations

import torch

from petastorm_tpu_torch.parallel.collectives import axis_index, axis_size, f, g, ppermute
from petastorm_tpu_torch.parallel.mesh import to_local


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def spmd_pipeline(stage_fn, stage_params, microbatches, mesh, axis="pp"):
    """This rank's part of the pipeline; returns the (n_micro, micro_b, ...) outputs,
    the same on every stage.

    ``stage_fn(params, x) -> y`` is one stage's computation; ``stage_params`` is this
    rank's slice (leading dim 1) of the stacked stage parameters; ``microbatches`` has
    shape (n_micro, micro_b, ...), identical on every stage."""
    n_stages = axis_size(mesh, axis)
    stage = axis_index(mesh, axis)
    params = tree_map(lambda p: p[0], stage_params)
    n_micro = microbatches.shape[0]
    first = torch.tensor(stage == 0, device=microbatches.device)
    last = torch.tensor(stage == n_stages - 1, device=microbatches.device)
    # only stage 0 reads the inputs: their cotangent is stage 0's, summed over the axis
    microbatches = f(microbatches, mesh, axis)
    state = torch.zeros_like(microbatches[0])
    outputs = [None] * n_micro
    ticks = n_micro + n_stages - 1
    for t in range(ticks):
        x = torch.where(first, microbatches[min(t, n_micro - 1)], state)
        y = stage_fn(params, x)
        mb = t - (n_stages - 1)  # the last stage finishes microbatch mb at tick t
        if mb >= 0:
            outputs[mb] = y
        if t < ticks - 1:  # the last tick's hop would go unused
            state = ppermute(y, mesh, axis)
    out = torch.stack(outputs)
    # only the last stage's outputs are the pipeline's: the sum over the axis hands them
    # to every stage
    return g(torch.where(last, out, torch.zeros_like(out)), mesh, axis)


def pipelined_apply(stage_fn, stacked_params, x, mesh, n_micro, pp_axis="pp"):
    """Mesh-level entry: apply an ``n_stages``-deep pipeline to a global batch.

    ``stacked_params``: a tree of tensors with leading axis n_stages, as DTensors laid
    out by :func:`stage_sharding` (or whole, and each rank takes its stage); ``x``: the
    (batch, ...) global batch, replicated; ``n_micro`` microbatches must divide it.
    Returns the (batch, ...) outputs, the whole batch on every rank."""
    if x.shape[0] % n_micro:
        raise ValueError("batch %d not divisible into %d microbatches" % (x.shape[0], n_micro))
    from torch.distributed.tensor import DTensor

    stage = axis_index(mesh, pp_axis)

    def local_stage(p):
        return p.to_local() if isinstance(p, DTensor) else p[stage:stage + 1]

    x = to_local(x)
    xm = x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))
    out = spmd_pipeline(stage_fn, tree_map(local_stage, stacked_params), xm, mesh, pp_axis)
    return out.reshape((x.shape[0],) + tuple(out.shape[2:]))


def stage_sharding(mesh, pp_axis="pp"):
    """:class:`~petastorm_tpu_torch.parallel.mesh.NamedSharding` for stage-stacked
    parameters (leading axis over ``pp``)."""
    from petastorm_tpu_torch.parallel.mesh import NamedSharding, PartitionSpec

    return NamedSharding(mesh, PartitionSpec(pp_axis))
