"""Parallel machinery of the port: device meshes, batch shardings and DTensor delivery
over ``torch.distributed`` (:mod:`.mesh`), the differentiable collectives
(:mod:`.collectives`), sequence/context parallelism (ring attention and Ulysses,
:mod:`.attention`), pipeline microbatching (:mod:`.pipeline`), and the process pool's
shared-memory slab ring (:mod:`.shm_ring`)."""

from petastorm_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    batch_sharding,
    local_batch_size,
    make_mesh,
    sequence_sharding,
)


def __getattr__(name):
    if name in ("ring_attention", "ulysses_attention", "reference_attention",
                "ring_self_attention", "ulysses_self_attention"):
        from petastorm_tpu_torch.parallel import attention

        return getattr(attention, name)
    if name in ("spmd_pipeline", "pipelined_apply", "stage_sharding"):
        from petastorm_tpu_torch.parallel import pipeline

        return getattr(pipeline, name)
    raise AttributeError("module 'petastorm_tpu_torch.parallel' has no attribute %r" % name)
