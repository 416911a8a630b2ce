"""Parallel machinery of the port: device meshes, batch shardings and DTensor delivery
over ``torch.distributed`` (:mod:`.mesh`), and the process pool's shared-memory slab
ring (:mod:`.shm_ring`). The JAX package's attention and pipeline modules are ROADMAP.md
Queue 1 item 15; their names raise ``AttributeError`` naming it."""

from petastorm_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    batch_sharding,
    local_batch_size,
    make_mesh,
    sequence_sharding,
)


def __getattr__(name):
    if name in ("ring_attention", "ulysses_attention", "reference_attention",
                "ring_self_attention", "ulysses_self_attention", "spmd_pipeline",
                "pipelined_apply", "stage_sharding"):
        raise AttributeError(
            "petastorm_tpu_torch.parallel.%s is not ported yet: see ROADMAP.md Queue 1 "
            "item 15 (parallel/attention.py and parallel/pipeline.py)" % name)
    raise AttributeError("module 'petastorm_tpu_torch.parallel' has no attribute %r" % name)
