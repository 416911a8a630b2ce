"""Compatibility with stores written by the reference petastorm
(:mod:`.reference`). The JAX package's ``compat`` also holds a ``jax.shard_map``
version shim, which has no counterpart here."""
from petastorm_tpu_torch.compat.reference import loads_reference_pickle

__all__ = ["loads_reference_pickle"]
