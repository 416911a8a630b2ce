"""Parallel machinery of the port. Only the process pool's shared-memory slab ring
(:mod:`.shm_ring`) is ported; the JAX package's mesh, attention and pipeline modules
are ROADMAP.md Queue 1 item 15."""
