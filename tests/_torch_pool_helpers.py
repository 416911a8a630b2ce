"""Shared by the port's tests: the slab-leak checks and the workers the pool children
run.

The port's slabs are named ``ptpu_torch_shm_<creator pid>_...``, outside the glob of
the JAX package's ``_no_leaked_shm_segments`` fixture (``ptpu_shm_*``), so that fixture
neither sees them nor blames them on a test in another xdist worker. This module holds
their own check: ``no_leaked_port_slabs`` (autouse in every test module that imports
it) fails a test that leaves a slab created by this process (its pid in the name).

It also holds ``_no_leaked_shm_segments``, the JAX package's slab check scoped to this
process. The conftest fixture of that name globs every ``ptpu_shm_*`` segment on the
host, so under ``pytest -n`` it blames one worker's live pool slabs on a test that runs
in another. A test module that imports this fixture overrides the conftest one for its
own tests: the JAX package's ring names each slab after the pid of the process that
creates it (the pool's parent, the test process), so a slab that a test's own JAX pool
leaves behind still fails that test, and other processes' segments are none of its
business.

This module imports numpy, pytest and the port only: pool children import it to
unpickle the workers below, and a child must not load jax or the JAX package.
"""
import contextlib
import glob
import os
import sys
import time

import numpy as np
import pytest


def port_slabs():
    """``/dev/shm`` paths of the slabs this process created."""
    from petastorm_tpu_torch.parallel.shm_ring import SEGMENT_PREFIX

    return set(glob.glob("/dev/shm/%s%d_*" % (SEGMENT_PREFIX, os.getpid())))


@contextlib.contextmanager
def slab_leak_check():
    """Raise ``AssertionError`` when the block leaves a slab of this process behind."""
    before = port_slabs()
    yield
    leaked = port_slabs() - before
    assert not leaked, "leaked port shared-memory slabs: %s" % sorted(leaked)


def own_reference_slabs(shm_dir="/dev/shm"):
    """Paths of the JAX package's pool slabs (``ptpu_shm_<pid>_...``) this process
    created."""
    return set(glob.glob(os.path.join(shm_dir, "ptpu_shm_%d_*" % os.getpid())))


@contextlib.contextmanager
def own_reference_slab_check(shm_dir="/dev/shm"):
    """Raise ``AssertionError`` when the block leaves a JAX-package slab of this process
    behind in ``shm_dir``."""
    if not os.path.isdir(shm_dir):
        yield
        return
    before = own_reference_slabs(shm_dir)
    yield
    leaked = own_reference_slabs(shm_dir) - before
    assert not leaked, "leaked shared-memory slabs: %s" % sorted(leaked)


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
    """The conftest check of the same name, scoped to this process's segments."""
    with own_reference_slab_check():
        yield


@pytest.fixture(autouse=True)
def no_leaked_port_slabs():
    """Every test leaves ``/dev/shm`` free of the port's slabs: ``ProcessExecutor.join``
    unlinks its whole ring, so a slab surviving a test is a leak."""
    with slab_leak_check():
        yield


# -- workers the children run -----------------------------------------------------------


def payload_worker(i):
    return (0, i, {"x": np.full((50_000,), i, np.int32)})


def slow_payload_worker(i):
    time.sleep(0.3)
    return (0, i, {"x": np.full((50_000,), i, np.int32)})


def negate(x):
    return -x


def failing_worker(i):
    if i == 3:
        raise ValueError("item 3 is bad")
    return (0, i, {"x": np.full((4,), i, np.int32)})


class PayloadBytesWorker:
    """Deterministic bytes-heavy worker: results carry raw bytes that any corruption on
    the wire would change (the transport tests' byte-identity probe)."""

    def __call__(self, item):
        rng = np.random.default_rng(item)
        return (item, rng.integers(0, 256, size=4096, dtype=np.uint8).tobytes())


def slow_square(x):
    time.sleep(0.3)
    return x * x


class KnobWorker:
    """A worker with a live-knob apply seam (the control frame's target)."""

    def __init__(self):
        self.depth = 1

    def apply_readahead_depth(self, value):
        self.depth = int(value)
        return self.depth

    def __call__(self, item):
        time.sleep(0.05)
        return item


class ModulesProbe:
    """Runs ``worker`` on the item, then reports which of jax, the JAX package and torch
    the child process has loaded."""

    def __init__(self, worker):
        self.worker = worker

    def __call__(self, item):
        self.worker(item)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "petastorm_tpu", "torch"))
        return (0, 0, {"loaded": np.array(loaded or [""]),
                       "cuda_visible": np.array([os.environ.get("CUDA_VISIBLE_DEVICES",
                                                                "unset")])})


class FirstItemProbe:
    """Runs ``worker`` on the item and reports whether pandas (which pyarrow's first
    ``to_numpy`` imports) was loaded in the child before the item began; forwards the
    worker's ``warm``."""

    def __init__(self, worker):
        self.worker = worker
        self.warm = getattr(worker, "warm", None)

    def __call__(self, item):
        loaded = "pandas" in sys.modules
        self.worker(item)
        return (0, 0, {"pandas_before_item": np.array([loaded])})


def double_x_plus_a(d):
    """An opaque transform the reader tests hand to both packages: ``x2 = 2x + a`` on a
    row dict (per-row path) and on a pandas DataFrame (batch path) alike."""
    d["x2"] = d["x"] * 2.0 + d["a"]
    return d


def gloo_checkpoint_rank(rank, world, port, url, ckpt, out):
    """One rank of a ``torch.distributed`` (gloo, CPU) job over a sharded reader: take
    ``rank + 1`` batches, save the job's data-plane state (collective), rebuild the
    reader, restore it and read the rest. Writes ``{"pre", "post", "payload_keys"}`` as
    JSON to ``out``. Run in a spawned process by the checkpoint tests."""
    import datetime
    import json

    import torch.distributed as dist

    from petastorm_tpu_torch import checkpoint as ptck
    from petastorm_tpu_torch import make_batch_reader

    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        def build():
            return make_batch_reader(url, cur_shard=rank, shard_count=world, shard_seed=0,
                                     shuffle_row_groups=True, seed=4, num_epochs=1,
                                     reader_pool_type="dummy")

        with build() as reader:
            it = iter(reader)
            pre = [int(i) for _ in range(rank + 1) for i in next(it).id]
            payload = ptck.global_state_dict(reader)
            ptck.save(ckpt, reader)
        resumed = build()
        ptck.restore(ckpt, resumed)
        with resumed:
            post = [int(i) for b in resumed for i in b.id]
        with open(out, "w") as f:
            json.dump({"pre": pre, "post": post,
                       "payload_keys": sorted(payload[ptck._GLOBAL_KEY])}, f)
    finally:
        dist.destroy_process_group()


def gloo_make_dataloader_rank(rank, world, port, url, out):
    """One rank of a ``torch.distributed`` (gloo, CPU) job: ``make_dataloader`` with no
    ``cur_shard`` reads the rank's shard; ``InMemDataLoader`` without a sharding refuses
    the multi-process job (``ValueError``). Writes ``{"ids", "cur_shard",
    "shard_count", "inmem_error"}`` as JSON to ``out``."""
    import datetime
    import json

    import torch.distributed as dist

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import InMemDataLoader, make_dataloader

    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        with make_dataloader(url, 4, device="cpu", last_batch="partial",
                             reader_pool_type="dummy", shuffle_row_groups=False) as loader:
            ids = [int(i) for b in loader for i in b["id"]]
            shard = (loader.reader.cur_shard, loader.reader.shard_count)
        reader = make_batch_reader(url, reader_pool_type="dummy")
        try:
            with InMemDataLoader(reader, 4, device="cpu"):
                error = None
        except ValueError as e:
            error = str(e)
        finally:
            reader.stop()
            reader.join()
        with open(out, "w") as f:
            json.dump({"ids": ids, "cur_shard": shard[0], "shard_count": shard[1],
                       "inmem_error": error}, f)
    finally:
        dist.destroy_process_group()
