"""The slab-leak check the port's test modules use in place of the conftest one
(``_torch_pool_helpers._no_leaked_shm_segments``): it fails a test that leaves a
``ptpu_shm_<own pid>_*`` segment behind and ignores the segments of other processes,
which under ``pytest -n`` are other workers' live pools. The segments here are made in a
temporary directory standing for ``/dev/shm``, so no other worker's check sees them."""
import os

import pytest

from _torch_pool_helpers import (_no_leaked_shm_segments, no_leaked_port_slabs,  # noqa: F401
                                 own_reference_slab_check)


def _segment(shm_dir, pid):
    path = os.path.join(str(shm_dir), "ptpu_shm_%d_x" % pid)
    with open(path, "wb") as f:
        f.write(b"\0" * 64)
    return path


def test_a_segment_of_this_process_left_behind_fails(tmp_path):
    path = None
    try:
        with pytest.raises(AssertionError, match="leaked shared-memory slabs.*ptpu_shm_%d_x"
                           % os.getpid()):
            with own_reference_slab_check(str(tmp_path)):
                path = _segment(tmp_path, os.getpid())
    finally:
        if path is not None:
            os.unlink(path)
    assert not os.listdir(tmp_path)


def test_a_segment_of_another_process_is_ignored(tmp_path):
    other = 10 * os.getpid() + 7  # never this process's pid, nor a prefix-match of it
    paths = []
    try:
        with own_reference_slab_check(str(tmp_path)):
            paths.append(_segment(tmp_path, other))
        # a segment of this process that was there before the block is no leak either
        paths.append(_segment(tmp_path, os.getpid()))
        with own_reference_slab_check(str(tmp_path)):
            pass
    finally:
        for path in paths:
            os.unlink(path)
    assert not os.listdir(tmp_path)


def test_a_segment_removed_inside_the_block_passes(tmp_path):
    with own_reference_slab_check(str(tmp_path)):
        os.unlink(_segment(tmp_path, os.getpid()))
    assert not os.listdir(tmp_path)
