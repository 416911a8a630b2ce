"""The port's shuffling buffers against the JAX package's ``tests/test_shuffle.py``,
case for case.

Both packages' buffers draw from ``PCG64(seed)`` (``shuffle.py`` in each), so the
comparison level is bit-exact: for the same seed and the same sequence of adds and
retrieves the retrieved order equals the JAX package's. The statistical-quality cases
are kept as they are.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

from petastorm_tpu import shuffle as ref_shuffle  # noqa: E402
from petastorm_tpu_torch.shuffle import (  # noqa: E402
    BatchedRandomShufflingBuffer,
    NoopShufflingBuffer,
    RandomShufflingBuffer,
)


def _drain(b):
    got = []
    while b.can_retrieve:
        got.append(b.retrieve())
    return got


def _ids(batches, key):
    return [v for out in batches for v in out[key].tolist()]


def test_noop_fifo():
    b = NoopShufflingBuffer()
    b.add_many([1, 2, 3])
    assert [b.retrieve() for _ in range(3)] == [1, 2, 3]
    assert not b.can_retrieve
    theirs = ref_shuffle.NoopShufflingBuffer()
    theirs.add_many([1, 2, 3])
    assert [theirs.retrieve() for _ in range(3)] == [1, 2, 3]


def test_random_buffer_drains_all():
    def run(cls):
        b = cls(100, 10, seed=0)
        b.add_many(range(50))
        got = _drain(b)
        assert len(got) == 50 - 10  # stops at threshold while not finished
        b.finish()
        return got + _drain(b)

    got = run(RandomShufflingBuffer)
    assert sorted(got) == list(range(50))
    assert got == run(ref_shuffle.RandomShufflingBuffer)


def test_random_buffer_shuffles():
    def run(cls):
        b = cls(1000, 0, seed=1)
        b.add_many(range(500))
        b.finish()
        return [b.retrieve() for _ in range(500)]

    got = run(RandomShufflingBuffer)
    assert got != list(range(500))
    assert sorted(got) == list(range(500))
    assert got == run(ref_shuffle.RandomShufflingBuffer)


def test_random_buffer_backpressure():
    for cls in (RandomShufflingBuffer, ref_shuffle.RandomShufflingBuffer):
        b = cls(10, 2, extra_capacity=5)
        b.add_many(range(10))
        assert not b.can_add
        with pytest.raises(RuntimeError, match="capacity"):
            b.add_many(range(100))


def test_random_buffer_threshold_validation():
    with pytest.raises(ValueError) as ours:
        RandomShufflingBuffer(5, 10)
    with pytest.raises(ValueError) as theirs:
        ref_shuffle.RandomShufflingBuffer(5, 10)
    assert str(ours.value) == str(theirs.value)


def test_batched_buffer_roundtrip():
    def run(cls):
        b = cls(100, 0, batch_size=8, seed=2)
        for start in range(0, 64, 16):
            b.add_many({"x": np.arange(start, start + 16), "y": np.ones(16)})
        b.finish()
        out = []
        while b.can_retrieve:
            batch = b.retrieve()
            assert set(batch.keys()) == {"x", "y"}
            assert len(batch["x"]) == len(batch["y"]) <= 8
            out.append(batch)
        return out

    ours = run(BatchedRandomShufflingBuffer)
    seen = _ids(ours, "x")
    assert sorted(seen) == list(range(64))
    assert seen != list(range(64))  # shuffled
    theirs = run(ref_shuffle.BatchedRandomShufflingBuffer)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        for k in ("x", "y"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_batched_buffer_threshold():
    for cls in (BatchedRandomShufflingBuffer, ref_shuffle.BatchedRandomShufflingBuffer):
        b = cls(100, min_after_retrieve=20, batch_size=10)
        b.add_many({"x": np.arange(25)})
        assert not b.can_retrieve  # 25 < 20 + 10
        b.add_many({"x": np.arange(10)})
        assert b.can_retrieve


def test_batched_buffer_ragged_rejected():
    with pytest.raises(ValueError, match="Ragged") as ours:
        BatchedRandomShufflingBuffer(10, 0, 2).add_many({"x": np.arange(3),
                                                         "y": np.arange(4)})
    with pytest.raises(ValueError, match="Ragged") as theirs:
        ref_shuffle.BatchedRandomShufflingBuffer(10, 0, 2).add_many({"x": np.arange(3),
                                                                     "y": np.arange(4)})
    assert str(ours.value) == str(theirs.value)


def test_batched_buffer_incremental_adds_and_retrieves_interleaved():
    """Exercises the preallocated-store path: staged chunks, growth, hole backfill; the
    same sequence of adds and retrieves gives the JAX package's batches."""
    def run(cls):
        rng = np.random.RandomState(0)
        b = cls(64, min_after_retrieve=16, batch_size=8, seed=3)
        out = []
        next_id = 0
        for _ in range(30):
            n = rng.randint(1, 20)
            ids = np.arange(next_id, next_id + n)
            b.add_many({"id": ids, "x": ids.astype(np.float64) * 0.5})
            next_id += n
            while b.can_retrieve:
                batch = b.retrieve()
                np.testing.assert_array_equal(batch["x"], batch["id"] * 0.5)
                out.append(batch)
        b.finish()
        while b.can_retrieve:
            batch = b.retrieve()
            np.testing.assert_array_equal(batch["x"], batch["id"] * 0.5)
            out.append(batch)
        return out, next_id

    ours, total = run(BatchedRandomShufflingBuffer)
    assert sorted(_ids(ours, "id")) == list(range(total))  # exact permutation
    theirs, _ = run(ref_shuffle.BatchedRandomShufflingBuffer)
    assert [len(b["id"]) for b in ours] == [len(b["id"]) for b in theirs]
    assert _ids(ours, "id") == _ids(theirs, "id")


def test_batched_buffer_statistical_shuffle_quality():
    """Statistical quality, not just 'order differs': with capacity >= N the output
    order must be rank-decorrelated from the input."""
    n = 2000
    b = BatchedRandomShufflingBuffer(n, min_after_retrieve=0, batch_size=50, seed=7)
    for start in range(0, n, 200):
        b.add_many({"id": np.arange(start, start + 200)})
    b.finish()
    out = []
    while b.can_retrieve:
        out.extend(b.retrieve()["id"].tolist())
    assert sorted(out) == list(range(n))
    positions = np.empty(n)
    positions[np.asarray(out)] = np.arange(n)
    rho = np.corrcoef(np.arange(n), positions)[0, 1]  # Spearman on identity input
    assert abs(rho) < 0.15, rho
    displacement = np.abs(positions - np.arange(n)).mean()
    assert displacement > n / 6, displacement  # uniform shuffle expectation ~ n/3


def test_random_buffer_statistical_shuffle_quality():
    n = 2000
    b = RandomShufflingBuffer(n, 0, seed=5)
    b.add_many(range(n))
    b.finish()
    out = [b.retrieve() for _ in range(n)]
    positions = np.empty(n)
    positions[np.asarray(out)] = np.arange(n)
    rho = np.corrcoef(np.arange(n), positions)[0, 1]
    assert abs(rho) < 0.15, rho
