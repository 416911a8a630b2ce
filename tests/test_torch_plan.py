"""The port's plan and scheduler against the JAX package's ``tests/test_plan.py``, case
for case: sharding determinism, epoch shuffles, checkpoint and resume.

Both packages draw from numpy ``PCG64`` (``plan.py`` in each), so the comparison level
is bit-exact: ``shard_indices``, ``epoch_permutation`` and every ``EpochPlan`` order
equal the JAX package's for the same seeds, and each package's checkpoint state resumes
the other's plan to the same remainder.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

from petastorm_tpu import plan as ref_plan  # noqa: E402
from petastorm_tpu_torch.plan import EpochPlan, epoch_permutation, shard_indices  # noqa: E402


def _both_raise(exc, fn_ours, fn_theirs, match=None):
    with pytest.raises(exc, match=match) as ours:
        fn_ours()
    with pytest.raises(exc, match=match) as theirs:
        fn_theirs()
    assert str(ours.value) == str(theirs.value)


def test_shards_disjoint_and_exact():
    n, k = 23, 4
    union = []
    for i in range(k):
        union.extend(shard_indices(n, i, k).tolist())
        np.testing.assert_array_equal(shard_indices(n, i, k), ref_plan.shard_indices(n, i, k))
    assert sorted(union) == list(range(n))


def test_shard_seed_deterministic_and_different():
    a = shard_indices(100, 1, 4, shard_seed=7)
    b = shard_indices(100, 1, 4, shard_seed=7)
    c = shard_indices(100, 1, 4, shard_seed=8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # seeded shards are still disjoint/exact
    union = np.concatenate([shard_indices(100, i, 4, shard_seed=7) for i in range(4)])
    assert sorted(union.tolist()) == list(range(100))
    for n, k, seed in ((100, 4, 7), (100, 4, 8), (37, 5, 0), (1000, 8, 123456789)):
        for i in range(k):
            ours = shard_indices(n, i, k, shard_seed=seed)
            np.testing.assert_array_equal(ours, ref_plan.shard_indices(n, i, k,
                                                                       shard_seed=seed))


def test_shard_validation():
    for args in ((10, 4, 4), (10, -1, 4)):
        _both_raise(ValueError, lambda: shard_indices(*args),
                    lambda: ref_plan.shard_indices(*args))


def test_epoch_permutation_identity_when_not_shuffling():
    np.testing.assert_array_equal(epoch_permutation(5, 3, 42, False), np.arange(5))
    np.testing.assert_array_equal(epoch_permutation(5, 3, 42, False),
                                  ref_plan.epoch_permutation(5, 3, 42, False))


def test_epoch_permutations_differ_across_epochs():
    p0 = epoch_permutation(50, 0, 42, True)
    p1 = epoch_permutation(50, 1, 42, True)
    assert not np.array_equal(p0, p1)
    np.testing.assert_array_equal(p0, epoch_permutation(50, 0, 42, True))
    for n, seed in ((50, 42), (7, None), (1, 3), (513, 2 ** 40)):
        for epoch in range(4):
            ours = epoch_permutation(n, epoch, seed, True)
            theirs = ref_plan.epoch_permutation(n, epoch, seed, True)
            if seed is None:  # unseeded: fresh entropy in each package
                assert sorted(ours.tolist()) == sorted(theirs.tolist())
            else:
                np.testing.assert_array_equal(ours, theirs)


def _both_plans(*args, **kwargs):
    return EpochPlan(*args, **kwargs), ref_plan.EpochPlan(*args, **kwargs)


def test_plan_single_epoch_order():
    plan, theirs = _both_plans(["a", "b", "c"], num_epochs=1, shuffle=False)
    assert list(plan) == ["a", "b", "c"] == list(theirs)


def test_plan_multiple_epochs():
    plan, theirs = _both_plans([0, 1, 2], num_epochs=3, shuffle=False)
    assert list(plan) == [0, 1, 2] * 3 == list(theirs)


def test_plan_shuffled_epochs_cover_all():
    plan, theirs = _both_plans(list(range(10)), num_epochs=2, shuffle=True, seed=1)
    out = list(plan)
    assert sorted(out[:10]) == list(range(10))
    assert sorted(out[10:]) == list(range(10))
    assert out[:10] != out[10:]  # reshuffled per epoch
    assert out == list(theirs)
    for seed in (0, 5, 99):
        ours, ref = _both_plans(list(range(33)), num_epochs=3, shuffle=True, seed=seed,
                                with_epoch=True)
        assert list(ours) == list(ref)


def test_plan_infinite():
    plan, theirs = _both_plans([0, 1], num_epochs=None)
    out = [next(plan) for _ in range(7)]
    assert out == [0, 1, 0, 1, 0, 1, 0]
    assert not plan.exhausted()
    assert out == [next(theirs) for _ in range(7)]
    ours, ref = _both_plans(list(range(5)), num_epochs=None, shuffle=True, seed=4)
    assert [next(ours) for _ in range(23)] == [next(ref) for _ in range(23)]


def test_plan_empty():
    plan, theirs = _both_plans([], num_epochs=1)
    assert plan.exhausted() and theirs.exhausted()
    with pytest.raises(StopIteration):
        next(plan)


def test_plan_invalid_epochs():
    for epochs in (0, 1.5):
        _both_raise(ValueError, lambda: EpochPlan([1], num_epochs=epochs),
                    lambda: ref_plan.EpochPlan([1], num_epochs=epochs))


def test_plan_reset():
    plan, theirs = _both_plans([0, 1, 2], num_epochs=1, shuffle=True, seed=3)
    first = list(plan)
    plan.reset()
    assert list(plan) == first
    assert list(theirs) == first


def test_plan_checkpoint_resume():
    plan = EpochPlan(list(range(7)), num_epochs=3, shuffle=True, seed=9)
    consumed = [next(plan) for _ in range(10)]
    state = plan.state_dict()
    rest = list(plan)
    plan2 = EpochPlan(list(range(7)), num_epochs=3, shuffle=True, seed=9)
    plan2.load_state_dict(state)
    assert list(plan2) == rest
    assert len(consumed) + len(rest) == 21
    # the states are the JAX package's and resume across packages both ways
    theirs = ref_plan.EpochPlan(list(range(7)), num_epochs=3, shuffle=True, seed=9)
    assert [next(theirs) for _ in range(10)] == consumed
    ref_state = theirs.state_dict()
    assert ref_state == state
    into_ref = ref_plan.EpochPlan(list(range(7)), num_epochs=3, shuffle=True, seed=9)
    into_ref.load_state_dict(state)
    assert list(into_ref) == rest
    into_port = EpochPlan(list(range(7)), num_epochs=3, shuffle=True, seed=9)
    into_port.load_state_dict(ref_state)
    assert list(into_port) == rest


def test_plan_checkpoint_wrong_size_rejected():
    # SHRINK is a real mismatch (consumed ordinals would dangle) ...
    plan = EpochPlan(list(range(6)))
    state = plan.state_dict()
    other = EpochPlan(list(range(5)))
    with pytest.raises(ValueError, match="items"):
        other.load_state_dict(state)
    _both_raise(ValueError, lambda: EpochPlan(list(range(5))).load_state_dict(state),
                lambda: ref_plan.EpochPlan(list(range(5))).load_state_dict(state),
                match="items")
    # ... but GROWTH is legal under mutable datasets: files appended after the save are
    # simply unconsumed on resume
    grown = EpochPlan(list(range(7)))
    grown.load_state_dict(state)
    ref_grown = ref_plan.EpochPlan(list(range(7)))
    ref_grown.load_state_dict(state)
    out = list(grown)
    assert sorted(out) == list(range(7))
    assert out == list(ref_grown)
