"""The port's device shuffle ring (petastorm_tpu_torch.ops.device_shuffle) on the
contract cases of the JAX package's DeviceShuffleBuffer (tests/test_ops.py), on CPU
tensors: exactly once, decorrelation beyond a batch, warm-up and a short tail, the
errors, seeded determinism and ``drain()`` a permutation. The draws are torch's, so the
orders cannot equal the JAX package's; each case also runs the reference on the same
stream and holds both to the same contract."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from petastorm_tpu.ops.device_shuffle import DeviceShuffleBuffer as RefBuffer  # noqa: E402
from petastorm_tpu_torch.ops.device_shuffle import DeviceShuffleBuffer  # noqa: E402


def _batch(module, lo, hi):
    if module == "ref":
        ids = jnp.arange(lo, hi, dtype=jnp.int32)
        return {"y": ids, "x": ids.astype(jnp.float32).reshape(-1, 1) * 2}
    ids = torch.arange(lo, hi, dtype=torch.int32)
    return {"y": ids, "x": ids.to(torch.float32).reshape(-1, 1) * 2}


def _push_stream(buf, module, n_batches, b=8, start=0):
    """Push batches of consecutive ids; returns everything the buffer emitted."""
    out = []
    for i in range(n_batches):
        got = buf.push(_batch(module, start + i * b, start + (i + 1) * b))
        if got is not None:
            out.append(got)
    return out


def _ids(emitted):
    return np.concatenate([np.asarray(o["y"]) for o in emitted])


BUFFERS = {"ref": RefBuffer, "port": DeviceShuffleBuffer}


@pytest.mark.parametrize("module", sorted(BUFFERS))
def test_exactly_once_and_rows_stay_aligned(module):
    buf = BUFFERS[module](24, seed=0)
    emitted = _push_stream(buf, module, 10, b=8)  # 80 rows through a 24-row ring
    assert len(emitted) == 7 and buf.capacity == 24
    emitted += list(buf.drain())
    assert sorted(_ids(emitted).tolist()) == list(range(80))
    for o in emitted:
        np.testing.assert_array_equal(np.asarray(o["x"]).ravel(), np.asarray(o["y"]) * 2)


@pytest.mark.parametrize("module", sorted(BUFFERS))
def test_decorrelates_beyond_a_batch(module):
    buf = BUFFERS[module](64, seed=3)
    emitted = _push_stream(buf, module, 40, b=8)
    emitted += list(buf.drain())
    ids = _ids(emitted)
    assert sorted(ids.tolist()) == list(range(320))
    assert ids.tolist() != list(range(320))
    displacement = np.abs(ids - np.arange(len(ids)))
    assert displacement.mean() > 8  # mixing beyond batch granularity


@pytest.mark.parametrize("module", sorted(BUFFERS))
def test_warmup_and_a_short_tail(module):
    """A stream smaller than the capacity: warm-up never completes, drain emits an exact
    permutation (with a short tail batch), and the ring is empty afterwards."""
    buf = BUFFERS[module](64, seed=1)
    assert _push_stream(buf, module, 3, b=8) == []
    assert buf.push(_batch(module, 24, 30)) is None
    out = list(buf.drain())
    assert sorted(_ids(out).tolist()) == list(range(30))
    assert [len(np.asarray(o["y"])) for o in out] == [8, 8, 8, 6]
    assert buf.filled == 0


@pytest.mark.parametrize("module", sorted(BUFFERS))
def test_short_warmup_batch_is_only_legal_last(module):
    buf = BUFFERS[module](64, seed=1)
    buf.push(_batch(module, 0, 8))
    buf.push(_batch(module, 8, 12))
    with pytest.raises(ValueError, match="FINAL push"):
        buf.push(_batch(module, 12, 20))


@pytest.mark.parametrize("module", sorted(BUFFERS))
def test_oversized_batches_raise(module):
    buf = BUFFERS[module](16, seed=0)
    buf.push(_batch(module, 0, 8))
    with pytest.raises(ValueError, match="exceed"):
        buf.push(_batch(module, 8, 20))  # during warm-up
    buf.push(_batch(module, 8, 16))
    with pytest.raises(ValueError, match="exceed"):
        buf.push(_batch(module, 16, 28))  # once warm


@pytest.mark.parametrize("module", sorted(BUFFERS))
def test_mismatched_columns_raise(module):
    buf = BUFFERS[module](8, seed=0)
    buf.push(_batch(module, 0, 8))
    with pytest.raises(ValueError, match="columns"):
        buf.push({"z": _batch(module, 0, 8)["y"]})


@pytest.mark.parametrize("module", sorted(BUFFERS))
def test_same_seed_same_slots_regardless_of_the_data(module):
    """Same seed → same slot stream: a ring over other data exchanges the same
    positions; another seed gives another order."""
    def run(offset, seed=7):
        buf = BUFFERS[module](16, seed=seed)
        emitted = _push_stream(buf, module, 6, b=8, start=offset)
        emitted += list(buf.drain())
        return _ids(emitted)

    a, b = run(0), run(1000)
    np.testing.assert_array_equal(a + 1000, b)
    assert run(0, seed=8).tolist() != a.tolist()


def test_capacity_rounds_up_to_a_batch_multiple_and_drain_is_a_permutation():
    buf = DeviceShuffleBuffer(20, seed=2)
    assert _push_stream(buf, "port", 3, b=8) == []
    assert buf.capacity == 24 and buf.filled == 24
    out = list(buf.drain(batch_rows=5))
    assert [len(o["y"]) for o in out] == [5, 5, 5, 5, 4]
    ids = _ids(out)
    assert sorted(ids.tolist()) == list(range(24)) and ids.tolist() != list(range(24))
    # refill after a drain: the ring starts over at the new first batch's size
    assert buf.push(_batch("port", 100, 104)) is None and buf.capacity == 20


def test_exchange_casts_into_the_ring_and_emits_fresh_tensors():
    """The incoming batch is cast to the ring's dtype (index_copy_), and the emitted rows
    are a fresh tensor (index_select), not a view of the ring."""
    buf = DeviceShuffleBuffer(8, seed=0)
    buf.push({"y": torch.arange(8, dtype=torch.int32)})
    out = buf.push({"y": torch.arange(8, 16, dtype=torch.int64)})
    assert out["y"].dtype == torch.int32 and out["y"].is_contiguous()
    assert out["y"].untyped_storage().data_ptr() != \
        buf._lanes[0][1].untyped_storage().data_ptr()
    rest = list(buf.drain())
    assert sorted(torch.cat([out["y"]] + [r["y"] for r in rest]).tolist()) == list(range(16))


def test_shardings_raise_naming_multi_card_placement():
    """``shardings=`` is taken (multi-card placement is ported): the callable is asked
    once a column, with the first batch's local tensor, and a column it leaves unplaced
    (None) is emitted as a plain tensor, as the reference's callable leaves its column
    on the default layout; the contract holds (the DTensor delivery is held in
    ``tests/test_torch_sharding.py``)."""
    asked = []

    def layout(name, arr):
        asked.append((name, tuple(arr.shape)))
        return None

    for module, cls in (("port", DeviceShuffleBuffer), ("ref", RefBuffer)):
        buf = cls(8, seed=1, shardings=layout)
        out = _push_stream(buf, module, 4)
        out += list(buf.drain())
        assert sorted(_ids(out).tolist()) == list(range(32))
        if module == "port":
            assert all(isinstance(o["y"], torch.Tensor) for o in out)
            assert sorted(asked) == [("x", (8, 1)), ("y", (8,))]
    with pytest.raises(ValueError, match="positive"):
        DeviceShuffleBuffer(0)


def test_exchange_runs_no_python_loop_over_rows(monkeypatch):
    """One exchange is one slot draw, and one gather and one scatter a group of columns
    of one dtype and row shape, whatever the batch's row count or column count."""
    calls = {"randperm": 0, "index_select": 0, "index_copy_": 0}
    real_randperm = torch.randperm

    def randperm(*a, **k):
        calls["randperm"] += 1
        return real_randperm(*a, **k)

    monkeypatch.setattr(torch, "randperm", randperm)
    def batch(lo):
        ids = torch.arange(lo, lo + 2048)
        return {"y": ids, "z": ids * 3, "f": ids.to(torch.float32),
                "g": ids.to(torch.float32) / 2}

    buf = DeviceShuffleBuffer(4096, seed=0)
    for i in range(2):
        buf.push(batch(i * 2048))
    real_select, real_copy = torch.Tensor.index_select, torch.Tensor.index_copy_

    def select(self, *a):
        calls["index_select"] += 1
        return real_select(self, *a)

    def copy(self, *a):
        calls["index_copy_"] += 1
        return real_copy(self, *a)

    monkeypatch.setattr(torch.Tensor, "index_select", select)
    monkeypatch.setattr(torch.Tensor, "index_copy_", copy)
    out = buf.push(batch(4096))
    assert list(out) == ["y", "z", "f", "g"] and len(out["y"]) == 2048
    assert torch.equal(out["z"], out["y"] * 3) and torch.equal(out["f"], out["y"].float())
    assert calls == {"randperm": 1, "index_select": 2, "index_copy_": 2}
    assert buf.nbytes == 4096 * (8 + 8 + 4 + 4)


@pytest.mark.gpu
def test_ring_lives_and_draws_on_the_card():
    """On a CUDA batch the ring, its generator and every emitted tensor stay on the
    card; the contract holds and a seed repeats its order there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())

    def run(seed):
        buf = DeviceShuffleBuffer(64, seed=seed)
        emitted = []
        for i in range(20):
            ids = torch.arange(i * 16, (i + 1) * 16, device=dev)
            out = buf.push({"y": ids, "x": ids.float()[:, None] * 2})
            if out is not None:
                emitted.append(out)
        assert buf._generator.device == dev
        assert all(ring.device == dev for _names, ring in buf._lanes)
        emitted += list(buf.drain())
        assert all(v.device == dev for o in emitted for v in o.values())
        for o in emitted:
            assert torch.equal(o["x"][:, 0], o["y"].float() * 2)
        return torch.cat([o["y"] for o in emitted]).cpu().tolist()

    a = run(5)
    assert sorted(a) == list(range(320)) and a != list(range(320))
    assert run(5) == a
