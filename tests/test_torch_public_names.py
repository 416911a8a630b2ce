"""Public names of the JAX package that the port took over after its modules were in
place, each held against the JAX package's on the same inputs: ``dict_to_record``,
``EmptyResultError``, ``pad_to_shape``, ``EpochPlan.seek_epoch`` and
``remaining_in_epoch``, ``ExecutorBase``, ``SHM_LEASE_KEY``, the codec base's on-device
contract, ``SlabRing(trace=)`` and ``ReadaheadPool.abandon_hung_threads``
(``tests/test_torch_imports.py`` checks that every public name has a counterpart)."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

import petastorm_tpu as ref  # noqa: E402
import petastorm_tpu_torch as port  # noqa: E402


def _schemas():
    schemas = []
    for pkg in ("petastorm_tpu", "petastorm_tpu_torch"):
        codecs = __import__(pkg + ".codecs", fromlist=["x"])
        uni = __import__(pkg + ".unischema", fromlist=["x"])
        schemas.append(uni.Unischema("Rec", [
            uni.UnischemaField("id", np.int32, (), codecs.ScalarCodec(
                __import__(pkg + ".types", fromlist=["x"]).IntegerType()), False),
            uni.UnischemaField("matrix", np.float32, (3, 4), codecs.NdarrayCodec(), False),
            uni.UnischemaField("name", np.str_, (), None, True)]))
    return schemas


def test_dict_to_record_equals_the_jax_packages():
    ref_schema, port_schema = _schemas()
    rng = np.random.RandomState(26)
    row = {"id": 7, "matrix": rng.standard_normal((3, 4)).astype(np.float32)}
    ours = port.dict_to_record(port_schema, dict(row))
    theirs = ref.dict_to_record(ref_schema, dict(row))
    assert ours == theirs
    assert ours["name"] is None  # inserted as an explicit null
    with pytest.raises(ValueError, match="not part of schema"):
        port.dict_to_record(port_schema, dict(row, extra=1))


def test_empty_result_error_is_a_framework_error():
    assert issubclass(port.EmptyResultError, port.PetastormTpuError)
    assert port.EmptyResultError.__doc__ == ref.EmptyResultError.__doc__


@pytest.mark.parametrize("shape", [(5, None), (None, 6), (4, 4), (9, 8)])
def test_pad_to_shape_equals_the_jax_packages(shape):
    from petastorm_tpu.utils import pad_to_shape as ref_pad
    from petastorm_tpu_torch.utils import pad_to_shape

    a = np.random.RandomState(3).randint(0, 9, (4, 4))
    out = pad_to_shape(a, shape, pad_value=-1)
    np.testing.assert_array_equal(out, ref_pad(a, shape, pad_value=-1))
    assert out is a if out.shape == a.shape else out.dtype == a.dtype


@pytest.mark.parametrize("shape,match", [((3,), "rank"), ((3, 4), "exceeds")])
def test_pad_to_shape_raises_as_the_jax_package(shape, match):
    from petastorm_tpu.utils import pad_to_shape as ref_pad
    from petastorm_tpu_torch.utils import pad_to_shape

    a = np.zeros((4, 4))
    for fn in (pad_to_shape, ref_pad):
        with pytest.raises(ValueError, match=match):
            fn(a, shape)


def test_plan_seek_epoch_and_remaining_in_epoch_equal_the_jax_packages():
    from petastorm_tpu.plan import EpochPlan as RefPlan
    from petastorm_tpu_torch.plan import EpochPlan

    items = list(range(7))
    ours = EpochPlan(items, num_epochs=4, with_epoch=True)
    theirs = RefPlan(items, num_epochs=4, with_epoch=True)
    for _ in range(3):
        assert next(ours) == next(theirs)
    assert ours.remaining_in_epoch() == theirs.remaining_in_epoch() == 4
    ours.seek_epoch(2)
    theirs.seek_epoch(2)
    assert ours.remaining_in_epoch() == theirs.remaining_in_epoch() == 7
    assert list(ours) == list(theirs)
    assert ours.exhausted() and theirs.exhausted()
    assert ours.remaining_in_epoch() == theirs.remaining_in_epoch()
    shuffled = EpochPlan(items, num_epochs=2, shuffle=True, seed=5)
    shuffled.seek_epoch(1)
    assert sorted(shuffled) == items  # the whole of epoch 1, in its permutation


def test_every_pool_is_an_executor_base_with_the_truncated_flag():
    from petastorm_tpu_torch import workers
    from petastorm_tpu_torch.plan import EpochPlan

    for cls in (workers.SyncExecutor, workers.ThreadExecutor, workers.ProcessExecutor):
        assert issubclass(cls, workers.ExecutorBase)
    assert workers.ExecutorBase.truncated is False
    with workers.SyncExecutor() as pool:
        pool.start(lambda item: item * 2, EpochPlan(list(range(5))))
        results = pool.results()
        assert [next(results), next(results)] == [0, 2]
        pool.stop()
        assert list(results) == []
        assert pool.truncated  # stopped mid-pass, not exhausted
    with workers.ThreadExecutor(workers_count=2) as pool:  # __exit__ stops and joins
        pool.start(lambda item: item, EpochPlan(list(range(6))))
        assert sorted(pool.results()) == list(range(6))
        assert not pool.truncated
    base = workers.ExecutorBase()
    recorder = object()
    base.set_provenance(recorder)
    assert base._prov is recorder
    with pytest.raises(NotImplementedError):
        base.start(None, None)


def test_shm_lease_key_is_the_generic_lease_key_under_the_jax_name():
    from petastorm_tpu.serializers import SHM_LEASE_KEY as REF_KEY
    from petastorm_tpu_torch.io.lease import LEASE_KEY
    from petastorm_tpu_torch.serializers import SHM_LEASE_KEY

    assert SHM_LEASE_KEY is LEASE_KEY
    assert SHM_LEASE_KEY == REF_KEY


def test_codec_base_refuses_the_on_device_path_as_the_jax_package():
    from petastorm_tpu.codecs import DataframeColumnCodec as RefBase
    from petastorm_tpu_torch.codecs import CompressedImageCodec, DataframeColumnCodec

    for base in (DataframeColumnCodec(), RefBase()):
        assert not base.device_decodable
        with pytest.raises(NotImplementedError, match="does not support on-device decode"):
            base.host_stage_decode(None, b"")
    with pytest.raises(NotImplementedError, match="does not support on-device decode"):
        DataframeColumnCodec().device_decode_batch(None, [], "cpu")
    assert CompressedImageCodec.host_stage_decode is not DataframeColumnCodec.host_stage_decode


def test_slab_ring_takes_its_tracer_at_construction():
    from petastorm_tpu_torch.parallel.shm_ring import SlabRing
    from petastorm_tpu_torch.trace import TraceRecorder

    tracer = TraceRecorder()
    ring = SlabRing(4096, 1, trace=tracer)
    try:
        held = ring.acquire()
        assert held is not None
        assert ring.acquire(timeout=0.05) is None  # starved: a wait span
        assert [e["name"] for e in tracer.events()] == ["shm.acquire_wait"]
        ring.release(held)
    finally:
        ring.close()


def test_readahead_abandon_hung_threads_detaches_a_hung_read():
    """A read hung past the exit drain's join: ``abandon_hung_threads`` takes its IO
    thread out of the interpreter's exit joins (as the JAX package's does), and the
    thread still ends once the read returns."""
    from concurrent.futures import thread as cf_thread

    from petastorm_tpu_torch.io.readahead import ReadaheadPool

    release = threading.Event()
    started = threading.Event()

    def hung_read(piece, columns):
        started.set()
        release.wait(10)
        return np.zeros(1)

    class Piece:
        path, row_group = "f.parquet", 0

    pool = ReadaheadPool(hung_read, depth=1, io_threads=1)
    try:
        assert pool.schedule([(Piece(), None)]) == 1
        assert started.wait(5)
        threads = [t for t in pool._pool._threads if t.is_alive()]
        assert threads and all(t in cf_thread._threads_queues for t in threads)
        pool.abandon_hung_threads()
        assert not any(t in cf_thread._threads_queues for t in threads)
    finally:
        release.set()
        pool.shutdown()
        pool.join_threads(5)
    assert not any(t.is_alive() for t in threads)
