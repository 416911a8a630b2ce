"""The port's wire serializers and slab ring (``petastorm_tpu_torch.serializers``,
``petastorm_tpu_torch.parallel.shm_ring``) against the JAX package's: each wire's round
trip on the same payloads as the reference's round trip (values, dtypes, writability),
malformed frames, the socket fallback of oversized payloads, a child killed mid-item,
the degradation to the socket wire, and the port's own slab-leak check.

The reference's shm serializers run over a ring of the port's (``ptpu_torch_shm_*``
segments, which its slab client attaches by name like any other): a ring of the JAX
package's own (``ptpu_shm_*``) would be blamed by the conftest leak fixture on tests
running meanwhile in other xdist workers (ROADMAP.md Queue 3 C)."""
import os
import signal
import time

import numpy as np
import pytest

from _torch_pool_helpers import (_no_leaked_shm_segments, no_leaked_port_slabs,  # noqa: F401
                                 payload_worker, port_slabs, slab_leak_check, slow_payload_worker)
from petastorm_tpu import serializers as ref
from petastorm_tpu_torch import serializers as port
from petastorm_tpu_torch.io.lease import LEASE_KEY
from petastorm_tpu_torch.parallel import shm_ring
from petastorm_tpu_torch.plan import EpochPlan
from petastorm_tpu_torch.workers import ProcessExecutor

WIRES = ["pickle", "arrow", "shm", "shm-arrow", "shm-view", "shm-arrow-view"]


def _payloads():
    """Every dtype family the read path produces, tensor, scalar and string columns,
    and shapes that push each framing through its fallbacks (complex: not Arrow; object:
    pickle only; a row list: the per-row path)."""
    rng = np.random.RandomState(7)
    ragged = np.empty(3, dtype=object)
    ragged[:] = [[1], [2, 3], [4, 5, 6]]
    return [
        (0, 0, {"f32": rng.standard_normal((6, 3)).astype(np.float32),
                "i64": np.arange(6),
                "img": rng.randint(0, 255, (6, 4, 4, 3)).astype(np.uint8),
                "flag": np.array([True, False] * 3)}),
        (1, 5, {"s": np.array(["a", "bb", "ccc"]),
                "b": np.array([b"x", b"\xff\x00", b"z"], dtype="S4"),
                "v": np.arange(3, dtype=np.float64)}),
        (2, 7, {"c64": (rng.standard_normal(4)
                        + 1j * rng.standard_normal(4)).astype(np.complex64)}),
        (3, 9, {"ragged": ragged}),
        (4, 1, [{"row": 0, "x": np.arange(4, dtype=np.int16)},
                {"row": 1, "x": np.arange(4, 8, dtype=np.int16)}]),
    ]


def _roundtrip(mod, wire, payload, slab_bytes=1 << 20, nslabs=2):
    """One payload through ``mod``'s wire without a pool: for the shm wires a child-side
    serializer writes into a parent-owned ring (the port's) and the parent side rebuilds
    it. Returns ``(kind, result, ring or None)``; the caller closes the ring."""
    if not wire.startswith("shm"):
        s = mod.make_serializer(wire)
        kind, frames = s.serialize(payload)
        return kind, s.deserialize(kind, [bytes(f) for f in frames]), None
    ring = shm_ring.SlabRing(slab_bytes, nslabs)
    parent, child = mod.make_serializer(wire), mod.make_serializer(wire)
    parent.bind_ring(ring)
    child.bind_slabs(ring.names, ring.slab_bytes)
    slab = ring.acquire()
    child.set_slab(slab)
    kind, frames = child.serialize(payload)
    if kind != mod.KIND_SHM:
        ring.release(slab)
    result = parent.deserialize(kind, frames)
    child.close()
    return kind, result, ring


def _columns(result):
    payload = result[2]
    if isinstance(payload, dict):
        return {k: v for k, v in payload.items() if k != LEASE_KEY}
    return list(payload)


def _assert_same(ours, theirs, want):
    assert ours[:2] == theirs[:2] == want[:2]
    a, b, w = _columns(ours), _columns(theirs), want[2]
    if isinstance(w, dict):
        assert set(a) == set(b) == set(w)
        items = [(a[k], b[k], w[k]) for k in w]
    else:
        assert len(a) == len(b) == len(w)
        items = [(x[k], y[k], z[k]) for x, y, z in zip(a, b, w) for k in z]
    for x, y, z in items:
        if isinstance(z, np.ndarray):
            # the Arrow wire narrows a bytes column to its longest value, as the
            # reference's does: the kind survives, and the port's dtype is the reference's
            assert x.dtype == y.dtype and x.dtype.kind == z.dtype.kind
            assert x.shape == y.shape == z.shape
            assert x.flags.writeable == y.flags.writeable
        if isinstance(z, np.ndarray) and z.dtype == object:
            for xe, ye, ze in zip(x, y, z):
                np.testing.assert_array_equal(xe, ze)
                np.testing.assert_array_equal(ye, ze)
        else:
            np.testing.assert_array_equal(x, z)
            np.testing.assert_array_equal(y, z)


def _release(result):
    payload = result[2]
    lease = payload.pop(LEASE_KEY, None) if isinstance(payload, dict) \
        else getattr(payload, "lease", None)
    if lease is not None:
        lease.release()


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("idx", range(5))
def test_wire_roundtrip_property_all_wires(wire, idx):
    """Each wire's round trip equals the reference wire's on the same payload: values,
    dtypes, shapes and writability (writable by default, read-only views on -view)."""
    payload = _payloads()[idx]
    k_ours, ours, ring = _roundtrip(port, wire, payload)
    k_ref, theirs, ref_ring = _roundtrip(ref, wire, payload)
    try:
        assert k_ours == k_ref
        _assert_same(ours, theirs, payload)
        if wire.endswith("-view"):
            assert (LEASE_KEY in ours[2]) if isinstance(ours[2], dict) \
                else ours[2].lease is not None
    finally:
        _release(ours)
        _release(theirs)
        for r in (ring, ref_ring):
            if r is not None:
                r.close()
    if ring is not None:
        assert not any(os.path.exists("/dev/shm/" + n) for n in ring.names)


def test_arrow_serializer_preserves_bytes_vs_str_dtypes():
    payload = (0, 0, {"b": np.array([b"ab", b"\xff\x01"], dtype="S4"),
                      "u": np.array(["xy", "z"]), "v": np.arange(2)})
    for mod in (port, ref):
        s = mod.ArrowTableSerializer()
        kind, frames = s.serialize(payload)
        assert kind == mod.KIND_ARROW
        _, _, cols = s.deserialize(kind, [bytes(f) for f in frames])
        assert cols["b"].dtype.kind == "S" and cols["b"][1] == b"\xff\x01"
        assert cols["u"].dtype.kind == "U" and cols["u"][0] == "xy"


def test_make_serializer_names_equal_the_references():
    for name in ["pickle", "arrow", "shm", "shm-pickle", "shm-arrow", "shm-view",
                 "shm-pickle-view", "shm-arrow-view"]:
        ours, theirs = port.make_serializer(name), ref.make_serializer(name)
        assert type(ours).__name__ == type(theirs).__name__
        assert getattr(ours, "inner_name", None) == getattr(theirs, "inner_name", None)
        assert getattr(ours, "writable", None) == getattr(theirs, "writable", None)
    with pytest.raises(ValueError):
        port.make_serializer("zmq")


def test_malformed_wire_frames_raise_cleanly():
    """Garbage on the wire raises an exception the pool hands the consumer; it never
    hangs or returns truncated data."""
    for s in (port.PickleSerializer(), port.ArrowTableSerializer()):
        kind, frames = s.serialize((0, 0, {"v": np.arange(4)}))
        bad = [b"\x00\xff garbage \x13\x37"] + [bytes(f) for f in frames[1:]]
        with pytest.raises(Exception):
            s.deserialize(kind, bad)
        with pytest.raises(Exception):
            s.deserialize(kind, [])
    s = port.make_serializer("shm")
    with pytest.raises(ValueError, match="no slab ring"):
        s.deserialize(port.KIND_SHM, [b"\x00\xff garbage descriptor"])
    ring = shm_ring.SlabRing(4096, 1)
    try:
        s.bind_ring(ring)
        blob = b"\x00\xff garbage descriptor"
        with pytest.raises(ValueError, match="crc") as info:
            s.deserialize(port.KIND_SHM, [blob])
        assert info.value.slab_released is False  # the caller still owns its grant
        with pytest.raises(ValueError, match="truncated"):
            s.deserialize(port.KIND_SHM, [b"\x01"])
    finally:
        ring.close()


def test_shm_writable_contract_default_and_view():
    """The default shm wire returns writable arrays and frees the slab at once; the view
    wire returns read-only views and holds the slab until the lease is released."""
    payload = (0, 0, {"img": np.zeros((4, 3, 3), np.uint8), "ids": np.arange(4)})
    kind, result, ring = _roundtrip(port, "shm", payload)
    try:
        assert kind == port.KIND_SHM
        assert result[2]["img"].flags.writeable
        result[2]["img"][0] = 7
        assert ring.stats()["shm_slabs_in_flight"] == 0
        assert ring.stats()["shm_items"] == 1
    finally:
        ring.close()
    kind, result, ring = _roundtrip(port, "shm-view", payload)
    try:
        lease = result[2].pop(LEASE_KEY)
        assert not result[2]["img"].flags.writeable
        with pytest.raises(ValueError):
            result[2]["img"][0] = 7
        assert ring.stats()["shm_slabs_in_flight"] == 1
        lease.release()
        assert ring.stats()["shm_slabs_in_flight"] == 0
        from petastorm_tpu_torch.errors import LeaseError

        with pytest.raises(LeaseError):
            lease.release()
        assert ring.stats()["shm_slabs_in_flight"] == 0
    finally:
        ring.close()


def test_shm_writable_object_columns_survive_slab_reuse():
    """Pickle 5 reattaches buffers inside object columns, where the writable walk cannot
    copy them: the writable wire backs them with owned copies, so overwriting the slab
    after delivery changes nothing."""
    ragged = np.empty(3, dtype=object)
    ragged[:] = [np.arange(3), np.arange(5, dtype=np.float32), np.arange(2) + 7]
    payload = (0, 0, {"ragged": ragged, "flat": np.arange(4)})
    for wire in ("shm", "shm-arrow"):
        kind, result, ring = _roundtrip(port, wire, payload)
        try:
            assert kind == port.KIND_SHM
            for i in range(len(ring)):
                ring.buffer(i)[:] = b"\xaa" * ring.slab_bytes
            for got, want in zip(result[2]["ragged"], ragged):
                np.testing.assert_array_equal(got, want)
                assert got.flags.writeable
        finally:
            ring.close()


def test_shm_view_unrecognized_result_shape_copies_out_before_release():
    ragged = np.empty(2, dtype=object)
    ragged[:] = [np.arange(3), np.arange(5, dtype=np.float32)]
    payload = {"ragged": ragged, "flat": np.arange(4)}  # a bare dict: no lease slot
    kind, result, ring = _roundtrip(port, "shm-view", payload)
    try:
        assert kind == port.KIND_SHM and LEASE_KEY not in result
        assert ring.stats()["shm_slabs_in_flight"] == 0
        for i in range(len(ring)):
            ring.buffer(i)[:] = b"\xaa" * ring.slab_bytes
        np.testing.assert_array_equal(result["flat"], np.arange(4))
        for got, want in zip(result["ragged"], ragged):
            np.testing.assert_array_equal(got, want)
    finally:
        ring.close()


@pytest.mark.parametrize("wire", ["shm", "shm-view"])
def test_shm_oversized_payload_falls_back_to_socket_frames(wire):
    """A payload larger than a slab takes the inner socket frames; the grant goes back
    to the ring unused, as in the reference."""
    payload = (0, 0, {"big": np.zeros((64 << 10,), np.uint8)})
    kind, result, ring = _roundtrip(port, wire, payload,
                                    slab_bytes=4 << 10)
    k_ref, theirs, ref_ring = _roundtrip(ref, wire, payload, slab_bytes=4 << 10)
    try:
        assert kind == k_ref == port.KIND_PICKLE
        _assert_same(result, theirs, payload)
        assert ring.stats()["shm_slabs_in_flight"] == 0
    finally:
        ring.close()
        ref_ring.close()


def test_shm_pool_oversized_fallback_end_to_end():
    """Slabs smaller than every payload: each item takes the socket, the results are
    unchanged and the fallbacks are counted."""
    with ProcessExecutor(workers_count=2, results_queue_size=4, serializer="shm",
                         results_timeout_s=120, shm_slab_bytes=16 << 10) as ex:
        ex.start(payload_worker, EpochPlan(list(range(8)), num_epochs=1))
        got = sorted(ex.results(), key=lambda r: r[1])
        stats = ex.wire_stats()
    assert [r[1] for r in got] == list(range(8))
    for _e, i, cols in got:
        np.testing.assert_array_equal(cols["x"], np.full((50_000,), i, np.int32))
        assert cols["x"].flags.writeable
    assert stats["shm_fallbacks"] >= 8 and stats["shm_items"] == 0


def test_shm_pool_child_killed_mid_item_reclaims_slab_and_unlinks():
    """A child SIGKILLed mid-item: its slab is reclaimed, the replacement attaches the
    same ring, every result arrives exactly once, and join() unlinks every slab."""
    with ProcessExecutor(workers_count=2, results_queue_size=4, serializer="shm",
                         results_timeout_s=120) as ex:
        ex.start(slow_payload_worker, EpochPlan(list(range(12)), num_epochs=1))
        time.sleep(1.0)
        os.kill(ex.child_pids()[0], signal.SIGKILL)
        got = sorted(ex.results(), key=lambda r: r[1])
        names = list(ex._ring.names)
        respawns = ex.pool_stats()["respawns"]
        ex.stop()
        ex.join()
    assert [r[1] for r in got] == list(range(12))
    for _e, i, cols in got:
        np.testing.assert_array_equal(cols["x"], np.full((50_000,), i, np.int32))
    assert respawns == 1
    assert not any(os.path.exists("/dev/shm/" + n) for n in names)


def test_shm_unavailable_degrades_to_socket_wire(monkeypatch):
    """Without working shared memory the pool keeps the socket behaviour: same results,
    a ``shm_unavailable`` marker."""
    monkeypatch.setattr(shm_ring, "_supported_cache", False)
    with ProcessExecutor(workers_count=2, results_queue_size=4, serializer="shm",
                         results_timeout_s=120) as ex:
        ex.start(payload_worker, EpochPlan(list(range(6)), num_epochs=1))
        got = sorted(ex.results(), key=lambda r: r[1])
        stats = ex.wire_stats()
    assert [r[1] for r in got] == list(range(6))
    for _e, i, cols in got:
        np.testing.assert_array_equal(cols["x"], np.full((50_000,), i, np.int32))
        assert cols["x"].flags.writeable
    assert stats == {"shm_unavailable": 1}


def test_ring_larger_than_dev_shm_degrades_to_socket_wire(monkeypatch):
    """A ring that /dev/shm cannot back is refused before any segment exists (a sparse
    segment would SIGBUS its writer): the pool takes the socket wire."""
    monkeypatch.setattr(shm_ring, "shm_free_bytes", lambda path="/dev/shm": 1 << 20)
    with pytest.raises(OSError, match="needs"):
        shm_ring.SlabRing(1 << 20, 4)
    failed = shm_ring.degradation_counts().get("shm_ring_create_failed", 0)
    with ProcessExecutor(workers_count=1, results_queue_size=2, serializer="shm-view",
                         results_timeout_s=120) as ex:
        ex.start(payload_worker, EpochPlan(list(range(3)), num_epochs=1))
        got = sorted(r[1] for r in ex.results())
        assert ex.wire_stats() == {"shm_unavailable": 1} and not ex.wire_views
    assert got == [0, 1, 2]
    assert shm_ring.degradation_counts()["shm_ring_create_failed"] == failed + 1


def test_jpeg_row_group_crosses_the_wire_once_and_decodes_equal(tmp_path):
    """A row group of JPEG staging payloads from the batched stage 1 pickles its shared
    coefficient buffers once (the rows are references into them), and the rebuilt rows
    decode to the same pixels as the originals."""
    cv2 = pytest.importorskip("cv2")
    from petastorm_tpu_torch.ops import jpeg, native

    if not native.native_available():
        pytest.skip("native stage 1 unavailable: %s" % native.native_error())
    rng = np.random.RandomState(0)
    blobs = [cv2.imencode(".jpg", rng.randint(0, 256, (32, 48, 3)).astype(np.uint8))[1]
             .tobytes() for _ in range(6)]
    rows = jpeg.entropy_decode_jpeg_batch(blobs)
    col = np.empty(len(rows), dtype=object)
    col[:] = rows
    payload = (0, 0, {"image": col, "id": np.arange(len(rows))})
    s = port.make_serializer("arrow")
    kind, frames = s.serialize(payload)
    shipped = sum(memoryview(f).nbytes for f in frames)
    coeff_bytes = sum(c.nbytes for c in rows[0].batch_ref[0])
    assert kind == port.KIND_PICKLE and shipped < coeff_bytes * 1.5
    back = s.deserialize(kind, [bytes(f) for f in frames])[2]["image"]
    assert all(r.batch_ref[0] is back[0].batch_ref[0] for r in back)
    got = jpeg.decode_jpeg_batch(list(back), device="cpu").numpy()
    want = jpeg.decode_jpeg_batch(rows, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_port_slab_leak_check_catches_a_ring_never_joined():
    """The port's slab-leak check (``_torch_pool_helpers``) fails on a slab this process
    left in /dev/shm, and names it; the slab is then cleaned up."""
    ring = None
    with pytest.raises(AssertionError, match="leaked port shared-memory slabs") as info:
        with slab_leak_check():
            ring = shm_ring.SlabRing(4096, 2)
    try:
        assert all(n in str(info.value) for n in ring.names)
        assert port_slabs() >= {"/dev/shm/" + n for n in ring.names}
        assert all(n.startswith("ptpu_torch_shm_%d_" % os.getpid()) for n in ring.names)
    finally:
        ring.close()
    assert not any(os.path.exists("/dev/shm/" + n) for n in ring.names)
