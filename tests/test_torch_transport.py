"""The port's tcp transport against the JAX package's, on the CPU: the JAX package's
transport tests under the same names (framing, link death with the in-flight ledger,
heartbeats, redial backoff, the process pool on tcp, the control frames, the fallback to
the pipe, the resume across a SIGKILL, the chaos net actions, the tenant frame
negotiation), frames byte-equal to the reference's, a hub of either package adopting a
child of the other, and the re-dispatch across a double redial delivered once."""
import json
import os
import pickle
import signal
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import (KnobWorker, PayloadBytesWorker,  # noqa: E402,F401
                                 _no_leaked_shm_segments, no_leaked_port_slabs,
                                 slow_square)
from petastorm_tpu_torch.errors import TransportFrameCorrupt, TransportLinkDown  # noqa: E402
from petastorm_tpu_torch.plan import EpochPlan  # noqa: E402
from petastorm_tpu_torch.recovery import RecoveryOptions  # noqa: E402
from petastorm_tpu_torch.transport import PipeTransport, Transport  # noqa: E402
from petastorm_tpu_torch.transport.framing import (K_OBJ, K_RAW,  # noqa: E402
                                                   pack_frame, take_frame)
from petastorm_tpu_torch.workers import ProcessExecutor, ThreadExecutor  # noqa: E402


def _fast_links(**overrides):
    """RecoveryOptions tuned for test-speed link detection and reconnect."""
    base = dict(link_heartbeat_s=0.1, link_miss_threshold=3,
                link_reconnect_s=5.0, link_connect_timeout_s=5.0,
                io_retry_backoff_s=0.01)
    base.update(overrides)
    return RecoveryOptions(**base)


# -- framing -----------------------------------------------------------------------------


def test_frame_roundtrip_and_crc_rejection():
    buf = bytearray(pack_frame(K_OBJ, b"hello") + pack_frame(K_RAW, b""))
    assert take_frame(buf) == (K_OBJ, b"hello")
    assert take_frame(buf) == (K_RAW, b"")
    assert take_frame(buf) is None  # empty: no partial-frame explosion

    # a flipped payload byte is caught by the crc trailer
    frame = bytearray(pack_frame(K_RAW, b"x" * 64))
    frame[10] ^= 0xFF
    with pytest.raises(TransportFrameCorrupt):
        take_frame(frame)

    # a flipped kind byte is caught too (the crc covers it)
    frame = bytearray(pack_frame(K_RAW, b"y" * 8))
    frame[2] ^= 0x01
    with pytest.raises(TransportFrameCorrupt):
        take_frame(frame)

    # partial frames keep the buffer intact and parse once completed
    whole = pack_frame(K_OBJ, b"z" * 100)
    buf = bytearray(whole[:20])
    assert take_frame(buf) is None
    buf += whole[20:]
    assert take_frame(buf) == (K_OBJ, b"z" * 100)


def _seeded_frames(seed=20):
    """(kind, payload, tenant) over every kind, seeded payload sizes and bytes."""
    from petastorm_tpu_torch.transport import framing

    rng = np.random.default_rng(seed)
    kinds = (framing.K_OBJ, framing.K_RAW, framing.K_HB, framing.K_HB_ACK,
             framing.K_HELLO, framing.K_HELLO_ACK)
    out = []
    for kind in kinds:
        for size in (0, 1, int(rng.integers(2, 300)), int(rng.integers(300, 70000))):
            payload = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
            for tenant in (None, "acme", "t" * 255):
                out.append((kind, payload, tenant))
    return out


def test_frames_are_byte_equal_to_the_reference_and_parse_across_packages():
    from petastorm_tpu.errors import TransportFrameCorrupt as RefCorrupt
    from petastorm_tpu.transport import framing as ref
    from petastorm_tpu_torch.transport import framing as port

    assert (port.MAGIC, port.HEADER_LEN, port.TRAILER_LEN, port.MAX_FRAME,
            port.K_TENANT_FLAG) == (ref.MAGIC, ref.HEADER_LEN, ref.TRAILER_LEN,
                                    ref.MAX_FRAME, ref.K_TENANT_FLAG)
    for kind, payload, tenant in _seeded_frames():
        frame = port.pack_frame(kind, payload, tenant=tenant)
        assert frame == ref.pack_frame(kind, payload, tenant=tenant)
        assert port.frame_size(bytearray(frame)) == ref.frame_size(bytearray(frame)) \
            == len(frame)
        # each package parses the other's frame (they are the same bytes)
        for take, split in ((port.take_frame, port.split_tenant),
                            (ref.take_frame, ref.split_tenant)):
            k, p = take(bytearray(frame))
            assert split(k, p) == (kind, payload, tenant)
        # a flipped byte past the header raises in both
        bad = bytearray(frame)
        bad[len(bad) - 1] ^= 0x5A
        with pytest.raises(TransportFrameCorrupt):
            port.take_frame(bytearray(bad))
        with pytest.raises(RefCorrupt):
            ref.take_frame(bytearray(bad))
    with pytest.raises(ValueError):
        port.pack_frame(port.K_OBJ, b"", tenant="t" * 256)


# -- an in-process loopback link (hub + parent + child endpoints) ------------------------


def _loopback_link(rec=None):
    from petastorm_tpu_torch.transport.tcp import TcpHub, connect_child_tcp

    rec = rec or _fast_links()
    hub = TcpHub(rec)
    parent = hub.create_session(0)
    child = connect_child_tcp(hub.address_for(0), bytes.fromhex(hub.token))
    assert parent.wait_connected(5.0)
    parent.mark_ready()
    child.mark_ready()
    return hub, parent, child


def test_link_death_reconnect_and_inflight_ledger():
    hub, parent, child = _loopback_link()
    try:
        parent.send({"n": 1})
        assert child.poll(2.0) and child.recv() == {"n": 1}
        child.send_bytes(b"R" * 10000)
        assert parent.poll(2.0) and parent.recv_bytes() == b"R" * 10000

        # dispatch an item, then kill the link out from under the child: the ledger
        # still holds the un-acked item through the reconnect
        parent.track(("item", 7))
        with child._cv:
            sock = child._sock
        sock.close()
        with pytest.raises(TransportLinkDown):
            # the child finds the death, redials, and surfaces the lost conversation;
            # an unreachable parent would raise EOFError
            child.poll(2.0)
        assert parent.reconnect(5.0), "hub never re-adopted the redial"
        assert parent.inflight() == ("item", 7)  # survives the link death
        # the feeder's contract: re-track before the re-dispatch (pins the
        # conversation to the fresh link generation)
        parent.track(("item", 7))
        parent.send(("item", 7))  # the re-dispatch
        assert child.poll(10.0) and child.recv() == ("item", 7)
        child.send(("ok", 7))
        assert parent.poll(10.0) and parent.recv() == ("ok", 7)
        parent.settle()
        assert parent.inflight() is None
    finally:
        child.close()
        parent.close()
        hub.close()


def test_heartbeat_detects_half_open_link():
    from petastorm_tpu_torch.transport import net_metrics

    hub, parent, child = _loopback_link()
    missed_before = net_metrics().hb_missed.value
    try:
        # one conversation so the parent's policing is armed (ready traffic)
        parent.send("ping")
        assert child.poll(2.0) and child.recv() == "ping"
        child.send("pong")
        assert parent.poll(2.0) and parent.recv() == "pong"
        # half-open: the child stops all transmission without closing; the heartbeat
        # detector trips within miss_threshold x heartbeat_s (0.3 s here, and slack)
        child._hb_stop.set()
        time.sleep(0.15)  # let a heartbeat possibly in flight drain
        deadline = time.monotonic() + 5.0
        with pytest.raises(TransportLinkDown, match="half-open"):
            while time.monotonic() < deadline:
                parent.poll(0.2)
        assert net_metrics().hb_missed.value > missed_before
    finally:
        child.close()
        parent.close()
        hub.close()


def test_reconnect_storm_backoff_bounds():
    """Redial against a dead hub: bounded attempts under the ceiling, then a clean give-up,
    never a tight connect storm or an over-stay."""
    from petastorm_tpu_torch.transport.tcp import TcpChildTransport, TcpHub

    rec = _fast_links(link_reconnect_s=1.0, link_connect_timeout_s=0.2,
                      io_retry_backoff_s=0.05)
    hub = TcpHub(rec)
    port = hub.port
    hub.close()  # nothing listens here any more

    child = TcpChildTransport("127.0.0.1", port, 0, token="00", recovery=rec)
    dials = []
    original = TcpChildTransport.dial

    def counting_dial(self):
        dials.append(time.monotonic())
        return original(self)

    TcpChildTransport.dial = counting_dial
    try:
        t0 = time.monotonic()
        assert child._redial() is False
        elapsed = time.monotonic() - t0
    finally:
        TcpChildTransport.dial = original
        child.close()
    # within the ceiling (and one connect timeout of slack for the attempt in flight),
    # at least two attempts, and the backoff keeps them far below a tight loop's count
    assert elapsed < 1.0 + 0.2 + 0.5, elapsed
    assert 2 <= len(dials) <= 32, dials


# -- executor-level: byte identity, control frames, fallback -----------------------------


@pytest.mark.parametrize("transport", [None, "tcp"])
def test_process_pool_byte_identity_vs_thread(transport):
    """The transport is a wire, not a transform: the thread pool's results pin the bytes;
    the pipe and tcp process pools deliver them byte-identical."""
    worker = PayloadBytesWorker()
    ex = ThreadExecutor(workers_count=2, results_queue_size=4)
    try:
        ex.start(worker, EpochPlan(list(range(16)), num_epochs=1))
        expected = sorted(ex.results())
    finally:
        ex.stop()
        ex.join()
    with ProcessExecutor(workers_count=2, results_queue_size=4,
                         results_timeout_s=120, transport=transport,
                         recovery=_fast_links()) as ex:
        ex.start(worker, EpochPlan(list(range(16)), num_epochs=1))
        got = sorted(ex.results())
        assert ex._transport_name == (transport or "pipe")
    assert got == expected


def test_tcp_child_sigkill_heals_by_respawn():
    """SIGKILL of a child on tcp: its socket closes, the feeder classifies a child death
    (the process is gone, so the reconnect wait ends unhealed), respawns over a fresh
    session and dispatches again: every result exactly once."""
    with ProcessExecutor(workers_count=2, results_queue_size=4,
                         results_timeout_s=120, transport="tcp",
                         recovery=_fast_links()) as ex:
        ex.start(slow_square, EpochPlan(list(range(20)), num_epochs=1))
        time.sleep(1.0)  # children connected and mid-task
        os.kill(ex._procs[0].pid, signal.SIGKILL)
        got = sorted(ex.results())
        handles = list(ex._procs)
    assert got == sorted(x * x for x in range(20))
    assert len(handles) == 3  # two originals + one respawned replacement
    assert all(p.poll() is not None for p in handles)  # every child reaped


def test_ctl_frames_ride_tcp_respawn_free():
    """``broadcast_io_knobs`` control frames ride the tcp wire: acked, and without a
    respawn (the retune reaches the running children over their live links)."""
    with ProcessExecutor(workers_count=2, results_queue_size=2,
                         results_timeout_s=120, transport="tcp",
                         recovery=_fast_links()) as ex:
        ex.start(KnobWorker(), EpochPlan(list(range(24)), num_epochs=1))
        it = ex.results()
        got = [next(it)]
        ex.broadcast_io_knobs({"readahead_depth": 7})
        got.extend(it)
        acks = ex.ctl_acks()
        procs = list(ex._procs)
    assert sorted(got) == list(range(24))
    applied = [a for a in acks.values() if a.get("readahead_depth") == 7]
    assert applied, "no child acked the live retune over tcp: %r" % acks
    assert len(procs) == 2, "a retune must not respawn children"


def test_tcp_setup_failure_falls_back_to_pipe(monkeypatch):
    """All links down at setup: the pool degrades to the local pipe wire as a classified
    degradation, with the same results, never a hang or a raise."""
    import petastorm_tpu_torch.transport.tcp as tcp_mod

    def boom(*_a, **_k):
        raise OSError("no sockets for you")

    monkeypatch.setattr(tcp_mod, "TcpHub", boom)
    with ProcessExecutor(workers_count=2, results_queue_size=4,
                         results_timeout_s=120, transport="tcp") as ex:
        ex.start(slow_square, EpochPlan(list(range(6)), num_epochs=1))
        got = sorted(ex.results())
        assert ex._transport_name == "pipe"
    assert got == sorted(x * x for x in range(6))


# -- reader-level: checkpoint-watermark resume across a SIGKILL --------------------------


@pytest.fixture(scope="module")
def transport_dataset(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq

    root = tmp_path_factory.mktemp("transport_ds")
    rng = np.random.default_rng(5)
    for i in range(8):
        base = i * 64
        table = pa.table({
            "id": np.arange(base, base + 64, dtype=np.int64),
            "x": rng.random(64),
        })
        pq.write_table(table, str(root / ("part_%03d.parquet" % i)),
                       row_group_size=64)
    return str(root)


def _leaked_total():
    from petastorm_tpu_torch.obs.metrics import default_registry

    return default_registry().counter("ptpu_lease_leaked_total").value


def test_sigkill_mid_epoch_with_checkpoint_watermark_resume(transport_dataset):
    """SIGKILL a child on tcp mid-epoch, checkpoint after the kill was absorbed, resume in
    a fresh reader: the two passes hold every planned row exactly once, and no lease
    leaks."""
    from petastorm_tpu_torch.reader import make_batch_reader

    leaked_before = _leaked_total()
    rec = dict(link_heartbeat_s=0.1, link_miss_threshold=3,
               link_reconnect_s=5.0, io_retry_backoff_s=0.01,
               worker_respawns=4)

    def open_reader():
        return make_batch_reader(
            "file://" + transport_dataset, num_epochs=1,
            shuffle_row_groups=False, reader_pool_type="process",
            workers_count=2, results_timeout_s=120, transport="tcp",
            recovery=rec)

    first_ids = []
    with open_reader() as reader:
        it = iter(reader)
        first_ids.extend(int(v) for v in np.asarray(next(it).id))
        # SIGKILL one child mid-epoch: its item goes out again on the respawned session
        os.kill(reader._executor._procs[0].pid, signal.SIGKILL)
        for _ in range(3):
            first_ids.extend(int(v) for v in np.asarray(next(it).id))
        state = reader.state_dict()

    with open_reader() as reader:
        reader.load_state_dict(state)
        rest_ids = [int(v) for b in reader for v in np.asarray(b.id)]

    combined = first_ids + rest_ids
    assert len(combined) == len(set(combined)), "a row was replayed"
    assert sorted(combined) == list(range(8 * 64)), "a row was lost"
    import gc

    gc.collect()
    assert _leaked_total() - leaked_before == 0


# -- transport interface hygiene ---------------------------------------------------------


def test_pipe_transport_is_a_noop_shim():
    """The base ledger hooks are no-ops and the pipe shim binds the connection's methods
    directly (the port's own ``recv_bytes`` aside: a one-copy ``readv``)."""
    from multiprocessing import Pipe

    a, b = Pipe()
    try:
        t = PipeTransport(a)
        assert t.send == a.send and t.recv == a.recv and t.poll == a.poll
        b.send_bytes(b"frame")
        assert t.recv_bytes() == b"frame"
        t.track("anything")
        assert t.inflight() is None  # no ledger on a pipe
        t.settle()
        assert isinstance(t, Transport)
        assert not t.ready
        t.mark_ready()
        assert t.ready
    finally:
        a.close()
        b.close()


def test_chaos_partition_sentinel_and_corrupt_frame():
    """The net actions at the plan's level: a partition opens a window returning DROPPED
    for matching sites only; corrupt_frame flips a byte."""
    from petastorm_tpu_torch.chaos import FaultPlan, FaultRule
    from petastorm_tpu_torch.chaos.plan import DROPPED

    plan = FaultPlan([
        FaultRule("transport.send", "net.partition", nth=2, times=1,
                  latency_s=0.3),
    ], seed=3)
    frame = pack_frame(K_RAW, b"abc")
    assert plan.hit("transport.send", payload=frame) == frame  # hit 1
    assert plan.hit("transport.send", payload=frame) is DROPPED  # fires
    assert plan.hit("transport.send", payload=frame) is DROPPED  # window
    assert plan.hit("transport.recv", payload=frame) == frame  # other site
    assert plan.stats()["dropped_frames"] >= 2
    time.sleep(0.35)
    assert plan.hit("transport.send", payload=frame) == frame  # closed

    plan = FaultPlan([
        FaultRule("transport.send", "net.corrupt_frame", nth=1, times=1),
    ], seed=3)
    corrupted = plan.hit("transport.send", payload=frame)
    assert corrupted != frame and len(corrupted) == len(frame)
    with pytest.raises(TransportFrameCorrupt):
        take_frame(bytearray(corrupted))


# -- tenant frame header re-negotiation across mid-epoch reconnects ----------------------


def _quiet_session(rec=None):
    """Hub + parent endpoint without mark_ready: no heartbeat thread, so a raw-socket
    'old peer' below never has to echo K_HB frames."""
    from petastorm_tpu_torch.transport.tcp import TcpHub

    hub = TcpHub(rec or _fast_links())
    parent = hub.create_session(0)
    return hub, parent


def _old_peer_dial(hub, session=0):
    """Dial like a peer without the tenant feature: a hello without ``features``. The hub
    answers with the historical empty ack."""
    from petastorm_tpu_torch.transport.framing import K_HELLO, K_HELLO_ACK

    sock = socket.create_connection(("127.0.0.1", hub.port), timeout=5.0)
    sock.settimeout(0.2)
    hello = json.dumps({"token": hub.token, "session": session})
    sock.sendall(pack_frame(K_HELLO, hello.encode("utf-8")))
    buf = bytearray()
    kind, ack = _raw_recv(sock, buf)
    assert kind == K_HELLO_ACK
    return sock, ack, buf


def _raw_recv(sock, buf, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while True:
        frame = take_frame(buf)
        if frame is not None:
            return frame
        try:
            data = sock.recv(1 << 12)
        except socket.timeout:
            data = b""
        if data:
            buf += data
        else:
            assert time.monotonic() < deadline, "raw peer recv timed out"


def _wait_adoptions(parent, n, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while parent._adopted < n:
        assert time.monotonic() < deadline, "hub never adopted the redial"
        time.sleep(0.01)


def _wire_billed(tenant):
    from petastorm_tpu_torch.obs.metrics import default_registry

    return default_registry().counter("ptpu_tenant_wire_bytes_total",
                                      tenant=tenant).value


def test_reconnect_downgrades_tenant_frames_for_old_peer():
    """A peer with the tenant feature first, then a mid-epoch reconnect from a peer
    without it: the hub negotiates down (empty ack), and every later frame is the legacy
    byte format (no K_TENANT_FLAG, no slug header)."""
    from petastorm_tpu_torch.transport.framing import K_TENANT_FLAG, split_tenant
    from petastorm_tpu_torch.transport.tcp import connect_child_tcp

    hub, parent = _quiet_session()
    child = connect_child_tcp(hub.address_for(0), bytes.fromhex(hub.token))
    try:
        assert parent.wait_connected(5.0)
        assert parent._tenant_frames and child._tenant_frames
        parent.set_tenant("acme")
        billed0 = _wire_billed("acme")
        parent.send({"epoch": 1, "n": 0})
        assert child.poll(2.0) and child.recv() == {"epoch": 1, "n": 0}
        # negotiated link: the frame carried the slug and the receiving side billed it
        assert child.peer_tenant == "acme"
        expected_tagged = pack_frame(
            K_OBJ, pickle.dumps({"epoch": 1, "n": 0}, protocol=4),
            tenant="acme")
        assert _wire_billed("acme") - billed0 == len(expected_tagged)

        # mid-epoch link death; a peer without the feature takes over the session
        child.close()
        sock, ack, buf = _old_peer_dial(hub)
        try:
            assert ack == b""  # the historical empty ack, byte-exact
            _wait_adoptions(parent, 2)
            assert parent._tenant_frames is False  # negotiated down
            billed1 = _wire_billed("acme")
            msg = {"epoch": 1, "n": 1}
            parent.send(msg)  # still set_tenant("acme"): must downgrade
            kind, payload = _raw_recv(sock, buf)
            assert kind == K_OBJ and not kind & K_TENANT_FLAG
            assert split_tenant(kind, payload) == (K_OBJ, payload, None)
            assert pickle.loads(payload) == msg
            # and billing stopped: untagged frames charge no tenant
            assert _wire_billed("acme") == billed1
        finally:
            sock.close()
    finally:
        child.close()
        parent.close()
        hub.close()


def test_reconnect_upgrades_tenant_frames_after_old_peer():
    """The reverse: a peer without the feature holds the session first (untagged,
    unbilled), dies mid-epoch, and a redial with the feature negotiates up: tagging and
    per-tenant wire billing resume on the fresh generation, no hub restart."""
    from petastorm_tpu_torch.transport.tcp import connect_child_tcp

    hub, parent = _quiet_session()
    parent.set_tenant("acme")
    sock, ack, buf = _old_peer_dial(hub)
    try:
        assert ack == b""
        assert parent.wait_connected(5.0)
        assert parent._tenant_frames is False
        billed0 = _wire_billed("acme")
        parent.send({"epoch": 2, "n": 0})
        kind, payload = _raw_recv(sock, buf)
        assert kind == K_OBJ and pickle.loads(payload) == {"epoch": 2, "n": 0}
        assert _wire_billed("acme") == billed0  # nothing billed

        sock.close()  # the old peer dies mid-epoch
        child = connect_child_tcp(hub.address_for(0), bytes.fromhex(hub.token))
        try:
            _wait_adoptions(parent, 2)
            assert parent._tenant_frames is True  # negotiated up
            assert child._tenant_frames is True  # the ack carried the features
            msg = {"epoch": 2, "n": 1}
            parent.send(msg)
            assert child.poll(2.0) and child.recv() == msg
            assert child.peer_tenant == "acme"
            expected = pack_frame(K_OBJ, pickle.dumps(msg, protocol=4),
                                  tenant="acme")
            assert _wire_billed("acme") - billed0 == len(expected)
        finally:
            child.close()
    finally:
        sock.close()
        parent.close()
        hub.close()


# -- wire compatibility with the JAX package ---------------------------------------------


def _ref_links():
    from petastorm_tpu.recovery import RecoveryOptions as RefRecovery

    return RefRecovery(link_heartbeat_s=0.1, link_miss_threshold=3, link_reconnect_s=5.0,
                       link_connect_timeout_s=5.0, io_retry_backoff_s=0.01)


def _exchange_both_ways(parent, child, parent_rtt, child_rtt):
    """Dict, numpy and raw messages both ways, the tenant slug both ways, and heartbeats
    echoed back to each side's observer within a few intervals."""
    assert parent._tenant_frames and child._tenant_frames  # the feature negotiated
    parent.set_tenant("acme")
    child.set_tenant("team-b")
    arr = np.random.default_rng(7).integers(0, 1 << 30, size=(64, 3), dtype=np.int64)
    parent.send({"op": "lease", "item": ("p.parquet", 3), "arr": arr})
    assert child.poll(5.0)
    got = child.recv()
    assert got["op"] == "lease" and got["item"] == ("p.parquet", 3)
    assert np.array_equal(got["arr"], arr) and got["arr"].dtype == arr.dtype
    assert child.peer_tenant == "acme"
    child.send({"op": "done", "cols": {"x": arr * 2}})
    child.send_bytes(arr.tobytes())
    assert parent.poll(5.0)
    back = parent.recv()
    assert np.array_equal(back["cols"]["x"], arr * 2)
    assert parent.poll(5.0) and parent.recv_bytes() == arr.tobytes()
    assert parent.peer_tenant == "team-b"
    # heartbeats flow: the child echoes the parent's, whose round trips the parent's
    # histogram counts (each package observes on its own registry)
    before = parent_rtt()
    deadline = time.monotonic() + 5.0
    while parent_rtt() < before + 2:
        assert time.monotonic() < deadline, "no heartbeat round trip observed"
        parent.poll(0.1)
        child.poll(0.05)
    del child_rtt  # the child observes none: it is the echo side in both packages


def test_a_reference_hub_adopts_a_port_child():
    from petastorm_tpu.transport import net_metrics as ref_net_metrics
    from petastorm_tpu.transport.tcp import TcpHub as RefHub
    from petastorm_tpu_torch.transport.tcp import connect_child_tcp

    hub = RefHub(_ref_links())
    parent = hub.create_session(3)
    child = connect_child_tcp(hub.address_for(3), bytes.fromhex(hub.token))
    try:
        assert parent.wait_connected(5.0)
        parent.mark_ready()
        child.mark_ready()
        _exchange_both_ways(parent, child, lambda: ref_net_metrics().rtt.count, None)
    finally:
        child.close()
        parent.close()
        hub.close()


def test_a_port_hub_adopts_a_reference_child():
    from petastorm_tpu.transport.tcp import connect_child_tcp as ref_connect
    from petastorm_tpu_torch.transport import net_metrics
    from petastorm_tpu_torch.transport.tcp import TcpHub

    hub = TcpHub(_fast_links())
    parent = hub.create_session(4)
    child = ref_connect(hub.address_for(4), bytes.fromhex(hub.token))
    try:
        assert parent.wait_connected(5.0)
        parent.mark_ready()
        child.mark_ready()
        _exchange_both_ways(parent, child, lambda: net_metrics().rtt.count, None)
    finally:
        child.close()
        parent.close()
        hub.close()


# -- the re-dispatch across a double redial ----------------------------------------------


def test_redispatch_across_a_double_redial_is_delivered_once():
    """The child's link dies twice mid-item (it redials each time); the parent follows
    the feeder's contract (track, send; on TransportLinkDown reconnect and send again).
    The item reaches each generation the child serves, and exactly one result comes
    back."""
    hub, parent, child = _loopback_link()
    received = []
    stop = threading.Event()

    def child_loop():
        while not stop.is_set():
            try:
                if not child.poll(0.1):
                    continue
                msg = child.recv()
                received.append((child._gen, msg))
                if len(received) <= 2:
                    # the link dies mid-item, before the answer: the child finds it on
                    # its next op, redials, and waits for the re-dispatch
                    with child._cv:
                        sock = child._sock
                    sock.close()
                    continue
                child.send(("ok", msg))
            except TransportLinkDown:
                continue
            except (EOFError, OSError):
                return

    t = threading.Thread(target=child_loop, daemon=True)
    t.start()
    results = []
    sends = 0
    try:
        item = ("item", 11)
        deadline = time.monotonic() + 30.0
        parent.track(item)
        parent.send(item)
        sends += 1
        while not results:
            assert time.monotonic() < deadline, (received, sends)
            try:
                if parent.poll(0.2):
                    results.append(parent.recv())
            except TransportLinkDown:
                assert parent.reconnect(10.0), "the child never redialed"
                parent.track(item)
                parent.send(item)
                sends += 1
        parent.settle()
        # nothing else arrives: the item was answered once
        end = time.monotonic() + 0.5
        while time.monotonic() < end:
            if parent.poll(0.1):
                results.append(parent.recv())
    finally:
        stop.set()
        t.join(timeout=5.0)
        child.close()
        parent.close()
        hub.close()
    assert results == [("ok", item)], results
    gens = [g for g, _ in received]
    assert [m for _, m in received] == [item] * 3
    assert gens == sorted(set(gens)) and len(gens) == 3  # one receipt a generation
    assert sends == 3 and parent.inflight() is None
