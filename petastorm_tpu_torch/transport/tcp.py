"""Framed tcp transport: the process pool's wire over loopback or LAN sockets.

Port of ``petastorm_tpu.transport.tcp``, wire-compatible with it (a JAX package hub
adopts a port child and the other way round). The parent (``ProcessExecutor``, or a
``DataService``) owns one :class:`TcpHub`: a listening socket and an acceptor thread that
routes each incoming connection to its *session* by the hello frame it opens with. The
parent talks to each peer through a :class:`TcpTransport`; the peer dials back with a
:class:`TcpChildTransport`. Every frame is length-prefixed and crc32-trailered
(:mod:`~petastorm_tpu_torch.transport.framing`); every socket op is bounded (reads tick
at :data:`TICK` and resume a partial frame from the endpoint's buffer, so a timeout never
loses the stream's sync).

The reconnect state machine::

    CONNECTED --error/EOF/corrupt frame/half-open--> DOWN
        parent: transport_link_down degradation, TransportLinkDown raised; the feeder
                calls reconnect(): a bounded wait for a generation NEWER than the one
                its conversation was lost on
        child:  redials the hub with jittered exponential backoff
                (base io_retry_backoff_s, ceiling link_reconnect_s)
    DOWN --child hello accepted--> CONNECTED (generation += 1)
        parent: transport_reconnected degradation, ptpu_net_reconnects_total; buffers
                of the dead generation are discarded: a result conversation is valid
                only on the generation its item went out on (the in-flight ledger pins
                it), so half a result is never stitched to a fresh link
    DOWN --no redial within link_reconnect_s--> DEAD
        parent: the feeder takes the child-death path (respawn budget, poison
                policy); child: exits (the parent is gone)

The re-dispatch reaches the generation the child serves. ``reconnect()`` never accepts
the socket a lost conversation went out on, even when this side has not seen it die
yet (the child redialed first): it waits for the adoption of a newer generation. If the
child redials again before the result, ``poll()`` raises once more for the conversation
and the feeder sends the item again on the newest link; frames of the older generations
are dropped with them, so the item is delivered once.

Half-open detection: both sides run a heartbeat thread (one frame a
``link_heartbeat_s``) and police the age of inbound traffic while they wait on the link;
``link_miss_threshold`` quiet intervals tear the link down. A peer that is busy (a child
mid-decode, a parent blocked on a full results queue) keeps sending through its
heartbeat thread, so silence means the link, not the workload, is gone.

Chaos: the ``transport.send`` and ``transport.recv`` sites fire on every frame of a
*ready* link with the raw frame as payload. ``net.slow`` delays a frame, ``net.reset``
becomes a real socket teardown, ``net.corrupt_frame`` flips a byte the receiver's crc
trailer catches. ``net.partition`` keeps reliable-transport semantics: heartbeat frames
are dropped (starving the peer's half-open detector) while app frames stall at the send
site until the window closes or the link is torn down under them.
"""
from __future__ import annotations

import json
import os
import pickle
import select
import socket
import struct
import threading
import time
import zlib
from collections import deque

from petastorm_tpu_torch import chaos as _chaos
from petastorm_tpu_torch.errors import TransportFrameCorrupt, TransportLinkDown
from petastorm_tpu_torch.transport import Transport, net_metrics
from petastorm_tpu_torch.transport.framing import (
    K_HB,
    K_HB_ACK,
    K_HELLO,
    K_HELLO_ACK,
    K_OBJ,
    K_RAW,
    pack_frame,
    split_tenant,
    take_frame,
)

#: socket read/accept tick — every blocking socket op is bounded by this and
#: re-checks deadlines/stop conditions between ticks
TICK = 0.05

_HB_STAMP = struct.Struct(">d")


def _jitter(attempt):
    """Deterministic backoff jitter factor in [0.5, 1.0): crc32 of
    (pid, attempt) — no ``random`` state, replayable like the chaos coins."""
    h = zlib.crc32(("%d|%d" % (os.getpid(), attempt)).encode("ascii"))
    return 0.5 + (h & 0xFFFF) / 131072.0


def _degradation(*args, **kwargs):
    from petastorm_tpu_torch.obs.log import degradation

    degradation(*args, **kwargs)


class _FramedLink(Transport):
    """Shared framed-socket machinery: buffered frame reads over bounded
    socket timeouts, heartbeat accounting, chaos hook sites, and the
    ``Connection``-surface API. Subclasses define what a link death means
    (:meth:`_link_down`) — the parent waits for re-adoption, the child
    redials."""

    #: chaos item key for this link's hook-site hits
    _site_key = None
    #: does this endpoint echo inbound HB frames as HB_ACK (the child does;
    #: the parent is the rtt observer)
    _ack_hb = False

    def __init__(self, recovery):
        self._rec = recovery
        self._cv = threading.Condition()
        self._sock = None
        self._gen = 0           # bumps on every (re)established socket
        self._closed = False
        self._rbuf = bytearray()
        self._app = deque()     # decoded (kind, payload) app frames
        self._send_lock = threading.Lock()
        self._last_rx = 0.0
        self._missed = 0
        self._warned_down = False
        #: half-open policing is armed per LINK GENERATION by the first
        #: inbound frame after this side is ready: the peer may mark ready
        #: later than we do (the pool registers children sequentially), and
        #: policing a link whose peer has not yet reached steady state reads
        #: its bootstrap pause as a half-open connection
        self._ready_rx = False
        self._hb_stop = threading.Event()
        self._hb_thread = None
        self._inflight = None
        self._inflight_gen = -1
        #: True once poll() raised for the tracked conversation (its generation was
        #: replaced); cleared by the next track(), so a further adoption before the
        #: result raises again
        self._inflight_lost = False
        #: the newest generation this side tore down: reconnect() waits past it
        self._dead_gen = 0
        #: per-tenant frame tagging: armed only after the hello
        #: exchange proved the peer understands K_TENANT_FLAG — an old peer
        #: must never receive a flagged kind byte it would read as garbage
        self._tenant_frames = False
        self._tx_tenant = None
        self._warned_downgrade = False
        self.peer_tenant = None
        #: lazy self-pipe for wakeable polls (created on first
        #: ``poll(wakeable=True)``): lets another thread return a poller
        #: control without a byte on the wire (``wake()``)
        self._wake_rx = None
        self._wake_tx = None

    # -- tenant tagging -----------------------------------------------------------------

    def set_tenant(self, label):
        """Pin the tenant slug outbound app frames are tagged with (the
        executor calls this with the reader's resolved tenant; None falls
        back to the thread/process tenant context at send time)."""
        self._tx_tenant = label

    def _frame_tenant(self):
        """The slug to tag the next outbound app frame with, or None. A
        tenant that WANTS tagging on an un-negotiated link degrades once
        (``tenant_frame_downgrade``) and ships untagged — old peers keep
        working, attribution loses the wire dimension only."""
        label = self._tx_tenant
        if label is None:
            from petastorm_tpu_torch.obs import tenant as _tenant_ctx

            label = _tenant_ctx.current_label()
        if label is None:
            return None
        if not self._tenant_frames:
            if not self._warned_downgrade:
                self._warned_downgrade = True
                _degradation(
                    "tenant_frame_downgrade",
                    "transport link %s peer did not negotiate tenant frame "
                    "headers — sending untagged (per-tenant wire accounting "
                    "is lost on this link)", self._site_key)
            return None
        return label

    # -- in-flight ledger ---------------------------------------------------------------

    def track(self, key):
        with self._cv:
            self._inflight = key
            self._inflight_gen = self._gen
            self._inflight_lost = False

    def settle(self):
        with self._cv:
            self._inflight = None

    def inflight(self):
        with self._cv:
            return self._inflight

    # -- lifecycle ----------------------------------------------------------------------

    def _install(self, sock, first, leftover=b""):
        """Adopt ``sock`` as the live link (caller-side naming differs:
        parent adoption vs child redial). Buffers from the dead generation
        are discarded — partial frames, un-consumed results, everything.
        ``leftover`` carries bytes the hello/ack exchange read PAST its own
        frame (the peer's first frames can coalesce with it into one recv)
        — they belong to the fresh generation and seed its buffer."""
        sock.settimeout(TICK)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        with self._cv:
            if self._closed:
                try:
                    sock.close()
                except OSError:
                    pass
                return False
            old, self._sock = self._sock, sock
            self._gen += 1
            self._rbuf.clear()
            self._app.clear()
            if leftover:
                self._rbuf += leftover
            self._last_rx = time.monotonic()
            self._missed = 0
            self._warned_down = False
            self._ready_rx = False  # re-armed by the fresh link's first frame
            self._cv.notify_all()
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        m = net_metrics()
        m.connects.inc()
        if not first:
            m.reconnects.inc()
        return True

    def mark_ready(self):
        super().mark_ready()
        if self._hb_thread is None:
            self._hb_thread = threading.Thread(
                target=self._hb_loop, daemon=True,
                name="ptpu-net-hb-%s" % (self._site_key or "link"))
            self._hb_thread.start()

    def close(self):
        with self._cv:
            self._closed = True
            sock, self._sock = self._sock, None
            wake_rx, self._wake_rx = self._wake_rx, None
            wake_tx, self._wake_tx = self._wake_tx, None
            self._cv.notify_all()
        self._hb_stop.set()
        for s in (sock, wake_rx, wake_tx):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass

    # -- heartbeats ---------------------------------------------------------------------

    def _hb_loop(self):
        """Transport heartbeat sender: proves link liveness to the peer even
        while this side's main thread is busy (a child mid-decode, a parent
        blocked on a full results queue). Quiet on failure — it closes the
        socket so the main thread's next op fails fast, never redials or
        raises from this thread."""
        while not self._hb_stop.wait(self._rec.link_heartbeat_s):
            if not self.ready:
                continue
            with self._cv:
                sock = self._sock
            if sock is None:
                continue
            self._send_quiet(pack_frame(
                K_HB, _HB_STAMP.pack(time.monotonic())), sock)

    def _send_quiet(self, frame, sock):
        """Best-effort frame send for the heartbeat thread: chaos applies
        (a partition must starve the peer's half-open detector for real),
        errors close the socket and return."""
        try:
            frame = self._chaos_frame("transport.send", frame)
            if frame is None:
                return
            with self._send_lock:  # frames must never interleave mid-wire
                self._sendall(sock, frame)
            m = net_metrics()
            m.frames_tx.inc()
            m.bytes_tx.inc(len(frame))
        except (OSError, TransportLinkDown):
            self._quiet_close(sock)

    def _quiet_close(self, sock):
        with self._cv:
            if self._sock is sock:
                self._sock = None
        try:
            sock.close()
        except OSError:
            pass

    # -- chaos --------------------------------------------------------------------------

    def _chaos_frame(self, site, frame):
        """Run one frame through the chaos hook site; returns the (possibly
        corrupted) frame, None when a partition dropped it, and converts an
        injected reset into a real link teardown."""
        if _chaos.ACTIVE is None or not self.ready:
            return frame
        from petastorm_tpu_torch.chaos.plan import DROPPED

        out = _chaos.ACTIVE.hit(site, key=self._site_key, payload=frame)
        if out is DROPPED:
            return None
        return out

    # -- send path ----------------------------------------------------------------------

    def send(self, obj):
        self._send_wire(pack_frame(K_OBJ, pickle.dumps(obj, protocol=4),
                                   tenant=self._frame_tenant()))

    def send_bytes(self, data):
        self._send_wire(pack_frame(K_RAW, data, tenant=self._frame_tenant()))

    def _send_wire(self, frame):
        with self._cv:
            sock = self._sock
            gen = self._gen
        while True:
            try:
                out = self._chaos_frame("transport.send", frame)
            except ConnectionResetError as e:  # chaos net.reset: REAL teardown
                self._link_down(e, sock=sock)
            if out is not None:
                frame = out
                break
            # net.partition: the frame is stalled IN the network, never
            # silently lost — reliable-transport semantics (real TCP
            # retransmits through a partition, so data is delayed or the
            # connection dies; a sender that believes "sent" about a lost
            # frame would deadlock the conversation). The peer's half-open
            # detector may tear the link down mid-stall: this conversation
            # then aborts and the in-flight ledger re-dispatches it.
            time.sleep(TICK)
            with self._cv:
                replaced = self._sock is not sock
            if replaced or self._closed:
                self._link_down(TransportLinkDown(
                    "transport link %s torn down during a partition stall"
                    % self._site_key), sock=sock)
        if sock is None:
            self._link_down(TransportLinkDown(
                "transport link %s is down" % self._site_key))
        try:
            with self._send_lock:  # frames must never interleave mid-wire
                self._sendall(sock, frame)
        except OSError as e:
            self._link_down(e, sock=sock)
        with self._cv:
            if self._inflight is not None and self._sock is sock:
                # re-pin the conversation to the generation the frame really
                # went out on: track() may have pinned an older generation if
                # an adoption slipped in between track and send — leaving the
                # stale pin would make poll() declare this (successfully
                # dispatched) conversation replaced and re-dispatch a
                # DUPLICATE onto the same live link
                self._inflight_gen = gen
        m = net_metrics()
        m.frames_tx.inc()
        m.bytes_tx.inc(len(frame))

    def _sendall(self, sock, data):
        """sendall over a tick-bounded socket: short ticks keep the shared
        socket timeout uniform; the overall send is bounded by the reconnect
        ceiling (a peer that cannot drain a frame for that long is a dead
        link, not backpressure — app backpressure lives in the results
        queue, not in TCP buffers)."""
        deadline = time.monotonic() + max(5.0, self._rec.link_reconnect_s)
        view = memoryview(data)
        while view:
            try:
                n = sock.send(view)
            except socket.timeout:
                if time.monotonic() > deadline:
                    raise OSError(
                        "transport send stalled past the %.0fs link ceiling"
                        % max(5.0, self._rec.link_reconnect_s)) from None
                continue
            view = view[n:]

    # -- receive path -------------------------------------------------------------------

    def poll(self, timeout=0.0, wakeable=False):
        """True when a complete app frame is buffered; reads/demultiplexes
        inbound traffic (heartbeats, acks) meanwhile. Raises
        :class:`TransportLinkDown` on any link fault, including a link that
        was replaced mid-conversation (the in-flight ledger pins the dispatch
        generation) and a heartbeat-detected half-open link.

        The wait honors ``timeout`` precisely (readability is select-gated,
        so an idle link never rounds the wait up to the socket tick). With
        ``wakeable=True`` another thread's :meth:`wake` interrupts the wait
        and poll returns False early — the service's serve loop uses this to
        flush a freshly decoded item the moment it lands instead of riding
        out the poll tick (delivery latency would otherwise quantize to it,
        and the trainer-side provenance fold would charge the slack to
        ``svc.lease_wait``)."""
        deadline = time.monotonic() + max(0.0, timeout)
        if wakeable:
            self._ensure_wake()
        while True:
            with self._cv:
                if self._inflight is not None and not self._inflight_lost \
                        and self._inflight_gen != self._gen:
                    # the peer reconnected while a result was owed on the OLD
                    # socket: that conversation is unfinishable. Raise WITHOUT
                    # tearing the fresh link down: the pin stays on the lost
                    # generation, so the feeder's reconnect() finds the fresh one
                    # live at once and its re-track pins the re-dispatch there
                    self._inflight_lost = True
                    raise TransportLinkDown(
                        "link %s replaced mid-conversation (peer reconnected);"
                        " re-dispatching its un-acked item" % self._site_key)
                if self._app:
                    return True
                sock = self._sock
                wake_rx = self._wake_rx if wakeable else None
            if sock is None:
                self._link_down(TransportLinkDown(
                    "transport link %s is down" % self._site_key))
            if self._rbuf:
                # leftover bytes from the hello/ack exchange or a previous
                # partial parse may already complete a frame without a read
                self._drain_frames(sock)
                with self._cv:
                    if self._app:
                        return True
            remaining = deadline - time.monotonic()
            rlist = [sock] if wake_rx is None else [sock, wake_rx]
            try:
                ready = select.select(rlist, (), (),
                                      max(0.0, min(remaining, TICK)))[0]
            except (OSError, ValueError):
                # fd died under us (close/generation swap): the recv path
                # owns the canonical link-death handling
                self._read_once(sock)
                ready = ()
            if wake_rx is not None and wake_rx in ready:
                self._drain_wake(wake_rx)
                return False  # woken: the caller's queue check is the point
            if sock in ready:
                self._read_once(sock)
                with self._cv:
                    if self._app:
                        return True
            else:
                self._police_staleness(sock)
            if time.monotonic() >= deadline:
                return False

    def _ensure_wake(self):
        with self._cv:
            if self._wake_rx is None and not self._closed:
                rx, tx = socket.socketpair()
                rx.setblocking(False)
                tx.setblocking(False)
                self._wake_rx, self._wake_tx = rx, tx

    @staticmethod
    def _drain_wake(wake_rx):
        try:
            while wake_rx.recv(64):
                pass
        except (BlockingIOError, OSError):
            pass

    def wake(self):
        """Nudge a thread blocked in ``poll(wakeable=True)`` so it re-checks
        caller state now. No-op until the first wakeable poll armed the
        self-pipe; never blocks (a pending nudge already buffered is
        enough)."""
        with self._cv:
            tx = self._wake_tx
        if tx is None:
            return
        try:
            tx.send(b"\0")
        except (BlockingIOError, OSError):
            pass

    def _read_once(self, sock):
        if self._rbuf:
            # leftover bytes seeded by the hello/ack exchange (or left by a
            # previous partial parse): frames may already be complete
            self._drain_frames(sock)
            with self._cv:
                if self._app:
                    return
        try:
            data = sock.recv(1 << 16)
        except socket.timeout:
            self._police_staleness(sock)
            return
        except OSError as e:
            self._link_down(e, sock=sock)
        if not data:
            self._link_down(TransportLinkDown(
                "peer closed transport link %s" % self._site_key), sock=sock)
        with self._cv:
            if self._sock is not sock:
                return  # replaced mid-read: these bytes died with their link
            self._last_rx = time.monotonic()
            self._missed = 0
            if self.ready:
                self._ready_rx = True  # peer reached steady state: police on
            self._rbuf += data  # under the lock: adoption clears this buffer
        net_metrics().bytes_rx.inc(len(data))
        self._drain_frames(sock)

    def _drain_frames(self, sock):
        from petastorm_tpu_torch.transport.framing import frame_size

        while True:
            try:
                total = frame_size(self._rbuf)
            except TransportFrameCorrupt as e:
                self._frame_corrupt(e, sock)
            if total is None:
                return
            raw = bytes(self._rbuf[:total])
            del self._rbuf[:total]
            try:
                out = self._chaos_frame("transport.recv", raw)
            except ConnectionResetError as e:
                self._link_down(e, sock=sock)
            if out is None:
                # net.partition at the recv site: only heartbeat frames are
                # droppable (starving the local staleness detector — the
                # observable inbound effect of a partition); app frames are
                # reliable-transport data a real partition would have
                # retransmitted, so they pass through
                if len(raw) > 2 and raw[2] in (K_HB, K_HB_ACK):
                    continue
            else:
                raw = out
            try:
                kind, payload = take_frame(bytearray(raw))
                kind, payload, frame_tenant = split_tenant(kind, payload)
            except TransportFrameCorrupt as e:
                self._frame_corrupt(e, sock)
            net_metrics().frames_rx.inc()
            if frame_tenant is not None:
                # rx-side only: both endpoints of an in-process test share the
                # default registry, so a tx-side twin would double-count
                self.peer_tenant = frame_tenant
                from petastorm_tpu_torch.obs import tenant as _tenant_ctx

                _tenant_ctx.charge("wire_bytes", len(raw), label=frame_tenant)
            self._handle_frame(kind, payload, sock)

    def _handle_frame(self, kind, payload, sock):
        if kind == K_HB:
            if self._ack_hb:
                self._send_quiet(pack_frame(K_HB_ACK, payload), sock)
            return
        if kind == K_HB_ACK:
            try:
                (stamp,) = _HB_STAMP.unpack(payload)
            except struct.error:
                return
            net_metrics().rtt.observe(max(0.0, time.monotonic() - stamp))
            return
        with self._cv:
            if self._sock is sock:  # frames die with a replaced generation
                self._app.append((kind, payload))

    def _frame_corrupt(self, exc, sock):
        net_metrics().frames_corrupt.inc()
        _degradation(
            "transport_frame_corrupt",
            "transport link %s received a corrupt frame (%s); tearing the "
            "link down — the in-flight item re-dispatches, the corrupt "
            "payload is never delivered", self._site_key, exc, once=False)
        self._link_down(exc, sock=sock)

    def _police_staleness(self, sock):
        """Half-open detection: count quiet heartbeat intervals while this
        side is WAITING on the link; at the miss threshold the link dies.
        Armed only once the peer has demonstrably reached steady state on
        THIS link generation (``_ready_rx``) — a peer still bootstrapping
        its other links is quiet, not gone."""
        if not self.ready or not self._ready_rx:
            return
        hb = self._rec.link_heartbeat_s
        with self._cv:
            if self._sock is not sock:
                return
            age = time.monotonic() - self._last_rx
            missed = int(age / hb)
            if missed > self._missed:
                net_metrics().hb_missed.inc(missed - self._missed)
                self._missed = missed
            tripped = missed >= self._rec.link_miss_threshold
        if tripped:
            self._link_down(TransportLinkDown(
                "half-open link %s: no traffic for %.1fs (%d heartbeat "
                "intervals)" % (self._site_key, age, missed)), sock=sock)

    def _next_app_frame(self):
        while True:
            with self._cv:
                if self._app:
                    return self._app.popleft()
            self.poll(TICK)

    def recv(self):
        kind, payload = self._next_app_frame()
        if kind != K_OBJ:
            self._link_down(TransportFrameCorrupt(
                "expected an object frame on link %s, got kind %d"
                % (self._site_key, kind)))
        return pickle.loads(payload)

    def recv_bytes(self):
        kind, payload = self._next_app_frame()
        if kind != K_RAW:
            self._link_down(TransportFrameCorrupt(
                "expected a raw frame on link %s, got kind %d"
                % (self._site_key, kind)))
        return payload

    # -- link death ---------------------------------------------------------------------

    def _tear_down(self, exc, sock=None):
        """Common half of :meth:`_link_down`: close the dead socket, warn
        once per connection. ``sock`` pins the failure to the generation it
        happened on — an error from an already-replaced socket must never
        tear down the fresh link that superseded it. Returns the exception
        to (re-)raise."""
        with self._cv:
            if sock is not None and self._sock is not None \
                    and self._sock is not sock:
                stale = True  # the failure belongs to a dead generation
            else:
                stale = False
                sock, self._sock = self._sock, None
                self._dead_gen = self._gen
            warned, self._warned_down = self._warned_down, True
        if sock is not None and not stale:
            try:
                sock.close()
            except OSError:
                pass
        if not warned and not stale:
            _degradation(
                "transport_link_down",
                "transport link %s died (%s); un-acked items re-dispatch "
                "through the poison/quarantine path", self._site_key, exc,
                once=False)
        if isinstance(exc, TransportLinkDown):
            return exc
        err = TransportLinkDown(
            "transport link %s died: %s" % (self._site_key, exc))
        err.__cause__ = exc
        return err

    def _link_down(self, exc, sock=None):
        raise NotImplementedError


class TcpTransport(_FramedLink):
    """Parent (driver) side of one child's link. The hub adopts reconnected
    sockets into it; the driver recovers from a :class:`TransportLinkDown`
    by calling :meth:`reconnect` — a bounded wait for that adoption — and
    re-dispatching the ledgered in-flight item."""

    def __init__(self, session, recovery):
        super().__init__(recovery)
        self.session = session
        self._site_key = "session=%d" % session
        self._adopted = 0

    def adopt(self, sock, leftover=b""):
        """Called by the hub's acceptor thread with a hello-verified socket
        (initial connect or a redial)."""
        first = self._adopted == 0
        if self._install(sock, first, leftover=leftover):
            self._adopted += 1
            if not first:
                _degradation(
                    "transport_reconnected",
                    "transport link %s re-established (adoption %d); "
                    "re-dispatching its un-acked items", self._site_key,
                    self._adopted, once=False)

    def wait_connected(self, timeout):
        """Bounded wait for the first adoption (pool start / respawn)."""
        with self._cv:
            return self._cv.wait_for(
                lambda: self._sock is not None or self._closed, timeout) \
                and self._sock is not None

    def reconnect(self, timeout=None):
        """Bounded wait for the child to redial after a link death; True when a
        generation newer than the one the conversation was lost on is live (the
        caller re-tracks and re-dispatches on it). The lost generation is the tracked
        item's, or the newest one this side tore down: the socket a lost conversation
        went out on is never taken for a healed link, even before this side saw it
        die (a frame sent there would vanish with it)."""
        if timeout is None:
            timeout = self._rec.link_reconnect_s
        with self._cv:
            floor = self._dead_gen
            if self._inflight is not None:
                floor = max(floor, self._inflight_gen)

            def healed():
                return self._sock is not None and self._gen > floor

            ok = self._cv.wait_for(lambda: healed() or self._closed, timeout)
            return bool(ok and healed() and not self._closed)

    def _link_down(self, exc, sock=None):
        raise self._tear_down(exc, sock)


class TcpChildTransport(_FramedLink):
    """Child side: dials the hub, redials with jittered exponential backoff
    on any link death (base ``io_retry_backoff_s``, per-sleep cap
    ``io_retry_max_backoff_s``, overall ceiling ``link_reconnect_s``). A
    successful redial surfaces as :class:`TransportLinkDown` — the child's
    work loop discards the broken conversation and waits for the parent's
    re-dispatch; an exhausted ceiling surfaces as ``EOFError`` (the parent is
    gone; the child exits)."""

    _ack_hb = True  # the child echoes heartbeats; the parent observes rtt

    def __init__(self, host, port, session, token, recovery):
        super().__init__(recovery)
        self._host = host
        self._port = port
        self.session = session
        self._token = token
        self._site_key = "session=%d" % session
        self._dialed = 0

    def dial(self):
        """One connect + hello/ack exchange, bounded by
        ``link_connect_timeout_s`` end to end. Raises ``OSError`` on failure
        (the caller owns retry policy)."""
        timeout = self._rec.link_connect_timeout_s
        deadline = time.monotonic() + timeout
        sock = socket.create_connection((self._host, self._port),
                                        timeout=timeout)
        try:
            sock.settimeout(TICK)
            from petastorm_tpu_torch.obs import tenant as _tenant_ctx

            hello = json.dumps({"token": self._token, "session": self.session,
                                "attempt": self._dialed,
                                "features": ["tenant"],
                                "tenant": _tenant_ctx.current_label(),
                                }).encode("utf-8")
            self._sendall(sock, pack_frame(K_HELLO, hello))
            buf = bytearray()
            while True:
                frame = take_frame(buf)
                if frame is not None:
                    break
                try:
                    data = sock.recv(1 << 12)
                except socket.timeout:
                    data = b""
                if data:
                    buf += data
                elif time.monotonic() > deadline:
                    raise OSError("transport hello ack did not arrive within "
                                  "%.0fs" % timeout)
            kind, ack_payload = frame
            if kind != K_HELLO_ACK:
                raise OSError("unexpected transport hello response kind %d"
                              % kind)
            # version negotiation: a new hub answers with a JSON
            # feature list; an old hub's empty ack simply negotiates nothing
            # (children without the feature never parse the ack payload, so the
            # asymmetric upgrade is safe in both directions)
            features = ()
            if ack_payload:
                try:
                    features = json.loads(
                        ack_payload.decode("utf-8")).get("features") or ()
                except (ValueError, AttributeError):
                    features = ()
            self._tenant_frames = "tenant" in features
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        self._install(sock, self._dialed == 0, leftover=bytes(buf))
        self._dialed += 1

    def _redial(self):
        """Jittered-backoff redial under the reconnect ceiling. The first
        attempt is immediate — the common case is a blipped link with a
        healthy hub."""
        rec = self._rec
        deadline = time.monotonic() + rec.link_reconnect_s
        attempt = 0
        while not self._closed:
            try:
                self.dial()
                return True
            except OSError:
                pass
            delay = min(rec.io_retry_max_backoff_s,
                        rec.io_retry_backoff_s * (2 ** attempt)) \
                * _jitter(attempt)
            attempt += 1
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            time.sleep(min(delay, remaining))
        return False

    def _link_down(self, exc, sock=None):
        err = self._tear_down(exc, sock)
        if self._closed:
            raise EOFError("transport closed") from err
        with self._cv:
            live = self._sock is not None  # a stale-generation failure
        if live or self._redial():
            # the conversation is lost but the LINK is back: the work loop
            # discards its in-flight state and awaits the re-dispatch
            raise err
        raise EOFError(
            "transport link %s could not be re-established within %.0fs — "
            "parent gone" % (self._site_key, self._rec.link_reconnect_s)) \
            from err


class TcpHub:
    """The parent's listener: one loopback/LAN socket, an acceptor thread
    that hello-verifies each inbound connection (shared-secret token) and
    routes it to its session's :class:`TcpTransport` — initial connects and
    redials alike. Sessions are registered by the pool before it spawns the
    child that will dial them."""

    def __init__(self, recovery, token=None, host="127.0.0.1"):
        self._rec = recovery
        self.token = token if token is not None else os.urandom(16).hex()
        self._sessions = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((host, 0))
            srv.listen(128)
            srv.settimeout(TICK)
        except BaseException:
            srv.close()
            raise
        self._srv = srv
        self.host, self.port = srv.getsockname()[:2]
        self._thread = threading.Thread(target=self._accept_loop, daemon=True,
                                        name="ptpu-tcp-hub")
        self._thread.start()

    def address_for(self, session):
        """The child argv address: ``tcp:<host>:<port>:<session>``."""
        return "tcp:%s:%d:%d" % (self.host, self.port, session)

    def create_session(self, session):
        transport = TcpTransport(session, self._rec)
        with self._lock:
            self._sessions[session] = transport
        return transport

    def drop_session(self, session):
        with self._lock:
            self._sessions.pop(session, None)

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                sock, _addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed
            # hello on its OWN short-lived thread: a dialer that connects but
            # stalls before its hello (a wedged child, a stray scanner) must
            # not park the acceptor for link_connect_timeout_s — during a
            # reconnect storm that would hold every OTHER child's redial past
            # its parent's reconnect ceiling, turning one slow dialer into
            # cascading spurious child deaths
            threading.Thread(target=self._bootstrap_safe, args=(sock,),
                             daemon=True, name="ptpu-tcp-hello").start()

    def _bootstrap_safe(self, sock):
        try:
            self._bootstrap(sock)
        except Exception:  # noqa: BLE001 — one bad dial must not kill accepts
            try:
                sock.close()
            except OSError:
                pass  # an unauthenticated or garbled dial is dropped silently

    def _bootstrap(self, sock):
        """Read + verify the hello frame (bounded), ack, route to its
        session. Unknown sessions and bad tokens are dropped silently —
        the dialer's own connect timeout reports the failure."""
        sock.settimeout(TICK)
        deadline = time.monotonic() + self._rec.link_connect_timeout_s
        buf = bytearray()
        while True:
            frame = take_frame(buf)
            if frame is not None:
                break
            try:
                data = sock.recv(1 << 12)
            except socket.timeout:
                data = b""
            if data:
                buf += data
            elif time.monotonic() > deadline:
                raise OSError("transport hello did not arrive in time")
        kind, payload = frame
        if kind != K_HELLO:
            raise OSError("expected a hello frame, got kind %d" % kind)
        hello = json.loads(payload.decode("utf-8"))
        if hello.get("token") != self.token:
            raise OSError("transport hello token mismatch")
        with self._lock:
            transport = self._sessions.get(hello.get("session"))
        if transport is None:
            raise OSError("transport hello for unknown session %r"
                          % hello.get("session"))
        # feature negotiation: only a child that advertised the
        # tenant feature gets a feature-list ack (and tagged frames); an old
        # child gets the historical empty ack and an untagged link
        features = hello.get("features") or ()
        tenant_ok = "tenant" in features
        transport._tenant_frames = tenant_ok
        if hello.get("tenant"):
            transport.peer_tenant = hello["tenant"]
        ack = json.dumps({"features": ["tenant"]}).encode("utf-8") \
            if tenant_ok else b""
        sock.sendall(pack_frame(K_HELLO_ACK, ack))
        transport.adopt(sock, leftover=bytes(buf))

    def close(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)


def parse_address(address):
    """``tcp:<host>:<port>:<session>`` -> (host, port, session)."""
    parts = address.split(":")
    if len(parts) != 4 or parts[0] != "tcp":
        raise ValueError("malformed tcp transport address %r" % address)
    return parts[1], int(parts[2]), int(parts[3])


def connect_child_tcp(address, authkey):
    """Child-side bootstrap (``_child_worker``): dial the hub named by the
    argv ``address``, authenticating with the authkey the parent piped to
    stdin. Link policy comes from the ``PTPU_LINK_*`` / retry env vars the
    parent exported into the child environment."""
    from petastorm_tpu_torch.recovery import RecoveryOptions

    host, port, session = parse_address(address)
    transport = TcpChildTransport(host, port, session,
                                  token=bytes(authkey).hex(),
                                  recovery=RecoveryOptions())
    transport.dial()
    return transport
