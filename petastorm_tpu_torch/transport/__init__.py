"""The process pool's wire.

Port of ``petastorm_tpu.transport``: a :class:`Transport` interface with two
implementations.

- :class:`PipeTransport`: the unix-socket ``multiprocessing.connection.Connection`` each
  pool child talks over, its methods bound straight to the connection's.
- :class:`~petastorm_tpu_torch.transport.tcp.TcpTransport`: length-prefixed
  crc32-trailered frames (:mod:`~petastorm_tpu_torch.transport.framing`) over loopback or
  LAN sockets, with bounded connect and read timeouts, heartbeats that find a half-open
  link, a jittered-backoff redial driven by
  :class:`~petastorm_tpu_torch.recovery.RecoveryOptions`, and an in-flight ledger a link:
  a link death dispatches the un-acknowledged item again through the poison policy,
  delivered once or quarantined.

The interface is the ``Connection`` surface the pool speaks (``send``/``recv``/``poll``/
``send_bytes``/``recv_bytes``/``close``) plus ``reconnect``, ``track``/``settle``/
``inflight`` and ``mark_ready``. Link faults surface as
:class:`petastorm_tpu_torch.errors.TransportLinkDown`, a ``ConnectionResetError``, so the
pool's dead-child handling classifies them.

Metrics (``ptpu_net_*``, the JAX package's families, resolved once a process): connects,
reconnects, heartbeats missed, frames and bytes by direction, corrupt frames, and the
heartbeat round-trip histogram.
"""
from __future__ import annotations

import os
import struct
import threading

from petastorm_tpu_torch.errors import (  # noqa: F401  (re-exported: the plane's API)
    TransportFrameCorrupt,
    TransportLinkDown,
)

#: the transport names the pool factories and PTPU_TRANSPORT take
TRANSPORTS = ("pipe", "tcp")


class Transport:
    """The pool-wire interface. Concrete transports implement the ``Connection``
    surface; this base supplies the no-op ledger hooks of the pipe."""

    #: True once the handshake (the pid ack) completed: the chaos sites and the
    #: heartbeat policing act on the steady-state link only
    ready = False

    def mark_ready(self):
        self.ready = True

    # the in-flight ledger: the feeder tracks the item it dispatched and settles it when
    # the result is fully received; whatever is still tracked at a link death is what
    # goes out again. A dead pipe is a dead child, so the pipe keeps no ledger.

    def track(self, key):
        pass

    def settle(self):
        pass

    def inflight(self):
        """The un-acknowledged dispatched item, or None."""
        return None


class PipeTransport(Transport):
    """A ``multiprocessing.connection.Connection``, its methods bound straight to the
    connection's (no indirection a message). There is no ``reconnect``: a dead pipe is a
    dead child, which the pool respawns.

    ``recv_bytes`` is the port's own: the Connection's reads a large frame in chunks
    appended to a ``BytesIO`` under the GIL and copies it out again, which, with a
    feeder thread a child each receiving tens of MB an item, starves the parent's
    other threads of the GIL. This one reads the frame with ``os.readv`` straight into
    one preallocated ``bytearray`` (one copy, done by the kernel with the GIL released)
    and returns it, writable. It speaks the Connection's framing (a 4-byte big-endian
    length; -1 then an 8-byte length beyond 2 GiB), so either end may be either kind."""

    def __init__(self, conn):
        self._conn = conn
        self.send = conn.send
        self.recv = conn.recv
        self.send_bytes = conn.send_bytes
        self.poll = conn.poll
        self.close = conn.close

    def fileno(self):
        return self._conn.fileno()

    def recv_bytes(self):
        fd = self._conn.fileno()
        (size,) = struct.unpack("!i", _read_exact(fd, 4))
        if size == -1:
            (size,) = struct.unpack("!Q", _read_exact(fd, 8))
        return _read_exact(fd, size)


def _read_exact(fd, size):
    """``size`` bytes from ``fd`` into a new ``bytearray``; EOFError at end of file."""
    buf = bytearray(size)
    view = memoryview(buf)
    got = 0
    while got < size:
        n = os.readv(fd, [view[got:]])
        if n == 0:
            raise EOFError("connection closed mid-frame")
        got += n
    return buf


_net_metrics = None
_net_lock = threading.Lock()


class _NetMetrics:
    """The ``ptpu_net_*`` families, resolved once a process (hot paths pay one
    ``inc()``)."""

    __slots__ = ("connects", "reconnects", "hb_missed", "frames_tx",
                 "frames_rx", "bytes_tx", "bytes_rx", "frames_corrupt", "rtt")

    def __init__(self, registry):
        self.connects = registry.counter(
            "ptpu_net_connects_total",
            help="tcp transport links established (first connects + redials)")
        self.reconnects = registry.counter(
            "ptpu_net_reconnects_total",
            help="tcp transport links re-established after a link death")
        self.hb_missed = registry.counter(
            "ptpu_net_heartbeats_missed_total",
            help="heartbeat intervals that passed with no traffic from the "
                 "peer (link_miss_threshold of these = half-open, torn down)")
        self.frames_tx = registry.counter(
            "ptpu_net_frames_total", direction="tx",
            help="transport frames by direction")
        self.frames_rx = registry.counter(
            "ptpu_net_frames_total", direction="rx")
        self.bytes_tx = registry.counter(
            "ptpu_net_bytes_total", direction="tx",
            help="transport wire bytes by direction (headers + trailers "
                 "included)")
        self.bytes_rx = registry.counter(
            "ptpu_net_bytes_total", direction="rx")
        self.frames_corrupt = registry.counter(
            "ptpu_net_frames_corrupt_total",
            help="frames rejected by the crc32 trailer / magic check — each "
                 "one also tears its link down")
        self.rtt = registry.histogram(
            "ptpu_net_rtt_seconds",
            help="transport heartbeat round-trip time (HB -> HB_ACK)")


def net_metrics():
    """The process-wide net-metric struct (made at first use)."""
    global _net_metrics
    m = _net_metrics
    if m is None:
        with _net_lock:
            if _net_metrics is None:
                from petastorm_tpu_torch.obs.metrics import default_registry

                _net_metrics = _NetMetrics(default_registry())
            m = _net_metrics
    return m


def normalize_transport(value):
    """``None`` → ``PTPU_TRANSPORT`` or ``'pipe'``; any name but ``'pipe'`` and
    ``'tcp'`` raises ``ValueError``."""
    if value is None:
        value = os.environ.get("PTPU_TRANSPORT") or "pipe"
    if value not in TRANSPORTS:
        raise ValueError("transport must be one of %s, got %r" % (TRANSPORTS, value))
    return value
