"""The process pool's wire.

Port of ``petastorm_tpu.transport``: :class:`PipeTransport`, the unix-socket
``multiprocessing.connection.Connection`` each pool child talks over, with the
``Connection`` surface the pool speaks (``send``/``recv``/``poll``/``send_bytes``/
``recv_bytes``/``close``). The JAX package's second transport,
framed tcp with reconnect, heartbeats and an in-flight ledger (``transport/tcp.py``,
``framing.py``), is not ported: ``transport='tcp'`` and ``PTPU_TRANSPORT=tcp`` raise
``NotImplementedError`` naming its ROADMAP.md item.
"""
from __future__ import annotations

import os
import struct

from petastorm_tpu_torch._unported import not_ported

#: the JAX package's transport names; the port has the first
TRANSPORTS = ("pipe", "tcp")


class PipeTransport:
    """A ``multiprocessing.connection.Connection``, its methods bound straight to the
    connection's (no indirection a message). There is
    no ``reconnect``: a dead pipe is a dead child, which the pool respawns.

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


def normalize_transport(value):
    """``None`` → ``PTPU_TRANSPORT`` or ``'pipe'``. ``'tcp'`` raises
    ``NotImplementedError`` (not ported); any other name raises ``ValueError``."""
    from_env = value is None
    if from_env:
        value = os.environ.get("PTPU_TRANSPORT") or "pipe"
    if value not in TRANSPORTS:
        raise ValueError("transport must be one of %s, got %r" % (TRANSPORTS, value))
    if value == "tcp":
        raise not_ported("%s='tcp'" % ("PTPU_TRANSPORT" if from_env else "transport"),
                         "process_pool")
    return value
