"""Wire framing of the tcp transport: length-prefixed, crc32-trailered frames.

Port of ``petastorm_tpu.transport.framing``; the frames are byte-identical to the JAX
package's, so either package's hub and child speak to the other. A frame is::

    >H   magic   (0xF7A5: a stream-desync canary)
    >B   kind    (K_* below)
    >I   length  (payload bytes; bounded by MAX_FRAME)
    ...  payload
    >I   crc32 over (kind byte + payload)

The crc covers the kind, so a flipped kind byte cannot re-type a payload; the magic
makes a desynchronised stream (a partial frame left by a link death) fail loudly instead
of parsing garbage lengths. A failed check raises
:class:`petastorm_tpu_torch.errors.TransportFrameCorrupt`: the link is torn down and the
in-flight item dispatched again; a corrupt payload is never delivered (the chaos
``net.corrupt_frame`` action is caught here).

Parsing works on a buffer (:func:`take_frame` over a ``bytearray`` the endpoint appends
socket reads to), so a read timeout mid-frame keeps the partial bytes and resumes.
"""
from __future__ import annotations

import struct
import zlib

from petastorm_tpu_torch.errors import TransportFrameCorrupt

MAGIC = 0xF7A5
_HEADER = struct.Struct(">HBI")
_TRAILER = struct.Struct(">I")
HEADER_LEN = _HEADER.size
TRAILER_LEN = _TRAILER.size

#: frame kinds
K_OBJ = 1      #: a pickled python object (the Connection.send/recv parity)
K_RAW = 2      #: raw serializer bytes (the Connection.send_bytes parity)
K_HB = 3       #: transport heartbeat; payload = ">d" sender-monotonic stamp
K_HB_ACK = 4   #: heartbeat echo (same payload) — the sender's rtt sample
K_HELLO = 5    #: connection bootstrap: token + session id + dial attempt
K_HELLO_ACK = 6

#: kind-byte flag: the payload is prefixed with an optional tenant
#: header — one length byte + that many ascii slug bytes — before the real
#: payload. Version-negotiated in the hello exchange: a sender only sets the
#: flag after the peer advertised the ``tenant`` feature, so old peers never
#: see a flagged kind (and :func:`split_tenant` makes a new receiver treat an
#: unflagged frame as untagged — old senders keep working unchanged). The crc
#: covers the flagged kind byte plus the prefixed payload, so the tenant
#: header enjoys the same corruption detection as the body.
K_TENANT_FLAG = 0x80

#: hard bound on one frame's payload — a desynced length field must fail fast,
#: not allocate gigabytes (result payloads are row-group batches, well under)
MAX_FRAME = 1 << 31


def pack_frame(kind, payload, tenant=None):
    """One wire frame for ``payload`` (bytes-like).

    ``tenant`` (a validated bounded slug, or None) rides an optional header
    in front of the payload, marked by :data:`K_TENANT_FLAG` on the kind
    byte. Callers must only pass a tenant after hello negotiation confirmed
    the peer understands the flag.
    """
    payload = bytes(payload)
    if tenant is not None:
        slug = tenant.encode("ascii")
        if not 0 < len(slug) < 256:
            raise ValueError("tenant frame header slug %r out of bounds"
                             % (tenant,))
        kind |= K_TENANT_FLAG
        payload = bytes((len(slug),)) + slug + payload
    crc = zlib.crc32(bytes((kind,)) + payload) & 0xFFFFFFFF
    return _HEADER.pack(MAGIC, kind, len(payload)) + payload \
        + _TRAILER.pack(crc)


def split_tenant(kind, payload):
    """``(kind, payload, tenant-or-None)`` with the tenant header stripped.

    Receivers call this on every frame :func:`take_frame` yields: unflagged
    frames (every frame an old peer sends) pass through untouched with
    ``tenant=None``; flagged frames lose the flag bit and the slug prefix. A
    flagged frame whose header is truncated or non-ascii is corrupt — same
    teardown path as a crc mismatch.
    """
    if not kind & K_TENANT_FLAG:
        return kind, payload, None
    kind &= ~K_TENANT_FLAG
    if not payload:
        raise TransportFrameCorrupt(
            "tenant-flagged frame (kind=%d) carries no tenant header" % kind)
    n = payload[0]
    if len(payload) < 1 + n:
        raise TransportFrameCorrupt(
            "tenant frame header truncated (kind=%d want %d slug bytes, "
            "frame has %d)" % (kind, n, len(payload) - 1))
    try:
        tenant = payload[1:1 + n].decode("ascii")
    except UnicodeDecodeError:
        raise TransportFrameCorrupt(
            "tenant frame header is not ascii (kind=%d)" % kind)
    return kind, payload[1 + n:], tenant


def frame_size(buf):
    """Total byte length of the frame at the head of ``buf``, or None while
    the header (or body) is still incomplete. Raises on a bad magic/length —
    the stream is desynchronized and the link must die."""
    if len(buf) < HEADER_LEN:
        return None
    magic, _kind, length = _HEADER.unpack_from(buf)
    if magic != MAGIC:
        raise TransportFrameCorrupt(
            "transport stream desynchronized (bad frame magic 0x%04X)" % magic)
    if length > MAX_FRAME:
        raise TransportFrameCorrupt(
            "transport frame length %d exceeds the %d-byte bound (desynced "
            "stream?)" % (length, MAX_FRAME))
    total = HEADER_LEN + length + TRAILER_LEN
    return total if len(buf) >= total else None


def take_frame(buf):
    """Pop one complete frame off the head of ``buf`` (a ``bytearray``):
    ``(kind, payload-bytes)``, or ``None`` when the buffer holds only a
    partial frame. Raises :class:`TransportFrameCorrupt` on a crc/magic
    mismatch (the corrupt bytes are consumed first so the caller can count
    before tearing the link down)."""
    total = frame_size(buf)
    if total is None:
        return None
    _magic, kind, length = _HEADER.unpack_from(buf)
    payload = bytes(buf[HEADER_LEN:HEADER_LEN + length])
    (crc,) = _TRAILER.unpack_from(buf, HEADER_LEN + length)
    del buf[:total]
    if crc != (zlib.crc32(bytes((kind,)) + payload) & 0xFFFFFFFF):
        raise TransportFrameCorrupt(
            "transport frame crc mismatch (kind=%d len=%d)" % (kind, length))
    return kind, payload
