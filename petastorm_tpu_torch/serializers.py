"""Wire serializers for the process pool.

Port of ``petastorm_tpu.serializers``. Every serializer speaks one frame protocol,
``serialize(obj) -> (kind, [buffer, ...])`` and ``deserialize(kind, [buffer, ...]) ->
obj``, so the pool ships each buffer with ``send_bytes`` instead of one monolithic
pickle stream:

- :class:`PickleSerializer`: pickle protocol 5 with out-of-band buffers (numpy payloads
  leave as raw buffer views, not copied into the stream first).
- :class:`ArrowTableSerializer`: the tagged columnar results of the batch path,
  ``(epoch, ordinal, {name: ndarray})``, as one Arrow IPC stream (tensor columns as
  FixedSizeList with the shape in field metadata); what Arrow cannot express (object
  columns: JPEG staging payloads, pass-through columns) rides pickle frames.
- :class:`ShmSerializer`: either framing above, written by the child straight into a
  granted shared-memory slab (:mod:`petastorm_tpu_torch.parallel.shm_ring`); only a
  descriptor crosses the socket and the parent rebuilds views into the slab. Payloads
  larger than the slab, and items without a grant, take the inner socket frames.

Writable-batch contract: by default deserialized arrays are writable, as the thread
pool's are (the read-only rebuilds are copied once). Names ending in ``-view`` skip that
copy and deliver read-only views into the slab with a
:class:`petastorm_tpu_torch.io.lease.Lease` riding the batch; the slab returns to the
ring when the lease is released.

One difference from the JAX package: pickling a row-group batch of JPEG staging
payloads (:class:`petastorm_tpu_torch.ops.jpeg.JpegPlanes` rows from the batched stage
1, which view their row group's stacked coefficient buffers) ships those buffers once
and each row as a reference into them, so the parent's stage 2 packs the row group run
by run, as it does for the thread pool. The JAX package detaches each row (a copy a row,
and a pack a row in the parent). A row pickled on its own still carries only itself.
"""
from __future__ import annotations

import io
import json
import pickle
import struct
import sys
import zlib

import numpy as np

from petastorm_tpu_torch.io.lease import LEASE_KEY, Lease, count_copy

KIND_PICKLE = 0
KIND_ARROW = 1
KIND_SHM = 2

#: frame offsets inside a slab are rounded up to this
_SLAB_ALIGN = 64


def _degradation(name, msg, *args, once=True):
    from petastorm_tpu_torch.parallel.shm_ring import degradation

    degradation(name, msg, *args, once=once)


def _ensure_writable(obj):
    """Deserialized payloads are writable, as the thread pool's: read-only rebuilds are
    copied (charged to the ``wire_writable`` copy-census site)."""
    copied = [0]
    out = _ensure_writable_impl(obj, copied)
    count_copy("wire_writable", copied[0])
    return out


def _ensure_writable_impl(obj, copied):
    if isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.flags.writeable:
            return obj
        copied[0] += obj.nbytes
        return obj.copy()
    if isinstance(obj, dict):
        return {k: _ensure_writable_impl(v, copied) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_ensure_writable_impl(v, copied) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_ensure_writable_impl(v, copied) for v in obj)
    return obj


def _planes_from_batch_ref(height, width, samps, batch_ref, kmax, specmax):
    """Rebuild one row of a row-group batch of JPEG staging payloads from the shared
    buffers (the wire form of :class:`_WirePickler`)."""
    from petastorm_tpu_torch.ops.jpeg import JpegComponent, JpegPlanes

    coeffs, qtabs, i = batch_ref
    comps = [JpegComponent(coeffs[c][i].reshape(by, bx, 64), qtabs[i, c], h, v)
             for c, (h, v, by, bx) in enumerate(samps)]
    return JpegPlanes(height, width, comps, batch_ref=batch_ref, kmax=kmax,
                      specmax=specmax)


class _WirePickler(pickle.Pickler):
    """Pickle protocol 5 where a JPEG staging row that views its row group's buffers
    travels as a reference into them: the pickle memo then ships the buffers once for
    the whole row group."""

    def reducer_override(self, obj):
        jpeg = sys.modules.get("petastorm_tpu_torch.ops.jpeg")
        if jpeg is None or type(obj) is not jpeg.JpegPlanes or obj.batch_ref is None:
            return NotImplemented
        samps = tuple((c.h_samp, c.v_samp) + tuple(c.blocks.shape[:2])
                      for c in obj.components)
        return (_planes_from_batch_ref,
                (obj.height, obj.width, samps, obj.batch_ref, obj.kmax, obj.specmax))


class PickleSerializer:
    """Pickle protocol 5 with out-of-band buffers. ``ensure_writable=False`` (the shm
    view mode) hands back the zero-copy rebuilds as they are."""

    def __init__(self, ensure_writable=True):
        self._ensure = ensure_writable

    def serialize(self, obj):
        buffers = []
        head = io.BytesIO()
        _WirePickler(head, protocol=5, buffer_callback=buffers.append).dump(obj)
        return KIND_PICKLE, [head.getbuffer()] + [b.raw() for b in buffers]

    def deserialize(self, kind, frames):
        if kind != KIND_PICKLE:
            raise ValueError("PickleSerializer got kind %r" % kind)
        obj = pickle.loads(frames[0], buffers=frames[1:])
        return _ensure_writable(obj) if self._ensure else obj


def _arrow_expressible(columns):
    for arr in columns.values():
        if not isinstance(arr, np.ndarray) or arr.dtype.hasobject:
            return False
        if arr.dtype.kind not in "biufc" and arr.dtype.kind not in ("U", "S"):
            return False
    return True


class ArrowTableSerializer(PickleSerializer):
    """Arrow IPC for tagged columnar batch results; pickle frames otherwise."""

    def serialize(self, obj):
        if (isinstance(obj, tuple) and len(obj) == 3 and isinstance(obj[2], dict)
                and obj[2] and _arrow_expressible(obj[2])):
            try:
                return KIND_ARROW, [self._encode(obj)]
            except Exception as e:  # noqa: BLE001 — Arrow cannot express it: pickle
                _degradation("arrow_fallback", "Arrow IPC encode failed (%s); this "
                             "batch rides the pickle wire", e)
        return super().serialize(obj)

    def deserialize(self, kind, frames):
        if kind == KIND_ARROW:
            return self._decode(frames[0], ensure_writable=self._ensure)
        return super().deserialize(kind, frames)

    @staticmethod
    def _encode(obj):
        import pyarrow as pa

        epoch, ordinal, columns = obj
        fields = []
        arrays = []
        for name, arr in columns.items():
            if arr.dtype.kind in ("U", "S"):
                # the numpy kind rides in metadata: 'S' bytes must not come back as str
                pa_type = pa.string() if arr.dtype.kind == "U" else pa.binary()
                pa_arr = pa.array(arr.tolist(), type=pa_type)
                fields.append(pa.field(name, pa_arr.type,
                                       metadata={b"npkind": arr.dtype.kind.encode()}))
            elif arr.ndim == 1:
                pa_arr = pa.array(arr)
                fields.append(pa.field(name, pa_arr.type))
            else:
                flat_len = int(np.prod(arr.shape[1:]))
                flat = np.ascontiguousarray(arr).reshape(len(arr) * flat_len)
                pa_arr = pa.FixedSizeListArray.from_arrays(pa.array(flat), flat_len)
                fields.append(pa.field(name, pa_arr.type, metadata={
                    b"shape": json.dumps(list(arr.shape[1:])).encode()}))
            arrays.append(pa_arr)
        schema = pa.schema(fields, metadata={b"epoch": str(epoch).encode(),
                                             b"ordinal": str(ordinal).encode()})
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, schema) as writer:
            writer.write_batch(pa.record_batch(arrays, schema=schema))
        return sink.getvalue()

    @staticmethod
    def _decode(frame, ensure_writable=True):
        import pyarrow as pa

        with pa.ipc.open_stream(pa.py_buffer(frame)) as reader:
            batch = reader.read_next_batch()
            schema = reader.schema
        epoch = int(schema.metadata[b"epoch"])
        ordinal = int(schema.metadata[b"ordinal"])
        columns = {}
        for i, field in enumerate(schema):
            col = batch.column(i)
            meta = field.metadata or {}
            if b"shape" in meta:
                inner = json.loads(meta[b"shape"].decode())
                flat = col.flatten().to_numpy(zero_copy_only=False)
                columns[field.name] = flat.reshape((len(col),) + tuple(inner))
            elif b"npkind" in meta:
                kind = meta[b"npkind"].decode()
                columns[field.name] = np.asarray(
                    col.to_pylist(), dtype=np.str_ if kind == "U" else np.bytes_)
            else:
                columns[field.name] = col.to_numpy(zero_copy_only=False)
        if ensure_writable:
            columns = _ensure_writable(columns)
        return epoch, ordinal, columns


class _LeasedRows(list):
    """Per-row payload list carrying its lease (view mode); the Reader holds the lease
    while it drains the rows."""

    lease = None


class ShmSerializer:
    """Slab transport around an inner framing (pickle or Arrow).

    Child side (``bind_slabs``, then ``set_slab`` per item): writes the inner frames
    into the granted slab and ships a descriptor ``(inner_kind, slab_id, [(offset,
    length), ...])`` with a crc32 trailer as the only socket frame. Items without a
    grant, or whose frames exceed the slab, ship the inner frames unchanged.

    Parent side (``bind_ring``): rebuilds the inner frames as views into the slab. With
    ``writable=True`` the inner writable copy runs and the slab returns at once; with
    ``writable=False`` read-only views are delivered with a refcounted
    :class:`~petastorm_tpu_torch.io.lease.Lease` over the slab attached to the payload.
    """

    def __init__(self, inner_name="pickle", writable=True):
        if inner_name not in ("pickle", "arrow"):
            raise ValueError("ShmSerializer inner must be 'pickle' or 'arrow', got %r"
                             % inner_name)
        self.inner_name = inner_name
        self.writable = writable
        inner_cls = PickleSerializer if inner_name == "pickle" else ArrowTableSerializer
        self.inner = inner_cls(ensure_writable=writable)
        self._client = None   # child side: SlabClient
        self._slab = None     # child side: this item's grant
        self._ring = None     # parent side: SlabRing

    # -- child side ---------------------------------------------------------------------

    def bind_slabs(self, names, slab_bytes):
        from petastorm_tpu_torch.parallel.shm_ring import SlabClient

        self._client = SlabClient(names, slab_bytes)

    def set_slab(self, slab_id):
        """The parent's grant for the next ``serialize()`` (None: no slab; socket
        frames)."""
        self._slab = slab_id

    def close(self):
        if self._client is not None:
            self._client.close()

    def serialize(self, obj):
        kind, frames = self.inner.serialize(obj)
        slab, self._slab = self._slab, None
        if slab is None or self._client is None:
            return kind, frames
        views = [memoryview(f).cast("B") for f in frames]
        end = 0
        offsets = []
        for v in views:
            start = -(-end // _SLAB_ALIGN) * _SLAB_ALIGN
            end = start + v.nbytes
            offsets.append((start, v.nbytes))
        if end > self._client.slab_bytes:
            # larger than a slab: this item takes the socket; the parent sees a non-shm
            # kind and returns the unused grant
            return kind, frames
        buf = self._client.buffer(slab)
        for v, (start, length) in zip(views, offsets):
            buf[start:start + length] = v
        # a corrupt descriptor must be detected, never acted on: a flipped byte could
        # still parse into another slab id, and freeing that would free a slab some
        # consumer's lease still views
        blob = pickle.dumps((kind, slab, offsets))
        return KIND_SHM, [blob + struct.pack("<I", zlib.crc32(blob))]

    # -- parent side --------------------------------------------------------------------

    def bind_ring(self, ring):
        self._ring = ring

    def deserialize(self, kind, frames):
        if kind != KIND_SHM:
            return self.inner.deserialize(kind, frames)
        if self._ring is None:
            raise ValueError("shm descriptor received but no slab ring is bound")
        # slab ownership: an exception raised before this method takes the grant carries
        # slab_released=False (the caller still owns it and returns it); one raised
        # after carries slab_released=True (the lease's release below returned it)
        try:
            desc = memoryview(frames[0]).cast("B")
            if len(desc) < 5:
                raise ValueError("shm descriptor truncated (%d bytes)" % len(desc))
            blob, (crc,) = desc[:-4], struct.unpack("<I", desc[-4:])
            if zlib.crc32(blob) != crc:
                raise ValueError("shm descriptor failed its crc check (corrupt wire bytes)")
            inner_kind, slab, offsets = pickle.loads(blob)
        except Exception as e:
            e.slab_released = False
            raise
        from petastorm_tpu_torch.parallel.shm_ring import SlabLease

        slab_lease = SlabLease(self._ring, slab)
        if self.writable:
            lease = slab_lease
        else:
            lease = Lease(release_cb=slab_lease.release, kind="shm_slab")
            # a dead-child reclaim must revoke this lease, not re-grant a viewed slab
            self._ring.register_lease(slab, lease)
        try:
            base = self._ring.buffer(slab)
            self._ring.add_bytes(sum(length for _s, length in offsets))
            if self.writable and inner_kind == KIND_PICKLE:
                result = self._deserialize_owned(base, inner_kind, offsets)
            else:
                # the Arrow framing rebuilds only flat numeric and string columns, all
                # reached by the writable walk; view mode wants views anyway
                views = [base[start:start + length].toreadonly()
                         for start, length in offsets]
                result = self.inner.deserialize(inner_kind, views)
                del views
            if not self.writable:
                attached = self._attach_lease(result, lease)
                if attached is not None:
                    return attached
                # a result shape the lease cannot ride: rebuild it from owned buffers
                # before the release below, so correctness never depends on the consumer
                # knowing about leases
                _degradation("shm_view_copyout", "shm view-mode payload of type %s "
                             "cannot carry a slab lease; delivering an owned copy",
                             type(result).__name__)
                if inner_kind == KIND_PICKLE:
                    result = self._deserialize_owned(base, inner_kind, offsets)
                else:
                    result = _ensure_writable(result)
        except BaseException as e:
            lease.release()
            e.slab_released = True
            raise
        lease.release()
        return result

    def _deserialize_owned(self, base, inner_kind, offsets):
        """Inner deserialize with the out-of-band buffers backed by owned writable
        copies: pickle 5 reattaches buffers anywhere in the object graph (object-array
        elements, staging payloads), where the writable walk cannot reach them, so slab
        views there would go stale at the release."""
        head_start, head_len = offsets[0]
        frames = [base[head_start:head_start + head_len].toreadonly()]
        frames += [bytearray(base[start:start + length]) for start, length in offsets[1:]]
        count_copy("wire_owned", sum(length for _s, length in offsets[1:]))
        return self.inner.deserialize(inner_kind, frames)

    @staticmethod
    def _attach_lease(result, lease):
        """Ride the lease with the payload; None for a shape it cannot ride."""
        if isinstance(result, tuple) and len(result) == 3:
            epoch, ordinal, payload = result
            if isinstance(payload, dict):
                payload[LEASE_KEY] = lease
                return result
            if isinstance(payload, list):
                leased = _LeasedRows(payload)
                leased.lease = lease
                return (epoch, ordinal, leased)
        return None


#: shm serializer name -> constructor arguments; the name is what crosses the
#: handshake, so both ends agree from it alone
_SHM_NAMES = {
    "shm": dict(inner_name="pickle", writable=True),
    "shm-pickle": dict(inner_name="pickle", writable=True),
    "shm-arrow": dict(inner_name="arrow", writable=True),
    "shm-view": dict(inner_name="pickle", writable=False),
    "shm-pickle-view": dict(inner_name="pickle", writable=False),
    "shm-arrow-view": dict(inner_name="arrow", writable=False),
}


def make_serializer(name):
    if name in (None, "pickle"):
        return PickleSerializer()
    if name == "arrow":
        return ArrowTableSerializer()
    if name in _SHM_NAMES:
        return ShmSerializer(**_SHM_NAMES[name])
    raise ValueError("Unknown serializer %r (expected 'pickle', 'arrow', or one of %s)"
                     % (name, sorted(_SHM_NAMES)))
