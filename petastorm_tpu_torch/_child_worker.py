"""Entry point of a :class:`petastorm_tpu_torch.workers.ProcessExecutor` child.

Port of ``petastorm_tpu._child_worker``. A child is a clean interpreter started as
``python -m petastorm_tpu_torch._child_worker <socket>`` with the package root on
``PYTHONPATH``: it never re-imports the user's ``__main__`` (as multiprocessing's spawn
does) and is never forked from the parent, which holds a CUDA context, pinned memory
and threads. The parent also starts it with ``CUDA_VISIBLE_DEVICES`` empty: a child
only reads and decodes on the host, and must not make a CUDA context of its own.

Protocol, over a ``multiprocessing.connection`` unix socket (authkey on stdin): the
parent sends its ``sys.path``, the wire serializer's name (a shared-memory name is
followed by the slab ring's segment names and slab size), then the pickled worker; the
child answers ``("pid", pid)``. Then items: ``(item, hints, settings)`` on the socket
wire, ``(slab_id, item, hints, settings)`` on the shared-memory wire, where ``slab_id``
is the parent's grant for this item's result (None: the ring was empty, use the
socket), ``hints`` the rest of this child's dispatch claim (handed to the worker's
``prefetch`` before the item is worked: the child's own readahead pool reads them while
it decodes) and ``settings`` None or a dict the worker applies before the item
(``apply_settings``: how a reader's later adoption by a loader reaches running
children). The child answers ``("ok", kind, nframes, (work_s, serialize_s), io)``,
``io`` the worker's ``io_stats()`` (or None), followed by ``nframes`` raw frames from
the serializer, or ``("exc", exception)``. A ``None`` item shuts the child down, and the
worker's ``close()`` releases its readahead pool and its ranged-GET engine.

A parent that owns a host-wide cache arena exports its token
(:data:`petastorm_tpu_torch.io.arena.ENV_ATTACH`): the child attaches before its first
item, so its first read of a warm piece maps the shared footers and row groups instead
of reading the store (attach trouble degrades once, inside ``arena.resolve``).

The JAX package's child also speaks tcp, heartbeats, stack dumps, chaos, provenance,
tenants and live knob frames; those are not ported (ROADMAP.md Queue 1 items 4(c) and
8), and the parent never asks for them.
"""
import os
import pickle
import sys
import time
from multiprocessing.connection import Client


def _dial(address, authkey, patience_s=30.0):
    """Connect to the parent's socket, retrying while its backlog is full (some kernels
    refuse such a connect with EAGAIN instead of queueing it)."""
    deadline = time.monotonic() + patience_s
    while True:
        try:
            return Client(address, authkey=authkey)
        except (BlockingIOError, ConnectionRefusedError):
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def main():
    address = sys.argv[1]
    authkey = sys.stdin.buffer.read(32)
    conn = _dial(address, authkey)
    serializer = None
    worker = None
    try:
        # bootstrap receives are unbounded: the parent sends the handshake right after
        # accepting, and if it dies instead the closed socket raises EOFError
        for entry in conn.recv():  # the parent's sys.path, so the worker pickle resolves
            if entry not in sys.path:
                sys.path.append(entry)
        from petastorm_tpu_torch.serializers import make_serializer

        serializer_name = conn.recv()
        serializer = make_serializer(serializer_name)
        shm_wire = serializer_name.startswith("shm")
        if shm_wire:
            slab_names, slab_bytes = conn.recv()
            serializer.bind_slabs(slab_names, slab_bytes)
        worker = conn.recv()
        conn.send(("pid", os.getpid()))
        from petastorm_tpu_torch.io import arena as arena_mod

        arena_mod.attach_from_env()
        apply_settings = getattr(worker, "apply_settings", None)
        prefetch = getattr(worker, "prefetch", None)
        io_stats = getattr(worker, "io_stats", None)
        while True:
            # waiting for the next item is this process's job; the parent's teardown
            # closes the socket (EOFError, handled)
            msg = conn.recv()
            if msg is None:
                return
            if shm_wire:
                slab_id, item, hints, settings = msg
                serializer.set_slab(slab_id)
            else:
                item, hints, settings = msg
            if settings and apply_settings is not None:
                apply_settings(settings)
            if hints and prefetch is not None:
                prefetch(hints)  # never raises (degradation-counted)
            try:
                t0 = time.perf_counter()
                result = worker(item)
                t1 = time.perf_counter()
                kind, frames = serializer.serialize(result)
                t2 = time.perf_counter()
            except Exception as e:  # noqa: BLE001 — shipped to the parent
                try:
                    pickle.dumps(e)
                    conn.send(("exc", e))
                except Exception:  # noqa: BLE001 — unpicklable exception: rebuild it
                    conn.send(("exc", RuntimeError("%s: %s" % (type(e).__name__, e))))
                continue
            conn.send(("ok", kind, len(frames), (t1 - t0, t2 - t1),
                       io_stats() if io_stats is not None else None))
            for frame in frames:
                conn.send_bytes(frame)
    except (EOFError, BrokenPipeError, ConnectionResetError):
        return
    finally:
        close = getattr(worker, "close", None)
        if close is not None:
            close()  # the readahead pool's IO threads
        if serializer is not None and hasattr(serializer, "close"):
            serializer.close()  # detach (never unlink) the attached slabs
        conn.close()


if __name__ == "__main__":
    main()
