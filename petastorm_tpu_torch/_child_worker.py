"""Entry point of a :class:`petastorm_tpu_torch.workers.ProcessExecutor` child.

Port of ``petastorm_tpu._child_worker``. A child is a clean interpreter started as
``python -m petastorm_tpu_torch._child_worker <socket>`` with the package root on
``PYTHONPATH``: it never re-imports the user's ``__main__`` (as multiprocessing's spawn
does) and is never forked from the parent, which holds a CUDA context, pinned memory
and threads. The parent also starts it with ``CUDA_VISIBLE_DEVICES`` empty: a child
only reads and decodes on the host, and must not make a CUDA context of its own.

Protocol, over a ``multiprocessing.connection`` unix socket, or over a framed tcp link
to the parent's hub when the address is ``tcp:<host>:<port>:<session>``
(:mod:`petastorm_tpu_torch.transport.tcp`; the authkey on stdin either way): the
parent sends its ``sys.path``, the wire serializer's name (a shared-memory name is
followed by the slab ring's segment names and slab size), the health settings
(``{"stack_dump_dir", "ping_interval_s"}``), then the pickled worker; the child calls
the worker's ``warm()`` where it has one (the first-use imports of a read) and answers
``("pid", pid)``. Then items: ``(item, hints, settings)`` on the socket
wire, ``(slab_id, item, hints, settings)`` on the shared-memory wire, where ``slab_id``
is the parent's grant for this item's result (None: the ring was empty, use the
socket), ``hints`` the rest of this child's dispatch claim (handed to the worker's
``prefetch`` before the item is worked: the child's own readahead pool reads them while
it decodes) and ``settings`` None or a dict the worker applies before the item
(``apply_settings``: how a reader's later adoption by a loader reaches running
children). A ``("ctl", {knob: value})`` message ahead of an item is a live knob retune:
the child applies each knob through the worker's ``apply_<knob>`` and answers
``("ctl_ack", {knob: applied value})`` before it takes the item. The child answers
``("ok", kind, nframes, (work_s, serialize_s), io, spans)``, ``io`` the worker's ``io_stats()`` (or None) and ``spans`` the trace piggyback
``(pid, wall_anchor, perf_anchor, [(name, t0, dur), ...], prov_blob)``: ``child.work``
(the worker call) and ``child.serialize`` (the wire encode) around this item, ``t0`` from
the child's ``perf_counter`` and one (wall, perf) anchor pair sampled at start for clock
alignment. ``prov_blob`` is the item's provenance record ``(epoch, ordinal, key, spans,
annotations)`` (:mod:`petastorm_tpu_torch.obs.provenance`; the child arms its
lightweight collector at bootstrap): the same two spans plus every span the worker
recorded inside them (reads, GETs, the transform) and its annotations, or None when it
recorded nothing. The record is taken in a ``finally`` on every exit of the attempt, so
a failed attempt never leaks into the next item. Recording is a few ``perf_counter``
pairs an item (a row group, not a row), so it is always on; the parent merges the spans
only when a :class:`~petastorm_tpu_torch.trace.TraceRecorder` or a
:class:`~petastorm_tpu_torch.obs.provenance.ProvenanceRecorder` is attached. Then
``nframes`` raw frames from the serializer follow; or the child answers ``("exc",
exception)``. A
``None`` item shuts the child down, and the worker's ``close()`` releases its readahead
pool and its ranged-GET engine.

A parent that owns a host-wide cache arena exports its token
(:data:`petastorm_tpu_torch.io.arena.ENV_ATTACH`): the child attaches before its first
item, so its first read of a warm piece maps the shared footers and row groups instead
of reading the store (attach trouble degrades once, inside ``arena.resolve``).

A parent armed with a propagated :class:`~petastorm_tpu_torch.chaos.FaultPlan` exports
it as ``PTPU_CHAOS_SPEC``: the child arms its own copy at bootstrap, opted into the
``kill`` action (``os._exit(137)`` mid-item, exactly a crashed child), and evaluates the
``child.item`` site around each ``worker(item)``, besides the worker's own read sites.

Liveness: the child interleaves ``("hb", wall_ts)`` pings with its answers, one as soon
as it receives an item and one every ``ping_interval_s`` while it waits for work; the
parent drains them into the child's heartbeat. A child hung inside ``worker(item)``
sends nothing, so its heartbeat ages: the stall signal. With ``stack_dump_dir`` the child
registers ``faulthandler`` on SIGUSR1, writing every thread's stack to
``<dir>/stacks-<pid>.txt``, which the parent signals and reads into a flight record.

The child adopts the parent's tenant (``PTPU_TENANT``, stamped by the pool) as its
process default before it dials (:func:`petastorm_tpu_torch.obs.tenant.attach_from_env`),
so a tcp hello already carries it and the IO it does is charged to that tenant.

On tcp the child redials with jittered backoff after any link death (its policy comes in
the ``PTPU_LINK_*`` environment the pool sets). A healed link surfaces as
:class:`~petastorm_tpu_torch.errors.TransportLinkDown`, caught by the work loop: whatever
the conversation was (an item half received, a result half sent) is void, and the loop
waits for the parent's re-dispatch. A parent that cannot be reached surfaces as
``EOFError``, as a closed pipe does, and the child exits.
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


def _register_stack_dump(dump_dir):
    """SIGUSR1 → faulthandler writes every thread's stack (the worker's and its
    readahead IO threads') to a file the parent reads; costs nothing until signalled.
    A file that cannot be opened leaves the parent with its own stacks only."""
    import faulthandler
    import signal

    if not dump_dir or not hasattr(signal, "SIGUSR1"):
        return
    try:
        dump_file = open(os.path.join(dump_dir, "stacks-%d.txt" % os.getpid()), "w")
        faulthandler.register(signal.SIGUSR1, file=dump_file, all_threads=True)
    except OSError:
        pass


def _apply_knobs(worker, knobs):
    """Apply a control frame's ``{knob: value}`` through ``worker.apply_<knob>``;
    ``{knob: applied value}`` of the knobs that applied (a failed retune is degraded,
    never fatal to the child)."""
    applied = {}
    for knob, value in knobs.items():
        fn = getattr(worker, "apply_%s" % knob, None)
        if fn is None:
            continue
        try:
            applied[knob] = fn(value)
        except Exception as e:  # noqa: BLE001 — a bad retune must not kill the child
            from petastorm_tpu_torch.obs.log import degradation

            degradation("ctl_child_apply_failed", "pool-child knob %r apply failed: %s",
                        knob, e)
    return applied


def main():
    address = sys.argv[1]
    authkey = sys.stdin.buffer.read(32)
    from petastorm_tpu_torch.obs import tenant as tenant_mod

    tenant_mod.attach_from_env()  # before the dial: a tcp hello carries the tenant
    link_down = ()  # a dead pipe cannot heal: end of file or a reset is a gone parent
    if address.startswith("tcp:"):
        from petastorm_tpu_torch.errors import TransportLinkDown
        from petastorm_tpu_torch.transport.tcp import connect_child_tcp

        conn = connect_child_tcp(address, authkey)
        link_down = TransportLinkDown
    else:
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
        health_cfg = conn.recv()
        ping_s = float(health_cfg.get("ping_interval_s") or 0)
        _register_stack_dump(health_cfg.get("stack_dump_dir"))
        worker = conn.recv()
        warm = getattr(worker, "warm", None)
        if warm is not None:
            warm()  # first-use imports, before the parent times this child's items
        pid = os.getpid()
        conn.send(("pid", pid))
        if hasattr(conn, "mark_ready"):
            conn.mark_ready()  # tcp: heartbeats and chaos sites on the steady-state link
        # the clock-alignment anchor pair of this child's spans
        wall_anchor, perf_anchor = time.time(), time.perf_counter()
        from petastorm_tpu_torch import chaos

        chaos.arm_from_env(in_child=True)
        from petastorm_tpu_torch.io import arena as arena_mod

        arena_mod.attach_from_env()
        from petastorm_tpu_torch.obs import provenance as prov

        prov.arm_child()
        apply_settings = getattr(worker, "apply_settings", None)
        prefetch = getattr(worker, "prefetch", None)
        io_stats = getattr(worker, "io_stats", None)
        while True:
            try:
                if ping_s:
                    # the idle heartbeat: alive while waiting for work (this thread is the
                    # only sender, so a ping never lands inside a result's frames)
                    while not conn.poll(ping_s):
                        conn.send(("hb", time.time()))
                # waiting for the next item is this process's job; the parent's teardown
                # closes the socket (EOFError, handled)
                msg = conn.recv()
                if msg is None:
                    return
                if isinstance(msg, tuple) and len(msg) == 2 and msg[0] == "ctl":
                    # a live knob retune (item messages are 3- or 4-tuples)
                    conn.send(("ctl_ack", _apply_knobs(worker, msg[1] or {})))
                    continue
                if ping_s:
                    conn.send(("hb", time.time()))  # item received, about to work
                if shm_wire:
                    slab_id, item, hints, settings = msg
                    serializer.set_slab(slab_id)
                else:
                    item, hints, settings = msg
                if settings and apply_settings is not None:
                    apply_settings(settings)
                if hints and prefetch is not None:
                    prefetch(hints)  # never raises (degradation-counted)
                prov.begin_item(item)
                try:
                    try:
                        t0 = time.perf_counter()
                        if chaos.ACTIVE is not None:
                            chaos.ACTIVE.hit("child.item", key=chaos.item_key(item))
                        result = worker(item)
                        t1 = time.perf_counter()
                        kind, frames = serializer.serialize(result)
                        t2 = time.perf_counter()
                        # mirrored into the item's record, so the parent's wire.roundtrip
                        # folds to the wire's overhead (the worker's spans nest in here)
                        prov.add_span("child.work", t0, t1 - t0)
                        prov.add_span("child.serialize", t1, t2 - t1)
                    except Exception as e:  # noqa: BLE001 — shipped to the parent
                        try:
                            pickle.dumps(e)
                            conn.send(("exc", e))
                        except link_down:
                            raise  # to the conversation's handler below
                        except Exception:  # noqa: BLE001 — unpicklable exception: rebuild
                            conn.send(("exc", RuntimeError("%s: %s" % (type(e).__name__,
                                                                      e))))
                        continue
                finally:
                    # taken on every exit of the attempt: a failed one never leaks into the
                    # next item's record
                    prov_blob = prov.end_item()
                conn.send(("ok", kind, len(frames), (t1 - t0, t2 - t1),
                           io_stats() if io_stats is not None else None,
                           (pid, wall_anchor, perf_anchor,
                            [("child.work", t0, t1 - t0), ("child.serialize", t1, t2 - t1)],
                            prov_blob)))
                for frame in frames:
                    conn.send_bytes(frame)
            except link_down:
                # the link died and redialed: this conversation is void, and the
                # parent sends its in-flight item again
                continue
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
