"""Deterministic, seeded fault injection for the data pipeline.

Port of ``petastorm_tpu.chaos.plan``: the same rules, triggers, JSON and ledger, so a
plan written for the JAX package arms the port identically. A :class:`FaultPlan` is a
list of :class:`FaultRule`, each a *site pattern* (fnmatch glob over the named hook
sites threaded through the real seams), a *trigger* (nth matching hit, seeded
probability, item-key substring) and an *action* (raise a transient or permanent IO
error, inject latency, corrupt wire bytes, kill the pool child mid-item, hang). The plan
is evaluated at each hook site through :meth:`FaultPlan.hit`; with no plan armed every
site costs one ``is None`` check.

Determinism: triggers never consult the wall clock or ``random`` state. ``nth`` counts
matching hits a rule a process; ``probability`` is a pure function of ``(plan seed,
rule index, hit number)`` through crc32, so a scenario replays identically given the
same plan and the same per-process hit sequence. Across a concurrent pool the
interleaving of hits can vary, so poison and kill rules key by ``item_key``, which is
stable whichever thread or child processes the item.

Hook sites of the port:

=================  ====================================================
site               seam
=================  ====================================================
reader.read        ``_WorkerBase._read_columns_once``: every synchronous
                   row-group read attempt (retry attempts hit again)
reader.read_run    ``_WorkerBase._read_run_once``: coalesced ranged reads
io.pagedec         ``ArrowWorker._pagedec_read``: the pass-through's raw
                   page fetch of a row group (key ``<path>:<row group>``)
io.readahead       ``ReadaheadPool._read_task_body``: background reads
io.remote          ``RemoteEngine._run_attempt``: one ranged GET attempt
                   (key ``<path>:<offset>+<length>#primary|hedge``)
worker.item        sync and thread pools, around ``worker(item)``
pool.dispatch      ``ProcessExecutor._feed_child`` before the item ships
pool.recv          ``ProcessExecutor._recv_result`` before each receive
wire.decode        the feeder, once a result's frames before decoding
                   (the only site where ``corrupt`` mutates real bytes)
child.item         the pool child's loop, around ``worker(item)``
                   (the only site where ``kill`` takes the process down)
decode.device_inflate  ``DataLoader._inflate_passthrough``, once a batch
dataset.mutate     ``DatasetWatcher.poll_once``, once a watch tick when a
                   mutator is attached: the only site where the
                   ``remove_file``/``rewrite_file``/``append_piece``
                   actions change a real dataset
transport.send     ``transport/tcp.py``, once an outbound frame of a ready
                   tcp link (parent and child evaluate their own copies of
                   the plan): where the ``net.partition``/``net.reset``/
                   ``net.slow``/``net.corrupt_frame`` actions act
transport.recv     the same, once an inbound frame (before the crc check,
                   so ``net.corrupt_frame`` is caught by the trailer)
=================  ====================================================

The mutation actions call the method of the same name on the site's payload, a mutator such
as :class:`~petastorm_tpu_torch.dataset.mutate.LocalDatasetMutator`, with the rule's JSON
``target``. ``hang`` sleeps ``hang_s`` (ended early by a disarm):
the stall watchdog's prey (:mod:`petastorm_tpu_torch.obs.health`), which the process pool's
healer ends by killing the hung child under ``escalation="heal"``.

Every injected fault is recorded: a ``ptpu_degradations_total{cause="chaos_injected"}``
count, a ``chaos`` event in any live flight recorder, and an in-memory ledger
(:meth:`FaultPlan.injections`).
"""
from __future__ import annotations

import fnmatch
import json
import threading
import time
import zlib

_ACTIONS = ("raise_transient", "raise_permanent", "latency", "corrupt",
            "kill", "hang", "remove_file", "rewrite_file", "append_piece",
            "net.partition", "net.reset", "net.slow", "net.corrupt_frame")

#: network fault actions, evaluated at the tcp transport's ``transport.send`` and
#: ``transport.recv`` sites, whose payload is one raw wire frame. ``net.partition`` opens
#: a drop window of ``latency_s`` seconds on the firing rule: every frame matching that
#: rule's site pattern inside the window returns :data:`DROPPED`, and the transport drops
#: heartbeat frames (starving the peer's half-open detector) but stalls app frames at
#: the send site until the window closes or the link dies under them (TCP retransmits
#: through a partition: data is delayed or the connection torn down, never silently
#: lost). ``net.reset`` raises a ``ConnectionResetError`` the transport turns into a real
#: socket teardown; ``net.slow`` sleeps ``latency_s`` a frame; ``net.corrupt_frame``
#: flips a byte the receiver's crc32 trailer catches.
_NET_ACTIONS = ("net.partition", "net.reset", "net.slow", "net.corrupt_frame")


class _Dropped:
    """Sentinel :meth:`FaultPlan.hit` returns when a ``net.partition`` window swallowed
    the frame: transports check ``payload is DROPPED``."""

    def __repr__(self):
        return "<chaos DROPPED frame>"


DROPPED = _Dropped()

#: dataset-mutation actions, evaluated at the ``dataset.mutate`` site, whose payload is a
#: mutator with a method of each name; ``rule.target`` is the JSON spec handed to it
_MUTATE_ACTIONS = ("remove_file", "rewrite_file", "append_piece")

#: process-role flag: ``kill`` only ever takes down a pool child (or a process
#: that explicitly opted in, e.g. the chaos harness's subprocesses) — firing
#: ``os._exit`` inside the training process would kill the job the
#: chaos plane exists to protect.
_kill_allowed = False


def allow_kill(value=True):
    """Mark this process as killable by the ``kill`` action (pool children
    call this when arming from the environment)."""
    global _kill_allowed
    _kill_allowed = bool(value)


def kill_allowed():
    return _kill_allowed


class ChaosError(RuntimeError):
    """A chaos action could not execute as configured (e.g. ``kill`` evaluated
    in a process that did not opt in) — always a plan-authoring error."""


class FaultRule:
    """One injection rule: site pattern × trigger × action.

    Parameters
    ----------
    site : str
        fnmatch pattern over hook-site names (``"reader.*"``, ``"child.item"``).
    action : str
        One of ``raise_transient`` (a ``ConnectionResetError`` — classified
        transient by the retry machinery), ``raise_permanent`` (a
        ``FileNotFoundError`` — never retried), ``latency`` (sleep
        ``latency_s``), ``corrupt`` (flip a byte in the site's payload — only
        meaningful at ``wire.decode``), ``kill`` (``os._exit`` — pool children
        only), ``hang`` (sleep ``hang_s``), ``remove_file``/``rewrite_file``/
        ``append_piece`` (call the ``dataset.mutate`` site's mutator with
        ``target``), and the tcp transport's ``net.partition``, ``net.reset``,
        ``net.slow`` and ``net.corrupt_frame`` (see ``_NET_ACTIONS``).
    nth : int, optional
        Fire on the Nth matching hit (1-based), counted per rule per process.
    every : int, optional
        Fire on every Nth matching hit (combines with ``nth`` as an offset:
        ``nth=2, every=3`` fires on hits 2, 5, 8, ...).
    probability : float, optional
        Fire with this probability — deterministic per ``(seed, rule, hit)``.
    item_key : str, optional
        Only hits whose key contains this substring match (and count).
    times : int, optional
        Total-fire budget (None = unlimited).
    latency_s / hang_s / message :
        Action parameters.
    target : optional
        Dataset-mutation action spec (JSON data; see
        :mod:`petastorm_tpu_torch.dataset.mutate` for the shapes the mutation
        actions take).
    """

    __slots__ = ("site", "action", "nth", "every", "probability", "item_key",
                 "times", "latency_s", "hang_s", "message", "target")

    def __init__(self, site, action, nth=None, every=None, probability=None,
                 item_key=None, times=None, latency_s=0.05, hang_s=3600.0,
                 message=None, target=None):
        if action not in _ACTIONS:
            raise ValueError("action must be one of %s, got %r"
                             % (_ACTIONS, action))
        if nth is not None and int(nth) < 1:
            raise ValueError("nth is 1-based (the first matching hit is 1)")
        if probability is not None and not (0.0 <= float(probability) <= 1.0):
            raise ValueError("probability must be in [0, 1]")
        self.site = site
        self.action = action
        self.nth = None if nth is None else int(nth)
        self.every = None if every is None else max(1, int(every))
        self.probability = None if probability is None else float(probability)
        self.item_key = item_key
        self.times = None if times is None else int(times)
        self.latency_s = float(latency_s)
        self.hang_s = float(hang_s)
        self.message = message
        self.target = target

    def to_spec(self):
        return {name: getattr(self, name) for name in self.__slots__}

    @classmethod
    def from_spec(cls, spec):
        return cls(**spec)

    def __repr__(self):
        trig = []
        if self.nth is not None:
            trig.append("nth=%d" % self.nth)
        if self.every is not None:
            trig.append("every=%d" % self.every)
        if self.probability is not None:
            trig.append("p=%g" % self.probability)
        if self.item_key is not None:
            trig.append("key~%r" % self.item_key)
        return "<FaultRule %s %s %s>" % (self.site, self.action,
                                         " ".join(trig) or "always")


def _coin(seed, rule_idx, hit_no, probability):
    """Deterministic biased coin: crc32 of the identifying triple, uniform
    over 2**32 (no ``random`` state, no wall clock — replayable)."""
    h = zlib.crc32(("%d|%d|%d" % (seed, rule_idx, hit_no)).encode("ascii"))
    return (h & 0xFFFFFFFF) / 4294967296.0 < probability


def item_key(item):
    """Stable key for a dispatched plan item: the tagged ``(epoch, ordinal,
    (piece, partition))`` shape the reader dispatches resolves to
    ``"epoch=E ordinal=O <path>:<row_group>"``; anything else keys by repr.
    ``FaultRule.item_key`` substring-matches against this."""
    try:
        if isinstance(item, tuple) and len(item) == 3:
            epoch, ordinal, inner = item
            piece = inner[0] if isinstance(inner, tuple) and inner else inner
            path = getattr(piece, "path", None)
            rg = getattr(piece, "row_group", None)
            if path is not None:
                return "epoch=%s ordinal=%s %s:%s" % (epoch, ordinal, path, rg)
            return "epoch=%s ordinal=%s %r" % (epoch, ordinal, inner)
    except Exception:  # noqa: BLE001 — a key must never fail the dispatch
        pass  # graftlint: disable=GL-O002 (falls through to the repr key)
    return repr(item)


class FaultPlan:
    """A seeded set of :class:`FaultRule` evaluated at the pipeline's hook
    sites. Thread-safe (hits come from every pipeline thread); pickle/JSON
    round-trippable (the plan crosses the pool handshake via the
    ``PTPU_CHAOS_SPEC`` environment variable — see :func:`..arm`)."""

    def __init__(self, rules, seed=0, max_ledger=4096):
        self._rules = list(rules)
        for r in self._rules:
            if not isinstance(r, FaultRule):
                raise TypeError("FaultPlan takes FaultRule instances, got %r"
                                % type(r).__name__)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._hits = [0] * len(self._rules)   # matching hits per rule
        self._fires = [0] * len(self._rules)  # executed actions per rule
        #: rule index -> monotonic deadline of an open net.partition window: frames
        #: matching that rule's site pattern are dropped until then
        self._drop_until = {}
        self._dropped_frames = 0
        self._ledger = []
        self._max_ledger = int(max_ledger)

    @property
    def rules(self):
        return list(self._rules)

    # -- evaluation (the per-site hook) -------------------------------------------------

    def hit(self, site, key=None, payload=None):
        """Evaluate every rule against one hook-site hit.

        May sleep (``latency``/``hang``/``net.slow``), raise (``raise_*``,
        ``net.reset``), exit the process (``kill``, opted-in processes only), return a
        corrupted copy of ``payload`` (``corrupt``/``net.corrupt_frame``) or return
        :data:`DROPPED` (an open ``net.partition`` window swallowed the frame); returns
        ``payload`` unchanged when nothing fires. Hook sites call this only when a plan
        is armed."""
        if self._drop_until and self._in_drop_window(site):
            return DROPPED
        for idx, rule in enumerate(self._rules):
            if not fnmatch.fnmatchcase(site, rule.site):
                continue
            if rule.item_key is not None and (key is None
                                              or rule.item_key not in key):
                continue
            with self._lock:
                self._hits[idx] += 1
                hit_no = self._hits[idx]
                if not self._should_fire(rule, idx, hit_no):
                    continue
                self._fires[idx] += 1
            payload = self._execute(rule, idx, site, key, payload)
        return payload

    def _in_drop_window(self, site):
        """Is ``site`` inside an open ``net.partition`` window? Expired windows are
        pruned; dropped frames are counted (not ledgered: a partition drops heartbeats
        at wire rate)."""
        now = time.monotonic()
        with self._lock:
            for idx, deadline in list(self._drop_until.items()):
                if now >= deadline:
                    del self._drop_until[idx]
                    continue
                if fnmatch.fnmatchcase(site, self._rules[idx].site):
                    self._dropped_frames += 1
                    return True
        return False

    def _should_fire(self, rule, idx, hit_no):
        """Caller holds the lock. Trigger conditions compose conjunctively."""
        if rule.times is not None and self._fires[idx] >= rule.times:
            return False
        if rule.every is not None:
            anchor = rule.nth if rule.nth is not None else rule.every
            if hit_no < anchor or (hit_no - anchor) % rule.every != 0:
                return False
        elif rule.nth is not None and hit_no != rule.nth:
            return False
        if rule.probability is not None and not _coin(
                self.seed, idx, hit_no, rule.probability):
            return False
        return True

    def _execute(self, rule, idx, site, key, payload):
        self._record(rule, idx, site, key)
        action = rule.action
        if action == "latency":
            time.sleep(rule.latency_s)
            return payload
        if action == "hang":
            # sleep in small slices so a disarm() (or the process being killed
            # by the heal tier) ends the hang promptly instead of pinning the
            # thread for the full duration after the scenario moved on
            deadline = time.monotonic() + rule.hang_s
            while time.monotonic() < deadline:
                if _current_plan() is not self:
                    return payload
                time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))
            return payload
        if action == "raise_transient":
            raise ConnectionResetError(
                rule.message or "chaos-injected transient IO error at %s (%s)"
                % (site, key))
        if action == "raise_permanent":
            raise FileNotFoundError(
                rule.message or "chaos-injected permanent IO error at %s (%s)"
                % (site, key))
        if action in ("corrupt", "net.corrupt_frame"):
            return _corrupt_payload(payload, self.seed, idx)
        if action == "net.slow":
            time.sleep(rule.latency_s)
            return payload
        if action == "net.reset":
            # the transport turns this into a real socket teardown, which the peer
            # observes too: exactly a mid-frame connection reset
            raise ConnectionResetError(
                rule.message or "chaos net.reset at %s (%s)" % (site, key))
        if action == "net.partition":
            # open the drop window (latency_s is its length) and swallow the frame
            # that fired it
            with self._lock:
                self._drop_until[idx] = time.monotonic() + rule.latency_s
                self._dropped_frames += 1
            return DROPPED
        if action in _MUTATE_ACTIONS:
            # the dataset.mutate site passes a mutator as the payload; the action is a
            # call of its method with the rule's spec
            method = getattr(payload, action, None)
            if method is None:
                raise ChaosError(
                    "chaos %r fired at %s without a dataset mutator payload; mutation "
                    "rules target the 'dataset.mutate' site of a watcher with a mutator "
                    "attached (DatasetWatcher.set_mutator)" % (action, site))
            method(rule.target)
            return payload
        if action == "kill":
            if not _kill_allowed:
                raise ChaosError(
                    "chaos 'kill' action fired at %s in a process that did not "
                    "opt in (allow_kill); kill rules target in-child sites "
                    "like 'child.item'" % site)
            import os as _os

            _os._exit(137)  # SIGKILL-like: no teardown, exactly a crashed child
        raise ChaosError("unknown chaos action %r" % action)  # unreachable

    def _record(self, rule, idx, site, key):
        entry = {"site": site, "action": rule.action, "rule": idx,
                 "key": key, "t": time.time()}
        with self._lock:
            if len(self._ledger) < self._max_ledger:
                self._ledger.append(entry)
        from petastorm_tpu_torch.obs import flight as _flight
        from petastorm_tpu_torch.obs.log import degradation

        for recorder in _flight.active_recorders():
            recorder.record("chaos", site=site, action=rule.action, key=key)
        degradation(
            "chaos_injected",
            "chaos plane injected %s at %s (key=%s, rule %d)", rule.action,
            site, key, idx)

    # -- inspection ---------------------------------------------------------------------

    def injections(self):
        """The in-process injection ledger (site/action/rule/key dicts, in
        order). A pool child's injections live in ITS process — the harness
        observes those through the degradation/flight record instead."""
        with self._lock:
            return list(self._ledger)

    def stats(self):
        with self._lock:
            return {
                "hits": list(self._hits),
                "fires": list(self._fires),
                "injected_total": sum(self._fires),
                "dropped_frames": self._dropped_frames,
            }

    # -- (de)serialization --------------------------------------------------------------

    def to_json(self):
        return json.dumps({"seed": self.seed,
                           "rules": [r.to_spec() for r in self._rules]})

    @classmethod
    def from_json(cls, text):
        spec = json.loads(text)
        return cls([FaultRule.from_spec(r) for r in spec["rules"]],
                   seed=spec.get("seed", 0))

    def __repr__(self):
        return "<FaultPlan seed=%d rules=%r>" % (self.seed, self._rules)


def _corrupt_payload(payload, seed, rule_idx):
    """Flip one byte in the largest buffer of ``payload`` (a list of wire
    frames, or a single bytes-like). Returns a corrupted COPY — the original
    buffers may be views into shared memory someone else still owns."""
    if payload is None:
        raise ChaosError(
            "chaos 'corrupt' fired at a site with no byte payload; corrupt "
            "rules target 'wire.decode'")
    frames = list(payload) if isinstance(payload, (list, tuple)) else [payload]
    sizes = [len(memoryview(f).cast("B")) if f is not None else 0
             for f in frames]
    target = max(range(len(frames)), key=lambda i: sizes[i])
    if sizes[target] == 0:
        raise ChaosError("chaos 'corrupt' fired on an empty payload")
    buf = bytearray(memoryview(frames[target]).cast("B"))
    pos = zlib.crc32(("corrupt|%d|%d" % (seed, rule_idx)).encode("ascii")) \
        % len(buf)
    buf[pos] ^= 0xFF
    frames[target] = bytes(buf)
    if isinstance(payload, (list, tuple)):
        return type(payload)(frames) if isinstance(payload, tuple) else frames
    return frames[0]


def _current_plan():
    """The armed plan (import indirection so ``hang`` can notice disarm)."""
    from petastorm_tpu_torch import chaos

    return chaos.ACTIVE
