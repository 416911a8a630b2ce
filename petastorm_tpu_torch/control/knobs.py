"""Live pipeline knobs: the bounded, thread-safe actuation seam.

Port of ``petastorm_tpu.control.knobs``. The options structs (``IoOptions``,
``RemoteIoOptions``) are configuration: immutable, shareable and picklable, read once by
each component. Live retunes go through the components' ``apply_*()`` setters instead
(``ReadaheadPool.apply_depth``, ``RemoteReadEngine.apply_max_inflight``,
``ThreadExecutor.resize``, ...), each under the component's own lock, and the options are
never mutated:

- :class:`Knob` describes one tunable: bounds, default, and the getter and setter that
  bind it to a live component.
- :class:`KnobSet` is the registry the controller actuates through: ``apply()`` clamps
  into the knob's bounds, calls the setter and reports the change; ``describe()`` and
  ``collect()`` read the LIVE values (dashboards and the controller's own feedback read
  the truth after a retune, not the construction-time configuration).

:func:`build_knobset` wires the standard knobs of a running
:class:`~petastorm_tpu_torch.reader.Reader`.
"""
from __future__ import annotations

import threading

#: enum knobs export their value as its index into ``values`` (gauges are numeric);
#: ``describe()`` carries the string
ENUM = "enum"
NUMERIC = "numeric"


class Knob:
    """One live tunable: bounds and the closures binding it to a component.

    ``get()`` returns the live value; ``apply_fn(value)`` retunes the component and
    returns the value actually applied (a component may quantize). For ``kind="enum"``
    the domain is ``values`` instead of ``[lo, hi]``."""

    __slots__ = ("name", "kind", "get", "apply_fn", "lo", "hi", "default", "values",
                 "integer", "unit")

    def __init__(self, name, get, apply_fn, lo=None, hi=None, default=None, values=None,
                 integer=True, unit=""):
        self.name = name
        self.get = get
        self.apply_fn = apply_fn
        self.kind = ENUM if values is not None else NUMERIC
        self.values = tuple(values) if values is not None else None
        self.lo = lo
        self.hi = hi
        self.default = default if default is not None else get()
        self.integer = bool(integer)
        self.unit = unit

    def clamp(self, value):
        """The in-bounds value closest to ``value`` (an enum member as is; another enum
        value raises ``ValueError``: an enum has no nearest neighbour)."""
        if self.kind == ENUM:
            if value not in self.values:
                raise ValueError("knob %r accepts %s, got %r"
                                 % (self.name, self.values, value))
            return value
        value = float(value)
        if self.lo is not None:
            value = max(float(self.lo), value)
        if self.hi is not None:
            value = min(float(self.hi), value)
        if self.integer:
            value = int(round(value))
        return value

    def numeric_value(self, value=None):
        """The knob's value as a number (an enum as its index): the export shape."""
        value = self.get() if value is None else value
        if self.kind == ENUM:
            try:
                return self.values.index(value)
            except ValueError:
                return -1
        return value


class KnobSet:
    """Thread-safe registry of live knobs: the controller's actuation seam.

    Every change goes through :meth:`apply` (bounded, serialized under one lock); reads
    (:meth:`get`, :meth:`describe`, :meth:`collect`) return live component state.
    :meth:`checkpoint` and :meth:`restore` are the controller's revert."""

    def __init__(self):
        self._lock = threading.RLock()
        self._knobs = {}

    # -- registration -------------------------------------------------------------------

    def add(self, knob):
        with self._lock:
            if knob.name in self._knobs:
                raise ValueError("knob %r already registered" % knob.name)
            self._knobs[knob.name] = knob
        return knob

    def numeric(self, name, get, apply_fn, lo, hi, default=None, integer=True, unit=""):
        return self.add(Knob(name, get, apply_fn, lo=lo, hi=hi, default=default,
                             integer=integer, unit=unit))

    def enum(self, name, get, apply_fn, values, default=None):
        return self.add(Knob(name, get, apply_fn, values=values, default=default))

    # -- reads --------------------------------------------------------------------------

    def __contains__(self, name):
        with self._lock:
            return name in self._knobs

    def names(self):
        with self._lock:
            return sorted(self._knobs)

    def knob(self, name):
        with self._lock:
            return self._knobs[name]

    def get(self, name):
        """The LIVE value of ``name`` (read from the component)."""
        return self.knob(name).get()

    def describe(self):
        """``{name: {"value", "default", "lo", "hi" or "values", "unit"}}``: the live
        values beside their defaults (the stats panel's knob table)."""
        with self._lock:
            knobs = dict(self._knobs)
        out = {}
        for name, knob in knobs.items():
            entry = {"value": knob.get(), "default": knob.default, "unit": knob.unit}
            if knob.kind == ENUM:
                entry["values"] = knob.values
            else:
                entry["lo"] = knob.lo
                entry["hi"] = knob.hi
            out[name] = entry
        return out

    # -- actuation ----------------------------------------------------------------------

    def apply(self, name, value):
        """Retune ``name`` to the clamped ``value``. Returns ``(before, after)``, equal
        when the clamp or the component made the call a no-op."""
        with self._lock:
            knob = self._knobs[name]
            before = knob.get()
            target = knob.clamp(value)
            if target == before:
                return before, before
            after = knob.apply_fn(target)
            if after is None:
                after = knob.get()
        return before, after

    def checkpoint(self):
        """``{name: live value}``: the revert target the controller takes before an
        actuation experiment."""
        with self._lock:
            return {name: knob.get() for name, knob in self._knobs.items()}

    def restore(self, snapshot):
        """Apply a :meth:`checkpoint` again. Returns ``[(name, before, after)]`` of the
        knobs that moved (the revert decisions)."""
        moved = []
        for name, value in snapshot.items():
            if name not in self:
                continue
            before, after = self.apply(name, value)
            if after != before:
                moved.append((name, before, after))
        return moved

    # -- export -------------------------------------------------------------------------

    def collect(self):
        """Pull-collector payload: each knob's live value and default (numeric; an
        enum as its index), exported as ``ptpu_ctl_knob_*``."""
        with self._lock:
            knobs = dict(self._knobs)
        out = {}
        for name, knob in knobs.items():
            out["knob_%s" % name] = knob.numeric_value()
            out["knob_%s_default" % name] = knob.numeric_value(knob.default)
        return out


def _process_arena():
    from petastorm_tpu_torch.io import arena as arena_mod

    return arena_mod.process_arena()


def _arena_budget():
    arena_obj = _process_arena()
    return arena_obj.budget if arena_obj is not None else 0


def build_knobset(reader):
    """The standard :class:`KnobSet` over a running reader's live components.

    - ``workers``: the fleet size, actuating :meth:`Reader.resize_workers` (grow
      spawns, shrink drains between items); thread and process pools.
    - The IO knobs, bound for in-process pools (thread and dummy: the worker object is
      shared) and for process pools, whose ``broadcast_io_knobs`` sends a retune to the
      running children in a control frame (children spawned later inherit it through
      the worker's pickle): ``readahead_depth`` and ``readahead_bytes`` (the depth also
      resizes the dispatch lookahead and the IO thread pool); ``remote_max_inflight``
      and ``hedge_quantile`` when the ranged-GET engine is active for the reader's
      filesystem; ``pagedec``, the pass-through mode, when it is not off.
    - ``arena_bytes``: the host-wide arena budget, for every pool type (the budget
      lives in the arena's shared control segment, so a parent-side retune governs
      every attached process).
    - ``mem_cache_bytes`` and ``disk_admit``: in-process pools only (a process pool's
      cache tiers live in its children, with no parent-side value to read back).
    """
    ks = KnobSet()
    worker = getattr(reader, "_worker", None)
    opts = getattr(reader, "_io_options", None)
    pool_args = getattr(reader, "_pool_args", None) or {}
    pool_type = pool_args.get("reader_pool_type", "thread")
    configured_workers = pool_args.get("workers_count", 4)

    if getattr(reader, "resize_workers", None) is not None \
            and pool_type not in ("dummy", "sync"):
        def _workers_target():
            # the applied TARGET, not the alive count: retiring workers drain with a
            # lag, and a finished stream has none alive; both would feed the
            # controller (and its revert checkpoints) values nobody set
            target = getattr(reader._executor, "target_workers", None)
            return target if target is not None else configured_workers

        ks.numeric("workers", get=_workers_target, apply_fn=reader.resize_workers,
                   lo=1, hi=max(2 * configured_workers, 8), default=configured_workers)

    in_process = pool_type in ("thread", "dummy", "sync")
    can_broadcast = hasattr(getattr(reader, "_executor", None), "broadcast_io_knobs")
    if worker is None or opts is None or not (in_process or can_broadcast):
        return ks

    if opts.readahead:
        ks.numeric("readahead_depth",
                   get=lambda: worker.live_io_knobs()["readahead_depth"],
                   apply_fn=reader.apply_readahead_depth,
                   lo=1, hi=64, default=opts.readahead_depth)
        # lo=0: 0 is a legal value (the construction convention for "uncapped"); a
        # tighter floor would let a restore() clamp an uncapped budget into a cap
        ks.numeric("readahead_bytes",
                   get=lambda: worker.live_io_knobs()["readahead_bytes"],
                   apply_fn=reader.apply_readahead_bytes,
                   lo=0, hi=4 << 30, default=opts.readahead_bytes, unit="bytes")
    if opts.remote.active_for(worker._fs):
        ks.numeric("remote_max_inflight",
                   get=lambda: worker.live_io_knobs()["remote_max_inflight"],
                   apply_fn=reader.apply_remote_max_inflight,
                   lo=1, hi=64, default=opts.remote.max_inflight)
        ks.numeric("hedge_quantile",
                   get=lambda: worker.live_io_knobs()["hedge_quantile"],
                   apply_fn=reader.apply_hedge_quantile,
                   lo=0.5, hi=0.999, default=opts.remote.hedge_quantile, integer=False)
    if getattr(worker, "_pagedec_supported", False) and opts.pagedec != "off":
        # the controller's lever back to the host inflate when the device inflate
        # stage dominates
        ks.enum("pagedec", get=worker.live_pagedec, apply_fn=reader.apply_pagedec,
                values=("auto", "on", "off"), default=opts.pagedec)
    if _process_arena() is not None and opts.arena_bytes:
        ks.numeric("arena_bytes", get=_arena_budget, apply_fn=worker.apply_arena_bytes,
                   lo=8 << 20, hi=64 << 30, default=opts.arena_bytes, unit="bytes")
    if not in_process:
        return ks
    cache = getattr(worker, "_cache", None)
    mem = getattr(cache, "mem", None) if cache is not None else None
    if mem is not None:
        ks.numeric("mem_cache_bytes", get=lambda: mem.budget,
                   apply_fn=worker.apply_mem_cache_bytes,
                   lo=8 << 20, hi=16 << 30, default=mem.budget, unit="bytes")
    if cache is not None and hasattr(cache, "apply_disk_admit"):
        ks.enum("disk_admit", get=lambda: cache.disk_admit,
                apply_fn=cache.apply_disk_admit, values=("always", "scan-resistant"))
    return ks
