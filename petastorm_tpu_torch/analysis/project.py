"""Whole-program analysis context.

The per-file rules see one module at a time, which is exactly why the controller
deadlock escaped them: ``_DONE`` was posted while holding ``_active_lock``
*through a helper call*, and the helper's blocking ``Queue.put()`` lived three
screens away from the ``with`` block. :class:`ProjectContext` gives rules the
project-wide view those bugs hide in:

- **one index over the already-parsed corpus** — the engine hands over the
  same :class:`~petastorm_tpu_torch.analysis.engine.FileContext` objects the
  per-file phase used (no re-read, no re-parse), and this module indexes
  modules, classes, and methods over them;

- **lock identities** — every ``self.<attr>`` bound to a
  ``threading.Lock``/``RLock``/``Condition`` constructor is a tracked lock,
  keyed ``(class, attr)``. A lock *passed between constructors*
  (``self._b = Helper(self._lock)`` where ``Helper.__init__`` stores the
  parameter onto ``self``) is unified into ONE identity via union-find, so an
  acquisition through either name feeds the same lock-order node;

- **receiver typing project-style** — queues (with boundedness: ``put`` only
  blocks on a maxsize'd queue), Events, Threads, ``Connection``s, sockets and
  executor-built futures bound to ``self.<attr>`` anywhere in a class;

- **a conservative one-level intra-module call graph** — ``self.helper(...)``
  resolves to the same class's method, a bare ``helper(...)`` to a
  module-level ``def`` in the same file. One hop only, resolution must be
  unambiguous, and anything dynamic resolves to nothing: the goal is zero
  false edges, not completeness.

On top sit the project rules (``rules/project_concurrency.py``): GL-C005
(blocking call reached while a tracked lock is held, including through one
call hop — the controller shape) and GL-C006 (lock-order cycles across the global
acquisition graph, reported with both witness paths).
"""
from __future__ import annotations

import ast
import os

from petastorm_tpu_torch.analysis.rules._astutil import (
    attr_chain,
    call_kwarg,
    children,
    self_attr,
    walk,
)

#: lock constructors → kind; Condition is a lock (acquired via ``with``) whose
#: ``wait()`` additionally RELEASES it while blocked — the rules special-case
#: that
_LOCK_KINDS = {
    "threading.Lock": "lock", "Lock": "lock",
    "threading.RLock": "rlock", "RLock": "rlock",
    "threading.Condition": "condition", "Condition": "condition",
}

#: queue constructors whose ``put`` can block when a maxsize is given
_QUEUE_CTORS = frozenset((
    "queue.Queue", "Queue", "queue.LifoQueue", "LifoQueue",
    "queue.PriorityQueue", "PriorityQueue", "queue.JoinableQueue",
    "JoinableQueue", "multiprocessing.Queue", "mp.Queue",
))
#: unbounded by construction: ``put`` never blocks, ``get`` still does
_SIMPLE_QUEUE_CTORS = frozenset(("queue.SimpleQueue", "SimpleQueue"))
_EVENT_CTORS = frozenset(("threading.Event", "Event"))
_THREAD_CTORS = frozenset(("threading.Thread", "Thread", "threading.Timer",
                           "Timer", "multiprocessing.Process", "Process",
                           "mp.Process"))
_CONN_CTORS = frozenset(("Client", "multiprocessing.connection.Client"))
_SOCK_CTORS = frozenset(("socket.socket", "socket.create_connection",
                         "create_connection"))

#: socket methods that block on a quiet peer (both directions: a full send
#: buffer against a stalled reader parks ``send``/``sendall`` too)
_SOCK_BLOCKING = frozenset(("recv", "recv_into", "recvfrom", "accept",
                            "connect", "send", "sendall"))


def _bounded_arg(node):
    """True when an explicit timeout argument actually bounds the call: any
    expression except the literal ``None`` (which is "block forever" spelled
    out). Dynamic timeouts are assumed real."""
    return node is not None and not (
        isinstance(node, ast.Constant) and node.value is None)


def _iter_methods(cls_node):
    for node in cls_node.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


class ClassInfo:
    """One class's project-phase typing: methods by name plus the
    ``self.<attr>`` receiver types collected from every constructor
    assignment in the class body."""

    def __init__(self, module, node):
        self.module = module
        self.node = node
        self.name = node.name
        self.qualname = "%s.%s" % (module.name, node.name)
        self.methods = {m.name: m for m in _iter_methods(node)}
        self.lock_attrs = {}     # attr -> "lock" | "rlock" | "condition"
        self.queue_attrs = {}    # attr -> bool (True: put can block)
        self.event_attrs = set()
        self.thread_attrs = set()
        self.conn_attrs = set()
        self.sock_attrs = set()
        self.sock_bounded = set()
        self.future_attrs = set()
        #: __init__ parameter name -> self attr it is stored to (lock-identity
        #: unification input)
        self.init_param_attrs = {}

    def collect(self):
        init = self.methods.get("__init__")
        init_params = set()
        if init is not None:
            args = init.args
            init_params = {a.arg for a in (args.posonlyargs + args.args
                                           + args.kwonlyargs)} - {"self"}
        for method in self.methods.values():
            for node in walk(method):
                if isinstance(node, ast.Assign):
                    self._collect_assign(node, method, init_params)
                elif isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "settimeout" and node.args:
                    recv = self_attr(node.func.value)
                    if recv is None:
                        continue
                    arg = node.args[0]
                    if isinstance(arg, ast.Constant) and arg.value is None:
                        self.sock_bounded.discard(recv)
                    else:
                        self.sock_bounded.add(recv)

    def _collect_assign(self, node, method, init_params):
        value = node.value
        chain = attr_chain(value.func) if isinstance(value, ast.Call) else None
        for target in node.targets:
            attr = self_attr(target)
            if attr is None:
                continue
            if chain in _LOCK_KINDS:
                self.lock_attrs[attr] = _LOCK_KINDS[chain]
            elif chain in _QUEUE_CTORS:
                self.queue_attrs[attr] = self._queue_possibly_bounded(value)
            elif chain in _SIMPLE_QUEUE_CTORS:
                self.queue_attrs[attr] = False
            elif chain in _EVENT_CTORS:
                self.event_attrs.add(attr)
            elif chain in _THREAD_CTORS:
                self.thread_attrs.add(attr)
            elif chain is not None and \
                    chain.split(".")[-1] in ("Client",) and \
                    (chain in _CONN_CTORS):
                self.conn_attrs.add(attr)
            elif chain in _SOCK_CTORS:
                self.sock_attrs.add(attr)
                if chain.endswith("create_connection") and \
                        _bounded_arg(call_kwarg(value, "timeout")):
                    self.sock_bounded.add(attr)
            elif isinstance(value, ast.Call) and \
                    isinstance(value.func, ast.Attribute) and \
                    value.func.attr == "submit":
                # an executor-built future: `self._fut = pool.submit(...)`
                self.future_attrs.add(attr)
            elif method.name == "__init__" and isinstance(value, ast.Name) \
                    and value.id in init_params:
                self.init_param_attrs[value.id] = attr

    @staticmethod
    def _queue_possibly_bounded(call):
        """Whether ``put`` on this queue can block. ``Queue()`` and
        ``Queue(0)`` are infinite (put never blocks); a literal positive
        maxsize is bounded; a DYNAMIC maxsize is treated as bounded — pipeline
        queues are bounded by design, and an unbounded one would not need the
        parameter."""
        maxsize = call.args[0] if call.args else call_kwarg(call, "maxsize")
        if maxsize is None:
            return False
        if isinstance(maxsize, ast.Constant):
            try:
                return maxsize.value is not None and int(maxsize.value) > 0
            except (TypeError, ValueError):
                return True
        return True


class ModuleInfo:
    """One parsed file: its FileContext plus class/function indexes."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.path = ctx.path
        self.name = os.path.splitext(os.path.basename(ctx.path))[0]
        self.tree = ctx.tree
        self.classes = {}    # class name -> ClassInfo (module-level classes)
        self.functions = {}  # module-level def name -> FunctionDef
        self.sleep_aliases = {"time.sleep"}
        for node in ctx.tree.body:
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = ClassInfo(self, node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
        for node in ctx.by_type(ast.ImportFrom):
            if node.module == "time":
                for a in node.names:
                    if a.name == "sleep":
                        self.sleep_aliases.add(a.asname or "sleep")

    def rel_label(self):
        """Short path label for witness messages (basename keeps messages
        readable; the Finding itself carries the full path)."""
        return os.path.basename(self.path)


class BlockingSite:
    """One blocking call found by the classifier: where, why, and — for a
    ``Condition.wait`` — which lock identity the wait legitimately holds."""

    __slots__ = ("node", "reason", "cond_key")

    def __init__(self, node, reason, cond_key=None):
        self.node = node
        self.reason = reason
        self.cond_key = cond_key


class ProjectContext:
    """The whole-program index: built once per lint run from the parsed
    corpus, shared by every :class:`ProjectRule`."""

    def __init__(self, file_contexts):
        self.modules = [ModuleInfo(ctx) for ctx in file_contexts]
        self.modules_by_path = {m.path: m for m in self.modules}
        self._classes_by_name = {}
        for module in self.modules:
            for cls in module.classes.values():
                self._classes_by_name.setdefault(cls.name, []).append(cls)
        for module in self.modules:
            for cls in module.classes.values():
                cls.collect()
        self._alias_parent = {}  # union-find over (class_qualname, attr) keys
        self._lock_labels = {}   # representative key -> display label
        self._unify_ctor_passed_locks()
        self._summaries = {}

    # -- lock identity -----------------------------------------------------------------

    def _find(self, key):
        parent = self._alias_parent.get(key, key)
        if parent == key:
            return key
        root = self._find(parent)
        self._alias_parent[key] = root
        return root

    def _union(self, a, b):
        ra, rb = self._find(a), self._find(b)
        if ra == rb:
            return
        # deterministic representative: lexicographically smaller key wins
        lo, hi = (ra, rb) if ra <= rb else (rb, ra)
        self._alias_parent[hi] = lo

    def lock_id(self, cls, attr):
        """Canonical identity key for ``cls``'s lock attribute ``attr``."""
        return self._find((cls.qualname, attr))

    def lock_label(self, key):
        """``Class._attr`` display label for a canonical lock key."""
        qual, attr = key
        return "%s.%s" % (qual.split(".", 1)[1], attr)

    def _unify_ctor_passed_locks(self):
        """``self._b = Helper(self._lock)`` where ``Helper.__init__`` stores
        the parameter onto ``self`` makes the two attributes ONE lock. Only
        unambiguous targets unify: the callee's last dotted segment must name
        exactly one class in the project."""
        for module in self.modules:
            for cls in module.classes.values():
                for method in cls.methods.values():
                    for node in walk(method):
                        if isinstance(node, ast.Call):
                            self._unify_call(cls, node)

    def _unify_call(self, caller, call):
        chain = attr_chain(call.func)
        if chain is None:
            return
        candidates = self._classes_by_name.get(chain.split(".")[-1])
        if candidates is None or len(candidates) != 1:
            return
        callee = candidates[0]
        if not callee.init_param_attrs:
            return
        init = callee.methods.get("__init__")
        if init is None:
            return
        params = [a.arg for a in (init.args.posonlyargs + init.args.args)]
        if params and params[0] == "self":
            params = params[1:]
        pairs = []
        for i, arg in enumerate(call.args):
            if i < len(params):
                pairs.append((params[i], arg))
        for kw in call.keywords:
            if kw.arg is not None:
                pairs.append((kw.arg, kw.value))
        for param, arg in pairs:
            stored_attr = callee.init_param_attrs.get(param)
            if stored_attr is None:
                continue
            passed_attr = self_attr(arg)
            if passed_attr is None or passed_attr not in caller.lock_attrs:
                continue
            callee.lock_attrs.setdefault(
                stored_attr, caller.lock_attrs[passed_attr])
            self._union((caller.qualname, passed_attr),
                        (callee.qualname, stored_attr))

    # -- call graph --------------------------------------------------------------------

    def resolve_call(self, module, cls, call):
        """One-level intra-module resolution: ``self.m(...)`` → the same
        class's method, bare ``f(...)`` → a module-level def of the same
        file. Returns ``(owner_cls_or_None, FunctionDef)`` or None."""
        func = call.func
        if isinstance(func, ast.Attribute) and cls is not None and \
                isinstance(func.value, ast.Name) and func.value.id == "self":
            target = cls.methods.get(func.attr)
            if target is not None:
                return cls, target
            return None
        if isinstance(func, ast.Name):
            target = module.functions.get(func.id)
            if target is not None:
                return None, target
        return None

    # -- blocking-call classification --------------------------------------------------

    def blocking_reason(self, module, cls, call):
        """Classify one Call as an unbounded blocking call under the typing
        env of ``cls``/``module``. Returns a :class:`BlockingSite` or None.

        Timed variants are clean everywhere here: a bounded wait under a lock
        is a latency bug at worst, not a deadlock."""
        func = call.func
        chain = attr_chain(func)
        if chain in module.sleep_aliases:
            return BlockingSite(call, "`%s(...)` sleeps" % chain)
        if not isinstance(func, ast.Attribute):
            return None
        meth = func.attr
        attr = self_attr(func.value) if cls is not None else None
        if attr is None:
            return None
        if attr in cls.queue_attrs:
            if meth == "get" and not self._get_bounded(call):
                return BlockingSite(
                    call, "`self.%s.get()` has no timeout" % attr)
            if meth == "put" and cls.queue_attrs[attr] and \
                    not self._put_bounded(call):
                return BlockingSite(
                    call, "`self.%s.put()` has no timeout and the queue is "
                          "bounded" % attr)
        elif attr in cls.event_attrs:
            if meth == "wait" and not self._first_arg_bounded(call):
                return BlockingSite(
                    call, "`self.%s.wait()` has no timeout" % attr)
        elif attr in cls.thread_attrs:
            if meth == "join" and not self._first_arg_bounded(call):
                return BlockingSite(
                    call, "`self.%s.join()` has no timeout" % attr)
        elif attr in cls.conn_attrs:
            if meth in ("recv", "recv_bytes", "send", "send_bytes"):
                return BlockingSite(
                    call, "`self.%s.%s()` on a Connection blocks with no "
                          "timeout parameter" % (attr, meth))
        elif attr in cls.sock_attrs and attr not in cls.sock_bounded:
            if meth in _SOCK_BLOCKING:
                return BlockingSite(
                    call, "`self.%s.%s()` on a socket with no settimeout"
                          % (attr, meth))
        elif attr in cls.future_attrs:
            if meth == "result" and not self._first_arg_bounded(call):
                return BlockingSite(
                    call, "`self.%s.result()` has no timeout" % attr)
        elif attr in cls.lock_attrs and \
                cls.lock_attrs[attr] == "condition":
            if meth in ("wait", "wait_for"):
                timeout = call_kwarg(call, "timeout")
                pos = 1 if meth == "wait_for" else 0
                if len(call.args) > pos:
                    timeout = call.args[pos]
                if not _bounded_arg(timeout):
                    return BlockingSite(
                        call,
                        "`self.%s.%s()` has no timeout" % (attr, meth),
                        cond_key=self.lock_id(cls, attr))
        return None

    @staticmethod
    def _get_bounded(call):
        """``Queue.get(block, timeout)``: non-blocking or timed forms."""
        if _bounded_arg(call_kwarg(call, "timeout")):
            return True
        if len(call.args) >= 2:
            return _bounded_arg(call.args[1])
        if len(call.args) == 1 and isinstance(call.args[0], ast.Constant) \
                and not call.args[0].value:
            return True
        block = call_kwarg(call, "block")
        return block is not None and isinstance(block, ast.Constant) \
            and not block.value

    @staticmethod
    def _put_bounded(call):
        """``Queue.put(item, block, timeout)``: non-blocking or timed forms."""
        if _bounded_arg(call_kwarg(call, "timeout")):
            return True
        if len(call.args) >= 3:
            return _bounded_arg(call.args[2])
        if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
                and not call.args[1].value:
            return True
        block = call_kwarg(call, "block")
        return block is not None and isinstance(block, ast.Constant) \
            and not block.value

    @staticmethod
    def _first_arg_bounded(call):
        """``join(timeout)`` / ``wait(timeout)`` / ``result(timeout)``."""
        if _bounded_arg(call_kwarg(call, "timeout")):
            return True
        return len(call.args) >= 1 and _bounded_arg(call.args[0])

    # -- function summaries (the one-hop seam) -----------------------------------------

    def summary(self, module, cls, func):
        """What calling ``func`` can do while the CALLER holds a lock:
        ``blocking`` — BlockingSites anywhere in its body (nested defs
        excluded: they run later, elsewhere); ``acquires`` — lock identities
        it takes via ``with self.<lock>``. Cached per function."""
        key = id(func)
        cached = self._summaries.get(key)
        if cached is not None:
            return cached
        blocking, acquires = [], []
        stack = list(func.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue  # deferred execution: not part of this call
            if isinstance(node, ast.With):
                for item in node.items:
                    attr = self_attr(item.context_expr)
                    if cls is not None and attr in cls.lock_attrs:
                        acquires.append(
                            (self.lock_id(cls, attr), item.context_expr))
            if isinstance(node, ast.Call):
                site = self.blocking_reason(module, cls, node)
                if site is not None:
                    blocking.append(site)
            stack.extend(children(node))
        result = {"blocking": blocking, "acquires": acquires}
        self._summaries[key] = result
        return result

    # -- lock-region walking -----------------------------------------------------------

    def lock_region_events(self, module, cls, method):
        """Walk one method yielding, in source order:

        - ``("acquire", lock_key, node, held_before)`` at each ``with
          self.<lock>`` entry;
        - ``("block", BlockingSite, held)`` at each unbounded blocking call;
        - ``("call", call_node, (owner, funcdef), held)`` at each resolvable
          one-hop call.

        ``held`` is the frozenset of lock identities lexically held. Nested
        function bodies are walked with an EMPTY held set — a closure runs
        later, usually on another thread, when the lock is no longer held
        (same principle as GL-C001's collector)."""
        events = []
        self._walk_region(module, cls, method.body, frozenset(), events)
        return events

    def _walk_region(self, module, cls, body, held, events):
        for node in body:
            self._visit_region(module, cls, node, held, events)

    def _visit_region(self, module, cls, node, held, events):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._walk_region(module, cls, node.body, frozenset(), events)
            return
        if isinstance(node, ast.Lambda):
            self._visit_region(module, cls, node.body, frozenset(), events)
            return
        if isinstance(node, ast.With):
            inner = held
            for item in node.items:
                attr = self_attr(item.context_expr)
                if attr is not None and attr in cls.lock_attrs:
                    key = self.lock_id(cls, attr)
                    events.append(("acquire", key, item.context_expr, inner))
                    inner = inner | {key}
                else:
                    self._visit_region(module, cls, item.context_expr, held,
                                       events)
            self._walk_region(module, cls, node.body, inner, events)
            return
        if isinstance(node, ast.Call):
            site = self.blocking_reason(module, cls, node)
            if site is not None:
                events.append(("block", site, held))
            else:
                resolved = self.resolve_call(module, cls, node)
                if resolved is not None:
                    events.append(("call", node, resolved, held))
        for child in children(node):
            self._visit_region(module, cls, child, held, events)
