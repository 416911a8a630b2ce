"""Concurrency rules: lock discipline, blocking teardown, unmanaged threads.

These target the executor/loader layer (``workers.py``, ``loader.py``,
``reader.py``): classes mixing worker threads with shared mutable attributes,
where the classic latent bugs are a write that bypasses the lock every other
access holds, an untimed ``Queue.get()``/``Thread.join()`` on a shutdown path
(the 300s teardown hangs of VERDICT r4), and threads that outlive the process
because nobody daemonized or joined them.
"""
from __future__ import annotations

import ast
import re

from petastorm_tpu_torch.analysis.findings import Severity
from petastorm_tpu_torch.analysis.engine import Rule
from petastorm_tpu_torch.analysis.rules._astutil import (
    attr_chain,
    call_kwarg,
    children,
    self_attr,
    walk,
    walk_scope,
)

_LOCK_CTORS = {"threading.Lock", "threading.RLock", "threading.Condition",
               "Lock", "RLock", "Condition"}
#: types that synchronize internally — mutating them without the class lock is
#: fine (Event.set/clear, Queue.put/get, Semaphore.release are all thread-safe)
_SELF_SYNC_CTORS = {"threading.Event", "Event", "threading.Semaphore",
                    "threading.BoundedSemaphore", "Semaphore",
                    "queue.Queue", "Queue", "queue.SimpleQueue", "SimpleQueue",
                    "queue.LifoQueue", "queue.PriorityQueue",
                    "multiprocessing.Queue", "mp.Queue"}
_THREAD_CTORS = {"threading.Thread", "Thread"}
_QUEUE_CTORS = {"queue.Queue", "Queue", "queue.SimpleQueue", "SimpleQueue",
                "multiprocessing.Queue", "mp.Queue", "queue.LifoQueue",
                "queue.PriorityQueue"}
#: method calls that mutate their receiver in place (list/deque/dict/set API)
_MUTATORS = {"append", "extend", "insert", "pop", "popleft", "appendleft",
             "remove", "clear", "update", "add", "discard", "setdefault"}
_TEARDOWN_METHODS = {"stop", "close", "shutdown", "join", "terminate", "reset",
                     "__exit__", "__del__"}


def _ctor_chain(value):
    """Dotted ctor name when ``value`` is a plain constructor call, else None."""
    if isinstance(value, ast.Call):
        return attr_chain(value.func)
    return None


def _iter_methods(cls):
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


class _AccessCollector:
    """Walk one method body recording self-attribute accesses with the set of
    ``with self.<lock>`` regions active at each access. Nested function bodies
    are walked with an EMPTY active set: a closure may run on another thread,
    so a lock held at definition time guards nothing at call time."""

    def __init__(self, lock_attrs):
        self.lock_attrs = lock_attrs
        #: (attr, is_write, node, frozenset(active_locks))
        self.accesses = []

    def collect(self, method):
        for stmt in method.body:
            self._visit(stmt, frozenset())

    def _visit(self, node, active):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            body = node.body if isinstance(node.body, list) else [node.body]
            for child in body:
                self._visit(child, frozenset())
            return
        if isinstance(node, ast.With):
            locks_here = set()
            for item in node.items:
                a = self_attr(item.context_expr)
                if a in self.lock_attrs:
                    locks_here.add(a)
                self._visit(item.context_expr, active)
            inner = active | frozenset(locks_here)
            for child in node.body:
                self._visit(child, inner)
            return
        self._record(node, active)
        for child in children(node):
            self._visit(child, active)

    def _record(self, node, active):
        attr = self_attr(node)
        if attr is not None and attr not in self.lock_attrs:
            is_write = isinstance(node.ctx, (ast.Store, ast.Del))
            self.accesses.append((attr, is_write, node, active))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            recv = self_attr(node.func.value)
            if recv is not None and recv not in self.lock_attrs:
                self.accesses.append((recv, True, node, active))


class LockDisciplineRule(Rule):
    """GL-C001: an attribute accessed under ``with self.<lock>`` somewhere in the
    class is written elsewhere without holding any of those locks."""

    rule_id = "GL-C001"
    severity = Severity.ERROR
    description = ("shared attribute written outside the lock that guards its "
                   "other accesses")
    fix_hint = ("hold the same `with self.<lock>:` the other accesses hold (or "
                "move the write into a locked helper)")

    def check(self, tree, ctx):
        for cls in ctx.by_type(ast.ClassDef):
            lock_attrs, self_sync_attrs = set(), set()
            for node in walk(cls):
                if isinstance(node, ast.Assign):
                    chain = _ctor_chain(node.value)
                    for tgt in node.targets:
                        a = self_attr(tgt)
                        if not a:
                            continue
                        if chain in _LOCK_CTORS:
                            lock_attrs.add(a)
                        elif chain in _SELF_SYNC_CTORS:
                            self_sync_attrs.add(a)
            if not lock_attrs:
                continue
            # attrs EVER rebound to a self-synchronizing object are exempt from
            # lock discipline (their own methods synchronize); the lock attrs
            # themselves are excluded inside _AccessCollector
            lock_attrs = lock_attrs | self_sync_attrs
            per_method = []
            for method in _iter_methods(cls):
                collector = _AccessCollector(lock_attrs)
                collector.collect(method)
                per_method.append((method, collector.accesses))
            guarded = {}  # attr -> set of locks it is accessed under
            for _method, accesses in per_method:
                for attr, _w, _node, active in accesses:
                    if active:
                        guarded.setdefault(attr, set()).update(active)
            for method, accesses in per_method:
                if method.name == "__init__":
                    continue  # construction precedes any concurrent access
                for attr, is_write, node, active in accesses:
                    if not is_write or attr not in guarded:
                        continue
                    if active & guarded[attr]:
                        continue
                    yield ctx.finding(
                        self, node,
                        "attribute `self.%s` is written in `%s.%s` without "
                        "holding `self.%s`, which guards its other accesses"
                        % (attr, cls.name, method.name,
                           "`/`self.".join(sorted(guarded[attr]))))


def _untimed_blocking_call(node, method_attr):
    """True for ``X.<method_attr>(...)`` forms that can block forever: no
    timeout and not explicitly non-blocking. ``get()``, ``get(True)`` and
    ``get(block=True)`` all block; ``get(False)``/``get(timeout=...)``/
    ``join(5)`` do not."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == method_attr):
        return False
    if call_kwarg(node, "timeout") is not None:
        return False
    if node.args:
        first = node.args[0]
        if method_attr in ("join", "result"):
            # Thread.join(timeout) / Future.result(timeout): the first
            # positional IS the timeout — join(5) is timed, join(None) blocks
            return isinstance(first, ast.Constant) and first.value is None
        # Queue.get(block, timeout): the FIRST positional is block, not a
        # timeout — get(5) sets block=5 (truthy) and still blocks forever.
        # A second positional supplies the timeout; a dynamic block flag is
        # assumed deliberate.
        if len(node.args) >= 2:
            return False
        return isinstance(first, ast.Constant) and bool(first.value)
    block = call_kwarg(node, "block")
    if block is not None:
        # block=True without timeout blocks forever; block=<dynamic> is assumed
        # deliberate
        return isinstance(block, ast.Constant) and bool(block.value)
    return True


def _is_submit_call(value):
    """True for ``<anything>.submit(...)`` — an executor-built Future."""
    return isinstance(value, ast.Call) and \
        isinstance(value.func, ast.Attribute) and value.func.attr == "submit"


class BlockingTeardownRule(Rule):
    """GL-C002: untimed ``Queue.get()`` / ``Thread.join()`` /
    ``Future.result()`` inside stop/close/shutdown/join paths — a wedged
    worker then hangs teardown forever."""

    rule_id = "GL-C002"
    severity = Severity.ERROR
    description = ("blocking Queue.get()/Thread.join()/Future.result() without "
                   "a timeout on a stop/shutdown path")
    fix_hint = ("pass a timeout (`.join(timeout=...)` / `.get(timeout=...)` / "
                "`.result(timeout=...)`) or use `.get_nowait()` so teardown "
                "cannot hang on a wedged worker")

    def check(self, tree, ctx):
        for cls in ctx.by_type(ast.ClassDef):
            thread_attrs, queue_attrs, thread_list_attrs = set(), set(), set()
            future_attrs, future_list_attrs = set(), set()
            for method in _iter_methods(cls):
                local_threads = set()
                for node in walk(method):
                    if isinstance(node, ast.Assign):
                        chain = _ctor_chain(node.value)
                        for tgt in node.targets:
                            a = self_attr(tgt)
                            if chain in _THREAD_CTORS:
                                if a:
                                    thread_attrs.add(a)
                                elif isinstance(tgt, ast.Name):
                                    local_threads.add(tgt.id)
                            elif chain in _QUEUE_CTORS and a:
                                queue_attrs.add(a)
                            elif _is_submit_call(node.value) and a:
                                # self._flush_future = pool.submit(...)
                                future_attrs.add(a)
                    if isinstance(node, ast.Call) and \
                            isinstance(node.func, ast.Attribute) and \
                            node.func.attr == "append" and node.args:
                        arg = node.args[0]
                        a = self_attr(node.func.value)
                        if a is None:
                            continue
                        if isinstance(arg, ast.Name) and arg.id in local_threads:
                            thread_list_attrs.add(a)
                        elif _is_submit_call(arg):
                            # self._futures.append(pool.submit(...))
                            future_list_attrs.add(a)
            if not (thread_attrs or queue_attrs or thread_list_attrs
                    or future_attrs or future_list_attrs):
                continue
            for method in _iter_methods(cls):
                if method.name not in _TEARDOWN_METHODS:
                    continue
                for finding in self._check_teardown(
                        method, cls, ctx, thread_attrs, queue_attrs,
                        thread_list_attrs, future_attrs, future_list_attrs):
                    yield finding

    def _check_teardown(self, method, cls, ctx, thread_attrs, queue_attrs,
                        thread_list_attrs, future_attrs, future_list_attrs):
        # loop vars bound from a tracked attr list: for t in self._threads:
        loop_threads, loop_futures = set(), set()
        for node in walk(method):
            if isinstance(node, ast.For) and isinstance(node.target, ast.Name):
                it = self_attr(node.iter)
                if it in thread_list_attrs:
                    loop_threads.add(node.target.id)
                elif it in future_list_attrs:
                    loop_futures.add(node.target.id)
        for node in walk(method):
            if not isinstance(node, ast.Call):
                continue
            if _untimed_blocking_call(node, "join"):
                recv = node.func.value
                a = self_attr(recv)
                if a in thread_attrs or (
                        isinstance(recv, ast.Name) and recv.id in loop_threads):
                    yield ctx.finding(
                        self, node,
                        "`%s.%s` joins a worker thread with no timeout — a "
                        "wedged worker hangs teardown forever"
                        % (cls.name, method.name))
            elif _untimed_blocking_call(node, "get"):
                a = self_attr(node.func.value)
                if a in queue_attrs:
                    yield ctx.finding(
                        self, node,
                        "`%s.%s` blocks on `self.%s.get()` with no timeout on "
                        "a shutdown path" % (cls.name, method.name, a))
            elif _untimed_blocking_call(node, "result"):
                recv = node.func.value
                a = self_attr(recv)
                if a in future_attrs or (
                        isinstance(recv, ast.Name) and recv.id in loop_futures):
                    yield ctx.finding(
                        self, node,
                        "`%s.%s` blocks on an executor future's `.result()` "
                        "with no timeout on a shutdown path — a wedged task "
                        "hangs teardown forever" % (cls.name, method.name))


class ThreadHandlingRule(Rule):
    """GL-C003: a thread started without ``daemon=True`` and never joined keeps
    the process alive after main exits (or leaks silently under pytest)."""

    rule_id = "GL-C003"
    severity = Severity.WARNING
    description = "thread started without daemon=True or a matching join()"
    fix_hint = ("pass `daemon=True` to threading.Thread(...), or join the "
                "thread on every exit path")

    def check(self, tree, ctx):
        scopes = [tree] + ctx.by_type(ast.FunctionDef, ast.AsyncFunctionDef)
        for scope in scopes:
            scope_src = None  # unparsed lazily: only scopes with a Thread ctor pay
            for node in walk_scope(scope):
                if not isinstance(node, ast.Call):
                    continue
                if attr_chain(node.func) not in _THREAD_CTORS:
                    continue
                daemon = call_kwarg(node, "daemon")
                if daemon is not None and not (
                        isinstance(daemon, ast.Constant) and daemon.value is False):
                    continue  # daemon=True (or a dynamic flag: assume intentional)
                if scope_src is None:
                    scope_src = ast.unparse(scope)
                if self._is_handled(node, scope, scope_src, ctx):
                    continue
                yield ctx.finding(
                    self, node,
                    "thread created without daemon=True and without visible "
                    "join handling in `%s`"
                    % getattr(scope, "name", "<module>"))

    def _is_handled(self, call, scope, scope_src, ctx):
        parent = ctx.parent(call)
        # threading.Thread(...).start() with no binding: nobody can ever join it
        if isinstance(parent, ast.Attribute):
            return False
        if not (isinstance(parent, ast.Assign) and len(parent.targets) == 1
                and isinstance(parent.targets[0], ast.Name)):
            # passed/returned/stored somewhere we can't track: don't guess
            return True
        name = parent.targets[0].id
        # joined, daemonized after the fact, or handed to a container that the
        # surrounding code joins (textual check — this is a heuristic rule).
        # Word boundaries matter: `fmt.join(...)` must not count as `t.join(...)`.
        esc = re.escape(name)
        if re.search(r"\b%s\.join\(" % esc, scope_src) or \
                re.search(r"\b%s\.daemon\s*=\s*True\b" % esc, scope_src):
            return True
        if re.search(r"\.append\(\s*%s\s*\)" % esc, scope_src) and \
                ".join(" in scope_src:
            return True
        return False


_OPTIONS_SEGMENT = re.compile(r"(?:^|_)opt(?:ion)?s$", re.IGNORECASE)

#: scopes where writing an options field IS the contract: the options class's
#: own methods (construction/unpickle/normalization) and the sanctioned live
#: actuation seam (control/knobs.py KnobSet)
_OPTIONS_OWNER_CLASS = re.compile(r"Options$")
_SANCTIONED_CLASSES = {"KnobSet"}


class OptionsMutationRule(Rule):
    """GL-C004: post-construction mutation of an ``*Options`` struct field.

    The ``IoOptions``/``RemoteIoOptions``/``RecoveryOptions``/... structs are
    construction-frozen config: one instance is shared across readers, crosses
    the pool-child pickle wire, and is read lock-free by worker threads.
    Mutating a field after construction (``reader._io_options.readahead_depth
    = 8``) silently retunes OTHER pipelines sharing the struct, never reaches
    components that copied the value at build time, and races every lock-free
    reader. Live retunes go through the sanctioned seam instead:
    ``petastorm_tpu_torch.control.KnobSet.apply()`` / the component's
    ``apply_*()`` setters, which are bounded, thread-safe, and observable
    (``ptpu_ctl_*``).

    Exempt: methods of classes named ``*Options`` (their ``__init__``/
    ``normalize`` own the fields) and the ``KnobSet`` seam itself.
    """

    rule_id = "GL-C004"
    severity = Severity.WARNING
    description = ("post-construction mutation of an *Options struct field "
                   "outside the sanctioned KnobSet.apply() seam")
    fix_hint = ("route live retunes through petastorm_tpu_torch.control.KnobSet"
                ".apply() or the component's apply_*() setter (options "
                "structs are shared, pickled config — mutating them races "
                "lock-free readers and skips components that copied the "
                "value); or justify with '# graftlint: disable=GL-C004'")

    def check(self, tree, ctx):
        exempt = set()
        for node in ctx.by_type(ast.ClassDef):
            if _OPTIONS_OWNER_CLASS.search(node.name) \
                    or node.name in _SANCTIONED_CLASSES:
                for sub in walk(node):
                    exempt.add(id(sub))
        for node in ctx.by_type(ast.Assign, ast.AugAssign):
            if id(node) in exempt:
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for target in targets:
                for finding in self._check_target(node, target, ctx):
                    yield finding

    def _check_target(self, node, target, ctx):
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                yield from self._check_target(node, elt, ctx)
            return
        if not isinstance(target, ast.Attribute):
            return
        chain = attr_chain(target.value)
        if chain is None:
            return
        segments = chain.split(".")
        if not any(_OPTIONS_SEGMENT.search(seg) for seg in segments):
            return
        yield ctx.finding(
            self, node,
            "field %r assigned on options object `%s` after construction — "
            "options structs are frozen config; use the KnobSet/apply_*() "
            "seam for live retunes" % (target.attr, chain))
