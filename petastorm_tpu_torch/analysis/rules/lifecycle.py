"""Resource-lifecycle rule: readers/executors/loaders must not leak.

Every one of these objects owns background threads, child processes, sockets, or
device buffers; an instance abandoned without ``stop()``/``close()`` leaks them
until interpreter exit (and under pytest, across the whole test run). The rule
tracks constructor calls of the project's closeable types through their enclosing
function and requires one of the accepted ownership outcomes below.
"""
from __future__ import annotations

import ast

from petastorm_tpu_torch.analysis.findings import Severity
from petastorm_tpu_torch.analysis.engine import Rule
from petastorm_tpu_torch.analysis.rules._astutil import call_func_name, walk, walk_scope

#: Constructors/factories returning objects that expose close()/stop() and
#: support the context-manager protocol. Project types only — stdlib `open()`
#: etc. is the standard linters' turf. ``SharedMemory`` is the one stdlib
#: exception: a segment constructed without a ``close()``/``unlink()`` path
#: outlives the process in ``/dev/shm`` (not just the interpreter), and the shm
#: wire (petastorm_tpu_torch/parallel/shm_ring.py) makes it a recurring project idiom
#: — so the analyzer covers it alongside the ring's own types.
CLOSEABLE_FACTORIES = frozenset({
    "make_reader", "make_batch_reader", "Reader",
    "make_executor", "ThreadExecutor", "ProcessExecutor", "SyncExecutor",
    "DataLoader", "InMemDataLoader", "BatchedDataLoader",
    "make_weighted_reader", "WeightedSamplingReader",
    "SharedMemory", "SlabRing", "SlabClient",
    # async-IO runtime: a ReadaheadPool owns live IO threads
    # (shutdown() is its closer) and a MemCache pins process-wide bytes
    # (clear() releases them)
    "ReadaheadPool", "MemCache",
    # lease contract: constructing a Lease IS the acquire (refcount 1
    # over someone else's buffers — release() is its closer; leaking one
    # strands a slab/staging slot until GC, counted ptpu_lease_leaked_total),
    # and a PinnedStagingPool owns mlock'd host slabs (close() unpins/unmaps)
    "Lease", "PinnedStagingPool",
    # remote tier: a RemoteReadEngine owns the ranged-GET thread pool
    # (shutdown() is its closer); FooterCache pins parsed-footer bytes and
    # TieredCache pins the mem tier's process-wide bytes (clear() releases
    # both)
    "RemoteReadEngine", "FooterCache", "TieredCache",
    # host-wide cache arena: a CacheArena owns named /dev/shm
    # segments (creator: close() unlinks the whole set; attacher: close()/
    # detach() drops the mappings and deregisters the pid) — leaking one
    # strands host-wide shared memory past process exit, same failure class
    # as a bare SharedMemory
    "CacheArena",
})

#: calls that merely CONSUME an iterable without taking ownership of it
_CONSUMERS = frozenset({"list", "iter", "next", "enumerate", "sorted", "zip",
                        "sum", "min", "max", "len", "tuple", "set", "dict",
                        "print", "repr", "str", "isinstance", "type"})

_CLOSERS = frozenset({"stop", "close", "join", "terminate", "shutdown", "unlink",
                      "clear", "release", "detach"})


class ResourceLifecycleRule(Rule):
    """GL-L001: a closeable constructed but not consumed via ``with``, closed in
    a ``finally``, or handed off (returned / yielded / stored / wrapped by
    another closeable that assumes ownership). Covers ``SharedMemory`` (and the
    slab-ring types built on it): a segment with no ``close()``/``unlink()``
    path leaks a ``/dev/shm`` file past process exit."""

    rule_id = "GL-L001"
    severity = Severity.ERROR
    description = ("reader/executor/loader/shared-memory segment constructed "
                   "without a context manager or try/finally close")
    fix_hint = ("use `with make_reader(...) as r:` (or close in a `finally:`); "
                "passing a reader into DataLoader(...) transfers ownership to "
                "the loader's own `with` block; a SharedMemory segment needs a "
                "close()+unlink() (creator) or close() (attacher) path")

    def check(self, tree, ctx):
        scopes = [tree] + ctx.by_type(ast.FunctionDef, ast.AsyncFunctionDef)
        for scope in scopes:
            scope_nodes = list(walk_scope(scope))
            for node in scope_nodes:
                if not isinstance(node, ast.Call):
                    continue
                name = call_func_name(node)
                if name not in CLOSEABLE_FACTORIES:
                    continue
                ok, tracked = self._call_context_ok(node, ctx)
                if ok:
                    continue
                if tracked is not None and self._name_ok(tracked, scope_nodes, ctx,
                                                         factory=name):
                    continue
                yield ctx.finding(
                    self, node,
                    "`%s(...)` result is never closed: not used as a context "
                    "manager, closed in a finally, or handed off" % name)
        yield from self._check_double_release(ctx)

    # -- lease release discipline ------------------------------------------------------

    def _check_double_release(self, ctx):
        """Flag an UNBALANCED ``x.release()`` in one straight-line statement
        list: each name gets one implied base reference plus one per
        ``x.retain()`` seen earlier in the list; a release past that budget is
        the caller bug :class:`petastorm_tpu_torch.errors.LeaseError` catches at
        runtime. Conservative: the scan STOPS at the first compound statement
        in a list (a branch may retain or release — what it did to any
        refcount is unknowable, and a wrong guess in either direction makes
        false positives), and a rebind/del of the name resets its tracking —
        so conditional release patterns never false-positive. Teardown blocks
        stay covered: a ``finally:`` body is its own statement list."""
        for stmts in self._stmt_lists(ctx):
            state = {}  # name -> [extra_refs_from_retains, base_release_lineno]
            for stmt in stmts:
                if self._clears_tracking(stmt):
                    break
                self._absorb_retains_and_rebinds(stmt, state)
                if not (isinstance(stmt, ast.Expr)
                        and isinstance(stmt.value, ast.Call)):
                    continue
                target = self._release_target(stmt.value)
                if target is None:
                    continue
                entry = state.setdefault(target, [0, None])
                if entry[0] > 0:
                    entry[0] -= 1  # consumes a retain() seen earlier
                elif entry[1] is None:
                    entry[1] = stmt.lineno  # the implied base reference
                else:
                    yield ctx.finding(
                        self, stmt.value,
                        "`%s.release()` called again after the release on "
                        "line %d with no retain() between: the lease contract "
                        "is exactly-once release per retain (double release "
                        "raises LeaseError at runtime)" % (target, entry[1]),
                        fix_hint="drop the extra release(), or retain() once "
                                 "per holder")

    @staticmethod
    def _stmt_lists(ctx):
        for node in ctx.walk():
            for field in ("body", "orelse", "finalbody"):
                stmts = getattr(node, field, None)
                if isinstance(stmts, list) and stmts \
                        and isinstance(stmts[0], ast.stmt):
                    yield stmts

    @staticmethod
    def _dotted_name(expr):
        parts = []
        while isinstance(expr, ast.Attribute):
            parts.append(expr.attr)
            expr = expr.value
        if not isinstance(expr, ast.Name):
            return None
        parts.append(expr.id)
        return ".".join(reversed(parts))

    @classmethod
    def _release_target(cls, call):
        """Dotted receiver of a bare ``<recv>.release()`` call, else None."""
        if isinstance(call.func, ast.Attribute) and call.func.attr == "release" \
                and not call.args and not call.keywords:
            return cls._dotted_name(call.func.value)
        return None

    @staticmethod
    def _clears_tracking(stmt):
        """ANY compound statement wipes per-list tracking: its branch bodies
        are separate lists, and what they did to a refcount is unknowable."""
        compound = (ast.If, ast.For, ast.AsyncFor, ast.While, ast.Try,
                    ast.With, ast.AsyncWith)
        if hasattr(ast, "Match"):
            compound += (ast.Match,)
        return isinstance(stmt, compound)

    @classmethod
    def _flatten_targets(cls, targets):
        """Expand tuple/list/starred assignment targets so a rebind inside
        ``lease, other = make_two()`` still resets ``lease``'s tracking."""
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                yield from cls._flatten_targets(t.elts)
            elif isinstance(t, ast.Starred):
                yield from cls._flatten_targets([t.value])
            else:
                yield t

    @classmethod
    def _absorb_retains_and_rebinds(cls, stmt, state):
        """Fold one simple statement into the release-budget state: every
        ``x.retain()`` anywhere in it grants one extra release; any rebind or
        ``del`` of a name drops that name's tracking (a different lease now)."""
        for sub in walk(stmt):
            if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "retain":
                name = cls._dotted_name(sub.func.value)
                if name is not None:
                    state.setdefault(name, [0, None])[0] += 1
            elif isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = sub.targets if isinstance(sub, ast.Assign) \
                    else [sub.target]
                for t in cls._flatten_targets(targets):
                    name = cls._dotted_name(t)
                    if name is not None:
                        state.pop(name, None)
            elif isinstance(sub, ast.Delete):
                for t in sub.targets:
                    name = cls._dotted_name(t)
                    if name is not None:
                        state.pop(name, None)

    def _call_context_ok(self, call, ctx):
        """(resolved?, tracked_name): classify the constructor call by its parent.

        Returns (True, None) when the call site itself is fine, (False, name)
        when the result is bound to a local name that must be followed, and
        (False, None) when the result is plainly dropped."""
        parent = ctx.parent(call)
        if isinstance(parent, ast.withitem):
            return True, None
        if isinstance(parent, (ast.Return, ast.Yield, ast.YieldFrom, ast.Await)):
            return True, None  # ownership moves to the caller
        if isinstance(parent, ast.keyword):
            parent = ctx.parent(parent)
        if isinstance(parent, ast.Call):
            outer = call_func_name(parent)
            if outer in CLOSEABLE_FACTORIES or outer == "closing":
                # wrapped by another closeable (DataLoader closes its reader on
                # __exit__) or contextlib.closing — the wrapper is now tracked
                return self._call_context_ok(parent, ctx)
            if outer in _CONSUMERS:
                return False, None  # list(make_reader(...)) consumes AND leaks
            return True, None  # passed to unknown callee: assume it takes ownership
        if isinstance(parent, ast.Assign):
            if len(parent.targets) == 1 and isinstance(parent.targets[0], ast.Name):
                return False, parent.targets[0].id
            return True, None  # attribute/subscript/tuple target: escapes tracking
        if isinstance(parent, (ast.Starred, ast.Subscript, ast.Attribute,
                               ast.IfExp, ast.BoolOp)):
            return True, None  # too dynamic to judge
        if isinstance(parent, ast.Expr):
            if self._in_pytest_raises(parent, ctx):
                return True, None  # the constructor is EXPECTED to raise
            return False, None  # bare statement: constructed and dropped
        return True, None

    @staticmethod
    def _in_pytest_raises(node, ctx):
        """True inside a ``with pytest.raises(...):`` body — a bare constructor
        call there asserts the constructor throws, so nothing is ever built."""
        while node is not None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return False
            if isinstance(node, ast.With):
                for item in node.items:
                    if isinstance(item.context_expr, ast.Call) and \
                            call_func_name(item.context_expr) == "raises":
                        return True
            node = ctx.parent(node)
        return False

    def _name_ok(self, name, scope_nodes, ctx, factory=None):
        """True when the bound name reaches an accepted ownership outcome
        anywhere in the enclosing scope."""
        for node in scope_nodes:
            # Lease only: a straight-line `name.release()` statement counts.
            # Unlike readers/shm segments, a lease missed on an exception path
            # does not leak an OS resource — the GC safety net reclaims it and
            # counts ptpu_lease_leaked_total — so the static bar is the happy
            # path, with the double-release check guarding the other side.
            if factory == "Lease" and isinstance(node, ast.Call) \
                    and self._release_target(node) == name:
                return True
            # with name: / with wrapper(name):
            if isinstance(node, ast.withitem) and self._expr_uses_name(
                    node.context_expr, name):
                return True
            # try: ... finally: name.stop()/close()/join()
            if isinstance(node, ast.Try):
                for stmt in node.finalbody:
                    for sub in walk(stmt):
                        if isinstance(sub, ast.Call) and \
                                isinstance(sub.func, ast.Attribute) and \
                                sub.func.attr in _CLOSERS and \
                                isinstance(sub.func.value, ast.Name) and \
                                sub.func.value.id == name:
                            return True
            # return name / yield name (ownership to caller / fixture finalizer);
            # only the BARE name counts — `return list(reader)` returns the
            # consumed rows, the reader itself still leaks
            if isinstance(node, (ast.Return, ast.Yield)) and node.value is not None \
                    and self._is_bare_name(node.value, name):
                return True
            # self.x = name / container[k] = name: lifetime escapes the function
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Name) \
                    and node.value.id == name:
                if any(isinstance(t, (ast.Attribute, ast.Subscript))
                       for t in node.targets):
                    return True
            # passed onward: DataLoader(name, ...) transfers ownership; any other
            # non-consumer call is assumed to take it too (addfinalizer, helpers)
            if isinstance(node, ast.Call):
                callee = call_func_name(node)
                args = list(node.args) + [kw.value for kw in node.keywords]
                # elements of literal list/tuple args transfer too:
                # WeightedSamplingReader([r1, r2], ...) owns both readers
                for container in list(args):
                    if isinstance(container, (ast.List, ast.Tuple)):
                        args.extend(container.elts)
                for arg in args:
                    if isinstance(arg, ast.Name) and arg.id == name:
                        if callee not in _CONSUMERS:
                            return True
                    # name.stop passed as a callback (request.addfinalizer(r.stop))
                    if isinstance(arg, ast.Attribute) and \
                            isinstance(arg.value, ast.Name) and \
                            arg.value.id == name and arg.attr in _CLOSERS:
                        return True
        return False

    @staticmethod
    def _expr_uses_name(expr, name):
        return any(isinstance(n, ast.Name) and n.id == name
                   for n in walk(expr))

    @staticmethod
    def _is_bare_name(expr, name):
        if isinstance(expr, ast.Name):
            return expr.id == name
        if isinstance(expr, (ast.Tuple, ast.List, ast.Dict)):
            values = expr.values if isinstance(expr, ast.Dict) else expr.elts
            return any(isinstance(e, ast.Name) and e.id == name for e in values)
        return False
