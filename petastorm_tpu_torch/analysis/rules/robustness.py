"""Robustness rule family.

GL-R001: unbounded blocking calls in pipeline code.
GL-R002: stat-then-open TOCTOU windows — validating a path via
``os.stat``/``os.path.getsize``/``os.path.getmtime`` and later ``open()``-ing
it without re-checking a validation token.
GL-R003: unbounded sockets — a ``socket.socket()`` that reaches a blocking
use (``recv``/``accept``/``connect``) with no ``settimeout`` anywhere on the
same receiver chain (the framed transport's contract is that every
socket wait ticks and re-checks its deadline/stop condition).

At pod scale the failure mode that hurts most is not a crash but a *hang*: a
thread parked forever in ``queue.get()`` / ``Connection.recv()`` /
``Thread.join()`` / ``Event.wait()`` with no timeout pins a TPU slice until a
human notices. Every blocking wait in pipeline code must either carry a
timeout (and handle its expiry — degrade, retry, or re-check a stop event) or
justify its unboundedness with an inline
``# graftlint: disable=GL-R001`` comment (e.g. a receive that is bounded by a
``poll(timeout)`` loop right above it, or a child process whose whole job is
waiting for the next item and whose parent kills it on teardown).

GL-R001 tracks variables assigned from the blocking-primitive constructors —
``queue.Queue``/``SimpleQueue``/``LifoQueue``/``PriorityQueue``,
``threading.Thread``/``Timer``/``multiprocessing.Process``,
``threading.Event``, ``multiprocessing.connection.Client`` (and
``Listener.accept()``) — across the whole module (including ``self.<attr>``
assignments, so a queue built in ``__init__`` and drained in ``run`` is still
typed), then flags:

=========  ==============  ==========================================
kind       method          flagged when
=========  ==============  ==========================================
queue      ``get``         no ``timeout`` (kwarg or 2nd positional)
                           and not explicitly non-blocking
                           (``get(False)`` / ``get(block=False)``)
thread     ``join``        no timeout argument
event      ``wait``        no timeout argument
conn       ``recv``        always — ``Connection.recv`` has no timeout
                           parameter; bound it with a ``poll(t)`` loop
                           and carry the inline disable
=========  ==============  ==========================================

Receivers the tracker cannot type are left alone — swallowing a specific
``dict.get(key)`` or ``", ".join(parts)`` as a false positive would drown the
real findings.
"""
from __future__ import annotations

import ast

from petastorm_tpu_torch.analysis.findings import Severity
from petastorm_tpu_torch.analysis.engine import Rule
from petastorm_tpu_torch.analysis.rules._astutil import (
    attr_chain,
    call_func_name,
    call_kwarg,
)

#: constructor name (last dotted segment) -> tracked kind
_CONSTRUCTORS = {
    "Queue": "queue",
    "SimpleQueue": "queue",
    "LifoQueue": "queue",
    "PriorityQueue": "queue",
    "JoinableQueue": "queue",
    "Thread": "thread",
    "Timer": "thread",
    "Process": "thread",
    "Event": "event",
    "Client": "conn",
    # executors — a chain typed "executor" seeds future typing
    # (x = pool.submit(...) → x is a future; fs = [pool.submit(...) ...] → a
    # future list whose loop variables are futures)
    "ThreadPoolExecutor": "executor",
    "ProcessPoolExecutor": "executor",
}

#: kind -> method name whose unbounded form is flagged
_BLOCKING_METHOD = {
    "queue": "get",
    "thread": "join",
    "event": "wait",
    "conn": "recv",
    "future": "result",
}


def _wait_aliases(ctx):
    """Dotted chains that mean ``concurrent.futures.wait`` in this file.
    Only forms actually importing the futures machinery register — a bare
    ``wait(...)`` matches nothing unless ``from concurrent.futures import
    wait`` appears."""
    aliases = set()
    for node in ctx.by_type(ast.Import):
        for a in node.names:
            if a.name == "concurrent.futures":
                aliases.add("%s.wait" % (a.asname or "concurrent.futures"))
    for node in ctx.by_type(ast.ImportFrom):
        if node.module == "concurrent":
            for a in node.names:
                if a.name == "futures":
                    aliases.add("%s.wait" % (a.asname or "futures"))
        elif node.module == "concurrent.futures":
            for a in node.names:
                if a.name == "wait":
                    aliases.add(a.asname or "wait")
    return aliases


def _is_false_const(node):
    return isinstance(node, ast.Constant) and node.value is False


class UnboundedBlockingCallRule(Rule):
    """GL-R001: ``queue.get()`` / ``Connection.recv()`` / ``Thread.join()`` /
    ``Event.wait()`` without a timeout in pipeline code."""

    rule_id = "GL-R001"
    severity = Severity.WARNING
    description = ("unbounded blocking call (queue.get/Connection.recv/"
                   "Thread.join/Event.wait without a timeout) — a silent-hang "
                   "hazard at pod scale")
    fix_hint = ("pass a timeout and handle its expiry (re-check a stop event, "
                "degrade, or raise), bound a Connection.recv with a poll(t) "
                "loop, or justify the unbounded wait with an inline "
                "'# graftlint: disable=GL-R001' comment")

    def check(self, tree, ctx):
        kinds = self._collect_kinds(ctx)
        wait_aliases = _wait_aliases(ctx)
        for node in ctx.by_type(ast.Call):
            if wait_aliases and attr_chain(node.func) in wait_aliases:
                if not self._wait_has_timeout(node):
                    yield ctx.finding(
                        self, node,
                        "futures.wait() without a timeout blocks forever if "
                        "any task wedges — a hung pipeline instead of a "
                        "diagnosable failure")
                continue
            if not kinds or not isinstance(node.func, ast.Attribute):
                continue
            recv = attr_chain(node.func.value)
            kind = kinds.get(recv)
            if kind is None or node.func.attr != _BLOCKING_METHOD.get(kind):
                continue
            if kind == "conn":
                yield ctx.finding(
                    self, node,
                    "%s.recv() blocks forever (Connection.recv has no timeout "
                    "parameter): a dead or wedged peer hangs this thread — "
                    "bound it with a poll(timeout) loop" % recv)
                continue
            if self._has_timeout(node, kind):
                continue
            what = "executor task" if kind == "future" else kind
            yield ctx.finding(
                self, node,
                "%s.%s() without a timeout blocks forever if the %s never "
                "delivers — a hung pipeline instead of a diagnosable failure"
                % (recv, node.func.attr, what))

    @staticmethod
    def _collect_kinds(ctx):
        """Map of assigned-name chain (``q``, ``self._results``) -> kind, from
        constructor assignments anywhere in the module. A second pass types
        FUTURES off the executors found in the first: ``x = pool.submit(...)``
        makes ``x`` a future, a list built from ``submit`` results (listcomp
        or ``.append``) makes its ``for``-loop and comprehension variables
        futures."""
        kinds = {}
        assigns = ctx.by_type(ast.Assign)
        for node in assigns:
            if not isinstance(node.value, ast.Call):
                continue
            name = call_func_name(node.value)
            kind = _CONSTRUCTORS.get(name)
            if kind is None and name == "accept":
                # conn = listener.accept() — the other way a Connection is born
                kind = "conn"
            if kind is None:
                continue
            for target in node.targets:
                chain = attr_chain(target)
                if chain is not None:
                    kinds[chain] = kind
        def is_submit(call):
            return isinstance(call, ast.Call) and \
                isinstance(call.func, ast.Attribute) and \
                call.func.attr == "submit" and \
                kinds.get(attr_chain(call.func.value)) == "executor"
        futlists = set()
        for node in assigns:
            value = node.value
            targets = [attr_chain(t) for t in node.targets]
            if is_submit(value):
                for chain in targets:
                    if chain is not None:
                        kinds[chain] = "future"
            elif isinstance(value, ast.ListComp) and is_submit(value.elt):
                futlists.update(c for c in targets if c is not None)
        for node in ctx.by_type(ast.Call):
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "append" and node.args and \
                    is_submit(node.args[0]):
                chain = attr_chain(node.func.value)
                if chain is not None:
                    futlists.add(chain)
        if futlists:
            for node in ctx.by_type(ast.For):
                if isinstance(node.target, ast.Name) and \
                        attr_chain(node.iter) in futlists:
                    kinds[node.target.id] = "future"
            for node in ctx.by_type(ast.ListComp, ast.SetComp,
                                    ast.GeneratorExp):
                for gen in node.generators:
                    if isinstance(gen.target, ast.Name) and \
                            attr_chain(gen.iter) in futlists:
                        kinds[gen.target.id] = "future"
        return kinds

    @staticmethod
    def _wait_has_timeout(call):
        """``futures.wait(fs, timeout, return_when)``: 2nd positional or a
        non-None ``timeout`` kwarg bounds it."""
        timeout = call_kwarg(call, "timeout")
        if timeout is None and len(call.args) >= 2:
            timeout = call.args[1]
        return timeout is not None and not (
            isinstance(timeout, ast.Constant) and timeout.value is None)

    @staticmethod
    def _has_timeout(call, kind):
        def bounded(node):
            # an explicit None is "no timeout" spelled out — still unbounded
            return node is not None and not (
                isinstance(node, ast.Constant) and node.value is None)

        if bounded(call_kwarg(call, "timeout")):
            return True
        if kind == "queue":
            # queue.get(block, timeout): non-blocking get(False) is bounded,
            # and a 2nd positional IS the timeout
            if len(call.args) >= 2:
                return bounded(call.args[1])
            if len(call.args) == 1 and _is_false_const(call.args[0]):
                return True
            block = call_kwarg(call, "block")
            if block is not None and _is_false_const(block):
                return True
            return False
        # thread.join(timeout) / event.wait(timeout): 1st positional is it
        return len(call.args) >= 1 and bounded(call.args[0])


#: socket methods whose unbounded form blocks forever on a quiet peer
_SOCKET_BLOCKING = frozenset(("recv", "recv_into", "recvfrom", "accept",
                              "connect"))


class UnboundedSocketRule(Rule):
    """GL-R003: a raw socket used to block without a timeout.

    At pod scale a socket parked forever in ``recv()``/``accept()`` against a
    dead or half-open peer is the same silent hang GL-R001 polices for queues
    and pipes — except the peer is now a *network* away, where "gone without
    a FIN" is the common failure, not the exotic one. The transport plane's
    contract (``petastorm_tpu_torch/transport/tcp.py``) is that every socket
    carries a tick timeout and every wait re-checks its deadline between
    ticks; this rule keeps that true for future socket code.

    Tracking mirrors GL-R001's receiver typing: variables (or ``self.<attr>``
    chains) assigned from ``socket.socket(...)`` / ``socket.create_connection
    (...)`` — including the first element of a ``conn, addr = srv.accept()``
    tuple unpack — are typed as sockets module-wide. A blocking call
    (``recv``/``recv_into``/``recvfrom``/``accept``/``connect``) on a tracked
    chain is flagged unless the chain is BOUNDED somewhere in the module:

    - ``<chain>.settimeout(x)`` with a non-None ``x`` (a ``settimeout(None)``
      re-flags it — that is "blocking forever" spelled out);
    - ``<chain>.setblocking(False)`` (non-blocking mode);
    - the socket came from ``socket.create_connection(..., timeout=...)``
      (the stdlib applies the timeout to the returned socket).

    Untyped receivers are left alone (same philosophy as GL-R001: drowning
    real findings in false positives helps nobody); justified unbounded
    sockets carry an inline ``# graftlint: disable=GL-R003`` with the reason.
    """

    rule_id = "GL-R003"
    severity = Severity.WARNING
    description = ("unbounded socket: blocking use (recv/accept/connect) of a "
                   "socket with no settimeout on its chain — a dead or "
                   "half-open peer hangs this thread forever")
    fix_hint = ("call settimeout(t) on the socket before blocking (and "
                "re-check a deadline/stop condition per tick), use "
                "create_connection(..., timeout=...), or justify with an "
                "inline '# graftlint: disable=GL-R003' comment")

    def check(self, tree, ctx):
        socks, bounded = self._collect(ctx)
        if not socks:
            return
        for node in ctx.by_type(ast.Call):
            if not isinstance(node.func, ast.Attribute):
                continue
            recv = attr_chain(node.func.value)
            if recv not in socks or recv in bounded:
                continue
            if node.func.attr not in _SOCKET_BLOCKING:
                continue
            yield ctx.finding(
                self, node,
                "%s.%s() on a socket with no settimeout anywhere on its "
                "chain blocks forever if the peer is gone or half-open — "
                "bound it with settimeout(t) and re-check a deadline per "
                "tick" % (recv, node.func.attr))

    @staticmethod
    def _collect(ctx):
        """``(socket chains, bounded chains)`` from module-wide assignments:
        a chain is bounded by a non-None ``settimeout``, a
        ``setblocking(False)``, or a ``create_connection`` timeout."""
        socks = set()
        bounded = set()
        for node in ctx.by_type(ast.Assign, ast.Call):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                name = call_func_name(node.value)
                ctor = name in ("socket", "create_connection")
                if name == "accept":
                    # conn, addr = srv.accept(): the FIRST unpack element is
                    # the new socket (plain targets get the tuple, untracked)
                    for target in node.targets:
                        if isinstance(target, (ast.Tuple, ast.List)) \
                                and target.elts:
                            chain = attr_chain(target.elts[0])
                            if chain is not None:
                                socks.add(chain)
                    continue
                if not ctor:
                    continue
                timeout = call_kwarg(node.value, "timeout")
                has_timeout = name == "create_connection" and (
                    len(node.value.args) >= 2
                    or (timeout is not None
                        and not (isinstance(timeout, ast.Constant)
                                 and timeout.value is None)))
                for target in node.targets:
                    chain = attr_chain(target)
                    if chain is None:
                        continue
                    socks.add(chain)
                    if has_timeout:
                        bounded.add(chain)
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                recv = attr_chain(node.func.value)
                if recv is None:
                    continue
                if node.func.attr == "settimeout" and node.args:
                    arg = node.args[0]
                    if isinstance(arg, ast.Constant) and arg.value is None:
                        bounded.discard(recv)  # "block forever", spelled out
                    else:
                        bounded.add(recv)
                elif node.func.attr == "setblocking" and node.args and \
                        isinstance(node.args[0], ast.Constant) and \
                        node.args[0].value is False:
                    bounded.add(recv)
        return socks, bounded


#: callables whose dotted name (or bare from-import name) marks their first
#: argument as a stat-VALIDATED path
_STAT_CALLS = frozenset((
    "os.stat", "os.path.getsize", "os.path.getmtime",
    "stat", "getsize", "getmtime",
))

#: callables that OPEN their first argument (builtin + the common stdlib/pyarrow
#: spellings pipeline code uses)
_OPEN_CALLS = frozenset(("open", "os.open", "io.open"))

#: method names (last attribute segment) that open their first argument on a
#: filesystem object (pyarrow fs / fsspec)
_OPEN_METHODS = frozenset(("open_input_file", "open_input_stream",
                           "open_output_stream"))


class StatThenOpenRule(Rule):
    """GL-R002: a path validated via ``os.stat``/``os.path.getsize``/
    ``os.path.getmtime`` and later ``open()``-ed in the same function without
    re-checking a validation token.

    The gap between the stat and the open is a TOCTOU window: under a mutable
    dataset the file can be rewritten (or replaced) in between, so whatever
    the stat "validated" — a cache entry, a size-derived read plan, a
    generation check — no longer describes the bytes the open returns. The
    mutable-dataset plane exists precisely because this window is real
    (docs/robustness.md "Mutable datasets"); code that must live with it
    re-validates AFTER the open (``fstat``/``source.size()``/a
    generation-token check à la ``FooterCache.get(..., stat_token=)``) or
    carries an inline ``# graftlint: disable=GL-R002`` naming why the window
    is benign.

    Tracking is deliberately narrow — a variable (or ``self.<attr>``) passed
    as the stat call's first argument, later passed as the first argument of
    an open call in the SAME function scope — so findings are real: untyped
    receivers and computed path expressions are left alone.
    """

    rule_id = "GL-R002"
    severity = Severity.WARNING
    description = ("stat-then-open TOCTOU: path validated by os.stat/getsize/"
                   "getmtime, then open()ed without re-checking a validation "
                   "token — under a mutable dataset the bytes opened may not "
                   "be the bytes validated")
    fix_hint = ("re-validate AFTER the open (fstat the handle / compare the "
                "open source's size / a generation-token check), or justify "
                "the window with an inline '# graftlint: disable=GL-R002' "
                "comment")

    def check(self, tree, ctx):
        scopes = [tree] + ctx.by_type(ast.FunctionDef, ast.AsyncFunctionDef)
        for scope in scopes:
            yield from self._check_scope(scope, ctx)

    def _check_scope(self, scope, ctx):
        from petastorm_tpu_torch.analysis.rules._astutil import walk_scope

        statted = {}  # arg chain -> stat call line
        opens = []    # (node, chain, line)
        for node in walk_scope(scope):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            callee = attr_chain(node.func) or call_func_name(node)
            if callee is None:
                continue
            target = attr_chain(node.args[0])
            if target is None:
                continue
            line = getattr(node, "lineno", 0)
            if callee in _STAT_CALLS:
                prev = statted.get(target)
                statted[target] = min(prev, line) if prev is not None else line
            elif callee in _OPEN_CALLS or \
                    (isinstance(node.func, ast.Attribute)
                     and node.func.attr in _OPEN_METHODS):
                opens.append((node, target, line))
        for node, target, line in opens:
            stat_line = statted.get(target)
            if stat_line is not None and stat_line < line:
                yield ctx.finding(
                    self, node,
                    "%r is opened here after being validated by a stat-family "
                    "call on line %d — a TOCTOU window: the file can change "
                    "between the two (re-validate after the open, or disable "
                    "with a justification)" % (target, stat_line))
