"""Observability rule: broad exceptions must not be silently swallowed.

``except Exception: pass`` (and the bare ``except: pass``) is the
anti-observability pattern: whatever failed — a wire fallback, a cache write,
a child teardown — leaves no log line, no counter, no flight-recorder event.
In a pipeline whose production failure mode is "silently limping",
every swallowed broad exception is a place the degradation log
(:func:`petastorm_tpu_torch.obs.log.degradation`) should have fired instead: it
costs one counter increment, warn-onces the log, and mirrors the event into
any live flight recorder.

GL-O002 flags a handler that (a) catches ``Exception``/``BaseException`` (or
a tuple containing one, or nothing at all — the bare ``except:``) AND (b) does
nothing but ``pass``. Narrow handlers (``except OSError: pass`` on a
best-effort unlink) stay clean — swallowing a *specific* expected error is a
decision; swallowing everything is a blindfold. Handlers that log, count,
re-raise, or otherwise act are clean whatever they catch. Genuinely-silent
teardown paths (interpreter shutdown, best-effort kills) carry an inline
``# graftlint: disable=GL-O002`` with their justification.
"""
from __future__ import annotations

import ast

from petastorm_tpu_torch.analysis.findings import Severity
from petastorm_tpu_torch.analysis.engine import Rule
from petastorm_tpu_torch.analysis.rules._astutil import children, walk

_BROAD = ("Exception", "BaseException")


def _is_broad(type_node):
    """True when the handler's exception spec includes Exception/BaseException
    (direct name, dotted ``builtins.Exception``, or inside a tuple) — or is
    absent entirely (bare ``except:``)."""
    if type_node is None:
        return True
    if isinstance(type_node, ast.Tuple):
        return any(_is_broad(elt) for elt in type_node.elts)
    if isinstance(type_node, ast.Name):
        return type_node.id in _BROAD
    if isinstance(type_node, ast.Attribute):
        return type_node.attr in _BROAD
    return False


#: provenance/trace span-open calls paired with their mandatory closers:
#: ``begin_item`` arms a THREAD-GLOBAL item context — left open it
#: misattributes every later span on that thread to the wrong item;
#: ``open_span`` returns a handle whose ``close()`` records the span — left
#: open the region silently never appears in any attribution report.
_SPAN_OPENERS = {"begin_item": "end_item", "open_span": "close"}


def _call_name(node):
    """Trailing identifier of a call's func (``x.y.begin_item`` → begin_item)."""
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _finally_calls(scope_body):
    """Every call name appearing inside ANY ``finally`` block of the scope
    (nested function defs excluded — their finallys protect their own opens),
    plus the receiver names of attribute calls (``h.close()`` → ``h``)."""
    names = set()
    receivers = set()
    for node in _walk_scope(scope_body):
        if not isinstance(node, ast.Try) or not node.finalbody:
            continue
        for stmt in node.finalbody:
            for sub in walk(stmt):
                if isinstance(sub, ast.Call):
                    name = _call_name(sub)
                    if name:
                        names.add(name)
                    if isinstance(sub.func, ast.Attribute) and \
                            isinstance(sub.func.value, ast.Name):
                        receivers.add((sub.func.value.id, sub.func.attr))
    return names, receivers


def _walk_scope(body):
    """Walk statements of one function scope WITHOUT descending into nested
    function/class definitions (each is its own span-pairing scope)."""
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue  # a nested scope: its opens/finallys are its own
        stack.extend(children(node))


class UnpairedSpanRule(Rule):
    """GL-O003: a trace/provenance span opened without a finally-guarded close.

    ``provenance.begin_item(...)`` must be paired with ``end_item()`` in a
    ``finally`` block of the same function, and an ``open_span(...)`` handle
    must be assigned and ``<handle>.close()``'d in a ``finally`` (or opened as
    a ``with`` context). An exception between open and close otherwise leaks
    the thread's item context (every later span on that thread lands on the
    WRONG item) or silently drops the span from the attribution report — the
    observability analog of a leaked resource, enforced statically like
    GL-L001's closers."""

    rule_id = "GL-O003"
    severity = Severity.WARNING
    description = ("trace/provenance span opened without a finally-guarded "
                   "close (begin_item without end_item in a finally; "
                   "open_span handle without .close() in a finally)")
    fix_hint = ("wrap the region in try/finally with end_item()/"
                "<handle>.close() in the finally (or use the `with "
                "provenance.span(...)` context manager), or justify with an "
                "inline '# graftlint: disable=GL-O003' comment")

    def check(self, tree, ctx):
        scopes = [tree.body]
        scopes.extend(n.body for n in ctx.by_type(ast.FunctionDef,
                                                  ast.AsyncFunctionDef))
        for body in scopes:
            yield from self._check_scope(body, ctx)

    def _check_scope(self, body, ctx):
        with_exprs = set()
        assigned_to = {}  # open-call node -> assigned simple name (or None)
        opens = []
        for node in _walk_scope(body):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    with_exprs.add(id(item.context_expr))
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                if len(node.targets) == 1 and \
                        isinstance(node.targets[0], ast.Name):
                    assigned_to[id(node.value)] = node.targets[0].id
            if isinstance(node, ast.Call) and _call_name(node) in _SPAN_OPENERS:
                opens.append(node)
        if not opens:
            return
        closer_names, closer_receivers = _finally_calls(body)
        for call in opens:
            if id(call) in with_exprs:
                continue  # `with open_span(...)`-style: closed by __exit__
            opener = _call_name(call)
            closer = _SPAN_OPENERS[opener]
            if opener == "begin_item":
                if closer in closer_names:
                    continue
            else:  # open_span: the HANDLE must be closed
                name = assigned_to.get(id(call))
                if name is not None and (name, closer) in closer_receivers:
                    continue
            yield ctx.finding(
                self, call,
                "%s(...) is not paired with a finally-guarded %s — an "
                "exception here leaks the span/item context and poisons "
                "every later attribution on this thread" % (opener, closer))


def _is_time_sleep(node):
    """``time.sleep(...)`` or a bare ``sleep(...)`` call."""
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr == "sleep" and isinstance(func.value, ast.Name) \
            and func.value.id == "time"
    return isinstance(func, ast.Name) and func.id == "sleep"


def _walk_loop(body):
    """Walk a loop body WITHOUT descending into nested function/class
    definitions (a closure's sleep is its own loop's business)."""
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(children(node))


class SleepyPollLoopRule(Rule):
    """GL-O004: a monitor/controller loop that watches an Event but sleeps
    with ``time.sleep()``.

    The pattern ``while not stop.is_set(): ...; time.sleep(t)`` (or the
    body-check variant ``while True: if stop.is_set(): break; time.sleep(t)``)
    is an *unkillable poll loop*: ``stop.set()`` does nothing until the
    current sleep expires, so teardown latency is the poll interval — and a
    long interval wedges joins, atexit hooks and test teardown behind it.
    The watcher/health/reporter threads each shipped this bug once before
    converging on ``stop_event.wait(timeout)``, which sleeps the same amount
    but wakes IMMEDIATELY on ``set()``. Loops that sleep without any Event in
    sight (deadline polls, retry backoff, CLI redraw loops) are clean — there
    is nothing to wake them.
    """

    rule_id = "GL-O004"
    severity = Severity.WARNING
    description = ("poll loop watching an Event but sleeping with "
                   "time.sleep() — stop() cannot wake it until the sleep "
                   "expires (use <event>.wait(timeout))")
    fix_hint = ("replace `while not ev.is_set(): ...; time.sleep(t)` with "
                "`while not ev.wait(t): ...` (same cadence, wakes immediately "
                "on set()), or justify with an inline "
                "'# graftlint: disable=GL-O004' comment")

    def check(self, tree, ctx):
        for node in ctx.by_type(ast.While):
            watches_event = any(
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "is_set"
                for sub in walk(node.test))
            sleeps = []
            for sub in _walk_loop(node.body):
                if isinstance(sub, ast.Call) and _is_time_sleep(sub):
                    sleeps.append(sub)
                elif not watches_event and isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == "is_set":
                    # body-check variant: `if stop.is_set(): break` + sleep
                    watches_event = True
            if not watches_event:
                continue
            for sleep_call in sleeps:
                yield ctx.finding(
                    self, sleep_call,
                    "this loop watches an Event (is_set) but sleeps with "
                    "time.sleep() — stop()/set() cannot wake it until the "
                    "sleep expires; use <event>.wait(timeout) as the loop "
                    "condition instead")


#: registry metric-factory method names whose keyword arguments (minus
#: ``help``) become label dimensions on the series name
_METRIC_FACTORIES = ("counter", "gauge", "histogram")

#: call names whose return value has unbounded cardinality — a label built
#: from one mints a fresh series per process/occurrence/path and walks the
#: registry straight into the DEFAULT_MAX_SERIES cap
_UNBOUNDED_CALLS = frozenset((
    "getpid", "getppid", "get_ident", "get_native_id",
    "uuid1", "uuid3", "uuid4", "uuid5",
    "time", "time_ns", "monotonic", "monotonic_ns", "perf_counter",
    "token_hex", "token_urlsafe", "hexdigest", "urandom",
    "mkdtemp", "mkstemp", "gettempdir", "getcwd",
    "abspath", "realpath", "basename", "dirname", "normpath", "expanduser",
))

#: through these the taint flows unchanged (str(pid) is as unbounded as pid)
_TAINT_TRANSPARENT = ("str", "repr", "format")


def _tainted(expr, env, depth=0):
    """The unbounded source feeding ``expr``, or None. ``env`` maps local
    names to their taint reason (loop targets over unbounded iterables,
    one-hop assignments from tainted expressions)."""
    if depth > 6:
        return None
    if isinstance(expr, ast.Call):
        name = _call_name(expr)
        if name in _UNBOUNDED_CALLS:
            return "%s()" % name
        if name in _TAINT_TRANSPARENT:
            for arg in expr.args:
                reason = _tainted(arg, env, depth + 1)
                if reason:
                    return reason
        return None
    if isinstance(expr, ast.Attribute) and expr.attr == "pid":
        return ".pid"
    if isinstance(expr, ast.Name):
        return env.get(expr.id)
    if isinstance(expr, ast.BinOp):  # "%s" % pid, prefix + path
        return _tainted(expr.left, env, depth + 1) \
            or _tainted(expr.right, env, depth + 1)
    if isinstance(expr, ast.JoinedStr):  # f"w{os.getpid()}"
        for value in expr.values:
            if isinstance(value, ast.FormattedValue):
                reason = _tainted(value.value, env, depth + 1)
                if reason:
                    return reason
    return None


def _bounded_iter(expr):
    """True when a ``for`` target over ``expr`` stays a bounded label set:
    a literal tuple/list/set of constants, or (by convention) an ALL-CAPS
    module constant like ``TIERS`` — a closed enum frozen at import time."""
    if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
        return all(isinstance(e, ast.Constant) for e in expr.elts)
    if isinstance(expr, ast.Name):
        return expr.id.isupper()
    if isinstance(expr, ast.Attribute):
        return expr.attr.isupper()
    return False


class UnboundedLabelRule(Rule):
    """GL-O005: a metric label value that flows from an unbounded source.

    Every distinct label value mints a separate series; the temporal plane
    caps total series at ``DEFAULT_MAX_SERIES`` and then silently drops new
    ones. A label built from a pid, uuid, timestamp, filesystem path, or a
    loop variable over an open-ended collection is the classic way to burn
    that budget: the dashboard goes blind precisely when the fleet scales.
    Bounded enums (a loop over an ALL-CAPS constant tuple like ``TIERS``)
    and validated slugs (``tenant=`` labels pass through
    :class:`petastorm_tpu_torch.obs.tenant.TenantContext`, which enforces a
    bounded closed-alphabet grammar precisely so this rule never has to
    flag them) stay clean."""

    rule_id = "GL-O005"
    severity = Severity.WARNING
    description = ("metric label value flows from an unbounded source "
                   "(pid/uuid/time/path call or a loop variable over an "
                   "open-ended iterable) — each value mints a new series "
                   "and exhausts the cardinality cap")
    fix_hint = ("label with a bounded validated slug (see obs.tenant"
                ".TenantContext), a fixed enum, or aggregate the dimension "
                "away; justify a genuinely bounded dynamic label with an "
                "inline '# graftlint: disable=GL-O005' comment")

    def check(self, tree, ctx):
        scopes = [tree.body]
        scopes.extend(n.body for n in ctx.by_type(ast.FunctionDef,
                                                  ast.AsyncFunctionDef))
        for body in scopes:
            yield from self._check_scope(body, ctx)

    def _check_scope(self, body, ctx):
        env = {}
        calls = []
        for node in _walk_scope(body):
            if isinstance(node, (ast.For, ast.AsyncFor)) \
                    and not _bounded_iter(node.iter):
                for target in walk(node.target):
                    if isinstance(target, ast.Name):
                        env[target.id] = ("the loop over %s"
                                          % (ast.unparse(node.iter)[:40]))
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                reason = _tainted(node.value, {})
                if reason:
                    env[node.targets[0].id] = reason
            elif isinstance(node, ast.Call) \
                    and _call_name(node) in _METRIC_FACTORIES \
                    and isinstance(node.func, ast.Attribute):
                calls.append(node)
        for call in calls:
            for kw in call.keywords:
                if kw.arg is None or kw.arg == "help":
                    continue
                reason = _tainted(kw.value, env)
                if reason:
                    yield ctx.finding(
                        self, call,
                        "label %s= flows from %s — an unbounded label value "
                        "mints a fresh series per occurrence and exhausts "
                        "the registry's cardinality cap"
                        % (kw.arg, reason))


#: provenance/trace span-recording calls whose time arguments MUST be
#: ``perf_counter`` samples: spans land on the recorder's perf timeline and
#: cross-process blobs are aligned through a (wall, perf) anchor pair, so a
#: wall-clock sample fed here is on the wrong timeline entirely
_SPAN_SINKS = frozenset((
    "add_span", "add_item_span", "batch_span", "transfer_span",
))


class WallClockSpanRule(Rule):
    """GL-O006: a wall-clock sample fed to a span sink (or a ``perf_anchor``).

    The provenance/trace planes keep every span on the process-local
    ``perf_counter`` timeline; wall time enters exactly once, as the
    ``(wall, perf)`` anchor pair that clock-aligns cross-process and
    cross-wire merges (``absorb_child``, the fleet ``merge_exports``). A
    ``time.time()`` sample passed as a span endpoint puts the span on the
    wrong timeline — after anchor alignment it lands decades off and every
    fold/merge built on it is garbage; a wall sample passed as a
    ``perf_anchor=`` poisons the alignment base itself, skewing EVERY span
    absorbed through it. GL-O001 catches wall-minus-wall durations; this
    rule catches the wall value escaping into the span plane before any
    subtraction happens. Keyword arguments whose names start with ``wall``
    (``wall_anchor=``) are the one sanctioned wall entry point and stay
    clean."""

    rule_id = "GL-O006"
    severity = Severity.WARNING
    description = ("wall-clock (time.time()) sample fed to a provenance/"
                   "trace span sink or perf_anchor — spans live on the "
                   "perf_counter timeline; anchored fleet merges break")
    fix_hint = ("sample time.perf_counter() for span endpoints and "
                "perf anchors; wall time belongs only in wall_anchor= "
                "(the clock-alignment pair), or justify with an inline "
                "'# graftlint: disable=GL-O006' comment")

    def check(self, tree, ctx):
        from petastorm_tpu_torch.analysis.rules._astutil import attr_chain, \
            walk_scope
        from petastorm_tpu_torch.analysis.rules.hotpath import _scopes, \
            _wall_clock_aliases

        aliases = _wall_clock_aliases(ctx)

        def is_wall_call(node):
            return isinstance(node, ast.Call) \
                and attr_chain(node.func) in aliases

        for scope in _scopes(ctx):
            sampled = set()  # names assigned from a time.time() call in scope
            for node in walk_scope(scope):
                if isinstance(node, ast.Assign) and is_wall_call(node.value):
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            sampled.add(target.id)

            def derives(node):
                return is_wall_call(node) or (
                    isinstance(node, ast.Name) and node.id in sampled)

            for node in walk_scope(scope):
                if not isinstance(node, ast.Call):
                    continue
                if _call_name(node) in _SPAN_SINKS:
                    for arg in node.args:
                        if derives(arg):
                            yield ctx.finding(
                                self, node,
                                "span endpoint derives from time.time() — "
                                "spans live on the perf_counter timeline; "
                                "after anchor alignment this span lands on "
                                "the wrong clock and breaks every fold/"
                                "merge over it")
                            break
                    for kw in node.keywords:
                        if kw.arg and not kw.arg.startswith("wall") \
                                and derives(kw.value):
                            yield ctx.finding(
                                self, node,
                                "span %s= derives from time.time() — spans "
                                "live on the perf_counter timeline; wall "
                                "time enters only through wall_anchor="
                                % kw.arg)
                else:
                    for kw in node.keywords:
                        if kw.arg == "perf_anchor" and derives(kw.value):
                            yield ctx.finding(
                                self, node,
                                "perf_anchor= derives from time.time() — a "
                                "wall sample as the perf anchor skews the "
                                "alignment base of EVERY span absorbed "
                                "through it")


class SilentExceptionSwallowRule(Rule):
    """GL-O002: ``except Exception: pass`` / bare ``except: pass``."""

    rule_id = "GL-O002"
    severity = Severity.WARNING
    description = ("broad exception silently swallowed (except Exception/bare "
                   "except whose body is only pass)")
    fix_hint = ("route it through petastorm_tpu_torch.obs.log.degradation(cause, ...) "
                "so it is counted and greppable, narrow the except to the "
                "specific expected error, or justify the silence with an "
                "inline '# graftlint: disable=GL-O002' comment")

    def check(self, tree, ctx):
        for node in ctx.by_type(ast.ExceptHandler):
            if not _is_broad(node.type):
                continue
            if len(node.body) == 1 and isinstance(node.body[0], ast.Pass):
                what = "bare except" if node.type is None \
                    else "except %s" % ast.unparse(node.type)
                yield ctx.finding(
                    self, node,
                    "%s swallows every error silently — anti-observability "
                    "(no log, no counter, no flight-record event)" % what)
