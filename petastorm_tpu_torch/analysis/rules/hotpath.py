"""Hot-path timing rule: durations must come from a monotonic clock.

``time.time()`` is the WALL clock: NTP slews and steps move it mid-run, so a
duration computed as the difference of two ``time.time()`` samples can come out
wrong — or negative — exactly when a long pipeline run crosses a clock
adjustment. Every per-stage timer in this codebase (``PipelineStats``,
``TraceRecorder``, the slab ring's acquire wait, every benchmark window) uses
``time.perf_counter()`` for that reason; GL-O001 keeps it that way.

The rule flags a subtraction whose operands BOTH derive from ``time.time()``
(a direct call, or a name assigned from one in the same scope) — the
two-samples-of-the-wall-clock pattern that encodes a duration. Legitimate
wall-clock uses stay clean: timestamps for logs/artifacts, deadline arithmetic
(``time.time() + 10``), and comparisons against file mtimes (one operand is not
a wall-clock sample).
"""
from __future__ import annotations

import ast

from petastorm_tpu_torch.analysis.findings import Severity
from petastorm_tpu_torch.analysis.engine import Rule
from petastorm_tpu_torch.analysis.rules._astutil import attr_chain, walk_scope


def _wall_clock_aliases(ctx):
    """Dotted call chains that mean ``time.time`` in this file: the module form
    plus any ``from time import time [as x]`` binding."""
    aliases = {"time.time"}
    for node in ctx.by_type(ast.ImportFrom):
        if node.module == "time":
            for a in node.names:
                if a.name == "time":
                    aliases.add(a.asname or "time")
    for node in ctx.by_type(ast.Import):
        for a in node.names:
            if a.name == "time" and a.asname:
                aliases.add("%s.time" % a.asname)
    return aliases


def _scopes(ctx):
    """Module, every class body, and every function/method body — each is one
    name-resolution scope for the assigned-from-time.time() tracking (walked
    with the shared ``walk_scope`` helper, which stops at nested scopes)."""
    yield ctx.tree
    yield from ctx.by_type(ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


class WallClockDurationRule(Rule):
    """GL-O001: duration computed from ``time.time()`` samples."""

    rule_id = "GL-O001"
    severity = Severity.WARNING
    description = "time.time() used to compute a duration"
    fix_hint = ("use time.perf_counter() for durations: the wall clock is "
                "adjusted by NTP slews/steps mid-run, so time.time() deltas "
                "can be wrong or negative; keep time.time() for timestamps")

    def check(self, tree, ctx):
        aliases = _wall_clock_aliases(ctx)

        def is_wall_call(node):
            return isinstance(node, ast.Call) and attr_chain(node.func) in aliases

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
                if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub) \
                        and derives(node.left) and derives(node.right):
                    yield ctx.finding(
                        self, node,
                        "duration computed from time.time() samples (wall "
                        "clock); use time.perf_counter()")
