"""Capture-hazard rules for ``torch.compile`` bodies and CUDA graph captures.

Two regions of a torch program run host code once and replay or compile the
device work:

- a ``torch.compile`` body, traced by dynamo: a host read of a tensor breaks the
  graph (or freezes a value at trace time), and host I/O breaks it too;
- a CUDA graph capture (``with torch.cuda.graph(g):`` or a function handed to
  ``torch.cuda.make_graphed_callables``): a read of a device value on the host
  fails while the stream is capturing, a Python branch on a tensor needs exactly
  such a read, and host I/O runs once at capture and never on replay.

The three rules keep the ids and severities of the JAX package's tracing rules:

- GL-J001: a read of device values on the host — ``np.*`` calls (dtype
  metadata such as ``np.iinfo`` allowed), ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()`` and ``torch.cuda.synchronize()``;
- GL-J002: a Python ``if``/``while``/conditional expression whose test depends
  on a tensor argument of the compiled or graphed function, or on a tensor bound
  inside the captured block. ``is None``, ``.shape``, ``.ndim``, ``.dtype``,
  ``.device``, ``.dim()``, ``.numel()``, ``.size()`` and ``isinstance``/``len``
  and the like are static and stay clean; so does a parameter annotated with a
  Python scalar type (``int``, ``float``, ``bool``, ``str``), which dynamo
  specialises on;
- GL-J003: host I/O (print/open/time/logging...). ``os.path.*`` is exempt.

Recognised forms: ``@torch.compile``, ``@torch.compile(...)``,
``@functools.partial(torch.compile, ...)``, ``torch.compile(fn)`` on a local
``def fn`` (the nearest preceding def), ``with torch.cuda.graph(...):`` and
``torch.cuda.make_graphed_callables(fn, ...)`` (or a tuple of local functions).
``import torch as th`` and ``from torch(.cuda) import ...`` aliases resolve.

This analyzer lints the port: it does not look for ``jax.jit`` or ``pjit``.
"""
from __future__ import annotations

import ast

from petastorm_tpu_torch.analysis.findings import Severity
from petastorm_tpu_torch.analysis.engine import Rule
from petastorm_tpu_torch.analysis.rules._astutil import attr_chain, children, walk

_PARTIAL_CHAINS = {"functools.partial", "partial"}

#: np attributes that never touch array *values*: dtype/type metadata queries
_NP_ALLOWED = {"dtype", "iinfo", "finfo", "result_type", "promote_types",
               "can_cast", "broadcast_shapes"}
#: tensor methods that copy device values to the host
_HOST_READ_METHODS = {"item", "tolist", "cpu", "numpy"}

#: static tensor metadata — branching on these is fine
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device"}
_STATIC_METHODS = {"dim", "numel", "size"}
_STATIC_CALLS = {"isinstance", "len", "hasattr", "getattr", "callable", "type",
                 "issubclass"}
#: parameter annotations that mark a Python scalar, not a tensor
_SCALAR_ANNOTATIONS = {"int", "float", "bool", "str", "bytes"}

_IO_NAMES = {"print", "open", "input", "breakpoint"}
_IO_ROOTS = {"time", "os", "sys", "logging", "shutil", "socket", "subprocess",
             "io", "pathlib", "requests", "logger", "log"}
_IO_EXEMPT_PREFIXES = ("os.path.",)


class _Region:
    """One compiled or captured region: the nodes to walk, the names that hold
    tensors there, and how messages name it."""

    def __init__(self, kind, label, roots, tensors):
        self.kind = kind          # "compiled" | "captured"
        self.label = label        # "compiled `f`", "the CUDA graph capture at line 9"
        self.roots = roots        # nodes whose subtrees form the region
        self.tensors = tensors    # names GL-J002 treats as tensors

    def nodes(self):
        for root in self.roots:
            yield from walk(root)


def _torch_chains(ctx, dotted):
    """Every dotted name by which this file can spell ``torch.<dotted>``."""
    key = "tracing.chains." + dotted
    cached = ctx.cache.get(key)
    if cached is not None:
        return cached
    full = "torch." + dotted
    chains = {full}
    for node in ctx.by_type(ast.Import):
        for alias in node.names:
            if alias.name == "torch" and alias.asname:
                chains.add(alias.asname + "." + dotted)
    for node in ctx.by_type(ast.ImportFrom):
        module = node.module or ""
        if node.level or not (module == "torch" or module.startswith("torch.")):
            continue
        for alias in node.names:
            source = module + "." + alias.name
            bound = alias.asname or alias.name
            if full == source:
                chains.add(bound)
            elif full.startswith(source + "."):
                chains.add(bound + full[len(source):])
    ctx.cache[key] = chains
    return chains


def _compile_decorated(dec, compile_chains):
    """True for ``@torch.compile``, ``@torch.compile(...)`` and
    ``@functools.partial(torch.compile, ...)``."""
    if attr_chain(dec) in compile_chains:
        return True
    if isinstance(dec, ast.Call):
        chain = attr_chain(dec.func)
        if chain in compile_chains:
            return True
        if chain in _PARTIAL_CHAINS and dec.args \
                and attr_chain(dec.args[0]) in compile_chains:
            return True
    return False


def _local_def(defs, name_node, call):
    """The nearest def named like ``name_node`` at or above ``call``, or None."""
    if not isinstance(name_node, ast.Name):
        return None
    candidates = [d for d in defs
                  if d.name == name_node.id and d.lineno <= call.lineno]
    return max(candidates, key=lambda d: d.lineno) if candidates else None


def _tensor_params(funcdef):
    """Parameter names a compiled or graphed function receives tensors in."""
    args = list(funcdef.args.posonlyargs) + list(funcdef.args.args)
    if args and args[0].arg == "self":
        args = args[1:]
    args += list(funcdef.args.kwonlyargs)
    return {a.arg for a in args
            if not (isinstance(a.annotation, ast.Name)
                    and a.annotation.id in _SCALAR_ANNOTATIONS)}


def _bound_names(stmts):
    """Names a block of statements binds (assignments, loop and with targets)."""
    names = set()
    for stmt in stmts:
        for node in walk(stmt):
            targets = ()
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For,
                                   ast.AsyncFor, ast.NamedExpr)):
                targets = (node.target,)
            elif isinstance(node, ast.withitem) and node.optional_vars is not None:
                targets = (node.optional_vars,)
            for target in targets:
                for sub in walk(target):
                    if isinstance(sub, ast.Name):
                        names.add(sub.id)
    return names


def _regions(ctx):
    """Every compiled or captured region of the file, deduplicated. Cached on
    the FileContext: the three rules share one computation."""
    cached = ctx.cache.get("tracing.regions")
    if cached is not None:
        return cached
    compile_chains = _torch_chains(ctx, "compile")
    graph_chains = _torch_chains(ctx, "cuda.graph")
    graphed_chains = _torch_chains(ctx, "cuda.make_graphed_callables")
    defs = ctx.by_type(ast.FunctionDef, ast.AsyncFunctionDef)
    regions, seen = [], set()

    def add_function(funcdef, kind):
        if funcdef is None or funcdef in seen:
            return
        seen.add(funcdef)
        label = ("compiled `%s`" % funcdef.name if kind == "compiled"
                 else "CUDA-graphed `%s`" % funcdef.name)
        regions.append(_Region(kind, label, [funcdef], _tensor_params(funcdef)))

    for funcdef in defs:
        if any(_compile_decorated(d, compile_chains) for d in funcdef.decorator_list):
            add_function(funcdef, "compiled")
    for call in ctx.by_type(ast.Call):
        chain = attr_chain(call.func)
        if chain in compile_chains and call.args:
            add_function(_local_def(defs, call.args[0], call), "compiled")
        elif chain in graphed_chains and call.args:
            first = call.args[0]
            fns = first.elts if isinstance(first, (ast.Tuple, ast.List)) else [first]
            for fn in fns:
                add_function(_local_def(defs, fn, call), "captured")
    for with_node in ctx.by_type(ast.With, ast.AsyncWith):
        if any(isinstance(item.context_expr, ast.Call)
               and attr_chain(item.context_expr.func) in graph_chains
               for item in with_node.items):
            regions.append(_Region(
                "captured", "the CUDA graph capture at line %d" % with_node.lineno,
                list(with_node.body), _bound_names(with_node.body)))
    ctx.cache["tracing.regions"] = regions
    return regions


def _region_nodes(ctx, node_type):
    """(region, node) for each node of ``node_type`` in a region, each node once
    (a capture block inside a compiled function reports as the capture)."""
    done = set()
    for region in reversed(_regions(ctx)):
        for node in region.nodes():
            if isinstance(node, node_type) and node not in done:
                done.add(node)
                yield region, node


class NumpyInJitRule(Rule):
    """GL-J001: a host read of device values in a compiled or captured region."""

    rule_id = "GL-J001"
    severity = Severity.WARNING
    description = ("host read of device values inside a torch.compile body or a "
                   "CUDA graph capture")
    fix_hint = ("keep the value on the device (torch ops, torch.where); a host "
                "read fails while the stream is capturing, and in a compiled "
                "body it breaks the graph or freezes a trace-time constant")

    def check(self, tree, ctx):
        np_aliases = ctx.numpy_aliases
        sync_chains = _torch_chains(ctx, "cuda.synchronize")
        for region, node in _region_nodes(ctx, ast.Call):
            chain = attr_chain(node.func)
            shown = None
            if chain in sync_chains:
                shown = chain + "()"
            elif chain and "." in chain and chain.split(".", 1)[0] in np_aliases:
                if chain.rsplit(".", 1)[-1] not in _NP_ALLOWED:
                    shown = chain + "(...)"
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _HOST_READ_METHODS:
                shown = ".%s()" % node.func.attr
            if shown:
                yield ctx.finding(
                    self, node,
                    "`%s` inside %s reads device values on the host%s" % (
                        shown, region.label,
                        " (fails while the stream is capturing)"
                        if region.kind == "captured" else
                        " (a graph break or a trace-time constant)"))


class TracedBranchRule(Rule):
    """GL-J002: a Python branch on a tensor in a compiled or captured region."""

    rule_id = "GL-J002"
    severity = Severity.ERROR
    description = ("Python branch on a tensor inside a torch.compile body or a "
                   "CUDA graph capture")
    fix_hint = ("branch on the device with torch.where, or on static metadata "
                "(.shape, .dtype, .dim()); a tensor's truth value is a host read")

    def check(self, tree, ctx):
        for region, node in _region_nodes(ctx, (ast.If, ast.While, ast.IfExp)):
            if not region.tensors:
                continue
            hit = self._tensor_names_in_test(node.test, region.tensors)
            if not hit:
                continue
            kind = {"If": "if", "While": "while",
                    "IfExp": "conditional expression"}[type(node).__name__]
            finding = ctx.finding(
                self, node,
                "%s-branch on tensor%s `%s` of %s" % (
                    kind, "s" if len(hit) > 1 else "", "`, `".join(sorted(hit)),
                    region.label))
            # an If/While node's end_lineno spans its whole BODY; a suppression
            # comment must sit on the header, not anywhere inside the branch
            finding.end_line = getattr(node.test, "end_lineno", None) or finding.line
            yield finding

    @staticmethod
    def _tensor_names_in_test(test, tensors):
        """Tensor names the test's truthiness depends on, after pruning identity
        checks, static metadata and static calls."""
        hits = set()

        def visit(node):
            if isinstance(node, ast.Compare) and all(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return
            if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
                return
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Name) and node.func.id in _STATIC_CALLS:
                    return
                if isinstance(node.func, ast.Attribute):
                    if node.func.attr in _STATIC_METHODS:
                        return
                    # `x.any()`, `x.sum() > 0`: the receiver's value decides
                    visit(node.func.value)
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    visit(arg)
                return
            if isinstance(node, ast.Name) and node.id in tensors:
                hits.add(node.id)
                return
            for child in children(node):
                visit(child)

        visit(test)
        return hits


class HostIoInJitRule(Rule):
    """GL-J003: host I/O in a compiled or captured region."""

    rule_id = "GL-J003"
    severity = Severity.WARNING
    description = "host I/O inside a torch.compile body or a CUDA graph capture"
    fix_hint = ("hoist the I/O out of the compiled or captured region: it runs "
                "once at capture and never on replay, and breaks a compiled "
                "graph (torch has no traced print)")

    def check(self, tree, ctx):
        for region, node in _region_nodes(ctx, ast.Call):
            chain = attr_chain(node.func)
            flagged = None
            if isinstance(node.func, ast.Name) and node.func.id in _IO_NAMES:
                flagged = node.func.id
            elif chain and "." in chain:
                if chain.startswith(_IO_EXEMPT_PREFIXES):
                    continue
                if chain.split(".", 1)[0] in _IO_ROOTS:
                    flagged = chain
            if flagged:
                yield ctx.finding(
                    self, node,
                    "`%s(...)` inside %s %s" % (
                        flagged, region.label,
                        "runs once at capture, not on replay"
                        if region.kind == "captured" else
                        "breaks the graph and runs outside the compiled code"))
