"""Small AST helpers shared by the rule visitors."""
from __future__ import annotations

import ast

_NO_CHILDREN = ()


def children(node):
    """``ast.iter_child_nodes(node)`` as a tuple, built once and kept on the node.
    Every rule walks the same trees, and deriving a node's children anew on each
    walk was most of the analyzer's time."""
    try:
        return node._gl_children
    except AttributeError:
        pass
    out = []
    for name in node._fields:
        value = getattr(node, name, None)
        if isinstance(value, ast.AST):
            out.append(value)
        elif isinstance(value, list):
            out.extend(item for item in value if isinstance(item, ast.AST))
    kids = tuple(out) if out else _NO_CHILDREN
    node._gl_children = kids
    return kids


def walk(node):
    """``ast.walk``: the same nodes in the same breadth-first order, over
    :func:`children`."""
    out = [node]
    i = 0
    while i < len(out):
        out.extend(children(out[i]))
        i += 1
    return iter(out)


def attr_chain(node):
    """Dotted-name string for a Name/Attribute chain ('torch.compile'), else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def self_attr(node):
    """Attribute name when ``node`` is ``self.<attr>``, else None."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def call_func_name(call):
    """Last segment of a Call's func ('make_reader' for pkg.make_reader(...))."""
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def call_kwarg(call, name):
    """The keyword argument node named ``name``, or None."""
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def literal_strings(node):
    """String constants inside a str/tuple/list literal, or None when not literal."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                out.append(elt.value)
            else:
                return None
        return out
    return None


def literal_ints(node):
    """Int constants inside an int/tuple/list literal, or None when not literal."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, int):
                out.append(elt.value)
            else:
                return None
        return out
    return None


_NESTED_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)


def walk_scope(node):
    """Iterate the nodes of ``node``'s body WITHOUT descending into nested
    function or class definitions (their bodies are separate execution scopes).
    The list is built once and kept on the node: several rules walk each scope."""
    try:
        return iter(node._gl_scope)
    except AttributeError:
        pass
    out = []
    stack = list(children(node))
    while stack:
        child = stack.pop()
        out.append(child)
        if not isinstance(child, _NESTED_SCOPES):
            stack.extend(children(child))
    node._gl_scope = out
    return iter(out)
