"""Rule engine: parse files, run rule visitors, apply inline suppressions.

A rule is an object with ``rule_id``, ``severity``, ``description`` and a
``check(tree, ctx)`` generator yielding :class:`~petastorm_tpu_torch.analysis.findings.Finding`.
``ctx`` is a :class:`FileContext` carrying the source text, path, a lazily built
child→parent node map, and helpers shared by several rules (import-alias
resolution, source-line extraction).

Two phases share every parsed tree. The per-file phase runs each
:class:`Rule` over one module at a time; the whole-program phase then builds a
:class:`~petastorm_tpu_torch.analysis.project.ProjectContext` over the SAME
``FileContext`` objects — no file is read or parsed twice — and runs each
:class:`ProjectRule` once across the corpus. Findings from both phases flow
through the same inline-suppression and baseline machinery: a project-phase
finding lands on a concrete file/line, so ``# graftlint: disable=GL-C005`` and
baseline entries behave identically for it.

Inline suppressions (documented in docs/static_analysis.md):

- ``# graftlint: disable=GL-C001`` (comma-separated ids, or ``all``) on the
  flagged line suppresses findings on that line;
- ``# graftlint: disable-file=GL-J001`` anywhere in the file suppresses the
  named rules (or ``all``) for the whole file.
"""
from __future__ import annotations

import ast
import io
import os
import re
import tokenize

from petastorm_tpu_torch.analysis.findings import Finding, Severity

_SUPPRESS_LINE = re.compile(r"#\s*graftlint:\s*disable=([\w\-,]+)")
_SUPPRESS_FILE = re.compile(r"#\s*graftlint:\s*disable-file=([\w\-,]+)")


class FileContext:
    """Per-file state shared by rule visitors."""

    def __init__(self, path, source, tree):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self._parents = None
        self._numpy_aliases = None
        self._walk_cache = None
        self._type_index = None
        #: cross-rule memoization slot (e.g. the tracing rules' region index):
        #: three rules needing the same derived index compute it once
        self.cache = {}

    def walk(self):
        """Every node of the tree, walked ONCE and cached. The rules iterate
        this instead of re-running ``ast.walk(tree)`` each — with ~16 per-file
        rules plus the project phase, repeated full walks were the analyzer's
        dominant cost (not parsing)."""
        if self._walk_cache is None:
            from petastorm_tpu_torch.analysis.rules._astutil import walk

            self._walk_cache = list(walk(self.tree))
        return self._walk_cache

    def by_type(self, *types):
        """All nodes of the given AST type(s), from a bucket index built once
        per file. Order follows the cached walk (breadth-first, same as
        ``ast.walk``)."""
        if self._type_index is None:
            index = {}
            for node in self.walk():
                index.setdefault(type(node), []).append(node)
            self._type_index = index
        if len(types) == 1:
            return self._type_index.get(types[0], [])
        out = []
        for t in types:
            out.extend(self._type_index.get(t, []))
        return out

    @property
    def parents(self):
        """Child node → parent node map (built once per file)."""
        if self._parents is None:
            from petastorm_tpu_torch.analysis.rules._astutil import children

            self._parents = {}
            for parent in self.walk():
                for child in children(parent):
                    self._parents[child] = parent
        return self._parents

    def parent(self, node):
        return self.parents.get(node)

    def code_at(self, line):
        """Stripped source text of a 1-based line (baseline fingerprint input)."""
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    @property
    def numpy_aliases(self):
        """Names the file binds to the numpy module (``import numpy as np`` …)."""
        if self._numpy_aliases is None:
            aliases = set()
            for node in self.by_type(ast.Import):
                for a in node.names:
                    if a.name == "numpy":
                        aliases.add(a.asname or "numpy")
            aliases.update({"np", "numpy"} & _module_like_names(self))
            self._numpy_aliases = aliases or {"np", "numpy"}
        return self._numpy_aliases

    def finding(self, rule, node, message, fix_hint=""):
        line = getattr(node, "lineno", 1)
        return Finding(
            rule_id=rule.rule_id,
            severity=rule.severity,
            path=self.path,
            line=line,
            col=getattr(node, "col_offset", 0) + 1,
            message=message,
            fix_hint=fix_hint or rule.fix_hint,
            code=self.code_at(line),
            end_line=getattr(node, "end_lineno", None) or line,
        )


def _module_like_names(ctx):
    names = set()
    for node in ctx.by_type(ast.Import):
        for a in node.names:
            names.add((a.asname or a.name).split(".")[0])
    return names


class Rule:
    """Base rule: subclasses set the id/severity/description and implement check."""

    rule_id = "GL-X000"
    severity = Severity.ERROR
    description = ""
    fix_hint = ""

    def check(self, tree, ctx):
        raise NotImplementedError


class ProjectRule(Rule):
    """Whole-program rule: runs ONCE over the
    :class:`~petastorm_tpu_torch.analysis.project.ProjectContext` built from every
    parsed file, after the per-file phase. Subclasses implement
    ``check_project(project)`` yielding Findings anchored at concrete
    file/line positions (so inline suppressions and the baseline apply
    unchanged)."""

    def check(self, tree, ctx):
        return iter(())  # project rules have no per-file phase

    def check_project(self, project):
        raise NotImplementedError


class ParseErrorRule(Rule):
    """Not a real visitor — the id under which unparseable files are reported."""

    rule_id = "GL-X001"
    severity = Severity.ERROR
    description = "file could not be parsed as Python"


def default_rules():
    from petastorm_tpu_torch.analysis.rules import ALL_RULES

    return [cls() for cls in ALL_RULES]


def default_project_rules():
    from petastorm_tpu_torch.analysis.rules import ALL_PROJECT_RULES

    return [cls() for cls in ALL_PROJECT_RULES]


def _suppressions(source):
    """(per-line {lineno: set(ids)}, file-wide set(ids)); 'all' means every rule.

    Matches COMMENT tokens only (via tokenize): a ``# graftlint: disable=...``
    inside a string literal — lint-fixture strings in the analyzer's own test
    suite, docstrings quoting the syntax — must NOT register a suppression."""
    per_line = {}
    per_file = set()
    if "graftlint" not in source:
        return per_line, per_file  # no directive anywhere: skip the tokenizer
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError, ValueError):
        return per_line, per_file  # ast.parse succeeded upstream; be safe anyway
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_FILE.search(tok.string)
        if m:
            per_file.update(x.strip() for x in m.group(1).split(","))
            continue
        m = _SUPPRESS_LINE.search(tok.string)
        if m:
            per_line.setdefault(tok.start[0], set()).update(
                x.strip() for x in m.group(1).split(","))
    return per_line, per_file


def _suppressed(finding, per_line, per_file):
    if "all" in per_file or finding.rule_id in per_file:
        return True
    # a comment on ANY line of the flagged statement counts: the natural spot
    # for a trailing `# graftlint: disable=` on a multi-line call is its last line
    last = max(finding.line, finding.end_line or finding.line)
    for line in range(finding.line, last + 1):
        ids = per_line.get(line, ())
        if "all" in ids or finding.rule_id in ids:
            return True
    return False


def _parse_error_finding(source, path, e):
    rule = ParseErrorRule()
    lines = source.splitlines()
    lineno = e.lineno or 1
    # a real code fingerprint: an empty one would make a baselined parse
    # error match EVERY future parse error in the file
    code = lines[lineno - 1].strip() if 0 < lineno <= len(lines) else ""
    return Finding(rule.rule_id, rule.severity, path, lineno,
                   (e.offset or 0) + 1, "syntax error: %s" % e.msg, code=code)


def _run_project_phase(contexts, project_rules):
    """Run each project rule once over the already-parsed corpus."""
    if not project_rules or not contexts:
        return []
    from petastorm_tpu_torch.analysis.project import ProjectContext

    project = ProjectContext(contexts)
    findings = []
    for rule in project_rules:
        findings.extend(rule.check_project(project))
    return findings


def analyze_source(source, path="<string>", rules=None, project_rules=None):
    """Run rules over one source string. Returns (findings, suppressed_count).

    The project phase runs too, over a single-module corpus — so fixture
    strings exercise GL-C005/GL-C006 exactly like files on disk do."""
    rules = default_rules() if rules is None else rules
    project_rules = default_project_rules() if project_rules is None \
        else project_rules
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [_parse_error_finding(source, path, e)], 0
    ctx = FileContext(path, source, tree)
    per_line, per_file = _suppressions(source)
    findings, n_suppressed = [], 0
    all_findings = []
    for rule in rules:
        all_findings.extend(rule.check(tree, ctx))
    all_findings.extend(_run_project_phase([ctx], project_rules))
    for finding in all_findings:
        if _suppressed(finding, per_line, per_file):
            n_suppressed += 1
        else:
            findings.append(finding)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule_id))
    return findings, n_suppressed


def iter_python_files(paths):
    """Expand files/directories into .py files (skips hidden dirs and __pycache__).

    A path that does not exist — or an explicit file that is not Python — raises
    instead of being silently skipped: a typo'd path in the CI lint step must
    fail the build (exit 2), not report '0 findings' forever. Overlapping path
    arguments (`lint dir/ dir/m.py`) are deduplicated — analyzing a file twice
    would double its findings and spuriously exhaust baseline counts."""
    seen = set()

    def emit(p):
        key = os.path.realpath(p)
        if key in seen:
            return None
        seen.add(key)
        return p

    for path in paths:
        if os.path.isfile(path):
            if not path.endswith(".py"):
                raise ValueError("not a Python file: %s" % path)
            p = emit(path)
            if p is not None:
                yield p
            continue
        if not os.path.isdir(path):
            raise FileNotFoundError("no such file or directory: %s" % path)
        for root, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(
                d for d in dirnames
                if not d.startswith(".") and d != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    p = emit(os.path.join(root, fn))
                    if p is not None:
                        yield p


def analyze_paths(paths, rules=None, project_rules=None):
    """Run rules over files/directories. Returns (findings, suppressed_count).

    Each file is read and parsed ONCE; the resulting ``FileContext`` objects
    (with their cached walks and suppression maps) feed both the per-file
    phase and the whole-program project phase."""
    rules = default_rules() if rules is None else rules
    project_rules = default_project_rules() if project_rules is None \
        else project_rules
    findings, n_suppressed = [], 0
    contexts, suppression_maps = [], {}
    for path in iter_python_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
        except (OSError, UnicodeDecodeError) as e:
            rule = ParseErrorRule()
            findings.append(Finding(rule.rule_id, rule.severity, path, 1, 1,
                                    "cannot read file: %s" % e))
            continue
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            findings.append(_parse_error_finding(source, path, e))
            continue
        ctx = FileContext(path, source, tree)
        contexts.append(ctx)
        per_line, per_file = _suppressions(source)
        suppression_maps[path] = (per_line, per_file)
        file_findings = []
        for rule in rules:
            file_findings.extend(rule.check(tree, ctx))
        file_findings.sort(key=lambda f: (f.line, f.col, f.rule_id))
        for finding in file_findings:
            if _suppressed(finding, per_line, per_file):
                n_suppressed += 1
            else:
                findings.append(finding)
    project_findings = _run_project_phase(contexts, project_rules)
    project_findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule_id))
    for finding in project_findings:
        per_line, per_file = suppression_maps.get(finding.path, ({}, set()))
        if _suppressed(finding, per_line, per_file):
            n_suppressed += 1
        else:
            findings.append(finding)
    return findings, n_suppressed
