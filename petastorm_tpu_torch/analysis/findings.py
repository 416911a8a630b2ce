"""Findings model: what a rule reports and how it prints."""
from __future__ import annotations

from dataclasses import dataclass, field


class Severity:
    """Finding severities. Both fail the build (exit 1) — the split is advisory:
    ``ERROR`` findings are near-certain defects, ``WARNING`` findings are hazards
    a human should either fix or baseline with a justification."""

    ERROR = "error"
    WARNING = "warning"


@dataclass
class Finding:
    """One rule violation at a source location."""

    rule_id: str
    severity: str
    path: str  # as given to the engine (CLI prints it verbatim)
    line: int
    col: int
    message: str
    fix_hint: str = ""
    #: stripped source text of ``line`` — the baseline matches on this, not the
    #: line number, so unrelated edits above a baselined finding don't unbaseline it
    code: str = field(default="", repr=False)
    #: last line of the flagged node — an inline suppression anywhere on a
    #: multi-line statement (the natural trailing-comment spot) must apply
    end_line: int = field(default=0, repr=False)

    def format(self, show_hint=True):
        text = "%s:%d:%d: %s [%s] %s" % (
            self.path, self.line, self.col, self.severity, self.rule_id, self.message)
        if show_hint and self.fix_hint:
            text += "\n    hint: %s" % self.fix_hint
        return text

    def to_dict(self):
        return {
            "rule": self.rule_id,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "fix_hint": self.fix_hint,
            "code": self.code,
        }
