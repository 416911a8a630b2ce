"""Suppression baseline: known findings accepted with a justification.

The baseline file (``.graftlint-baseline.json``, checked in at the repo root)
lets the linter gate NEW findings while carrying a reviewed set of accepted
ones. Entries match on ``(rule, path, stripped source line)`` — not the line
number — so edits elsewhere in a file don't churn the baseline; ``count``
covers N identical lines (e.g. the same pattern in two branches).

Every entry carries a ``justification`` explaining why the finding is accepted
rather than fixed; ``petastorm-tpu-torch-lint --write-baseline`` refreshes the file
(new entries get a TODO justification a maintainer must fill in).
"""
from __future__ import annotations

import json
import os


class Baseline:
    def __init__(self, entries=None, path=None):
        #: (rule, relpath, code) -> {"count": int, "justification": str}
        self.entries = entries or {}
        self.path = path

    # -- IO ----------------------------------------------------------------------------

    @classmethod
    def load(cls, path):
        with open(path, "r", encoding="utf-8") as f:
            payload = json.load(f)
        entries = {}
        for e in payload.get("entries", []):
            key = (e["rule"], e["path"], e["code"])
            entries[key] = {
                "count": int(e.get("count", 1)),
                "justification": e.get("justification", ""),
            }
        return cls(entries, path=path)

    @classmethod
    def find(cls, start_dir):
        """Locate ``.graftlint-baseline.json`` in ``start_dir`` or a parent."""
        d = os.path.abspath(start_dir)
        while True:
            candidate = os.path.join(d, ".graftlint-baseline.json")
            if os.path.isfile(candidate):
                return candidate
            parent = os.path.dirname(d)
            if parent == d:
                return None
            d = parent

    def save(self, path=None):
        path = path or self.path
        entries = []
        for (rule, relpath, code), meta in sorted(self.entries.items()):
            entries.append({
                "rule": rule,
                "path": relpath,
                "code": code,
                "count": meta["count"],
                "justification": meta["justification"],
            })
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"version": 1, "entries": entries}, f, indent=2)
            f.write("\n")

    # -- matching ----------------------------------------------------------------------

    def _relpath(self, finding_path):
        if self.path is None:
            return finding_path
        root = os.path.dirname(os.path.abspath(self.path))
        rel = os.path.relpath(os.path.abspath(finding_path), root)
        return rel.replace(os.sep, "/")

    def key_for(self, finding):
        return (finding.rule_id, self._relpath(finding.path), finding.code)

    def filter(self, findings):
        """Split findings into (new, baselined) honoring per-entry counts."""
        remaining = {k: v["count"] for k, v in self.entries.items()}
        new, baselined = [], []
        for f in findings:
            key = self.key_for(f)
            if remaining.get(key, 0) > 0:
                remaining[key] -= 1
                baselined.append(f)
            else:
                new.append(f)
        return new, baselined

    def stale_entries(self, findings):
        """Baseline entries with UNUSED capacity — fully fixed, or count:N
        entries where fewer than N occurrences remain. Partially-consumed
        entries matter: their leftover count would silently absorb the next NEW
        identical finding, so they must be reported for a --write-baseline
        refresh just like fully-fixed ones."""
        used = {}
        for f in findings:
            key = self.key_for(f)
            used[key] = used.get(key, 0) + 1
        return [key for key, meta in sorted(self.entries.items())
                if used.get(key, 0) < meta["count"]]

    @classmethod
    def from_findings(cls, findings, path, previous=None, analyzed_paths=None,
                      run_rules=None):
        """Build a baseline covering ``findings``; justifications carried over
        from ``previous`` when the entry already existed.

        ``analyzed_paths`` (relative paths, baseline-root convention) marks
        which files this run actually scanned, and ``run_rules`` which rule ids
        actually ran: previous entries for files OUTSIDE that set — or for
        rules excluded via --select/--ignore — are preserved verbatim. Running
        ``--write-baseline`` on a subset of the tree or of the rules must not
        prune the rest of the baseline ('not scanned' is not 'fixed')."""
        baseline = cls({}, path=path)
        for f in findings:
            if f.rule_id == "GL-X001":
                # a parse/read error is never an acceptable steady state — and
                # its fingerprint would match any future breakage of the file
                continue
            key = baseline.key_for(f)
            if key in baseline.entries:
                baseline.entries[key]["count"] += 1
            else:
                just = ""
                if previous is not None:
                    prev = previous.entries.get(key)
                    if prev:
                        just = prev["justification"]
                baseline.entries[key] = {
                    "count": 1,
                    "justification": just or "TODO: justify or fix",
                }
        if previous is not None:
            for key, meta in previous.entries.items():
                if key in baseline.entries:
                    continue
                outside_paths = analyzed_paths is not None \
                    and key[1] not in analyzed_paths
                outside_rules = run_rules is not None and key[0] not in run_rules
                if outside_paths or outside_rules:
                    baseline.entries[key] = dict(meta)
        return baseline
