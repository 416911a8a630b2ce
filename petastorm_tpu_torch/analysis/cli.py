"""``petastorm-tpu-torch-lint`` console script.

Exit codes: 0 = clean (baselined findings allowed), 1 = new findings,
2 = not a lint result — an internal analyzer error, a bad path, or a
command-line usage error (argparse's own convention is also 2). Automation
should branch on 0 vs 1 and treat 2 as "the lint did not run". Run it over the
port's package, its tests and its examples as

    petastorm-tpu-torch-lint petastorm_tpu_torch/ tests/test_torch_*.py \
        tests/_torch_*.py examples/torch/
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

from petastorm_tpu_torch.analysis.baseline import Baseline
from petastorm_tpu_torch.analysis.engine import (
    analyze_paths,
    default_project_rules,
    default_rules,
    iter_python_files,
)

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_INTERNAL_ERROR = 2


def _build_parser():
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-lint",
        description="Project-native static analysis: concurrency, resource "
                    "lifecycle, torch.compile/CUDA graph capture, and schema/codec "
                    "contract rules. "
                    "Rule ids as in docs/static_analysis.md.")
    parser.add_argument("paths", nargs="*", default=["petastorm_tpu_torch"],
                        help="files or directories to analyze "
                             "(default: petastorm_tpu_torch)")
    parser.add_argument("--baseline", default=None,
                        help="baseline file (default: nearest "
                             ".graftlint-baseline.json above the first path)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore any baseline file (report everything)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="accept the current findings into the baseline "
                             "file and exit 0")
    parser.add_argument("--select", default=None,
                        help="comma-separated rule ids to run (default: all)")
    parser.add_argument("--ignore", default=None,
                        help="comma-separated rule ids to skip")
    parser.add_argument("--format", choices=("text", "json", "github"),
                        default="text",
                        help="output format ('github' emits workflow-command "
                             "annotations — ::error file=...,line=... — so "
                             "findings annotate the PR diff)")
    parser.add_argument("--list-rules", action="store_true",
                        help="list registered rules and exit")
    parser.add_argument("--show-baselined", action="store_true",
                        help="also print findings covered by the baseline")
    return parser


def _pick_rules(args):
    """(per-file rules, project rules) after --select/--ignore filtering —
    one id namespace across both registries, so ``--select GL-C005`` runs
    just the project phase and ``--ignore GL-C006`` drops it."""
    rules = default_rules()
    project_rules = default_project_rules()
    if args.select:
        wanted = {r.strip() for r in args.select.split(",")}
        rules = [r for r in rules if r.rule_id in wanted]
        project_rules = [r for r in project_rules if r.rule_id in wanted]
        missing = wanted - {r.rule_id for r in rules} \
            - {r.rule_id for r in project_rules}
        if missing:
            raise ValueError("unknown rule id(s): %s" % ", ".join(sorted(missing)))
    if args.ignore:
        dropped = {r.strip() for r in args.ignore.split(",")}
        rules = [r for r in rules if r.rule_id not in dropped]
        project_rules = [r for r in project_rules
                         if r.rule_id not in dropped]
    return rules, project_rules


def _resolve_baseline(args):
    if args.no_baseline:
        return None
    if args.baseline:
        if os.path.isfile(args.baseline):
            return Baseline.load(args.baseline)
        return Baseline({}, path=args.baseline)  # --write-baseline target
    found = Baseline.find(os.path.dirname(os.path.abspath(args.paths[0]))
                          if os.path.isfile(args.paths[0]) else args.paths[0])
    return Baseline.load(found) if found else None


def _gh_escape(value, in_property=False):
    """Escape per the GitHub workflow-command rules: ``%``/CR/LF always, and
    ``,``/``:`` additionally inside property values."""
    value = str(value).replace("%", "%25").replace("\r", "%0D") \
        .replace("\n", "%0A")
    if in_property:
        value = value.replace(",", "%2C").replace(":", "%3A")
    return value


def _gh_annotation(finding):
    """One ``::error``/``::warning`` workflow command for a finding. Paths are
    repo-relative (annotations only attach to the diff when they match the
    checkout's paths)."""
    level = "error" if str(finding.severity) == "error" else "warning"
    path = os.path.relpath(finding.path).replace(os.sep, "/")
    props = "file=%s,line=%d,col=%d,title=%s" % (
        _gh_escape(path, in_property=True), finding.line, finding.col,
        _gh_escape(finding.rule_id, in_property=True))
    message = finding.message
    if finding.fix_hint:
        message += " — " + finding.fix_hint
    return "::%s %s::%s" % (level, props, _gh_escape(message))


def run(argv=None):
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        for rule in default_rules() + default_project_rules():
            print("%s  [%s]  %s" % (rule.rule_id, rule.severity, rule.description))
        return EXIT_CLEAN

    rules, project_rules = _pick_rules(args)
    findings, n_suppressed = analyze_paths(args.paths, rules,
                                           project_rules=project_rules)
    baseline = _resolve_baseline(args)

    if args.write_baseline:
        path = (baseline.path if baseline is not None
                else os.path.join(os.getcwd(), ".graftlint-baseline.json"))
        root = os.path.dirname(os.path.abspath(path))
        analyzed = {
            os.path.relpath(os.path.abspath(p), root).replace(os.sep, "/")
            for p in iter_python_files(args.paths)
        }
        updated = Baseline.from_findings(
            findings, path, previous=baseline, analyzed_paths=analyzed,
            run_rules={r.rule_id for r in rules + project_rules})
        updated.save(path)
        print("wrote %d baseline entr%s to %s" % (
            len(updated.entries), "y" if len(updated.entries) == 1 else "ies",
            path))
        return EXIT_CLEAN

    if baseline is not None:
        new, baselined = baseline.filter(findings)
        stale = baseline.stale_entries(findings)
    else:
        new, baselined, stale = findings, [], []

    if args.format == "github":
        for f in new:
            print(_gh_annotation(f))
        print("%d finding%s, %d baselined, %d suppressed inline" % (
            len(new), "" if len(new) == 1 else "s", len(baselined),
            n_suppressed))
    elif args.format == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in new],
            "baselined": [f.to_dict() for f in baselined],
            "suppressed_inline": n_suppressed,
            "stale_baseline_entries": [list(k) for k in stale],
        }, indent=2))
    else:
        for f in new:
            print(f.format())
        if args.show_baselined and baselined:
            print("\nbaselined findings:")
            for f in baselined:
                print("  " + f.format(show_hint=False))
        if stale:
            print("\nnote: %d stale baseline entr%s (fixed findings — run "
                  "--write-baseline to prune):" % (
                      len(stale), "y" if len(stale) == 1 else "ies"))
            for rule, path, code in stale:
                print("  %s %s: %s" % (rule, path, code))
        summary = "%d finding%s" % (len(new), "" if len(new) == 1 else "s")
        if baselined:
            summary += ", %d baselined" % len(baselined)
        if n_suppressed:
            summary += ", %d suppressed inline" % n_suppressed
        print(summary)
    return EXIT_FINDINGS if new else EXIT_CLEAN


def main(argv=None):
    try:
        return run(argv)
    except KeyboardInterrupt:
        return 130  # conventional SIGINT code — NOT an internal error
    except BrokenPipeError:
        return 141  # downstream pager/head closed the pipe — not our bug
    except SystemExit:
        raise
    except Exception:  # noqa: BLE001 — exit 2 is the internal-error contract
        traceback.print_exc()
        return EXIT_INTERNAL_ERROR


if __name__ == "__main__":
    sys.exit(main())
