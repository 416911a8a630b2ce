"""Attribution regression forensics: ``python -m petastorm_tpu_torch.obs.diff run_a run_b``.

Port of ``petastorm_tpu.obs.diff``. The trend gate
(:mod:`petastorm_tpu_torch.benchmark.trend`) says *that* rows/s regressed; this module
says *why*: trend entries carry the per-site critical-path self times of their measured
workload (the attribution plane's ``stage_self_s``), so two runs diff site by site,
"rows/s -28.0%: io.remote self-time 2.3x", naming the regressed seam instead of leaving
the operator to bisect. The entries are the JAX package's schema, so each package's
``diff`` reads the other's history.

``run_a``/``run_b`` select runs three ways:

- a path to a JSON/JSONL file (the LAST trend-schema entry in it wins; a
  ``BENCH_HISTORY.jsonl`` copy works as is);
- an integer index into ``--history`` (Python semantics: ``-1`` is the newest entry,
  ``-2`` the one before);
- the words ``latest`` / ``prev`` (aliases for ``-1`` / ``-2``).

The last stdout line is a one-line JSON verdict (schema ``ptpu-bench-diff-v1``) so CI
can gate on it; ``--fail-threshold`` makes the command itself exit 1 on a rows/s
regression beyond the fraction. ``--history`` defaults to ``BENCH_HISTORY.jsonl`` in the
working directory, as in the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os

DIFF_SCHEMA = "ptpu-bench-diff-v1"

#: a site must own at least this share of either run's total self time to be
#: named (sub-noise sites produce huge meaningless ratios)
_MIN_SITE_SHARE = 0.05
#: and its self-time ratio must move at least this much to be called regressed
_MIN_RATIO = 1.25


def _trend_entries(path):
    from petastorm_tpu_torch.benchmark.trend import ACCEPTED_SCHEMAS

    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict) \
                    and obj.get("schema") in ACCEPTED_SCHEMAS:
                entries.append(obj)
    if not entries:
        # a bare JSON file holding one entry (or a list) also works
        with open(path) as f:
            try:
                obj = json.load(f)
            except ValueError:
                obj = None
        if isinstance(obj, dict):
            entries = [obj]
        elif isinstance(obj, list):
            entries = [e for e in obj if isinstance(e, dict)]
    return entries


def load_run(ref, history="BENCH_HISTORY.jsonl"):
    """Resolve one run reference (path / index / latest / prev) to a trend
    entry dict."""
    if isinstance(ref, dict):
        return ref
    ref = str(ref)
    if ref == "latest":
        ref = "-1"
    elif ref == "prev":
        ref = "-2"
    if os.path.exists(ref):
        entries = _trend_entries(ref)
        if not entries:
            raise ValueError("no trend entries in %s" % ref)
        return entries[-1]
    try:
        index = int(ref)
    except ValueError:
        raise ValueError(
            "run reference %r is neither an existing file nor an index into "
            "%s" % (ref, history))
    entries = _trend_entries(history)
    if not entries:
        raise ValueError("no trend entries in history %s" % history)
    try:
        return entries[index]
    except IndexError:
        raise ValueError("history %s has %d entries; index %d out of range"
                         % (history, len(entries), index))


def diff_runs(run_a, run_b):
    """Diff two trend entries (a = baseline, b = candidate) into a forensic
    verdict dict: rows/s movement, per-site self-time ratios over the
    significant sites, the named regressed site (largest significant
    self-time growth), and the one-line human verdict."""
    from petastorm_tpu_torch.obs.critical_path import diff_self_times

    rows_a = run_a.get("rows_per_s") or 0.0
    rows_b = run_b.get("rows_per_s") or 0.0
    rows_delta = (rows_b / rows_a - 1.0) if rows_a else 0.0

    sites_a = run_a.get("sites") or {}
    sites_b = run_b.get("sites") or {}
    site_diffs = diff_self_times(sites_a, sites_b,
                                 min_share=_MIN_SITE_SHARE)
    ratios = {site: round(ratio, 3)
              for site, ratio, _a, _b in site_diffs}
    regressed_site = None
    regressed_ratio = None
    # site_diffs is sorted worst-growth-first: the candidate is its head,
    # named only when the growth clears the ratio bar
    if site_diffs and site_diffs[0][1] >= _MIN_RATIO:
        regressed_site = site_diffs[0][0]
        regressed_ratio = round(site_diffs[0][1], 3)

    parts = ["rows/s %+.1f%%" % (100.0 * rows_delta)]
    if regressed_site is not None:
        parts.append("%s self-time %.1fx (%.3fs -> %.3fs)"
                     % (regressed_site, regressed_ratio,
                        sites_a.get(regressed_site, 0.0),
                        sites_b.get(regressed_site, 0.0)))
    hedge_note = _hedge_note(run_a, run_b)
    if hedge_note:
        parts.append(hedge_note)
    tenant_breakdown, tenant_note = _tenant_breakdown(run_a, run_b)
    if tenant_note:
        parts.append(tenant_note)
    p99_a, p99_b = run_a.get("step_p99_s"), run_b.get("step_p99_s")
    if p99_a and p99_b and p99_a > 0 and p99_b / p99_a >= _MIN_RATIO:
        parts.append("step p99 %.1fx (%.1fms -> %.1fms)"
                     % (p99_b / p99_a, p99_a * 1e3, p99_b * 1e3))
    if regressed_site is None and len(parts) == 1:
        parts.append("no site's critical-path self time moved >=%.2fx at "
                     ">=%d%% share" % (_MIN_RATIO, 100 * _MIN_SITE_SHARE))
    return {
        "schema": DIFF_SCHEMA,
        "rows_per_s_a": round(rows_a, 1),
        "rows_per_s_b": round(rows_b, 1),
        "rows_per_s_delta": round(rows_delta, 4),
        "site_ratios": ratios,
        "regressed_site": regressed_site,
        "regressed_site_ratio": regressed_ratio,
        "workload_a": run_a.get("workload"),
        "workload_b": run_b.get("workload"),
        "tenant_breakdown": tenant_breakdown,
        "verdict": ": ".join([parts[0], ", ".join(parts[1:])]) if parts[1:]
        else parts[0],
    }


def _tenant_breakdown(run_a, run_b):
    """Per-tenant forensics: when BOTH runs carry the
    tenant-dimensioned site map (``"tenants": {tenant: {site: self_s}}`` —
    written by workloads that ran with ``tenant=``-labeled series), diff each
    tenant's critical-path self-times independently and name the worst
    offender: "tenant b's io.remote self-time 2.1x". Returns
    ``(breakdown_dict_or_None, note_or_None)``."""
    from petastorm_tpu_torch.obs.critical_path import diff_self_times

    tenants_a = run_a.get("tenants")
    tenants_b = run_b.get("tenants")
    if not isinstance(tenants_a, dict) or not isinstance(tenants_b, dict):
        return None, None
    breakdown = {}
    worst = None  # (ratio, tenant, site)
    for tenant in sorted(set(tenants_a) & set(tenants_b)):
        diffs = diff_self_times(tenants_a[tenant] or {},
                                tenants_b[tenant] or {},
                                min_share=_MIN_SITE_SHARE)
        breakdown[tenant] = {site: round(ratio, 3)
                             for site, ratio, _a, _b in diffs}
        if diffs and diffs[0][1] >= _MIN_RATIO \
                and (worst is None or diffs[0][1] > worst[0]):
            worst = (diffs[0][1], tenant, diffs[0][0])
    if not breakdown:
        return None, None
    note = None
    if worst is not None:
        note = "tenant %s's %s self-time %.1fx" % (worst[1], worst[2],
                                                   worst[0])
    return breakdown, note


def _hedge_note(run_a, run_b):
    """"hedge win rate halved" style note when both entries carry the remote
    io counters (optional trend fields)."""
    def win_rate(run):
        io = run.get("io") or {}
        hedges = io.get("hedges")
        if not hedges:
            return None
        return io.get("hedge_wins", 0) / hedges

    wa, wb = win_rate(run_a), win_rate(run_b)
    if wa is None or wb is None or wa <= 0:
        return None
    if wb / wa <= 0.6:
        return "hedge win rate %.0f%% -> %.0f%%" % (100 * wa, 100 * wb)
    return None


def render(verdict, run_a, run_b):
    lines = ["bench diff (%s -> %s):"
             % (run_a.get("workload", "?"), run_b.get("workload", "?")),
             "  rows/s %.0f -> %.0f (%+.1f%%)"
             % (verdict["rows_per_s_a"], verdict["rows_per_s_b"],
                100 * verdict["rows_per_s_delta"])]
    if verdict["workload_a"] != verdict["workload_b"]:
        lines.append("  WARNING: different workload fingerprints — rows/s "
                     "numbers are not directly comparable")
    sites_a = run_a.get("sites") or {}
    sites_b = run_b.get("sites") or {}
    for site in sorted(set(sites_a) | set(sites_b),
                       key=lambda s: -(verdict["site_ratios"].get(s, 0))):
        a, b = sites_a.get(site, 0.0), sites_b.get(site, 0.0)
        ratio = verdict["site_ratios"].get(site)
        flag = "  <-- regressed" if site == verdict["regressed_site"] else ""
        lines.append("  %-24s %8.3fs -> %8.3fs self%s%s"
                     % (site, a, b,
                        "  (%.2fx)" % ratio if ratio is not None else "",
                        flag))
    breakdown = verdict.get("tenant_breakdown")
    if breakdown:
        lines.append("  per-tenant self-time ratios:")
        for tenant in sorted(breakdown):
            ratios = breakdown[tenant]
            worst = max(ratios.items(), key=lambda kv: kv[1]) \
                if ratios else None
            lines.append("    %-16s %s" % (tenant, "  ".join(
                "%s %.2fx" % (site, ratios[site])
                for site in sorted(ratios, key=lambda s: -ratios[s])[:4])
                if worst else "(no significant sites)"))
    lines.append("  verdict: %s" % verdict["verdict"])
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m petastorm_tpu_torch.obs.diff", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("run_a", help="baseline run: file path, history "
                                      "index, 'latest' or 'prev'")
    parser.add_argument("run_b", help="candidate run (same forms)")
    parser.add_argument("--history", default="BENCH_HISTORY.jsonl",
                        help="history JSONL indices resolve against")
    parser.add_argument("--fail-threshold", type=float, default=None,
                        metavar="FRACTION",
                        help="exit 1 when rows/s regressed more than this "
                             "fraction (default: report only)")
    args = parser.parse_args(argv)

    try:
        run_a = load_run(args.run_a, history=args.history)
        run_b = load_run(args.run_b, history=args.history)
    except ValueError as e:
        print("diff: %s" % e)
        return 2
    verdict = diff_runs(run_a, run_b)
    print(render(verdict, run_a, run_b))
    print(json.dumps(verdict))
    if args.fail_threshold is not None \
            and verdict["rows_per_s_delta"] < -args.fail_threshold:
        return 1
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
