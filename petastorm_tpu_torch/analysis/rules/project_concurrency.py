"""Whole-program concurrency rules: the deadlock shapes per-file
analysis cannot see.

GL-C005 — blocking under a lock. The controller's live deadlock: ``_DONE`` was posted
while holding ``_active_lock``; a worker blocked on the full results queue
could never drain it, and every collector wedged. The blocking ``put`` lived
in a helper method, three screens from the ``with`` block — so the rule
follows ONE call-graph hop: a direct unbounded blocking call under a tracked
lock fires at the call, and a call to a method whose body blocks fires at the
call site naming the inner location.

GL-C006 — lock-order cycles. Each function contributes (held → acquired)
edges to a global lock-order graph keyed by unified lock identity; any cycle
(ABBA or longer) is reported once with a witness path for every direction.
Warning, not error: two locks acquired in both orders from different
call stacks may still be serialized by a third — the graph can't see that —
but in this codebase every such cycle so far has been a real bug.
"""
from __future__ import annotations

from petastorm_tpu_torch.analysis.engine import ProjectRule
from petastorm_tpu_torch.analysis.findings import Finding, Severity


class BlockingUnderLockRule(ProjectRule):
    rule_id = "GL-C005"
    severity = Severity.ERROR
    description = ("unbounded blocking call reached while holding a lock "
                   "(direct or through one call hop)")
    fix_hint = ("compute under the lock, block outside it — or use the timed "
                "variant (timeout=...) and re-check a stop condition in a loop")

    def check_project(self, project):
        for module in project.modules:
            for cls in module.classes.values():
                for method in cls.methods.values():
                    yield from self._check_method(project, module, cls,
                                                  method)

    def _check_method(self, project, module, cls, method):
        for event in project.lock_region_events(module, cls, method):
            kind = event[0]
            if kind == "block":
                _, site, held = event
                if not held or self._cond_wait_ok(site, held):
                    continue
                yield self._finding(
                    project, module, site.node,
                    "%s while %s is held" % (
                        site.reason, self._held_label(project, held)),
                )
            elif kind == "call":
                _, call, (owner, funcdef), held = event
                if not held:
                    continue
                summary = project.summary(
                    module, owner if owner is not None else cls
                    if funcdef in cls.methods.values() else None, funcdef)
                for site in summary["blocking"]:
                    if self._cond_wait_ok(site, held):
                        continue
                    yield self._finding(
                        project, module, call,
                        "call to `%s()` blocks while %s is held: %s at "
                        "%s:%d" % (
                            funcdef.name,
                            self._held_label(project, held),
                            site.reason,
                            module.rel_label(),
                            site.node.lineno,
                        ),
                    )
                    break  # one finding per call site, not one per inner site

    @staticmethod
    def _cond_wait_ok(site, held):
        """``with self._cond: self._cond.wait()`` is THE condition-variable
        idiom — wait releases the lock while blocked. It is only clean when
        the condition's own lock is the sole lock held; any other lock stays
        held across the wait and the finding stands."""
        return site.cond_key is not None and held == {site.cond_key}

    @staticmethod
    def _held_label(project, held):
        labels = sorted(project.lock_label(k) for k in held)
        return "`%s`" % "`, `".join(labels)

    def _finding(self, project, module, node, message):
        ctx = module.ctx
        line = getattr(node, "lineno", 1)
        return Finding(
            rule_id=self.rule_id,
            severity=self.severity,
            path=module.path,
            line=line,
            col=getattr(node, "col_offset", 0) + 1,
            message=message,
            fix_hint=self.fix_hint,
            code=ctx.code_at(line),
            end_line=getattr(node, "end_lineno", None) or line,
        )


class LockOrderCycleRule(ProjectRule):
    rule_id = "GL-C006"
    severity = Severity.WARNING
    description = ("inconsistent lock acquisition order across the project "
                   "(ABBA deadlock candidate)")
    fix_hint = ("pick one global order for these locks and acquire them in "
                "that order everywhere (or merge them into one lock)")

    def check_project(self, project):
        # edges[(a, b)] = first witness: a held while b acquired
        edges = {}
        for module in project.modules:
            for cls in module.classes.values():
                for method in cls.methods.values():
                    qual = "%s.%s" % (cls.qualname, method.name)
                    self._collect_edges(project, module, cls, method, qual,
                                        edges)
        yield from self._report_cycles(project, edges)

    def _collect_edges(self, project, module, cls, method, qual, edges):
        for event in project.lock_region_events(module, cls, method):
            kind = event[0]
            if kind == "acquire":
                _, key, node, held = event
                for h in held:
                    self._add_edge(edges, h, key, qual, module, node, None)
            elif kind == "call":
                _, call, (owner, funcdef), held = event
                if not held:
                    continue
                summary = project.summary(module, owner, funcdef)
                for key, node in summary["acquires"]:
                    for h in held:
                        self._add_edge(edges, h, key, qual, module, call,
                                       funcdef.name)

    @staticmethod
    def _add_edge(edges, held_key, acquired_key, qual, module, node, via):
        if held_key == acquired_key:
            return  # re-entry of the same identity is RLock territory, not order
        edge = (held_key, acquired_key)
        if edge not in edges:
            edges[edge] = (qual, module, node, via)

    def _report_cycles(self, project, edges):
        adj = {}
        for (a, b) in edges:
            adj.setdefault(a, set()).add(b)
        reported = set()
        # ABBA pairs first: both single edges exist, report once per pair
        for (a, b) in sorted(edges, key=self._edge_sort_key):
            if (b, a) not in edges or a > b or (a, b) in reported:
                continue
            reported.add((a, b))
            yield self._pair_finding(project, edges, a, b)
        # longer cycles: any strongly connected component of size >= 3
        for scc in _sccs(adj):
            if len(scc) < 3:
                continue
            cycle = self._representative_cycle(adj, scc)
            if cycle is None:
                continue
            key = tuple(sorted(cycle))
            if key in reported:
                continue
            reported.add(key)
            yield self._cycle_finding(project, edges, cycle)

    @staticmethod
    def _edge_sort_key(edge):
        return edge

    def _pair_finding(self, project, edges, a, b):
        qual1, module1, node1, via1 = edges[(a, b)]
        qual2, module2, node2, via2 = edges[(b, a)]
        la, lb = project.lock_label(a), project.lock_label(b)
        message = (
            "lock order cycle between `%s` and `%s`: %s and %s" % (
                la, lb,
                self._witness(module1, node1, qual1, via1, la, lb),
                self._witness(module2, node2, qual2, via2, lb, la),
            ))
        return self._finding(module1, node1, message)

    def _cycle_finding(self, project, edges, cycle):
        labels = [project.lock_label(k) for k in cycle]
        witnesses = []
        for i, key in enumerate(cycle):
            nxt = cycle[(i + 1) % len(cycle)]
            qual, module, node, via = edges[(key, nxt)]
            witnesses.append(self._witness(
                module, node, qual, via,
                project.lock_label(key), project.lock_label(nxt)))
        first = edges[(cycle[0], cycle[1 % len(cycle)])]
        message = "lock order cycle through `%s`: %s" % (
            "` -> `".join(labels + [labels[0]]), "; ".join(witnesses))
        return self._finding(first[1], first[2], message)

    @staticmethod
    def _witness(module, node, qual, via, held_label, acquired_label):
        where = "%s:%d" % (module.rel_label(), node.lineno)
        if via:
            return "%s takes `%s` then `%s` via %s() (%s)" % (
                qual, held_label, acquired_label, via, where)
        return "%s takes `%s` then `%s` (%s)" % (
            qual, held_label, acquired_label, where)

    @staticmethod
    def _representative_cycle(adj, scc):
        """One concrete cycle inside an SCC, by DFS from its smallest node."""
        scc_set = set(scc)
        start = min(scc)
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(adj.get(node, ())):
                if nxt == start and len(path) >= 3:
                    return path
                if nxt in scc_set and nxt not in path:
                    stack.append((nxt, path + [nxt]))
        return None

    def _finding(self, module, node, message):
        line = getattr(node, "lineno", 1)
        return Finding(
            rule_id=self.rule_id,
            severity=self.severity,
            path=module.path,
            line=line,
            col=getattr(node, "col_offset", 0) + 1,
            message=message,
            fix_hint=self.fix_hint,
            code=module.ctx.code_at(line),
            end_line=getattr(node, "end_lineno", None) or line,
        )


def _sccs(adj):
    """Tarjan's strongly connected components, iterative."""
    index_counter = [0]
    index, lowlink = {}, {}
    on_stack, stack = set(), []
    result = []
    for root in sorted(adj):
        if root in index:
            continue
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = lowlink[root] = index_counter[0]
        index_counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = lowlink[nxt] = index_counter[0]
                    index_counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(adj.get(nxt, ())))))
                    advanced = True
                    break
                elif nxt in on_stack:
                    lowlink[node] = min(lowlink[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[node])
            if lowlink[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                result.append(comp)
    return result
