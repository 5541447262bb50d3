"""The topology checker: pre-boot validation of a runtime/topo.Topology
(the port's copy of firedancer_tpu/analysis/topo_check.py, rule for rule).

It runs on a Topology object, built and never launched, so a mis-wired
graph fails in the parent with a readable report instead of dying inside
a spawned child; `runtime.topo.launch()` calls `validate_or_raise` before
any shared memory exists.

Wiring is declarative and optional: stages that pass `ins=` / `outs=` to
`Topology.stage()` take part in the graph checks, and a topology whose
stages declare nothing still gets the per-link invariants.  Rules about
something missing (FD102 no producer, FD103 no consumer) need every stage
declared, since an undeclared stage may be the missing end; rules about
something present (FD101, FD106, FD107, FD109) fire on any declared
subset.
"""

from __future__ import annotations

from ..tango.rings import DCache
from .framework import SEV_ERROR, Finding, get_rule


class TopologyError(RuntimeError):
    """Raised by validate_or_raise; .findings carries the full report."""

    def __init__(self, findings: list[Finding]):
        self.findings = findings
        lines = [f.format() for f in findings]
        super().__init__(f"topology failed pre-boot validation ({len(findings)} finding(s)):\n  "
                         + "\n  ".join(lines))


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _builder_picklable(builder) -> bool:
    """A module-level callable, which the spawn pickler resolves by its
    qualified name in the fresh interpreter."""
    qn = getattr(builder, "__qualname__", None)
    mod = getattr(builder, "__module__", None)
    if qn is None or mod is None:
        return False  # functools.partial and the like
    return "<locals>" not in qn and "<lambda>" not in qn


def check_topology(topo, label: str = "topology") -> list[Finding]:
    """Every finding for a Topology; callers decide what is fatal."""
    out: list[Finding] = []
    where = f"topo:{label}"

    def hit(rule: str, msg: str) -> None:
        out.append(Finding(rule=rule, path=where, line=0, msg=msg))

    links = {}
    for ls in topo.links:
        if ls.name in links:
            hit("FD108", f"duplicate link name '{ls.name}'")
        links[ls.name] = ls
        if not _is_pow2(ls.depth):
            hit("FD104", f"link '{ls.name}' depth {ls.depth} is not a power of two")
        dcache_sz = getattr(ls, "dcache_sz", None)
        if dcache_sz is not None:
            need = DCache.footprint(ls.mtu, ls.depth)
            if dcache_sz < need:
                hit("FD105", f"link '{ls.name}' dcache_sz {dcache_sz} <"
                    f" footprint({ls.mtu}, {ls.depth}) = {need}")
            elif dcache_sz % DCache.CHUNK_SZ:
                hit("FD105", f"link '{ls.name}' dcache_sz {dcache_sz} is not a multiple of"
                    f" the {DCache.CHUNK_SZ}-byte chunk: the u64 cells after the dcache"
                    " would be misaligned")

    stage_names: set[str] = set()
    producers: dict[str, list[str]] = {}  # link -> producing stages
    consumers: dict[str, list[str]] = {}  # link -> consuming stages
    declared = []
    for ss in topo.stages:
        if ss.name in stage_names:
            hit("FD108", f"duplicate stage name '{ss.name}'")
        stage_names.add(ss.name)
        if not _builder_picklable(ss.builder):
            hit("FD110", f"stage '{ss.name}' builder"
                f" {getattr(ss.builder, '__qualname__', ss.builder)!r} is not a"
                " module-level function")
        ins = getattr(ss, "ins", None)
        outs = getattr(ss, "outs", None)
        if ins is None and outs is None:
            continue  # hand-wired: the graph rules do not apply
        declared.append(ss)
        if not ins and not outs:
            hit("FD111", f"stage '{ss.name}' declares wiring but no links")
        for ln in outs or ():
            if ln not in links:
                hit("FD109", f"stage '{ss.name}' produces unknown link '{ln}'")
            producers.setdefault(ln, []).append(ss.name)
        for ln in ins or ():
            if ln not in links:
                hit("FD109", f"stage '{ss.name}' consumes unknown link '{ln}'")
            consumers.setdefault(ln, []).append(ss.name)

    for ln, ps in producers.items():
        if len(ps) > 1:
            hit("FD101", f"link '{ln}' has {len(ps)} producers ({', '.join(ps)});"
                " mcache publish is single-producer")

    if declared and len(declared) == len(topo.stages):
        for ln, cs in consumers.items():
            if ln in links and ln not in producers:
                hit("FD102", f"stage(s) {', '.join(cs)} consume link '{ln}' which no stage"
                    " produces")
        for ln, ps in producers.items():
            if ln in links and ln not in consumers:
                hit("FD103", f"link '{ln}' (produced by {ps[0]}) has no consumer; its fseq"
                    " never advances and the producer stalls after depth frags")
    if declared:
        for ln, cs in consumers.items():
            if ln in links and links[ln].n_consumers < len(cs):
                hit("FD106", f"link '{ln}' provisions {links[ln].n_consumers} fseq slot(s)"
                    f" for {len(cs)} consumers ({', '.join(cs)})")
        out.extend(_credit_cycles(topo, producers, consumers, where))
    return out


def _credit_cycles(topo, producers, consumers, where) -> list[Finding]:
    """FD107: a directed cycle whose stages are all credit-gated (they stop
    consuming while any output is backpressured) can deadlock.  One stage
    on the loop that keeps draining breaks it (pack, on the pack <-> bank
    loop)."""
    gated = {s.name for s in topo.stages if getattr(s, "credit_gated", False)}
    adj: dict[str, set[str]] = {n: set() for n in gated}
    for ln, ps in producers.items():
        for p in ps:
            if p not in gated:
                continue
            for c in consumers.get(ln, ()):
                if c in gated:
                    adj[p].add(c)
    out: list[Finding] = []
    color: dict[str, int] = {}  # 0 visiting, 1 done

    def dfs(n: str, path: list[str]) -> None:
        color[n] = 0
        path.append(n)
        for m in sorted(adj[n]):
            if m not in color:
                dfs(m, path)
            elif color[m] == 0:
                cyc = path[path.index(m):] + [m]
                out.append(Finding(rule="FD107", path=where, line=0,
                                   msg="credit-gated cycle " + " -> ".join(cyc)
                                   + "; no stage on the loop drains while backpressured"))
        path.pop()
        color[n] = 1

    for n in sorted(gated):
        if n not in color:
            dfs(n, [])
    return out


def validate_or_raise(topo, label: str = "topology") -> list[Finding]:
    """launch()'s check: raise TopologyError on any error-severity
    finding, else return the (warning-only) findings."""
    findings = check_topology(topo, label)
    fatal = [f for f in findings if get_rule(f.rule).severity == SEV_ERROR]
    if fatal:
        raise TopologyError(fatal)
    return findings


def restart_domains(topo) -> list[tuple[str, bool]]:
    """The crash and restart domains, [(stage, restartable)] in stage
    order: one StageSpec is one spawned process is one domain, so a fused
    stage (the fused poh+shred stage) restarts as a whole."""
    return [(spec.name, bool(getattr(spec, "restartable", False))) for spec in topo.stages]
