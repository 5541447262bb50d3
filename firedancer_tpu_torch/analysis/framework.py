"""The rule registry and the Finding type of the topology checker (the
port's copy of the pieces of firedancer_tpu/analysis/framework.py that
analysis/topo_check.py needs: the FD1xx rules, with the JAX package's ids,
names and severities).

A Rule is identity and documentation; the checker emits Findings tagged
with a registered rule id, and callers decide on the ids what is fatal.
"""

from __future__ import annotations

from dataclasses import dataclass

SEV_ERROR = "error"
SEV_WARNING = "warning"


@dataclass(frozen=True)
class Rule:
    id: str  # stable: FD1xx topology
    name: str  # short kebab-case handle
    severity: str  # SEV_ERROR | SEV_WARNING
    summary: str


@dataclass
class Finding:
    rule: str
    path: str  # "topo:<label>" for topology findings
    line: int  # 0 for topology findings
    msg: str

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.rule} [{get_rule(self.rule).severity}] {self.msg}"


_RULES: dict[str, Rule] = {}


def _rule(id: str, name: str, severity: str, summary: str) -> Rule:
    r = Rule(id, name, severity, summary)
    if id in _RULES:
        raise ValueError(f"duplicate rule id {id}")
    _RULES[id] = r
    return r


def get_rule(id: str) -> Rule:
    return _RULES[id]


def all_rules() -> list[Rule]:
    return [_RULES[k] for k in sorted(_RULES)]


# -- topology rules (FD1xx): the fd_topob pre-boot invariants -----------------

FD101 = _rule("FD101", "topo-multi-producer", SEV_ERROR,
              "link has more than one producing stage (mcache is single-producer)")
FD102 = _rule("FD102", "topo-no-producer", SEV_ERROR,
              "stage consumes a link no stage produces (orphan consumer)")
FD103 = _rule("FD103", "topo-no-consumer", SEV_ERROR,
              "link is produced but no stage consumes it (producer stalls at depth)")
FD104 = _rule("FD104", "topo-depth-pow2", SEV_ERROR,
              "link depth is not a power of two (mcache line index is seq & (depth-1))")
FD105 = _rule("FD105", "topo-dcache-small", SEV_ERROR,
              "dcache_sz override below DCache.footprint(mtu, depth): frags in flight"
              " would be overwritten before consumers read them")
FD106 = _rule("FD106", "topo-fseq-underprovision", SEV_ERROR,
              "link declares fewer fseq slots (n_consumers) than consuming stages:"
              " credit flow cannot see the extra consumers and will overrun them")
FD107 = _rule("FD107", "topo-credit-deadlock", SEV_ERROR,
              "cycle of credit-gated stages: every stage on the loop stops consuming"
              " when backpressured, so the loop can wedge permanently")
FD108 = _rule("FD108", "topo-dup-name", SEV_ERROR,
              "duplicate stage or link name (shm segment names would collide)")
FD109 = _rule("FD109", "topo-unknown-link", SEV_ERROR,
              "stage wiring references a link the topology never declared")
FD110 = _rule("FD110", "topo-unpicklable-builder", SEV_ERROR,
              "stage builder is not a module-level callable: it cannot pickle into"
              " the spawned child (fork is unusable with a live CUDA context)")
FD111 = _rule("FD111", "topo-isolated-stage", SEV_WARNING,
              "stage declares wiring but neither produces nor consumes any link")
