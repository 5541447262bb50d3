"""Declarative fault injection: what breaks, where, and when (the port's
copy of firedancer_tpu/chaos/faults.py).

Two injection surfaces, matching the two ways this framework runs a
topology:

  - PROCESS topologies (runtime/topo.py): `FaultInjector` is an
    `on_poll` hook for `TopologyHandle.supervise` — it fires scheduled
    stage kills (SIGKILL through the supervisor's own
    `kill_stage`), heartbeat freezes (SIGSTOP) and thaws at their
    offsets, and records what fired so the scenario summary can assert
    the schedule actually ran.  The supervisor then judges the damage
    exactly as it would a real crash: that indirection is the point —
    chaos exercises the REAL recovery machinery, not a parallel one.

  - in-process pipelines (models/leader.py): `LinkFaults` describes a
    lossy link (drop/dup/reorder probabilities) applied by splicing the
    tango shim (`tango/lossy.wrap_stage_input`) over a stage input,
    seeded from the run seed.

Schedules are plain frozen dataclasses: a scenario file can enumerate
them, a test can assert on them, and `describe()` round-trips into the
deterministic summary.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ..utils.rng import Rng


@dataclass(frozen=True)
class KillStage:
    """SIGKILL `stage` at `at_s` seconds after arm() — the crash fault."""

    stage: str
    at_s: float

    def fire(self, handle) -> None:
        handle.kill_stage(self.stage)

    def describe(self) -> str:
        return f"kill:{self.stage}@{self.at_s:g}s"


@dataclass(frozen=True)
class FreezeStage:
    """SIGSTOP `stage` at `at_s`: alive but silent — the wedge fault
    (stale cnc heartbeat is the supervisor's only evidence)."""

    stage: str
    at_s: float

    def fire(self, handle) -> None:
        handle.freeze_stage(self.stage)

    def describe(self) -> str:
        return f"freeze:{self.stage}@{self.at_s:g}s"


@dataclass(frozen=True)
class ThawStage:
    stage: str
    at_s: float

    def fire(self, handle) -> None:
        handle.thaw_stage(self.stage)

    def describe(self) -> str:
        return f"thaw:{self.stage}@{self.at_s:g}s"


@dataclass(frozen=True)
class LinkFaults:
    """Lossy-link spec for a cooperative pipeline stage input (consumed
    by `apply_link_faults`, not by the supervisor hook)."""

    stage: str
    in_idx: int = 0
    drop_p: float = 0.0
    dup_p: float = 0.0
    reorder_p: float = 0.0

    def describe(self) -> str:
        parts = []
        if self.drop_p:
            parts.append(f"drop={self.drop_p:g}")
        if self.dup_p:
            parts.append(f"dup={self.dup_p:g}")
        if self.reorder_p:
            parts.append(f"reorder={self.reorder_p:g}")
        return f"link:{self.stage}[{self.in_idx}]({','.join(parts)})"


@dataclass(frozen=True)
class Partition:
    """Withhold a voter group's votes between two steps (gossip
    partition as choreo sees it); consumed by the fork-storm scenario's
    event generator."""

    at_step: int
    heal_step: int
    group_frac: float = 0.3  # fraction of voters cut off

    def describe(self) -> str:
        return (f"partition:{self.group_frac:g}"
                f"@[{self.at_step},{self.heal_step})")


class FaultInjector:
    """The supervisor-hook half: pass `on_poll=injector` to
    `TopologyHandle.supervise` after `arm()`.  Offsets are wall-clock
    seconds from arm time (the supervisor loop is the only clock a
    process topology has)."""

    def __init__(self, schedule):
        self.schedule = sorted(
            [f for f in schedule if hasattr(f, "fire")],
            key=lambda f: f.at_s,
        )
        self.fired: list[str] = []
        self._t0: float | None = None

    def arm(self, t0: float | None = None) -> "FaultInjector":
        self._t0 = time.monotonic() if t0 is None else t0
        return self

    def __call__(self, handle) -> None:
        if self._t0 is None:
            self.arm()
        now = time.monotonic() - self._t0
        while self.schedule and self.schedule[0].at_s <= now:
            fault = self.schedule.pop(0)
            fault.fire(handle)
            self.fired.append(fault.describe())

    def all_fired(self) -> bool:
        return not self.schedule


def apply_link_faults(pipe, faults, rng: Rng):
    """Splice lossy shims over a cooperative LeaderPipeline (or any
    object with `.stages`) per the LinkFaults specs; returns
    {describe(): shim} so invariants can read the fault counters."""
    from ..tango.lossy import wrap_stage_input

    by_name = {s.name: s for s in pipe.stages}
    shims = {}
    for lf in faults:
        if not isinstance(lf, LinkFaults):
            continue
        shims[lf.describe()] = wrap_stage_input(
            by_name[lf.stage], lf.in_idx, rng,
            drop_p=lf.drop_p, dup_p=lf.dup_p, reorder_p=lf.reorder_p,
        )
    return shims
