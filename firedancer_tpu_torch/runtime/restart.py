"""Per-stage restart policy for the supervisor (the port's copy of
firedancer_tpu/runtime/restart.py, schedule for schedule).

A stage that died once is respawned in place (its rings are intact); one
that crash-loops takes the topology down and leaves the evidence.  This is
the policy half: bounded attempts with exponential backoff and seeded
jitter, so the schedule for a (seed, stage) is the same on every run
(utils/rng.py).  The mechanism is runtime/topo.TopologyHandle.supervise
(respawn, ring reattach) and runtime/stage.Stage.resume_from_rings (cursor
recovery, the exactly-once publish guard).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

from ..utils.rng import Rng


@dataclass(frozen=True)
class RestartPolicy:
    """Attempt k (1-based) waits `backoff_base_s * backoff_mult**(k-1)`
    scaled by a seeded jitter in [1, 1 + jitter_frac); past `max_restarts`
    the supervisor fails fast with a flight dump."""

    max_restarts: int = 3
    backoff_base_s: float = 0.05
    backoff_mult: float = 2.0
    jitter_frac: float = 0.5
    seed: int = 0

    def delay_s(self, stage: str, attempt: int) -> float:
        """Backoff before restart `attempt` (1-based) of `stage`."""
        if attempt < 1:
            raise ValueError("attempt is 1-based")
        base = self.backoff_base_s * self.backoff_mult ** (attempt - 1)
        # one Rng per (stage, attempt): the schedule does not depend on how
        # many draws other stages made
        r = Rng(self.seed, zlib.crc32(stage.encode()) ^ (attempt << 32))
        return base * (1.0 + self.jitter_frac * r.float01())

    def schedule(self, stage: str) -> list[float]:
        """The stage's whole backoff schedule, in seconds."""
        return [self.delay_s(stage, a) for a in range(1, self.max_restarts + 1)]


def policy_for(restart, stage: str) -> RestartPolicy | None:
    """supervise(restart=...)'s argument resolved for one stage: a policy
    covers every stage, a dict covers the stages it names, None none."""
    if restart is None:
        return None
    if isinstance(restart, RestartPolicy):
        return restart
    return restart.get(stage)
