"""The slot clock: one wall-clock deadline authority for the leader (the
port's copy of firedancer_tpu/runtime/slot_clock.py).

A leader is judged by the 400 ms slot cadence: every tick and every slot
boundary derives from wall-clock time reckoned against one anchor.  This
module holds the geometry (`SlotClockCfg`, picklable, anchored once) and
the reader (`SlotClock`) that answers the only questions deadline code
asks: which slot is it, when does it end, which ticks are due, and is a
slot past saving.

  - All arithmetic is integer nanoseconds off one anchor (`t0_ns`), so
    every stage built from the same anchored cfg derives identical
    boundaries.
  - The cadence is configurable (400 ms real, compressed for tests), but
    the geometry is fixed at anchor time: slot s starts at
    t0 + (s - slot0) * slot_ns.  Load never moves a boundary.
  - `now_fn` is injectable (tests use virtual time) and defaults to
    time.monotonic_ns, the clock the frag timestamps use.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class SlotClockCfg:
    """Picklable slot-clock geometry.

    `t0_ns` is the shared anchor: resolve it once (`anchored`) before the
    cfg reaches the stages, or each stage anchors at its own build instant
    and the clocks disagree.  `boot_grace_s` anchors the epoch slightly in
    the future, so slot0 starts once the pipeline is actually up."""

    slot_ms: float = 400.0
    slot0: int = 1
    ticks_per_slot: int = 8
    # the leader window: seal slots [slot0, slot0 + n_slots) then stop
    # (the handoff fires on this schedule, not on drain); None = unbounded
    n_slots: int | None = None
    # grace past the deadline before a slot is MISSED rather than sealed
    # late (jitter allowance, as a fraction of the slot)
    miss_grace_frac: float = 0.25
    t0_ns: int | None = None

    def anchored(self, boot_grace_s: float = 0.0,
                 now_ns: int | None = None) -> "SlotClockCfg":
        """Resolve the epoch anchor now (+ boot grace); idempotent when
        t0_ns is already set."""
        if self.t0_ns is not None:
            return self
        base = time.monotonic_ns() if now_ns is None else now_ns
        return replace(self, t0_ns=base + int(boot_grace_s * 1e9))

    def build(self, now_fn=None) -> "SlotClock":
        return SlotClock(self, now_fn=now_fn)


class SlotClock:
    """Deadline reader over an anchored cfg.  Pure integer-ns queries, cheap
    enough for one clock read per loop sweep (never one per frag)."""

    def __init__(self, cfg: SlotClockCfg, now_fn=None):
        if cfg.ticks_per_slot <= 0:
            raise ValueError("ticks_per_slot must be positive")
        if cfg.slot_ms <= 0:
            raise ValueError("slot_ms must be positive")
        self.cfg = cfg if cfg.t0_ns is not None else cfg.anchored()
        self._now_fn = now_fn or time.monotonic_ns
        self.slot_ns = max(int(cfg.slot_ms * 1e6), cfg.ticks_per_slot)
        self.tick_ns = self.slot_ns // cfg.ticks_per_slot
        self.grace_ns = int(self.slot_ns * cfg.miss_grace_frac)
        self.t0 = self.cfg.t0_ns

    # -- queries -------------------------------------------------------------

    def now(self) -> int:
        return self._now_fn()

    def slot_at(self, now_ns: int) -> int:
        """The slot whose window contains now (clamped to slot0 before the
        anchor: the boot-grace period belongs to the first slot)."""
        return self.cfg.slot0 + max(0, now_ns - self.t0) // self.slot_ns

    def start_of(self, slot: int) -> int:
        return self.t0 + (slot - self.cfg.slot0) * self.slot_ns

    def deadline_of(self, slot: int) -> int:
        return self.start_of(slot) + self.slot_ns

    def remaining_ns(self, slot: int, now_ns: int) -> int:
        return self.deadline_of(slot) - now_ns

    def ticks_due(self, slot: int, now_ns: int) -> int:
        """Ticks of `slot` that should have landed by now, in
        [0, ticks_per_slot]: tick k (1-based) is due at start + k * tick_ns."""
        d = now_ns - self.start_of(slot)
        if d <= 0:
            return 0
        return min(d // self.tick_ns, self.cfg.ticks_per_slot)

    def tick_deadline(self, slot: int, k: int) -> int:
        """When tick k (1-based) of `slot` is due to land."""
        return self.start_of(slot) + k * self.tick_ns

    def missed(self, slot: int, now_ns: int) -> bool:
        """Past saving: the deadline + grace has elapsed, so the slot is a
        MISS, not a late seal."""
        return now_ns > self.deadline_of(slot) + self.grace_ns

    # -- leader window -------------------------------------------------------

    def last_slot(self) -> int | None:
        if self.cfg.n_slots is None:
            return None
        return self.cfg.slot0 + self.cfg.n_slots - 1

    def in_window(self, slot: int) -> bool:
        last = self.last_slot()
        return last is None or slot <= last

    def window_end_ns(self) -> int | None:
        """The handoff instant: the last window slot's deadline."""
        last = self.last_slot()
        return None if last is None else self.deadline_of(last)

    def window_done(self, now_ns: int | None = None) -> bool:
        end = self.window_end_ns()
        if end is None:
            return False
        return (self.now() if now_ns is None else now_ns) >= end


def resolve_clock(clock) -> SlotClock | None:
    """Accept a SlotClockCfg (pipeline constructors: the picklable form), a built
    SlotClock (tests with injected time), or None: the one coercion every
    clocked stage constructor uses."""
    if clock is None or isinstance(clock, SlotClock):
        return clock
    if isinstance(clock, SlotClockCfg):
        return clock.build()
    raise TypeError(f"clock must be SlotClockCfg | SlotClock | None, "
                    f"got {type(clock).__name__}")
